"""Google Cloud Storage remote client over the raw JSON API; the
counterpart of seaweedfs_tpu/remote_storage/gcs_client.py, on
rpc/httpclient's Session (one per client and thread) instead of a
`requests.Session`.

The slot of SeaweedFS weed/remote_storage/gcs/gcs_storage_client.go:21
with plain HTTP instead of cloud.google.com/go/storage.

Auth modes (pick one in remote.configure):
  (none)                — anonymous (public buckets, fake-gcs-server)
  -token=...            — static OAuth2 bearer token
  -token_url=...        — metadata-style endpoint returning
                          {"access_token": ..., "expires_in": ...}
                          (GCE/GKE workload identity)
  -credentials_file=... — service-account JSON key; the OAuth2 JWT
                          grant is signed in-tree (utils/rs256.py),
                          no google-auth needed

`-endpoint` overrides https://storage.googleapis.com for emulators.
"""
from __future__ import annotations

import threading
import urllib.parse
from typing import Iterator

from ..rpc.httpclient import Session
from .client import RemoteEntry, RemoteStorageClient, register_remote

GCS_ENDPOINT = "https://storage.googleapis.com"
SCOPE = "https://www.googleapis.com/auth/devstorage.read_write"


def _rfc3339_to_unix(s: str) -> float:
    # 2024-01-02T03:04:05.678Z — stdlib-parsable after the tz fixup
    try:
        from datetime import datetime

        return datetime.fromisoformat(s.replace("Z", "+00:00")) \
            .timestamp()
    except ValueError:
        return 0.0


class GcsRemoteClient(RemoteStorageClient):
    def __init__(self, bucket: str = "", endpoint: str = "",
                 token: str = "", token_url: str = "",
                 credentials_file: str = "", project: str = "", **_):
        if not bucket:
            raise ValueError("gcs remote storage needs -bucket")
        from ..utils.gcp_auth import GcpTokenSource

        self.bucket = bucket
        self.endpoint = (endpoint or GCS_ENDPOINT).rstrip("/")
        self.project = project
        self._local = threading.local()
        self._tokens = GcpTokenSource(
            token=token, token_url=token_url,
            credentials_file=credentials_file, scope=SCOPE)
        self._auth()  # fail fast on bad credentials

    def _session(self) -> Session:
        """This client's keep-alive pool on this thread (the reference
        keeps one requests.Session per client)."""
        s = getattr(self._local, "session", None)
        if s is None:
            s = self._local.session = Session()
        return s

    def _auth(self) -> dict:
        return self._tokens.headers()

    # -- helpers --------------------------------------------------------
    def _obj_url(self, key: str, media: bool = False) -> str:
        q = urllib.parse.quote(key.lstrip("/"), safe="")
        url = (f"{self.endpoint}/storage/v1/b/{self.bucket}/o/{q}")
        return url + "?alt=media" if media else url

    @staticmethod
    def _entry(item: dict) -> RemoteEntry:
        return RemoteEntry(
            key=item["name"], size=int(item.get("size", 0)),
            mtime=_rfc3339_to_unix(item.get("updated", "")),
            etag=item.get("md5Hash", item.get("etag", "")))

    # -- verbs ----------------------------------------------------------
    def traverse(self, prefix: str = "") -> Iterator[RemoteEntry]:
        page = ""
        while True:
            params = {"prefix": prefix.lstrip("/")}
            if page:
                params["pageToken"] = page
            r = self._session().get(
                f"{self.endpoint}/storage/v1/b/{self.bucket}/o",
                params=params, headers=self._auth(), timeout=60)
            r.raise_for_status()
            d = r.json()
            for item in d.get("items", []):
                yield self._entry(item)
            page = d.get("nextPageToken", "")
            if not page:
                return

    def head(self, key: str) -> RemoteEntry | None:
        r = self._session().get(self._obj_url(key), headers=self._auth(),
                           timeout=30)
        if r.status_code == 404:
            return None
        r.raise_for_status()
        return self._entry(r.json())

    def read_file(self, key: str, offset: int = 0,
                  size: int = -1) -> bytes:
        headers = self._auth()
        if offset or size >= 0:
            end = "" if size < 0 else str(offset + size - 1)
            headers["Range"] = f"bytes={offset}-{end}"
        r = self._session().get(self._obj_url(key, media=True),
                           headers=headers, timeout=300)
        r.raise_for_status()
        return r.content

    def write_file(self, key: str, data: bytes) -> RemoteEntry:
        r = self._session().post(
            f"{self.endpoint}/upload/storage/v1/b/{self.bucket}/o",
            params={"uploadType": "media", "name": key.lstrip("/")},
            data=data, headers={
                **self._auth(),
                "Content-Type": "application/octet-stream"},
            timeout=300)
        r.raise_for_status()
        return self._entry(r.json())

    def delete_file(self, key: str) -> None:
        r = self._session().delete(self._obj_url(key), headers=self._auth(),
                              timeout=60)
        if r.status_code not in (204, 404):
            r.raise_for_status()

    def list_buckets(self) -> list[str]:
        params = {"project": self.project} if self.project else {}
        r = self._session().get(f"{self.endpoint}/storage/v1/b",
                           params=params, headers=self._auth(),
                           timeout=30)
        r.raise_for_status()
        return sorted(i["name"] for i in r.json().get("items", []))


register_remote("gcs", GcsRemoteClient)
