"""Azure Blob Storage remote client over the raw REST API; the
counterpart of seaweedfs_tpu/remote_storage/azure_client.py, on
rpc/httpclient's Session (one per client and thread) instead of a
`requests.Session`.

The slot of SeaweedFS weed/remote_storage/azure/azure_storage_client.go:23
with plain HTTP + SharedKey request signing instead of
azure-storage-blob-go — HMAC-SHA256 over the canonicalized headers
and resource, per the published authorization scheme. The request goes
out with exactly the signed headers: `http.client` adds only Host and
Accept-Encoding (neither signed), and a bodyless request carries no
Content-Length, which signs as the empty string either way.

Configure: -account=... -key=<base64> -container=...; -endpoint
overrides https://{account}.blob.core.windows.net for Azurite-style
emulators.
"""
from __future__ import annotations

import base64
import hashlib
import hmac
import threading
import urllib.parse
import xml.etree.ElementTree as ET
from email.utils import formatdate, parsedate_to_datetime
from typing import Iterator

from ..rpc.httpclient import Response, Session
from .client import RemoteEntry, RemoteStorageClient, register_remote

API_VERSION = "2020-10-02"


def shared_key_signature(account: str, key_b64: str, method: str,
                         path: str, query: dict[str, str],
                         headers: dict[str, str]) -> str:
    """SharedKey string-to-sign + HMAC. `path` is the url path
    (/container/blob); headers must already include x-ms-date and
    x-ms-version."""
    h = {k.lower(): v for k, v in headers.items()}
    canon_headers = "".join(
        f"{k}:{h[k]}\n" for k in sorted(h) if k.startswith("x-ms-"))
    canon_resource = f"/{account}{path}"
    for k in sorted(query):
        canon_resource += f"\n{k.lower()}:{query[k]}"
    # API >= 2015-02-21: a zero Content-Length signs as the empty
    # string (an HTTP client may add "Content-Length: 0" to bodyless
    # DELETEs; both sides must canonicalize it away)
    content_length = h.get("content-length", "")
    if content_length == "0":
        content_length = ""
    sts = "\n".join([
        method,
        h.get("content-encoding", ""),
        h.get("content-language", ""),
        content_length,
        h.get("content-md5", ""),
        h.get("content-type", ""),
        "",  # Date: always empty, x-ms-date is used instead
        h.get("if-modified-since", ""),
        h.get("if-match", ""),
        h.get("if-none-match", ""),
        h.get("if-unmodified-since", ""),
        h.get("range", ""),
    ]) + "\n" + canon_headers + canon_resource
    mac = hmac.new(base64.b64decode(key_b64), sts.encode(),
                   hashlib.sha256).digest()
    return f"SharedKey {account}:{base64.b64encode(mac).decode()}"


class AzureRemoteClient(RemoteStorageClient):
    def __init__(self, account: str = "", key: str = "",
                 container: str = "", endpoint: str = "", **_):
        if not account or not key:
            raise ValueError("azure remote storage needs -account/-key")
        if not container:
            raise ValueError("azure remote storage needs -container")
        self.account = account
        self.key = key
        self.container = container
        self.endpoint = (endpoint or
                         f"https://{account}.blob.core.windows.net"
                         ).rstrip("/")
        self._local = threading.local()

    def _session(self) -> Session:
        """This client's keep-alive pool on this thread: a connection a
        refused request left unread is never reused by another client,
        as the reference's per-client requests.Session keeps it."""
        s = getattr(self._local, "session", None)
        if s is None:
            s = self._local.session = Session()
        return s

    # -- signed request -------------------------------------------------
    def _request(self, method: str, path: str,
                 query: dict[str, str] | None = None,
                 headers: dict[str, str] | None = None,
                 data: bytes = b"") -> Response:
        query = query or {}
        headers = dict(headers or {})
        headers["x-ms-date"] = formatdate(usegmt=True)
        headers["x-ms-version"] = API_VERSION
        if data:
            headers["Content-Length"] = str(len(data))
        headers["Authorization"] = shared_key_signature(
            self.account, self.key, method, path, query, headers)
        url = self.endpoint + urllib.parse.quote(path) + (
            "?" + urllib.parse.urlencode(query) if query else "")
        return self._session().request(method, url, headers=headers,
                                 data=data or None, timeout=300)

    def _blob_path(self, key: str) -> str:
        return f"/{self.container}/{key.lstrip('/')}"

    # -- verbs ----------------------------------------------------------
    def traverse(self, prefix: str = "") -> Iterator[RemoteEntry]:
        marker = ""
        while True:
            q = {"restype": "container", "comp": "list",
                 "prefix": prefix.lstrip("/")}
            if marker:
                q["marker"] = marker
            r = self._request("GET", f"/{self.container}", q)
            r.raise_for_status()
            root = ET.fromstring(r.content)
            for blob in root.iter("Blob"):
                name = blob.findtext("Name", "")
                props = blob.find("Properties")
                size = int(props.findtext("Content-Length", "0")) \
                    if props is not None else 0
                lm = props.findtext("Last-Modified", "") \
                    if props is not None else ""
                try:
                    mtime = parsedate_to_datetime(lm).timestamp() \
                        if lm else 0.0
                except (TypeError, ValueError):
                    mtime = 0.0
                etag = props.findtext("Etag", "") \
                    if props is not None else ""
                yield RemoteEntry(key=name, size=size, mtime=mtime,
                                  etag=etag)
            marker = root.findtext("NextMarker", "") or ""
            if not marker:
                return

    def head(self, key: str) -> RemoteEntry | None:
        r = self._request("HEAD", self._blob_path(key))
        if r.status_code == 404:
            return None
        r.raise_for_status()
        lm = r.headers.get("Last-Modified", "")
        try:
            mtime = parsedate_to_datetime(lm).timestamp() if lm else 0.0
        except (TypeError, ValueError):
            mtime = 0.0
        return RemoteEntry(
            key=key.lstrip("/"),
            size=int(r.headers.get("Content-Length", 0)),
            mtime=mtime, etag=r.headers.get("Etag", ""))

    def read_file(self, key: str, offset: int = 0,
                  size: int = -1) -> bytes:
        headers = {}
        if offset or size >= 0:
            end = "" if size < 0 else str(offset + size - 1)
            headers["x-ms-range"] = f"bytes={offset}-{end}"
        r = self._request("GET", self._blob_path(key), headers=headers)
        r.raise_for_status()
        return r.content

    def write_file(self, key: str, data: bytes) -> RemoteEntry:
        r = self._request(
            "PUT", self._blob_path(key),
            headers={"x-ms-blob-type": "BlockBlob",
                     "Content-Type": "application/octet-stream"},
            data=data)
        r.raise_for_status()
        import time as _time

        return RemoteEntry(key=key.lstrip("/"), size=len(data),
                           mtime=_time.time(),
                           etag=r.headers.get("Etag", ""))

    def delete_file(self, key: str) -> None:
        r = self._request("DELETE", self._blob_path(key))
        if r.status_code not in (202, 404):
            r.raise_for_status()

    def list_buckets(self) -> list[str]:
        r = self._request("GET", "/", {"comp": "list"})
        r.raise_for_status()
        root = ET.fromstring(r.content)
        return sorted(c.findtext("Name", "")
                      for c in root.iter("Container"))


register_remote("azure", AzureRemoteClient)
