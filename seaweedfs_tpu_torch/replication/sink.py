"""Replication sinks: where filer metadata events get mirrored; the
counterpart of seaweedfs_tpu/replication/sink.py, on rpc/httpclient
instead of `requests`.

Equivalent of SeaweedFS weed/replication/sink/: filersink, localsink,
s3sink, plus gcssink/azuresink over the in-tree REST remote clients
and b2sink over the native B2 API — every cloud sink speaks its real
wire protocol, no SDKs. A sink receives entry lifecycle callbacks;
file content is provided by a reader callable so sinks don't need to
know the source's chunk layout.
"""
from __future__ import annotations

import hashlib
import os
import shutil
import time
import urllib.parse
from typing import Callable

from ..filer.entry import Entry
from ..rpc.httpclient import Response, basic_auth, session

DataReader = Callable[[], bytes]


def _prefixed_key(prefix: str, path: str) -> str:
    """Object key for a filer path under an optional key prefix —
    shared by every flat-keyspace sink."""
    key = path.lstrip("/")
    return f"{prefix}/{key}" if prefix else key


class ReplicationSink:
    name = "base"

    def create_entry(self, path: str, entry: Entry,
                     read_data: DataReader) -> None:
        raise NotImplementedError

    def update_entry(self, path: str, entry: Entry,
                     read_data: DataReader) -> None:
        self.create_entry(path, entry, read_data)

    def delete_entry(self, path: str, is_directory: bool) -> None:
        raise NotImplementedError


class FilerSink(ReplicationSink):
    """Mirror into another filer over its HTTP API
    (replication/sink/filersink/)."""

    name = "filer"

    def __init__(self, filer_url: str, dest_path: str = "/",
                 signature: int = 0):
        self.filer_url = filer_url.rstrip("/") \
            if filer_url.startswith("http") else f"http://{filer_url}"
        self.dest = dest_path.rstrip("/")
        # signature of the SOURCE filer: carried on writes so the
        # target's events name the origin (active-active loop guard)
        self.signature = signature

    def _url(self, path: str) -> str:
        return f"{self.filer_url}{self.dest}{path}"

    def _params(self) -> dict:
        return {"signatures": str(self.signature)} if self.signature \
            else {}

    def create_entry(self, path: str, entry: Entry,
                     read_data: DataReader) -> None:
        if entry.is_directory:
            session().put(self._url(path),
                          params={"mkdir": "1", **self._params()},
                          timeout=30).raise_for_status()
            return
        r = session().put(self._url(path), data=read_data(),
                          params=self._params(),
                          headers={"Content-Type": entry.mime or
                                   "application/octet-stream"},
                          timeout=300)
        r.raise_for_status()

    def delete_entry(self, path: str, is_directory: bool) -> None:
        params = {"recursive": "true", **self._params()}
        session().delete(self._url(path), params=params, timeout=60)


class LocalSink(ReplicationSink):
    """Mirror into a local directory (replication/sink/localsink/)."""

    name = "local"

    def __init__(self, directory: str):
        self.dir = directory
        os.makedirs(directory, exist_ok=True)

    def _path(self, path: str) -> str:
        return os.path.join(self.dir, path.lstrip("/"))

    def create_entry(self, path: str, entry: Entry,
                     read_data: DataReader) -> None:
        target = self._path(path)
        if entry.is_directory:
            os.makedirs(target, exist_ok=True)
            return
        os.makedirs(os.path.dirname(target), exist_ok=True)
        tmp = target + ".tmp"
        with open(tmp, "wb") as f:
            f.write(read_data())
        os.replace(tmp, target)

    def delete_entry(self, path: str, is_directory: bool) -> None:
        target = self._path(path)
        try:
            if is_directory:
                shutil.rmtree(target, ignore_errors=True)
            else:
                os.remove(target)
        except FileNotFoundError:
            pass


class S3Sink(ReplicationSink):
    """Mirror into an S3-compatible endpoint (replication/sink/s3sink/).
    Targets this build's own gateway or any endpoint that accepts
    anonymous/open PUTs; SigV4 credentials optional."""

    name = "s3"

    def __init__(self, endpoint: str, bucket: str, prefix: str = "",
                 access_key: str = "", secret_key: str = ""):
        self.endpoint = endpoint.rstrip("/") \
            if endpoint.startswith("http") else f"http://{endpoint}"
        self.bucket = bucket
        self.prefix = prefix.strip("/")
        self.access_key = access_key
        self.secret_key = secret_key

    def _key(self, path: str) -> str:
        return _prefixed_key(self.prefix, path)

    def _headers(self, method: str, url: str, payload: bytes) -> dict:
        if not self.access_key:
            return {}
        from ..s3.sigv4_client import sign_headers

        return sign_headers(method, url, self.access_key,
                            self.secret_key, payload)

    def create_entry(self, path: str, entry: Entry,
                     read_data: DataReader) -> None:
        if entry.is_directory:
            return  # keys are flat
        url = f"{self.endpoint}/{self.bucket}/{self._key(path)}"
        data = read_data()
        r = session().put(url, data=data,
                          headers=self._headers("PUT", url, data),
                          timeout=300)
        r.raise_for_status()

    def delete_entry(self, path: str, is_directory: bool) -> None:
        if is_directory:
            return
        url = f"{self.endpoint}/{self.bucket}/{self._key(path)}"
        session().delete(url, headers=self._headers("DELETE", url, b""),
                         timeout=60)


class _RemoteClientSink(ReplicationSink):
    """Sink over a RemoteStorageClient: GCS and Azure replicate
    through the same in-tree REST clients the remote-mount tier uses
    (gcs_storage_client.go / azure_storage_client.go are likewise
    shared by the reference's sinks)."""

    def __init__(self, client, prefix: str = ""):
        self._c = client
        self.prefix = prefix.strip("/")

    def _key(self, path: str) -> str:
        return _prefixed_key(self.prefix, path)

    def create_entry(self, path: str, entry: Entry,
                     read_data: DataReader) -> None:
        if entry.is_directory:
            return  # object keys are flat
        self._c.write_file(self._key(path), read_data())

    def delete_entry(self, path: str, is_directory: bool) -> None:
        if is_directory:
            return
        self._c.delete_file(self._key(path))


class GcsSink(_RemoteClientSink):
    """replication/sink/gcssink/gcs_sink.go:18 over the JSON API."""

    name = "gcs"

    def __init__(self, bucket: str, prefix: str = "", **conf):
        from ..remote_storage.gcs_client import GcsRemoteClient

        super().__init__(GcsRemoteClient(bucket=bucket, **conf), prefix)


class AzureSink(_RemoteClientSink):
    """replication/sink/azuresink/azure_sink.go:20 over Blob REST."""

    name = "azure"

    def __init__(self, container: str, prefix: str = "", **conf):
        from ..remote_storage.azure_client import AzureRemoteClient

        super().__init__(AzureRemoteClient(container=container, **conf),
                         prefix)


class B2Sink(ReplicationSink):
    """replication/sink/b2sink/b2_sink.go:17 over the native B2 API
    (b2_authorize_account / b2_get_upload_url / b2_upload_file /
    b2_hide_file) — no blazer SDK. The account authorization is the
    `Authorization: Basic` header `requests` builds for auth=."""

    name = "b2"

    def __init__(self, bucket: str, key_id: str, application_key: str,
                 prefix: str = "",
                 api_base: str = "https://api.backblazeb2.com"):
        self.bucket_name = bucket
        self.prefix = prefix.strip("/")
        self._key_id = key_id
        self._app_key = application_key
        self._api_base = api_base.rstrip("/")
        self._authorize()
        r = self._api("b2_list_buckets",
                      {"accountId": self.account_id,
                       "bucketName": bucket})
        buckets = r.json().get("buckets", [])
        if not buckets:
            raise KeyError(f"b2 bucket {bucket!r} not found")
        self.bucket_id = buckets[0]["bucketId"]

    def _authorize(self) -> None:
        r = session().get(
            f"{self._api_base}/b2api/v2/b2_authorize_account",
            headers={"Authorization": basic_auth(self._key_id,
                                                 self._app_key)},
            timeout=30)
        r.raise_for_status()
        d = r.json()
        self.api_url = d["apiUrl"].rstrip("/")
        self.token = d["authorizationToken"]
        self.account_id = d["accountId"]

    def _api(self, verb: str, body: dict) -> Response:
        """POST a b2api call; a 401 re-authorizes once (B2 tokens
        expire within 24h — a long-running replicator must renew)."""
        for attempt in (0, 1):
            r = session().post(
                f"{self.api_url}/b2api/v2/{verb}", json=body,
                headers={"Authorization": self.token}, timeout=60)
            if r.status_code == 401 and attempt == 0:
                self._authorize()
                continue
            return r
        return r

    def _key(self, path: str) -> str:
        return _prefixed_key(self.prefix, path)

    def create_entry(self, path: str, entry: Entry,
                     read_data: DataReader) -> None:
        if entry.is_directory:
            return
        data = read_data()
        # B2's documented contract: uploads ROUTINELY fail with 503
        # (pod busy) or 401 (expired upload token) and the client must
        # fetch a fresh upload URL and retry — blazer, which the
        # reference uses, does exactly this
        for attempt in range(3):
            r = self._api("b2_get_upload_url",
                          {"bucketId": self.bucket_id})
            if r.status_code == 503 and attempt < 2:
                time.sleep(0.2 * (attempt + 1))
                continue
            r.raise_for_status()
            up = r.json()
            r = session().post(
                up["uploadUrl"], data=data, headers={
                    "Authorization": up["authorizationToken"],
                    "X-Bz-File-Name": urllib.parse.quote(
                        self._key(path)),
                    "Content-Type": entry.mime or "b2/x-auto",
                    "X-Bz-Content-Sha1": hashlib.sha1(data).hexdigest(),
                }, timeout=300)
            if r.status_code in (401, 503) and attempt < 2:
                time.sleep(0.2 * (attempt + 1))
                continue
            r.raise_for_status()
            return

    def delete_entry(self, path: str, is_directory: bool) -> None:
        if is_directory:
            return
        r = self._api("b2_hide_file",
                      {"bucketId": self.bucket_id,
                       "fileName": self._key(path)})
        if r.status_code == 200:
            return
        try:
            code = r.json().get("code")
        except ValueError:  # non-JSON error body (proxy, LB)
            code = None
        if code not in ("no_such_file", "already_hidden"):
            r.raise_for_status()


def make_sink(kind: str, **kwargs) -> ReplicationSink:
    sinks = {"filer": FilerSink, "local": LocalSink, "s3": S3Sink,
             "gcs": GcsSink, "azure": AzureSink, "b2": B2Sink}
    if kind not in sinks:
        raise KeyError(f"unknown sink {kind!r}; have {sorted(sinks)}")
    return sinks[kind](**kwargs)
