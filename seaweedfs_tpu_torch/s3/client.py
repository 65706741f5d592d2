"""Low-level S3-compatible HTTP client shared by every outbound S3 use;
the counterpart of seaweedfs_tpu/s3/client.py, on the port's
`rpc.httpclient` in place of `requests`.

One place for the SigV4-vs-anonymous convention, URL building/quoting,
ranged GETs, streamed PUTs with known Content-Length, and ListObjectsV2
paging — so fixes to any of those apply to all S3 consumers at once.
Server-side verification lives in s3/auth.py; the reference's
equivalents are the aws-sdk-go wrappers under
weed/storage/backend/s3_backend and weed/remote_storage/s3. Its users
here are the remote tier: storage/backend.py S3BackendStorage (a tiered
volume's .dat) and remote_storage/ type "s3" (offloaded EC shards).

`put_stream` sends a file-like body in `httpclient.BODY_BLOCK` pieces
with its Content-Length; an object of `MULTIPART_THRESHOLD` bytes or
more goes as a multipart upload of `PART_SIZE` parts, since a gateway
refuses a request body at its cap with 413 (the reference's aiohttp
gateway caps bodies at 1 GiB, `client_max_size`, and the reference's
`put_stream` sends one PUT whatever the size). `download_to` streams
the object to a file in 4 MiB pieces. None of them holds the object
in memory.
"""
from __future__ import annotations

import hashlib
import time
import xml.etree.ElementTree as ET
from dataclasses import dataclass
from typing import Iterator
from urllib.parse import quote

from ..rpc.httpclient import session
from .sigv4_client import sign_headers

_NS = "{http://s3.amazonaws.com/doc/2006-03-01/}"
# bytes per write of download_to
DOWNLOAD_PIECE = 4 << 20
# put_stream: objects this large go as multipart uploads (the S3
# gateway's body cap, s3/server.py MAX_BODY), in parts of PART_SIZE
MULTIPART_THRESHOLD = 1 << 30
PART_SIZE = 64 << 20


@dataclass
class ObjectInfo:
    key: str
    size: int = 0
    mtime: float = 0.0
    etag: str = ""


def _parse_iso(s: str) -> float:
    from datetime import datetime
    try:
        return datetime.fromisoformat(
            s.replace("Z", "+00:00")).timestamp()
    except ValueError:
        return 0.0


class _Body:
    """`total` bytes of a file-like `reader` as a request body: the
    length gives the Content-Length, read(n) what is left of it."""

    def __init__(self, reader, total: int):
        self._reader = reader
        self.left = total

    def __len__(self) -> int:
        return self.left

    def read(self, n: int = -1) -> bytes:
        if self.left <= 0:
            return b""
        want = self.left if n is None or n < 0 else min(n, self.left)
        blob = self._reader.read(want)
        self.left -= len(blob)
        return blob


class S3Client:
    """Bucket-scoped S3 HTTP verbs. Empty access_key => anonymous
    (unsigned) requests, which is how the in-process gateway is used in
    tests."""

    def __init__(self, endpoint: str = "", bucket: str = "",
                 access_key: str = "", secret_key: str = "",
                 region: str = "us-east-1", **_):
        if not endpoint or not bucket:
            raise ValueError("s3 client needs endpoint and bucket")
        self.endpoint = endpoint.rstrip("/")
        self.bucket = bucket
        self.access_key = access_key
        self.secret_key = secret_key
        self.region = region

    def url(self, key: str = "", query: str = "") -> str:
        u = f"{self.endpoint}/{self.bucket}"
        if key:
            u += "/" + quote(key.lstrip("/"), safe="/~._-")
        if query:
            u += "?" + query
        return u

    def headers(self, method: str, url: str, payload: bytes = b"",
                unsigned_payload: bool = False) -> dict:
        if not self.access_key:
            return {}
        return sign_headers(method, url, self.access_key,
                            self.secret_key, payload=payload,
                            region=self.region,
                            unsigned_payload=unsigned_payload)

    # -- objects --------------------------------------------------------
    def get_object(self, key: str, offset: int = 0,
                   size: int = -1) -> bytes:
        if size == 0:
            return b""
        url = self.url(key)
        h = self.headers("GET", url)
        if offset or size > 0:
            end = "" if size < 0 else str(offset + size - 1)
            h["Range"] = f"bytes={offset}-{end}"
        r = session().get(url, headers=h, timeout=600)
        r.raise_for_status()
        return r.content

    def put_object(self, key: str, data: bytes) -> ObjectInfo:
        url = self.url(key)
        r = session().put(url, data=data,
                          headers=self.headers("PUT", url, payload=data),
                          timeout=600)
        r.raise_for_status()
        return ObjectInfo(
            key=key.lstrip("/"), size=len(data), mtime=time.time(),
            etag=r.headers.get(
                "ETag", hashlib.md5(data).hexdigest()).strip('"'))

    def put_stream(self, key: str, reader, total: int) -> int:
        """Streamed PUT of `total` bytes from a file-like `reader`
        (exposing read(n)); signs with UNSIGNED-PAYLOAD so the body
        isn't hashed/buffered up front, and sends a Content-Length (S3
        rejects chunked encoding without the STREAMING-* signing
        scheme). From MULTIPART_THRESHOLD bytes on, a multipart upload
        whose parts stream the same way."""
        if total >= MULTIPART_THRESHOLD:
            return self._put_multipart(key, reader, total)
        self._put_unsigned(self.url(key), _Body(reader, total))
        return total

    def _put_unsigned(self, url: str, body: _Body):
        r = session().put(
            url, data=body,
            headers=self.headers("PUT", url, unsigned_payload=True),
            timeout=3600)
        r.raise_for_status()
        return r

    def _post(self, url: str, payload: bytes = b""):
        r = session().post(url, data=payload,
                           headers=self.headers("POST", url,
                                                payload=payload),
                           timeout=600)
        r.raise_for_status()
        return r

    def _put_multipart(self, key: str, reader, total: int) -> int:
        """CreateMultipartUpload, UploadPart per PART_SIZE of the
        reader, CompleteMultipartUpload; aborted on any failure."""
        r = self._post(self.url(key, "uploads"))
        upload_id = ET.fromstring(r.content).findtext(f"{_NS}UploadId")
        if not upload_id:
            raise ValueError(f"no UploadId for {key}: {r.text[:200]}")
        uid = quote(upload_id, safe="~._-")
        try:
            parts = []
            for number, off in enumerate(range(0, total, PART_SIZE), 1):
                body = _Body(reader, min(PART_SIZE, total - off))
                r = self._put_unsigned(self.url(
                    key, f"partNumber={number}&uploadId={uid}"), body)
                parts.append((number, r.headers.get("ETag", "")))
            done = "".join(
                f"<Part><PartNumber>{n}</PartNumber><ETag>{etag}</ETag>"
                "</Part>" for n, etag in parts)
            self._post(self.url(key, f"uploadId={uid}"),
                       (f"<CompleteMultipartUpload>{done}"
                        "</CompleteMultipartUpload>").encode())
        except BaseException:
            url = self.url(key, f"uploadId={uid}")
            try:
                session().delete(url, headers=self.headers("DELETE", url),
                                 timeout=60)
            except OSError:
                pass
            raise
        return total

    def head_object(self, key: str) -> ObjectInfo | None:
        url = self.url(key)
        r = session().head(url, headers=self.headers("HEAD", url),
                           timeout=60)
        if r.status_code == 404:
            return None
        r.raise_for_status()
        return ObjectInfo(
            key=key.lstrip("/"),
            size=int(r.headers.get("Content-Length", 0)),
            etag=r.headers.get("ETag", "").strip('"'))

    def delete_object(self, key: str) -> None:
        url = self.url(key)
        r = session().delete(url, headers=self.headers("DELETE", url),
                             timeout=300)
        if r.status_code >= 300 and r.status_code != 404:
            r.raise_for_status()

    def download_to(self, key: str, dest_path: str) -> int:
        url = self.url(key)
        r = session().get(url, headers=self.headers("GET", url),
                          stream=True, timeout=3600)
        try:
            r.raise_for_status()
            n = 0
            with open(dest_path, "wb") as out:
                for blob in r.iter_content(DOWNLOAD_PIECE):
                    out.write(blob)
                    n += len(blob)
        finally:
            r.close()
        return n

    # -- listing --------------------------------------------------------
    def list_buckets(self) -> list[str]:
        """Service-level ListBuckets (ignores this client's bucket
        scope) — remote.mount.buckets discovery."""
        url = f"{self.endpoint}/"
        r = session().get(url, headers=self.headers("GET", url),
                          timeout=300)
        r.raise_for_status()
        root = ET.fromstring(r.text)
        return [n.text for n in root.iter(f"{_NS}Name") if n.text]

    def list_objects(self, prefix: str = "") -> Iterator[ObjectInfo]:
        """ListObjectsV2 with continuation-token paging."""
        token = ""
        while True:
            q = "list-type=2&max-keys=1000"
            if prefix:
                q += f"&prefix={quote(prefix.lstrip('/'), safe='~._-')}"
            if token:
                q += "&continuation-token=" + \
                    quote(token, safe="~._-")
            url = self.url(query=q)
            r = session().get(url, headers=self.headers("GET", url),
                              timeout=300)
            r.raise_for_status()
            root = ET.fromstring(r.text)
            for c in root.iter(f"{_NS}Contents"):
                yield ObjectInfo(
                    key=c.find(f"{_NS}Key").text,
                    size=int(c.find(f"{_NS}Size").text or 0),
                    mtime=_parse_iso(
                        c.findtext(f"{_NS}LastModified") or ""),
                    etag=(c.findtext(f"{_NS}ETag") or "").strip('"'))
            if (root.findtext(f"{_NS}IsTruncated") or "") != "true":
                return
            token = root.findtext(f"{_NS}NextContinuationToken") or ""
            if not token:
                return
