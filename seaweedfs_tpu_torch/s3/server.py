"""S3 REST gateway over the filer; the counterpart of
seaweedfs_tpu/s3/server.py, with its core API.

Equivalent of SeaweedFS weed/s3api/s3api_server.go:47-150 (router) and
its handler files: bucket CRUD (s3api_bucket_handlers.go), object CRUD
+ copy (s3api_object_handlers*.go), ListObjects V1/V2
(s3api_objects_list_handlers.go), multipart (filer_multipart.go,
s3api_object_multipart_handlers.go), batch delete, SigV4 auth
(auth_signature_v4.go, s3/auth.py).

Buckets live at /buckets/<name> in the filer namespace and map to a
storage collection of the same name, exactly like the reference.
Multipart parts are staged under /buckets/<bucket>/.uploads/<id>/ and
stitched into the final object by a metadata-only entry create — the
bytes never move. A request body is read whole (SigV4 signs its
sha256), up to the reference's 1 GiB cap: a body that declares 1 GiB or
more is refused with 413 before a byte of it is read. A GET streams the
filer's reply through, so an object is never held whole in the gateway.

One departure, a fix: a completed multipart upload's ETag (md5 of
the parts' md5s, then -N) is kept on the object as `s3_etag`, and GET,
HEAD and the listings answer it. The reference answers the filer's ETag
there, which is ETagChunks of the object's chunks: the same value only
while every part fits one filer chunk (8 MiB). An object of 1 GiB or
more comes as a multipart upload (s3/client.py `put_stream` sends one).

Every route runs behind the tracing, deadline (an edge server: it
mints the budget when the client sent none) and fault middlewares
(rpc/http.server_middlewares); /debug/traces and /debug/breakers serve
this process's spans and breakers.

Identities and the circuit breaker's limits load from the filer's KV
(`s3/identities`, `s3/circuit_breaker`) at start and every
`identity_refresh_seconds` on a thread, which `stop` joins.

Admission, in the reference's order: per-tenant qos (utils/qos.py; the
tenant is the request's access key, read without verifying it) between
the deadline and the fault middlewares, then the circuit breaker
(s3/circuit_breaker.py, s3api_circuit_breaker.go) by the declared body
length BEFORE the body is read: over a limit answers 503
TooManyRequests, and while limits are on a PUT or POST that declares no
length answers 411 MissingContentLength (a DELETE carries none and
keeps working). /debug/qos serves the qos registry; /metrics exports
the tenants' demand gauges.

Not here, each answering S3's NotImplemented (501): bucket ACL, policy,
CORS, lifecycle and ownership controls; object ACL, tagging, retention,
legal hold and object lock; SelectObjectContent; POST-policy (browser
form) uploads. Nor the event stream.

The native front (s3/native_front.py, `-s3.native`) owns the public
port when it runs: this app then serves on a loopback backend port
what the front relays, and /status carries `native_s3_front`.
"""
from __future__ import annotations

import hashlib
import json
import re
import threading
import time
import urllib.parse
import uuid
import xml.etree.ElementTree as ET

from ..filer.entry import entry_size
from ..rpc.http import (App, Request, Response, debug_index_factory,
                        json_response, server_middlewares, text_response)
from ..rpc.httpclient import RequestException, session
from ..utils import extheaders, glog, metrics, qos, retry, tracing
from .auth import (ACTION_ADMIN, ACTION_LIST, ACTION_READ, ACTION_WRITE,
                   IdentityAccessManagement, S3AuthError)
from .circuit_breaker import CircuitBreaker, CircuitOpen

XMLNS = "http://s3.amazonaws.com/doc/2006-03-01/"
BUCKETS_DIR = "/buckets"
UPLOADS_DIR = ".uploads"
IDENTITIES_KV_KEY = "s3/identities"  # filer KV key holding the config
CIRCUIT_BREAKER_KV_KEY = "s3/circuit_breaker"  # limits, hot-reloaded
# bytes per piece of a streamed GET
STREAM_PIECE = 1 << 20
# how long stop waits for the identity reload thread
JOIN_TIMEOUT = 10.0
# the reference app's client_max_size: bodies are buffered for SigV4
# payload hashing; larger objects go through multipart parts
MAX_BODY = 1 << 30


class S3Error(Exception):
    def __init__(self, code: str, message: str, status: int):
        super().__init__(message)
        self.code = code
        self.status = status


ERR_NO_SUCH_BUCKET = ("NoSuchBucket", "bucket does not exist", 404)
ERR_NO_SUCH_KEY = ("NoSuchKey", "key does not exist", 404)
ERR_BUCKET_NOT_EMPTY = ("BucketNotEmpty", "bucket is not empty", 409)
ERR_BUCKET_EXISTS = ("BucketAlreadyExists", "bucket already exists", 409)
ERR_NO_SUCH_UPLOAD = ("NoSuchUpload", "upload id not found", 404)
ERR_NOT_IMPLEMENTED = ("NotImplemented",
                       "this sub-resource is not implemented", 501)

# sub-resources the reference routes that the port answers 501
_BUCKET_UNPORTED = ("policy", "cors", "acl", "lifecycle",
                    "ownershipControls")
_OBJECT_UNPORTED = ("tagging", "acl", "retention", "legal-hold",
                    "object-lock", "select")


def _xml(tag: str, *children, text: str | None = None,
         ns: bool = True) -> ET.Element:
    el = ET.Element(tag)
    if ns:
        el.set("xmlns", XMLNS)
    if text is not None:
        el.text = text
    for c in children:
        el.append(c)
    return el


def _leaf(tag: str, text) -> ET.Element:
    el = ET.Element(tag)
    el.text = str(text)
    return el


def _find(el: ET.Element, tag: str) -> ET.Element | None:
    """Find a child with or without the S3 namespace. (`find(a) or
    find(b)` is wrong — childless Elements are falsy.)"""
    found = el.find(tag)
    if found is None:
        found = el.find(f"{{{XMLNS}}}{tag}")
    return found


def _xml_response(root: ET.Element, status: int = 200) -> Response:
    body = b'<?xml version="1.0" encoding="UTF-8"?>\n' + \
        ET.tostring(root)
    return Response(body, status, content_type="application/xml")


def _error_response(code: str, message: str, status: int,
                    resource: str = "") -> Response:
    root = _xml("Error", ns=False)
    root.append(_leaf("Code", code))
    root.append(_leaf("Message", message))
    root.append(_leaf("Resource", resource))
    return _xml_response(root, status)


def _src_bucket_of(src: str) -> str:
    """Bucket name out of an x-amz-copy-source header value."""
    return urllib.parse.unquote(src.lstrip("/")).partition("/")[0]


def _iso(ts: float) -> str:
    return time.strftime("%Y-%m-%dT%H:%M:%S.000Z", time.gmtime(ts))


def _etag_from_chunks(meta: dict) -> str:
    """ETagChunks fallback (weed/filer/filechunks.go) for entries the
    filer stored without a whole-stream md5."""
    chunks = meta.get("chunks") or []
    if len(chunks) == 1:
        return chunks[0].get("etag", "")
    joined = b"".join(bytes.fromhex(c["etag"])
                      for c in chunks if c.get("etag"))
    if not joined:
        return ""
    return f"{hashlib.md5(joined).hexdigest()}-{len(chunks)}"


def _entry_etag(meta: dict) -> str:
    """An object's S3 ETag: the multipart ETag where the upload was
    completed here, else the filer's md5, else ETagChunks."""
    return (meta.get("extended") or {}).get("s3_etag") \
        or meta.get("md5", "") or _etag_from_chunks(meta)


# standard header names aiohttp's parser hands the reference in their
# canonical spelling whatever the client sent (other names keep the
# client's case); auth looks some of them up by that spelling
_CANONICAL = {h.lower(): h for h in (
    "Accept", "Accept-Encoding", "Authorization", "Connection",
    "Content-Encoding", "Content-Length", "Content-MD5", "Content-Type",
    "Date", "Expect", "Host", "Range", "Transfer-Encoding", "User-Agent")}


def _header_dict(req: Request) -> dict[str, str]:
    return {_CANONICAL.get(k.lower(), k): v for k, v in req.headers.items()}


class S3ApiServer:
    def __init__(self, filer_url: str, iam_config: dict | None = None,
                 region: str = "us-east-1",
                 identity_refresh_seconds: float = 5.0,
                 circuit_breaker_config: dict | None = None):
        self.filer_url = filer_url.rstrip("/")
        self.region = region
        self.iam = IdentityAccessManagement(iam_config)
        self.identity_refresh_seconds = identity_refresh_seconds
        self.circuit_breaker = CircuitBreaker(circuit_breaker_config)
        self._load_identities_from_filer()
        # bucket metadata cache: a short TTL + invalidation on local
        # bucket mutations (the reference's s3api_bucket_registry role)
        self._bucket_meta_cache: dict[str, tuple[dict, float]] = {}
        self._cache_lock = threading.Lock()
        self._stop = threading.Event()
        self._reload: threading.Thread | None = None
        # the native S3 front (s3/native_front.py) when one owns the
        # public port; /status then carries its counters
        self._native_front = None
        self.app = self._build_app()
        self.app.on_startup.append(self._start_reload)
        self.app.on_cleanup.append(self._stop_reload)

    # -- lifecycle ------------------------------------------------------
    def _start_reload(self) -> None:
        """Hot reload of filer-stored identities (the reference reloads
        via metadata subscription, auth_credentials_subscribe.go)."""
        self._stop.clear()
        self._reload = threading.Thread(target=self._reload_loop,
                                        name="s3-identities", daemon=True)
        self._reload.start()

    def _stop_reload(self) -> None:
        self._stop.set()
        if self._reload is not None:
            self._reload.join(timeout=JOIN_TIMEOUT)
            self._reload = None

    def _reload_loop(self) -> None:
        while not self._stop.wait(self.identity_refresh_seconds):
            try:
                self._load_identities_from_filer()
            except (ValueError, KeyError, TypeError) as e:
                # malformed KV content must not end the reload loop —
                # revocations have to keep propagating once it is fixed
                glog.warning("s3: identities in the filer: %s", e)

    def _load_identities_from_filer(self) -> None:
        """Pick up s3.configure-style identities stored in the filer
        (auth_credentials_subscribe.go's role), and the circuit
        breaker's limits (the reference's SeaweedFS keeps them at
        /etc/s3/circuit_breaker.json, reloaded the same way)."""
        try:
            resp = session().get(
                f"{self.filer_url}/kv/{IDENTITIES_KV_KEY}", timeout=5)
            if resp.status_code == 200:
                self.iam.load_config(json.loads(resp.content))
        except RequestException:
            pass
        try:
            resp = session().get(
                f"{self.filer_url}/kv/{CIRCUIT_BREAKER_KV_KEY}", timeout=5)
            if resp.status_code == 200:
                self.circuit_breaker.load_config(json.loads(resp.content))
        except RequestException:
            pass

    def _build_app(self) -> App:
        app = App(middlewares=server_middlewares(
                      "s3", edge=True, qos_tenant=qos.s3_tenant),
                  max_body=MAX_BODY)
        app.get("/status", self.handle_status)
        app.get("/metrics", self.handle_metrics)
        # /debug index BEFORE the catch-all dispatch, or it would be
        # parsed as a bucket name
        app.get("/debug", debug_index_factory("s3", {
            "/status": "the filer and whether access is open",
            "/metrics": "Prometheus text exposition",
            "/debug/traces": "recent spans recorded in-process",
            "/debug/breakers": "circuit breaker states",
            "/debug/qos": "per-tenant admission buckets + shed counts",
        }))
        app.get("/debug/traces", tracing.handle_debug_traces)
        app.get("/debug/breakers", retry.handle_debug_breakers)
        app.get("/debug/qos", qos.handle_debug_qos)
        app.route("*", "/{tail:.*}", self.dispatch)
        return app

    def handle_status(self, req: Request) -> Response:
        out = {"filer": self.filer_url, "open": self.iam.is_open}
        front = self._native_front
        if front is not None:
            out["native_s3_front"] = front.stats()
        return json_response(out)

    def handle_metrics(self, req: Request) -> Response:
        # per-tenant demand sketches -> workload_tenant_* gauges: tenant
        # demand rides the federation to the master's aggregator
        qos.export_demand_metrics()
        return text_response(metrics.render(),
                             content_type="text/plain; version=0.0.4")

    # -- auth + dispatch ------------------------------------------------
    def dispatch(self, req: Request) -> Response:
        """Error mapping and request metrics around the dispatch (the
        reference's error middleware; the route keeps its handler's
        name, which names its server span)."""
        start = time.perf_counter()
        code = "500"
        try:
            try:
                resp = self._dispatch(req)
            except (S3Error, S3AuthError) as e:
                resp = _error_response(e.code, str(e), e.status, req.path)
            except (KeyError, ValueError, ET.ParseError) as e:
                resp = _error_response("InvalidRequest", str(e), 400,
                                       req.path)
            code = str(resp.status)
            return resp
        finally:
            metrics.histogram_observe(
                "s3_request_seconds", time.perf_counter() - start,
                labels={"method": req.method})
            metrics.counter_add("s3_requests_total", labels={
                "method": req.method, "code": code})

    def _dispatch(self, req: Request) -> Response:
        tail = req.match_info["tail"]
        bucket, _, key = tail.partition("/")
        cb_action = "write" if req.method in ("PUT", "POST", "DELETE") \
            else "read"
        # the breaker is taken BEFORE the body is read, by its declared
        # length: writeBytes exists to stop concurrent uploads from
        # ballooning the gateway's memory, so it gates the read itself.
        # A write with no declared length could evade a byte limit:
        # demand one, as AWS does (411) for PUTs
        declared = req.content_length
        if declared is None:
            decoded = req.headers.get("x-amz-decoded-content-length")
            if decoded and decoded.isdigit():
                declared = int(decoded)  # streaming-signed uploads
        if declared is None and req.method in ("PUT", "POST") and \
                self.circuit_breaker.enabled:
            # body-carrying verbs only: a DELETE has no Content-Length
            # and keeps working under limits
            raise S3Error("MissingContentLength",
                          "uploads must declare a content length", 411)
        try:
            with self.circuit_breaker.acquire(cb_action, bucket,
                                              declared or 0):
                # refused with 413 before it is read when it declares
                # the cap
                payload = req.read()
                return self._dispatch_authed(req, bucket, key, payload)
        except CircuitOpen as e:
            # s3api_circuit_breaker.go rejects with TooManyRequests
            raise S3Error("TooManyRequests", str(e), 503) from None

    def _dispatch_authed(self, req: Request, bucket: str, key: str,
                         payload: bytes) -> Response:
        if req.method == "POST" and bucket and not key \
                and req.content_type.startswith("multipart/form-data"):
            # browser form upload (POST policy)
            raise S3Error("NotImplemented",
                          "POST-policy form uploads are not implemented",
                          501)
        identity, stream_ctx = self.iam.authenticate_ctx(
            req.method, req.path, dict(req.query), _header_dict(req),
            hashlib.sha256(payload).hexdigest())
        if stream_ctx is not None:
            # aws-chunked framed body (SigV4 streaming upload): verify
            # the chunk-signature chain and unwrap to the real bytes
            payload = stream_ctx.decode(payload)

        def check(action: str, target: str | None = None):
            b = bucket if target is None else target
            if identity is not None and not identity.allows(action, b):
                raise S3Error("AccessDenied",
                              f"{action} denied on {b}", 403)

        q = req.query
        if not bucket:
            check(ACTION_LIST)
            return self._list_buckets()
        if not key:
            return self._bucket_op(req, bucket, q, payload, check)
        return self._object_op(req, bucket, key, q, payload, check)

    def _bucket_op(self, req, bucket, q, payload, check) -> Response:
        m = req.method
        if any(sub in q for sub in _BUCKET_UNPORTED):
            raise S3Error(*ERR_NOT_IMPLEMENTED)
        if m == "PUT":
            check(ACTION_ADMIN)
            return self._put_bucket(bucket)
        if m == "DELETE":
            check(ACTION_ADMIN)
            return self._delete_bucket(bucket)
        if m == "HEAD":
            check(ACTION_READ)
            self._require_bucket(bucket)
            return Response(status=200)
        if m == "POST" and "delete" in q:
            check(ACTION_WRITE)
            return self._delete_objects(bucket, payload)
        if m == "GET":
            check(ACTION_LIST)
            self._require_bucket(bucket)
            if "uploads" in q:
                return self._list_multipart_uploads(bucket)
            if "location" in q:
                return _xml_response(_xml("LocationConstraint",
                                          text=self.region))
            if "requestPayment" in q:
                root = _xml("RequestPaymentConfiguration")
                root.append(_leaf("Payer", "BucketOwner"))
                return _xml_response(root)
            return self._list_objects(bucket, q)
        raise S3Error("MethodNotAllowed", f"{m} on bucket", 405)

    def _object_op(self, req, bucket, key, q, payload, check) -> Response:
        m = req.method
        if m == "POST" and "uploads" in q:
            check(ACTION_WRITE)
            return self._initiate_multipart(bucket, key, req)
        if m == "POST" and "uploadId" in q:
            check(ACTION_WRITE)
            return self._complete_multipart(bucket, key, q["uploadId"],
                                            payload)
        if m == "DELETE" and "uploadId" in q:
            check(ACTION_WRITE)
            return self._abort_multipart(bucket, q["uploadId"])
        if m == "PUT" and "partNumber" in q:
            check(ACTION_WRITE)
            src = req.headers.get("x-amz-copy-source", "")
            if src:
                # copying reads the SOURCE bucket: the writer identity
                # must hold Read there too
                check(ACTION_READ, _src_bucket_of(src))
                return self._upload_part_copy(
                    bucket, q["uploadId"], int(q["partNumber"]), src,
                    req.headers.get("x-amz-copy-source-range", ""))
            return self._upload_part(bucket, q["uploadId"],
                                     int(q["partNumber"]), payload)
        if m == "GET" and "uploadId" in q:
            check(ACTION_READ)
            return self._list_parts(bucket, key, q["uploadId"])
        if any(sub in q for sub in _OBJECT_UNPORTED):
            raise S3Error(*ERR_NOT_IMPLEMENTED)
        if m == "PUT":
            check(ACTION_WRITE)
            src = req.headers.get("x-amz-copy-source", "")
            if src:
                check(ACTION_READ, _src_bucket_of(src))
                return self._copy_object(bucket, key, src, req)
            return self._put_object(bucket, key, payload, req)
        if m in ("GET", "HEAD"):
            check(ACTION_READ)
            return self._get_object(bucket, key, req)
        if m == "DELETE":
            check(ACTION_WRITE)
            return self._delete_object(bucket, key)
        raise S3Error("MethodNotAllowed", f"{m} on object", 405)

    # -- filer helpers --------------------------------------------------
    def _fpath(self, bucket: str, key: str = "") -> str:
        p = f"{self.filer_url}{BUCKETS_DIR}/{bucket}"
        if key:
            p += "/" + urllib.parse.quote(key)
        return p

    @staticmethod
    def _filer(method: str, url: str, **kw):
        kw.setdefault("timeout", (5.0, 120.0))
        return session().request(method, url, **kw)

    _BUCKET_TTL = 2.0

    def _invalidate_bucket(self, bucket: str) -> None:
        with self._cache_lock:
            self._bucket_meta_cache.pop(bucket, None)

    def _require_bucket(self, bucket: str) -> dict:
        now = time.monotonic()
        with self._cache_lock:
            hit = self._bucket_meta_cache.get(bucket)
        if hit is not None and now - hit[1] < self._BUCKET_TTL:
            return hit[0]
        resp = self._filer("GET", self._fpath(bucket),
                           params={"meta": "1"})
        if resp.status_code != 200:
            self._invalidate_bucket(bucket)  # only EXISTENCE is cached
            raise S3Error(*ERR_NO_SUCH_BUCKET)
        meta = resp.json()
        with self._cache_lock:
            self._bucket_meta_cache[bucket] = (meta, now)
        return meta

    def _entry_meta(self, bucket: str, key: str) -> dict:
        resp = self._filer("GET", self._fpath(bucket, key),
                           params={"meta": "1"})
        if resp.status_code != 200:
            raise S3Error(*ERR_NO_SUCH_KEY)
        return resp.json()

    # -- service / bucket -----------------------------------------------
    def _list_buckets(self) -> Response:
        resp = self._filer("GET", self.filer_url + BUCKETS_DIR + "/")
        entries = resp.json().get("entries", []) \
            if resp.status_code == 200 else []
        buckets = ET.Element("Buckets")
        for e in entries:
            if not (e["mode"] & 0o40000):
                continue
            b = ET.Element("Bucket")
            b.append(_leaf("Name", e["full_path"].rsplit("/", 1)[-1]))
            b.append(_leaf("CreationDate", _iso(e.get("crtime", 0))))
            buckets.append(b)
        owner = ET.Element("Owner")
        owner.append(_leaf("ID", "seaweedfs_tpu"))
        return _xml_response(_xml("ListAllMyBucketsResult", owner,
                                  buckets))

    def _put_bucket(self, bucket: str) -> Response:
        resp = self._filer("GET", self._fpath(bucket),
                           params={"meta": "1"})
        if resp.status_code == 200:
            raise S3Error(*ERR_BUCKET_EXISTS)
        self._filer("POST", self._fpath(bucket) + "/",
                    params={"mkdir": "1"})
        self._invalidate_bucket(bucket)
        return Response(status=200, headers={"Location": f"/{bucket}"})

    def _delete_bucket(self, bucket: str) -> Response:
        self._require_bucket(bucket)
        # .uploads sorts first, so one extra slot is needed to see a
        # real object behind an in-progress multipart upload
        listing = self._filer("GET", self._fpath(bucket) + "/",
                              params={"limit": "2"})
        entries = listing.json().get("entries", [])
        if any(e["full_path"].rsplit("/", 1)[-1] != UPLOADS_DIR
               for e in entries):
            raise S3Error(*ERR_BUCKET_NOT_EMPTY)
        self._filer("DELETE", self._fpath(bucket),
                    params={"recursive": "true"})
        self._invalidate_bucket(bucket)
        return Response(status=204)

    def _delete_objects(self, bucket: str, payload: bytes) -> Response:
        root = ET.fromstring(payload)
        deleted, errors = [], []
        for obj in root.iter():
            if not obj.tag.endswith("Object"):
                continue
            key_el = _find(obj, "Key")
            if key_el is None or not key_el.text:
                continue
            key = key_el.text
            resp = self._filer("DELETE", self._fpath(bucket, key))
            if resp.status_code in (204, 404):
                deleted.append(key)
            else:
                errors.append(key)
        out = _xml("DeleteResult")
        for k in deleted:
            d = ET.Element("Deleted")
            d.append(_leaf("Key", k))
            out.append(d)
        for k in errors:
            e = ET.Element("Error")
            e.append(_leaf("Key", k))
            e.append(_leaf("Code", "InternalError"))
            out.append(e)
        return _xml_response(out)

    # -- object ---------------------------------------------------------
    def _put_object(self, bucket: str, key: str, payload: bytes,
                    req: Request) -> Response:
        self._require_bucket(bucket)
        if key.endswith("/") and not payload:
            self._filer("POST", self._fpath(bucket, key),
                        params={"mkdir": "1"})
            return Response(status=200)
        # fullmd5: AWS-exact single-PUT ETag (md5 of the whole body)
        # even when the filer autochunks a large payload
        params = {"collection": bucket, "fullmd5": "1"}
        mime = req.headers.get("Content-Type", "")
        headers = {"Content-Type": mime} if mime else {}
        # x-amz-meta-* rides the SAME filer create as the chunks
        # (x-seaweed-ext-*: SaveAmzMetaData, s3api_object_handlers_put.go)
        for k, v in req.headers.items():
            if k.lower().startswith("x-amz-meta-"):
                if not v.isascii():
                    raise S3Error(
                        "InvalidArgument",
                        f"x-amz-meta-* values must be US-ASCII ({k})", 400)
                name = k.lower()[len("x-amz-meta-"):]
                headers[f"x-seaweed-ext-s3_meta_{name}"] = \
                    extheaders.armor(v)
        resp = self._filer("POST", self._fpath(bucket, key),
                           params=params, data=payload, headers=headers)
        if resp.status_code >= 300:
            raise S3Error("InternalError", resp.text, 500)
        etag = resp.json().get("etag", "")
        metrics.counter_add("s3_put_bytes", len(payload))
        return Response(status=200, headers={"ETag": f'"{etag}"'})

    def _get_object(self, bucket: str, key: str,
                    req: Request) -> Response:
        # ONE filer round trip: the data response carries the entry
        # kind (X-Seaweed-Entry) and the s3_* extended attributes as
        # headers. A key that exists only as a directory is NoSuchKey.
        headers = {}
        if "Range" in req.headers:
            headers["Range"] = req.headers["Range"]
        resp = self._filer("GET" if req.method == "GET" else "HEAD",
                           self._fpath(bucket, key), headers=headers,
                           stream=req.method == "GET")
        if resp.status_code >= 300 or \
                resp.headers.get("X-Seaweed-Entry") == "dir":
            resp.close()
            if resp.status_code == 404:
                # S3 tells a missing BUCKET from a missing KEY
                self._require_bucket(bucket)
                raise S3Error(*ERR_NO_SUCH_KEY)
            if resp.status_code == 416:
                raise S3Error("InvalidRange",
                              "the requested range is not satisfiable",
                              416)
            if resp.status_code >= 400:
                raise S3Error("InternalError",
                              f"filer answered {resp.status_code}", 500)
            raise S3Error(*ERR_NO_SUCH_KEY)
        etag = resp.headers.get("ETag", "")
        multipart = resp.headers.get("x-seaweed-ext-s3_etag")
        if multipart:
            etag = f'"{extheaders.unarmor(multipart)}"'
        out_headers = {"ETag": etag}
        for h in ("Content-Range", "Accept-Ranges", "Last-Modified",
                  "Content-Length", "Content-Type"):
            if h in resp.headers:
                out_headers[h] = resp.headers[h]
        pfx = "x-seaweed-ext-s3_meta_"
        for k, v in resp.headers.items():
            if k.lower().startswith(pfx):
                out_headers[f"x-amz-meta-{k[len(pfx):]}"] = \
                    extheaders.unarmor(v)
        if req.method == "HEAD":
            return Response(status=resp.status_code, headers=out_headers)
        length = int(resp.headers.get("Content-Length", "0"))
        return Response(status=resp.status_code, headers=out_headers,
                        length=length,
                        stream=resp.iter_content(STREAM_PIECE))

    def _delete_object(self, bucket: str, key: str) -> Response:
        """Deleting a key that is really a directory (a 'folder
        marker') must NOT wipe nested objects — AWS deletes exactly one
        key. Non-recursive delete; a non-empty dir is left alone."""
        self._filer("DELETE", self._fpath(bucket, key))
        return Response(status=204)

    def _copy_object(self, bucket: str, key: str, src: str,
                     req: Request) -> Response:
        self._require_bucket(bucket)
        src = urllib.parse.unquote(src.lstrip("/"))
        src_bucket, _, src_key = src.partition("/")
        # x-amz-metadata-directive (CopyObject API): COPY (default)
        # carries the source's user metadata; REPLACE takes the
        # request's x-amz-meta-* instead; a self-copy without REPLACE
        # is rejected exactly like real S3
        directive = req.headers.get(
            "x-amz-metadata-directive", "COPY").upper()
        if directive not in ("COPY", "REPLACE"):
            raise S3Error("InvalidArgument",
                          f"bad metadata directive {directive}", 400)
        if (src_bucket, src_key) == (bucket, key) and directive == "COPY":
            raise S3Error(
                "InvalidRequest",
                "This copy request is illegal because it is trying to "
                "copy an object to itself without changing the "
                "object's metadata", 400)
        meta = self._entry_meta(src_bucket, src_key)
        data = self._filer("GET", self._fpath(src_bucket, src_key))
        if data.status_code != 200:
            raise S3Error(*ERR_NO_SUCH_KEY)
        headers = {"Content-Type": meta.get(
            "mime", "application/octet-stream")}
        if directive == "REPLACE":
            if "Content-Type" in req.headers:
                headers["Content-Type"] = req.headers["Content-Type"]
            for k, v in req.headers.items():
                if k.lower().startswith("x-amz-meta-"):
                    name = k.lower()[len("x-amz-meta-"):]
                    headers[f"x-seaweed-ext-s3_meta_{name}"] = \
                        extheaders.armor(v)
        else:
            for k, v in (meta.get("extended") or {}).items():
                if k.startswith("s3_meta_"):
                    headers[f"x-seaweed-ext-{k}"] = extheaders.armor(v)
        resp = self._filer("POST", self._fpath(bucket, key),
                           params={"collection": bucket},
                           data=data.content, headers=headers)
        if resp.status_code >= 300:
            raise S3Error("InternalError", resp.text, 500)
        etag = resp.json().get("etag", "")
        root = _xml("CopyObjectResult")
        root.append(_leaf("ETag", f'"{etag}"'))
        root.append(_leaf("LastModified", _iso(time.time())))
        return _xml_response(root)

    # -- listing --------------------------------------------------------
    def _list_objects(self, bucket: str, q) -> Response:
        prefix = q.get("prefix", "")
        delimiter = q.get("delimiter", "")
        max_keys = int(q.get("max-keys", "1000"))
        v2 = q.get("list-type") == "2"
        start_after = q.get("start-after", "") if v2 else \
            q.get("marker", "")
        token = q.get("continuation-token", "")
        if token:
            start_after = urllib.parse.unquote(token)
        # encoding-type=url: keys/prefixes are percent-encoded in the
        # XML; validated BEFORE the walk
        enc = q.get("encoding-type", "")
        if enc not in ("", "url"):
            raise S3Error("InvalidArgument",
                          f"invalid encoding-type {enc}", 400)

        def _enc(s: str) -> str:
            return urllib.parse.quote(s, safe="/") if enc == "url" else s

        items, truncated = self._walk_keys(bucket, prefix, delimiter,
                                           start_after, max_keys)
        root = _xml("ListBucketResult")
        root.append(_leaf("Name", bucket))
        root.append(_leaf("Prefix", _enc(prefix)))
        root.append(_leaf("MaxKeys", max_keys))
        root.append(_leaf("IsTruncated", "true" if truncated else "false"))
        if enc:
            root.append(_leaf("EncodingType", enc))
        if delimiter:
            root.append(_leaf("Delimiter", _enc(delimiter)))
        for kind, name, meta in items:
            if kind != "key":
                continue
            c = ET.Element("Contents")
            c.append(_leaf("Key", _enc(name)))
            c.append(_leaf("LastModified", _iso(meta.get("mtime", 0))))
            c.append(_leaf("ETag", f'"{_entry_etag(meta)}"'))
            # max(offset+size), NOT the chunk-size sum: overlapping
            # rewrites keep superseded chunks in the list
            c.append(_leaf("Size", entry_size(meta)))
            c.append(_leaf("StorageClass", "STANDARD"))
            root.append(c)
        for kind, name, _ in items:
            if kind == "prefix":
                cp = ET.Element("CommonPrefixes")
                cp.append(_leaf("Prefix", _enc(name)))
                root.append(cp)
        if v2:
            root.append(_leaf("KeyCount", len(items)))
            if truncated and items:
                root.append(_leaf("NextContinuationToken",
                                  urllib.parse.quote(items[-1][1])))
        elif truncated and items:
            root.append(_leaf("NextMarker", _enc(items[-1][1])))
        return _xml_response(root)

    def _walk_keys(self, bucket: str, prefix: str, delimiter: str,
                   start_after: str, max_keys: int):
        """Walk the bucket subtree in lexical order, grouping by
        delimiter. Returns (items, truncated) where items is an ordered
        list of ("key", name, meta) / ("prefix", name, {}) — prefixes
        count toward max_keys and pagination resumes after the LAST
        item of either kind, matching S3 semantics."""
        base = f"{BUCKETS_DIR}/{bucket}"
        items: list[tuple[str, str, dict]] = []
        seen_prefixes: set[str] = set()
        truncated = False

        def list_dir(dirpath: str, last: str = ""):
            out = []
            while True:
                r = session().get(
                    f"{self.filer_url}{urllib.parse.quote(dirpath)}/",
                    params={"limit": "1024", "lastFileName": last},
                    timeout=60)
                if r.status_code != 200:
                    return out
                body = r.json()
                out.extend(body.get("entries", []))
                if not body.get("shouldDisplayLoadMore"):
                    return out
                last = body.get("lastFileName", "")

        def group(rel: str) -> bool:
            """Emit rel's common prefix; False once max_keys is hit."""
            nonlocal truncated
            grouped = prefix + rel[len(prefix):].split("/")[0] + "/"
            if grouped > (start_after or "") and \
                    grouped not in seen_prefixes:
                if len(items) >= max_keys:
                    truncated = True
                    return False
                seen_prefixes.add(grouped)
                items.append(("prefix", grouped, {}))
            return True

        def walk(dirpath: str) -> bool:
            nonlocal truncated
            entries = list_dir(dirpath)
            # S3 key order, not filer name order: a directory 'dir'
            # emits keys 'dir/...', which sort AFTER 'dir.txt'
            entries.sort(key=lambda e: e["full_path"].rsplit("/", 1)[-1]
                         + ("/" if e["mode"] & 0o40000 else ""))
            for e in entries:
                rel = e["full_path"][len(base) + 1:]
                is_dir = bool(e["mode"] & 0o40000)
                if rel.split("/")[0] == UPLOADS_DIR:
                    continue
                probe = rel + ("/" if is_dir else "")
                if prefix and not (probe.startswith(prefix)
                                   or prefix.startswith(probe)):
                    continue
                if is_dir:
                    sub = rel + "/"
                    # group only dirs strictly below the prefix; a dir
                    # equal to the prefix is recursed into
                    if delimiter == "/" and sub != prefix and \
                            sub.startswith(prefix):
                        if not group(sub):
                            return False
                        continue
                    if not walk(e["full_path"]):
                        return False
                else:
                    if not rel.startswith(prefix):
                        continue
                    if start_after and rel <= start_after:
                        continue
                    if delimiter == "/" and "/" in rel[len(prefix):]:
                        if not group(rel):
                            return False
                        continue
                    if len(items) >= max_keys:
                        truncated = True
                        return False
                    items.append(("key", rel, e))
            return True

        walk(base)
        return items, truncated

    # -- multipart ------------------------------------------------------
    @staticmethod
    def _upload_dir(upload_id: str) -> str:
        return f"{UPLOADS_DIR}/{upload_id}"

    def _initiate_multipart(self, bucket: str, key: str,
                            req: Request) -> Response:
        self._require_bucket(bucket)
        upload_id = uuid.uuid4().hex
        marker = {"full_path": "", "mime": "application/json",
                  "extended": {"s3_key": key, "mime": req.headers.get(
                      "Content-Type", "")}, "mode": 0o40775}
        self._filer("PUT", self._fpath(bucket, self._upload_dir(upload_id))
                    + "?meta=1", json=marker)
        root = _xml("InitiateMultipartUploadResult")
        root.append(_leaf("Bucket", bucket))
        root.append(_leaf("Key", key))
        root.append(_leaf("UploadId", upload_id))
        return _xml_response(root)

    def _upload_marker(self, bucket: str, upload_id: str) -> dict:
        resp = self._filer("GET",
                           self._fpath(bucket, self._upload_dir(upload_id)),
                           params={"meta": "1"})
        if resp.status_code != 200:
            raise S3Error(*ERR_NO_SUCH_UPLOAD)
        return resp.json()

    @staticmethod
    def _check_part_number(part_number: int) -> None:
        # AWS contract; also keeps the %05d name <-> int round trip
        if not 1 <= part_number <= 10000:
            raise S3Error("InvalidArgument",
                          "part number must be between 1 and 10000", 400)

    def _part_path(self, upload_id: str, part_number: int) -> str:
        return f"{self._upload_dir(upload_id)}/{part_number:05d}.part"

    def _upload_part(self, bucket: str, upload_id: str, part_number: int,
                     payload: bytes) -> Response:
        self._check_part_number(part_number)
        self._upload_marker(bucket, upload_id)
        # fullmd5: the part entry's md5 is the md5 of the PART bytes,
        # which the final "-N" etag is composed from; saveInside=false:
        # complete assembles the object from the parts' CHUNKS
        resp = self._filer("POST", self._fpath(
            bucket, self._part_path(upload_id, part_number)),
            params={"collection": bucket, "fullmd5": "1",
                    "saveInside": "false"}, data=payload)
        if resp.status_code >= 300:
            raise S3Error("InternalError", resp.text, 500)
        etag = resp.json().get("etag", "")
        return Response(status=200, headers={"ETag": f'"{etag}"'})

    def _upload_part_copy(self, bucket: str, upload_id: str,
                          part_number: int, src: str,
                          src_range: str) -> Response:
        """UploadPartCopy (s3api_object_copy_handlers.go:135): copy a
        source object — optionally an `x-amz-copy-source-range:
        bytes=a-b` slice — in as a part."""
        self._check_part_number(part_number)
        self._upload_marker(bucket, upload_id)
        src = urllib.parse.unquote(src.lstrip("/"))
        src_bucket, _, src_key = src.partition("/")
        self._entry_meta(src_bucket, src_key)
        headers = {}
        if src_range:
            if not re.fullmatch(r"bytes=(\d+)-(\d+)", src_range.strip()):
                raise S3Error("InvalidArgument",
                              f"bad copy range {src_range!r}", 400)
            headers["Range"] = src_range
        data = self._filer("GET", self._fpath(src_bucket, src_key),
                           headers=headers)
        if data.status_code == 416:
            raise S3Error("InvalidRange",
                          f"copy range {src_range!r} is outside the "
                          "source object", 416)
        if data.status_code not in (200, 206):
            raise S3Error(*ERR_NO_SUCH_KEY)
        resp = self._filer("POST", self._fpath(
            bucket, self._part_path(upload_id, part_number)),
            params={"collection": bucket, "saveInside": "false"},
            data=data.content)
        if resp.status_code >= 300:
            raise S3Error("InternalError", resp.text, 500)
        etag = resp.json().get("etag", "")
        root = _xml("CopyPartResult")
        root.append(_leaf("ETag", f'"{etag}"'))
        root.append(_leaf("LastModified", _iso(time.time())))
        return _xml_response(root)

    def _complete_multipart(self, bucket: str, key: str, upload_id: str,
                            payload: bytes) -> Response:
        marker = self._upload_marker(bucket, upload_id)
        want_parts = []
        if payload:
            root = ET.fromstring(payload)
            for p in root.iter():
                if p.tag.endswith("Part"):
                    num = _find(p, "PartNumber")
                    if num is not None:
                        want_parts.append(int(num.text))
        updir = self._upload_dir(upload_id)
        listing = self._filer("GET", self._fpath(bucket, updir) + "/")
        parts = sorted(
            (e for e in listing.json().get("entries", [])
             if e["full_path"].endswith(".part")),
            key=lambda e: e["full_path"])
        if want_parts:
            by_num = {int(e["full_path"].rsplit("/", 1)[-1][:5]): e
                      for e in parts}
            try:
                parts = [by_num[n] for n in sorted(want_parts)]
            except KeyError:
                raise S3Error("InvalidPart", "listed part missing", 400)
        offset, chunks, etags = 0, [], []
        for e in parts:
            for ch in e.get("chunks", []):
                chunks.append({"fid": ch["fid"],
                               "offset": offset + ch["offset"],
                               "size": ch["size"],
                               "mtime_ns": ch["mtime_ns"],
                               "etag": ch.get("etag", "")})
            offset += sum(ch["size"] for ch in e.get("chunks", []))
            if e.get("md5"):
                etags.append(e["md5"])
        final_etag = hashlib.md5(
            b"".join(bytes.fromhex(t) for t in etags)).hexdigest() + \
            f"-{len(parts)}"
        entry = {"mime": marker.get("extended", {}).get("mime", "") or
                 "application/octet-stream",
                 "md5": "", "collection": bucket, "chunks": chunks,
                 "extended": {"s3_etag": final_etag}}
        resp = self._filer("PUT", self._fpath(bucket, key) + "?meta=1",
                           json=entry)
        if resp.status_code >= 300:
            raise S3Error("InternalError", resp.text, 500)
        # drop part entries without touching the shared chunks
        self._filer("DELETE", self._fpath(bucket, updir),
                    params={"recursive": "true",
                            "skipChunkDeletion": "true"})
        root = _xml("CompleteMultipartUploadResult")
        root.append(_leaf("Bucket", bucket))
        root.append(_leaf("Key", key))
        root.append(_leaf("ETag", f'"{final_etag}"'))
        return _xml_response(root)

    def _abort_multipart(self, bucket: str, upload_id: str) -> Response:
        self._filer("DELETE",
                    self._fpath(bucket, self._upload_dir(upload_id)),
                    params={"recursive": "true"})
        return Response(status=204)

    def _list_multipart_uploads(self, bucket: str) -> Response:
        listing = self._filer("GET", self._fpath(bucket, UPLOADS_DIR)
                              + "/")
        root = _xml("ListMultipartUploadsResult")
        root.append(_leaf("Bucket", bucket))
        if listing.status_code == 200:
            for e in listing.json().get("entries", []):
                up = ET.Element("Upload")
                up.append(_leaf("UploadId",
                                e["full_path"].rsplit("/", 1)[-1]))
                up.append(_leaf("Key", e.get("extended", {}).get(
                    "s3_key", "")))
                up.append(_leaf("Initiated", _iso(e.get("crtime", 0))))
                root.append(up)
        return _xml_response(root)

    def _list_parts(self, bucket: str, key: str,
                    upload_id: str) -> Response:
        self._upload_marker(bucket, upload_id)
        updir = self._upload_dir(upload_id)
        listing = self._filer("GET", self._fpath(bucket, updir) + "/")
        root = _xml("ListPartsResult")
        root.append(_leaf("Bucket", bucket))
        root.append(_leaf("Key", key))
        root.append(_leaf("UploadId", upload_id))
        for e in listing.json().get("entries", []):
            if not e["full_path"].endswith(".part"):
                continue
            p = ET.Element("Part")
            p.append(_leaf("PartNumber",
                           int(e["full_path"].rsplit("/", 1)[-1][:5])))
            p.append(_leaf("ETag", f'"{e.get("md5", "")}"'))
            p.append(_leaf("Size", sum(ch["size"]
                                       for ch in e.get("chunks", []))))
            root.append(p)
        return _xml_response(root)
