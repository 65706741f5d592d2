"""Pooled HTTP client for every sync call site; the counterpart of
seaweedfs_tpu/rpc/httpclient.py, written on `http.client` instead of
`requests`.

One `Session` per thread (`session()`), holding one keep-alive
connection pool per host. Every call gets an explicit timeout —
`DEFAULT_TIMEOUT` (connect, read) unless the caller passes one, clipped
to the ambient deadline — so a dead peer fails in seconds instead of
wedging a server thread. Each request carries the ambient deadline on
X-Sw-Deadline and the trace context on traceparent.

Failures follow utils/retry.RetryPolicy: a connect failure (refused,
unreachable, connect timeout) provably never sent the request, so any
method replays after a full-jitter backoff; a 502/503/504 replays only
for idempotent methods or with the server's X-Sw-Retryable attestation.
A pooled connection the server closed while idle is detected before
reuse, and a reused connection that fails before any response byte is
retried once on a fresh one. A read timeout is never replayed.

Every attempt consults the peer's circuit breaker (utils/retry.py): an
open breaker raises `BreakerOpen` (a `retry.BreakerOpenError`) at once, with no connect;
a connect failure counts against the peer, a timeout or a mid-stream
drop settles a held half-open probe as inconclusive, and any answer
closes the breaker. The client fault hook (`faults.sync_hook` for
service "httpclient") fires before each attempt; an injected fault is
a connection that never carried the request, so it replays like a
connect failure and hands a held probe slot back.

A 307 or 308 is followed (up to MAX_REDIRECTS hops) with the same
method, body and headers, as `requests` does: HA master followers
answer mutating and topology routes with a 307 to the raft leader.
The final response lists the hops in `history`.

A body is bytes, a str, or a file-like object with `read(n)` whose
length `len(body)` (or the caller's Content-Length) gives: it is sent
in BODY_BLOCK pieces with that Content-Length (S3 refuses chunked
bodies without a streaming signature), always on a fresh connection,
and never replayed once a byte of it went out.

An `https://` url goes over `http.client.HTTPSConnection`, verified
against the CA that REQUESTS_CA_BUNDLE (or CURL_CA_BUNDLE) names, as the
reference's `requests` session resolves it, else the system store that
SSL_CERT_FILE / SSL_CERT_DIR point OpenSSL at. Pools are keyed by
scheme, host, port and the trusted CA, so a plain connection is never
reused for an `https` url, nor one verified against another CA. A
failed handshake or verification raises `SSLError` (a
`ConnectionError`) at once: it is never retried, and never over plain
HTTP.

The response mirrors what the call sites used of `requests`:
`status_code`, `headers` (case-insensitive), `content`, `text`,
`json()`, and with `stream=True` `iter_content(n)` / `close()`; as a
context manager it closes on exit.
"""
from __future__ import annotations

import base64
import http.client
import json as _json
import os
import select
import socket
import ssl
import threading
import time
from urllib.parse import urlencode, urljoin, urlsplit

from ..utils import faults, retry, tracing

# applied when a call site passes no timeout; (connect, read) so a
# black-holed peer fails in seconds while long reads still stream
DEFAULT_TIMEOUT = (5.0, 60.0)
_POOL_PER_HOST = 32
# 307 / 308 hops one call follows (an HA follower names its leader)
MAX_REDIRECTS = 5
# bytes per socket write of a file-like body (http.client's default is
# 8 KiB, which makes a GiB upload crawl)
BODY_BLOCK = 1 << 20

_local = threading.local()


class RequestException(OSError):
    """Base of every client failure (an OSError, so replica-failover
    code that catches OSError treats it as "this peer is down")."""


class ConnectionError(RequestException):  # noqa: A001 — requests' name
    """The transport failed (connect or mid-stream)."""


class SSLError(ConnectionError):
    """The TLS handshake or the server's certificate failed (requests'
    name). Never retried."""


class Timeout(RequestException):
    """Connect or read timed out."""


class HTTPError(RequestException):
    """raise_for_status() on a 4xx / 5xx."""


class BreakerOpen(retry.BreakerOpenError, RequestException):
    """The peer's circuit breaker is open: no connect was tried. A
    retry.BreakerOpenError, and a RequestException so every call site
    that handles a dead peer handles this one."""


class Response:
    def __init__(self, method: str, url: str, raw: http.client.HTTPResponse,
                 conn: http.client.HTTPConnection | None,
                 release) -> None:
        self.method = method
        self.url = url
        self.status_code = raw.status
        self.reason = raw.reason
        self.headers = raw.msg
        self._raw = raw
        self._conn = conn
        self._release = release
        self._content: bytes | None = None
        self.history: list[Response] = []

    def _done(self, reusable: bool) -> None:
        if self._conn is not None:
            conn, self._conn = self._conn, None
            self._release(conn, reusable and not self._raw.will_close)

    @property
    def content(self) -> bytes:
        if self._content is None:
            try:
                self._content = self._raw.read()
            except socket.timeout as e:
                self._done(False)
                raise Timeout(f"{self.method} {self.url}: read timed out") \
                    from e
            except (OSError, http.client.HTTPException) as e:
                self._done(False)
                raise ConnectionError(f"{self.method} {self.url}: {e}") from e
            self._done(True)
        return self._content

    @property
    def text(self) -> str:
        return self.content.decode("utf-8", "replace")

    def json(self):
        return _json.loads(self.content)

    def iter_content(self, chunk_size: int = 1 << 20):
        if self._content is not None:
            for i in range(0, len(self._content), chunk_size):
                yield self._content[i:i + chunk_size]
            return
        try:
            while True:
                piece = self._raw.read(chunk_size)
                if not piece:
                    break
                yield piece
        except socket.timeout as e:
            self._done(False)
            raise Timeout(f"{self.method} {self.url}: read timed out") from e
        except (OSError, http.client.HTTPException) as e:
            self._done(False)
            raise ConnectionError(f"{self.method} {self.url}: {e}") from e
        self._content = b""
        self._done(True)

    def close(self) -> None:
        """Give up on an unread body: the connection is not reused."""
        if self._conn is not None:
            self._raw.close()
            self._done(False)

    def __enter__(self) -> "Response":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def raise_for_status(self) -> None:
        if self.status_code >= 400:
            raise HTTPError(f"{self.status_code} {self.reason} for "
                            f"{self.method} {self.url}")


def _split_timeout(timeout) -> tuple[float, float]:
    if timeout is None:
        timeout = DEFAULT_TIMEOUT
    conn_to, read_to = timeout if isinstance(timeout, tuple) \
        else (timeout, timeout)
    rem = retry.remaining()
    if rem is not None:
        if rem <= 0:
            raise retry.DeadlineExceeded("no budget left for the request")
        conn_to, read_to = min(conn_to, rem), min(read_to, rem)
    return float(conn_to), float(read_to)


_tls_lock = threading.Lock()
_tls: dict[str | None, ssl.SSLContext] = {}


def client_context() -> ssl.SSLContext:
    """The verifying client context for https urls, one per CA file
    (REQUESTS_CA_BUNDLE / CURL_CA_BUNDLE, read at each call so a
    process can set them after import; neither set: OpenSSL's default
    paths, which SSL_CERT_FILE / SSL_CERT_DIR override)."""
    ca = os.environ.get("REQUESTS_CA_BUNDLE") or \
        os.environ.get("CURL_CA_BUNDLE") or None
    with _tls_lock:
        ctx = _tls.get(ca)
        if ctx is None:
            ctx = _tls[ca] = ssl.create_default_context(cafile=ca)
            ctx.ca_file = ca    # the pools key on it
        return ctx


def _dropped(conn: http.client.HTTPConnection) -> bool:
    """An idle pooled connection the server closed reads as EOF."""
    sock = conn.sock
    if sock is None:
        return True
    try:
        readable, _, _ = select.select([sock], [], [], 0)
    except (OSError, ValueError):
        return True
    return bool(readable)


class Session:
    """Keep-alive pools for one thread (`session()` hands out one per
    thread; http.client connections are not thread-safe)."""

    def __init__(self) -> None:
        # (host, port) -> idle plain connections; (host, port, "https",
        # the context's CA file) -> idle TLS ones
        self._pools: dict[tuple, list] = {}

    @staticmethod
    def _key(host: str, port: int, ctx: ssl.SSLContext | None) -> tuple:
        if ctx is None:
            return host, port
        return host, port, "https", ctx.ca_file

    def _take(self, host: str, port: int,
              ctx: ssl.SSLContext | None = None):
        pool = self._pools.get(self._key(host, port, ctx))
        while pool:
            conn = pool.pop()
            if not _dropped(conn):
                return conn
            conn.close()
        return None

    def _release(self, host: str, port: int,
                 ctx: ssl.SSLContext | None = None):
        key = self._key(host, port, ctx)

        def release(conn: http.client.HTTPConnection, reusable: bool):
            pool = self._pools.setdefault(key, [])
            if reusable and len(pool) < _POOL_PER_HOST:
                pool.append(conn)
            else:
                conn.close()
        return release

    @staticmethod
    def _connect(ctx: ssl.SSLContext | None, host: str, port: int,
                 conn_to: float, read_to: float
                 ) -> http.client.HTTPConnection:
        if ctx is not None:
            conn = http.client.HTTPSConnection(
                host, port, timeout=conn_to, blocksize=BODY_BLOCK,
                context=ctx)
        else:
            conn = http.client.HTTPConnection(host, port, timeout=conn_to,
                                              blocksize=BODY_BLOCK)
        conn.connect()
        conn.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        conn.sock.settimeout(read_to)
        return conn

    def close(self) -> None:
        for pool in self._pools.values():
            for conn in pool:
                conn.close()
        self._pools.clear()

    def request(self, method: str, url: str, params: dict | None = None,
                data=None, json=None,
                headers: dict | None = None, timeout=None,
                stream: bool = False) -> Response:
        history: list[Response] = []
        while True:
            resp = self._request_once(method, url, params, data, json,
                                      headers, timeout, stream)
            loc = resp.headers.get("Location")
            # a file-like body is spent: its 307 goes back to the caller
            if loc is None or resp.status_code not in (307, 308) or \
                    hasattr(data, "read"):
                resp.history = history
                return resp
            if len(history) >= MAX_REDIRECTS:
                resp.close()
                raise ConnectionError(f"{method} {url}: more than "
                                      f"{MAX_REDIRECTS} redirects")
            resp.content  # noqa: B018 — drain, give the conn back
            history.append(resp)
            # the Location carries the query; params went into it
            url, params = urljoin(resp.url, loc), None

    def _request_once(self, method: str, url: str, params, data, json,
                      headers, timeout, stream: bool) -> Response:
        method = method.upper()
        parts = urlsplit(url)
        if parts.scheme not in ("http", "https"):
            raise ValueError(f"unsupported url {url!r}: http or https only")
        host = parts.hostname or ""
        port = parts.port or (443 if parts.scheme == "https" else 80)
        target = parts.path or "/"
        query = parts.query
        if params:
            extra = urlencode([(k, v) for k, v in params.items()
                               if v is not None])
            query = f"{query}&{extra}" if query else extra
        if query:
            target += "?" + query
        hdrs = dict(headers or {})
        body = data.encode() if isinstance(data, str) else data
        if json is not None:
            body = _json.dumps(json).encode()
            hdrs.setdefault("Content-Type", "application/json")
        if body is None and method in ("POST", "PUT"):
            body = b""
        if hasattr(body, "read") and not any(
                k.lower() == "content-length" for k in hdrs):
            hdrs["Content-Length"] = str(len(body))
        retry.inject(hdrs)
        conn_to, read_to = _split_timeout(timeout)
        if tracing.current() is None:
            return self._send(method, url, parts.scheme, host, port,
                              target, body, hdrs, conn_to, read_to, stream)
        peer = parts.netloc
        with tracing.span(f"{method} {peer}", kind="client",
                          peer=peer) as rec:
            tracing.inject(hdrs)
            resp = self._send(method, url, parts.scheme, host, port,
                              target, body, hdrs, conn_to, read_to, stream)
            rec["status"] = str(resp.status_code)
            return resp

    def _send(self, method, url, scheme, host, port, target, body, hdrs,
              conn_to, read_to, stream) -> Response:
        pol = retry.policy()
        ctx = client_context() if scheme == "https" else None
        release = self._release(host, port, ctx)
        peer = urlsplit(url).netloc
        breaker = retry.breaker_for(peer)
        last_exc: Exception | None = None
        # a file-like body is read as it is sent: it goes out once, on
        # a connection of its own
        streamed = hasattr(body, "read")
        attempt = 0
        while attempt < pol.max_attempts:
            if attempt:
                time.sleep(pol.backoff(attempt))
            retry.check_deadline()
            if not breaker.allow():
                raise BreakerOpen(peer, breaker.retry_after())
            try:
                faults.sync_hook("httpclient", method)
            except faults.FaultInjected as e:
                # the fault fired before any byte moved: the peer was
                # never contacted, so a held probe slot goes back
                breaker.release_probe()
                last_exc = e
                if pol.should_retry(attempt, method, conn_failure=True):
                    attempt += 1
                    continue
                raise
            conn = None if streamed else self._take(host, port, ctx)
            reused = conn is not None
            if conn is None:
                try:
                    conn = self._connect(ctx, host, port, conn_to, read_to)
                except ssl.SSLError as e:
                    # the peer answered, but not with a TLS session we
                    # trust: no replay, and never a fall back to plain
                    breaker.probe_inconclusive()
                    raise SSLError(f"{method} {url}: {e}") from e
                except OSError as e:
                    # refused / unreachable / connect timeout: the
                    # request never left, so any method may replay, and
                    # it counts against the peer's breaker
                    breaker.record_failure()
                    last_exc = (Timeout if isinstance(e, socket.timeout)
                                else ConnectionError)(
                        f"{method} {url}: connect: {e}")
                    last_exc.__cause__ = e
                    if pol.should_retry(attempt, method, conn_failure=True):
                        attempt += 1
                        continue
                    raise last_exc
            else:
                conn.sock.settimeout(read_to)
            try:
                conn.request(method, target, body=body, headers=hdrs)
                raw = conn.getresponse()
            except socket.timeout as e:
                conn.close()
                # unproven outcome: a held probe must still settle
                breaker.probe_inconclusive()
                raise Timeout(f"{method} {url}: timed out") from e
            except (OSError, http.client.HTTPException) as e:
                conn.close()
                if reused:
                    # the server closed the idle connection as we
                    # reused it: nothing was answered, so a held probe
                    # slot goes back and the request goes again fresh
                    breaker.release_probe()
                    continue
                breaker.probe_inconclusive()
                raise ConnectionError(f"{method} {url}: {e}") from e
            breaker.record_success()
            resp = Response(method, url, raw, conn, release)
            retryable = (resp.status_code == 503 and
                         retry.RETRYABLE_HEADER in resp.headers)
            if (retryable or resp.status_code in (502, 503, 504)) and \
                    not streamed and pol.should_retry(attempt, method,
                                     status=resp.status_code,
                                     retryable_response=retryable):
                resp.close()
                attempt += 1
                continue
            if not stream:
                resp.content  # noqa: B018 — read now, give the conn back
            return resp
        raise last_exc or ConnectionError(f"{method} {url}: retries spent")

    def get(self, url: str, **kw) -> Response:
        return self.request("GET", url, **kw)

    def head(self, url: str, **kw) -> Response:
        return self.request("HEAD", url, **kw)

    def post(self, url: str, **kw) -> Response:
        return self.request("POST", url, **kw)

    def put(self, url: str, **kw) -> Response:
        return self.request("PUT", url, **kw)

    def delete(self, url: str, **kw) -> Response:
        return self.request("DELETE", url, **kw)


def session() -> Session:
    s = getattr(_local, "session", None)
    if s is None:
        s = _local.session = Session()
    return s


def basic_auth(user: str, password: str) -> str:
    """The Authorization value `requests` sends for auth=(user,
    password): latin-1 bytes joined by a colon, base64."""
    raw = b":".join((user.encode("latin1"), password.encode("latin1")))
    return "Basic " + base64.b64encode(raw).decode()


class SharedSession:
    """What a store calls of one `requests.Session` that many threads
    share: each call goes through the calling thread's `session()`,
    with `auth = (user, password)` sent as basic auth when set."""

    def __init__(self) -> None:
        self.auth: tuple[str, str] | None = None

    def request(self, method: str, url: str, headers: dict | None = None,
                **kw) -> Response:
        hdrs = dict(headers or {})
        if self.auth is not None:
            hdrs.setdefault("Authorization", basic_auth(*self.auth))
        return session().request(method, url, headers=hdrs, **kw)

    def get(self, url: str, **kw) -> Response:
        return self.request("GET", url, **kw)

    def head(self, url: str, **kw) -> Response:
        return self.request("HEAD", url, **kw)

    def post(self, url: str, **kw) -> Response:
        return self.request("POST", url, **kw)

    def put(self, url: str, **kw) -> Response:
        return self.request("PUT", url, **kw)

    def delete(self, url: str, **kw) -> Response:
        return self.request("DELETE", url, **kw)

    def close(self) -> None:
        """The pools belong to the threads' sessions: nothing to free."""
