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

A 307 or 308 is followed (up to MAX_REDIRECTS hops) with the same
method, body and headers, as `requests` does: HA master followers
answer mutating and topology routes with a 307 to the raft leader.
The final response lists the hops in `history`.

The response mirrors what the call sites used of `requests`:
`status_code`, `headers` (case-insensitive), `content`, `text`,
`json()`, and with `stream=True` `iter_content(n)` / `close()`.
"""
from __future__ import annotations

import http.client
import json as _json
import select
import socket
import threading
import time
from urllib.parse import urlencode, urljoin, urlsplit

from ..utils import retry, tracing

# applied when a call site passes no timeout; (connect, read) so a
# black-holed peer fails in seconds while long reads still stream
DEFAULT_TIMEOUT = (5.0, 60.0)
_POOL_PER_HOST = 32
# 307 / 308 hops one call follows (an HA follower names its leader)
MAX_REDIRECTS = 5

_local = threading.local()


class RequestException(OSError):
    """Base of every client failure (an OSError, so replica-failover
    code that catches OSError treats it as "this peer is down")."""


class ConnectionError(RequestException):  # noqa: A001 — requests' name
    """The transport failed (connect or mid-stream)."""


class Timeout(RequestException):
    """Connect or read timed out."""


class HTTPError(RequestException):
    """raise_for_status() on a 4xx / 5xx."""


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
        self._pools: dict[tuple[str, int], list] = {}

    def _take(self, host: str, port: int):
        pool = self._pools.get((host, port))
        while pool:
            conn = pool.pop()
            if not _dropped(conn):
                return conn
            conn.close()
        return None

    def _release(self, host: str, port: int):
        def release(conn: http.client.HTTPConnection, reusable: bool):
            pool = self._pools.setdefault((host, port), [])
            if reusable and len(pool) < _POOL_PER_HOST:
                pool.append(conn)
            else:
                conn.close()
        return release

    @staticmethod
    def _connect(host: str, port: int, conn_to: float,
                 read_to: float) -> http.client.HTTPConnection:
        conn = http.client.HTTPConnection(host, port, timeout=conn_to)
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
                data: bytes | str | None = None, json=None,
                headers: dict | None = None, timeout=None,
                stream: bool = False) -> Response:
        history: list[Response] = []
        while True:
            resp = self._request_once(method, url, params, data, json,
                                      headers, timeout, stream)
            loc = resp.headers.get("Location")
            if loc is None or resp.status_code not in (307, 308):
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
        if parts.scheme != "http":
            raise ValueError(f"unsupported url {url!r}: http only")
        host, port = parts.hostname or "", parts.port or 80
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
        retry.inject(hdrs)
        conn_to, read_to = _split_timeout(timeout)
        if tracing.current() is None:
            return self._send(method, url, host, port, target, body, hdrs,
                              conn_to, read_to, stream)
        peer = parts.netloc
        with tracing.span(f"{method} {peer}", kind="client",
                          peer=peer) as rec:
            tracing.inject(hdrs)
            resp = self._send(method, url, host, port, target, body, hdrs,
                              conn_to, read_to, stream)
            rec["status"] = str(resp.status_code)
            return resp

    def _send(self, method, url, host, port, target, body, hdrs,
              conn_to, read_to, stream) -> Response:
        pol = retry.policy()
        release = self._release(host, port)
        last_exc: Exception | None = None
        attempt = 0
        while attempt < pol.max_attempts:
            if attempt:
                time.sleep(pol.backoff(attempt))
            retry.check_deadline()
            conn = self._take(host, port)
            reused = conn is not None
            if conn is None:
                try:
                    conn = self._connect(host, port, conn_to, read_to)
                except OSError as e:
                    # refused / unreachable / connect timeout: the
                    # request never left, so any method may replay
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
                raise Timeout(f"{method} {url}: timed out") from e
            except (OSError, http.client.HTTPException) as e:
                conn.close()
                if reused:
                    # the server closed the idle connection as we
                    # reused it: nothing was answered, go again fresh
                    continue
                raise ConnectionError(f"{method} {url}: {e}") from e
            resp = Response(method, url, raw, conn, release)
            retryable = (resp.status_code == 503 and
                         retry.RETRYABLE_HEADER in resp.headers)
            if (retryable or resp.status_code in (502, 503, 504)) and \
                    pol.should_retry(attempt, method,
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

    def delete(self, url: str, **kw) -> Response:
        return self.request("DELETE", url, **kw)


def session() -> Session:
    s = getattr(_local, "session", None)
    if s is None:
        s = _local.session = Session()
    return s
