"""HTTP transport on the standard library; the counterpart of
seaweedfs_tpu/rpc/http.py.

The reference serves every control verb as JSON over HTTP from aiohttp
apps, one event loop per server. The port keeps the wire contract — the
same route table, query parameters, JSON bodies and status codes — on
`http.server.ThreadingHTTPServer`: one thread per connection, HTTP/1.1
keep-alive, daemon threads, handlers that are plain functions
`handler(request) -> Response`. Long work (a volume's encode, a
rebuild) therefore runs on the connection's own thread, where the
reference ran it in `asyncio.to_thread`.

Every request passes through `App.handle`:

* a passed `X-Sw-Deadline` answers 504 before the handler runs, and a
  live one is bound for the handler (utils/retry.deadline_scope), so
  the hops it makes carry it on;
* exceptions listed in the app's `bad_request` map to 400
  `{"error": "bad request: ..."}` (the volume server's error
  middleware); any other exception is logged with its traceback and
  answers 500 `{"error": ...}` — a handler that raises never yields a
  200.
"""
from __future__ import annotations

import http.server
import json
import os
import re
import socket
import threading
import time
import traceback
from typing import Any, Callable, Iterable
from urllib.parse import parse_qsl, unquote

from ..utils import glog, retry

# an idle keep-alive connection is closed after this many seconds
IDLE_TIMEOUT = 120.0
# bytes per write of a streamed file response
FILE_PIECE = 1 << 20

# statuses whose replies carry no body (RFC 9110 §15.3.5, §15.4.5): a
# handler's body for them is dropped, as aiohttp drops it
_NO_BODY = (204, 304)

# paths that skip the deadline check (the reference's _SKIP_PATHS)
_NO_DEADLINE = frozenset({"/metrics", "/status", "/healthz"})


class Request:
    """One parsed request: method, path, query, headers, match info
    and the body, read whole once (`read`) or in pieces
    (`read_exactly`, for bodies too large to hold)."""

    def __init__(self, method: str, path: str, query_string: str,
                 headers, rfile, match_info: dict | None = None):
        self.method = method
        self.path = path
        self.query_string = query_string
        self.headers = headers          # case-insensitive .get()
        self.match_info = match_info or {}
        self._rfile = rfile
        self._body: bytes | None = None
        self._chunked = "chunked" in (headers.get("Transfer-Encoding")
                                      or "").lower()
        self._left = 0 if self._chunked else (self.content_length or 0)
        self._chunk_left = 0            # bytes left of the current chunk
        self._eof = False
        query: dict[str, str] = {}
        for k, v in parse_qsl(query_string, keep_blank_values=True):
            query.setdefault(k, v)      # first value wins, as aiohttp
        self.query = query

    @property
    def content_length(self) -> int | None:
        v = self.headers.get("Content-Length")
        return int(v) if v is not None else None

    @property
    def content_type(self) -> str:
        return (self.headers.get("Content-Type") or "").split(";")[0] \
            .strip()

    def read(self) -> bytes:
        """The whole body (what is left of it after read_exactly)."""
        if self._body is None:
            out = bytearray()
            while True:
                piece = self._read_some(1 << 20)
                if not piece:
                    break
                out += piece
            self._body = bytes(out)
        return self._body

    def read_exactly(self, n: int) -> bytes:
        """The next n bytes of the body, fewer only at its end."""
        out = bytearray()
        while len(out) < n:
            piece = self._read_some(n - len(out))
            if not piece:
                break
            out += piece
        return bytes(out)

    def _read_some(self, n: int) -> bytes:
        if self._eof:
            return b""
        if not self._chunked:
            if self._left <= 0:
                self._eof = True
                return b""
            piece = self._rfile.read(min(n, self._left))
            if not piece:
                raise ConnectionError("request body cut short")
            self._left -= len(piece)
            return piece
        if self._chunk_left == 0:
            line = self._rfile.readline(1 << 16)
            size = int(line.split(b";", 1)[0].strip() or b"0", 16)
            if size == 0:
                while self._rfile.readline(1 << 16) not in (b"\r\n", b"\n",
                                                            b""):
                    pass                # trailers
                self._eof = True
                return b""
            self._chunk_left = size
        piece = self._rfile.read(min(n, self._chunk_left))
        if not piece:
            raise ConnectionError("request body cut short")
        self._chunk_left -= len(piece)
        if self._chunk_left == 0:
            self._rfile.readline(1 << 16)   # the chunk's CRLF
        return piece

    def json(self) -> Any:
        return json.loads(self.read() or b"null")


class Response:
    """A reply: status, headers and one of: bytes, a byte range of a
    file (streamed in FILE_PIECE writes; `pace(n)` is called before
    each write when set, for the repair token bucket), or `stream`, an
    iterable of byte pieces whose total is `length` (sent with that
    Content-Length; its `close()` is called once the reply is done).
    A 101 reply with `upgrade` hands the connection, once the reply
    head is sent, to `upgrade(ws)` as an rpc/websocket.WebSocket, on
    the request's thread; the connection ends when it returns."""

    def __init__(self, body: bytes = b"", status: int = 200,
                 headers: dict | None = None,
                 content_type: str | None = None,
                 file: tuple[str, int, int] | None = None,
                 pace: Callable[[int], None] | None = None,
                 stream: Iterable[bytes] | None = None,
                 length: int | None = None,
                 upgrade: Callable | None = None):
        self.body = body
        self.upgrade = upgrade
        self.status = status
        self.headers = dict(headers or {})
        if content_type is not None:
            self.headers["Content-Type"] = content_type
        self.file = file
        self.pace = pace
        self.stream = stream
        self._length = length

    @property
    def length(self) -> int:
        if self.stream is not None:
            return self._length or 0
        return self.file[2] if self.file is not None else len(self.body)


def json_response(data: Any, status: int = 200,
                  headers: dict | None = None) -> Response:
    return Response(json.dumps(data).encode(), status, headers,
                    content_type="application/json")


def json_ok(data: Any = None, **extra) -> Response:
    body = dict(data or {})
    body.update(extra)
    return json_response(body)


def json_error(msg: str, status: int = 400) -> Response:
    return json_response({"error": msg}, status=status)


def text_response(text: str, status: int = 200,
                  content_type: str = "text/plain") -> Response:
    return Response(text.encode(), status, content_type=content_type)


def file_response(path: str, offset: int = 0, length: int | None = None,
                  pace: Callable[[int], None] | None = None) -> Response:
    if length is None:
        length = os.path.getsize(path) - offset
    return Response(status=200, content_type="application/octet-stream",
                    file=(path, offset, length), pace=pace)


_PARAM = re.compile(r"\{(\w+)(?::([^{}]*(?:\{[^{}]*\}[^{}]*)*))?\}")


def _compile(path: str) -> re.Pattern:
    out, pos = [], 0
    for m in _PARAM.finditer(path):
        out.append(re.escape(path[pos:m.start()]))
        out.append(f"(?P<{m.group(1)}>{m.group(2) or '[^/]+'})")
        pos = m.end()
    out.append(re.escape(path[pos:]))
    return re.compile("".join(out) + r"\Z")


Handler = Callable[[Request], Response]


class App:
    """A route table: (method, path pattern) -> handler. A pattern may
    hold `{name}` or `{name:regex}` segments (aiohttp's syntax); method
    "*" matches any method, and a GET route answers HEAD too."""

    def __init__(self, bad_request: tuple[type, ...] = ()):
        self._exact: dict[tuple[str, str], Handler] = {}
        self._patterns: list[tuple[str, re.Pattern, Handler]] = []
        self.bad_request = bad_request
        # run by ServerThread: on_startup once the port is bound,
        # on_cleanup after the server stopped
        self.on_startup: list[Callable[[], None]] = []
        self.on_cleanup: list[Callable[[], None]] = []

    def route(self, method: str, path: str, handler: Handler) -> None:
        if "{" in path:
            self._patterns.append((method, _compile(path), handler))
        else:
            self._exact[(method, path)] = handler

    def get(self, path: str, handler: Handler) -> None:
        self.route("GET", path, handler)

    def post(self, path: str, handler: Handler) -> None:
        self.route("POST", path, handler)

    def resolve(self, method: str, path: str
                ) -> tuple[Handler | None, dict, bool]:
        """-> (handler, match_info, path_known)."""
        methods = (method, "*", "GET") if method == "HEAD" else (method, "*")
        for m in methods:
            h = self._exact.get((m, path))
            if h is not None:
                return h, {}, True
        known = False
        for m_route, pat, h in self._patterns:
            mt = pat.match(path)
            if mt is None:
                continue
            known = True
            if m_route in methods:
                return h, mt.groupdict(), True
        return None, {}, known or any(p == path for _, p in self._exact)

    def handle(self, req: Request) -> Response:
        handler, info, known = self.resolve(req.method, req.path)
        if handler is None:
            return json_error(f"{req.method} {req.path}: "
                              f"{'method not allowed' if known else 'not found'}",
                              status=405 if known else 404)
        req.match_info = info
        dl = None
        if req.path not in _NO_DEADLINE:
            dl = retry.parse_deadline(req.headers.get(retry.DEADLINE_HEADER))
            if dl is not None and dl <= time.time():
                return text_response("deadline exceeded\n", status=504)
        try:
            with retry.deadline_scope(absolute=dl):
                return handler(req)
        except retry.DeadlineExceeded:
            return text_response("deadline exceeded\n", status=504)
        except self.bad_request as e:
            return json_error(f"bad request: {e}", status=400)
        except Exception as e:  # noqa: BLE001 — the server must answer
            glog.error("%s %s failed: %s\n%s", req.method, req.path, e,
                       traceback.format_exc())
            return json_error(f"{type(e).__name__}: {e}", status=500)


class _Handler(http.server.BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    server_version = "seaweedfs-tpu-torch"
    timeout = IDLE_TIMEOUT

    def setup(self) -> None:
        super().setup()
        self.connection.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY,
                                   1)
        self.server.track(self.connection, True)

    def finish(self) -> None:
        try:
            super().finish()
        finally:
            self.server.track(self.connection, False)

    def log_message(self, fmt: str, *args) -> None:
        glog.v(3, "%s " + fmt, self.address_string(), *args)

    def _dispatch(self) -> None:
        path, _, qs = self.path.partition("?")
        req = Request(self.command, unquote(path), qs, self.headers,
                      self.rfile)
        resp = self.server.app.handle(req)
        try:
            req.read()                  # drain what the handler left
        except (ConnectionError, ValueError):
            self.close_connection = True
        if resp.upgrade is not None:
            self._upgrade(resp)
            return
        self.send_response(resp.status)
        sent = {k.lower() for k in resp.headers}
        no_body = resp.status in _NO_BODY
        for k, v in resp.headers.items():
            if no_body and k.lower() == "content-length":
                continue
            self.send_header(k, str(v))
        if "content-length" not in sent and not no_body:
            self.send_header("Content-Length", str(resp.length))
        self.end_headers()
        if self.command == "HEAD" or no_body:
            _close_stream(resp)
            return
        if resp.stream is not None:
            self._send_stream(resp)
            return
        if resp.file is None:
            if resp.body:
                self.wfile.write(resp.body)
            return
        fpath, offset, length = resp.file
        with open(fpath, "rb") as f:
            if resp.pace is None:
                self.connection.sendfile(f, offset, length)
                return
            f.seek(offset)
            while length > 0:
                piece = f.read(min(FILE_PIECE, length))
                if not piece:
                    raise IOError(f"{fpath} shrank while being sent")
                resp.pace(len(piece))
                self.wfile.write(piece)
                length -= len(piece)

    def _upgrade(self, resp: Response) -> None:
        """Answer 101 and serve the websocket until its handler returns;
        reads block without the idle timeout (a stopping server shuts
        the socket down, which ends them)."""
        from .websocket import WebSocket

        self.close_connection = True
        self.send_response(resp.status)
        for k, v in resp.headers.items():
            self.send_header(k, str(v))
        self.end_headers()
        self.wfile.flush()
        self.connection.settimeout(None)
        ws = WebSocket(self.connection, lambda: self.rfile.read1(1 << 16),
                       client=False)
        try:
            resp.upgrade(ws)
        finally:
            ws.close()

    def _send_stream(self, resp: Response) -> None:
        """Write a streamed body. The status is already sent, so a
        source that fails or comes up short mid-body ends the
        connection: the client sees a cut body, never a wrong one."""
        left = resp.length
        try:
            for piece in resp.stream:
                if len(piece) > left:
                    raise IOError(f"stream gave {len(piece) - left} B more "
                                  f"than its {resp.length} B")
                self.wfile.write(piece)
                left -= len(piece)
            if left:
                raise IOError(f"stream ended {left} B short of its "
                              f"{resp.length} B")
        except Exception as e:  # noqa: BLE001 — the status is sent
            glog.warning("%s %s: streamed reply cut: %s", self.command,
                         self.path, e)
            self.close_connection = True
        finally:
            _close_stream(resp)

    do_GET = do_POST = do_PUT = do_DELETE = do_HEAD = _dispatch


def _close_stream(resp: Response) -> None:
    close = getattr(resp.stream, "close", None)
    if close is not None:
        close()


class _Server(http.server.ThreadingHTTPServer):
    daemon_threads = True
    allow_reuse_address = True
    request_queue_size = 128

    def __init__(self, addr, app: App):
        self.app = app
        self._conns: set[socket.socket] = set()
        self._conns_lock = threading.Lock()
        super().__init__(addr, _Handler)

    def track(self, conn: socket.socket, alive: bool) -> None:
        with self._conns_lock:
            (self._conns.add if alive else self._conns.discard)(conn)

    def handle_error(self, request, client_address) -> None:
        # a peer that hung up mid-reply; the handler thread just ends
        glog.v(1, "connection from %s ended: %s", client_address,
               traceback.format_exc(limit=1).strip().splitlines()[-1])

    def close_connections(self) -> None:
        with self._conns_lock:
            conns, self._conns = list(self._conns), set()
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass


class ServerThread:
    """Serve an App on (host, port) from a daemon thread; port 0 binds
    an ephemeral port, read back from `.port` / `.url` after start()."""

    def __init__(self, app: App, host: str = "127.0.0.1", port: int = 0):
        self.app = app
        self.host = host
        self.port = port
        self._server: _Server | None = None
        self._thread: threading.Thread | None = None

    def start(self) -> "ServerThread":
        self._server = _Server((self.host, self.port), self.app)
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, kwargs={"poll_interval": 0.1},
            name=f"http-{self.port}", daemon=True)
        self._thread.start()
        for fn in self.app.on_startup:
            fn()
        return self

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    def stop(self) -> None:
        """Stop accepting, close open connections, then run the app's
        cleanup callbacks (heartbeat threads, stores)."""
        if self._server is None:
            return
        server, self._server = self._server, None
        server.shutdown()
        server.server_close()
        server.close_connections()
        if self._thread is not None:
            self._thread.join(timeout=10)
        for fn in self.app.on_cleanup:
            try:
                fn()
            except Exception as e:  # noqa: BLE001 — finish every cleanup
                glog.error("cleanup %s failed: %s", fn, e)


def run_apps_forever(servers: list[ServerThread]) -> None:
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        for s in servers:
            s.stop()


def debug_index_factory(service: str, endpoints: dict[str, str]) -> Handler:
    """GET /debug — one self-describing index of a server's debug
    surface; ?format=text renders a plain listing for terminals."""
    listing = dict(sorted(endpoints.items()))

    def handle(req: Request) -> Response:
        if req.query.get("format") == "text":
            width = max(len(p) for p in listing)
            lines = [f"{service} debug endpoints:"] + [
                f"  {path.ljust(width)}  {desc}"
                for path, desc in listing.items()]
            return text_response("\n".join(lines) + "\n")
        return json_response({"service": service, "endpoints": listing})
    return handle
