"""A small RFC 6455 websocket server side and client on the standard
library, for the master's KeepConnected stream (/ws/keepconnected).

The reference serves and consumes its streams with aiohttp's
websockets. The port keeps the wire format — text frames of JSON, ping
answered by pong, a close handshake — and carries it on its own HTTP
server: a handler returns `upgrade(req, on_open)`, the server answers
101 and hands the connection to `on_open(ws)` on the request's own
thread until it returns. `connect(url)` is the client. Neither side
negotiates extensions, so frames are never compressed; fragmented
messages are joined. A server's frames go unmasked, a client's masked
(RFC 6455 §5.3).
"""
from __future__ import annotations

import base64
import hashlib
import json
import os
import socket
import struct
import threading
from typing import Any, Callable
from urllib.parse import urlsplit

_GUID = b"258EAFA5-E914-47DA-95CA-C5AB0DC85B11"
# how long close() waits to send its close frame to a peer not reading
CLOSE_TIMEOUT = 1.0
CONT, TEXT, BINARY, CLOSE, PING, PONG = 0x0, 0x1, 0x2, 0x8, 0x9, 0xA
# largest message either side accepts
MAX_MESSAGE = 64 << 20


class WebSocketError(ConnectionError):
    pass


def accept_key(key: str) -> str:
    return base64.b64encode(
        hashlib.sha1(key.encode() + _GUID).digest()).decode()


class WebSocket:
    """One open websocket over a connected socket. `send_*` may be
    called from any thread; `receive` from one reader thread.
    `fill()` returns the next bytes the socket has (b"" at its end):
    the server's buffered request reader, or the client's socket."""

    def __init__(self, sock: socket.socket, fill: Callable[[], bytes],
                 client: bool, buffered: bytes = b""):
        self.sock = sock
        self._fill = fill
        self._buf = bytearray(buffered)
        self._client = client
        self._send_lock = threading.Lock()
        self.closed = False

    # -- sending ---------------------------------------------------------
    def _send_frame(self, opcode: int, payload: bytes) -> None:
        n = len(payload)
        head = bytearray([0x80 | opcode])
        mask_bit = 0x80 if self._client else 0
        if n < 126:
            head.append(mask_bit | n)
        elif n < 1 << 16:
            head.append(mask_bit | 126)
            head += struct.pack("!H", n)
        else:
            head.append(mask_bit | 127)
            head += struct.pack("!Q", n)
        if self._client:
            mask = os.urandom(4)
            head += mask
            payload = _mask(payload, mask)
        with self._send_lock:
            if self.closed and opcode != CLOSE:
                raise WebSocketError("websocket is closed")
            self.sock.sendall(bytes(head) + payload)

    def send_text(self, text: str) -> None:
        self._send_frame(TEXT, text.encode())

    def send_json(self, obj: Any) -> None:
        self.send_text(json.dumps(obj))

    def ping(self, payload: bytes = b"") -> None:
        self._send_frame(PING, payload)

    def close(self, code: int = 1000) -> None:
        """Send a close frame (once) and shut the socket down."""
        with self._send_lock:
            was, self.closed = self.closed, True
        if not was:
            try:
                head = bytearray([0x80 | CLOSE])
                body = struct.pack("!H", code)
                if self._client:
                    mask = os.urandom(4)
                    head += bytes([0x80 | len(body)]) + mask
                    body = _mask(body, mask)
                else:
                    head.append(len(body))
                with self._send_lock:
                    self.sock.settimeout(CLOSE_TIMEOUT)
                    self.sock.sendall(bytes(head) + body)
            except OSError:
                pass
        self.abort()

    def abort(self) -> None:
        """Shut the socket down with no close frame: a send blocked on
        a peer that stopped reading fails at once, and so does a
        blocked receive."""
        self.closed = True
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass

    # -- receiving -------------------------------------------------------
    def _parse(self) -> tuple[bool, int, bytes] | None:
        """One whole frame off the front of the buffer, or None while
        the buffer holds less."""
        buf = self._buf
        if len(buf) < 2:
            return None
        b0, b1 = buf[0], buf[1]
        n, at = b1 & 0x7F, 2
        if n == 126:
            if len(buf) < 4:
                return None
            n, at = struct.unpack_from("!H", buf, 2)[0], 4
        elif n == 127:
            if len(buf) < 10:
                return None
            n, at = struct.unpack_from("!Q", buf, 2)[0], 10
        if n > MAX_MESSAGE:
            raise WebSocketError(f"frame of {n} B is over the limit")
        mask = None
        if b1 & 0x80:
            if len(buf) < at + 4:
                return None
            mask, at = bytes(buf[at:at + 4]), at + 4
        if len(buf) < at + n:
            return None
        payload = bytes(buf[at:at + n])
        del buf[:at + n]
        if mask is not None:
            payload = _mask(payload, mask)
        return bool(b0 & 0x80), b0 & 0x0F, payload

    def _read_frame(self) -> tuple[bool, int, bytes]:
        while True:
            frame = self._parse()
            if frame is not None:
                return frame
            more = self._fill()    # a socket timeout leaves buf whole
            if not more:
                raise WebSocketError("connection closed")
            self._buf += more

    def receive(self) -> str | bytes | None:
        """The next data message (str for text, bytes for binary), or
        None once the stream ended. Pings are answered here. A socket
        timeout propagates (socket.timeout) with the stream intact."""
        parts: list[bytes] = []
        kind = None
        while True:
            try:
                fin, op, payload = self._read_frame()
            except socket.timeout:
                raise
            except (WebSocketError, OSError, ValueError):
                self.closed = True
                return None
            if op == PING:
                try:
                    self._send_frame(PONG, payload)
                except OSError:
                    pass
                continue
            if op == PONG:
                continue
            if op == CLOSE:
                self.close()
                return None
            if op in (TEXT, BINARY):
                kind, parts = op, [payload]
            elif op == CONT and kind is not None:
                parts.append(payload)
            else:
                self.close(1002)
                return None
            if fin:
                data = b"".join(parts)
                return data.decode() if kind == TEXT else data


def _mask(data: bytes, mask: bytes) -> bytes:
    if not data:
        return data
    n = len(data)
    key = int.from_bytes((mask * (n // 4 + 1))[:n], "big")
    return (int.from_bytes(data, "big") ^ key).to_bytes(n, "big")


def upgrade(req, on_open: Callable[[WebSocket], None]):
    """A handler's reply that turns its connection into a websocket
    (server side), or 400 for a request that is no websocket
    handshake."""
    from .http import Response, json_error

    key = req.headers.get("Sec-WebSocket-Key")
    if (req.headers.get("Upgrade") or "").lower() != "websocket" or \
            not key:
        return json_error("websocket handshake expected", status=400)
    return Response(status=101, headers={
        "Upgrade": "websocket", "Connection": "Upgrade",
        "Sec-WebSocket-Accept": accept_key(key)},
        upgrade=on_open)


def connect(url: str, timeout: float = 10.0) -> WebSocket:
    """Open a client websocket to ws://host:port/path (http:// is taken
    as ws://). The socket keeps `timeout` as its read timeout."""
    parts = urlsplit(url)
    if parts.scheme not in ("ws", "http"):
        raise ValueError(f"unsupported websocket url {url!r}")
    host, port = parts.hostname or "", parts.port or 80
    target = (parts.path or "/") + (f"?{parts.query}" if parts.query
                                    else "")
    sock = socket.create_connection((host, port), timeout=timeout)
    try:
        key = base64.b64encode(os.urandom(16)).decode()
        sock.sendall((f"GET {target} HTTP/1.1\r\nHost: {parts.netloc}\r\n"
                      "Upgrade: websocket\r\nConnection: Upgrade\r\n"
                      f"Sec-WebSocket-Key: {key}\r\n"
                      "Sec-WebSocket-Version: 13\r\n\r\n").encode())
        buf = b""
        while b"\r\n\r\n" not in buf:
            more = sock.recv(1 << 16)
            if not more or len(buf) > 1 << 16:
                raise WebSocketError(f"{url}: handshake cut short")
            buf += more
        head, _, rest = buf.partition(b"\r\n\r\n")
        lines = head.decode("latin-1").split("\r\n")
        status = lines[0].split()
        headers = {}
        for line in lines[1:]:
            k, _, v = line.partition(":")
            headers[k.strip().lower()] = v.strip()
        if len(status) < 2 or status[1] != "101":
            raise WebSocketError(f"{url}: handshake answered "
                                 f"{' '.join(status[1:]) or 'nothing'}")
        if headers.get("sec-websocket-accept") != accept_key(key):
            raise WebSocketError(f"{url}: bad Sec-WebSocket-Accept")
    except BaseException:
        sock.close()
        raise
    return WebSocket(sock, lambda: sock.recv(1 << 16), client=True,
                     buffered=rest)
