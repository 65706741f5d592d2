"""Minimal gRPC client: HTTP/2 framing + HPACK + length-prefixed
messages, unary calls over one cleartext (h2c) connection — plus a tiny
protobuf wire encoder/decoder.

The reference speaks gRPC everywhere (its filer stores ride clientv3 /
client-go / ydb-go-sdk; its own services are gRPC). This build's RPC
substrate is HTTP+WS by design, but the store families that ONLY talk
gRPC (tikv, ydb, native etcd v3) need the real thing — so here it is
in-tree, from the RFCs (7540 framing, 7541 HPACK incl. the Appendix B
Huffman code) and the gRPC HTTP/2 transport spec, zero SDK. Validated
in tests against a real grpc-core server (tests/test_grpc_lite.py).

Scope: unary calls, h2c (no TLS — same scope as the reference's
default plaintext gRPC between cluster peers), one call at a time per
channel (the filer-store contract serializes anyway). Flow control is
honored on both directions; interleaved SETTINGS/PING/WINDOW_UPDATE/
GOAWAY frames are handled mid-call.

The port's copy of seaweedfs_tpu/utils/grpc_lite.py: the same frames,
HPACK blocks and protobuf bytes, over the standard library only.
"""
from __future__ import annotations

import socket
import struct
import threading

# ---------------------------------------------------------------------------
# protobuf wire helpers (encoding spec: varint=0, fixed64=1, bytes=2,
# fixed32=5)
# ---------------------------------------------------------------------------


def pb_varint(v: int) -> bytes:
    out = bytearray()
    if v < 0:
        v += 1 << 64  # negative int64s encode as 10-byte varints
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def pb_tag(field: int, wire: int) -> bytes:
    return pb_varint(field << 3 | wire)


def pb_bytes(field: int, data: bytes) -> bytes:
    return pb_tag(field, 2) + pb_varint(len(data)) + data


def pb_str(field: int, s: str) -> bytes:
    return pb_bytes(field, s.encode())


def pb_uint(field: int, v: int) -> bytes:
    return b"" if v == 0 else pb_tag(field, 0) + pb_varint(v)


def pb_bool(field: int, v: bool) -> bytes:
    return pb_uint(field, 1 if v else 0)


def pb_decode(data: bytes) -> dict[int, list]:
    """Generic decode -> {field: [value, ...]} (varints as int, bytes
    as bytes; nested messages stay bytes for the caller to pb_decode)."""
    out: dict[int, list] = {}
    i, n = 0, len(data)
    while i < n:
        key, i = _read_varint(data, i)
        field, wire = key >> 3, key & 7
        if wire == 0:
            v, i = _read_varint(data, i)
        elif wire == 1:
            v = struct.unpack_from("<Q", data, i)[0]
            i += 8
        elif wire == 2:
            ln, i = _read_varint(data, i)
            v = data[i:i + ln]
            if len(v) != ln:
                raise ValueError("truncated protobuf")
            i += ln
        elif wire == 5:
            v = struct.unpack_from("<I", data, i)[0]
            i += 4
        else:
            raise ValueError(f"protobuf wire type {wire}")
        out.setdefault(field, []).append(v)
    return out


def pb_first(msg: dict[int, list], field: int, default=None):
    vals = msg.get(field)
    return vals[0] if vals else default


def _read_varint(data: bytes, i: int) -> tuple[int, int]:
    v = shift = 0
    while True:
        if i >= len(data):
            raise ValueError("truncated varint")
        b = data[i]
        i += 1
        v |= (b & 0x7F) << shift
        if not b & 0x80:
            return v, i
        shift += 7
        if shift > 70:
            raise ValueError("varint too long")


# ---------------------------------------------------------------------------
# HPACK (RFC 7541)
# ---------------------------------------------------------------------------

# Appendix A static table (index 1..61)
_STATIC = [
    (":authority", ""), (":method", "GET"), (":method", "POST"),
    (":path", "/"), (":path", "/index.html"), (":scheme", "http"),
    (":scheme", "https"), (":status", "200"), (":status", "204"),
    (":status", "206"), (":status", "304"), (":status", "400"),
    (":status", "404"), (":status", "500"), ("accept-charset", ""),
    ("accept-encoding", "gzip, deflate"), ("accept-language", ""),
    ("accept-ranges", ""), ("accept", ""),
    ("access-control-allow-origin", ""), ("age", ""), ("allow", ""),
    ("authorization", ""), ("cache-control", ""),
    ("content-disposition", ""), ("content-encoding", ""),
    ("content-language", ""), ("content-length", ""),
    ("content-location", ""), ("content-range", ""),
    ("content-type", ""), ("cookie", ""), ("date", ""), ("etag", ""),
    ("expect", ""), ("expires", ""), ("from", ""), ("host", ""),
    ("if-match", ""), ("if-modified-since", ""), ("if-none-match", ""),
    ("if-range", ""), ("if-unmodified-since", ""),
    ("last-modified", ""), ("link", ""), ("location", ""),
    ("max-forwards", ""), ("proxy-authenticate", ""),
    ("proxy-authorization", ""), ("range", ""), ("referer", ""),
    ("refresh", ""), ("retry-after", ""), ("server", ""),
    ("set-cookie", ""), ("strict-transport-security", ""),
    ("transfer-encoding", ""), ("user-agent", ""), ("vary", ""),
    ("via", ""), ("www-authenticate", ""),
]

# Appendix B Huffman code: (code, bit length) per symbol 0..255 + EOS
_HUFFMAN = [
    (0x1ff8, 13), (0x7fffd8, 23), (0xfffffe2, 28), (0xfffffe3, 28),
    (0xfffffe4, 28), (0xfffffe5, 28), (0xfffffe6, 28), (0xfffffe7, 28),
    (0xfffffe8, 28), (0xffffea, 24), (0x3ffffffc, 30), (0xfffffe9, 28),
    (0xfffffea, 28), (0x3ffffffd, 30), (0xfffffeb, 28), (0xfffffec, 28),
    (0xfffffed, 28), (0xfffffee, 28), (0xfffffef, 28), (0xffffff0, 28),
    (0xffffff1, 28), (0xffffff2, 28), (0x3ffffffe, 30), (0xffffff3, 28),
    (0xffffff4, 28), (0xffffff5, 28), (0xffffff6, 28), (0xffffff7, 28),
    (0xffffff8, 28), (0xffffff9, 28), (0xffffffa, 28), (0xffffffb, 28),
    (0x14, 6), (0x3f8, 10), (0x3f9, 10), (0xffa, 12),
    (0x1ff9, 13), (0x15, 6), (0xf8, 8), (0x7fa, 11),
    (0x3fa, 10), (0x3fb, 10), (0xf9, 8), (0x7fb, 11),
    (0xfa, 8), (0x16, 6), (0x17, 6), (0x18, 6),
    (0x0, 5), (0x1, 5), (0x2, 5), (0x19, 6),
    (0x1a, 6), (0x1b, 6), (0x1c, 6), (0x1d, 6),
    (0x1e, 6), (0x1f, 6), (0x5c, 7), (0xfb, 8),
    (0x7ffc, 15), (0x20, 6), (0xffb, 12), (0x3fc, 10),
    (0x1ffa, 13), (0x21, 6), (0x5d, 7), (0x5e, 7),
    (0x5f, 7), (0x60, 7), (0x61, 7), (0x62, 7),
    (0x63, 7), (0x64, 7), (0x65, 7), (0x66, 7),
    (0x67, 7), (0x68, 7), (0x69, 7), (0x6a, 7),
    (0x6b, 7), (0x6c, 7), (0x6d, 7), (0x6e, 7),
    (0x6f, 7), (0x70, 7), (0x71, 7), (0x72, 7),
    (0xfc, 8), (0x73, 7), (0xfd, 8), (0x1ffb, 13),
    (0x7fff0, 19), (0x1ffc, 13), (0x3ffc, 14), (0x22, 6),
    (0x7ffd, 15), (0x3, 5), (0x23, 6), (0x4, 5),
    (0x24, 6), (0x5, 5), (0x25, 6), (0x26, 6),
    (0x27, 6), (0x6, 5), (0x74, 7), (0x75, 7),
    (0x28, 6), (0x29, 6), (0x2a, 6), (0x7, 5),
    (0x2b, 6), (0x76, 7), (0x2c, 6), (0x8, 5),
    (0x9, 5), (0x2d, 6), (0x77, 7), (0x78, 7),
    (0x79, 7), (0x7a, 7), (0x7b, 7), (0x7ffe, 15),
    (0x7fc, 11), (0x3ffd, 14), (0x1ffd, 13), (0xffffffc, 28),
    (0xfffe6, 20), (0x3fffd2, 22), (0xfffe7, 20), (0xfffe8, 20),
    (0x3fffd3, 22), (0x3fffd4, 22), (0x3fffd5, 22), (0x7fffd9, 23),
    (0x3fffd6, 22), (0x7fffda, 23), (0x7fffdb, 23), (0x7fffdc, 23),
    (0x7fffdd, 23), (0x7fffde, 23), (0xffffeb, 24), (0x7fffdf, 23),
    (0xffffec, 24), (0xffffed, 24), (0x3fffd7, 22), (0x7fffe0, 23),
    (0xffffee, 24), (0x7fffe1, 23), (0x7fffe2, 23), (0x7fffe3, 23),
    (0x7fffe4, 23), (0x1fffdc, 21), (0x3fffd8, 22), (0x7fffe5, 23),
    (0x3fffd9, 22), (0x7fffe6, 23), (0x7fffe7, 23), (0xffffef, 24),
    (0x3fffda, 22), (0x1fffdd, 21), (0xfffe9, 20), (0x3fffdb, 22),
    (0x3fffdc, 22), (0x7fffe8, 23), (0x7fffe9, 23), (0x1fffde, 21),
    (0x7fffea, 23), (0x3fffdd, 22), (0x3fffde, 22), (0xfffff0, 24),
    (0x1fffdf, 21), (0x3fffdf, 22), (0x7fffeb, 23), (0x7fffec, 23),
    (0x1fffe0, 21), (0x1fffe1, 21), (0x3fffe0, 22), (0x1fffe2, 21),
    (0x7fffed, 23), (0x3fffe1, 22), (0x7fffee, 23), (0x7fffef, 23),
    (0xfffea, 20), (0x3fffe2, 22), (0x3fffe3, 22), (0x3fffe4, 22),
    (0x7ffff0, 23), (0x3fffe5, 22), (0x3fffe6, 22), (0x7ffff1, 23),
    (0x3ffffe0, 26), (0x3ffffe1, 26), (0xfffeb, 20), (0x7fff1, 19),
    (0x3fffe7, 22), (0x7ffff2, 23), (0x3fffe8, 22), (0x1ffffec, 25),
    (0x3ffffe2, 26), (0x3ffffe3, 26), (0x3ffffe4, 26), (0x7ffffde, 27),
    (0x7ffffdf, 27), (0x3ffffe5, 26), (0xfffff1, 24), (0x1ffffed, 25),
    (0x7fff2, 19), (0x1fffe3, 21), (0x3ffffe6, 26), (0x7ffffe0, 27),
    (0x7ffffe1, 27), (0x3ffffe7, 26), (0x7ffffe2, 27), (0xfffff2, 24),
    (0x1fffe4, 21), (0x1fffe5, 21), (0x3ffffe8, 26), (0x3ffffe9, 26),
    (0xffffffd, 28), (0x7ffffe3, 27), (0x7ffffe4, 27), (0x7ffffe5, 27),
    (0xfffec, 20), (0xfffff3, 24), (0xfffed, 20), (0x1fffe6, 21),
    (0x3fffe9, 22), (0x1fffe7, 21), (0x1fffe8, 21), (0x7ffff3, 23),
    (0x3fffea, 22), (0x3fffeb, 22), (0x1ffffee, 25), (0x1ffffef, 25),
    (0xfffff4, 24), (0xfffff5, 24), (0x3ffffea, 26), (0x7ffff4, 23),
    (0x3ffffeb, 26), (0x7ffffe6, 27), (0x3ffffec, 26), (0x3ffffed, 26),
    (0x7ffffe7, 27), (0x7ffffe8, 27), (0x7ffffe9, 27), (0x7ffffea, 27),
    (0x7ffffeb, 27), (0xffffffe, 28), (0x7ffffec, 27), (0x7ffffed, 27),
    (0x7ffffee, 27), (0x7ffffef, 27), (0x7fffff0, 27), (0x3ffffee, 26),
    (0x3fffffff, 30),
]


def _build_huffman_tree():
    # binary trie: node = [left, right]; leaves = symbol int
    root: list = [None, None]
    for sym, (code, length) in enumerate(_HUFFMAN[:256]):
        node = root
        for bit in range(length - 1, -1, -1):
            b = (code >> bit) & 1
            if bit == 0:
                node[b] = sym
            else:
                if node[b] is None:
                    node[b] = [None, None]
                node = node[b]
    return root


_HUFF_ROOT = _build_huffman_tree()


def huffman_decode(data: bytes) -> bytes:
    out = bytearray()
    node = _HUFF_ROOT
    for byte in data:
        for bit in range(7, -1, -1):
            node = node[(byte >> bit) & 1]
            if node is None:
                raise ValueError("bad huffman code")
            if isinstance(node, int):
                out.append(node)
                node = _HUFF_ROOT
    # trailing bits must be a prefix of EOS (all ones) — tolerated
    return bytes(out)


class HpackDecoder:
    """Response-side HPACK state: static + dynamic table, all literal
    forms, Huffman strings, table-size updates."""

    def __init__(self, max_size: int = 4096):
        self.dynamic: list[tuple[str, str]] = []
        self.max_size = max_size
        self.size = 0

    def _entry(self, idx: int) -> tuple[str, str]:
        if idx <= 0:
            raise ValueError("hpack index 0")
        if idx <= len(_STATIC):
            return _STATIC[idx - 1]
        didx = idx - len(_STATIC) - 1
        if didx >= len(self.dynamic):
            raise ValueError(f"hpack index {idx} out of range")
        return self.dynamic[didx]

    def _add(self, name: str, value: str) -> None:
        self.dynamic.insert(0, (name, value))
        self.size += len(name) + len(value) + 32
        while self.size > self.max_size and self.dynamic:
            n, v = self.dynamic.pop()
            self.size -= len(n) + len(v) + 32

    def decode(self, data: bytes) -> list[tuple[str, str]]:
        out: list[tuple[str, str]] = []
        i = 0
        while i < len(data):
            b = data[i]
            if b & 0x80:  # indexed
                idx, i = self._int(data, i, 7)
                out.append(self._entry(idx))
            elif b & 0x40:  # literal, incremental indexing
                idx, i = self._int(data, i, 6)
                name = self._entry(idx)[0] if idx else None
                if name is None:
                    name, i = self._string(data, i)
                value, i = self._string(data, i)
                self._add(name, value)
                out.append((name, value))
            elif b & 0x20:  # dynamic table size update
                new, i = self._int(data, i, 5)
                self.max_size = new
                while self.size > self.max_size and self.dynamic:
                    n, v = self.dynamic.pop()
                    self.size -= len(n) + len(v) + 32
            else:  # literal without indexing / never indexed
                idx, i = self._int(data, i, 4)
                name = self._entry(idx)[0] if idx else None
                if name is None:
                    name, i = self._string(data, i)
                value, i = self._string(data, i)
                out.append((name, value))
        return out

    @staticmethod
    def _int(data: bytes, i: int, prefix: int) -> tuple[int, int]:
        mask = (1 << prefix) - 1
        v = data[i] & mask
        i += 1
        if v < mask:
            return v, i
        shift = 0
        while True:
            b = data[i]
            i += 1
            v += (b & 0x7F) << shift
            if not b & 0x80:
                return v, i
            shift += 7

    def _string(self, data: bytes, i: int) -> tuple[str, int]:
        huff = bool(data[i] & 0x80)
        length, i = self._int(data, i, 7)
        raw = data[i:i + length]
        if len(raw) != length:
            raise ValueError("truncated hpack string")
        i += length
        if huff:
            raw = huffman_decode(raw)
        return raw.decode("utf-8", "replace"), i


def hpack_encode_raw(headers: list[tuple[str, str]]) -> bytes:
    """Request-side encoding: every field as 'literal without indexing,
    new name', raw strings — always legal, no encoder state."""
    out = bytearray()
    for name, value in headers:
        out.append(0x00)
        nb, vb = name.encode(), value.encode()
        out += _hpack_len(len(nb)) + nb
        out += _hpack_len(len(vb)) + vb
    return bytes(out)


def _hpack_len(n: int) -> bytes:
    if n < 127:
        return bytes([n])
    out = bytearray([127])
    n -= 127
    while n >= 128:
        out.append(n & 0x7F | 0x80)
        n >>= 7
    out.append(n)
    return bytes(out)


# ---------------------------------------------------------------------------
# HTTP/2 + gRPC
# ---------------------------------------------------------------------------

PREFACE = b"PRI * HTTP/2.0\r\n\r\nSM\r\n\r\n"
F_DATA, F_HEADERS, F_RST, F_SETTINGS = 0, 1, 3, 4
F_PING, F_GOAWAY, F_WINDOW_UPDATE, F_CONTINUATION = 6, 7, 8, 9
FLAG_END_STREAM, FLAG_END_HEADERS, FLAG_ACK, FLAG_PADDED = 1, 4, 1, 8


class GrpcError(IOError):
    def __init__(self, code: int, message: str):
        super().__init__(f"grpc-status {code}: {message}")
        self.code = code
        self.message = message


class GrpcChannel:
    """One h2c connection; unary calls serialized by a lock. Dead
    connections re-dial on the next call."""

    def __init__(self, host: str = "127.0.0.1", port: int = 2379,
                 timeout: float = 30.0, authority: str | None = None):
        self.host, self.port = host, int(port)
        self.timeout = timeout
        self.authority = authority or f"{host}:{port}"
        self._lock = threading.Lock()
        self._sock: socket.socket | None = None
        self._next_stream = 1
        self._decoder = HpackDecoder()
        self._recv_buf = b""
        self._max_frame = 16384
        self._send_window = 65535       # connection-level
        self._peer_initial_window = 65535
        self._stream_window = 65535     # the single active stream's

    # -- connection -----------------------------------------------------
    def _connect(self) -> socket.socket:
        if self._sock is not None:
            return self._sock
        s = socket.create_connection((self.host, self.port),
                                     timeout=self.timeout)
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        s.sendall(PREFACE + self._frame(F_SETTINGS, 0, 0, b""))
        self._sock = s
        self._next_stream = 1
        self._decoder = HpackDecoder()
        self._recv_buf = b""
        self._send_window = 65535
        self._peer_initial_window = 65535
        return s

    def _teardown(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            finally:
                self._sock = None

    def close(self) -> None:
        with self._lock:
            self._teardown()

    @staticmethod
    def _frame(ftype: int, flags: int, stream: int,
               payload: bytes) -> bytes:
        return struct.pack(">I", len(payload))[1:] + \
            bytes([ftype, flags]) + struct.pack(">I", stream) + payload

    def _read_frame(self, s) -> tuple[int, int, int, bytes]:
        while len(self._recv_buf) < 9:
            got = s.recv(64 << 10)
            if not got:
                raise IOError("h2 connection closed")
            self._recv_buf += got
        length = int.from_bytes(self._recv_buf[:3], "big")
        ftype, flags = self._recv_buf[3], self._recv_buf[4]
        stream = struct.unpack(">I", self._recv_buf[5:9])[0] & 0x7FFFFFFF
        while len(self._recv_buf) < 9 + length:
            got = s.recv(64 << 10)
            if not got:
                raise IOError("h2 connection closed mid-frame")
            self._recv_buf += got
        payload = self._recv_buf[9:9 + length]
        self._recv_buf = self._recv_buf[9 + length:]
        return ftype, flags, stream, payload

    def _handle_conn_frame(self, s, ftype: int, flags: int,
                           payload: bytes) -> None:
        """Frames any peer may interleave at any time."""
        if ftype == F_SETTINGS and not flags & FLAG_ACK:
            for off in range(0, len(payload) - 5, 6):
                ident, value = struct.unpack_from(">HI", payload, off)
                if ident == 5:  # MAX_FRAME_SIZE
                    self._max_frame = value
                elif ident == 4:
                    # INITIAL_WINDOW_SIZE applies RETROACTIVELY to open
                    # streams (RFC 7540 §6.9.2) — grpc-core grants its
                    # 4MB send window this way, never via per-stream
                    # WINDOW_UPDATE before the first consume
                    delta = value - self._peer_initial_window
                    self._peer_initial_window = value
                    self._stream_window += delta
            s.sendall(self._frame(F_SETTINGS, FLAG_ACK, 0, b""))
        elif ftype == F_PING and not flags & FLAG_ACK:
            s.sendall(self._frame(F_PING, FLAG_ACK, 0, payload))
        elif ftype == F_GOAWAY:
            raise IOError("h2 GOAWAY from server")
        elif ftype == F_WINDOW_UPDATE:
            self._send_window += struct.unpack(">I", payload)[0]

    # -- unary call -----------------------------------------------------
    def unary(self, path: str, request: bytes,
              metadata: list[tuple[str, str]] | None = None) -> bytes:
        """POST `path` (e.g. '/tikvpb.Tikv/RawGet') with one
        length-prefixed message; returns the response message bytes.
        Raises GrpcError on non-zero grpc-status, IOError on transport
        failure (after one reconnect attempt for idempotent retry by
        the caller)."""
        with self._lock:
            try:
                return self._unary_locked(path, request, metadata)
            except GrpcError:
                raise  # application status: the stream drained cleanly,
                # the connection is healthy — keep it
            except (OSError, IOError) as e:
                self._teardown()
                # one retry on a fresh connection (dead keep-alive)
                try:
                    return self._unary_locked(path, request, metadata)
                except GrpcError:
                    raise
                except (OSError, IOError) as e2:
                    self._teardown()
                    raise IOError(f"grpc {path}: {e2}") from e2

    def _unary_locked(self, path, request, metadata) -> bytes:
        s = self._connect()
        stream = self._next_stream
        self._next_stream += 2
        headers = [(":method", "POST"), (":scheme", "http"),
                   (":path", path), (":authority", self.authority),
                   ("content-type", "application/grpc"),
                   ("te", "trailers")]
        headers += list(metadata or [])
        s.sendall(self._frame(F_HEADERS, FLAG_END_HEADERS, stream,
                              hpack_encode_raw(headers)))
        # length-prefixed message: flag(0=uncompressed) + u32 length
        lpm = b"\x00" + struct.pack(">I", len(request)) + request
        self._stream_window = self._peer_initial_window
        pending: list[tuple[int, int, bytes]] = []
        off = 0
        while off < len(lpm):
            while min(self._send_window, self._stream_window) <= 0:
                # blocked on flow control: service frames until a
                # window opens; anything else for our stream (an early
                # error response) is buffered for _read_response
                ftype, flags, fstream, payload = self._read_frame(s)
                if fstream == 0:
                    self._handle_conn_frame(s, ftype, flags, payload)
                elif ftype == F_WINDOW_UPDATE and fstream == stream:
                    self._stream_window += \
                        struct.unpack(">I", payload)[0]
                elif ftype == F_RST and fstream == stream:
                    raise IOError(
                        f"h2 RST_STREAM "
                        f"{struct.unpack('>I', payload)[0]}")
                elif fstream == stream:
                    pending.append((ftype, flags, payload))
            take = min(len(lpm) - off, self._max_frame,
                       self._send_window, self._stream_window)
            last = off + take >= len(lpm)
            s.sendall(self._frame(F_DATA,
                                  FLAG_END_STREAM if last else 0,
                                  stream, lpm[off:off + take]))
            self._send_window -= take
            self._stream_window -= take
            off += take
        if not lpm:
            s.sendall(self._frame(F_DATA, FLAG_END_STREAM, stream, b""))
        return self._read_response(s, stream, pending)

    def _read_response(self, s, stream: int,
                       pending: list | None = None) -> bytes:
        body = bytearray()
        headers: list[tuple[str, str]] = []
        header_block = b""
        in_headers = False
        queued = list(pending or [])
        while True:
            if queued:
                ftype, flags, payload = queued.pop(0)
                fstream = stream
            else:
                ftype, flags, fstream, payload = self._read_frame(s)
            if fstream == 0:
                self._handle_conn_frame(s, ftype, flags, payload)
                continue
            if fstream != stream:
                continue  # no other streams are open; ignore strays
            if ftype == F_RST:
                raise IOError(
                    f"h2 RST_STREAM {struct.unpack('>I', payload)[0]}")
            if ftype == F_HEADERS:
                if flags & FLAG_PADDED:
                    pad = payload[0]
                    payload = payload[1:len(payload) - pad]
                if flags & 0x20:  # PRIORITY
                    payload = payload[5:]
                header_block = payload
                in_headers = not flags & FLAG_END_HEADERS
                if not in_headers:
                    headers += self._decoder.decode(header_block)
            elif ftype == F_CONTINUATION and in_headers:
                header_block += payload
                if flags & FLAG_END_HEADERS:
                    in_headers = False
                    headers += self._decoder.decode(header_block)
            elif ftype == F_DATA:
                if flags & FLAG_PADDED:
                    pad = payload[0]
                    payload = payload[1:len(payload) - pad]
                body += payload
                if payload:
                    # replenish both windows so the server never stalls
                    upd = struct.pack(">I", len(payload))
                    s.sendall(
                        self._frame(F_WINDOW_UPDATE, 0, 0, upd) +
                        self._frame(F_WINDOW_UPDATE, 0, stream, upd))
            if flags & FLAG_END_STREAM and not in_headers and \
                    ftype in (F_DATA, F_HEADERS, F_CONTINUATION):
                break
        hmap = {k: v for k, v in headers}
        status = int(hmap.get("grpc-status", "0") or 0)
        if status != 0:
            raise GrpcError(status, hmap.get("grpc-message", ""))
        if hmap.get(":status", "200") != "200":
            raise IOError(f"h2 :status {hmap.get(':status')}")
        if not body:
            return b""
        if body[0] != 0:
            raise IOError("compressed grpc response unsupported")
        (mlen,) = struct.unpack_from(">I", body, 1)
        msg = bytes(body[5:5 + mlen])
        if len(msg) != mlen:
            raise IOError("truncated grpc message")
        return msg
