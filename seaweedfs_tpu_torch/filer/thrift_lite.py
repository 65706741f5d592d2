"""Minimal Apache Thrift client: binary protocol, buffered or framed
transport, generic value model — enough to speak the HBase Thrift1
gateway (mutateRow / getRowWithColumns / scannerOpenWithScan / ...).

The reference's hbase store rides the gohbase native RPC
(SeaweedFS weed/filer/hbase/hbase_store.go:39); every HBase
deployment also ships the Thrift gateway (port 9090), which is the
protocol class this tree had not written yet — implemented here from
the Thrift wire spec, zero SDK, same in-tree-protocol approach as
cql_lite / mysql_lite / kafka_lite.

Wire format (TBinaryProtocol, strict):
  message: i32 (0x80010000 | type)  string name  i32 seqid  <struct>
  struct:  fields (i8 type, i16 id, value...) terminated by STOP (0)
  types:   BOOL=2 BYTE=3 DOUBLE=4 I16=6 I32=8 I64=10 STRING=11
           STRUCT=12 MAP=13 SET=14 LIST=15
Values decode into a generic model: structs -> {field_id: value},
maps -> dict, lists/sets -> list, strings -> bytes.

The port's copy of seaweedfs_tpu/filer/thrift_lite.py: the same binary-
protocol bytes, over the standard library only.
"""
from __future__ import annotations

import socket
import struct
import threading

STOP, BOOL, BYTE, DOUBLE = 0, 2, 3, 4
I16, I32, I64, STRING, STRUCT, MAP, SET, LIST = 6, 8, 10, 11, 12, 13, 14, 15
MSG_CALL, MSG_REPLY, MSG_EXCEPTION = 1, 2, 3
VERSION_1 = 0x80010000


class Writer:
    """Append-only binary-protocol encoder."""

    def __init__(self):
        self.buf = bytearray()

    def message(self, name: str, seqid: int,
                mtype: int = MSG_CALL) -> "Writer":
        self.i32(VERSION_1 | mtype)
        self.string(name.encode())
        self.i32(seqid)
        return self

    def field(self, ftype: int, fid: int) -> "Writer":
        self.buf.append(ftype)
        self.buf += struct.pack(">h", fid)
        return self

    def stop(self) -> "Writer":
        self.buf.append(STOP)
        return self

    def bool_(self, v: bool) -> "Writer":
        self.buf.append(1 if v else 0)
        return self

    def i16(self, v: int) -> "Writer":
        self.buf += struct.pack(">h", v)
        return self

    def i32(self, v: int) -> "Writer":
        # wrap to signed: the message-version word is 0x8001xxxx
        self.buf += struct.pack(
            ">i", ((v + 0x80000000) & 0xFFFFFFFF) - 0x80000000)
        return self

    def i64(self, v: int) -> "Writer":
        self.buf += struct.pack(">q", v)
        return self

    def string(self, v: bytes) -> "Writer":
        self.buf += struct.pack(">i", len(v))
        self.buf += v
        return self

    def list_header(self, etype: int, n: int) -> "Writer":
        self.buf.append(etype)
        self.buf += struct.pack(">i", n)
        return self

    def map_header(self, ktype: int, vtype: int, n: int) -> "Writer":
        self.buf.append(ktype)
        self.buf.append(vtype)
        self.buf += struct.pack(">i", n)
        return self


class Truncated(IOError):
    """Message ends mid-value — the unframed transport reads more
    bytes on this, and ONLY this (structural corruption must not be
    mistaken for 'need more': that recv loop would never end)."""


class Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def _take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise Truncated("thrift: truncated message")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def u8(self) -> int:
        return self._take(1)[0]

    def i16(self) -> int:
        return struct.unpack(">h", self._take(2))[0]

    def i32(self) -> int:
        return struct.unpack(">i", self._take(4))[0]

    def i64(self) -> int:
        return struct.unpack(">q", self._take(8))[0]

    def string(self) -> bytes:
        n = self.i32()
        if n < 0:
            raise IOError("thrift: negative string length")
        return self._take(n)

    def value(self, ftype: int):
        if ftype == BOOL:
            return self.u8() != 0
        if ftype == BYTE:
            return self.u8()
        if ftype == DOUBLE:
            return struct.unpack(">d", self._take(8))[0]
        if ftype == I16:
            return self.i16()
        if ftype == I32:
            return self.i32()
        if ftype == I64:
            return self.i64()
        if ftype == STRING:
            return self.string()
        if ftype == STRUCT:
            return self.struct()
        if ftype == MAP:
            kt, vt = self.u8(), self.u8()
            n = self.i32()
            return {self._hashable(self.value(kt)): self.value(vt)
                    for _ in range(n)}
        if ftype in (SET, LIST):
            et = self.u8()
            n = self.i32()
            return [self.value(et) for _ in range(n)]
        raise IOError(f"thrift: unknown type {ftype}")

    @staticmethod
    def _hashable(v):
        return bytes(v) if isinstance(v, (bytearray, memoryview)) else v

    def struct(self) -> dict[int, object]:
        out: dict[int, object] = {}
        while True:
            ftype = self.u8()
            if ftype == STOP:
                return out
            fid = self.i16()
            out[fid] = self.value(ftype)


class ThriftError(IOError):
    """Server-side thrift exception (IOError / IllegalArgument /
    TApplicationException), surfaced with its message string."""


class ThriftClient:
    """One connection, binary protocol, thread-safe via a call lock
    (the filer store contract serializes per-call anyway). Reconnects
    on socket failure; the caller retries idempotent ops."""

    def __init__(self, host: str = "127.0.0.1", port: int = 9090,
                 framed: bool = False, timeout: float = 30.0):
        self.host, self.port = host, int(port)
        self.framed = framed
        self.timeout = timeout
        self._sock: socket.socket | None = None
        self._seq = 0
        self._lock = threading.Lock()

    def _connect(self) -> socket.socket:
        if self._sock is None:
            s = socket.create_connection((self.host, self.port),
                                         timeout=self.timeout)
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._sock = s
        return self._sock

    def close(self) -> None:
        with self._lock:
            self._close_locked()

    def _close_locked(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            finally:
                self._sock = None

    def _recv_exactly(self, s: socket.socket, n: int) -> bytes:
        out = bytearray()
        while len(out) < n:
            got = s.recv(n - len(out))
            if not got:
                raise IOError("thrift: connection closed")
            out += got
        return bytes(out)

    def call(self, name: str, build_args) -> object:
        """Invoke `name`; `build_args(w)` writes the argument struct
        fields (without the trailing stop). Returns the success value
        (field 0 of the reply struct; None for void). Raises
        ThriftError on declared exceptions, IOError on transport
        failure after one reconnect retry."""
        with self._lock:
            last: Exception | None = None
            for attempt in (0, 1):
                self._seq += 1
                w = Writer().message(name, self._seq)
                build_args(w)
                w.stop()
                payload = bytes(w.buf)
                if self.framed:
                    payload = struct.pack(">i", len(payload)) + payload
                try:
                    s = self._connect()
                    s.sendall(payload)
                    raw = self._read_reply(s)
                except (OSError, IOError) as e:
                    self._close_locked()  # _lock is already held here
                    last = e
                    continue
                return self._parse_reply(name, raw)
            raise IOError(f"thrift call {name}: {last}")

    def _read_reply(self, s: socket.socket) -> bytes:
        if self.framed:
            n = struct.unpack(">i", self._recv_exactly(s, 4))[0]
            if n < 0 or n > (64 << 20):
                raise IOError("thrift: bad frame length")
            return self._recv_exactly(s, n)
        # unframed (TBufferedTransport): the message has no length
        # prefix, so parse incrementally from a growing buffer until a
        # complete header+struct decodes. Only Truncated means "need
        # more bytes"; any other parse error is a non-Thrift peer and
        # fails immediately instead of recv-looping forever
        buf = bytearray(self._recv_exactly(s, 4))
        while True:
            try:
                r = Reader(bytes(buf))
                r.i32()      # version | message type
                r.string()   # method name
                r.i32()      # seqid
                r.struct()   # reply struct
                return bytes(buf[:r.pos])
            except Truncated:
                if len(buf) > (64 << 20):
                    raise IOError("thrift: reply exceeds 64MB")
                got = s.recv(64 << 10)
                if not got:
                    raise IOError("thrift: connection closed mid-reply")
                buf += got

    def _parse_reply(self, name: str, raw: bytes) -> object:
        r = Reader(raw)
        ver = r.i32()
        mtype = ver & 0xFF
        rname = r.string().decode("utf-8", "replace")
        r.i32()  # seqid
        if mtype == MSG_EXCEPTION:
            exc = r.struct()
            raise ThriftError(
                f"{name}: {exc.get(1, b'').decode('utf-8', 'replace')!s}")
        if rname != name:
            raise IOError(f"thrift: reply for {rname!r}, wanted {name!r}")
        result = r.struct()
        for fid, val in result.items():
            if fid != 0:
                msg = val.get(1, b"") if isinstance(val, dict) else val
                if isinstance(msg, (bytes, bytearray)):
                    msg = msg.decode("utf-8", "replace")
                raise ThriftError(f"{name}: {msg}")
        return result.get(0)
