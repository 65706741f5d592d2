"""Minimal Cassandra CQL binary protocol v4 client (stdlib only).

Implemented from the public native-protocol spec
(cassandra/doc/native_protocol_v4.spec) for the cassandra filer store —
wire protocol #4 after redis RESP, the etcd v3 gateway, and MongoDB
OP_MSG, and the same zero-SDK approach. Covers what the store needs:
STARTUP (+ PLAIN SASL auth), QUERY/PREPARE/EXECUTE with bound values,
and RESULT rows decoding (void / rows / set_keyspace / prepared /
schema_change kinds).

Frame: version(1) flags(1) stream(i16) opcode(1) length(i32) body.
Requests use version 0x04, responses arrive as 0x84.

The port's copy of seaweedfs_tpu/filer/cql_lite.py: the same files, keys,
rows and request bytes, over the standard library only.
"""
from __future__ import annotations

import socket
import struct

# opcodes
OP_ERROR = 0x00
OP_STARTUP = 0x01
OP_READY = 0x02
OP_AUTHENTICATE = 0x03
OP_OPTIONS = 0x05
OP_SUPPORTED = 0x06
OP_QUERY = 0x07
OP_RESULT = 0x08
OP_PREPARE = 0x09
OP_EXECUTE = 0x0A
OP_AUTH_RESPONSE = 0x0F
OP_AUTH_SUCCESS = 0x10

CONSISTENCY_ONE = 0x0001
CONSISTENCY_LOCAL_QUORUM = 0x0006

RESULT_VOID = 1
RESULT_ROWS = 2
RESULT_SET_KEYSPACE = 3
RESULT_PREPARED = 4
RESULT_SCHEMA_CHANGE = 5


class CqlError(IOError):
    def __init__(self, code: int, message: str):
        super().__init__(f"cql error 0x{code:04x}: {message}")
        self.code = code
        self.message = message


# -- primitive encoders (spec section 3) --------------------------------

def enc_string(s: str) -> bytes:
    b = s.encode()
    return struct.pack(">H", len(b)) + b


def enc_long_string(s: str) -> bytes:
    b = s.encode()
    return struct.pack(">i", len(b)) + b


def enc_string_map(m: dict[str, str]) -> bytes:
    out = struct.pack(">H", len(m))
    for k, v in m.items():
        out += enc_string(k) + enc_string(v)
    return out


def enc_bytes(b: bytes | None) -> bytes:
    if b is None:
        return struct.pack(">i", -1)
    return struct.pack(">i", len(b)) + b


def enc_value(v) -> bytes:
    """Python value -> [bytes] in the type cassandra expects for the
    bound column: str->utf8, bytes->blob, int->int(4), None->null."""
    if v is None:
        return enc_bytes(None)
    if isinstance(v, bool):
        return enc_bytes(b"\x01" if v else b"\x00")
    if isinstance(v, int):
        return enc_bytes(struct.pack(">i", v))
    if isinstance(v, str):
        return enc_bytes(v.encode())
    if isinstance(v, (bytes, bytearray, memoryview)):
        return enc_bytes(bytes(v))
    raise TypeError(f"unsupported CQL value type {type(v)}")


class _Reader:
    def __init__(self, buf: bytes):
        self.buf = buf
        self.at = 0

    def take(self, n: int) -> bytes:
        b = self.buf[self.at:self.at + n]
        if len(b) != n:
            raise IOError("short CQL frame")
        self.at += n
        return b

    def u8(self) -> int:
        return self.take(1)[0]

    def u16(self) -> int:
        return struct.unpack(">H", self.take(2))[0]

    def i32(self) -> int:
        return struct.unpack(">i", self.take(4))[0]

    def string(self) -> str:
        return self.take(self.u16()).decode()

    def short_bytes(self) -> bytes:
        return self.take(self.u16())

    def bytes_(self) -> bytes | None:
        n = self.i32()
        return None if n < 0 else self.take(n)

    def skip_option(self) -> None:
        """Skip one type <option> (spec 4.2.5.2)."""
        tid = self.u16()
        if tid == 0x0000:  # custom: class name string
            self.string()
        elif tid in (0x0020, 0x0022):  # list / set: one inner option
            self.skip_option()
        elif tid == 0x0021:  # map: two inner options
            self.skip_option()
            self.skip_option()
        elif tid == 0x0030:  # UDT
            self.string()
            self.string()
            for _ in range(self.u16()):
                self.string()
                self.skip_option()
        elif tid == 0x0031:  # tuple
            for _ in range(self.u16()):
                self.skip_option()
        # all other ids are leaf types with no payload


class CqlClient:
    """One connection to a cassandra node, v4, synchronous."""

    def __init__(self, host: str, port: int = 9042, username: str = "",
                 password: str = "", keyspace: str = "",
                 timeout: float = 30.0):
        self._sock = socket.create_connection((host, int(port)), timeout)
        self._stream = 0
        self._startup(username, password)
        if keyspace:
            self.query(f'USE "{keyspace}"', consistency=CONSISTENCY_ONE)

    # -- framing --------------------------------------------------------
    def _send(self, opcode: int, body: bytes) -> None:
        self._stream = (self._stream + 1) % 32768
        hdr = struct.pack(">BBhBI", 0x04, 0, self._stream, opcode,
                          len(body))
        self._sock.sendall(hdr + body)

    def _recv_exact(self, n: int) -> bytes:
        out = b""
        while len(out) < n:
            piece = self._sock.recv(n - len(out))
            if not piece:
                raise IOError("cassandra connection closed")
            out += piece
        return out

    def _recv(self) -> tuple[int, bytes]:
        hdr = self._recv_exact(9)
        _ver, flags, stream, opcode, length = struct.unpack(">BBhBI", hdr)
        body = self._recv_exact(length)
        if stream != self._stream:
            # one request in flight at a time: a stray frame means the
            # connection is desynced (same contract as MongoWire)
            self.close()
            raise IOError(f"cql stream desync: {stream} != {self._stream}")
        if flags & 0x01:
            # compression is never negotiated in STARTUP, so a
            # compressed frame is unreadable
            self.close()
            raise IOError("unexpected compressed CQL frame")
        if flags & (0x02 | 0x08):
            # tracing id and/or server warnings prefix the body
            # (e.g. tombstone-scan warnings on RESULT frames); strip
            # them so the payload parse starts at the real body
            r = _Reader(body)
            if flags & 0x02:
                r.take(16)  # tracing uuid
            if flags & 0x08:
                for _ in range(r.u16()):  # [string list] of warnings
                    r.string()
            body = body[r.at:]
        if opcode == OP_ERROR:
            r = _Reader(body)
            raise CqlError(r.i32(), r.string())
        return opcode, body

    # -- handshake ------------------------------------------------------
    def _startup(self, username: str, password: str) -> None:
        self._send(OP_STARTUP, enc_string_map({"CQL_VERSION": "3.0.0"}))
        opcode, body = self._recv()
        if opcode == OP_AUTHENTICATE:
            # SASL PLAIN (PasswordAuthenticator)
            token = b"\x00" + username.encode() + b"\x00" + \
                password.encode()
            self._send(OP_AUTH_RESPONSE, enc_bytes(token))
            opcode, body = self._recv()
            if opcode != OP_AUTH_SUCCESS:
                raise IOError(f"cassandra auth failed (opcode {opcode})")
        elif opcode != OP_READY:
            raise IOError(f"unexpected startup reply opcode {opcode}")

    # -- queries --------------------------------------------------------
    @staticmethod
    def _query_params(values, consistency: int) -> bytes:
        out = struct.pack(">H", consistency)
        if values:
            out += bytes([0x01])  # flags: values follow
            out += struct.pack(">H", len(values))
            for v in values:
                out += enc_value(v)
        else:
            out += bytes([0x00])
        return out

    def query(self, cql: str, values: list | tuple = (),
              consistency: int = CONSISTENCY_LOCAL_QUORUM):
        self._send(OP_QUERY, enc_long_string(cql) +
                   self._query_params(values, consistency))
        return self._result(self._recv())

    def prepare(self, cql: str) -> bytes:
        self._send(OP_PREPARE, enc_long_string(cql))
        opcode, body = self._recv()
        r = _Reader(body)
        kind = r.i32()
        if kind != RESULT_PREPARED:
            raise IOError(f"PREPARE returned result kind {kind}")
        return r.short_bytes()  # metadata after the id is irrelevant

    def execute(self, stmt_id: bytes, values: list | tuple = (),
                consistency: int = CONSISTENCY_LOCAL_QUORUM):
        self._send(OP_EXECUTE, struct.pack(">H", len(stmt_id)) + stmt_id +
                   self._query_params(values, consistency))
        return self._result(self._recv())

    # -- RESULT decoding ------------------------------------------------
    def _result(self, frame):
        opcode, body = frame
        if opcode != OP_RESULT:
            raise IOError(f"unexpected opcode {opcode}")
        r = _Reader(body)
        kind = r.i32()
        if kind in (RESULT_VOID, RESULT_SET_KEYSPACE,
                    RESULT_SCHEMA_CHANGE):
            return None
        if kind != RESULT_ROWS:
            raise IOError(f"unexpected result kind {kind}")
        flags = r.i32()
        col_count = r.i32()
        if flags & 0x0002:  # has_more_pages
            r.bytes_()  # paging state (unused: LIMIT bounds our reads)
        names: list[str] = []
        if not flags & 0x0004:  # no_metadata unset -> specs present
            if flags & 0x0001:  # global_tables_spec
                r.string()
                r.string()
            for _ in range(col_count):
                if not flags & 0x0001:
                    r.string()
                    r.string()
                names.append(r.string())
                r.skip_option()
        rows_count = r.i32()
        rows = []
        for _ in range(rows_count):
            rows.append([r.bytes_() for _ in range(col_count)])
        return rows

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass
