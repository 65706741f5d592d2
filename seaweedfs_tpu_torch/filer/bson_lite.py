"""Minimal BSON + MongoDB OP_MSG wire codec (stdlib only).

Implemented from the public BSON spec (bsonspec.org) and the MongoDB
wire-protocol documentation for the mongodb filer store — the same
zero-SDK approach as the redis RESP and etcd gateway stores. Covers the
types the store needs: document, array, utf8 string, binary (subtype
0), int32/int64, double, bool, null.

OP_MSG framing: (messageLength, requestID, responseTo, opCode=2013)
then flagBits:int32 and one section of kind 0 (a single BSON document).

The port's copy of seaweedfs_tpu/filer/bson_lite.py: the same files, keys,
rows and request bytes, over the standard library only.
"""
from __future__ import annotations

import itertools
import socket
import struct

OP_MSG = 2013
_req_ids = itertools.count(1)


class MongoError(IOError):
    """Server-side {ok: 0} reply. The connection stays synced (the
    full reply was read) — callers must not treat this as a transport
    failure worth a reconnect."""


class Int64(int):
    """Force int64 encoding: some wire fields (getMore's cursor id)
    must be BSON type long even when the value fits in 31 bits."""


# -- BSON ---------------------------------------------------------------

def _enc_cstring(s: str) -> bytes:
    b = s.encode()
    if b"\x00" in b:
        raise ValueError("BSON keys cannot contain NUL")
    return b + b"\x00"


def _enc_value(key: str, v) -> bytes:
    k = _enc_cstring(key)
    if isinstance(v, bool):  # before int: bool is an int subclass
        return b"\x08" + k + (b"\x01" if v else b"\x00")
    if isinstance(v, Int64):
        return b"\x12" + k + struct.pack("<q", v)
    if isinstance(v, int):
        if -(1 << 31) <= v < (1 << 31):
            return b"\x10" + k + struct.pack("<i", v)
        return b"\x12" + k + struct.pack("<q", v)
    if isinstance(v, float):
        return b"\x01" + k + struct.pack("<d", v)
    if isinstance(v, str):
        b = v.encode()
        return b"\x02" + k + struct.pack("<i", len(b) + 1) + b + b"\x00"
    if isinstance(v, (bytes, bytearray, memoryview)):
        b = bytes(v)
        return b"\x05" + k + struct.pack("<i", len(b)) + b"\x00" + b
    if v is None:
        return b"\x0a" + k
    if isinstance(v, dict):
        return b"\x03" + k + encode_doc(v)
    if isinstance(v, (list, tuple)):
        inner = b"".join(_enc_value(str(i), x) for i, x in enumerate(v))
        return b"\x04" + k + struct.pack(
            "<i", len(inner) + 5) + inner + b"\x00"
    raise TypeError(f"bson_lite cannot encode {type(v)!r}")


def encode_doc(doc: dict) -> bytes:
    body = b"".join(_enc_value(k, v) for k, v in doc.items())
    return struct.pack("<i", len(body) + 5) + body + b"\x00"


def _dec_value(t: int, buf: bytes, at: int):
    if t == 0x01:
        return struct.unpack_from("<d", buf, at)[0], at + 8
    if t == 0x02:
        n = struct.unpack_from("<i", buf, at)[0]
        return buf[at + 4:at + 3 + n].decode(), at + 4 + n
    if t in (0x03, 0x04):
        n = struct.unpack_from("<i", buf, at)[0]
        inner = decode_doc(buf[at:at + n])
        if t == 0x04:
            inner = [inner[k] for k in sorted(inner, key=int)]
        return inner, at + n
    if t == 0x05:
        n = struct.unpack_from("<i", buf, at)[0]
        return buf[at + 5:at + 5 + n], at + 5 + n
    if t == 0x08:
        return buf[at] != 0, at + 1
    if t == 0x0a:
        return None, at
    if t == 0x10:
        return struct.unpack_from("<i", buf, at)[0], at + 4
    if t == 0x12:
        return struct.unpack_from("<q", buf, at)[0], at + 8
    raise ValueError(f"bson_lite cannot decode type 0x{t:02x}")


def decode_doc(buf: bytes) -> dict:
    out: dict = {}
    at = 4
    while buf[at] != 0:
        t = buf[at]
        end = buf.index(b"\x00", at + 1)
        key = buf[at + 1:end].decode()
        out[key], at = _dec_value(t, buf, end + 1)
    return out


# -- OP_MSG -------------------------------------------------------------

class MongoWire:
    """One mongod connection speaking OP_MSG kind-0 commands."""

    def __init__(self, host: str, port: int, timeout: float = 30.0):
        self._sock = socket.create_connection((host, port), timeout)

    def command(self, doc: dict) -> dict:
        payload = b"\x00\x00\x00\x00\x00" + encode_doc(doc)
        rid = next(_req_ids)
        header = struct.pack("<iiii", 16 + len(payload), rid, 0, OP_MSG)
        self._sock.sendall(header + payload)
        raw = self._recv_exact(16)
        length, _reply_id, response_to, _op = struct.unpack_from(
            "<iiii", raw)
        if response_to != rid:
            # a stray frame (e.g. the unread reply left behind by an
            # earlier timeout) must not be attributed to this command;
            # the connection is desynced beyond recovery
            self.close()
            raise IOError(
                f"mongodb reply desync: responseTo {response_to} "
                f"!= requestID {rid}")
        body = self._recv_exact(length - 16)
        # flagBits:4 then kind byte then the reply document
        if body[4] != 0:
            raise IOError("unexpected OP_MSG section kind")
        reply = decode_doc(body[5:])
        if reply.get("ok") != 1:  # 1 == 1.0 covers the double form
            raise MongoError(f"mongodb error: {reply}")
        return reply

    def _recv_exact(self, n: int) -> bytes:
        out = b""
        while len(out) < n:
            piece = self._sock.recv(n - len(out))
            if not piece:
                raise IOError("mongodb connection closed")
            out += piece
        return out

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass
