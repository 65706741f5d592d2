"""AWS binary event-stream framing (application/vnd.amazon.eventstream);
the counterpart of seaweedfs_tpu/s3/eventstream.py.

The wire format of S3 SelectObjectContent responses: each message is

    [ total_len u32 | headers_len u32 | prelude_crc u32 ]
    [ headers ... ] [ payload ... ] [ message_crc u32 ]

with CRC32 (IEEE) over the prelude for prelude_crc and over the whole
message up to (but excluding) message_crc. Each header is

    [ name_len u8 | name | value_type u8 | value... ]

and Select only ever uses value type 7 (string: u16 length + bytes).
SeaweedFS's gateway does not implement SelectObjectContent (its query
engine sits behind the volume server's Query rpc,
weed/pb/volume_server.proto:107); this framing lets stock AWS SDK
clients parse the gateway's Select subset.
"""
from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass, field

HEADER_STRING = 7


def _encode_headers(headers: dict[str, str]) -> bytes:
    out = bytearray()
    for name, value in headers.items():
        nb, vb = name.encode(), value.encode()
        out.append(len(nb))
        out += nb
        out.append(HEADER_STRING)
        out += struct.pack(">H", len(vb))
        out += vb
    return bytes(out)


def encode_message(headers: dict[str, str], payload: bytes = b"") -> bytes:
    hdr = _encode_headers(headers)
    total = 4 + 4 + 4 + len(hdr) + len(payload) + 4
    prelude = struct.pack(">II", total, len(hdr))
    prelude_crc = struct.pack(">I", zlib.crc32(prelude))
    body = prelude + prelude_crc + hdr + payload
    return body + struct.pack(">I", zlib.crc32(body))


@dataclass
class Message:
    headers: dict[str, str] = field(default_factory=dict)
    payload: bytes = b""

    @property
    def event_type(self) -> str:
        return self.headers.get(":event-type", "")


def decode_messages(data: bytes) -> list[Message]:
    """Parse a byte string of concatenated messages (raises ValueError
    on framing or CRC errors)."""
    msgs = []
    pos = 0
    while pos < len(data):
        if len(data) - pos < 16:
            raise ValueError("truncated prelude")
        total, hdr_len = struct.unpack_from(">II", data, pos)
        (pre_crc,) = struct.unpack_from(">I", data, pos + 8)
        if zlib.crc32(data[pos:pos + 8]) != pre_crc:
            raise ValueError("prelude crc mismatch")
        if pos + total > len(data):
            raise ValueError("truncated message")
        (msg_crc,) = struct.unpack_from(">I", data, pos + total - 4)
        if zlib.crc32(data[pos:pos + total - 4]) != msg_crc:
            raise ValueError("message crc mismatch")
        headers = {}
        hp, hend = pos + 12, pos + 12 + hdr_len
        while hp < hend:
            nlen = data[hp]
            hp += 1
            name = data[hp:hp + nlen].decode()
            hp += nlen
            vtype = data[hp]
            hp += 1
            if vtype != HEADER_STRING:
                raise ValueError(f"unsupported header type {vtype}")
            (vlen,) = struct.unpack_from(">H", data, hp)
            hp += 2
            headers[name] = data[hp:hp + vlen].decode()
            hp += vlen
        payload = data[hend:pos + total - 4]
        msgs.append(Message(headers=headers, payload=payload))
        pos += total
    return msgs


# -- S3 Select event constructors --------------------------------------

def _event(event_type: str, payload: bytes = b"",
           content_type: str | None = None) -> bytes:
    headers = {":message-type": "event", ":event-type": event_type}
    if content_type:
        headers[":content-type"] = content_type
    return encode_message(headers, payload)


def records_event(data: bytes) -> bytes:
    return _event("Records", data, "application/octet-stream")


def stats_event(scanned: int, processed: int, returned: int) -> bytes:
    xml = (f"<Stats><BytesScanned>{scanned}</BytesScanned>"
           f"<BytesProcessed>{processed}</BytesProcessed>"
           f"<BytesReturned>{returned}</BytesReturned></Stats>")
    return _event("Stats", xml.encode(), "text/xml")


def cont_event() -> bytes:
    return _event("Cont")


def end_event() -> bytes:
    return _event("End")


def select_response(records: bytes, scanned: int, processed: int) -> bytes:
    """Full SelectObjectContent response body: Records* Stats End."""
    out = b""
    # AWS chunks records into <=1MB events; match that so huge results
    # don't produce one oversized frame
    CHUNK = 1 << 20
    for off in range(0, len(records), CHUNK):
        out += records_event(records[off:off + CHUNK])
    out += stats_event(scanned, processed, len(records))
    out += end_event()
    return out
