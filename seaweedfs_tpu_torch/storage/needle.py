"""Needle record format — the unit of storage in a volume .dat file; a
copy of seaweedfs_tpu/storage/needle.py.

Byte-compatible with the reference's Version2/Version3 layouts
(weed/storage/needle/needle_write.go:20-110, needle_read.go:15-23,
198-210):

    header:  cookie(4) id(8 BE) size(4 BE)
    body:    data_size(4) data flags(1)
             [name_size(1) name] [mime_size(1) mime]
             [last_modified(5 BE)] [ttl(2)] [pairs_size(2) pairs]
    tail:    crc32c(4 BE raw) [append_at_ns(8 BE), v3 only] padding to 8

`size` covers the body only; a body of size 0 (data_size absent) is an
empty/tombstone record. Padding length is the reference's exact quirk:
8 - (total % 8), i.e. a full 8 bytes when already aligned.

CRC is Castagnoli (crc32c) over the raw data bytes, stored big-endian as
the raw sum (the legacy `.Value()` transform is accepted on read for
compatibility, needle_read.go:76-80). The JAX package computes it with
google_crc32c; here it comes from the in-tree native library
(native/gf256_codec.cc `crc32c_update`, SSE4.2), built with g++ at first
use. If that library cannot be built, reading or writing a record with
data raises: there is no second CRC implementation to fall back to.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass, field

from .. import native
from . import types as t

VERSION2 = 2
VERSION3 = 3
CURRENT_VERSION = VERSION3

CHECKSUM_SIZE = 4
LAST_MODIFIED_BYTES = 5
TTL_BYTES = 2

FLAG_IS_COMPRESSED = 0x01
FLAG_HAS_NAME = 0x02
FLAG_HAS_MIME = 0x04
FLAG_HAS_LAST_MODIFIED = 0x08
FLAG_HAS_TTL = 0x10
FLAG_HAS_PAIRS = 0x20
FLAG_IS_CHUNK_MANIFEST = 0x80


def crc32c(data: bytes, initial: int = 0) -> int:
    """CRC32C of `data`, continuing from `initial` (google_crc32c's
    value / extend)."""
    return native.crc32c(data, initial)


def legacy_crc_value(c: int) -> int:
    """Deprecated on-disk transform still accepted on read
    (needle/crc.go:26-28)."""
    return (((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def padding_length(size: int, version: int = CURRENT_VERSION) -> int:
    total = t.NEEDLE_HEADER_SIZE + size + CHECKSUM_SIZE
    if version == VERSION3:
        total += t.TIMESTAMP_SIZE
    return t.NEEDLE_PADDING - (total % t.NEEDLE_PADDING)


def body_length(size: int, version: int = CURRENT_VERSION) -> int:
    n = size + CHECKSUM_SIZE + padding_length(size, version)
    if version == VERSION3:
        n += t.TIMESTAMP_SIZE
    return n


def disk_size(size: int, version: int = CURRENT_VERSION) -> int:
    """Total on-disk record bytes (GetActualSize, needle_read.go:206)."""
    return t.NEEDLE_HEADER_SIZE + body_length(size, version)


@dataclass
class Needle:
    id: int = 0
    cookie: int = 0
    data: bytes = b""
    name: bytes = b""
    mime: bytes = b""
    pairs: bytes = b""
    flags: int = 0
    last_modified: int = 0     # unix seconds, 5 bytes stored
    ttl: bytes = b"\x00\x00"   # (count, unit) stored pair
    checksum: int = 0
    append_at_ns: int = 0
    size: int = field(default=0, init=False)  # body size, set on write/read

    # -- flag helpers -------------------------------------------------
    def has(self, flag: int) -> bool:
        return bool(self.flags & flag)

    def set_flag(self, flag: int, on: bool = True) -> None:
        if on:
            self.flags |= flag
        else:
            self.flags &= ~flag

    @property
    def is_compressed(self) -> bool:
        return self.has(FLAG_IS_COMPRESSED)

    @property
    def is_chunk_manifest(self) -> bool:
        return self.has(FLAG_IS_CHUNK_MANIFEST)

    # -- serialization ------------------------------------------------
    def _computed_size(self) -> int:
        if not self.data:
            return 0
        size = 4 + len(self.data) + 1
        if self.flags & FLAG_HAS_NAME and self.name:
            size += 1 + min(len(self.name), 255)
        if self.flags & FLAG_HAS_MIME and self.mime:
            size += 1 + len(self.mime)
        if self.flags & FLAG_HAS_LAST_MODIFIED:
            size += LAST_MODIFIED_BYTES
        if self.flags & FLAG_HAS_TTL:
            size += TTL_BYTES
        if self.flags & FLAG_HAS_PAIRS and self.pairs:
            size += 2 + len(self.pairs)
        return size

    def to_bytes(self, version: int = CURRENT_VERSION) -> bytes:
        """Full padded on-disk record."""
        if version not in (VERSION2, VERSION3):
            raise ValueError(f"unsupported needle version {version}")
        if len(self.mime) > 255:
            raise ValueError(
                f"mime too long ({len(self.mime)} bytes, max 255)")
        if len(self.pairs) > 0xFFFF:
            raise ValueError(
                f"pairs too long ({len(self.pairs)} bytes, max 65535)")
        if len(self.data) > 0xFFFFFFFF - 1024:
            raise ValueError("needle data exceeds 4GB limit")
        # auto-set presence flags from populated fields
        if self.name:
            self.flags |= FLAG_HAS_NAME
        if self.mime:
            self.flags |= FLAG_HAS_MIME
        if self.last_modified:
            self.flags |= FLAG_HAS_LAST_MODIFIED
        if self.ttl != b"\x00\x00":
            self.flags |= FLAG_HAS_TTL
        if self.pairs:
            self.flags |= FLAG_HAS_PAIRS

        self.size = self._computed_size()
        self.checksum = crc32c(self.data) if self.data else 0

        out = bytearray()
        out += struct.pack(">IQ", self.cookie, self.id)
        out += struct.pack(">I", t.size_to_u32(self.size))
        if self.size:
            out += struct.pack(">I", len(self.data))
            out += self.data
            out.append(self.flags & 0xFF)
            if self.flags & FLAG_HAS_NAME and self.name:
                name = self.name[:255]
                out.append(len(name))
                out += name
            if self.flags & FLAG_HAS_MIME and self.mime:
                out.append(len(self.mime))
                out += self.mime
            if self.flags & FLAG_HAS_LAST_MODIFIED:
                out += self.last_modified.to_bytes(8, "big")[-LAST_MODIFIED_BYTES:]
            if self.flags & FLAG_HAS_TTL:
                out += self.ttl[:TTL_BYTES]
            if self.flags & FLAG_HAS_PAIRS and self.pairs:
                out += struct.pack(">H", len(self.pairs))
                out += self.pairs
        out += struct.pack(">I", self.checksum)
        if version == VERSION3:
            out += struct.pack(">Q", self.append_at_ns)
        out += b"\x00" * padding_length(self.size, version)
        return bytes(out)

    @classmethod
    def from_bytes(cls, blob: bytes, version: int = CURRENT_VERSION,
                   verify_crc: bool = True) -> "Needle":
        """Parse a full on-disk record (header + body)."""
        n = cls()
        cookie, nid, size_u32 = struct.unpack_from(">IQI", blob, 0)
        n.cookie, n.id = cookie, nid
        size = t.u32_to_size(size_u32)
        n.size = size
        if size <= 0:
            return n
        body = blob[t.NEEDLE_HEADER_SIZE:t.NEEDLE_HEADER_SIZE + size]
        try:
            n._parse_body(body)
        except (IndexError, struct.error) as e:
            # a flipped length byte must read as corruption, not crash
            raise ValueError(f"corrupt needle body: {e}") from e
        stored_crc = struct.unpack_from(
            ">I", blob, t.NEEDLE_HEADER_SIZE + size)[0]
        if verify_crc and n.data:
            actual = crc32c(n.data)
            if stored_crc not in (actual, legacy_crc_value(actual)):
                raise ValueError("CRC error: data on disk corrupted")
            n.checksum = actual
        if version == VERSION3 and len(blob) >= t.NEEDLE_HEADER_SIZE + size + 12:
            n.append_at_ns = struct.unpack_from(
                ">Q", blob, t.NEEDLE_HEADER_SIZE + size + 4)[0]
        return n

    def _parse_body(self, body: bytes) -> None:
        (data_size,) = struct.unpack_from(">I", body, 0)
        idx = 4
        self.data = body[idx:idx + data_size]
        self._parse_meta(body, idx + data_size)

    def _parse_meta(self, body: bytes, idx: int) -> None:
        """Parse the post-data fields ([flags][name][mime][lm][ttl]
        [pairs]) starting at `idx`. Split out so the streaming read
        path can parse metadata from a small tail pread without the
        data bytes in memory."""
        self.flags = body[idx]
        idx += 1
        if self.flags & FLAG_HAS_NAME:
            ln = body[idx]
            idx += 1
            self.name = body[idx:idx + ln]
            idx += ln
        if self.flags & FLAG_HAS_MIME:
            lm = body[idx]
            idx += 1
            self.mime = body[idx:idx + lm]
            idx += lm
        if self.flags & FLAG_HAS_LAST_MODIFIED:
            self.last_modified = int.from_bytes(
                body[idx:idx + LAST_MODIFIED_BYTES], "big")
            idx += LAST_MODIFIED_BYTES
        if self.flags & FLAG_HAS_TTL:
            self.ttl = body[idx:idx + TTL_BYTES]
            idx += TTL_BYTES
        if self.flags & FLAG_HAS_PAIRS:
            (lp,) = struct.unpack_from(">H", body, idx)
            idx += 2
            self.pairs = body[idx:idx + lp]
            idx += lp

    def etag(self) -> str:
        return f"{self.checksum:08x}"


def whole_records_prefix(data, version: int = CURRENT_VERSION) -> int:
    """Length of the longest prefix of `data` (bytes or bytearray) that
    is whole needle records — the framing rule for record streams
    (incremental copy / tail), which carry no explicit framing because
    records self-describe via their headers."""
    off = 0
    while off + t.NEEDLE_HEADER_SIZE <= len(data):
        _, _, size_u32 = struct.unpack_from(">IQI", data, off)
        nsize = max(t.u32_to_size(size_u32), 0)
        disk = disk_size(nsize, version)
        if off + disk > len(data):
            break
        off += disk
    return off
