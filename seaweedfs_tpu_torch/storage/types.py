"""Core storage value types and on-disk constants — a copy of
seaweedfs_tpu/storage/types.py.

Byte-compatible with the reference formats (weed/storage/types/
needle_types.go:33-40, offset_4bytes.go:14-17 / offset_5bytes.go:14-17).
Offsets are stored in units of NEEDLE_PADDING (8 bytes); the default
4-byte big-endian form gives a 32GB max volume. WEED_5BYTES_OFFSET=1 in
the environment selects the reference's `5BytesOffset` build-tag
variant: 17-byte index entries whose offset is 4 BE lower bytes
followed by one high byte. Like the build tag, the choice is
process-wide and must match the files on disk. Sizes are int32 with -1
as the tombstone marker.
"""
from __future__ import annotations

import os as _os
from dataclasses import dataclass

NEEDLE_ID_SIZE = 8
OFFSET_SIZE = 5 if _os.environ.get("WEED_5BYTES_OFFSET") == "1" else 4
SIZE_SIZE = 4
COOKIE_SIZE = 4
NEEDLE_PADDING = 8
NEEDLE_HEADER_SIZE = COOKIE_SIZE + NEEDLE_ID_SIZE + SIZE_SIZE  # 16
NEEDLE_MAP_ENTRY_SIZE = NEEDLE_ID_SIZE + OFFSET_SIZE + SIZE_SIZE  # 16 / 17
TIMESTAMP_SIZE = 8
TOMBSTONE_SIZE = -1  # Size value marking a deleted needle
SIZE_MASK = 0xFFFFFFFF
# 32GB with 4-byte padded offsets; 8TiB with 5
MAX_VOLUME_SIZE = NEEDLE_PADDING * (1 << (8 * OFFSET_SIZE))


def offset_to_disk_bytes(offset: int) -> bytes:
    """Stored (padded-unit) offset -> its on-disk index encoding."""
    if OFFSET_SIZE == 4:
        return offset.to_bytes(4, "big")
    return (offset & 0xFFFFFFFF).to_bytes(4, "big") + \
        bytes([offset >> 32])


def disk_bytes_to_offset(b: bytes) -> int:
    if OFFSET_SIZE == 4:
        return int.from_bytes(b[:4], "big")
    return (b[4] << 32) | int.from_bytes(b[:4], "big")


def size_is_deleted(size: int) -> bool:
    return size < 0 or size == TOMBSTONE_SIZE


def size_is_valid(size: int) -> bool:
    return size > 0 and size != TOMBSTONE_SIZE


def size_to_u32(size: int) -> int:
    return size & SIZE_MASK


def u32_to_size(u: int) -> int:
    """Stored uint32 -> signed Size."""
    return u - (1 << 32) if u & 0x80000000 else u


def offset_to_actual(stored: int) -> int:
    """Stored (padded-unit) offset -> byte offset in the volume file."""
    return stored * NEEDLE_PADDING


def actual_to_offset(byte_offset: int) -> int:
    if byte_offset % NEEDLE_PADDING:
        raise ValueError(f"offset {byte_offset} not {NEEDLE_PADDING}-aligned")
    stored = byte_offset // NEEDLE_PADDING
    if stored >= 1 << (8 * OFFSET_SIZE):
        raise ValueError(f"offset {byte_offset} exceeds max volume size")
    return stored


@dataclass(frozen=True)
class NeedleValue:
    """One needle-map entry: (key, stored offset, size)."""

    key: int          # NeedleId, uint64
    offset: int       # stored units of NEEDLE_PADDING
    size: int         # signed; TOMBSTONE_SIZE or negative = deleted

    def to_bytes(self) -> bytes:
        return (self.key.to_bytes(NEEDLE_ID_SIZE, "big")
                + offset_to_disk_bytes(self.offset)
                + size_to_u32(self.size).to_bytes(SIZE_SIZE, "big"))

    @classmethod
    def from_bytes(cls, b: bytes) -> "NeedleValue":
        key = int.from_bytes(b[:8], "big")
        offset = disk_bytes_to_offset(b[8:8 + OFFSET_SIZE])
        size = u32_to_size(int.from_bytes(
            b[8 + OFFSET_SIZE:8 + OFFSET_SIZE + SIZE_SIZE], "big"))
        return cls(key, offset, size)


def format_file_id(volume_id: int, key: int, cookie: int) -> str:
    """'vid,khexchex' — reference fid string (needle/file_id.go)."""
    return f"{volume_id},{key:x}{cookie:08x}"


def parse_file_id(fid: str) -> tuple[int, int, int]:
    """fid string -> (volume_id, key, cookie). A `_N` suffix adds N to
    the key (needle.go ParsePath:121-141) — that's how clients address
    the extra slots of an `assign?count=N` batch: fid, fid_1, ...,
    fid_{N-1}."""
    vid_s, _, rest = fid.partition(",")
    delta = 0
    if "_" in rest:
        rest, _, delta_s = rest.rpartition("_")
        try:
            delta = int(delta_s)
        except ValueError:
            raise ValueError(f"bad file id delta {fid!r}") from None
    if not rest or len(rest) <= 8:
        raise ValueError(f"bad file id {fid!r}")
    volume_id = int(vid_s)
    key = int(rest[:-8], 16) + delta
    cookie = int(rest[-8:], 16)
    return volume_id, key, cookie
