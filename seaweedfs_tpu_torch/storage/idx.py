""".idx / .ecx index file IO: flat arrays of 16-byte (key, offset, size)
entries, big-endian.

Reference: weed/storage/idx/walk.go:12,45. Unlike the row-at-a-time Go
walker, reads are vectorized through a numpy structured dtype — the
whole index becomes three columns in one shot. Copy of
seaweedfs_tpu/storage/idx.py.
"""
from __future__ import annotations

from typing import Callable, Iterator

import numpy as np

from . import types as t

if t.OFFSET_SIZE == 4:
    # logical layout == disk layout
    IDX_DTYPE = np.dtype([("key", ">u8"), ("offset", ">u4"),
                          ("size", ">u4")])
    _RAW_DTYPE = IDX_DTYPE
else:
    # 5BytesOffset variant (offset_5bytes.go): on disk the offset is
    # 4 BE lower bytes then 1 high byte; in memory a uniform u8 column
    IDX_DTYPE = np.dtype([("key", ">u8"), ("offset", ">u8"),
                          ("size", ">u4")])
    _RAW_DTYPE = np.dtype([("key", ">u8"), ("off_lo", ">u4"),
                           ("off_hi", "u1"), ("size", ">u4")])
assert _RAW_DTYPE.itemsize == t.NEEDLE_MAP_ENTRY_SIZE


def parse_index_bytes(buf: bytes) -> np.ndarray:
    """Raw index bytes -> structured array (key, offset, size-u32)."""
    usable = (len(buf) // t.NEEDLE_MAP_ENTRY_SIZE) * \
        t.NEEDLE_MAP_ENTRY_SIZE
    raw = np.frombuffer(buf[:usable], dtype=_RAW_DTYPE)
    if _RAW_DTYPE is IDX_DTYPE:
        return raw
    arr = np.empty(len(raw), dtype=IDX_DTYPE)
    arr["key"] = raw["key"]
    arr["offset"] = (raw["off_hi"].astype(np.uint64) << 32) | \
        raw["off_lo"].astype(np.uint64)
    arr["size"] = raw["size"]
    return arr


def read_index(path: str) -> np.ndarray:
    """Whole index file -> structured array (key, offset, size-u32)."""
    with open(path, "rb") as f:
        buf = f.read()
    return parse_index_bytes(buf)


def write_index(path: str, entries: np.ndarray) -> None:
    entries = np.ascontiguousarray(entries, dtype=IDX_DTYPE)
    if _RAW_DTYPE is not IDX_DTYPE:
        raw = np.empty(len(entries), dtype=_RAW_DTYPE)
        raw["key"] = entries["key"]
        raw["off_lo"] = entries["offset"] & 0xFFFFFFFF
        raw["off_hi"] = entries["offset"] >> 32
        raw["size"] = entries["size"]
        entries = raw
    with open(path, "wb") as f:
        f.write(entries.tobytes())


def append_entry(f, key: int, offset: int, size: int) -> None:
    """Append one entry to an open binary file object."""
    f.write(t.NeedleValue(key, offset, size).to_bytes())


def walk(path: str, fn: Callable[[int, int, int], None],
         start_from: int = 0) -> None:
    """Visit (key, offset, signed size) for each entry in file order."""
    arr = read_index(path)
    for rec in arr[start_from:]:
        fn(int(rec["key"]), int(rec["offset"]), t.u32_to_size(int(rec["size"])))


def iter_entries(path: str) -> Iterator[t.NeedleValue]:
    arr = read_index(path)
    for rec in arr:
        yield t.NeedleValue(int(rec["key"]), int(rec["offset"]),
                            t.u32_to_size(int(rec["size"])))
