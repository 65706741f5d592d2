"""Needle record size arithmetic — the part of seaweedfs_tpu/storage/
needle.py that the EC decoder needs to find a volume's end.

A needle record in a volume .dat (Version2/Version3 layouts,
weed/storage/needle/needle_write.go:20-110, needle_read.go:198-210):

    header:  cookie(4) id(8 BE) size(4 BE)
    body:    `size` bytes
    tail:    crc32c(4) [append_at_ns(8), v3 only] padding to 8

Padding length is the reference's exact quirk: 8 - (total % 8), i.e. a
full 8 bytes when already aligned. The record codec itself (and its
CRC32C) comes with the storage layer.
"""
from __future__ import annotations

from . import types as t

VERSION2 = 2
VERSION3 = 3
CURRENT_VERSION = VERSION3

CHECKSUM_SIZE = 4


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
