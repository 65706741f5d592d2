"""Volume super block: the 8-byte header of every .dat file; a copy of
seaweedfs_tpu/storage/super_block.py.

Byte-compatible with weed/storage/super_block/super_block.go:16-23:
[version, replica placement byte, ttl(2),
compaction revision(2 BE), extra size(2 BE)] (+ optional protobuf extra,
which we keep as opaque bytes).
"""
from __future__ import annotations

import struct
from dataclasses import dataclass, field

SUPER_BLOCK_SIZE = 8


@dataclass(frozen=True)
class ReplicaPlacement:
    """xyz-digit placement: x=other DCs, y=other racks, z=other servers
    in-rack (replica_placement.go:8-31)."""

    diff_dc: int = 0
    diff_rack: int = 0
    same_rack: int = 0

    @classmethod
    def parse(cls, s: str) -> "ReplicaPlacement":
        s = (s or "000").rjust(3, "0")
        d = [int(c) for c in s]
        if any(not 0 <= c <= 2 for c in d):
            raise ValueError(f"unknown replication type {s!r}")
        return cls(diff_dc=d[0], diff_rack=d[1], same_rack=d[2])

    @classmethod
    def from_byte(cls, b: int) -> "ReplicaPlacement":
        return cls.parse(f"{b:03d}")

    def to_byte(self) -> int:
        return self.diff_dc * 100 + self.diff_rack * 10 + self.same_rack

    def __str__(self) -> str:
        return f"{self.diff_dc}{self.diff_rack}{self.same_rack}"

    @property
    def copy_count(self) -> int:
        return self.diff_dc + self.diff_rack + self.same_rack + 1


@dataclass
class SuperBlock:
    version: int = 3
    replica_placement: ReplicaPlacement = field(default_factory=ReplicaPlacement)
    ttl: bytes = b"\x00\x00"
    compaction_revision: int = 0
    extra: bytes = b""

    def to_bytes(self) -> bytes:
        header = struct.pack(
            ">BB2sHH", self.version, self.replica_placement.to_byte(),
            self.ttl[:2].ljust(2, b"\x00"), self.compaction_revision,
            len(self.extra))
        return header + self.extra

    @property
    def block_size(self) -> int:
        return SUPER_BLOCK_SIZE + (len(self.extra) if self.version >= 2 else 0)

    @classmethod
    def from_bytes(cls, header: bytes) -> "SuperBlock":
        if len(header) < SUPER_BLOCK_SIZE:
            raise ValueError("super block truncated")
        version, rp_byte, ttl, rev, extra_size = struct.unpack_from(
            ">BB2sHH", header, 0)
        sb = cls(version=version,
                 replica_placement=ReplicaPlacement.from_byte(rp_byte),
                 ttl=ttl, compaction_revision=rev)
        if extra_size:
            sb.extra = header[SUPER_BLOCK_SIZE:SUPER_BLOCK_SIZE + extra_size]
        return sb

    @classmethod
    def read_from(cls, f) -> "SuperBlock":
        pos = f.tell()
        f.seek(0)
        head = f.read(SUPER_BLOCK_SIZE)
        if len(head) < SUPER_BLOCK_SIZE:
            f.seek(pos)
            raise ValueError("super block truncated")
        extra_size = struct.unpack_from(">H", head, 6)[0]
        extra = f.read(extra_size) if extra_size else b""
        f.seek(pos)
        return cls.from_bytes(head + extra)
