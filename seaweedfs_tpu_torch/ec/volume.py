"""EC runtime objects: mounted shard sets served by a volume server.

A copy of seaweedfs_tpu/ec/volume.py. Equivalents of the reference's
weed/storage/erasure_coding/ec_volume.go (EcVolume: shards + .ecx
search + deletion journal), ec_shard.go (EcVolumeShard),
ec_volume_info.go (ShardBits bitmask), and the read path of
store_ec.go:136-229 — local interval reads plus hook points for remote
shard fetch and on-the-fly reconstruction (wired up in storage/store.py).
"""
from __future__ import annotations

import os
from bisect import bisect_left
from dataclasses import dataclass

import numpy as np

from ..storage import idx as idxmod
from ..storage import needle as ndl
from ..storage import types as t
from . import geometry as geo
from .decoder import read_ecj


class ShardBits:
    """uint32 bitmask of present shard ids (ec_volume_info.go:65)."""

    def __init__(self, bits: int = 0):
        self.bits = bits

    def add(self, *ids: int) -> "ShardBits":
        for i in ids:
            self.bits |= 1 << i
        return self

    def remove(self, *ids: int) -> "ShardBits":
        for i in ids:
            self.bits &= ~(1 << i)
        return self

    def has(self, i: int) -> bool:
        return bool(self.bits >> i & 1)

    def ids(self) -> list[int]:
        return [i for i in range(geo.MAX_SHARD_COUNT) if self.has(i)]

    def count(self) -> int:
        return bin(self.bits).count("1")

    def __repr__(self) -> str:
        return f"ShardBits({self.ids()})"

    def __eq__(self, other) -> bool:
        return isinstance(other, ShardBits) and self.bits == other.bits


@dataclass
class EcVolumeShard:
    collection: str
    vid: int
    shard_id: int
    path: str

    remote = False

    def __post_init__(self):
        self._f = open(self.path, "rb")
        self.size = os.path.getsize(self.path)

    def read_at(self, offset: int, size: int) -> bytes:
        """Positional reads: the shard is read from many request
        threads at once (degraded reads, shard_read, a partial rebuild
        of this server), so no shared file position moves. (The
        reference seeks then reads one shared file object, which two
        threads can interleave into wrong bytes.)"""
        fd = self._f.fileno()
        out = []
        while size > 0:
            piece = os.pread(fd, size, offset)
            if not piece:
                break
            out.append(piece)
            offset += len(piece)
            size -= len(piece)
        return b"".join(out)

    def close(self) -> None:
        self._f.close()


@dataclass
class RemoteEcShard:
    """A shard whose bytes live on a remote tier (cold storage): same
    read_at/size/close surface as EcVolumeShard, so the degraded-read
    ladder (local interval -> remote fan-out -> reconstruction) serves
    tiered volumes unchanged — a "local" interval read becomes a ranged
    read of the remote object. The .ecx/.ecj indexes stay on local
    disk, so needle location costs no remote round-trip."""

    collection: str
    vid: int
    shard_id: int
    key: str   # object key within the remote storage
    size: int  # shard byte length, recorded at offload time
    reader: "callable"  # fn(key, offset, size) -> bytes

    remote = True

    def read_at(self, offset: int, size: int) -> bytes:
        return self.reader(self.key, offset, size)

    def close(self) -> None:
        pass


class EcVolume:
    """A mounted EC volume: local shards, sorted .ecx index, .ecj
    deletion journal, and shard-size-derived geometry."""

    def __init__(self, dirname: str, collection: str, vid: int):
        self.dir = dirname
        self.collection = collection
        self.vid = vid
        self.shards: dict[int, EcVolumeShard] = {}
        base = self.base_name()
        # per-volume codec from the .vif sidecar (wide-code tier);
        # absent -> the RS(10,4) default
        from ..storage import volume_info as vinfo

        vi = vinfo.maybe_load_volume_info(base + ".vif")
        self.codec = vi.ec_codec if vi else ""
        self.code = geo.parse_code(self.codec)
        self.k, self.m = self.code.k, self.code.m
        self.total = self.k + self.m
        self._ecx = idxmod.read_index(base + ".ecx") if \
            os.path.exists(base + ".ecx") else np.empty(0, idxmod.IDX_DTYPE)
        self._keys = self._ecx["key"].astype(np.uint64)
        self.deleted: set[int] = set(read_ecj(base))
        # datSize is not persisted; derive the shard-file row split from
        # any present shard once mounted (shard_size = nL*LB + nS*SB)
        self._shard_size: int | None = None

    def base_name(self) -> str:
        name = f"{self.collection}_{self.vid}" if self.collection else \
            str(self.vid)
        return os.path.join(self.dir, name)

    # -- shard management ---------------------------------------------
    def mount_shard(self, shard_id: int) -> EcVolumeShard:
        if shard_id in self.shards:
            return self.shards[shard_id]
        path = self.base_name() + geo.shard_ext(shard_id)
        shard = EcVolumeShard(self.collection, self.vid, shard_id, path)
        self.shards[shard_id] = shard
        if self._shard_size is None:
            self._shard_size = shard.size
        return shard

    def mount_remote_shard(self, shard_id: int, key: str, size: int,
                           reader) -> RemoteEcShard:
        """Mount a shard backed by a remote object instead of a local
        file (tiered cold storage; manifest-driven, storage/store.py
        tier_offload_ec / restart rediscovery)."""
        prev = self.shards.get(shard_id)
        if prev is not None:
            prev.close()
        shard = RemoteEcShard(self.collection, self.vid, shard_id,
                              key, size, reader)
        self.shards[shard_id] = shard
        if self._shard_size is None:
            self._shard_size = shard.size
        return shard

    def unmount_shard(self, shard_id: int) -> None:
        s = self.shards.pop(shard_id, None)
        if s is not None:
            s.close()

    def shard_bits(self) -> ShardBits:
        return ShardBits().add(*self.shards)

    @property
    def shard_size(self) -> int:
        if self._shard_size is None:
            raise RuntimeError("no shard mounted yet")
        return self._shard_size

    def derived_dat_size(self) -> int:
        """Upper-bound .dat size consistent with the shard size.

        The interval math only needs the large/small row split. The
        encoder always emits >= 1 small row (its large loop exits at
        remaining <= 10*LB with remaining > 0) and <= 1024 small rows,
        so shard_size = nL*LB + nS*SB with nS in [1, 1024] decomposes
        uniquely, and row_layout(derived) reproduces exactly (nL, nS).
        """
        ss = self.shard_size
        n_large = ss // geo.LARGE_BLOCK
        n_small = (ss - n_large * geo.LARGE_BLOCK) // geo.SMALL_BLOCK
        if n_small == 0 and n_large > 0:
            # exact-LB shard size: encoder invariant nS >= 1 means this is
            # really (n_large-1) large rows + 1024 small rows
            n_large -= 1
            n_small = geo.LARGE_BLOCK // geo.SMALL_BLOCK
        return (n_large * geo.LARGE_BLOCK + n_small * geo.SMALL_BLOCK) * \
            self.k

    # -- needle lookup -------------------------------------------------
    def locate_needle(self, needle_id: int) -> tuple[int, int]:
        """Binary-search .ecx -> (byte offset in .dat space, size).
        Raises KeyError if absent or deleted (ec_volume.go:211,235)."""
        i = bisect_left(self._keys, needle_id)
        if i >= len(self._keys) or int(self._keys[i]) != needle_id:
            raise KeyError(f"needle {needle_id} not in ec volume {self.vid}")
        size = t.u32_to_size(int(self._ecx["size"][i]))
        if not t.size_is_valid(size) or needle_id in self.deleted:
            raise KeyError(f"needle {needle_id} deleted")
        return t.offset_to_actual(int(self._ecx["offset"][i])), size

    def needle_intervals(self, needle_id: int) -> tuple[list[geo.Interval], int]:
        offset, size = self.locate_needle(needle_id)
        disk = ndl.disk_size(size)
        return geo.locate(self.derived_dat_size(), offset, disk,
                          data_shards=self.k), size

    def live_needle_ids(self) -> list[tuple[int, int]]:
        """Live (needle_id, size) pairs from the .ecx minus .ecj
        tombstones — the EC side of volume.fsck's id census."""
        out = []
        for i in range(len(self._keys)):
            key = int(self._keys[i])
            size = t.u32_to_size(int(self._ecx["size"][i]))
            if t.size_is_valid(size) and key not in self.deleted:
                out.append((key, size))
        return out

    # -- reads ----------------------------------------------------------
    def read_interval_local(self, interval: geo.Interval) -> bytes | None:
        """Bytes for one interval if its shard is local, else None."""
        sid, off = interval.to_shard_and_offset()
        shard = self.shards.get(sid)
        if shard is None:
            return None
        return shard.read_at(off, interval.size)

    # -- deletes --------------------------------------------------------
    def delete_needle(self, needle_id: int) -> None:
        """Journal the deletion (.ecj append; ec_volume_delete.go:27)."""
        if needle_id in self.deleted:
            return
        with open(self.base_name() + ".ecj", "ab") as f:
            f.write(int(needle_id).to_bytes(8, "big"))
        self.deleted.add(needle_id)

    def close(self) -> None:
        for s in list(self.shards.values()):
            s.close()
        self.shards.clear()
