"""Decode EC shard files back into a volume .dat/.idx pair — the
counterpart of seaweedfs_tpu/ec/decoder.py.

Equivalent of the reference's ec_decoder.go (WriteDatFile :154,
WriteIdxFileFromEcIndex :18): concatenate data-shard blocks in stripe-row
order, truncating to the original .dat size; missing data shards are
regenerated first, through the codec (the CUDA kernel by default).
"""
from __future__ import annotations

import os

import numpy as np

from ..storage import idx as idxmod
from ..storage import needle as needle_mod
from ..storage import needle_map
from ..storage import types as t
from ..utils import tracing
from . import geometry as geo
from .backend import CodecBackend
from .encoder import codec_of, rebuild_ec_files


def write_dat_file(base: str, dat_size: int,
                   large_block: int = geo.LARGE_BLOCK,
                   small_block: int = geo.SMALL_BLOCK,
                   backend: str | CodecBackend = "cuda") -> None:
    """Reassemble `base`.dat from the volume's data shards. Missing data
    shards are regenerated first (rebuild_ec_files with only_shards, so
    absent parity files are left alone, as the reference's
    ReconstructData) under the `ec.rebuild_missing_data` span."""
    k, _m = codec_of(base)
    missing_data = [i for i in range(k)
                    if not os.path.exists(base + geo.shard_ext(i))]
    if missing_data:
        with tracing.span("ec.rebuild_missing_data", kind="internal"):
            rebuild_ec_files(base, backend=backend,
                             only_shards=missing_data)

    n_large, n_small = geo.row_layout(dat_size, large_block, small_block,
                                      data_shards=k)
    shards = [np.memmap(base + geo.shard_ext(i), dtype=np.uint8, mode="r")
              if os.path.getsize(base + geo.shard_ext(i)) else
              np.zeros(0, dtype=np.uint8) for i in range(k)]
    remaining = dat_size
    with open(base + ".dat", "wb") as out:
        shard_off = 0
        for block, rows in ((large_block, n_large), (small_block, n_small)):
            for _ in range(rows):
                for i in range(k):
                    take = min(block, remaining)
                    if take <= 0:
                        break
                    out.write(shards[i][shard_off:shard_off + take])
                    remaining -= take
                shard_off += block


def write_idx_from_ecx(base: str) -> None:
    """.ecx + .ecj deletions -> .idx (WriteIdxFileFromEcIndex,
    ec_decoder.go:18): copy the sorted entries, then append tombstones
    for journaled deletions."""
    arr = idxmod.read_index(base + ".ecx")
    deleted_keys = read_ecj(base)
    with open(base + ".idx", "wb") as f:
        f.write(arr.tobytes())
        for key in deleted_keys:
            f.write(t.NeedleValue(key, 0, t.TOMBSTONE_SIZE).to_bytes())


def read_ecj(base: str) -> list[int]:
    """.ecj deletion journal: flat big-endian uint64 needle keys
    (ec_volume_delete.go:27,51)."""
    path = base + ".ecj"
    if not os.path.exists(path):
        return []
    with open(path, "rb") as f:
        buf = f.read()
    usable = (len(buf) // 8) * 8
    return [int(x) for x in np.frombuffer(buf[:usable], dtype=">u8")]


def append_ecj(base: str, key: int) -> None:
    with open(base + ".ecj", "ab") as f:
        f.write(int(key).to_bytes(8, "big"))


def find_dat_size(base: str) -> int:
    """The original .dat size from the .ecx-indexed needles, as the
    reference derives it (ec_decoder.go FindDatFileSize): the largest
    live entry's offset + its padded record size."""
    db = needle_map.MemDb()
    db.load_from_idx(base + ".ecx")
    ends = [0]

    def visit(_key: int, off: int, size: int) -> None:
        if t.size_is_valid(size):
            ends.append(t.offset_to_actual(off)
                        + needle_entry_disk_size(size))

    db.ascending_visit(visit)
    return max(ends)


def needle_entry_disk_size(data_size: int) -> int:
    """Padded on-disk size of a needle record given its Size field:
    header(16) + body + checksum(4) [+ timestamp(8), v3] rounded up to 8
    (storage/needle.py)."""
    return needle_mod.disk_size(data_size)
