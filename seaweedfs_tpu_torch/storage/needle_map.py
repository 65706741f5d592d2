"""The sorted-visit needle map — MemDb of seaweedfs_tpu/storage/
needle_map.py, the one map the EC lifecycle needs.

MemDb mirrors the reference's needle_map/memdb.go: a key -> (offset,
size) map replayed from an .idx log, visited in ascending key order to
produce sorted .ecx files (weed/storage/erasure_coding/
ec_encoder.go:27-55). The live volume maps (NeedleMap,
CompactNeedleMap, BtreeNeedleMap) come with the storage layer.
"""
from __future__ import annotations

from typing import Callable

import numpy as np

from . import idx as idxmod
from . import types as t


class MemDb:
    """Sorted-visit map used for .ecx generation and idx compaction."""

    def __init__(self) -> None:
        self._m: dict[int, tuple[int, int]] = {}

    def set(self, key: int, offset: int, size: int) -> None:
        self._m[key] = (offset, size)

    def delete(self, key: int) -> None:
        self._m.pop(key, None)

    def get(self, key: int) -> tuple[int, int] | None:
        return self._m.get(key)

    def __len__(self) -> int:
        return len(self._m)

    def ascending_visit(self, fn: Callable[[int, int, int], None]) -> None:
        for key in sorted(self._m):
            off, size = self._m[key]
            fn(key, off, size)

    def load_from_idx(self, idx_path: str) -> None:
        """Replay .idx: valid entries set, tombstones remove
        (needle_map/memdb.go LoadFromIdx semantics)."""
        arr = idxmod.read_index(idx_path)
        for rec in arr:
            key = int(rec["key"])
            off = int(rec["offset"])
            size = t.u32_to_size(int(rec["size"]))
            if off == 0 or t.size_is_deleted(size):
                self._m.pop(key, None)
            else:
                self._m[key] = (off, size)

    def save_to_idx(self, idx_path: str) -> None:
        keys = sorted(self._m)
        arr = np.empty(len(keys), dtype=idxmod.IDX_DTYPE)
        for i, k in enumerate(keys):
            off, size = self._m[k]
            arr[i] = (k, off, t.size_to_u32(size))
        idxmod.write_index(idx_path, arr)
