"""Needle maps: the live key -> (offset, size) index of a volume.

The reference keeps three index-persistence strategies (memory / leveldb /
sorted-file, weed/storage/needle_map*.go) over a compact sharded map
(needle_map/compact_map.go:28). Here the core map is a python dict over
vectorized numpy loads — idiomatic and fast enough for the control plane;
the batched scrub/EC paths never touch it per-needle, they consume whole
index columns (storage/idx.py).

MemDb mirrors needle_map/memdb.go: an insert-ordered map with an
ascending-key visit used to produce sorted .ecx files
(weed/storage/erasure_coding/ec_encoder.go:27-55).

A copy of seaweedfs_tpu/storage/needle_map.py.
"""
from __future__ import annotations

import os
from typing import Callable, Iterator

import numpy as np

from . import idx as idxmod
from . import types as t

OFFSET_DTYPE = np.uint32 if t.OFFSET_SIZE == 4 else np.uint64


class NeedleMap:
    """Live per-volume map: key -> (offset, size), with accounting
    mirroring the reference's mapMetric (file/deleted counts and bytes)."""

    def __init__(self) -> None:
        self._m: dict[int, tuple[int, int]] = {}
        self.file_count = 0
        self.deleted_count = 0
        self.file_bytes = 0
        self.deleted_bytes = 0
        self.max_key = 0

    def __len__(self) -> int:
        return len(self._m)

    def get(self, key: int) -> tuple[int, int] | None:
        """-> (stored offset, size) for live needles, else None."""
        v = self._m.get(key)
        if v is None or t.size_is_deleted(v[1]):
            return None
        return v

    def get_any(self, key: int) -> tuple[int, int] | None:
        """Raw entry including tombstones (size<0) — the
        ?readDeleted=true read path (volume_read.go:29)."""
        return self._m.get(key)

    def put(self, key: int, offset: int, size: int) -> None:
        old = self._m.get(key)
        if old is not None and t.size_is_valid(old[1]):
            self.deleted_count += 1
            self.deleted_bytes += old[1]
            self.file_count -= 1
            self.file_bytes -= old[1]
        self._m[key] = (offset, size)
        if t.size_is_valid(size):
            self.file_count += 1
            self.file_bytes += size
        self.max_key = max(self.max_key, key)

    def delete(self, key: int) -> int:
        """Mark deleted; returns reclaimed bytes (0 if absent)."""
        old = self._m.get(key)
        if old is None or not t.size_is_valid(old[1]):
            return 0
        self._m[key] = (old[0], t.TOMBSTONE_SIZE)
        self.deleted_count += 1
        self.deleted_bytes += old[1]
        self.file_count -= 1
        self.file_bytes -= old[1]
        return old[1]

    def items(self) -> Iterator[tuple[int, int, int]]:
        for k, (off, size) in self._m.items():
            yield k, off, size

    def live_items(self) -> Iterator[tuple[int, int, int]]:
        for k, (off, size) in self._m.items():
            if t.size_is_valid(size):
                yield k, off, size

    def deleted_keys(self) -> Iterator[int]:
        """Keys with a tombstone — the delete half of the replica-sync
        census (volume.check.disk must propagate deletes, not resurrect
        the stale live copy)."""
        for k, (_off, size) in self._m.items():
            if t.size_is_deleted(size):
                yield k


def new_needle_map(kind: str = "memory", idx_path: str = ""):
    """Fresh, empty map of the configured strategy — rebuild paths must
    honor the kind too, or a compact-configured node falls back to the
    dict map's ~6x memory after crash recovery."""
    if kind == "compact":
        return CompactNeedleMap()
    if kind == "btree":
        if not idx_path:
            raise ValueError("btree needle map needs the idx path")
        nm = BtreeNeedleMap(idx_path)
        nm.clear()
        return nm
    if kind != "memory":
        raise ValueError(f"unknown needle map kind {kind!r}")
    return NeedleMap()


def load_needle_map(idx_path: str, kind: str = "memory"):
    """Replay an .idx log into a live map (needle_map_memory.go
    LoadCompactNeedleMap equivalent): later entries win; tombstones
    (size<0 or offset==0&&size==0 per reference semantics) delete.
    kind selects the strategy: "memory" (dict), "compact" (sorted
    numpy array, needle_map_kind in store.go:57), or "btree" (on-disk
    sqlite sidecar — the reference's -index=leveldb analog)."""
    if kind == "compact":
        return load_compact_needle_map(idx_path)
    if kind == "btree":
        return load_btree_needle_map(idx_path)
    if kind != "memory":
        raise ValueError(f"unknown needle map kind {kind!r}")
    nm = new_needle_map(kind)
    if not os.path.exists(idx_path):
        return nm
    arr = idxmod.read_index(idx_path)
    for rec in arr:
        key = int(rec["key"])
        off = int(rec["offset"])
        size = t.u32_to_size(int(rec["size"]))
        if off > 0 and t.size_is_valid(size):
            nm.put(key, off, size)
        else:
            nm.delete(key)
    return nm


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


class CompactNeedleMap:
    """Memory-frugal needle map: the loaded index is a sorted numpy
    structured array (16 bytes/needle, the compact_map.go:28 goal —
    a python dict burns ~100 bytes/needle) probed by binary search,
    with a small dict overlay for writes since load. The overlay is
    merged into the array when it grows past OVERLAY_LIMIT, keeping
    lookups O(log n) and memory O(n * 16B).

    Same surface and metric fields as NeedleMap; selected per volume
    with needle_map_kind="compact" (needle_map_kind, store.go:57).
    """

    OVERLAY_LIMIT = 8192

    def __init__(self) -> None:
        self._keys = np.empty(0, dtype=np.uint64)
        # u32 holds 4-byte offsets; the 5BytesOffset variant needs
        # u64 or offsets past 32GB would silently truncate mod 2^32
        self._offsets = np.empty(0, dtype=OFFSET_DTYPE)
        self._sizes = np.empty(0, dtype=np.int64)  # -1 = tombstone
        self._overlay: dict[int, tuple[int, int]] = {}
        self.file_count = 0
        self.deleted_count = 0
        self.file_bytes = 0
        self.deleted_bytes = 0
        self.max_key = 0

    def __len__(self) -> int:
        base = len(self._keys)
        novel = sum(1 for k in self._overlay
                    if not self._base_has(k))
        return base + novel

    def _base_has(self, key: int) -> bool:
        i = int(np.searchsorted(self._keys, np.uint64(key)))
        return i < len(self._keys) and int(self._keys[i]) == key

    def _base_get(self, key: int) -> tuple[int, int] | None:
        i = int(np.searchsorted(self._keys, np.uint64(key)))
        if i < len(self._keys) and int(self._keys[i]) == key:
            return int(self._offsets[i]), int(self._sizes[i])
        return None

    def _lookup(self, key: int) -> tuple[int, int] | None:
        if key in self._overlay:
            return self._overlay[key]
        return self._base_get(key)

    def get(self, key: int) -> tuple[int, int] | None:
        v = self._lookup(key)
        if v is None or t.size_is_deleted(v[1]):
            return None
        return v

    def get_any(self, key: int) -> tuple[int, int] | None:
        """Raw entry including tombstones (readDeleted path)."""
        return self._lookup(key)

    def put(self, key: int, offset: int, size: int) -> None:
        old = self._lookup(key)
        if old is not None and t.size_is_valid(old[1]):
            self.deleted_count += 1
            self.deleted_bytes += old[1]
            self.file_count -= 1
            self.file_bytes -= old[1]
        self._overlay[key] = (offset, size)
        if t.size_is_valid(size):
            self.file_count += 1
            self.file_bytes += size
        self.max_key = max(self.max_key, key)
        self._maybe_merge()

    def delete(self, key: int) -> int:
        old = self._lookup(key)
        if old is None or not t.size_is_valid(old[1]):
            return 0
        self._overlay[key] = (old[0], t.TOMBSTONE_SIZE)
        self.deleted_count += 1
        self.deleted_bytes += old[1]
        self.file_count -= 1
        self.file_bytes -= old[1]
        self._maybe_merge()
        return old[1]

    def _maybe_merge(self) -> None:
        if len(self._overlay) >= self.OVERLAY_LIMIT:
            self.merge_overlay()

    def merge_overlay(self) -> None:
        if not self._overlay:
            return
        ok = np.fromiter(self._overlay.keys(), dtype=np.uint64,
                         count=len(self._overlay))
        ov = np.array([v for v in self._overlay.values()],
                      dtype=np.int64).reshape(-1, 2)
        keys = np.concatenate([self._keys, ok])
        offsets = np.concatenate([self._offsets,
                                  ov[:, 0].astype(OFFSET_DTYPE)])
        sizes = np.concatenate([self._sizes, ov[:, 1]])
        # stable sort + keep the LAST occurrence of each key (overlay
        # entries were appended after the base, so they win)
        order = np.argsort(keys, kind="stable")
        keys, offsets, sizes = keys[order], offsets[order], sizes[order]
        keep = np.ones(len(keys), dtype=bool)
        keep[:-1] = keys[:-1] != keys[1:]
        self._keys = keys[keep]
        self._offsets = offsets[keep]
        self._sizes = sizes[keep]
        self._overlay = {}

    def items(self) -> Iterator[tuple[int, int, int]]:
        self.merge_overlay()
        for i in range(len(self._keys)):
            yield (int(self._keys[i]), int(self._offsets[i]),
                   int(self._sizes[i]))

    def live_items(self) -> Iterator[tuple[int, int, int]]:
        for k, off, size in self.items():
            if t.size_is_valid(size):
                yield k, off, size

    def deleted_keys(self) -> Iterator[int]:
        for k, _off, size in self.items():
            if t.size_is_deleted(size):
                yield k


def load_compact_needle_map(idx_path: str) -> CompactNeedleMap:
    """Vectorized .idx replay into a CompactNeedleMap: one structured
    read, later-entries-win dedupe and metric computation all as numpy
    column ops (the vectorized version of
    needle_map_memory.go LoadCompactNeedleMap)."""
    nm = CompactNeedleMap()
    if not os.path.exists(idx_path):
        return nm
    arr = idxmod.read_index(idx_path)
    if len(arr) == 0:
        return nm
    keys = arr["key"].astype(np.uint64)
    offsets = arr["offset"].astype(OFFSET_DTYPE)
    sizes = arr["size"].astype(np.int64)
    sizes = np.where(sizes >= 0x80000000, sizes - (1 << 32), sizes)
    # tombstone rows delete; size-0 rows count as deletes too, exactly
    # like the memory loader's `off > 0 and size_is_valid(size)` test —
    # the two kinds must produce identical live-sets from one .idx
    dead = (offsets == 0) | (sizes <= 0)
    sizes = np.where(dead, np.int64(t.TOMBSTONE_SIZE), sizes)
    # later entries win: stable sort by key keeps append order within
    # a key; take each key's last row
    order = np.argsort(keys, kind="stable")
    keys, offsets, sizes = keys[order], offsets[order], sizes[order]
    keep = np.ones(len(keys), dtype=bool)
    keep[:-1] = keys[:-1] != keys[1:]
    # count a key as "deleted" only if its final row is a tombstone;
    # overwritten intermediate rows add to deleted_bytes like the
    # incremental path does
    shadowed_sizes = sizes[~keep]
    nm._keys = keys[keep]
    nm._offsets = offsets[keep]
    nm._sizes = sizes[keep]
    live = nm._sizes >= 0
    nm.file_count = int(np.count_nonzero(live))
    nm.file_bytes = int(nm._sizes[live].sum())
    # every shadowed live row was ended by exactly one overwrite or
    # tombstone — the same events the incremental path counts
    shadowed_live = shadowed_sizes[shadowed_sizes >= 0]
    nm.deleted_count = int(len(shadowed_live))
    nm.deleted_bytes = int(shadowed_live.sum())
    nm.max_key = int(nm._keys[-1]) if len(nm._keys) else 0
    return nm


class BtreeNeedleMap:
    """On-disk needle index: the reference's third strategy
    (needle_map_leveldb.go, `-index=leveldb`) for servers whose needle
    maps don't fit RAM. sqlite's B-tree plays the leveldb role — O(log
    n) key probes with O(1) resident memory; only the map METRICS
    (file/deleted counts and bytes, mapMetric) live in RAM.

    Startup rides a watermark like the reference's
    (needle_map_leveldb.go:70 levelDbWrite watermark): the sidecar
    remembers how many .idx bytes it reflects; reopening replays only
    the .idx TAIL past the watermark (later-wins, idempotent), and a
    truncated .idx (vacuum commit) triggers a full rebuild.
    """

    def __init__(self, idx_path: str):
        import sqlite3

        self.db_path = idx_path + ".bdb"
        self._db = sqlite3.connect(self.db_path, check_same_thread=False)
        self._db.execute("PRAGMA journal_mode=WAL")
        self._db.execute("PRAGMA synchronous=OFF")
        self._db.execute(
            "CREATE TABLE IF NOT EXISTS needles ("
            "key INTEGER PRIMARY KEY, offset INTEGER, size INTEGER)")
        self._db.execute(
            "CREATE TABLE IF NOT EXISTS meta (k TEXT PRIMARY KEY, v)")
        self._lock = __import__("threading").RLock()
        self._dirty = 0
        self.file_count = 0
        self.deleted_count = 0
        self.file_bytes = 0
        self.deleted_bytes = 0
        self.max_key = 0
        self._load_metrics()

    # -- metrics persistence (mapMetric analog) -------------------------
    METRIC_KEYS = ("file_count", "deleted_count", "file_bytes",
                   "deleted_bytes", "max_key")

    def _load_metrics(self) -> None:
        rows = dict(self._db.execute("SELECT k, v FROM meta"))
        for k in self.METRIC_KEYS:
            setattr(self, k, int(rows.get(k, 0)))

    def _save_metrics(self) -> None:
        self._db.executemany(
            "INSERT OR REPLACE INTO meta (k, v) VALUES (?, ?)",
            [(k, getattr(self, k)) for k in self.METRIC_KEYS])

    def watermark(self) -> int:
        # sqlite connections are not safe for unsynchronized concurrent
        # use even with check_same_thread=False
        with self._lock:
            row = self._db.execute(
                "SELECT v FROM meta WHERE k='idx_bytes'").fetchone()
        return int(row[0]) if row else 0

    def set_watermark(self, idx_bytes: int) -> None:
        with self._lock:
            self._save_metrics()
            self._db.execute(
                "INSERT OR REPLACE INTO meta (k, v) VALUES "
                "('idx_bytes', ?)", (idx_bytes,))
            self._db.commit()
            self._dirty = 0

    def clear(self) -> None:
        with self._lock:
            self._db.execute("DELETE FROM needles")
            self._db.execute("DELETE FROM meta")
            for k in self.METRIC_KEYS:
                setattr(self, k, 0)
            self._db.commit()

    # -- signed-size storage: rows keep tombstones (size<0) so the
    # deleted-keys census works without the .idx
    def _lookup(self, key: int) -> tuple[int, int] | None:
        row = self._db.execute(
            "SELECT offset, size FROM needles WHERE key=?",
            (key,)).fetchone()
        return (int(row[0]), int(row[1])) if row else None

    def __len__(self) -> int:
        with self._lock:
            return int(self._db.execute(
                "SELECT COUNT(*) FROM needles").fetchone()[0])

    def get(self, key: int) -> tuple[int, int] | None:
        import sqlite3

        try:
            with self._lock:
                v = self._lookup(key)
        except sqlite3.ProgrammingError as e:
            # a vacuum commit closed this map object under a concurrent
            # unlocked reader; OSError routes the caller into the
            # locked retry, which re-reads the volume's NEW map
            raise OSError(f"needle map closed: {e}") from e
        if v is None or t.size_is_deleted(v[1]):
            return None
        return v

    def get_any(self, key: int) -> tuple[int, int] | None:
        """Raw row including tombstones (readDeleted path)."""
        with self._lock:
            return self._lookup(key)

    # no standalone commit cadence here: transaction sizing is owned by
    # the group-commit scheduler (storage/commit.py), whose batch close
    # calls sync()/set_watermark so idx durability matches .dat acks
    def put(self, key: int, offset: int, size: int) -> None:
        with self._lock:
            old = self._lookup(key)
            if old == (offset, size):
                # identical row: watermark-tail replay after a crash
                # re-applies committed puts — counting them as
                # overwrites would inflate deleted_count/bytes
                return
            if old is not None and t.size_is_valid(old[1]):
                self.deleted_count += 1
                self.deleted_bytes += old[1]
                self.file_count -= 1
                self.file_bytes -= old[1]
            self._db.execute(
                "INSERT OR REPLACE INTO needles (key, offset, size) "
                "VALUES (?, ?, ?)", (key, offset, size))
            if t.size_is_valid(size):
                self.file_count += 1
                self.file_bytes += size
            self.max_key = max(self.max_key, key)
            self._dirty += 1

    def delete(self, key: int) -> int:
        with self._lock:
            old = self._lookup(key)
            if old is None or not t.size_is_valid(old[1]):
                return 0
            self._db.execute(
                "UPDATE needles SET size=? WHERE key=?",
                (t.TOMBSTONE_SIZE, key))
            self.deleted_count += 1
            self.deleted_bytes += old[1]
            self.file_count -= 1
            self.file_bytes -= old[1]
            self._dirty += 1
            return old[1]

    def recount_live(self) -> None:
        """Recompute file_count/file_bytes from the rows (one SQL
        aggregate, no Python materialization) — used after a tail
        replay, where interleaved crash windows can drift the
        incremental counters."""
        with self._lock:
            row = self._db.execute(
                "SELECT COUNT(*), COALESCE(SUM(size), 0) FROM needles "
                "WHERE size >= 0").fetchone()
            self.file_count, self.file_bytes = int(row[0]), int(row[1])
            row = self._db.execute(
                "SELECT COALESCE(MAX(key), 0) FROM needles").fetchone()
            self.max_key = max(self.max_key, int(row[0]))

    ITEMS_BATCH = 4096

    def items(self) -> Iterator[tuple[int, int, int]]:
        # keyset pagination, NOT fetchall: this map exists for volumes
        # whose index doesn't fit RAM — scrub/compact iteration must
        # stay O(batch) resident
        with self._lock:
            self._db.commit()
        last = -1
        while True:
            with self._lock:
                rows = self._db.execute(
                    "SELECT key, offset, size FROM needles "
                    "WHERE key > ? ORDER BY key LIMIT ?",
                    (last, self.ITEMS_BATCH)).fetchall()
            if not rows:
                return
            for k, off, size in rows:
                yield int(k), int(off), int(size)
            last = int(rows[-1][0])

    def live_items(self) -> Iterator[tuple[int, int, int]]:
        for k, off, size in self.items():
            if t.size_is_valid(size):
                yield k, off, size

    def deleted_keys(self) -> Iterator[int]:
        for k, _off, size in self.items():
            if t.size_is_deleted(size):
                yield k

    def sync(self) -> None:
        with self._lock:
            self._db.commit()
            self._dirty = 0

    def close(self) -> None:
        with self._lock:
            try:
                self._save_metrics()
                self._db.commit()
                self._db.close()
            except Exception:
                pass


def load_btree_needle_map(idx_path: str) -> BtreeNeedleMap:
    """Open the .bdb sidecar and catch up from the .idx log tail past
    the watermark (full rebuild when the .idx shrank, i.e. a vacuum
    rewrote it). A corrupt sidecar (synchronous=OFF allows it after an
    OS crash) is dropped and rebuilt from the intact .idx, never fatal."""
    import sqlite3

    try:
        nm = BtreeNeedleMap(idx_path)
        mark = nm.watermark()
    except sqlite3.DatabaseError:
        drop_btree_sidecar(idx_path)
        nm = BtreeNeedleMap(idx_path)
        mark = 0
    idx_size = os.path.getsize(idx_path) if os.path.exists(idx_path) \
        else 0
    if mark > idx_size:
        nm.clear()  # idx rewritten shorter (vacuum commit): rebuild
        mark = 0
    if mark < idx_size:
        entry = t.NEEDLE_MAP_ENTRY_SIZE
        mark -= mark % entry  # torn tail of a previous run
        with open(idx_path, "rb") as f:
            f.seek(mark)
            blob = f.read(idx_size - mark)
        arr = idxmod.parse_index_bytes(blob)
        for rec in arr:
            key = int(rec["key"])
            off = int(rec["offset"])
            size = t.u32_to_size(int(rec["size"]))
            if off > 0 and t.size_is_valid(size):
                nm.put(key, off, size)
            else:
                nm.delete(key)
        # an unclean shutdown means the tail was replayed over rows the
        # db may already hold: idempotent re-application keeps the ROWS
        # right but cannot reconstruct overwrite/delete counters (the
        # original sizes are gone from the rows). The .idx has the full
        # history — recompute ALL metrics from it exactly, the same way
        # the compact loader does (garbage_ratio feeds vacuum decisions
        # and must not drift down).
        full = idxmod.read_index(idx_path)
        if len(full):
            import numpy as np

            keys = full["key"].astype(np.uint64)
            sizes = full["size"].astype(np.int64)
            sizes = np.where(sizes >= 0x80000000, sizes - (1 << 32),
                             sizes)
            offs = full["offset"].astype(np.uint64)
            dead = (offs == 0) | (sizes <= 0)
            sizes = np.where(dead, np.int64(t.TOMBSTONE_SIZE), sizes)
            order = np.argsort(keys, kind="stable")
            keys_s, sizes_s = keys[order], sizes[order]
            keep = np.ones(len(keys_s), dtype=bool)
            keep[:-1] = keys_s[:-1] != keys_s[1:]
            shadowed = sizes_s[~keep]
            shadowed_live = shadowed[shadowed >= 0]
            nm.deleted_count = int(len(shadowed_live))
            nm.deleted_bytes = int(shadowed_live.sum())
        nm.recount_live()
    nm.set_watermark(idx_size)
    return nm


def drop_btree_sidecar(idx_path: str) -> None:
    """Remove the .bdb sidecar (and WAL files) so the next open does a
    full rebuild — required whenever the .idx is REWRITTEN rather than
    appended (vacuum commit, index rebuild): the size-only watermark
    cannot detect same-size reordered content."""
    for suffix in (".bdb", ".bdb-wal", ".bdb-shm"):
        try:
            os.remove(idx_path + suffix)
        except FileNotFoundError:
            pass
