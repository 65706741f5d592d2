"""Sharded filer store: one namespace partitioned across N child stores.

The reference solves metadata growth with FilerStore *multiplicity* —
path-specific stores layered over the default one (weed/filer/
filerstore_wrapper.go pathSpecific + filer.conf). This module is the
same idea turned into a first-class composite: `make_store("sharded",
shards=N, child="leveldb", path=DIR)` routes every entry to one of N
independent child engines, each in its own directory, so LSM memtable
flushes and compactions parallelize and one hot bucket's churn can't
stall reads against the rest of the namespace.

Routing — bucket/first-segment with a consistent-hash ring:
- `/buckets/<bucket>/**` routes by `buckets/<bucket>`: every S3 bucket
  gets its own shard assignment, the reference's per-bucket store
  split.
- everything else routes by its first path segment (`/x/**` -> "x"),
  the flat-namespace fallback, so a directory and its whole subtree
  stay on ONE shard and directory listings below the top level hit
  exactly one child.
- route keys map to shards through a consistent-hash ring (md5-based,
  stable across processes — python's builtin hash is salted) with
  virtual nodes, so growing the shard count moves ~1/N of the keys.

Only the two fan-out directories — "/" and "/buckets", whose children
own their routing keys — list across shards; those listings k-way
merge the per-shard sorted pages, preserving byte-identical order and
pagination seams with a single store (the contract the property test
pins). kv records route by key hash; begin/end_batch fan out so the
native S3 applier's group-commit window covers every shard it touched.

The port's copy of seaweedfs_tpu/filer/sharded_store.py: the same files, keys,
rows and request bytes, over the standard library only.
"""
from __future__ import annotations

import bisect
import hashlib
import heapq
import os

from .entry import Entry
from .filerstore import FilerStore, _norm, _split, make_store, register_store

BUCKETS_SEG = "buckets"
_VNODES = 64  # ring points per shard: smooths the key distribution


def _stable_hash(s: str) -> int:
    return int.from_bytes(hashlib.md5(s.encode()).digest()[:8], "big")


class _HashRing:
    """Consistent-hash ring over shard indices (stable, md5-based)."""

    def __init__(self, n_shards: int):
        points = []
        for shard in range(n_shards):
            for v in range(_VNODES):
                points.append((_stable_hash(f"shard-{shard}-{v}"), shard))
        points.sort()
        self._hashes = [h for h, _ in points]
        self._shards = [s for _, s in points]

    def shard_for(self, key: str) -> int:
        i = bisect.bisect(self._hashes, _stable_hash(key))
        if i == len(self._hashes):
            i = 0
        return self._shards[i]


def _route_key(path: str) -> str:
    """Routing key of an entry at `path`: 'buckets/<bucket>' under
    /buckets, else the first segment. '' for '/' itself."""
    segs = path.strip("/").split("/")
    if not segs or not segs[0]:
        return ""
    if segs[0] == BUCKETS_SEG and len(segs) >= 2:
        return f"{BUCKETS_SEG}/{segs[1]}"
    return segs[0]


@register_store("sharded")
class ShardedStore(FilerStore):
    """Composite store: `shards` child stores of kind `child`, each in
    its own subdirectory of `path` (so leveldb children compact
    independently). Extra child constructor kwargs ride in
    `child_options`."""

    def __init__(self, path: str = "filerdb", shards: int = 4,
                 child: str = "leveldb",
                 child_options: dict | None = None, **_):
        if shards < 2:
            raise ValueError(f"sharded store needs >= 2 shards, "
                             f"got {shards}")
        self.shards = int(shards)
        self.child_kind = child
        self.path = path
        self._ring = _HashRing(self.shards)
        opts = dict(child_options or {})
        self.children: list[FilerStore] = []
        if child not in ("memory",):
            os.makedirs(path, exist_ok=True)
        for i in range(self.shards):
            self.children.append(make_store(
                child, path=os.path.join(path, f"shard-{i:02d}"), **opts))

    # -- routing --------------------------------------------------------
    def _shard_of(self, path: str) -> FilerStore:
        return self.children[self._ring.shard_for(_route_key(path))]

    def _dir_fans_out(self, dirpath: str) -> bool:
        """True when `dirpath`'s children own their routing keys (so a
        listing spans shards): the root and /buckets."""
        return dirpath == "/" or dirpath == "/" + BUCKETS_SEG

    # -- entry CRUD -----------------------------------------------------
    def insert_entry(self, entry: Entry) -> None:
        self._shard_of(entry.full_path).insert_entry(entry)

    def insert_entry_encoded(self, entry: Entry, entry_dict: dict) -> None:
        # the filer's hot-path primitive: route it, don't flatten it
        self._shard_of(entry.full_path).insert_entry_encoded(
            entry, entry_dict)

    def update_entry(self, entry: Entry) -> None:
        self._shard_of(entry.full_path).update_entry(entry)

    def find_entry(self, path: str) -> Entry | None:
        d, n = _split(path)
        if not n:
            return None
        return self._shard_of(path).find_entry(path)

    def delete_entry(self, path: str) -> None:
        self._shard_of(path).delete_entry(path)

    def delete_folder_children(self, path: str) -> None:
        path = _norm(path)
        if self._dir_fans_out(path):
            # children own their routing keys: the subtree spans shards
            for c in self.children:
                c.delete_folder_children(path)
        else:
            # the whole subtree shares `path`'s routing key
            self._shard_of(path).delete_folder_children(path)

    def list_directory_entries(self, dirpath: str, start_from: str = "",
                               inclusive: bool = False,
                               limit: int = 1024,
                               prefix: str = "") -> list[Entry]:
        dirpath = _norm(dirpath)
        if not self._dir_fans_out(dirpath):
            # a non-fan-out directory's children all share one routing
            # key — that of any child path under it
            child_path = dirpath.rstrip("/") + "/x"
            return self._shard_of(child_path).list_directory_entries(
                dirpath, start_from, inclusive, limit, prefix)
        # fan-out directory: k-way merge the per-shard sorted pages.
        # Each shard applies start_from/prefix/limit itself; merging by
        # name and truncating reproduces the single-store page exactly.
        pages = [c.list_directory_entries(dirpath, start_from,
                                          inclusive, limit, prefix)
                 for c in self.children]
        merged = heapq.merge(*pages, key=lambda e: e.name)
        if limit:
            out = []
            for e in merged:
                out.append(e)
                if len(out) >= limit:
                    break
            return out
        return list(merged)

    # -- kv side-channel ------------------------------------------------
    def _kv_shard(self, key: str) -> FilerStore:
        return self.children[self._ring.shard_for("kv/" + key)]

    def kv_put(self, key: str, value: bytes) -> None:
        self._kv_shard(key).kv_put(key, value)

    def kv_get(self, key: str) -> bytes | None:
        return self._kv_shard(key).kv_get(key)

    def kv_delete(self, key: str) -> None:
        self._kv_shard(key).kv_delete(key)

    # -- batching / lifecycle -------------------------------------------
    def begin_batch(self) -> None:
        for c in self.children:
            c.begin_batch()

    def end_batch(self) -> None:
        for c in self.children:
            c.end_batch()

    def close(self) -> None:
        for c in self.children:
            c.close()

    # -- observability --------------------------------------------------
    def debug_snapshot(self) -> dict:
        return {
            "kind": "sharded",
            "shards": self.shards,
            "child": self.child_kind,
            "path": self.path,
            "routing": "buckets/<bucket> | first-segment, "
                       f"md5 ring x{_VNODES} vnodes",
            "per_shard": [_child_snapshot(c) for c in self.children],
        }

    def publish_metrics(self) -> None:
        """Refresh per-shard gauges (scraped at /metrics, federated
        into /cluster/metrics). Approximate entry counts: memtable +
        segment index sizes, O(1) per shard."""
        from ..utils import metrics

        for i, c in enumerate(self.children):
            snap = _child_snapshot(c)
            lab = {"shard": f"{i:02d}"}
            if snap.get("entries") is not None:
                metrics.gauge_set("filer_store_shard_entries",
                                  snap["entries"], labels=lab)
            if snap.get("segments") is not None:
                metrics.gauge_set("filer_store_shard_segments",
                                  snap["segments"], labels=lab)


def _child_snapshot(store: FilerStore) -> dict:
    """Best-effort stats for one child store (exact for weedkv)."""
    snap = getattr(store, "debug_snapshot", None)
    if snap is not None:
        return snap()
    db = getattr(store, "db", None)
    if db is not None and hasattr(db, "_segments"):  # weedkv engine
        with db._lock:
            seg_keys = sum(len(s.keys) for s in db._segments)
            disk = 0
            for s in db._segments:
                try:
                    disk += os.path.getsize(s.path)
                except OSError:
                    pass
            return {"kind": store.name,
                    # memtable + segment index sizes: counts tombstones
                    # and shadowed versions until the next compaction
                    "entries": len(db._mem) + seg_keys,
                    "memtable_entries": len(db._mem),
                    "segments": len(db._segments),
                    "compaction_debt_segments": max(
                        0, len(db._segments) - 1),
                    "disk_bytes": disk}
    dirs = getattr(store, "_dirs", None)
    if dirs is not None:  # memory store
        return {"kind": store.name,
                "entries": sum(len(v) for v in dirs.values())}
    return {"kind": store.name, "entries": None}
