"""Read-through metadata cache in front of any FilerStore.

Positive + negative entry cache and a bounded directory-listing page
cache, invalidated *exactly* through the filer's metadata event log:
`attach(meta_log)` registers a sync listener, which MetaEventLog calls
inside `append` under the filer mutation lock — the same zero-staleness
hook the native S3 front's entry cache rides (s3/native_front.py), so
read-after-write holds for BOTH mutation paths (python filer API and
the native applier channel) with no polling and no staleness window
after a mutation returns.

Why it pays: the weedkv engine serializes reads against memtable
flushes and compactions on one lock, so a grown store's LSM churn is
exactly what the read p99 measures. A cache hit never touches the engine, and misses only pay
once per key per invalidation.

Two caches, both LRU-bounded:
- entries: path -> entry dict (positive) or miss marker (negative).
  Values are stored as dicts and rebuilt via Entry.from_dict per hit
  so callers can never mutate shared state (the filer's hardlink
  resolution writes into the entries it returns).
- pages: (dir, start_from, inclusive, limit, prefix) -> list of entry
  dicts, indexed by directory so one mutation event drops every
  cached page of that directory.

TTL'd entries are never cached: python-side expiry (Filer._expire)
emits no meta event, so a cached copy would outlive the object — the
same rule the native front applies. Expiry's store deletes still
invalidate inline (every write through this wrapper drops its own
keys) so even the event-less path can't strand a stale positive.

The port's copy of seaweedfs_tpu/filer/store_cache.py: the same files, keys,
rows and request bytes, over the standard library only.
"""
from __future__ import annotations

import threading
from collections import OrderedDict

from ..utils import metrics
from .entry import Entry
from .filerstore import FilerStore, _norm, _split

_MISS = object()  # negative-cache marker

DEFAULT_ENTRIES = 65536
DEFAULT_PAGES = 1024


class _LRU:
    """Minimal LRU dict; caller holds the cache lock."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self.data: OrderedDict = OrderedDict()

    def get(self, key):
        v = self.data.get(key, _MISS)
        if v is not _MISS:
            self.data.move_to_end(key)
        return v

    def put(self, key, value):
        """-> the evicted key, or None."""
        self.data[key] = value
        self.data.move_to_end(key)
        if len(self.data) > self.capacity:
            k, _ = self.data.popitem(last=False)
            return k
        return None

    def drop(self, key) -> None:
        self.data.pop(key, None)


class CachingStore(FilerStore):
    """Wrap `inner` with the read-through cache. Writes pass through
    and invalidate inline; `attach(meta_log)` adds the exact
    event-log invalidation that also covers mutations this wrapper
    object never sees (none today — the inline pass-through is belt,
    the event hook is suspenders AND the refresh path that turns a
    write into a warm cache line)."""

    def __init__(self, inner: FilerStore, entries: int = DEFAULT_ENTRIES,
                 pages: int = DEFAULT_PAGES, **_):
        self.inner = inner
        self.name = f"cached-{inner.name}"
        self._lock = threading.Lock()
        self._entries = _LRU(max(1, entries))
        self._pages = _LRU(max(1, pages))
        # dir -> set of page-cache keys, so a mutation in `dir` drops
        # every cached page of that directory in O(pages-of-dir)
        self._dir_pages: dict[str, set] = {}
        # fill/invalidate race guard: a read that started BEFORE a
        # mutation must not cache its stale result AFTER the
        # mutation's invalidation ran. Every invalidation bumps the
        # affected directory's generation (and subtree invalidations
        # bump a global epoch — recursive deletes are rare, so the
        # coarse epoch almost never blocks a fill); fills snapshot
        # both before the inner read and only cache if neither moved.
        self._dir_gen: dict[str, int] = {}
        self._tree_epoch = 0

    def _bump(self, dirpath: str) -> None:
        if len(self._dir_gen) >= 262144:
            self._dir_gen.clear()
            self._tree_epoch += 1  # in-flight fills all discard
        self._dir_gen[dirpath] = self._dir_gen.get(dirpath, 0) + 1

    def _snap(self, dirpath: str) -> tuple[int, int]:
        return self._dir_gen.get(dirpath, 0), self._tree_epoch

    def attach(self, meta_log) -> None:
        meta_log.sync_listeners.append(self._on_meta_event)

    # -- cache mechanics ------------------------------------------------
    def _count(self, what: str, kind: str, n: int = 1) -> None:
        lab = {"kind": kind}
        metrics.counter_add(f"filer_store_cache_{what}_total", n,
                            labels=lab)

    def _drop_entry(self, path: str) -> None:
        self._entries.drop(path)

    def _drop_dir_pages(self, dirpath: str) -> None:
        for key in self._dir_pages.pop(dirpath, ()):
            self._pages.drop(key)

    def _invalidate_path(self, path: str) -> None:
        """One entry changed: drop it and its parent's listing pages."""
        path = _norm(path)
        d, _n = _split(path)
        with self._lock:
            self._drop_entry(path)
            self._drop_dir_pages(d)
            self._bump(d)

    def _invalidate_tree(self, path: str) -> None:
        """A subtree is gone: drop every cached key at or under it."""
        path = _norm(path)
        sub = path if path.endswith("/") else path + "/"
        with self._lock:
            for p in [p for p in self._entries.data
                      if p == path or p.startswith(sub)]:
                self._entries.drop(p)
            for d in [d for d in self._dir_pages
                      if d == path or d.startswith(sub)]:
                self._drop_dir_pages(d)
            self._tree_epoch += 1

    def _on_meta_event(self, ev: dict) -> None:
        """Sync listener (under the mutation lock): refresh or drop.
        Must stay tiny and never raise — MetaEventLog swallows
        exceptions, but a slow listener taxes every mutation."""
        new, old = ev.get("new_entry"), ev.get("old_entry")
        ent = new or old
        if ent is None:
            return
        path = _norm(ent["full_path"])
        d, _n = _split(path)
        is_dir = bool(ent.get("mode", 0) & 0o40000)
        with self._lock:
            self._drop_dir_pages(d)
            self._bump(d)
            if new is None:  # delete
                if is_dir:
                    # children died with it (delete_folder_children)
                    sub = path + "/"
                    for p in [p for p in self._entries.data
                              if p == path or p.startswith(sub)]:
                        self._entries.drop(p)
                    for dd in [dd for dd in self._dir_pages
                               if dd == path or dd.startswith(sub)]:
                        self._drop_dir_pages(dd)
                    self._tree_epoch += 1
                else:
                    self._entries.drop(path)
                return
            if new.get("ttl_sec"):
                # expiry emits no event — never cache a TTL'd entry
                self._entries.drop(path)
                return
            # create/update: the event carries the authoritative dict,
            # so the write itself warms the cache (read-after-write is
            # a hit, not a re-read)
            evicted = self._entries.put(path, new)
        if evicted is not None:
            self._count("evictions", "entry")

    # -- reads (the point) ----------------------------------------------
    def find_entry(self, path: str) -> Entry | None:
        path = _norm(path)
        d, _n = _split(path)
        with self._lock:
            v = self._entries.get(path)
            snap = self._snap(d)
        if v is not _MISS:
            if v is None:
                self._count("hits", "negative")
                return None
            self._count("hits", "entry")
            return Entry.from_dict(v)
        e = self.inner.find_entry(path)
        self._count("misses", "entry")
        payload = None if e is None or e.ttl_sec else e.to_dict()
        evicted = None
        with self._lock:
            if self._snap(d) == snap:  # no mutation raced the read
                if e is None:
                    evicted = self._entries.put(path, None)
                elif payload is not None:
                    evicted = self._entries.put(path, payload)
        if evicted is not None:
            self._count("evictions", "entry")
        return e

    def list_directory_entries(self, dirpath: str, start_from: str = "",
                               inclusive: bool = False,
                               limit: int = 1024,
                               prefix: str = "") -> list[Entry]:
        dirpath = _norm(dirpath)
        key = (dirpath, start_from, inclusive, limit, prefix)
        with self._lock:
            v = self._pages.get(key)
            snap = self._snap(dirpath)
        if v is not _MISS:
            self._count("hits", "page")
            return [Entry.from_dict(d) for d in v]
        batch = self.inner.list_directory_entries(
            dirpath, start_from, inclusive, limit, prefix)
        self._count("misses", "page")
        if any(e.ttl_sec for e in batch):
            return batch  # pages with expiring entries never cached
        # serialize OUTSIDE the lock: a 1000-entry page costs ~ms to
        # encode, and every other op would convoy behind it
        payload = [e.to_dict() for e in batch]
        evicted = None
        with self._lock:
            if self._snap(dirpath) == snap:  # no mutation raced it
                evicted = self._pages.put(key, payload)
                self._dir_pages.setdefault(dirpath, set()).add(key)
                if evicted is not None:
                    # keep the dir index honest about LRU evictions
                    self._dir_pages.get(evicted[0], set()).discard(
                        evicted)
        if evicted is not None:
            self._count("evictions", "page")
        return batch

    # -- writes: pass through, invalidate inline ------------------------
    def insert_entry(self, entry: Entry) -> None:
        self.inner.insert_entry(entry)
        self._invalidate_path(entry.full_path)

    def insert_entry_encoded(self, entry: Entry, entry_dict: dict) -> None:
        self.inner.insert_entry_encoded(entry, entry_dict)
        self._invalidate_path(entry.full_path)

    def update_entry(self, entry: Entry) -> None:
        self.inner.update_entry(entry)
        self._invalidate_path(entry.full_path)

    def delete_entry(self, path: str) -> None:
        self.inner.delete_entry(path)
        self._invalidate_path(path)

    def delete_folder_children(self, path: str) -> None:
        self.inner.delete_folder_children(path)
        self._invalidate_tree(path)

    # -- kv: uncached pass-through (hardlink records are read under
    # the filer's own locks; the win lives in entries and listings) ----
    def kv_put(self, key: str, value: bytes) -> None:
        self.inner.kv_put(key, value)

    def kv_get(self, key: str) -> bytes | None:
        return self.inner.kv_get(key)

    def kv_delete(self, key: str) -> None:
        self.inner.kv_delete(key)

    def begin_batch(self) -> None:
        self.inner.begin_batch()

    def end_batch(self) -> None:
        self.inner.end_batch()

    def close(self) -> None:
        self.inner.close()

    # -- observability --------------------------------------------------
    def stats(self) -> dict:
        with self._lock:
            sizes = {"entries": len(self._entries.data),
                     "entry_capacity": self._entries.capacity,
                     "pages": len(self._pages.data),
                     "page_capacity": self._pages.capacity}
        with metrics._lock:
            for (name, lab), v in metrics._counters.items():
                if name.startswith("filer_store_cache_"):
                    kind = dict(lab).get("kind", "")
                    short = name[len("filer_store_cache_"):-len("_total")]
                    sizes[f"{short}_{kind}"] = int(v)
        return sizes

    def debug_snapshot(self) -> dict:
        from .sharded_store import _child_snapshot

        inner_snap = getattr(self.inner, "debug_snapshot", None)
        return {"kind": "cache", "cache": self.stats(),
                "inner": inner_snap() if inner_snap
                else _child_snapshot(self.inner)}

    def publish_metrics(self) -> None:
        pm = getattr(self.inner, "publish_metrics", None)
        if pm is not None:
            pm()
        with self._lock:
            metrics.gauge_set("filer_store_cache_entries",
                              len(self._entries.data))
            metrics.gauge_set("filer_store_cache_pages",
                              len(self._pages.data))
