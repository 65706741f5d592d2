"""Local metadata cache for the mount, kept fresh by the filer's
metadata subscription; the counterpart of
seaweedfs_tpu/mount/meta_cache.py.

Equivalent of SeaweedFS weed/mount/meta_cache/ (local leveldb of
entries + meta_cache_subscribe.go invalidation): getattr/lookup/readdir
hit this cache; create/update/delete events invalidate it so a shared
mount converges without re-listing on every access.
"""
from __future__ import annotations

import threading
import time

from ..filer.entry import Entry


class MetaCache:
    def __init__(self, ttl: float = 60.0):
        self.ttl = ttl
        self._entries: dict[str, tuple[Entry | None, float]] = {}
        # dir path -> (child names, ts): serves repeat readdirs without
        # a filer round-trip until invalidated or TTL-expired
        self._listed_dirs: dict[str, tuple[list[str], float]] = {}
        self._lock = threading.Lock()

    # -- reads ----------------------------------------------------------
    def get(self, path: str) -> tuple[bool, Entry | None]:
        """-> (hit, entry). entry None with hit=True caches negatives."""
        with self._lock:
            rec = self._entries.get(path)
            if rec is None:
                return False, None
            entry, ts = rec
            if time.monotonic() - ts > self.ttl:
                del self._entries[path]
                return False, None
            return True, entry

    def dir_listing(self, path: str) -> list[str] | None:
        with self._lock:
            rec = self._listed_dirs.get(path)
            if rec is None:
                return None
            names, ts = rec
            if time.monotonic() - ts > self.ttl:
                del self._listed_dirs[path]
                return None
            return list(names)

    # -- writes ---------------------------------------------------------
    def put(self, path: str, entry: Entry | None) -> None:
        with self._lock:
            self._entries[path] = (entry, time.monotonic())

    def mark_dir_listed(self, path: str, names: list[str]) -> None:
        with self._lock:
            self._listed_dirs[path] = (list(names), time.monotonic())

    def invalidate(self, path: str) -> None:
        with self._lock:
            self._entries.pop(path, None)
            parent = path.rsplit("/", 1)[0] or "/"
            self._listed_dirs.pop(parent, None)

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._listed_dirs.clear()

    # -- subscription hook (meta_cache_subscribe.go) --------------------
    def on_meta_event(self, ev: dict) -> None:
        """Apply one filer metadata event (event_log.py schema:
        old/new entry dicts with full_path): invalidate both paths and
        their parents' listings, so the next access reads the filer.
        The reference installs the event's new entry instead; an event
        arrives after the mount's own later writes to the same path
        (its create lands after its flush's put), and that put then
        serves the stale entry (0 bytes for a file just written) until
        the next event."""
        for side in ("old_entry", "new_entry"):
            entry = ev.get(side)
            if entry and entry.get("full_path"):
                self.invalidate(entry["full_path"])
