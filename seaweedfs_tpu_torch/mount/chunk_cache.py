"""Tiered read cache for file chunks: memory LRU over an optional
bounded disk tier; the counterpart of seaweedfs_tpu/mount/chunk_cache.py.

Equivalent of SeaweedFS weed/util/chunk_cache/ (memory + on-disk
volume tiers fed by the mount's read path, weedfs.go:29-60). Keys are
whole fids — the mount reads whole chunks and slices locally, which is
also what keeps volume-server round-trips amortized.
"""
from __future__ import annotations

import hashlib
import os
import threading
from collections import OrderedDict


class MemoryChunkCache:
    def __init__(self, capacity_bytes: int = 64 << 20):
        self.capacity = capacity_bytes
        self._used = 0
        self._data: OrderedDict[str, bytes] = OrderedDict()
        self._lock = threading.Lock()

    def get(self, fid: str) -> bytes | None:
        with self._lock:
            data = self._data.get(fid)
            if data is not None:
                self._data.move_to_end(fid)
            return data

    def put(self, fid: str, data: bytes) -> None:
        if len(data) > self.capacity:
            return
        with self._lock:
            old = self._data.pop(fid, None)
            if old is not None:
                self._used -= len(old)
            self._data[fid] = data
            self._used += len(data)
            while self._used > self.capacity:
                _, evicted = self._data.popitem(last=False)
                self._used -= len(evicted)


class DiskChunkCache:
    """Disk tier: one file per fid under a cache dir, LRU by mtime."""

    def __init__(self, cache_dir: str, capacity_bytes: int = 1 << 30):
        self.dir = cache_dir
        self.capacity = capacity_bytes
        os.makedirs(cache_dir, exist_ok=True)
        self._lock = threading.Lock()

    def _path(self, fid: str) -> str:
        h = hashlib.sha1(fid.encode()).hexdigest()
        return os.path.join(self.dir, h)

    def get(self, fid: str) -> bytes | None:
        path = self._path(fid)
        try:
            with open(path, "rb") as f:
                data = f.read()
            os.utime(path)  # LRU touch
            return data
        except OSError:
            return None

    def put(self, fid: str, data: bytes) -> None:
        if len(data) > self.capacity:
            return
        path = self._path(fid)
        tmp = path + ".tmp"
        with self._lock:
            try:
                with open(tmp, "wb") as f:
                    f.write(data)
                os.replace(tmp, path)
            except OSError:
                return
            self._evict()

    def _evict(self) -> None:
        entries = []
        total = 0
        for name in os.listdir(self.dir):
            p = os.path.join(self.dir, name)
            try:
                st = os.stat(p)
            except OSError:
                continue
            entries.append((st.st_mtime, st.st_size, p))
            total += st.st_size
        entries.sort()
        for _, size, p in entries:
            if total <= self.capacity:
                break
            try:
                os.remove(p)
                total -= size
            except OSError:
                pass


class TieredChunkCache:
    def __init__(self, memory_bytes: int = 64 << 20,
                 disk_dir: str | None = None,
                 disk_bytes: int = 1 << 30):
        self.mem = MemoryChunkCache(memory_bytes)
        self.disk = DiskChunkCache(disk_dir, disk_bytes) if disk_dir \
            else None

    def get(self, fid: str) -> bytes | None:
        data = self.mem.get(fid)
        if data is not None:
            return data
        if self.disk is not None:
            data = self.disk.get(fid)
            if data is not None:
                self.mem.put(fid, data)  # promote
        return data

    def put(self, fid: str, data: bytes) -> None:
        self.mem.put(fid, data)
        if self.disk is not None:
            self.disk.put(fid, data)
