"""Volume-file storage backends: the local part of
seaweedfs_tpu/storage/backend.py.

Mirrors the reference's plugin pattern (weed/storage/backend/
backend.go:15-45): a `StorageFile` is the random-access byte store a
volume's .dat lives on; factories are registered by type string so
more backends can be added without touching the engine. Here: disk,
memory, mmap and the gated rclone placeholder. The remote tier
(S3RangeFile, S3BackendStorage and the configured-storage registry)
is not in this package yet.
"""
from __future__ import annotations

import os
import threading
from typing import Callable, Protocol


class StorageFile(Protocol):
    def read_at(self, size: int, offset: int) -> bytes: ...
    def write_at(self, data: bytes, offset: int) -> int: ...
    def append(self, data: bytes) -> int: ...
    def truncate(self, size: int) -> None: ...
    def size(self) -> int: ...
    def sync(self) -> None: ...
    def close(self) -> None: ...
    @property
    def name(self) -> str: ...


class DiskFile:
    """Local-disk backend (backend/disk_file.go equivalent)."""

    remote = False  # reads are page-cache, not network

    def __init__(self, path: str, create: bool = False):
        mode = "r+b" if os.path.exists(path) else ("w+b" if create else None)
        if mode is None:
            raise FileNotFoundError(path)
        self._f = open(path, mode)
        self._path = path
        # one lock per file: streaming readers (tail/incremental copy/
        # plain GETs) run in worker threads concurrently with appends;
        # an unguarded seek+write pair could land a record at a reader's
        # offset and destroy live data. Reads use pread so they never
        # move the shared file position.
        self._lock = threading.RLock()

    @property
    def name(self) -> str:
        return self._path

    def read_at(self, size: int, offset: int) -> bytes:
        # flush needs the lock (it touches the buffered writer); the
        # pread itself doesn't move the shared position, so the actual
        # disk read runs unlocked and GETs stay concurrent. The fd is
        # dup'ed under the lock: a bare cached fd number could be
        # closed by a concurrent compact commit and REUSED for the new
        # file, silently serving wrong bytes — the dup stays pinned to
        # the old file until we close it.
        with self._lock:
            self._f.flush()
            fd = os.dup(self._f.fileno())
        try:
            return os.pread(fd, size, offset)
        finally:
            os.close(fd)

    def write_at(self, data: bytes, offset: int) -> int:
        with self._lock:
            self._f.seek(offset)
            return self._f.write(data)

    def append(self, data: bytes) -> int:
        with self._lock:
            self._f.seek(0, os.SEEK_END)
            offset = self._f.tell()
            self._f.write(data)
            return offset

    def truncate(self, size: int) -> None:
        with self._lock:
            self._f.flush()
            self._f.truncate(size)

    def size(self) -> int:
        with self._lock:
            self._f.flush()
            return os.fstat(self._f.fileno()).st_size

    def flush(self) -> None:
        """Userspace buffer -> OS (no fsync)."""
        with self._lock:
            self._f.flush()

    def sync(self) -> None:
        with self._lock:
            self._f.flush()
            os.fsync(self._f.fileno())

    def datasync(self) -> None:
        """flush + fdatasync: forces the data and the size metadata
        needed to retrieve it, skipping the mtime journal ordering —
        ~3x cheaper than fsync on ext4 appends, which is what the
        group-commit batch flush amortizes."""
        with self._lock:
            self._f.flush()
            os.fdatasync(self._f.fileno())

    def close(self) -> None:
        with self._lock:
            try:
                self._f.flush()
            finally:
                self._f.close()


class MemoryFile:
    remote = False

    """In-memory backend for tests and the memory_map analogue."""

    def __init__(self, name: str = "<memory>"):
        self._buf = bytearray()
        self._name = name

    @property
    def name(self) -> str:
        return self._name

    def read_at(self, size: int, offset: int) -> bytes:
        return bytes(self._buf[offset:offset + size])

    def write_at(self, data: bytes, offset: int) -> int:
        end = offset + len(data)
        if end > len(self._buf):
            self._buf.extend(b"\x00" * (end - len(self._buf)))
        self._buf[offset:end] = data
        return len(data)

    def append(self, data: bytes) -> int:
        offset = len(self._buf)
        self._buf.extend(data)
        return offset

    def truncate(self, size: int) -> None:
        del self._buf[size:]

    def size(self) -> int:
        return len(self._buf)

    def flush(self) -> None:
        pass

    def sync(self) -> None:
        pass

    def close(self) -> None:
        pass


class MmapFile:
    remote = False

    """Memory-mapped volume file backend — the counterpart of the
    reference's memory_map backend (storage/backend/memory_map/, the
    `-memoryMapLimitMB` path): reads come straight out of the mapping,
    appends extend the file and remap. Best for read-heavy volumes
    whose working set fits the page cache."""

    # appends extend the backing file in GROW steps so a remap happens
    # once per megabyte, not once per record; the file is trimmed back
    # to the logical size on close. (After a crash the grow padding
    # survives as trailing zeros — the volume load scan walks them as
    # empty tombstones, same as any torn tail.)
    GROW = 1 << 20

    def __init__(self, path: str, create: bool = False):
        import mmap as _mmap

        mode = "r+b" if os.path.exists(path) else ("w+b" if create else None)
        if mode is None:
            raise FileNotFoundError(path)
        self._f = open(path, mode)
        self._path = path
        self._lock = threading.RLock()
        self._size = os.path.getsize(path)    # logical bytes
        self._mapped = self._size             # physical/mapped bytes
        self._mmap_mod = _mmap
        self._map = None
        self._remap()

    def _remap(self) -> None:
        if self._map is not None:
            self._map.close()
            self._map = None
        if self._mapped > 0:
            self._f.flush()
            self._map = self._mmap_mod.mmap(
                self._f.fileno(), self._mapped,
                access=self._mmap_mod.ACCESS_WRITE)

    @property
    def name(self) -> str:
        return self._path

    def read_at(self, size: int, offset: int) -> bytes:
        with self._lock:
            if offset >= self._size:
                return b""
            end = min(offset + size, self._size)
            return bytes(self._map[offset:end])

    def write_at(self, data: bytes, offset: int) -> int:
        with self._lock:
            end = offset + len(data)
            if end > self._mapped:
                grown = ((end + self.GROW - 1) // self.GROW) * self.GROW
                self._f.truncate(grown)
                self._mapped = grown
                self._remap()
            self._map[offset:end] = data
            self._size = max(self._size, end)
            return len(data)

    def append(self, data: bytes) -> int:
        with self._lock:
            offset = self._size
            self.write_at(data, offset)
            return offset

    def truncate(self, size: int) -> None:
        with self._lock:
            self._f.truncate(size)
            self._size = size
            self._mapped = size
            self._remap()

    def size(self) -> int:
        with self._lock:
            return self._size

    def flush(self) -> None:
        # mapped stores are already visible through the fd; nothing
        # buffered in userspace to push (DiskFile flushes its writer)
        pass

    def sync(self) -> None:
        with self._lock:
            if self._map is not None:
                self._map.flush()
            os.fsync(self._f.fileno())

    def close(self) -> None:
        with self._lock:
            if self._map is not None:
                self._map.close()
                self._map = None
            # drop the grow padding so the on-disk file ends at the
            # logical size (plain DiskFile can reopen it verbatim)
            try:
                self._f.truncate(self._size)
            except OSError:
                pass
            self._f.close()


class RcloneFile:
    """Placeholder for the rclone backend (backend/rclone_backend/):
    needs the rclone binary, which this environment does not ship.
    Marked unavailable so `create()` fails fast at construction with a
    clear error instead of a bare NotImplementedError at use time; a
    build that bundles rclone re-registers a real factory via
    `register("rclone", ...)`."""

    available = False
    unavailable_reason = ("needs the rclone binary on PATH, which this "
                          "build does not ship")

    def __init__(self, *a, **kw):
        raise RuntimeError(
            f"backend 'rclone' not available in this build: "
            f"{self.unavailable_reason}")


_factories: dict[str, Callable[..., StorageFile]] = {
    "disk": DiskFile,
    "memory": MemoryFile,
    "mmap": MmapFile,
    "rclone": RcloneFile,
}


def register(name: str, factory: Callable[..., StorageFile]) -> None:
    _factories[name] = factory


def create(kind: str, *args, **kwargs) -> StorageFile:
    try:
        factory = _factories[kind]
    except KeyError:
        raise KeyError(f"unknown storage backend {kind!r}; "
                       f"known: {sorted(_factories)}") from None
    if not getattr(factory, "available", True):
        # fail fast at construction, before any volume state exists
        raise RuntimeError(
            f"backend {kind!r} not available in this build: "
            f"{getattr(factory, 'unavailable_reason', 'unavailable')}")
    return factory(*args, **kwargs)
