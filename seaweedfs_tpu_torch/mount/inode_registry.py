"""Inode <-> path bimap for the mount layer; the counterpart of
seaweedfs_tpu/mount/inode_registry.py.

Equivalent of SeaweedFS weed/mount/inode_to_path.go: stable inode
numbers per path for kernel-facing handles, with rename moving the
inode to the new path (so open handles survive renames) and unlink
retiring it.
"""
from __future__ import annotations

import threading

ROOT_INODE = 1


class InodeRegistry:
    def __init__(self) -> None:
        self._path_to_inode: dict[str, int] = {"/": ROOT_INODE}
        self._inode_to_path: dict[int, str] = {ROOT_INODE: "/"}
        self._next = ROOT_INODE + 1
        self._lock = threading.Lock()

    def lookup(self, path: str) -> int:
        """Path -> inode, allocating on first sight."""
        with self._lock:
            ino = self._path_to_inode.get(path)
            if ino is None:
                ino = self._next
                self._next += 1
                self._path_to_inode[path] = ino
                self._inode_to_path[ino] = path
            return ino

    def path_of(self, inode: int) -> str | None:
        with self._lock:
            return self._inode_to_path.get(inode)

    def inode_of(self, path: str) -> int | None:
        with self._lock:
            return self._path_to_inode.get(path)

    def replace_path(self, old: str, new: str) -> None:
        """Rename: the inode follows the file (inode_to_path.go
        MovePath), including everything under a renamed directory."""
        with self._lock:
            moves = [(p, new + p[len(old):]) for p in self._path_to_inode
                     if p == old or p.startswith(old + "/")]
            for src, dst in moves:
                ino = self._path_to_inode.pop(src)
                # a pre-existing inode at the destination is retired
                stale = self._path_to_inode.pop(dst, None)
                if stale is not None:
                    self._inode_to_path.pop(stale, None)
                self._path_to_inode[dst] = ino
                self._inode_to_path[ino] = dst

    def forget(self, path: str) -> None:
        with self._lock:
            ino = self._path_to_inode.pop(path, None)
            if ino is not None:
                self._inode_to_path.pop(ino, None)
