"""WeedFS: the mount's filesystem core — POSIX-shaped operations over
the filer, with local meta cache, tiered chunk read cache, and the
dirty-page upload pipeline for writes; the counterpart of
seaweedfs_tpu/mount/weedfs.py.

Equivalent of SeaweedFS weed/mount/weedfs.go:29-60 and its op
files (weedfs_file_read.go, weedfs_file_write.go, weedfs_dir_*.go,
weedfs_attr.go, filehandle.go): the kernel-facing FUSE layer is a thin
adapter (fuse_adapter.py, optional); everything stateful lives here so
the same core drives tests, tools, and FUSE alike.

Concurrency model: one DirtyPages per open filehandle, all handles
sharing one bounded upload pipeline (page_writer/upload_pipeline.go);
reads overlay unflushed dirty bytes on committed chunk content so a
writer observes its own writes before flush.
"""
from __future__ import annotations

import base64
import errno
import os
import stat
import threading
import time
from concurrent.futures import ThreadPoolExecutor

from ..filer.entry import DIR_MODE_FLAG, Entry, FileChunk, total_size
from ..filer.filechunks import compact_file_chunks, view_from_chunks
from .chunk_cache import TieredChunkCache
from .filer_client import FilerClient
from .inode_registry import InodeRegistry
from .meta_cache import MetaCache
from .page_writer import DirtyPages


class FuseError(OSError):
    def __init__(self, errno_: int, msg: str = ""):
        super().__init__(errno_, msg or os.strerror(errno_))


# extended-attribute limits (weedfs_xattr.go:14-16; the VFS caps from
# xattr(7)) and the filer storage prefix shared with the reference
XATTR_PREFIX = "xattr-"
MAX_XATTR_NAME_SIZE = 255
MAX_XATTR_VALUE_SIZE = 65536
# <sys/xattr.h> setxattr(2) flags
XATTR_CREATE = 1
XATTR_REPLACE = 2


class FileHandle:
    def __init__(self, fh: int, path: str, entry: Entry,
                 dirty: DirtyPages):
        self.fh = fh
        self.path = path
        self.entry = entry
        self.dirty = dirty
        self.refs = 1
        self.lock = threading.Lock()
        # per-handle sequential/random classifier (reader_pattern.go):
        # drives whole-chunk caching + readahead vs ranged fetches
        from ..filer.stream import ReaderPattern

        self.pattern = ReaderPattern()


class WeedFS:
    def __init__(self, filer_url: str, master_url: str | None = None,
                 root: str = "/", chunk_size: int = 8 << 20,
                 cache_dir: str | None = None,
                 cache_mem_bytes: int = 64 << 20,
                 cache_disk_bytes: int = 1 << 30,
                 upload_workers: int = 8,
                 collection: str = "", replication: str = "",
                 subscribe: bool = True,
                 meta_ttl: float = 60.0,
                 write_memory_limit: int = 64 << 20,
                 disable_xattr: bool = False):
        """root: the filer directory this mount exposes as '/'."""
        self.client = FilerClient(filer_url, master_url,
                                  collection=collection,
                                  replication=replication)
        self.root = root.rstrip("/") or ""
        self.chunk_size = chunk_size
        self.inodes = InodeRegistry()
        self.meta = MetaCache(ttl=meta_ttl)
        self.chunks = TieredChunkCache(cache_mem_bytes, cache_dir,
                                       cache_disk_bytes)
        # readahead machinery (created HERE, not lazily under per-
        # handle locks — two handles racing a lazy init would each
        # build a pool and dedup against different in-flight sets)
        from concurrent.futures import ThreadPoolExecutor

        self._ra_pool = ThreadPoolExecutor(max_workers=1)
        self._ra_inflight: set[str] = set()
        # per-chunk-list next-chunk maps (memo[0] keeps the list alive
        # so an id() reuse after GC can never alias a stale map)
        self._ra_memos: dict[int, tuple] = {}
        # dirty-write RAM cap per handle; spill goes next to the read
        # cache when one is configured (page_writer.go swap file)
        self.write_memory_limit = write_memory_limit
        self.swap_dir = cache_dir
        self.disable_xattr = disable_xattr
        self.pipeline = ThreadPoolExecutor(max_workers=upload_workers)
        self._handles: dict[int, FileHandle] = {}
        self._next_fh = 1
        self._lock = threading.Lock()
        if self.root:
            # ensure the mounted directory exists
            try:
                self.client.mkdir(self.root)
            except Exception:
                pass
        # per-mount quota from the shell's mount.configure
        # (command_mount_configure.go): refreshed with the usage cache
        self.quota_bytes = 0
        self._usage_cache: tuple[float, int] = (-1e18, 0)
        self.quota_refresh_seconds = 15.0
        self._quota_refreshing = threading.Event()
        try:
            self._refresh_quota()
        except Exception:
            pass  # filer hiccup must not abort mounting; retried on use
        if subscribe:
            self.client.subscribe_meta(self.root or "/",
                                       self._on_meta_event)

    # ------------------------------------------------------------------
    # path plumbing
    # ------------------------------------------------------------------
    def _abs(self, path: str) -> str:
        path = "/" + path.strip("/")
        return (self.root + path).rstrip("/") or "/"

    def _rel(self, full: str) -> str:
        if self.root and full.startswith(self.root):
            full = full[len(self.root):]
        return full or "/"

    def _on_meta_event(self, ev: dict) -> None:
        self.meta.on_meta_event(ev)

    # ------------------------------------------------------------------
    # metadata ops
    # ------------------------------------------------------------------
    def _entry(self, path: str) -> Entry | None:
        full = self._abs(path)
        hit, entry = self.meta.get(full)
        if hit:
            return entry
        entry = self.client.lookup_entry(full)
        self.meta.put(full, entry)
        return entry

    def getattr(self, path: str) -> dict:
        if path in ("/", ""):
            return {"st_mode": stat.S_IFDIR | 0o755, "st_ino": 1,
                    "st_nlink": 2, "st_size": 0, "st_mtime": 0,
                    "st_ctime": 0, "st_uid": 0, "st_gid": 0}
        entry = self._entry(path)
        if entry is None:
            raise FuseError(2)  # ENOENT
        return self._attr_of(entry)

    def _attr_of(self, entry: Entry) -> dict:
        is_dir = entry.is_directory
        mode = (stat.S_IFDIR if is_dir else
                stat.S_IFLNK if entry.symlink_target else stat.S_IFREG)
        size = entry.file_size
        # open handles know about unflushed extents
        with self._lock:
            for h in self._handles.values():
                if h.path == self._rel(entry.full_path):
                    size = max(size, self._dirty_extent(h))
        return {"st_mode": mode | (entry.mode & 0o7777),
                "st_ino": self.inodes.lookup(entry.full_path),
                "st_nlink": 2 if is_dir else 1,
                "st_size": size, "st_mtime": entry.mtime,
                "st_ctime": entry.crtime, "st_uid": entry.uid,
                "st_gid": entry.gid}

    def _dirty_extent(self, h: FileHandle) -> int:
        d = h.dirty
        with d._lock:
            hi = 0
            for _, off, size, _, _ in d._uploads:
                hi = max(hi, off + size)
            for idx, slot in d._slots.items():
                hi = max(hi, idx * d.chunk_size + slot.extent)
            return hi

    def readdir(self, path: str) -> list[str]:
        full = self._abs(path)
        entry = self._entry(path)
        if path not in ("/", "") and (entry is None or
                                      not entry.is_directory):
            raise FuseError(20 if entry is not None else 2)  # ENOTDIR
        cached = self.meta.dir_listing(full)
        if cached is not None:
            return [".", ".."] + cached
        children = []
        for e in self.client.list_dir(full):
            self.meta.put(e.full_path, e)
            children.append(e.name)
        self.meta.mark_dir_listed(full, children)
        return [".", ".."] + children

    def mkdir(self, path: str, mode: int = 0o755) -> None:
        full = self._abs(path)
        if self._entry(path) is not None:
            raise FuseError(17)  # EEXIST
        self.client.mkdir(full)
        self.meta.invalidate(full)

    def rmdir(self, path: str) -> None:
        full = self._abs(path)
        entry = self._entry(path)
        if entry is None:
            raise FuseError(2)
        if not entry.is_directory:
            raise FuseError(20)
        if self.client.list_dir(full, limit=1):
            raise FuseError(39)  # ENOTEMPTY
        self.client.delete(full)
        self.meta.invalidate(full)
        self.inodes.forget(full)

    def unlink(self, path: str) -> None:
        full = self._abs(path)
        entry = self._entry(path)
        if entry is None:
            raise FuseError(2)
        self.client.delete(full)
        self.meta.invalidate(full)
        self.inodes.forget(full)

    def rename(self, old: str, new: str) -> None:
        full_old, full_new = self._abs(old), self._abs(new)
        if self._entry(old) is None:
            raise FuseError(2)
        self.client.rename(full_old, full_new)
        self.inodes.replace_path(full_old, full_new)
        self.meta.invalidate(full_old)
        self.meta.invalidate(full_new)
        with self._lock:  # open handles follow the rename
            targets = []
            for h in self._handles.values():
                if h.path == old:
                    targets.append((h, new))
                elif h.path.startswith(old + "/"):
                    targets.append((h, new + h.path[len(old):]))
        # h.lock is taken OUTSIDE self._lock (release() orders
        # h.lock -> self._lock; nesting the other way would deadlock)
        for h, new_path in targets:
            with h.lock:
                h.path = new_path
                # the pinned entry must follow too, or a later flush
                # saves the dirty chunks back under the OLD path —
                # resurrecting the deleted name, starving the new one
                h.entry.full_path = self._abs(new_path)

    def link(self, src: str, dst: str) -> None:
        """Hard link (weedfs_link.go): another name for src's chunks,
        shared through the filer's hardlink record."""
        if self._entry(src) is None:
            raise FuseError(2)  # ENOENT
        if self._entry(dst) is not None:
            raise FuseError(17)  # EEXIST
        try:
            self.client.link(self._abs(src), self._abs(dst))
        except OSError as e:
            # local pre-checks ran against a possibly-stale meta cache;
            # the server's verdict wins and must keep POSIX semantics
            status = e.errno
            if status == 404:
                raise FuseError(2, str(e))   # ENOENT
            if status == 409:
                raise FuseError(17, str(e))  # EEXIST
            raise FuseError(5, str(e))       # EIO
        self.meta.invalidate(self._abs(src))
        self.meta.invalidate(self._abs(dst))

    def symlink(self, target: str, linkpath: str) -> None:
        full = self._abs(linkpath)
        entry = Entry(full_path=full, mode=0o777,
                      symlink_target=target)
        self.client.save_entry(entry)
        self.meta.invalidate(full)

    def readlink(self, path: str) -> str:
        entry = self._entry(path)
        if entry is None:
            raise FuseError(2)
        if not entry.symlink_target:
            raise FuseError(22)  # EINVAL
        return entry.symlink_target

    def chmod(self, path: str, mode: int) -> None:
        self._update_attr(path, mode=mode & 0o7777)

    def chown(self, path: str, uid: int, gid: int) -> None:
        self._update_attr(path, uid=uid, gid=gid)

    def utimens(self, path: str, mtime: float) -> None:
        self._update_attr(path, mtime=mtime)

    def _update_attr(self, path: str, **fields) -> None:
        entry = self._entry(path)
        if entry is None:
            raise FuseError(2)
        dir_bit = entry.mode & DIR_MODE_FLAG
        for k, v in fields.items():
            setattr(entry, k, v)
        entry.mode |= dir_bit
        self.client.save_entry(entry)
        self.meta.put(entry.full_path, entry)

    # ------------------------------------------------------------------
    # extended attributes (weedfs_xattr.go:22-181): stored as
    # `xattr-`-prefixed entry extended attributes on the filer, values
    # base64-armored so arbitrary xattr BYTES survive the JSON entry
    # encoding every filer store shares (the reference's protobuf
    # entries carry raw []byte and don't need the armor).
    # ------------------------------------------------------------------
    def _xattr_check(self, name: str | None) -> None:
        """Pre-lookup validation, in the reference's order
        (weedfs_xattr.go: DisableXAttr first, then the name cap)."""
        if self.disable_xattr:
            raise FuseError(errno.ENOTSUP)
        if name is not None:
            if not name:
                raise FuseError(errno.EINVAL)
            if len(name) > MAX_XATTR_NAME_SIZE:
                raise FuseError(errno.ERANGE)

    def _xattr_entry(self, path: str, name: str | None) -> Entry:
        self._xattr_check(name)
        entry = self._entry(path)
        if entry is None:
            raise FuseError(errno.ENOENT)
        return entry

    def getxattr(self, path: str, name: str) -> bytes:
        entry = self._xattr_entry(path, name)
        v = entry.extended.get(XATTR_PREFIX + name)
        if v is None:
            raise FuseError(errno.ENODATA)  # == ENOATTR on linux
        return base64.b64decode(v)

    def setxattr(self, path: str, name: str, value: bytes,
                 flags: int = 0) -> None:
        """Proper setxattr(2) flag semantics (XATTR_CREATE on an
        existing name is EEXIST, XATTR_REPLACE on a missing one is
        ENODATA) — the reference silently no-ops the first case
        (weedfs_xattr.go:123-133). Too-large values are ERANGE, the
        reference's linux arm (weedfs_xattr.go:99-104)."""
        self._xattr_check(name)
        if len(value) > MAX_XATTR_VALUE_SIZE:
            raise FuseError(errno.ERANGE)
        self._check_quota(len(value))
        key = XATTR_PREFIX + name

        def mutate(extended: dict) -> None:
            exists = key in extended
            if flags == XATTR_CREATE and exists:
                raise FuseError(errno.EEXIST)
            if flags == XATTR_REPLACE and not exists:
                raise FuseError(errno.ENODATA)
            extended[key] = base64.b64encode(value).decode()

        self._mutate_xattrs(path, mutate)

    def listxattr(self, path: str) -> list[str]:
        entry = self._xattr_entry(path, None)
        return [k[len(XATTR_PREFIX):] for k in entry.extended
                if k.startswith(XATTR_PREFIX)]

    def removexattr(self, path: str, name: str) -> None:
        self._xattr_check(name)
        key = XATTR_PREFIX + name

        def mutate(extended: dict) -> None:
            if key not in extended:
                raise FuseError(errno.ENODATA)
            del extended[key]

        self._mutate_xattrs(path, mutate)

    def _mutate_xattrs(self, path: str,
                       mutate: "Callable[[dict], None]") -> None:
        """Apply an extended-attributes mutation and persist it. When
        the path has an open write handle, the mutation runs on the
        HANDLE's entry under its lock — that object owns the freshest
        chunk list, so saving it cannot revert a concurrent flush's
        chunks (the reference reaches the same safety via
        fh.dirtyMetadata deferral, weedfs_xattr.go:135-138)."""
        with self._lock:
            handles = [h for h in self._handles.values()
                       if h.path == path]
        if handles:
            h = handles[0]
            with h.lock:
                mutate(h.entry.extended)
                self.client.save_entry(h.entry)
                self.meta.put(h.entry.full_path, h.entry)
                for other in handles[1:]:
                    if other.entry is not h.entry:
                        other.entry.extended = dict(h.entry.extended)
            return
        entry = self._entry(path)
        if entry is None:
            raise FuseError(errno.ENOENT)
        mutate(entry.extended)
        self.client.save_entry(entry)
        self.meta.put(entry.full_path, entry)

    # ------------------------------------------------------------------
    # file handles
    # ------------------------------------------------------------------
    def create(self, path: str, mode: int = 0o644) -> int:
        full = self._abs(path)
        entry = Entry(full_path=full, mode=mode & 0o7777, chunks=[])
        self.client.save_entry(entry)
        self.meta.invalidate(full)  # parent's cached listing is stale
        self.meta.put(full, entry)
        return self._open_handle(path, entry)

    def open(self, path: str, truncate: bool = False) -> int:
        entry = self._entry(path)
        if entry is None:
            raise FuseError(2)
        if entry.is_directory:
            raise FuseError(21)  # EISDIR
        if truncate and entry.chunks:
            entry.chunks = []
            entry.mtime = time.time()
            self.client.save_entry(entry)
            self.meta.put(entry.full_path, entry)
        return self._open_handle(path, entry)

    def _open_handle(self, path: str, entry: Entry) -> int:
        with self._lock:
            fh = self._next_fh
            self._next_fh += 1
            dirty = DirtyPages(self._uploader(), self.chunk_size,
                               pipeline=self.pipeline,
                               memory_limit=self.write_memory_limit,
                               swap_dir=self.swap_dir)
            self._handles[fh] = FileHandle(fh, path, entry, dirty)
            return fh

    def _uploader(self):
        def up(data: bytes):
            fid, _etag, ckey = self.client.upload_chunk(data)
            return fid, ckey
        return up

    def _handle(self, fh: int) -> FileHandle:
        with self._lock:
            h = self._handles.get(fh)
        if h is None:
            raise FuseError(9)  # EBADF
        return h

    # ------------------------------------------------------------------
    # io
    # ------------------------------------------------------------------
    def _refresh_quota(self) -> None:
        import json as _json

        raw = self.client.kv_get("mount.conf")
        conf = _json.loads(raw) if raw else {}
        mount_dir = self.root or "/"
        self.quota_bytes = int(
            conf.get(mount_dir, {}).get("quota_bytes", 0))

    def _du(self, path: str) -> int:
        total = 0
        for e in self.client.list_dir(path):
            if e.is_directory:
                total += self._du(e.full_path)
            else:
                total += total_size(e.chunks)
        return total

    def refresh_quota_now(self) -> None:
        """Synchronous quota + usage refresh (tests and tooling; the
        write path refreshes in the background instead)."""
        self._quota_refreshing.set()
        self._refresh_usage_bg(time.monotonic())

    def _refresh_usage_bg(self, now: float) -> None:
        try:
            self._refresh_quota()
            usage = self._du(self.root or "/") if self.quota_bytes \
                else 0
            # flushed handles are in the filer's usage now; only keep
            # counting what is still dirty
            with self._lock:
                for h in self._handles.values():
                    if not h.dirty.has_dirty():
                        h.dirty.written_bytes = 0
            self._usage_cache = (now, usage)
        except Exception:
            # keep the stale view; retried next window
            self._usage_cache = (now, self._usage_cache[1])
        finally:
            self._quota_refreshing.clear()

    def _check_quota(self, incoming: int) -> None:
        """EDQUOT when the mount is over its configured quota
        (weedfs_quota.go maybeCheckQuota): usage is the filer's view
        refreshed periodically, plus bytes buffered in open handles.
        The config is re-read on the same cadence even when no quota is
        currently set, so mount.configure takes effect on live mounts;
        refresh errors keep the previous view (fail open) — a filer
        hiccup must not fail writes that never depended on it."""
        now = time.monotonic()
        ts, usage = self._usage_cache
        if now - ts > self.quota_refresh_seconds and \
                not self._quota_refreshing.is_set():
            # the usage walk is one list_dir per directory — never run
            # it inline in write(); a background refresh keeps write
            # latency flat and the stale view serves meanwhile
            self._quota_refreshing.set()
            threading.Thread(target=self._refresh_usage_bg,
                             args=(now,), daemon=True).start()
        if not self.quota_bytes:
            return
        with self._lock:
            buffered = sum(h.dirty.written_bytes
                           for h in self._handles.values())
        if usage + buffered + incoming > self.quota_bytes:
            raise FuseError(errno.EDQUOT,
                            f"quota {self.quota_bytes} exceeded")

    def write(self, fh: int, offset: int, data: bytes) -> int:
        h = self._handle(fh)
        self._check_quota(len(data))
        with h.lock:
            if h.entry.content and not h.entry.chunks:
                # inline small file (entry.Content): its bytes become
                # dirty pages so the flush rewrites the whole file as
                # chunks — the saved entry then carries no content
                h.dirty.write(0, h.entry.content)
                h.entry.content = b""
            h.dirty.write(offset, data)
        return len(data)

    def read(self, fh: int, offset: int, size: int) -> bytes:
        h = self._handle(fh)
        # h.lock makes the (entry.chunks, dirty overlay) pair atomic
        # against flush: mid-flush the overlay is already drained but
        # the chunks aren't merged yet — an unlocked read in that
        # window returns zeros, and a concurrent kernel READAHEAD
        # hitting it poisons the page cache with them
        with h.lock:
            h.pattern.monitor(offset, size)
            # inline small files carry their bytes in the entry
            # (entry.Content) — no chunks to fetch
            inline = h.entry.content if not h.entry.chunks else b""
            committed_size = total_size(h.entry.chunks) or len(inline)
            out = bytearray(size)
            # committed chunks first
            n_committed = 0
            if offset < committed_size:
                want = min(size, committed_size - offset)
                if inline:
                    data = inline[offset:offset + want]
                else:
                    data = self._read_chunks(h.entry.chunks, offset,
                                             want, h.pattern)
                out[:len(data)] = data
                n_committed = len(data)
            # dirty overlay wins over committed bytes
            covered = h.dirty.read_overlay(offset, size, out)
            # the readable extent includes unflushed HOLES: a write at
            # offset 1000 makes bytes 0..999 real zeros now, not EOF —
            # pre- and post-flush reads of a sparse file must agree
            file_size = max(committed_size, self._dirty_extent(h))
            max_extent = max(
                [offset + n_committed, min(offset + size, file_size)]
                + [e for _, e in covered]) - offset
            return bytes(out[:min(size, max(max_extent, 0))])

    def _read_chunks(self, chunks: list[FileChunk], offset: int,
                     size: int, pattern=None) -> bytes:
        """Assemble [offset, offset+size) from visible chunk views.
        Sequential handles ride the tiered whole-chunk cache with
        one-chunk readahead (reader_cache.go MaybeCache); random
        handles fetch exactly the requested ranges — a 4KB random
        read must not pull an 8MB chunk into the cache
        (reader_pattern.go's whole point)."""
        views = view_from_chunks(chunks, offset, size)
        random_mode = pattern is not None and pattern.is_random
        chunk_sizes = {c.fid: c.size for c in chunks}
        out = bytearray(size)
        for v in views:
            data = self.chunks.get(v.fid)
            if data is None and random_mode and not v.cipher_key and \
                    v.view_size < chunk_sizes.get(v.fid, 0):
                piece = self.client.read_chunk_range(
                    v.fid, v.offset_in_chunk, v.view_size)
                out[v.view_offset - offset:
                    v.view_offset - offset + len(piece)] = piece
                continue
            if data is None:
                # read_chunk decrypts ciphered chunks; the tiered
                # cache holds plaintext (keys live in entry metadata,
                # the cache dir is as trusted as the mount itself)
                data = self.client.read_chunk(v.fid, v.cipher_key)
                self.chunks.put(v.fid, data)
            if not random_mode:
                self._maybe_readahead(chunks, v.fid)
            piece = data[v.offset_in_chunk:v.offset_in_chunk + v.view_size]
            pos = v.view_offset - offset
            out[pos:pos + len(piece)] = piece
        return bytes(out)

    def _maybe_readahead(self, chunks: list[FileChunk],
                         cur_fid: str) -> None:
        """Prefetch the next chunk after `cur_fid` into the tiered
        cache on a background thread (bounded to one in flight). The
        next-chunk map is memoized per chunk LIST (flush installs a
        new list object) — the FUSE read hot path must not re-sort
        1000+ chunks per 128KB kernel read."""
        memo = self._ra_memos.get(id(chunks))
        if memo is None or memo[0] is not chunks:
            ordered = sorted(
                (c for c in chunks if not c.is_chunk_manifest),
                key=lambda c: c.offset)
            nxt_map = {ordered[i].fid: ordered[i + 1]
                       for i in range(len(ordered) - 1)}
            if len(self._ra_memos) > 64:  # open-file working set cap
                self._ra_memos.clear()
            memo = self._ra_memos[id(chunks)] = (chunks, nxt_map)
        nxt = memo[1].get(cur_fid)
        if nxt is None or nxt.cipher_key or \
                self.chunks.get(nxt.fid) is not None:
            return
        inflight = self._ra_inflight
        if nxt.fid in inflight or len(inflight) >= 2:
            return
        inflight.add(nxt.fid)

        def fetch(fid=nxt.fid):
            try:
                data = self.client.read_chunk(fid)
                self.chunks.put(fid, data)
            except Exception:
                pass  # readahead is best-effort
            finally:
                inflight.discard(fid)

        # copy_context: keep the caller's trace/deadline on the
        # readahead thread (pool.submit drops contextvars)
        import contextvars as _cv

        self._ra_pool.submit(_cv.copy_context().run, fetch)

    def flush(self, fh: int) -> None:
        """Commit dirty pages: upload remainders, merge new chunks into
        the entry, save (weedfs_file_sync.go doFlush)."""
        h = self._handle(fh)
        with h.lock:
            new_chunks = h.dirty.flush()
            if not new_chunks:
                return
            entry = h.entry
            # garbage = fully-shadowed chunks; the filer's meta save
            # deletes committed ones it no longer sees, and never-
            # committed ones are reclaimed by volume.fsck
            entry.chunks, _garbage = compact_file_chunks(
                entry.chunks + new_chunks)
            entry.mtime = time.time()
            self.client.save_entry(entry)
            self.meta.put(entry.full_path, entry)

    def release(self, fh: int) -> None:
        h = self._handle(fh)
        self.flush(fh)
        with self._lock:
            h.refs -= 1
            if h.refs <= 0:
                self._handles.pop(fh, None)

    def truncate(self, path: str, length: int, fh: int | None = None) -> None:
        # flush EVERY handle on this path (the path-based syscall has
        # no fh): dirty spans surviving a truncate would resurrect the
        # truncated bytes at the next flush
        with self._lock:
            open_fhs = [h.fh for h in self._handles.values()
                        if h.path == path]
        for open_fh in open_fhs:
            self.flush(open_fh)
        entry = self._entry(path)
        if entry is None:
            raise FuseError(2)
        if entry.content and not entry.chunks:
            # inline file: POSIX truncate semantics on the bytes
            # themselves (extend pads zeros). A LARGE extend must not
            # balloon the metadata store — convert to a chunk instead
            # (the same inline->chunks conversion write() does)
            padded = entry.content[:length].ljust(length, b"\0")
            if length > (64 << 10):
                fid, etag, ckey = self.client.upload_chunk(
                    padded, name=entry.name)
                entry.chunks = [FileChunk(
                    fid=fid, offset=0, size=length,
                    mtime_ns=time.time_ns(), etag=etag,
                    cipher_key=ckey)]
                entry.content = b""
            else:
                entry.content = padded
        elif length == 0:
            entry.chunks = []
        else:
            kept = []
            for c in entry.chunks:
                if c.offset >= length:
                    continue
                if c.offset + c.size > length:
                    import dataclasses

                    # replace() keeps every other field — dropping
                    # cipher_key here would destroy the only copy of
                    # the chunk's AES key
                    c = dataclasses.replace(c, size=length - c.offset)
                kept.append(c)
            entry.chunks = kept
        entry.mtime = time.time()
        self.client.save_entry(entry)
        self.meta.put(entry.full_path, entry)
        with self._lock:
            for h in self._handles.values():
                if h.path == path:
                    h.entry = entry

    # ------------------------------------------------------------------
    def statfs(self) -> dict:
        return {"f_bsize": self.chunk_size, "f_blocks": 1 << 30,
                "f_bfree": 1 << 30, "f_bavail": 1 << 30}

    def destroy(self) -> None:
        for fh in list(self._handles):
            try:
                self.release(fh)
            except Exception:
                pass
        self.client.stop_subscription()
        self.pipeline.shutdown(wait=True)
        # don't wait: an in-flight readahead may sit in a 60s HTTP
        # read; its best-effort cache put after teardown is harmless
        self._ra_pool.shutdown(wait=False, cancel_futures=True)
