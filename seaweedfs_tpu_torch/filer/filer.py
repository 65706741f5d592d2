"""The Filer: a directory namespace over a pluggable metadata store;
the counterpart of seaweedfs_tpu/filer/filer.py, copied as is (its
locks were threading locks there too).

Equivalent of SeaweedFS weed/filer/filer.go:36 (Filer) — path -> Entry
CRUD with parent-directory auto-creation (CreateEntry filer.go:197),
TTL expiry on read/list, recursive delete that hands the dead chunks
back for volume-server deletion (filer_delete_entry.go), hard links,
and rename via move. Every mutation is appended to the metadata event
log (filer_notify.go).
"""
from __future__ import annotations

import base64
import fnmatch
import json
import threading
import time
import uuid
from dataclasses import replace
from typing import Callable

from .entry import DIR_MODE_FLAG, Entry, FileChunk
from .event_log import MetaEventLog
from .filerstore import FilerStore, make_store

LIST_BATCH = 1024


class DirectoryNotEmptyError(OSError):
    pass


def norm_path(path: str) -> str:
    out = "/" + "/".join(p for p in path.split("/") if p and p != ".")
    return out


def _split_pattern(pattern: str) -> tuple[str, str]:
    """Literal head / glob tail of a name pattern (filer_search.go:11):
    the head feeds the store's prefix index, the tail is fnmatch'd."""
    for i, ch in enumerate(pattern):
        if ch in "*?[":
            return pattern[:i], pattern[i:]
    return pattern, ""  # wildcard-less: pure literal, exact match


class _TrackedRLock:
    """RLock with a portable is-held-by-this-thread probe, for
    interpreters whose RLock lacks the private _is_owned API. The
    deferred chunk-free drain depends on that probe to never run
    deletions while a metadata lock is held (see _drain_freed)."""

    def __init__(self):
        self._lock = threading.RLock()
        self._owner: int | None = None
        self._depth = 0

    def acquire(self, blocking: bool = True, timeout: float = -1):
        got = self._lock.acquire(blocking, timeout)
        if got:
            self._owner = threading.get_ident()
            self._depth += 1
        return got

    def release(self):
        self._depth -= 1
        if self._depth == 0:
            self._owner = None
        self._lock.release()

    __enter__ = acquire

    def __exit__(self, *exc):
        self.release()

    def _is_owned(self) -> bool:
        return self._owner == threading.get_ident()


def _owned_rlock():
    lock = threading.RLock()
    return lock if hasattr(lock, "_is_owned") else _TrackedRLock()


class Filer:
    def __init__(self, store: FilerStore | str = "memory",
                 on_delete_chunks: Callable[[list[FileChunk]], None]
                 | None = None, signature: int = 0, **store_kwargs):
        self.store = (store if isinstance(store, FilerStore)
                      else make_store(store, **store_kwargs))
        self.meta_log = MetaEventLog(signature=signature)
        self.on_delete_chunks = on_delete_chunks or (lambda chunks: None)
        # lock order: _mutation_lock (all metadata writes) outer,
        # _hardlink_lock (shared-record read-modify-write) inner. Both
        # reentrant: the TTL-expiry path runs inside readers that a
        # mutation may invoke on its own thread.
        self._mutation_lock = _owned_rlock()
        self._hardlink_lock = _owned_rlock()
        # chunks freed by TTL expiry hit volume servers over HTTP; when
        # expiry fires inside a locked mutation the frees are queued
        # here and drained once the locks are released
        self._free_lock = threading.Lock()
        self._free_queue: list[FileChunk] = []
        # known-directory cache for _ensure_parents (mutation-lock
        # protected; see _invalidate_dir)
        self._parent_cache: set[str] = set()

    # -- hard links (filerstore_hardlink.go) ----------------------------
    # Linked entries share one content record in the store's KV space:
    # {"count": refs, "chunks": [...]}. Entries carry hard_link_id and
    # no chunks of their own; reads resolve through the record, so a
    # write via any name is visible through all names, and the chunks
    # are reclaimed only when the last name goes away.
    HARDLINK_KV_PREFIX = "hardlink/"

    def _hardlink_record(self, hid: str) -> dict | None:
        raw = self.store.kv_get(self.HARDLINK_KV_PREFIX + hid)
        return json.loads(raw) if raw else None

    def _put_hardlink_record(self, hid: str, rec: dict) -> None:
        self.store.kv_put(self.HARDLINK_KV_PREFIX + hid,
                          json.dumps(rec).encode())

    def _resolve_hardlink(self, e: Entry) -> Entry:
        if e.hard_link_id and not e.is_directory:
            rec = self._hardlink_record(e.hard_link_id)
            if rec is not None:
                e.chunks = [FileChunk.from_dict(c)
                            for c in rec.get("chunks", [])]
                if rec.get("content"):
                    e.content = base64.b64decode(rec["content"])
                # version stamp: a later save of this entry proves it
                # saw THIS content (guards metadata-only saves built
                # from a stale read from clobbering newer writes)
                e.extended["hardlink_ver"] = str(rec.get("ver", 0))
        return e

    def link(self, src_path: str, dst_path: str,
             signatures: list[int] | None = None) -> Entry:
        """Create a hard link: dst becomes another name for src's
        content (mount link(), filer_pb AppendToEntry-style sharing)."""
        src_path, dst_path = norm_path(src_path), norm_path(dst_path)
        with self._mutation_lock, self._hardlink_lock:
            # src is (re)read under the lock: two concurrent first-links
            # must not each mint their own record for the same file
            src = self.find_entry(src_path)
            if src is None:
                raise FileNotFoundError(src_path)
            if src.is_directory:
                raise IsADirectoryError(f"cannot hard-link a "
                                        f"directory: {src_path}")
            if self.find_entry(dst_path) is not None:
                raise FileExistsError(dst_path)
            if not src.hard_link_id:
                hid = uuid.uuid4().hex
                rec0 = {"count": 1,
                        "chunks": [c.to_dict() for c in src.chunks]}
                if src.content:
                    # inline small file: its bytes live in the shared
                    # record so every NAME serves them
                    rec0["content"] = base64.b64encode(
                        src.content).decode()
                self._put_hardlink_record(hid, rec0)
                old_src = replace(src)
                src.hard_link_id = hid
                self.store.insert_entry(
                    replace(src, chunks=[], content=b""))
                # src changed shape: event consumers (meta backups,
                # other mounts) must learn its hard_link_id
                d, _ = src.dir_and_name
                self.meta_log.append(d, old_src, src, signatures)
            rec = self._hardlink_record(src.hard_link_id)
            rec["count"] = int(rec.get("count", 1)) + 1
            self._put_hardlink_record(src.hard_link_id, rec)
            # dst insert stays under the lock: a racing link() to the
            # same dst must hit FileExistsError, not clobber-and-leak
            dst = Entry(full_path=dst_path, mode=src.mode, uid=src.uid,
                        gid=src.gid, mime=src.mime, md5=src.md5,
                        collection=src.collection,
                        replication=src.replication,
                        ttl_sec=src.ttl_sec,
                        hard_link_id=src.hard_link_id)
            self._ensure_parents(dst_path)
            self.store.insert_entry(replace(dst, chunks=[]))
            dst = self._resolve_hardlink(dst)
            d, _ = dst.dir_and_name
            # log the RESOLVED entry (subscribers must see real
            # chunks) INSIDE the lock: a racing delete of dst would
            # otherwise log its delete first and subscribers would
            # apply create-after-delete, resurrecting the name
            self.meta_log.append(d, None, dst, signatures)
        self._drain_freed()
        return dst

    def _hardlink_unref(self, e: Entry) -> list[FileChunk]:
        """Drop one reference; returns the chunks to reclaim when this
        was the last name."""
        with self._hardlink_lock:
            rec = self._hardlink_record(e.hard_link_id)
            if rec is None:
                return []
            rec["count"] = int(rec.get("count", 1)) - 1
            if rec["count"] <= 0:
                self.store.kv_delete(
                    self.HARDLINK_KV_PREFIX + e.hard_link_id)
                return [FileChunk.from_dict(c)
                        for c in rec.get("chunks", [])]
            self._put_hardlink_record(e.hard_link_id, rec)
            return []

    def _expire(self, e: Entry) -> None:
        """Drop a TTL-expired name; a hardlinked name must release its
        record reference or the shared chunks leak forever. Frees are
        queued — this can run inside a locked mutation's read."""
        self.store.delete_entry(e.full_path)
        if e.is_directory:
            # a cached parent that expired must be re-created by the
            # next write under it
            self._invalidate_dir(e.full_path)
        if e.hard_link_id and not e.is_directory:
            freed = self._hardlink_unref(e)
            if freed:
                with self._free_lock:
                    self._free_queue.extend(freed)

    def _drain_freed(self) -> None:
        """Run queued chunk deletions — only once no metadata lock is
        held by this thread (mutations drain on their way out)."""
        if self._mutation_lock._is_owned() or \
                self._hardlink_lock._is_owned():
            return
        with self._free_lock:
            chunks, self._free_queue = self._free_queue, []
        if chunks:
            self.on_delete_chunks(chunks)

    # -- reads ----------------------------------------------------------
    def find_entry(self, path: str) -> Entry | None:
        path = norm_path(path)
        if path == "/":
            return Entry(full_path="/", mode=0o775 | DIR_MODE_FLAG)
        e = self.store.find_entry(path)
        if e is not None and e.is_expired():
            self._expire(e)
            self._drain_freed()
            return None
        return self._resolve_hardlink(e) if e is not None else None

    def list_entries(self, dirpath: str, start_from: str = "",
                     inclusive: bool = False, limit: int = LIST_BATCH,
                     prefix: str = "", name_pattern: str = "",
                     name_pattern_exclude: str = "") -> list[Entry]:
        """`name_pattern`/`name_pattern_exclude` are shell globs applied
        over the page stream (filer_search.go:24 ListDirectoryEntries):
        the literal head of the pattern becomes the store prefix filter
        (splitPattern, filer_search.go:11) and the wildcard tail is
        glob-matched against the remainder, paging past misses so a
        page of non-matches can't be misread as end-of-directory.
        Divergence from the reference: a wildcard-less pattern is an
        exact-name filter here (the reference silently ignores it)."""
        dirpath = norm_path(dirpath)
        pat_prefix, rest = _split_pattern(name_pattern)
        if pat_prefix:
            prefix = pat_prefix
        out, now = [], time.time()
        # TTL-expired entries are filtered AFTER the raw page, so keep
        # paging until `limit` live entries are in hand or the raw
        # stream truly ends — otherwise a page with expired entries
        # under-fills and callers misread it as end-of-directory
        last, first = start_from, True
        while len(out) < limit:
            want = limit - len(out)
            batch = self.store.list_directory_entries(
                dirpath, last, inclusive if first else False, want,
                prefix)
            for e in batch:
                if e.is_expired(now):
                    self._expire(e)
                    continue
                name = e.name
                if name_pattern_exclude and fnmatch.fnmatchcase(
                        name, name_pattern_exclude):
                    continue
                if name_pattern and not fnmatch.fnmatchcase(
                        name[len(pat_prefix):], rest):
                    continue
                out.append(self._resolve_hardlink(e))
            if len(batch) < want:
                break
            last, first = batch[-1].name, False
        self._drain_freed()
        return out

    def iter_tree(self, dirpath: str):
        """Depth-first generator over a subtree, expired entries
        skipped. Pagination is driven by the RAW store batch size —
        list_entries filters expired entries post-page, so its result
        length cannot signal end-of-directory."""
        dirpath = norm_path(dirpath)
        start, now = "", time.time()
        while True:
            batch = self.store.list_directory_entries(
                dirpath, start_from=start, limit=LIST_BATCH)
            for e in batch:
                if e.is_expired(now):
                    continue
                yield self._resolve_hardlink(e)
                if e.is_directory:
                    yield from self.iter_tree(e.full_path)
            if len(batch) < LIST_BATCH:
                return
            start = batch[-1].name

    # -- writes ---------------------------------------------------------
    def create_entry(self, entry: Entry,
                     signatures: list[int] | None = None,
                     gc_old_chunks: bool = False) -> Entry:
        """Insert/overwrite one entry. gc_old_chunks=True also reclaims
        the replaced entry's chunks that the new entry dropped —
        computed inside the mutation lock so two concurrent overwrites
        of one path can't both snapshot the same predecessor and leak
        the loser's chunks (the find+create+GC TOCTOU)."""
        entry.full_path = norm_path(entry.full_path)
        if entry.full_path == "/":
            return entry
        freed: list[FileChunk] = []
        with self._mutation_lock:
            self._ensure_parents(entry.full_path)
            old = self.store.find_entry(entry.full_path)
            if old is not None and old.is_directory \
                    and not entry.is_directory:
                raise IsADirectoryError(entry.full_path)
            if old is not None and old.hard_link_id and \
                    entry.hard_link_id != old.hard_link_id:
                # this NAME now points elsewhere: drop one reference on
                # the old record; chunks free only at the last name
                freed.extend(self._hardlink_unref(old))
            logged = entry
            if entry.hard_link_id and not entry.is_directory:
                # content lives in the shared record: a write through
                # any name must be visible through every name. A save
                # whose hardlink_ver doesn't match saw STALE content
                # (chmod built from an old read racing a writer): its
                # metadata lands but its chunk list is ignored — it
                # must not resurrect freed chunks or delete newer ones.
                try:
                    caller_ver = int(
                        entry.extended.pop("hardlink_ver"))
                except (KeyError, TypeError, ValueError):
                    caller_ver = None
                with self._hardlink_lock:
                    rec = self._hardlink_record(entry.hard_link_id) \
                        or {"count": 1, "ver": 0, "chunks": []}
                    current = int(rec.get("ver", 0))
                    # ver 0 = record never written (fresh link target);
                    # an empty chunk list at ver>=1 is a real truncate
                    # and must NOT readmit stale saves
                    accept = caller_ver == current or current == 0
                    if accept:
                        keep = {c.fid for c in entry.chunks}
                        freed.extend(
                            FileChunk.from_dict(c)
                            for c in rec.get("chunks", [])
                            if c.get("fid") not in keep)
                        rec["chunks"] = [c.to_dict()
                                         for c in entry.chunks]
                        # the record holds EITHER chunks or inline
                        # content — a chunked rewrite must not leave
                        # stale inline bytes shadowing it (reads
                        # prefer content)
                        if entry.content:
                            rec["content"] = base64.b64encode(
                                entry.content).decode()
                        else:
                            rec.pop("content", None)
                        rec["ver"] = current + 1
                        self._put_hardlink_record(entry.hard_link_id,
                                                  rec)
                    else:
                        # rejected: free NOTHING here — the discarded
                        # list may be a stale reader's historical view
                        # (those chunks were already reclaimed when
                        # they were replaced, and must not be "freed"
                        # again) or a losing writer's fresh uploads
                        # (left for volume.fsck's orphan sweep). The
                        # event log must carry what the record ACTUALLY
                        # contains, not the discarded list.
                        logged = replace(
                            logged,
                            chunks=[FileChunk.from_dict(c)
                                    for c in rec.get("chunks", [])],
                            content=base64.b64decode(rec["content"])
                            if rec.get("content") else b"")
                entry = replace(entry, chunks=[], content=b"")
            if gc_old_chunks and old is not None and \
                    not old.is_directory and not old.hard_link_id:
                # logged always carries the REAL new content (even for
                # hardlinked entries whose stored chunks are cleared)
                keep = {c.fid for c in logged.chunks}
                freed.extend(c for c in old.chunks
                             if c.fid not in keep)
            ed = entry.to_dict()  # built once: store encode + event
            self.store.insert_entry_encoded(entry, ed)
            d, _ = entry.dir_and_name
            # the event carries the RESOLVED shape (real chunks):
            # subscribers must not see hardlinked files as empty
            self.meta_log.append(d, old, logged, signatures,
                                 new_dict=ed if logged is entry else None)
        if freed:
            # chunk deletion does volume-server round trips: never
            # under the metadata locks
            self.on_delete_chunks(freed)
        self._drain_freed()
        return self._resolve_hardlink(entry)

    def update_entry(self, entry: Entry,
                     signatures: list[int] | None = None) -> Entry:
        return self.create_entry(entry, signatures)

    def mkdir(self, path: str, mode: int = 0o775,
              signatures: list[int] | None = None) -> Entry:
        path = norm_path(path)
        e = self.find_entry(path)
        if e is not None:
            if not e.is_directory:
                raise NotADirectoryError(path)
            return e
        return self.create_entry(
            Entry(full_path=path, mode=mode | DIR_MODE_FLAG),
            signatures=signatures)

    def _ensure_parents(self, path: str) -> None:
        # known-directory cache: bulk ingest repeats the same parent
        # chain for every entry (S3 keys under one bucket), and the
        # store round trips measured as a third of create_entry's cost.
        # Only positive knowledge is cached, under the mutation lock;
        # directory deletes/renames invalidate in _invalidate_dir.
        cache = self._parent_cache
        parts = path.strip("/").split("/")[:-1]
        cur = ""
        for p in parts:
            cur += "/" + p
            if cur in cache:
                continue
            if self.store.find_entry(cur) is None:
                ent = Entry(full_path=cur, mode=0o775 | DIR_MODE_FLAG)
                self.store.insert_entry(ent)
                d, _ = ent.dir_and_name
                self.meta_log.append(d, None, ent)
            if len(cache) >= 65536:
                cache.clear()
            cache.add(cur)

    def _invalidate_dir(self, path: str) -> None:
        """Drop `path` and everything under it from the known-directory
        cache (a deleted dir must be re-created by the next write)."""
        cache = self._parent_cache
        sub = path + "/"
        for p in [p for p in cache if p == path or p.startswith(sub)]:
            cache.discard(p)

    def delete_entry(self, path: str, recursive: bool = False,
                     delete_chunks: bool = True,
                     signatures: list[int] | None = None) -> None:
        """delete_chunks=False removes names only, leaving volume data
        alive (the reference's isDeleteData=false — used when another
        entry still references the same chunks, e.g. multipart
        completion)."""
        path = norm_path(path)
        with self._mutation_lock:
            dead = self._delete_entry_locked(path, recursive,
                                             signatures)
        if dead and delete_chunks:
            # volume-server round trips happen outside the lock
            self.on_delete_chunks(dead)
        self._drain_freed()

    def _delete_entry_locked(self, path, recursive,
                             signatures) -> list[FileChunk]:
        e = self.find_entry(path)
        if e is None:
            return []
        dead_chunks: list[FileChunk] = []
        if e.is_directory:
            # list_entries pages past TTL-expired entries internally,
            # so one live result == genuinely non-empty
            if not recursive and self.list_entries(path, limit=1):
                raise DirectoryNotEmptyError(
                    f"directory not empty: {path}")
            for sub in self.iter_tree(path):
                if not sub.is_directory:
                    if sub.hard_link_id:
                        dead_chunks.extend(self._hardlink_unref(sub))
                    else:
                        dead_chunks.extend(sub.chunks)
                d, _ = sub.dir_and_name
                self.meta_log.append(d, sub, None, signatures)
            self.store.delete_folder_children(path)
        elif e.hard_link_id:
            dead_chunks.extend(self._hardlink_unref(e))
        else:
            dead_chunks.extend(e.chunks)
        self.store.delete_entry(path)
        if e.is_directory:
            self._invalidate_dir(path)
        d, _ = e.dir_and_name
        self.meta_log.append(d, e, None, signatures)
        return dead_chunks

    def rename(self, old_path: str, new_path: str,
               signatures: list[int] | None = None) -> None:
        """Move an entry (recursively for directories) — the metadata-
        only streaming rename of filer_grpc_server_rename.go; chunks
        stay where they are."""
        old_path, new_path = norm_path(old_path), norm_path(new_path)
        if new_path == old_path or \
                new_path.startswith(old_path.rstrip("/") + "/"):
            # moving a directory into its own subtree would copy the
            # children under the new name and then delete_folder_children
            # the old tree — INCLUDING the copies (the reference filer
            # rejects this too)
            raise ValueError(
                f"cannot move {old_path} into itself ({new_path})")
        with self._mutation_lock:
            e = self.find_entry(old_path)
            if e is None:
                raise FileNotFoundError(old_path)
            if self.find_entry(new_path) is not None:
                raise FileExistsError(new_path)
            self._move(e, new_path, signatures)
        self._drain_freed()

    def _move(self, e: Entry, new_path: str,
              signatures: list[int] | None) -> None:
        old_path = e.full_path
        children = []
        if e.is_directory:
            children = list(self.iter_tree(old_path))
        moved = Entry.from_dict(e.to_dict())
        moved.full_path = new_path
        self.create_entry(moved, signatures)
        for sub in children:
            rel = sub.full_path[len(old_path):]
            sub_new = Entry.from_dict(sub.to_dict())
            sub_new.full_path = new_path + rel
            self.create_entry(sub_new, signatures)
        # delete old names only (not data)
        if e.is_directory:
            for sub in children:
                d, _ = sub.dir_and_name
                self.meta_log.append(d, sub, None, signatures)
            self.store.delete_folder_children(old_path)
            self._invalidate_dir(old_path)
        self.store.delete_entry(old_path)
        d, _ = e.dir_and_name
        self.meta_log.append(d, e, None, signatures)

    def close(self) -> None:
        self.store.close()
