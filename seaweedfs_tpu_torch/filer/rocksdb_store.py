"""RocksDB filer store via the stable C API (ctypes on librocksdb).

The reference gates its rocksdb store behind a build tag + cgo
(SeaweedFS weed/filer/rocksdb/rocksdb_store.go:47, tag
`rocksdb`); the analogue here is runtime gating: when librocksdb.so is
on the loader path this store activates, otherwise constructing it
raises ImportError exactly like the reference binary built without the
tag. The always-available embedded-KV slot is weedkv.py — this
build's own LSM (memtable + SSTables + compaction), which the
leveldb/rocksdb rows redesign into one in-tree engine.

Key layout matches the etcd store (one lexicographic keyspace):
  E<dir>\\x00<name> -> entry JSON     K<key> -> kv side-channel
RocksDB iterators give the prefix scans listings need.

The port's copy of seaweedfs_tpu/filer/rocksdb_store.py: the same files, keys,
rows and request bytes, over the standard library only.
"""
from __future__ import annotations

import ctypes
import ctypes.util
import json

from .entry import Entry
from .filerstore import (FilerStore, _list_filter, _norm, _split,
                         register_store)

SEP = b"\x00"


def _load_librocksdb():
    name = ctypes.util.find_library("rocksdb")
    if not name:
        raise ImportError(
            "filer store 'rocksdb' needs librocksdb.so on this host "
            "(the reference gates the same store behind its `rocksdb` "
            "build tag); the always-available embedded store here is "
            "-store=leveldb (weedkv LSM)")
    lib = ctypes.CDLL(name)
    c = ctypes.c_char_p
    p = ctypes.POINTER(c)
    sz = ctypes.c_size_t
    szp = ctypes.POINTER(sz)
    v = ctypes.c_void_p
    sigs = {
        "rocksdb_options_create": ([], v),
        "rocksdb_options_set_create_if_missing": ([v, ctypes.c_ubyte],
                                                  None),
        "rocksdb_open": ([v, c, p], v),
        "rocksdb_close": ([v], None),
        "rocksdb_writeoptions_create": ([], v),
        "rocksdb_readoptions_create": ([], v),
        "rocksdb_put": ([v, v, c, sz, c, sz, p], None),
        "rocksdb_get": ([v, v, c, sz, szp, p], v),
        "rocksdb_delete": ([v, v, c, sz, p], None),
        "rocksdb_create_iterator": ([v, v], v),
        "rocksdb_iter_destroy": ([v], None),
        "rocksdb_iter_seek": ([v, c, sz], None),
        "rocksdb_iter_next": ([v], None),
        "rocksdb_iter_valid": ([v], ctypes.c_ubyte),
        "rocksdb_iter_key": ([v, szp], v),
        "rocksdb_iter_value": ([v, szp], v),
        "rocksdb_free": ([v], None),
    }
    for fname, (argtypes, restype) in sigs.items():
        fn = getattr(lib, fname)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


@register_store("rocksdb")
class RocksdbStore(FilerStore):
    """`-store=rocksdb -store.path=/data/filer.rdb` (needs
    librocksdb)."""

    def __init__(self, path: str = "filer.rdb", **_):
        self.lib = _load_librocksdb()
        opts = self.lib.rocksdb_options_create()
        self.lib.rocksdb_options_set_create_if_missing(opts, 1)
        err = ctypes.c_char_p()
        self.db = self.lib.rocksdb_open(opts, path.encode(),
                                        ctypes.byref(err))
        if err.value:
            raise IOError(f"rocksdb open {path}: "
                          f"{err.value.decode('utf-8', 'replace')}")
        self.wo = self.lib.rocksdb_writeoptions_create()
        self.ro = self.lib.rocksdb_readoptions_create()

    # -- raw kv ---------------------------------------------------------
    def _check(self, err: ctypes.c_char_p, op: str) -> None:
        if err.value:
            msg = err.value.decode("utf-8", "replace")
            self.lib.rocksdb_free(
                ctypes.cast(err, ctypes.c_void_p))
            raise IOError(f"rocksdb {op}: {msg}")

    def _put(self, key: bytes, value: bytes) -> None:
        err = ctypes.c_char_p()
        self.lib.rocksdb_put(self.db, self.wo, key, len(key),
                             value, len(value), ctypes.byref(err))
        self._check(err, "put")

    def _get(self, key: bytes) -> bytes | None:
        err = ctypes.c_char_p()
        vlen = ctypes.c_size_t()
        ptr = self.lib.rocksdb_get(self.db, self.ro, key, len(key),
                                   ctypes.byref(vlen),
                                   ctypes.byref(err))
        self._check(err, "get")
        if not ptr:
            return None
        out = ctypes.string_at(ptr, vlen.value)
        self.lib.rocksdb_free(ptr)
        return out

    def _delete(self, key: bytes) -> None:
        err = ctypes.c_char_p()
        self.lib.rocksdb_delete(self.db, self.wo, key, len(key),
                                ctypes.byref(err))
        self._check(err, "delete")

    def _scan(self, prefix: bytes, start: bytes):
        """Yield (key, value) for keys >= start with `prefix`."""
        it = self.lib.rocksdb_create_iterator(self.db, self.ro)
        try:
            self.lib.rocksdb_iter_seek(it, start, len(start))
            while self.lib.rocksdb_iter_valid(it):
                klen = ctypes.c_size_t()
                kptr = self.lib.rocksdb_iter_key(it,
                                                 ctypes.byref(klen))
                key = ctypes.string_at(kptr, klen.value)
                if not key.startswith(prefix):
                    return
                vlen = ctypes.c_size_t()
                vptr = self.lib.rocksdb_iter_value(
                    it, ctypes.byref(vlen))
                yield key, ctypes.string_at(vptr, vlen.value)
                self.lib.rocksdb_iter_next(it)
        finally:
            self.lib.rocksdb_iter_destroy(it)

    # -- entries --------------------------------------------------------
    @staticmethod
    def _entry_key(dirpath: str, name: str) -> bytes:
        return b"E" + _norm(dirpath).encode() + SEP + name.encode()

    def insert_entry(self, entry: Entry) -> None:
        d, n = entry.dir_and_name
        self._put(self._entry_key(d, n),
                  json.dumps(entry.to_dict()).encode())

    update_entry = insert_entry

    def find_entry(self, path: str) -> Entry | None:
        d, n = _split(path)
        if not n:
            return None
        raw = self._get(self._entry_key(d, n))
        if raw is None:
            return None
        return Entry.from_dict(json.loads(raw))

    def delete_entry(self, path: str) -> None:
        d, n = _split(path)
        if n:
            self._delete(self._entry_key(d, n))

    def delete_folder_children(self, path: str) -> None:
        norm = _norm(path)
        prefixes = [b"E/"] if norm == "/" else [
            b"E" + norm.encode() + SEP,  # direct children
            b"E" + norm.encode() + b"/",  # nested directories
        ]
        for pfx in prefixes:
            doomed = [k for k, _ in self._scan(pfx, pfx)]
            for k in doomed:
                self._delete(k)

    def list_directory_entries(self, dirpath: str, start_from: str = "",
                               inclusive: bool = False,
                               limit: int = 1024,
                               prefix: str = "") -> list[Entry]:
        dirpath = _norm(dirpath)
        base = b"E" + dirpath.encode() + SEP
        first = prefix or start_from or ""
        if prefix and start_from and start_from > prefix:
            first = start_from
        out: list[Entry] = []
        for key, val in self._scan(base, base + first.encode()):
            name = key[len(base):].decode("utf-8", "replace")
            verdict = _list_filter(name, prefix, start_from, inclusive)
            if verdict == "stop":
                break
            if verdict == "skip":
                continue
            out.append(Entry.from_dict(json.loads(val)))
            if len(out) >= limit:
                break
        return out

    # -- kv side-channel ------------------------------------------------
    def kv_put(self, key: str, value: bytes) -> None:
        self._put(b"K" + key.encode(), value)

    def kv_get(self, key: str) -> bytes | None:
        return self._get(b"K" + key.encode())

    def kv_delete(self, key: str) -> None:
        self._delete(b"K" + key.encode())

    def close(self) -> None:
        if getattr(self, "db", None):
            self.lib.rocksdb_close(self.db)
            self.db = None
