"""Pluggable filer metadata stores; the counterpart of
seaweedfs_tpu/filer/filerstore.py with its two embedded stores.

Equivalent of SeaweedFS weed/filer/filerstore.go:21-44 (`FilerStore`
interface) and its registration pattern — concrete stores register
themselves in `STORES` by type string, like the reference's `init()` ->
`filer.Stores`.

- `memory`: dict-backed, for tests and ephemeral filers.
- `sqlite`: stdlib sqlite3, the durable single-file embedded store
  (weed/filer/sqlite/), the reference CLI's default.

Not here: the weedkv `leveldb` engine, the sharded and caching
wrappers and the network engines (redis, mysql, ...); `make_store`
names the two it has.
"""
from __future__ import annotations

import json
import sqlite3
import threading
from typing import Callable

from .entry import Entry


class FilerStore:
    """Interface every metadata store implements. Paths are passed as
    (dir, name); list order is by name ascending."""

    name = "abstract"

    def insert_entry(self, entry: Entry) -> None:
        raise NotImplementedError

    def insert_entry_encoded(self, entry: Entry, entry_dict: dict) -> None:
        """Insert with the caller's already-built entry.to_dict() —
        the filer builds that dict once per mutation for the event log
        and serializing stores reuse it instead of re-walking the
        entry (a measured slice of the S3 applier's per-op budget).
        Default: ignore the dict. NOTE the filer's hot path calls
        THIS method, so a store that overrides it (weedkv, sqlite)
        must treat it as the primitive — overriding only insert_entry
        on such a subclass would be bypassed."""
        self.insert_entry(entry)

    def update_entry(self, entry: Entry) -> None:
        raise NotImplementedError

    def find_entry(self, path: str) -> Entry | None:
        raise NotImplementedError

    def delete_entry(self, path: str) -> None:
        raise NotImplementedError

    def delete_folder_children(self, path: str) -> None:
        raise NotImplementedError

    def list_directory_entries(self, dirpath: str, start_from: str = "",
                               inclusive: bool = False,
                               limit: int = 1024,
                               prefix: str = "") -> list[Entry]:
        raise NotImplementedError

    # generic KV side-channel (weed/filer/filerstore.go KvPut/KvGet)
    def kv_put(self, key: str, value: bytes) -> None:
        raise NotImplementedError

    def kv_get(self, key: str) -> bytes | None:
        raise NotImplementedError

    def kv_delete(self, key: str) -> None:
        raise NotImplementedError

    # group-commit window (BeginTransaction/CommitTransaction in
    # filerstore.go, reduced to its durability essence): between begin
    # and end the store may defer per-write log flushing; end_batch
    # makes everything since begin durable. Bulk ingest (the native S3
    # applier) wraps each record batch so N inserts pay ONE flush.
    # Default: no-op (stores that flush per write are already durable).
    def begin_batch(self) -> None:
        pass

    def end_batch(self) -> None:
        pass

    def close(self) -> None:
        pass


STORES: dict[str, Callable[..., FilerStore]] = {}


def register_store(name: str):
    def deco(cls):
        cls.name = name
        STORES[name] = cls
        return cls
    return deco


def make_store(kind: str, **kwargs) -> FilerStore:
    if kind not in STORES:
        raise KeyError(f"unknown filer store {kind!r}; "
                       f"have {sorted(STORES)}")
    return STORES[kind](**kwargs)


def _norm(path: str) -> str:
    path = "/" + path.strip("/")
    return path


def _like_escape(s: str) -> str:
    """Escape LIKE wildcards so paths match literally (pair with
    ESCAPE '\\' — sqlite treats backslash as plain text otherwise)."""
    return s.replace("\\", r"\\").replace("%", r"\%").replace("_", r"\_")


def _split(path: str) -> tuple[str, str]:
    path = _norm(path)
    if path == "/":
        return "", ""
    d, _, n = path.rpartition("/")
    return (d or "/", n)


@register_store("memory")
class MemoryStore(FilerStore):
    def __init__(self, **_):
        self._lock = threading.RLock()
        # dir -> {name -> Entry}
        self._dirs: dict[str, dict[str, Entry]] = {}
        self._kv: dict[str, bytes] = {}

    def insert_entry(self, entry: Entry) -> None:
        d, n = entry.dir_and_name
        with self._lock:
            self._dirs.setdefault(d, {})[n] = entry

    update_entry = insert_entry

    def find_entry(self, path: str) -> Entry | None:
        d, n = _split(path)
        if not n:
            return None
        with self._lock:
            return self._dirs.get(d, {}).get(n)

    def delete_entry(self, path: str) -> None:
        d, n = _split(path)
        with self._lock:
            self._dirs.get(d, {}).pop(n, None)

    def delete_folder_children(self, path: str) -> None:
        path = _norm(path)
        with self._lock:
            prefix = path if path.endswith("/") else path + "/"
            for d in [d for d in self._dirs
                      if d == path or d.startswith(prefix)]:
                del self._dirs[d]

    def list_directory_entries(self, dirpath: str, start_from: str = "",
                               inclusive: bool = False,
                               limit: int = 1024,
                               prefix: str = "") -> list[Entry]:
        dirpath = _norm(dirpath)
        with self._lock:
            names = sorted(self._dirs.get(dirpath, {}))
            out = []
            for n in names:
                if prefix and not n.startswith(prefix):
                    continue
                if start_from:
                    if n < start_from or (n == start_from and not inclusive):
                        continue
                out.append(self._dirs[dirpath][n])
                if len(out) >= limit:
                    break
            return out

    def kv_put(self, key: str, value: bytes) -> None:
        with self._lock:
            self._kv[key] = value

    def kv_get(self, key: str) -> bytes | None:
        with self._lock:
            return self._kv.get(key)

    def kv_delete(self, key: str) -> None:
        with self._lock:
            self._kv.pop(key, None)


@register_store("sqlite")
class SqliteStore(FilerStore):
    """Durable embedded store: one table keyed (dir, name), JSON entry
    blobs — the same layout idea as the reference's abstract_sql store
    (weed/filer/abstract_sql/abstract_sql_store.go)."""

    def __init__(self, path: str = ":memory:", **_):
        self._conn = sqlite3.connect(path, check_same_thread=False)
        self._lock = threading.RLock()
        with self._lock:
            self._conn.executescript("""
                CREATE TABLE IF NOT EXISTS filemeta(
                    dir TEXT NOT NULL, name TEXT NOT NULL,
                    meta TEXT NOT NULL, PRIMARY KEY(dir, name));
                CREATE TABLE IF NOT EXISTS kv(
                    k TEXT PRIMARY KEY, v BLOB NOT NULL);
            """)
            self._conn.commit()

    def insert_entry(self, entry: Entry) -> None:
        self.insert_entry_encoded(entry, entry.to_dict())

    def insert_entry_encoded(self, entry: Entry, entry_dict: dict) -> None:
        d, n = entry.dir_and_name
        with self._lock:
            self._conn.execute(
                "INSERT OR REPLACE INTO filemeta(dir,name,meta) "
                "VALUES(?,?,?)", (d, n, json.dumps(entry_dict)))
            self._conn.commit()

    update_entry = insert_entry

    def find_entry(self, path: str) -> Entry | None:
        d, n = _split(path)
        if not n:
            return None
        with self._lock:
            row = self._conn.execute(
                "SELECT meta FROM filemeta WHERE dir=? AND name=?",
                (d, n)).fetchone()
        return Entry.from_dict(json.loads(row[0])) if row else None

    def delete_entry(self, path: str) -> None:
        d, n = _split(path)
        with self._lock:
            self._conn.execute(
                "DELETE FROM filemeta WHERE dir=? AND name=?", (d, n))
            self._conn.commit()

    def delete_folder_children(self, path: str) -> None:
        path = _norm(path)
        like = _like_escape(
            path if path.endswith("/") else path + "/") + "%"
        with self._lock:
            self._conn.execute(
                "DELETE FROM filemeta WHERE dir=? "
                r"OR dir LIKE ? ESCAPE '\'", (path, like))
            self._conn.commit()

    def list_directory_entries(self, dirpath: str, start_from: str = "",
                               inclusive: bool = False,
                               limit: int = 1024,
                               prefix: str = "") -> list[Entry]:
        dirpath = _norm(dirpath)
        cmp = ">=" if inclusive else ">"
        q = "SELECT meta FROM filemeta WHERE dir=?"
        args: list = [dirpath]
        if start_from:
            q += f" AND name {cmp} ?"
            args.append(start_from)
        if prefix:
            q += r" AND name LIKE ? ESCAPE '\'"
            args.append(_like_escape(prefix) + "%")
        q += " ORDER BY name LIMIT ?"
        args.append(limit)
        with self._lock:
            rows = self._conn.execute(q, args).fetchall()
        return [Entry.from_dict(json.loads(r[0])) for r in rows]

    def kv_put(self, key: str, value: bytes) -> None:
        with self._lock:
            self._conn.execute(
                "INSERT OR REPLACE INTO kv(k,v) VALUES(?,?)", (key, value))
            self._conn.commit()

    def kv_get(self, key: str) -> bytes | None:
        with self._lock:
            row = self._conn.execute(
                "SELECT v FROM kv WHERE k=?", (key,)).fetchone()
        return bytes(row[0]) if row else None

    def kv_delete(self, key: str) -> None:
        with self._lock:
            self._conn.execute("DELETE FROM kv WHERE k=?", (key,))
            self._conn.commit()

    def close(self) -> None:
        with self._lock:
            self._conn.close()
