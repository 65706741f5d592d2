"""Cassandra filer store speaking the native CQL v4 wire protocol.

The slot of SeaweedFS weed/filer/cassandra/cassandra_store.go:23
(and its kv side, cassandra_store_kv.go), with the client written
in-tree (filer/cql_lite.py) instead of gocql — the fourth
fully-implemented external wire protocol after redis RESP, the etcd v3
gateway, and MongoDB OP_MSG.

Schema (cassandra/README.txt):
    CREATE TABLE filemeta (
        directory varchar, name varchar, meta blob,
        PRIMARY KEY (directory, name)
    ) WITH CLUSTERING ORDER BY (name ASC);

Entries are one row per (directory, name) with the entry JSON in
`meta`; listing is the clustering-ordered name range scan the
reference uses (SELECT ... WHERE directory=? AND name>? LIMIT ?).
TTL rides cassandra's row TTL (INSERT ... USING TTL ?). The KV
side-channel packs keys into (directory, name) by base64-splitting at
8 bytes exactly like genDirAndName (cassandra_store_kv.go:53-60).
Prefix listing is not supported natively by the reference
(ErrUnsupportedListDirectoryPrefixed) — here it pages the plain range
scan and filters, which keeps the wrapper behavior without the
unsupported error.

The port's copy of seaweedfs_tpu/filer/cassandra_store.py: the same files, keys,
rows and request bytes, over the standard library only.
"""
from __future__ import annotations

import base64
import json
import threading

from .cql_lite import CqlClient, CqlError
from .entry import Entry
from .filerstore import (FilerStore, _delete_subtree_by_walk, _norm,
                         _split, register_store)


@register_store("cassandra")
class CassandraStore(FilerStore):
    """`-store=cassandra -store.host=... -store.port=9042
    -store.database=seaweedfs` (database = keyspace; optional
    -store.user/-store.password for PasswordAuthenticator)."""

    name = "cassandra"

    def __init__(self, host: str = "127.0.0.1", port: int = 9042,
                 database: str = "seaweedfs", user: str = "",
                 username: str = "", password: str = "", **_):
        username = user or username
        self._conn_args = (host, int(port), username, password, database)
        self._cql = CqlClient(host, int(port), username=username,
                              password=password, keyspace=database)
        self._lock = threading.Lock()  # one socket, serialized requests
        # prepared statements (gocql prepares transparently; the wire
        # client does it explicitly once per connection)
        self._prep: dict[str, bytes] = {}

    # -- plumbing -------------------------------------------------------
    def _reconnect(self) -> None:
        host, port, username, password, database = self._conn_args
        self._cql.close()
        self._cql = CqlClient(host, port, username=username,
                              password=password, keyspace=database)
        self._prep.clear()

    UNPREPARED = 0x2500

    def _exec(self, cql: str, values: tuple):
        """Prepared execute with a one-shot reconnect on transport
        failure. A CqlError is a server answer on a healthy, synced
        connection and is never retried — except UNPREPARED: the
        server evicts prepared-statement cache entries under memory
        pressure, and the contract (gocql does the same) is to
        re-prepare and re-execute."""
        with self._lock:
            try:
                return self._exec_locked(cql, values)
            except CqlError as e:
                if e.code != self.UNPREPARED:
                    raise
                self._prep.pop(cql, None)
                return self._exec_locked(cql, values)
            except (IOError, OSError):
                self._reconnect()
                return self._exec_locked(cql, values)

    def _exec_locked(self, cql: str, values: tuple):
        stmt = self._prep.get(cql)
        if stmt is None:
            stmt = self._cql.prepare(cql)
            self._prep[cql] = stmt
        return self._cql.execute(stmt, values)

    # -- entries --------------------------------------------------------
    def insert_entry(self, entry: Entry) -> None:
        d, n = entry.dir_and_name
        meta = json.dumps(entry.to_dict()).encode()
        # row TTL carries the entry TTL exactly like the reference
        # (InsertEntry USING TTL ?, cassandra_store.go:108-112)
        self._exec(
            "INSERT INTO filemeta (directory,name,meta) "
            "VALUES (?,?,?) USING TTL ?",
            (_norm(d), n, meta, max(0, int(entry.ttl_sec))))

    update_entry = insert_entry

    def find_entry(self, path: str) -> Entry | None:
        d, n = _split(path)
        if not n:
            return None
        rows = self._exec(
            "SELECT meta FROM filemeta WHERE directory=? AND name=?",
            (_norm(d), n))
        if not rows or rows[0][0] is None:
            return None
        return Entry.from_dict(json.loads(rows[0][0]))

    def delete_entry(self, path: str) -> None:
        d, n = _split(path)
        if not n:
            return
        self._exec(
            "DELETE FROM filemeta WHERE directory=? AND name=?",
            (_norm(d), n))

    def delete_folder_children(self, path: str) -> None:
        """Whole-subtree delete. Directories are partitions, so there
        is no single range statement — this walks child directories
        (entries flagged is_directory) and drops partitions bottom-up.
        The reference deletes only the top partition
        (cassandra_store.go:173-183) and leaves grandchildren to gocql
        users' recursive delete; the filer contract in this tree is
        subtree semantics, matching every other store here."""
        _delete_subtree_by_walk(self, path)

    def delete_directory_range(self, d: str) -> None:
        self._exec("DELETE FROM filemeta WHERE directory=?", (d,))

    def list_directory_entries(self, dirpath: str, start_from: str = "",
                               inclusive: bool = False,
                               limit: int = 1024,
                               prefix: str = "") -> list[Entry]:
        dirpath = _norm(dirpath)
        out: list[Entry] = []
        cursor = start_from
        first = True
        while len(out) < limit:
            op = ">=" if (inclusive and first and cursor) else ">"
            batch = self._exec(
                "SELECT name, meta FROM filemeta WHERE directory=? "
                f"AND name{op}? LIMIT ?",
                (dirpath, cursor, limit + 1))
            if not batch:
                break
            first = False
            for name_b, meta_b in batch:
                name = (name_b or b"").decode()
                cursor = name
                if prefix and not name.startswith(prefix):
                    if prefix and name > prefix + "\xff":
                        return out  # past the prefix range: done
                    continue
                if meta_b is None:
                    continue
                out.append(Entry.from_dict(json.loads(meta_b)))
                if len(out) >= limit:
                    return out
            if len(batch) <= limit:
                break  # exhausted the partition
        return out

    # -- kv side-channel (cassandra_store_kv.go) ------------------------
    @staticmethod
    def _kv_dir_name(key: str) -> tuple[str, str]:
        raw = key.encode()
        while len(raw) < 8:
            raw += b"\x00"
        return (base64.b64encode(raw[:8]).decode(),
                base64.b64encode(raw[8:]).decode())

    def kv_put(self, key: str, value: bytes) -> None:
        d, n = self._kv_dir_name(key)
        self._exec(
            "INSERT INTO filemeta (directory,name,meta) "
            "VALUES (?,?,?) USING TTL ?", (d, n, value, 0))

    def kv_get(self, key: str) -> bytes | None:
        d, n = self._kv_dir_name(key)
        rows = self._exec(
            "SELECT meta FROM filemeta WHERE directory=? AND name=?",
            (d, n))
        return rows[0][0] if rows else None

    def kv_delete(self, key: str) -> None:
        d, n = self._kv_dir_name(key)
        self._exec(
            "DELETE FROM filemeta WHERE directory=? AND name=?", (d, n))

    def close(self) -> None:
        self._cql.close()
