"""Shared SQL filer-store layer + mysql/postgres adapters.

Equivalent of SeaweedFS weed/filer/abstract_sql/ (the 472-LoC
abstract_sql_store.go shared by the mysql/postgres/sqlite plugins):
one table keyed (dir, name) holding encoded entry blobs, plus a KV
table, with the dialect differences (parameter placeholders, upsert
syntax, LIKE escaping) isolated in a small Dialect object.

The sqlite store in filerstore.py predates this layer and stays
self-contained; mysql and postgres register here over the in-tree
wire clients (mysql_lite.py / pg_lite.py) — no external drivers, the
same zero-SDK approach as the redis/etcd/mongodb/cassandra stores.

The port's copy of seaweedfs_tpu/filer/abstract_sql.py: the same files, keys,
rows and request bytes, over the standard library only.
"""
from __future__ import annotations

import hashlib
import json
import threading
from dataclasses import dataclass

from .entry import Entry
from .filerstore import FilerStore, _like_escape, _norm, _split, \
    register_store


def dir_hash(directory: str) -> int:
    """First 64 bits of MD5(dir) as a signed big-endian int64 — the
    reference's util.HashStringToLong (util/bytes.go:77), which keys
    the filemeta primary index. The full directory still rides every
    WHERE clause, so a 64-bit collision can't cross-read; the PK
    (dirhash, name) keeps index keys inside InnoDB's 3072-byte limit
    (8 + 766*4 with utf8mb4 = exactly 3072, hence VARCHAR(766))."""
    v = int.from_bytes(hashlib.md5(directory.encode()).digest()[:8],
                       "big")
    return v - (1 << 64) if v >= (1 << 63) else v


@dataclass
class Dialect:
    placeholder: str               # "?" or "%s"
    upsert_meta: str               # full upsert statement for filemeta
    upsert_kv: str                 # full upsert statement for kv
    create_meta: str
    create_kv: str
    like_escape_clause: str = r" ESCAPE '\'"
    quote: str = "`"  # identifier quote (backtick mysql, " postgres)


MYSQL_DIALECT = Dialect(
    # schema mirrors the reference's scaffold (filer.toml [mysql],
    # mysql/mysql_sql_gen.go:24-49)
    placeholder="%s",
    create_meta="""CREATE TABLE IF NOT EXISTS {table}(
        dirhash BIGINT NOT NULL, name VARCHAR(766) NOT NULL,
        directory TEXT NOT NULL, meta LONGBLOB,
        PRIMARY KEY(dirhash, name))
        DEFAULT CHARSET=utf8mb4 COLLATE=utf8mb4_bin""",
    create_kv="""CREATE TABLE IF NOT EXISTS kv(
        k VARCHAR(766) PRIMARY KEY, v LONGBLOB NOT NULL)
        DEFAULT CHARSET=utf8mb4 COLLATE=utf8mb4_bin""",
    upsert_meta="""INSERT INTO {table}(dirhash,name,directory,meta)
        VALUES(%s,%s,%s,%s)
        ON DUPLICATE KEY UPDATE meta=VALUES(meta)""",
    upsert_kv="""INSERT INTO kv(k,v) VALUES(%s,%s)
        ON DUPLICATE KEY UPDATE v=VALUES(v)""",
    like_escape_clause=" ESCAPE '\\\\'",
)

POSTGRES_DIALECT = Dialect(
    placeholder="%s",
    create_meta="""CREATE TABLE IF NOT EXISTS {table}(
        dirhash BIGINT NOT NULL, name TEXT NOT NULL,
        directory TEXT NOT NULL, meta BYTEA,
        PRIMARY KEY(dirhash, name))""",
    create_kv="""CREATE TABLE IF NOT EXISTS kv(
        k TEXT PRIMARY KEY, v BYTEA NOT NULL)""",
    upsert_meta="""INSERT INTO {table}(dirhash,name,directory,meta)
        VALUES(%s,%s,%s,%s)
        ON CONFLICT(dirhash,name) DO UPDATE SET meta=EXCLUDED.meta""",
    upsert_kv="""INSERT INTO kv(k,v) VALUES(%s,%s)
        ON CONFLICT(k) DO UPDATE SET v=EXCLUDED.v""",
    quote='"',
)


class AbstractSqlStore(FilerStore):
    """FilerStore over any DB-API 2.0 connection.

    Query shapes mirror the reference's generators
    (mysql/mysql_sql_gen.go:24-49): every filemeta statement keys on
    dirhash AND carries the full directory, so index keys stay short
    and hash collisions stay harmless.

    Transport failures reconnect once via `_connect` (long-lived
    sockets get idle-closed by the server — MySQL's wait_timeout —
    and a reconnect must not surface as a filer error); server-side
    SQL errors (`server_errors` classes) are never retried, the
    connection is still synced after them."""

    # exception types that mean "the server answered with an error" —
    # set by subclasses to their wire client's error class
    server_errors: tuple = ()

    BUCKETS_DIR = "/buckets"

    def __init__(self, conn, dialect: Dialect, bucket_tables: bool = False):
        self._conn = conn
        self._d = dialect
        self._lock = threading.RLock()
        # mysql2/postgres2 layout (mysql2_store.go:60,88): entries
        # under /buckets/<bucket>/ live in a per-bucket table, so
        # deleting a bucket is one DROP TABLE instead of a scan of
        # every row. Tables are created lazily on first touch (the
        # reference creates them on the bucket-creation event;
        # CREATE IF NOT EXISTS makes both orders correct) and cached.
        self._bucket_tables = bucket_tables
        self._known_tables: set[str] = set()
        self._exec(dialect.create_meta.format(table="filemeta"))
        self._exec(dialect.create_kv)
        self._known_tables.add("filemeta")

    def _table_for(self, directory: str, create: bool = False) -> str:
        """The quoted table holding entries of `directory`. Default
        layout: always filemeta. Bucket layout: /buckets/<b>/... maps
        to table bucket_<b> (the bucket DIR ENTRY itself lives in
        /buckets, i.e. the default table). Tables are created only on
        WRITE paths (create=True) — reads on never-written buckets
        must not run DDL (unauthenticated probes would grow the
        catalog unboundedly, and a read racing a bucket drop could
        resurrect the dropped table)."""
        if self._bucket_tables and \
                directory.startswith(self.BUCKETS_DIR + "/"):
            bucket = directory[len(self.BUCKETS_DIR) + 1:].split("/")[0]
            table = self._bucket_table(bucket)
            if create and table not in self._known_tables:
                self._exec(self._d.create_meta.format(table=table))
                self._known_tables.add(table)
            return table
        return "filemeta"

    _BUCKET_NAME_OK = frozenset(
        "abcdefghijklmnopqrstuvwxyz"
        "ABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789._-")

    def _bucket_table(self, bucket: str) -> str:
        # strict charset: the name lands inside a quoted SQL
        # identifier AND the drivers' printf-style parameter
        # substitution ('%' would shift every placeholder)
        if not bucket or any(c not in self._BUCKET_NAME_OK
                             for c in bucket):
            raise ValueError(f"invalid bucket name {bucket!r}")
        q = self._d.quote
        return f"{q}bucket_{bucket}{q}"

    def _read(self, table: str, sql: str, args: tuple) -> list:
        """Execute a read/point-delete against a possibly-nonexistent
        bucket table: a server error on a table THIS process never
        created reads as 'no such table' -> empty (the bucket was
        never written or was dropped); errors on known tables are
        real and re-raised."""
        try:
            return self._exec(sql, args)
        except self.server_errors:
            if table != "filemeta" and table not in self._known_tables:
                return []
            raise

    def _connect(self):
        """Build a replacement connection after a transport failure;
        subclasses with reconnect support override this."""
        raise NotImplementedError

    def _exec(self, sql: str, args: tuple = ()) -> list:
        with self._lock:
            try:
                return self._exec_locked(sql, args)
            except self.server_errors:
                raise  # SQL error on a healthy, synced connection
            except (IOError, OSError):
                try:
                    replacement = self._connect()
                except NotImplementedError:
                    raise
                try:
                    self._conn.close()
                except (IOError, OSError):
                    pass
                self._conn = replacement
                return self._exec_locked(sql, args)

    def _exec_locked(self, sql: str, args: tuple) -> list:
        cur = self._conn.cursor()
        cur.execute(sql, args)
        rows = cur.fetchall() if cur.description else []
        self._conn.commit()
        return rows

    def insert_entry(self, entry: Entry) -> None:
        d, n = entry.dir_and_name
        d = _norm(d)
        table = self._table_for(d, create=True)
        self._exec(self._d.upsert_meta.format(table=table),
                   (dir_hash(d), n, d,
                    json.dumps(entry.to_dict()).encode()))

    update_entry = insert_entry

    def find_entry(self, path: str) -> Entry | None:
        d, n = _split(path)
        if not n:
            return None
        ph = self._d.placeholder
        table = self._table_for(d)
        rows = self._read(
            table,
            f"SELECT meta FROM {table} WHERE dirhash={ph} "
            f"AND name={ph} AND directory={ph}", (dir_hash(d), n, d))
        return Entry.from_dict(json.loads(rows[0][0])) if rows else None

    def delete_entry(self, path: str) -> None:
        d, n = _split(path)
        ph = self._d.placeholder
        table = self._table_for(d)
        self._read(
            table,
            f"DELETE FROM {table} WHERE dirhash={ph} AND "
            f"name={ph} AND directory={ph}", (dir_hash(d), n, d))

    def delete_folder_children(self, path: str) -> None:
        path = _norm(path)
        if self._bucket_tables and \
                path.startswith(self.BUCKETS_DIR + "/"):
            rel = path[len(self.BUCKETS_DIR) + 1:]
            if "/" not in rel:
                # the whole bucket: one DROP TABLE reclaims everything
                # (mysql2_store.go:88 OnBucketDeletion) — the O(1)
                # delete this layout exists for
                table = self._bucket_table(rel)
                self._exec(f"DROP TABLE IF EXISTS {table}")
                self._known_tables.discard(table)
                return
        if self._bucket_tables and path in ("/", self.BUCKETS_DIR):
            # the subtree spans every bucket table: drop the ones this
            # process knows about (tables created by other processes
            # need their own bucket-level deletes, same multi-writer
            # caveat as the reference's event-driven table lifecycle)
            for table in list(self._known_tables - {"filemeta"}):
                self._exec(f"DROP TABLE IF EXISTS {table}")
                self._known_tables.discard(table)
        like = _like_escape(
            path if path.endswith("/") else path + "/") + "%"
        ph = self._d.placeholder
        # whole-subtree delete (the directory LIKE arm walks nested
        # dirs; the reference deletes one level and recurses in the
        # filer — same end state, fewer round trips here)
        table = self._table_for(path)
        self._read(
            table,
            f"DELETE FROM {table} WHERE directory={ph} "
            f"OR directory LIKE {ph}{self._d.like_escape_clause}",
            (path, like))

    def list_directory_entries(self, dirpath: str, start_from: str = "",
                               inclusive: bool = False,
                               limit: int = 1024,
                               prefix: str = "") -> list[Entry]:
        dirpath = _norm(dirpath)
        ph = self._d.placeholder
        cmp = ">=" if inclusive else ">"
        table = self._table_for(dirpath)
        q = (f"SELECT meta FROM {table} WHERE "
             f"dirhash={ph} AND directory={ph}")
        args: list = [dir_hash(dirpath), dirpath]
        if start_from:
            q += f" AND name {cmp} {ph}"
            args.append(start_from)
        if prefix:
            q += f" AND name LIKE {ph}{self._d.like_escape_clause}"
            args.append(_like_escape(prefix) + "%")
        q += f" ORDER BY name LIMIT {ph}"
        args.append(limit)
        rows = self._read(table, q, tuple(args))
        return [Entry.from_dict(json.loads(r[0])) for r in rows]

    def kv_put(self, key: str, value: bytes) -> None:
        self._exec(self._d.upsert_kv, (key, value))

    def kv_get(self, key: str) -> bytes | None:
        ph = self._d.placeholder
        rows = self._exec(f"SELECT v FROM kv WHERE k={ph}", (key,))
        return bytes(rows[0][0]) if rows else None

    def kv_delete(self, key: str) -> None:
        ph = self._d.placeholder
        self._exec(f"DELETE FROM kv WHERE k={ph}", (key,))

    def close(self) -> None:
        with self._lock:
            self._conn.close()


@register_store("mysql")
class MysqlStore(AbstractSqlStore):
    """weed/filer/mysql equivalent
    (SeaweedFS weed/filer/mysql/mysql_store.go:14). The driver
    is the in-tree wire client (mysql_lite.py: HandshakeV10 +
    mysql_native_password + COM_QUERY text protocol), so the mysql
    dialect is a first-class store, not SDK-gated."""

    bucket_tables = False

    def __init__(self, host: str = "127.0.0.1", port: int = 3306,
                 user: str = "root", password: str = "",
                 database: str = "seaweedfs", **_):
        from .mysql_lite import MysqlConnection, MysqlError

        self._args = (host, int(port), user, password, database)
        self.server_errors = (MysqlError,)
        super().__init__(self._connect(), MYSQL_DIALECT,
                         bucket_tables=self.bucket_tables)

    def _connect(self):
        from .mysql_lite import MysqlConnection

        host, port, user, password, database = self._args
        return MysqlConnection(host, port, user=user, password=password,
                               database=database)


@register_store("mysql2")
class Mysql2Store(MysqlStore):
    """weed/filer/mysql2 equivalent
    (SeaweedFS weed/filer/mysql2/mysql2_store.go:60,88): the
    same wire and schema, but entries under /buckets/<bucket>/ live in
    a table per bucket, so dropping a bucket is one DROP TABLE instead
    of a row scan."""

    bucket_tables = True


@register_store("postgres")
class PostgresStore(AbstractSqlStore):
    """weed/filer/postgres equivalent
    (SeaweedFS weed/filer/postgres/postgres_store.go:14). The
    driver is the in-tree wire client (pg_lite.py: StartupMessage,
    cleartext/md5 auth, simple Query protocol, bytea hex codec)."""

    bucket_tables = False

    def __init__(self, host: str = "127.0.0.1", port: int = 5432,
                 user: str = "postgres", password: str = "",
                 database: str = "seaweedfs", **_):
        from .pg_lite import PgError

        self._args = (host, int(port), user, password, database)
        self.server_errors = (PgError,)
        super().__init__(self._connect(), POSTGRES_DIALECT,
                         bucket_tables=self.bucket_tables)

    def _connect(self):
        from .pg_lite import PgConnection

        host, port, user, password, database = self._args
        return PgConnection(host, port, user=user, password=password,
                            database=database)


@register_store("postgres2")
class Postgres2Store(PostgresStore):
    """weed/filer/postgres2 equivalent
    (SeaweedFS weed/filer/postgres2/postgres2_store.go): the
    per-bucket-table layout over the postgres wire — bucket deletion
    is one DROP TABLE."""

    bucket_tables = True
