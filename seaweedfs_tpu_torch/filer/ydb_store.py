"""YDB filer store over the Table service gRPC API (grpc_lite).

The reference's store (SeaweedFS weed/filer/ydb/ydb_store.go,
itself gated behind `//go:build ydb` — NOT in default reference
builds) rides ydb-go-sdk with the YQL statements in ydb_queries.go;
this build speaks Ydb.Table.V1.TableService directly through the
in-tree gRPC client with the same (dir_hash, name, directory, meta)
schema the abstract_sql family uses, and the same YQL shapes as the
reference's queries (DECLARE'd parameters, UPSERT/DELETE/SELECT,
`name LIKE` prefix windows).

Message encoding follows the public ydb-api-protos surface
(ydb_operation.proto, ydb_table.proto, ydb_value.proto) via the
generic protobuf helpers; the in-repo mini-ydb double (a real
grpc-core server) validates the full round trip. Until a live YDB run
is recorded, treat the field numbering as double-validated — the
reference's own build never ships this store either.

`-store=ydb -store.host=... -store.port=2136 -store.database=/local`

The port's copy of seaweedfs_tpu/filer/ydb_store.py: the same tables,
rows and YQL, over the standard library only.
"""
from __future__ import annotations

import json

from ..utils import grpc_lite as g
from .abstract_sql import dir_hash
from .entry import Entry
from .filerstore import (FilerStore, _delete_subtree_by_walk,
                         _like_escape, _norm, _split, register_store)

SVC = "/Ydb.Table.V1.TableService"
STATUS_SUCCESS = 400000   # Ydb.StatusIds.SUCCESS
STATUS_BAD_SESSION = 400100
# real YDB caps an ExecuteDataQuery result set at 1000 rows
# (truncated=true past that); page below the cap and LOOP on the flag
RESULT_SET_CAP = 1000

# Ydb.Type.PrimitiveTypeId
T_INT64 = 3
T_UINT64 = 4
T_STRING = 0x1001  # bytes
T_UTF8 = 0x1200    # text


def _typed(type_id: int, value_field: int, raw) -> bytes:
    """TypedValue{type{type_id}, value{<field>: raw}} bytes."""
    t = g.pb_uint(1, type_id)
    if value_field in (8, 9):  # bytes_value / text_value
        v = g.pb_bytes(value_field,
                       raw if isinstance(raw, bytes) else raw.encode())
    else:
        v = g.pb_tag(value_field, 0) + g.pb_varint(raw)
    return g.pb_bytes(1, t) + g.pb_bytes(2, v)


def p_int64(v: int) -> bytes:
    return _typed(T_INT64, 4, v)


def p_uint64(v: int) -> bytes:
    return _typed(T_UINT64, 5, v)


def p_utf8(s: str) -> bytes:
    return _typed(T_UTF8, 9, s)


def p_string(b: bytes) -> bytes:
    return _typed(T_STRING, 8, b)


UPSERT = """DECLARE $dir_hash AS Int64; DECLARE $directory AS Utf8;
DECLARE $name AS Utf8; DECLARE $meta AS String;
UPSERT INTO filemeta (dir_hash, name, directory, meta)
VALUES ($dir_hash, $name, $directory, $meta);"""

DELETE = """DECLARE $dir_hash AS Int64; DECLARE $name AS Utf8;
DELETE FROM filemeta WHERE dir_hash = $dir_hash AND name = $name;"""

FIND = """DECLARE $dir_hash AS Int64; DECLARE $name AS Utf8;
SELECT meta FROM filemeta
WHERE dir_hash = $dir_hash AND name = $name;"""

DELETE_CHILDREN = """DECLARE $dir_hash AS Int64;
DECLARE $directory AS Utf8;
DELETE FROM filemeta
WHERE dir_hash = $dir_hash AND directory = $directory;"""

LIST = """DECLARE $dir_hash AS Int64; DECLARE $directory AS Utf8;
DECLARE $start_name AS Utf8; DECLARE $prefix AS Utf8;
DECLARE $limit AS Uint64;
SELECT name, meta FROM filemeta
WHERE dir_hash = $dir_hash AND directory = $directory
AND name {op} $start_name AND name LIKE $prefix ESCAPE '\\\\'
ORDER BY name ASC LIMIT $limit;"""

KV_UPSERT = """DECLARE $k AS Utf8; DECLARE $v AS String;
UPSERT INTO kv (k, v) VALUES ($k, $v);"""

KV_GET = """DECLARE $k AS Utf8;
SELECT v FROM kv WHERE k = $k;"""

KV_DELETE = """DECLARE $k AS Utf8;
DELETE FROM kv WHERE k = $k;"""

SCHEME = ("CREATE TABLE IF NOT EXISTS filemeta (dir_hash Int64, "
          "name Utf8, directory Utf8, meta String, "
          "PRIMARY KEY (dir_hash, name));\n"
          "CREATE TABLE IF NOT EXISTS kv (k Utf8, v String, "
          "PRIMARY KEY (k));")


class YdbError(IOError):
    pass


class _Ydb:
    """The TableService subset the store needs: one session, YQL
    data/scheme queries in auto-commit serializable transactions."""

    def __init__(self, host: str, port: int, database: str,
                 token: str = ""):
        self.ch = g.GrpcChannel(host, port)
        self.meta = [("x-ydb-database", database)]
        if token:
            self.meta.append(("x-ydb-auth-ticket", token))
        self.database = database
        self.session = ""

    def _call(self, method: str, req: bytes) -> dict[int, list]:
        """-> the decoded result message from Operation.result (Any)."""
        raw = self.ch.unary(f"{SVC}/{method}", req, metadata=self.meta)
        resp = g.pb_decode(raw)
        op_raw = g.pb_first(resp, 1)
        if op_raw is None:
            raise YdbError(f"ydb {method}: response without operation")
        op = g.pb_decode(bytes(op_raw))
        status = g.pb_first(op, 3, 0)
        if status != STATUS_SUCCESS:
            issues = op.get(4, [])
            raise YdbError(f"ydb {method}: status {status} "
                           f"({len(issues)} issues)")
        any_raw = g.pb_first(op, 5)
        if any_raw is None:
            return {}
        any_msg = g.pb_decode(bytes(any_raw))
        return g.pb_decode(bytes(g.pb_first(any_msg, 2, b"")))

    def ensure_session(self) -> str:
        if not self.session:
            result = self._call("CreateSession", b"")
            sid = g.pb_first(result, 1)
            if not sid:
                raise YdbError("ydb: CreateSession returned no id")
            self.session = bytes(sid).decode()
        return self.session

    def _with_session(self, method: str, build) -> dict[int, list]:
        """Run `build(session_id) -> request bytes` with one retry on
        BAD_SESSION / transport failure — an idle-expired or node-lost
        session must recover with a fresh CreateSession, never poison
        the store until restart (the family convention: abstract_sql
        and cassandra reconnect the same way)."""
        for attempt in (0, 1):
            try:
                return self._call(method, build(self.ensure_session()))
            except YdbError as e:
                if attempt == 0 and str(STATUS_BAD_SESSION) in str(e):
                    self.session = ""
                    continue
                raise
            except (OSError, IOError):
                if attempt == 0:
                    self.session = ""  # channel redials on next call
                    continue
                raise

    def scheme(self, yql: str) -> None:
        # ExecuteSchemeQueryRequest {session_id=1, yql_text=2}
        self._with_session(
            "ExecuteSchemeQuery",
            lambda sid: g.pb_str(1, sid) + g.pb_str(2, yql))

    def execute(self, yql: str, params: dict[str, bytes]
                ) -> tuple[list[list[dict]], bool]:
        """-> (rows of the FIRST result set — each row a list of
        decoded Ydb.Value field maps — and the ResultSet.truncated
        flag). Auto-commit serializable tx, like the reference's
        table.DefaultTxControl."""
        def build(sid: str) -> bytes:
            # TransactionControl {begin_tx=2
            # {serializable_read_write=1 {}}, commit_tx=10}
            txc = g.pb_bytes(2, g.pb_bytes(1, b"")) + g.pb_bool(10, True)
            req = g.pb_str(1, sid)
            req += g.pb_bytes(2, txc)
            req += g.pb_bytes(3, g.pb_str(1, yql))  # Query{yql_text=1}
            for name, tv in params.items():
                entry = g.pb_str(1, name) + g.pb_bytes(2, tv)
                req += g.pb_bytes(4, entry)  # map<string, TypedValue>
            return req

        result = self._with_session("ExecuteDataQuery", build)
        sets = result.get(1, [])
        if not sets:
            return [], False
        rs = g.pb_decode(bytes(sets[0]))
        rows = []
        for row_raw in rs.get(2, []):  # ResultSet.rows
            row = g.pb_decode(bytes(row_raw))
            rows.append([g.pb_decode(bytes(item))
                         for item in row.get(12, [])])  # Value.items
        return rows, bool(g.pb_first(rs, 3, 0))  # truncated

    def close(self) -> None:
        self.ch.close()


def _cell_bytes(cell: dict[int, list]) -> bytes:
    """Ydb.Value scalar -> bytes (bytes_value=8 or text_value=9)."""
    v = g.pb_first(cell, 8)
    if v is None:
        v = g.pb_first(cell, 9, b"")
    return bytes(v)


@register_store("ydb")
class YdbStore(FilerStore):
    """`-store=ydb -store.host=... -store.port=2136
    -store.database=/local`."""

    def __init__(self, host: str = "127.0.0.1", port: int = 2136,
                 database: str = "/local", password: str = "", **_):
        self.db = _Ydb(host, int(port), database, token=password)
        self.db.scheme(SCHEME)

    # -- entries --------------------------------------------------------
    def insert_entry(self, entry: Entry) -> None:
        d, n = entry.dir_and_name
        self.db.execute(UPSERT, {
            "$dir_hash": p_int64(dir_hash(d)),
            "$directory": p_utf8(d),
            "$name": p_utf8(n),
            "$meta": p_string(json.dumps(entry.to_dict()).encode()),
        })

    update_entry = insert_entry

    def find_entry(self, path: str) -> Entry | None:
        d, n = _split(path)
        if not n:
            return None
        rows, _ = self.db.execute(FIND, {
            "$dir_hash": p_int64(dir_hash(d)),
            "$name": p_utf8(n),
        })
        if not rows:
            return None
        return Entry.from_dict(json.loads(_cell_bytes(rows[0][0])))

    def delete_entry(self, path: str) -> None:
        d, n = _split(path)
        if not n:
            return
        self.db.execute(DELETE, {
            "$dir_hash": p_int64(dir_hash(d)),
            "$name": p_utf8(n),
        })

    def delete_folder_children(self, path: str) -> None:
        # dirhash partitions scatter nested directories: recursive walk
        # via the shared helper, then one range delete per directory
        _delete_subtree_by_walk(self, path)

    def delete_directory_range(self, d: str) -> None:
        self.db.execute(DELETE_CHILDREN, {
            "$dir_hash": p_int64(dir_hash(d)),
            "$directory": p_utf8(d),
        })

    def list_directory_entries(self, dirpath: str, start_from: str = "",
                               inclusive: bool = False,
                               limit: int = 1024,
                               prefix: str = "") -> list[Entry]:
        dirpath = _norm(dirpath)
        out: list[Entry] = []
        cursor, cur_inclusive = start_from, inclusive or not start_from
        while len(out) < limit:
            want = min(limit - len(out), RESULT_SET_CAP)
            op = ">=" if cur_inclusive else ">"
            rows, truncated = self.db.execute(LIST.format(op=op), {
                "$dir_hash": p_int64(dir_hash(dirpath)),
                "$directory": p_utf8(dirpath),
                "$start_name": p_utf8(cursor),
                # LIKE wildcards in names must match literally — every
                # other store escapes the same way (filerstore
                # _like_escape + ESCAPE)
                "$prefix": p_utf8(_like_escape(prefix) + "%"),
                "$limit": p_uint64(want),
            })
            for r in rows:
                out.append(Entry.from_dict(json.loads(_cell_bytes(r[1]))))
            # a full page OR a truncated result set may hide more rows;
            # continue from the last name (exclusive)
            if not rows or (len(rows) < want and not truncated):
                break
            cursor = bytes(g.pb_first(rows[-1][0], 9, b"")).decode()
            cur_inclusive = False
        return out[:limit]

    # -- kv side-channel ------------------------------------------------
    def kv_put(self, key: str, value: bytes) -> None:
        self.db.execute(KV_UPSERT, {"$k": p_utf8(key),
                                    "$v": p_string(value)})

    def kv_get(self, key: str) -> bytes | None:
        rows, _ = self.db.execute(KV_GET, {"$k": p_utf8(key)})
        return _cell_bytes(rows[0][0]) if rows else None

    def kv_delete(self, key: str) -> None:
        self.db.execute(KV_DELETE, {"$k": p_utf8(key)})

    def close(self) -> None:
        self.db.close()
