"""HBase filer store over the HBase Thrift1 gateway (thrift_lite.py).

The reference's store (SeaweedFS weed/filer/hbase/
hbase_store.go:20-108, hbase_store_kv.go) rides the gohbase native
RPC; this build speaks the Thrift gateway every HBase ships (default
port 9090, `hbase thrift start`) through the in-tree binary-protocol
client — no SDK.

Same data model as the reference: one table, column family ``meta``
holds entries (row key = full path, qualifier ``a``, value = entry
JSON) and column family ``kv`` holds the kv side-channel under the
same qualifier. Directory listings scan the path keyspace from
``<dir>/<prefix>`` and keep only direct children, exactly like the
reference's ListDirectoryPrefixedEntries scan loop (hbase_store.go:155
checks ``dir != string(dirPath)`` and skips deeper descendants).

`-store=hbase -store.host=... -store.port=9090 -store.table=seaweedfs`

The port's copy of seaweedfs_tpu/filer/hbase_store.py: the same table,
row keys, column families and cells, over the standard library only.
"""
from __future__ import annotations

import json

from .entry import Entry
from .filerstore import (FilerStore, _list_filter, _norm,
                         register_store)
from .thrift_lite import (LIST, MAP, STRING, STRUCT, BOOL, I32,
                          ThriftClient, ThriftError, Writer)

META_COL = b"meta:a"
KV_COL = b"kv:a"
SCAN_BATCH = 256


def _w_attributes(w: Writer, fid: int) -> None:
    """The trailing `map<Text,Text> attributes` every Thrift1 verb
    takes — always empty here."""
    w.field(MAP, fid).map_header(STRING, STRING, 0)


class _Hbase:
    """The handful of Hbase.thrift verbs the store needs."""

    def __init__(self, host: str, port: int, framed: bool,
                 table: str):
        self.c = ThriftClient(host, port, framed=framed)
        self.table = table.encode()

    def create_table_if_missing(self) -> None:
        try:
            self.c.call("createTable", self._create_args)
        except ThriftError as e:
            # AlreadyExists (or a gateway that forbids DDL): the store
            # works as long as the table is there — probe it
            if "exist" not in str(e).lower():
                self.get_row(b"__probe__", META_COL)

    def _create_args(self, w: Writer) -> None:
        w.field(STRING, 1).string(self.table)
        w.field(LIST, 2).list_header(STRUCT, 2)
        for family in (b"meta:", b"kv:"):
            w.field(STRING, 1).string(family)
            w.stop()

    def put(self, row: bytes, column: bytes, value: bytes) -> None:
        def args(w: Writer) -> None:
            w.field(STRING, 1).string(self.table)
            w.field(STRING, 2).string(row)
            w.field(LIST, 3).list_header(STRUCT, 1)
            # Mutation {1: isDelete, 2: column, 3: value, 4: writeToWAL}
            w.field(BOOL, 1).bool_(False)
            w.field(STRING, 2).string(column)
            w.field(STRING, 3).string(value)
            w.field(BOOL, 4).bool_(True)
            w.stop()
            _w_attributes(w, 4)

        self.c.call("mutateRow", args)

    def delete_column(self, row: bytes, column: bytes) -> None:
        def args(w: Writer) -> None:
            w.field(STRING, 1).string(self.table)
            w.field(STRING, 2).string(row)
            w.field(LIST, 3).list_header(STRUCT, 1)
            w.field(BOOL, 1).bool_(True)  # isDelete
            w.field(STRING, 2).string(column)
            w.stop()
            _w_attributes(w, 4)

        self.c.call("mutateRow", args)

    def get_row(self, row: bytes, column: bytes) -> bytes | None:
        def args(w: Writer) -> None:
            w.field(STRING, 1).string(self.table)
            w.field(STRING, 2).string(row)
            w.field(LIST, 3).list_header(STRING, 1).string(column)
            _w_attributes(w, 4)

        rows = self.c.call("getRowWithColumns", args) or []
        for r in rows:
            # TRowResult {1: row, 2: map<Text, TCell{1: value}>}
            cells = r.get(2) or {}
            cell = cells.get(column)
            if cell is not None:
                return bytes(cell.get(1, b""))
        return None

    def scan(self, start_row: bytes, column: bytes):
        """Yield (row, value) from start_row to table end — the caller
        breaks when rows leave its prefix window, mirroring the
        reference's open-ended NewScanRange + prefix check."""
        def open_args(w: Writer) -> None:
            w.field(STRING, 1).string(self.table)
            w.field(STRUCT, 2)  # TScan
            w.field(STRING, 1).string(start_row)
            w.field(LIST, 4).list_header(STRING, 1).string(column)
            w.field(I32, 5).i32(SCAN_BATCH)  # caching
            w.stop()
            _w_attributes(w, 3)

        scanner = self.c.call("scannerOpenWithScan", open_args)
        try:
            while True:
                def get_args(w: Writer, sid=scanner) -> None:
                    w.field(I32, 1).i32(sid)
                    w.field(I32, 2).i32(SCAN_BATCH)

                rows = self.c.call("scannerGetList", get_args) or []
                if not rows:
                    return
                for r in rows:
                    cells = r.get(2) or {}
                    cell = cells.get(column)
                    if cell is not None:
                        yield bytes(r.get(1, b"")), \
                            bytes(cell.get(1, b""))
        finally:
            try:
                self.c.call(
                    "scannerClose",
                    lambda w: w.field(I32, 1).i32(scanner))
            except (IOError, ThriftError):
                pass  # server reaps leaked scanners by lease timeout


@register_store("hbase")
class HbaseStore(FilerStore):
    """`-store=hbase -store.host=... -store.port=9090`."""

    def __init__(self, host: str = "127.0.0.1", port: int = 9090,
                 table: str = "seaweedfs", framed: bool = False, **_):
        self.h = _Hbase(host, int(port), framed, table)
        self.h.create_table_if_missing()

    # -- entries --------------------------------------------------------
    def insert_entry(self, entry: Entry) -> None:
        self.h.put(entry.full_path.encode(), META_COL,
                   json.dumps(entry.to_dict()).encode())

    update_entry = insert_entry

    def find_entry(self, path: str) -> Entry | None:
        raw = self.h.get_row(_norm(path).encode(), META_COL)
        if raw is None:
            return None
        return Entry.from_dict(json.loads(raw))

    def delete_entry(self, path: str) -> None:
        self.h.delete_column(_norm(path).encode(), META_COL)

    def delete_folder_children(self, path: str) -> None:
        # path-keyed rows: the subtree is exactly the rows prefixed by
        # "<path>/" (one contiguous scan window; "/t" and "/tother"
        # cannot collide because the separator byte is fixed)
        norm = _norm(path)
        pfx = b"/" if norm == "/" else (norm + "/").encode()
        doomed = []
        for row, _val in self.h.scan(pfx, META_COL):
            if not row.startswith(pfx):
                break
            doomed.append(row)
        for row in doomed:
            self.h.delete_column(row, META_COL)

    def list_directory_entries(self, dirpath: str, start_from: str = "",
                               inclusive: bool = False,
                               limit: int = 1024,
                               prefix: str = "") -> list[Entry]:
        dirpath = _norm(dirpath)
        base = (b"/" if dirpath == "/" else (dirpath + "/").encode())
        start = base + (start_from or prefix or "").encode()
        if prefix and start_from and prefix > start_from:
            start = base + prefix.encode()
        out: list[Entry] = []
        for row, val in self.h.scan(start, META_COL):
            if not row.startswith(base):
                break
            name_b = row[len(base):]
            if b"/" in name_b:
                continue  # deeper descendant (hbase_store.go:155)
            name = name_b.decode("utf-8", "replace")
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
        self.h.put(key.encode(), KV_COL, value)

    def kv_get(self, key: str) -> bytes | None:
        return self.h.get_row(key.encode(), KV_COL)

    def kv_delete(self, key: str) -> None:
        self.h.delete_column(key.encode(), KV_COL)

    def close(self) -> None:
        self.h.c.close()
