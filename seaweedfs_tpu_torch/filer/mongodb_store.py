"""MongoDB filer store speaking the real wire protocol (OP_MSG + BSON).

The slot of SeaweedFS weed/filer/mongodb/mongodb_store.go, with
the client written in-tree (filer/bson_lite.py) instead of pymongo —
the third fully-implemented external wire protocol after redis RESP
and the etcd v3 gateway.

Layout (mirrors the reference: one collection, entries keyed by path):
  collection "filemeta": {_id: "<dir>\\x7f<name>", dir: "<dir>",
                          name: "<name>", meta: <entry-json bytes>}
  collection "filemeta_kv": {_id: <key>, value: <bytes>}

Directory listing filters on the indexed `dir` field with a `name`
range — no delimiter tricks needed because dir equality can't match
nested paths. 0x7f in _id merely keeps ids readable/unique; listing
never parses it.

The port's copy of seaweedfs_tpu/filer/mongodb_store.py: the same files, keys,
rows and request bytes, over the standard library only.
"""
from __future__ import annotations

import json
import threading

from .bson_lite import Int64, MongoError, MongoWire
from .entry import Entry
from .filerstore import FilerStore, _norm, _split, register_store

ID_SEP = "\x7f"


@register_store("mongodb")
class MongodbStore(FilerStore):
    """`-store=mongodb -store.host=... -store.port=27017
    -store.database=seaweedfs`."""

    def __init__(self, host: str = "127.0.0.1", port: int = 27017,
                 database: str = "seaweedfs", **_):
        self.db = database
        self._host, self._port = host, int(port)
        self._wire = MongoWire(self._host, self._port)
        self._lock = threading.Lock()  # one socket, serialized cmds
        # fail fast like the reference's initial ping
        self._cmd({"ping": 1})
        # the reference ensures the directory+name index on startup
        # (mongodb_store.go indexUnique); harmless if it exists
        try:
            self._cmd({"createIndexes": "filemeta", "indexes": [
                {"key": {"dir": 1, "name": 1}, "name": "dir_name"}]})
        except IOError:
            pass  # server without createIndexes (e.g. a thin double)

    def _cmd(self, doc: dict) -> dict:
        doc = dict(doc)
        doc["$db"] = self.db
        with self._lock:
            try:
                return self._wire.command(doc)
            except MongoError:
                raise  # server-side error; connection still synced
            except (IOError, OSError):
                # transport failure: the wire closes itself on
                # timeout/desync (an unread reply would be
                # mis-attributed); reconnect so a single slow query
                # doesn't wedge the store forever. Retry only
                # IDEMPOTENT commands — a getMore consumes the cursor
                # server-side, so re-sending it after a lost reply
                # would silently skip a whole batch.
                self._wire.close()
                self._wire = MongoWire(self._host, self._port)
                if "getMore" in doc:
                    raise
                return self._wire.command(doc)

    # -- entries --------------------------------------------------------
    @staticmethod
    def _eid(dirpath: str, name: str) -> str:
        return f"{_norm(dirpath)}{ID_SEP}{name}"

    def insert_entry(self, entry: Entry) -> None:
        d, n = entry.dir_and_name
        self._cmd({"update": "filemeta", "updates": [{
            "q": {"_id": self._eid(d, n)},
            "u": {"_id": self._eid(d, n), "dir": _norm(d), "name": n,
                  "meta": json.dumps(entry.to_dict()).encode()},
            "upsert": True}]})

    update_entry = insert_entry

    def find_entry(self, path: str) -> Entry | None:
        d, n = _split(path)
        if not n:
            return None
        got = self._cmd({"find": "filemeta",
                         "filter": {"_id": self._eid(d, n)},
                         "limit": 1})
        batch = got["cursor"]["firstBatch"]
        if not batch:
            return None
        return Entry.from_dict(json.loads(batch[0]["meta"]))

    def delete_entry(self, path: str) -> None:
        d, n = _split(path)
        if not n:
            return
        self._cmd({"delete": "filemeta", "deletes": [
            {"q": {"_id": self._eid(d, n)}, "limit": 1}]})

    def delete_folder_children(self, path: str) -> None:
        norm = _norm(path)
        sub = {"dir": {"$gte": norm + "/",
                       "$lt": norm + "0"}}  # '0' = '/' + 1
        if norm == "/":
            sub = {"dir": {"$gte": "/"}}  # every dir is absolute
        self._cmd({"delete": "filemeta", "deletes": [
            {"q": {"dir": norm}, "limit": 0},
            {"q": sub, "limit": 0}]})

    def list_directory_entries(self, dirpath: str, start_from: str = "",
                               inclusive: bool = False,
                               limit: int = 1024,
                               prefix: str = "") -> list[Entry]:
        dirpath = _norm(dirpath)
        name_cond: dict = {}
        if prefix:
            name_cond["$gte"] = prefix
            name_cond["$lt"] = prefix[:-1] + chr(ord(prefix[-1]) + 1)
        if start_from:
            op = "$gte" if inclusive else "$gt"
            # >=, not >: an exclusive start equal to the prefix must
            # REPLACE the $gte bound or the boundary entry repeats on
            # every continuation page
            if "$gte" not in name_cond or \
                    start_from >= name_cond["$gte"]:
                name_cond.pop("$gte", None)
                name_cond[op] = start_from
        filt: dict = {"dir": dirpath}
        if name_cond:
            filt["name"] = name_cond
        out: list[Entry] = []
        got = self._cmd({"find": "filemeta", "filter": filt,
                         "sort": {"name": 1}, "limit": limit,
                         "batchSize": limit})
        cursor = got["cursor"]
        while True:
            for row in cursor.get("firstBatch",
                                  cursor.get("nextBatch", [])):
                name = row["name"]
                if prefix and not name.startswith(prefix):
                    continue
                out.append(Entry.from_dict(json.loads(row["meta"])))
                if len(out) >= limit:
                    break
            if len(out) >= limit or not cursor.get("id"):
                return out
            # a real mongod REQUIRES getMore to be BSON long, even
            # for small ids (wire-typed field, not a plain number)
            got = self._cmd({"getMore": Int64(cursor["id"]),
                             "collection": "filemeta",
                             "batchSize": limit - len(out)})
            cursor = got["cursor"]

    # -- kv side-channel ------------------------------------------------
    def kv_put(self, key: str, value: bytes) -> None:
        self._cmd({"update": "filemeta_kv", "updates": [{
            "q": {"_id": key}, "u": {"_id": key, "value": value},
            "upsert": True}]})

    def kv_get(self, key: str) -> bytes | None:
        got = self._cmd({"find": "filemeta_kv",
                         "filter": {"_id": key}, "limit": 1})
        batch = got["cursor"]["firstBatch"]
        return bytes(batch[0]["value"]) if batch else None

    def kv_delete(self, key: str) -> None:
        self._cmd({"delete": "filemeta_kv", "deletes": [
            {"q": {"_id": key}, "limit": 1}]})

    def close(self) -> None:
        self._wire.close()
