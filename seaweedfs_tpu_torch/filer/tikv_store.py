"""TiKV filer store over the RawKV gRPC API (utils/grpc_lite.py).

The reference's store (SeaweedFS weed/filer/tikv/
tikv_store.go:30-80) rides client-go's transactional KV through PD
region routing; this build speaks TiKV's RawKV service
(tikvpb.Tikv/RawGet|RawPut|RawDelete|RawScan|RawDeleteRange,
kvrpcpb messages) through the in-tree gRPC client — no SDK.

Key layout mirrors the reference (tikv_store.go:373 generateKey):
entries live at sha1(dir) + name so one directory's children form a
contiguous scan range; a 1-byte namespace tag ('m' entries, 'k' kv)
keeps the kv side-channel out of entry scans (the reference splits
namespaces the same way in its kv file).

Deployment note: RawKV addresses a tikv node directly
(`-store.host=<tikv> -store.port=20160`). Multi-region clusters route
via PD, which client-go embeds; that routing layer (the reference's
txnkv client) is PD's job, not a wire protocol, and is out of scope
here — single-node/region TiKV and any RawKV-compatible endpoint work
as-is.

The port's copy of seaweedfs_tpu/filer/tikv_store.py: the same RawKV
keys, values and scan batches, over the standard library only.
"""
from __future__ import annotations

import hashlib
import json

from ..utils import grpc_lite as g
from .entry import Entry
from .filerstore import (FilerStore, _delete_subtree_by_walk,
                         _list_filter, _norm, _split, register_store)

SVC = "/tikvpb.Tikv"


def _dir_hash(dirpath: str) -> bytes:
    return hashlib.sha1(dirpath.encode()).digest()


def _entry_key(dirpath: str, name: str) -> bytes:
    return b"m" + _dir_hash(dirpath) + name.encode()


def _prefix_end(prefix: bytes) -> bytes:
    p = bytearray(prefix)
    for i in reversed(range(len(p))):
        if p[i] < 0xFF:
            p[i] += 1
            return bytes(p[:i + 1])
    return b""  # unbounded


@register_store("tikv")
class TikvStore(FilerStore):
    """`-store=tikv -store.host=... -store.port=20160`."""

    SCAN_LIMIT = 1024

    def __init__(self, host: str = "127.0.0.1", port: int = 20160,
                 **_):
        self.ch = g.GrpcChannel(host, int(port))
        # fail fast on a wrong endpoint, like the reference's client
        # construction + first region lookup
        self._raw_get(b"k__probe__")

    # -- RawKV verbs -----------------------------------------------------
    # kvrpcpb field numbers (public proto): requests carry context=1;
    # responses region_error=1, error=2.
    def _call(self, method: str, req: bytes,
              err_field: int | None = 2) -> dict[int, list]:
        """region_error is field 1 on every Raw* response; the string
        `error` rides field 2 on get/put/delete/delete-range — but NOT
        on RawScan, where 2 is the kvs list."""
        resp = g.pb_decode(self.ch.unary(f"{SVC}/{method}", req))
        err = g.pb_first(resp, 1)
        if isinstance(err, bytes) and err:
            raise IOError(f"tikv {method} region error: {err[:200]!r}")
        if err_field is not None:
            err = g.pb_first(resp, err_field)
            if isinstance(err, bytes) and err:
                raise IOError(f"tikv {method}: {err[:200]!r}")
        return resp

    def _raw_get(self, key: bytes) -> bytes | None:
        # RawGetRequest {context=1, key=2, cf=3}; resp value=3,
        # not_found=4
        resp = self._call("RawGet", g.pb_bytes(2, key))
        if g.pb_first(resp, 4, 0):
            return None
        # proto3 omits empty bytes: an existing key with value b"" has
        # NEITHER field set — only not_found distinguishes absence
        val = g.pb_first(resp, 3)
        return bytes(val) if val is not None else b""

    def _raw_put(self, key: bytes, value: bytes) -> None:
        # RawPutRequest {context=1, key=2, value=3, cf=4}
        self._call("RawPut", g.pb_bytes(2, key) + g.pb_bytes(3, value))

    def _raw_delete(self, key: bytes) -> None:
        # RawDeleteRequest {context=1, key=2, cf=3}
        self._call("RawDelete", g.pb_bytes(2, key))

    def _raw_delete_range(self, start: bytes, end: bytes) -> None:
        # RawDeleteRangeRequest {context=1, start_key=2, end_key=3}
        self._call("RawDeleteRange",
                   g.pb_bytes(2, start) + g.pb_bytes(3, end))

    def _raw_scan(self, start: bytes, end: bytes,
                  limit: int) -> list[tuple[bytes, bytes]]:
        # RawScanRequest {context=1, start_key=2, limit=3, key_only=4,
        # cf=5, reverse=6, end_key=7}; resp kvs=2 of
        # KvPair {error=1, key=2, value=3}
        req = g.pb_bytes(2, start) + g.pb_uint(3, limit)
        if end:
            req += g.pb_bytes(7, end)
        resp = self._call("RawScan", req, err_field=None)
        out = []
        for raw in resp.get(2, []):
            pair = g.pb_decode(bytes(raw))
            out.append((bytes(g.pb_first(pair, 2, b"")),
                        bytes(g.pb_first(pair, 3, b""))))
        return out

    # -- entries --------------------------------------------------------
    def insert_entry(self, entry: Entry) -> None:
        d, n = entry.dir_and_name
        self._raw_put(_entry_key(d, n),
                      json.dumps(entry.to_dict()).encode())

    update_entry = insert_entry

    def find_entry(self, path: str) -> Entry | None:
        d, n = _split(path)
        if not n:
            return None
        raw = self._raw_get(_entry_key(d, n))
        if raw is None:
            return None
        return Entry.from_dict(json.loads(raw))

    def delete_entry(self, path: str) -> None:
        d, n = _split(path)
        if n:
            self._raw_delete(_entry_key(d, n))

    def delete_folder_children(self, path: str) -> None:
        # directory hashes scatter the keyspace: shared recursive walk,
        # then one contiguous RawDeleteRange per directory
        _delete_subtree_by_walk(self, path)

    def delete_directory_range(self, d: str) -> None:
        base = b"m" + _dir_hash(d)
        self._raw_delete_range(base, _prefix_end(base))

    def list_directory_entries(self, dirpath: str, start_from: str = "",
                               inclusive: bool = False,
                               limit: int = 1024,
                               prefix: str = "") -> list[Entry]:
        dirpath = _norm(dirpath)
        base = b"m" + _dir_hash(dirpath)
        first = prefix or start_from or ""
        if prefix and start_from and start_from > prefix:
            first = start_from
        cursor = base + first.encode()
        out: list[Entry] = []
        while len(out) < limit:
            batch = self._raw_scan(cursor, _prefix_end(base),
                                   min(self.SCAN_LIMIT,
                                       limit - len(out) + 1))
            if not batch:
                break
            for key, val in batch:
                name = key[len(base):].decode("utf-8", "replace")
                verdict = _list_filter(name, prefix, start_from,
                                       inclusive)
                if verdict == "stop":
                    return out
                if verdict == "skip":
                    continue
                out.append(Entry.from_dict(json.loads(val)))
                if len(out) >= limit:
                    return out
            if len(batch) < self.SCAN_LIMIT and \
                    len(batch) < limit - len(out) + 1:
                break
            cursor = batch[-1][0] + b"\x00"
        return out

    # -- kv side-channel ------------------------------------------------
    def kv_put(self, key: str, value: bytes) -> None:
        self._raw_put(b"k" + key.encode(), value)

    def kv_get(self, key: str) -> bytes | None:
        return self._raw_get(b"k" + key.encode())

    def kv_delete(self, key: str) -> None:
        self._raw_delete(b"k" + key.encode())

    def close(self) -> None:
        self.ch.close()
