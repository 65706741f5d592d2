"""etcd filer store over the official etcd v3 HTTP/JSON gateway.

The reference's etcd store (SeaweedFS weed/filer/etcd/
etcd_store.go) rides clientv3 gRPC; etcd ships a first-party HTTP/JSON
gateway for the same v3 KV API (grpc-gateway: POST /v3/kv/put,
/v3/kv/range, /v3/kv/deleterange with base64 keys — the /v3 path since
etcd 3.4; older 3.x used /v3alpha//v3beta), which this store speaks
directly — a REAL wire protocol against a real etcd, with zero client
SDK (same in-tree-protocol approach as the redis RESP store).

Key layout (etcd ranges are lexicographic over bytes):
  E<dir>\\x00<name>  -> entry JSON   (\\x00 sorts before every path
                                     char, so a directory's children
                                     form one contiguous range that
                                     CANNOT collide with deeper paths)
  K<key>             -> kv side-channel value

The port's copy of seaweedfs_tpu/filer/etcd_store.py: the same files, keys,
rows and request bytes, over the standard library only.
"""
from __future__ import annotations

import base64
import json

from ..rpc.httpclient import session
from .entry import Entry
from .filerstore import FilerStore, _norm, _split, register_store

SEP = "\x00"


def _b64(s: bytes) -> str:
    return base64.b64encode(s).decode()


def _unb64(s: str) -> bytes:
    return base64.b64decode(s)


def _prefix_end(prefix: bytes) -> bytes:
    """etcd range_end for 'every key with this prefix': the prefix with
    its last byte incremented (the gateway's getPrefix)."""
    p = bytearray(prefix)
    for i in reversed(range(len(p))):
        if p[i] < 0xFF:
            p[i] += 1
            return bytes(p[:i + 1])
    return b"\x00"  # all-0xff prefix: range to the keyspace end


@register_store("etcd")
class EtcdStore(FilerStore):
    """`-store=etcd -store.host=... -store.port=2379`."""

    def __init__(self, host: str = "127.0.0.1", port: int = 2379,
                 password: str = "", user: str = "root", **_):
        self.base = f"http://{host}:{int(port)}/v3"
        self._user = user
        self._password = password
        self._headers: dict = {}
        if password:
            self._authenticate()
        # fail fast on a wrong endpoint, like the reference's
        # clientv3.New + initial status rpc
        self._call("kv/range", {"key": _b64(b"\x00"), "limit": 1})

    def _authenticate(self) -> None:
        """v3/auth/authenticate: etcd simple tokens EXPIRE (default
        300s TTL) — callers re-auth on token rejection, not just once
        at startup."""
        r = session().post(f"{self.base}/auth/authenticate",
                          json={"name": self._user,
                                "password": self._password}, timeout=10)
        r.raise_for_status()
        self._headers = {"Authorization": r.json()["token"]}

    def _call(self, path: str, body: dict) -> dict:
        for attempt in (0, 1):
            r = session().post(f"{self.base}/{path}", json=body,
                              headers=self._headers, timeout=30)
            if r.status_code < 300:
                return r.json()
            if attempt == 0 and self._password and \
                    ("invalid auth token" in r.text
                     or r.status_code == 401):
                self._authenticate()
                continue
            raise IOError(f"etcd {path}: {r.status_code} {r.text[:200]}")

    # -- entries --------------------------------------------------------
    @staticmethod
    def _entry_key(dirpath: str, name: str) -> bytes:
        return f"E{_norm(dirpath)}{SEP}{name}".encode()

    def insert_entry(self, entry: Entry) -> None:
        d, n = entry.dir_and_name
        self._call("kv/put", {
            "key": _b64(self._entry_key(d, n)),
            "value": _b64(json.dumps(entry.to_dict()).encode())})

    update_entry = insert_entry

    def find_entry(self, path: str) -> Entry | None:
        d, n = _split(path)
        if not n:
            return None
        got = self._call("kv/range",
                         {"key": _b64(self._entry_key(d, n))})
        kvs = got.get("kvs", [])
        if not kvs:
            return None
        return Entry.from_dict(json.loads(_unb64(kvs[0]["value"])))

    def delete_entry(self, path: str) -> None:
        d, n = _split(path)
        if not n:
            return
        self._call("kv/deleterange",
                   {"key": _b64(self._entry_key(d, n))})

    def delete_folder_children(self, path: str) -> None:
        # two contiguous ranges cover the subtree without touching a
        # sibling that merely shares a name prefix (/t vs /tother):
        #   E<path>\x00*  — path's DIRECT children
        #   E<path>/*     — every nested directory's entries
        norm = _norm(path)
        if norm == "/":
            # root: every entry key starts with "E/" (dirs are
            # normalized absolute), one range covers the world —
            # base+"/" would be "E//", which matches nothing
            pfx = b"E/"
            self._call("kv/deleterange", {
                "key": _b64(pfx), "range_end": _b64(_prefix_end(pfx))})
            return
        base = f"E{norm}".encode()
        for pfx in (base + SEP.encode(), base + b"/"):
            self._call("kv/deleterange", {
                "key": _b64(pfx),
                "range_end": _b64(_prefix_end(pfx))})

    def list_directory_entries(self, dirpath: str, start_from: str = "",
                               inclusive: bool = False,
                               limit: int = 1024,
                               prefix: str = "") -> list[Entry]:
        dirpath = _norm(dirpath)
        base = f"E{dirpath}{SEP}".encode()
        start = base + (prefix or start_from or "").encode()
        if start_from and (not prefix or start_from > prefix):
            start = base + start_from.encode()
        out: list[Entry] = []
        while len(out) < limit:
            got = self._call("kv/range", {
                "key": _b64(start),
                "range_end": _b64(_prefix_end(base)),
                "limit": limit - len(out) + 1,
                "sort_order": "ASCEND", "sort_target": "KEY"})
            kvs = got.get("kvs", [])
            for kv in kvs:
                # slice BYTES by the byte-length prefix, then decode —
                # slicing the decoded str by len(bytes) mangles names
                # under non-ASCII directory paths
                name = _unb64(kv["key"])[len(base):].decode()
                if prefix and not name.startswith(prefix):
                    if name > prefix:
                        return out  # past the prefix window: done
                    continue
                if start_from:
                    if name < start_from or \
                            (name == start_from and not inclusive):
                        continue
                out.append(Entry.from_dict(
                    json.loads(_unb64(kv["value"]))))
                if len(out) >= limit:
                    return out
            if not got.get("more") and len(kvs) <= limit:
                return out
            if not kvs:
                return out
            start = _unb64(kvs[-1]["key"]) + b"\x00"
        return out

    # -- kv side-channel ------------------------------------------------
    def kv_put(self, key: str, value: bytes) -> None:
        self._call("kv/put", {"key": _b64(b"K" + key.encode()),
                              "value": _b64(value)})

    def kv_get(self, key: str) -> bytes | None:
        got = self._call("kv/range",
                         {"key": _b64(b"K" + key.encode())})
        kvs = got.get("kvs", [])
        return _unb64(kvs[0]["value"]) if kvs else None

    def kv_delete(self, key: str) -> None:
        self._call("kv/deleterange",
                   {"key": _b64(b"K" + key.encode())})
