"""Redis filer store over a self-contained RESP client.

Equivalent of SeaweedFS weed/filer/redis2/ (redis_store.go +
universal_redis_store.go): every entry lives at its full path as an
encoded blob, and each directory keeps a sorted set of child names so
listings are ordered server-side (ZRANGEBYLEX). No third-party redis
package: the client below speaks RESP2 over a plain socket, which is
all the store needs (SET/GET/DEL/ZADD/ZREM/ZRANGEBYLEX).

Works against real redis; tests run it against the in-process
mini-redis in tests/miniredis.py.

The port's copy of seaweedfs_tpu/filer/redis_store.py: the same files, keys,
rows and request bytes, over the standard library only.
"""
from __future__ import annotations

import json
import socket
import threading

from .entry import Entry
from .filerstore import FilerStore, _norm, _split, register_store

DIR_LIST_SUFFIX = "\x00children"  # NUL can't appear in filer paths


class RespError(Exception):
    pass


class RespClient:
    """Minimal RESP2 client: one socket, one outstanding command."""

    def __init__(self, host: str = "127.0.0.1", port: int = 6379,
                 password: str = "", db: int = 0,
                 timeout: float = 30.0):
        self._sock = socket.create_connection((host, port),
                                              timeout=timeout)
        self._buf = b""
        self._lock = threading.Lock()
        if password:
            self.cmd("AUTH", password)
        if db:
            self.cmd("SELECT", str(db))

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass

    # -- wire ----------------------------------------------------------
    def cmd(self, *args: str | bytes):
        out = bytearray(f"*{len(args)}\r\n".encode())
        for a in args:
            b = a if isinstance(a, bytes) else str(a).encode()
            out += f"${len(b)}\r\n".encode() + b + b"\r\n"
        with self._lock:
            self._sock.sendall(out)
            return self._read_reply()

    def _read_line(self) -> bytes:
        while b"\r\n" not in self._buf:
            chunk = self._sock.recv(65536)
            if not chunk:
                raise RespError("connection closed")
            self._buf += chunk
        line, self._buf = self._buf.split(b"\r\n", 1)
        return line

    def _read_exact(self, n: int) -> bytes:
        while len(self._buf) < n + 2:
            chunk = self._sock.recv(65536)
            if not chunk:
                raise RespError("connection closed")
            self._buf += chunk
        data, self._buf = self._buf[:n], self._buf[n + 2:]
        return data

    def _read_reply(self):
        line = self._read_line()
        t, rest = line[:1], line[1:]
        if t == b"+":
            return rest.decode()
        if t == b"-":
            raise RespError(rest.decode())
        if t == b":":
            return int(rest)
        if t == b"$":
            n = int(rest)
            return None if n < 0 else self._read_exact(n)
        if t == b"*":
            n = int(rest)
            return None if n < 0 else \
                [self._read_reply() for _ in range(n)]
        raise RespError(f"bad reply type {line!r}")

    def pipeline(self, cmds: list[tuple]) -> list:
        """Send every command in one write, read every reply in order.
        Error replies come back as RespError VALUES (not raised) so
        one redirected key doesn't mask the rest of the batch — the
        cluster client retries those individually."""
        out = bytearray()
        for args in cmds:
            out += f"*{len(args)}\r\n".encode()
            for a in args:
                b = a if isinstance(a, bytes) else str(a).encode()
                out += f"${len(b)}\r\n".encode() + b + b"\r\n"
        with self._lock:
            self._sock.sendall(out)
            replies = []
            for _ in cmds:
                try:
                    replies.append(self._read_reply())
                except RespError as e:
                    replies.append(e)
            return replies

    def mget(self, keys: list[str]) -> list:
        return self.cmd("MGET", *keys) or []


@register_store("redis")
class RedisStore(FilerStore):
    def __init__(self, host: str = "127.0.0.1", port: int = 6379,
                 password: str = "", db: int = 0, **_):
        self._r = RespClient(host, int(port), password, int(db))

    @staticmethod
    def _dir_key(dirpath: str) -> str:
        return _norm(dirpath) + DIR_LIST_SUFFIX

    def insert_entry(self, entry: Entry) -> None:
        d, n = entry.dir_and_name
        self._r.cmd("SET", entry.full_path,
                    json.dumps(entry.to_dict()))
        if n:
            self._r.cmd("ZADD", self._dir_key(d), "0", n)

    update_entry = insert_entry

    def find_entry(self, path: str) -> Entry | None:
        raw = self._r.cmd("GET", _norm(path))
        return Entry.from_dict(json.loads(raw)) if raw else None

    def delete_entry(self, path: str) -> None:
        path = _norm(path)
        d, n = _split(path)
        self._r.cmd("DEL", path)
        self._r.cmd("DEL", self._dir_key(path))
        if n:
            self._r.cmd("ZREM", self._dir_key(d), n)

    def delete_folder_children(self, path: str) -> None:
        path = _norm(path)
        key = self._dir_key(path)
        children = self._r.cmd("ZRANGE", key, "0", "-1") or []
        for name in children:
            child = path.rstrip("/") + "/" + name.decode()
            self.delete_folder_children(child)
            self._r.cmd("DEL", child)
            self._r.cmd("DEL", self._dir_key(child))
        self._r.cmd("DEL", key)

    def list_directory_entries(self, dirpath: str, start_from: str = "",
                               inclusive: bool = False,
                               limit: int = 1024,
                               prefix: str = "") -> list[Entry]:
        key = self._dir_key(dirpath)
        if start_from:
            lo = (("[" if inclusive else "(") + start_from).encode()
        elif prefix:
            lo = b"[" + prefix.encode()
        else:
            lo = b"-"
        # \xff upper bound covers every utf-8 name continuation byte
        hi = b"[" + prefix.encode() + b"\xff" if prefix else b"+"
        names = self._r.cmd("ZRANGEBYLEX", key, lo, hi,
                            "LIMIT", "0", str(limit)) or []
        base = _norm(dirpath).rstrip("/")
        wanted = [nb.decode() for nb in names
                  if not prefix or nb.decode().startswith(prefix)]
        if not wanted:
            return []
        # one MGET for the whole page instead of a GET per child — on a
        # 100k-entry directory the per-name round trips were the cost,
        # not redis (whose sorted sets are already skiplists; the
        # reference's redis3 chunked ItemList solves a cluster-slot
        # concern this single-keyspace store doesn't have)
        raws = self._r.mget([f"{base}/{n}" for n in wanted])
        out: list[Entry] = []
        for raw in raws:
            if raw is not None:
                out.append(Entry.from_dict(json.loads(raw)))
        return out

    def kv_put(self, key: str, value: bytes) -> None:
        self._r.cmd("SET", "kv\x00" + key, value)

    def kv_get(self, key: str) -> bytes | None:
        v = self._r.cmd("GET", "kv\x00" + key)
        return bytes(v) if v is not None else None

    def kv_delete(self, key: str) -> None:
        self._r.cmd("DEL", "kv\x00" + key)

    def close(self) -> None:
        self._r.close()
