"""Redis Cluster filer store — MOVED/ASK-aware RESP over the in-tree
client, no third-party SDK.

Equivalent of SeaweedFS weed/filer/redis/redis_cluster_store.go:35
(and redis2/redis3's cluster variants), which lean on go-redis's
NewClusterClient. That client's essential behaviors are implemented
here directly, per the public Redis Cluster spec:

- key -> slot: CRC16/XMODEM mod 16384, honoring {hash tags};
- the slot map comes from CLUSTER SLOTS against any live node, and is
  rebuilt whenever a node answers -MOVED (the authoritative "your map
  is stale" signal) or a connection dies;
- -ASK redirects are one-shot: follow to the target with ASKING
  prefixed, WITHOUT touching the slot map (the slot is mid-migration);
- multi-key reads (the listing page's MGET) become per-node pipelines
  of single-key GETs — cluster redis rejects cross-slot MGET, and a
  pipelined batch preserves the one-round-trip-per-node economy.

The store schema is untouched RedisStore (entry blob at its path key,
one sorted set of child names per directory): every command it issues
is single-key, which is exactly why the reference ships a cluster
variant of this same layout.

The port's copy of seaweedfs_tpu/filer/redis_cluster_store.py: the same files, keys,
rows and request bytes, over the standard library only.
"""
from __future__ import annotations

import random
import threading

from .filerstore import register_store
from .redis_store import RedisStore, RespClient, RespError

SLOTS = 16384


def _crc16_table():
    table = []
    for i in range(256):
        crc = i << 8
        for _ in range(8):
            crc = ((crc << 1) ^ 0x1021 if crc & 0x8000 else crc << 1) \
                & 0xFFFF
        table.append(crc)
    return table


_CRC16 = _crc16_table()


def key_slot(key: str | bytes) -> int:
    """CRC16(key) mod 16384 with the {hash tag} rule: when the key
    contains a non-empty brace section, only that section hashes."""
    k = key.encode() if isinstance(key, str) else key
    lb = k.find(b"{")
    if lb >= 0:
        rb = k.find(b"}", lb + 1)
        if rb > lb + 1:
            k = k[lb + 1:rb]
    crc = 0
    for byte in k:
        crc = ((crc << 8) ^ _CRC16[((crc >> 8) ^ byte) & 0xFF]) & 0xFFFF
    return crc % SLOTS


class ClusterRespClient:
    """Slot-routed RESP: one keep-alive RespClient per master node."""

    MAX_REDIRECTS = 8

    def __init__(self, seeds: list[tuple[str, int]], password: str = "",
                 timeout: float = 30.0):
        self._seeds = seeds
        self._password = password
        self._timeout = timeout
        self._lock = threading.Lock()
        self._conns: dict[tuple[str, int], RespClient] = {}
        # slot -> (host, port); filled by _refresh
        self._slot_owner: list[tuple[str, int] | None] = [None] * SLOTS
        self.moved_seen = 0  # observability: redirects handled
        self._refresh()

    def close(self) -> None:
        with self._lock:
            for c in self._conns.values():
                c.close()
            self._conns.clear()

    # -- connections + slot map -----------------------------------------
    def _conn(self, addr: tuple[str, int]) -> RespClient:
        with self._lock:
            c = self._conns.get(addr)
            if c is None:
                c = RespClient(addr[0], addr[1], self._password,
                               timeout=self._timeout)
                self._conns[addr] = c
            return c

    def _drop_conn(self, addr: tuple[str, int]) -> None:
        with self._lock:
            c = self._conns.pop(addr, None)
        if c is not None:
            c.close()

    def _refresh(self) -> None:
        """Rebuild the slot map from the first node that answers
        CLUSTER SLOTS; node lists are tried seeds-first then known."""
        candidates = list(self._seeds) + [
            a for a in self._slot_owner if a is not None]
        seen = set()
        for addr in candidates:
            if addr in seen:
                continue
            seen.add(addr)
            try:
                rows = self._conn(addr).cmd("CLUSTER", "SLOTS") or []
            except (RespError, OSError):
                self._drop_conn(addr)
                continue
            owner: list[tuple[str, int] | None] = [None] * SLOTS
            for row in rows:
                lo, hi, master = int(row[0]), int(row[1]), row[2]
                node = (master[0].decode()
                        if isinstance(master[0], bytes) else master[0],
                        int(master[1]))
                for s in range(lo, hi + 1):
                    owner[s] = node
            self._slot_owner = owner
            return
        raise RespError("no cluster node answered CLUSTER SLOTS")

    def _addr_for(self, key) -> tuple[str, int]:
        addr = self._slot_owner[key_slot(key)]
        return addr if addr is not None else random.choice(self._seeds)

    @staticmethod
    def _parse_redirect(msg: str) -> tuple[str, int]:
        # "MOVED 3999 127.0.0.1:7002" / "ASK 3999 127.0.0.1:7002"
        hostport = msg.split()[2]
        host, _, port = hostport.rpartition(":")
        return host, int(port)

    # -- command routing -------------------------------------------------
    def cmd(self, *args, key=None):
        """Route by args[1] (the key for every command RedisStore
        speaks); follow MOVED (with a map rebuild) and ASK (one-shot)
        up to MAX_REDIRECTS, and retry once through a fresh
        connection when a node drops."""
        k = key if key is not None else args[1]
        addr = self._addr_for(k)
        asking = False
        last = None
        for _ in range(self.MAX_REDIRECTS):
            try:
                conn = self._conn(addr)
                if asking:
                    # ASKING + the command must be one locked exchange:
                    # a concurrent thread's command on this shared conn
                    # would otherwise consume the one-shot grant
                    asking = False
                    reply = conn.pipeline([("ASKING",), args])[1]
                    if isinstance(reply, RespError):
                        raise reply
                    return reply
                return conn.cmd(*args)
            except RespError as e:
                msg = str(e)
                if msg.startswith("MOVED "):
                    self.moved_seen += 1
                    self._refresh()  # MOVED = the whole map is stale
                    # the redirect target is authoritative for THIS
                    # slot even when the refreshed node's view lags
                    addr = self._parse_redirect(msg)
                    self._slot_owner[key_slot(k)] = addr
                    continue
                if msg.startswith("ASK "):
                    addr = self._parse_redirect(msg)
                    asking = True
                    continue
                raise
            except OSError as e:
                self._drop_conn(addr)
                self._refresh()
                addr = self._addr_for(k)
                last = e
        raise RespError(f"redirect loop for {k!r} (last={last})")

    def mget(self, keys: list[str]) -> list:
        """Cross-slot MGET replacement: pipeline single-key GETs per
        owning node, then patch up any redirected stragglers
        individually."""
        by_addr: dict[tuple[str, int], list[int]] = {}
        for i, k in enumerate(keys):
            by_addr.setdefault(self._addr_for(k), []).append(i)
        out: list = [None] * len(keys)
        for addr, idxs in by_addr.items():
            try:
                replies = self._conn(addr).pipeline(
                    [("GET", keys[i]) for i in idxs])
            except OSError:
                self._drop_conn(addr)
                self._refresh()
                replies = [RespError("retry")] * len(idxs)
            for i, rep in zip(idxs, replies):
                if isinstance(rep, RespError):
                    out[i] = self.cmd("GET", keys[i])  # full redirect path
                else:
                    out[i] = rep
        return out


@register_store("redis_cluster")
class RedisClusterStore(RedisStore):
    """`-store redis_cluster -store.host host1:port1,host2:port2`.
    Same keyspace schema as the single-node store; only the transport
    changes (redis_cluster_store.go keeps the same universal layout)."""

    def __init__(self, host: str = "127.0.0.1:7000", port: int = 0,
                 password: str = "", **_):
        seeds = []
        for part in str(host).split(","):
            part = part.strip()
            if not part:
                continue
            h, _, p = part.rpartition(":")
            seeds.append((h or "127.0.0.1", int(p)))
        if not seeds and port:
            seeds = [("127.0.0.1", int(port))]
        if not seeds:
            raise ValueError(
                "redis_cluster needs -store.host host:port[,host:port…]")
        self._r = ClusterRespClient(seeds, password)
