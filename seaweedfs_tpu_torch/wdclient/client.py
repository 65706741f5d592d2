"""MasterClient: client-side volume-location cache; the counterpart of
seaweedfs_tpu/wdclient/client.py.

Equivalent of SeaweedFS weed/wdclient/masterclient.go:20 + vid_map.go:37:
a vid -> locations map and a vid -> {shard id: holders} map, with HTTP
lookup and master failover over a list of masters (a follower 307s a
lookup to the raft leader; an unreachable master rotates to the next).
With `subscribe=True` a thread keeps both maps fresh through the
leader's KeepConnected websocket (rpc/websocket.py): a snapshot on
connect, deltas after. A follower answers the stream with the leader's
address, and the client follows it (masterclient.go:172); a stream that
ends or never opens rotates to the next master. Without a
subscription, entries live for the caller's `max_age`, and a caller
that finds an entry stale (a holder that no longer has the shard)
drops it with `invalidate(vid)` and reads the master again.
`lookup_file_id_urls` turns a fid into the urls the filer reads it
from, breaker-healthy peers first (utils/retry.py).
"""
from __future__ import annotations

import json
import socket
import threading
import time

from ..rpc import websocket
from ..rpc.httpclient import RequestException, session
from ..utils import retry


def _order_by_breaker(urls: list[str]) -> list[str]:
    """Peers whose circuit breaker is closed/half-open first, open-
    breaker peers last (still listed — when every replica is open the
    caller should try anyway rather than fail without a request).
    Reads breaker state without consuming the half-open probe slot."""
    good, bad = [], []
    for u in urls:
        peer = u.split("//", 1)[-1].split("/", 1)[0]
        (bad if retry.breaker_for(peer).state == retry.OPEN
         else good).append(u)
    return good + bad

LOOKUP_TIMEOUT = 10.0
# timeout of one master's /cluster/leader probe
LEADER_PROBE_TIMEOUT = 3.0
# a quiet KeepConnected stream is pinged after this many seconds
STREAM_PING = 30.0
# how long stop() waits for the subscription thread
JOIN_TIMEOUT = 5.0


def find_leader(masters: list[str]) -> str:
    """The raft leader's url among `masters` (masterclient.go:160
    tryAllMasters): the first that says it leads or names the leader
    over /cluster/leader; "" when none answers with one."""
    for m in masters:
        try:
            d = session().get(f"{m}/cluster/leader",
                              timeout=LEADER_PROBE_TIMEOUT).json()
        except (OSError, ValueError):
            continue
        if d.get("IsLeader"):
            return m
        if d.get("Leader"):
            return f"http://{d['Leader']}"
    return ""


class MasterClient:
    def __init__(self, master_urls: list[str] | str,
                 subscribe: bool = False):
        if isinstance(master_urls, str):
            master_urls = master_urls.split(",")
        self.masters = [u if u.startswith("http") else f"http://{u}"
                        for u in (m.strip().rstrip("/")
                                  for m in master_urls) if u]
        self._current = 0
        self._vid_cache: dict[int, list[dict]] = {}
        self._cache_time: dict[int, float] = {}
        # EC per-shard locations: vid -> {shard_id: [urls]}
        # (vid_map.go:169-236 ecVidMap)
        self._ec_cache: dict[int, dict[int, list[str]]] = {}
        self._ec_cache_time: dict[int, float] = {}
        self._lock = threading.Lock()
        self._ws_thread: threading.Thread | None = None
        self._ws: websocket.WebSocket | None = None
        self._stop = threading.Event()
        if subscribe:
            self.start_subscription()

    @property
    def master_url(self) -> str:
        return self.masters[self._current]

    def failover(self) -> None:
        self._current = (self._current + 1) % len(self.masters)

    # -- lookups --------------------------------------------------------
    def lookup(self, vid: int, max_age: float = 600.0) -> list[dict]:
        """-> [{'url':..., 'publicUrl':...}] for a volume id, cached."""
        with self._lock:
            locs = self._vid_cache.get(vid)
            if locs is not None and \
                    time.monotonic() - self._cache_time.get(vid, 0) < max_age:
                return locs
        for _ in range(len(self.masters)):
            try:
                resp = session().get(f"{self.master_url}/dir/lookup",
                                     params={"volumeId": str(vid)},
                                     timeout=LOOKUP_TIMEOUT)
                if resp.status_code == 404:
                    return []
                resp.raise_for_status()
                locs = resp.json().get("locations", [])
                with self._lock:
                    self._vid_cache[vid] = locs
                    self._cache_time[vid] = time.monotonic()
                return locs
            except RequestException:
                self.failover()
        return []

    def lookup_ec(self, vid: int,
                  max_age: float = 600.0) -> dict[int, list[str]]:
        """-> {shard_id: [urls]} for an EC volume, cached for max_age."""
        with self._lock:
            shards = self._ec_cache.get(vid)
            if shards is not None and \
                    time.monotonic() - self._ec_cache_time.get(vid, 0) \
                    < max_age:
                return shards
        for _ in range(len(self.masters)):
            try:
                resp = session().get(f"{self.master_url}/cluster/ec_shards",
                                     params={"volumeId": str(vid)},
                                     timeout=LOOKUP_TIMEOUT)
                resp.raise_for_status()
                shards = {int(sid): urls for sid, urls in
                          resp.json().get("shards", {}).items()}
                with self._lock:
                    self._ec_cache[vid] = shards
                    self._ec_cache_time[vid] = time.monotonic()
                return shards
            except RequestException:
                self.failover()
        # master unreachable: a stale map beats no map — the shards
        # themselves are still where they were for almost all reads
        with self._lock:
            return self._ec_cache.get(vid, {})

    def cached_volumes(self) -> int:
        with self._lock:
            return len(self._vid_cache)

    def invalidate(self, vid: int) -> None:
        with self._lock:
            self._vid_cache.pop(vid, None)
            self._cache_time.pop(vid, None)
            self._ec_cache.pop(vid, None)
            self._ec_cache_time.pop(vid, None)

    def lookup_file_id_urls(self, fid: str,
                            max_age: float = 600.0) -> list[str]:
        """All urls for a fid (every replica, or every holder of an EC
        volume's shards) — callers iterate for failover, or hedge the
        second. Breaker-healthy first, else in the master's order."""
        vid = int(fid.split(",")[0])
        locs = self.lookup(vid, max_age=max_age)
        if not locs:
            raise LookupError(f"volume {vid} has no locations")
        return _order_by_breaker(
            [f"http://{loc['url']}/{fid}" for loc in locs])

    def lookup_file_id(self, fid: str, max_age: float = 600.0) -> str:
        """fid -> full url (GetLookupFileIdFunction equivalent)."""
        return self.lookup_file_id_urls(fid, max_age=max_age)[0]

    # -- KeepConnected subscription (masterclient.go:130-217) -----------
    def start_subscription(self) -> None:
        if self._ws_thread is not None:
            return
        self._stop.clear()
        self._ws_thread = threading.Thread(
            target=self._ws_loop, name="keepconnected", daemon=True)
        self._ws_thread.start()

    def stop(self) -> None:
        self._stop.set()
        ws = self._ws
        if ws is not None:
            ws.close()
        if self._ws_thread is not None:
            self._ws_thread.join(timeout=JOIN_TIMEOUT)
            self._ws_thread = None

    def _ws_loop(self) -> None:
        while not self._stop.is_set():
            got_data = redirected = False
            try:
                ws = websocket.connect(
                    f"{self.master_url}/ws/keepconnected",
                    timeout=STREAM_PING)
            except (OSError, ValueError):
                self.failover()
                self._stop.wait(1.0)
                continue
            self._ws = ws
            try:
                while not self._stop.is_set():
                    try:
                        msg = ws.receive()
                    except socket.timeout:
                        ws.ping()
                        continue
                    if msg is None:
                        break
                    d = json.loads(msg)
                    if "leader" in d:
                        # a follower refusing the stream names the
                        # leader (masterclient.go:172)
                        self._follow_leader(d["leader"])
                        redirected = True
                        break
                    got_data = True
                    self._apply(d)
            except (OSError, ValueError):
                pass
            finally:
                self._ws = None
                ws.close()
            # rotate unless this stream served us or named the leader,
            # and never spin
            if not got_data and not redirected:
                self.failover()
            self._stop.wait(0.2 if (got_data or redirected) else 1.0)

    def _follow_leader(self, leader: str) -> None:
        if not leader:
            return
        url = leader if leader.startswith("http") else f"http://{leader}"
        if url in self.masters:
            self._current = self.masters.index(url)
        else:
            self.masters.append(url)
            self._current = len(self.masters) - 1

    def _apply(self, msg: dict) -> None:
        now = time.monotonic()
        with self._lock:
            if "snapshot" in msg:
                self._vid_cache = {
                    int(vid): locs for vid, locs in msg["snapshot"].items()}
                self._cache_time = {v: now for v in self._vid_cache}
            for vid, locs in msg.get("updates", {}).items():
                self._vid_cache[int(vid)] = locs
                self._cache_time[int(vid)] = now
            if "ec_snapshot" in msg:
                self._ec_cache = {
                    int(vid): {int(s): urls for s, urls in shards.items()}
                    for vid, shards in msg["ec_snapshot"].items()}
                self._ec_cache_time = {v: now for v in self._ec_cache}
            for vid, shards in msg.get("ec_updates", {}).items():
                self._ec_cache[int(vid)] = {
                    int(s): urls for s, urls in shards.items()}
                self._ec_cache_time[int(vid)] = now
