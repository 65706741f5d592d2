"""MasterClient: client-side volume-location cache; the counterpart of
seaweedfs_tpu/wdclient/client.py.

Equivalent of SeaweedFS weed/wdclient/masterclient.go:20 + vid_map.go:37:
a vid -> locations map and a vid -> {shard id: holders} map, with HTTP
lookup and master failover. The reference keeps both maps fresh through
the master's KeepConnected websocket (`subscribe=True`); the port has
no such stream, so entries live for the caller's `max_age` and a caller
that finds an entry stale (a holder that no longer has the shard)
drops it with `invalidate(vid)` and reads the master again.
"""
from __future__ import annotations

import threading
import time

from ..rpc.httpclient import RequestException, session

LOOKUP_TIMEOUT = 10.0


class MasterClient:
    def __init__(self, master_urls: list[str] | str):
        if isinstance(master_urls, str):
            master_urls = [master_urls]
        self.masters = [u.rstrip("/") for u in master_urls]
        self._current = 0
        self._vid_cache: dict[int, list[dict]] = {}
        self._cache_time: dict[int, float] = {}
        # EC per-shard locations: vid -> {shard_id: [urls]}
        # (vid_map.go:169-236 ecVidMap)
        self._ec_cache: dict[int, dict[int, list[str]]] = {}
        self._ec_cache_time: dict[int, float] = {}
        self._lock = threading.Lock()

    @property
    def master_url(self) -> str:
        return self.masters[self._current]

    def _failover(self) -> None:
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
                self._failover()
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
                self._failover()
        # master unreachable: a stale map beats no map — the shards
        # themselves are still where they were for almost all reads
        with self._lock:
            return self._ec_cache.get(vid, {})

    def invalidate(self, vid: int) -> None:
        with self._lock:
            self._vid_cache.pop(vid, None)
            self._cache_time.pop(vid, None)
            self._ec_cache.pop(vid, None)
            self._ec_cache_time.pop(vid, None)
