"""In-process cluster harness: one master and N volume servers on
localhost ephemeral ports, each served from its own thread; the
counterpart of seaweedfs_tpu/server/cluster.py.

The single-host analogue of the reference's docker-compose cluster
fixtures and the `weed server` combined command (command/server.go:94-107)
— used by tests and chip_smoke.py. `ec_backend` takes a backend name or
a codec instance, as Store does; with "cuda" (and the default "auto")
every volume server's encode and rebuild run the hand-written kernel,
and construction raises without a GPU. `repair_*` configure the
master's redundancy watchdog (with `repair_enabled`, lost replicas and
shards are rebuilt without an operator), `admin_scripts` its
maintenance timer. `stop()` stops both before the volume servers, so
the teardown never reads as lost servers. Not here: filer, S3, broker,
tiering.
"""
from __future__ import annotations

import os
import time

from ..ec.backend import CodecBackend
from ..rpc.http import ServerThread
from ..rpc.httpclient import session
from ..storage.store import Store
from .master_server import MasterServer
from .volume_server import VolumeServer


class Cluster:
    def __init__(self, base_dir: str, n_volume_servers: int = 2,
                 dirs_per_server: int = 1, max_volumes: int = 16,
                 volume_size_limit: int = 1 << 30,
                 default_replication: str = "000",
                 pulse_seconds: float = 0.4,
                 ec_backend: str | CodecBackend = "auto",
                 topology: list[tuple[str, str]] | None = None,
                 disk_types: list[str] | None = None,
                 admin_scripts: list[str] | None = None,
                 admin_script_interval: float = 60.0,
                 repair_enabled: bool = False,
                 repair_interval: float = 10.0,
                 repair_concurrency: int = 2,
                 repair_max_bytes_per_sec: float = 0.0,
                 repair_partial_ec: bool = True,
                 repair_grace: float = 0.0):
        """topology: optional per-server (data_center, rack) labels;
        disk_types: optional per-server disk class (hdd/ssd)."""
        self.base_dir = base_dir
        self.master = MasterServer(
            volume_size_limit=volume_size_limit,
            default_replication=default_replication,
            pulse_seconds=pulse_seconds,
            admin_scripts=admin_scripts,
            admin_script_interval=admin_script_interval,
            repair_enabled=repair_enabled,
            repair_interval=repair_interval,
            repair_concurrency=repair_concurrency,
            repair_max_bytes_per_sec=repair_max_bytes_per_sec,
            repair_partial_ec=repair_partial_ec,
            repair_grace=repair_grace)
        self.master_thread = ServerThread(self.master.app).start()
        self.master.admin_scripts_url = self.master_thread.url
        self.volume_servers: list[VolumeServer] = []
        self.volume_threads: list[ServerThread] = []
        self.stores: list[Store] = []
        try:
            for i in range(n_volume_servers):
                dirs = []
                for d in range(dirs_per_server):
                    path = os.path.join(base_dir, f"vol{i}_{d}")
                    os.makedirs(path, exist_ok=True)
                    dirs.append(path)
                store = Store(dirs, ip="127.0.0.1", port=0,
                              ec_backend=ec_backend)
                for loc in store.locations:
                    loc.max_volumes = max_volumes
                dc, rack = (topology[i] if topology else
                            ("DefaultDataCenter", "DefaultRack"))
                vs = VolumeServer(store, self.master_url, data_center=dc,
                                  rack=rack, pulse_seconds=pulse_seconds,
                                  disk_type=(disk_types[i] if disk_types
                                             and i < len(disk_types)
                                             else "hdd"))
                thread = ServerThread(vs.app).start()
                store.port = thread.port
                store.public_url = thread.address
                self.volume_servers.append(vs)
                self.volume_threads.append(thread)
                self.stores.append(store)
            self.wait_for_nodes(n_volume_servers)
        except BaseException:
            self.stop()
            raise

    @property
    def master_url(self) -> str:
        return self.master_thread.url

    def volume_url(self, i: int) -> str:
        return self.volume_threads[i].url

    def wait_for_nodes(self, n: int, timeout: float = 15.0) -> None:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if len(self.master.topo.nodes) >= n:
                return
            time.sleep(0.05)
        raise TimeoutError(
            f"only {len(self.master.topo.nodes)}/{n} volume servers "
            "registered")

    def wait_for_ec_shards(self, vid: int, min_shards: int = 14,
                           timeout: float = 15.0) -> None:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            shards = self.master.topo.lookup_ec_shards(vid)
            if sum(len(v) for v in shards.values()) >= min_shards:
                return
            time.sleep(0.05)
        raise TimeoutError(f"ec shards of {vid} not fully registered")

    def admin(self, server_i: int, path: str, body: dict) -> dict:
        resp = session().post(f"{self.volume_url(server_i)}{path}",
                              json=body, timeout=120)
        out = resp.json()
        if resp.status_code >= 300:
            raise RuntimeError(f"{path}: {out}")
        return out

    def stop(self) -> None:
        # the watchdog and the admin scripts first: stopping servers
        # under a live watchdog starts repairs against dead ports
        self.master.stop_maintenance()
        for t in self.volume_threads:
            t.stop()
        self.master_thread.stop()
