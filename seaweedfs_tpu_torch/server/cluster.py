"""In-process cluster harness: one master and N volume servers on
localhost ephemeral ports, each served from its own thread; the
counterpart of seaweedfs_tpu/server/cluster.py.

The single-host analogue of the reference's docker-compose cluster
fixtures and the `weed server` combined command (command/server.go:94-107)
— used by tests and chip_smoke.py. `ec_backend` takes a backend name or
a codec instance, as Store does; with "cuda" (and the default "auto")
every volume server's encode and rebuild run the hand-written kernel,
and construction raises without a GPU. Not here: filer, S3, broker,
repair, tiering.
"""
from __future__ import annotations

import os
import time

from ..ec.backend import CodecBackend
from ..rpc.http import ServerThread
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
                 disk_types: list[str] | None = None):
        """topology: optional per-server (data_center, rack) labels;
        disk_types: optional per-server disk class (hdd/ssd)."""
        self.base_dir = base_dir
        self.master = MasterServer(volume_size_limit=volume_size_limit,
                                   default_replication=default_replication,
                                   pulse_seconds=pulse_seconds)
        self.master_thread = ServerThread(self.master.app).start()
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

    def wait_for_nodes(self, n: int, timeout: float = 15.0) -> None:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if len(self.master.topo.nodes) >= n:
                return
            time.sleep(0.05)
        raise TimeoutError(
            f"only {len(self.master.topo.nodes)}/{n} volume servers "
            "registered")

    def stop(self) -> None:
        for t in self.volume_threads:
            t.stop()
        self.master_thread.stop()
