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
the teardown never reads as lost servers. `with_filer` adds a filer
(`filer_store` memory, sqlite or leveldb; `filer_cipher` for
-encryptVolumeData) and `with_s3` the S3 gateway over it
(`s3_config` its identities), as the reference's harness; the filer
announces itself every pulse, so the master's watchdog and admin
scripts always find it and take its DLM lock.

HA layouts: `n_masters=3` starts three raft masters in the process (on
ports reserve_ports holds listening until they serve, each with its
raft state under `base_dir/raft_<i>`, raft timing scaled by
`raft_tick`), and `external_masters` takes the urls of
masters the caller runs (as processes, say) and starts none. Every
volume server and the filer are then given the whole master list;
`master_url` is the current leader's url and `master_urls` the list,
`leader_index()` names the in-process master that leads, and
`stop_master(i)` stops one as a lost process would. The wait helpers
read the leader over HTTP in every layout; `master` and
`master_thread` exist only for in-process masters.

Spans: a Cluster pushes none. With in-process masters, every
master's tracing sink already sees every span of the process (they
share one ring), so each span reaches the collector once; with
`external_masters`, the caller starts one rpc/trace_push.SpanPusher
for the process, as the CLI does for each server process.

`tier_*` configure the masters' tiering controller (with
`tier_enabled`, idle volumes are sealed into EC, offloaded to
`tier_remote` and recalled on re-access; with several masters each
keeps its state under `tier_state_dir/master_<i>`), and
`tier_backends` the backend storages every volume server can upload a
volume's .dat to (`{"s3.default": {"endpoint": ..., "bucket": ...}}`).
`stop()` stops the controller with the watchdog.

The secured, durable write path: `jwt_secret` is given to the masters
(they sign every assign) and the volume servers (they check every
write and delete by fid); `commit_durability` / `commit_max_delay` /
`commit_max_bytes` set every volume server's ack contract
(storage/commit.py), as in the reference's harness. `tls` maps a role
("master", "filer", "s3") to the SSLContext its listener serves HTTPS
with (utils/tls.py); the volume servers stay plain, as the reference
keeps its blob HTTP, and a client trusts the CA through
REQUESTS_CA_BUNDLE / SSL_CERT_FILE. `qos` is passed to utils/qos.py's
`configure` (the registry is process-wide, as the CLI's -qos.* flags
make it); the S3 circuit breaker's limits arrive through the filer's KV
(`s3/circuit_breaker`), as in the reference.

The native fronts: `s3_native` and `filer_native` (both off by default,
as in the reference) start volume server 0's C++ front
(VolumeServer.enable_native — the S3 and filer fronts append to the
volumes this process's volume front has attached) and then the native
S3 gateway (s3/native_front.py) or filer (filer/native_front.py) front
on the public port, the Python app demoted to a loopback backend it
relays to; `s3_url` and `filer_url` name the fronts, `s3_front` and
`filer_front` are their control planes, and `filer_thread.url` stays
the Python filer. The fronts speak plain HTTP. `start_broker()` adds
an mq broker over the filer (mq/broker.py), registered with the master
as the reference's is; `broker_thread.url` is its address.
"""
from __future__ import annotations

import os
import socket
import ssl
import time

from ..ec.backend import CodecBackend
from ..rpc.http import ServerThread
from ..rpc.httpclient import session
from ..storage.store import Store
from ..wdclient.client import find_leader
from .filer_server import FilerServer
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
                 repair_grace: float = 0.0,
                 with_filer: bool = False,
                 filer_store: str = "memory",
                 filer_cipher: bool = False,
                 with_s3: bool = False,
                 s3_config: dict | None = None,
                 filer_native: bool = False,
                 s3_native: bool = False,
                 n_masters: int = 1,
                 raft_tick: float = 1.0,
                 external_masters: list[str] | None = None,
                 tier_backends: dict[str, dict] | None = None,
                 tier_enabled: bool = False,
                 tier_interval: float = 30.0,
                 tier_concurrency: int = 1,
                 tier_seal_after_idle: float = 3600.0,
                 tier_offload_after_idle: float = 7200.0,
                 tier_recall_reads: int = 3,
                 tier_recall_window: float = 300.0,
                 tier_max_bytes_per_sec: float = 0.0,
                 tier_remote: dict | None = None,
                 tier_state_dir: str = "",
                 jwt_secret: str = "",
                 commit_durability: str = "buffered",
                 commit_max_delay: float = 0.002,
                 commit_max_bytes: int = 4 << 20,
                 tls: dict[str, ssl.SSLContext] | None = None,
                 qos: dict | None = None):
        """topology: optional per-server (data_center, rack) labels;
        disk_types: optional per-server disk class (hdd/ssd)."""
        self.base_dir = base_dir
        tls = tls or {}
        if set(tls) - {"master", "filer", "s3"}:
            raise ValueError(f"tls roles {sorted(tls)}: master, filer or "
                             f"s3 (the volume servers' HTTP stays plain)")
        if (s3_native and "s3" in tls) or (filer_native and "filer" in tls):
            raise ValueError("the native fronts speak plain HTTP")
        if qos:
            from ..utils import qos as _qos

            _qos.configure(**qos)
        self.masters: list[MasterServer] = []
        self.master_threads: list[ServerThread] = []
        self._stopped_masters: set[int] = set()
        self.external_masters = [
            m if m.startswith("http") else f"http://{m}"
            for m in (external_masters or [])]
        kwargs = dict(
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
            repair_grace=repair_grace,
            tier_enabled=tier_enabled,
            tier_interval=tier_interval,
            tier_concurrency=tier_concurrency,
            tier_seal_after_idle=tier_seal_after_idle,
            tier_offload_after_idle=tier_offload_after_idle,
            tier_recall_reads=tier_recall_reads,
            tier_recall_window=tier_recall_window,
            tier_max_bytes_per_sec=tier_max_bytes_per_sec,
            tier_remote=tier_remote,
            jwt_secret=jwt_secret)
        if not self.external_masters:
            # raft peers know every address before any master starts:
            # the masters' ports are held, listening, until they serve
            socks = reserve_ports(n_masters) if n_masters > 1 else [None]
            peers = [f"127.0.0.1:{s.getsockname()[1]}" for s in socks] \
                if n_masters > 1 else None
            for i, sock in enumerate(socks):
                raft = {}
                if peers:
                    raft_dir = os.path.join(base_dir, f"raft_{i}")
                    os.makedirs(raft_dir, exist_ok=True)
                    raft = dict(me=peers[i], peers=peers,
                                raft_state_dir=raft_dir,
                                raft_tick=raft_tick)
                state_dir = tier_state_dir
                if state_dir and peers:
                    state_dir = os.path.join(state_dir, f"master_{i}")
                m = MasterServer(**kwargs, **raft,
                                 tier_state_dir=state_dir)
                t = ServerThread(m.app, sock=sock,
                                 ssl_context=tls.get("master")).start()
                m.admin_scripts_url = t.url
                self.masters.append(m)
                self.master_threads.append(t)
        self.volume_servers: list[VolumeServer] = []
        self.volume_threads: list[ServerThread] = []
        self.stores: list[Store] = []
        self.filer_thread = self.s3_thread = None
        self.s3_front = self.filer_front = None
        self.broker = None
        self.broker_thread: ServerThread | None = None
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
                vs = VolumeServer(store, self.master_urls, data_center=dc,
                                  rack=rack, pulse_seconds=pulse_seconds,
                                  disk_type=(disk_types[i] if disk_types
                                             and i < len(disk_types)
                                             else "hdd"),
                                  tier_backends=tier_backends,
                                  jwt_secret=jwt_secret,
                                  commit_durability=commit_durability,
                                  commit_max_delay=commit_max_delay,
                                  commit_max_bytes=commit_max_bytes)
                if i == 0 and ((s3_native and with_s3) or (
                        filer_native and (with_filer or with_s3))):
                    # the front's port is the store's public one from
                    # the first heartbeat on; the app is its backend
                    (public,) = free_ports(1)
                    store.port = public
                    store.public_url = f"127.0.0.1:{public}"
                    thread = ServerThread(vs.app).start()
                    vs.enable_native(public, thread.port,
                                     listen_ip="127.0.0.1")
                else:
                    thread = ServerThread(vs.app).start()
                    store.port = thread.port
                    store.public_url = thread.address
                self.volume_servers.append(vs)
                self.volume_threads.append(thread)
                self.stores.append(store)
            self.filer: FilerServer | None = None
            self.filer_thread: ServerThread | None = None
            if with_filer or with_s3:
                # distinct path per kind: sqlite wants a FILE, weedkv a
                # DIRECTORY — sharing one name would wedge a base_dir
                # that switches store kinds across restarts
                store_path = ":memory:"
                if filer_store == "sqlite":
                    store_path = os.path.join(base_dir, "filer.db")
                elif filer_store == "leveldb":
                    store_path = os.path.join(base_dir, "filerdb")
                # announce every pulse: the master forgets a member
                # after 3 silent pulses, and a filer it forgot leaves
                # the watchdog with a process-local lock
                self.filer = FilerServer(self.master_urls,
                                         store=filer_store,
                                         store_path=store_path,
                                         cipher=filer_cipher,
                                         announce_pulse=pulse_seconds)
                self.filer_thread = ServerThread(
                    self.filer.app, ssl_context=tls.get("filer")).start()
                self.filer.address = self.filer_thread.address
            self.s3 = None
            self.s3_thread: ServerThread | None = None
            if with_s3:
                from ..s3.server import S3ApiServer

                self.s3 = S3ApiServer(self.filer_url, iam_config=s3_config)
                self.s3_thread = ServerThread(
                    self.s3.app, ssl_context=tls.get("s3")).start()
                if s3_native:
                    from ..s3.native_front import NativeS3Front

                    self.s3_front = NativeS3Front(
                        self.s3, self.filer.filer, self.master_url, 0,
                        self.s3_thread.port)
                    self.s3._native_front = self.s3_front
            if filer_native and self.filer is not None:
                from ..filer.native_front import NativeFilerFront

                self.filer_front = NativeFilerFront(
                    self.filer, self.master_url, 0, self.filer_thread.port)
            self.wait_for_nodes(n_volume_servers)
            if self.filer is not None:
                self.wait_for_filer()
        except BaseException:
            self.stop()
            raise

    def start_broker(self) -> str:
        """Start an in-process mq broker against this cluster's filer.
        -> its url."""
        from ..mq.broker import BrokerServer

        self.broker = BrokerServer(self.filer_url, self.master_url)
        self.broker_thread = ServerThread(self.broker.app).start()
        self.broker.address = self.broker_thread.address
        return self.broker_thread.url

    # -- masters ----------------------------------------------------------
    @property
    def master_urls(self) -> str:
        """Every master, comma-separated (what servers are given)."""
        return ",".join(self.external_masters or
                        [t.url for t in self.master_threads])

    @property
    def master_thread(self) -> ServerThread:
        return self.master_threads[self.leader_index()]

    @property
    def master(self) -> MasterServer:
        """The in-process master that leads (the one master, without
        HA)."""
        return self.masters[self.leader_index()]

    def leader_index(self, timeout: float = 15.0) -> int:
        """Index of the in-process master that leads, once one does."""
        if not self.masters:
            raise RuntimeError("the masters run outside this process "
                               "(external_masters): use master_url")
        if len(self.masters) == 1:
            return 0
        deadline = time.monotonic() + timeout
        while True:
            for i, m in enumerate(self.masters):
                if i not in self._stopped_masters and m.is_leader():
                    return i
            if time.monotonic() > deadline:
                raise TimeoutError("no raft leader among the masters")
            time.sleep(0.02)

    @property
    def master_url(self) -> str:
        """The leading master's url."""
        if not self.external_masters:
            return self.master_thread.url
        deadline = time.monotonic() + 15.0
        while time.monotonic() < deadline:
            leader = find_leader(self.external_masters)
            if leader:
                return leader
            time.sleep(0.05)
        raise TimeoutError("no raft leader among the masters")

    def stop_master(self, i: int) -> None:
        """Stop in-process master i, as a lost process."""
        self._stopped_masters.add(i)
        self.masters[i].stop_maintenance()
        self.master_threads[i].stop()

    def _get(self, path: str, **params) -> dict:
        return session().get(f"{self.master_url}{path}", params=params,
                             timeout=10).json()

    def volume_url(self, i: int) -> str:
        return self.volume_threads[i].url

    def wait_for_nodes(self, n: int, timeout: float = 15.0) -> None:
        deadline = time.monotonic() + timeout
        have = 0
        while time.monotonic() < deadline:
            topo = self._get("/dir/status")["Topology"]
            have = sum(len(r["nodes"]) for dc in topo["datacenters"]
                       for r in dc["racks"])
            if have >= n:
                return
            time.sleep(0.05)
        raise TimeoutError(f"only {have}/{n} volume servers registered")

    def wait_for_ec_shards(self, vid: int, min_shards: int = 14,
                           timeout: float = 15.0) -> None:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            shards = self._get("/cluster/ec_shards", volumeId=vid)["shards"]
            if sum(len(v) for v in shards.values()) >= min_shards:
                return
            time.sleep(0.05)
        raise TimeoutError(f"ec shards of {vid} not fully registered")

    @property
    def filer_url(self) -> str:
        if self.filer_front is not None:
            return f"http://127.0.0.1:{self.filer_front.port}"
        if self.filer_thread is None:
            raise RuntimeError("cluster started without a filer")
        return self.filer_thread.url

    @property
    def s3_url(self) -> str:
        if self.s3_front is not None:
            return f"http://127.0.0.1:{self.s3_front.port}"
        if self.s3_thread is None:
            raise RuntimeError("cluster started without s3")
        return self.s3_thread.url

    def wait_for_filer(self, timeout: float = 15.0) -> None:
        """Until the master lists the filer and its lock ring holds it
        (its first announce), so the admin lock goes through its DLM."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            listed = any(n.get("address") == self.filer.address
                         for n in self._get("/cluster/nodes",
                                            type="filer")["nodes"])
            if listed and self.filer.dlm.ring.servers():
                return
            time.sleep(0.02)
        raise TimeoutError("the filer never announced itself")

    def admin(self, server_i: int, path: str, body: dict) -> dict:
        resp = session().post(f"{self.volume_url(server_i)}{path}",
                              json=body, timeout=120)
        out = resp.json()
        if resp.status_code >= 300:
            raise RuntimeError(f"{path}: {out}")
        return out

    def stop(self) -> None:
        # the watchdog, the tiering controller and the admin scripts
        # first: stopping servers under them starts repairs and
        # transitions against dead ports
        live = [i for i in range(len(self.masters))
                if i not in self._stopped_masters]
        for i in live:
            self.masters[i].stop_maintenance()
        for front in (self.s3_front, self.filer_front):
            if front is not None:
                front.stop()
        for t in (self.broker_thread, self.s3_thread, self.filer_thread):
            if t is not None:
                t.stop()
        for t in self.volume_threads:
            t.stop()
        for i in live:
            self.master_threads[i].stop()


def reserve_ports(n: int) -> list[socket.socket]:
    """n listening localhost sockets on distinct free ports, held until a
    ServerThread serves on each (`ServerThread(app, sock=s)`). A port
    that free_ports probed and closed can be taken before its server
    binds it — by any connection's local port, under a parallel test
    run — and that bind then fails with EADDRINUSE."""
    socks = []
    for _ in range(n):
        s = socket.socket()
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind(("127.0.0.1", 0))
        s.listen(128)
        socks.append(s)
    return socks


def free_ports(n: int) -> list[int]:
    """n distinct free localhost ports, for servers in other processes
    (in-process servers take reserve_ports: a port closed here can be
    taken before its server binds it)."""
    socks = []
    for _ in range(n):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        socks.append(s)
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports
