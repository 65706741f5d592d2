"""Master server: the cluster's control plane over HTTP; the counterpart
of seaweedfs_tpu/server/master_server.py.

Equivalent of SeaweedFS weed/server/master_server.go (HTTP routes
:135-149) and master_grpc_server*.go: /dir/assign (Assign,
master_grpc_server_assign.go:37), /dir/lookup, /vol/grow
(ProcessGrowRequest, master_grpc_server_volume.go:21-77), the
heartbeat (SendHeartbeat, master_grpc_server.go:61), and the status
and EC-registry views the shell reads.

The heartbeat: the reference keeps one websocket per volume server and
unregisters the server when the stream drops. Here every pulse is one
`POST /heartbeat` carrying the same JSON the websocket carried, and the
reply carries what the master sent back on the stream. A server that
stays silent for `Topology.dead_nodes`' timeout (5 pulses) is
unregistered by the reaper thread, in place of the disconnect.

The redundancy watchdog (master/watchdog.py) is poked on every
heartbeat and every unregistration; /debug/repair shows and feeds its
queue, and /cluster/status carries its deficit sets. With
`admin_scripts`, a timer thread runs shell command lines against this
master every `admin_script_interval` seconds (master_server.go:259-308
startAdminScripts). The timer and the watchdog's repairs take the
admin lock through a live filer's DLM (`live_filer_url`, from the
filers' membership announces), so they serialize against operator
shells; without a filer the lock is process-local. /vol/vacuum runs the shell's volume.vacuum; the
vacuum switch is a plain attribute (the reference commits it through
raft).

Single master only. Not here: raft and followers, tiering, the
collector, the workload aggregator, the KeepConnected stream
(`/ws/keepconnected`; clients re-read the EC map by TTL,
wdclient/client.py), traces, metrics federation, JWT signing.
"""
from __future__ import annotations

import json
import secrets
import threading

from ..cluster.membership import ClusterMembership
from ..master.sequence import MemorySequencer
from ..master.topology import (NoFreeSlots, NoWritableVolume, Topology,
                               VolumeInfo)
from ..master.watchdog import JOIN_TIMEOUT, RedundancyWatchdog
from ..rpc.http import (App, Request, Response, debug_index_factory,
                        json_error, json_ok, json_response, text_response)
from ..rpc.httpclient import session
from ..storage import types as t
from ..utils import glog, metrics

# timeout of one /admin/assign_volume call made by /vol/grow
GROW_TIMEOUT = (5.0, 60.0)


class MasterServer:
    def __init__(self, volume_size_limit: int = 30 << 30,
                 default_replication: str = "000",
                 pulse_seconds: float = 5.0,
                 admin_scripts: list[str] | None = None,
                 admin_script_interval: float = 60.0,
                 repair_enabled: bool = False,
                 repair_interval: float = 10.0,
                 repair_concurrency: int = 2,
                 repair_max_attempts: int = 5,
                 repair_grace: float = 0.0,
                 repair_max_bytes_per_sec: float = 0.0,
                 repair_partial_ec: bool = True):
        self.topo = Topology(volume_size_limit, pulse_seconds)
        self.default_replication = default_replication
        self.seq = MemorySequencer()
        self.pulse_seconds = pulse_seconds
        self.vacuum_disabled = False
        self.membership = ClusterMembership(ttl_seconds=pulse_seconds * 3)
        self._grow_lock = threading.Lock()
        self._stop = threading.Event()
        self._reaper: threading.Thread | None = None
        # periodic maintenance scripts: shell command lines run on a
        # timer, e.g. ["volume.vacuum", "volume.fix.replication"].
        # admin_scripts_url is this master's own HTTP address, set by
        # the runner once the listen socket binds.
        self.admin_scripts = admin_scripts or []
        self.admin_script_interval = admin_script_interval
        self.admin_scripts_url = ""
        self.admin_script_runs: list[dict] = []
        self._admin_stop = threading.Event()
        self._admin_thread: threading.Thread | None = None
        # redundancy watchdog: deficit tracking always on, repair
        # driving gated by -repair.enabled (watchdog.py)
        self.watchdog = RedundancyWatchdog(
            self, enabled=repair_enabled, interval=repair_interval,
            concurrency=repair_concurrency,
            max_attempts=repair_max_attempts, grace=repair_grace,
            max_bytes_per_sec=repair_max_bytes_per_sec,
            partial_ec=repair_partial_ec)
        self.app = self._build_app()

    def _build_app(self) -> App:
        app = App()
        app.get("/debug", debug_index_factory("master", {
            "/debug/ec": "EC codec router: probe curve + backends",
            "/debug/repair": "watchdog deficits, queue, history "
                             "(POST enqueues one repair)",
        }))
        app.get("/debug/ec", self.handle_debug_ec)
        app.get("/debug/repair", self.handle_debug_repair)
        app.post("/debug/repair", self.handle_repair_enqueue)
        app.get("/metrics", self.handle_metrics)
        for method in ("GET", "POST"):
            app.route(method, "/dir/assign", self.handle_assign)
            app.route(method, "/vol/grow", self.handle_grow)
        app.get("/dir/lookup", self.handle_lookup)
        app.get("/vol/status", self.handle_vol_status)
        app.get("/dir/status", self.handle_dir_status)
        app.get("/cluster/status", self.handle_cluster_status)
        app.post("/cluster/announce", self.handle_cluster_announce)
        app.get("/cluster/nodes", self.handle_cluster_nodes)
        app.get("/cluster/ec_shards", self.handle_ec_shards)
        app.post("/heartbeat", self.handle_heartbeat)
        for method in ("GET", "POST"):
            app.route(method, "/vol/vacuum", self.handle_vacuum_now)
        app.post("/vol/vacuum/disable", self.handle_vacuum_toggle)
        app.post("/vol/vacuum/enable", self.handle_vacuum_toggle)
        app.on_startup.append(self.start)
        app.on_cleanup.append(self.stop)
        return app

    # ------------------------------------------------------------------
    # liveness: unregister servers whose heartbeats stopped; the
    # watchdog and the admin-scripts timer
    # ------------------------------------------------------------------
    def start(self) -> None:
        self._stop.clear()
        self._reaper = threading.Thread(target=self._reap_loop,
                                        name="master-reaper", daemon=True)
        self._reaper.start()
        self.watchdog.start()
        if self.admin_scripts:
            self._admin_stop.clear()
            self._admin_thread = threading.Thread(
                target=self._admin_scripts_loop, name="admin-scripts",
                daemon=True)
            self._admin_thread.start()

    def stop_maintenance(self) -> None:
        """Stop the watchdog and the admin-scripts timer: what would
        start repairs. A cluster stops these before its volume servers,
        or the teardown itself reads as lost servers."""
        self._admin_stop.set()
        if self._admin_thread is not None:
            self._admin_thread.join(timeout=JOIN_TIMEOUT)
            self._admin_thread = None
        self.watchdog.stop()

    def stop(self) -> None:
        self.stop_maintenance()
        self._stop.set()
        if self._reaper is not None:
            self._reaper.join(timeout=10)
            self._reaper = None

    def _reap_loop(self) -> None:
        while not self._stop.wait(self.pulse_seconds):
            self.reap_dead_nodes()

    def reap_dead_nodes(self) -> list[str]:
        dead = self.topo.dead_nodes()
        for node_id in dead:
            glog.warning("volume server %s silent for 5 pulses: "
                         "unregistered", node_id)
            self.topo.unregister_data_node(node_id)
        if dead:
            self.watchdog.poke()
        return dead

    def live_filer_url(self) -> str:
        """A live filer's url from the membership announces, or "" (the
        admin lock is then process-local, as without a filer)."""
        filers = self.membership.list_nodes("filer")
        return f"http://{filers[0].address}" if filers else ""

    def _admin_scripts_loop(self) -> None:
        from ..shell.env import CommandEnv, ShellError
        from ..shell.repl import run_command

        while not self.admin_scripts_url:
            if self._admin_stop.wait(0.05):
                return
        while not self._admin_stop.wait(self.admin_script_interval):
            # the cluster-wide admin lock lives in the filer DLM: find
            # a live filer so maintenance serializes against operator
            # shells (commands.go:78 confirmIsLocked)
            env = CommandEnv(self.admin_scripts_url,
                             filer_url=self.live_filer_url())
            runs = []
            try:
                try:
                    env.acquire_lock()
                except ShellError:
                    continue        # lock contention: retry next tick
                for line in self.admin_scripts:
                    if self.vacuum_disabled and \
                            line.startswith("volume.vacuum"):
                        runs.append({"script": line, "ok": False,
                                     "error": "vacuum disabled"})
                        continue
                    try:
                        run_command(env, line)
                        runs.append({"script": line, "ok": True})
                    except Exception as e:  # noqa: BLE001 — recorded
                        runs.append({"script": line, "ok": False,
                                     "error": str(e)})
            finally:
                env.close()
            self.admin_script_runs.extend(runs)
            del self.admin_script_runs[:-100]

    # ------------------------------------------------------------------
    # assignment
    # ------------------------------------------------------------------
    def handle_assign(self, req: Request) -> Response:
        q = req.query
        count = int(q.get("count", 1))
        collection = q.get("collection", "")
        replication = q.get("replication") or self.default_replication
        ttl = _parse_ttl(q.get("ttl", ""))
        dc = q.get("dataCenter") or None
        disk = q.get("disk", "")
        try:
            vid, nodes = self.topo.pick_for_write(collection, replication,
                                                  ttl, disk_type=disk,
                                                  preferred_dc=dc or "")
        except NoWritableVolume:
            try:
                self._grow(collection, replication, ttl, dc,
                           disk_type=disk)
            except NoFreeSlots as e:
                return json_error(str(e), status=500)
            try:
                vid, nodes = self.topo.pick_for_write(
                    collection, replication, ttl, disk_type=disk,
                    preferred_dc=dc or "")
            except NoWritableVolume as e:
                return json_error(str(e), status=500)
        key = self.seq.next_ids(count)
        node = nodes[0]
        if dc:
            # the returned upload target must be IN the requested dc
            for cand in nodes:
                if cand.rack.dc.id == dc:
                    node = cand
                    break
        fid = t.format_file_id(vid, key, _new_cookie())
        return json_ok({
            "fid": fid,
            "url": node.url,
            "publicUrl": node.public_url,
            "count": count,
            "replicas": [{"url": n.url, "publicUrl": n.public_url}
                         for n in nodes[1:]],
            "auth": "",
        })

    def handle_lookup(self, req: Request) -> Response:
        vid_s = req.query.get("volumeId", "")
        vid = int(vid_s.split(",")[0]) if vid_s else 0
        nodes = self.topo.lookup(vid)
        if not nodes:
            return json_error(f"volume {vid} not found", status=404)
        return json_ok({
            "volumeId": str(vid),
            "locations": [{"url": n.url, "publicUrl": n.public_url}
                          for n in nodes],
        })

    def handle_grow(self, req: Request) -> Response:
        q = req.query
        count = int(q.get("count", 1))
        collection = q.get("collection", "")
        replication = q.get("replication") or self.default_replication
        ttl = _parse_ttl(q.get("ttl", ""))
        try:
            grown = 0
            for _ in range(count):
                self._grow(collection, replication, ttl,
                           q.get("dataCenter") or None, force=True,
                           disk_type=q.get("disk", ""),
                           rack=q.get("rack") or None,
                           data_node=q.get("dataNode") or None)
                grown += 1
        except NoFreeSlots as e:
            return json_error(str(e), status=500)
        return json_ok({"count": grown})

    def _grow(self, collection: str, replication: str,
              ttl: tuple[int, int], dc: str | None = None,
              force: bool = False, disk_type: str = "",
              rack: str | None = None,
              data_node: str | None = None) -> int:
        """findAndGrow (volume_growth.go:107): pick servers, allocate the
        volume on each over its admin API, let heartbeats register it.
        Without `force`, skips when another waiter already grew the
        layout (the assign-path contention case)."""
        with self._grow_lock:
            if not force:
                try:
                    self.topo.pick_for_write(collection, replication,
                                             ttl, disk_type=disk_type,
                                             preferred_dc=dc or "")
                    return 0
                except NoWritableVolume:
                    pass
            nodes = self.topo.find_empty_slots(replication, dc,
                                               disk_type=disk_type,
                                               preferred_rack=rack,
                                               preferred_node=data_node)
            vid = self.topo.next_volume_id()
            for node in nodes:
                resp = session().post(
                    f"http://{node.url}/admin/assign_volume",
                    json={"volume": vid, "collection": collection,
                          "replication": replication,
                          "ttl": list(bytes(ttl))},
                    timeout=GROW_TIMEOUT)
                if resp.status_code != 200:
                    raise NoFreeSlots(f"allocate volume {vid} on "
                                      f"{node.url}: {resp.text}")
            # optimistic local registration so assigns can proceed
            # before the next heartbeat confirms
            for node in nodes:
                v = VolumeInfo(vid=vid, collection=collection,
                               replica_placement=replication, ttl=ttl)
                node.volumes[vid] = v
                self.topo._register_volume(v, node)
            return vid

    # ------------------------------------------------------------------
    # heartbeat (master_grpc_server.go:61 SendHeartbeat, one pulse)
    # ------------------------------------------------------------------
    def handle_heartbeat(self, req: Request) -> Response:
        hb = req.json()
        node_id = f"{hb['ip']}:{hb['port']}"
        node = self.topo.register_node(
            node_id, hb["ip"], hb["port"],
            hb.get("public_url", node_id),
            hb.get("max_volume_count", 8),
            hb.get("data_center", "DefaultDataCenter"),
            hb.get("rack", "DefaultRack"),
            hb.get("disk_type", "hdd"))
        if "volumes" in hb:
            self.topo.sync_node_volumes(
                node, [VolumeInfo(
                    vid=v["id"], collection=v.get("collection", ""),
                    size=v.get("size", 0),
                    file_count=v.get("file_count", 0),
                    delete_count=v.get("delete_count", 0),
                    deleted_bytes=v.get("deleted_bytes", 0),
                    read_only=v.get("read_only", False),
                    replica_placement=v.get("replica_placement", "000"),
                    ttl=tuple(v.get("ttl", (0, 0))),
                    modified_at=v.get("modified_at", 0),
                    last_read_at=v.get("last_read_at", 0.0),
                    read_count=v.get("read_count", 0),
                ) for v in hb["volumes"]])
        if "ec_shards" in hb:
            self.topo.sync_node_ec_shards(
                node, [(e["id"], e.get("collection", ""),
                        e["shard_bits"], e.get("codec", ""),
                        {"remote": e.get("remote", False),
                         "last_read_at": e.get("last_read_at", 0.0),
                         "read_count": e.get("read_count", 0)})
                       for e in hb["ec_shards"]])
        if "repair_bw" in hb:
            node.repair_bw = hb["repair_bw"]
        self.watchdog.poke()
        return json_ok({"volume_size_limit": self.topo.volume_size_limit,
                        "pulse_seconds": self.pulse_seconds})

    # ------------------------------------------------------------------
    # status / introspection
    # ------------------------------------------------------------------
    def handle_cluster_status(self, req: Request) -> Response:
        wd = self.watchdog
        return json_ok({
            "IsLeader": True,
            "Leader": "",
            "Peers": [],
            "VacuumDisabled": self.vacuum_disabled,
            "Topology": self.topo.to_dict(),
            "EcRouter": _ec_router_snapshot(),
            "UnderReplicated": wd.under_replicated,
            "UnderParity": wd.under_parity,
            "RepairQueueDepth": wd.queue_depth(),
            "RepairEnabled": wd.enabled,
            "RepairMaxBytesPerSec": wd.max_bytes_per_sec,
            "RepairPlacementViolations": wd.placement_violations,
            # per-node repair bucket fill/debt as last heartbeated
            "RepairBandwidth": self._repair_bandwidth(),
        })

    def _repair_bandwidth(self) -> dict:
        with self.topo.lock:
            return {n.url: n.repair_bw
                    for n in self.topo.nodes.values()
                    if n.repair_bw is not None}

    def handle_debug_repair(self, req: Request) -> Response:
        """Watchdog state: deficit sets, queue, in-flight and recent
        repairs."""
        return json_ok(self.watchdog.snapshot())

    def handle_repair_enqueue(self, req: Request) -> Response:
        """Enqueue one repair (scrub wiring + operator hook):
        {"volume": vid, "kind": "replica"|"ec", "reason": "..."}.
        Every malformed input is a 400 with a JSON error — never a 500
        and never a silent accept."""
        try:
            body = json.loads(req.read())
        except ValueError:
            return json_error("repair enqueue body must be JSON",
                              status=400)
        if not isinstance(body, dict):
            return json_error("repair enqueue body must be a JSON "
                              "object", status=400)
        try:
            vid = int(body["volume"])
        except (KeyError, TypeError, ValueError):
            return json_error("repair enqueue requires an integer "
                              "volume id", status=400)
        if vid <= 0:
            return json_error(f"volume id must be positive, got {vid}",
                              status=400)
        kind = body.get("kind", "replica")
        if kind not in ("replica", "ec"):
            return json_error(f"unknown repair kind {kind!r}", status=400)
        accepted = self.watchdog.enqueue(
            vid, kind, str(body.get("reason", "operator")),
            collection=str(body.get("collection", "")))
        return json_ok({"accepted": accepted,
                        "enabled": self.watchdog.enabled})

    def handle_vacuum_now(self, req: Request) -> Response:
        """/vol/vacuum?garbageThreshold=0.3 — the on-demand cluster
        vacuum (master_server.go:141 volumeVacuumHandler): the same
        volume_vacuum the shell verb and the admin scripts run."""
        if self.vacuum_disabled:
            return json_error("vacuum disabled", status=409)
        gc = req.query.get("garbageThreshold", "")
        try:
            threshold = float(gc) if gc else 0.3
        except ValueError:
            return json_error(
                f"garbageThreshold {gc!r} is not a valid float",
                status=406)
        from ..shell.commands_volume import volume_vacuum
        from ..shell.env import CommandEnv, ShellError

        env = CommandEnv(self.admin_scripts_url)
        try:
            results = volume_vacuum(env, garbage_threshold=threshold)
        except ShellError as e:
            # e.g. vacuum disabled between our check and the verb's
            # own re-check: keep the JSON error contract
            return json_error(str(e), status=409)
        finally:
            env.close()
        return json_ok({"garbageThreshold": threshold,
                        "results": results})

    def handle_vacuum_toggle(self, req: Request) -> Response:
        """volume.vacuum.disable / enable (command_volume_vacuum_disable
        .go): a master-side switch the admin scripts and the shell's
        vacuum both consult."""
        self.vacuum_disabled = req.path.endswith("/disable")
        return json_ok({"vacuum_disabled": self.vacuum_disabled})

    def handle_metrics(self, req: Request) -> Response:
        return text_response(metrics.render(),
                             content_type="text/plain; version=0.0.4")

    def handle_cluster_announce(self, req: Request) -> Response:
        """Filer/broker liveness beat (cluster.go membership)."""
        d = req.json()
        address, node_type = d.get("address"), d.get("type")
        if not address or not node_type:
            return json_error("announce requires address and type",
                              status=400)
        if d.get("leave"):
            self.membership.leave(address, node_type)
        else:
            self.membership.announce(address, node_type,
                                     d.get("filerGroup", ""),
                                     d.get("version", ""))
        return json_ok({"ok": True})

    def handle_cluster_nodes(self, req: Request) -> Response:
        node_type = req.query.get("type", "")
        return json_ok({"nodes": self.membership.to_dict(node_type)})

    def handle_dir_status(self, req: Request) -> Response:
        return json_ok({"Topology": self.topo.to_dict()})

    def handle_vol_status(self, req: Request) -> Response:
        return json_ok({"Volumes": self.topo.to_dict()})

    def handle_ec_shards(self, req: Request) -> Response:
        vid = int(req.query.get("volumeId", 0))
        shards = self.topo.lookup_ec_shards(vid)
        return json_ok({
            "volumeId": vid,
            "collection": self.topo.ec_collections.get(vid, ""),
            "codec": self.topo.ec_codecs.get(vid, ""),
            "shards": {str(sid): [n.url for n in nodes]
                       for sid, nodes in shards.items()},
        })

    def handle_debug_ec(self, req: Request) -> Response:
        return json_response(_ec_router_snapshot())


def _ec_router_snapshot() -> dict:
    """EC router state: reads the probe cache only (never triggers a
    sweep from the control plane)."""
    from ..ec import backend as ec_backend

    return ec_backend.probe_snapshot()


def _parse_ttl(s: str) -> tuple[int, int]:
    """'3m'/'4h'/'5d'/'6w'/'7M'/'8y' -> stored (count, unit) pair
    (needle/volume_ttl.go:33)."""
    if not s:
        return (0, 0)
    units = {"m": 1, "h": 2, "d": 3, "w": 4, "M": 5, "y": 6}
    if s[-1].isdigit():
        return (int(s), 1)
    return (int(s[:-1]), units.get(s[-1], 1))


def _new_cookie() -> int:
    return secrets.randbits(32)
