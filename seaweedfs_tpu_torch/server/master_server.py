"""Master server: the cluster's control plane over HTTP; the counterpart
of seaweedfs_tpu/server/master_server.py.

Equivalent of SeaweedFS weed/server/master_server.go (HTTP routes
:135-149) and master_grpc_server*.go: /dir/assign (Assign,
master_grpc_server_assign.go:37), /dir/lookup, /vol/grow
(ProcessGrowRequest, master_grpc_server_volume.go:21-77), the
heartbeat (SendHeartbeat, master_grpc_server.go:61), KeepConnected
(/ws/keepconnected, :250-330), and the status and EC-registry views the
shell reads.

The heartbeat is the reference's stream: each volume server holds one
websocket to /ws/heartbeat (rpc/websocket.py) and sends its full report
on it every pulse, or at once when poked; the master answers each with
the volume size limit and its pulse. The server is unregistered the
moment its stream ends, however it ends: a close, a process that died
(its socket closes with it), `stop()`, or no pong to the ping sent
after 30 s of silence (the reference's `WebSocketResponse(heartbeat=30)`).
Where a server reconnects before its old stream's end is seen, only the
stream that last reported for the node unregisters it. KeepConnected
is a websocket too: a full location and EC-shard snapshot on connect,
then deltas on every heartbeat, grow and unregistration.

HA: with `peers`, the masters run raft (master/raft.py) on threads and
the leader alone owns the topology. A follower answers the mutating and
topology routes with a 307 to the leader (503 while none is elected),
ends a heartbeat stream at its first report (the volume server then
finds the leader), and answers KeepConnected with `{"leader": ...}`.
/vol/grow takes a raft barrier and commits the new max volume id before
handing it out; the vacuum switch is committed through the log, so
every master reports it and it survives a failover. `peers` forces the
snowflake sequencer, so needle keys stay unique across failovers.

The redundancy watchdog (master/watchdog.py) is poked on every
heartbeat and every unregistration; /debug/repair shows and feeds its
queue, and /cluster/status carries its deficit sets. With
`admin_scripts`, a timer thread runs shell command lines against this
master every `admin_script_interval` seconds (master_server.go:259-308
startAdminScripts). The timer and the watchdog's repairs take the
admin lock through a live filer's DLM (`live_filer_url`, from the
filers' membership announces), so they serialize against operator
shells; without a filer the lock is process-local. Only the raft
leader runs the admin scripts and drives repairs, and a fresh leader
holds repairs for 5 pulses while the volume servers re-register
(watchdog.py).

The tiering controller (master/tiering.py) moves volumes through hot →
ec → remote → hot: heat bookkeeping always, transitions with
`tier_enabled`; it is poked on every heartbeat and unregistration,
/debug/tiering shows its states and queue (POST forces one
transition), and a fresh leader holds its transitions as the watchdog
holds repairs. The metrics federator (master/collector.py) scrapes
every volume server's and filer's /metrics on a thread; /cluster/metrics
serves the merged, instance-labeled corpus, and /cluster/status folds
the tier states, the `tier_bw` buckets the heartbeats carry and the
scraped `tier_bytes_moved_total` into `Tiering`, and the scrape's
health into `Observability.Federation`.

The observability plane: every route runs behind the tracing, deadline
and fault middlewares (rpc/http.server_middlewares) with the
reference's 1 MiB body cap. The span collector (master/collector.py)
takes pushed span batches at /cluster/traces/push and this process's
own spans through a tracing sink, and serves the stitched traces at
/cluster/traces (`?trace_id=` or `?trace=`, `?format=otlp`); with
`otlp_url` a thread posts settled traces as OTLP/JSON. The workload
aggregator (master/workload.py) ingests the heartbeats' sketches and
serves the distributions and advisors at /debug/workload (POST sets an
operator override). /cluster/status folds the breakers, the workload
and the collector's pushers. /ws/heartbeat records no span: the
reference's one span per stream lasts as long as the stream, and a
middleware's span here would end at the 101. `/` is the reference's
HTML page of the topology.

With `jwt_secret` (`-jwt.secret`) /dir/assign signs each fid it hands
out (utils/security.Guard, jwt.go:30): the reply's `auth` is an HS256
token for that fid, valid 10 s, which the volume servers' guard checks
on the write; without a secret `auth` is "". The qos fold of
/cluster/status (`Qos`: admitted and shed per tenant) reads the
gateways' qos_* counters from the federation scrape.
"""
from __future__ import annotations

import collections
import json
import re
import secrets
import threading
import zlib

from ..cluster.membership import ClusterMembership
from ..master.collector import MetricsFederator, SpanCollector
from ..master.raft import HTTPTransport, RaftNode
from ..master.sequence import MemorySequencer, SnowflakeSequencer
from ..master.topology import (NoFreeSlots, NoWritableVolume, Topology,
                               VolumeInfo)
from ..master.tiering import TieringController
from ..master.watchdog import JOIN_TIMEOUT, RedundancyWatchdog
from ..master.workload import WorkloadAggregator
from ..rpc.http import (App, Request, Response, debug_index_factory,
                        json_error, json_ok, json_response,
                        server_middlewares, text_response)
from ..rpc.httpclient import session
from ..rpc.websocket import WebSocket, upgrade
from ..storage import types as t
from ..utils import glog, metrics, retry, tracing
from ..utils.security import Guard

# timeout of one /admin/assign_volume call made by /vol/grow
GROW_TIMEOUT = (5.0, 60.0)
# KeepConnected messages one subscriber may have waiting; one that falls
# this far behind is dropped, and reconnects for a fresh snapshot
KEEPCONNECTED_BACKLOG = 256
# seconds of a heartbeat stream's silence before the master pings it;
# with no pong in half as long again the stream is dropped (the
# reference's WebSocketResponse(heartbeat=30))
HEARTBEAT_KEEPALIVE = 30.0


class _Subscriber:
    """One KeepConnected stream. Broadcasts only queue here, so the
    heartbeat and grow threads never write to a socket; the
    connection's own thread writes the queue out. A subscriber that
    stops reading blocks only that thread, and once its backlog is full
    its socket is shut down, which ends that write too."""

    def __init__(self, ws: WebSocket):
        self.ws = ws
        self._queue: collections.deque[dict] = collections.deque()
        self._cond = threading.Condition()
        self._ended = False

    def offer(self, msg: dict) -> bool:
        """Queue msg; False once the stream has ended or was dropped."""
        with self._cond:
            if self._ended:
                return False
            if len(self._queue) < KEEPCONNECTED_BACKLOG:
                self._queue.append(msg)
                self._cond.notify()
                return True
            self._ended = True
            self._cond.notify()
        glog.warning("KeepConnected subscriber %d messages behind: "
                     "dropped", KEEPCONNECTED_BACKLOG)
        self.ws.abort()
        return False

    def end(self) -> None:
        with self._cond:
            self._ended = True
            self._cond.notify()

    def run(self) -> None:
        """Write queued messages until the stream ends."""
        while True:
            with self._cond:
                while not self._queue and not self._ended:
                    self._cond.wait()
                if self._ended:
                    return
                msg = self._queue.popleft()
            try:
                self.ws.send_json(msg)
            except OSError:
                return


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
                 repair_partial_ec: bool = True,
                 sequencer: str = "memory",
                 me: str = "",
                 peers: list[str] | None = None,
                 raft_state_dir: str | None = None,
                 raft_tick: float = 1.0,
                 tier_enabled: bool = False,
                 tier_interval: float = 30.0,
                 tier_concurrency: int = 1,
                 tier_seal_after_idle: float = 3600.0,
                 tier_offload_after_idle: float = 7200.0,
                 tier_recall_reads: int = 3,
                 tier_recall_window: float = 300.0,
                 tier_max_attempts: int = 5,
                 tier_max_bytes_per_sec: float = 0.0,
                 tier_remote: dict | None = None,
                 tier_state_dir: str = "",
                 trace_store_size: int = 2048,
                 scrape_interval: float = 10.0,
                 otlp_url: str = "",
                 advisor_seal_quantile: float = 0.95,
                 advisor_demand_quantile: float = 0.9,
                 advisor_headroom: float = 1.5,
                 jwt_secret: str = ""):
        self.topo = Topology(volume_size_limit, pulse_seconds)
        self.guard = Guard(jwt_secret)
        self.default_replication = default_replication
        if sequencer == "memory" and peers:
            # a per-process counter would re-issue, after a failover,
            # keys the old leader already handed out
            sequencer = "snowflake"
        self.seq = (SnowflakeSequencer(node_id=zlib.crc32(me.encode()))
                    if sequencer == "snowflake" else MemorySequencer())
        self.pulse_seconds = pulse_seconds
        self.vacuum_disabled = False
        self.membership = ClusterMembership(ttl_seconds=pulse_seconds * 3)
        self.raft: RaftNode | None = None
        if peers:
            self.raft = RaftNode(me, peers, HTTPTransport(),
                                 state_dir=raft_state_dir, tick=raft_tick,
                                 on_apply=self._on_raft_apply)
        # KeepConnected subscribers
        self._clients: set[_Subscriber] = set()
        self._clients_lock = threading.Lock()
        self._grow_lock = threading.Lock()
        self._stop = threading.Event()
        self._stepdown: threading.Thread | None = None
        # open heartbeat streams -> the thread serving each, and each
        # node's newest stream (only that one unregisters the node)
        self._hb_streams: dict[WebSocket, threading.Thread] = {}
        self._hb_owner: dict[str, WebSocket] = {}
        self._hb_lock = threading.Lock()
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
        # tiering lifecycle controller: heat/tier bookkeeping always
        # on, data movement gated by -tier.enabled (tiering.py)
        self.tiering = TieringController(
            self, enabled=tier_enabled, interval=tier_interval,
            concurrency=tier_concurrency,
            seal_after_idle=tier_seal_after_idle,
            offload_after_idle=tier_offload_after_idle,
            recall_reads=tier_recall_reads,
            recall_window=tier_recall_window,
            max_attempts=tier_max_attempts,
            max_bytes_per_sec=tier_max_bytes_per_sec,
            remote=tier_remote, state_dir=tier_state_dir)
        # cluster observability plane (collector.py): span collector,
        # OTLP export and a scrape thread over every node's /metrics
        self.collector = SpanCollector(max_traces=trace_store_size)
        self.federator = MetricsFederator(self, interval=scrape_interval)
        self.otlp_url = otlp_url
        self._fed_stop = threading.Event()
        self._fed_thread: threading.Thread | None = None
        self._otlp_thread: threading.Thread | None = None
        # workload-characterization plane (workload.py): heartbeat
        # sketch aggregation + recommend-only advisors
        self.workload = WorkloadAggregator(
            self, seal_quantile=advisor_seal_quantile,
            demand_quantile=advisor_demand_quantile,
            headroom=advisor_headroom)
        self.app = self._build_app()

    def _build_app(self) -> App:
        app = App(middlewares=server_middlewares("master"),
                  max_body=1 << 20)
        app.get("/debug", debug_index_factory("master", {
            "/debug/traces": "recent spans recorded in-process",
            "/debug/breakers": "circuit breaker states",
            "/debug/ec": "EC codec router: probe curve + backends",
            "/debug/repair": "watchdog deficits, queue, history "
                             "(POST enqueues one repair)",
            "/debug/tiering": "tier states and transitions (POST "
                              "forces one)",
            "/debug/workload": "heat/demand distributions + "
                               "threshold advisors (POST sets an "
                               "advisor override)",
        }))
        app.get("/debug/traces", tracing.handle_debug_traces)
        app.get("/debug/breakers", retry.handle_debug_breakers)
        app.get("/debug/ec", self.handle_debug_ec)
        app.get("/debug/repair", self.handle_debug_repair)
        app.post("/debug/repair", self.handle_repair_enqueue)
        app.get("/debug/tiering", self.handle_debug_tiering)
        app.post("/debug/tiering", self.handle_tier_enqueue)
        app.get("/debug/workload", self.handle_debug_workload)
        app.post("/debug/workload", self.handle_workload_override)
        app.get("/metrics", self.handle_metrics)
        app.get("/cluster/metrics", self.handle_cluster_metrics)
        app.get("/cluster/traces", self.handle_cluster_traces)
        app.post("/cluster/traces/push", self.handle_cluster_traces_push)
        for method in ("GET", "POST"):
            app.route(method, "/dir/assign", self.handle_assign)
            app.route(method, "/vol/grow", self.handle_grow)
        app.get("/dir/lookup", self.handle_lookup)
        app.get("/cluster/leader", self.handle_cluster_leader)
        app.post("/cluster/raft/add", self.handle_raft_membership)
        app.post("/cluster/raft/remove", self.handle_raft_membership)
        app.get("/ws/keepconnected", self.handle_keepconnected)
        app.get("/vol/status", self.handle_vol_status)
        app.get("/dir/status", self.handle_dir_status)
        app.get("/cluster/status", self.handle_cluster_status)
        app.post("/cluster/announce", self.handle_cluster_announce)
        app.get("/cluster/nodes", self.handle_cluster_nodes)
        app.get("/cluster/ec_shards", self.handle_ec_shards)
        app.get("/ws/heartbeat", self.handle_heartbeat_ws)
        app.get("/", self.handle_ui)
        for method in ("GET", "POST"):
            app.route(method, "/vol/vacuum", self.handle_vacuum_now)
        app.post("/vol/vacuum/disable", self.handle_vacuum_toggle)
        app.post("/vol/vacuum/enable", self.handle_vacuum_toggle)
        if self.raft is not None:
            self.raft.http_routes(app)
        app.on_startup.append(self.start)
        app.on_cleanup.append(self.stop)
        return app

    # ------------------------------------------------------------------
    # leadership (master_server.go:167,219)
    # ------------------------------------------------------------------
    def is_leader(self) -> bool:
        return self.raft is None or self.raft.is_leader()

    def _on_raft_apply(self, cmd: dict) -> None:
        """Committed entries drive the topology's volume-id high-water
        mark on every master (raft_server.go:72); the vacuum switch
        rides the same log. Runs under the raft lock."""
        if cmd.get("op") == "max_volume_id":
            with self.topo.lock:
                self.topo.max_volume_id = max(self.topo.max_volume_id,
                                              int(cmd["value"]))
        elif cmd.get("op") == "vacuum_disabled":
            self.vacuum_disabled = bool(cmd["value"])

    def _leader_redirect(self, req: Request) -> Response | None:
        """None on the leader (or a single master); else a 307 to the
        raft leader, or 503 while none is elected."""
        if self.is_leader():
            return None
        leader = self.raft.leader()
        if not leader or leader == self.raft.me:
            return json_error("no raft leader elected yet", status=503)
        url = f"http://{leader}{req.path}"
        if req.query_string:
            url += f"?{req.query_string}"
        return Response(status=307, headers={"Location": url})

    def handle_cluster_leader(self, req: Request) -> Response:
        """Leadership probe without serializing the topology (what a
        volume server asks before it heartbeats)."""
        return json_ok({
            "IsLeader": self.is_leader(),
            "Leader": (self.raft.leader() or "") if self.raft else "",
        })

    def handle_raft_membership(self, req: Request) -> Response:
        """cluster.raft.add / remove (command_cluster_raft_server_add.go
        / _remove.go): a single-server change committed through the
        log."""
        if self.raft is None:
            return json_error("raft is not enabled on this master",
                              status=400)
        redirect = self._leader_redirect(req)
        if redirect is not None:
            return redirect
        peer = req.query.get("peer", "")
        if not peer:
            return json_error("missing ?peer=host:port", status=400)
        ok = (self.raft.add_peer(peer) if req.path.endswith("/add")
              else self.raft.remove_peer(peer))
        if not ok:
            return json_error("membership change did not commit "
                              "(no quorum or not leader)", status=503)
        return json_ok({"peers": self.raft.peers})

    # ------------------------------------------------------------------
    # lifecycle: the step-down watch, the watchdog and the
    # admin-scripts timer
    # ------------------------------------------------------------------
    def start(self) -> None:
        self._stop.clear()
        if self.raft is not None:
            # the first /cluster/status imports the mesh module (torch
            # under it): seconds holding the GIL, which would starve a
            # leader's heartbeats and depose it. Pay it before joining.
            _ec_router_snapshot()
            self.raft.start()
        self._stepdown = threading.Thread(target=self._stepdown_loop,
                                          name="master-stepdown",
                                          daemon=True)
        self._stepdown.start()
        self.watchdog.start()
        self.tiering.start()
        tracing.add_sink(self._local_span_sink)
        self._fed_stop.clear()
        self._fed_thread = threading.Thread(
            target=self.federator.run, args=(self._fed_stop,),
            name="metrics-federation", daemon=True)
        self._fed_thread.start()
        if self.otlp_url:
            self._otlp_thread = threading.Thread(
                target=self._otlp_push_loop, args=(self._fed_stop,),
                name="otlp-push", daemon=True)
            self._otlp_thread.start()
        if self.admin_scripts:
            self._admin_stop.clear()
            self._admin_thread = threading.Thread(
                target=self._admin_scripts_loop, name="admin-scripts",
                daemon=True)
            self._admin_thread.start()

    def stop_maintenance(self) -> None:
        """Stop the watchdog, the tiering controller and the
        admin-scripts timer: what would start repairs and transitions.
        A cluster stops these before its volume servers, or the
        teardown itself reads as lost servers."""
        self._admin_stop.set()
        if self._admin_thread is not None:
            self._admin_thread.join(timeout=JOIN_TIMEOUT)
            self._admin_thread = None
        self.watchdog.stop()
        self.tiering.stop()

    def stop(self) -> None:
        self.stop_maintenance()
        tracing.remove_sink(self._local_span_sink)
        self._fed_stop.set()
        for th in (self._fed_thread, self._otlp_thread):
            if th is not None:
                th.join(timeout=JOIN_TIMEOUT)
        self._fed_thread = self._otlp_thread = None
        self._stop.set()
        if self._stepdown is not None:
            self._stepdown.join(timeout=10)
            self._stepdown = None
        if self.raft is not None:
            self.raft.stop()
        self._close_clients()
        self._end_heartbeat_streams()

    def _stepdown_loop(self) -> None:
        """Every pulse, a master that is not the leader ends its
        KeepConnected streams, whose clients then find the leader (its
        heartbeat streams end at their next report)."""
        while not self._stop.wait(self.pulse_seconds):
            if not self.is_leader():
                self._close_clients()

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
            if not self.is_leader():
                continue    # only the leader runs maintenance
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
        redir = self._leader_redirect(req)
        if redir is not None:
            return redir
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
            "auth": self.guard.sign(fid),
        })

    def handle_lookup(self, req: Request) -> Response:
        # topology lives on the raft leader; followers redirect
        redir = self._leader_redirect(req)
        if redir is not None:
            return redir
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
        redir = self._leader_redirect(req)
        if redir is not None:
            return redir
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
            if self.raft is not None:
                # a fresh leader applies prior terms' high-water marks
                # before it mints an id, or it could re-issue one
                if not self.raft.barrier():
                    raise NoFreeSlots("raft leader not ready")
            vid = self.topo.next_volume_id()
            if self.raft is not None:
                # the new mark commits on a majority before the id is
                # handed out (raft_server.go:72)
                if not self.raft.propose({"op": "max_volume_id",
                                          "value": vid}):
                    raise NoFreeSlots("lost raft leadership mid-grow")
            for node in nodes:
                # the allocation stays under _grow_lock, as the
                # reference holds its grow lock across the same POST
                # (server/master_server.py:440-475): two grows must not
                # both pick a node's last free slot
                resp = session().post(  # sw-lint: disable=lock-discipline
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
            self._send_to_clients({"updates": {str(vid): [
                {"url": n.url, "publicUrl": n.public_url}
                for n in nodes]}})
            return vid

    # ------------------------------------------------------------------
    # heartbeat (master_grpc_server.go:61 SendHeartbeat): one stream per
    # volume server, unregistered when it ends
    # ------------------------------------------------------------------
    def handle_heartbeat_ws(self, req: Request) -> Response:
        def serve(ws: WebSocket) -> None:
            me = threading.current_thread()
            with self._hb_lock:
                if self._stop.is_set():
                    return          # a stopping master takes no stream
                self._hb_streams[ws] = me
            me.name = "master-heartbeat-stream"
            ws.keepalive(HEARTBEAT_KEEPALIVE)
            node_id = None
            try:
                while True:
                    data = ws.receive()
                    if data is None:
                        break
                    if not isinstance(data, str):
                        continue
                    if not self.is_leader():
                        # only the leader owns topology; dropping the
                        # stream sends the volume server back to
                        # _find_leader
                        break
                    hb = json.loads(data)
                    node_id = f"{hb['ip']}:{hb['port']}"
                    with self._hb_lock:
                        self._hb_owner[node_id] = ws
                    node = self._ingest_heartbeat(node_id, hb)
                    ws.send_json({
                        "volume_size_limit": self.topo.volume_size_limit,
                        "pulse_seconds": self.pulse_seconds,
                    })
                    self._broadcast_node_update(node)
            finally:
                with self._hb_lock:
                    self._hb_streams.pop(ws, None)
                if node_id is not None:
                    self._heartbeat_ended(node_id, ws)
        return upgrade(req, serve)

    def _ingest_heartbeat(self, node_id: str, hb: dict):
        """Register the reporting node and sync what its report holds.
        -> the node."""
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
        # live repair/tier-bucket fill/debt piggybacked on the
        # heartbeat -> visible in /cluster/status per node
        if "repair_bw" in hb:
            node.repair_bw = hb["repair_bw"]
        if "tier_bw" in hb:
            node.tier_bw = hb["tier_bw"]
        # per-volume heat sketches + node byte rates for the workload
        # aggregator (compact encodings; absent with telemetry off)
        if "workload" in hb:
            self.workload.ingest(node_id, hb["workload"])
        self.watchdog.poke()
        self.tiering.poke()
        return node

    def _heartbeat_ended(self, node_id: str, ws: WebSocket) -> None:
        """Unregister node_id as its stream `ws` ends, unless a newer
        stream reports for it."""
        with self._hb_lock:
            if self._hb_owner.get(node_id) is not ws:
                return
            del self._hb_owner[node_id]
        glog.v(1, "heartbeat stream of %s ended: unregistered", node_id)
        self.topo.unregister_data_node(node_id)
        self.workload.forget(node_id)
        self.watchdog.poke()
        self.tiering.poke()
        self._broadcast_all_locations()

    def _end_heartbeat_streams(self) -> None:
        """Abort every heartbeat stream and wait for its thread, which
        unregisters its node on the way out."""
        with self._hb_lock:
            streams = list(self._hb_streams.items())
        for ws, _ in streams:
            ws.abort()
        for _, th in streams:
            if th is not threading.current_thread():
                th.join(timeout=JOIN_TIMEOUT)

    # ------------------------------------------------------------------
    # status / introspection
    # ------------------------------------------------------------------
    def handle_cluster_status(self, req: Request) -> Response:
        wd = self.watchdog
        return json_ok({
            "IsLeader": self.is_leader(),
            "Leader": (self.raft.leader() or "") if self.raft else "",
            "Peers": list(self.raft.peers) if self.raft else [],
            "VacuumDisabled": self.vacuum_disabled,
            "Topology": self.topo.to_dict(),
            "Breakers": retry.breakers_snapshot(),
            "EcRouter": _ec_router_snapshot(),
            "UnderReplicated": wd.under_replicated,
            "UnderParity": wd.under_parity,
            "RepairQueueDepth": wd.queue_depth(),
            "RepairEnabled": wd.enabled,
            "RepairMaxBytesPerSec": wd.max_bytes_per_sec,
            "RepairPlacementViolations": wd.placement_violations,
            # per-node repair bucket fill/debt as last heartbeated
            "RepairBandwidth": self._repair_bandwidth(),
            # tiering lifecycle: per-tier volume counts, queue depth,
            # per-node tier bucket state, cluster-wide bytes moved
            "Tiering": self._tiering_summary(),
            # measured-distribution plane: nodes reporting sketches,
            # tenants seen, and the three advisors' current vs
            # recommended thresholds (detail at /debug/workload)
            "Workload": self.workload.status_fold(),
            "Qos": self._qos_summary(),
            "Observability": {
                **self.collector.observability(),
                "Federation": self.federator.observability(),
            },
        })

    _QOS_SERIES = re.compile(
        r'^(qos_shed_total|qos_admitted_total)\{([^}]*)\}\s+'
        r'([0-9.eE+-]+)\s*$')

    def _qos_summary(self) -> dict:
        """Cluster-wide admit / shed totals per tenant, folded from the
        last federated scrape of each gateway (the master runs no edge
        layer itself: its view is the scraped corpus)."""
        with self.federator._lock:
            texts = [sc["text"] for sc in self.federator._scraped.values()
                     if sc.get("text")]
        admitted: dict[str, float] = {}
        shed: dict[str, dict[str, float]] = {}
        for text in texts:
            for line in text.splitlines():
                m = self._QOS_SERIES.match(line.strip())
                if not m:
                    continue
                fam, rawlab, val = m.groups()
                labels = dict(
                    p.split("=", 1) for p in rawlab.split(",") if "=" in p)
                tenant = labels.get("tenant", "").strip('"')
                if not tenant:
                    continue
                if fam == "qos_admitted_total":
                    admitted[tenant] = admitted.get(tenant, 0) + float(val)
                else:
                    reason = labels.get("reason", "").strip('"')
                    by = shed.setdefault(tenant, {})
                    by[reason] = by.get(reason, 0) + float(val)
        return {"Admitted": admitted, "Shed": shed}

    _TIER_BYTES_SERIES = re.compile(
        r'^tier_bytes_moved_total\{([^}]*)\}\s+([0-9.eE+-]+)\s*$')

    def _tiering_summary(self) -> dict:
        """The /cluster/status tiering fold: controller state plus
        cluster-wide offload/recall byte totals summed from the last
        federated scrape of each volume server (the movement happens
        node-side, so the master's view is the scraped corpus)."""
        snap = self.tiering.snapshot()
        with self.topo.lock:
            tier_bw = {n.url: n.tier_bw
                       for n in self.topo.nodes.values()
                       if n.tier_bw is not None}
        moved: dict[str, float] = {}
        for text in self.federator.scraped_texts():
            for line in text.splitlines():
                m = self._TIER_BYTES_SERIES.match(line.strip())
                if not m:
                    continue
                rawlab, val = m.groups()
                labels = dict(
                    p.split("=", 1) for p in rawlab.split(",") if "=" in p)
                d = labels.get("dir", "").strip('"')
                if d:
                    moved[d] = moved.get(d, 0) + float(val)
        return {
            "Enabled": snap["enabled"],
            "TierCounts": snap["tier_counts"],
            "QueueDepth": snap["queue_depth"],
            "RemoteConfigured": snap["remote_configured"],
            "MaxBytesPerSec": snap["max_bytes_per_sec"],
            "TierBandwidth": tier_bw,
            "BytesMoved": moved,
        }

    def _self_instance(self) -> str:
        """This master's instance label (host:port once the runner has
        bound the listen socket, a stable placeholder before that)."""
        url = self.admin_scripts_url
        if url:
            return url.split("://", 1)[-1].rstrip("/")
        return "master"

    def _local_span_sink(self, rec: dict) -> None:
        """tracing sink: the master's own spans feed the collector
        in-process (same sampling verdict as remote pushers). In an
        in-process cluster every server's span arrives here once, and
        nothing pushes it a second time."""
        if not tracing.sample_decision(rec.get("trace_id", "")):
            return
        self.collector.add_spans(self._self_instance(),
                                 rec.get("service") or "master", [rec])

    def _otlp_push_loop(self, stop: threading.Event) -> None:
        """-trace.otlpUrl: POST OTLP/JSON batches of settled traces to
        an external collector (Jaeger/Tempo OTLP HTTP endpoint)."""
        url = self.otlp_url
        if not url.startswith("http"):
            url = "http://" + url
        while not stop.wait(5.0):
            ids = self.collector.drain_otlp_pending()
            if not ids:
                continue
            payload = self.collector.to_otlp(trace_ids=ids)
            n_spans = sum(len(ss["spans"])
                          for rs in payload["resourceSpans"]
                          for ss in rs["scopeSpans"])
            try:
                r = session().post(
                    url, json=payload,
                    headers={"Content-Type": "application/json"},
                    timeout=(5.0, 10.0))
                if r.status_code < 300:
                    metrics.counter_add("otlp_spans_exported_total",
                                        n_spans)
                else:
                    metrics.counter_add("otlp_export_failures_total", 1)
            except Exception as e:  # noqa: BLE001 — the loop goes on
                metrics.counter_add("otlp_export_failures_total", 1)
                glog.v(2, "otlp export to %s failed: %s", url, e)

    def handle_cluster_traces(self, req: Request) -> Response:
        """GET /cluster/traces — cross-process trace store.
        ?trace_id= (alias ?trace=) for one stitched tree,
        ?format=otlp for OTLP/JSON, ?limit= for the list size."""
        try:
            limit = int(req.query.get("limit", "50"))
        except ValueError:
            limit = 50
        trace_id = req.query.get("trace_id", "") or \
            req.query.get("trace", "")
        if req.query.get("format") == "otlp":
            ids = [trace_id] if trace_id else None
            return json_response(
                self.collector.to_otlp(trace_ids=ids, limit=limit))
        if trace_id:
            tree = self.collector.get_trace(trace_id)
            if tree is None:
                return json_error(f"trace {trace_id} not found",
                                  status=404)
            return json_response(tree)
        return json_response(
            {"traces": self.collector.list_traces(limit=limit),
             "observability": self.collector.observability()})

    def handle_cluster_traces_push(self, req: Request) -> Response:
        """POST /cluster/traces/push — one SpanPusher batch:
        {"instance", "service", "spans": [...], "dropped": n}."""
        try:
            d = req.json()
        except Exception:
            return json_error("push body must be JSON", status=400)
        spans = d.get("spans")
        if not isinstance(spans, list):
            return json_error("push requires a spans list", status=400)
        accepted = self.collector.add_spans(
            str(d.get("instance") or req.remote or "unknown"),
            str(d.get("service") or "unknown"),
            [s for s in spans if isinstance(s, dict)],
            dropped=int(d.get("dropped") or 0))
        return json_ok({"accepted": accepted})

    def handle_debug_workload(self, req: Request) -> Response:
        """GET /debug/workload — cluster heat/demand distributions,
        per-node provenance, tenant demand and the three advisors."""
        return json_ok(self.workload.snapshot())

    def handle_workload_override(self, req: Request) -> Response:
        """POST /debug/workload — set/clear one advisor override:
        {"advisor": "seal"|"qos"|"repair", "override": number|null,
        "tenant": "..." (qos only)}. Malformed input is always a 400
        with a JSON error."""
        redir = self._leader_redirect(req)
        if redir is not None:
            return redir
        try:
            body = req.json()
        except Exception:
            return json_error("workload override body must be JSON",
                              status=400)
        if not isinstance(body, dict):
            return json_error("workload override body must be a JSON "
                              "object", status=400)
        if "advisor" not in body:
            return json_error("workload override requires an "
                              "'advisor' field", status=400)
        if "override" not in body:
            return json_error("workload override requires an "
                              "'override' field (number or null)",
                              status=400)
        try:
            out = self.workload.set_override(
                str(body["advisor"]), body["override"],
                tenant=str(body.get("tenant", "")))
        except ValueError as e:
            return json_error(str(e), status=400)
        return json_ok(out)

    def handle_cluster_metrics(self, req: Request) -> Response:
        """GET /cluster/metrics — the federated, instance-labeled
        exposition of every registered node plus this master."""
        # first-hit freshness: a target the loop has not scraped yet
        # gets one sweep now, so a new node shows up immediately
        if self.federator.missing():
            self.federator.scrape_once()
        # the merged corpus embeds this master's own registry render:
        # refresh the workload_* gauges first, as handle_metrics does
        self.workload.export_gauges()
        return text_response(
            self.federator.merged(self_instance=self._self_instance()),
            content_type="text/plain")

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
        redir = self._leader_redirect(req)
        if redir is not None:
            return redir
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

    def handle_debug_tiering(self, req: Request) -> Response:
        """Tiering controller state: per-volume tier states, pending
        wants, in-flight transitions and recent results."""
        return json_ok(self.tiering.snapshot())

    def handle_tier_enqueue(self, req: Request) -> Response:
        """Operator hook: force one tier transition.
        {"volume": vid, "transition": "seal"|"offload"|"recall"}.
        Malformed input is always a 400 with a JSON error."""
        redir = self._leader_redirect(req)
        if redir is not None:
            return redir
        try:
            body = json.loads(req.read())
        except ValueError:
            return json_error("tiering enqueue body must be JSON",
                              status=400)
        if not isinstance(body, dict):
            return json_error("tiering enqueue body must be a JSON "
                              "object", status=400)
        try:
            vid = int(body["volume"])
        except (KeyError, TypeError, ValueError):
            return json_error("tiering enqueue requires an integer "
                              "volume id", status=400)
        if vid <= 0:
            return json_error(f"volume id must be positive, got {vid}",
                              status=400)
        try:
            accepted = self.tiering.enqueue(
                vid, str(body.get("transition", "")),
                reason=str(body.get("reason", "operator")),
                collection=str(body.get("collection", "")))
        except ValueError as e:
            return json_error(str(e), status=400)
        return json_ok({"accepted": accepted,
                        "enabled": self.tiering.enabled})

    def handle_vacuum_now(self, req: Request) -> Response:
        """/vol/vacuum?garbageThreshold=0.3 — the on-demand cluster
        vacuum (master_server.go:141 volumeVacuumHandler): the same
        volume_vacuum the shell verb and the admin scripts run."""
        redir = self._leader_redirect(req)
        if redir is not None:
            return redir
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
        vacuum both consult; with raft it is committed through the
        log."""
        redir = self._leader_redirect(req)
        if redir is not None:
            return redir
        disabled = req.path.endswith("/disable")
        if self.raft is not None:
            if not self.raft.propose({"op": "vacuum_disabled",
                                      "value": disabled}):
                return json_error("vacuum toggle did not commit "
                                  "(no quorum)", status=503)
        else:
            self.vacuum_disabled = disabled
        return json_ok({"vacuum_disabled": self.vacuum_disabled})

    def handle_metrics(self, req: Request) -> Response:
        # workload distributions + advisor gauges refresh per scrape
        self.workload.export_gauges()
        return text_response(metrics.render(),
                             content_type="text/plain; version=0.0.4")

    def handle_cluster_announce(self, req: Request) -> Response:
        """Filer/broker liveness beat (cluster.go membership)."""
        redir = self._leader_redirect(req)
        if redir is not None:
            return redir
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
        redir = self._leader_redirect(req)
        if redir is not None:
            return redir
        node_type = req.query.get("type", "")
        return json_ok({"nodes": self.membership.to_dict(node_type)})

    def handle_dir_status(self, req: Request) -> Response:
        return json_ok({"Topology": self.topo.to_dict()})

    def handle_vol_status(self, req: Request) -> Response:
        return json_ok({"Volumes": self.topo.to_dict()})

    def handle_ec_shards(self, req: Request) -> Response:
        # the EC registry lives on the leader, as /dir/lookup's map
        redir = self._leader_redirect(req)
        if redir is not None:
            return redir
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

    # ------------------------------------------------------------------
    # KeepConnected (master_grpc_server.go:250): a full snapshot on
    # connect, location and EC deltas after
    # ------------------------------------------------------------------
    def handle_keepconnected(self, req: Request) -> Response:
        def serve(ws: WebSocket) -> None:
            if not self.is_leader():
                ws.send_json({"leader": self.raft.leader() or ""})
                return
            sub = _Subscriber(ws)
            with self._clients_lock:
                self._clients.add(sub)
            # registered first: a delta queued before the snapshot is
            # one the snapshot already holds
            sub.offer({"snapshot": self._location_snapshot(),
                       "ec_snapshot": self._ec_shard_snapshot()})

            def read() -> None:
                while ws.receive() is not None:
                    pass
                sub.end()

            threading.Thread(target=read, name="keepconnected-read",
                             daemon=True).start()
            try:
                sub.run()
            finally:
                with self._clients_lock:
                    self._clients.discard(sub)
        return upgrade(req, serve)

    def _location_snapshot(self) -> dict:
        out: dict[str, list[dict]] = {}
        with self.topo.lock:
            for layout in self.topo.layouts.values():
                for vid, nodes in layout.locations.items():
                    out[str(vid)] = [
                        {"url": n.url, "publicUrl": n.public_url}
                        for n in nodes]
            for vid in self.topo.ec_locations:
                out[str(vid)] = [
                    {"url": n.url, "publicUrl": n.public_url, "ec": True}
                    for n in self.topo.lookup(vid)]
        return out

    def _ec_shard_snapshot(self) -> dict:
        """{vid: {sid: [urls]}}: the per-shard map clients cache
        (vid_map.go:169-236 ecVidMap)."""
        out: dict[str, dict] = {}
        with self.topo.lock:
            for vid in self.topo.ec_locations:
                out[str(vid)] = {
                    str(sid): [n.url for n in nodes]
                    for sid, nodes in self.topo.lookup_ec_shards(vid)
                    .items()}
        return out

    def _broadcast_node_update(self, node) -> None:
        if not self._clients:
            return
        updates: dict = {}
        ec_updates: dict = {}
        with self.topo.lock:
            for vid in node.volumes:
                updates[str(vid)] = [
                    {"url": n.url, "publicUrl": n.public_url}
                    for n in self.topo.lookup(vid)]
            for vid in node.ec_shards:
                updates[str(vid)] = [
                    {"url": n.url, "publicUrl": n.public_url, "ec": True}
                    for n in self.topo.lookup(vid)]
                ec_updates[str(vid)] = {
                    str(sid): [n.url for n in nodes]
                    for sid, nodes in self.topo.lookup_ec_shards(vid)
                    .items()}
        if updates or ec_updates:
            msg: dict = {"updates": updates}
            if ec_updates:
                msg["ec_updates"] = ec_updates
            self._send_to_clients(msg)

    def _broadcast_all_locations(self) -> None:
        if self._clients:
            self._send_to_clients({
                "snapshot": self._location_snapshot(),
                "ec_snapshot": self._ec_shard_snapshot()})

    def _send_to_clients(self, msg: dict) -> None:
        with self._clients_lock:
            subs = list(self._clients)
        for sub in subs:
            if not sub.offer(msg):
                with self._clients_lock:
                    self._clients.discard(sub)

    def _close_clients(self) -> None:
        with self._clients_lock:
            subs, self._clients = list(self._clients), set()
        for sub in subs:
            sub.end()

    def handle_ui(self, req: Request) -> Response:
        """The status page (master_ui/templates.go): the node count,
        the max volume id and the topology as JSON."""
        topo = self.topo.to_dict()
        n_nodes = sum(len(r["nodes"]) for dc in topo["datacenters"]
                      for r in dc["racks"])
        return text_response(
            f"<html><body><h1>seaweedfs-tpu master</h1>"
            f"<p>nodes: {n_nodes}, max volume id: "
            f"{topo['max_volume_id']}</p>"
            f"<pre>{json.dumps(topo, indent=2)}</pre></body></html>",
            content_type="text/html; charset=utf-8")


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
