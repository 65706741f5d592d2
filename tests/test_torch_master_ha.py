"""HA masters on the port: raft over HTTP, the leader proxy, a failover
with EC under the watchdog, and the two traps of a failover, each held
against the JAX package (tolerance 0).

* The four cases of tests/test_master_ha.py against three port masters
  (tests/torch_port_cases.py rebinds them): one leader, a follower's
  307 for /dir/assign and /dir/lookup, the max volume id on every
  master.
* TestRaftMembership (tests/test_shell_ext.py) on port masters, driven
  by the reference's shell and by the port's: cluster.raft.add /
  remove through the log, and the vacuum switch committed through it.
* A failover with EC on the CPU (CudaCodec(device="cpu"), the kernel's
  plain version): three raft masters, five volume servers over three
  racks, a filer, the watchdog's repairs on at grace 0. The leader is
  stopped; a new one leads, every heartbeat re-homes there, the EC
  registry is whole again, the fresh leader queues no repair; then a
  lost volume server's shards are rebuilt by the new leader's watchdog,
  sha256-equal; a grown vid is above every earlier one and no fid key
  repeats across the failover.
* A leader cut off from the other masters but not from the volume
  servers: it steps down, every server re-homes to the leader the
  others elected, and that leader finds the EC volume whole and queues
  no repair.
* The fresh-leader trap: a leader whose topology holds only some of an
  EC volume's servers sees a recoverable deficit. The reference's
  watchdog queues the rebuild of shards that are not lost; the port's
  holds repairs for 5 pulses since it took
  leadership, and queues the rebuild once the window has passed.
* The snowflake batch: a batch of 128 keys that starts near the end of
  a millisecond's 4096 sequences. The reference's keys run into the
  node-id bits; the port's stay inside this node's field. Batches that
  fit give the same ids on both.

Every wait polls for the state it asserts, up to a deadline.
"""
import errno
import hashlib
import os
import socket
import time
import types
import zlib

import numpy as np
import pytest
import requests

from seaweedfs_tpu.master import sequence as ref_sequence
from seaweedfs_tpu.master import topology as ref_topology
from seaweedfs_tpu.master import watchdog as ref_watchdog
from seaweedfs_tpu.shell import commands_cluster as ref_commands_cluster
from seaweedfs_tpu.shell.env import CommandEnv as RefCommandEnv
from seaweedfs_tpu_torch.master import sequence as port_sequence
from seaweedfs_tpu_torch.master.raft import Transport
from seaweedfs_tpu_torch.master import topology as port_topology
from seaweedfs_tpu_torch.master import watchdog as port_watchdog
from seaweedfs_tpu_torch.operation import verbs
from seaweedfs_tpu_torch.ops.codec_cuda import CudaCodec
from seaweedfs_tpu_torch.rpc.http import ServerThread
from seaweedfs_tpu_torch.rpc.httpclient import session
from seaweedfs_tpu_torch.server import cluster as cluster_mod
from seaweedfs_tpu_torch.server.cluster import (Cluster, free_ports,
                                                reserve_ports)
from seaweedfs_tpu_torch.server.master_server import MasterServer
from seaweedfs_tpu_torch.server.volume_server import VolumeServer
from seaweedfs_tpu_torch.shell import commands_cluster, repl
from seaweedfs_tpu_torch.shell.env import CommandEnv
from seaweedfs_tpu_torch.storage import types as t
from seaweedfs_tpu_torch.storage.store import Store

from tests import test_master_ha as ref_ha_cases
from tests.torch_port_cases import call_case, port_cases

SEED = 20261017
TOPOLOGY = [("dc1", "rA"), ("dc1", "rA"), ("dc1", "rB"), ("dc1", "rB"),
            ("dc1", "rC")]
PULSE = 0.3
# raft timing: an election window of uniform(0.15, 0.3) * 2 s. The
# reference's tests use 0.6 (90-180 ms), which the heartbeats of three
# masters sharing one loaded test process can miss, and an unasked
# re-election then moves the leader under a test
RAFT_TICK = 2.0


def _wait(pred, timeout=20.0, msg="condition", step=0.05):
    end = time.monotonic() + timeout
    while True:
        out = pred()
        if out:
            return out
        if time.monotonic() > end:
            raise AssertionError(f"timed out waiting for {msg}")
        time.sleep(step)


def _stable_leader(peers) -> str | None:
    states = []
    for p in peers:
        try:
            states.append(session().get(f"http://{p}/raft/status",
                                        timeout=2).json())
        except OSError:
            states.append(None)
    # every master names it (a follower that has not heard the leader
    # yet would answer 503 to a redirected request)
    leaders = [s["me"] for s in states if s and s["state"] == "leader"]
    if len(leaders) == 1 and all(s and s["leader"] == leaders[0]
                                 for s in states):
        return leaders[0]
    return None


# ----------------------------------------------------------------------
# tests/test_master_ha.py's cases on three port masters
# ----------------------------------------------------------------------
HA_CASES = port_cases(ref_ha_cases)


@pytest.fixture(scope="module")
def ha(tmp_path_factory):
    """The reference fixture's layout with the port's servers: three
    raft masters and one volume server heartbeating at the leader."""
    base = tmp_path_factory.mktemp("ha")
    socks = reserve_ports(3)
    peers = [f"127.0.0.1:{s.getsockname()[1]}" for s in socks]
    masters, threads = [], []
    vt = None
    try:
        for me, sock in zip(peers, socks):
            m = MasterServer(pulse_seconds=0.4, me=me, peers=peers,
                             raft_state_dir=str(base), raft_tick=RAFT_TICK)
            masters.append(m)
            threads.append(ServerThread(m.app, sock=sock).start())
        leader = _wait(lambda: _stable_leader(peers), msg="a stable leader")
        vol_dir = os.path.join(str(base), "vol0")
        os.makedirs(vol_dir, exist_ok=True)
        store = Store([vol_dir], ip="127.0.0.1", port=0,
                      ec_backend="numpy")
        vs = VolumeServer(store, f"http://{leader}", pulse_seconds=0.3)
        vt = ServerThread(vs.app).start()
        store.port = vt.port
        store.public_url = vt.address
        lead = masters[peers.index(leader)]
        _wait(lambda: len(lead.topo.nodes) >= 1, msg="the volume server")
        yield {"peers": peers, "leader": leader, "masters": masters}
    finally:
        for th in threads:
            th.stop()
        if vt is not None:
            vt.stop()


@pytest.mark.parametrize("case", list(HA_CASES))
def test_master_ha_cases_on_the_port(case, ha):
    call_case(HA_CASES[case], {"ha": ha})


# ----------------------------------------------------------------------
# TestRaftMembership with both shells
# ----------------------------------------------------------------------
@pytest.mark.parametrize("shell", ["reference", "port"])
def test_raft_membership_round_trip(tmp_path, shell):
    cmds, env_cls = ((ref_commands_cluster, RefCommandEnv)
                     if shell == "reference"
                     else (commands_cluster, CommandEnv))
    socks = reserve_ports(3)
    peers = [f"127.0.0.1:{s.getsockname()[1]}" for s in socks]
    masters = [MasterServer(pulse_seconds=0.4, me=me, peers=peers,
                            raft_state_dir=str(tmp_path), raft_tick=RAFT_TICK)
               for me in peers]
    threads = [ServerThread(m.app, sock=s).start()
               for m, s in zip(masters, socks)]
    try:
        leader = _wait(lambda: _stable_leader(peers), msg="a leader")
        follower = next(p for p in peers if p != leader)
        # the shell is pointed at a follower: the change is 307'd
        e = env_cls(f"http://{follower}")
        e.locked = True  # no filer DLM in this layout
        new = "127.0.0.1:59999"
        out = cmds.cluster_raft_change(e, new, add=True)
        assert new in out["peers"]
        _wait(lambda: new in requests.get(f"http://{follower}/raft/status",
                                          timeout=2).json()["peers"],
              10, "the added peer on a follower")
        out = cmds.cluster_raft_change(e, new, add=False)
        assert new not in out["peers"]
        leader = _wait(lambda: _stable_leader(peers), msg="a leader")
        ps = cmds.cluster_raft_ps(env_cls(f"http://{leader}"))
        assert sorted(p["address"] for p in ps["peers"]) == \
            sorted(p for p in peers if p != leader)
        # the vacuum switch rides the log
        r = requests.post(f"http://{leader}/vol/vacuum/disable", timeout=10)
        assert r.json()["vacuum_disabled"] is True
        _wait(lambda: requests.get(f"http://{follower}/cluster/status",
                                   timeout=2).json()["VacuumDisabled"],
              10, "VacuumDisabled on a follower")
        r = requests.post(f"http://{follower}/vol/vacuum/enable",
                          timeout=10)
        assert r.history and r.json()["vacuum_disabled"] is False
        _wait(lambda: not any(m.vacuum_disabled for m in masters), 10,
              "vacuum enabled everywhere")
    finally:
        for th in threads:
            th.stop()


# ----------------------------------------------------------------------
# the masters' ports: taken between the probe and the bind
# ----------------------------------------------------------------------
def _take(port: int) -> socket.socket:
    """Bind a port as another process's connection would hold it as its
    local port (no SO_REUSEADDR)."""
    s = socket.socket()
    s.bind(("127.0.0.1", port))
    return s


def test_a_port_taken_after_free_ports_fails_the_masters_bind():
    """The collision: free_ports closes its probe, another socket takes
    the port, and the master's server cannot bind it."""
    (port,) = free_ports(1)
    thief = _take(port)
    try:
        with pytest.raises(OSError) as ei:
            ServerThread(MasterServer(pulse_seconds=0.4).app,
                         port=port).start()
        assert ei.value.errno == errno.EADDRINUSE
    finally:
        thief.close()


def test_cluster_holds_its_masters_ports_until_they_serve(tmp_path,
                                                         monkeypatch):
    """Cluster(n_masters=3) reserves listening sockets: a socket that
    tries to take one of them after the reservation is refused, and each
    master serves on its reserved port."""
    refused = []

    def reserve_then_race(n):
        socks = reserve_ports(n)
        for s in socks:
            with pytest.raises(OSError) as ei:
                _take(s.getsockname()[1])
            refused.append((s.getsockname()[1], ei.value.errno))
        return socks

    monkeypatch.setattr(cluster_mod, "reserve_ports", reserve_then_race)
    c = Cluster(str(tmp_path), n_volume_servers=1, n_masters=3,
                ec_backend="numpy", raft_tick=RAFT_TICK)
    try:
        assert [e for _, e in refused] == [errno.EADDRINUSE] * 3
        assert [t.port for t in c.master_threads] == [p for p, _ in refused]
        leader = _wait(lambda: _stable_leader(
            [t.address for t in c.master_threads]), msg="a leader")
        assert leader in [t.address for t in c.master_threads]
    finally:
        c.stop()


# ----------------------------------------------------------------------
# a failover with EC under the watchdog
# ----------------------------------------------------------------------
def _key(fid: str) -> int:
    return t.parse_file_id(fid)[1]


def _shard_digests(c, env, vid):
    by_url = {f"{s.ip}:{s.port}": s for s in c.stores}
    out = {}
    for sid, urls in env.ec_shard_locations(vid).items():
        shard = by_url[urls[0]].ec_volumes[vid].shards[sid]
        with open(shard.path, "rb") as f:
            out[sid] = hashlib.sha256(f.read()).hexdigest()
    return out


@pytest.fixture(scope="module")
def failover(tmp_path_factory):
    """Runs the failover once; the tests read its record."""
    c = Cluster(str(tmp_path_factory.mktemp("failover")),
                n_volume_servers=len(TOPOLOGY), max_volumes=8,
                volume_size_limit=8 << 20, pulse_seconds=PULSE,
                topology=TOPOLOGY, repair_enabled=True, repair_interval=0.5,
                repair_grace=0.0, ec_backend=CudaCodec(device="cpu"),
                with_filer=True, n_masters=3, raft_tick=RAFT_TICK)
    rec = {"cluster": c}
    env = None
    try:
        old = c.leader_index()
        rec["old_leader"] = c.master_threads[old].address
        urls = [th.url for th in c.master_threads]
        follower = urls[(old + 1) % 3]
        # a master list with a follower first; assigns 307 to the leader
        env = CommandEnv(",".join([follower] + urls),
                         filer_url=c.filer_url)
        rng = np.random.default_rng(SEED)
        grown = session().get(f"{follower}/vol/grow",
                              params={"collection": "ha"}, timeout=30)
        assert grown.history and grown.json()["count"] == 1
        live = {}
        for _ in range(60):
            a = verbs.assign(follower, collection="ha")
            data = rng.bytes(int(rng.integers(1 << 10, 64 << 10)))
            verbs.upload(a, data)
            live[a.fid] = data
        vid = int(next(iter(live)).split(",")[0])
        assert {int(f.split(",")[0]) for f in live} == {vid}
        rec["vid"], rec["live"] = vid, live
        rec["before_keys"] = [_key(f) for f in live]
        rec["vids_before"] = c.masters[old].topo.max_volume_id
        assert repl.run_command(env, "lock") == "locked"
        repl.run_command(env, f"ec.encode -volumeId={vid}")
        assert repl.run_command(env, "unlock") == "unlocked"
        _wait(lambda: len(env.ec_shard_locations(vid)) == 14,
              msg="14 shards registered")
        rec["digests"] = _shard_digests(c, env, vid)

        # the leader is lost
        t_kill = time.monotonic()
        c.stop_master(old)
        new = c.leader_index()
        rec["new_leader"] = c.master_threads[new].address
        rec["failover_s"] = time.monotonic() - t_kill
        lead = c.masters[new]
        repairs = []

        def whole():
            snap = lead.watchdog.snapshot()
            repairs.extend(snap["recent"] + snap["in_flight"])
            if snap["queue_depth"]:
                repairs.append({"queued": snap["queue_depth"]})
            return len(lead.topo.nodes) == len(TOPOLOGY) and sum(
                len(n) for n in lead.topo.lookup_ec_shards(vid).values()) \
                == 14

        _wait(whole, msg="the new leader's registry whole")
        rec["registered_s"] = time.monotonic() - t_kill
        # and through the rest of its repair hold
        _wait(lambda: whole() and lead.watchdog.repair_hold() == 0,
              msg="the hold passed")
        time.sleep(1.0)         # two scans of the watchdog after it
        whole()
        rec["fresh_repairs"] = repairs
        rec["homes"] = {vs.master_url for vs in c.volume_servers}

        # a volume server lost under the new leader
        held = {}
        for sid, hosts in env.ec_shard_locations(vid).items():
            held.setdefault(hosts[0], []).append(sid)
        victim = min(held, key=lambda u: (len(held[u]), u))
        rec["lost"] = sorted(held[victim])
        index = {f"{s.ip}:{s.port}": i for i, s in enumerate(c.stores)}
        c.volume_threads[index[victim]].stop()
        _wait(lambda: any(e["volume"] == vid for e in
                          env.master_get("/cluster/status")["UnderParity"]),
              msg="the deficit")
        _wait(lambda: not env.master_get("/cluster/status")["UnderParity"]
              and len(env.ec_shard_locations(vid)) == 14,
              timeout=60, msg="14 live shards again")
        rec["heal"] = _wait(
            lambda: [r for r in env.master_get("/debug/repair")["recent"]
                     if r["ok"] and r["volume"] == vid], msg="the result")
        rec["healed_digests"] = _shard_digests(c, env, vid)
        # through a list that still names the dead leader first
        reader = CommandEnv(",".join(
            [urls[old]] + [u for u in urls if u != urls[old]]))
        holder = reader.volume_locations(vid)
        rec["reads"] = {fid: session().get(f"http://{holder[0]}/{fid}",
                                           timeout=30).content
                        for fid in live}
        after = [verbs.assign(c.master_url, collection="ha")
                 for _ in range(20)]
        rec["after_keys"] = [_key(a.fid) for a in after]
        rec["grown"] = session().get(f"{c.master_url}/vol/grow",
                                     timeout=30).json()
        rec["vids_after"] = c.master.topo.max_volume_id
        rec["node_ids"] = {zlib.crc32(m.raft.me.encode()) & 0x3FF
                           for i, m in enumerate(c.masters) if i != old}
        yield rec
    finally:
        if env is not None:
            env.close()
        c.stop()


def test_failover_elects_a_new_leader(failover):
    assert failover["new_leader"] != failover["old_leader"]
    assert failover["failover_s"] < 10


def test_heartbeats_rehome_to_the_new_leader(failover):
    assert failover["homes"] == {f"http://{failover['new_leader']}"}


def test_fresh_leader_queues_no_repair(failover):
    assert failover["fresh_repairs"] == []


def test_new_leaders_watchdog_rebuilds_a_lost_server(failover):
    rebuilt = sorted(s for r in failover["heal"]
                     for s in r["detail"].get("rebuilt", []))
    assert rebuilt == failover["lost"]
    assert failover["healed_digests"] == failover["digests"]
    assert failover["reads"] == failover["live"]


def test_ids_unique_across_the_failover(failover):
    before, after = failover["before_keys"], failover["after_keys"]
    assert not set(before) & set(after)
    # minted by a live master's snowflake sequencer
    assert {(k >> 12) & 0x3FF for k in after} <= failover["node_ids"]
    assert failover["grown"]["count"] == 1
    assert failover["vids_after"] > failover["vids_before"]


# ----------------------------------------------------------------------
# a leader cut off from the other masters, not from the volume servers
# ----------------------------------------------------------------------
class _Cut(Transport):
    """A master's raft transport with some peers unreachable."""

    def __init__(self, inner: Transport, cut: set[str]):
        self.inner, self.cut = inner, cut

    def request_vote(self, peer, args):
        return None if peer in self.cut else \
            self.inner.request_vote(peer, args)

    def append_entries(self, peer, args):
        return None if peer in self.cut else \
            self.inner.append_entries(peer, args)

    def install_snapshot(self, peer, args):
        return None if peer in self.cut else \
            self.inner.install_snapshot(peer, args)


def test_cut_off_leader_hands_its_servers_over(tmp_path):
    # pulse 0.5: a hold of 2.5 s, past the cut-off leader's step-down
    # (one election window, 0.6 s) and the servers' next beat
    c = Cluster(str(tmp_path), n_volume_servers=len(TOPOLOGY),
                max_volumes=4, volume_size_limit=8 << 20, pulse_seconds=0.5,
                topology=TOPOLOGY, repair_enabled=True, repair_interval=0.5,
                repair_grace=0.0, ec_backend=CudaCodec(device="cpu"),
                n_masters=3, raft_tick=RAFT_TICK)
    env = CommandEnv(c.master_urls)
    try:
        rng = np.random.default_rng(SEED)
        fids = [verbs.upload_data(c.master_url, rng.bytes(4096))
                for _ in range(20)]
        vid = int(fids[0].split(",")[0])
        assert repl.run_command(env, "lock") == "locked"
        repl.run_command(env, f"ec.encode -volumeId={vid}")
        assert repl.run_command(env, "unlock") == "unlocked"
        c.wait_for_ec_shards(vid)

        old = c.leader_index()
        me = [m.raft.me for m in c.masters]
        for i, m in enumerate(c.masters):
            cut = set(me) - {me[old]} if i == old else {me[old]}
            m.raft.transport = _Cut(m.raft.transport, cut)
        _wait(lambda: not c.masters[old].is_leader(),
              msg="the cut-off leader's step-down")
        new = c.leader_index()
        assert new != old
        lead = c.masters[new]
        repairs = []

        def whole():
            snap = lead.watchdog.snapshot()
            repairs.extend(snap["recent"] + snap["in_flight"])
            if snap["queue_depth"]:
                repairs.append({"queued": snap["queue_depth"]})
            return len(lead.topo.nodes) == len(TOPOLOGY) and sum(
                len(n) for n in lead.topo.lookup_ec_shards(vid).values()) \
                == 14

        _wait(whole, msg="the new leader's registry whole")
        _wait(lambda: whole() and lead.watchdog.repair_hold() == 0,
              msg="the hold passed")
        time.sleep(1.0)         # two scans of the watchdog after it
        whole()
        assert repairs == []
        assert {vs.master_url for vs in c.volume_servers} == \
            {c.master_threads[new].url}
    finally:
        env.close()
        c.stop()


# ----------------------------------------------------------------------
# the fresh-leader trap, on both packages' watchdogs
# ----------------------------------------------------------------------
# RS(10,4) volume 7 over five servers; after a failover only the first
# three have re-registered: 10 of 14 shards, a recoverable "deficit"
SHARDS = {"10.0.0.1:8080": range(0, 3), "10.0.0.2:8080": range(3, 6),
          "10.0.0.3:8080": range(6, 10), "10.0.0.4:8080": range(10, 12),
          "10.0.0.5:8080": range(12, 14)}


def _register(topo, node_ids):
    for node_id in node_ids:
        ip, port = node_id.split(":")
        node = topo.register_node(node_id, ip, int(port), node_id, 30,
                                  "dc1", node_id[-6], "hdd")
        topo.sync_node_ec_shards(node, [
            (7, "", sum(1 << s for s in SHARDS[node_id]), "",
             {"remote": False, "last_read_at": 0.0, "read_count": 0})])


@pytest.mark.parametrize("package", ["reference", "port"])
def test_fresh_leader_trap(package):
    topo_mod, wd_mod = ((ref_topology, ref_watchdog)
                        if package == "reference"
                        else (port_topology, port_watchdog))
    topo = topo_mod.Topology(volume_size_limit=1 << 30, pulse_seconds=PULSE)
    raft = types.SimpleNamespace(is_leader=lambda: True,
                                 leader_since=time.monotonic())
    master = types.SimpleNamespace(topo=topo, raft=raft)
    wd = wd_mod.RedundancyWatchdog(master, enabled=True, grace=0.0)
    _register(topo, list(SHARDS)[:3])
    for _ in range(2):          # a task queues from its second scan on
        wd._scan_once()
    assert [(e["volume"], e["have"], e["recoverable"])
            for e in wd.under_parity] == [(7, 10, True)]
    if package == "reference":
        # the trap: a rebuild of shards 10-13, which are not lost
        assert (7, "ec") in wd._queued
        return
    assert wd._queued == set() and (7, "ec") in wd._tracked
    # the other two servers re-register inside the hold: nothing lost
    _register(topo, list(SHARDS)[3:])
    wd._scan_once()
    assert wd.under_parity == [] and wd._tracked == {}
    # a server really lost after the window is rebuilt at once
    raft.leader_since = time.monotonic() - 5 * PULSE - 0.01
    topo.unregister_data_node("10.0.0.5:8080")
    for _ in range(2):
        wd._scan_once()
    assert (7, "ec") in wd._queued


# ----------------------------------------------------------------------
# the snowflake batch, on both packages' sequencers
# ----------------------------------------------------------------------
class _Clock:
    """time.time() at `ms` (since the snowflake epoch), advancing one
    microsecond per call."""

    def __init__(self, ms: int):
        self.now = (1_577_836_800_000 + ms) / 1000 + 0.00001
        self.calls = 0

    def time(self) -> float:
        self.calls += 1
        return self.now + self.calls * 1e-6


@pytest.mark.parametrize("package", ["reference", "port"])
def test_snowflake_batch_near_the_end_of_a_millisecond(monkeypatch,
                                                       package):
    mod = ref_sequence if package == "reference" else port_sequence
    ms = 123_456_789
    monkeypatch.setattr(mod, "time", _Clock(ms))
    seq = mod.SnowflakeSequencer(node_id=zlib.crc32(b"127.0.0.1:9333"))
    node = seq.node_id
    seq._last_ms, seq._seq = ms, 4000        # 4001 used this ms
    first = seq.next_ids(128)
    keys = range(first, first + 128)
    nodes = {(k >> 12) & 0x3FF for k in keys}
    if package == "reference":
        # the trap: the batch's last keys carry the next node id
        assert nodes == {node, node + 1}
        return
    assert nodes == {node}
    assert first & 0xFFF == 0 and first >> 22 > ms   # the next ms
    nxt = seq.next_ids(128)
    assert nxt == first + 128                         # contiguous, unique


def test_snowflake_ids_equal_to_the_reference(monkeypatch):
    ms = 987_654_321
    node = zlib.crc32(b"10.1.2.3:9333")
    ref = ref_sequence.SnowflakeSequencer(node_id=node)
    port = port_sequence.SnowflakeSequencer(node_id=node)
    for counts in ([1] * 5 + [10, 1, 128, 3],):
        monkeypatch.setattr(ref_sequence, "time", _Clock(ms))
        got_ref = [ref.next_ids(n) for n in counts]
        monkeypatch.setattr(port_sequence, "time", _Clock(ms))
        got_port = [port.next_ids(n) for n in counts]
        assert got_port == got_ref
    with pytest.raises(ValueError):
        port.next_ids(4097)
