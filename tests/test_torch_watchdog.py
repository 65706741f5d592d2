"""The port's redundancy watchdog and repair queue against the JAX
package's (tolerance 0), and the port of tests/test_watchdog.py and
tests/test_admin_scripts.py.

* `RedundancyWatchdog.scan()` and the pending set one scan leaves, of
  both packages, on both packages' `Topology` fed the same heartbeats:
  under-replicated volumes, under-parity EC volumes (RS and LRC) and an
  unrecoverable one.
* `snapshot()` has the reference's key set; `POST /debug/repair` gives
  the reference master's status and body for every malformed input.
* Against the port's `Cluster` (volume servers on
  CudaCodec(device="cpu"), the kernel's plain version): deficits
  surfaced while repair is off, a lost replica restored by the watchdog,
  two deleted EC shards rebuilt sha256-equal without an operator, the
  admin-scripts timer, and teardown under a live watchdog.
"""
import hashlib
import threading
import time
import types

import numpy as np
import pytest

from seaweedfs_tpu.master import topology as ref_topology
from seaweedfs_tpu.master import watchdog as ref_watchdog
from seaweedfs_tpu.server import cluster as ref_cluster_mod
from seaweedfs_tpu_torch.master import topology as port_topology
from seaweedfs_tpu_torch.master import watchdog as port_watchdog
from seaweedfs_tpu_torch.operation import verbs
from seaweedfs_tpu_torch.ops.codec_cuda import CudaCodec
from seaweedfs_tpu_torch.rpc.httpclient import session
from seaweedfs_tpu_torch.server.cluster import Cluster
from seaweedfs_tpu_torch.shell import commands_ec
from seaweedfs_tpu_torch.shell.env import CommandEnv


# -repair.grace of the clusters that run ec.encode under a live watchdog
GRACE = 5.0


def _wait(pred, timeout=15, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.1)
    raise TimeoutError(f"{msg} never became true")


def _digest(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


# ----------------------------------------------------------------------
# scan() and the pending set: port vs reference on the same heartbeats
# ----------------------------------------------------------------------
# (node, dc, rack, [(vid, collection, replication)],
#  [(vid, collection, shard ids, codec)])
HEARTBEATS = [
    ("10.0.0.1:8080", "dc1", "rA",
     [(1, "", "001"), (2, "pics", "010"), (3, "", "000"), (4, "", "002")],
     [(20, "ec", range(0, 5), ""), (21, "", range(0, 3), ""),
      (22, "cold", range(0, 16), "28.4"),
      (23, "lrc", [0, 1, 2, 3, 4, 5], "lrc-12.3.2")]),
    ("10.0.0.2:8080", "dc1", "rB",
     [(1, "", "001"), (4, "", "002"), (5, "x", "100")],
     [(20, "ec", range(5, 12), ""), (21, "", range(3, 6), ""),
      (22, "cold", range(16, 31), "28.4"),
      (23, "lrc", [6, 7, 8, 9, 10, 12, 13, 14, 15, 16], "lrc-12.3.2")]),
    ("10.0.0.3:8080", "dc2", "rC",
     [(6, "", "001")],
     [(24, "", range(0, 14), "")]),
]


def _feed(mod, topo) -> None:
    for node_id, dc, rack, vols, ecs in HEARTBEATS:
        ip, port = node_id.split(":")
        node = topo.register_node(node_id, ip, int(port), node_id, 30,
                                  dc, rack, "hdd")
        topo.sync_node_volumes(node, [
            mod.VolumeInfo(vid=vid, collection=col, size=1000,
                           replica_placement=rp)
            for vid, col, rp in vols])
        topo.sync_node_ec_shards(node, [
            (vid, col, sum(1 << s for s in sids), codec,
             {"remote": False, "last_read_at": 0.0, "read_count": 0})
            for vid, col, sids, codec in ecs])


def _pending(wd) -> list[dict]:
    out = []
    for task in wd._tracked.values():
        d = task.to_dict()
        d.pop("age_seconds")
        out.append(d)
    return sorted(out, key=lambda d: (d["volume"], d["kind"]))


@pytest.mark.parametrize("topo_of", ["reference", "port"])
def test_scan_equal_to_the_reference(topo_of):
    """Both watchdogs scan the same topology (each package's in turn)
    and leave the same deficits and pending tasks behind."""
    mod = ref_topology if topo_of == "reference" else port_topology
    topo = mod.Topology(volume_size_limit=1 << 30, pulse_seconds=1.0)
    _feed(mod, topo)
    master = types.SimpleNamespace(topo=topo, raft=None)
    ref_wd = ref_watchdog.RedundancyWatchdog(master)
    port_wd = port_watchdog.RedundancyWatchdog(master)
    ur, up = port_wd.scan()
    assert (ur, up) == ref_wd.scan()
    assert {e["volume"]: (e["have"], e["want"]) for e in ur} == \
        {2: (1, 2), 4: (2, 3), 5: (1, 2), 6: (1, 2)}
    by_vid = {e["volume"]: e for e in up}
    assert sorted(by_vid) == [20, 21, 22, 23]
    assert by_vid[20]["recoverable"] and by_vid[22]["recoverable"]
    assert not by_vid[21]["recoverable"]          # 6 of RS(10,4)
    assert by_vid[23]["code"] == "lrc-12.3.2"
    ref_wd._scan_once()
    port_wd._scan_once()
    assert port_wd.under_replicated == ref_wd.under_replicated
    assert port_wd.under_parity == ref_wd.under_parity
    assert _pending(port_wd) == _pending(ref_wd)
    assert (21, "ec") not in port_wd._tracked     # not rebuildable
    # a node that comes back heals its deficits: both drop them
    node = topo.register_node("10.0.0.4:8080", "10.0.0.4", 8080,
                              "10.0.0.4:8080", 30, "dc2", "rD", "hdd")
    topo.sync_node_volumes(node, [
        mod.VolumeInfo(vid=6, collection="", size=1000,
                       replica_placement="001")])
    ref_wd._scan_once()
    port_wd._scan_once()
    assert _pending(port_wd) == _pending(ref_wd)
    assert (6, "replica") not in port_wd._tracked
    assert (2, "replica") in port_wd._tracked


def test_enqueue_dedupe_equal_to_the_reference():
    topo = port_topology.Topology(volume_size_limit=1 << 30,
                                  pulse_seconds=1.0)
    master = types.SimpleNamespace(topo=topo, raft=None)
    ref_wd = ref_watchdog.RedundancyWatchdog(master)
    port_wd = port_watchdog.RedundancyWatchdog(master)
    for wd in (ref_wd, port_wd):
        assert wd.enqueue(7, "replica", "scrub") is True
        assert wd.enqueue(7, "replica", "operator") is True
        assert wd.enqueue(8, "ec", "scrub", collection="c") is True
        wd._inflight[(9, "ec")] = time.monotonic()
        assert wd.enqueue(9, "ec", "operator") is False
    assert _pending(port_wd) == _pending(ref_wd)
    assert [t["reason"] for t in _pending(port_wd)] == ["operator",
                                                        "scrub"]


def test_snapshot_has_the_reference_keys():
    master = types.SimpleNamespace(
        topo=port_topology.Topology(1 << 30, 1.0), raft=None)
    ref = ref_watchdog.RedundancyWatchdog(master, interval=0.5)
    port = port_watchdog.RedundancyWatchdog(master, interval=0.5)
    rs, ps = ref.snapshot(), port.snapshot()
    assert set(ps) == set(rs)
    assert {k: v for k, v in ps.items() if k != "last_scan_age_seconds"} \
        == {k: v for k, v in rs.items() if k != "last_scan_age_seconds"}


# ----------------------------------------------------------------------
# POST /debug/repair: the reference master's answers, body for body
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def masters(tmp_path_factory):
    """A reference master and a port master, no volume servers."""
    base = tmp_path_factory.mktemp("masters")
    ref = port = None
    try:
        ref = ref_cluster_mod.Cluster(str(base / "ref"),
                                      n_volume_servers=0)
        port = Cluster(str(base / "port"), n_volume_servers=0)
        yield ref.master_url, port.master_url
    finally:
        for c in (port, ref):
            if c is not None:
                c.stop()


MALFORMED = [
    ("not-json", {"data": b"\x00not json",
                  "headers": {"Content-Type": "application/json"}}),
    ("empty", {"data": b""}),
    ("null", {"data": b"null"}),
    ("list", {"json": [1, 2, 3]}),
    ("string", {"json": "volume"}),
    ("no-volume", {"json": {"kind": "replica"}}),
    ("volume-str", {"json": {"volume": "x", "kind": "replica"}}),
    ("volume-null", {"json": {"volume": None}}),
    ("volume-zero", {"json": {"volume": 0, "kind": "replica"}}),
    ("volume-negative", {"json": {"volume": -3, "kind": "replica"}}),
    ("bad-kind", {"json": {"volume": 1, "kind": "bogus"}}),
    ("kind-list", {"json": {"volume": 1, "kind": ["ec"]}}),
]


@pytest.mark.parametrize("name,kwargs", MALFORMED,
                         ids=[m[0] for m in MALFORMED])
def test_malformed_enqueue_answers_as_the_reference(masters, name,
                                                    kwargs):
    ref_url, port_url = masters
    out = []
    for url in (ref_url, port_url):
        r = session().post(url + "/debug/repair", timeout=10, **kwargs)
        out.append((r.status_code, r.json()))
    assert out[1] == out[0]
    assert out[1][0] == 400 and "error" in out[1][1]


def test_accepted_enqueue_answers_as_the_reference(masters):
    out = []
    for url in masters:
        r = session().post(url + "/debug/repair",
                           json={"volume": "12", "kind": "ec",
                                 "reason": 5, "collection": "c"},
                           timeout=10)
        snap = session().get(url + "/debug/repair", timeout=10).json()
        pend = [{k: v for k, v in p.items() if k != "age_seconds"}
                for p in snap["pending"]]
        out.append((r.status_code, r.json(), pend))
    assert out[1] == out[0]
    assert out[1][1] == {"accepted": True, "enabled": False}


# ----------------------------------------------------------------------
# tests/test_watchdog.py against the port's Cluster
# ----------------------------------------------------------------------
def _locations(cluster, vid):
    r = session().get(cluster.master_url + "/dir/lookup",
                      params={"volumeId": str(vid)}, timeout=5).json()
    return [loc["url"] for loc in r.get("locations", [])]


def _repair(cluster):
    return session().get(cluster.master_url + "/debug/repair",
                         timeout=5).json()


def _status(cluster):
    return session().get(cluster.master_url + "/cluster/status",
                         timeout=5).json()


def _kill_holder(cluster, vid):
    """Stop the server thread of one replica holder; -> its url."""
    victim = next(i for i, s in enumerate(cluster.stores)
                  if s.find_volume(vid) is not None)
    url = cluster.stores[victim].public_url
    cluster.volume_threads[victim].stop()
    return url


def _write_replicated(cluster, n=5):
    a0 = verbs.assign(cluster.master_url, replication="001")
    vid = int(a0.fid.split(",")[0])
    verbs.upload(a0, b"watchdog-payload-0")
    fids = [a0.fid]
    for i in range(1, n):
        a = verbs.assign(cluster.master_url, replication="001")
        verbs.upload(a, b"watchdog-payload-%d" % i)
        if int(a.fid.split(",")[0]) == vid:
            fids.append(a.fid)
    return vid, fids


def _cluster(tmp_path, enabled: bool, n: int = 3, **kw) -> Cluster:
    return Cluster(str(tmp_path), n_volume_servers=n, pulse_seconds=0.3,
                   volume_size_limit=8 << 20, repair_enabled=enabled,
                   repair_interval=0.5, ec_backend=CudaCodec(device="cpu"),
                   **kw)


class TestDeficitVisibility:
    """Repair disabled: deficits are surfaced and tracked as pending
    work, but nothing repairs on its own."""

    def test_under_replicated_surfaced_and_pending(self, tmp_path):
        c = _cluster(tmp_path, enabled=False)
        try:
            vid, _ = _write_replicated(c)
            assert len(_locations(c, vid)) == 2
            _kill_holder(c, vid)
            _wait(lambda: any(u["volume"] == vid for u in
                              _status(c)["UnderReplicated"]),
                  msg="deficit in /cluster/status")
            st = _status(c)
            row = next(u for u in st["UnderReplicated"]
                       if u["volume"] == vid)
            assert (row["have"], row["want"]) == (1, 2)
            assert st["RepairEnabled"] is False
            rep = _repair(c)
            assert rep["enabled"] is False
            assert any(p["volume"] == vid and p["kind"] == "replica"
                       for p in rep["pending"])
            # nothing is repaired behind the operator's back
            assert rep["queue_depth"] == 0 and rep["in_flight"] == []
        finally:
            c.stop()

    def test_manual_enqueue_validation(self, masters):
        url = masters[1]
        r = session().post(url + "/debug/repair",
                           json={"volume": 7, "kind": "replica",
                                 "reason": "test"}, timeout=5)
        assert r.status_code == 200
        body = r.json()
        assert body["accepted"] is True and body["enabled"] is False
        pending = session().get(url + "/debug/repair",
                                timeout=5).json()["pending"]
        assert (7, "replica") in {(p["volume"], p["kind"])
                                  for p in pending}


class TestAutoRepair:
    def test_replica_restored_within_interval(self, tmp_path):
        c = _cluster(tmp_path, enabled=True)
        try:
            vid, fids = _write_replicated(c)
            dead = _kill_holder(c, vid)
            # the watchdog notices the loss and re-replicates without
            # any operator involvement
            # the copy's reply waits for the heartbeat that registers
            # it, so the master may list the new replica just before the
            # worker records its result: wait for both
            _wait(lambda: len(_locations(c, vid)) == 2
                  and dead not in _locations(c, vid)
                  and any(r["ok"] for r in _repair(c)["recent"]),
                  timeout=20, msg="replica restored")
            rep = _repair(c)
            assert rep["enabled"] is True
            oks = [r for r in rep["recent"]
                   if r["volume"] == vid and r["ok"]]
            assert oks and oks[-1]["kind"] == "replica"
            _wait(lambda: _status(c)["UnderReplicated"] == [],
                  msg="deficit cleared")
            for fid in fids:
                for url in _locations(c, vid):
                    assert session().get(f"http://{url}/{fid}",
                                         timeout=5).status_code == 200
            text = session().get(c.master_url + "/metrics",
                                 timeout=5).text
            assert "repair_seconds" in text
            assert "repair_bytes_total" in text
            assert "repair_queue_depth" in text
        finally:
            c.stop()

    def test_snapshot_shape(self, tmp_path):
        c = _cluster(tmp_path, enabled=True, n=0)
        try:
            rep = _repair(c)
            for key in ("enabled", "interval", "concurrency",
                        "max_attempts", "grace", "queue_depth",
                        "scan_count", "under_replicated", "under_parity",
                        "pending", "in_flight", "recent"):
                assert key in rep, key
            assert rep["interval"] == 0.5 and rep["concurrency"] == 2
        finally:
            c.stop()

    def test_ec_shards_rebuilt_sha256_equal(self, tmp_path):
        """Two deleted shards of an EC volume come back, byte for byte,
        through the watchdog's ec.rebuild on the volume servers'
        codec."""
        # the grace rides out ec.encode's server-by-server mounts, which
        # the watchdog would otherwise take for lost shards
        c = _cluster(tmp_path, enabled=True, n=4, repair_grace=GRACE)
        try:
            env = CommandEnv(c.master_url)
            env.acquire_lock()
            rng = np.random.default_rng(3)
            a0 = verbs.assign(c.master_url, collection="heal")
            vid = int(a0.fid.split(",")[0])
            payloads = {}
            for i in range(24):
                a = a0 if i == 0 else verbs.assign(c.master_url,
                                                   collection="heal")
                if int(a.fid.split(",")[0]) != vid:
                    continue
                data = rng.bytes(int(rng.integers(100, 40000)))
                verbs.upload(a, data)
                payloads[a.fid] = data
            commands_ec.ec_encode(env, vid)
            assert _repair(c)["recent"] == []
            assert all(len(u) == 1 for u in
                       env.ec_shard_locations(vid).values())
            paths = {}
            for s in c.stores:
                ecv = s.ec_volumes.get(vid)
                for sid, shard in (ecv.shards.items() if ecv else ()):
                    paths[sid] = shard.path
            orig = {sid: _digest(p) for sid, p in paths.items()}
            assert sorted(orig) == list(range(14))
            locs = env.ec_shard_locations(vid)
            index = {f"{s.ip}:{s.port}": i for i, s in enumerate(c.stores)}
            for sid in (2, 12):
                c.admin(index[locs[sid][0]], "/admin/ec/delete",
                        {"volume": vid, "shard_ids": [sid]})
            _wait(lambda: any(p["volume"] == vid for p in
                              _repair(c)["recent"] if p["ok"]),
                  timeout=20 + GRACE, msg="EC repair recorded")
            c.wait_for_ec_shards(vid, 14)
            rec = next(r for r in _repair(c)["recent"]
                       if r["volume"] == vid)
            assert rec["kind"] == "ec" and rec["reason"] == "watchdog"
            assert sorted(rec["detail"]["rebuilt"]) == [2, 12]
            assert rec["detail"]["mode"] == "partial"
            now = {}
            for s in c.stores:
                ecv = s.ec_volumes.get(vid)
                for sid, shard in (ecv.shards.items() if ecv else ()):
                    now[sid] = _digest(shard.path)
            assert now == orig
            _wait(lambda: _status(c)["UnderParity"] == [],
                  msg="under-parity cleared")
            url = next(iter(locs[0]))
            for fid, data in payloads.items():
                assert session().get(f"http://{url}/{fid}",
                                     timeout=10).content == data
        finally:
            c.stop()


def test_stop_under_live_watchdog_leaves_no_thread(tmp_path):
    """Cluster.stop() stops the watchdog before the volume servers: the
    teardown starts no repair and leaves no repair thread behind."""
    before = {t.ident for t in threading.enumerate()}
    c = _cluster(tmp_path, enabled=True)
    vid, _ = _write_replicated(c)
    c.stop()
    assert all(r["volume"] != vid for r in c.master.watchdog._results)
    left = [t.name for t in threading.enumerate()
            if t.ident not in before and t.is_alive()
            and t.name.startswith(("repair-", "admin-scripts",
                                   "master-stepdown",
                                   "master-heartbeat-stream",
                                   "websocket-keepalive",
                                   "volume-heartbeat"))]
    assert left == []


# ----------------------------------------------------------------------
# tests/test_admin_scripts.py against the port's Cluster
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def cron_cluster(tmp_path_factory):
    c = Cluster(str(tmp_path_factory.mktemp("cron_cluster")),
                n_volume_servers=1, volume_size_limit=16 << 20,
                admin_scripts=["volume.grow -count=1 -collection=cron",
                               "volume.vacuum -threshold=0.99"],
                admin_script_interval=0.4,
                ec_backend=CudaCodec(device="cpu"))
    yield c
    c.stop()


def test_scripts_run_and_take_effect(cron_cluster):
    _wait(lambda: len(cron_cluster.master.admin_script_runs) >= 2,
          msg="two admin script runs")
    runs = cron_cluster.master.admin_script_runs
    assert all(r["ok"] for r in runs), runs
    # the grow script really created a volume in the 'cron' collection
    vols = [v for n in cron_cluster.master.topo.nodes.values()
            for v in n.volumes.values() if v.collection == "cron"]
    assert vols


def test_scripts_bounded_history(cron_cluster):
    assert len(cron_cluster.master.admin_script_runs) <= 100


def test_scripts_skip_vacuum_while_disabled(cron_cluster):
    master = cron_cluster.master
    r = session().post(cron_cluster.master_url + "/vol/vacuum/disable",
                       timeout=5)
    assert r.json() == {"vacuum_disabled": True}
    try:
        n0 = len(master.admin_script_runs)
        _wait(lambda: len(master.admin_script_runs) >= n0 + 2,
              msg="a run while vacuum is disabled")
        skipped = [r for r in master.admin_script_runs[n0:]
                   if r["script"].startswith("volume.vacuum")]
        assert skipped and all(r == {"script": r["script"], "ok": False,
                                     "error": "vacuum disabled"}
                               for r in skipped)
    finally:
        session().post(cron_cluster.master_url + "/vol/vacuum/enable",
                       timeout=5)
