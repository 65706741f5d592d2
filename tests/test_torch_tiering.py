"""The port's tiering controller (master/tiering.py), its master routes
and the automatic lifecycle, against the JAX package's (tolerance 0).

* On a fake master with the same topology snapshot (each package's
  `Topology` in turn, fed the same heartbeats) and the same persisted
  `tiering.json`, both controllers' `_scan_once` want and queue the
  same tasks and leave the same states: seal, offload, recall (on the
  second scan, once the read count moved), resume of each transitional
  state, adopt-observed, finish-observed, and a vanished volume
  forgotten.
* `tiering.json`: both write the same bytes, and each loads the
  other's.
* A fresh raft leader: the reference queues a seal of a replicated
  volume whose second replica has not re-registered; the port tracks
  it and queues it once the watchdog's hold has passed. A restarted
  master: the reference resumes an offload at once with a holder not
  yet registered; the port waits 5 pulses.
* `POST /debug/tiering`: the reference master's status and body for
  every malformed input; the reference's own cases of
  tests/test_tiering.py (`test_tier_lifecycle_auto`,
  `test_tier_manual_enqueue_validation`) on the port's `Cluster`.
* The lifecycle on a port `Cluster` (volume servers on
  CudaCodec(device="cpu")): hot -> ec -> remote -> hot, the 14 cold
  objects sha256-equal to the reference encoder's shards of the same
  .dat, every needle equal cold and after the recall, reads kept
  going through the recall.
* A master restarted on its `-tier.stateDir` mid-offload resumes and
  leaves exactly 14 objects.
* A lost cold holder, on the reference's cluster and the port's: the
  watchdog rebuilds its shards from the remote-backed survivors, the
  controller adopts `ec`, offloads the rebuilt shards onto the same
  keys and the volume is `remote` again; same objects, no duplicate.
"""
import functools
import glob
import hashlib
import json
import os
import threading
import time
import types as pytypes

import numpy as np
import pytest
import requests

from seaweedfs_tpu.ec import encoder as ref_encoder
from seaweedfs_tpu.master import tiering as ref_tiering
from seaweedfs_tpu.master import topology as ref_topology
from seaweedfs_tpu.server import cluster as ref_cluster_mod
from seaweedfs_tpu_torch.master import tiering as port_tiering
from seaweedfs_tpu_torch.master import topology as port_topology
from seaweedfs_tpu_torch.master import watchdog as port_watchdog
from seaweedfs_tpu_torch.operation import verbs
from seaweedfs_tpu_torch.ops.codec_cuda import CudaCodec
from seaweedfs_tpu_torch.rpc.http import ServerThread
from seaweedfs_tpu_torch.server.cluster import Cluster
from seaweedfs_tpu_torch.server.master_server import MasterServer
from seaweedfs_tpu_torch.shell import commands_ec
from seaweedfs_tpu_torch.shell.env import CommandEnv
from seaweedfs_tpu_torch.shell.repl import run_command
from seaweedfs_tpu_torch.storage import backend as port_backend
from seaweedfs_tpu_torch.wdclient.client import MasterClient

from tests import test_tiering as ref_cases
from tests.torch_port_cases import call_case, port_cases

SEED = 20261017
REMOTE = {"type": "local", "root": "/cold"}
PortCluster = functools.partial(Cluster, ec_backend=CudaCodec(device="cpu"))


def _wait(pred, timeout=60.0, msg="condition", interval=0.1):
    deadline = time.monotonic() + timeout
    last = None
    while time.monotonic() < deadline:
        try:
            last = pred()
            if last:
                return last
        except Exception as e:  # noqa: BLE001 — polled again
            last = e
        time.sleep(interval)
    raise TimeoutError(f"{msg} never became true (last: {last!r})")


def _digest(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def _files(root) -> dict[str, str]:
    out = {}
    for dirpath, _, names in os.walk(root):
        for n in names:
            p = os.path.join(dirpath, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, root)] = _digest(f.read())
    return out


# ----------------------------------------------------------------------
# _scan_once: both controllers on one topology snapshot
# ----------------------------------------------------------------------
OLD = 1000.0     # seconds in the past: idle past every threshold


def _heartbeats(now: float, recall_reads: int) -> list:
    """(node, [(vid, collection, size, modified_at, replication)],
    [(vid, collection, shard ids, remote, last_read_at, read_count)])"""
    old = now - OLD
    return [
        ("10.0.0.1:8080",
         [(1, "a", 5000, old, "000"), (2, "a", 5000, now, "000"),
          (9, "b", 5000, old, "000")],
         [(3, "c", range(0, 7), False, old, 0),
          (4, "c", range(0, 7), True, old, recall_reads),
          (5, "c", range(0, 7), True, old, 0),
          (6, "d", range(0, 14), False, old, 0),
          (7, "d", range(0, 14), True, old, 0),
          (8, "d", range(0, 14), False, old, 0),
          (12, "e", range(0, 14), True, old, 0)]),
        ("10.0.0.2:8080", [],
         [(3, "c", range(7, 14), False, old, 0),
          (4, "c", range(7, 14), True, old, 0),
          (5, "c", range(7, 14), False, old, 0)]),
    ]


STATES = {  # the persisted intent both controllers start from
    1: "hot", 2: "hot", 3: "ec", 4: "remote", 5: "offloading",
    6: "sealing", 8: "hot", 9: "recalling", 10: "ec", 11: "sealing",
    12: "recalling"}


def _feed(mod, topo, now: float, recall_reads: int) -> None:
    for node_id, vols, ecs in _heartbeats(now, recall_reads):
        ip, port = node_id.split(":")
        node = topo.register_node(node_id, ip, int(port), node_id, 30,
                                  "dc1", "r1", "hdd")
        topo.sync_node_volumes(node, [
            mod.VolumeInfo(vid=vid, collection=col, size=size,
                           modified_at=int(mtime), replica_placement=rp)
            for vid, col, size, mtime, rp in vols])
        topo.sync_node_ec_shards(node, [
            (vid, col, sum(1 << s for s in sids), "",
             {"remote": remote, "last_read_at": lra, "read_count": rc})
            for vid, col, sids, remote, lra, rc in ecs])


def _state_file(path, now: float, states: dict = STATES) -> None:
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "tiering.json"), "w") as f:
        json.dump({"volumes": {
            str(v): {"state": s, "collection": "", "transitions": 1,
                     "updated_at": now - OLD}
            for v, s in states.items()}}, f)


def _queued(ctl) -> list:
    out = []
    while not ctl._queue.empty():
        t = ctl._queue.get_nowait()
        out.append((t.vid, t.transition, t.reason, t.collection))
    return out


def _view(ctl) -> dict:
    return {
        "tracked": sorted((t.vid, t.transition, t.reason, t.collection)
                          for t in ctl._tracked.values()),
        "queued": sorted(ctl._queued),
        "states": {v: (s["state"], s["collection"], s["transitions"])
                   for v, s in sorted(ctl.states.items())},
    }


@pytest.mark.parametrize("topo_of", ["reference", "port"])
def test_scan_wants_what_the_reference_wants(topo_of, tmp_path):
    mod = ref_topology if topo_of == "reference" else port_topology
    topo = mod.Topology(volume_size_limit=1 << 30, pulse_seconds=1.0)
    now = time.time()
    _feed(mod, topo, now, recall_reads=0)
    master = pytypes.SimpleNamespace(topo=topo, raft=None)
    master.watchdog = port_watchdog.RedundancyWatchdog(master)
    kw = dict(enabled=True, seal_after_idle=100.0,
              offload_after_idle=100.0, recall_reads=3,
              recall_window=60.0, remote=dict(REMOTE))
    ctls = {}
    for name, cls in (("reference", ref_tiering.TieringController),
                      ("port", port_tiering.TieringController)):
        _state_file(tmp_path / name, now)
        ctls[name] = cls(master, state_dir=str(tmp_path / name), **kw)
    for ctl in ctls.values():
        ctl._scan_once()
    first = {n: _view(c) for n, c in ctls.items()}
    assert first["port"] == first["reference"]
    # the read count moves by 5 > recall_reads: a recall on scan two
    _feed(mod, topo, now, recall_reads=5)
    for ctl in ctls.values():
        ctl._scan_once()
    second = {n: _view(c) for n, c in ctls.items()}
    assert second["port"] == second["reference"]
    queued = {n: _queued(c) for n, c in ctls.items()}
    assert queued["port"] == queued["reference"]
    want = {(1, "seal", "controller"), (3, "offload", "controller"),
            (4, "recall", "controller"), (5, "offload", "resume"),
            (11, "seal", "resume"), (12, "recall", "resume")}
    assert {t[:3] for t in second["port"]["tracked"]} == want
    states = second["port"]["states"]
    assert states[6][0] == "ec"          # sealing, observed ec
    assert states[7][0] == "remote"      # unknown, adopted as observed
    assert states[8][0] == "ec"          # hot, an operator's ec.encode
    assert states[9][0] == "hot"         # recalling, observed hot
    assert states[11][0] == "sealing"    # vanished mid-flight: kept
    assert 10 not in states              # vanished at rest: forgotten
    assert states[2] == ("hot", "", 1)   # written just now: no seal
    assert sorted(t[0] for t in queued["port"]) == [1, 3, 4, 5, 11, 12]


def test_state_file_bytes_and_cross_load(tmp_path, monkeypatch):
    """Both controllers persist the same tiering.json; each loads the
    other's."""
    clock = pytypes.SimpleNamespace(time=lambda: 1_760_000_000.5,
                                    monotonic=time.monotonic)
    monkeypatch.setattr(ref_tiering, "time", clock)
    monkeypatch.setattr(port_tiering, "time", clock)
    master = pytypes.SimpleNamespace(
        topo=port_topology.Topology(1 << 30, 1.0), raft=None)
    blobs = {}
    for name, mod in (("reference", ref_tiering), ("port", port_tiering)):
        ctl = mod.TieringController(master, state_dir=str(tmp_path / name))
        for vid, state, col in ((3, "sealing", "a"), (3, "ec", None),
                                (9, "offloading", "cold"),
                                (9, "remote", "cold"), (12, "hot", "")):
            ctl._set_state(vid, state, col)
        with open(tmp_path / name / "tiering.json", "rb") as f:
            blobs[name] = f.read()
    assert blobs["port"] == blobs["reference"]
    for reader, writer in (("port", "reference"), ("reference", "port")):
        mod = port_tiering if reader == "port" else ref_tiering
        ctl = mod.TieringController(master,
                                    state_dir=str(tmp_path / writer))
        assert ctl.states == {int(k): v for k, v in
                              json.loads(blobs[writer])["volumes"].items()}
        assert ctl.snapshot()["tier_counts"]["remote"] == 1


def test_fresh_leader_holds_transitions(tmp_path):
    """A fresh raft leader sees one of a 001 volume's two replicas; the
    reference queues its seal at once, the port tracks it and queues it
    once the watchdog's hold (5 pulses) has passed."""
    topo = port_topology.Topology(volume_size_limit=1 << 30,
                                  pulse_seconds=1.0)
    old = time.time() - OLD
    node = topo.register_node("10.0.0.1:8080", "10.0.0.1", 8080,
                              "10.0.0.1:8080", 30, "dc1", "r1", "hdd")
    topo.sync_node_volumes(node, [port_topology.VolumeInfo(
        vid=21, collection="r", size=5000, modified_at=int(old),
        replica_placement="001")])
    raft = pytypes.SimpleNamespace(is_leader=lambda: True,
                                   leader_since=time.monotonic())
    master = pytypes.SimpleNamespace(topo=topo, raft=raft)
    master.watchdog = port_watchdog.RedundancyWatchdog(master)
    kw = dict(enabled=True, seal_after_idle=100.0)
    ctls = {}
    for name, mod in (("reference", ref_tiering), ("port", port_tiering)):
        _state_file(tmp_path / name, time.time(), {21: "hot"})
        ctls[name] = mod.TieringController(
            master, state_dir=str(tmp_path / name), **kw)
        ctls[name]._scan_once()
    assert ctls["reference"]._queued == {(21, "seal")}
    assert ctls["port"]._queued == set()
    assert (21, "seal") in ctls["port"]._tracked
    assert ctls["port"].transition_hold() > 0
    raft.leader_since -= port_watchdog.REAP_PULSES * 1.0
    ctls["port"]._scan_once()
    assert ctls["port"]._queued == {(21, "seal")}


def test_restarted_master_holds_a_resume(tmp_path):
    """A master restarted mid-offload: two of the EC volume's three
    holders have re-registered (one's shards already remote). The
    reference queues the resumed offload at once, which would offload
    only the holders it sees and record the volume remote; the port
    holds it for 5 pulses after the controller started."""
    topo = port_topology.Topology(volume_size_limit=1 << 30,
                                  pulse_seconds=1.0)
    old = time.time() - OLD
    for i, (sids, remote) in enumerate(((range(0, 5), True),
                                        (range(5, 10), False))):
        node = topo.register_node(f"10.0.0.{i}:8080", f"10.0.0.{i}",
                                  8080, f"10.0.0.{i}:8080", 30, "dc1",
                                  f"r{i}", "hdd")
        topo.sync_node_ec_shards(node, [
            (7, "c", sum(1 << s for s in sids), "",
             {"remote": remote, "last_read_at": old, "read_count": 0})])
    master = pytypes.SimpleNamespace(topo=topo, raft=None)
    master.watchdog = port_watchdog.RedundancyWatchdog(master)
    ctls = {}
    for name, mod in (("reference", ref_tiering), ("port", port_tiering)):
        _state_file(tmp_path / name, time.time(), {7: "offloading"})
        ctls[name] = mod.TieringController(
            master, enabled=True, remote=dict(REMOTE),
            state_dir=str(tmp_path / name))
    # what start() stamps, without its threads
    ctls["port"]._started_at = time.monotonic()
    for ctl in ctls.values():
        ctl._scan_once()
    assert ctls["reference"]._queued == {(7, "offload")}
    assert ctls["port"]._queued == set()
    assert ctls["port"]._tracked[(7, "offload")].reason == "resume"
    ctls["port"]._started_at -= port_watchdog.REAP_PULSES * 1.0
    ctls["port"]._scan_once()
    assert ctls["port"]._queued == {(7, "offload")}


# ----------------------------------------------------------------------
# the master's routes
# ----------------------------------------------------------------------
BAD_BODIES = ["not json", "[1, 2]", json.dumps({"transition": "seal"}),
              json.dumps({"volume": "x", "transition": "seal"}),
              json.dumps({"volume": 0, "transition": "seal"}),
              json.dumps({"volume": -3, "transition": "seal"}),
              json.dumps({"volume": 1, "transition": "melt"}),
              json.dumps({"volume": 1}),
              json.dumps({"volume": 1, "transition": "offload"})]


def test_debug_tiering_400s_as_the_reference(tmp_path):
    ref = ref_cluster_mod.Cluster(str(tmp_path / "ref"),
                                  n_volume_servers=0)
    try:
        port = PortCluster(str(tmp_path / "port"), n_volume_servers=0)
        try:
            for body in BAD_BODIES:
                out = [requests.post(f"{url}/debug/tiering", data=body,
                                     timeout=10)
                       for url in (ref.master_url, port.master_url)]
                assert (out[1].status_code, out[1].json()) == \
                    (out[0].status_code, out[0].json()), body
                assert out[1].status_code == 400
            ok = [requests.post(f"{url}/debug/tiering", timeout=10,
                                json={"volume": 4, "transition": "recall"})
                  for url in (ref.master_url, port.master_url)]
            assert ok[1].json() == ok[0].json() == \
                {"accepted": True, "enabled": False}
            snaps = [requests.get(f"{url}/debug/tiering", timeout=10).json()
                     for url in (ref.master_url, port.master_url)]
            assert set(snaps[1]) == set(snaps[0])
            for s in snaps:
                s.pop("last_scan_age_seconds")
                s.pop("scan_count")
                for p in s["pending"]:
                    p.pop("age_seconds")
            assert snaps[1] == snaps[0]
            st = requests.get(f"{port.master_url}/cluster/status",
                              timeout=10).json()
            assert st["Tiering"]["Enabled"] is False
            assert st["Tiering"]["BytesMoved"] == {}
            # the fold carries the span collector's block beside the
            # federation's, key for key as the reference's
            ref_st = requests.get(f"{ref.master_url}/cluster/status",
                                  timeout=10).json()
            assert set(st["Observability"]) == set(ref_st["Observability"])
            assert st["Observability"]["Federation"] == {}
        finally:
            port.stop()
    finally:
        ref.stop()


CASES = port_cases(ref_cases, Cluster=PortCluster, backend=port_backend,
                   verbs=verbs, CommandEnv=CommandEnv,
                   run_command=run_command)


@pytest.mark.parametrize("case", ["test_tier_lifecycle_auto",
                                  "test_tier_manual_enqueue_validation"])
def test_reference_case_on_the_port(case, tmp_path):
    call_case(CASES[case], {"tmp_path": tmp_path})


# ----------------------------------------------------------------------
# the lifecycle on a port Cluster
# ----------------------------------------------------------------------
def _tier_state(master_url, vid):
    snap = requests.get(f"{master_url}/debug/tiering", timeout=5).json()
    return snap["volumes"].get(str(vid), {}).get("state")


def _read(master_url, fid) -> bytes | None:
    try:
        url = MasterClient(master_url).lookup_file_id(fid)
        r = requests.get(url, timeout=10)
    except (LookupError, OSError):
        return None
    return r.content if r.status_code == 200 else None


def _read_retrying(master_url, fid, timeout=30.0) -> bytes:
    return _wait(lambda: _read(master_url, fid), timeout=timeout,
                 msg=f"read {fid}")


def _fill(master_url, col, n, seed) -> tuple[int, dict]:
    rng = np.random.default_rng(seed)
    a0 = verbs.assign(master_url, collection=col)
    vid = int(a0.fid.split(",")[0])
    payloads = {}
    data = rng.bytes(20_000)
    verbs.upload(a0, data)
    payloads[a0.fid] = data
    while len(payloads) < n:
        a = verbs.assign(master_url, collection=col)
        assert int(a.fid.split(",")[0]) == vid
        data = rng.bytes(int(rng.integers(1000, 60_000)))
        verbs.upload(a, data)
        payloads[a.fid] = data
    return vid, payloads


def test_lifecycle_shards_equal_to_the_reference_encoder(tmp_path):
    cold = tmp_path / "cold"
    c = PortCluster(str(tmp_path / "cluster"), n_volume_servers=3,
                    volume_size_limit=8 << 20, max_volumes=8,
                    pulse_seconds=0.3, tier_enabled=True,
                    tier_interval=0.3, tier_seal_after_idle=2.0,
                    tier_offload_after_idle=1.0, tier_recall_reads=40,
                    tier_recall_window=60.0,
                    tier_remote={"type": "local", "root": str(cold)},
                    tier_state_dir=str(tmp_path / "state"))
    try:
        vid, payloads = _fill(c.master_url, "life", 30, SEED)
        # the .dat as sealed: the reference encoder's shards of it
        vol = next(s.find_volume(vid) for s in c.stores
                   if s.has_volume(vid))
        vol.sync()
        copy = tmp_path / "ref" / f"life_{vid}"
        os.makedirs(copy.parent)
        with open(vol.file_name() + ".dat", "rb") as f, \
                open(str(copy) + ".dat", "wb") as g:
            g.write(f.read())
        ref_encoder.write_ec_files(str(copy), backend="numpy")
        want = {f"tier-ec/life/{vid}/{sid:02d}.ec":
                _digest(open(f"{copy}.ec{sid:02d}", "rb").read())
                for sid in range(14)}
        _wait(lambda: _tier_state(c.master_url, vid) == "remote",
              msg="sealed and offloaded")
        assert _files(cold) == want
        assert glob.glob(str(tmp_path / "cluster" / "*" /
                             f"life_{vid}.ec[0-9][0-9]")) == []
        assert glob.glob(str(tmp_path / "cluster" / "*" /
                             f"life_{vid}.ecx"))
        for fid, data in payloads.items():
            assert _read_retrying(c.master_url, fid) == data
        # keep reading until the recall: every read is retried through
        # a fresh lookup until it answers, so a read that races the
        # decode waits for the plain volume instead of failing
        misses = []
        stop = threading.Event()

        def reader():
            fids = list(payloads)
            i = 0
            while not stop.is_set():
                fid = fids[i % len(fids)]
                if _read(c.master_url, fid) != payloads[fid]:
                    misses.append(fid)
                    assert _read_retrying(c.master_url, fid) == \
                        payloads[fid]
                i += 1

        th = threading.Thread(target=reader, daemon=True)
        th.start()
        try:
            _wait(lambda: _tier_state(c.master_url, vid) == "hot",
                  msg="recalled")
        finally:
            stop.set()
            th.join(timeout=60)
        assert _files(cold) == {}
        assert glob.glob(str(tmp_path / "cluster" / "*" /
                             f"life_{vid}.rsm")) == []
        for fid, data in payloads.items():
            assert _read_retrying(c.master_url, fid) == data
        snap = requests.get(f"{c.master_url}/debug/tiering",
                            timeout=5).json()
        assert [(r["transition"], r["reason"], r["ok"])
                for r in snap["recent"]] == [
            ("recall", "controller", True),
            ("offload", "controller", True),
            ("seal", "controller", True)]
        requests.get(f"{c.master_url}/cluster/metrics", timeout=10)
        st = _wait(lambda: requests.get(
            f"{c.master_url}/cluster/status",
            timeout=5).json()["Tiering"]["BytesMoved"].get("recall"),
            timeout=30, msg="recall bytes federated")
        assert st > 0
        assert len(misses) < len(payloads)
    finally:
        c.stop()


def _restart_master(c, **overrides) -> MasterServer:
    """Stop the cluster's one master as a killed process and start a
    new one on its port (the volume servers heartbeat there again)."""
    port = c.master_threads[0].port
    c.stop_master(0)
    m = MasterServer(volume_size_limit=8 << 20, pulse_seconds=0.3,
                     **overrides)
    t = ServerThread(m.app, port=port).start()
    m.admin_scripts_url = t.url
    c.masters[0], c.master_threads[0] = m, t
    c._stopped_masters.discard(0)
    return m


def test_master_restarted_mid_offload_resumes(tmp_path):
    cold, state = tmp_path / "cold", tmp_path / "state"
    remote = {"type": "local", "root": str(cold)}
    c = PortCluster(str(tmp_path / "cluster"), n_volume_servers=3,
                    volume_size_limit=8 << 20, max_volumes=8,
                    pulse_seconds=0.3, tier_remote=remote,
                    tier_state_dir=str(state))
    try:
        vid, payloads = _fill(c.master_url, "crash", 24, SEED + 1)
        env = CommandEnv(c.master_url)
        env.acquire_lock()
        commands_ec.ec_encode(env, vid)
        env.close()
        # the transition persisted "offloading" and moved the first
        # holder's shards; then the master died
        c.master.tiering._set_state(vid, "offloading", "crash")
        first = next(i for i, s in enumerate(c.stores)
                     if vid in s.ec_volumes)
        done = c.admin(first, "/admin/tier_offload",
                       {"volume": vid, "remote": remote})
        assert done["moved_bytes"] > 0
        m = _restart_master(c, tier_enabled=True, tier_interval=0.3,
                            tier_remote=remote,
                            tier_state_dir=str(state),
                            tier_offload_after_idle=3600.0)
        assert m.tiering.states[vid]["state"] == "offloading"
        c.wait_for_nodes(3)
        _wait(lambda: _tier_state(c.master_url, vid) == "remote",
              msg="offload resumed")
        rec = m.tiering.snapshot()["recent"][0]
        assert (rec["transition"], rec["reason"], rec["ok"]) == \
            ("offload", "resume", True)
        by_server = {r["server"]: r for r in rec["detail"]["servers"]}
        first_url = f"{c.stores[first].ip}:{c.stores[first].port}"
        assert by_server[first_url]["moved_bytes"] == 0
        assert sorted(_files(cold)) == \
            [f"tier-ec/crash/{vid}/{sid:02d}.ec" for sid in range(14)]
        for fid, data in payloads.items():
            assert _read_retrying(c.master_url, fid) == data
    finally:
        c.stop()


def _lost_cold_holder(cluster, tmp_path, stop_server) -> dict:
    """Seal and offload one volume, stop the holder of the fewest
    shards, and follow the volume until it is remote again."""
    url = cluster.master_url
    vid, payloads = _fill(url, "lost", 24, SEED + 2)
    _wait(lambda: _tier_state(url, vid) == "remote", msg="offloaded")
    cold = tmp_path / "cold"
    objects = _files(cold)
    shards = requests.get(f"{url}/cluster/ec_shards",
                          params={"volumeId": vid}, timeout=5).json()
    held: dict[str, list] = {}
    for sid, urls in shards["shards"].items():
        held.setdefault(urls[0], []).append(int(sid))
    victim = min(held, key=lambda u: (len(held[u]), u))
    stop_server(victim)
    seen = []

    def remote_again():
        snap = requests.get(f"{url}/debug/tiering", timeout=5).json()
        st = snap["volumes"].get(str(vid), {}).get("state")
        if not seen or seen[-1] != st:
            seen.append(st)
        offloads = sum(1 for r in snap["recent"]
                       if r["transition"] == "offload" and r["ok"])
        locs = requests.get(f"{url}/cluster/ec_shards",
                            params={"volumeId": vid}, timeout=5).json()
        return st == "remote" and offloads == 2 and \
            len(locs["shards"]) == 14 and \
            victim not in {u for us in locs["shards"].values()
                           for u in us}

    _wait(remote_again, timeout=60, msg="remote again", interval=0.05)
    for fid, data in payloads.items():
        assert _read_retrying(url, fid) == data
    snap = requests.get(f"{url}/debug/tiering", timeout=5).json()
    st = snap["volumes"][str(vid)]
    return {"objects_before": objects, "objects_after": _files(cold),
            "lost": sorted(held[victim]), "states_seen": seen,
            "final": (st["state"], st["transitions"]),
            "offloads": sum(1 for r in snap["recent"]
                            if r["transition"] == "offload" and r["ok"])}


@pytest.mark.parametrize("pkg", ["reference", "port"])
def test_lost_cold_holder_rebuilt_and_offloaded_again(pkg, tmp_path):
    kw = dict(n_volume_servers=4, volume_size_limit=8 << 20,
              max_volumes=8, pulse_seconds=0.3, with_filer=True,
              repair_enabled=True, repair_interval=0.3, repair_grace=0.0,
              tier_enabled=True, tier_interval=0.3,
              tier_seal_after_idle=1.0, tier_offload_after_idle=1.0,
              tier_recall_reads=1 << 30, tier_recall_window=60.0,
              tier_remote={"type": "local",
                           "root": str(tmp_path / "cold")},
              tier_state_dir=str(tmp_path / "state"))
    if pkg == "reference":
        c = ref_cluster_mod.Cluster(str(tmp_path / "c"), ec_backend="numpy",
                                    **kw)
    else:
        c = PortCluster(str(tmp_path / "c"), **kw)
    try:
        by_url = {f"{s.ip}:{s.port}": i for i, s in enumerate(c.stores)}
        out = _lost_cold_holder(
            c, tmp_path, lambda u: c.volume_threads[by_url[u]].stop())
    finally:
        c.stop()
    # the same 14 keys, the rebuilt shards' objects equal the lost ones
    assert out["objects_after"] == out["objects_before"]
    assert len(out["objects_after"]) == 14
    assert 0 < len(out["lost"]) <= 4
    # the rebuilt shards are local: the volume reads ec, is adopted as
    # ec, and the second offload makes it remote again
    assert out["states_seen"][0] == "remote"
    assert "ec" in out["states_seen"] and out["final"][0] == "remote"
    assert out["offloads"] == 2


def _gauge(text: str, name: str, collection: str) -> float:
    """The gauge of one collection. Both packages keep their gauges
    process-wide, so an earlier cluster's collections stay listed."""
    head = f'{name}{{collection="{collection}"}} '
    for line in text.splitlines():
        if line.startswith(head):
            return float(line.rsplit(" ", 1)[1])
    raise KeyError(head)


def test_volume_server_metrics_count_ec_bytes(tmp_path):
    """The volume servers' /metrics, which the federator scrapes: the
    EC gauges of one sealed volume. The reference's
    `volume_server_ec_bytes` reads 0 (it calls the `shard_size`
    property, and the TypeError is swallowed); the port's counts the
    shard bytes."""
    out = {}
    for name, mk in (("reference", functools.partial(
            ref_cluster_mod.Cluster, ec_backend="numpy")),
            ("port", PortCluster)):
        c = mk(str(tmp_path / name), n_volume_servers=1,
               volume_size_limit=8 << 20)
        try:
            vid, _ = _fill(c.master_url, "m", 8, SEED + 3)
            env = CommandEnv(c.master_url)
            env.acquire_lock()
            run_command(env, f"ec.encode -volumeId={vid}")
            env.close()
            text = requests.get(f"{c.volume_url(0)}/metrics",
                                timeout=10).text
            ecv = c.stores[0].ec_volumes[vid]
            out[name] = (_gauge(text, "volume_server_ec_shards", "m"),
                         _gauge(text, "volume_server_ec_bytes", "m"), ecv)
        finally:
            c.stop()
    assert out["port"][0] == out["reference"][0] == 14
    assert out["reference"][1] == 0
    with pytest.raises(TypeError):
        out["reference"][2].shard_size()
    assert out["port"][1] == 14 * out["port"][2].shard_size > 0
