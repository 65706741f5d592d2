"""The port of tests/test_chaos_rack_loss.py: whole-rack-kill chaos
against the port's cluster, with the same markers.

Six volume servers across three racks, replication 010 (one replica in
a second rack), a bandwidth-shaped watchdog.  Kill EVERY node in rack B
mid-workload and require datacenter-grade behaviour:

* repair completes and every repaired volume is rack-spread again —
  zero placement violations (the new replica never lands beside the
  survivor while another rack has slots);
* repair traffic stays inside -repair.maxBytesPerSec (token-bucket
  admission measured over the whole outage window);
* zero acked-write loss: every payload acked before the kill reads
  back from every live replica afterwards;
* foreground reads sampled DURING the repair stay inside the SLO.
"""
import time

import numpy as np
import pytest

from seaweedfs_tpu_torch.operation import verbs
from seaweedfs_tpu_torch.ops.codec_cuda import CudaCodec
from seaweedfs_tpu_torch.rpc.httpclient import session
from seaweedfs_tpu_torch.server.cluster import Cluster
from seaweedfs_tpu_torch.utils import metrics, ratelimit

pytestmark = [pytest.mark.chaos, pytest.mark.rackloss]

CAP = 400_000.0  # repair bytes/s per node bucket
TOPOLOGY = [("dc1", "rA"), ("dc1", "rA"),
            ("dc1", "rB"), ("dc1", "rB"),
            ("dc1", "rC"), ("dc1", "rC")]
DEAD = (2, 3)  # rack B
FOREGROUND_P99_SLO = 2.0  # generous: in-process servers on shared CPU


@pytest.fixture()
def cluster(tmp_path):
    ratelimit.reset()
    c = Cluster(str(tmp_path), n_volume_servers=6,
                pulse_seconds=0.3, volume_size_limit=8 << 20,
                default_replication="010", topology=TOPOLOGY,
                repair_enabled=True, repair_interval=0.5,
                repair_max_bytes_per_sec=CAP,
                ec_backend=CudaCodec(device="cpu"))
    yield c
    c.stop()


def _status(cluster):
    return session().get(cluster.master_url + "/cluster/status",
                         timeout=5).json()


def _locations(cluster, vid):
    r = session().get(cluster.master_url + "/dir/lookup",
                      params={"volumeId": str(vid)}, timeout=5).json()
    return [loc["url"] for loc in r.get("locations", [])]


def _bw_total():
    return metrics._counters.get(("repair_bw_bytes_total", ()), 0.0)


def test_rack_kill_repairs_shaped_spread_and_lossless(cluster):
    rack_of = {cluster.stores[i].public_url: TOPOLOGY[i][1]
               for i in range(6)}
    dead_urls = {cluster.stores[i].public_url for i in DEAD}
    rng = np.random.default_rng(5)
    payloads = {}
    # one volume per collection; keep writing until rack B holds a
    # replica of at least 3 volumes so the kill forces real repair
    affected = set()
    for ci in range(15):
        col = f"rackloss{ci}"
        for _ in range(4):
            a = verbs.assign(cluster.master_url, collection=col)
            data = rng.bytes(int(rng.integers(10_000, 40_000)))
            verbs.upload(a, data)
            payloads[a.fid] = data
        vid = int(a.fid.split(",")[0])
        if set(_locations(cluster, vid)) & dead_urls:
            affected.add(vid)
        if len(affected) >= 3:
            break
    assert len(affected) >= 3, "rack B never got replicas"
    vids = sorted({int(f.split(",")[0]) for f in payloads})
    for vid in vids:  # the write path already spread every volume
        assert len({rack_of[u] for u in _locations(cluster, vid)}) == 2

    bw0 = _bw_total()
    assert _status(cluster)["RepairPlacementViolations"] == 0
    t0 = time.monotonic()
    for i in DEAD:
        cluster.volume_threads[i].stop()

    # poll for full recovery while running a foreground read workload
    fids = list(payloads)
    lat = []
    t_done = None
    deadline = time.monotonic() + 90
    while time.monotonic() < deadline:
        fid = fids[len(lat) % len(fids)]
        vid = int(fid.split(",")[0])
        live = [u for u in _locations(cluster, vid)
                if u not in dead_urls]
        if live:
            t = time.monotonic()
            r = session().get(f"http://{live[0]}/{fid}", timeout=10)
            lat.append(time.monotonic() - t)
            assert r.status_code == 200, fid
        healed = all(
            len(set(_locations(cluster, v)) - dead_urls) == 2
            for v in vids)
        if healed and not _status(cluster)["UnderReplicated"]:
            t_done = time.monotonic()
            break
        time.sleep(0.05)
    assert t_done is not None, "rack-B repair never completed"
    elapsed = t_done - t0

    # bandwidth cap: all shaped bytes over the outage window respect
    # rate*w + burst (+ one in-flight chunk per side of the copy)
    moved = _bw_total() - bw0
    assert moved > 0, "repair moved no bytes through the shaper"
    burst = max(64 << 10, CAP / 8)
    assert moved <= CAP * elapsed + 2 * burst + 2 * (1 << 20), \
        f"{moved} repair bytes in {elapsed:.2f}s exceeds the cap"

    # placement: every volume rack-spread again, nothing left on the
    # dead rack, and the master counted zero violations
    st = _status(cluster)
    assert st["RepairPlacementViolations"] == 0
    assert st["RepairMaxBytesPerSec"] == CAP
    assert st["RepairBandwidth"], "no node published repair_bw state"
    for vid in vids:
        locs = _locations(cluster, vid)
        assert not set(locs) & dead_urls
        assert len(locs) == 2
        assert len({rack_of[u] for u in locs}) == 2, \
            f"volume {vid} healed co-located: {locs}"

    # zero acked-write loss: every payload from every live replica
    for fid, data in payloads.items():
        for u in _locations(cluster, int(fid.split(",")[0])):
            assert session().get(f"http://{u}/{fid}",
                                 timeout=10).content == data

    # foreground SLO during the repair
    assert len(lat) >= 20, "foreground workload barely ran"
    p99 = float(np.percentile(lat, 99))
    assert p99 <= FOREGROUND_P99_SLO, f"foreground p99 {p99:.3f}s"
