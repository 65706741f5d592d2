"""The port's workload aggregator (seaweedfs_tpu_torch/master/workload.py)
and the master's /debug/workload, against the JAX package's.

* 25 of the 30 cases of tests/test_workload.py run on the port
  (tests/torch_port_cases.py rebinds the aggregator, the federator, the
  master, `ServerThread`, `Store`, `metrics` and `_sketch`): ingest,
  merges, staleness, the three advisors and their overrides, the gauges
  and the status fold; the Store's heat taps and heartbeat payload;
  federation staleness; the master's /debug index, /debug/workload GET
  and POST, the gauges in /metrics, the /cluster/status fold and the
  ?trace= alias. Left out: TestTenantDemand's five cases, which drive
  the gateways' tenant-demand sketches of utils/qos.py, not ported.
* The same heartbeats and the same federated scrape give the same
  snapshot, gauges and status fold in both packages (tolerance 0, the
  ages masked).
* The same heartbeat payloads and override POSTs to a reference and a
  port master give the same /debug/workload JSON and statuses, each
  driven by the other package's client.
"""
import random
import threading
import time

import pytest
import requests

from seaweedfs_tpu.master import workload as ref_workload
from seaweedfs_tpu.rpc.http import ServerThread as RefServerThread
from seaweedfs_tpu.server.master_server import MasterServer as RefMaster
from seaweedfs_tpu.utils import metrics as ref_metrics
from seaweedfs_tpu.utils import sketch as ref_sketch
from seaweedfs_tpu_torch.master import workload
from seaweedfs_tpu_torch.master.collector import MetricsFederator
from seaweedfs_tpu_torch.rpc.http import ServerThread
from seaweedfs_tpu_torch.rpc.httpclient import session
from seaweedfs_tpu_torch.server.master_server import MasterServer
from seaweedfs_tpu_torch.storage.store import Store
from seaweedfs_tpu_torch.utils import metrics
from seaweedfs_tpu_torch.utils import sketch

from tests import test_workload as ref_cases
from tests.torch_port_cases import port_cases, run_case

CASES = port_cases(
    ref_cases, WorkloadAggregator=workload.WorkloadAggregator,
    MetricsFederator=MetricsFederator, ServerThread=ServerThread,
    MasterServer=MasterServer, Store=Store, metrics=metrics,
    _sketch=sketch,
    skip=tuple(f"TestTenantDemand.{m}" for m in vars(
        ref_cases.TestTenantDemand) if m.startswith("test_")))


@pytest.fixture(autouse=True)
def _telemetry_on():
    """Both packages' telemetry pinned on; each restored after."""
    saved = [(m, m.enabled(), m.alpha(), m.window())
             for m in (sketch, ref_sketch)]
    for m in (sketch, ref_sketch):
        m.configure(enabled=True, alpha=0.01, window=300.0)
    yield
    for m, en, al, wi in saved:
        m.configure(enabled=en, alpha=al, window=wi)


@pytest.fixture(scope="module")
def master_srv():
    m = MasterServer(pulse_seconds=0.4, scrape_interval=3600.0)
    t = ServerThread(m.app).start()
    yield m, t
    t.stop()


@pytest.mark.parametrize("case", list(CASES))
def test_workload_cases_on_the_port(case, master_srv, tmp_path):
    run_case(CASES[case], {"master_srv": master_srv, "tmp_path": tmp_path})


# -- the same heartbeats, both aggregators -----------------------------------

def _payloads(mod_sketch, seed: int) -> list[tuple[str, dict]]:
    rng = random.Random(seed)
    out = []
    for i in range(12):
        vols = {}
        for vid in rng.sample(range(1, 9), rng.randrange(1, 4)):
            kinds = {}
            for k, scale in (("rg", 100.0), ("rs", 65536.0),
                             ("wg", 10.0), ("ws", 4096.0)):
                if rng.random() < 0.8:
                    s = mod_sketch.QuantileSketch(alpha=0.01)
                    for _ in range(rng.randrange(1, 200)):
                        s.record(rng.expovariate(1.0 / scale))
                    kinds[k] = s.to_dict()
            vols[str(vid)] = kinds
        out.append((f"10.0.0.{i % 5}:8080", {
            "alpha": 0.01, "volumes": vols,
            "fg_bps": rng.choice([0.0, 100.0, 5e6]),
            "peak_bps": rng.choice([0.0, 1e7, 2e7])}))
    return out


class _Federator:
    def __init__(self, texts):
        self._lock = threading.Lock()
        self._scraped = {f"gw:{i}": {"text": t, "ts": time.time(),
                                     "error": ""}
                         for i, t in enumerate(texts)}


class _Master:
    class tiering:
        seal_after_idle = 3600.0

    class watchdog:
        max_bytes_per_sec = 5e5

    def __init__(self, texts):
        self.federator = _Federator(texts)


SCRAPE = ('workload_tenant_rate_rps{tenant="acme"} 10\n'
          'workload_tenant_bytes_per_sec{tenant="acme"} 1000\n'
          'workload_tenant_provisioned_rate{tenant="acme"} 500\n'
          'workload_tenant_bytes{tenant="acme",q="0.99"} 4096\n'
          'workload_tenant_delay_seconds{tenant="beta",q="0.5"} 0.02\n')


def _masked(snap: dict) -> dict:
    for n in snap["nodes"].values():
        n.pop("age_seconds")
    return snap


def _gauges(mod) -> dict:
    with mod._lock:
        return {k: v for k, v in mod._gauges.items()
                if k[0].startswith("workload_")}


def _drop_workload_gauges(mod) -> None:
    """Forget the workload_* gauges earlier tests of this process set,
    so the comparison sees only this export."""
    with mod._lock:
        for k in [k for k in mod._gauges if k[0].startswith("workload_")]:
            del mod._gauges[k]


@pytest.mark.parametrize("seed", range(3))
def test_same_heartbeats_same_workload(seed):
    aggs = [ref_workload.WorkloadAggregator(_Master([SCRAPE]),
                                            seal_quantile=0.9),
            workload.WorkloadAggregator(_Master([SCRAPE]),
                                        seal_quantile=0.9)]
    for agg, mod_sketch in zip(aggs, (ref_sketch, sketch)):
        for node, payload in _payloads(mod_sketch, seed):
            agg.ingest(node, payload)
        agg.forget("10.0.0.4:8080")
        agg.set_override("repair", 42.0)
        agg.set_override("qos", 9.5, tenant="acme")
    ref, port = aggs
    assert _masked(port.snapshot()) == _masked(ref.snapshot())
    assert port.status_fold() == ref.status_fold()
    _drop_workload_gauges(metrics)
    _drop_workload_gauges(ref_metrics)
    ref.export_gauges()
    port.export_gauges()
    assert _gauges(metrics) == _gauges(ref_metrics)


@pytest.fixture(scope="module")
def masters():
    ref = RefMaster(pulse_seconds=0.4, scrape_interval=3600.0)
    ref_t = RefServerThread(ref.app).start()
    port = MasterServer(pulse_seconds=0.4, scrape_interval=3600.0)
    port_t = ServerThread(port.app).start()
    yield (ref, ref_t), (port, port_t)
    port_t.stop()
    ref_t.stop()


def test_same_posts_same_debug_workload(masters):
    (ref, ref_t), (port, port_t) = masters
    posts = [{"advisor": "seal", "override": 1234.5},
             {"advisor": "qos", "override": 7, "tenant": "acme"},
             {"advisor": "repair", "override": None},
             {"advisor": "seal", "override": -1},
             {"advisor": "nope", "override": 1},
             {"override": 1}, {"advisor": "seal"}, [1, 2]]
    out = []
    for (m, t), get, post in (((ref, ref_t), session().get,
                               session().post),
                              ((port, port_t), requests.get,
                               requests.post)):
        for node, payload in _payloads(ref_sketch, 7):
            m.workload.ingest(node, payload)
        statuses = [(r.status_code, r.json()) for r in
                    (post(t.url + "/debug/workload", json=b, timeout=10)
                     for b in posts)]
        snap = get(t.url + "/debug/workload", timeout=10).json()
        out.append((statuses, _masked(snap)))
    assert out[1] == out[0]
    assert out[1][1]["cluster"]["read_size"]["count"] > 0
