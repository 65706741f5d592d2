"""The port's span collector (seaweedfs_tpu_torch/master/collector.py
`SpanCollector`), span pusher (rpc/trace_push.py) and the master's
/cluster/traces routes, against the JAX package's.

* 30 of the 33 cases of tests/test_trace_collector.py run on the port
  unchanged (tests/torch_port_cases.py rebinds the collector, the
  pusher, the master, `ServerThread`, `metrics` and `tracing`).
  TestSpanPusher.test_end_to_end_push races its pusher (it reads the
  pushed counter as soon as the master holds the push, before the
  pusher has read the reply; ROADMAP Queue 3 item 1 lists it): it runs
  here with the same assertions once the counter moved. Left out:
  TestMetricsPushThread's two cases, which drive the pushgateway loop
  of utils/metrics.py that the port does not have.
* The same span batches give the same stitched trees, summaries, OTLP
  documents and observability blocks in both packages (tolerance 0,
  the push lag masked), and the same store after tail-based eviction.
* The same pushes to a reference and a port master give the same
  /cluster/traces JSON, OTLP and 404s.
* Each package's pusher and client drive the other's /cluster/traces
  and /cluster/traces/push.
"""
import random
import time

import pytest
import requests

from seaweedfs_tpu.master import collector as ref_collector
from seaweedfs_tpu.rpc.http import ServerThread as RefServerThread
from seaweedfs_tpu.rpc.trace_push import SpanPusher as RefSpanPusher
from seaweedfs_tpu.server.master_server import MasterServer as RefMaster
from seaweedfs_tpu.utils import tracing as ref_tracing
from seaweedfs_tpu_torch.master import collector
from seaweedfs_tpu_torch.rpc.http import ServerThread
from seaweedfs_tpu_torch.rpc.httpclient import session
from seaweedfs_tpu_torch.rpc.trace_push import SpanPusher
from seaweedfs_tpu_torch.server.master_server import MasterServer
from seaweedfs_tpu_torch.utils import metrics, tracing

from tests import test_trace_collector as ref_cases
from tests.torch_port_cases import port_cases, run_case

CASES = port_cases(
    ref_cases, MAX_SPANS_PER_TRACE=collector.MAX_SPANS_PER_TRACE,
    OTLP_SCOPE=collector.OTLP_SCOPE,
    MetricsFederator=collector.MetricsFederator,
    SpanCollector=collector.SpanCollector,
    _family_of=collector._family_of,
    _inject_instance=collector._inject_instance,
    ServerThread=ServerThread, SpanPusher=SpanPusher,
    MasterServer=MasterServer, metrics=metrics, tracing=tracing,
    skip=("TestMetricsPushThread.test_stop_before_start_is_noop",
          "TestMetricsPushThread.test_start_stop_start_cycle",
          "TestSpanPusher.test_end_to_end_push"))


@pytest.fixture
def sample_config():
    rate = tracing.sample_rate()
    yield
    tracing.configure(sample_rate=rate)


@pytest.fixture(scope="module")
def master_srv():
    m = MasterServer(pulse_seconds=0.4, scrape_interval=3600.0)
    t = ServerThread(m.app).start()
    yield m, t
    t.stop()


@pytest.mark.parametrize("case", list(CASES))
def test_trace_collector_cases_on_the_port(case, master_srv,
                                           sample_config):
    run_case(CASES[case], {"master_srv": master_srv,
                           "sample_config": None})


def test_end_to_end_push_once_counted(master_srv, sample_config):
    """TestSpanPusher.test_end_to_end_push, waiting for the pusher to
    count its push as well as for the master to hold it."""
    m, t = master_srv
    tracing.configure(sample_rate=1.0)
    counter = ref_cases._counter.__code__
    pushed = type(ref_cases._counter)(counter, {"metrics": metrics})
    sp = SpanPusher(t.url, "unittest", "unit:1", interval=0.2)
    sp.start()
    try:
        pushed0 = pushed("trace_spans_pushed_total")
        with tracing.span("unit-root", service="unittest",
                          kind="server") as rec:
            pass
        tid = rec["trace_id"]
        deadline = time.time() + 10
        while time.time() < deadline:
            if "unit:1" in m.collector.observability()["Pushers"] and \
                    pushed("trace_spans_pushed_total") > pushed0:
                break
            time.sleep(0.05)
        assert m.collector.get_trace(tid) is not None
        assert pushed("trace_spans_pushed_total") > pushed0
        st = m.collector.observability()["Pushers"]["unit:1"]
        assert st["Service"] == "unittest"
        assert st["SpansDropped"] == 0
    finally:
        sp.stop()


# -- the same batches, both collectors ----------------------------------------

def _batches(seed: int) -> list[tuple[str, str, list[dict], int]]:
    """Seeded push batches: traces over several instances, out of
    order, with errors, slow spans, unknown kinds and junk."""
    rng = random.Random(seed)
    out = []
    for _ in range(120):
        tid = "%032x" % rng.getrandbits(128)
        root = "%016x" % rng.getrandbits(64)
        spans = [{"trace_id": tid, "span_id": root, "parent_id": "",
                  "service": "s3", "name": "dispatch", "kind": "server",
                  "peer": "10.0.0.9", "start": 1.7e9 + rng.random(),
                  "duration": rng.choice([0.01, 0.2, 1.5]),
                  "status": rng.choice(["200", "200", "error", "404"])}]
        for _ in range(rng.randrange(0, 5)):
            spans.append({
                "trace_id": tid, "span_id": "%016x" % rng.getrandbits(64),
                "parent_id": rng.choice([root, spans[-1]["span_id"]]),
                "service": rng.choice(["filer", "volume", "master"]),
                "name": rng.choice(["handle_put", "GET 10.0.0.2:8080",
                                    "ec.write_ec_files"]),
                "kind": rng.choice(["server", "client", "internal",
                                    "mystery"]),
                "peer": "", "start": 1.7e9 + rng.random(),
                "duration": rng.random() * 0.5, "status": "200"})
        rng.shuffle(spans)
        if rng.random() < 0.05:
            spans.append({"trace_id": ""})
        inst = rng.choice(["s3:8333", "filer:8888", "vol:8080"])
        out.append((inst, spans[0].get("service") or "s3", spans,
                    rng.randrange(0, 3)))
    return out


def _observability(c) -> dict:
    obs = c.observability()
    for st in obs["Pushers"].values():
        st.pop("PushLagSeconds")
    return obs


@pytest.mark.parametrize("seed", range(3))
def test_same_batches_same_store(seed):
    cols = [ref_collector.SpanCollector(max_traces=32, slow_threshold=1.0),
            collector.SpanCollector(max_traces=32, slow_threshold=1.0)]
    for inst, svc, spans, dropped in _batches(seed):
        accepted = [c.add_spans(inst, svc, [dict(s) for s in spans],
                                dropped=dropped) for c in cols]
        assert accepted[1] == accepted[0]
    ref, port = cols
    assert list(port._traces) == list(ref._traces)
    assert port.list_traces(limit=100) == ref.list_traces(limit=100)
    for tid in list(ref._traces):
        assert port.get_trace(tid) == ref.get_trace(tid)
    assert port.to_otlp(limit=100) == ref.to_otlp(limit=100)
    assert port.to_otlp(trace_ids=list(ref._traces)[:5]) == \
        ref.to_otlp(trace_ids=list(ref._traces)[:5])
    assert _observability(port) == _observability(ref)
    assert port.drain_otlp_pending(min_idle=0.0) == \
        ref.drain_otlp_pending(min_idle=0.0)


# -- the same pushes, both masters -------------------------------------------

@pytest.fixture(scope="module")
def masters():
    ref = RefMaster(pulse_seconds=0.4, scrape_interval=3600.0)
    ref_t = RefServerThread(ref.app).start()
    port = MasterServer(pulse_seconds=0.4, scrape_interval=3600.0)
    port_t = ServerThread(port.app).start()
    yield (ref, ref_t), (port, port_t)
    port_t.stop()
    ref_t.stop()


def test_same_pushes_same_cluster_traces(masters):
    (_, ref_t), (_, port_t) = masters
    batches = _batches(99)[:20]
    for url in (ref_t.url, port_t.url):
        for inst, svc, spans, dropped in batches:
            r = requests.post(f"{url}/cluster/traces/push", json={
                "instance": "push-" + inst, "service": svc,
                "spans": spans, "dropped": dropped}, timeout=10)
            assert r.status_code == 200
    tids = list(dict.fromkeys(s["trace_id"] for _, _, spans, _ in batches
                              for s in spans if s.get("trace_id")))

    def fetch(url):
        out = []
        for tid in tids:
            tree = requests.get(f"{url}/cluster/traces",
                                params={"trace_id": tid}, timeout=10)
            otlp = requests.get(f"{url}/cluster/traces",
                                params={"trace": tid, "format": "otlp"},
                                timeout=10)
            out.append((tree.status_code, tree.json(), otlp.json()))
        miss = requests.get(f"{url}/cluster/traces",
                            params={"trace": "f" * 32}, timeout=10)
        bad = [requests.post(f"{url}/cluster/traces/push", data=body,
                             timeout=10).status_code
               for body in (b"not json", b'{"spans": "nope"}')]
        return out, (miss.status_code, miss.json()), bad
    assert fetch(port_t.url) == fetch(ref_t.url)


def test_each_pusher_reaches_the_others_master(masters, sample_config):
    (ref, ref_t), (port, port_t) = masters
    tracing.configure(sample_rate=1.0)
    ref_tracing.configure(sample_rate=1.0)
    port_pusher = SpanPusher(ref_t.url, "porttest", "portpush:1",
                             interval=3600)
    ref_pusher = RefSpanPusher(port_t.url, "reftest", "refpush:1",
                               interval=3600)
    recs = {}
    for mod, pusher, name in ((tracing, port_pusher, "from-port"),
                              (ref_tracing, ref_pusher, "from-ref")):
        rec = {"trace_id": mod.new_trace_id(),
               "span_id": mod.new_span_id(), "parent_id": "",
               "service": name, "name": name, "kind": "server",
               "peer": "", "start": time.time(), "duration": 0.01,
               "status": "200"}
        pusher._enqueue(rec)
        assert pusher.flush() is True
        recs[name] = rec
    got = ref.collector.get_trace(recs["from-port"]["trace_id"])
    assert got["spans"] == 1 and got["tree"][0]["instance"] == "portpush:1"
    got = port.collector.get_trace(recs["from-ref"]["trace_id"])
    assert got["spans"] == 1 and got["tree"][0]["instance"] == "refpush:1"
    # each package's client reads the other's /cluster/traces
    body = session().get(f"{ref_t.url}/cluster/traces",
                         timeout=10).json()
    assert "portpush:1" in body["observability"]["Pushers"]
    body = requests.get(f"{port_t.url}/cluster/traces", timeout=10).json()
    assert "refpush:1" in body["observability"]["Pushers"]
    assert body["observability"]["Pushers"]["refpush:1"][
        "SpansDropped"] == 0
