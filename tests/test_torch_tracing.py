"""The port's server-side tracing (seaweedfs_tpu_torch/utils/tracing.py
`middleware`, `handle_debug_traces`) against the JAX package's.

* The 10 cases of tests/test_tracing.py run on the port
  (tests/torch_port_cases.py rebinds `tracing`, `glog`, `metrics` and
  `Cluster`): traceparent, the ring, spans, the slow-request log and
  one trace across S3 -> filer -> volume, with /debug/traces on every
  server and `request_trace_seconds{handler="dispatch",service="s3"}`.
* Both packages parse and format the same traceparent headers alike.
* The server middleware records the same server span for the same
  request (name, kind, service, status, trace and parent ids; the span
  id, clock and peer masked), and skips the same paths.
* The same S3 requests to a reference and a port cluster give traces of
  the same shape: the same (service, kind, name, status) spans in the
  same order, peers masked.
* Each package's client reads the other's /debug/traces, in both forms.
"""
import functools
import random
import re
import time

import pytest
import requests
from aiohttp import web

from seaweedfs_tpu.rpc.http import ServerThread as RefServerThread
from seaweedfs_tpu.server.cluster import Cluster as RefCluster
from seaweedfs_tpu.utils import tracing as ref_tracing
from seaweedfs_tpu_torch.rpc import http as rhttp
from seaweedfs_tpu_torch.rpc.httpclient import session
from seaweedfs_tpu_torch.server.cluster import Cluster
from seaweedfs_tpu_torch.utils import glog, metrics, tracing

from tests import test_tracing as ref_cases
from tests.torch_port_cases import expand_params, port_cases, run_case

PortCluster = functools.partial(Cluster, ec_backend="native")
CASES = port_cases(ref_cases, tracing=tracing, glog=glog, metrics=metrics,
                   Cluster=PortCluster)
PARAMS = expand_params(ref_cases, CASES)


@pytest.fixture
def trace_config():
    """The reference's fixture, on the port's knobs: snapshot and
    restore tracing's settings and ring."""
    slow, size = tracing._slow_threshold, tracing._buffer_size
    yield
    tracing.configure(slow_threshold=slow, buffer_size=size)
    tracing.reset()


@pytest.mark.parametrize("case", list(PARAMS))
def test_tracing_cases_on_the_port(case, trace_config, monkeypatch,
                                   tmp_path_factory):
    name, kwargs = PARAMS[case]
    run_case(CASES[name], dict(kwargs, trace_config=None,
                               monkeypatch=monkeypatch,
                               tmp_path_factory=tmp_path_factory))


@pytest.mark.parametrize("seed", range(4))
def test_traceparent_parse_and_format_match(seed):
    rng = random.Random(seed)
    alphabet = "0123456789abcdefABCDEFxz-"
    headers = []
    for _ in range(300):
        tid = "".join(rng.choice(alphabet[:16]) for _ in range(32))
        sid = "".join(rng.choice(alphabet[:16]) for _ in range(16))
        h = f"{rng.choice(['00', '01', 'ff', '0g'])}-{tid}-{sid}-" \
            f"{rng.choice(['01', '00', 'zz'])}"
        if rng.random() < 0.3:      # corrupt one character
            i = rng.randrange(len(h))
            h = h[:i] + rng.choice(alphabet) + h[i + 1:]
        if rng.random() < 0.1:
            h += "-extra"
        headers.append(h)

    def run(mod):
        out = []
        for h in headers:
            ctx = mod.parse_traceparent(h)
            out.append(None if ctx is None else
                       (ctx.trace_id, ctx.span_id, ctx.flags,
                        mod.format_traceparent(ctx)))
        return out
    assert run(tracing) == run(ref_tracing)


# -- the server middleware --------------------------------------------------

def _mask(rec: dict) -> dict:
    """A span without its random or clock fields (a root's trace id
    is fresh)."""
    drop = {"span_id", "start", "duration", "peer", "children"}
    if not rec["parent_id"]:
        drop.add("trace_id")
    return {k: v for k, v in rec.items() if k not in drop}


def test_server_span_matches_the_reference(trace_config):
    parent = "00-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-01"

    def handle_thing(req):
        return rhttp.json_error("nope", status=418)

    async def ref_handle_thing(req):
        return web.json_response({"error": "nope"}, status=418)
    ref_handle_thing.__name__ = "handle_thing"

    port_app = rhttp.App(middlewares=rhttp.server_middlewares("volume"))
    port_app.get("/thing", handle_thing)
    port_app.get("/metrics", handle_thing)
    from seaweedfs_tpu.utils import faults as ref_faults
    from seaweedfs_tpu.utils import retry as ref_retry
    ref_app = web.Application(middlewares=[
        ref_tracing.aiohttp_middleware("volume"),
        ref_retry.aiohttp_middleware("volume"),
        ref_faults.aiohttp_middleware("volume")])
    ref_app.router.add_get("/thing", ref_handle_thing)
    ref_app.router.add_get("/metrics", ref_handle_thing)
    got = []
    for mod, app, server in ((ref_tracing, ref_app, RefServerThread),
                             (tracing, port_app, rhttp.ServerThread)):
        mod.reset()
        t = server(app).start()
        try:
            for path in ("/thing", "/metrics"):
                r = requests.get(t.url + path,
                                 headers={"traceparent": parent},
                                 timeout=10)
                assert r.status_code == 418
            requests.get(t.url + "/thing", timeout=10)
        finally:
            t.stop()
        spans = [s for tr in mod.traces_json(10) for s in tr["spans"]]
        got.append(sorted((_mask(s) for s in spans),
                          key=lambda s: s["parent_id"]))
    assert got[1] == got[0]
    assert len(got[1]) == 2         # /metrics records none
    assert got[1][1]["trace_id"] == "0af7651916cd43dd8448eb211c80319c"
    assert got[1][1]["parent_id"] == "b7ad6b7169203331"
    assert got[1][1]["name"] == "handle_thing"
    assert got[1][1]["status"] == "418"


# -- traces of the same S3 requests in both packages -------------------------

@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    ref = RefCluster(str(tmp_path_factory.mktemp("ref_tr")),
                     n_volume_servers=1, volume_size_limit=16 << 20,
                     with_filer=True, with_s3=True)
    try:
        port = PortCluster(str(tmp_path_factory.mktemp("port_tr")),
                           n_volume_servers=1, volume_size_limit=16 << 20,
                           with_filer=True, with_s3=True)
    except BaseException:
        ref.stop()
        raise
    yield ref, port
    port.stop()
    ref.stop()


_PEER = re.compile(r" 127\.0\.0\.1:\d+$")


def _shape(trace: dict) -> list[tuple]:
    return [(s["service"], s["kind"], _PEER.sub(" peer", s["name"]),
             s["status"]) for s in trace["spans"]]


def test_same_requests_same_trace_shapes(pair):
    shapes = []
    for c, mod in zip(pair, (ref_tracing, tracing)):
        requests.put(f"{c.s3_url}/shape", timeout=10)
        requests.put(f"{c.s3_url}/shape/k", data=b"traced" * 50,
                     timeout=10)
        mod.reset()
        assert requests.get(f"{c.s3_url}/shape/k",
                            timeout=10).content == b"traced" * 50
        assert requests.get(f"{c.s3_url}/shape/none",
                            timeout=10).status_code == 404
        time.sleep(0.2)
        shapes.append(sorted(_shape(t) for t in mod.traces_json(10)
                             if t["spans"][0]["service"] == "s3"))
    assert shapes[1] == shapes[0]
    services = {s[0] for tr in shapes[1] for s in tr}
    assert {"s3", "filer", "master", "volume"} <= services


def test_each_client_reads_the_others_debug_traces(pair):
    ref, port = pair
    for url, get in ((port.s3_url, requests.get),
                     (ref.s3_url, session().get),
                     (port.master_url, requests.get),
                     (ref.volume_url(0), session().get)):
        body = get(url + "/debug/traces", params={"limit": 5},
                   timeout=10).json()
        assert set(body) == {"traces", "breakers"}
        assert isinstance(body["breakers"], list)
        assert len(body["traces"]) <= 5
        spans = get(url + "/debug/traces",
                    params={"limit": 3, "format": "spans"},
                    timeout=10).json()
        assert isinstance(spans, list) and len(spans) <= 3
        for t in spans:
            assert set(t) == {"trace_id", "spans"}
