"""The port's seeded fault injection (seaweedfs_tpu_torch/utils/faults.py)
against the JAX package's.

* The 13 cases of tests/test_faults_spec.py run on the port
  (tests/torch_port_cases.py rebinds `faults`); the parametrized one
  once per malformed spec.
* The same spec and seed give the same decision sequence in both
  packages, with the same counters (tolerance 0), for every hop class
  of the chaos spec; both packages parse, refuse and format the same
  specs the same way.
* The server middleware: for the same spec and seed, a port App and a
  reference aiohttp app answer the same requests with the same statuses,
  bodies and headers (503 + X-Sw-Retryable + Retry-After: 0 before the
  handler runs), skip the same paths and sleep the same delays.
"""
import random
import time

import pytest
import requests
from aiohttp import web

from seaweedfs_tpu.rpc.http import ServerThread as RefServerThread
from seaweedfs_tpu.utils import faults as ref_faults
from seaweedfs_tpu_torch.rpc import http as rhttp
from seaweedfs_tpu_torch.utils import faults

from tests import test_faults_spec as ref_cases
from tests.torch_port_cases import expand_params, port_cases, run_case

CHAOS_SPEC = ("volume:*:error=0.05,filer:*:error=0.05,"
              "volume:*:delay=30ms,filer:*:delay=30ms")
SEED = 20240817

CASES = port_cases(ref_cases, faults=faults)
PARAMS = expand_params(ref_cases, CASES)


@pytest.fixture(autouse=True)
def _restore():
    """The registries are process-global: leave both unconfigured."""
    yield
    faults.configure(spec=None)
    ref_faults.configure(spec=None)


@pytest.mark.parametrize("case", list(PARAMS))
def test_faults_spec_cases_on_the_port(case):
    name, kwargs = PARAMS[case]
    run_case(CASES[name], kwargs)


@pytest.mark.parametrize("spec,seed", [
    (CHAOS_SPEC, SEED),
    ("volume:read:error=0.3,*:write:error=0.2", 7),
    ("*:*:error=1.0,master:*:delay=2s", 0),
    ("filer:*:delay=500us,s3:write:error=0.5", 123456789),
])
def test_same_seed_same_decisions(spec, seed):
    ref, port = ref_faults.FaultRegistry(), faults.FaultRegistry()
    ref.configure(spec, seed=seed)
    port.configure(spec, seed=seed)
    rng = random.Random(seed)
    hops = [(rng.choice(["volume", "filer", "master", "s3", "httpclient"]),
             rng.choice(["read", "write"])) for _ in range(2000)]
    assert [port.decide(*h) for h in hops] == [ref.decide(*h) for h in hops]
    assert port._counts == ref._counts


def test_process_registry_and_hooks_match():
    """configure / sync_hook / counts through the module-level
    registry give the same outcomes and counters in both packages."""
    spec = "httpclient:*:error=0.3,httpclient:read:delay=1us"
    out = []
    for mod in (ref_faults, faults):
        mod.configure(spec, seed=SEED)
        seq = []
        for i in range(300):
            try:
                mod.sync_hook("httpclient", "GET" if i % 3 else "POST")
                seq.append(False)
            except mod.FaultInjected:
                seq.append(True)
        out.append((seq, mod.counts(), mod.enabled()))
        mod.configure(spec=None)
    assert out[1] == out[0]
    assert any(out[1][0]) and not all(out[1][0])


@pytest.mark.parametrize("spec", [
    CHAOS_SPEC, " volume:read:error=0.1 , ,", "a:*:delay=0.25",
    "s3:write:delay=2s,master:read:error=1", "x:*:delay=1.5ms",
    "volume:read", "volume:launch:error=0.1", "volume:read:error=0",
    "volume:read:delay=-5ms", "volume:read:explode=1",
])
def test_parse_and_format_match(spec):
    def run(mod):
        try:
            rules = mod.parse_spec(spec)
        except mod.FaultSpecError as e:
            return "error", str(e)
        return [tuple(vars(r).values()) for r in rules], \
            mod.format_spec(rules)
    assert run(faults) == run(ref_faults)


# -- the server middleware --------------------------------------------------

def _port_app(calls):
    def handle_x(req):
        calls.append(req.method)
        return rhttp.text_response("ok\n")

    app = rhttp.App(middlewares=rhttp.server_middlewares("volume"))
    for m in ("GET", "POST"):
        app.route(m, "/x", handle_x)
    app.get("/status", handle_x)
    return app


def _ref_app(calls):
    from seaweedfs_tpu.utils import retry as ref_retry
    from seaweedfs_tpu.utils import tracing as ref_tracing

    async def handle_x(req):
        calls.append(req.method)
        return web.Response(text="ok\n")

    app = web.Application(middlewares=[
        ref_tracing.aiohttp_middleware("volume"),
        ref_retry.aiohttp_middleware("volume"),
        ref_faults.aiohttp_middleware("volume")])
    app.router.add_get("/x", handle_x)
    app.router.add_post("/x", handle_x)
    app.router.add_get("/status", handle_x)
    return app


def _drive(url, n=60):
    out = []
    for i in range(n):
        path = "/status" if i % 10 == 9 else "/x"
        r = (requests.get if i % 2 else requests.post)(url + path,
                                                       timeout=10)
        out.append((path, r.status_code, r.text,
                    r.headers.get("X-Sw-Retryable"),
                    r.headers.get("Retry-After")))
    return out


def test_server_middleware_matches_the_reference():
    spec = "volume:*:error=0.3"
    calls = {"ref": [], "port": []}
    ref_faults.configure(spec, seed=SEED)
    t = RefServerThread(_ref_app(calls["ref"])).start()
    try:
        ref_out = _drive(t.url)
    finally:
        t.stop()
    ref_counts = ref_faults.counts()
    faults.configure(spec, seed=SEED)
    t = rhttp.ServerThread(_port_app(calls["port"])).start()
    try:
        port_out = _drive(t.url)
    finally:
        t.stop()
    assert port_out == ref_out
    assert faults.counts() == ref_counts
    assert calls["port"] == calls["ref"]
    injected = [o for o in port_out if o[1] == 503]
    assert injected and all(o[2:] == ("fault injected\n", "1", "0")
                            for o in injected)
    # /status is never injected, and an injected 503 never ran the
    # handler
    assert all(o[1] == 200 for o in port_out if o[0] == "/status")
    assert len(calls["port"]) == len(port_out) - len(injected)


def test_server_middleware_delay_before_the_handler():
    faults.configure("volume:read:delay=200ms", seed=0)
    t = rhttp.ServerThread(_port_app([])).start()
    try:
        t0 = time.monotonic()
        assert requests.get(t.url + "/x", timeout=10).status_code == 200
        slow = time.monotonic() - t0
        t0 = time.monotonic()
        assert requests.post(t.url + "/x", timeout=10).status_code == 200
        fast = time.monotonic() - t0
    finally:
        t.stop()
    assert slow >= 0.2 > fast
    assert faults.counts() == {"volume:delay": 1}
