"""Deterministic chaos on the port: seeded faults, retries, the edge
deadline and the breaker's trip and recovery, against the JAX
package's tests/test_chaos_deterministic.py and
tests/test_httpclient_retry.py.

* Two chaos cases run on the port (tests/torch_port_cases.py rebinds
  `Cluster`, `faults`, `retry` and `session`): S3 PUT/GET cycles under
  the reference's chaos spec (5% injected 503s and 30 ms delays on the
  filer and volume hops, seed 20240817, 5 attempts) all succeed with
  zero duplicate keys; the s3 edge refuses an expired client deadline
  before any work. The cycles are cut from the reference's 200 to
  `CYCLES` (60): the injected delays alone cost ~0.12 s a cycle, and
  200 took 32 s on the CPU. chip_smoke.py phase 13e runs the 200.
* The other two import inside their body what the port swaps out
  (aiohttp for the revived listener; the reference's Store with its
  "jax" backend), so they run here with the same assertions on the
  port's objects: the breaker trips on a dead peer (the master's
  /debug/breakers shows it open and trips >= 1), refuses fast while
  open, closes on the half-open probe once a listener is back on the
  port, and the topology dump carries every node's breaker; a degraded
  read's interval reconstruct is pinned to the CPU codec while
  whole-volume work keeps the device codec.
* tests/test_httpclient_retry.py's two cases, on the port's client: a
  503 abandoned for a retry is closed (its connection is not reused),
  the returned response is not; when every attempt answers 503 the
  last one comes back open with its body.
"""
import functools
import socket
import threading
import time
import types

import pytest
import requests

from seaweedfs_tpu_torch.ec.backend import cpu_backend_name
from seaweedfs_tpu_torch.ops.codec_cuda import CudaCodec
from seaweedfs_tpu_torch.rpc import http as rhttp
from seaweedfs_tpu_torch.rpc import httpclient
from seaweedfs_tpu_torch.rpc.httpclient import session
from seaweedfs_tpu_torch.server.cluster import Cluster
from seaweedfs_tpu_torch.storage.store import Store
from seaweedfs_tpu_torch.utils import faults, retry

from tests import test_chaos_deterministic as ref_cases
from tests.torch_port_cases import port_cases, run_case

PortCluster = functools.partial(Cluster, ec_backend="native")
CYCLES = 60
CASES = port_cases(
    ref_cases, Cluster=PortCluster, faults=faults, retry=retry,
    CYCLES=CYCLES,
    session=session, ServerThread=rhttp.ServerThread,
    skip=("TestBreakerTripAndRecover."
          "test_breaker_trips_on_dead_peer_then_recovers",
          "TestDegradedReadCodecPin."
          "test_interval_reconstruct_pinned_to_cpu_codec"))


@pytest.fixture(autouse=True)
def _restore():
    """The registries are process-global: every case leaves them as
    the reference's `_chaos` does."""
    yield
    faults.configure(spec=None)
    retry.configure(max_attempts=3, breaker_failures=5, breaker_reset=5.0)
    retry.reset_breakers()


@pytest.mark.parametrize("case", list(CASES))
def test_chaos_cases_on_the_port(case, tmp_path):
    run_case(CASES[case], {"tmp_path": tmp_path})


def test_breaker_trips_on_dead_peer_then_recovers(tmp_path):
    c = PortCluster(str(tmp_path), n_volume_servers=1,
                    volume_size_limit=64 << 20)
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    peer = f"127.0.0.1:{port}"
    retry.reset_breakers()
    retry.configure(breaker_failures=3, breaker_reset=0.3)
    try:
        sess = session()
        for _ in range(6):
            with pytest.raises(OSError):
                sess.get(f"http://{peer}/ping", timeout=2)
        snap = {b["peer"]: b for b in requests.get(
            f"{c.master_url}/debug/breakers", timeout=10
        ).json()["breakers"]}
        assert snap[peer]["state"] == retry.OPEN, snap
        assert snap[peer]["trips"] >= 1
        # while open: fail fast, no connect attempted
        t0 = time.monotonic()
        with pytest.raises(retry.BreakerOpenError):
            sess.get(f"http://{peer}/ping", timeout=2)
        assert time.monotonic() - t0 < 0.5
        # the peer comes back on the same port; after reset_timeout the
        # half-open probe succeeds and the breaker closes
        app = rhttp.App()
        app.get("/ping", lambda req: rhttp.text_response("pong"))
        revived = rhttp.ServerThread(app, port=port).start()
        try:
            time.sleep(0.35)
            r = sess.get(f"http://{peer}/ping", timeout=5)
            assert r.status_code == 200
            snap = {b["peer"]: b for b in requests.get(
                f"{c.master_url}/debug/breakers", timeout=10
            ).json()["breakers"]}
            assert snap[peer]["state"] == retry.CLOSED, snap
        finally:
            revived.stop()
        # breaker state also rides the master topology dump
        topo = requests.get(f"{c.master_url}/dir/status",
                            timeout=10).json()["Topology"]
        nodes = [n for dc in topo["datacenters"]
                 for r in dc["racks"] for n in r["nodes"]]
        assert nodes and all(
            n["breaker"] in (retry.CLOSED, retry.OPEN, retry.HALF_OPEN)
            for n in nodes), topo
    finally:
        c.stop()


def test_interval_reconstruct_pinned_to_cpu_codec(tmp_path):
    device = CudaCodec(device="cpu")
    store = Store([str(tmp_path)], ip="127.0.0.1", port=0,
                  ec_backend=device)
    ecv = types.SimpleNamespace(k=10, m=4)
    rs = store._rs_for(ecv, interval=True)
    assert rs.backend.name == cpu_backend_name()
    assert rs.backend.name in ("native", "numpy")
    assert rs.backend is not device
    # whole-volume ops keep the configured device backend
    assert store._rs_for(ecv).backend is device


# -- tests/test_httpclient_retry.py on the port's client ----------------------

def _statuses_app(statuses: list[int]):
    """Answers /x with the next status of `statuses` (the last one
    repeats), its body naming the attempt."""
    served = []
    lock = threading.Lock()

    def handle_x(req):
        with lock:
            i = len(served)
            served.append(i)
        code = statuses[min(i, len(statuses) - 1)]
        return rhttp.text_response(f"attempt {i}", status=code)

    app = rhttp.App()
    app.get("/x", handle_x)
    return app, served


def test_status_retry_closes_abandoned_response(monkeypatch):
    app, served = _statuses_app([503, 200])
    t = rhttp.ServerThread(app).start()
    closed = []
    orig_close = httpclient.Response.close

    def close(self):
        closed.append(self.status_code)
        return orig_close(self)
    monkeypatch.setattr(httpclient.Response, "close", close)
    try:
        resp = httpclient.Session().request("GET", t.url + "/x")
        assert resp.status_code == 200 and resp.text == "attempt 1"
        assert len(served) == 2
        assert closed == [503], \
            "the abandoned 503 must be closed, not left on the pool"
    finally:
        t.stop()


def test_exhausted_status_retries_return_last_response_open():
    app, served = _statuses_app([503])
    t = rhttp.ServerThread(app).start()
    try:
        resp = httpclient.Session().request("GET", t.url + "/x",
                                            stream=True)
        assert resp.status_code == 503
        assert len(served) == retry.policy().max_attempts
        # returned open: the caller can still read the error body
        assert resp.content == f"attempt {len(served) - 1}".encode()
    finally:
        t.stop()
