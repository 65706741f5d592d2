"""The port's circuit breakers (seaweedfs_tpu_torch/utils/retry.py) and
their use in the HTTP client, against the JAX package's.

* The 20 cases of tests/test_breaker.py run on the port
  (tests/torch_port_cases.py rebinds `retry`; the re-registration
  cases import the topology inside their body, which
  `swap_modules` points at the port's).
* The same sequence of events (failures, successes, probes,
  settlements, clock steps) gives the same snapshots in both packages
  at a pinned clock (tolerance 0), and `configure` moves both the same
  way.
* The port's client (rpc/httpclient.py) feeds the breaker as the
  reference's does: connect failures open it, an open breaker refuses
  with no connect, an answer closes it (an HTTP error status too), an
  injected client fault hands a held probe back, a timeout settles it
  inconclusive, and a probe that met a pooled connection the peer had
  closed is admitted again on a fresh one.
* Each package's client reads the other's /debug/breakers.
"""
import random
import socket
import time
import types
from urllib.parse import urlsplit

import pytest
import requests

from seaweedfs_tpu.rpc.http import ServerThread as RefServerThread
from seaweedfs_tpu.server.master_server import MasterServer as RefMaster
from seaweedfs_tpu.utils import retry as ref_retry
from seaweedfs_tpu_torch.master import topology as port_topology
from seaweedfs_tpu_torch.rpc import http as rhttp
from seaweedfs_tpu_torch.rpc import httpclient
from seaweedfs_tpu_torch.server.master_server import MasterServer
from seaweedfs_tpu_torch.utils import faults, retry

from tests import test_breaker as ref_cases
from tests.torch_port_cases import port_cases, run_case, swap_modules

CASES = port_cases(ref_cases, retry=retry)


@pytest.fixture(autouse=True)
def _clean():
    """Breakers, faults and the retry policy are process-global."""
    retry.reset_breakers()
    ref_retry.reset_breakers()
    yield
    faults.configure(spec=None)
    for mod in (retry, ref_retry):
        mod.configure(max_attempts=3, base_delay=0.02, max_delay=1.0,
                      edge_budget=300.0, breaker_failures=5,
                      breaker_reset=5.0)
    retry.reset_breakers()
    ref_retry.reset_breakers()


@pytest.mark.parametrize("case", list(CASES))
def test_breaker_cases_on_the_port(case):
    with swap_modules({"seaweedfs_tpu.master.topology": port_topology}):
        run_case(CASES[case], {})


def _clock(monkeypatch, mod, start=1_700_000_000.0):
    now = [start]
    monkeypatch.setattr(mod, "time", types.SimpleNamespace(
        time=lambda: now[0], sleep=time.sleep, monotonic=time.monotonic))
    return now


@pytest.mark.parametrize("seed", range(6))
def test_same_events_same_snapshots(monkeypatch, seed):
    rng = random.Random(seed)
    events = [rng.choice(["fail", "fail", "ok", "allow", "allow",
                          "inconclusive", "release", "tick", "bigtick"])
              for _ in range(400)]
    snaps = []
    for mod in (ref_retry, retry):
        now = _clock(monkeypatch, mod)
        br = mod.CircuitBreaker("10.0.0.7:8080", mod._BreakerConfig(
            failure_threshold=3, reset_timeout=2.0))
        out = []
        for ev in events:
            if ev == "fail":
                br.record_failure()
            elif ev == "ok":
                br.record_success()
            elif ev == "allow":
                out.append(br.allow())
            elif ev == "inconclusive":
                br.probe_inconclusive()
            elif ev == "release":
                br.release_probe()
            else:
                now[0] += 0.7 if ev == "tick" else 2.5
            out.append((br.snapshot(), br.state, br.retry_after()))
        snaps.append(out)
    assert snaps[1] == snaps[0]


def test_configure_moves_both_alike(monkeypatch):
    for mod in (ref_retry, retry):
        mod.configure(max_attempts=0, base_delay=0.5, max_delay=4.0,
                      edge_budget=12.0, breaker_failures=0,
                      breaker_reset=0.25)
    assert retry.policy().max_attempts == ref_retry.policy().max_attempts \
        == 1
    assert (retry.policy().base_delay, retry.policy().max_delay) == \
        (ref_retry.policy().base_delay, ref_retry.policy().max_delay)
    assert retry.EDGE_BUDGET == ref_retry.EDGE_BUDGET == 12.0
    assert vars(retry._registry.config) == vars(ref_retry._registry.config)


def _dead_peer() -> str:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return f"127.0.0.1:{port}"


def test_client_opens_then_refuses_without_a_connect(monkeypatch):
    retry.configure(breaker_failures=3, breaker_reset=60.0)
    peer = _dead_peer()
    sess = httpclient.session()
    # one call makes max_attempts (3) connect attempts: each counts
    with pytest.raises(httpclient.ConnectionError):
        sess.get(f"http://{peer}/x", timeout=2)
    assert retry.breaker_for(peer).state == retry.OPEN
    dials = []
    monkeypatch.setattr(httpclient.Session, "_connect", staticmethod(
        lambda *a: dials.append(a) or pytest.fail("dialed")))
    with pytest.raises(retry.BreakerOpenError) as e:
        sess.get(f"http://{peer}/x", timeout=2)
    # a RequestException too: the port's dead-peer paths catch it
    assert isinstance(e.value, httpclient.RequestException)
    assert e.value.peer == peer and e.value.retry_after > 0
    assert dials == []


def _answering_app():
    app = rhttp.App()
    app.get("/ok", lambda req: rhttp.text_response("ok"))
    app.get("/gone", lambda req: rhttp.json_error("gone", status=404))

    def slow(req):
        time.sleep(1.0)
        return rhttp.text_response("late")
    app.get("/slow", slow)
    return app


def test_client_answer_closes_and_error_status_counts_as_alive():
    t = rhttp.ServerThread(_answering_app()).start()
    try:
        br = retry.breaker_for(t.address)
        br.record_failure()
        br.record_failure()
        r = httpclient.session().get(t.url + "/gone", timeout=5)
        assert r.status_code == 404
        assert br.snapshot()["consecutive_failures"] == 0
        assert br.state == retry.CLOSED
    finally:
        t.stop()


def _half_open(peer):
    retry.configure(breaker_failures=1, breaker_reset=60.0)
    br = retry.breaker_for(peer)
    br.record_failure()
    br._opened_at -= 61.0
    assert br.state == retry.HALF_OPEN
    return br


def test_client_injected_fault_releases_the_probe():
    t = rhttp.ServerThread(_answering_app()).start()
    try:
        br = _half_open(t.address)
        faults.configure("httpclient:*:error=1.0", seed=0)
        retry.configure(max_attempts=1)
        with pytest.raises(faults.FaultInjected):
            httpclient.session().get(t.url + "/ok", timeout=5)
        # the peer was never contacted: still half-open, slot free
        assert br.state == retry.HALF_OPEN and not br._probing
        faults.configure(spec=None)
        assert httpclient.session().get(t.url + "/ok",
                                        timeout=5).status_code == 200
        assert br.state == retry.CLOSED
    finally:
        t.stop()


def test_client_timeout_settles_the_probe_inconclusive():
    t = rhttp.ServerThread(_answering_app()).start()
    try:
        br = _half_open(t.address)
        with pytest.raises(httpclient.Timeout):
            httpclient.session().get(t.url + "/slow", timeout=(2.0, 0.2))
        assert br.state == retry.OPEN and not br._probing
    finally:
        t.stop()


def test_client_stale_pooled_connection_hands_the_probe_back(monkeypatch):
    t = rhttp.ServerThread(_answering_app()).start()
    try:
        sess = httpclient.session()
        assert sess.get(t.url + "/ok", timeout=5).status_code == 200
        parts = urlsplit(t.url)
        pool = sess._pools[(parts.hostname, parts.port)]
        assert pool
        # the pooled connection breaks between the pool's liveness
        # check and the send (the peer closed it while idle)
        for conn in pool:
            conn.sock.shutdown(socket.SHUT_WR)
        monkeypatch.setattr(httpclient, "_dropped", lambda conn: False)
        br = _half_open(t.address)
        retry.configure(max_attempts=1)
        assert sess.get(t.url + "/ok", timeout=5).status_code == 200
        assert br.state == retry.CLOSED and not br._probing
    finally:
        t.stop()


@pytest.fixture(scope="module")
def masters():
    ref = RefMaster(pulse_seconds=0.4, scrape_interval=3600.0)
    ref_t = RefServerThread(ref.app).start()
    port = MasterServer(pulse_seconds=0.4, scrape_interval=3600.0)
    port_t = rhttp.ServerThread(port.app).start()
    yield ref_t, port_t
    port_t.stop()
    ref_t.stop()


def test_each_client_reads_the_others_debug_breakers(masters):
    ref_t, port_t = masters
    retry.breaker_for("hostb:1").record_failure()
    retry.breaker_for("hosta:1")
    ref_retry.breaker_for("hostb:1").record_failure()
    ref_retry.breaker_for("hosta:1")
    # the reference's client (requests) against the port's route, the
    # port's client against the reference's
    from_port = requests.get(port_t.url + "/debug/breakers",
                             timeout=10).json()
    from_ref = httpclient.session().get(ref_t.url + "/debug/breakers",
                                        timeout=10).json()
    mine = [b for b in from_port["breakers"]
            if b["peer"] in ("hosta:1", "hostb:1")]
    theirs = [b for b in from_ref["breakers"]
              if b["peer"] in ("hosta:1", "hostb:1")]
    assert mine == theirs
    assert [b["peer"] for b in mine] == ["hosta:1", "hostb:1"]
    assert mine[1]["consecutive_failures"] == 1
