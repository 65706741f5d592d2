"""The port's S3 circuit breaker (seaweedfs_tpu_torch/s3/circuit_breaker.py
and its place in s3/server.py) against the JAX package's, and a small
secured cluster run in both packages, with tolerance 0.

* The reference's unit, integration and KV-reload cases of
  tests/test_s3_breaker_policy.py run on the port
  (tests/torch_port_cases.py; its POST-policy cases run in
  tests/test_torch_s3_subresources.py).
* Seeded sequences of nested acquires and releases (read / write,
  global and per-bucket counts and bytes) through both breakers give
  the same admissions and the same refusals (scope and limit).
* The small secured cluster: a JWT secret, batch durability, three
  volume servers, the S3 gateway on TLS, qos on (a provisioned tenant
  and a greedy one) and the breaker's limits from the filer's KV — the
  same requests to a reference and a port cluster give the same
  statuses, ETags and bytes: objects of a few MiB in all, the greedy
  tenant shed with 503 + Retry-After + X-Sw-Retryable, a PUT with no
  length 411 while limits are on, a DELETE with none still 204, a
  bucket at `writeCount` 0 refused 503 TooManyRequests after the
  reload while reads go on.
"""
import hashlib
import json
import random
import time

import pytest
import requests

from seaweedfs_tpu.s3 import circuit_breaker as ref_cb
from seaweedfs_tpu.utils import qos as ref_qos
from seaweedfs_tpu_torch.s3 import circuit_breaker as cb
from seaweedfs_tpu_torch.s3 import server as port_s3_server
from seaweedfs_tpu_torch.server.cluster import Cluster
from seaweedfs_tpu_torch.utils import qos, retry, tls

from tests import test_s3_breaker_policy as ref_cases
from tests.test_torch_tls import (RefTlsCluster, port_tls_cluster,
                                  trust_in_aiohttp)
from tests.torch_port_cases import port_cases, run_case, swap_modules

CASES = {k: v for k, v in port_cases(
    ref_cases, CircuitBreaker=cb.CircuitBreaker, CircuitOpen=cb.CircuitOpen,
    Cluster=Cluster).items()
    if k.startswith(("TestCircuitBreakerUnit.", "TestBreakerIntegration.",
                     "TestBreakerKvReload."))}


@pytest.mark.parametrize("case", list(CASES))
def test_reference_breaker_cases_on_the_port(case, tmp_path_factory):
    with swap_modules({"seaweedfs_tpu.s3.server": port_s3_server}):
        run_case(CASES[case], {"tmp_path_factory": tmp_path_factory})


def _walk(mod, seed: int) -> list:
    """Nested acquires from one seeded script: -> each acquire's
    outcome (admitted, or the refusal's scope and limit)."""
    rng = random.Random(seed)
    buckets = ["a", "b", "hot"]
    config = {"global": {k: rng.choice([None, 2, 3, 1000, 4096])
                         for k in cb.LIMIT_KEYS},
              "buckets": {"hot": {rng.choice(cb.LIMIT_KEYS):
                                  rng.choice([0, 1, 2, 600])}}}
    config["global"] = {k: v for k, v in config["global"].items()
                        if v is not None}
    breaker = mod.CircuitBreaker(config)
    held, out = [], []
    for _ in range(200):
        if held and rng.random() < 0.45:
            held.pop(rng.randrange(len(held))).__exit__(None, None, None)
            continue
        g = breaker.acquire(rng.choice(["read", "write", "other"]),
                            rng.choice(buckets),
                            rng.choice([0, 10, 100, 700, 5000]))
        try:
            g.__enter__()
        except mod.CircuitOpen as e:
            out.append((e.scope, e.what, str(e)))
            continue
        out.append("ok")
        held.append(g)
    while held:
        held.pop().__exit__(None, None, None)
    # everything released: the counters are back to zero
    for counters in [breaker._global, *breaker._buckets.values()]:
        assert [getattr(counters, k) for k in counters.__slots__] == \
            [0, 0, 0, 0]
    return out


@pytest.mark.parametrize("seed", range(8))
def test_breaker_decisions_match(seed):
    got, want = _walk(cb, seed), _walk(ref_cb, seed)
    assert got == want
    assert "ok" in got


# -- the small secured cluster, in both packages -----------------------

PROVISIONED = "AKPROV"
GREEDY = "AKGREEDY"


def _cred(ak: str) -> str:
    return f"X-Amz-Credential={ak}/20260101/us-east-1/s3/aws4_request"


def _objects() -> list[tuple[str, bytes]]:
    rng = random.Random(20261017)
    return [(f"obj-{i}", rng.randbytes(rng.randint(200 << 10, 600 << 10)))
            for i in range(8)]


def _drive(c, ca: str, kv_put, cb_enabled) -> list:
    """One request script against a cluster of either package; ->
    (step, status, detail)."""
    out = []
    s3 = c.s3_url

    def req(method, path, ak=PROVISIONED, **kw):
        sep = "&" if "?" in path else "?"
        return requests.request(method, f"{s3}{path}{sep}{_cred(ak)}",
                                verify=ca, timeout=60, **kw)

    r = req("PUT", "/sec")
    out.append(("bucket", r.status_code))
    objs = _objects()
    for key, body in objs:
        r = req("PUT", f"/sec/{key}", data=body)
        out.append(("put", key, r.status_code,
                    r.headers.get("ETag", "").strip('"') ==
                    hashlib.md5(body).hexdigest()))
    for key, body in objs:
        r = req("GET", f"/sec/{key}")
        out.append(("get", key, r.status_code, r.content == body))
    r = req("PUT", "/sec/greedy", ak=GREEDY, data=b"g" * 8192)
    out.append(("greedy", r.status_code, r.headers.get("Retry-After"),
                r.headers.get(retry.RETRYABLE_HEADER),
                r.json().get("reason") if r.status_code == 503 else ""))
    # the breaker's limits arrive through the filer's KV
    kv_put({"global": {"writeBytes": 64 << 20},
            "buckets": {"blocked": {"writeCount": 0}}})
    deadline = time.monotonic() + 20
    while not cb_enabled():
        assert time.monotonic() < deadline, "the limits never loaded"
        time.sleep(0.1)

    def chunks():
        yield b"no-length " * 100
    r = req("PUT", "/sec/chunked", data=chunks())
    out.append(("no length", r.status_code,
                "MissingContentLength" in r.text))
    r = req("DELETE", f"/sec/{objs[0][0]}")
    out.append(("delete without length", r.status_code))
    r = req("GET", f"/sec/{objs[0][0]}")
    out.append(("get deleted", r.status_code))
    out.append(("bucket blocked", req("PUT", "/blocked").status_code))
    r = req("PUT", "/blocked/x", data=b"x" * 100)
    out.append(("blocked put", r.status_code, "TooManyRequests" in r.text))
    r = req("GET", f"/sec/{objs[1][0]}")
    out.append(("read under limits", r.status_code, r.content == objs[1][1]))
    return out


@pytest.fixture
def _qos_on():
    spec = {"default": {"rate": 0},
            "tenants": {PROVISIONED: {"rate": 1e12},
                        GREEDY: {"rate": 1000}}}
    for mod in (qos, ref_qos):
        mod.reset()
        mod.configure(enabled=True, max_delay=0.5)
        mod.load_spec(spec)
    yield
    for mod in (qos, ref_qos):
        mod.reset()


def test_secured_cluster_matches(tmp_path, monkeypatch, _qos_on):
    certs = tls.generate_self_signed(str(tmp_path / "certs"))
    ca = certs["ca_cert"]
    monkeypatch.setenv("REQUESTS_CA_BUNDLE", ca)
    monkeypatch.setenv("SSL_CERT_FILE", ca)
    trust_in_aiohttp(ca)
    ctx = tls.server_ssl_context(certs["cert"], certs["key"])
    key = port_s3_server.CIRCUIT_BREAKER_KV_KEY
    out = {}
    ref = RefTlsCluster(str(tmp_path / "ref"), ctx, {"s3"})
    try:
        ref.s3.identity_refresh_seconds = 0.5
        out["reference"] = _drive(
            ref, ca,
            lambda conf: requests.put(f"{ref.filer_url}/kv/{key}",
                                      data=json.dumps(conf), timeout=30),
            lambda: ref.s3.circuit_breaker.enabled)
    finally:
        ref.stop()
    port = port_tls_cluster(str(tmp_path / "port"), ctx, {"s3"})
    try:
        assert port.s3_url.startswith("https://")
        port.s3.identity_refresh_seconds = 0.5
        out["port"] = _drive(
            port, ca,
            lambda conf: requests.put(f"{port.filer_url}/kv/{key}",
                                      data=json.dumps(conf), timeout=30),
            lambda: port.s3.circuit_breaker.enabled)
        snap = requests.get(f"{port.s3_url}/debug/qos", verify=ca,
                            timeout=30).json()
        assert snap["tenants"][GREEDY]["shed"] == {"rate": 1}
    finally:
        port.stop()
    assert out["port"] == out["reference"]
    steps = dict((s[0], s[1:]) for s in out["port"])
    assert steps["greedy"][0] == 503 and steps["no length"] == (411, True)
    assert steps["delete without length"] == (204,)
    assert steps["blocked put"] == (503, True)
