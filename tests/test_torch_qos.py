"""The port's per-tenant edge QoS (seaweedfs_tpu_torch/utils/qos.py, its
middleware in the filer and the S3 gateway, /debug/qos and the master's
`Qos` fold) against the JAX package's, with tolerance 0.

* Decisions: seeded request sequences (tenants, costs, deadline
  budgets, clock steps, spec reloads, priorities) through both
  registries at a pinned clock give the same verdicts — admitted or
  shed, the reason, the pacing wait and Retry-After to the bit — and
  the same snapshots.
* The reference's tests/test_qos.py runs on the port
  (tests/torch_port_cases.py): the admission unit cases, tenant
  extraction, the gateways' shed / deadline / isolation / control-plane
  / /debug/qos / access-key / cluster-status cases on a port cluster,
  and the overload case (a 10x burst: every acked write reads back,
  the shed counter accounts for the excess, the tame tenant never
  fails). The middleware paces on the handler's thread where the
  reference awaits asyncio.sleep: the tame tenant's latency shows no
  thread is held up by the burst.
"""
import random
import time

import pytest

from seaweedfs_tpu.utils import qos as ref_qos
from seaweedfs_tpu_torch.server.cluster import Cluster
from seaweedfs_tpu_torch.utils import metrics, qos, retry

from tests import test_qos as ref_cases
from tests.torch_port_cases import port_cases, run_case

CASES = port_cases(ref_cases, qos=qos, metrics=metrics, retry=retry,
                   Cluster=Cluster, OVERFLOW_TENANT=qos.OVERFLOW_TENANT)
UNIT = {k: v for k, v in CASES.items()
        if k.startswith(("TestAdmission.", "TestTenantExtraction."))}
LIVE = {k: v for k, v in CASES.items() if k not in UNIT}


@pytest.fixture(autouse=True)
def _clean_qos():
    """Both registries are process-global."""
    qos.reset()
    ref_qos.reset()
    yield
    qos.reset()
    ref_qos.reset()


@pytest.mark.parametrize("case", list(UNIT))
def test_reference_qos_unit_cases_on_the_port(case, tmp_path):
    run_case(UNIT[case], {"tmp_path": tmp_path})


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    c = Cluster(str(tmp_path_factory.mktemp("qos_cluster")),
                n_volume_servers=1, volume_size_limit=16 << 20,
                with_s3=True)
    yield c
    c.stop()


@pytest.mark.parametrize("case", list(LIVE))
def test_reference_qos_gateway_cases_on_the_port(case, cluster):
    run_case(LIVE[case], {"cluster": cluster})


class _Clock:
    def __init__(self):
        self.now = 5000.0

    def __call__(self) -> float:
        return self.now


def _sequence(seed: int) -> list[tuple]:
    rng = random.Random(seed)
    tenants = [f"t{i}" for i in range(rng.randint(2, 7))] + ["", "a/b c"]
    ops = []
    for _ in range(300):
        roll = rng.random()
        if roll < 0.05:
            ops.append(("spec", {
                "default": {"rate": rng.choice([0, 20_000, 200_000]),
                            "priority": rng.choice([1, 2])},
                "tenants": {rng.choice(tenants): {
                    "rate": rng.choice([10_000, 50_000]),
                    "burst": rng.choice([0, 8192, 1 << 20]),
                    "priority": rng.choice([0.5, 1, 4])}}}))
        elif roll < 0.25:
            ops.append(("tick", rng.choice([0.001, 0.05, 0.3, 2.0])))
        else:
            ops.append(("admit", rng.choice(tenants),
                        rng.choice([0, 100, 4096, 65536, 1 << 20]),
                        rng.choice([None, None, 0.05, 0.5, 30.0])))
    return ops


def _run(mod, ops, clock, seed: int) -> list:
    mod.configure(enabled=True, rate=100_000 + 1000 * seed,
                  max_tenants=4, max_delay=1.0 + seed % 3)
    out = []
    for op in ops:
        if op[0] == "tick":
            clock.now += op[1]
        elif op[0] == "spec":
            mod.load_spec(op[1])
        else:
            a = mod.admit(op[1], op[2], op[3])
            out.append((a.tenant, a.admitted, a.shed_reason, a.wait,
                        a.retry_after))
    return out


@pytest.mark.parametrize("seed", range(6))
def test_decisions_match_on_seeded_sequences(seed, monkeypatch):
    clock = _Clock()
    monkeypatch.setattr(time, "monotonic", clock)
    ops = _sequence(seed)
    got = _run(qos, ops, clock, seed)
    clock.now = 5000.0
    want = _run(ref_qos, ops, clock, seed)
    assert got == want
    assert any(not a for _, a, *_ in got) and any(a for _, a, *_ in got)
    # both runs end at the same pinned clock: fill and debt too
    assert qos.snapshot() == ref_qos.snapshot()


@pytest.mark.parametrize("path", ["/bucket/key", "/", "/kv/x",
                                  "/debug/qos", "/status", "/a b/c"])
def test_tenant_extraction_matches(path):
    class Req:
        headers = {"Authorization": "AWS4-HMAC-SHA256 Credential=AKX/"
                                    "20230101/us-east-1/s3/aws4_request"}
        query = {}

    Req.path = path
    assert qos.filer_tenant(Req) == ref_qos.filer_tenant(Req)
    assert qos.s3_tenant(Req) == ref_qos.s3_tenant(Req) == "AKX"
