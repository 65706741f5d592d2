"""The port's native filer front (seaweedfs_tpu_torch/filer/native_front.py
over native/dataplane.cc ROLE_FILER) against the JAX package's, with
tolerance 0.

* Every case of the reference's tests/test_filer_native_front.py runs
  twice, `[reference]` on the JAX package's `Cluster(with_filer=True,
  filer_native=True)` and `[port]` on the port's (tests/torch_port_cases.py
  rebinds `Cluster` and the plane's module; the fault case's import gets
  the port's utils/faults.py). On each side its C++ front is held
  header by header against its own Python filer: the counters, PUT /
  GET / HEAD / conditional / range / DELETE parity, the relayed verbs,
  zero staleness both ways, the writes gate, odd paths, the front's
  fault gate and a body over the fast path's 1 MB gate.
* Parity: the same seeded PUTs, GETs, HEADs, ranges and deletes of
  1-64 KiB files through both packages' native fronts get equal
  statuses, bodies and headers (Date, Server, Connection and
  Last-Modified aside: the last is a write timestamp), and the native
  counters move alike.
"""
import functools
import random
import time

import pytest
import requests

import seaweedfs_tpu_torch.utils.faults as port_faults
from seaweedfs_tpu.server.cluster import Cluster as RefCluster
from seaweedfs_tpu_torch.native import dataplane as dpmod
from seaweedfs_tpu_torch.server.cluster import Cluster

from tests import test_filer_native_front as ref_cases
from tests.torch_port_cases import call_case, port_cases, swap_modules

PortCluster = functools.partial(Cluster, ec_backend="native")
SIDES = {
    "reference": (port_cases(ref_cases), {}),
    "port": (port_cases(ref_cases, Cluster=PortCluster, dpmod=dpmod),
             {"seaweedfs_tpu.utils.faults": port_faults}),
}


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """A reference and a port cluster, each behind its native filer
    front (one front of a role per library, so one cluster of each)."""
    out = {}
    try:
        for name, cls in (("reference", RefCluster), ("port", PortCluster)):
            c = out[name] = cls(
                str(tmp_path_factory.mktemp(f"filernative_{name}")),
                n_volume_servers=1, volume_size_limit=64 << 20,
                with_filer=True, filer_native=True)
            # until the refill thread pools fids, PUTs relay
            deadline = time.time() + 10
            while time.time() < deadline and \
                    c.filer_front.front.pool_level() == 0:
                time.sleep(0.05)
            assert c.filer_front.front.pool_level() > 0
        yield out
    finally:
        for c in out.values():
            c.stop()


@pytest.mark.parametrize("side", list(SIDES))
@pytest.mark.parametrize("case", list(SIDES["port"][0]))
def test_reference_case(case, side, pair):
    cases, swaps = SIDES[side]
    c = pair[side]
    with swap_modules(swaps):
        call_case(cases[case], {"cluster": c, "native": c.filer_url,
                                "backend": c.filer_thread.url})


def _ops(seed: int) -> list[tuple]:
    rng = random.Random(seed)
    ops, paths = [], []
    for i in range(96):
        roll = rng.random()
        if roll < 0.45 or not paths:
            path = f"/pp/{seed}/f{i:03d}" + rng.choice([".bin", ".txt",
                                                        ".html", ""])
            ops.append(("PUT", path,
                        rng.randbytes(rng.randrange(1 << 10, 64 << 10)), {}))
            paths.append(path)
        elif roll < 0.7:
            ops.append(("GET", rng.choice(paths), None, {}))
        elif roll < 0.8:
            ops.append(("HEAD", rng.choice(paths), None, {}))
        elif roll < 0.9:
            a = rng.randrange(0, 1 << 10)
            ops.append(("GET", rng.choice(paths), None,
                        {"Range": f"bytes={a}-{a + rng.randrange(512)}"}))
        else:
            ops.append(("DELETE", rng.choice(paths), None, {}))
    return ops


_NOISE = ref_cases.IGNORED_HEADERS | {"last-modified"}


@pytest.mark.parametrize("seed", [0, 1])
def test_seeded_parity(pair, seed):
    before = {n: c.filer_front.stats() for n, c in pair.items()}
    for method, path, body, hdrs in _ops(seed):
        got = {}
        for name, c in pair.items():
            r = requests.request(method, c.filer_url + path, data=body,
                                 headers=hdrs, timeout=30)
            got[name] = (r.status_code, r.content,
                         {k.lower(): v for k, v in r.headers.items()
                          if k.lower() not in _NOISE})
        assert got["port"] == got["reference"], (method, path, hdrs)
    moved = {n: {k: v - before[n][k]
                 for k, v in c.filer_front.stats().items()}
             for n, c in pair.items()}
    assert moved["port"] == moved["reference"]
    assert moved["port"]["fast_put"] > 0 and moved["port"]["fast_get"] > 0
    assert moved["port"]["chan_fail"] == 0
