"""The port's native S3 front (seaweedfs_tpu_torch/s3/native_front.py over
native/dataplane.cc ROLE_S3) against the JAX package's, with tolerance 0.

* Every case of the reference's tests/test_s3_native_front.py runs
  twice, `[reference]` on the JAX package's `Cluster(with_s3=True,
  s3_native=True)` and `[port]` on the port's (tests/torch_port_cases.py
  rebinds `Cluster` and the plane's module): the C++ MD5, the native
  counters, metadata, read-after-write, delete, a write through the
  Python filer, a tampered signature, a scoped identity, a dry fid
  pool, a rename through the filer, ranges, multipart parts, abort and
  range overflow.
* Parity: the same seeded SigV4-signed PUTs, GETs, HEADs, ranges and
  deletes of 1-64 KiB objects to both native fronts get equal statuses,
  bodies and ETags, and the native counters move alike.
"""
import functools
import hashlib
import random
import time

import pytest

from seaweedfs_tpu.server.cluster import Cluster as RefCluster
from seaweedfs_tpu_torch.native import dataplane as dpmod
from seaweedfs_tpu_torch.server.cluster import Cluster

from tests import test_s3_native_front as ref_cases
from tests.s3v4client import S3V4Client
from tests.torch_port_cases import call_case, port_cases

PortCluster = functools.partial(Cluster, ec_backend="native")
SIDES = {
    "reference": port_cases(ref_cases),
    "port": port_cases(ref_cases, Cluster=PortCluster, dpmod=dpmod),
}
CFG = {"identities": [
    {"name": "admin", "credentials": [
        {"accessKey": ref_cases.AK, "secretKey": ref_cases.SK}],
     "actions": ["Admin"]},
    {"name": "scoped", "credentials": [
        {"accessKey": ref_cases.RAK, "secretKey": ref_cases.RSK}],
     "actions": ["Read:nf", "Write:nf"]},
]}


def _ready(c, bucket: str) -> S3V4Client:
    s3 = S3V4Client(c.s3_url, ref_cases.AK, ref_cases.SK)
    assert s3.put(f"/{bucket}").status in (200, 409)
    # until the refill thread pools fids for the bucket, PUTs relay
    deadline = time.time() + 10
    while time.time() < deadline and \
            c.s3_front.front.pool_level(bucket) == 0:
        time.sleep(0.05)
    assert c.s3_front.front.pool_level(bucket) > 0
    return s3


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """A reference and a port cluster, each behind its native S3 front
    (one front of a role per library, so one cluster of each)."""
    out = {}
    try:
        for name, cls in (("reference", RefCluster), ("port", PortCluster)):
            out[name] = cls(
                str(tmp_path_factory.mktemp(f"s3native_{name}")),
                n_volume_servers=1, volume_size_limit=64 << 20,
                with_s3=True, s3_native=True, s3_config=CFG)
        yield out
    finally:
        for c in out.values():
            c.stop()


@pytest.mark.parametrize("side", list(SIDES))
@pytest.mark.parametrize("case", list(SIDES["port"]))
def test_reference_case(case, side, pair):
    c = pair[side]
    call_case(SIDES[side][case], {"cluster": c, "s3": _ready(c, "nf")})


def _ops(seed: int) -> list[tuple]:
    rng = random.Random(seed)
    ops, keys = [], []
    for i in range(96):
        roll = rng.random()
        if roll < 0.45 or not keys:
            key = f"/pp/obj-{seed}-{i:03d}.bin"
            body = rng.randbytes(rng.randrange(1 << 10, 64 << 10))
            ops.append(("put", key, body, {}))
            keys.append(key)
        elif roll < 0.7:
            ops.append(("get", rng.choice(keys), None, {}))
        elif roll < 0.8:
            ops.append(("head", rng.choice(keys), None, {}))
        elif roll < 0.9:
            a = rng.randrange(0, 1 << 10)
            ops.append(("get", rng.choice(keys), None,
                        {"Range": f"bytes={a}-{a + rng.randrange(512)}"}))
        else:
            ops.append(("delete", rng.choice(keys), None, {}))
    return ops


@pytest.mark.parametrize("seed", [0, 1])
def test_seeded_parity(pair, seed):
    clients = {name: _ready(c, "pp") for name, c in pair.items()}
    before = {n: c.s3_front.stats() for n, c in pair.items()}
    for verb, key, body, hdrs in _ops(seed):
        got = {}
        for name, s3 in clients.items():
            if verb == "put":
                r = s3.put(key, body, headers=hdrs)
            else:
                r = getattr(s3, verb)(key, headers=hdrs)
            got[name] = (r.status, r.body, r.header("etag"),
                         r.header("content-range"),
                         r.header("content-length"))
        assert got["port"] == got["reference"], (verb, key, hdrs)
        if verb == "put":
            assert got["port"][2] == f'"{hashlib.md5(body).hexdigest()}"'
    moved = {n: {k: v - before[n][k] for k, v in c.s3_front.stats().items()}
             for n, c in pair.items()}
    assert moved["port"] == moved["reference"]
    assert moved["port"]["fast_put"] > 0 and moved["port"]["fast_get"] > 0
    assert moved["port"]["chan_fail"] == 0
