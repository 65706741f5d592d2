"""The port's query engine, /admin/query and S3 Select against the JAX
package's, with tolerance 0.

* Every case of the reference's tests/test_query.py runs twice,
  `[reference]` and `[port]` (tests/torch_port_cases.py rebinds
  `Filter`, `parse_select`, `query_json_bytes`, `verbs` and `Cluster`;
  the S3 case's import of the event-stream decoder gets the port's):
  projection, dotted paths, numeric and float compares, NDJSON, single
  documents and arrays, the SELECT subset and its refusals, the volume
  server's query route and the gateway's SelectObjectContent.
* The same seeded JSON needles — a few fields, about a fifth stored
  gzipped — go to one volume of each package; /admin/query replies to
  seeded selections and filters (every operand, dotted paths, misses,
  bad operands, bad fids) are byte-equal, status and Content-Type too.
* query_json_bytes and parse_select give equal results on seeded
  documents and expressions.
"""
import functools
import json

import numpy as np
import pytest
import requests

import seaweedfs_tpu_torch.s3.eventstream as port_eventstream
from seaweedfs_tpu import query as ref_query
from seaweedfs_tpu.server.cluster import Cluster as RefCluster
from seaweedfs_tpu_torch import query
from seaweedfs_tpu_torch.operation import verbs
from seaweedfs_tpu_torch.server.cluster import Cluster

from tests import test_query as ref_cases
from tests.torch_port_cases import port_cases, run_case, swap_modules

SEED = 20261017
PortCluster = functools.partial(Cluster, ec_backend="native")
SIDES = {
    "reference": (port_cases(ref_cases), RefCluster, {}),
    "port": (port_cases(ref_cases, Cluster=PortCluster, verbs=verbs,
                        Filter=query.Filter,
                        parse_select=query.parse_select,
                        query_json_bytes=query.query_json_bytes),
             PortCluster,
             {"seaweedfs_tpu.s3.eventstream": port_eventstream}),
}
CASES = list(SIDES["port"][0])


def test_every_reference_case_is_mirrored():
    assert CASES == list(port_cases(ref_cases))
    assert len(CASES) == 16


@pytest.fixture(scope="module")
def clusters(tmp_path_factory):
    out = {}
    try:
        for side, (_, cls, _) in SIDES.items():
            out[side] = cls(str(tmp_path_factory.mktemp(side)),
                            n_volume_servers=1, volume_size_limit=16 << 20,
                            with_filer=True, with_s3=True)
        yield out
    finally:
        for c in out.values():
            c.stop()


@pytest.mark.parametrize("side", list(SIDES))
@pytest.mark.parametrize("case", CASES)
def test_reference_case(case, side, clusters):
    cases, _, swaps = SIDES[side]
    with swap_modules(swaps, parents=True):
        run_case(cases[case], {"cluster": clusters[side]})


def _docs(rng, n: int) -> list[bytes]:
    """n seeded NDJSON bodies of 1-4 documents each."""
    out = []
    for i in range(n):
        lines = []
        for _ in range(int(rng.integers(1, 5))):
            d = {"a": int(rng.integers(-50, 50)),
                 "b": ["x", "y", "z"][int(rng.integers(3))],
                 "c": float(np.round(rng.uniform(0, 10), 3)),
                 "n": {"d": int(rng.integers(0, 5))}}
            if rng.random() < 0.2:
                del d["a"]
            lines.append(json.dumps(d))
        out.append(("\n".join(lines) + "\n").encode())
    return out


@pytest.fixture(scope="module")
def loaded(clusters):
    """The same seeded needles on one volume of each package: -> {side:
    (volume url, fids)}. A fifth go up as application/json, which both
    volume servers store gzipped."""
    rng = np.random.default_rng([SEED, 1])
    docs = _docs(rng, 40)
    mimes = ["application/json" if rng.random() < 0.2
             else "application/octet-stream" for _ in docs]
    out = {}
    for side, c in clusters.items():
        fids, url = [], None
        for body, mime in zip(docs, mimes):
            if mime == "application/json":
                body *= 8  # long enough that gzip saves its 10%
            a = verbs.assign(c.master_url, collection="q")
            verbs.upload(a, body, mime=mime)
            fids.append(a.fid)
            url = a.url
        out[side] = (url, fids)
    store = clusters["port"].stores[0]
    gz = [store.read_needle(*port_fid(f)).is_compressed
          for f in out["port"][1]]
    assert 0 < sum(gz) < len(gz)
    return out


def port_fid(fid: str) -> tuple[int, int]:
    from seaweedfs_tpu_torch.storage.types import parse_file_id

    vid, key, _ = parse_file_id(fid)
    return vid, key


def _bodies(rng) -> list[dict]:
    out = [{"selections": []}, {"selections": ["a", "n.d"]},
           {"selections": ["b"], "filter": {"field": "b", "operand": "=",
                                            "value": "y"}},
           {"selections": ["a"], "filter": {"field": "a", "op": ">=",
                                            "value": "0"}},
           {"filter": {"field": "a", "operand": "~", "value": "1"}},
           {"selections": ["missing.path"]}]
    for _ in range(8):
        out.append({"selections": [["a"], ["a", "c"], ["n.d", "b"], []][
            int(rng.integers(4))],
            "filter": {"field": ["a", "c", "n.d", "b", "zz"][
                int(rng.integers(5))],
                "operand": ["=", "!=", ">", "<", ">=", "<="][
                    int(rng.integers(6))],
                "value": str(int(rng.integers(-10, 10)))}})
    return out


def test_admin_query_byte_equal(clusters, loaded):
    rng = np.random.default_rng([SEED, 2])
    bodies = _bodies(rng)
    n_rows = 0
    for body in bodies:
        got = {}
        pick = sorted(rng.choice(len(loaded["port"][1]), 12,
                                 replace=False))
        for side, (url, fids) in loaded.items():
            r = requests.post(f"http://{url}/admin/query",
                              json={**body,
                                    "fids": [fids[i] for i in pick]},
                              timeout=30)
            got[side] = (r.status_code, r.headers.get("Content-Type"),
                         r.content)
        assert got["port"] == got["reference"], body
        n_rows += got["port"][2].count(b"\n")
    assert n_rows > 0
    # refusals: no fids, a malformed fid
    for body in ({"selections": []}, {"fids": ["nope"]}):
        st = [requests.post(f"http://{url}/admin/query", json=body,
                            timeout=10) for url, _ in loaded.values()]
        assert st[1].status_code == st[0].status_code == 400
        assert st[1].json() == st[0].json()


@pytest.mark.parametrize("seed", range(6))
def test_engine_matches(seed):
    rng = np.random.default_rng([SEED, 10 + seed])
    data = b"".join(_docs(rng, 6)) + b"not json\n"
    for body in _bodies(rng):
        fd = body.get("filter", {})
        op = fd.get("operand", fd.get("op", "="))
        if op not in query.json_query.OPS:
            continue
        got = list(query.query_json_bytes(
            data, body.get("selections", []),
            query.Filter(fd.get("field", ""), op, fd.get("value", ""))))
        want = list(ref_query.query_json_bytes(
            data, body.get("selections", []),
            ref_query.Filter(fd.get("field", ""), op, fd.get("value", ""))))
        assert got == want
    for expr in ("SELECT * FROM S3Object",
                 "SELECT s.a, s.n.d FROM S3Object s WHERE s.c >= 2.5",
                 "select s.b from s3object[s] where s.b = 'y'",
                 "SELECT a FROM S3Object AS t WHERE t.a != -3",
                 "SELECT count(*) FROM S3Object", "DROP TABLE x"):
        try:
            want = ref_query.parse_select(expr)
        except ValueError:
            with pytest.raises(ValueError):
                query.parse_select(expr)
            continue
        got = query.parse_select(expr)
        assert (got[0], vars(got[1])) == (want[0], vars(want[1]))
