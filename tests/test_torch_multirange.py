"""Multi-range GETs and paged reads on the port's volume server against
the JAX package's, with tolerance 0.

* Every case of the reference's tests/test_multirange.py runs twice,
  `[reference]` and `[port]` (tests/torch_port_cases.py rebinds
  `Cluster` and `httprange`): the range parser, the filer's and the
  volume server's multipart/byteranges (Python and through the native
  front), the S3 gateway's, the 416s, and needles past the paged-read
  limit.
* The same seeded 3-range request goes to a reference and a port volume
  server on the same needle bytes, directly and through each package's
  native front: status, Content-Type up to the boundary, and every
  part's headers and body are equal. So are single-range and
  whole-needle replies of a needle past the paged-read limit, whose
  GETs go through the port's paged path (counted by
  `volume_server_paged_reads_total`) also when the native front relays
  them.
"""
import functools
import re

import numpy as np
import pytest
import requests

import seaweedfs_tpu_torch.native.dataplane as port_dpmod
from seaweedfs_tpu.server.cluster import Cluster as RefCluster
from seaweedfs_tpu_torch.server.cluster import Cluster
from seaweedfs_tpu_torch.utils import httprange, metrics

from tests import test_multirange as ref_cases
from tests.torch_port_cases import port_cases, run_case, swap_modules

SEED = 20261017
PortCluster = functools.partial(Cluster, ec_backend="native")
SIDES = {
    "reference": (port_cases(ref_cases), RefCluster, {}),
    "port": (port_cases(ref_cases, Cluster=PortCluster,
                        httprange=httprange),
             PortCluster,
             {"seaweedfs_tpu.native.dataplane": port_dpmod}),
}
CASES = list(SIDES["port"][0])


def test_every_reference_case_is_mirrored():
    assert CASES == list(port_cases(ref_cases))
    assert len(CASES) == 15


@pytest.fixture(scope="module")
def clusters(tmp_path_factory):
    """One cluster (with a filer) of each package, as the reference
    fixture, and the 3 MB filer file its filer cases read."""
    out = {}
    try:
        for side, (_, cls, _) in SIDES.items():
            c = out[side] = cls(str(tmp_path_factory.mktemp(side)),
                                n_volume_servers=1,
                                volume_size_limit=64 << 20,
                                with_filer=True)
            url = f"{c.filer_url}/mr/blob.bin"
            r = requests.post(url, data=ref_cases.BLOB, params={"maxMB": "1"},
                              headers={"Content-Type":
                                       "application/octet-stream"},
                              timeout=60)
            assert r.status_code == 201, r.text
        yield out
    finally:
        for c in out.values():
            c.stop()


@pytest.mark.parametrize("side", list(SIDES))
@pytest.mark.parametrize("case", CASES)
def test_reference_case(case, side, clusters, tmp_path_factory):
    cases, _, swaps = SIDES[side]
    c = clusters[side]
    with swap_modules(swaps, parents=True):
        run_case(cases[case], {
            "cluster": c, "filer_file": f"{c.filer_url}/mr/blob.bin",
            "tmp_path_factory": tmp_path_factory})


def _parts(body: bytes, content_type: str) -> list:
    m = re.search(r"boundary=([0-9a-f]+)", content_type)
    assert m, content_type
    delim = b"--" + m.group(1).encode()
    pieces = body.split(delim)
    assert pieces[0] == b"" and pieces[-1] == b"--\r\n"
    out = []
    for raw in pieces[1:-1]:
        head, _, data = raw[2:].partition(b"\r\n\r\n")
        assert data.endswith(b"\r\n")
        out.append((head, data[:-2]))
    return out


def _same_needle(clusters, body: bytes, mime: str) -> dict:
    """POST the same bytes under the same mime to one needle of each
    package -> {side: url}."""
    urls = {}
    for side, c in clusters.items():
        a = requests.get(f"{c.master_url}/dir/assign", timeout=10).json()
        url = f"http://{a['publicUrl']}/{a['fid']}"
        r = requests.post(url, data=body, headers={"Content-Type": mime},
                          timeout=60)
        assert r.status_code == 201, r.text
        urls[side] = url
    return urls


def _front(cluster, side: str):
    vs = cluster.volume_servers[0]
    return vs.enable_native(0, cluster.volume_threads[0].port)


def _spec(rng, size: int) -> str:
    starts = sorted(int(x) for x in rng.choice(size - 64, 3,
                                               replace=False))
    return "bytes=" + ",".join(
        f"{s}-{s + int(rng.integers(1, 64))}" for s in starts)


@pytest.mark.parametrize("via", ["python", "native"])
@pytest.mark.parametrize("seed", range(3))
def test_three_ranges_equal(clusters, seed, via):
    rng = np.random.default_rng([SEED, seed])
    size = int(rng.integers(5000, 200_000))
    body = rng.bytes(size)
    mime = ["application/octet-stream", "text/x-seeded", ""][seed]
    urls = _same_needle(clusters, body, mime or "application/octet-stream")
    spec = _spec(rng, size)
    replies = {}
    for side, url in urls.items():
        c = clusters[side]
        if via == "native":
            public = _front(c, side)
            url = re.sub(r"//[^/]+/", f"//127.0.0.1:{public}/", url)
        try:
            replies[side] = requests.get(url, headers={"Range": spec},
                                         timeout=30)
        finally:
            if via == "native":
                c.volume_servers[0].disable_native()
    ref, port = replies["reference"], replies["port"]
    assert port.status_code == ref.status_code == 206
    assert port.headers["Content-Type"].split("boundary=")[0] == \
        ref.headers["Content-Type"].split("boundary=")[0]
    assert _parts(port.content, port.headers["Content-Type"]) == \
        _parts(ref.content, ref.headers["Content-Type"])
    assert len(_parts(ref.content, ref.headers["Content-Type"])) == 3


def _paged_reads() -> float:
    return metrics.counter_value("volume_server_paged_reads_total")


@pytest.mark.parametrize("via", ["python", "native"])
def test_paged_reads_equal(clusters, via):
    rng = np.random.default_rng([SEED, 50])
    size = (3 << 20) + 4321
    body = rng.bytes(size)
    urls = _same_needle(clusters, body, "application/x-paged")
    specs = [None, "bytes=1048570-2097161", f"bytes=-{size // 3}",
             "bytes=5-5"]
    for spec in specs:
        got = {}
        before = _paged_reads()
        for side, url in urls.items():
            c = clusters[side]
            if via == "native":
                public = _front(c, side)
                # a query the front does not serve: relayed to Python
                url = re.sub(r"//[^/]+/", f"//127.0.0.1:{public}/",
                             url) + "?relayed=1"
            try:
                got[side] = requests.get(
                    url, headers={"Range": spec} if spec else {},
                    timeout=30)
            finally:
                if via == "native":
                    c.volume_servers[0].disable_native()
        ref, port = got["reference"], got["port"]
        assert port.status_code == ref.status_code
        assert port.content == ref.content
        for h in ("Content-Type", "Content-Range", "Content-Length",
                  "Etag"):
            assert port.headers.get(h) == ref.headers.get(h), h
        # the port's reply came through its paged path
        assert _paged_reads() == before + 1, spec
