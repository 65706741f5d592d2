"""Chunk manifests on the port's volume server against the JAX
package's, with tolerance 0.

* Every case of the reference's tests/test_chunked_manifest.py runs
  twice, `[reference]` on the JAX package's cluster and `[port]` on the
  port's (tests/torch_port_cases.py rebinds the case's names; an import
  inside a case gets the port's module): the manifest's round trip, the
  chunked upload read back whole, by one range and by several, HEAD,
  `?cm=false`, the delete cascade, the native front's relays of a
  manifest GET and DELETE, and readDeleted.
* Each package's `upload_chunked` stores a seeded file of uneven size on
  the other package's cluster: the GET reassembles the same bytes, the
  `?cm=false` manifest is byte-equal to both packages' `marshal()` of
  the chunk list, and a manifest-only DELETE leaves no chunk readable.
* The manifest's JSON and `load_chunk_manifest` (plain and gzipped) are
  byte-equal between the packages on seeded chunk lists.
"""
import functools
import gzip
import json

import numpy as np
import pytest
import requests

import seaweedfs_tpu_torch.native.dataplane as port_dpmod
import seaweedfs_tpu_torch.operation.chunked_file as port_chunked
import seaweedfs_tpu_torch.storage.needle as port_needle
import seaweedfs_tpu_torch.storage.volume as port_volume
from seaweedfs_tpu.operation import chunked_file as ref_chunked
from seaweedfs_tpu.server.cluster import Cluster as RefCluster
from seaweedfs_tpu_torch.server.cluster import Cluster

from tests import test_chunked_manifest as ref_cases
from tests.torch_port_cases import port_cases, run_case, swap_modules

SEED = 20261017
PortCluster = functools.partial(Cluster, ec_backend="native")
SIDES = {
    "reference": (port_cases(ref_cases), {}),
    "port": (port_cases(ref_cases, Cluster=PortCluster,
                        ChunkManifest=port_chunked.ChunkManifest,
                        load_chunk_manifest=port_chunked
                        .load_chunk_manifest),
             {"seaweedfs_tpu.operation.chunked_file": port_chunked,
              "seaweedfs_tpu.native.dataplane": port_dpmod,
              "seaweedfs_tpu.storage.needle": port_needle,
              "seaweedfs_tpu.storage.volume": port_volume}),
}
CASES = list(SIDES["port"][0])


def test_every_reference_case_is_mirrored():
    assert CASES == list(port_cases(ref_cases))
    assert len(CASES) == 9


@pytest.fixture(scope="module")
def clusters(tmp_path_factory):
    """One cluster of each package, the reference fixture's shape."""
    ref = RefCluster(str(tmp_path_factory.mktemp("ref_chunked")),
                     n_volume_servers=1, volume_size_limit=64 << 20)
    try:
        port = PortCluster(str(tmp_path_factory.mktemp("port_chunked")),
                           n_volume_servers=1, volume_size_limit=64 << 20)
    except BaseException:
        ref.stop()
        raise
    yield {"reference": ref, "port": port}
    port.stop()
    ref.stop()


@pytest.mark.parametrize("side", list(SIDES))
@pytest.mark.parametrize("case", CASES)
def test_reference_case(case, side, clusters, tmp_path):
    cases, swaps = SIDES[side]
    with swap_modules(swaps, parents=True):
        run_case(cases[case], {"cluster": clusters[side],
                               "tmp_path": tmp_path})


def _seeded(n: int, seed: int) -> bytes:
    return np.random.default_rng([SEED, seed]).bytes(n)


def _url(cluster, fid: str) -> str:
    a = requests.get(f"{cluster.master_url}/dir/lookup",
                     params={"volumeId": fid.split(",")[0]},
                     timeout=10).json()
    return f"http://{a['locations'][0]['url']}/{fid}"


@pytest.mark.parametrize("client,server", [("reference", "port"),
                                           ("port", "reference")])
def test_upload_chunked_across_packages(client, server, clusters):
    mod = ref_chunked if client == "reference" else port_chunked
    cluster = clusters[server]
    data = _seeded(3 * (1 << 20) + 12345, 1)
    chunk = (1 << 20) - 999   # uneven: the last chunk is short

    def pieces():
        for off in range(0, len(data), chunk):
            yield data[off:off + chunk]

    fid, stored = mod.upload_chunked(cluster.master_url, pieces(),
                                     len(data), "cross.bin",
                                     "application/x-cross", chunk)
    assert stored == len(data)
    url = _url(cluster, fid)
    g = requests.get(url, timeout=30)
    assert g.status_code == 200 and g.content == data
    assert g.headers["Content-Type"] == "application/x-cross"
    raw = requests.get(url, params={"cm": "false"}, timeout=30).content
    cm = port_chunked.load_chunk_manifest(raw)
    assert [c.offset for c in cm.chunks] == list(range(0, len(data), chunk))
    ref_cm = ref_chunked.ChunkManifest(
        name=cm.name, mime=cm.mime, size=cm.size,
        chunks=[ref_chunked.ChunkInfo(c.fid, c.offset, c.size)
                for c in cm.chunks])
    assert raw == cm.marshal() == ref_cm.marshal()
    chunk_urls = [_url(cluster, c.fid) for c in cm.chunks]
    d = requests.delete(url, timeout=30)
    assert d.status_code == 202 and d.json()["size"] == len(data)
    for cu in chunk_urls + [url]:
        assert requests.get(cu, timeout=10).status_code == 404, cu


@pytest.mark.parametrize("seed", range(4))
def test_manifest_bytes_match(seed):
    rng = np.random.default_rng([SEED, 100 + seed])
    n = int(rng.integers(0, 6))
    rows = [(f"{int(rng.integers(1, 99))},{int(rng.integers(1 << 40)):x}"
             f"{int(rng.integers(1 << 32)):08x}",
             int(rng.integers(0, 1 << 34)), int(rng.integers(0, 1 << 26)))
            for _ in range(n)]
    name = ["", "a.bin", "dir/ünï.txt"][seed % 3]
    mime = ["", "text/plain", "application/octet-stream"][seed % 3]
    size = sum(r[2] for r in rows)
    mk = {m: m.ChunkManifest(name=name, mime=mime, size=size,
                             chunks=[m.ChunkInfo(*r) for r in rows])
          for m in (ref_chunked, port_chunked)}
    raw = mk[port_chunked].marshal()
    assert raw == mk[ref_chunked].marshal()
    for blob, gz in ((raw, False), (gzip.compress(raw), True)):
        got = port_chunked.load_chunk_manifest(blob, gz)
        want = ref_chunked.load_chunk_manifest(blob, gz)
        assert json.dumps(got.__dict__, default=vars) == \
            json.dumps(want.__dict__, default=vars)
        assert [(c.fid, c.offset, c.size) for c in
                got.as_file_chunks()] == \
            [(c.fid, c.offset, c.size) for c in want.as_file_chunks()]


def test_native_front_relays_each_new_kind(clusters):
    """Through a port volume server behind its native front, each
    request kind of this slice is relayed to the Python handlers (the
    front's `proxied` count grows by one) and answered as they answer:
    a ?cm=true POST, a manifest GET, HEAD, multi-range GET and DELETE,
    a multipart/form-data POST."""
    c = clusters["port"]
    vs = c.volume_servers[0]
    public = vs.enable_native(0, c.volume_threads[0].port)
    base = f"http://127.0.0.1:{public}"
    try:
        data = _seeded((2 << 20) + 99, 7)
        chunk = 1 << 20
        chunks = []
        for off in range(0, len(data), chunk):
            a = port_chunked.verbs.assign(c.master_url)
            r = requests.post(f"{base}/{a.fid}", data=data[off:off + chunk],
                              timeout=30)
            assert r.status_code == 201, r.text
            chunks.append(port_chunked.ChunkInfo(a.fid, off,
                                                 len(data[off:off + chunk])))
        cm = port_chunked.ChunkManifest(name="front.bin", size=len(data),
                                        chunks=chunks)
        a = port_chunked.verbs.assign(c.master_url)
        url = f"{base}/{a.fid}"

        def relayed(method, u, **kw):
            before = vs.dp.http_stats()["proxied"]
            r = requests.request(method, u, timeout=30, **kw)
            assert vs.dp.http_stats()["proxied"] == before + 1, method
            return r

        r = relayed("POST", url + "?cm=true", data=cm.marshal())
        assert r.status_code == 201, r.text
        g = relayed("GET", url)
        assert g.content == data and g.headers["X-File-Store"] == "chunked"
        h = relayed("HEAD", url)
        assert h.headers["Content-Length"] == str(len(data))
        m = relayed("GET", url, headers={
            "Range": "bytes=0-9,1048570-1048579,-5"})
        assert m.status_code == 206 and data[1048570:1048580] in m.content
        d = relayed("DELETE", url)
        assert d.status_code == 202 and d.json()["size"] == len(data)
        for ch in chunks:
            assert requests.get(f"{base}/{ch.fid}",
                                timeout=10).status_code == 404
        a = port_chunked.verbs.assign(c.master_url)
        r = relayed("POST", f"{base}/{a.fid}",
                    files={"file": ("form.txt", b"form body", "text/x-f")})
        assert r.status_code == 201 and r.json()["name"] == "form.txt"
        g = requests.get(f"{base}/{a.fid}", timeout=10)
        assert (g.content, g.headers["Content-Type"]) == (b"form body",
                                                          "text/x-f")
    finally:
        vs.disable_native()


@pytest.mark.parametrize("side", ["reference", "port"])
def test_replicated_manifest_keeps_its_flag(side, tmp_path):
    """A ?cm=true POST to a 001 volume: the port's fan-out forwards the
    manifest flag, so the replica reassembles on GET as the primary
    does. The reference's fan-out drops it: its replica stores the
    manifest as plain bytes (a shared fault, fixed in the port)."""
    cls = RefCluster if side == "reference" else PortCluster
    c = cls(str(tmp_path), n_volume_servers=2, volume_size_limit=16 << 20,
            default_replication="001")
    try:
        data = _seeded(300_000, 9)
        a = requests.get(f"{c.master_url}/dir/assign", timeout=10).json()
        chunk = f"http://{a['url']}/{a['fid']}"
        assert requests.post(chunk, data=data, timeout=30).status_code \
            == 201
        cm = port_chunked.ChunkManifest(
            name="r.bin", size=len(data),
            chunks=[port_chunked.ChunkInfo(a["fid"], 0, len(data))])
        m = requests.get(f"{c.master_url}/dir/assign", timeout=10).json()
        r = requests.post(f"http://{m['url']}/{m['fid']}?cm=true",
                          data=cm.marshal(), timeout=30)
        assert r.status_code == 201, r.text
        vid, key = (int(x, 16) if i else int(x) for i, x in enumerate(
            (m["fid"].split(",")[0], m["fid"].split(",")[1][:-8])))
        flags = [s.read_needle(vid, key).is_chunk_manifest
                 for s in c.stores if s.find_volume(vid) is not None]
        # the primary flags it in both packages; the replica in the port
        assert sorted(flags) == ([True, True] if side == "port"
                                 else [False, True])
        for s in c.stores:
            g = requests.get(f"http://{s.ip}:{s.port}/{m['fid']}",
                             timeout=30)
            if side == "port":
                assert g.content == data
    finally:
        c.stop()
