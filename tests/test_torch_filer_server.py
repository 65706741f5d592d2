"""The port's filer server against the JAX package's, over HTTP.

* The cases of tests/test_filer_server.py run unchanged against a port
  `Cluster(with_filer=True)` (tests/torch_port_cases.py rebinds
  `Cluster`; the cases talk HTTP through `requests`), the websocket
  metadata subscription included. Not run: the aiohttp hedged-read
  internals, which the port does not have.
* The same requests to a reference `Cluster(with_filer=True)` and to
  the port's get the same statuses, bodies, listing JSON (timestamps
  and fids masked), ranges (multi-range parts compared part by part:
  the boundary is random), ETags and error bodies.
* A compressible name is stored gzipped by both volume servers: the
  same needle flags, size and stored bytes.
* A large file is streamed, not held: its GET arrives with the whole
  Content-Length first.
"""
import functools
import hashlib
import json
import re

import numpy as np
import pytest
import requests

from seaweedfs_tpu.server.cluster import Cluster as RefCluster
from seaweedfs_tpu.storage import needle as ref_ndl
from seaweedfs_tpu.storage.types import parse_file_id as ref_parse_fid
from seaweedfs_tpu_torch.server.cluster import Cluster
from seaweedfs_tpu_torch.storage import needle as port_ndl
from seaweedfs_tpu_torch.storage.types import parse_file_id

from tests import test_filer_server as ref_cases
from tests.torch_port_cases import call_case, port_cases

SEED = 20261017
PortCluster = functools.partial(Cluster, ec_backend="native")
CASES = port_cases(
    ref_cases, Cluster=PortCluster,
    skip=("TestAsyncHedgedReadFailover.test_primary_fast_failure_fails_over",
          "TestAsyncHedgedReadFailover.test_slow_primary_hedges_and_loser_is_cancelled",
          "TestAsyncHedgedReadFailover.test_all_replicas_down_returns_none_for_fallback"))


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    """The reference case file's cluster, on the port."""
    c = PortCluster(str(tmp_path_factory.mktemp("port_filer")),
                    n_volume_servers=2, volume_size_limit=16 << 20,
                    with_filer=True)
    yield c
    c.stop()


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """A reference and a port cluster, one volume server each."""
    ref = RefCluster(str(tmp_path_factory.mktemp("ref_fs")),
                     n_volume_servers=1, volume_size_limit=64 << 20,
                     with_filer=True)
    try:
        port = PortCluster(str(tmp_path_factory.mktemp("port_fs")),
                           n_volume_servers=1, volume_size_limit=64 << 20,
                           with_filer=True)
    except BaseException:
        ref.stop()
        raise
    yield ref, port
    port.stop()
    ref.stop()


@pytest.mark.parametrize("case", list(CASES))
def test_filer_server_cases_on_the_port(case, cluster, tmp_path_factory):
    call_case(CASES[case], {"cluster": cluster,
                            "tmp_path_factory": tmp_path_factory,
                            "monkeypatch": None})


_MASK = ("mtime", "crtime", "mtime_ns", "fid", "hard_link_id")


def _mask(obj):
    if isinstance(obj, dict):
        return {k: ("*" if k in _MASK else _mask(v)) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_mask(v) for v in obj]
    return obj


def _body(r):
    ctype = r.headers.get("Content-Type", "")
    if "json" in ctype and r.content:
        return _mask(r.json())
    if ctype.startswith("multipart/byteranges"):
        boundary = ctype.split("boundary=")[1]
        return [p.replace(boundary.encode(), b"B")
                for p in r.content.split(b"--" + boundary.encode())]
    return r.content


_HEADERS = ("ETag", "Content-Range", "Accept-Ranges", "Content-Length",
            "X-Seaweed-Entry")


def _both(pair, method, path, **kw):
    out = []
    for c in pair:
        r = requests.request(method, f"{c.filer_url}{path}", timeout=30,
                             **kw)
        hdrs = {h: r.headers.get(h) for h in _HEADERS}
        if hdrs["Content-Length"] is not None and not isinstance(
                _body(r), bytes):
            # masked JSON (timestamps) / a random multipart boundary
            hdrs["Content-Length"] = "masked"
        ext = {k.lower(): v for k, v in r.headers.items()
               if k.lower().startswith("x-seaweed-ext-")}
        ctype = (r.headers.get("Content-Type") or "").split(";")[0]
        out.append((r.status_code, _body(r), hdrs, ext, ctype))
    return out


def _seq(rng):
    """The request sequence both filers answer, seeded."""
    big = rng.bytes((2 << 20) + 12345)
    small = rng.bytes(3000)
    text = json.dumps({"k": [int(x) for x in rng.integers(0, 1000, 400)]}
                      ).encode()
    return [
        ("POST", "/docs/a.bin", {"data": small}),
        ("POST", "/docs/big.bin", {"data": big, "params": {"maxMB": "1"}}),
        ("POST", "/docs/full.bin", {"data": big, "params": {
            "maxMB": "1", "fullmd5": "1"}}),
        ("POST", "/docs/t.json", {"data": text, "headers": {
            "Content-Type": "application/json",
            "x-seaweed-ext-s3_meta_color": "blue%20sky"}}),
        ("GET", "/docs/a.bin", {}),
        ("GET", "/docs/big.bin", {}),
        ("GET", "/docs/full.bin", {}),
        ("GET", "/docs/t.json", {}),
        ("HEAD", "/docs/big.bin", {}),
        ("GET", "/docs/big.bin", {"headers": {"Range": "bytes=100-2100000"}}),
        ("GET", "/docs/big.bin", {"headers": {"Range": "bytes=-5000"}}),
        ("GET", "/docs/big.bin", {"headers": {"Range": "bytes=2097000-"}}),
        ("GET", "/docs/big.bin", {"headers": {
            "Range": "bytes=0-9,1048570-1048590,-3"}}),
        ("HEAD", "/docs/big.bin", {"headers": {"Range": "bytes=5-9"}}),
        ("GET", "/docs/big.bin", {"headers": {"Range": "bytes=9999999-"}}),
        ("GET", "/docs/big.bin", {"headers": {"Range": "bytes=x-y"}}),
        ("GET", "/docs/a.bin", {"headers": {
            "If-None-Match": f'"{hashlib.md5(small).hexdigest()}"'}}),
        ("GET", "/docs/missing.bin", {}),
        ("GET", "/docs/a.bin", {"params": {"meta": "1"}}),
        ("GET", "/docs/big.bin", {"params": {"metadata": "true",
                                             "resolveManifest": "true"}}),
        ("POST", "/docs/sub/", {}),
        ("POST", "/docs/sub/x.txt", {"data": b"x" * 50}),
        ("POST", "/docs/inline.txt", {"data": b"inline bytes",
                                      "params": {"saveInside": "true"}}),
        ("GET", "/docs/inline.txt", {"headers": {"Range": "bytes=7-11"}}),
        ("GET", "/docs/", {"params": {"limit": "2"}}),
        ("GET", "/docs/", {"params": {"limit": "2",
                                      "lastFileName": "big.bin"}}),
        ("GET", "/docs/", {"params": {"prefix": "t"}}),
        ("GET", "/docs/", {"params": {"namePattern": "*.bin"}}),
        ("GET", "/docs/", {"params": {"namePatternExclude": "*.bin"}}),
        ("PUT", "/docs/renamed.bin", {"params": {"mv.from": "/docs/a.bin"}}),
        ("GET", "/docs/a.bin", {}),
        ("GET", "/docs/renamed.bin", {}),
        ("PUT", "/docs/linked.bin", {"params": {
            "link.from": "/docs/renamed.bin"}}),
        ("GET", "/docs/linked.bin", {}),
        ("PUT", "/docs/sub", {"params": {"mv.from": "/docs"}}),
        ("DELETE", "/docs/sub", {}),
        ("DELETE", "/docs/missing", {}),
        ("POST", "/docs/md5.bin", {"data": b"abc", "headers": {
            "Content-MD5": "kAFQmDzST7DWlj99KOF/cg=="}}),
        ("POST", "/docs/md5.bin", {"data": b"abd", "headers": {
            "Content-MD5": "kAFQmDzST7DWlj99KOF/cg=="}}),
        ("POST", "/docs/md5.bin", {"data": b"abc", "headers": {
            "Content-MD5": "not-base64"}}),
        ("POST", "/docs/form.bin", {"files": {
            "file": ("upload.bin", b"\x00\x01form", "image/png")}}),
        ("GET", "/docs/form.bin", {}),
        ("POST", "/docs/form2.bin", {"files": {
            "other": ("x.bin", b"no file part")}}),
        ("PUT", "/kv/some/key", {"data": b"\x00\x01v"}),
        ("GET", "/kv/some/key", {}),
        ("DELETE", "/kv/some/key", {}),
        ("GET", "/kv/some/key", {}),
        ("PUT", "/kv/filer.conf", {"data": json.dumps({"rules": [
            {"location_prefix": "/ro/", "read_only": True},
            {"location_prefix": "/short/",
             "max_file_name_length": 4}]}).encode()}),
        ("POST", "/ro/x.bin", {"data": b"no"}),
        ("DELETE", "/ro/x.bin", {}),
        ("POST", "/short/toolong.bin", {"data": b"no"}),
        ("POST", "/short/ok", {"data": b"yes"}),
        ("POST", "/dlm/find", {"data": b"not json"}),
        ("DELETE", "/docs", {}),
        ("DELETE", "/docs", {"params": {"recursive": "true"}}),
        ("GET", "/docs/renamed.bin", {}),
    ]


def test_same_requests_same_answers(pair):
    rng = np.random.default_rng(SEED)
    for method, path, kw in _seq(rng):
        ref, port = _both(pair, method, path, **kw)
        assert port == ref, (method, path, kw.get("params"),
                             kw.get("headers"))


def _needle(cluster, path: str, parse, ndl):
    meta = requests.get(f"{cluster.filer_url}{path}",
                        params={"meta": "1"}, timeout=30).json()
    vid, key, cookie = parse(meta["chunks"][0]["fid"])
    for s in cluster.stores:
        if s.has_volume(vid):
            n = s.read_needle(vid, key, cookie)
            return n.flags & ndl.FLAG_IS_COMPRESSED, len(n.data), n.data, \
                n.name
    raise AssertionError(f"no store holds volume {vid}")


@pytest.mark.parametrize("name,compressed", [
    ("logs/app.log", True), ("data/rows.json", True),
    ("bin/blob.bin", False), ("logs/short.txt", False)])
def test_compressible_names_stored_gzipped_by_both(pair, name, compressed):
    rng = np.random.default_rng([SEED, len(name)])
    if name.endswith(".bin"):
        data = rng.bytes(5000)
    elif "short" in name:
        data = b"tiny"
    else:
        data = ("\n".join(f"{i} {w}" for i, w in enumerate(
            rng.choice(["GET", "PUT", "ok", "miss"], 800)))).encode()
    ref, port = pair
    got = []
    for c, parse, ndl in ((ref, ref_parse_fid, ref_ndl),
                          (port, parse_file_id, port_ndl)):
        r = requests.post(f"{c.filer_url}/gz/{name}", data=data, timeout=30)
        assert r.status_code == 201
        assert requests.get(f"{c.filer_url}/gz/{name}",
                            timeout=30).content == data
        got.append(_needle(c, f"/gz/{name}", parse, ndl))
    assert got[0] == got[1]
    assert bool(got[1][0]) is compressed
    if compressed:
        assert got[1][1] < len(data)


def test_large_get_is_streamed_with_its_length(cluster):
    """A 3-chunk file comes back piece by piece: the Content-Length is
    the whole file's, and the pieces join to its bytes."""
    data = np.random.default_rng(SEED + 1).bytes((3 << 20) + 7)
    url = f"{cluster.filer_url}/stream/big.bin"
    r = requests.post(url, data=data, params={"maxMB": "1"}, timeout=30)
    assert r.status_code == 201
    meta = requests.get(url, params={"meta": "1"}, timeout=30).json()
    assert len(meta["chunks"]) == 4
    with requests.get(url, stream=True, timeout=30) as g:
        assert g.headers["Content-Length"] == str(len(data))
        pieces = list(g.iter_content(1 << 16))
    assert b"".join(pieces) == data
    got = requests.get(url, headers={"Range": "bytes=1048570-3145730"},
                       timeout=30)
    assert got.status_code == 206 and got.content == data[1048570:3145731]
    assert re.fullmatch(r"bytes 1048570-3145730/3145735",
                        got.headers["Content-Range"])
