"""The port's WebDAV gateway against the JAX package's, with tolerance 0.

* The WebDAV cases of tests/test_webdav_iam.py run `[reference]` on the
  JAX package's gateway over its filer and `[port]` on the port's over
  the port's filer (tests/torch_port_cases.py rebinds the fixture).
* Over each package's filer, the reference's gateway and the port's
  answer the same requests alike: PROPFIND Depth 0 and 1 byte for byte
  over the same entries (escaped names, sizes, dates); every method's
  status, headers and body through a script with each refusal (404,
  405, 409, 412, 423, 400); a file over the filer's chunk size
  round-trips through each gateway over each filer, whole and ranged.
* An HTTP method no route takes (OPTIONS, PROPFIND at a filer) answers
  405 from both filers, where the port's standard-library server
  answered 501.
* The reference's regression case of a LOCK refresh (the token kept,
  UNLOCK only with it) runs on both gateways; a spent X-Sw-Deadline
  answers 504 from both (the deadline middleware at this edge).
* Under `-jwt.secret` a WebDAV DELETE leaves the file's chunk on its
  volume: the filer's unsigned chunk DELETE gets 401 in both packages
  (ROADMAP Queue 3 item 5, a fault both keep).
"""
import functools
import hashlib
import re
import time

import numpy as np
import pytest
import requests

from seaweedfs_tpu.operation import verbs as ref_verbs
from seaweedfs_tpu.rpc.http import ServerThread as RefServerThread
from seaweedfs_tpu.server.cluster import Cluster as RefCluster
from seaweedfs_tpu.webdav.server import WebDavServer as RefWebDav
from seaweedfs_tpu_torch.operation import verbs as port_verbs
from seaweedfs_tpu_torch.rpc import http as port_http
from seaweedfs_tpu_torch.rpc.http import ServerThread
from seaweedfs_tpu_torch.server.cluster import Cluster
from seaweedfs_tpu_torch.webdav import server as port_webdav
from seaweedfs_tpu_torch.webdav.server import WebDavServer

from tests import test_review_regressions2 as ref_regressions
from tests import test_webdav_iam as ref_cases
from tests.torch_port_cases import port_cases, run_case, swap_modules, within

SEED = 20261018
CHUNK = 256 << 10                 # the filers' chunk size (-maxMB)
PortCluster = functools.partial(Cluster, ec_backend="native")
PKG = {"reference": (RefCluster, RefWebDav, RefServerThread),
       "port": (PortCluster, WebDavServer, ServerThread)}
# the cases talk HTTP only: the side picks the gateway and its filer
CASES = {k: v for k, v in port_cases(ref_cases).items()
         if k.startswith("TestWebDav.")}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """A reference and a port cluster with a filer each, and over each
    filer a reference gateway and a port gateway."""
    out = {"clusters": {}, "dav": {}, "threads": []}
    try:
        for side, (Cl, _, _) in PKG.items():
            c = within(60, Cl, str(tmp_path_factory.mktemp(f"dav_{side}")),
                       n_volume_servers=1, volume_size_limit=32 << 20,
                       with_filer=True)
            c.filer.chunk_size = CHUNK
            out["clusters"][side] = c
        for filer, c in out["clusters"].items():
            for gw, (_, Dav, Thread) in PKG.items():
                t = Thread(Dav(c.filer_url).app).start()
                out["threads"].append(t)
                out["dav"][(gw, filer)] = t.url
        yield out
    finally:
        for t in out["threads"]:
            within(30, t.stop)
        for c in out["clusters"].values():
            within(60, c.stop)


def test_every_reference_case_is_mirrored():
    assert len(CASES) == 9


@pytest.mark.parametrize("side", list(PKG))
@pytest.mark.parametrize("case", list(CASES))
def test_reference_webdav_cases(case, side, world):
    run_case(CASES[case], {"gateways": {"dav": world["dav"][(side, side)]}})


def _tree(filer: str, root: str) -> dict[str, bytes]:
    """Seeded entries under `root`, written straight to the filer."""
    rng = np.random.default_rng([SEED, len(root)])
    files = {f"{root}/a.txt": b"alpha", f"{root}/empty.bin": b"",
             f"{root}/sp ace & <amp>.bin": rng.bytes(3000),
             f"{root}/ünï.txt": "ü".encode() * 100,
             f"{root}/sub/deep.bin": rng.bytes(70000)}
    for path, data in files.items():
        assert requests.put(filer + path, data=data,
                            timeout=30).status_code < 300
    assert requests.put(filer + f"{root}/emptydir", params={"mkdir": "1"},
                        timeout=30).status_code < 300
    return files


@pytest.mark.parametrize("filer", list(PKG))
def test_propfind_is_byte_equal_over_one_filer(filer, world):
    root = f"/pf-{filer}"
    _tree(world["clusters"][filer].filer_url, root)
    for path in (root, root + "/", root + "/sub", root + "/a.txt",
                 root + "/sp ace & <amp>.bin", "/"):
        for depth in ("0", "1"):
            body = {}
            for gw in PKG:
                r = requests.request("PROPFIND",
                                     world["dav"][(gw, filer)] + path,
                                     headers={"Depth": depth}, timeout=30)
                assert r.status_code == 207, (gw, path, r.text)
                assert r.headers["Content-Type"] == \
                    "application/xml; charset=utf-8"
                body[gw] = r.content
                if path == "/":
                    # a filer names the root's mtime as the time it
                    # answers: the two gateways ask a moment apart
                    body[gw] = _DATE.sub(b"DATE", body[gw], count=1)
            assert body["port"] == body["reference"], (path, depth)
    r = requests.request("PROPFIND", world["dav"][("port", filer)] + root,
                         headers={"Depth": "1"}, timeout=30)
    hrefs = re.findall(rb"<D:href>([^<]*)</D:href>", r.content)
    assert hrefs == [f"{root}/".encode()] + sorted(
        f"{root}/{n}".encode().replace(b"&", b"&amp;").replace(
            b"<", b"&lt;").replace(b">", b"&gt;")
        for n in ("a.txt", "empty.bin", "emptydir/",
                  "sp ace & <amp>.bin", "sub/", "ünï.txt"))
    sizes = re.findall(rb"<D:getcontentlength>(\d+)<", r.content)
    assert sizes == [b"0", b"5", b"0", b"0", b"3000", b"0", b"200"]


# the script's answers compared between the two gateways: status, the
# headers a client reads, and the body (lock tokens and dates masked)
_HEADERS = ("DAV", "Allow", "MS-Author-Via", "Content-Type", "ETag",
            "Content-Range", "Accept-Ranges")
_TOKEN = re.compile(rb"opaquelocktoken:[0-9a-f-]{36}")
_DATE = re.compile(rb"[A-Z][a-z]{2}, \d\d [A-Z][a-z]{2} \d{4} [\d:]{8} GMT")


def _script(base: str, root: str) -> list[tuple]:
    """Every method, with each of its refusals, under `root`."""
    out = []

    def do(label, method, path, body=None, **headers):
        url = base + root + path
        for k in ("Destination",):
            if k in headers and not headers[k].startswith("http"):
                headers[k] = base + root + headers[k]
        r = requests.request(method, url, data=body, headers=headers,
                             timeout=30)
        out.append((label, r.status_code,
                    {k: r.headers.get(k) for k in _HEADERS},
                    "Lock-Token" in r.headers,
                    "Last-Modified" in r.headers,
                    r.headers.get("Content-Length"),
                    _DATE.sub(b"DATE", _TOKEN.sub(b"TOKEN", r.content))
                    .replace(root.encode(), b"ROOT")
                    .replace(root[1:].encode(), b"NAME")))
        return r

    do("mkcol", "MKCOL", "")
    do("mkcol again: 405", "MKCOL", "")
    do("mkcol sub", "MKCOL", "/sub")
    do("options", "OPTIONS", "")
    do("put", "PUT", "/a.txt", b"alpha bytes")
    do("put over", "PUT", "/a.txt", b"alpha bytes, twice")
    do("put typed", "PUT", "/t.json", b'{"k": 1}',
       **{"Content-Type": "application/json"})
    do("get", "GET", "/a.txt")
    do("head", "HEAD", "/a.txt")
    do("range", "GET", "/a.txt", Range="bytes=2-7")
    do("get missing: 404", "GET", "/nope")
    do("get collection: 405", "GET", "/sub")
    do("propfind 0", "PROPFIND", "/a.txt", Depth="0")
    do("propfind missing: 404", "PROPFIND", "/nope", Depth="1")
    do("proppatch", "PROPPATCH", "/a.txt", b"<x/>")
    do("unknown method: 405", "REPORT", "/a.txt")
    do("copy", "COPY", "/a.txt", Destination="/b.txt")
    do("copy onto, Overwrite F: 412", "COPY", "/a.txt",
       Destination="/b.txt", Overwrite="F")
    do("copy onto", "COPY", "/a.txt", Destination="/b.txt")
    do("copy no destination: 400", "COPY", "/a.txt")
    do("copy missing: 404", "COPY", "/nope", Destination="/c.txt")
    do("copy collection", "COPY", "/sub", Destination="/sub2")
    do("move", "MOVE", "/b.txt", Destination="/sub/m.txt")
    do("move onto, Overwrite F: 412", "MOVE", "/a.txt",
       Destination="/sub/m.txt", Overwrite="F")
    do("move onto", "MOVE", "/a.txt", Destination="/sub/m.txt")
    do("move no destination: 400", "MOVE", "/sub/m.txt")
    do("move missing: 404", "MOVE", "/nope", Destination="/x.txt")
    token = do("lock", "LOCK", "/sub/m.txt").headers["Lock-Token"]
    do("lock, foreign token: 423", "LOCK", "/sub/m.txt",
       If="(<opaquelocktoken:00000000-0000-0000-0000-000000000000>)")
    do("lock refresh", "LOCK", "/sub/m.txt", If=f"({token})")
    do("put locked: 423", "PUT", "/sub/m.txt", b"x")
    do("delete locked: 423", "DELETE", "/sub/m.txt")
    do("move locked: 423", "MOVE", "/sub/m.txt", Destination="/y.txt")
    do("move onto locked: 423", "MOVE", "/t.json",
       Destination="/sub/m.txt")
    do("copy onto locked: 423", "COPY", "/t.json",
       Destination="/sub/m.txt")
    do("put with token", "PUT", "/sub/m.txt", b"held", If=f"({token})")
    do("unlock, wrong token: 409", "UNLOCK", "/sub/m.txt",
       **{"Lock-Token": "<opaquelocktoken:x>"})
    do("unlock", "UNLOCK", "/sub/m.txt", **{"Lock-Token": token})
    do("unlock, none held", "UNLOCK", "/sub/m.txt")
    do("propfind 1", "PROPFIND", "", Depth="1")
    do("delete", "DELETE", "/t.json")
    do("delete missing: 404", "DELETE", "/t.json")
    do("delete collection", "DELETE", "/sub2")
    do("get deleted: 404", "GET", "/sub2/m.txt")
    return out


@pytest.mark.parametrize("filer", list(PKG))
def test_every_method_answers_as_the_reference(filer, world):
    # roots of one length: the bodies name them (masked) and their
    # lengths are compared
    got = {gw: _script(world["dav"][(gw, filer)], f"/m-{gw[:3]}-{filer}")
           for gw in PKG}
    for ref, port in zip(got["reference"], got["port"]):
        assert port[:2] == ref[:2]
        assert port == ref, ref[0]
    assert len(got["port"]) == len(got["reference"]) == 44
    statuses = {s for _, s, *_ in got["port"]}
    assert {201, 204, 206, 207, 400, 404, 405, 409, 412, 423} <= statuses


@pytest.mark.parametrize("gw,filer", [(g, f) for g in PKG for f in PKG])
def test_a_file_over_the_chunk_size_round_trips(gw, filer, world):
    dav = world["dav"][(gw, filer)]
    fu = world["clusters"][filer].filer_url
    data = np.random.default_rng([SEED, 7]).bytes(14 * CHUNK + 1234)
    path = f"/big-{gw}-{filer}/f.bin"
    assert requests.request("MKCOL", dav + path.rsplit("/", 1)[0],
                            timeout=30).status_code == 201
    assert requests.put(dav + path, data=data, timeout=60).status_code == 201
    meta = requests.get(fu + path, params={"meta": "1"}, timeout=30).json()
    assert len(meta["chunks"]) == 15
    r = requests.get(dav + path, timeout=60)
    assert r.status_code == 200
    assert hashlib.sha256(r.content).digest() == \
        hashlib.sha256(data).digest()
    assert r.headers["Content-Length"] == str(len(data))
    h = requests.head(dav + path, timeout=30)
    assert (h.status_code, h.headers["Content-Length"]) == \
        (200, str(len(data)))
    lo, hi = CHUNK - 17, 3 * CHUNK + 5
    r = requests.get(dav + path, headers={"Range": f"bytes={lo}-{hi}"},
                     timeout=30)
    assert r.status_code == 206 and r.content == data[lo:hi + 1]
    assert r.headers["Content-Range"] == f"bytes {lo}-{hi}/{len(data)}"


@pytest.mark.parametrize("filer", list(PKG))
def test_a_method_no_route_takes_answers_405(filer, world):
    fu = world["clusters"][filer].filer_url
    for method in ("OPTIONS", "PROPFIND", "MKCOL", "LOCK"):
        for path in ("/", "/some/dir", "/status"):
            r = requests.request(method, fu + path, timeout=30)
            assert r.status_code == 405, (method, path, r.status_code)


def test_port_app_answers_unrouted_methods_as_aiohttp():
    """An App routing no WebDAV method: 405 on a known path, 404 on an
    unknown one, never the standard library's 501; a "*" route takes
    every method."""
    from seaweedfs_tpu_torch.rpc.http import App, text_response

    app = App()
    app.get("/known", lambda r: text_response("k"))
    app.route("*", "/any/{rest:.*}", lambda r: text_response(r.method))
    t = ServerThread(app).start()
    try:
        for method, path, want in (("PROPFIND", "/known", 405),
                                   ("OPTIONS", "/known", 405),
                                   ("MKCOL", "/unknown", 404),
                                   ("GET", "/known", 200)):
            assert requests.request(method, t.url + path,
                                    timeout=10).status_code == want
        for method in ("PROPFIND", "MOVE", "COPY", "LOCK", "UNLOCK",
                       "PROPPATCH", "OPTIONS", "GET", "DELETE"):
            r = requests.request(method, t.url + "/any/x", timeout=10)
            assert (r.status_code, r.text) == (200, method)
    finally:
        t.stop()


@pytest.mark.parametrize("side", list(PKG))
def test_jwt_chunk_delete_is_refused_and_the_chunk_stays(side, tmp_path,
                                                         monkeypatch):
    """ROADMAP Queue 3 item 5: the filer deletes a file's chunks without
    a token, every volume server answers 401, and the error is dropped
    (both packages): the chunk stays on its volume."""
    Cl, Dav, Thread = PKG[side]
    verbs = ref_verbs if side == "reference" else port_verbs
    refused: list[str] = []
    real_delete = verbs.delete

    def spy(url, *args, **kwargs):
        try:
            return real_delete(url, *args, **kwargs)
        except Exception as e:
            refused.append(str(e))
            raise

    monkeypatch.setattr(verbs, "delete", spy)
    c = within(60, Cl, str(tmp_path / side), n_volume_servers=1,
               volume_size_limit=16 << 20, with_filer=True,
               jwt_secret="webdav-jwt-secret")
    t = None
    try:
        t = Thread(Dav(c.filer_url).app).start()
        data = b"guarded bytes " * 100
        assert requests.put(t.url + "/g.bin", data=data,
                            timeout=30).status_code == 201
        fid = requests.get(c.filer_url + "/g.bin", params={"meta": "1"},
                           timeout=30).json()["chunks"][0]["fid"]
        assert requests.get(f"{c.volume_url(0)}/{fid}",
                            timeout=30).content == data
        assert requests.delete(t.url + "/g.bin", timeout=30).status_code \
            == 204
        assert requests.get(t.url + "/g.bin", timeout=30).status_code == 404
        deadline = time.monotonic() + 20
        while not refused and time.monotonic() < deadline:
            time.sleep(0.05)
        assert refused and all("401" in e for e in refused), refused
        r = requests.get(f"{c.volume_url(0)}/{fid}", timeout=30)
        assert (r.status_code, r.content) == (200, data)
    finally:
        if t is not None:
            within(30, t.stop)
        within(60, c.stop)


LOCK_CASE = port_cases(ref_regressions)[
    "TestWave3.test_webdav_lock_refresh_keeps_token_and_unlock_validates"]


@pytest.mark.parametrize("side", list(PKG))
def test_lock_refresh_keeps_its_token(side, world):
    """The reference's regression case: a LOCK presenting the live
    token keeps it; only the holder's token UNLOCKs."""
    mapping = {"seaweedfs_tpu.webdav.server": port_webdav,
               "seaweedfs_tpu.rpc.http": port_http} if side == "port" \
        else {}
    with swap_modules(mapping, parents=True):
        run_case(LOCK_CASE, {"cluster": world["clusters"][side]})


@pytest.mark.parametrize("gw", list(PKG))
def test_a_spent_deadline_answers_504(gw, world):
    """The gateway keeps the deadline middleware: a request whose
    X-Sw-Deadline has passed answers 504 before any filer hop."""
    for method in ("GET", "PROPFIND", "PUT"):
        r = requests.request(method, world["dav"][(gw, gw)] + "/dl.txt",
                             headers={"X-Sw-Deadline": "1.0"}, data=b"x",
                             timeout=30)
        assert r.status_code == 504, (method, r.status_code)
    assert requests.get(world["dav"][(gw, gw)] + "/dl.txt",
                        timeout=30).status_code == 404
