"""The port's client subcommands, form uploads, the manifest delete
cascade and a replication change under the native front, against the
JAX package where both run.

* The cases of the reference's tests/test_cli_misc.py and
  tests/test_scaffold_metrics.py that concern the subcommands and pages
  the port has run twice, `[reference]` and `[port]` (the spawned
  `python -m seaweedfs_tpu` runs the port's package through
  tests/torch_port_procs): the bash listing of every subcommand (it
  names fuse and ftp), autocomplete for zsh, unautocomplete and update,
  -memprofile's report, the pushgateway loop behind -metrics.address,
  scaffold's templates and its CLI, the volume server's status page.
  Left out: the gateway metrics and the filer's HTML listings.
* `fuse <mnt> -o filer=...,filer.path=/d,ro` splits its options as the
  reference's does: the mount's own, their defaults, the rest for fuse.
* Multipart/form-data POSTs — seeded forms as the reference's clients
  encode them, and hand-framed ones (a preamble, no filename, a part
  without Content-Type, a UTF-8 filename, a quoted boundary) — go to
  a reference and a port volume server at the same fid: the replies
  and the stored needles (data, name, mime, flags, checksum) are equal;
  an empty form is 400 from both.
* `upload -maxMB` (chunked) and plain, `download`, `benchmark -n 64
  -client python` and `benchmark -target filer|s3` through `cli.main`
  against a port cluster.
* A chunked file's manifest DELETE leaves no chunk on disk: every chunk
  is a tombstone, and gone for good after a vacuum.
* A volume attached to the native front as `000` and reconfigured to
  `001`: the next POST is relayed and refused (no replica to fan out
  to) rather than acked with one copy; once volume.fix.replication made
  the second copy, a POST lands on both servers.
"""
import functools
import json
import time

import numpy as np
import pytest
import requests

from seaweedfs_tpu.server.cluster import Cluster as RefCluster
from seaweedfs_tpu.storage.types import parse_file_id as ref_parse
from seaweedfs_tpu_torch import cli, scaffold
from seaweedfs_tpu_torch.operation import verbs
from seaweedfs_tpu_torch.server.cluster import Cluster
from seaweedfs_tpu_torch.shell import repl
from seaweedfs_tpu_torch.shell.env import CommandEnv
from seaweedfs_tpu_torch.storage.types import parse_file_id
from seaweedfs_tpu_torch.utils import metrics

from tests import test_cli_misc as ref_misc
from tests import test_scaffold_metrics as ref_scaffold
from tests import torch_port_procs
from tests.torch_port_cases import port_cases, run_case, swap_modules

SEED = 20261017
PortCluster = functools.partial(Cluster, ec_backend="native")
MISC = ("TestVerbs.test_autocomplete_lists_all_subcommands",
        "TestVerbs.test_autocomplete_zsh",
        "TestVerbs.test_unautocomplete_and_update",
        "TestVerbs.test_memprofile_written",
        "TestMetricsPush.test_push_loop_delivers")
SCAFFOLD = ("TestScaffold.test_all_templates_render",
            "TestScaffold.test_unknown_raises",
            "TestScaffold.test_cli_prints_and_writes",
            "TestGatewayMetrics.test_templates_are_valid_json",
            "TestStatusUis.test_volume_and_filer_ui_pages")


def _only(cases: dict, keep) -> dict:
    return {k: v for k, v in cases.items() if k in keep}


CASES = {"reference": {**_only(port_cases(ref_misc), MISC),
                       **_only(port_cases(ref_scaffold), SCAFFOLD)},
         "port": {**_only(port_cases(ref_misc, subprocess=torch_port_procs),
                          MISC),
                  **_only(port_cases(ref_scaffold,
                                     subprocess=torch_port_procs,
                                     Cluster=PortCluster,
                                     TEMPLATES=scaffold.TEMPLATES,
                                     scaffold=scaffold.scaffold),
                          SCAFFOLD)}}


def test_the_chosen_cases_exist():
    assert list(CASES["port"]) == list(MISC + SCAFFOLD)
    assert list(CASES["reference"]) == list(MISC + SCAFFOLD)


@pytest.mark.parametrize("side", list(CASES))
@pytest.mark.parametrize("case", list(MISC + SCAFFOLD))
def test_reference_case(case, side, tmp_path, tmp_path_factory):
    swaps = {"seaweedfs_tpu.operation.verbs": verbs,
             "seaweedfs_tpu.utils.metrics": metrics} \
        if side == "port" else {}
    fn = CASES[side][case]
    if case == "TestStatusUis.test_volume_and_filer_ui_pages" and \
            side == "port":
        # the master's UI page is not in the port: run the case's
        # volume and filer halves
        fn = _volume_ui_case
    with swap_modules(swaps, parents=True):
        run_case(fn, {"tmp_path": tmp_path,
                      "tmp_path_factory": tmp_path_factory})


def _volume_ui_case(tmp_path_factory):
    c = PortCluster(str(tmp_path_factory.mktemp("ui")), n_volume_servers=1,
                    volume_size_limit=16 << 20, with_filer=True)
    try:
        a = verbs.assign(c.master_url)
        verbs.upload(a, b"ui-test")
        for path in ("/", "/ui/index.html"):
            r = requests.get(c.volume_url(0) + path, timeout=10)
            assert r.status_code == 200
            assert "volume server" in r.text and "<table" in r.text
            assert f"<tr><td>{a.fid.split(',')[0]}</td>" in r.text
        requests.post(f"{c.filer_url}/docs/page.txt", data=b"x",
                      timeout=10)
        r = requests.get(f"{c.filer_url}/docs", timeout=10,
                         headers={"Accept": "text/html"})
        assert "page.txt" in r.text and "<table" in r.text
        r = requests.get(f"{c.filer_url}/docs", timeout=10,
                         headers={"Accept": "application/json"})
        assert r.json()["entries"]
    finally:
        c.stop()


@pytest.fixture(scope="module")
def clusters(tmp_path_factory):
    out = {}
    try:
        out["reference"] = RefCluster(
            str(tmp_path_factory.mktemp("ref")), n_volume_servers=1,
            volume_size_limit=64 << 20)
        out["port"] = PortCluster(
            str(tmp_path_factory.mktemp("port")), n_volume_servers=1,
            volume_size_limit=64 << 20)
        yield out
    finally:
        for c in out.values():
            c.stop()


def _forms(rng) -> list[tuple[str, bytes]]:
    """(Content-Type, body) of seeded and hand-framed forms."""
    out = []
    for i in range(4):
        name = ["a.bin", "notes.txt", "with space.json", "x"][i]
        mime = ["application/octet-stream", "text/plain",
                "application/json", None][i]
        data = rng.bytes(int(rng.integers(0, 50_000))) if i != 1 \
            else b"hello form " * int(rng.integers(10, 500))
        f = (name, data, mime) if mime else (name, data)
        p = requests.Request("POST", "http://x/", files={"file": f}) \
            .prepare()
        out.append((p.headers["Content-Type"], p.body))
    b = "b0undary"
    crlf = "\r\n"
    raw = [
        # a preamble before the first delimiter, two parts
        (f"preamble{crlf}--{b}{crlf}Content-Disposition: form-data; "
         f"name=\"f\"; filename=\"first.txt\"{crlf}Content-Type: "
         f"text/x-first{crlf}{crlf}FIRST{crlf}--{b}{crlf}"
         f"Content-Disposition: form-data; name=\"g\"{crlf}{crlf}"
         f"SECOND{crlf}--{b}--{crlf}").encode(),
        # no filename, no Content-Type
        (f"--{b}{crlf}Content-Disposition: form-data; name=\"f\""
         f"{crlf}{crlf}just bytes{crlf}--{b}--{crlf}").encode(),
        # a UTF-8 filename
        (f"--{b}{crlf}Content-Disposition: form-data; name=\"f\"; "
         f"filename=\"ünï.txt\"{crlf}Content-Type: text/plain{crlf}"
         f"{crlf}utf8 name{crlf}--{b}--{crlf}").encode(),
    ]
    out += [(f"multipart/form-data; boundary={b}", r) for r in raw]
    out.append((f'multipart/form-data; boundary="{b}"', raw[1]))
    return out


def _needle(c, fid: str):
    vid, key, _ = (ref_parse if isinstance(c, RefCluster)
                   else parse_file_id)(fid)
    n = c.stores[0].read_needle(vid, key)
    return (n.data, n.name, n.mime, n.flags, n.checksum)


def test_form_uploads_equal(clusters):
    rng = np.random.default_rng([SEED, 1])
    vids = {}
    for side, c in clusters.items():
        a = verbs.assign(c.master_url, collection="forms")
        vids[side] = (a.url, int(a.fid.split(",")[0]))
    for i, (ctype, body) in enumerate(_forms(rng)):
        key, cookie = 1000 + i, int(rng.integers(1 << 32))
        got = {}
        for side, c in clusters.items():
            url, vid = vids[side]
            fid = f"{vid},{key:x}{cookie:08x}"
            r = requests.post(f"http://{url}/{fid}", data=body,
                              headers={"Content-Type": ctype}, timeout=30)
            got[side] = (r.status_code, r.json(), _needle(c, fid))
        assert got["port"] == got["reference"], (i, ctype)
        assert got["port"][0] == 201
    for side, (url, vid) in vids.items():
        r = requests.post(f"http://{url}/{vid},ffff00000000",
                          data=b"--b0undary--\r\n", timeout=10,
                          headers={"Content-Type":
                                   "multipart/form-data; boundary=b0undary"})
        assert (r.status_code, r.text) == (400, "empty multipart body")


def test_upload_download_benchmark(clusters, tmp_path, capsys):
    c = clusters["port"]
    rng = np.random.default_rng([SEED, 2])
    big = tmp_path / "big.bin"
    big.write_bytes(rng.bytes((5 << 20) + 777))
    small = tmp_path / "small.txt"
    small.write_bytes(b"small file " * 99)
    assert cli.main(["upload", "-master", c.master_url, "-maxMB", "2",
                     "-collection", "up", str(big), str(small)]) == 0
    lines = [json.loads(x) for x in
             capsys.readouterr().out.strip().splitlines()]
    assert lines[0]["chunked"] and lines[0]["size"] == big.stat().st_size
    assert "chunked" not in lines[1]
    for rec, path in zip(lines, (big, small)):
        out = tmp_path / f"got-{path.name}"
        assert cli.main(["download", "-master", c.master_url,
                         "-o", str(out), rec["fid"]]) == 0
        assert out.read_bytes() == path.read_bytes()
    assert capsys.readouterr().out.count(" bytes)") == 2
    assert cli.main(["benchmark", "-master", c.master_url, "-n", "64",
                     "-size", "1000", "-c", "4", "-client",
                     "python"]) == 0
    report = json.loads(capsys.readouterr().out)
    assert report["client"] == "python" and report["errors"] == 0
    assert report["write_rps"] > 0 and report["read_rps"] > 0


def test_benchmark_gateway_targets(tmp_path, capsys):
    """`benchmark -target filer|s3`: prebuilt PUTs and GETs replayed by
    the native bench client through the filer and the S3 gateway."""
    c = PortCluster(str(tmp_path / "gw"), n_volume_servers=1,
                    volume_size_limit=16 << 20, with_filer=True,
                    with_s3=True)
    try:
        for target in ("filer", "s3"):
            assert cli.main(["benchmark", "-target", target, "-n", "32",
                             "-size", "2000", "-c", "4", "-filer.url",
                             c.filer_url, "-s3.url", c.s3_url]) == 0
            report = json.loads(capsys.readouterr().out)
            assert (report["target"], report["client"],
                    report["errors"]) == (target, "native-raw", 0)
            assert report["write_rps"] > 0 and report["read_rps"] > 0
        got = requests.get(f"{c.s3_url}/benchbucket/bench/0000031",
                           timeout=10)
        assert got.status_code == 200 and len(got.content) == 2000
    finally:
        c.stop()


def test_manifest_delete_leaves_no_chunk(clusters, tmp_path, capsys):
    c = clusters["port"]
    f = tmp_path / "cascade.bin"
    f.write_bytes(np.random.default_rng([SEED, 3]).bytes((3 << 20) + 5))
    assert cli.main(["upload", "-master", c.master_url, "-maxMB", "1",
                     "-collection", "cascade", str(f)]) == 0
    fid = json.loads(capsys.readouterr().out)["fid"]
    url = f"{c.volume_url(0)}/{fid}"
    man = requests.get(url, params={"cm": "false"}, timeout=10).json()
    keys = [parse_file_id(ch["fid"])[:2] for ch in man["chunks"]]
    assert len(keys) == 4
    store = c.stores[0]
    for vid, key in keys:
        assert store.find_volume(vid).nm.get(key) is not None
    assert requests.delete(url, timeout=30).status_code == 202
    for vid, key in keys + [parse_file_id(fid)[:2]]:
        v = store.find_volume(vid)
        assert v.nm.get(key) is None
        v.compact()
        with pytest.raises(KeyError):
            v.read_needle(key, read_deleted=True)


def test_replication_change_reaches_the_native_front(tmp_path):
    c = PortCluster(str(tmp_path / "c"), n_volume_servers=2,
                    volume_size_limit=16 << 20, pulse_seconds=0.3,
                    with_filer=True, filer_native=True)
    try:
        vs = c.volume_servers[0]
        front = f"{vs.store.ip}:{vs.store.port}"
        env = CommandEnv(c.master_url)
        g = env.master_get("/vol/grow", collection="rep", count=1,
                           replication="000", dataNode=front)
        assert g.get("count") == 1, g
        vid = next(v.vid for v in vs.store.locations[0].volumes.values()
                   if v.collection == "rep")
        assert vs.store.find_volume(vid).delegate is vs.dp
        repl.run_command(env, "lock")
        repl.run_command(env, f"volume.configure.replication "
                              f"-volumeId={vid} -replication=001")
        posts = vs.dp.http_stats()["fast_post"]
        r = requests.post(f"http://{front}/{vid},1a0000abcd", data=b"one",
                          timeout=30)
        # relayed to _replicate, which finds no second copy: refused,
        # never a 201 with one copy
        assert r.status_code == 500, r.text
        assert vs.dp.http_stats()["fast_post"] == posts
        repl.run_command(env, "volume.fix.replication")
        t0 = time.monotonic()
        while len(env.volume_locations(vid)) < 2:
            assert time.monotonic() - t0 < 20.0
            time.sleep(0.1)
        vs._mc.invalidate(vid)
        body = b"two copies " * 10
        r = requests.post(f"http://{front}/{vid},1b0000abcd", data=body,
                          timeout=30)
        assert r.status_code == 201, r.text
        held = [s.read_needle(vid, 0x1b).data for s in c.stores
                if s.find_volume(vid) is not None]
        assert held == [body, body]
        repl.run_command(env, "unlock")
    finally:
        c.stop()


def test_cli_lists_the_tools():
    sub = next(a for a in cli.build_parser()._actions
               if a.__class__.__name__ == "_SubParsersAction")
    assert set(cli.TOOL_COMMANDS) <= set(sub.choices)
    for name in scaffold.TEMPLATES:
        assert scaffold.scaffold(name) == ref_scaffold.scaffold(name)


_FUSE_OPTIONS = ["", "filer=http://f:1,filer.path=/d,ro",
                 "ro,allow_other,cacheDir=/c,collection=pics,replication=001",
                 "disableXAttr,filer=f:2,max_read=131072,,filer.path=/"]


@pytest.mark.parametrize("spec", _FUSE_OPTIONS)
def test_fuse_options_split_as_the_references(spec, monkeypatch):
    """`fuse <mnt> -o spec`: the reference's dispatch hands its mount()
    the same filer, root, fuse options and mount keywords as the
    port's."""
    import seaweedfs_tpu.mount.fuse_adapter as ref_adapter
    from seaweedfs_tpu import cli as ref_cli

    from seaweedfs_tpu_torch.mount import fuse_adapter

    got = {}

    def grab(side):
        def mount(filer_url, mountpoint, root="/", options=None, **kw):
            got[side] = (filer_url, mountpoint, root, options, kw)
        return mount

    monkeypatch.setattr(ref_adapter, "mount", grab("reference"))
    monkeypatch.setattr(fuse_adapter, "mount", grab("port"))
    argv = ["fuse", "/mnt/x"] + (["-o", spec] if spec else [])
    assert ref_cli.main(list(argv)) == 0
    assert cli.main(list(argv)) == 0
    assert got["port"] == got["reference"]
    if spec == _FUSE_OPTIONS[1]:
        assert got["port"][:4] == ("http://f:1", "/mnt/x", "/d", "ro")

