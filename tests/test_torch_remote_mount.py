"""The port's remote mounts against the JAX package's (tolerance 0 on
bytes).

* Every case of the reference's tests/test_remote_storage.py and
  tests/test_shell_ext.py::TestRemoteMountBuckets runs twice,
  `[reference]` on the JAX package's cluster and `[port]` on the port's
  (tests/torch_port_cases.py rebinds the case's names): the local and
  S3 clients, remote.configure / mount / meta.sync / cache / uncache /
  unmount, read-through whole and ranged, filer.remote.sync pushing a
  write and a delete, an empty remote file, remote.mount.buckets.
  `test_rename_of_uncached_placeholder_keeps_bytes` races in the
  reference (the old object is removed by a later event than the one
  that writes the new): both sides run a version that waits for the
  state it asserts.
* The same read-through requests to both packages' filers (whole,
  ranged, several ranges, HEAD, If-None-Match, a read larger than a
  chunk, a mount whose storage went away) get the same statuses, bodies
  and headers; cacheRemote / uncacheRemote pass a read-only filer.conf
  rule that refuses a PUT; a KV write of etc/remote.conf is seen by the
  next read at once.
* Behind each package's native filer front: an uncached entry is
  relayed and read through, a cached single-chunk one is served by the
  C++ front, and after uncacheRemote (which reaches the front through
  the meta event) it is read through again; the fronts' counters move
  alike.
* Each package's RemoteSyncWorker pushes writes made on the other
  package's filer.
"""
import functools
import json
import time

import numpy as np
import pytest
import requests

from seaweedfs_tpu.remote_storage.sync import RemoteSyncWorker as RefSync
from seaweedfs_tpu.server.cluster import Cluster as RefCluster
from seaweedfs_tpu.shell.env import CommandEnv as RefEnv
from seaweedfs_tpu.shell.repl import run_command as ref_run
from seaweedfs_tpu_torch import remote_storage as port_remote
from seaweedfs_tpu_torch.remote_storage.sync import RemoteSyncWorker
from seaweedfs_tpu_torch.server.cluster import Cluster
from seaweedfs_tpu_torch.shell import commands_fs, commands_remote
from seaweedfs_tpu_torch.shell.env import CommandEnv
from seaweedfs_tpu_torch.shell.repl import run_command

from tests import test_remote_storage as ref_cases
from tests import test_shell_ext as ref_ext
from tests.torch_port_cases import port_cases, run_case, within

SEED = 20261017
PortCluster = functools.partial(Cluster, ec_backend="native")
RACY = "TestEdgeCases.test_rename_of_uncached_placeholder_keeps_bytes"
PORT_NAMES = dict(
    LocalRemoteClient=port_remote.LocalRemoteClient,
    S3RemoteClient=port_remote.S3RemoteClient,
    make_client=port_remote.make_client,
    RemoteSyncWorker=RemoteSyncWorker, Cluster=PortCluster,
    CommandEnv=CommandEnv, run_command=run_command)


def _bucket_cases(**subs) -> dict:
    return {k: v for k, v in port_cases(ref_ext, **subs).items()
            if k.startswith("TestRemoteMountBuckets.")}


SIDES = {
    "reference": {**port_cases(ref_cases, skip=(RACY,)), **_bucket_cases()},
    "port": {**port_cases(ref_cases, skip=(RACY,), **PORT_NAMES),
             **_bucket_cases(commands_fs=commands_fs,
                             commands_remote=commands_remote)},
}
CASES = list(SIDES["port"])
PKG = {
    "reference": dict(Cluster=RefCluster, Env=RefEnv, run=ref_run,
                      Sync=RefSync),
    "port": dict(Cluster=PortCluster, Env=CommandEnv, run=run_command,
                 Sync=RemoteSyncWorker),
}


def test_every_reference_case_is_mirrored():
    ref = [k for k in port_cases(ref_cases) if k != RACY] + \
        [k for k in port_cases(ref_ext)
         if k.startswith("TestRemoteMountBuckets.")]
    assert CASES == ref == list(SIDES["reference"])
    assert len(CASES) == 11


def _start(cls, path, **kw):
    return within(60, cls, path, n_volume_servers=1,
                  volume_size_limit=8 << 20, **kw)


@pytest.fixture(scope="module")
def clusters(tmp_path_factory):
    """One cluster of each package, the reference fixture's shape."""
    out = {}
    try:
        for side in PKG:
            out[side] = _start(PKG[side]["Cluster"],
                               str(tmp_path_factory.mktemp(f"rm_{side}")),
                               with_s3=True)
        yield out
    finally:
        for c in out.values():
            within(30, c.stop)


@pytest.fixture(scope="module")
def remote_dirs(tmp_path_factory):
    """The reference fixture's cloud directory, one per side."""
    out = {}
    for side in PKG:
        root = tmp_path_factory.mktemp(f"cloud_{side}")
        (root / "photos").mkdir()
        (root / "photos" / "a.jpg").write_bytes(b"JPEG" * 100)
        (root / "photos" / "b.jpg").write_bytes(b"PNG" * 200)
        (root / "readme.txt").write_bytes(b"top-level")
        out[side] = str(root)
    return out


def _env(side, cluster):
    e = PKG[side]["Env"](cluster.master_url, filer_url=cluster.filer_url)
    e.acquire_lock()
    return e


@pytest.mark.parametrize("side", list(SIDES))
@pytest.mark.parametrize("case", CASES)
def test_reference_case(case, side, clusters, remote_dirs, tmp_path):
    c = clusters[side]
    env = _env(side, c)
    try:
        run_case(SIDES[side][case], {
            "cluster": c, "env": env, "remote_dir": remote_dirs[side],
            "tmp_path": tmp_path})
    finally:
        env.close()


def _wait(pred, timeout=15.0, what="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.05)
    raise AssertionError(f"{what} never became true")


@pytest.mark.parametrize("side", list(PKG))
def test_rename_of_uncached_placeholder_keeps_bytes(side, clusters,
                                                     tmp_path):
    """The reference case, waiting for the old object to go as well:
    the rename's create event copies the bytes to the new key, its later
    delete event removes the old one."""
    c, pkg = clusters[side], PKG[side]
    env = _env(side, c)
    root = tmp_path / "ren-cloud"
    root.mkdir()
    (root / "orig.txt").write_bytes(b"remote-only bytes")
    pkg["run"](env, f"remote.configure -name=rn -type=local -root={root}")
    pkg["run"](env, "remote.mount -dir=/renmnt -remote=rn")
    w = pkg["Sync"](c.filer_url, "/renmnt")
    w.start()
    try:
        requests.put(f"{c.filer_url}/renmnt/moved.txt",
                     params={"mv.from": "/renmnt/orig.txt"},
                     timeout=30).raise_for_status()
        target = root / "moved.txt"
        _wait(target.exists, what="the renamed object")
        assert target.read_bytes() == b"remote-only bytes"
        _wait(lambda: not (root / "orig.txt").exists(),
              what="the old object's removal")
        assert requests.get(f"{c.filer_url}/renmnt/moved.txt",
                            timeout=30).content == b"remote-only bytes"
    finally:
        within(5, w.stop)
        pkg["run"](env, "remote.unmount -dir=/renmnt")
        env.close()


# ----------------------------------------------------------------------
# the same read-through requests to both filers
# ----------------------------------------------------------------------
_HEADERS = ("ETag", "Content-Range", "Accept-Ranges", "Content-Length",
            "X-Seaweed-Entry", "Content-Type")


def _answer(r):
    hdrs = {h: r.headers.get(h) for h in _HEADERS}
    body = r.content
    ctype = r.headers.get("Content-Type", "")
    if ctype.startswith("multipart/byteranges"):
        boundary = ctype.split("boundary=")[1]
        body = body.replace(boundary.encode(), b"B")
        hdrs["Content-Type"] = "multipart/byteranges"
        hdrs["Content-Length"] = "masked"   # the boundary is random
    elif "json" in ctype:
        body = json.loads(body)
        hdrs["Content-Length"] = "masked"   # its times, masked below
    return r.status_code, body, hdrs


def _mounted(side, clusters, tmp_path, name, files: dict) -> tuple:
    c = clusters[side]
    root = tmp_path / f"{name}-{side}"
    for rel, data in files.items():
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_bytes(data)
    env = _env(side, c)
    PKG[side]["run"](env, f"remote.configure -name={name} -type=local "
                          f"-root={root}")
    PKG[side]["run"](env, f"remote.mount -dir=/{name} -remote={name}")
    return c, env, root


def test_read_through_answers_as_the_reference(clusters, tmp_path):
    rng = np.random.default_rng([SEED, 1])
    big = rng.bytes((9 << 20) + 4321)       # over one 8 MiB chunk
    files = {"big.bin": big, "d/small.txt": rng.bytes(3000),
             "empty.bin": b""}
    envs = {}
    try:
        for side in PKG:
            envs[side] = _mounted(side, clusters, tmp_path, "rt", files)
        reqs = [
            ("GET", "/rt/big.bin", {}), ("HEAD", "/rt/big.bin", {}),
            ("GET", "/rt/big.bin", {"Range": "bytes=100-8388800"}),
            ("GET", "/rt/big.bin", {"Range": "bytes=-5000"}),
            ("GET", "/rt/big.bin", {"Range": "bytes=9437180-"}),
            ("GET", "/rt/big.bin", {"Range": "bytes=0-9,500-599,"
                                             "9000000-9000099"}),
            ("GET", "/rt/big.bin", {"Range": "bytes=99999999-"}),
            ("GET", "/rt/d/small.txt", {}),
            ("GET", "/rt/d/small.txt", {"Range": "bytes=2990-4000"}),
            ("HEAD", "/rt/d/small.txt", {"Range": "bytes=1-2,4-5"}),
            ("GET", "/rt/empty.bin", {}),
            ("GET", "/rt/d/small.txt?meta=1", {}),
        ]
        for method, path, hdrs in reqs:
            got = {side: _answer(requests.request(
                method, f"{clusters[side].filer_url}{path}", headers=hdrs,
                timeout=60)) for side in PKG}
            if path.endswith("?meta=1"):
                for side in PKG:    # the placeholder's and file's times
                    d = got[side][1]
                    d.pop("mtime", None), d.pop("crtime", None)
                    remote = json.loads(d["extended"]["remote"])
                    remote.pop("mtime")
                    d["extended"]["remote"] = remote
            assert got["port"] == got["reference"], (method, path, hdrs)
        assert got["port"][0] == 200
        # If-None-Match on the remote ETag
        etags = {side: requests.head(
            f"{clusters[side].filer_url}/rt/big.bin",
            timeout=30).headers["ETag"] for side in PKG}
        for side in PKG:
            r = requests.get(f"{clusters[side].filer_url}/rt/big.bin",
                             headers={"If-None-Match": etags[side]},
                             timeout=30)
            assert r.status_code == 304
        # the cloud object goes away under its placeholder: the same
        # error answer, before any byte of a body
        for side, (c, env, root) in envs.items():
            (root / "d" / "small.txt").unlink()
        got = {}
        for side in PKG:
            status, body, hdrs = _answer(requests.get(
                f"{clusters[side].filer_url}/rt/d/small.txt", timeout=30))
            # the error names each side's own cloud directory
            got[side] = (status, json.dumps(body).replace(f"rt-{side}", "rt"),
                         hdrs)
        assert got["port"] == got["reference"]
        assert got["port"][0] == 404
        # the storage goes away under the mount: 502 on both
        for side, (c, env, _) in envs.items():
            PKG[side]["run"](env, "remote.unmount -dir=/rt")
        got = {side: _answer(requests.get(
            f"{clusters[side].filer_url}/rt/big.bin", timeout=30))
            for side in PKG}
        assert got["port"] == got["reference"]
        assert got["port"][0] == 502
    finally:
        for side, (c, env, _) in envs.items():
            env.close()


def test_cache_verbs_pass_a_read_only_rule(clusters, tmp_path):
    envs = {}
    try:
        for side in PKG:
            envs[side] = _mounted(side, clusters, tmp_path, "ro",
                                  {"x.bin": b"read only bytes" * 99})
        answers = {}
        for side, (c, env, _) in envs.items():
            url = f"{c.filer_url}/ro/x.bin"
            PKG[side]["run"](env, "fs.configure -locationPrefix=/ro/ "
                                  "-readOnly=true -apply")
            seq = [requests.put(url, data=b"new", timeout=30).status_code,
                   requests.post(url, params={"cacheRemote": "1"},
                                 timeout=30).status_code]
            seq.append(bool(requests.get(url, params={"meta": "1"},
                                         timeout=30).json().get("chunks")))
            seq.append(requests.get(url, timeout=30).content)
            seq.append(requests.post(url, params={"uncacheRemote": "1"},
                                     timeout=30).status_code)
            seq.append(bool(requests.get(url, params={"meta": "1"},
                                         timeout=30).json().get("chunks")))
            seq.append(requests.post(f"{c.filer_url}/ro/nope.bin",
                                     params={"cacheRemote": "1"},
                                     timeout=30).status_code)
            PKG[side]["run"](env, "fs.configure -locationPrefix=/ro/ "
                                  "-delete -apply")
            answers[side] = seq
        assert answers["port"] == answers["reference"]
        assert answers["port"] == [403, 200, True,
                                   b"read only bytes" * 99, 200, False, 404]
    finally:
        for side, (c, env, _) in envs.items():
            PKG[side]["run"](env, "remote.unmount -dir=/ro")
            env.close()


def test_conf_write_is_seen_at_once(clusters, tmp_path):
    for side in PKG:
        c, env, root = _mounted(side, clusters, tmp_path, "cw",
                                {"f.txt": b"first root"})
        try:
            url = f"{c.filer_url}/cw/f.txt"
            assert requests.get(url, timeout=30).content == b"first root"
            other = tmp_path / f"cw2-{side}"
            other.mkdir()
            (other / "f.txt").write_bytes(b"other root")
            # the storage's root changes under the mount: no TTL wait
            PKG[side]["run"](env, f"remote.configure -name=cw -type=local "
                                  f"-root={other}")
            assert requests.get(url, timeout=30).content == b"other root"
        finally:
            PKG[side]["run"](env, "remote.unmount -dir=/cw")
            env.close()


# ----------------------------------------------------------------------
# behind the native filer front
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def native_pair(tmp_path_factory):
    """A reference and a port cluster, each behind its native filer
    front (one front of a role per library, so one cluster of each)."""
    out = {}
    try:
        for side in PKG:
            out[side] = _start(PKG[side]["Cluster"], str(
                tmp_path_factory.mktemp(f"rmnative_{side}")),
                with_filer=True, filer_native=True)
        yield out
    finally:
        for c in out.values():
            within(30, c.stop)


def test_native_front_reads_through_and_serves_the_cached(native_pair,
                                                          tmp_path):
    rng = np.random.default_rng([SEED, 2])
    data = rng.bytes(200_000)
    moved, steps = {}, {}
    for side, c in native_pair.items():
        root = tmp_path / f"nat-{side}"
        root.mkdir()
        (root / "obj.bin").write_bytes(data)
        env = _env(side, c)
        run = PKG[side]["run"]
        stats = c.filer_front.stats
        try:
            run(env, f"remote.configure -name=nat -type=local -root={root}")
            run(env, "remote.mount -dir=/nat -remote=nat")
            url = f"{c.filer_url}/nat/obj.bin"
            seq = []
            for step in ("uncached", "cache", "cached", "uncache",
                         "read-through"):
                before = stats()["fast_get"]
                if step == "cache":
                    seq.append(run(env, "remote.cache -dir=/nat"))
                elif step == "uncache":
                    seq.append(run(env, "remote.uncache -dir=/nat"))
                else:
                    r = requests.get(url, timeout=30)
                    seq.append((r.status_code, r.content == data,
                                r.headers.get("ETag"),
                                stats()["fast_get"] - before))
            steps[side] = seq
            moved[side] = stats()
        finally:
            run(env, "remote.unmount -dir=/nat")
            env.close()
    assert steps["port"] == steps["reference"]
    # relayed, then served by the C++ front, then relayed again
    assert [s[3] for s in steps["port"] if isinstance(s, tuple)] == \
        [0, 1, 0]
    assert all(s[:2] == (200, True) for s in steps["port"]
               if isinstance(s, tuple))


# ----------------------------------------------------------------------
# each package's sync worker on the other package's filer
# ----------------------------------------------------------------------
@pytest.mark.parametrize("worker,filer", [("reference", "port"),
                                          ("port", "reference")])
def test_sync_worker_across_packages(worker, filer, clusters, tmp_path):
    c = clusters[filer]
    env = _env(filer, c)
    root = tmp_path / "xcloud"
    root.mkdir()
    (root / "kept.txt").write_bytes(b"from the cloud")
    run = PKG[filer]["run"]
    run(env, f"remote.configure -name=xs -type=local -root={root}")
    run(env, "remote.mount -dir=/xsync -remote=xs")
    w = PKG[worker]["Sync"](c.filer_url, "/xsync")
    w.start()
    rng = np.random.default_rng([SEED, 3])
    try:
        bodies = {f"d{i}/f{i}.bin": rng.bytes(int(rng.integers(1, 300_000)))
                  for i in range(6)}
        for rel, data in bodies.items():
            requests.put(f"{c.filer_url}/xsync/{rel}", data=data,
                         timeout=30).raise_for_status()
        for rel, data in bodies.items():
            _wait(lambda p=root / rel: p.exists() and
                  p.read_bytes() == data, what=f"{rel} in the cloud")
        requests.delete(f"{c.filer_url}/xsync/d0/f0.bin",
                        timeout=30).raise_for_status()
        _wait(lambda: not (root / "d0/f0.bin").exists(),
              what="the delete mirrored")
        requests.put(f"{c.filer_url}/xsync/moved.bin",
                     params={"mv.from": "/xsync/d1/f1.bin"},
                     timeout=30).raise_for_status()
        _wait(lambda: (root / "moved.bin").exists() and
              not (root / "d1/f1.bin").exists(), what="the rename mirrored")
        assert (root / "moved.bin").read_bytes() == bodies["d1/f1.bin"]
        # the worker's own metadata refresh pushed nothing back
        _wait(lambda: w.pushed == 7, what="7 pushes")
        time.sleep(0.5)
        assert (w.pushed, w.deleted, w.failed) == (7, 2, 0)
        assert (root / "kept.txt").read_bytes() == b"from the cloud"
    finally:
        within(5, w.stop)
        run(env, "remote.unmount -dir=/xsync")
        env.close()
