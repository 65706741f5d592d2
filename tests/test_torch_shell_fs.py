"""The port's fs.* shell commands and mount.configure against the JAX
package's.

* The cases of tests/test_shell_fs_volume.py::TestFsCommands and
  ::TestReplDispatch and of tests/test_shell_ext.py's TestFsCdPwd,
  TestFsMetaExt and TestMountConfigure run twice, `[reference]` on the
  JAX package's cluster and `[port]` on the port's
  (tests/torch_port_cases.py rebinds the case's names): ls (with
  globs), cat, du, tree, mkdir, mv, rm, meta.save / meta.load,
  meta.cat, meta.changeVolumeId, verify, cd / pwd, mount.configure, and
  the repl's dispatch, and meta.notify into a log queue.
* The same tree saved by both packages' fs.meta.save gives the same
  bytes, and each package's fs.meta.load restores the other's file.
* The same fs.* command lines through both packages' repls give the
  same answers (times masked).
"""
import functools
import json

import numpy as np
import pytest
import requests

from seaweedfs_tpu.server.cluster import Cluster as RefCluster
from seaweedfs_tpu.shell import commands_fs as ref_cmd_fs
from seaweedfs_tpu.shell.env import CommandEnv as RefEnv
from seaweedfs_tpu.shell.repl import run_command as ref_run
from seaweedfs_tpu_torch.server.cluster import Cluster
from seaweedfs_tpu_torch.shell import commands_fs, repl
from seaweedfs_tpu_torch.shell.env import CommandEnv, ShellError

from tests import test_shell_ext as ref_ext
from tests import test_shell_fs_volume as ref_fsv
from tests.torch_port_cases import port_cases, run_case, within

SEED = 20261017
PortCluster = functools.partial(Cluster, ec_backend="native")
PORT_NAMES = dict(Cluster=PortCluster, commands_fs=commands_fs, repl=repl,
                  CommandEnv=CommandEnv, ShellError=ShellError)


def _pick(cases: dict, classes: tuple) -> dict:
    return {k: v for k, v in cases.items()
            if k.split(".")[0] in classes}


FSV = ("TestFsCommands", "TestReplDispatch")
EXT = ("TestFsCdPwd", "TestFsMetaExt", "TestMountConfigure")
SIDES = {
    "reference": {**_pick(port_cases(ref_fsv), FSV),
                  **_pick(port_cases(ref_ext), EXT)},
    "port": {**_pick(port_cases(ref_fsv, **PORT_NAMES), FSV),
             **_pick(port_cases(ref_ext, **PORT_NAMES), EXT)},
}
CASES = list(SIDES["port"])
PKG = {"reference": dict(Cluster=RefCluster, Env=RefEnv, run=ref_run,
                         fs=ref_cmd_fs),
       "port": dict(Cluster=PortCluster, Env=CommandEnv,
                    run=repl.run_command, fs=commands_fs)}


def test_every_reference_case_is_mirrored():
    assert CASES == list(SIDES["reference"])
    assert len(CASES) == 13


@pytest.fixture(scope="module")
def clusters(tmp_path_factory):
    """The reference fixtures' cluster shape, one per package."""
    out = {}
    try:
        for side, pkg in PKG.items():
            out[side] = within(60, pkg["Cluster"], str(
                tmp_path_factory.mktemp(f"shellfs_{side}")),
                n_volume_servers=2, volume_size_limit=4 << 20,
                max_volumes=40, with_filer=True)
        yield out
    finally:
        for c in out.values():
            within(30, c.stop)


@pytest.fixture(scope="module")
def envs(clusters):
    out = {}
    for side, c in clusters.items():
        out[side] = PKG[side]["Env"](c.master_url, filer_url=c.filer_url)
        out[side].acquire_lock()
    yield out
    for e in out.values():
        e.close()


@pytest.mark.parametrize("side", list(SIDES))
@pytest.mark.parametrize("case", CASES)
def test_reference_case(case, side, clusters, envs, tmp_path):
    run_case(SIDES[side][case], {"cluster": clusters[side],
                                 "env": envs[side], "tmp_path": tmp_path})


def _tree(c, root: str) -> dict[str, bytes]:
    rng = np.random.default_rng([SEED, 1])
    files = {f"{root}/a/{i}.bin": rng.bytes(int(rng.integers(1, 9000)))
             for i in range(5)}
    files[f"{root}/b/c/deep.txt"] = b"deep"
    for path, data in files.items():
        requests.post(f"{c.filer_url}{path}", data=data,
                      timeout=30).raise_for_status()
    return files


@pytest.mark.parametrize("saver,loader", [("reference", "port"),
                                          ("port", "reference")])
def test_meta_save_load_across_packages(saver, loader, clusters, envs,
                                        tmp_path):
    """On each cluster: both packages save the same bytes, and the
    loader's package restores the saver's file."""
    for side, c in clusters.items():
        root = f"/xml_{saver}"
        files = _tree(c, root)
        saved = {}
        for pkg in PKG:
            env = envs[side] if pkg == side else \
                PKG[pkg]["Env"](c.master_url, filer_url=c.filer_url)
            out = str(tmp_path / f"{side}-{pkg}.jsonl")
            assert PKG[pkg]["fs"].fs_meta_save(env, root, out) == 9
            saved[pkg] = open(out, "rb").read()
        assert saved["port"] == saved["reference"]
        for path in files:
            requests.delete(f"{c.filer_url}{path}",
                            params={"skipChunkDeletion": "true"},
                            timeout=30).raise_for_status()
        env = envs[side] if loader == side else \
            PKG[loader]["Env"](c.master_url, filer_url=c.filer_url)
        n = PKG[loader]["fs"].fs_meta_load(
            env, str(tmp_path / f"{side}-{saver}.jsonl"))
        assert n == 9
        for path, data in files.items():
            assert requests.get(f"{c.filer_url}{path}",
                                timeout=30).content == data


_LINES = ["fs.mkdir /rp", "fs.cd /rp", "fs.pwd", "fs.ls", "fs.ls -l /rp",
          "fs.cat /rp/one.txt", "fs.cat two.txt", "fs.du /rp",
          "fs.tree /rp", "fs.mv /rp/one.txt /rp/sub/uno.txt",
          "fs.ls /rp/*.txt", "fs.ls /rp/sub", "fs.meta.cat /rp/sub/uno.txt",
          "fs.verify /rp", "mount.configure -dir=/rp -quotaMB=3",
          "mount.configure", "mount.configure -dir=/rp -quotaMB=0",
          "fs.rm -r /rp/sub", "fs.ls /rp", "fs.cd /", "fs.rm -r /rp"]
_MASK = ("mtime", "crtime", "mtime_ns", "fid")


def _mask(obj):
    if isinstance(obj, dict):
        return {k: ("*" if k in _MASK else _mask(v)) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_mask(v) for v in obj]
    return obj


def test_repl_lines_answer_as_the_reference(clusters, envs):
    got = {}
    for side, c in clusters.items():
        requests.post(f"{c.filer_url}/rp/one.txt", data=b"one",
                      timeout=30).raise_for_status()
        requests.post(f"{c.filer_url}/rp/two.txt", data=b"two!",
                      timeout=30).raise_for_status()
        requests.post(f"{c.filer_url}/rp/sub/x.bin", data=b"x" * 70,
                      timeout=30).raise_for_status()
        answers = []
        for line in _LINES:
            answers.append(_mask(json.loads(json.dumps(
                PKG[side]["run"](envs[side], line), default=str))))
        with pytest.raises(Exception) as ei:
            PKG[side]["run"](envs[side], "fs.cat /rp/one.txt")
        answers.append(type(ei.value).__name__)
        got[side] = answers
    assert got["port"] == got["reference"]
