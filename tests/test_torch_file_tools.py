"""The port's offline volume tools and filer CLI verbs against the JAX
package's, with tolerance 0.

* Every case of the reference's tests/test_file_tools.py runs twice,
  `[reference]` and `[port]` (tests/torch_port_cases.py rebinds
  `tools`, `Volume`, the needle codec and `Cluster`; the CLI cases
  spawn `python -m seaweedfs_tpu_torch` through tests/torch_port_procs):
  fix, compact, export and its overwrite rule, filer.copy and
  filer.cat, the refusal of a missing volume, see.dat and see.idx.
* One seeded volume — uneven needles with names, mimes, stamps,
  overwrites and deletes, some gzipped — is copied for each package:
  `fix` writes byte-equal .idx files, `compact` byte-equal .dat and
  .idx, `export` the same tar members with the same bytes (also with
  -newerThanNs), and `see.dat` / `see.idx` the same JSON lines, through
  each package's functions and through each package's CLI.
"""
import functools
import gzip
import json
import os
import shutil
import subprocess
import sys
import tarfile

import numpy as np
import pytest

import seaweedfs_tpu_torch.operation.tools as port_tools
import seaweedfs_tpu_torch.storage.needle as port_needle
import seaweedfs_tpu_torch.storage.volume as port_volume
from seaweedfs_tpu.operation import tools as ref_tools
from seaweedfs_tpu.server.cluster import Cluster as RefCluster
from seaweedfs_tpu.storage import needle as ref_ndl
from seaweedfs_tpu.storage.volume import Volume as RefVolume
from seaweedfs_tpu_torch.server.cluster import Cluster

from tests import test_file_tools as ref_cases
from tests import torch_port_procs
from tests.torch_port_cases import port_cases, run_case, swap_modules

SEED = 20261017
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PortCluster = functools.partial(Cluster, ec_backend="native")
SIDES = {
    "reference": (port_cases(ref_cases), RefCluster, {}),
    "port": (port_cases(ref_cases, Cluster=PortCluster, tools=port_tools,
                        ndl=port_needle, Volume=port_volume.Volume,
                        subprocess=torch_port_procs),
             PortCluster,
             {"seaweedfs_tpu.operation.tools": port_tools,
              "seaweedfs_tpu.storage.needle": port_needle,
              "seaweedfs_tpu.storage.volume": port_volume,
              "subprocess": torch_port_procs}),
}
CASES = list(SIDES["port"][0])
TOOLS = {"reference": ref_tools, "port": port_tools}
PKG = {"reference": "seaweedfs_tpu", "port": "seaweedfs_tpu_torch"}


def test_every_reference_case_is_mirrored():
    assert CASES == list(port_cases(ref_cases))
    assert len(CASES) == 10


@pytest.fixture(scope="module")
def clusters(tmp_path_factory):
    out = {}
    try:
        for side, (_, cls, _) in SIDES.items():
            out[side] = cls(str(tmp_path_factory.mktemp(side)),
                            n_volume_servers=1, volume_size_limit=16 << 20,
                            with_filer=True)
        yield out
    finally:
        for c in out.values():
            c.stop()


@pytest.mark.parametrize("side", list(SIDES))
@pytest.mark.parametrize("case", CASES)
def test_reference_case(case, side, clusters, tmp_path):
    cases, _, swaps = SIDES[side]
    with swap_modules(swaps, parents=True):
        run_case(cases[case], {"cluster": clusters[side],
                               "tmp_path": tmp_path})


VID = 7
STAMP = 1_700_000_000_000_000_000


@pytest.fixture(scope="module")
def seeded(tmp_path_factory):
    """One seeded volume (.dat/.idx) in its own directory; -> (dir,
    newer-than stamp splitting its records)."""
    d = str(tmp_path_factory.mktemp("seeded"))
    rng = np.random.default_rng([SEED, 1])
    v = RefVolume(d, "", VID, create=True)
    keys = []
    for i in range(60):
        key = int(rng.integers(1, 40)) if keys and rng.random() < 0.15 \
            else i + 100
        n = ref_ndl.Needle(id=key, cookie=int(rng.integers(1 << 32)),
                           data=rng.bytes(int(rng.integers(0, 9000))),
                           append_at_ns=STAMP + 1000 * i)
        if rng.random() < 0.5:
            n.name = f"f{i}.{['bin', 'txt', 'dat'][i % 3]}".encode()
            n.flags |= ref_ndl.FLAG_HAS_NAME
        if rng.random() < 0.3:
            n.mime = b"text/plain"
            n.flags |= ref_ndl.FLAG_HAS_MIME
        if rng.random() < 0.4:
            n.last_modified = 1_700_000_000 + i
            n.flags |= ref_ndl.FLAG_HAS_LAST_MODIFIED
        if rng.random() < 0.2:
            n.data = gzip.compress(n.data, mtime=0)
            n.flags |= ref_ndl.FLAG_IS_COMPRESSED
        v.append_needle(n)
        keys.append(key)
        if rng.random() < 0.1:
            v.delete_needle(keys[int(rng.integers(len(keys)))])
    v.close()
    return d, STAMP + 1000 * 30


def _copy(src: str, dst: str) -> str:
    shutil.copytree(src, dst)
    return dst


def _bytes(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _members(path: str) -> list:
    with tarfile.open(path) as tar:
        return [(m.name, m.size, tar.extractfile(m).read())
                for m in tar.getmembers()]


def test_fix_and_compact_byte_equal(seeded, tmp_path):
    src, _ = seeded
    out = {}
    for side, tools in TOOLS.items():
        d = _copy(src, str(tmp_path / side))
        os.remove(os.path.join(d, f"{VID}.idx"))
        open(os.path.join(d, f"{VID}.idx"), "wb").close()
        fix = tools.fix_volume(d, VID)
        fixed_idx = _bytes(os.path.join(d, f"{VID}.idx"))
        comp = tools.compact_volume(d, VID)
        out[side] = (fix["records"], fixed_idx, comp["before_bytes"],
                     comp["after_bytes"], comp["records"],
                     _bytes(os.path.join(d, f"{VID}.dat")),
                     _bytes(os.path.join(d, f"{VID}.idx")))
    assert out["port"] == out["reference"]
    assert out["port"][3] < out["port"][2]


@pytest.mark.parametrize("newer", [False, True])
def test_export_and_see_byte_equal(seeded, tmp_path, newer):
    src, stamp = seeded
    out = {}
    for side, tools in TOOLS.items():
        d = _copy(src, str(tmp_path / side))
        tar = str(tmp_path / f"{side}.tar")
        res = tools.export_volume(d, VID, tar,
                                  newer_than_ns=stamp if newer else 0)
        out[side] = (res["files"], res["bytes"], _members(tar),
                     list(tools.see_dat(d, VID)),
                     list(tools.see_idx(d, VID)))
    assert out["port"] == out["reference"]
    assert 0 < out["port"][0] < 60


def _cli(side: str, *argv) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-m", PKG[side], *argv],
                          env=dict(os.environ, PYTHONPATH=REPO),
                          capture_output=True, text=True, timeout=120)


def test_cli_outputs_equal(seeded, tmp_path):
    src, stamp = seeded
    out = {}
    for side in TOOLS:
        d = _copy(src, str(tmp_path / side))
        tar = str(tmp_path / f"{side}.tar")
        runs = [_cli(side, "see.dat", "-dir", d, "-volumeId", str(VID)),
                _cli(side, "see.idx", "-dir", d, "-volumeId", str(VID)),
                _cli(side, "export", "-dir", d, "-volumeId", str(VID),
                     "-o", tar, "-newerThanNs", str(stamp)),
                _cli(side, "fix", "-dir", d, "-volumeId", str(VID)),
                _cli(side, "compact", "-dir", d, "-volumeId", str(VID))]
        for r in runs:
            assert r.returncode == 0, r.stderr
        export = json.loads(runs[2].stdout)
        assert export.pop("tar") == os.path.abspath(tar)
        out[side] = ([r.stdout for r in runs[:2]], export,
                     [r.stdout.replace(d, "D") for r in runs[3:]],
                     _members(tar),
                     _bytes(os.path.join(d, f"{VID}.dat")),
                     _bytes(os.path.join(d, f"{VID}.idx")))
    assert out["port"] == out["reference"]
