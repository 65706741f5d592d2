"""The port's kernel FUSE mount, end to end: the reference's
tests/test_fuse_mount.py run against the port's CLI.

* Its 10 cases (ordinary OS file I/O through the mountpoint: write and
  read back, the filer's HTTP view, mkdir / rename / listing, unlink,
  verified random and large sequential writes under a 1 MiB dirty cap,
  symlink / hardlink / truncate, statvfs, xattrs with the size-probe
  and ERANGE protocol) run over its own `mounted` fixture, whose
  `python -m seaweedfs_tpu master|volume|filer|mount` processes run
  the port's package (tests/torch_port_procs).
* A file written through a reference kernel mount reads equal through
  a port kernel mount of the same filer, and the reverse.

Gated as the reference gates its cases: the cases that mount skip
where /dev/fuse or libfuse.so.2 is missing.
"""
import hashlib
import os
import subprocess
import sys
import time
import types

import numpy as np
import pytest

from seaweedfs_tpu_torch.mount.fuse_ctypes import libfuse_available

from tests import test_fuse_mount as ref_fuse
from tests import torch_port_procs
from tests.torch_port_cases import call_case, port_cases

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 20261017
CASES = port_cases(ref_fuse)

def test_the_references_ten_cases_are_here():
    assert len(CASES) == 10


# the reference's fixture, its processes spawned from the port
_fixture = ref_fuse.mounted.__wrapped__
_port_mounted = types.FunctionType(
    _fixture.__code__, {**vars(ref_fuse), "subprocess": torch_port_procs},
    _fixture.__name__, _fixture.__defaults__, _fixture.__closure__)


@pytest.fixture(scope="module")
def mounted(tmp_path_factory):
    if not (os.path.exists("/dev/fuse") and libfuse_available()):
        pytest.skip("no usable /dev/fuse + libfuse")
    yield from _port_mounted(tmp_path_factory)


@pytest.mark.parametrize("case", list(CASES))
def test_reference_case(case, mounted):
    call_case(CASES[case], {"mounted": mounted})


def _mount_reference(filer: str, mnt: str, log) -> subprocess.Popen:
    """A mount process of the reference's CLI over the same filer."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "seaweedfs_tpu", "mount", "-filer", filer,
         "-dir", mnt], env=dict(os.environ, PYTHONPATH=REPO),
        stdout=log, stderr=subprocess.STDOUT)
    end = time.monotonic() + 30
    while not os.path.ismount(mnt):
        assert proc.poll() is None, "the reference's mount process died"
        assert time.monotonic() < end, "the reference's mount never came up"
        time.sleep(0.1)
    return proc


def test_each_packages_kernel_mount_reads_the_others_file(mounted,
                                                          tmp_path):
    port_mnt, filer = mounted
    ref_mnt = tmp_path / "ref-mnt"
    ref_mnt.mkdir()
    rng = np.random.default_rng([SEED, 22, 1])
    payloads = {"from-reference.bin": rng.bytes((2 << 20) + 4321),
                "from-port.bin": rng.bytes((1 << 20) + 99)}
    with open(tmp_path / "ref-mount.log", "wb") as log:
        proc = _mount_reference(filer, str(ref_mnt), log)
    try:
        writes = {"from-reference.bin": ref_mnt, "from-port.bin": port_mnt}
        reads = {"from-reference.bin": port_mnt, "from-port.bin": ref_mnt}
        for name, data in payloads.items():
            with open(os.path.join(writes[name], name), "wb") as f:
                f.write(data)
        for name, data in payloads.items():
            with open(os.path.join(reads[name], name), "rb") as f:
                got = f.read()
            assert hashlib.sha256(got).hexdigest() == \
                hashlib.sha256(data).hexdigest(), name
            assert os.stat(os.path.join(reads[name], name)).st_size == \
                len(data)
    finally:
        subprocess.run(["fusermount", "-u", str(ref_mnt)],
                       capture_output=True)
        try:
            assert proc.wait(timeout=15) == 0
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=10)
