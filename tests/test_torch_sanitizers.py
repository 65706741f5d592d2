"""The port's native data plane under ASan and TSan — the counterpart of
tests/test_sanitizers.py.

The instrumented library must be dlopened by a Python process whose
loader already mapped the sanitizer runtime (LD_PRELOAD at exec), so
each mode runs a fresh pytest subprocess with the environment of the
port's `dataplane.sanitizer_env`: the port's S3 and filer front parity
files and the S3 front's mixed-path mutation race, on the port's side
only (`-k port`). `halt_on_error=1` turns any finding into a nonzero
exit, and `log_path` lets this test assert that no report file was
written. The instrumented builds are cached under their own names in
`_build/` (native/build.py).
"""
import glob
import os
import shutil
import subprocess
import sys

import pytest

from seaweedfs_tpu_torch.native import build as nbuild
from seaweedfs_tpu_torch.native import dataplane

pytestmark = pytest.mark.sanitize

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the port's native hot-path surface: S3 / filer front parity and the
# mixed-path mutation race (appliers vs meta events vs native readers)
SUITES = [
    "tests/test_torch_s3_native_front.py",
    "tests/test_torch_filer_native_front.py",
    "tests/test_torch_native_front_races.py::test_reference_case["
    "test_s3_front_concurrent_mixed_path_mutations-port]",
]


def _runtime_present(mode: str) -> bool:
    rt = {"asan": "libasan.so", "tsan": "libtsan.so"}[mode]
    try:
        out = subprocess.run(["gcc", f"-print-file-name={rt}"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return False
    path = out.stdout.strip()
    return out.returncode == 0 and os.path.isabs(path) and \
        os.path.exists(path)


def _run_sanitized(mode: str, tmp_path) -> None:
    if shutil.which("g++") is None or not _runtime_present(mode):
        pytest.skip(f"no toolchain/runtime for {mode}")
    # build here so a compile failure reads as such, not as a timeout
    lib = nbuild.build_dataplane(verbose=False, mode=mode)
    assert os.path.dirname(lib) == nbuild.BUILD_DIR
    assert os.path.basename(lib).startswith(f"libdataplane.{mode}-")
    env = dict(os.environ)
    env.update(dataplane.sanitizer_env(mode, str(tmp_path)))
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
         "-p", "no:randomly", "-k", "port", *SUITES],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=540)
    reports = sorted(glob.glob(os.path.join(str(tmp_path),
                                            f"{mode}-report.*")))
    blobs = "".join(open(p, errors="replace").read() for p in reports)
    assert out.returncode == 0 and not reports, (
        f"{mode} run rc={out.returncode}\n--- stdout ---\n"
        f"{out.stdout[-4000:]}\n--- stderr ---\n{out.stderr[-2000:]}"
        f"\n--- reports ---\n{blobs[-4000:]}")
    assert " passed" in out.stdout, out.stdout[-2000:]


def test_native_suites_clean_under_asan(tmp_path):
    _run_sanitized("asan", tmp_path)


def test_native_suites_clean_under_tsan(tmp_path):
    _run_sanitized("tsan", tmp_path)


def test_sanitize_mode_selects_distinct_cached_lib(monkeypatch):
    monkeypatch.setenv(nbuild.SANITIZE_ENV, "asan")
    asan = nbuild.dp_lib_path()
    monkeypatch.setenv(nbuild.SANITIZE_ENV, "tsan")
    tsan = nbuild.dp_lib_path()
    monkeypatch.delenv(nbuild.SANITIZE_ENV)
    plain = nbuild.dp_lib_path()
    assert len({asan, tsan, plain}) == 3
    assert os.path.basename(asan).startswith("libdataplane.asan-")
    assert os.path.basename(tsan).startswith("libdataplane.tsan-")
    assert plain == nbuild.dp_lib_path("")
    monkeypatch.setenv(nbuild.SANITIZE_ENV, "bogus")
    with pytest.raises(ValueError):
        nbuild.sanitize_mode()


def test_loaded_mode_cannot_be_swapped_in_process(monkeypatch):
    dataplane._load()  # plain mode
    monkeypatch.setenv(nbuild.SANITIZE_ENV, "asan")
    with pytest.raises(RuntimeError, match="already loaded"):
        dataplane._load()
