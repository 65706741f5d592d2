"""Build the port's CUDA kernels from `seaweedfs_tpu_torch/csrc/` at
first use and load them with ctypes.

Each `csrc/<name>.cu` compiles on its own, with nvcc for sm_90a, into a
shared library with a plain C interface:
`seaweedfs_tpu_torch/_build/lib<name>-<hash>.so`. The hash covers the
source, every `.cuh` header in `csrc/` and the compiler flags, so an
edited source builds anew and an unchanged one is loaded as it is.
`build_all()` starts one nvcc per source, all at once, and waits for
them. Nothing here runs at import time; a missing nvcc raises.

A build that runs nvcc shows: a `cuda.kernel_build` span around it,
and per source that built, one `cuda_kernel_build_seconds{kernel}`
observation (from the start of the builds to the wait that saw that
source's nvcc end; its `_count` counts the builds). A failed build
records none, and loading a library already built records nothing.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

from ..utils import metrics, tracing

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}
# ptxas report (registers, shared memory, spills) of each library built
# by this process, keyed by kernel source name
build_logs: dict[str, str] = {}


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin); the CUDA kernels of "
        "seaweedfs_tpu_torch are built from csrc/ at first use")


def sources() -> list[str]:
    """Kernel source names: one per `csrc/*.cu`."""
    return sorted(os.path.splitext(os.path.basename(p))[0]
                  for p in glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def library_path(name: str) -> str:
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    deps = [os.path.join(CSRC_DIR, name + ".cu")]
    deps += sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh")))
    for path in deps:
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def _start(name: str, out: str) -> subprocess.Popen:
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
           os.path.join(CSRC_DIR, name + ".cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def build_all(names: list[str] | None = None) -> dict[str, str]:
    """Compile every source not built yet, one nvcc each, all started
    together. -> {name: library path}. Raises on a failed build."""
    names = sources() if names is None else names
    os.makedirs(BUILD_DIR, exist_ok=True)
    paths = {n: library_path(n) for n in names}
    todo = [n for n, p in paths.items() if not os.path.exists(p)]
    if not todo:
        return paths
    with tracing.span("cuda.kernel_build", peer=" ".join(todo)):
        _compile(todo, paths)
    return paths


def _compile(names: list[str], paths: dict[str, str]) -> None:
    t0 = time.perf_counter()
    procs = {n: _start(n, paths[n]) for n in names}
    failed = []
    for n, proc in procs.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        tmp = f"{paths[n]}.{os.getpid()}.tmp"
        build_logs[n] = log
        if proc.returncode != 0:
            failed.append(f"{n}.cu (nvcc exit {proc.returncode}):\n{log}")
            if os.path.exists(tmp):
                os.remove(tmp)
        else:
            os.replace(tmp, paths[n])   # atomic: concurrent builds agree
            metrics.histogram_observe("cuda_kernel_build_seconds", seconds,
                                      {"kernel": n})
    if failed:
        raise RuntimeError("CUDA kernel build failed: " + "\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, building it first when
    needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            path = build_all([name])[name]
            lib = ctypes.CDLL(path)
            _loaded[name] = lib
        return lib
