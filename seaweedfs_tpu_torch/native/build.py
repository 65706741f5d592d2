"""Build the port's native host libraries: g++ -> shared libraries with
a flat C interface (no pybind11), loaded with ctypes — the codec
(native/__init__.py) and the HTTP data plane (native/dataplane.py).

`build()` compiles `native/gf256_codec.cc` with
`g++ -O3 -march=native -shared -fPIC -std=c++17` into the gitignored
`seaweedfs_tpu_torch/_build/` (beside the CUDA kernels), at first use.
The library's name carries a hash of the source, the flags and the
host's CPU model, so an edited source builds anew, and a build made for
another CPU (-march=native) is never loaded. The compiler writes a
temporary name that is renamed into place, so a concurrent process never
loads a half-written library. The counterpart of seaweedfs_tpu/native/
build.py.

`build_dataplane()` compiles `native/dataplane.cc` the same way with
`-pthread`. A file lock (fcntl) is held around each compile, so the
workers of a parallel test run compile a library once, not once each.
Sanitizer builds: ``SEAWEEDFS_TPU_DP_SANITIZE={asan,tsan}`` (or the
`mode` argument) selects an instrumented data plane, cached under its
own name, built with -O1 -g -fno-omit-frame-pointer in place of
-O3 -march=native so reports carry usable stacks. A failed build raises
with g++'s stderr.

    python -m seaweedfs_tpu_torch.native.build     # prints the paths
"""
from __future__ import annotations

import fcntl
import hashlib
import os
import platform
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "gf256_codec.cc")
DP_SRC = os.path.join(HERE, "dataplane.cc")
BUILD_DIR = os.path.join(os.path.dirname(HERE), "_build")
FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")
DP_FLAGS = FLAGS + ("-pthread",)

SANITIZE_ENV = "SEAWEEDFS_TPU_DP_SANITIZE"
SANITIZE_FLAGS = {
    "asan": ("-fsanitize=address",),
    "tsan": ("-fsanitize=thread",),
}
SANITIZE_OPT = ("-O1", "-g", "-fno-omit-frame-pointer", "-shared",
                "-fPIC", "-std=c++17", "-pthread")


def sanitize_mode() -> str:
    """'' (plain), 'asan' or 'tsan' — from the environment."""
    mode = os.environ.get(SANITIZE_ENV, "").strip().lower()
    if mode in ("", "0", "off", "none"):
        return ""
    if mode not in SANITIZE_FLAGS:
        raise ValueError(
            f"{SANITIZE_ENV}={mode!r}: expected one of "
            f"{sorted(SANITIZE_FLAGS)} (or empty)")
    return mode


def dp_flags(mode: str) -> tuple[str, ...]:
    return DP_FLAGS if not mode else SANITIZE_OPT + SANITIZE_FLAGS[mode]


def _cpu_model() -> str:
    try:
        with open("/proc/cpuinfo", encoding="utf-8") as f:
            for line in f:
                if line.startswith(("model name", "flags")):
                    return line
    except OSError:
        pass
    return platform.processor() or platform.machine()


def library_path(src: str = SRC, flags: tuple[str, ...] = FLAGS,
                 tag: str = "") -> str:
    h = hashlib.sha256()
    h.update(" ".join(flags).encode() + b"\0" + _cpu_model().encode())
    with open(src, "rb") as f:
        h.update(f.read())
    name = os.path.splitext(os.path.basename(src))[0]
    tag = f".{tag}" if tag else ""
    return os.path.join(BUILD_DIR, f"lib{name}{tag}-{h.hexdigest()[:16]}.so")


def dp_lib_path(mode: str | None = None) -> str:
    """Where the data plane of sanitizer `mode` (default: the
    environment's) is built."""
    mode = sanitize_mode() if mode is None else mode
    return library_path(DP_SRC, dp_flags(mode), mode)


def _compile(src: str, lib: str, flags: tuple[str, ...],
             verbose: bool) -> str:
    if os.path.exists(lib):
        return lib
    os.makedirs(os.path.dirname(lib), exist_ok=True)
    with open(f"{lib}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # one compile per library
        if os.path.exists(lib):
            return lib  # another process built it while we waited
        tmp = f"{lib}.tmp{os.getpid()}"
        cmd = ["g++", *flags, "-o", tmp, src]
        if verbose:
            print("+", " ".join(cmd), file=sys.stderr)
        try:
            subprocess.run(cmd, check=True, capture_output=not verbose)
        except subprocess.CalledProcessError as e:
            raise RuntimeError(
                f"native build of {os.path.basename(src)} failed (g++ exit "
                f"{e.returncode}):\n"
                f"{(e.stderr or b'').decode(errors='replace')}") from None
        os.replace(tmp, lib)
    return lib


def build(verbose: bool = True) -> str:
    """Compile the codec library if it is not built yet; -> its path."""
    return _compile(SRC, library_path(), FLAGS, verbose)


def build_dataplane(verbose: bool = True, mode: str | None = None) -> str:
    """Compile the data-plane library of sanitizer `mode` (default: the
    SEAWEEDFS_TPU_DP_SANITIZE environment) if it is not built yet;
    -> its path."""
    mode = sanitize_mode() if mode is None else mode
    return _compile(DP_SRC, dp_lib_path(mode), dp_flags(mode), verbose)


if __name__ == "__main__":
    print(build())
    print(build_dataplane())
