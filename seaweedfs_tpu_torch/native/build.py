"""Build the port's native host codec: g++ -> a shared library with a
flat C interface (no pybind11), loaded with ctypes by native/__init__.py.

`build()` compiles `native/gf256_codec.cc` with
`g++ -O3 -march=native -shared -fPIC -std=c++17` into the gitignored
`seaweedfs_tpu_torch/_build/` (beside the CUDA kernels), at first use.
The library's name carries a hash of the source, the flags and the
host's CPU model, so an edited source builds anew, and a build made for
another CPU (-march=native) is never loaded. The compiler writes a
temporary name that is renamed into place, so a concurrent process never
loads a half-written library. The counterpart of seaweedfs_tpu/native/
build.py for the codec library; the data plane comes with its slice.

    python -m seaweedfs_tpu_torch.native.build     # prints the path
"""
from __future__ import annotations

import hashlib
import os
import platform
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "gf256_codec.cc")
BUILD_DIR = os.path.join(os.path.dirname(HERE), "_build")
FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")


def _cpu_model() -> str:
    try:
        with open("/proc/cpuinfo", encoding="utf-8") as f:
            for line in f:
                if line.startswith(("model name", "flags")):
                    return line
    except OSError:
        pass
    return platform.processor() or platform.machine()


def library_path(src: str = SRC) -> str:
    h = hashlib.sha256()
    h.update(" ".join(FLAGS).encode() + b"\0" + _cpu_model().encode())
    with open(src, "rb") as f:
        h.update(f.read())
    name = os.path.splitext(os.path.basename(src))[0]
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def _compile(src: str, lib: str, verbose: bool) -> str:
    if os.path.exists(lib):
        return lib
    os.makedirs(os.path.dirname(lib), exist_ok=True)
    tmp = f"{lib}.tmp{os.getpid()}"
    cmd = ["g++", *FLAGS, "-o", tmp, src]
    if verbose:
        print("+", " ".join(cmd), file=sys.stderr)
    try:
        subprocess.run(cmd, check=True, capture_output=not verbose)
    except subprocess.CalledProcessError as e:
        raise RuntimeError(
            f"native codec build failed (g++ exit {e.returncode}):\n"
            f"{(e.stderr or b'').decode(errors='replace')}") from None
    os.replace(tmp, lib)
    return lib


def build(verbose: bool = True) -> str:
    """Compile the codec library if it is not built yet; -> its path."""
    return _compile(SRC, library_path(), verbose)


if __name__ == "__main__":
    print(build())
