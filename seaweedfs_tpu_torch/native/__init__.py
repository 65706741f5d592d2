"""Native (C++) host library: the AVX2 GF(256) kernels, CRC32C and the
.dat record walker of gf256_codec.cc, bound with ctypes — the codec
part of seaweedfs_tpu/native/__init__.py.

The reference system gets these from vendored dependencies:
klauspost/reedsolomon SIMD GF(256) and hardware CRC32C. Here they are
in-tree C++ built by build.py on first use; no pybind11 for a flat C
ABI. `load()` builds on demand and returns the configured ctypes
handle; `available()` is a cheap probe (a built library or a g++ to
build one). ops.codec_native, the encoder's whole-file bypass, the
needle record's CRC32C (storage/needle.py) and the volume's index
rebuild (storage/volume.py) go through here. The HTTP data plane,
the reference's other native library, is native/dataplane.py.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import threading

import numpy as np

_lib = None
_load_lock = threading.Lock()


def available() -> bool:
    from . import build as _b
    return (os.path.exists(_b.library_path())
            or shutil.which("g++") is not None)


def load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    with _load_lock:  # concurrent first loads must not race the build
        if _lib is not None:
            return _lib
        return _load_locked()


def _load_locked() -> ctypes.CDLL:
    global _lib
    from . import build as _b
    path = _b.build(verbose=False)
    lib = ctypes.CDLL(path)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    lib.gf256_coded_matmul.argtypes = [
        u8p, ctypes.c_int, ctypes.c_int, u8p, ctypes.c_int64, u8p]
    lib.gf256_coded_matmul.restype = None
    lib.gf256_mul_xor.argtypes = [ctypes.c_uint8, u8p, u8p,
                                  ctypes.c_int64]
    lib.gf256_mul_xor.restype = None
    lib.crc32c_update.argtypes = [ctypes.c_uint32, u8p, ctypes.c_int64]
    lib.crc32c_update.restype = ctypes.c_uint32
    lib.crc32c_batch.argtypes = [u8p, ctypes.c_int, ctypes.c_int64, u32p]
    lib.crc32c_batch.restype = None
    lib.native_simd_level.argtypes = []
    lib.native_simd_level.restype = ctypes.c_int
    lib.gf256_scheduled_matmul.argtypes = [
        ctypes.POINTER(ctypes.c_int32), u8p, ctypes.c_int,
        ctypes.c_int64, u8p]
    lib.gf256_scheduled_matmul.restype = None
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.dat_scan.argtypes = [
        u8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint64), i64p,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64, i64p]
    lib.dat_scan.restype = ctypes.c_int64
    lib.ec_encode_file.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
        u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int]
    lib.ec_encode_file.restype = ctypes.c_int64
    _lib = lib
    return lib


def _u8p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def coded_matmul(coef: np.ndarray, shards: np.ndarray) -> np.ndarray:
    """out[i] = XOR_j coef[i,j]*shards[j] over GF(256) — C++ kernel."""
    lib = load()
    coef = np.ascontiguousarray(coef, dtype=np.uint8)
    shards = np.ascontiguousarray(shards, dtype=np.uint8)
    m, k = coef.shape
    if shards.ndim != 2 or shards.shape[0] != k:
        raise ValueError(f"shards {shards.shape} do not match coef "
                         f"{coef.shape}")
    n = shards.shape[1]
    out = np.empty((m, n), dtype=np.uint8)
    lib.gf256_coded_matmul(_u8p(coef), m, k, _u8p(shards),
                           ctypes.c_int64(n), _u8p(out))
    return out


def has_scheduled() -> bool:
    """Whether the loaded library carries the scheduled XOR kernel. The
    port's library is always built from its own source, which has it;
    kept for the reference's interface."""
    return hasattr(load(), "gf256_scheduled_matmul")


def scheduled_matmul(prog: np.ndarray, shards: np.ndarray,
                     m: int) -> np.ndarray:
    """Run a flattened ops/schedule program (int32, schedule.flatten
    layout) over (k, n) uint8 shards -> (m, n) uint8. Bit-identical
    with coded_matmul for the program's coefficient matrix."""
    lib = load()
    prog = np.ascontiguousarray(prog, dtype=np.int32)
    shards = np.ascontiguousarray(shards, dtype=np.uint8)
    k, n = shards.shape
    if prog.size < 3 or prog[0] != 8 * k or prog[1] != 8 * m:
        raise ValueError(f"program head {prog[:3].tolist()} does not "
                         f"match k={k}, m={m}")
    out = np.empty((m, n), dtype=np.uint8)
    lib.gf256_scheduled_matmul(
        prog.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        _u8p(shards), k, ctypes.c_int64(n), _u8p(out))
    return out


def crc32c(data: bytes | np.ndarray, initial: int = 0) -> int:
    lib = load()
    buf = np.frombuffer(data, dtype=np.uint8) \
        if isinstance(data, (bytes, bytearray, memoryview)) \
        else np.ascontiguousarray(data, dtype=np.uint8)
    return int(lib.crc32c_update(ctypes.c_uint32(initial), _u8p(buf),
                                 ctypes.c_int64(buf.size)))


def crc32c_batch(rows: np.ndarray) -> np.ndarray:
    """(m, n) rows -> (m,) uint32 CRCs, one C call."""
    lib = load()
    rows = np.ascontiguousarray(rows, dtype=np.uint8)
    m, n = rows.shape
    out = np.empty(m, dtype=np.uint32)
    lib.crc32c_batch(_u8p(rows), m, ctypes.c_int64(n),
                     out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)))
    return out


def simd_level() -> int:
    """0=scalar, 1=SSSE3, 2=SSSE3+SSE4.2, 3=AVX2."""
    return int(load().native_simd_level())


def ec_encode_file(dat_path: str, shard_paths: list[str],
                   coef: np.ndarray, k: int, m: int,
                   large_block: int, small_block: int,
                   chunk: int = 2 << 20, n_threads: int = 4) -> None:
    """Whole-file EC encode with no GIL anywhere: worker threads do
    pread -> GF(256) parity -> pwrite per stripe row (the
    ec_encoder.go:198-235 loop as one native call). Shard bytes are
    identical to every other backend (same ops/rs_matrix coefficients)."""
    lib = load()
    coef = np.ascontiguousarray(coef, dtype=np.uint8)
    if coef.shape != (m, k):
        raise ValueError(f"coef {coef.shape} is not ({m}, {k})")
    arr = (ctypes.c_char_p * len(shard_paths))(
        *[p.encode() for p in shard_paths])
    rc = lib.ec_encode_file(
        dat_path.encode(), arr, len(shard_paths), _u8p(coef), k, m,
        ctypes.c_int64(large_block), ctypes.c_int64(small_block),
        ctypes.c_int64(chunk), n_threads)
    if rc != 0:
        raise IOError(f"native ec_encode_file: {os.strerror(-rc)}")


def dat_scan(dat: np.ndarray, start: int, version: int
             ) -> tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """Walk a .dat image natively -> (ids u64, byte offsets i64,
    signed sizes i32, end_offset). end_offset < len(dat) means the
    tail is torn after the last whole record."""
    lib = load()
    dat = np.ascontiguousarray(dat, dtype=np.uint8)
    # smallest record is an empty v2 tombstone: 16+4 padded -> 24
    cap = max(1, dat.size // 24)
    ids = np.empty(cap, dtype=np.uint64)
    offsets = np.empty(cap, dtype=np.int64)
    sizes = np.empty(cap, dtype=np.int32)
    end = ctypes.c_int64(0)
    n = lib.dat_scan(
        _u8p(dat), ctypes.c_int64(dat.size), ctypes.c_int64(start),
        ctypes.c_int(version),
        ids.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        sizes.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.c_int64(cap), ctypes.byref(end))
    return ids[:n], offsets[:n], sizes[:n], int(end.value)
