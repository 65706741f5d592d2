"""ctypes binding for the native HTTP data plane (native/dataplane.cc);
the counterpart of seaweedfs_tpu/native/dataplane.py.

The C++ front owns the volume server's public port: GET/HEAD and plain
POST by fid are served natively (reference hot path
volume_server_handlers_read.go:31 / volume_write.go:144); everything
else is relayed to the Python backend on a loopback port. While a
volume is attached, the native library is the single authority for its
needle map and append offsets — Python's Volume delegates mutations
here and reads counters through NativeNeedleMap. The same library holds
the native S3 front (`S3Front`) and filer front (`FilerFront`), which
append to the volumes this process's volume front has attached, and a
C++ load generator (`bench`, `bench_raw`).

The library is built from this package's own dataplane.cc into
`_build/` at first use (native/build.py) and loaded with RTLD_LOCAL, so
it keeps its own globals beside any other copy loaded in the process.
Its C state is a process singleton: one front of each role per process.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

from ..storage import idx as idxmod
from ..storage import types as t

_lib = None
_lib_mode: str | None = None  # sanitize mode the cached _lib was built in
_load_lock = threading.Lock()

# role ids, mirroring ROLE_* in dataplane.cc
ROLE_VOLUME = 0
ROLE_S3 = 1
ROLE_FILER = 2


def available() -> bool:
    from . import build as _b
    import shutil

    return os.path.exists(_b.dp_lib_path()) or \
        shutil.which("g++") is not None


def sanitizer_env(mode: str, log_dir: str) -> dict[str, str]:
    """Environment for a *new* python process that will dlopen the
    sanitized data plane. The interpreter itself is uninstrumented, so
    the sanitizer runtime must be LD_PRELOADed before python starts —
    setting these in an already-running process does nothing, which is
    why the sanitize suite spawns subprocesses.

    halt_on_error=1 turns any report into a nonzero exit (the test
    gate); detect_leaks=0 because CPython itself "leaks" arenas at
    exit and would drown real reports; log_path redirects reports to
    files the caller can assert empty.
    """
    from . import build as _b

    if mode not in _b.SANITIZE_FLAGS:
        raise ValueError(f"unknown sanitize mode {mode!r}")
    rt = {"asan": "libasan.so", "tsan": "libtsan.so"}[mode]
    preload = subprocess.run(
        ["gcc", f"-print-file-name={rt}"],
        capture_output=True, text=True, check=True).stdout.strip()
    log_path = os.path.join(log_dir, f"{mode}-report")
    common = f"halt_on_error=1:log_path={log_path}:exitcode=66"
    env = {
        _b.SANITIZE_ENV: mode,
        "LD_PRELOAD": preload,
    }
    if mode == "asan":
        env["ASAN_OPTIONS"] = common + ":detect_leaks=0"
    else:
        # ignore_noninstrumented_modules: uninstrumented CPython
        # extension modules (e.g. _socket) look racy to TSan because
        # their atomics read as plain accesses; races are still
        # reported whenever any frame lands in the instrumented
        # data plane, which is the surface under test
        env["TSAN_OPTIONS"] = (common + ":report_signal_unsafe=0"
                               ":ignore_noninstrumented_modules=1")
    return env


def _load() -> ctypes.CDLL:
    global _lib, _lib_mode
    from . import build as _b

    mode = _b.sanitize_mode()
    if _lib is not None and _lib_mode == mode:
        return _lib
    with _load_lock:
        if _lib is not None:
            if _lib_mode != mode:
                # a sanitized .so cannot be safely swapped into a
                # process that already holds the plain one (and the
                # sanitizer runtime must be preloaded at exec time)
                raise RuntimeError(
                    f"data plane already loaded in mode "
                    f"{_lib_mode or 'plain'!r}; start a new process "
                    f"for {_b.SANITIZE_ENV}={mode}")
            return _lib

        lib = ctypes.CDLL(_b.build_dataplane(verbose=False),
                          mode=os.RTLD_LOCAL)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        u16p = ctypes.POINTER(ctypes.c_uint16)
        u64p = ctypes.POINTER(ctypes.c_uint64)
        i64p = ctypes.POINTER(ctypes.c_int64)
        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.dp_start.argtypes = [ctypes.c_uint16, ctypes.c_uint16,
                                 ctypes.c_int, u16p, ctypes.c_char_p]
        lib.dp_start.restype = ctypes.c_int
        lib.dp_stop.argtypes = []
        lib.dp_stop.restype = None
        lib.dp_config.argtypes = [ctypes.c_int, ctypes.c_char_p]
        lib.dp_config.restype = None
        lib.dp_faults.argtypes = [ctypes.c_double, ctypes.c_double,
                                  ctypes.c_double, ctypes.c_double,
                                  ctypes.c_uint64]
        lib.dp_faults.restype = None
        lib.dp_set_peers.argtypes = [ctypes.c_uint32, ctypes.c_char_p]
        lib.dp_set_peers.restype = ctypes.c_int
        lib.dp_peers_stale.argtypes = [ctypes.c_uint32]
        lib.dp_peers_stale.restype = ctypes.c_int
        lib.dp_attach.argtypes = [
            ctypes.c_uint32, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int64,
            ctypes.c_uint64, u64p, i64p, i32p, ctypes.c_int64]
        lib.dp_attach.restype = ctypes.c_int
        lib.dp_detach.argtypes = [ctypes.c_uint32, i64p, u64p]
        lib.dp_detach.restype = ctypes.c_int
        lib.dp_set_readonly.argtypes = [ctypes.c_uint32, ctypes.c_int]
        lib.dp_set_readonly.restype = ctypes.c_int
        lib.dp_set_replicas.argtypes = [ctypes.c_uint32, ctypes.c_int]
        lib.dp_set_replicas.restype = ctypes.c_int
        lib.dp_append.argtypes = [ctypes.c_uint32, u8p, ctypes.c_int64,
                                  ctypes.c_uint64, ctypes.c_int32,
                                  ctypes.c_uint64]
        lib.dp_append.restype = ctypes.c_int64
        lib.dp_delete.argtypes = [ctypes.c_uint32, ctypes.c_uint64, u8p,
                                  ctypes.c_int64, ctypes.c_uint64]
        lib.dp_delete.restype = ctypes.c_int64
        lib.dp_lookup.argtypes = [ctypes.c_uint32, ctypes.c_uint64, i64p,
                                  i32p]
        lib.dp_lookup.restype = ctypes.c_int
        lib.dp_lookup_any.argtypes = [ctypes.c_uint32, ctypes.c_uint64,
                                      i64p, i32p]
        lib.dp_lookup_any.restype = ctypes.c_int
        lib.dp_stats.argtypes = [ctypes.c_uint32, i64p]
        lib.dp_stats.restype = ctypes.c_int
        lib.dp_export.argtypes = [ctypes.c_uint32, u64p, i64p, i32p,
                                  ctypes.c_int64]
        lib.dp_export.restype = ctypes.c_int64
        lib.dp_http_stats.argtypes = [i64p]
        lib.dp_http_stats.restype = None
        lib.dp_front_stats.argtypes = [i64p]
        lib.dp_front_stats.restype = None
        lib.dp_bench.argtypes = [ctypes.c_char_p, ctypes.c_uint16,
                                 ctypes.c_int, ctypes.c_char_p,
                                 ctypes.c_char_p, ctypes.c_int64,
                                 ctypes.c_int64, ctypes.c_int, i64p, i64p]
        lib.dp_bench.restype = ctypes.c_int64
        lib.dp_bench_raw.argtypes = [ctypes.c_char_p, ctypes.c_uint16,
                                     u8p, i64p, ctypes.c_int64,
                                     ctypes.c_int, i64p, i64p]
        lib.dp_bench_raw.restype = ctypes.c_int64
        # -- native S3 front ------------------------------------------
        lib.dp_s3_start.argtypes = [ctypes.c_uint16, ctypes.c_uint16,
                                    ctypes.c_int,
                                    ctypes.POINTER(ctypes.c_uint16),
                                    ctypes.c_char_p, ctypes.c_int]
        lib.dp_s3_start.restype = ctypes.c_int
        lib.dp_s3_stop.argtypes = []
        lib.dp_s3_stop.restype = None
        lib.dp_s3_set_identities.argtypes = [ctypes.c_char_p]
        lib.dp_s3_set_identities.restype = None
        lib.dp_s3_set_buckets.argtypes = [ctypes.c_char_p]
        lib.dp_s3_set_buckets.restype = None
        lib.dp_s3_push_fids.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                        ctypes.c_int]
        lib.dp_s3_push_fids.restype = ctypes.c_int
        lib.dp_s3_pool_level.argtypes = [ctypes.c_char_p]
        lib.dp_s3_pool_level.restype = ctypes.c_int
        lib.dp_s3_cache_put.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                        ctypes.c_int64, ctypes.c_char_p,
                                        ctypes.c_char_p, ctypes.c_char_p,
                                        ctypes.c_int64]
        lib.dp_s3_cache_put.restype = ctypes.c_int
        lib.dp_s3_invalidate.argtypes = [ctypes.c_char_p, ctypes.c_int]
        lib.dp_s3_invalidate.restype = None
        lib.dp_s3_stats.argtypes = [i64p]
        lib.dp_s3_stats.restype = None
        lib.dp_md5_hex.argtypes = [u8p, ctypes.c_int64, ctypes.c_char_p]
        lib.dp_md5_hex.restype = None
        lib.dp_set_commit.argtypes = [ctypes.c_int, ctypes.c_double,
                                      ctypes.c_longlong]
        lib.dp_set_commit.restype = ctypes.c_int
        lib.dp_commit_stats.argtypes = [i64p]
        lib.dp_commit_stats.restype = None
        lib.dp_role_faults.argtypes = [ctypes.c_int, ctypes.c_double,
                                       ctypes.c_double, ctypes.c_double,
                                       ctypes.c_double, ctypes.c_uint64]
        lib.dp_role_faults.restype = None
        lib.dp_role_front_stats.argtypes = [ctypes.c_int, i64p]
        lib.dp_role_front_stats.restype = None
        lib.dp_s3_upload_mark.argtypes = [ctypes.c_char_p,
                                          ctypes.c_char_p, ctypes.c_int]
        lib.dp_s3_upload_mark.restype = None
        lib.dp_filer_start.argtypes = [ctypes.c_uint16, ctypes.c_uint16,
                                       ctypes.c_int,
                                       ctypes.POINTER(ctypes.c_uint16),
                                       ctypes.c_char_p, ctypes.c_int]
        lib.dp_filer_start.restype = ctypes.c_int
        lib.dp_filer_stop.argtypes = []
        lib.dp_filer_stop.restype = None
        lib.dp_filer_cache_put.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int64,
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
            ctypes.c_int64]
        lib.dp_filer_cache_put.restype = ctypes.c_int
        lib.dp_filer_invalidate.argtypes = [ctypes.c_char_p,
                                            ctypes.c_int]
        lib.dp_filer_invalidate.restype = None
        lib.dp_filer_push_fids.argtypes = [ctypes.c_char_p,
                                           ctypes.c_int]
        lib.dp_filer_push_fids.restype = ctypes.c_int
        lib.dp_filer_pool_level.argtypes = []
        lib.dp_filer_pool_level.restype = ctypes.c_int
        lib.dp_filer_set_writes.argtypes = [ctypes.c_int]
        lib.dp_filer_set_writes.restype = None
        lib.dp_filer_stats.argtypes = [i64p]
        lib.dp_filer_stats.restype = None
        _lib = lib
        _lib_mode = mode
        return lib


def md5_hex(data: bytes) -> str:
    """Test hook for the in-tree C++ MD5 (the S3 front's ETag hash)."""
    lib = _load()
    out = ctypes.create_string_buffer(33)
    lib.dp_md5_hex(_u8p(data), len(data), out)
    return out.value.decode()


def bench(host: str, port: int, mode: str, fids: list[str],
          payload_size: int, concurrency: int,
          auths: list[str] | None = None
          ) -> tuple[float, np.ndarray, int]:
    """Native load generator (no server needed on this side): drives
    GETs/POSTs over keep-alive connections from C++ worker threads.
    `auths`: optional per-fid bearer tokens for jwt-guarded rows.
    -> (wall seconds, per-request latency seconds — negative entries
    are failures, error count)."""
    lib = _load()
    blob = "\n".join(fids).encode()
    ablob = "\n".join(auths).encode() if auths else None
    lats = np.empty(len(fids), np.int64)
    errs = ctypes.c_int64(0)
    wall = lib.dp_bench(
        host.encode(), port, 1 if mode == "post" else 0, blob, ablob,
        len(fids), payload_size, concurrency,
        lats.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.byref(errs))
    if wall < 0:
        raise OSError(-wall, os.strerror(-wall))
    return wall / 1e9, lats.astype(np.float64) / 1e9, int(errs.value)


def bench_raw(host: str, port: int, requests: list[bytes],
              concurrency: int) -> tuple[float, np.ndarray, int]:
    """Replay prebuilt HTTP request bytes (already signed/framed by the
    caller) over native keep-alive connections — the S3/filer gateway
    benchmark client. -> (wall seconds, latency seconds with failures
    negative, error count)."""
    lib = _load()
    blob = b"".join(requests)
    offs = np.zeros(len(requests) + 1, np.int64)
    np.cumsum([len(r) for r in requests], out=offs[1:])
    lats = np.empty(len(requests), np.int64)
    errs = ctypes.c_int64(0)
    wall = lib.dp_bench_raw(
        host.encode(), port, _u8p(blob),
        offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(requests), concurrency,
        lats.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.byref(errs))
    if wall < 0:
        raise OSError(-wall, os.strerror(-wall))
    return wall / 1e9, lats.astype(np.float64) / 1e9, int(errs.value)


def _u8p(b: bytes):
    return ctypes.cast(ctypes.c_char_p(b), ctypes.POINTER(ctypes.c_uint8))


class DataPlane:
    """One native front server per process (the C library is a
    singleton); `attach` hands a volume's hot path to it."""

    def __init__(self) -> None:
        self._lib = _load()
        self.port = 0
        self.backend_port = 0

    # -- lifecycle ------------------------------------------------------
    def start(self, listen_port: int, backend_port: int,
              workers: int = 2, listen_ip: str = "") -> int:
        """listen_ip '' = all interfaces; otherwise the -ip bind
        address, honored exactly like the Python listener."""
        actual = ctypes.c_uint16(0)
        rc = self._lib.dp_start(listen_port, backend_port, workers,
                                ctypes.byref(actual), listen_ip.encode())
        if rc != 0:
            raise OSError(-rc, f"dp_start failed: {os.strerror(-rc)}")
        self.port = int(actual.value)
        self.backend_port = backend_port
        return self.port

    def stop(self) -> None:
        self._lib.dp_stop()

    def config(self, jwt_required: bool, secret: str = "") -> None:
        """jwt_required + the HS256 secret so the front verifies write
        tokens in-process instead of relaying every guarded write."""
        self._lib.dp_config(1 if jwt_required else 0, secret.encode())

    def set_commit(self, durability: str, max_delay: float,
                   max_bytes: int) -> None:
        """Push the group-commit ack contract (-commit.*) to every
        native front in this process: 'buffered' acks after pwrite
        (today's semantics), 'batch' acks from the fsync-completion
        callback, 'sync' fsyncs inline per write."""
        modes = {"buffered": 0, "batch": 1, "sync": 2}
        if durability not in modes:
            raise ValueError(f"unknown durability {durability!r}")
        self._lib.dp_set_commit(modes[durability], max_delay, max_bytes)

    def commit_stats(self) -> dict:
        """Group-commit counters (monotonic except queue_depth) for
        /debug/commit and the /metrics merge."""
        out = (ctypes.c_int64 * 6)()
        self._lib.dp_commit_stats(out)
        return {"batches": int(out[0]), "fsyncs": int(out[1]),
                "writes": int(out[2]), "bytes": int(out[3]),
                "fsync_seconds": int(out[4]) / 1e9,
                "queue_depth": int(out[5])}

    def set_faults(self, read_err: float = 0.0, write_err: float = 0.0,
                   read_delay: float = 0.0, write_delay: float = 0.0,
                   seed: int = 0) -> None:
        """Mirror this service's share of the -fault.spec into the
        native front: error probability and fixed delay per op class
        (read = GET/HEAD, write = POST/PUT/DELETE), with a seeded RNG
        for deterministic chaos runs. All zeros disables the gate."""
        self._lib.dp_faults(read_err, write_err, read_delay, write_delay,
                            seed & 0xFFFFFFFFFFFFFFFF)

    # -- volumes --------------------------------------------------------
    def attach(self, vid: int, dat_path: str, idx_path: str, version: int,
               read_only: bool, has_replicas: bool, tail: int,
               last_append_ns: int) -> None:
        """Load the .idx log and hand the volume to the native plane.
        The index replay (same semantics as load_needle_map) happens in
        C from the raw entry arrays."""
        if os.path.exists(idx_path):
            arr = idxmod.read_index(idx_path)
            keys = np.ascontiguousarray(arr["key"], dtype=np.uint64)
            offs = np.ascontiguousarray(
                arr["offset"].astype(np.int64) * t.NEEDLE_PADDING)
            sizes = np.ascontiguousarray(
                arr["size"].astype(np.uint32).view(np.int32))
        else:
            keys = np.empty(0, np.uint64)
            offs = np.empty(0, np.int64)
            sizes = np.empty(0, np.int32)
        rc = self._lib.dp_attach(
            vid, dat_path.encode(), idx_path.encode(), version,
            t.OFFSET_SIZE, 1 if read_only else 0, 1 if has_replicas else 0,
            tail, last_append_ns,
            keys.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            sizes.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            len(keys))
        if rc != 0:
            raise OSError(-rc, f"dp_attach({vid}): {os.strerror(-rc)}")

    def detach(self, vid: int) -> tuple[int, int]:
        """-> (dat tail offset, last_append_ns) at the detach point."""
        tail = ctypes.c_int64(0)
        ns = ctypes.c_uint64(0)
        rc = self._lib.dp_detach(vid, ctypes.byref(tail), ctypes.byref(ns))
        if rc != 0:
            raise OSError(-rc, f"dp_detach({vid}): {os.strerror(-rc)}")
        return int(tail.value), int(ns.value)

    def set_readonly(self, vid: int, ro: bool) -> None:
        self._lib.dp_set_readonly(vid, 1 if ro else 0)

    def set_replicas(self, vid: int, has: bool) -> None:
        self._lib.dp_set_replicas(vid, 1 if has else 0)

    def set_peers(self, vid: int, peers: list[str]) -> None:
        """Push the replica peer list ("host:port", self excluded) so
        the front fans primary writes out natively; clears the stale
        flag. Raises KeyError when the volume is not attached."""
        rc = self._lib.dp_set_peers(vid, ",".join(peers).encode())
        if rc != 0:
            raise KeyError(f"volume {vid} not attached")

    def peers_stale(self, vid: int) -> bool:
        """True when a fan-out failure invalidated the peer list (writes
        relay to Python until set_peers pushes a fresh one)."""
        rc = self._lib.dp_peers_stale(vid)
        if rc < 0:
            raise KeyError(f"volume {vid} not attached")
        return rc == 1

    # -- needle ops (Python-side delegation) ----------------------------
    def append(self, vid: int, rec: bytes, key: int, size: int,
               append_ns: int) -> int:
        off = self._lib.dp_append(vid, _u8p(rec), len(rec), key, size,
                                  append_ns)
        if off < 0:
            raise IOError(f"native append vid={vid}: {os.strerror(-off)}")
        return int(off)

    def delete(self, vid: int, key: int, tomb: bytes,
               append_ns: int) -> int:
        r = self._lib.dp_delete(vid, key, _u8p(tomb), len(tomb), append_ns)
        if r < 0:
            raise IOError(f"native delete vid={vid}: {os.strerror(-r)}")
        return int(r)

    def lookup(self, vid: int, key: int) -> tuple[int, int] | None:
        """-> (byte offset, size) of a live needle, else None."""
        off = ctypes.c_int64(0)
        size = ctypes.c_int32(0)
        rc = self._lib.dp_lookup(vid, key, ctypes.byref(off),
                                 ctypes.byref(size))
        if rc == 1:
            return int(off.value), int(size.value)
        return None

    def lookup_any(self, vid: int, key: int) -> tuple[int, int] | None:
        """Raw map entry incl. tombstones (size<0) — readDeleted."""
        off = ctypes.c_int64(0)
        size = ctypes.c_int32(0)
        rc = self._lib.dp_lookup_any(vid, key, ctypes.byref(off),
                                     ctypes.byref(size))
        if rc == 1:
            return int(off.value), int(size.value)
        return None

    def stats(self, vid: int) -> dict:
        out = (ctypes.c_int64 * 9)()
        rc = self._lib.dp_stats(vid, out)
        if rc != 0:
            raise KeyError(f"volume {vid} not attached")
        return {"file_count": out[0], "file_bytes": out[1],
                "deleted_count": out[2], "deleted_bytes": out[3],
                "tail": out[4], "last_append_ns": out[5],
                "max_key": out[6], "map_len": out[7],
                "read_only": bool(out[8])}

    def export(self, vid: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Full map dump incl. tombstones -> (keys u64, byte offsets
        i64, signed sizes i32)."""
        cap = max(16, self.stats(vid)["map_len"] + 1024)
        while True:
            keys = np.empty(cap, np.uint64)
            offs = np.empty(cap, np.int64)
            sizes = np.empty(cap, np.int32)
            n = self._lib.dp_export(
                vid, keys.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
                offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                sizes.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), cap)
            if n == -28:  # ENOSPC: grew between stats and export
                cap *= 2
                continue
            if n < 0:
                raise KeyError(f"volume {vid} not attached")
            return keys[:n], offs[:n], sizes[:n]

    def http_stats(self) -> dict:
        out = (ctypes.c_int64 * 8)()
        self._lib.dp_http_stats(out)
        return {"fast_get": out[0], "fast_post": out[1],
                "proxied": out[2], "errors": out[3],
                "fast_delete": out[4], "repl_post": out[5],
                "jwt_reject": out[6], "fanout_fail": out[7]}

    def front_stats(self) -> dict:
        """Native-front response/byte counters (monotonic snapshot for
        the host's /metrics merge)."""
        out = (ctypes.c_int64 * 6)()
        self._lib.dp_front_stats(out)
        return {"2xx": int(out[0]), "3xx": int(out[1]),
                "4xx": int(out[2]), "5xx": int(out[3]),
                "bytes_in": int(out[4]), "bytes_out": int(out[5])}

    def role_front_stats(self, role: int) -> dict:
        """Per-role front counters (ROLE_VOLUME/ROLE_S3/ROLE_FILER) for
        the per-front /metrics families."""
        out = (ctypes.c_int64 * 6)()
        self._lib.dp_role_front_stats(role, out)
        return {"2xx": int(out[0]), "3xx": int(out[1]),
                "4xx": int(out[2]), "5xx": int(out[3]),
                "bytes_in": int(out[4]), "bytes_out": int(out[5])}


class NativeNeedleMap:
    """needle_map interface over an attached volume's native map —
    get/counters/iteration for the Python control plane; mutations go
    through Volume's delegated append/delete, never through here."""

    def __init__(self, dp: DataPlane, vid: int):
        self._dp = dp
        self._vid = vid

    def get(self, key: int) -> tuple[int, int] | None:
        hit = self._dp.lookup(self._vid, key)
        if hit is None:
            return None
        byte_off, size = hit
        return byte_off // t.NEEDLE_PADDING, size

    def get_any(self, key: int) -> tuple[int, int] | None:
        """Raw entry incl. tombstones (readDeleted path)."""
        hit = self._dp.lookup_any(self._vid, key)
        if hit is None:
            return None
        byte_off, size = hit
        return byte_off // t.NEEDLE_PADDING, size

    def __len__(self) -> int:
        return self._dp.stats(self._vid)["map_len"]

    @property
    def file_count(self) -> int:
        return self._dp.stats(self._vid)["file_count"]

    @property
    def file_bytes(self) -> int:
        return self._dp.stats(self._vid)["file_bytes"]

    @property
    def deleted_count(self) -> int:
        return self._dp.stats(self._vid)["deleted_count"]

    @property
    def deleted_bytes(self) -> int:
        return self._dp.stats(self._vid)["deleted_bytes"]

    @property
    def max_key(self) -> int:
        return self._dp.stats(self._vid)["max_key"]

    def items(self):
        keys, offs, sizes = self._dp.export(self._vid)
        for k, o, s in zip(keys, offs, sizes):
            yield int(k), int(o) // t.NEEDLE_PADDING, int(s)

    def live_items(self):
        for k, o, s in self.items():
            if t.size_is_valid(s):
                yield k, o, s

    def deleted_keys(self):
        for k, _o, s in self.items():
            if t.size_is_deleted(s):
                yield k

    def put(self, key: int, offset: int, size: int) -> None:
        raise RuntimeError(
            "volume is natively attached; mutations must go through "
            "Volume.append_needle/delete_needle (delegated)")

    delete = put

    def close(self) -> None:
        pass  # lifetime is the attach window; detach owns cleanup


class S3Front:
    """The native S3 gateway front (one per process, combined-server
    mode): owns the public S3 port, serves SigV4 small-object PUT/GET
    natively against the LOCAL volume store, and relays everything
    else to the Python S3 app on `backend_port`. Entry metadata flows
    to the in-process filer over `chan_sock` (a socketpair created by
    the caller); identities/buckets/fid-pools/cache are pushed through
    the setters. See the S3-front block in dataplane.cc."""

    def __init__(self) -> None:
        self._lib = _load()
        self.port = 0

    def start(self, listen_port: int, backend_port: int, chan_fd: int,
              workers: int = 2, listen_ip: str = "") -> int:
        actual = ctypes.c_uint16(0)
        rc = self._lib.dp_s3_start(listen_port, backend_port, workers,
                                   ctypes.byref(actual),
                                   listen_ip.encode(), chan_fd)
        if rc != 0:
            raise OSError(-rc, f"dp_s3_start failed: {os.strerror(-rc)}")
        self.port = int(actual.value)
        return self.port

    def stop(self) -> None:
        self._lib.dp_s3_stop()

    def set_identities(self, rows: list[tuple[str, str, str, str, str]]
                       ) -> None:
        """rows: (access_key, secret, flags 'AWR', wr_csv, rd_csv)."""
        tsv = "\n".join("\t".join(r) for r in rows)
        self._lib.dp_s3_set_identities(tsv.encode())

    def set_buckets(self, buckets: list[str]) -> None:
        self._lib.dp_s3_set_buckets(",".join(buckets).encode())

    def push_fids(self, bucket: str, fid: str, count: int) -> None:
        rc = self._lib.dp_s3_push_fids(bucket.encode(), fid.encode(),
                                       count)
        if rc != 0:
            raise ValueError(f"bad fid {fid!r}")

    def pool_level(self, bucket: str) -> int:
        return int(self._lib.dp_s3_pool_level(bucket.encode()))

    def cache_put(self, path: str, fid: str, size: int, etag: str,
                  mime: str, meta_block: str, mtime: int) -> None:
        self._lib.dp_s3_cache_put(path.encode(), fid.encode(), size,
                                  etag.encode(), mime.encode(),
                                  meta_block.encode(), mtime)

    def invalidate(self, path: str, prefix: bool = False) -> None:
        self._lib.dp_s3_invalidate(path.encode(), 1 if prefix else 0)

    def upload_mark(self, bucket: str, upload_id: str,
                    present: bool) -> None:
        """Mark a multipart upload id as in flight (initiate) or gone
        (complete/abort); only marked uploads take the native
        part-upload path."""
        self._lib.dp_s3_upload_mark(bucket.encode(), upload_id.encode(),
                                    1 if present else 0)

    def set_faults(self, read_err: float = 0.0, write_err: float = 0.0,
                   read_delay: float = 0.0, write_delay: float = 0.0,
                   seed: int = 0) -> None:
        """This front's share of a -fault.spec (service 's3')."""
        self._lib.dp_role_faults(ROLE_S3, read_err, write_err, read_delay,
                                 write_delay, seed & 0xFFFFFFFFFFFFFFFF)

    def stats(self) -> dict:
        out = np.zeros(6, np.int64)
        self._lib.dp_s3_stats(
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
        return {"fast_put": int(out[0]), "fast_get": int(out[1]),
                "rejected": int(out[2]), "chan_fail": int(out[3]),
                "fast_del": int(out[4]), "fast_part": int(out[5])}


class FilerFront:
    """The native filer gateway front (one per process, combined-server
    mode): owns the public filer port, serves GET/PUT/HEAD/DELETE of
    plain files natively against the LOCAL volume store, and relays
    every other verb/path class to the Python filer app on
    `backend_port`. Entry mutations ride the same TSV applier channel
    shape as the S3 front (`chan_sock` socketpair created by the
    caller), so the zero-staleness cache contract holds across both
    fronts. See the filer-front block in dataplane.cc."""

    def __init__(self) -> None:
        self._lib = _load()
        self.port = 0

    def start(self, listen_port: int, backend_port: int, chan_fd: int,
              workers: int = 2, listen_ip: str = "") -> int:
        actual = ctypes.c_uint16(0)
        rc = self._lib.dp_filer_start(listen_port, backend_port, workers,
                                      ctypes.byref(actual),
                                      listen_ip.encode(), chan_fd)
        if rc != 0:
            raise OSError(-rc, f"dp_filer_start failed: {os.strerror(-rc)}")
        self.port = int(actual.value)
        return self.port

    def stop(self) -> None:
        self._lib.dp_filer_stop()

    def push_fids(self, fid: str, count: int) -> None:
        rc = self._lib.dp_filer_push_fids(fid.encode(), count)
        if rc != 0:
            raise ValueError(f"bad fid {fid!r}")

    def pool_level(self) -> int:
        return int(self._lib.dp_filer_pool_level())

    def set_writes(self, on: bool) -> None:
        """Enable the native PUT/DELETE fast path — only sound while
        the python filer would apply its defaults verbatim (no
        filer.conf path rules, no cipher, no save-inside inlining)."""
        self._lib.dp_filer_set_writes(1 if on else 0)

    def cache_put(self, path: str, fid: str, size: int, etag: str,
                  mime: str, ext_block: str, mtime: int) -> None:
        self._lib.dp_filer_cache_put(path.encode(), fid.encode(), size,
                                     etag.encode(), mime.encode(),
                                     ext_block.encode(), mtime)

    def invalidate(self, path: str, prefix: bool = False) -> None:
        self._lib.dp_filer_invalidate(path.encode(), 1 if prefix else 0)

    def set_faults(self, read_err: float = 0.0, write_err: float = 0.0,
                   read_delay: float = 0.0, write_delay: float = 0.0,
                   seed: int = 0) -> None:
        """This front's share of a -fault.spec (service 'filer')."""
        self._lib.dp_role_faults(ROLE_FILER, read_err, write_err,
                                 read_delay, write_delay,
                                 seed & 0xFFFFFFFFFFFFFFFF)

    def stats(self) -> dict:
        out = np.zeros(4, np.int64)
        self._lib.dp_filer_stats(
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
        return {"fast_put": int(out[0]), "fast_get": int(out[1]),
                "fast_del": int(out[2]), "chan_fail": int(out[3])}
