"""File-level erasure coding: volume .dat -> .ec00..ecNN shard files,
rebuild of missing shards, and parity verification — the counterpart of
seaweedfs_tpu/ec/encoder.py.

Functional equivalents of the reference's WriteEcFiles / RebuildEcFiles
(weed/storage/erasure_coding/ec_encoder.go:57,61), built for a batched
device codec:

* The .dat is memory-mapped and fed to the codec backend as wide (k, W)
  byte matrices — W spans many stripe rows of the small-block region at
  once (a row-group transpose turns contiguous file bytes into codec
  columns), so one kernel launch covers tens of MB.
* The same coded-matmul stream serves encode (parity rows) and rebuild
  (recovery rows from rs_matrix).

Shard-file bytes are identical to the reference's. The default backend
is the CUDA kernel on the GPU (`backend="cuda"`); pass a codec instance
such as `CudaCodec(device="cpu")` to run elsewhere. Left for later
slices: the native C++ bypass, the tracing span, `write_sorted_ecx` and
the measured pipeline depth (the double buffer is used).
"""
from __future__ import annotations

import os

import numpy as np

from . import geometry as geo
from .backend import CodecBackend, ReedSolomon

# Default column width per codec dispatch (bytes per shard). Multiple
# small rows are packed per dispatch up to this width.
DEFAULT_CHUNK = 32 << 20
# In-flight blocks of the streaming pipeline: the classic double buffer.
DEFAULT_DEPTH = 2


def _contig_view(row: np.ndarray):
    """Zero-copy buffer for file writes."""
    return memoryview(np.ascontiguousarray(row))


class _AsyncWriter:
    """Background thread pool draining ordered (file, array) queues.

    Each output file is pinned to ONE thread (first-seen round-robin), so
    per-file write order is the enqueue order while different shard files
    write concurrently; write() drops the GIL, so the page-cache copies
    overlap the codec work."""

    def __init__(self, max_pending_bytes: int = 256 << 20,
                 threads: int = 4):
        import queue
        import threading

        self._qs = [queue.Queue() for _ in range(max(1, threads))]
        self._affinity: dict[int, int] = {}  # id(file) -> queue index
        self._next = 0
        self._err: list[BaseException] = []
        # backpressure is byte-denominated: a count bound at 32MB rows
        # would pin hundreds of MB of blocks alive
        self._max = max_pending_bytes
        self._bytes = 0
        self._cond = threading.Condition()
        self._threads = [
            threading.Thread(target=self._run, args=(q,), daemon=True)
            for q in self._qs]
        for t in self._threads:
            t.start()

    def _run(self, q) -> None:
        while True:
            item = q.get()
            if item is None:
                return
            f, arr = item
            if not self._err:
                try:
                    view = _contig_view(arr)
                    # raw (buffering=0) files may short-write (e.g.
                    # ENOSPC partway); loop or the next block lands at
                    # the wrong offset and the shard silently corrupts
                    while len(view):
                        n = f.write(view)
                        if n is None or n == len(view):
                            break
                        view = view[n:]
                except BaseException as e:  # noqa: BLE001 - close re-raises
                    self._err.append(e)
            with self._cond:
                self._bytes -= arr.nbytes
                self._cond.notify_all()

    def put(self, f, arr: np.ndarray) -> None:
        with self._cond:
            while self._bytes >= self._max and not self._err:
                self._cond.wait()
            self._bytes += arr.nbytes
        qi = self._affinity.get(id(f))
        if qi is None:
            qi = self._affinity[id(f)] = self._next % len(self._qs)
            self._next += 1
        self._qs[qi].put((f, arr))

    def close(self) -> None:
        for q in self._qs:
            q.put(None)
        for t in self._threads:
            t.join()
        if self._err:
            raise self._err[0]


def code_of(base: str) -> geo.CodeConfig:
    """Full code config of the shard set at `base` (.vif sidecar)."""
    from ..storage import volume_info as vinfo

    vi = vinfo.maybe_load_volume_info(base + ".vif")
    return geo.parse_code(vi.ec_codec if vi else "")


def _record_codec(base: str, codec: str) -> None:
    """Persist a non-default codec in the .vif so every later consumer
    agrees on the geometry."""
    from ..storage import volume_info as vinfo

    vi = vinfo.maybe_load_volume_info(base + ".vif") or vinfo.VolumeInfo()
    vi.ec_codec = codec
    vinfo.save_volume_info(base + ".vif", vi)


def write_ec_files(base: str, backend: str | CodecBackend = "cuda",
                   large_block: int = geo.LARGE_BLOCK,
                   small_block: int = geo.SMALL_BLOCK,
                   chunk: int = DEFAULT_CHUNK,
                   codec: str = "") -> None:
    """Generate .ec00..ecNN from `base`.dat (WriteEcFiles equivalent).
    `codec` selects the code family: "k.m" a (wide) RS, "lrc-k.l.g" an
    LRC; default RS(10,4)."""
    code = geo.parse_code(codec or "")
    k, m = code.k, code.m
    # identity is the CODE, not (k, m): lrc-10.2.2 shares RS(10,4)'s
    # shard count but not its parity bytes, so it must hit the .vif too
    if code != geo.parse_code(""):
        _record_codec(base, codec)
    else:
        # re-encoding at the default codec must CLEAR a stale wide-code
        # marker left by a previous encode/decode cycle
        from ..storage import volume_info as vinfo

        vi = vinfo.maybe_load_volume_info(base + ".vif")
        if vi is not None and vi.ec_codec:
            vi.ec_codec = ""
            vinfo.save_volume_info(base + ".vif", vi)
    rs = ReedSolomon(k, m, backend=backend, code=code)
    dat_path = base + ".dat"
    dat_size = os.path.getsize(dat_path)
    n_large, n_small = geo.row_layout(dat_size, large_block, small_block,
                                      data_shards=k)

    dat = np.memmap(dat_path, dtype=np.uint8, mode="r") if dat_size else \
        np.zeros(0, dtype=np.uint8)
    # buffering=0: every write here is a full shard block; the default
    # BufferedWriter adds a copy
    outs = [open(base + geo.shard_ext(i), "wb", buffering=0)
            for i in range(k + m)]
    try:
        _encode_region(rs, dat, 0, n_large, large_block, chunk, outs)
        _encode_region(rs, dat, n_large * large_block * k,
                       n_small, small_block, chunk, outs)
    finally:
        for f in outs:
            f.close()
        if dat_size:
            del dat


def _region_blocks(dat: np.ndarray, start: int, n_rows: int,
                   block: int, chunk: int, k: int = geo.DATA_SHARDS,
                   wide: bool = True):
    """Yield the (k, w) codec input blocks for `n_rows` stripe rows of
    `block`-sized blocks starting at file offset `start`, in shard-file
    write order.

    wide=True packs many rows per dispatch via a transpose gather —
    right for device codecs, whose per-dispatch cost dwarfs the strided
    copy. wide=False walks one stripe row at a time: a full row is a
    CONTIGUOUS window of the .dat, so the codec input is a zero-copy
    reshape view — right for the host codec."""
    row_bytes = block * k
    total = dat.shape[0]
    if block >= chunk:
        # large blocks: walk one row at a time, column-chunked
        for r in range(n_rows):
            row_start = start + r * row_bytes
            for c0 in range(0, block, chunk):
                c1 = min(c0 + chunk, block)
                yield _gather_columns(dat, row_start, block, c0, c1, k)
        return
    if not wide:
        for r in range(n_rows):
            row_start = start + r * row_bytes
            if row_start + row_bytes <= total:
                yield dat[row_start:row_start + row_bytes] \
                    .reshape(k, block)
            else:  # tail row: zero-pad past EOF
                flat = np.zeros(row_bytes, dtype=np.uint8)
                avail = max(0, total - row_start)
                if avail:
                    flat[:avail] = dat[row_start:row_start + avail]
                yield flat.reshape(k, block)
        return
    # small blocks, wide: pack many rows per dispatch
    rows_per = max(1, chunk // block)
    for r0 in range(0, n_rows, rows_per):
        r1 = min(r0 + rows_per, n_rows)
        span_start = start + r0 * row_bytes
        span_len = (r1 - r0) * row_bytes
        avail = max(0, min(span_len, total - span_start))
        if avail == span_len:
            # full span: transpose straight off the memmap — one
            # strided copy instead of flat-copy + transpose-copy
            flat = dat[span_start:span_start + span_len]
        else:
            flat = np.zeros(span_len, dtype=np.uint8)
            if avail:
                flat[:avail] = dat[span_start:span_start + avail]
        # (rows, k, block) -> (k, rows*block): row-major per shard
        yield np.ascontiguousarray(
            flat.reshape(r1 - r0, k, block).transpose(1, 0, 2)
            .reshape(k, (r1 - r0) * block))


def _encode_region(rs: ReedSolomon, dat: np.ndarray, start: int, n_rows: int,
                   block: int, chunk: int, outs: list) -> None:
    """Encode a stripe-row region, writing each shard's blocks
    sequentially. Data-shard bytes are written as each block is
    gathered (they never touch the codec); parity arrives through the
    backend's streaming pipeline, which keeps DEFAULT_DEPTH blocks in flight
    on a device codec so H2D, kernel and D2H overlap."""
    k = rs.k
    # the host codec takes narrow zero-copy row views; device codecs get
    # wide packed dispatches that amortize launch and transfer latency
    wide = getattr(rs.backend, "name", "") != "numpy"
    w = _AsyncWriter()
    try:
        def gen():
            for data in _region_blocks(dat, start, n_rows, block, chunk,
                                       k, wide=wide):
                for i in range(k):
                    w.put(outs[i], data[i])
                yield data

        for parity in rs.encode_stream(gen(), depth=DEFAULT_DEPTH):
            for j in range(rs.m):
                w.put(outs[k + j], parity[j])
    finally:
        w.close()


def _gather_columns(dat: np.ndarray, row_start: int, block: int,
                    c0: int, c1: int,
                    k: int = geo.DATA_SHARDS) -> np.ndarray:
    """(k, c1-c0) data matrix for one stripe row, zero-padded past EOF."""
    w = c1 - c0
    out = np.zeros((k, w), dtype=np.uint8)
    total = dat.shape[0]
    for i in range(k):
        s = row_start + i * block + c0
        e = min(s + w, total)
        if e > s:
            out[i, : e - s] = dat[s:e]
    return out


def rebuild_ec_files(base: str, backend: str | CodecBackend = "cuda",
                     chunk: int = DEFAULT_CHUNK,
                     only_shards: list[int] | None = None) -> list[int]:
    """Regenerate missing .ecXX files from the present ones
    (RebuildEcFiles equivalent). Returns rebuilt shard ids.
    `only_shards` restricts which missing shards are produced."""
    code = code_of(base)
    k, m = code.k, code.m
    present, missing = [], []
    for i in range(k + m):
        (present if os.path.exists(base + geo.shard_ext(i)) else
         missing).append(i)
    if only_shards is not None:
        missing = [i for i in missing if i in set(only_shards)]
    if not missing:
        return []
    if not code.recoverable(present):
        raise ValueError(
            f"shards {present} cannot rebuild {code.spec} "
            f"(need rank {k})")

    rs = ReedSolomon(k, m, backend=backend, code=code)
    sizes = {os.path.getsize(base + geo.shard_ext(i)) for i in present}
    if len(sizes) != 1:
        raise ValueError(f"present shards disagree on size: {sizes}")
    shard_size = sizes.pop()

    # one recovery matrix serves every chunk; the code's repair plan
    # picks the inputs (an LRC single-loss reads its group, not k), and
    # only THOSE shards are opened — repair IO equals the plan's fan-in
    from ..ops import rs_matrix

    rows, inputs = rs_matrix.recovery_rows_for(code, present, missing)
    ins = {i: np.memmap(base + geo.shard_ext(i), dtype=np.uint8, mode="r")
           for i in inputs} if shard_size else {i: np.zeros(0, np.uint8)
                                                for i in inputs}
    outs = {i: open(base + geo.shard_ext(i), "wb", buffering=0)
            for i in missing}
    try:
        def gen():
            for c0 in range(0, shard_size, chunk):
                c1 = min(c0 + chunk, shard_size)
                yield np.stack([np.asarray(ins[i][c0:c1]) for i in inputs])

        w = _AsyncWriter()
        try:
            for rec in rs.matmul_stream(rows, gen(), depth=DEFAULT_DEPTH,
                                        op="reconstruct"):
                for j, i in enumerate(missing):
                    w.put(outs[i], rec[j])
        finally:
            w.close()
    finally:
        for f in outs.values():
            f.close()
    return missing


def verify_ec_files(base: str, backend: str | CodecBackend = "cuda",
                    chunk: int = DEFAULT_CHUNK) -> bool:
    """Parity-check the full shard set (scrub building block)."""
    code = code_of(base)
    k, m = code.k, code.m
    rs = ReedSolomon(k, m, backend=backend, code=code)
    paths = [base + geo.shard_ext(i) for i in range(k + m)]
    if not all(os.path.exists(p) for p in paths):
        return False
    size = os.path.getsize(paths[0])
    if any(os.path.getsize(p) != size for p in paths):
        return False
    if not size:
        return True
    maps = [np.memmap(p, dtype=np.uint8, mode="r") for p in paths]
    from collections import deque

    expected: deque = deque()

    def gen():
        for c0 in range(0, size, chunk):
            c1 = min(c0 + chunk, size)
            stack = np.stack([np.asarray(mm[c0:c1]) for mm in maps])
            expected.append(stack[k:])
            yield stack[:k]

    for parity in rs.encode_stream(gen(), depth=DEFAULT_DEPTH):
        if not np.array_equal(parity, expected.popleft()):
            return False
    return True
