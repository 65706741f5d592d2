"""Dense torch codec: the GF(256) coded matmul as a float32 GF(2)
bit-plane matmul — the counterpart of seaweedfs_tpu/ops/codec_jax.py.

Multiplication by a GF(256) constant is linear over GF(2)^8, so the m x k
coefficient matrix expands to an (8m x 8k) 0/1 matrix
(gf256.expand_to_bits) and

    out_bytes = pack( (A_bits @ unpack(shards)) mod 2 )

TorchCodec (backend name `torch`) runs that product with torch ops on
one device; CudaCodec (ops/codec_cuda.py, backend `cuda`) reuses all of
this class but swaps the per-coefficient operands and the kernel.

What it keeps from JaxCodec: the column slab split (bounding the (8k, n)
float32 intermediate), the LRU of per-coefficient device operands
(BITMAT_CACHE_MAX), the measured XOR-schedule chooser (`_plan_for`: the
CSE-scheduled program of ops/schedule.py run as torch XOR ops on uint8
bit planes, `xor_matmul`, picked per (matrix, size bucket) when it
measured faster than the dense product), and the depth-N staged
`coded_matmul_stream` with the ec_codec_stage_seconds{stage,backend}
stages pread, h2d, kernel, d2h and relay, plus `pin` on a GPU: the host
copy into pinned staging, which the JAX feed did not have. The one-shot
`coded_matmul` records its own three stages, h2d (the pageable upload),
kernel (the product with its slab `torch.cat`) and d2h (the read-back
into new host memory), once per call into
ec_codec_call_stage_seconds{stage,backend} (`_mark`), and opens a
profiler range `ec.codec.<stage>` around each. What it drops:
the power-of-two column padding (`_pad_width`), which only bounded XLA
recompiles — eager PyTorch compiles nothing, so blocks go to the device
at their true width and nothing is sliced off.

On a CUDA device the stream runs every block through a `DeviceLane`: a
ring of `depth` pinned host buffers (a pageable `np.memmap` slice would
make the copy synchronous), an upload on its own copy stream, the kernel
on the codec's compute stream (`TorchCodec.stream`, which the chooser's
measurement also runs on and synchronises) after the upload's event, and
a read-back on a third stream into pinned memory. Device stages are
timed with CUDA events, not the host clock. `staged_feed` is the
pipeline's skeleton (pread, upload and drain threads, relay) that every
feed of the port shares; the mesh codec and models/ec_pipeline run one
lane per card on it. `transfer_stream` runs the same feed with the
product replaced by a row-slice copy: the link's ceiling for the same
traffic, which the probe (ec/probe.py) pairs with every measured rate.
"""
from __future__ import annotations

import functools
import threading
import time as _time
from collections import OrderedDict, deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from . import bits, gf256, schedule
from ..utils import metrics, tracing
from ..utils.device import DEFAULT_DEVICE, resolve_device

# Columns per dense product: 2 Mi columns x 8k bit-rows of float32 is
# 640 MiB of intermediate at RS(10,4).
DEFAULT_SLAB = 1 << 21


def observe_stage(backend: str, stage: str, seconds: float) -> None:
    """Per-stage feed timing (pread/pin/h2d/kernel/d2h/relay), one histogram
    per (stage, backend)."""
    metrics.histogram_observe("ec_codec_stage_seconds", seconds,
                              {"stage": stage, "backend": backend})


def _mark(device: torch.device):
    """A stage boundary of a one-shot call: a CUDA event on the device's
    current stream, which the call's copies and kernels run on, or the
    host clock on the CPU. A stage is the device time between two marks
    of one shared stream, so it holds only while one-shot calls on the
    card do not overlap: two threads calling at once each see the
    other's queued work in their stages."""
    if device.type != "cuda":
        return _time.perf_counter()
    ev = torch.cuda.Event(enable_timing=True)
    ev.record(torch.cuda.current_stream(device))
    return ev


@functools.lru_cache(maxsize=schedule.PLAN_CACHE_MAX)
def _dead_after(program: schedule.Program) -> tuple[tuple[int, ...], ...]:
    """For each op of `program`, the op-result variables whose last read
    it is (outputs excepted): dropping them there bounds the live pool to
    the program's widest cut instead of one plane row per op."""
    last: dict[int, int] = {}
    for i, (_, a, b) in enumerate(program.ops):
        last[a] = last[b] = i
    keep = set(program.outputs)
    dead: list[list[int]] = [[] for _ in program.ops]
    for v, i in last.items():
        if v >= program.n_in and v not in keep:
            dead[i].append(v)
    return tuple(tuple(d) for d in dead)


def xor_matmul(program: schedule.Program, shards: torch.Tensor
               ) -> torch.Tensor:
    """The scheduled alternative to the dense product (codec_jax.
    _xor_matmul_body): run the CSE-scheduled XOR program over uint8 bit
    planes, (k, n) uint8 -> (m, n) uint8 on the tensor's device. Same
    bytes as the dense product: the schedule rewrites the program, not
    the layout. One torch op per XOR, so ~10^3 launches per call at
    RS(10,4); each dead intermediate is released after its last read."""
    if shards.shape[0] * 8 != program.n_in:
        raise ValueError(f"shards {tuple(shards.shape)} do not match a "
                         f"program over {program.n_in} planes")
    planes = bits.unpack_bits(shards, dtype=torch.uint8)
    pool: list[torch.Tensor | None] = [planes[i]
                                       for i in range(program.n_in)]
    pool += [None] * len(program.ops)
    for (dst, a, b), dead in zip(program.ops, _dead_after(program)):
        pool[dst] = pool[a] ^ pool[b]
        for v in dead:
            pool[v] = None
    zero = torch.zeros_like(planes[0])
    rows = torch.stack([pool[v] if v >= 0 else zero
                        for v in program.outputs])
    return bits.pack_bits_uint8(rows)


def _into(out: torch.Tensor | None, result: torch.Tensor) -> torch.Tensor:
    return result if out is None else out.copy_(result)


def _readback(t: torch.Tensor, marks: list | None = None) -> np.ndarray:
    """One device result as a host array (the reference's
    codec_jax._readback): the one-shot calls' drain site, which waits
    for the result by contract. Given a call's stage `marks`, it ends
    them with the read-back's own and waits for that too, so that every
    stage can be read."""
    arr = t.cpu().numpy()
    if marks is not None:
        marks.append(_mark(t.device))
        if t.is_cuda:
            marks[-1].synchronize()
    return arr


def host_tensor(arr: np.ndarray) -> torch.Tensor:
    """Zero-copy uint8 CPU tensor over a host array (copied only when the
    array is read-only or strided, e.g. a memmap view)."""
    arr = np.ascontiguousarray(arr, dtype=np.uint8)
    if not arr.flags.writeable:
        arr = arr.copy()
    return torch.from_numpy(arr)


class TorchCodec:
    """Coded-matmul backend running dense torch ops on one device
    (`device="cuda"` by default; raises when there is no GPU unless the
    caller asks for `device="cpu"`)."""

    name = "torch"

    # bound the per-instance coefficient-operand cache: reconstruction
    # over wide codes can see tens of thousands of distinct matrices
    BITMAT_CACHE_MAX = 256

    def __init__(self, slab: int = DEFAULT_SLAB,
                 device: str | torch.device = DEFAULT_DEVICE):
        self.slab = int(slab)
        self.device = resolve_device(device)
        self._mats: "OrderedDict[bytes, torch.Tensor]" = OrderedDict()
        self._mats_lock = threading.Lock()
        self._chooser = schedule.Chooser()
        # the compute stream: every feed's products and the chooser's
        # timed runs go here (None on the CPU)
        self.stream = None
        if self.device.type == "cuda":
            # the dense product is specified in full float32 (bits.py)
            torch.backends.cuda.matmul.allow_tf32 = False
            self.stream = torch.cuda.Stream(self.device)

    # -- per-backend operands and kernel (CudaCodec overrides both) ----
    def _make_mats(self, coef: np.ndarray) -> torch.Tensor:
        """Coefficient bytes -> the (8m, 8k) float32 bit-matrix."""
        a = gf256.expand_to_bits(coef).astype(np.float32)
        return torch.from_numpy(a).to(self.device)

    def _kernel(self, mats: torch.Tensor, x: torch.Tensor,
                out: torch.Tensor | None = None) -> torch.Tensor:
        """One (k, w) device slab -> (m, w) device result, written into
        `out` when one is given."""
        return _into(out, bits.coded_matmul_bits(mats, x))

    # ------------------------------------------------------------------
    def _coef_mats(self, coef: np.ndarray) -> torch.Tensor:
        key = coef.shape[0].to_bytes(2, "big") + coef.tobytes()
        with self._mats_lock:
            mats = self._mats.get(key)
            if mats is not None:
                self._mats.move_to_end(key)
                return mats
        mats = self._make_mats(coef)
        with self._mats_lock:
            self._mats[key] = mats
            while len(self._mats) > self.BITMAT_CACHE_MAX:
                self._mats.popitem(last=False)
        return mats

    def _run(self, mats, dev: torch.Tensor,
             plan: schedule.Program | None = None,
             out: torch.Tensor | None = None) -> torch.Tensor:
        """The kernel over one on-device (k, n) block, slab by slab: the
        scheduled XOR program when the chooser picked it (`plan`), else
        the dense product; into `out` when one is given. Slabs are
        column views of `dev` and `out` (no copy); no padding, since
        eager torch has no compiled shapes to bound."""
        if plan is not None:
            def op(x, o=None):
                return _into(o, xor_matmul(plan, x))
        else:
            op = functools.partial(self._kernel, mats)
        n = dev.shape[1]
        if n <= self.slab:
            return op(dev, out)
        if out is None:
            return torch.cat([op(dev[:, off:off + self.slab])
                              for off in range(0, n, self.slab)], dim=1)
        for off in range(0, n, self.slab):
            op(dev[:, off:off + self.slab], out[:, off:off + self.slab])
        return out

    def _plan_for(self, coef: np.ndarray, nbytes: int
                  ) -> schedule.Program | None:
        """The scheduled program when measurement says it beats the
        dense product at this (matrix, size bucket); None otherwise
        (codec_jax.JaxCodec._plan_for). Both are timed once per bucket
        on a seeded sample of at most one slab, after a warm call each,
        on a background thread, and the verdict is keyed by the
        sample's byte size; SEAWEEDFS_TPU_EC_SCHEDULE=on|off pins it.
        On a GPU the runs go to the codec's compute stream and each
        returns only after synchronising it, so the host clock times
        device work, not launches."""
        k = coef.shape[1]
        w = min(max(1, nbytes // max(1, k)), self.slab)
        sample_bytes = min(nbytes, k * w)
        state: dict = {}

        def prep():
            if not state:
                chunk = np.random.default_rng(0).integers(
                    0, 256, (k, w), dtype=np.uint8)
                state["x"] = torch.from_numpy(chunk).to(self.device)
                state["mats"] = self._coef_mats(coef)
                state["plan"] = schedule.plan_for(coef)

        def timed(fn):
            prep()
            if self.stream is None:
                fn()
                return
            with torch.cuda.stream(self.stream):
                fn()
            self.stream.synchronize()

        def run_sched():
            timed(lambda: xor_matmul(state["plan"], state["x"]))

        def run_dense():
            timed(lambda: self._kernel(state["mats"], state["x"]))

        if self._chooser.use_scheduled(coef, sample_bytes, run_sched,
                                       run_dense, background=True):
            return schedule.plan_for(coef)
        return None

    def coded_matmul(self, coef: np.ndarray, shards) -> np.ndarray:
        coef = np.asarray(coef, dtype=np.uint8)
        m, k = coef.shape
        shards = np.asarray(shards, dtype=np.uint8)
        if shards.ndim != 2 or shards.shape[0] != k:
            raise ValueError(f"shards {shards.shape} do not match coef "
                             f"{coef.shape}")
        if shards.shape[1] == 0:
            return np.zeros((m, 0), dtype=np.uint8)
        plan = self._plan_for(coef, shards.nbytes)
        mats = self._coef_mats(coef)
        marks = [_mark(self.device)]
        with tracing.annotate("ec.codec.h2d"):
            dev = host_tensor(shards).to(self.device)
        marks.append(_mark(self.device))
        with tracing.annotate("ec.codec.kernel"):
            out = self._run(mats, dev, plan)
        marks.append(_mark(self.device))
        with tracing.annotate("ec.codec.d2h"):
            res = _readback(out, marks)
        for stage, t0, t1 in zip(("h2d", "kernel", "d2h"), marks, marks[1:]):
            seconds = (t1 - t0 if isinstance(t0, float)
                       else t0.elapsed_time(t1) / 1e3)
            metrics.histogram_observe("ec_codec_call_stage_seconds", seconds,
                                      {"stage": stage, "backend": self.name})
        return res

    def coded_matmul_stream(self, coef: np.ndarray, blocks,
                            depth: int = 2):
        """Streaming pipeline: for each (k, w) uint8 column block from the
        iterable `blocks`, yield the matching (m, w) result, in order,
        with up to `depth` blocks in flight.

          caller thread   pread   next(blocks)
          upload thread   pin     stage into a pinned ring slot, and
                                  allocate the block's device input,
                                  output and pinned read-back (GPU)
                          h2d     copy to the device on the copy stream;
                                  then enqueue the kernel and the
                                  read-back
          drain thread    kernel  wait for the read-back, time each
                          d2h     device stage from its CUDA events

        `relay` is the time a finished block waited for the consumer, so
        pread+pin+h2d+kernel+d2h+relay accounts for the whole feed.
        """
        coef = np.asarray(coef, dtype=np.uint8)
        # streams are bulk: decide scheduled-vs-dense once at slab size
        plan = self._plan_for(coef, coef.shape[1] * self.slab)
        run = functools.partial(self._run, self._coef_mats(coef),
                                plan=plan)
        yield from self._stream(run, coef.shape[0], blocks, depth,
                                self.name)

    def transfer_stream(self, m: int, blocks, depth: int = 2):
        """The feed of coded_matmul_stream with the product replaced by
        a copy of each block's first `m` rows on the compute stream: the
        same pinned ring, streams and events, so the same bytes cross
        the link both ways. Stages are recorded under backend
        `<name>-ceiling`."""
        def copy_rows(dev, out):
            out.copy_(dev[:m])

        yield from self._stream(copy_rows, m, blocks, depth,
                                self.name + "-ceiling")

    def _stream(self, run, m: int, blocks, depth: int, backend: str):
        lane = DeviceLane(self.device, depth, self.stream)
        whole = (slice(None), slice(None))

        def upload(block):
            block = np.asarray(block, dtype=np.uint8)
            if block.shape[1] == 0:
                # an empty result still rides the queue: yielding it
                # directly would reorder it ahead of pending blocks
                return block.shape[1], []
            blk = lane.upload([block], [((m, block.shape[1]), torch.uint8)])
            lane.compute(blk, lambda x, out: run(x, out=out))
            lane.finish(blk)
            return block.shape[1], [(lane, whole, blk)]

        def drain(up_fut):
            n, parts = up_fut.result()
            return gather_lanes(parts, (m, n), backend), _time.perf_counter()

        yield from staged_feed(blocks, upload, drain, depth, backend)


def staged_feed(blocks, upload, drain, depth: int, backend: str):
    """The staged pipeline's skeleton, shared by every feed of the port
    (codec streams, the mesh codec, models/ec_pipeline): the caller
    thread reads the next block (`pread`, timed around the caller's
    iterator), an upload thread runs `upload(block)`, a drain thread
    `drain(future of upload)` -> (result, finish time), and at most
    `depth` blocks are in flight. `relay` is the time a finished result
    waited for the consumer. Yields the results in input order."""
    up_ex = ThreadPoolExecutor(1, thread_name_prefix="ec-h2d")
    down_ex = ThreadPoolExecutor(1, thread_name_prefix="ec-d2h")
    pending: deque = deque()

    def finish(fut):
        result, t_done = fut.result()
        observe_stage(backend, "relay", _time.perf_counter() - t_done)
        return result

    it = iter(blocks)
    try:
        while True:
            t0 = _time.perf_counter()
            try:
                block = next(it)
            except StopIteration:
                break
            observe_stage(backend, "pread", _time.perf_counter() - t0)
            pending.append(down_ex.submit(drain, up_ex.submit(upload,
                                                              block)))
            while len(pending) >= max(1, int(depth)):
                yield finish(pending.popleft())
        while pending:
            yield finish(pending.popleft())
    finally:
        # bounded: at most `depth` blocks in flight, and upload tasks
        # never wait on drain tasks, so this cannot hang
        up_ex.shutdown(wait=True, cancel_futures=True)
        down_ex.shutdown(wait=True, cancel_futures=True)


def observe_stages(backend: str, stages: dict[str, float]) -> None:
    for stage, seconds in stages.items():
        observe_stage(backend, stage, seconds)


def merge_stages(per_device: list[dict[str, float]]) -> dict[str, float]:
    """One block's stages over several devices: the host's staging
    (`pin`) runs device after device on the upload thread, so it adds up;
    the device stages run side by side, so the slowest device's counts."""
    out: dict[str, float] = {}
    for stages in per_device:
        for stage, seconds in stages.items():
            out[stage] = (out.get(stage, 0.0) + seconds if stage == "pin"
                          else max(out.get(stage, 0.0), seconds))
    return out


def gather_lanes(parts: list, shape: tuple[int, ...], backend: str
                 ) -> np.ndarray:
    """Wait for one block's pieces, parts = [(lane, index, block)], and
    gather each piece's first output into one host array of `shape` at
    its index (a single piece that covers the array is returned as it
    is). Observes the block's merged stages under `backend`, the host
    gather counted into `d2h`."""
    results = [(idx,) + lane.wait(blk) for lane, idx, blk in parts]
    t0 = _time.perf_counter()
    if len(results) == 1 and results[0][1][0].shape == tuple(shape):
        out = results[0][1][0]
    else:
        out = np.empty(shape, dtype=np.uint8)
        for idx, (arr, *_), _ in results:
            out[idx] = arr
    stages = merge_stages([st for _, _, st in results])
    if results:
        stages["d2h"] += _time.perf_counter() - t0
    observe_stages(backend, stages)
    return out


class _Block:
    """One block's state on one lane: device inputs and outputs, the
    pinned read-back buffers and the stage events (GPU), or the stage
    seconds measured on the host clock (CPU)."""

    def __init__(self, dev: list, out: list, host: list | None = None,
                 events: list | None = None):
        self.dev, self.out, self.host, self.events = dev, out, host, events
        self.stages: dict[str, float] = {}


class DeviceLane:
    """One device's share of a staged feed.

    On a GPU: a ring of `depth` pinned host staging buffers, an upload
    stream, the compute stream and a read-back stream, ordered by CUDA
    events, each device stage timed by its events:

      upload   pin     stage the inputs into the next pinned ring slot
                       (the slot is refilled only after the event of its
                       previous upload fired), and allocate the device
                       inputs, outputs and pinned read-back buffers
               h2d     copy the inputs to the device, non-blocking
      compute  kernel  the caller's function on the compute stream,
                       after the upload's event
      finish   d2h     read every output back into pinned memory

    Device tensors used on another stream than the one that allocated
    them are marked with record_stream. On the CPU the same calls make
    no copies and time `h2d` (wrapping the inputs), `kernel` and `d2h`
    (the numpy views) on the host clock. upload, compute and finish of a
    block run on one thread (a feed's upload thread); wait may run on
    another. Between compute and finish the caller may enqueue more work
    on the compute stream (a collective over several lanes), which the
    kernel stage then includes."""

    def __init__(self, device: torch.device, depth: int,
                 compute_stream: "torch.cuda.Stream | None" = None):
        self.device = device
        self.cuda = device.type == "cuda"
        self.compute_stream = compute_stream
        if self.cuda:
            self.copy_stream = torch.cuda.Stream(device)
            if compute_stream is None:
                self.compute_stream = torch.cuda.Stream(device)
            self.d2h_stream = torch.cuda.Stream(device)
        depth = max(1, int(depth))
        self.ring: list[torch.Tensor | None] = [None] * depth
        self.ring_free: list[torch.cuda.Event | None] = [None] * depth
        self.next_slot = 0

    def upload(self, arrays: list[np.ndarray],
               out_specs: list[tuple[tuple, torch.dtype]]) -> _Block:
        """Stage uint8 `arrays` onto the device and allocate outputs of
        the given (shape, dtype)."""
        t0 = _time.perf_counter()
        if not self.cuda:
            blk = _Block([host_tensor(a) for a in arrays],
                         [torch.empty(s, dtype=d) for s, d in out_specs])
            blk.stages["h2d"] = _time.perf_counter() - t0
            return blk
        slot = self.next_slot
        self.next_slot = (slot + 1) % len(self.ring)
        if self.ring_free[slot] is not None:
            # the slot's previous upload must have left the buffer
            self.ring_free[slot].synchronize()
        total = sum(a.nbytes for a in arrays)
        buf = self.ring[slot]
        if buf is None or buf.numel() < total:
            buf = torch.empty(total, dtype=torch.uint8, pin_memory=True)
            self.ring[slot] = buf
        staged, off = [], 0
        for a in arrays:
            view = buf[off:off + a.nbytes].view(a.shape)
            np.copyto(view.numpy(), a)
            staged.append(view)
            off += a.nbytes
        # every allocation before the first event: a first allocation on
        # a stream can call cudaMalloc, which waits on the device, and
        # inside a stage's events it would be billed to that stage
        with torch.cuda.device(self.device):
            with torch.cuda.stream(self.copy_stream):
                dev = [torch.empty(a.shape, dtype=torch.uint8,
                                   device=self.device) for a in arrays]
            with torch.cuda.stream(self.compute_stream):
                out = [torch.empty(s, dtype=d, device=self.device)
                       for s, d in out_specs]
        host = [torch.empty(s, dtype=d, pin_memory=True)
                for s, d in out_specs]
        pin_s = _time.perf_counter() - t0
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
        with torch.cuda.device(self.device):
            with torch.cuda.stream(self.copy_stream):
                ev[0].record()
                for d, s in zip(dev, staged):
                    d.copy_(s, non_blocking=True)
                ev[1].record()
        self.ring_free[slot] = ev[1]
        blk = _Block(dev, out, host, ev)
        blk.stages["pin"] = pin_s
        return blk

    def compute(self, blk: _Block, fn) -> None:
        """fn(*inputs, *outputs) on the compute stream, after the
        upload."""
        if not self.cuda:
            t0 = _time.perf_counter()
            fn(*blk.dev, *blk.out)
            blk.stages["kernel"] = _time.perf_counter() - t0
            return
        with torch.cuda.device(self.device), \
                torch.cuda.stream(self.compute_stream):
            self.compute_stream.wait_event(blk.events[1])
            for d in blk.dev:
                d.record_stream(self.compute_stream)
            blk.events[2].record()
            fn(*blk.dev, *blk.out)

    def finish(self, blk: _Block) -> None:
        """End the compute stage and read every output back."""
        if not self.cuda:
            return
        ev = blk.events
        with torch.cuda.device(self.device):
            with torch.cuda.stream(self.compute_stream):
                ev[3].record()
            with torch.cuda.stream(self.d2h_stream):
                self.d2h_stream.wait_event(ev[3])
                ev[4].record()
                for h, o in zip(blk.host, blk.out):
                    o.record_stream(self.d2h_stream)
                    h.copy_(o, non_blocking=True)
                ev[5].record()

    def wait(self, blk: _Block) -> tuple[list[np.ndarray], dict]:
        """-> (the outputs as host arrays, the block's stage seconds)."""
        if not self.cuda:
            t0 = _time.perf_counter()
            arrs = [o.numpy() for o in blk.out]
            blk.stages["d2h"] = _time.perf_counter() - t0
            return arrs, blk.stages
        ev = blk.events
        ev[5].synchronize()
        stages = dict(blk.stages)
        stages["h2d"] = ev[0].elapsed_time(ev[1]) / 1e3
        stages["kernel"] = ev[2].elapsed_time(ev[3]) / 1e3
        stages["d2h"] = ev[4].elapsed_time(ev[5]) / 1e3
        # the pinned tensors stay alive as long as the arrays' bases do;
        # the host allocator recycles them only after the copy's event
        # fired
        return [h.numpy() for h in blk.host], stages
