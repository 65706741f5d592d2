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
(BITMAT_CACHE_MAX), and the depth-N staged `coded_matmul_stream` with the
ec_codec_stage_seconds{stage,backend} stages pread, h2d, kernel, d2h and
relay, plus `pin` on a GPU: the host copy into pinned staging, which the
JAX feed did not have. What it drops: the power-of-two column padding
(`_pad_width`), which only bounded XLA recompiles — eager PyTorch
compiles nothing, so blocks go to the device at their true width and
nothing is sliced off; and the measured XOR-schedule chooser, which a
later slice ports.

On a CUDA device the stream stages every block through a ring of `depth`
pinned host buffers (a pageable `np.memmap` slice would make the copy
synchronous), uploads on its own copy stream, runs the kernel on a
compute stream that waits on the upload's event, and reads back on a
third stream into pinned memory. A ring slot is refilled only after the
event of its previous upload has fired; device tensors used on another
stream than the one that allocated them are marked with record_stream.
Device stages are timed with CUDA events, not the host clock.
"""
from __future__ import annotations

import threading
import time as _time
from collections import OrderedDict, deque
from concurrent.futures import Future, ThreadPoolExecutor

import numpy as np
import torch

from . import bits, gf256
from ..utils import metrics
from ..utils.device import DEFAULT_DEVICE, resolve_device

# Columns per dense product: 2 Mi columns x 8k bit-rows of float32 is
# 640 MiB of intermediate at RS(10,4).
DEFAULT_SLAB = 1 << 21


def observe_stage(backend: str, stage: str, seconds: float) -> None:
    """Per-stage feed timing (pread/pin/h2d/kernel/d2h/relay), one histogram
    per (stage, backend)."""
    metrics.histogram_observe("ec_codec_stage_seconds", seconds,
                              {"stage": stage, "backend": backend})


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
        if self.device.type == "cuda":
            # the dense product is specified in full float32 (bits.py)
            torch.backends.cuda.matmul.allow_tf32 = False

    # -- per-backend operands and kernel (CudaCodec overrides both) ----
    def _make_mats(self, coef: np.ndarray) -> torch.Tensor:
        """Coefficient bytes -> the (8m, 8k) float32 bit-matrix."""
        a = gf256.expand_to_bits(coef).astype(np.float32)
        return torch.from_numpy(a).to(self.device)

    def _kernel(self, mats: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """One (k, w) device slab -> (m, w) device result."""
        return bits.coded_matmul_bits(mats, x)

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

    def _run(self, mats: torch.Tensor, dev: torch.Tensor) -> torch.Tensor:
        """The kernel over one on-device (k, n) block, slab by slab.
        Slabs are column views of `dev` (row stride n, no copy); no
        padding, since eager torch has no compiled shapes to bound."""
        n = dev.shape[1]
        if n <= self.slab:
            return self._kernel(mats, dev)
        return torch.cat([self._kernel(mats, dev[:, off:off + self.slab])
                          for off in range(0, n, self.slab)], dim=1)

    def coded_matmul(self, coef: np.ndarray, shards) -> np.ndarray:
        coef = np.asarray(coef, dtype=np.uint8)
        m, k = coef.shape
        shards = np.asarray(shards, dtype=np.uint8)
        if shards.ndim != 2 or shards.shape[0] != k:
            raise ValueError(f"shards {shards.shape} do not match coef "
                             f"{coef.shape}")
        if shards.shape[1] == 0:
            return np.zeros((m, 0), dtype=np.uint8)
        mats = self._coef_mats(coef)
        out = self._run(mats, host_tensor(shards).to(self.device))
        return out.cpu().numpy()

    def coded_matmul_stream(self, coef: np.ndarray, blocks,
                            depth: int = 2):
        """Streaming pipeline: for each (k, w) uint8 column block from the
        iterable `blocks`, yield the matching (m, w) result, in order,
        with up to `depth` blocks in flight.

          caller thread   pread   next(blocks)
          upload thread   pin     stage into a pinned ring slot (GPU)
                          h2d     copy to the device on the copy stream;
                                  then enqueue the kernel and the
                                  read-back
          drain thread    kernel  wait for the read-back, time each
                          d2h     device stage from its CUDA events

        `relay` is the time a finished block waited for the consumer, so
        pread+pin+h2d+kernel+d2h+relay accounts for the whole feed.
        """
        coef = np.asarray(coef, dtype=np.uint8)
        m = coef.shape[0]
        depth = max(1, int(depth))
        backend = self.name
        feed_cls = _CudaFeed if self.device.type == "cuda" else _HostFeed
        feed = feed_cls(self, self._coef_mats(coef), m, depth)

        up_ex = ThreadPoolExecutor(1, thread_name_prefix="ec-h2d")
        down_ex = ThreadPoolExecutor(1, thread_name_prefix="ec-d2h")

        def drain(up_fut):
            return feed.drain(up_fut.result())

        def finish(fut) -> np.ndarray:
            arr, t_done = fut.result()
            relay = _time.perf_counter() - t_done
            if relay > 0:
                observe_stage(backend, "relay", relay)
            return arr

        try:
            pending: deque = deque()
            it = iter(blocks)
            while True:
                t0 = _time.perf_counter()
                try:
                    block = next(it)
                except StopIteration:
                    break
                observe_stage(backend, "pread", _time.perf_counter() - t0)
                block = np.asarray(block, dtype=np.uint8)
                if block.shape[1] == 0:
                    # an empty result still rides the queue: yielding it
                    # directly would reorder it ahead of pending blocks
                    f: Future = Future()
                    f.set_result((np.zeros((m, 0), dtype=np.uint8),
                                  _time.perf_counter()))
                    pending.append(f)
                else:
                    up = up_ex.submit(feed.upload, block)
                    pending.append(down_ex.submit(drain, up))
                while len(pending) >= depth:
                    yield finish(pending.popleft())
            while pending:
                yield finish(pending.popleft())
        finally:
            # bounded: at most `depth` blocks in flight, and upload tasks
            # never wait on drain tasks, so this cannot hang
            up_ex.shutdown(wait=True, cancel_futures=True)
            down_ex.shutdown(wait=True, cancel_futures=True)


class _HostFeed:
    """The stream's stages on the CPU: no copies, no streams; each stage
    is timed on the host clock."""

    def __init__(self, codec: TorchCodec, mats, m: int, depth: int):
        self.codec, self.mats = codec, mats

    def upload(self, block: np.ndarray):
        t0 = _time.perf_counter()
        x = host_tensor(block)
        t1 = _time.perf_counter()
        out = self.codec._run(self.mats, x)
        t2 = _time.perf_counter()
        observe_stage(self.codec.name, "h2d", t1 - t0)
        return out, t2 - t1

    def drain(self, handle):
        out, kernel_s = handle
        t0 = _time.perf_counter()
        arr = out.numpy()
        t1 = _time.perf_counter()
        observe_stage(self.codec.name, "kernel", kernel_s)
        observe_stage(self.codec.name, "d2h", t1 - t0)
        return arr, t1


class _CudaFeed:
    """The stream's stages on a GPU: a ring of `depth` pinned staging
    buffers, and three streams (upload, compute, read-back) ordered by
    CUDA events."""

    def __init__(self, codec: TorchCodec, mats, m: int, depth: int):
        self.codec, self.mats, self.m = codec, mats, m
        dev = codec.device
        self.copy_stream = torch.cuda.Stream(dev)
        self.compute_stream = torch.cuda.Stream(dev)
        self.d2h_stream = torch.cuda.Stream(dev)
        self.ring: list[torch.Tensor | None] = [None] * depth
        self.ring_free: list[torch.cuda.Event | None] = [None] * depth
        self.next_slot = 0

    def upload(self, block: np.ndarray):
        """Runs on the upload thread only, one block at a time."""
        codec = self.codec
        t0 = _time.perf_counter()
        slot = self.next_slot
        self.next_slot = (slot + 1) % len(self.ring)
        if self.ring_free[slot] is not None:
            # the slot's previous upload must have left the buffer
            self.ring_free[slot].synchronize()
        k, w = block.shape
        buf = self.ring[slot]
        if buf is None or buf.numel() < block.nbytes:
            buf = torch.empty(block.nbytes, dtype=torch.uint8,
                              pin_memory=True)
            self.ring[slot] = buf
        staged = buf[:block.nbytes].view(k, w)
        np.copyto(staged.numpy(), block)
        host_s = _time.perf_counter() - t0
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
        with torch.cuda.device(codec.device):
            with torch.cuda.stream(self.copy_stream):
                ev[0].record()
                dev = torch.empty((k, w), dtype=torch.uint8,
                                  device=codec.device)
                dev.copy_(staged, non_blocking=True)
                ev[1].record()
            self.ring_free[slot] = ev[1]
            with torch.cuda.stream(self.compute_stream):
                self.compute_stream.wait_event(ev[1])
                dev.record_stream(self.compute_stream)
                ev[2].record()
                out = codec._run(self.mats, dev)
                ev[3].record()
            host_out = torch.empty((self.m, w), dtype=torch.uint8,
                                   pin_memory=True)
            with torch.cuda.stream(self.d2h_stream):
                self.d2h_stream.wait_event(ev[3])
                out.record_stream(self.d2h_stream)
                ev[4].record()
                host_out.copy_(out, non_blocking=True)
                ev[5].record()
        return host_out, host_s, ev

    def drain(self, handle):
        host_out, host_s, ev = handle
        ev[5].synchronize()
        name = self.codec.name
        observe_stage(name, "pin", host_s)
        observe_stage(name, "h2d", ev[0].elapsed_time(ev[1]) / 1e3)
        observe_stage(name, "kernel", ev[2].elapsed_time(ev[3]) / 1e3)
        observe_stage(name, "d2h", ev[4].elapsed_time(ev[5]) / 1e3)
        # the pinned tensor stays alive as long as the array's base does;
        # the host allocator recycles it only after the copy's event fired
        return host_out.numpy(), _time.perf_counter()
