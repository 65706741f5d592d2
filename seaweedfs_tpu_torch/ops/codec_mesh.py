"""Mesh codec: the coded matmul over every local card — the counterpart
of seaweedfs_tpu/ops/codec_mesh.py (`-ec.backend=mesh`).

The (k, n) column block a caller hands any codec backend splits into
vol x col contiguous column pieces, one per mesh device, in the order
the reference lays out its vol segments and their col shards. Encode and
reconstruction are column-local, so there is no collective on this
path. On a CUDA mesh each piece goes through the hand-written kernel
(csrc/coded_matmul.cu via codec_cuda.coded_matmul) on its own card and
its own compute stream; on a CPU mesh through the kernel's plain
version, as CudaCodec(device="cpu") runs it. One CudaCodec per device
holds the packed product tables of that device.

The reference pads each segment's width to a power-of-two bucket
(`_seg_width` / `_to_batched`) only to bound XLA compiles; the kernel
masks its ragged edge, so the port keeps the split and drops the
padding and the trim. `_plan_for` returns None, as CudaCodec's does:
the kernel reads each byte once, and the scheduled XOR program never
applies to it. `_mesh_kernel` and `_mesh_sched_kernel` are the
reference's two XLA programs written as plain torch functions (the
dense float32 bit-plane product, and codec_torch.xor_matmul batched
over vol), held against the reference in the tests.

The stream is the depth-N staged feed of ops/codec_torch.py with one
DeviceLane per card: each block's pieces are scattered into each card's
pinned staging ring and copied with non_blocking=True on that card's
copy stream, the kernel runs on its compute stream, and the drain
gathers the pieces back into one (m, n) block. Stages record
ec_codec_stage_seconds{stage, backend="mesh"}: `pin` summed over cards
(one upload thread stages them in turn), device stages the slowest
card's, `d2h` plus the host gather.
"""
from __future__ import annotations

import contextlib
import functools
import time as _time

import numpy as np
import torch

from ..utils import metrics
from . import bits
from .codec_cuda import CudaCodec
from .codec_torch import (DeviceLane, gather_lanes, host_tensor,
                          staged_feed, xor_matmul)


def _mesh_kernel(a_bits: torch.Tensor, stripes: torch.Tensor
                 ) -> torch.Tensor:
    """(8m, 8k) 0/1 bit-matrix x (vol, k, w) uint8 -> (vol, m, w) uint8,
    the dense bit-plane product accumulated in float32 (exact: a column
    sums at most 8k products)."""
    bits.check_exact_matmul(stripes)
    acc = torch.matmul(a_bits.to(torch.float32), bits.unpack_bits(stripes))
    return bits.pack_bits_uint8(acc.to(torch.int32) & 1)


def _mesh_sched_kernel(program, stripes: torch.Tensor) -> torch.Tensor:
    """Scheduled twin of _mesh_kernel: the CSE-optimized XOR program
    (ops/schedule.Program) over uint8 bit-planes, batched over vol by
    laying the vol segments side by side as columns."""
    vol, k, w = stripes.shape
    flat = stripes.permute(1, 0, 2).reshape(k, vol * w)
    out = xor_matmul(program, flat)
    return out.reshape(out.shape[0], vol, w).permute(1, 0, 2).contiguous()


class MeshCodec:
    """Coded-matmul backend over the local (vol, col) mesh of cards
    (`device="cuda"`, the default: raises without a GPU, or with fewer
    cards than -ec.mesh.devices asks for) or of CPU entries
    (`device="cpu"`, or a CPU mesh passed in)."""

    name = "mesh"

    def __init__(self, mesh=None, device: str | torch.device = "cuda"):
        from ..parallel import mesh as pmesh

        if mesh is None:
            n_devices, col = pmesh.mesh_config()
            mesh = pmesh.make_mesh(n_devices, col, device=device)
        self.mesh = mesh
        self.vol, self.col = (int(x) for x in mesh.devices.shape)
        self.n_devices = int(mesh.devices.size)
        self._codecs = [CudaCodec(device=d) for d in mesh.device_list]
        metrics.gauge_set("ec_mesh_devices", self.n_devices)
        metrics.gauge_set("ec_mesh_vol", self.vol)
        metrics.gauge_set("ec_mesh_col", self.col)

    def describe(self) -> dict:
        from ..parallel import mesh as pmesh

        return pmesh.describe(self.mesh)

    def _plan_for(self, coef: np.ndarray, nbytes: int):
        # every piece runs the kernel, which reads each input byte once
        # and writes each output byte once (CudaCodec._plan_for)
        return None

    def _pieces(self, n: int) -> list[tuple[int, slice]]:
        """(device number, column slice) of every non-empty piece of n
        columns."""
        from ..parallel import mesh as pmesh

        return [(i, cs) for i, cs in
                enumerate(pmesh.column_slices(self.mesh, n))
                if cs.stop > cs.start]

    def coded_matmul(self, coef: np.ndarray, shards) -> np.ndarray:
        coef = np.asarray(coef, dtype=np.uint8)
        m, k = coef.shape
        shards = np.asarray(shards, dtype=np.uint8)
        if shards.ndim != 2 or shards.shape[0] != k:
            raise ValueError(f"shards {shards.shape} do not match coef "
                             f"{coef.shape}")
        n = shards.shape[1]
        out = np.empty((m, n), dtype=np.uint8)
        plan = self._plan_for(coef, shards.nbytes)
        # every piece's upload and launch first, then the read-backs, so
        # the cards compute side by side
        results = []
        for i, cs in self._pieces(n):
            codec = self._codecs[i]
            with _on(codec):
                x = host_tensor(shards[:, cs]).to(codec.device)
                results.append((codec, cs, codec._run(
                    codec._coef_mats(coef), x, plan)))
        for codec, cs, res in results:
            with _on(codec):
                out[:, cs] = res.cpu().numpy()
        return out

    def coded_matmul_stream(self, coef: np.ndarray, blocks,
                            depth: int = 2):
        """Depth-N staged pipeline over the mesh: while the drain thread
        gathers block j-1 from every card, the cards run block j's
        pieces and the upload thread scatters block j+1. Yields (m, w)
        per (k, w) block, in order."""
        coef = np.asarray(coef, dtype=np.uint8)
        m = coef.shape[0]
        # streams are bulk: one scheduled-vs-dense decision up front
        plan = self._plan_for(coef, coef.shape[1] * self.n_devices
                              * (1 << 20))
        runs = [functools.partial(c._run, c._coef_mats(coef), plan=plan)
                for c in self._codecs]
        yield from self._stream(runs, m, blocks, depth, self.name)

    def transfer_stream(self, m: int, blocks, depth: int = 2):
        """The feed of coded_matmul_stream with each card's product
        replaced by a copy of its piece's first `m` rows: the mesh's
        link ceiling for the same traffic. Stages are recorded under
        backend `mesh-ceiling`."""
        def copy_rows(dev, out):
            out.copy_(dev[:m])

        yield from self._stream([copy_rows] * self.n_devices, m, blocks,
                                depth, self.name + "-ceiling")

    def _stream(self, runs, m: int, blocks, depth: int, backend: str):
        lanes = [DeviceLane(c.device, depth, c.stream) for c in self._codecs]

        def upload(block):
            block = np.asarray(block, dtype=np.uint8)
            parts = []
            for i, cs in self._pieces(block.shape[1]):
                lane, run = lanes[i], runs[i]
                blk = lane.upload([block[:, cs]],
                                  [((m, cs.stop - cs.start), torch.uint8)])
                lane.compute(blk, lambda x, o, run=run: run(x, out=o))
                lane.finish(blk)
                parts.append((lane, (slice(None), cs), blk))
            return block.shape[1], parts

        def drain(up_fut):
            n, parts = up_fut.result()
            return gather_lanes(parts, (m, n), backend), _time.perf_counter()

        yield from staged_feed(blocks, upload, drain, depth, backend)


def _on(codec: CudaCodec):
    """The codec's card and compute stream as the current ones (nothing
    for a CPU codec)."""
    stack = contextlib.ExitStack()
    if codec.stream is not None:
        stack.enter_context(torch.cuda.device(codec.device))
        stack.enter_context(torch.cuda.stream(codec.stream))
    return stack
