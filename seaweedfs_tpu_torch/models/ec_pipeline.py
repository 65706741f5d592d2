"""Batched erasure-coding encode + scrub, their host feeds, and the
sharded rebuild — the counterpart of seaweedfs_tpu/models/ec_pipeline.py.

The step takes a (batch, k, cols) uint8 stripe tensor and the parity
bit-matrix, and returns the (batch, m, cols) parity plus the count of
bytes that differ from an expected-parity tensor (zero when clean). It
is the reference's XLA program written as torch ops: the dense float32
bit-plane product of ops/bits.py.

The feeds (`pipelined_encode_stream`, BASELINE config #3, batched encode
of many volumes; `pipelined_scrub`, config #5, cluster scrub) run that
step behind the depth-N staged pipeline of ops/codec_torch.py
(`staged_feed`: pread, pin, h2d, kernel, d2h, relay), one DeviceLane per
device. With `mesh=None` they run on one device; with a parallel.mesh
(vol, col) mesh every block splits over the cards, batch over vol and
columns over col, and each card runs the step on its piece. The scrub's
per-card counts meet in one SUM all-reduce. Uneven batches and widths
split into uneven pieces; nothing is padded.

`sharded_rebuild` spreads the (8k, n) bit rows of the surviving shards
over a 1-D mesh: each device multiplies its column block of the
recovery bit-matrix by its rows (float32 accumulation, cast to int32),
a reduce-scatter along columns sums the partial counts, and `& 1` and
the pack finish each device's column slice. The partial sums stay
integer until the `& 1` (total & 1 == XOR).
"""
from __future__ import annotations

import functools
import time

import numpy as np
import torch

from ..ops import gf256, rs_matrix
from ..ops.bits import check_exact_matmul, pack_bits_uint8, unpack_bits
from ..ops.codec_torch import (DeviceLane, gather_lanes, merge_stages,
                               observe_stages, staged_feed)
from ..parallel import mesh as pmesh
from ..utils.device import DEFAULT_DEVICE, resolve_device

# Stripes per dense product: bounds the float32 bit-plane expansion
# (32 bytes per input byte) to about this many bytes.
_EXPANSION_BYTES = 2 << 30

# the reference's name for the feed skeleton
_staged_feed = staged_feed


def parity_bit_matrix(k: int = 10, m: int = 4) -> np.ndarray:
    """Host-side (8m, 8k) 0/1 matrix for the systematic parity rows."""
    return gf256.expand_to_bits(rs_matrix.parity_rows(k, m))


def _as_device(x, device: torch.device, dtype: torch.dtype
               ) -> torch.Tensor:
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(device=device, dtype=dtype)


def encode_batch(a_bits, stripes,
                 device: str | torch.device = DEFAULT_DEVICE,
                 out: torch.Tensor | None = None) -> torch.Tensor:
    """(batch, k, n) uint8 stripes -> (batch, m, n) uint8 parity on
    `device` (numpy inputs or tensors; tensors elsewhere are moved),
    written into `out` when one is given."""
    dev = resolve_device(device)
    a = _as_device(a_bits, dev, torch.float32)
    x = _as_device(stripes, dev, torch.uint8)
    check_exact_matmul(x)
    b, k, n = x.shape
    per = max(1, _EXPANSION_BYTES // max(1, 32 * k * n))
    if out is None:
        out = torch.empty((b, a.shape[0] // 8, n), dtype=torch.uint8,
                          device=dev)
    for b0 in range(0, b, per):
        acc = torch.matmul(a, unpack_bits(x[b0:b0 + per]))
        out[b0:b0 + per] = pack_bits_uint8(acc.to(torch.int32) & 1)
    return out


def encode_scrub_step(a_bits, stripes, expected_parity,
                      device: str | torch.device = DEFAULT_DEVICE
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Encode parity AND count bytes differing from expected_parity
    (the scrub check). Returns (parity, mismatches) on `device`."""
    dev = resolve_device(device)
    parity = encode_batch(a_bits, stripes, device=dev)
    expected = _as_device(expected_parity, dev, torch.uint8)
    mism = (parity != expected).sum(dtype=torch.int64)
    return parity, mism


def _bit_matrix(a_bits, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a_bits, dtype=np.float32)
                           if isinstance(a_bits, np.ndarray) else a_bits,
                           dtype=torch.float32).to(device)


def jitted_encode(k: int = 10, m: int = 4,
                  device: str | torch.device = DEFAULT_DEVICE):
    """-> (fn, a_bits): fn(a_bits, stripes) is encode_batch bound to
    `device`, a_bits the float32 parity bit-matrix there. (Eager torch
    compiles nothing; the name is the reference's.)"""
    dev = resolve_device(device)
    return (functools.partial(encode_batch, device=dev),
            _bit_matrix(parity_bit_matrix(k, m), dev))


def sharded_encode_scrub(mesh: pmesh.Mesh, k: int = 10, m: int = 4):
    """Encode + scrub over a (vol, col) mesh -> (step, a_bits, place).

    place(arr) puts a (batch, k, cols) array over the mesh (batch over
    vol, columns over col) as a pmesh.Sharded; a_bits is the parity
    bit-matrix replicated on every device; step(a_bits, stripes,
    expected) -> (parity as a Sharded, the int64 mismatch count on the
    first device): each device runs encode_scrub_step on its piece and
    the counts meet in one SUM all-reduce."""
    a_rep = pmesh.replicate(mesh, _bit_matrix(parity_bit_matrix(k, m),
                                              torch.device("cpu")))

    def place(arr) -> pmesh.Sharded:
        return pmesh.shard_stripes(mesh, arr)

    def step(a_bits, stripes, expected):
        if not isinstance(stripes, pmesh.Sharded):
            stripes = place(stripes)
        if not isinstance(expected, pmesh.Sharded):
            expected = place(expected)
        parity, counts = [], []
        for a, (s, idx), (e, _) in zip(a_bits, stripes.pieces,
                                       expected.pieces):
            p, c = encode_scrub_step(a, s, e, device=s.device)
            parity.append((p, idx))
            counts.append(c)
        pmesh.all_reduce_sum(counts)
        shape = (stripes.shape[0], a_bits[0].shape[0] // 8,
                 stripes.shape[2])
        return pmesh.Sharded(parity, shape, torch.uint8), counts[0]

    return step, a_rep, place


# ---------------------------------------------------------------------
# Host-feed pipelines (BASELINE configs #3 and #5)
# ---------------------------------------------------------------------

def _feed_lanes(mesh, device, depth: int, k: int, m: int):
    """(lanes, a_bits per lane, slicer): one DeviceLane per device and
    a function giving each lane's (batch slice, column slice) of a
    (batch, k, cols) block."""
    if mesh is None:
        devices = [resolve_device(device)]

        def slicer(shape):
            return [(slice(None), slice(None))]
    else:
        devices = mesh.device_list

        def slicer(shape):
            return pmesh.stripe_slices(mesh, shape[0], shape[2])
    lanes = [DeviceLane(dev, depth) for dev in devices]
    a = parity_bit_matrix(k, m)
    return lanes, [_bit_matrix(a, dev) for dev in devices], slicer


def pipelined_encode_stream(stripe_blocks, k: int = 10, m: int = 4,
                            depth: int = 2, mesh=None,
                            device: str | torch.device = DEFAULT_DEVICE):
    """Batched-encode feed (config #3: 64 x 1 GB volumes). `stripe_blocks`
    yields (B, k, n) uint8 host arrays; yields (B, m, n) np.uint8 parity
    blocks in order, byte-equal to encode_batch on the same input.

    With `mesh` (a parallel.mesh (vol, col) mesh) each block is split
    over the mesh, batch over vol and columns over col, each card encodes
    its piece, and the drain gathers the pieces back into the caller's
    shape, so uneven volume tails ride the mesh unchanged. Without, it
    runs on `device`."""
    lanes, a_bits, slicer = _feed_lanes(mesh, device, depth, k, m)
    backend = "ec_pipeline" if mesh is None else "ec_pipeline_mesh"

    def encode(a, dev):
        return lambda x, out: encode_batch(a, x, device=dev, out=out)

    def upload(block):
        block = np.asarray(block, dtype=np.uint8)
        parts = []
        for lane, a, (bs, cs) in zip(lanes, a_bits, slicer(block.shape)):
            piece = block[bs, :, cs]
            blk = lane.upload([piece], [((piece.shape[0], m, piece.shape[2]),
                                         torch.uint8)])
            lane.compute(blk, encode(a, lane.device))
            lane.finish(blk)
            parts.append((lane, (bs, slice(None), cs), blk))
        return (block.shape[0], m, block.shape[2]), parts

    def drain(up_fut):
        shape, parts = up_fut.result()
        return gather_lanes(parts, shape, backend), time.perf_counter()

    yield from _staged_feed(stripe_blocks, upload, drain, depth, backend)


def pipelined_scrub(pair_blocks, k: int = 10, m: int = 4,
                    depth: int = 2, mesh=None,
                    device: str | torch.device = DEFAULT_DEVICE
                    ) -> tuple[int, int]:
    """Cluster-scrub feed (config #5: RS parity verify over a volume
    fleet). `pair_blocks` yields (stripes, expected_parity) uint8 host
    pairs; returns (total_mismatched_bytes, n_blocks). Only the int64
    scrub count crosses back over the link per block.

    With `mesh`, both arrays of each pair split over the mesh as in
    pipelined_encode_stream; each card counts its piece's mismatches and
    the counts meet in one SUM all-reduce on the compute streams."""
    lanes, a_bits, slicer = _feed_lanes(mesh, device, depth, k, m)
    backend = "ec_scrub" if mesh is None else "ec_scrub_mesh"

    def scrub(a, dev):
        def run(s, e, out):
            out.copy_(encode_scrub_step(a, s, e, device=dev)[1])
        return run

    def upload(pair):
        stripes, expected = (np.asarray(x, dtype=np.uint8) for x in pair)
        blks = []
        for lane, a, (bs, cs) in zip(lanes, a_bits,
                                     slicer(stripes.shape)):
            blk = lane.upload([stripes[bs, :, cs], expected[bs, :, cs]],
                              [((), torch.int64)])
            lane.compute(blk, scrub(a, lane.device))
            blks.append(blk)
        if mesh is not None:
            pmesh.all_reduce_sum([b.out[0] for b in blks],
                                 streams=[lane.compute_stream
                                          for lane in lanes]
                                 if lanes[0].cuda else None)
        for lane, blk in zip(lanes, blks):
            lane.finish(blk)
        return list(zip(lanes, blks))

    def drain(up_fut):
        results = [lane.wait(blk) for lane, blk in up_fut.result()]
        observe_stages(backend, merge_stages([st for _, st in results]))
        return int(results[0][0][0]), time.perf_counter()

    total = 0
    n = 0
    for val in _staged_feed(pair_blocks, upload, drain, depth, backend):
        total += val
        n += 1
    return total, n


# ---------------------------------------------------------------------
# Sharded rebuild
# ---------------------------------------------------------------------

def rebuild_mesh(n_devices: int | None = None,
                 device: str | torch.device = DEFAULT_DEVICE) -> pmesh.Mesh:
    """1-D mesh over the `shard` axis: device i holds bit rows
    i*8k/d .. (i+1)*8k/d of the surviving shards — the layout that
    mirrors storage reality, where each shard lives on a different
    server or card."""
    return pmesh.Mesh(pmesh.device_grid(n_devices, device),
                      (pmesh.SHARD_AXIS,))


class ShardedRebuild:
    """The sharded rebuild's step, rebuild(a_bits, shards) -> the rebuilt
    (m', n) bytes as a pmesh.Sharded, column-sliced over the mesh. Its
    two halves are callable apart (the card times them apart):

      place(shards)             each device's shard rows, on the device
      partials(a_bits, shards)  device i: a_bits[:, rows_i] (float32) @
                                its (8k/d, n) bit rows -> int32 counts
      reduce(partials)          reduce-scatter of the counts along
                                columns, then & 1 and the pack
    """

    def __init__(self, mesh: pmesh.Mesh, k: int):
        self.mesh = mesh
        self.k = k
        self.d = int(mesh.devices.size)
        # granularity is BIT rows: the (8k, n) expansion shards over
        # devices, so 8k (80 for RS(10,4)) must divide — device
        # boundaries may cut across a byte's bit-planes, which is fine
        # because the product contracts all of them
        assert (8 * k) % self.d == 0, f"{8 * k} bit rows over {self.d} devices"

    def _rows(self, i: int) -> tuple[int, int]:
        """Bit rows [r0, r1) of device i."""
        rows = 8 * self.k // self.d
        return i * rows, (i + 1) * rows

    def place(self, shards) -> list[torch.Tensor]:
        """Each device's share of the (k, n) shards: the shard rows its
        bit rows come from, on the device."""
        if isinstance(shards, np.ndarray):
            shards = torch.from_numpy(np.require(shards, np.uint8, ["C", "W"]))
        assert shards.shape[0] == self.k, tuple(shards.shape)
        n = shards.shape[1]
        assert n % (8 * self.d) == 0, f"{n} columns over 8 x {self.d}"
        out = []
        for i, dev in enumerate(self.mesh.device_list):
            r0, r1 = self._rows(i)
            out.append(shards[r0 // 8:-(-r1 // 8)].to(dev))
        return out

    def partials(self, a_bits, shards) -> list[torch.Tensor]:
        """`shards`: the (k, n) shards, or their place()d shares."""
        local = shards if isinstance(shards, list) else self.place(shards)
        out = []
        for i, rows in enumerate(local):
            r0, r1 = self._rows(i)
            check_exact_matmul(rows)
            bits = unpack_bits(rows)[r0 - 8 * (r0 // 8):r1 - 8 * (r0 // 8)]
            a = _bit_matrix(a_bits, rows.device)[:, r0:r1]
            out.append(torch.matmul(a, bits).to(torch.int32))
        return out

    def reduce(self, partials: list[torch.Tensor]) -> pmesh.Sharded:
        rows, n = partials[0].shape
        per = n // self.d
        # chunk i of each input's memory is column block i
        ins = [p.view(rows, self.d, per).transpose(0, 1).contiguous()
               for p in partials]
        outs = [torch.empty((rows, per), dtype=torch.int32, device=p.device)
                for p in partials]
        pmesh.reduce_scatter_sum(ins, outs)
        pieces = [(pack_bits_uint8(o & 1), (slice(None),
                                            slice(i * per, (i + 1) * per)))
                  for i, o in enumerate(outs)]
        return pmesh.Sharded(pieces, (rows // 8, n), torch.uint8)

    def __call__(self, a_bits, shards) -> pmesh.Sharded:
        return self.reduce(self.partials(a_bits, shards))


def sharded_rebuild(mesh: pmesh.Mesh, k: int = 10, m: int = 4,
                    present: list[int] | None = None,
                    missing: list[int] | None = None):
    """Distributed reconstruction with shard rows spread across the mesh
    -> (rebuild, a_bits, coef): rebuild(a_bits, shards) takes the (k, n)
    uint8 surviving shards (n divisible by 8 x the mesh size) and
    returns the (len(missing), n) rebuilt bytes, column-sharded;
    a_bits is the (8m', 8k) recovery bit-matrix, coef its GF(256)
    rows."""
    if present is None or missing is None:
        missing = list(range(m))
        present = list(range(m, k + m))[:k]
    coef, _ = rs_matrix.recovery_rows(k, len(missing), present, missing)
    a_bits = gf256.expand_to_bits(coef)      # (8m', 8k)
    return ShardedRebuild(mesh, k), a_bits, coef
