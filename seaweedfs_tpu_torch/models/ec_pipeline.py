"""Batched erasure-coding encode + scrub on one device — the counterpart
of seaweedfs_tpu/models/ec_pipeline.py:26-48.

The step takes a (batch, k, cols) uint8 stripe tensor and the parity
bit-matrix, and returns the (batch, m, cols) parity plus the count of
bytes that differ from an expected-parity tensor (zero when clean).
It is the reference's XLA program written as torch ops: the dense
float32 bit-plane product of ops/bits.py. The sharded (mesh) variants
wait for a later slice.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops import gf256, rs_matrix
from ..ops.bits import check_exact_matmul, pack_bits_uint8, unpack_bits
from ..utils.device import DEFAULT_DEVICE, resolve_device

# Stripes per dense product: bounds the float32 bit-plane expansion
# (32 bytes per input byte) to about this many bytes.
_EXPANSION_BYTES = 2 << 30


def parity_bit_matrix(k: int = 10, m: int = 4) -> np.ndarray:
    """Host-side (8m, 8k) 0/1 matrix for the systematic parity rows."""
    return gf256.expand_to_bits(rs_matrix.parity_rows(k, m))


def _as_device(x, device: torch.device, dtype: torch.dtype
               ) -> torch.Tensor:
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(device=device, dtype=dtype)


def encode_batch(a_bits, stripes,
                 device: str | torch.device = DEFAULT_DEVICE
                 ) -> torch.Tensor:
    """(batch, k, n) uint8 stripes -> (batch, m, n) uint8 parity on
    `device` (numpy inputs or tensors; tensors elsewhere are moved)."""
    dev = resolve_device(device)
    a = _as_device(a_bits, dev, torch.float32)
    x = _as_device(stripes, dev, torch.uint8)
    check_exact_matmul(x)
    b, k, n = x.shape
    per = max(1, _EXPANSION_BYTES // max(1, 32 * k * n))
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
