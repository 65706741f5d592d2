"""Torch bit-plane pack/unpack and the dense GF(2) coded matmul — the
counterpart of seaweedfs_tpu/ops/bits.py.

Every dense torch path (codec_torch, models.ec_pipeline) uses these
functions, so the bit order cannot drift between them: bit s of byte b
lands at plane-row 8*i+s for shard-row i (bit-minor), matching
gf256.expand_to_bits.

The product runs in float32. Sums of 0/1 products reach 8k terms (80
for RS(10,4), 224 for RS(28,4)); float32 holds every one of them
exactly, while a bf16 result (what torch.matmul returns for bf16
inputs) is exact only up to 256. TF32 must stay off for the CUDA
matmul: codec_torch.TorchCodec sets it off and coded_matmul_bits
refuses to run with it on.
"""
from __future__ import annotations

import torch


def unpack_bits(x: torch.Tensor, dtype: torch.dtype = torch.float32
                ) -> torch.Tensor:
    """(..., k, n) uint8 -> (..., 8k, n) 0/1 bit-planes of `dtype`."""
    shifts = torch.arange(8, dtype=torch.uint8, device=x.device)
    bits = (x.unsqueeze(-2) >> shifts[:, None]) & 1
    shape = x.shape[:-2] + (x.shape[-2] * 8, x.shape[-1])
    return bits.reshape(shape).to(dtype)


def pack_bits_uint8(bits: torch.Tensor) -> torch.Tensor:
    """(..., 8m, n) integer 0/1 -> (..., m, n) uint8."""
    m8, n = bits.shape[-2], bits.shape[-1]
    b = bits.reshape(bits.shape[:-2] + (m8 // 8, 8, n)).to(torch.uint8)
    w = (1 << torch.arange(8, dtype=torch.uint8, device=bits.device))
    return (b * w[:, None]).sum(dim=-2, dtype=torch.uint8)


def check_exact_matmul(t: torch.Tensor) -> None:
    """Raise when a float32 CUDA matmul would run in TF32."""
    if t.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "torch.backends.cuda.matmul.allow_tf32 is True; the dense "
            "GF(2) product is specified in full float32")


def coded_matmul_bits(a_bits: torch.Tensor, shards: torch.Tensor
                      ) -> torch.Tensor:
    """The dense codec op: (8m, 8k) float32 0/1 bit-matrix x (k, n)
    uint8 shards -> (m, n) uint8, the GF(256) coded matmul as a GF(2)
    matmul accumulated in float32."""
    check_exact_matmul(shards)
    acc = torch.matmul(a_bits.to(torch.float32), unpack_bits(shards))
    return pack_bits_uint8(acc.to(torch.int32) & 1)
