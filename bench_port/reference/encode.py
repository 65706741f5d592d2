"""Plain PyTorch reference of a seal: SeaweedFS's stripe layout and the
GF(256) coded matmul, on whatever device the tensors are on.

The layout follows encodeDatFile (weed/storage/erasure_coding/
ec_encoder.go): while more than k large blocks remain, a row of k large
blocks; then rows of k small blocks, the last one zero-padded. Data
shard i holds block i of every row, in row order. The product is one
table lookup per (parity row, data shard, byte) and an XOR: no bit
planes, no kernels, nothing of the program.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from . import gf256

# Columns per step of the product: bounds the int64 index copy to
# k * 8 bytes per column.
STEP_COLS = 1 << 24


@functools.cache
def _mul_table() -> np.ndarray:
    return gf256.mul_table()


def row_layout(dat_size: int, large: int, small: int, k: int
               ) -> tuple[int, int]:
    """(large rows, small rows) of a .dat of `dat_size` bytes."""
    n_large = max(0, -(-dat_size // (k * large)) - 1)
    rest = dat_size - n_large * k * large
    return n_large, -(-rest // (k * small))


def shard_bytes(dat_size: int, large: int, small: int, k: int) -> int:
    n_large, n_small = row_layout(dat_size, large, small, k)
    return n_large * large + n_small * small


def data_shards(dat: torch.Tensor, k: int, large: int, small: int
                ) -> torch.Tensor:
    """1-D uint8 .dat bytes -> (k, shard bytes) data shards."""
    n_large, n_small = row_layout(dat.numel(), large, small, k)
    big = n_large * k * large
    parts = []
    if n_large:
        parts.append(dat[:big].view(n_large, k, large).transpose(0, 1)
                     .reshape(k, n_large * large))
    if n_small:
        rest = torch.zeros(n_small * k * small, dtype=torch.uint8,
                           device=dat.device)
        rest[:dat.numel() - big] = dat[big:]
        parts.append(rest.view(n_small, k, small).transpose(0, 1)
                     .reshape(k, n_small * small))
    if not parts:
        return torch.zeros((k, 0), dtype=torch.uint8, device=dat.device)
    return torch.cat(parts, dim=1) if len(parts) > 1 else parts[0]


def coded_matmul(coef: np.ndarray, x: torch.Tensor) -> torch.Tensor:
    """(m, k) uint8 coefficients x (k, n) uint8 -> (m, n) uint8,
    out[i] = XOR_j coef[i, j] * x[j] over GF(256)."""
    coef = np.asarray(coef, dtype=np.uint8)
    m, k = coef.shape
    if x.dim() != 2 or x.shape[0] != k:
        raise ValueError(f"x {tuple(x.shape)} does not match coef {coef.shape}")
    tables = torch.from_numpy(_mul_table()[coef]).to(x.device)  # (m, k, 256)
    n = x.shape[1]
    out = torch.empty((m, n), dtype=torch.uint8, device=x.device)
    for c0 in range(0, n, STEP_COLS):
        idx = x[:, c0:c0 + STEP_COLS].long()
        for i in range(m):
            acc = tables[i, 0][idx[0]]
            for j in range(1, k):
                acc ^= tables[i, j][idx[j]]
            out[i, c0:c0 + STEP_COLS] = acc
    return out

