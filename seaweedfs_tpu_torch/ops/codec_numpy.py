"""CPU reference codec: GF(256) coded matmul via 64KB product-table gathers.

This is the correctness baseline (and the AVX2-klauspost stand-in for
benchmarks) that the device backends must match bit-for-bit. Mirrors what
the reference's CPU codec does per stripe (weed/storage/
erasure_coding/ec_encoder.go:166-196 `encodeDataOneBatch` -> enc.Encode).
"""
from __future__ import annotations

import numpy as np

from . import gf256


def coded_matmul(coef: np.ndarray, shards: np.ndarray) -> np.ndarray:
    """out[i] = XOR_j coef[i,j] * shards[j]   (GF(256), byte-wise).

    coef: (m, k) uint8; shards: (k, n) uint8 -> (m, n) uint8.
    """
    coef = np.asarray(coef, dtype=np.uint8)
    shards = np.asarray(shards, dtype=np.uint8)
    m, k = coef.shape
    assert shards.shape[0] == k, (coef.shape, shards.shape)
    n = shards.shape[1]
    out = np.zeros((m, n), dtype=np.uint8)
    # plain fancy indexing: measured ~2x faster than np.take(out=...)
    # for 256-entry uint8 tables despite the per-term allocation
    for i in range(m):
        acc = out[i]
        for j in range(k):
            c = coef[i, j]
            if c == 0:
                continue
            if c == 1:
                acc ^= shards[j]
            else:
                acc ^= gf256.MUL_TABLE[c][shards[j]]
    return out


class NumpyCodec:
    name = "numpy"

    def coded_matmul(self, coef: np.ndarray, shards: np.ndarray) -> np.ndarray:
        return coded_matmul(coef, shards)
