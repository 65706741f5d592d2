"""GF(2^8) arithmetic for Reed-Solomon coding.

Field: GF(256) with the primitive polynomial x^8+x^4+x^3+x^2+1 (0x11d) and
generator 2 — the same field used by the reference's codec dependency
(klauspost/reedsolomon, see the reference's weed/storage/erasure_coding/
ec_encoder.go:202 `reedsolomon.New`), so shard bytes are interoperable.

Two representations are maintained:

1. Byte-domain tables (EXP/LOG/MUL_TABLE) for host-side scalar math and the
   numpy CPU backend.
2. Bit-domain matrices: multiplication by a constant c is linear over
   GF(2)^8, i.e. an 8x8 bit-matrix M_c with
       M_c[s, t] = bit s of (c * 2^t).
   A whole m x k byte matrix then expands to an (8m x 8k) 0/1 matrix, and
   RS encode/reconstruct of k shards becomes ONE dense matmul over GF(2):
       parity_bits = (A_bits @ data_bits) mod 2
   (0/1 products summed in f32 stay exact for every code width). This
   module builds those matrices; the device paths live in bits.py /
   codec_torch.py (dense bit-plane matmul) and codec_cuda.py (the
   product-table kernel, which uses MUL_TABLE rows directly).

Host-side copy of seaweedfs_tpu/ops/gf256.py: pure numpy + python ints.
"""
from __future__ import annotations

import numpy as np

GF_POLY = 0x11D  # x^8 + x^4 + x^3 + x^2 + 1
FIELD = 256
ORDER = 255  # multiplicative group order


def _build_tables() -> tuple[np.ndarray, np.ndarray]:
    exp = np.zeros(512, dtype=np.uint8)
    log = np.zeros(256, dtype=np.int32)
    x = 1
    for i in range(ORDER):
        exp[i] = x
        log[x] = i
        x <<= 1
        if x & 0x100:
            x ^= GF_POLY
    # duplicate so exp[(la + lb)] works without a mod for la+lb < 510
    for i in range(ORDER, 512):
        exp[i] = exp[i - ORDER]
    return exp, log


EXP, LOG = _build_tables()

# Full 256x256 product table: 64KB, used by the numpy CPU codec backend.
_a = np.arange(256)
_la = LOG[_a][:, None]
_lb = LOG[_a][None, :]
MUL_TABLE = EXP[(_la + _lb) % ORDER].astype(np.uint8)
MUL_TABLE[0, :] = 0
MUL_TABLE[:, 0] = 0
del _a, _la, _lb

# Multiplicative inverse table (INV[0] is undefined; left as 0).
INV = np.zeros(256, dtype=np.uint8)
INV[1:] = EXP[(ORDER - LOG[np.arange(1, 256)]) % ORDER]


def gf_pow(a: int, n: int) -> int:
    if n == 0:
        return 1
    if a == 0:
        return 0
    return int(EXP[(int(LOG[a]) * n) % ORDER])


# ---------------------------------------------------------------------------
# Matrix algebra over GF(256) (host side, small matrices: k, m <= ~32)
# ---------------------------------------------------------------------------

def mat_mul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(r,n) @ (n,c) byte matrices over GF(256)."""
    a = np.asarray(a, dtype=np.uint8)
    b = np.asarray(b, dtype=np.uint8)
    assert a.shape[1] == b.shape[0]
    # products[i,j,t] = a[i,t]*b[t,j]; xor-reduce over t
    prod = MUL_TABLE[a[:, None, :], b.T[None, :, :]]  # (r, c, n)
    return np.bitwise_xor.reduce(prod, axis=2)


def mat_inv(m: np.ndarray) -> np.ndarray:
    """Invert a square byte matrix over GF(256) by Gauss-Jordan.

    Raises ValueError if singular.
    """
    m = np.asarray(m, dtype=np.uint8)
    n = m.shape[0]
    assert m.shape == (n, n)
    work = np.concatenate([m.copy(), np.eye(n, dtype=np.uint8)], axis=1)
    for col in range(n):
        # pivot
        if work[col, col] == 0:
            for r in range(col + 1, n):
                if work[r, col] != 0:
                    work[[col, r]] = work[[r, col]]
                    break
            else:
                raise ValueError("singular matrix over GF(256)")
        pivot = int(work[col, col])
        work[col] = MUL_TABLE[INV[pivot], work[col]]
        # eliminate other rows
        for r in range(n):
            if r != col and work[r, col] != 0:
                factor = int(work[r, col])
                work[r] ^= MUL_TABLE[factor, work[col]]
    return work[:, n:].copy()


# ---------------------------------------------------------------------------
# Bit-matrix expansion: GF(256) linear maps -> GF(2) matrices
# ---------------------------------------------------------------------------

def _build_bitmats() -> np.ndarray:
    """BITMAT[c] is the 8x8 0/1 matrix of 'multiply by c':

        bits(c*x)[s] = XOR_t BITMAT[c][s,t] * bits(x)[t]

    Column t is the bit-decomposition of c * 2^t.
    """
    out = np.zeros((256, 8, 8), dtype=np.uint8)
    for c in range(256):
        for t in range(8):
            v = MUL_TABLE[c, 1 << t]
            for s in range(8):
                out[c, s, t] = (v >> s) & 1
    return out


BITMAT = _build_bitmats()


def expand_to_bits(m: np.ndarray) -> np.ndarray:
    """Expand an (r, c) byte matrix to the (8r, 8c) GF(2) matrix of the
    same linear map, acting on bit-minor-expanded vectors:

        y_bits[8*i + s] = XOR_{j,t} out[8i+s, 8j+t] * x_bits[8j+t]
    """
    m = np.asarray(m, dtype=np.uint8)
    r, c = m.shape
    blocks = BITMAT[m]                      # (r, c, 8, 8)
    out = blocks.transpose(0, 2, 1, 3).reshape(8 * r, 8 * c)
    return np.ascontiguousarray(out)


