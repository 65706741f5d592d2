"""GF(2^8) arithmetic for the plain reference.

The field of SeaweedFS's codec dependency (klauspost/reedsolomon):
polynomial x^8 + x^4 + x^3 + x^2 + 1 (0x11d), generator 2. Written
from that definition alone; nothing here comes from the program.
"""
from __future__ import annotations

import numpy as np

POLY = 0x11D


def _exp_log() -> tuple[list[int], list[int]]:
    exp, log = [0] * 255, [0] * 256
    x = 1
    for i in range(255):
        exp[i] = x
        log[x] = i
        x <<= 1
        if x & 0x100:
            x ^= POLY
    return exp, log


EXP, LOG = _exp_log()


def mul(a: int, b: int) -> int:
    if a == 0 or b == 0:
        return 0
    return EXP[(LOG[a] + LOG[b]) % 255]


def inv(a: int) -> int:
    if a == 0:
        raise ZeroDivisionError("0 has no inverse in GF(256)")
    return EXP[(255 - LOG[a]) % 255]


def power(a: int, n: int) -> int:
    if n == 0:
        return 1
    if a == 0:
        return 0
    return EXP[(LOG[a] * n) % 255]


def mul_table() -> np.ndarray:
    """(256, 256) uint8: t[a, b] = a * b."""
    t = np.zeros((256, 256), dtype=np.uint8)
    for a in range(1, 256):
        for b in range(1, 256):
            t[a, b] = EXP[(LOG[a] + LOG[b]) % 255]
    return t


def mat_mul(a: list[list[int]], b: list[list[int]]) -> list[list[int]]:
    rows, inner, cols = len(a), len(b), len(b[0])
    out = [[0] * cols for _ in range(rows)]
    for r in range(rows):
        for c in range(cols):
            acc = 0
            for i in range(inner):
                acc ^= mul(a[r][i], b[i][c])
            out[r][c] = acc
    return out


def mat_inv(a: list[list[int]]) -> list[list[int]]:
    """Gauss-Jordan inverse of a square matrix; raises when singular."""
    n = len(a)
    work = [list(row) + [int(r == c) for c in range(n)]
            for r, row in enumerate(a)]
    for col in range(n):
        piv = next((r for r in range(col, n) if work[r][col]), None)
        if piv is None:
            raise ValueError("singular matrix")
        work[col], work[piv] = work[piv], work[col]
        scale = inv(work[col][col])
        work[col] = [mul(scale, v) for v in work[col]]
        for r in range(n):
            f = work[r][col]
            if r != col and f:
                work[r] = [v ^ mul(f, p) for v, p in zip(work[r], work[col])]
    return [row[n:] for row in work]
