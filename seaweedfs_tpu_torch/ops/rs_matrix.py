"""Reed-Solomon coding matrices over GF(256).

Uses the systematic-Vandermonde construction (Backblaze / klauspost
`buildMatrix` lineage — the default of the reference's codec dependency,
the reference's go.mod:62): rows of a Vandermonde matrix are made systematic
by right-multiplying with the inverse of its top k x k square, so shards
0..k-1 are the data bytes verbatim and shards k..n-1 are parity.

All matrices are small ((k+m) x k, k+m <= 256) host-side numpy uint8.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from functools import lru_cache

import numpy as np

from . import gf256


def vandermonde(rows: int, cols: int) -> np.ndarray:
    """v[r, c] = r ** c in GF(256). Any k of the rows are independent."""
    v = np.zeros((rows, cols), dtype=np.uint8)
    for r in range(rows):
        for c in range(cols):
            v[r, c] = gf256.gf_pow(r, c)
    return v


@lru_cache(maxsize=64)
def _encode_matrix_cached(data_shards: int, parity_shards: int) -> bytes:
    total = data_shards + parity_shards
    if total > gf256.FIELD:
        raise ValueError("data+parity shards must be <= 256")
    vm = vandermonde(total, data_shards)
    top_inv = gf256.mat_inv(vm[:data_shards, :data_shards])
    m = gf256.mat_mul(vm, top_inv)
    return m.tobytes()


def encode_matrix(data_shards: int, parity_shards: int) -> np.ndarray:
    """The (k+m) x k systematic encode matrix: identity on top, parity
    coefficient rows below."""
    total = data_shards + parity_shards
    raw = _encode_matrix_cached(data_shards, parity_shards)
    return np.frombuffer(raw, dtype=np.uint8).reshape(total, data_shards).copy()


def parity_rows(data_shards: int, parity_shards: int) -> np.ndarray:
    """Just the m x k parity coefficient block."""
    return encode_matrix(data_shards, parity_shards)[data_shards:, :]


# ---------------------------------------------------------------------------
# Inversion cache: repair storms re-invert the same surviving-set matrix
# ---------------------------------------------------------------------------

INVERSION_CACHE_MAX = 512

_inv_cache: "OrderedDict[tuple, bytes]" = OrderedDict()
_inv_lock = threading.Lock()


def _count_inv(outcome: str) -> None:
    try:
        from ..utils import metrics

        metrics.counter_add("rs_matrix_inversion_cache_total", 1,
                            {"outcome": outcome})
    except Exception:  # pragma: no cover - metrics must never fatal
        pass


def _cached_inverse(key: tuple, sub: np.ndarray) -> np.ndarray:
    """LRU-cached gf256.mat_inv keyed by the surviving-shard set (plus
    the code identity): a repair storm over one loss pattern hits the
    same k x k inversion on every stripe chunk."""
    with _inv_lock:
        raw = _inv_cache.get(key)
        if raw is not None:
            _inv_cache.move_to_end(key)
    if raw is not None:
        _count_inv("hit")
        n = sub.shape[0]
        return np.frombuffer(raw, dtype=np.uint8).reshape(n, n).copy()
    inv = gf256.mat_inv(sub)
    _count_inv("miss")
    with _inv_lock:
        _inv_cache[key] = inv.tobytes()
        while len(_inv_cache) > INVERSION_CACHE_MAX:
            _inv_cache.popitem(last=False)
    return inv


def reconstruction_matrix(
    data_shards: int,
    parity_shards: int,
    present: list[int],
) -> tuple[np.ndarray, list[int]]:
    """Matrix recovering ALL k+m shards from k present ones.

    `present` lists >= k available shard indices (0..k+m-1); the first k of
    them (sorted) are used as inputs. Returns (R, input_shard_ids) with
        all_shards = R @ stack(shards[i] for i in input_shard_ids)
    R is (k+m) x k; rows for the input shards are unit vectors.
    """
    k = data_shards
    present = sorted(set(present))
    if len(present) < k:
        raise ValueError(
            f"need >= {k} shards to reconstruct, have {len(present)}")
    inputs = present[:k]
    enc = encode_matrix(data_shards, parity_shards)
    sub = enc[inputs, :]                      # (k, k): inputs = sub @ data
    data_from_inputs = _cached_inverse(
        ("rs", k, parity_shards, tuple(inputs)), sub)
    return gf256.mat_mul(enc, data_from_inputs), inputs


def recovery_rows(
    data_shards: int,
    parity_shards: int,
    present: list[int],
    missing: list[int],
) -> tuple[np.ndarray, list[int]]:
    """Rows of the reconstruction matrix for `missing` shards only.

    Returns (matrix of shape (len(missing), k), input_shard_ids) where
        missing_shards = matrix @ stack(shards[i] for i in input_shard_ids)
    """
    full, inputs = reconstruction_matrix(data_shards, parity_shards, present)
    return full[missing, :].copy(), inputs


# ---------------------------------------------------------------------------
# Code-family matrices: a code is (encode matrix, locality groups,
# repair plan) — ec/geometry.CodeConfig carries the structure, this
# module builds the GF(256) matrices behind it.
# ---------------------------------------------------------------------------

@lru_cache(maxsize=64)
def _encode_matrix_for_cached(spec: str, k: int, n_local: int,
                              n_global: int) -> bytes:
    total = k + n_local + n_global
    if not n_local:  # plain RS
        return _encode_matrix_cached(k, n_global)
    enc = np.zeros((total, k), dtype=np.uint8)
    enc[:k] = np.eye(k, dtype=np.uint8)
    gs = k // n_local
    for i in range(n_local):
        enc[k + i, i * gs:(i + 1) * gs] = 1
    # Global rows: the LAST g systematic-Vandermonde parity rows of
    # RS(k, locals+globals). The first klauspost parity row is the
    # all-ones XOR row — exactly the sum of the local-group rows — so
    # taking rows [locals:] keeps the stack independent of the locals.
    pr = parity_rows(k, n_local + n_global)
    enc[k + n_local:] = pr[n_local:]
    return enc.tobytes()


def encode_matrix_for(code) -> np.ndarray:
    """(total, k) systematic encode matrix of a geometry.CodeConfig:
    identity on top; for LRC, local XOR indicator rows then global
    Vandermonde rows; for RS, the classic parity block."""
    raw = _encode_matrix_for_cached(code.spec, code.k, code.n_local,
                                    code.n_global)
    return np.frombuffer(raw, dtype=np.uint8).reshape(
        code.total, code.k).copy()


def parity_rows_for(code) -> np.ndarray:
    """The (m, k) parity coefficient block of a code's encode matrix."""
    return encode_matrix_for(code)[code.k:, :]


def _gf_eliminate(rows: np.ndarray) -> tuple[np.ndarray, list[int]]:
    """Row-reduce over GF(256) -> (reduced rows, pivot column list)."""
    work = np.array(rows, dtype=np.uint8)
    r, c = work.shape
    pivots: list[int] = []
    row = 0
    for col in range(c):
        if row >= r:
            break
        piv = None
        for rr in range(row, r):
            if work[rr, col]:
                piv = rr
                break
        if piv is None:
            continue
        if piv != row:
            work[[row, piv]] = work[[piv, row]]
        work[row] = gf256.MUL_TABLE[gf256.INV[work[row, col]], work[row]]
        for rr in range(r):
            if rr != row and work[rr, col]:
                work[rr] ^= gf256.MUL_TABLE[int(work[rr, col]), work[row]]
        pivots.append(col)
        row += 1
    return work, pivots


def rank_of(code, present: list[int]) -> int:
    """GF(256) rank of the encode-matrix rows of `present` shards —
    the honest recoverability check (LRC local-parity rows are
    linearly dependent with their group, so counting survivors lies)."""
    enc = encode_matrix_for(code)
    rows = enc[[s for s in sorted(set(present)) if 0 <= s < code.total]]
    if not len(rows):
        return 0
    _, pivots = _gf_eliminate(rows)
    return len(pivots)


def gf_solve(a: np.ndarray, b: np.ndarray) -> np.ndarray | None:
    """Solve A @ X = B over GF(256) (A: (r, c), B: (r, t)) -> X (c, t),
    free variables zeroed; None when inconsistent."""
    a = np.asarray(a, dtype=np.uint8)
    b = np.asarray(b, dtype=np.uint8)
    r, c = a.shape
    t = b.shape[1]
    work, pivots = _gf_eliminate(np.concatenate([a, b], axis=1))
    x = np.zeros((c, t), dtype=np.uint8)
    for row, col in enumerate(pivots):
        if col >= c:      # pivot landed in the B block: inconsistent
            return None
        x[col] = work[row, c:]
    # consistency: rows below the last pivot must be all-zero in B too
    for row in range(len(pivots), r):
        if work[row, c:].any():
            return None
    return x


def solve_inputs(code, available: list[int], missing: list[int],
                 prefer: list[int] | None = None) -> list[int] | None:
    """Greedy minimal-ish input set: the smallest prefix of available
    shards (preferred readers first, then data, locals, globals) whose
    encode rows span every missing shard's row. None = unrecoverable.
    Rows that do not grow the span are never added — a dependent local
    parity costs a read without buying information."""
    enc = encode_matrix_for(code)
    avail = [s for s in sorted(set(available))
             if 0 <= s < code.total and s not in set(missing)]
    prefer = [s for s in (prefer or []) if s in set(avail)]
    ordered = prefer + [s for s in avail if s not in set(prefer)]
    targets = enc[sorted(set(missing))]
    chosen: list[int] = []
    for sid in ordered:
        trial = chosen + [sid]
        basis, pivots = _gf_eliminate(enc[trial])
        if len(pivots) == len(chosen):  # dependent row: skip
            continue
        chosen = trial
        if gf_solve(enc[chosen].T, targets.T) is not None:
            return chosen
    return None


def recovery_rows_for(code, present: list[int], missing: list[int]
                      ) -> tuple[np.ndarray, list[int]]:
    """Code-aware recovery_rows: (matrix (len(missing), fanin),
    input_shard_ids) with
        missing = matrix @ stack(shards[i] for i in input_shard_ids)
    For RS this is the classic k-input inversion (cached); for LRC the
    input set follows the code's repair plan — a single group loss
    reads group_size shards, not k."""
    if code.is_rs:
        return recovery_rows(code.k, code.m, present, missing)
    missing = sorted(set(int(s) for s in missing))
    plan = code.repair_plan(missing, present)
    if plan is None:
        raise ValueError(
            f"code {code.spec}: shards {missing} unrecoverable from "
            f"{sorted(set(present))}")
    inputs = list(plan.reads)
    key = (code.spec, tuple(inputs), tuple(missing))
    with _inv_lock:
        raw = _inv_cache.get(key)
        if raw is not None:
            _inv_cache.move_to_end(key)
    if raw is not None:
        _count_inv("hit")
        rows = np.frombuffer(raw, dtype=np.uint8).reshape(
            len(missing), len(inputs)).copy()
        return rows, inputs
    enc = encode_matrix_for(code)
    x = gf_solve(enc[inputs].T, enc[missing].T)
    if x is None:  # plan said solvable; matrices disagree -> bug guard
        raise ValueError(
            f"code {code.spec}: no solution for {missing} from {inputs}")
    rows = np.ascontiguousarray(x.T)
    _count_inv("miss")
    with _inv_lock:
        _inv_cache[key] = rows.tobytes()
        while len(_inv_cache) > INVERSION_CACHE_MAX:
            _inv_cache.popitem(last=False)
    return rows, inputs
