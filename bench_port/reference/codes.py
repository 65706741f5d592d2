"""The parity rows of the codes a configuration states.

`rs`: Reed-Solomon as klauspost/reedsolomon builds it by default, and
so as SeaweedFS seals (weed/storage/erasure_coding/ec_encoder.go): the
(k + m, k) Vandermonde matrix v[r, c] = r^c, made systematic by
multiplying with the inverse of its top k x k square; rows k.. are the
parity rows.

`lrc`: LRC(k, l, g) in the layout of Huang et al., "Erasure Coding in
Windows Azure Storage" (USENIX ATC 2012): k data shards in l local
groups of k / l, then l local parities, then g global parities. The
configuration states the coefficients: each local parity is the XOR of
its group, and the global parities are the last g parity rows of
rs(k, l + g) above.
"""
from __future__ import annotations

import numpy as np

from . import gf256


def rs_parity_rows(k: int, m: int) -> list[list[int]]:
    vm = [[gf256.power(r, c) for c in range(k)] for r in range(k + m)]
    top_inv = gf256.mat_inv(vm[:k])
    return gf256.mat_mul(vm[k:], top_inv)


def parity_rows(config: dict) -> np.ndarray:
    """(m, k) uint8 parity coefficients of the configuration's code."""
    kind = config["code_kind"]
    k = int(config["data_shards"])
    if kind == "rs":
        rows = rs_parity_rows(k, int(config["parity_shards"]))
    elif kind == "lrc":
        n_local = int(config["local_parities"])
        n_global = int(config["global_parities"])
        if k % n_local:
            raise ValueError(f"k={k} does not split into {n_local} groups")
        size = k // n_local
        rows = [[int(g * size <= c < (g + 1) * size) for c in range(k)]
                for g in range(n_local)]
        rows += rs_parity_rows(k, n_local + n_global)[n_local:]
    else:
        raise ValueError(f"unknown code kind {kind!r}")
    return np.array(rows, dtype=np.uint8)


def shard_counts(config: dict) -> tuple[int, int]:
    """(k, m) of the configuration's code."""
    k = int(config["data_shards"])
    if config["code_kind"] == "lrc":
        return k, int(config["local_parities"]) + int(config["global_parities"])
    return k, int(config["parity_shards"])
