"""Codec backend registry for the erasure-coding subsystem — the
counterpart of seaweedfs_tpu/ec/backend.py.

A backend implements one method:

    coded_matmul(coef: (m,k) uint8, shards: (k,n) uint8) -> (m,n) uint8

computing out[i] = XOR_j coef[i,j]*shards[j] over GF(256), and device
backends add `coded_matmul_stream`. Registered names:

    numpy   the host reference codec (ops/codec_numpy.py)
    torch   dense float32 bit-plane matmul on the GPU (ops/codec_torch.py)
    cuda    the hand-written CUDA kernel (ops/codec_cuda.py)

`torch` and `cuda` run on the GPU and raise without one. Callers that
want them on the CPU pass an instance instead of a name, e.g.
`ReedSolomon(10, 4, backend=CudaCodec(device="cpu"))`. Encode,
reconstruct and verify are built on top here, using the systematic
matrices from ops.rs_matrix. The measured router (`auto`) waits for a
later slice.
"""
from __future__ import annotations

import time as _time
from typing import Callable, Protocol

import numpy as np

from ..ops import rs_matrix
from ..utils import metrics
from . import geometry as geo


def observe_codec(op: str, backend, seconds: float | None = None,
                  nbytes: int = 0, code: str = "") -> None:
    """Record one codec operation into ec_codec_seconds{op,backend}
    / ec_codec_bytes_total (bytes = input data processed). Either part
    may be skipped (seconds=None / nbytes=0) so streaming paths can
    count bytes at consumption and time at yield without double
    observations. When the caller knows its code family, bytes are
    also counted per code."""
    name = backend if isinstance(backend, str) else \
        (getattr(backend, "name", "") or "unknown")
    lab = {"op": op, "backend": name}
    if seconds is not None:
        metrics.histogram_observe("ec_codec_seconds", seconds, lab)
    if nbytes:
        metrics.counter_add("ec_codec_bytes_total", nbytes, lab)
        if code:
            metrics.counter_add("ec_codec_bytes_by_code_total", nbytes,
                                {"op": op, "backend": name, "code": code})


class CodecBackend(Protocol):
    name: str

    def coded_matmul(self, coef: np.ndarray, shards: np.ndarray) -> np.ndarray:
        ...


_factories: dict[str, Callable[[], CodecBackend]] = {}
_instances: dict[str, CodecBackend] = {}

# the blessed code specs: the RS default, the wide cold-tier RS and the
# LRC configs, as in the reference's registry
KNOWN_CODES = ("10.4", "lrc-10.2.2", "lrc-12.3.2", "28.4")


def register(name: str, factory: Callable[[], CodecBackend]) -> None:
    _factories[name] = factory


def backend_names() -> list[str]:
    return sorted(_factories)


def get_backend(name: str = "cuda") -> CodecBackend:
    """The process-wide instance of a registered backend. `torch` and
    `cuda` build on the GPU and raise when there is none."""
    inst = _instances.get(name)
    if inst is None:
        try:
            factory = _factories[name]
        except KeyError:
            raise KeyError(
                f"unknown codec backend {name!r}; known: {backend_names()}"
            ) from None
        inst = factory()
        _instances[name] = inst
    return inst


def _register_builtins() -> None:
    from ..ops import codec_numpy

    register("numpy", codec_numpy.NumpyCodec)

    def _torch_factory():
        from ..ops import codec_torch

        return codec_torch.TorchCodec()

    register("torch", _torch_factory)

    def _cuda_factory():
        from ..ops import codec_cuda

        return codec_cuda.CudaCodec()

    register("cuda", _cuda_factory)


_register_builtins()


class ReedSolomon:
    """RS(k, m) erasure codec over a pluggable coded-matmul backend.

    API shape follows the reference's codec dependency (Encode /
    Reconstruct / Verify) but operates on (shards, n) numpy arrays so
    callers can batch arbitrarily many stripes per call. The default
    backend is the CUDA kernel on the GPU.
    """

    def __init__(self, data_shards: int, parity_shards: int,
                 backend: str | CodecBackend = "cuda",
                 code: "geo.CodeConfig | str | None" = None):
        if code is not None:
            if isinstance(code, str):
                code = geo.parse_code(code)
            data_shards, parity_shards = code.k, code.m
        if data_shards <= 0 or parity_shards <= 0:
            raise ValueError("data_shards and parity_shards must be > 0")
        if data_shards + parity_shards > 256:
            raise ValueError("data+parity shards must be <= 256")
        self.k = data_shards
        self.m = parity_shards
        self.n = data_shards + parity_shards
        # the structural code config: RS unless an LRC (or other
        # structured) spec was passed — repair planning and parity
        # construction consult it instead of assuming k-of-n
        self.code = code if code is not None \
            else geo.CodeConfig(geo.codec_name(data_shards,
                                               parity_shards),
                                "rs", data_shards, 0, parity_shards)
        self.backend = (get_backend(backend) if isinstance(backend, str)
                        else backend)
        self._parity_rows = rs_matrix.parity_rows_for(self.code)

    def encode(self, data: np.ndarray) -> np.ndarray:
        """(k, n) data shards -> (m, n) parity shards."""
        data = np.asarray(data, dtype=np.uint8)
        if data.ndim != 2 or data.shape[0] != self.k:
            raise ValueError(f"data shape {data.shape}, need ({self.k}, n)")
        t0 = _time.perf_counter()
        out = self.backend.coded_matmul(self._parity_rows, data)
        observe_codec("encode", self.backend,
                      _time.perf_counter() - t0, data.nbytes,
                      code=self.code.spec)
        return out

    def reconstruct(self, shards: dict[int, np.ndarray],
                    missing: list[int] | None = None) -> dict[int, np.ndarray]:
        """Recover shards from any >= k present ones.

        shards: {shard_id: (n,) uint8 row}; missing: which ids to produce
        (default: all absent ids 0..k+m-1). Returns {id: row}.
        """
        present = sorted(shards)
        if missing is None:
            missing = [i for i in range(self.n) if i not in shards]
        if not missing:
            return {}
        rows, inputs = rs_matrix.recovery_rows_for(self.code, present,
                                                   missing)
        stack = np.stack([np.asarray(shards[i], dtype=np.uint8)
                          for i in inputs])
        t0 = _time.perf_counter()
        out = self.backend.coded_matmul(rows, stack)
        observe_codec("reconstruct", self.backend,
                      _time.perf_counter() - t0, stack.nbytes,
                      code=self.code.spec)
        return {sid: out[i] for i, sid in enumerate(missing)}

    def reconstruct_data(self, shards: dict[int, np.ndarray]
                         ) -> dict[int, np.ndarray]:
        """Recover only missing DATA shards (the reference's
        ReconstructData)."""
        missing = [i for i in range(self.k) if i not in shards]
        return self.reconstruct(shards, missing)

    def matmul_stream(self, coef: np.ndarray, blocks, depth: int = 2,
                      op: str = "encode"):
        """Yield coded_matmul(coef, block) per block, pipelined when the
        backend supports it (device in-flight depth `depth`), else
        computed synchronously block by block. Each block is recorded
        into ec_codec_seconds{op,backend} (steady-state inter-yield time
        for pipelined backends) and ec_codec_bytes_total."""
        def counted(src):
            for block in src:
                observe_codec(op, self.backend,
                              nbytes=getattr(block, "nbytes", 0))
                yield block

        stream = getattr(self.backend, "coded_matmul_stream", None)
        if stream is not None:
            it = stream(coef, counted(blocks), depth=depth)
        else:
            it = (self.backend.coded_matmul(coef, block)
                  for block in counted(blocks))
        while True:
            t0 = _time.perf_counter()
            try:
                out = next(it)
            except StopIteration:
                return
            observe_codec(op, self.backend, _time.perf_counter() - t0)
            yield out

    def encode_stream(self, blocks, depth: int = 2):
        """Streaming encode: yields (m, w) parity per (k, w) data block."""
        yield from self.matmul_stream(self._parity_rows, blocks,
                                      depth=depth, op="encode")

    def verify(self, shards: np.ndarray) -> bool:
        """(k+m, n) full shard stack -> parity consistency check."""
        shards = np.asarray(shards, dtype=np.uint8)
        if shards.ndim != 2 or shards.shape[0] != self.n:
            raise ValueError(f"shards shape {shards.shape}, need "
                             f"({self.n}, n)")
        expect = self.encode(shards[: self.k])
        return bool(np.array_equal(expect, shards[self.k:]))
