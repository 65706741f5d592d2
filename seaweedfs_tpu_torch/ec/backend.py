"""Codec backend registry and the measured router for the
erasure-coding subsystem — the counterpart of seaweedfs_tpu/ec/backend.py.

A backend implements one method:

    coded_matmul(coef: (m,k) uint8, shards: (k,n) uint8) -> (m,n) uint8

computing out[i] = XOR_j coef[i,j]*shards[j] over GF(256), and device
backends add `coded_matmul_stream`. Registered names:

    numpy   the host reference codec (ops/codec_numpy.py)
    native  the C++ AVX2 host codec (ops/codec_native.py), built with g++
            at first use
    torch   dense float32 bit-plane matmul on the GPU (ops/codec_torch.py)
    cuda    the hand-written CUDA kernel (ops/codec_cuda.py)
    mesh    the kernel over every local card (ops/codec_mesh.py; shape
            from -ec.mesh.devices / -ec.mesh.col)
    auto    AutoCodec: per request size, whichever of the device feed,
            the mesh and the CPU codec the measured curve (ec/probe.py)
            says is fastest

`torch`, `cuda` and `mesh` run on the GPU and raise without one, and so
does `auto` when it has to sweep (it measures the card's feed). Callers that
want the device codecs on the CPU pass an instance instead of a name,
e.g. `ReedSolomon(10, 4, backend=CudaCodec(device="cpu"))`. Routing to
the CPU codec happens only where the measured curve says it is faster,
never because a device path failed: those failures raise. Encode,
reconstruct and verify are built on top here, using the systematic
matrices from ops.rs_matrix.
"""
from __future__ import annotations

import os
import time as _time
from typing import Callable, Protocol

import numpy as np

from ..ops import rs_matrix
from ..utils import metrics, tracing
from . import geometry as geo


def _codec_label(backend) -> str:
    """Metrics label for a backend; AutoCodec reports what it resolved
    to (or "auto" before first use)."""
    name = getattr(backend, "name", "") or "unknown"
    if name == "auto":
        name = getattr(backend, "chosen", None) or "auto"
    return name


def observe_codec(op: str, backend, seconds: float | None = None,
                  nbytes: int = 0, code: str = "") -> None:
    """Record one codec operation into ec_codec_seconds{op,backend}
    / ec_codec_bytes_total (bytes = input data processed). Either part
    may be skipped (seconds=None / nbytes=0) so streaming paths can
    count bytes at consumption and time at yield without double
    observations. When the caller knows its code family, bytes are
    also counted per code."""
    name = backend if isinstance(backend, str) else _codec_label(backend)
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


def register(name: str, factory: Callable[[], CodecBackend]) -> None:
    _factories[name] = factory


def backend_names() -> list[str]:
    return sorted(_factories)


def get_backend(name: str = "cuda") -> CodecBackend:
    """The process-wide instance of a registered backend. `torch`, `cuda`
    and `mesh` build on the GPU and raise when there is none; `native`
    builds its library and raises when that fails."""
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

    def _native_factory():
        from ..ops import codec_native

        return codec_native.NativeCodec()

    register("native", _native_factory)

    def _torch_factory():
        from ..ops import codec_torch

        return codec_torch.TorchCodec()

    register("torch", _torch_factory)

    def _cuda_factory():
        from ..ops import codec_cuda

        return codec_cuda.CudaCodec()

    register("cuda", _cuda_factory)

    def _mesh_factory():
        from ..ops import codec_mesh

        return codec_mesh.MeshCodec()

    register("mesh", _mesh_factory)
    register("auto", AutoCodec)


_AUTO_ENV = "SEAWEEDFS_TPU_EC_BACKEND"
_auto_choice: str | None = None

# ----------------------------------------------------------------------
# code families: registered specs selectable via SEAWEEDFS_TPU_EC_CODE
# ----------------------------------------------------------------------

_CODE_ENV = "SEAWEEDFS_TPU_EC_CODE"

# the blessed code specs: the RS default, the wide cold-tier RS, and
# the LRC configs (local XOR groups cut single-loss repair fan-in from
# k to the group size at a small storage premium)
KNOWN_CODES = ("10.4", "lrc-10.2.2", "lrc-12.3.2", "28.4")


def default_code_spec() -> str:
    """The process default code (env SEAWEEDFS_TPU_EC_CODE): what
    ec.encode uses when no explicit codec is passed. '' = the classic
    RS(10,4). A malformed value is logged and ignored."""
    spec = os.environ.get(_CODE_ENV, "").strip()
    if not spec:
        return ""
    try:
        geo.parse_code(spec)
        return spec
    except (ValueError, TypeError) as e:
        from ..utils import glog

        glog.warning("ignoring %s=%r: %s", _CODE_ENV, spec, e)
        return ""


def get_code(spec: str = "") -> geo.CodeConfig:
    """Spec string (as recorded in a volume .vif) -> CodeConfig."""
    return geo.parse_code(spec or "")


def code_table() -> list[dict]:
    """The registry view: each known code's structure, storage overhead
    and repair fan-in. Every backend serves every code (the coefficient
    matrix is a runtime argument in all of them)."""
    out = []
    for spec in KNOWN_CODES:
        row = get_code(spec).describe()
        row["backends"] = backend_names()
        row["default"] = spec == (default_code_spec() or "10.4")
        out.append(row)
    return out


def cpu_backend_name() -> str:
    """The fastest CPU-side codec this host can run: the C++ AVX2
    library when it is built or g++ can build it, else the numpy codec.
    What the router compares the device feed against."""
    from .. import native

    return "native" if native.available() else "numpy"


# the request size the process-wide choice represents: bulk encodes
# stream in multi-MB blocks, so "which backend for big work" is "which
# backend at the top of the measured curve"
_ROUTER_BULK_BYTES = 64 << 20


def _env_override() -> str | None:
    """SEAWEEDFS_TPU_EC_BACKEND, validated; None when unset/auto. A
    name that is not registered is logged and ignored; a registered
    backend that fails to build raises."""
    env = os.environ.get(_AUTO_ENV, "").strip()
    if not env or env == "auto":
        return None
    try:
        get_backend(env)
    except KeyError as e:
        from ..utils import glog

        glog.warning("ignoring %s=%r: %s", _AUTO_ENV, env, e)
        return None
    return env


def _decide(curve: dict, nbytes: int) -> str:
    """Router core: the measured e2e rates interpolated at this request
    size versus the measured CPU-codec rate. A device backend (one card
    or the mesh) is chosen only when its *measured end-to-end* feed
    beats the CPU codec. Three-way: the mesh rows of the same sweep
    compete against the single-card rows, so small requests that cannot
    amortize the scatter stay on one card while bulk streams ride every
    card."""
    from . import probe

    cpu_name = curve.get("cpu_backend") or cpu_backend_name()
    cpu_rate = curve.get("cpu_mbps")
    candidates = []
    dev_rate = probe.e2e_mbps_at(curve, nbytes)
    dev_name = curve.get("device_backend")
    if dev_rate is not None and dev_name:
        candidates.append((dev_rate, dev_name))
    mesh_rate = probe.mesh_mbps_at(curve, nbytes)
    if mesh_rate is not None:
        candidates.append((mesh_rate, "mesh"))
    if candidates:
        rate, name = max(candidates)
        if cpu_rate is None or rate > cpu_rate:
            return name
    return cpu_name


def _curve_code(code: str) -> str:
    """Probe-curve key for a code spec: the default RS(10,4) rides the
    primary curve (''); any other code gets its own measured curve."""
    return "" if code in ("", "10.4") else code


def choose_backend_for_size(nbytes: int, code: str = "") -> str:
    """Backend for a request of `nbytes` under code `code`, from the
    measured size x depth curve (ec/probe.py): interpolate the device
    e2e rate at this size, compare to the measured CPU rate, pick the
    winner. Override with env SEAWEEDFS_TPU_EC_BACKEND. First use pays
    the sweep on the card (or reads the disk cache) and raises when
    there is no card; after that it is a dict lookup."""
    env = _env_override()
    if env is not None:
        return env
    from . import probe

    return _decide(probe.get_curve(code=_curve_code(code)), nbytes)


def pipeline_depth_for(nbytes: int, code: str = "") -> int:
    """Streaming-pipeline depth the measured curve recommends for blocks
    of `nbytes` (2 when nothing is measured — the classic double
    buffer). When the router would send this size to the mesh, the
    depth comes from the mesh rows: the scatter across N cards has its
    own overlap sweet spot. Never sweeps."""
    from . import probe

    curve = probe.peek(code=_curve_code(code))
    if curve is None:
        return 2
    env = _env_override()
    choice = env if env is not None else _decide(curve, nbytes)
    if choice == "mesh":
        return probe.mesh_depth_at(curve, nbytes)
    return probe.depth_at(curve, nbytes)


def choose_auto_backend() -> str:
    """Process-wide codec choice for bulk work, from measurement: the
    size x depth sweep of the real pipelined feed (ec/probe.py)
    interpolated at the bulk request size. Override with env
    SEAWEEDFS_TPU_EC_BACKEND. The decision is cached per process; the
    sweep result is cached on disk (TTL + host fingerprint)."""
    global _auto_choice
    env = _env_override()
    if env is not None:
        metrics.gauge_set("ec_codec_chosen_backend", 1, {"backend": env})
        return env
    if _auto_choice is not None:
        return _auto_choice
    from . import probe

    curve = probe.get_curve()
    choice = _decide(curve, _ROUTER_BULK_BYTES)
    summary = probe.summary(curve)
    summary["chosen"] = choice
    _auto_choice = choice
    metrics.gauge_set("ec_codec_chosen_backend", 1, {"backend": choice})
    from ..utils import glog

    glog.info("ec auto backend: %s", summary)
    return choice


def router_buckets(curve: dict) -> list[dict]:
    """Per-size-bucket routing table (one row per swept size): what the
    router would pick for a request of that size and the measured rates
    behind the decision."""
    from . import probe

    env = _env_override()
    out = []
    for size in probe.SWEEP_SIZES:
        dev_rate = probe.e2e_mbps_at(curve, size)
        mesh_rate = probe.mesh_mbps_at(curve, size)
        backend = env if env is not None else _decide(curve, size)
        depth = (probe.mesh_depth_at(curve, size) if backend == "mesh"
                 else probe.depth_at(curve, size))
        out.append({
            "size_mb": size >> 20,
            "backend": backend,
            "pinned_by_env": env is not None,
            "device_e2e_mbps": (round(dev_rate, 2)
                                if dev_rate is not None else None),
            "mesh_e2e_mbps": (round(mesh_rate, 2)
                              if mesh_rate is not None else None),
            "cpu_mbps": curve.get("cpu_mbps"),
            "depth": depth,
        })
    return out


def mesh_geometry() -> dict:
    """Mesh codec geometry for /debug/ec: the live instance's shape when
    one exists (never constructs one: a debug GET must not pay device
    init), else the configured knobs."""
    inst = _instances.get("mesh")
    if inst is not None:
        geom = dict(inst.describe())
        geom["state"] = "active"
        return geom
    from ..parallel import mesh as pmesh

    n_devices, col = pmesh.mesh_config()
    return {"state": "unbuilt", "devices": n_devices, "col": col}


def probe_snapshot() -> dict:
    """Router state: the measured curve, where it came from (process
    sweep vs disk cache), how stale it is, and the per-size-bucket
    decision, for the default code and every known code. Never sweeps:
    an unprobed process says so."""
    from . import probe

    snap: dict = {
        "env_override": os.environ.get(_AUTO_ENV, "").strip() or None,
        "process_choice": _auto_choice,
        "cpu_backend": cpu_backend_name(),
        "cache_path": probe.cache_path(),
        "cache_ttl_s": probe.cache_ttl_s(),
        "mesh": mesh_geometry(),
        "default_code": default_code_spec() or "10.4",
        "codes": code_table(),
    }
    per_code: dict[str, dict] = {}
    for spec in KNOWN_CODES:
        ccurve = probe.peek(code=_curve_code(spec))
        per_code[spec] = ({"state": "unprobed"} if ccurve is None else
                          {"state": "measured",
                           "buckets": router_buckets(ccurve)})
    snap["code_buckets"] = per_code
    curve = probe.peek()
    if curve is None:
        snap["probe"] = {"state": "unprobed"}
        return snap
    measured_at = float(curve.get("measured_at") or 0)
    snap["probe"] = {
        "state": "measured",
        "source": curve.get("source"),
        "age_s": round(max(0.0, _time.time() - measured_at), 1),
        "summary": probe.summary(curve),
        "rows": curve.get("rows", []),
    }
    snap["buckets"] = router_buckets(curve)
    return snap


class AutoCodec:
    """Backend `auto`: routes each op to the measured-fastest backend for
    its size — the per-request interpolation of the probe curve
    (choose_backend_for_size). Lazy, so constructing it never pays the
    probe. Callers that must keep a whole multi-dispatch operation on
    ONE backend (the file encode / rebuild paths) pin it first via
    resolve_for(total request bytes)."""

    name = "auto"

    def __init__(self, code_spec: str = ""):
        self._impl: CodecBackend | None = None
        self._pinned = False
        # the code family this instance routes for: per-code measured
        # curves can move the CPU/device crossover point
        self.code_spec = code_spec

    @property
    def chosen(self) -> str | None:
        return getattr(self._impl, "name", None)

    def _resolve(self) -> CodecBackend:
        """Process-wide (bulk-size) choice, pinned."""
        if not self._pinned:
            if _curve_code(self.code_spec):
                self._impl = get_backend(choose_backend_for_size(
                    _ROUTER_BULK_BYTES, self.code_spec))
            else:
                self._impl = get_backend(choose_auto_backend())
            self._pinned = True
        return self._impl

    def resolve_for(self, nbytes: int) -> CodecBackend:
        """Pin the backend the measured curve picks for a request of
        `nbytes` — the whole operation then rides one backend even as it
        streams through many dispatches."""
        self._impl = get_backend(choose_backend_for_size(
            nbytes, self.code_spec))
        self._pinned = True
        return self._impl

    def _backend_for(self, nbytes: int) -> CodecBackend:
        if self._pinned:
            return self._impl
        self._impl = get_backend(choose_backend_for_size(
            nbytes, self.code_spec))
        return self._impl

    def coded_matmul(self, coef: np.ndarray, shards) -> np.ndarray:
        shards = np.asarray(shards, dtype=np.uint8)
        return self._backend_for(shards.nbytes).coded_matmul(coef,
                                                             shards)

    def coded_matmul_stream(self, coef: np.ndarray, blocks,
                            depth: int = 2):
        # streams are bulk by construction: route like a large request
        impl = (self._impl if self._pinned
                else self._backend_for(_ROUTER_BULK_BYTES))
        stream = getattr(impl, "coded_matmul_stream", None)
        if stream is not None:
            yield from stream(coef, blocks, depth=depth)
        else:
            for block in blocks:
                yield impl.coded_matmul(coef, block)


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
        if backend == "auto" and _curve_code(self.code.spec):
            # a non-default code routes on its own measured curve, so
            # it gets its own AutoCodec instead of the shared singleton
            # (whose pinned choice belongs to the RS(10,4) curve)
            backend = AutoCodec(self.code.spec)
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
        # the host compare: a stage of the call beside the one-shot
        # encode's h2d, kernel and d2h (ops/codec_torch.py)
        t0 = _time.perf_counter()
        with tracing.annotate("ec.verify.compare"):
            same = bool(np.array_equal(expect, shards[self.k:]))
        metrics.histogram_observe(
            "ec_codec_call_stage_seconds", _time.perf_counter() - t0,
            {"stage": "compare", "backend": _codec_label(self.backend)})
        return same
