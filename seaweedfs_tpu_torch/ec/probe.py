"""Measured host<->device rate curve for the EC feed router — the
counterpart of seaweedfs_tpu/ec/probe.py.

The only honest router input is the *measured end-to-end rate of the
actual pipelined feed* at the sizes production requests come in. This
module produces it: a size x depth sweep of the real streaming codec
(ops/codec_torch `coded_matmul_stream`: pinned ring, copy / compute /
read-back streams, the CUDA kernel), each row paired with a transfer-only
ceiling twin (`TorchCodec.transfer_stream`: the same feed with the
product replaced by a row-slice copy on the compute stream), so every
device number carries the link bound it ran under. Each row also keeps
the feed's stage seconds (`ec_codec_stage_seconds` over the row), so a
slow row says where its time went.

The sweep result is cached on disk (JSON) with a TTL and a host
fingerprint (machine, torch and CUDA versions, the card's name and
count, the swept code's matrix, the probe schema); any mismatch,
expiry or parse error means a fresh sweep, never a crash. The port's
cache file is its own (`~/.cache/seaweedfs_tpu_torch/ec_probe.json`
unless SEAWEEDFS_TPU_EC_PROBE_CACHE names one), so the two packages
never read each other's curves.

Interpolation: `e2e_mbps_at(curve, nbytes)` is piecewise-linear in
log2(size) over the best depth per measured size, clamped at both
ends — monotone between measured points by construction.

With more than one card visible, the sweep also measures the mesh codec
(`mesh_rows`, same protocol without the ceilings, same shared budget;
`mesh` holds its geometry): its scatter and gather are real costs, so its curve is
measured, never derived from the single-card rows times N.
`mesh_mbps_at` / `mesh_depth_at` read it as `e2e_mbps_at` / `depth_at`
read the single-card rows.

Differences from the reference, by design: the sweep needs a CUDA device
and raises without one unless the caller passes `device="cpu"` (a CPU
sweep drives the kernel's plain version, for tests, and measures mesh
rows only for a mesh codec passed in); a device row, a mesh row, the
warm-up or the CPU codec that raises makes the sweep raise instead of
recording the error and moving on (budget-skipped rows stay marked
`"skipped": "budget"`).
"""
from __future__ import annotations

import json
import os
import time as _time

import numpy as np
import torch

from ..utils import metrics
from ..utils.device import DEFAULT_DEVICE, resolve_device

# probe schema version: bump when the sweep method or JSON layout
# changes so stale caches self-invalidate
PROBE_VERSION = 2

SWEEP_SIZES = (1 << 20, 4 << 20, 16 << 20, 64 << 20)
SWEEP_DEPTHS = (1, 2, 4)
# RS(10,4): the codec the production feed runs
_K, _M = 10, 4

_CACHE_ENV = "SEAWEEDFS_TPU_EC_PROBE_CACHE"
_TTL_ENV = "SEAWEEDFS_TPU_EC_PROBE_TTL"
_BUDGET_ENV = "SEAWEEDFS_TPU_EC_PROBE_BUDGET"
DEFAULT_TTL_S = 24 * 3600.0
# wall budget for one full sweep: on a fast link the whole table costs
# well under this; on a slow one unaffordable rows are skipped and
# marked, and the curve clamps to the largest measured size
DEFAULT_BUDGET_S = 45.0

# the feed stages a row records (ops/codec_torch.py)
STAGES = ("pread", "pin", "h2d", "kernel", "d2h", "relay")

# process cache of the active curves, keyed by code spec ("" = the
# default RS(10,4) production feed)
_curves: dict[str, dict] = {}


def cache_path(code: str = "") -> str:
    p = os.environ.get(_CACHE_ENV, "").strip()
    base = os.environ.get("XDG_CACHE_HOME",
                          os.path.join(os.path.expanduser("~"), ".cache"))
    if not p:
        p = os.path.join(base, "seaweedfs_tpu_torch", "ec_probe.json")
    if not code:
        return p
    # per-code curve, sibling of the default cache
    root, ext = os.path.splitext(p)
    return f"{root}-{code.replace('.', '_')}{ext or '.json'}"


def cache_ttl_s() -> float:
    try:
        return float(os.environ.get(_TTL_ENV, DEFAULT_TTL_S))
    except ValueError:
        return DEFAULT_TTL_S


def _device_info(dev: torch.device) -> dict:
    """{platform, kind, count} of what runs on `dev`: the card, or the
    host's CPU."""
    if dev.type == "cuda":
        return {"platform": "gpu",
                "kind": torch.cuda.get_device_name(dev),
                "count": torch.cuda.device_count()}
    return {"platform": "cpu", "kind": "cpu", "count": 1}


def code_fingerprint(spec: str = "") -> dict:
    """The code-config part of the fingerprint: the canonical spec and a
    hash of its encode matrix, so a curve swept for one coefficient
    matrix is never read for another."""
    import hashlib

    from ..ops import rs_matrix
    from . import geometry as geo

    code = geo.parse_code(spec or "")
    mat = rs_matrix.encode_matrix_for(code)
    return {"spec": code.spec,
            "matrix_hash": hashlib.sha256(mat.tobytes()).hexdigest()[:16]}


def host_fingerprint(code: str = "") -> dict:
    """What must match for a cached curve to be trusted: same machine,
    same visible cards (their count too: a mesh curve must not outlive
    a card) behind the same torch and CUDA, same mesh shape knobs, same
    swept code (spec + encode-matrix hash), same probe schema."""
    import platform as _plat

    from ..parallel import mesh as pmesh

    return {"probe_version": PROBE_VERSION,
            "host": _plat.node(),
            "machine": _plat.machine(),
            "code": code_fingerprint(code),
            "device": (_device_info(torch.device("cuda", 0))
                       if torch.cuda.is_available() else None),
            "device_count": torch.cuda.device_count(),
            "torch": torch.__version__,
            "cuda": torch.version.cuda,
            "mesh_config": list(pmesh.mesh_config())}


# ----------------------------------------------------------------------
# measurement
# ----------------------------------------------------------------------

def measure_cpu_mbps(backend, coef: np.ndarray | None = None,
                     k: int = _K) -> float:
    """Steady rate of the CPU-side codec on the encode shape (k x 1 MiB
    parity matmul, RS(10,4) by default), input bytes per second."""
    from ..ops import rs_matrix

    if coef is None:
        coef = rs_matrix.parity_rows(_K, _M)
    blk = np.random.default_rng(0).integers(
        0, 256, (k, 1 << 20), dtype=np.uint8)
    backend.coded_matmul(coef, blk)  # warm (library load, chooser)
    t0 = _time.perf_counter()
    backend.coded_matmul(coef, blk)
    return blk.nbytes / (_time.perf_counter() - t0) / 1e6


def _blocks(seed: int, size: int, n_blocks: int, k: int) -> list:
    w = max(1, size // k)
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (k, w), dtype=np.uint8)
            for _ in range(n_blocks)]


def _drive(stream, n_blocks: int, shape: tuple[int, int]) -> None:
    got = 0
    for out in stream:
        got += 1
        if out.shape != shape:
            raise RuntimeError(f"feed yielded {out.shape}, expected {shape}")
    if got != n_blocks:
        raise RuntimeError(f"feed yielded {got} of {n_blocks} blocks")


def _measure_e2e_row(codec, coef, size: int, depth: int,
                     n_blocks: int, k: int = _K, m: int = _M) -> float:
    """Pipelined e2e MB/s at one (size, depth): n_blocks distinct
    (k, size/k) blocks, generated before the clock starts, through the
    staged streaming pipeline; input bytes / wall from first pread to
    last yield."""
    blocks = _blocks(size ^ depth, size, n_blocks, k)
    t0 = _time.perf_counter()
    _drive(codec.coded_matmul_stream(coef, iter(blocks), depth=depth),
           n_blocks, (m, blocks[0].shape[1]))
    return n_blocks * blocks[0].nbytes / (_time.perf_counter() - t0) / 1e6


def _measure_xfer_ceiling(codec, size: int, depth: int, n_blocks: int,
                          k: int = _K, m: int = _M) -> float:
    """Transfer-only twin of the row above: the same (k, w) blocks cross
    H2D and an (m, w) row slice crosses D2H through the same pinned
    ring, streams and depth (codec.transfer_stream) — what the link
    alone supports for this traffic shape."""
    blocks = _blocks(size * 31 + depth, size, n_blocks, k)
    t0 = _time.perf_counter()
    _drive(codec.transfer_stream(m, iter(blocks), depth=depth),
           n_blocks, (m, blocks[0].shape[1]))
    return n_blocks * blocks[0].nbytes / (_time.perf_counter() - t0) / 1e6


def _stage_sums(backend: str) -> dict[str, float]:
    return {s: metrics.counter_value("ec_codec_stage_seconds_sum",
                                     {"stage": s, "backend": backend})
            for s in STAGES}


def _device_codec(dev: torch.device):
    """(name, codec) of the preferred device backend on `dev`: the CUDA
    kernel first, then the dense torch product. On a CUDA device these
    are the registry's instances; a CPU sweep builds its own."""
    from ..ops import codec_cuda, codec_torch
    from . import backend as ecb

    for name in ("cuda", "torch"):
        if dev.type == "cuda":
            try:
                return name, ecb.get_backend(name)
            except KeyError:  # not registered: try the next preference
                continue
        cls = codec_cuda.CudaCodec if name == "cuda" \
            else codec_torch.TorchCodec
        return name, cls(device=dev)
    raise RuntimeError("no device codec backend is registered")


def run_sweep(sizes=SWEEP_SIZES, depths=SWEEP_DEPTHS,
              budget_s: float | None = None,
              with_ceilings: bool = True, code: str = "",
              device: str | torch.device = DEFAULT_DEVICE,
              mesh=None) -> dict:
    """Measure the curve for one code family (default: the RS(10,4)
    production feed) on `device`: the CPU codec's rate, then every
    (size, depth) row of the device feed within the budget, then the
    mesh rows within what is left of it. The mesh is `mesh` (a
    MeshCodec) when given, else, on a CUDA device with more than one
    card visible, the registry's `mesh`. Raises without a CUDA device
    unless `device="cpu"`, and raises when a device or mesh row
    fails."""
    from ..ops import rs_matrix
    from . import backend as ecb
    from . import geometry as geo

    dev = resolve_device(device)
    cfg = geo.parse_code(code or "")
    k, m = cfg.k, cfg.m
    coef = rs_matrix.encode_matrix_for(cfg)[k:]
    if budget_s is None:
        try:
            budget_s = float(os.environ.get(_BUDGET_ENV,
                                            DEFAULT_BUDGET_S))
        except ValueError:
            budget_s = DEFAULT_BUDGET_S
    t_start = _time.perf_counter()
    curve: dict = {"fingerprint": host_fingerprint(code),
                   "measured_at": _time.time(),
                   "budget_s": budget_s,
                   "code": cfg.spec,
                   "rows": []}
    cpu_name = ecb.cpu_backend_name()
    curve["cpu_backend"] = cpu_name
    curve["cpu_mbps"] = round(
        measure_cpu_mbps(ecb.get_backend(cpu_name), coef, k), 1)
    curve["device"] = _device_info(dev)
    name, codec = _device_codec(dev)
    curve["device_backend"] = name

    budget = _Budget(budget_s, t_start)
    curve["rows"] = _sweep_rows(codec, coef, sizes, depths, budget,
                                with_ceilings, k, m)
    if mesh is None and dev.type == "cuda" and torch.cuda.device_count() > 1:
        mesh = ecb.get_backend("mesh")
    if mesh is not None:
        curve["mesh"] = mesh.describe()
        # as the reference's mesh rows: no transfer-only twins, which
        # would double the mesh's share of the one budget
        curve["mesh_rows"] = _sweep_rows(mesh, coef, sizes, depths, budget,
                                         False, k, m)
    curve["sweep_seconds"] = round(_time.perf_counter() - t_start, 2)
    return curve


class _Budget:
    """The sweep's shared wall budget: a row is affordable when its
    projected time at the last measured rate fits in what is left;
    before any rate is known, only a positive remainder is required."""

    def __init__(self, seconds: float, t_start: float):
        self.seconds, self.t_start = seconds, t_start
        self.last_rate: float | None = None

    def affordable(self, nbytes: int) -> bool:
        remaining = self.seconds - (_time.perf_counter() - self.t_start)
        if self.last_rate:
            return nbytes / 1e6 / self.last_rate <= remaining
        return remaining > 0


def _sweep_rows(codec, coef, sizes, depths, budget: _Budget,
                with_ceilings: bool, k: int, m: int) -> list[dict]:
    """The size x depth rows of one device codec's feed (the card's, or
    the mesh's), each with its stage seconds and, with_ceilings, its
    transfer-only twin; rows the budget cannot afford are marked
    `"skipped": "budget"` instead of silently dropped."""
    # spin up the path (first launches, pinned buffers, executors)
    # outside every timed row
    _measure_e2e_row(codec, coef, 1 << 18, 1, n_blocks=2, k=k, m=m)
    rows: list[dict] = []
    for size in sorted(sizes):
        if not budget.affordable(2 * size):
            rows += [{"size": int(size), "depth": int(depth),
                      "skipped": "budget"} for depth in depths]
            continue
        # one warm block at this width: allocations of this size are
        # made before any timed row
        _measure_e2e_row(codec, coef, size, 1, n_blocks=1, k=k, m=m)
        if with_ceilings:
            _measure_xfer_ceiling(codec, size, 1, n_blocks=1, k=k, m=m)
        for depth in depths:
            n_blocks = depth + 2
            row = {"size": int(size), "depth": int(depth),
                   "blocks": n_blocks}
            rows.append(row)
            if not budget.affordable(n_blocks * size
                                     * (2 if with_ceilings else 1)):
                row["skipped"] = "budget"
                continue
            before = _stage_sums(codec.name)
            rate = _measure_e2e_row(codec, coef, size, depth, n_blocks,
                                    k=k, m=m)
            after = _stage_sums(codec.name)
            row["e2e_mbps"] = round(rate, 2)
            row["stages_s"] = {s: after[s] - before[s] for s in STAGES}
            budget.last_rate = rate
            if with_ceilings:
                ceil = _measure_xfer_ceiling(codec, size, depth,
                                             n_blocks, k=k, m=m)
                row["xfer_ceiling_mbps"] = round(ceil, 2)
                if ceil > 0:
                    row["vs_ceiling"] = round(rate / ceil, 2)
    return rows


# ----------------------------------------------------------------------
# disk cache
# ----------------------------------------------------------------------

def load_cached(path: str | None = None,
                ttl_s: float | None = None,
                code: str = "") -> dict | None:
    """The cached curve if present, parseable, same-host, same-code and
    fresh — else None. Corruption and expiry both land here as None: the
    caller sweeps anew."""
    path = path or cache_path(code)
    ttl_s = cache_ttl_s() if ttl_s is None else ttl_s
    try:
        with open(path, encoding="utf-8") as f:
            curve = json.load(f)
    except (OSError, ValueError):
        return None
    if not isinstance(curve, dict) or not isinstance(curve.get("rows"),
                                                     list):
        return None
    if curve.get("fingerprint") != host_fingerprint(code):
        return None
    try:
        age = _time.time() - float(curve.get("measured_at", 0))
    except (TypeError, ValueError):
        return None
    if age < 0 or age > ttl_s:
        return None
    return curve


def save_cache(curve: dict, path: str | None = None) -> None:
    """Atomic write (rename), so a crashed writer leaves the old cache
    intact, not a half-written JSON."""
    path = path or cache_path()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(curve, f, indent=1)
    os.replace(tmp, path)


def get_curve(refresh: bool = False, code: str = "") -> dict:
    """The active curve for one code family: process memo -> disk cache
    -> fresh sweep on the card (persisted)."""
    memo = _curves.get(code)
    if memo is not None and not refresh:
        return memo
    curve = None if refresh else load_cached(code=code)
    if curve is None:
        curve = run_sweep(code=code)
        save_cache(curve, cache_path(code))
        curve["source"] = "fresh"
    else:
        curve["source"] = "cache"
    _curves[code] = curve
    return curve


def peek(code: str = "") -> dict | None:
    """The curve if this process already has one (memo or a valid disk
    cache) — never sweeps."""
    memo = _curves.get(code)
    if memo is not None:
        return memo
    curve = load_cached(code=code)
    if curve is not None:
        curve["source"] = "cache"
        _curves[code] = curve
    return curve


def invalidate() -> None:
    """Drop the process memo, all codes."""
    _curves.clear()


# ----------------------------------------------------------------------
# curve reading
# ----------------------------------------------------------------------

def measured_rows(curve: dict, key: str = "rows") -> list[dict]:
    return [r for r in curve.get(key, [])
            if isinstance(r.get("e2e_mbps"), (int, float))]


def best_by_size(curve: dict,
                 key: str = "rows") -> list[tuple[int, float, int]]:
    """[(size, best_e2e_mbps, best_depth)] ascending by size."""
    best: dict[int, tuple[float, int]] = {}
    for r in measured_rows(curve, key):
        size, rate, depth = int(r["size"]), float(r["e2e_mbps"]), \
            int(r["depth"])
        if size not in best or rate > best[size][0]:
            best[size] = (rate, depth)
    return [(s, best[s][0], best[s][1]) for s in sorted(best)]


def _interp_at(pts: list[tuple[int, float, int]],
               nbytes: int) -> float | None:
    if not pts:
        return None
    nbytes = max(1, int(nbytes))
    if len(pts) == 1 or nbytes <= pts[0][0]:
        return pts[0][1]
    if nbytes >= pts[-1][0]:
        return pts[-1][1]
    xs = np.log2([p[0] for p in pts])
    ys = [p[1] for p in pts]
    return float(np.interp(np.log2(nbytes), xs, ys))


def e2e_mbps_at(curve: dict, nbytes: int) -> float | None:
    """Device e2e MB/s the measured curve predicts for a request of
    `nbytes`: piecewise-linear in log2(size) over the best depth per
    measured size, clamped to the measured range."""
    return _interp_at(best_by_size(curve), nbytes)


def _nearest_depth(pts: list[tuple[int, float, int]],
                   nbytes: int) -> int:
    if not pts:
        return 2
    nbytes = max(1, int(nbytes))
    target = np.log2(nbytes)
    best = min(pts, key=lambda p: abs(np.log2(p[0]) - target))
    return best[2]


def depth_at(curve: dict, nbytes: int) -> int:
    """Pipeline depth of the nearest measured size (2 when the curve is
    empty): what the feed should run for this request size."""
    return _nearest_depth(best_by_size(curve), nbytes)


def mesh_mbps_at(curve: dict, nbytes: int) -> float | None:
    """Mesh-codec e2e MB/s at `nbytes`: the same interpolation over the
    mesh rows; None when no mesh was swept (a one-card host)."""
    return _interp_at(best_by_size(curve, "mesh_rows"), nbytes)


def mesh_depth_at(curve: dict, nbytes: int) -> int:
    """Pipeline depth the mesh rows recommend at `nbytes` (2 when no mesh
    row was measured)."""
    return _nearest_depth(best_by_size(curve, "mesh_rows"), nbytes)


def summary(curve: dict) -> dict:
    """Compact view for logs: per-size best rates plus the CPU rate the
    router compares against."""
    out = {
        "cpu_backend": curve.get("cpu_backend"),
        "cpu_mbps": curve.get("cpu_mbps"),
        "device": curve.get("device"),
        "device_backend": curve.get("device_backend"),
        "best_by_size_mb": {
            str(s >> 20): {"e2e_mbps": round(r, 2), "depth": d}
            for s, r, d in best_by_size(curve)},
        "skipped_rows": sum(1 for r in curve.get("rows", [])
                            if r.get("skipped")),
        "measured_at": curve.get("measured_at"),
        "source": curve.get("source"),
    }
    if curve.get("mesh") is not None:
        out["mesh"] = curve["mesh"]
        out["mesh_best_by_size_mb"] = {
            str(s >> 20): {"e2e_mbps": round(r, 2), "depth": d}
            for s, r, d in best_by_size(curve, "mesh_rows")}
    return out
