"""One run of one cell: set-up, the measured window, the plain reference,
and the result line.

The order is fixed: set-up (inputs made from the seed, every shape of
the window warmed; `setup_s` counts from the process's start to here),
the window (under `torch.profiler` with `--trace 1`), the device's
memory peak, a look for JAX in the process, the program's state
released, the reference over the same inputs, the comparison, and the
result. `run()` takes `device="cpu"` to skip the look for a card, for
the tests; the benchmark itself always runs on the card.
"""
from __future__ import annotations

import gc
import subprocess
import sys
import time
from dataclasses import dataclass

import torch

from . import devtrace
from .drivers import DRIVERS
from .spec import Spec

# Top-level module names that must not be loaded: JAX, and the JAX
# package of which the measured program is the port. Compared whole.
FORBIDDEN = ("jax", "jaxlib", "flax", "seaweedfs_tpu")


class NoDevice(RuntimeError):
    """Fewer cards than the cell asks for."""


class ForbiddenImport(RuntimeError):
    """The process holds a module it must not."""


def forbidden_modules(names=None) -> list[str]:
    """The FORBIDDEN top-level names among `names` (default: sys.modules)."""
    tops = {n.split(".")[0] for n in (sys.modules if names is None else names)}
    return sorted(tops & set(FORBIDDEN))


@dataclass
class Context:
    seed: int
    device: torch.device
    backend: object
    config: dict
    traffic: dict


def _backend(name: str, device: torch.device, control: bool):
    """What the driver hands the program as its codec backend: the name
    on the card; on the CPU the kernel's backend built for the CPU (it
    runs the kernel's plain version); the control when asked."""
    if control:
        from .reference.control import ControlCodec

        return ControlCodec(device)
    if device.type == "cpu" and name == "cuda":
        from seaweedfs_tpu_torch.ops.codec_cuda import CudaCodec

        return CudaCodec(device="cpu")
    return name


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def write_bytes() -> int | None:
    """Bytes this process caused to be written to storage so far."""
    try:
        with open("/proc/self/io") as f:
            for line in f:
                if line.startswith("write_bytes:"):
                    return int(line.split()[1])
    except OSError:
        pass
    return None


def _device(chips: int, device: str | None) -> torch.device:
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise NoDevice("torch.cuda.is_available() is False")
    if torch.cuda.device_count() < chips:
        raise NoDevice(f"{torch.cuda.device_count()} cards visible, the "
                       f"cell asks for {chips}")
    return torch.device("cuda", 0)


def run(cell: str, seed: int, seconds: float, trace: bool, *,
        t_start: float, device: str | None = None, control: bool = False,
        spec: Spec | None = None, log=None) -> tuple[dict, list[str]]:
    """Run one cell once -> (the result object, the lines that name each
    number compared with its limit). `log(line)` gets the earlier lines."""
    log = log or (lambda line: print(line, flush=True))
    spec = spec or Spec(cell)
    chips = int(spec.cell["chips"])
    dev = _device(chips, device)
    ctx = Context(seed, dev,
                  _backend(spec.traffic["backend"], dev, control),
                  spec.config, spec.traffic)
    driver = DRIVERS[spec.traffic["driver"]](ctx)

    def progress(what: str) -> None:
        print(f"bench_port: {what} at {time.perf_counter() - t_start:.3f} s",
              file=sys.stderr, flush=True)

    try:
        driver.setup()
        setup_s = time.perf_counter() - t_start
        progress("set-up done")
        if dev.type == "cuda":
            # the seeded inputs are made on the card at set-up; the
            # peak reported is the program's, over the window
            torch.cuda.reset_peak_memory_stats(dev)
        with devtrace.profiled(trace and dev.type == "cuda",
                               spec.traffic.get("product_kernels", ())) as tr:
            rec = driver.window(seconds)
        progress("window done")
        cuda = dev.type == "cuda"
        if cuda:
            torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
        found = forbidden_modules()
        if found:
            raise ForbiddenImport("loaded in the measuring process: "
                                  + ", ".join(found))
        driver.release()
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        checks, failed = driver.check()
        progress("reference done")
    finally:
        driver.cleanup()

    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    log(f"bench_port: cell={cell} seed={seed} device={kind!r} "
        f"card={power_limit() if dev.type == 'cuda' else 'none'!r} "
        f"attempted={rec['attempted']} window_span_s={rec['span_s']!r}")
    if tr:
        log(f"bench_port: kernel_s={tr['kernel_s']!r} "
            f"other_kernel_s={tr['other_kernel_s']!r}")
    if tr.get("host_calls"):
        log("bench_port: host CUDA calls (s) " + " ".join(
            f"{n}={s!r}" for n, s in tr["host_calls"]))
    if "codec_s" in rec:
        log(f"bench_port: fetch_s={rec['fetch_s']!r} "
            f"codec_s={rec['codec_s']!r}")
    if rec.get("op_s"):
        log(f"bench_port: op_s={[round(t, 4) for t in rec['op_s']]}")
    values = dict(rec["values"], setup_s=setup_s)
    metrics = {}
    if trace:
        record = dict(rec, trace=tr, device_kind=kind)
        for m in spec.metrics(True):
            v = spec.reader(m["name"])(record)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in spec.metrics(False):
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    correct = (rec["attempted"] > 0 and failed == 0
               and all(v <= lim for v, lim in checks.values()))
    device_out = {"platform": "gpu" if dev.type == "cuda" else "cpu",
                  "kind": kind, "count": chips if dev.type == "cuda" else 0,
                  "memory_peak_bytes": int(peak)}
    if trace and tr:
        device_out.update(busy_s=tr["busy_s"], window_s=tr["window_s"])
    result = {"correct": correct, "attempted": int(rec["attempted"]),
              "failed": int(failed), "metrics": metrics,
              "device": device_out}
    if trace and tr:
        result["breakdown"] = {"device_ops": tr["device_ops"],
                               "idle_gaps": tr["idle_gaps"]}
    result["checks"] = {name: {"value": v, "limit": lim}
                        for name, (v, lim) in checks.items()}
    log(f"bench_port: write_bytes={write_bytes()}")
    lines = [f"check {name}: {v} (limit {lim})"
             for name, (v, lim) in checks.items()]
    return result, lines
