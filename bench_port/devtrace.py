"""The device trace of a `--trace 1` run: `torch.profiler` over the
window, reduced to what the per-layer readers and the result line need.

From the trace's device events (kernels, copies, fills) inside the
window's own annotation it takes:
  busy_s            the union of their intervals
  window_s          the annotation's length
  kernel_s          the summed time of the coded product's kernels: those
                    whose name holds one of the traffic mix's
                    `product_kernels`
  other_kernel_s    the summed time of every other kernel, so that a
                    kernel that joins the path shows and never counts as
                    product time
  device_ops        the ten device operations that took most time
  idle_gaps         the ten longest gaps with no device event, each named
                    by the host event that covers most of it, if one covers
                    half (waits for the device are not work and name none)
  host_calls        the ten CUDA runtime calls that took most host time
"""
from __future__ import annotations

import contextlib
import json
import os
import tempfile
import warnings

WINDOW_NAME = "bench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
WAITS = ("cudaEventSynchronize", "cudaEventQuery", "cudaStreamSynchronize",
         "cudaStreamWaitEvent", "cudaDeviceSynchronize")
UNNAMED = "host: outside torch and CUDA calls (Python, numpy)"
TOP = 10


@contextlib.contextmanager
def profiled(enabled: bool, product_kernels=()):
    """Profile the block when `enabled`; yields a dict that holds the
    reduction (see `reduce_trace`) once the block has ended."""
    out: dict = {}
    if not enabled:
        yield out
        return
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    with warnings.catch_warnings():
        # one profiling cycle: its note about clearing events says nothing
        warnings.filterwarnings("ignore", message=".*Profiler clears events")
        with prof:
            with record_function(WINDOW_NAME):
                yield out
                torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json", prefix="bench-trace-")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            out.update(reduce_trace(json.load(f), product_kernels))
    finally:
        os.remove(path)


def _merge(intervals: list[tuple[float, float]]) -> list[list[float]]:
    merged: list[list[float]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def reduce_trace(trace: dict, product_kernels=()) -> dict:
    """Chrome-trace dict -> busy_s, window_s, kernel_s, other_kernel_s,
    device_ops, idle_gaps (seconds), or {} when the trace holds no
    window. A kernel is the product's when its name holds one of
    `product_kernels`."""
    events = [e for e in trace.get("traceEvents", [])
              if e.get("ph") == "X" and "dur" in e]
    windows = [e for e in events if e.get("name") == WINDOW_NAME
               and e.get("cat") in ("user_annotation", "cpu_op")]
    if not windows:
        return {}
    w = max(windows, key=lambda e: e["dur"])
    w0, w1 = float(w["ts"]), float(w["ts"]) + float(w["dur"])

    def clip(e):
        s = max(w0, float(e["ts"]))
        return s, max(s, min(w1, float(e["ts"]) + float(e["dur"])))

    device = [e for e in events if e.get("cat") in DEVICE_CATS]
    busy = _merge([clip(e) for e in device])
    busy_us = sum(e - s for s, e in busy)
    kernel_us = {True: 0.0, False: 0.0}
    for e in device:
        if e.get("cat") == "kernel":
            s, t = clip(e)
            kernel_us[any(p in e["name"] for p in product_kernels)] += t - s
    by_name: dict[str, float] = {}
    for e in device:
        s, t = clip(e)
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + (t - s) / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]

    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:TOP]
    host = [e for e in events if e.get("cat") in HOST_CATS
            and e.get("name") != WINDOW_NAME]
    named = []
    for g0, g1 in gaps:
        best, best_us = UNNAMED, (g1 - g0) / 2
        for e in host:
            ov = min(g1, e["ts"] + e["dur"]) - max(g0, e["ts"])
            if ov >= best_us and e["name"] not in WAITS:
                best, best_us = f"host: {e['name']}", ov
        named.append([best, (g1 - g0) / 1e6])
    calls: dict[str, float] = {}
    for e in host:
        if e.get("cat") == "cuda_runtime":
            calls[e["name"]] = calls.get(e["name"], 0.0) + e["dur"] / 1e6
    return {"busy_s": busy_us / 1e6, "window_s": (w1 - w0) / 1e6,
            "kernel_s": kernel_us[True] / 1e6,
            "other_kernel_s": kernel_us[False] / 1e6,
            "device_ops": [[n, s] for n, s in ops], "idle_gaps": named,
            "host_calls": sorted(calls.items(), key=lambda kv: -kv[1])[:TOP]}
