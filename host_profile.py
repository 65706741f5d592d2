#!/usr/bin/env python3
"""Where the server middlewares spend the host's time in chip_smoke.py's
phase 9 (the self-healing cell: a master and five volume servers in one
process, a 1 GiB volume, watchdog rebuilds through the CUDA kernel).

    python3 host_profile.py        # from the repo root, on a host with one GPU

Runs phase 9 four times in one process, in the order on, off, off, on:

* `on`: as shipped.
* `off`: the master's span sink is not registered (its collector sees
  no span) and the `request_trace_seconds` histogram is not observed.

In every run the same wrappers sum the thread CPU time (time.thread_time)
spent in each piece, so the accounting costs the same in both modes:

* `tracing_mw`, `deadline_mw`, `faults_mw`: each server middleware's
  own time, its handler's excluded (tracing_mw holds the server span's
  `finish`);
* `finish`: every span's finish (the ring, the histogram, the sinks),
  server and client spans alike;
* `sink`: the master's span sink (SpanCollector.add_spans);
* `histogram`: the `request_trace_seconds` observations;
* `process_cpu`: the process's CPU time over the phase.

Prints one JSON line per run ({"mode", "phase_s", "cpu_s": {...},
"calls": {...}}), then the card's name and power limit.
"""
from __future__ import annotations

import json
import threading
import time

import chip_smoke

ORDER = ("on", "off", "off", "on")


class _Ledger:
    def __init__(self):
        self._lock = threading.Lock()
        self.cpu: dict[str, float] = {}
        self.calls: dict[str, int] = {}

    def add(self, key: str, seconds: float) -> None:
        with self._lock:
            self.cpu[key] = self.cpu.get(key, 0.0) + seconds
            self.calls[key] = self.calls.get(key, 0) + 1


def _timed_middleware(factory, key: str, ledger: _Ledger):
    def make(*args, **kw):
        mw = factory(*args, **kw)

        def wrapped(req, handler):
            inner = [0.0]

            def timed_handler(r):
                t = time.thread_time()
                try:
                    return handler(r)
                finally:
                    inner[0] += time.thread_time() - t

            t0 = time.thread_time()
            try:
                return mw(req, timed_handler)
            finally:
                ledger.add(key, time.thread_time() - t0 - inner[0])
        return wrapped
    return make


def _timed(fn, key: str, ledger: _Ledger):
    def wrapped(*args, **kw):
        t0 = time.thread_time()
        try:
            return fn(*args, **kw)
        finally:
            ledger.add(key, time.thread_time() - t0)
    return wrapped


def _install(mode: str, ledger: _Ledger):
    """Patch the port's tracing, deadline, fault and metrics modules
    for one run -> a function that undoes it."""
    from seaweedfs_tpu_torch.utils import faults, metrics, retry, tracing

    saved = [(tracing, "middleware"), (retry, "middleware"),
             (faults, "middleware"), (tracing, "_finish"),
             (tracing, "add_sink"), (tracing, "remove_sink"),
             (metrics, "histogram_observe")]
    saved = [(mod, name, getattr(mod, name)) for mod, name in saved]
    orig = {name: fn for _, name, fn in saved
            if name not in ("middleware",)}
    tracing.middleware = _timed_middleware(saved[0][2], "tracing_mw",
                                           ledger)
    retry.middleware = _timed_middleware(saved[1][2], "deadline_mw",
                                         ledger)
    faults.middleware = _timed_middleware(saved[2][2], "faults_mw",
                                          ledger)
    tracing._finish = _timed(orig["_finish"], "finish", ledger)
    wrappers: dict = {}

    def add_sink(fn):
        if mode == "on":
            wrappers[fn] = _timed(fn, "sink", ledger)
            orig["add_sink"](wrappers[fn])

    def remove_sink(fn):
        if fn in wrappers:
            orig["remove_sink"](wrappers.pop(fn))

    tracing.add_sink, tracing.remove_sink = add_sink, remove_sink
    observe = orig["histogram_observe"]
    timed_observe = _timed(observe, "histogram", ledger)

    def histogram_observe(name, seconds, labels=None):
        if name != "request_trace_seconds":
            return observe(name, seconds, labels)
        if mode == "on":
            timed_observe(name, seconds, labels)

    metrics.histogram_observe = histogram_observe

    def undo():
        for fn in list(wrappers):
            remove_sink(fn)
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    return undo


def main() -> int:
    card = chip_smoke.phase_device()
    for mode in ORDER:
        ledger = _Ledger()
        undo = _install(mode, ledger)
        try:
            cpu0, t0 = time.process_time(), time.perf_counter()
            chip_smoke.phase_heal(card)
            phase_s = time.perf_counter() - t0
            ledger.cpu["process_cpu"] = time.process_time() - cpu0
        finally:
            undo()
        print(json.dumps({"mode": mode, "phase_s": phase_s,
                          "cpu_s": ledger.cpu, "calls": ledger.calls}),
              flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
