"""Everything a run finds by name: the cell and its metrics in
`BENCHMARK.json`, the configuration's file, the traffic mix's data file
and each per-layer metric's reader.

Lookups, all from the names in `BENCHMARK.json`:
  configuration  the `file` of its `configs` entry
  traffic mix    `traffic/<mix>.json` beside this file
  metric reader  `metrics/<name>.py`, else `metrics/<stem>.py` where the
                 stem is the name up to its first dot, so that the splits
                 of one quantity (`pin_s_per_GB.encode`, `.scrub`) share
                 one reader; it defines `read(record) -> float | None`
A later cell, mix or metric is a new entry and a new file; no file here
changes for it.
"""
from __future__ import annotations

import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)


class Spec:
    """One cell of a benchmark file, with what it names."""

    def __init__(self, cell: str, root: str = ROOT,
                 bench_dir: str = BENCH_DIR, bench: dict | None = None):
        self.root, self.bench_dir = root, bench_dir
        if bench is None:
            with open(os.path.join(root, "BENCHMARK.json")) as f:
                bench = json.load(f)
        self.bench = bench
        cells = {w["name"]: w for w in self.bench["workloads"]}
        if cell not in cells:
            raise KeyError(f"no workload {cell!r}; known: {sorted(cells)}")
        self.cell = cells[cell]
        entry = next(c for c in self.bench["configs"]
                     if c["name"] == self.cell["config"])
        with open(os.path.join(root, entry["file"])) as f:
            self.config = json.load(f)
        self.traffic = load_traffic(self.cell["traffic"], bench_dir)

    def metrics(self, trace: bool) -> list[dict]:
        """The cell's end-to-end metrics, or with `trace` its per-layer
        ones: those that list it under `workloads` or list none."""
        group = self.bench["per_layer" if trace else "end_to_end"]
        name = self.cell["name"]
        return [m for m in group
                if "workloads" not in m or name in m["workloads"]]

    def reader(self, metric: str):
        return load_reader(metric, self.bench_dir)


def load_traffic(mix: str, bench_dir: str = BENCH_DIR) -> dict:
    with open(os.path.join(bench_dir, "traffic", mix + ".json")) as f:
        return json.load(f)


def load_reader(metric: str, bench_dir: str = BENCH_DIR):
    """The `read` function of the metric's reader file."""
    for stem in (metric, metric.split(".")[0]):
        path = os.path.join(bench_dir, "metrics", stem + ".py")
        if os.path.exists(path):
            spec = importlib.util.spec_from_file_location(
                "bench_port_metric_" + stem.replace(".", "_"), path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod.read
    raise FileNotFoundError(f"no reader for metric {metric!r} under "
                            f"{os.path.join(bench_dir, 'metrics')}")
