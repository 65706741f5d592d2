"""Minimal Prometheus-style metrics registry.

Equivalent role to the reference's weed/stats/metrics.go:31-140: counters,
gauges and latency histograms rendered in the text exposition format.
Stdlib-only copy of seaweedfs_tpu/utils/metrics.py without the
pushgateway loop, which no module of the port uses yet.
"""
from __future__ import annotations

import threading
from collections import defaultdict

_lock = threading.Lock()
_counters: dict[tuple[str, tuple], float] = defaultdict(float)
_gauges: dict[tuple[str, tuple], float] = {}
_histograms: dict[tuple[str, tuple], list[int]] = {}
_HIST_BUCKETS = [0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1, 5, 10]


def _key(name: str, labels: dict | None) -> tuple[str, tuple]:
    return name, tuple(sorted((labels or {}).items()))


def counter_add(name: str, value: float = 1,
                labels: dict | None = None) -> None:
    with _lock:
        _counters[_key(name, labels)] += value


def gauge_set(name: str, value: float, labels: dict | None = None) -> None:
    with _lock:
        _gauges[_key(name, labels)] = value


def histogram_observe(name: str, seconds: float,
                      labels: dict | None = None) -> None:
    key = _key(name, labels)
    with _lock:
        buckets = _histograms.get(key)
        if buckets is None:
            buckets = [0] * (len(_HIST_BUCKETS) + 1)
            _histograms[key] = buckets
        for i, ub in enumerate(_HIST_BUCKETS):
            if seconds <= ub:
                buckets[i] += 1
                break
        else:
            buckets[-1] += 1
        _counters[_key(name + "_sum", labels)] += seconds
        _counters[_key(name + "_count", labels)] += 1


def _escape_label_value(v) -> str:
    # text exposition format: \ " and newline must be escaped in values
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _fmt_labels(labels: tuple) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_escape_label_value(v)}"' for k, v in labels)
    return "{" + inner + "}"


def render() -> str:
    """Text exposition format: one `# TYPE` line per family, histogram
    `_sum`/`_count` kept adjacent to their `_bucket` series."""
    lines = []
    with _lock:
        hist_names = {name for name, _ in _histograms}

        def is_hist_component(name: str) -> bool:
            return ((name.endswith("_sum") and name[:-4] in hist_names)
                    or (name.endswith("_count")
                        and name[:-6] in hist_names))

        last_family = None
        for (name, labels), v in sorted(_counters.items()):
            if is_hist_component(name):
                continue  # rendered with its histogram below
            if name != last_family:
                lines.append(f"# TYPE {name} counter")
                last_family = name
            lines.append(f"{name}{_fmt_labels(labels)} {v}")
        last_family = None
        for (name, labels), v in sorted(_gauges.items()):
            if name != last_family:
                lines.append(f"# TYPE {name} gauge")
                last_family = name
            lines.append(f"{name}{_fmt_labels(labels)} {v}")
        last_family = None
        for (name, labels), buckets in sorted(_histograms.items()):
            if name != last_family:
                lines.append(f"# TYPE {name} histogram")
                last_family = name
            cum = 0
            for i, ub in enumerate(_HIST_BUCKETS):
                cum += buckets[i]
                lab = dict(labels)
                lab["le"] = str(ub)
                lines.append(
                    f"{name}_bucket{_fmt_labels(tuple(sorted(lab.items())))}"
                    f" {cum}")
            cum += buckets[-1]
            lab = dict(labels)
            lab["le"] = "+Inf"
            lines.append(
                f"{name}_bucket{_fmt_labels(tuple(sorted(lab.items())))}"
                f" {cum}")
            s = _counters.get((name + "_sum", labels), 0.0)
            c = _counters.get((name + "_count", labels), 0.0)
            lines.append(f"{name}_sum{_fmt_labels(labels)} {s}")
            lines.append(f"{name}_count{_fmt_labels(labels)} {c}")
    return "\n".join(lines) + "\n"


def reset() -> None:
    with _lock:
        _counters.clear()
        _gauges.clear()
        _histograms.clear()


def counter_value(name: str, labels: dict | None = None) -> float:
    """Current value of one counter series (a histogram's `_sum` and
    `_count` are counters too), 0.0 when it was never touched."""
    with _lock:
        return _counters.get(_key(name, labels), 0.0)
