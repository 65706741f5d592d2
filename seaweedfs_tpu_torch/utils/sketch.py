"""Quantile sketches for workload-characterization telemetry; a copy of
seaweedfs_tpu/utils/sketch.py (stdlib only). The Store keeps its
per-volume read/write gap and size sketches here.

The measured-distribution substrate: before any controller threshold
can be driven by data, every layer that today only *counts* (volume
heat, tenant demand, queue delay) needs a cheap way to keep whole
*distributions* and ship them to the master. This module is that
primitive, shaped like DDSketch (Masson et al., VLDB
2019) — the same trade the workload-characterization literature this
repo follows (arXiv 1709.05365) makes when summarizing access-gap and
request-size distributions:

* **Log-bucketed histogram with a relative-error guarantee.** Values
  land in geometric buckets of ratio ``gamma = (1+alpha)/(1-alpha)``;
  any quantile read back is within ``alpha`` *relative* error of the
  exact stream quantile (default 1%). Relative — not rank — error is
  the right contract for latencies/gaps/sizes spanning 6+ decades:
  p99 = 2.02 s for a true 2 s is fine, "somewhere between p98 and
  p100" is not.
* **Constant memory.** Bucket count grows with the log of the value
  range, not the stream length (~180 buckets cover 1 µs..1 day at
  alpha=0.01 — in practice far fewer are touched). A hard
  ``max_buckets`` cap collapses the smallest buckets first, so a
  pathological range degrades the *low* quantiles only.
* **Lock-cheap record path.** ``record()`` is one ``math.log``, one
  dict upsert and a few scalar updates — no internal lock. Call
  sites serialize writers themselves (the in-tree taps record under
  an already-held short lock, or from a single thread); readers take
  a consistent copy via ``to_dict()``/``merge`` on a snapshot.
* **Mergeable and serializable.** ``merge(a, b)`` is bucket-wise
  addition and is *exactly* equivalent to sketching the concatenated
  stream (same buckets, same counts — not just same error bound), so
  per-volume sketches fold into per-node, per-node into cluster-wide,
  without re-touching raw data. ``to_dict()``/``from_dict()`` is a
  compact JSON-safe encoding that round-trips losslessly and rides
  the existing heartbeat plumbing.

``WindowedSketch`` wraps N rotating sub-sketches so long-running
servers report the *recent* distribution (default 5 min window in 6
slices) instead of an all-of-time average that can never change its
mind after a workload phase shift.

Module-level ``configure()``/``enabled()`` carry the ``-telemetry.*``
CLI flags; recording taps all consult ``enabled()`` so the whole
plane can be switched off (the workload-sweep bench gates the
enabled-vs-disabled hot-path delta).
"""
from __future__ import annotations

import math
import threading

# documented relative-error bound of every quantile read back
DEFAULT_ALPHA = 0.01
# below this, a value is counted in the zero bucket (gaps/sizes of 0
# are real: back-to-back accesses, empty bodies)
MIN_TRACKABLE = 1e-9
# hard bucket cap; collapse folds the smallest buckets together so
# upper quantiles (the ones advisors read) stay exact-within-alpha
DEFAULT_MAX_BUCKETS = 512


class QuantileSketch:
    """DDSketch-style log-bucketed quantile sketch.

    Writers are NOT internally synchronized — see the module
    docstring's lock-cheap contract.
    """

    __slots__ = ("alpha", "gamma", "_log_gamma", "max_buckets",
                 "buckets", "zeros", "count", "total", "min", "max")

    def __init__(self, alpha: float = DEFAULT_ALPHA,
                 max_buckets: int = DEFAULT_MAX_BUCKETS):
        if not 0.0 < alpha < 1.0:
            raise ValueError(f"alpha must be in (0, 1), got {alpha}")
        self.alpha = float(alpha)
        self.gamma = (1.0 + alpha) / (1.0 - alpha)
        self._log_gamma = math.log(self.gamma)
        self.max_buckets = max(8, int(max_buckets))
        self.buckets: dict[int, int] = {}
        self.zeros = 0
        self.count = 0
        self.total = 0.0
        self.min = math.inf
        self.max = -math.inf

    # -- recording ------------------------------------------------------

    def record(self, value: float, n: int = 1) -> None:
        """Count ``value`` (``n`` times). Negative values clamp to the
        zero bucket — gaps/sizes/delays are non-negative by
        construction, and a clock hiccup must not throw."""
        if n <= 0:
            return
        v = float(value)
        self.count += n
        if v > 0:
            self.total += v * n
        if v < self.min:
            self.min = max(v, 0.0)
        if v > self.max:
            self.max = v
        if v < MIN_TRACKABLE:
            self.zeros += n
            return
        idx = int(math.ceil(math.log(v) / self._log_gamma))
        b = self.buckets
        b[idx] = b.get(idx, 0) + n
        if len(b) > self.max_buckets:
            self._collapse()

    def _collapse(self) -> None:
        """Fold the two smallest buckets together until under the cap.
        Low quantiles blur; the upper quantiles advisors consume keep
        the alpha guarantee."""
        idxs = sorted(self.buckets)
        while len(idxs) > self.max_buckets:
            lo = idxs.pop(0)
            self.buckets[idxs[0]] += self.buckets.pop(lo)

    # -- queries --------------------------------------------------------

    def _bucket_value(self, idx: int) -> float:
        # midpoint estimator: relative error <= (gamma-1)/(gamma+1)
        # == alpha for any value in the bucket
        return 2.0 * self.gamma ** idx / (self.gamma + 1.0)

    def quantile(self, q: float) -> float:
        """The q-quantile (0 <= q <= 1) of the recorded stream, within
        ``alpha`` relative error of the exact stream quantile."""
        if self.count == 0:
            return 0.0
        q = min(1.0, max(0.0, q))
        rank = q * (self.count - 1)
        seen = self.zeros
        if rank < seen:
            return 0.0
        for idx in sorted(self.buckets):
            seen += self.buckets[idx]
            if rank < seen:
                return self._bucket_value(idx)
        return self._bucket_value(max(self.buckets)) \
            if self.buckets else 0.0

    def quantiles(self, qs) -> dict[str, float]:
        return {str(q): self.quantile(float(q)) for q in qs}

    def fraction_below(self, value: float) -> float:
        """CDF estimate: fraction of recorded values <= ``value``
        (the advisor's coverage read: how much of the stream a
        threshold already captures)."""
        if self.count == 0:
            return 0.0
        if value < MIN_TRACKABLE:
            return self.zeros / self.count
        limit = int(math.ceil(math.log(value) / self._log_gamma))
        below = self.zeros + sum(c for i, c in self.buckets.items()
                                 if i <= limit)
        return min(1.0, below / self.count)

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    # -- merge / serialize ---------------------------------------------

    def merge(self, other: "QuantileSketch") -> "QuantileSketch":
        """Fold ``other`` into self. Exactly equivalent to having
        sketched the concatenated stream (bucket-wise addition)."""
        if abs(other.alpha - self.alpha) > 1e-12:
            raise ValueError(
                f"cannot merge sketches with different alpha "
                f"({self.alpha} vs {other.alpha})")
        for idx, c in other.buckets.items():
            self.buckets[idx] = self.buckets.get(idx, 0) + c
        if len(self.buckets) > self.max_buckets:
            self._collapse()
        self.zeros += other.zeros
        self.count += other.count
        self.total += other.total
        self.min = min(self.min, other.min)
        self.max = max(self.max, other.max)
        return self

    def to_dict(self) -> dict:
        """Compact JSON-safe encoding (heartbeat wire format). Bucket
        keys become strings in JSON; from_dict accepts both."""
        out: dict = {"a": self.alpha, "n": self.count}
        if self.zeros:
            out["z"] = self.zeros
        if self.buckets:
            out["b"] = {str(i): c for i, c in self.buckets.items()}
        if self.count:
            out["t"] = round(self.total, 6)
            out["lo"] = self.min
            out["hi"] = self.max
        return out

    @classmethod
    def from_dict(cls, d: dict,
                  max_buckets: int = DEFAULT_MAX_BUCKETS
                  ) -> "QuantileSketch":
        sk = cls(alpha=float(d.get("a", DEFAULT_ALPHA)),
                 max_buckets=max_buckets)
        sk.zeros = int(d.get("z", 0))
        sk.count = int(d.get("n", 0))
        sk.total = float(d.get("t", 0.0))
        sk.min = float(d.get("lo", math.inf))
        sk.max = float(d.get("hi", -math.inf))
        for i, c in (d.get("b") or {}).items():
            sk.buckets[int(i)] = int(c)
        return sk

    def summary(self, qs=(0.5, 0.9, 0.99)) -> dict:
        """Human-facing digest for /debug payloads."""
        out = {"count": self.count, "mean": round(self.mean, 6)}
        if self.count:
            out["min"] = round(self.min, 6)
            out["max"] = round(self.max, 6)
            for q in qs:
                out[f"p{int(q * 100)}"] = round(self.quantile(q), 6)
        return out


class WindowedSketch:
    """Sliding-window wrapper: a ring of sub-sketches rotated by time,
    so ``merged()`` reflects only the trailing ``window`` seconds and
    a workload phase shift ages out instead of being averaged away.

    ``record``/``merged`` take an explicit ``now`` so tests and the
    heartbeat path stay deterministic; callers pass ``time.time()``.
    Same synchronization contract as QuantileSketch: writers
    serialize themselves.
    """

    __slots__ = ("alpha", "window", "slices", "_slice_len", "_ring")

    def __init__(self, alpha: float = DEFAULT_ALPHA,
                 window: float = 300.0, slices: int = 6):
        self.alpha = float(alpha)
        self.window = max(1.0, float(window))
        self.slices = max(2, int(slices))
        self._slice_len = self.window / self.slices
        # [(slice_start_epoch, sketch)] newest last
        self._ring: list[tuple[int, QuantileSketch]] = []

    def _epoch(self, now: float) -> int:
        return int(now / self._slice_len)

    def record(self, value: float, now: float) -> None:
        ep = self._epoch(now)
        if not self._ring or self._ring[-1][0] != ep:
            self._ring.append((ep, QuantileSketch(self.alpha)))
            oldest = ep - self.slices + 1
            while self._ring and self._ring[0][0] < oldest:
                self._ring.pop(0)
        self._ring[-1][1].record(value)

    def merged(self, now: float) -> QuantileSketch:
        """The trailing-window distribution (expired slices dropped)."""
        out = QuantileSketch(self.alpha)
        oldest = self._epoch(now) - self.slices + 1
        for ep, sk in self._ring:
            if ep >= oldest:
                out.merge(sk)
        return out

    def to_dict(self, now: float) -> dict:
        return self.merged(now).to_dict()


# -- module config: the -telemetry.* flag surface -----------------------

_conf_lock = threading.Lock()
_enabled = True
_alpha = DEFAULT_ALPHA
_window = 300.0


def configure(enabled: bool | None = None, alpha: float | None = None,
              window: float | None = None) -> None:
    """Apply -telemetry.* CLI flags (None = leave unchanged)."""
    global _enabled, _alpha, _window
    with _conf_lock:
        if enabled is not None:
            _enabled = bool(enabled)
        if alpha is not None:
            if not 0.0 < alpha < 1.0:
                raise ValueError(f"telemetry alpha must be in (0, 1), "
                                 f"got {alpha}")
            _alpha = float(alpha)
        if window is not None:
            _window = max(1.0, float(window))


def enabled() -> bool:
    return _enabled


def alpha() -> float:
    return _alpha


def window() -> float:
    return _window


def windowed() -> WindowedSketch:
    """A WindowedSketch at the configured alpha/window."""
    return WindowedSketch(alpha=_alpha, window=_window)
