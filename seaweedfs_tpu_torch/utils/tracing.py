"""Stdlib-only distributed tracing — copy of seaweedfs_tpu/utils/tracing.py
without its aiohttp glue (the middleware and the /debug/traces handler
come with the servers).

W3C-``traceparent``-style context (trace-id/span-id/flags): `span()`
records one finished span (name, start, duration, status, peer) into a
bounded process-global ring buffer, parented on the contextvar's active
span or on an explicit remote context. Server spans are summarized into
``request_trace_seconds{service,handler}`` histograms, and a local root
server span slower than the configurable threshold emits one glog line
carrying the full span tree. `traces_json` groups the ring by trace.
"""
from __future__ import annotations

import contextvars
import json
import secrets
import threading
import time
from collections import deque
from contextlib import contextmanager

from . import glog, metrics

_VERSION = "00"
_HEX = set("0123456789abcdef")

# -- configuration ------------------------------------------------------

_lock = threading.Lock()
_buffer_size = 1024
_spans: deque = deque(maxlen=_buffer_size)
_slow_threshold = 1.0  # seconds; <= 0 disables the slow-request log
_sample_rate = 1.0  # head-sampling fraction for the cluster collector
_sinks: list = []  # finished-span observers (cluster span pusher)


def configure(slow_threshold: float | None = None,
              buffer_size: int | None = None,
              sample_rate: float | None = None) -> None:
    """Adjust tracing knobs (CLI: -trace.slowThreshold/-trace.bufferSize/
    -trace.sample).

    Resizing the ring keeps the most recent spans.
    """
    global _slow_threshold, _buffer_size, _spans, _sample_rate
    with _lock:
        if slow_threshold is not None:
            _slow_threshold = float(slow_threshold)
        if buffer_size is not None and int(buffer_size) != _buffer_size:
            _buffer_size = max(1, int(buffer_size))
            _spans = deque(_spans, maxlen=_buffer_size)
        if sample_rate is not None:
            _sample_rate = min(1.0, max(0.0, float(sample_rate)))


def sample_rate() -> float:
    return _sample_rate


def slow_threshold() -> float:
    """-trace.slowThreshold in seconds; <= 0 means disabled. Shared by
    the slow-request log and the span pusher's keep-if-slow pass."""
    return _slow_threshold


def sample_decision(trace_id: str, rate: float | None = None) -> bool:
    """Deterministic head-sampling verdict for one trace.

    Hashes the trace-id's low 32 bits against the rate so every process
    reaches the same keep/drop decision without coordination — a kept
    trace is kept on all hops and stitches completely on the master.
    Malformed ids are kept (losing them would hide bugs, not traffic).
    """
    r = _sample_rate if rate is None else rate
    if r >= 1.0:
        return True
    if r <= 0.0:
        return False
    try:
        bucket = int(trace_id[-8:], 16)
    except (ValueError, TypeError):
        return True
    return bucket < r * 0x100000000


# -- span sinks ---------------------------------------------------------
# Observers called with each finished span record (a plain dict); the
# cluster span pusher registers here. Called outside the ring lock and
# exceptions are swallowed: a broken sink must never fail a request.


def add_sink(fn) -> None:
    with _lock:
        if fn not in _sinks:
            _sinks.append(fn)


def remove_sink(fn) -> None:
    with _lock:
        if fn in _sinks:
            _sinks.remove(fn)


def reset() -> None:
    with _lock:
        _spans.clear()


# -- traceparent --------------------------------------------------------


class TraceContext:
    __slots__ = ("trace_id", "span_id", "flags")

    def __init__(self, trace_id: str, span_id: str, flags: str = "01"):
        self.trace_id = trace_id
        self.span_id = span_id
        self.flags = flags

    def __repr__(self):  # pragma: no cover - debugging aid
        return f"TraceContext({format_traceparent(self)})"


def new_trace_id() -> str:
    return secrets.token_hex(16)


def new_span_id() -> str:
    return secrets.token_hex(8)


def _is_hex(s: str, n: int) -> bool:
    return len(s) == n and all(c in _HEX for c in s)


def format_traceparent(ctx: TraceContext) -> str:
    return f"{_VERSION}-{ctx.trace_id}-{ctx.span_id}-{ctx.flags}"


def parse_traceparent(header: str | None) -> TraceContext | None:
    """Parse ``00-<32 hex>-<16 hex>-<2 hex>``; None on any malformation
    (unknown 'ff' version, all-zero ids, wrong lengths, bad chars)."""
    if not header:
        return None
    parts = header.strip().lower().split("-")
    if len(parts) < 4:
        return None
    ver, trace_id, span_id, flags = parts[0], parts[1], parts[2], parts[3]
    if not _is_hex(ver, 2) or ver == "ff":
        return None
    if ver == _VERSION and len(parts) != 4:
        return None
    if not _is_hex(trace_id, 32) or trace_id == "0" * 32:
        return None
    if not _is_hex(span_id, 16) or span_id == "0" * 16:
        return None
    if not _is_hex(flags, 2):
        return None
    return TraceContext(trace_id, span_id, flags)


# -- span recording -----------------------------------------------------

_current: contextvars.ContextVar[TraceContext | None] = \
    contextvars.ContextVar("seaweedfs_tpu_torch_trace", default=None)


def current() -> TraceContext | None:
    return _current.get()


def current_traceparent() -> str:
    """Header value for the active span ("" when not tracing)."""
    ctx = _current.get()
    return format_traceparent(ctx) if ctx is not None else ""


def inject(headers: dict) -> dict:
    """Add a traceparent header for the active span (no-op otherwise)."""
    tp = current_traceparent()
    if tp:
        headers["traceparent"] = tp
    return headers


@contextmanager
def span(name: str, *, service: str = "", kind: str = "internal",
         peer: str = "", remote: TraceContext | None = None):
    """Record one span; yields the mutable record so callers can set
    ``rec["status"]`` (e.g. the HTTP response code).

    Parentage: an explicit ``remote`` context (incoming traceparent)
    wins, else the contextvar parent, else a fresh root trace.
    """
    parent = _current.get()
    if remote is not None:
        trace_id, parent_id = remote.trace_id, remote.span_id
    elif parent is not None:
        trace_id, parent_id = parent.trace_id, parent.span_id
    else:
        trace_id, parent_id = new_trace_id(), ""
    ctx = TraceContext(trace_id, new_span_id())
    token = _current.set(ctx)
    rec = {
        "trace_id": trace_id,
        "span_id": ctx.span_id,
        "parent_id": parent_id,
        "service": service,
        "name": name,
        "kind": kind,
        "peer": peer,
        "start": time.time(),
        "duration": 0.0,
        "status": "",
    }
    t0 = time.perf_counter()
    try:
        yield rec
    except BaseException:
        rec["status"] = "error"
        raise
    finally:
        rec["duration"] = time.perf_counter() - t0
        _current.reset(token)
        _finish(rec)


def _finish(rec: dict) -> None:
    with _lock:
        _spans.append(rec)
        # slow logging fires at local ROOT REQUEST spans only: child
        # spans are covered by their root's tree, and long-running
        # internal roots (EC rebuilds etc.) are expected to be slow
        slow = (_slow_threshold > 0 and not rec["parent_id"]
                and rec["kind"] == "server"
                and rec["duration"] >= _slow_threshold)
    if rec["kind"] == "server":
        metrics.histogram_observe(
            "request_trace_seconds", rec["duration"],
            {"service": rec["service"] or "unknown",
             "handler": rec["name"] or "unknown"})
    if slow:
        _log_slow(rec)
    for sink in list(_sinks):
        try:
            sink(rec)
        except Exception:
            pass


def _span_tree(trace_id: str) -> list[dict]:
    """Recorded spans of one trace nested children-under-parents."""
    with _lock:
        flat = [dict(s) for s in _spans if s["trace_id"] == trace_id]
    by_id = {s["span_id"]: s for s in flat}
    roots: list[dict] = []
    for s in flat:
        s.setdefault("children", [])
        parent = by_id.get(s["parent_id"])
        if parent is not None:
            parent.setdefault("children", []).append(s)
        else:
            roots.append(s)
    return roots


def _log_slow(rec: dict) -> None:
    tree = _span_tree(rec["trace_id"])
    glog.warning(
        "slow request trace_id=%s service=%s handler=%s "
        "duration=%.6fs threshold=%.3fs spans=%s",
        rec["trace_id"], rec["service"], rec["name"], rec["duration"],
        _slow_threshold, json.dumps(tree, sort_keys=True))


def traces_json(limit: int = 20) -> list[dict]:
    """Most-recent-first traces (grouped spans) for /debug/traces."""
    with _lock:
        snap = list(_spans)
    order: list[str] = []
    groups: dict[str, list[dict]] = {}
    for s in reversed(snap):  # newest span first
        tid = s["trace_id"]
        if tid not in groups:
            if len(order) >= max(1, limit):
                continue
            groups[tid] = []
            order.append(tid)
        groups[tid].append(dict(s))
    return [{"trace_id": tid,
             "spans": sorted(groups[tid], key=lambda s: s["start"])}
            for tid in order]
