"""Span pusher: ships finished spans to the master's trace collector;
the counterpart of seaweedfs_tpu/rpc/trace_push.py.

Every server process (volume, filer, S3) registers one SpanPusher as
a tracing sink; finished span records land in a bounded queue and a
daemon thread batches them to ``POST /cluster/traces/push`` on the
master over the shared pooled client (so pushes ride the same
breaker/retry/deadline layer as all other internal hops — and produce
no spans of their own, since the pusher thread carries no trace
context).

Head sampling happens here, at enqueue time, via the deterministic
per-trace verdict in `utils.tracing.sample_decision`: every process
reaches the same keep/drop decision for a given trace-id, so a sampled
trace arrives complete from all hops. A sampled-out span is *skipped*,
not dropped — ``trace_spans_dropped_total`` counts only real loss
(queue overflow / push give-up), so zero drops at any sample rate
means the collector saw everything it was meant to see.

One tail-sampling exception: spans slower than ``-trace.slowThreshold``
are pushed even when head sampling drops their trace (counted by
``trace_push_tail_kept_total``), so a 1% sample rate still surfaces
every slow outlier.
"""
from __future__ import annotations

import threading
from collections import deque

from ..utils import glog, metrics, retry, tracing

BATCH_SIZE = 128          # spans per push
FLUSH_INTERVAL = 2.0      # seconds between pushes when below BATCH_SIZE
QUEUE_MAX = 4096          # bounded backlog while the master is away


def master_from_filer(filer_url: str, timeout: float = 5.0) -> str:
    """Resolve the master address from a filer's /status (the S3
    gateway only knows its filer)."""
    from . import httpclient

    r = httpclient.session().get(
        filer_url.rstrip("/") + "/status", timeout=timeout)
    r.raise_for_status()
    m = str(r.json().get("master", ""))
    if not m:
        raise ValueError(f"no master in {filer_url}/status")
    if not m.startswith("http"):
        m = "http://" + m
    return m


class SpanPusher:
    """Batches finished spans from the tracing ring to the master.

    ``master_url`` may be a string or a zero-arg callable resolved on
    every flush (gateways re-resolve through their filer so a master
    failover doesn't orphan the pusher).
    """

    def __init__(self, master_url, service: str, instance: str, *,
                 batch_size: int = BATCH_SIZE,
                 interval: float = FLUSH_INTERVAL,
                 queue_max: int = QUEUE_MAX):
        self._master_url = master_url
        self.service = service
        self.instance = instance
        self.batch_size = max(1, int(batch_size))
        self.interval = float(interval)
        self.queue_max = max(self.batch_size, int(queue_max))
        self._q: deque = deque()
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._dropped_unreported = 0

    # -- lifecycle ------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()
        tracing.add_sink(self._enqueue)
        self._thread = threading.Thread(
            target=self._loop, name=f"span-push-{self.service}",
            daemon=True)
        self._thread.start()

    def stop(self, timeout: float = 5.0) -> None:
        """Unregister the sink, flush what's queued, join the thread.
        Idempotent; safe to call before start()."""
        tracing.remove_sink(self._enqueue)
        thread = self._thread
        self._thread = None
        self._stop.set()
        self._wake.set()
        if thread is not None:
            thread.join(timeout)

    # -- sink -----------------------------------------------------------

    def _enqueue(self, rec: dict) -> None:
        if not tracing.sample_decision(rec.get("trace_id", "")):
            # keep-if-slow tail pass: a span over -trace.slowThreshold
            # is pushed even when head sampling dropped its trace, so
            # low sample rates still surface every slow outlier (the
            # rest of that trace stays sampled out — the collector gets
            # a partial trace, flagged by the counter)
            thresh = tracing.slow_threshold()
            try:
                duration = float(rec.get("duration") or 0.0)
            except (TypeError, ValueError):
                duration = 0.0
            if thresh <= 0 or duration < thresh:
                return  # sampled out everywhere — not a drop
            metrics.counter_add("trace_push_tail_kept_total", 1)
        with self._lock:
            if len(self._q) >= self.queue_max:
                self._q.popleft()
                self._dropped_unreported += 1
                metrics.counter_add("trace_spans_dropped_total", 1)
            self._q.append(rec)
            full = len(self._q) >= self.batch_size
        if full:
            self._wake.set()

    # -- push loop ------------------------------------------------------

    def _resolve(self) -> str:
        url = self._master_url
        if callable(url):
            url = url()
        return str(url).rstrip("/")

    def _take_batch(self) -> tuple[list[dict], int]:
        with self._lock:
            n = min(len(self._q), self.batch_size)
            batch = [self._q.popleft() for _ in range(n)]
            dropped = self._dropped_unreported
            self._dropped_unreported = 0
        return batch, dropped

    def _requeue(self, batch: list[dict], dropped: int) -> None:
        with self._lock:
            self._dropped_unreported += dropped
            for rec in reversed(batch):
                if len(self._q) >= self.queue_max:
                    self._dropped_unreported += 1
                    metrics.counter_add("trace_spans_dropped_total", 1)
                    break
                self._q.appendleft(rec)

    def _push(self, batch: list[dict], dropped: int) -> bool:
        from . import httpclient

        try:
            url = self._resolve()
        except Exception:
            return False
        payload = {"instance": self.instance, "service": self.service,
                   "spans": batch, "dropped": dropped}
        try:
            r = httpclient.session().post(
                url + "/cluster/traces/push", json=payload,
                timeout=(5.0, 10.0))
        except retry.BreakerOpenError:
            return False
        except Exception as e:
            glog.v(2, "span push to %s failed: %s", url, e)
            return False
        if r.status_code >= 300:
            return False
        metrics.counter_add("trace_spans_pushed_total", len(batch))
        return True

    def flush(self) -> bool:
        """One push attempt; failed batches requeue (bounded). -> did
        everything queued at entry get delivered."""
        ok = True
        while True:
            batch, dropped = self._take_batch()
            if not batch and not dropped:
                return ok
            if not self._push(batch, dropped):
                self._requeue(batch, dropped)
                return False

    def _loop(self) -> None:
        while not self._stop.is_set():
            self._wake.wait(self.interval)
            self._wake.clear()
            self.flush()
        self.flush()  # final drain on shutdown
