"""Group-commit scheduler: fsync-coalesced durable acks; the counterpart
of seaweedfs_tpu/storage/commit.py.

One fsync can durably land hundreds of appends, because concurrent
needle writes share a contiguous .dat extent. Writers enqueue a ticket
per append; a single committer thread closes the open batch window when
either ``max_delay`` elapses or ``max_bytes`` accumulate, issues ONE
``Volume.commit_batch`` per dirty volume, and only then releases the
tickets. The ack contract is the scheduler's ``durability`` mode:

======== ==========================================================
buffered ack after the userspace append; batches still close (the
         .idx flush and the btree watermark), without fsync
batch    ack only after the covering batch fsync — fsync-durable at
         ~1 fsync per batch instead of ~1 per write
sync     per-write fsync (the caller fsyncs inline; the scheduler is
         not used)
======== ==========================================================

Where the reference's ticket is awaited on an asyncio loop, the port's
handlers run on threads: a ticket is a ``threading.Event`` that the
writer's thread ``wait()``s on.

Lock discipline (the reference's analysis/rules/lock_discipline.py):
the committer NEVER fsyncs while holding any lock — not its own
condition and not the volume write lock. The queue is taken under the
condition, the fsync runs after it is released; ``commit_batch`` takes
no lock (a vacuum swap is survived by the one retry in
``_commit_volume``, as the unlocked read path survives it).
"""
from __future__ import annotations

import threading
import time

from ..utils import sketch as _sketch
from ..utils.metrics import counter_add, histogram_observe

DURABILITY_MODES = ("buffered", "batch", "sync")

# buffered mode has no ack waiting on the window, so the batch close
# exists only for .idx hygiene: stretch tiny windows out to a saner
# cadence instead of spinning the committer at 0.5 ms
_BUFFERED_FLOOR = 0.025


class CommitTicket:
    """One enqueued append waiting for its covering batch commit."""

    __slots__ = ("volume", "nbytes", "enqueued_at", "error", "_event",
                 "queue_seconds", "fsync_seconds")

    def __init__(self, volume, nbytes: int):
        self.volume = volume
        self.nbytes = nbytes
        self.enqueued_at = time.monotonic()
        self.error: Exception | None = None
        self.queue_seconds = 0.0
        self.fsync_seconds = 0.0
        self._event = threading.Event()

    def _release(self) -> None:
        self._event.set()

    def wait(self, timeout: float | None = None) -> bool:
        """Block until the covering commit released this ticket; False
        when `timeout` passed first."""
        return self._event.wait(timeout)


class CommitScheduler:
    """Per-volume-server group-commit pipeline (one committer thread)."""

    def __init__(self, durability: str = "buffered",
                 max_delay: float = 0.002, max_bytes: int = 4 << 20):
        if durability not in DURABILITY_MODES:
            raise ValueError(
                f"durability must be one of {DURABILITY_MODES}, "
                f"got {durability!r}")
        self.durability = durability
        self.max_delay = float(max_delay)
        self.max_bytes = int(max_bytes)
        self._cond = threading.Condition()
        self._queue: list[CommitTicket] = []
        self._queue_bytes = 0
        self._window_opened: float | None = None
        self._stopping = False
        self._thread: threading.Thread | None = None
        # counters for /debug/commit (all monotonic, guarded by _cond)
        self.batches = 0
        self.commits = 0          # tickets released
        self.fsyncs = 0
        self.commit_errors = 0
        self._size_sketch = _sketch.windowed()
        self._bytes_sketch = _sketch.windowed()

    # -- writer side ---------------------------------------------------
    def submit(self, volume, nbytes: int) -> CommitTicket:
        """Enqueue an already-appended write; the returned ticket is
        released after the covering batch commit (`wait()` on it)."""
        t = CommitTicket(volume, nbytes)
        with self._cond:
            if self._stopping:
                raise RuntimeError("commit scheduler stopped")
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._run, name="commit-scheduler", daemon=True)
                self._thread.start()
            self._queue.append(t)
            self._queue_bytes += nbytes
            if self._window_opened is None:
                self._window_opened = t.enqueued_at
            self._cond.notify()
        return t

    # -- committer side ------------------------------------------------
    def _window(self) -> float:
        if self.durability == "batch":
            return self.max_delay
        return max(self.max_delay, _BUFFERED_FLOOR)

    def _run(self) -> None:
        while True:
            with self._cond:
                while not self._queue and not self._stopping:
                    self._cond.wait()
                if not self._queue and self._stopping:
                    return
                # adaptive window: close at max_delay after the first
                # enqueue, or at once when max_bytes piled up
                window = self._window()
                while not self._stopping:
                    elapsed = time.monotonic() - self._window_opened
                    if elapsed >= window or \
                            self._queue_bytes >= self.max_bytes:
                        break
                    self._cond.wait(window - elapsed)
                batch = self._queue
                nbytes = self._queue_bytes
                self._queue = []
                self._queue_bytes = 0
                self._window_opened = None
            # the condition is released: every blocking IO is out here
            self._commit(batch, nbytes)
            with self._cond:
                if self._stopping and not self._queue:
                    return

    def _commit(self, batch: list[CommitTicket], nbytes: int) -> None:
        now = time.monotonic()
        for t in batch:
            t.queue_seconds = now - t.enqueued_at
            histogram_observe("write_commit_seconds", t.queue_seconds,
                              {"stage": "queue"})
        volumes: dict[int, object] = {}
        for t in batch:
            volumes[id(t.volume)] = t.volume
        durable = self.durability != "buffered"
        t0 = time.monotonic()
        errors: dict[int, Exception] = {}
        for key, v in volumes.items():
            try:
                self._commit_volume(v, durable)
            except Exception as e:  # noqa: BLE001 — a disk failure
                errors[key] = e
        fsync_s = time.monotonic() - t0
        histogram_observe("write_commit_seconds", fsync_s,
                          {"stage": "fsync"})
        now = time.monotonic()
        with self._cond:
            self.batches += 1
            self.commits += len(batch)
            if durable:
                self.fsyncs += len(volumes)
            self.commit_errors += len(errors)
            self._size_sketch.record(len(batch), now)
            self._bytes_sketch.record(nbytes, now)
        counter_add("write_commit_batches_total", 1)
        if durable:
            counter_add("write_commit_fsyncs_total", len(volumes))
        for t in batch:
            t.fsync_seconds = fsync_s
            t.error = errors.get(id(t.volume))
            t._release()

    @staticmethod
    def _commit_volume(v, durable: bool) -> None:
        try:
            v.commit_batch(durable)
        except (ValueError, OSError):
            # a vacuum commit can swap .dat/.idx under us (commit_batch
            # takes no lock by design): wait behind the swap by taking
            # the write lock EMPTY, then retry on the fresh handles —
            # the fsync itself never runs under the volume write lock
            with v.write_lock:
                pass
            v.commit_batch(durable)

    # -- lifecycle / introspection -------------------------------------
    def flush(self, timeout: float = 5.0) -> None:
        """Block until everything enqueued now has committed."""
        with self._cond:
            pending = list(self._queue)
            self._cond.notify()
        deadline = time.monotonic() + timeout
        for t in pending:
            t.wait(max(0.0, deadline - time.monotonic()))

    def stop(self) -> None:
        """Commit what is queued, then end the committer thread."""
        with self._cond:
            self._stopping = True
            self._cond.notify_all()
            thread = self._thread
        if thread is not None:
            thread.join(timeout=5.0)

    def snapshot(self) -> dict:
        """/debug/commit payload: mode, live window, counters."""
        now = time.monotonic()
        with self._cond:
            opened = self._window_opened
            return {
                "durability": self.durability,
                "max_delay_seconds": self.max_delay,
                "max_bytes": self.max_bytes,
                "queue_depth": len(self._queue),
                "queue_bytes": self._queue_bytes,
                "window_open_seconds": (now - opened)
                if opened is not None else None,
                "batches": self.batches,
                "commits": self.commits,
                "fsyncs": self.fsyncs,
                "commit_errors": self.commit_errors,
                "batch_size": self._size_sketch.merged(now).summary(),
                "batch_bytes": self._bytes_sketch.merged(now).summary(),
            }
