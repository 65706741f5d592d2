"""Token-bucket byte-rate shaping for repair traffic; the counterpart of
seaweedfs_tpu/utils/ratelimit.py (the node-wide "repair" bucket; the
port has no tier traffic, so no "tier" bucket is ever made).

The repair plane moves bulk bytes (replica re-copies, EC shard
reconstruction reads) over the same NICs and disks that serve
foreground traffic; the warehouse-cluster study (arxiv 1309.0186)
measures repair as the DOMINANT cross-rack load when it runs
unshaped. `-repair.maxBytesPerSec` caps it with one bucket per node:
every repair byte a node sends (copy_file / shard_read source side)
or receives (volume_copy / ec/copy destination side) draws from that
node's bucket, so the per-node total holds regardless of how many
concurrent transfers the bounded-concurrency workers drive.

Design notes:

* Reservation-style accounting: ``acquire(n)`` debits the bucket
  immediately, then sleeps until the bytes owed have been refilled.
  Debiting under one lock makes grants strictly FIFO (no starvation:
  a large request queues ahead of later small ones rather than being
  overtaken forever).
* The bucket starts EMPTY and the burst allowance is small
  (``rate/8`` by default): admitted bytes over any window w are
  bounded by ``rate*w + burst``, so a 1-second window can exceed the
  cap by at most 12.5% and only right after an idle period.
* ``state()["debt"]`` is the number of bytes already granted but not
  yet payable at the current fill — the queueing backlog the heartbeat
  reports when repair is saturating its cap.
"""
from __future__ import annotations

import threading
import time


class TokenBucket:
    """Thread-safe byte token bucket; rate <= 0 means unlimited."""

    def __init__(self, rate: float, burst: float | None = None):
        self._lock = threading.Lock()
        # waiters park on the condition so a live configure() can wake
        # them to re-price their remaining wait at the new rate
        self._cond = threading.Condition(self._lock)
        self._t = time.monotonic()
        self.configure(rate, burst)

    def configure(self, rate: float, burst: float | None = None) -> None:
        """(Re)set the rate; keeps accumulated debt so a live rate
        change never forgives bytes already granted. Sleeping waiters
        are woken to re-price what they still owe at the new rate — a
        raise un-strands them early, a cut extends their wait instead
        of letting them duck under the new cap."""
        with self._lock:
            self.rate = float(rate)
            self.burst = (float(burst) if burst is not None
                          else max(64 << 10, self.rate / 8.0))
            if not hasattr(self, "_tokens"):
                self._tokens = 0.0  # start empty: no day-one burst
            elif self._tokens > self.burst:
                self._tokens = self.burst  # a burst cut caps the fill
            self._cond.notify_all()

    def _refill_locked(self, now: float) -> None:
        self._tokens = min(self.burst,
                           self._tokens + (now - self._t) * self.rate)
        self._t = now

    def cancel(self, n: int) -> None:
        """Return ``n`` bytes debited by an acquire that timed out."""
        if self.rate <= 0 or n <= 0:
            return
        with self._lock:
            self._refill_locked(time.monotonic())
            self._tokens = min(self.burst, self._tokens + n)

    def _owed(self, n: int) -> float:
        """Debit ``n`` bytes; return the refill BYTES still owed before
        the grant matures (0.0 = immediately available). Owed bytes,
        not seconds, stay correct across a live `configure`: the
        remaining wait is owed/rate at whatever the rate currently
        is."""
        if self.rate <= 0 or n <= 0:
            return 0.0
        with self._lock:
            self._refill_locked(time.monotonic())
            self._tokens -= n
            return max(0.0, -self._tokens)

    def _pay(self, owed: float, deadline: float | None) -> bool:
        """Sleep until ``owed`` bytes have been refilled at the
        prevailing (possibly re-configured) rate. Each configure()
        wakes the wait so the residue is re-priced — a FIFO waiter is
        never stranded sleeping a stale quote."""
        with self._cond:
            while owed > 1e-9:
                rate = self.rate
                if rate <= 0:
                    return True  # now unlimited: everything is paid
                wait = owed / rate
                if deadline is not None:
                    wait = min(wait, deadline - time.monotonic())
                    if wait <= 0:
                        return False
                t0 = time.monotonic()
                self._cond.wait(wait)
                # configure() notifies, ending the slice — but the
                # tail between the change and the wake-up ran at the
                # NEW rate, so deduct at whichever rate is lower:
                # conservative, never undercharges the live cap
                now_rate = self.rate
                paid_rate = min(rate, now_rate) if now_rate > 0 else rate
                owed -= (time.monotonic() - t0) * paid_rate
        return True

    def acquire(self, n: int, timeout: float | None = None) -> bool:
        """Blocking reserve: sleep until ``n`` bytes are available.
        With ``timeout``, refuse (and un-debit) when the queue is so
        deep the wait would exceed it."""
        if self.rate <= 0 or n <= 0:
            return True
        owed = self._owed(n)
        if timeout is not None and owed > timeout * self.rate:
            self.cancel(n)
            return False
        deadline = None if timeout is None \
            else time.monotonic() + timeout
        if owed > 0 and not self._pay(owed, deadline):
            self.cancel(n)
            return False
        return True

    def state(self) -> dict:
        with self._lock:
            self._refill_locked(time.monotonic())
            return {"rate": self.rate,
                    "burst": self.burst,
                    "fill": round(max(0.0, self._tokens), 1),
                    "debt": round(max(0.0, -self._tokens), 1)}


# -- process-local bucket registry ---------------------------------------
# One named bucket per shaping domain (volume servers use "repair" for
# their node-wide repair cap). The rate arrives with each throttled
# request (the master is the single place the cap is configured), so
# the registry re-configures on change instead of erroring.

_buckets: dict[str, TokenBucket] = {}
_reg_lock = threading.Lock()


def bucket(key: str, rate: float) -> TokenBucket:
    with _reg_lock:
        b = _buckets.get(key)
        if b is None:
            b = _buckets[key] = TokenBucket(rate)
        elif b.rate != float(rate):
            b.configure(rate)
        return b


def snapshot() -> dict[str, dict]:
    with _reg_lock:
        return {key: b.state() for key, b in _buckets.items()}


def reset() -> None:
    """Test hook: drop all registered buckets."""
    with _reg_lock:
        _buckets.clear()
