"""Retry policy and deadline propagation for internal hops; the
counterpart of seaweedfs_tpu/utils/retry.py.

* ``RetryPolicy`` — capped exponential backoff with **full jitter**
  (``sleep = uniform(0, min(cap, base * 2**attempt))``) and an overall
  deadline. Retries are idempotency-aware: GET/HEAD retry; other
  methods are replayed only when the request provably never left
  (a connect failure) or the far end attests it never started the work
  (``RETRYABLE_HEADER``).

* **Deadlines** — an absolute epoch deadline carried on every internal
  hop in the ``X-Sw-Deadline`` header. Servers reject work whose
  deadline already passed (rpc/http.py answers 504) and bind the
  caller's deadline for the handler, so a downstream hop never
  outlives the budget the edge minted. The ambient deadline lives in a
  contextvar, so it follows the handler through the calls it makes.

* ``CircuitBreaker`` — per-peer consecutive connection-failure breaker
  with a half-open probe, in one process-wide registry that the HTTP
  client and the volume server's replica fan-out share. Callers fail
  fast to the next replica instead of re-timing-out against a dead peer
  on every request; ``/debug/breakers`` serves the registry.

``middleware(service, edge)`` is the server side for rpc/http.App: it
answers 504 for a passed deadline and binds a live one for the handler;
an edge server (s3, filer) mints ``EDGE_BUDGET`` when the client sent
none. Stdlib only.
"""
from __future__ import annotations

import contextlib
import contextvars
import random
import threading
import time
from dataclasses import dataclass, replace
from typing import Iterator

# absolute unix-epoch seconds, decimal string, minted at the gateway
DEADLINE_HEADER = "X-Sw-Deadline"
# a 503 carrying this header attests the server rejected the request
# BEFORE doing any work — safe to replay even for non-idempotent methods
RETRYABLE_HEADER = "X-Sw-Retryable"

_IDEMPOTENT_METHODS = frozenset({"GET", "HEAD", "OPTIONS"})


class DeadlineExceeded(Exception):
    """The request's overall deadline passed before the work finished."""


class BreakerOpenError(ConnectionError):
    """Fail-fast refusal: the peer's circuit breaker is open.

    Subclasses ConnectionError so replica-failover paths that catch
    OSError treat it as "this peer is down, try the next one".
    """

    def __init__(self, peer: str, retry_after: float = 0.0):
        super().__init__(f"circuit open for peer {peer}")
        self.peer = peer
        self.retry_after = retry_after


# ---------------------------------------------------------------------------
# Deadline propagation
# ---------------------------------------------------------------------------

_deadline: contextvars.ContextVar[float | None] = contextvars.ContextVar(
    "sw_deadline", default=None)


def current_deadline() -> float | None:
    """Absolute epoch deadline for the ambient request, or None."""
    return _deadline.get()


def remaining(default: float | None = None) -> float | None:
    """Seconds left on the ambient deadline (may be <= 0), or default."""
    dl = _deadline.get()
    if dl is None:
        return default
    return dl - time.time()


def expired() -> bool:
    dl = _deadline.get()
    return dl is not None and dl <= time.time()


def check_deadline() -> None:
    """Raise DeadlineExceeded if the ambient deadline already passed."""
    if expired():
        raise DeadlineExceeded(
            f"deadline passed {time.time() - (_deadline.get() or 0):.3f}s ago")


@contextlib.contextmanager
def deadline_scope(budget: float | None = None,
                   absolute: float | None = None) -> Iterator[float | None]:
    """Bind a deadline for the duration of the with-block.

    ``budget`` is relative seconds from now, ``absolute`` an epoch
    timestamp (e.g. parsed from ``X-Sw-Deadline``). An inner scope can
    only tighten an outer one.
    """
    dl = absolute if absolute is not None else (
        time.time() + budget if budget is not None else None)
    outer = _deadline.get()
    if dl is None or (outer is not None and outer < dl):
        dl = outer
    token = _deadline.set(dl)
    try:
        yield dl
    finally:
        _deadline.reset(token)


def parse_deadline(value: str | None) -> float | None:
    """Parse an X-Sw-Deadline header value; garbage parses as None."""
    if not value:
        return None
    try:
        dl = float(value)
    except ValueError:
        return None
    # sanity: refuse deadlines more than a day out (clock-skew garbage)
    if dl - time.time() > 86400:
        return None
    return dl


def inject(headers: dict) -> dict:
    """Add X-Sw-Deadline to outgoing request headers. No-op when no
    ambient deadline is set."""
    dl = _deadline.get()
    if dl is not None and DEADLINE_HEADER not in headers:
        headers[DEADLINE_HEADER] = f"{dl:.6f}"
    return headers


# ---------------------------------------------------------------------------
# Retry policy
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class RetryPolicy:
    """Capped exponential backoff with full jitter + deadline awareness."""
    max_attempts: int = 3
    base_delay: float = 0.02     # seconds; first backoff in [0, base)
    max_delay: float = 1.0       # backoff cap

    def backoff(self, attempt: int,
                rng: random.Random | None = None) -> float:
        """Full-jitter sleep before attempt ``attempt`` (1-based retry
        index: first retry => attempt=1)."""
        cap = min(self.max_delay, self.base_delay * (2 ** max(0, attempt)))
        draw = (rng or random).uniform(0, cap)
        rem = remaining()
        if rem is not None:
            draw = min(draw, max(0.0, rem))
        return draw

    @staticmethod
    def idempotent(method: str, marked: bool | None = None) -> bool:
        if marked is not None:
            return marked
        return method.upper() in _IDEMPOTENT_METHODS

    def should_retry(self, attempt: int, method: str, *,
                     idempotent: bool | None = None,
                     conn_failure: bool = False,
                     status: int | None = None,
                     retryable_response: bool = False) -> bool:
        """May attempt ``attempt`` (0-based, just failed) be retried?

        * ``conn_failure`` — the request never reached the peer:
          always replayable.
        * ``retryable_response`` — the response carried
          ``X-Sw-Retryable`` (server attests no work was done).
        * otherwise only idempotent methods retry, and only on
          connection-ish statuses (502/503/504).
        """
        if attempt + 1 >= self.max_attempts:
            return False
        if expired():
            return False
        if conn_failure or retryable_response:
            return True
        if not self.idempotent(method, idempotent):
            return False
        return status in (502, 503, 504)


# ---------------------------------------------------------------------------
# Per-peer circuit breaker
# ---------------------------------------------------------------------------

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half-open"


@dataclass
class _BreakerConfig:
    failure_threshold: int = 5   # consecutive conn failures to trip
    reset_timeout: float = 5.0   # seconds open before the probe


class CircuitBreaker:
    """Connection-failure breaker for one peer (host:port).

    Only *connection-level* failures count — an HTTP error status means
    the peer is alive and must reset the streak.  Thread-safe: the HTTP
    client's threads and the replica fan-out share instances.
    """

    def __init__(self, peer: str, config: _BreakerConfig):
        self.peer = peer
        self._cfg = config
        self._lock = threading.Lock()
        self._failures = 0
        self._state = CLOSED
        self._opened_at = 0.0
        self._probing = False
        self._probe_at = 0.0
        self.trips = 0  # lifetime trip count (metric)

    @property
    def state(self) -> str:
        with self._lock:
            self._maybe_half_open()
            return self._state

    def _maybe_half_open(self) -> None:
        now = time.time()
        if (self._state == OPEN and
                now - self._opened_at >= self._cfg.reset_timeout):
            self._state = HALF_OPEN
            self._probing = False
            return
        # probe lease: an admitted probe whose caller never settled it
        # (timeout path, injected fault, crashed thread) must not hold
        # the slot forever — after reset_timeout the lease expires and
        # the next caller may probe, so a peer is never fail-fast
        # process-wide until restart just because one probe got lost
        if (self._state == HALF_OPEN and self._probing and
                now - self._probe_at >= self._cfg.reset_timeout):
            self._probing = False

    def allow(self) -> bool:
        """May a request go to this peer right now?  In half-open state
        exactly one probe is admitted; the rest fail fast until the
        probe reports back (or its lease expires)."""
        with self._lock:
            self._maybe_half_open()
            if self._state == CLOSED:
                return True
            if self._state == HALF_OPEN and not self._probing:
                self._probing = True
                self._probe_at = time.time()
                return True
            return False

    def retry_after(self) -> float:
        with self._lock:
            if self._state != OPEN:
                return 0.0
            return max(0.0, self._cfg.reset_timeout -
                       (time.time() - self._opened_at))

    def record_success(self) -> None:
        with self._lock:
            self._failures = 0
            self._state = CLOSED
            self._probing = False

    def probe_inconclusive(self) -> None:
        """Settle an admitted half-open probe whose attempt ended
        without proof either way (timed out, dropped mid-stream): the
        peer is still suspect, so go back to OPEN with a fresh timer —
        and the probe slot is released rather than leaked."""
        with self._lock:
            if self._state == HALF_OPEN and self._probing:
                self._state = OPEN
                self._opened_at = time.time()
                self._probing = False

    def release_probe(self) -> None:
        """Release an admitted probe slot without judging the peer —
        the attempt never reached it (e.g. an injected fault fired
        before any bytes moved), so the next caller may probe at once."""
        with self._lock:
            if self._state == HALF_OPEN and self._probing:
                self._probing = False

    def record_failure(self) -> None:
        """Record one connection-level failure."""
        with self._lock:
            if self._state == HALF_OPEN:
                # failed probe: straight back to open, timer restarts
                self._state = OPEN
                self._opened_at = time.time()
                self._probing = False
                return
            self._failures += 1
            if (self._state == CLOSED and
                    self._failures >= self._cfg.failure_threshold):
                self._state = OPEN
                self._opened_at = time.time()
                self.trips += 1

    def snapshot(self) -> dict:
        with self._lock:
            self._maybe_half_open()
            return {"peer": self.peer, "state": self._state,
                    "consecutive_failures": self._failures,
                    "trips": self.trips,
                    "retry_after": round(max(0.0, self._cfg.reset_timeout -
                                             (time.time() - self._opened_at))
                                         if self._state == OPEN else 0.0, 3)}


class BreakerRegistry:
    """Process-wide peer → breaker map (all clients share one view of
    peer health, like wdclient's vidMap is shared)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._breakers: dict[str, CircuitBreaker] = {}
        self.config = _BreakerConfig()

    def for_peer(self, peer: str) -> CircuitBreaker:
        peer = peer.strip().removeprefix("http://").removeprefix("https://")
        peer = peer.split("/", 1)[0]
        with self._lock:
            br = self._breakers.get(peer)
            if br is None:
                br = self._breakers[peer] = CircuitBreaker(peer, self.config)
            return br

    def snapshot(self) -> list[dict]:
        with self._lock:
            brs = list(self._breakers.values())
        return [b.snapshot() for b in sorted(brs, key=lambda b: b.peer)]

    def reset(self) -> None:
        with self._lock:
            self._breakers.clear()

    def reset_peer(self, peer: str) -> bool:
        """Forget one peer's breaker (same normalization as
        ``for_peer``). A volume server that re-registers after a
        restart is a fresh process — it must not inherit the dead
        process's OPEN breaker, or every client shuns it for a full
        reset_timeout after it came back healthy. Returns True when
        state existed and was dropped."""
        peer = peer.strip().removeprefix("http://").removeprefix("https://")
        peer = peer.split("/", 1)[0]
        with self._lock:
            return self._breakers.pop(peer, None) is not None


_registry = BreakerRegistry()


def breaker_for(peer: str) -> CircuitBreaker:
    return _registry.for_peer(peer)


def breakers_snapshot() -> list[dict]:
    return _registry.snapshot()


def reset_breakers() -> None:
    """Test hook: forget all peer state."""
    _registry.reset()


def reset_peer_breaker(peer: str) -> bool:
    """Drop one peer's breaker state (see BreakerRegistry.reset_peer)."""
    return _registry.reset_peer(peer)


# ---------------------------------------------------------------------------
# Process-wide defaults (tuned by cli.py global flags)
# ---------------------------------------------------------------------------

DEFAULT = RetryPolicy()
# budget minted at the gateway edge when the client sent no deadline
# (and by operation.verbs.upload_data); generous on purpose — it bounds
# runaway work (a dead peer chain), not ordinary large uploads
EDGE_BUDGET = 300.0
# hedged replica reads (filer/stream.py) fire the alternate after this
# many seconds (-hedge.delay)
HEDGE_DELAY = 0.35


def configure(max_attempts: int | None = None,
              base_delay: float | None = None,
              max_delay: float | None = None,
              edge_budget: float | None = None,
              breaker_failures: int | None = None,
              breaker_reset: float | None = None,
              hedge_delay: float | None = None) -> None:
    """Apply the -retry.* / -breaker.* / -hedge.* CLI flags."""
    global DEFAULT, EDGE_BUDGET, HEDGE_DELAY
    kw = {}
    if max_attempts is not None:
        kw["max_attempts"] = max(1, int(max_attempts))
    if base_delay is not None:
        kw["base_delay"] = float(base_delay)
    if max_delay is not None:
        kw["max_delay"] = float(max_delay)
    if kw:
        DEFAULT = replace(DEFAULT, **kw)
    if edge_budget is not None:
        EDGE_BUDGET = float(edge_budget)
    if breaker_failures is not None:
        _registry.config.failure_threshold = max(1, int(breaker_failures))
    if breaker_reset is not None:
        _registry.config.reset_timeout = float(breaker_reset)
    if hedge_delay is not None:
        HEDGE_DELAY = float(hedge_delay)


def policy() -> RetryPolicy:
    return DEFAULT


# ---------------------------------------------------------------------------
# Server side: the deadline middleware and /debug/breakers
# ---------------------------------------------------------------------------

def middleware(service: str, edge: bool = False):
    """Bind the request's deadline for the handler (rpc/http.App).

    Internal servers honour the X-Sw-Deadline a caller sent and answer
    504 before the handler runs when it already passed. Edge servers
    (``edge=True``: s3, filer) mint a fresh EDGE_BUDGET deadline when
    the client sent none, so every downstream hop inherits a bound.
    """
    from ..rpc.http import text_response

    skip = {"/metrics", "/debug/traces", "/debug/breakers", "/status",
            "/healthz"}

    def mw(req, handler):
        if req.path in skip:
            return handler(req)
        dl = parse_deadline(req.headers.get(DEADLINE_HEADER))
        if dl is not None and dl <= time.time():
            # nobody is waiting for this response any more
            return text_response("deadline exceeded\n", status=504)
        if dl is None and edge:
            dl = time.time() + EDGE_BUDGET
        if dl is None:
            return handler(req)
        token = _deadline.set(dl)
        try:
            return handler(req)
        except DeadlineExceeded:
            return text_response("deadline exceeded\n", status=504)
        finally:
            _deadline.reset(token)

    return mw


def handle_debug_breakers(req):
    """GET /debug/breakers: this process's peer breakers."""
    from ..rpc.http import json_response

    return json_response({"breakers": breakers_snapshot()})
