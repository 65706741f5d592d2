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

Stdlib only. Not here: the per-peer circuit breakers and the aiohttp
middleware of the reference (the port's transport binds the deadline
itself, in rpc/http.py).
"""
from __future__ import annotations

import contextlib
import contextvars
import random
import time
from dataclasses import dataclass
from typing import Iterator

# absolute unix-epoch seconds, decimal string, minted at the gateway
DEADLINE_HEADER = "X-Sw-Deadline"
# a 503 carrying this header attests the server rejected the request
# BEFORE doing any work — safe to replay even for non-idempotent methods
RETRYABLE_HEADER = "X-Sw-Retryable"

_IDEMPOTENT_METHODS = frozenset({"GET", "HEAD", "OPTIONS"})


class DeadlineExceeded(Exception):
    """The request's overall deadline passed before the work finished."""


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


# the process-wide policy every client call follows
DEFAULT = RetryPolicy()
# budget minted at the SDK edge (operation.verbs.upload_data); generous
# on purpose — it bounds runaway work, not ordinary large uploads
EDGE_BUDGET = 300.0


def policy() -> RetryPolicy:
    return DEFAULT
