"""Deterministic fault injection for internal hops; the counterpart of
seaweedfs_tpu/utils/faults.py.

Chaos as a reproducible unit test instead of a SIGKILL race: a seeded
RNG decides, per matching rule, whether a hop gets an injected delay
and/or error.  Enabled via the ``-fault.spec`` global flag or the
``SEAWEEDFS_TPU_FAULT_SPEC`` env var; off (zero overhead beyond one
``enabled()`` check) by default.

Spec grammar — comma-separated rules::

    service:op:kind=value[,service:op:kind=value...]

* ``service`` — which hop the rule applies to: a server name as seen by
  its middleware (``master``/``volume``/``filer``/``s3``), the client
  (``httpclient``), or ``*``.
* ``op`` — ``read`` (GET/HEAD), ``write`` (POST/PUT/DELETE), or ``*``.
* ``kind=value`` — ``error=P`` injects a 503 with probability ``P``
  (0..1]; ``delay=30ms`` (also ``s``/``us`` suffixes, bare number =
  seconds) sleeps before the handler runs.

Example: ``volume:read:error=0.05,filer:*:delay=30ms``.

Injected errors fire **before** the handler touches any state and the
503 carries ``X-Sw-Retryable`` (see utils/retry.py), so a retried
non-idempotent request can never double-apply — that is what makes the
chaos e2e's "zero duplicate writes" assertion meaningful.

The server side is `middleware(service)`, a middleware for
rpc/http.App; the client side is `sync_hook` in rpc/httpclient.py.
"""
from __future__ import annotations

import os
import random
import threading
import time
from dataclasses import dataclass

_READ_METHODS = frozenset({"GET", "HEAD", "OPTIONS"})


class FaultSpecError(ValueError):
    """Malformed -fault.spec value."""


@dataclass(frozen=True)
class Rule:
    service: str   # master|volume|filer|s3|httpclient|*
    op: str        # read|write|*
    kind: str      # error|delay
    value: float   # probability for error, seconds for delay

    def matches(self, service: str, op: str) -> bool:
        return (self.service in ("*", service) and
                self.op in ("*", op))


def _parse_duration(text: str) -> float:
    t = text.strip().lower()
    for suffix, scale in (("us", 1e-6), ("ms", 1e-3), ("s", 1.0)):
        if t.endswith(suffix):
            return float(t[:-len(suffix)]) * scale
    return float(t)


def _format_duration(seconds: float) -> str:
    if seconds >= 1.0 and float(seconds).is_integer():
        return f"{int(seconds)}s"
    ms = seconds * 1e3
    if ms >= 1.0 and float(ms).is_integer():
        return f"{int(ms)}ms"
    us = seconds * 1e6
    if float(us).is_integer():
        return f"{int(us)}us"
    return repr(seconds)


def parse_spec(text: str) -> list[Rule]:
    """Parse a -fault.spec string into rules; raises FaultSpecError on
    malformed input (a typo'd chaos spec must fail loudly at startup,
    not silently inject nothing)."""
    rules: list[Rule] = []
    for part in (p.strip() for p in text.split(",")):
        if not part:
            continue
        fields = part.split(":")
        if len(fields) != 3 or "=" not in fields[2]:
            raise FaultSpecError(
                f"bad fault rule {part!r}: want service:op:kind=value")
        service, op, kv = fields
        kind, _, raw = kv.partition("=")
        service, op, kind = service.strip(), op.strip(), kind.strip()
        if op not in ("read", "write", "*"):
            raise FaultSpecError(f"bad fault op {op!r} in {part!r}")
        if kind not in ("error", "delay"):
            raise FaultSpecError(f"bad fault kind {kind!r} in {part!r}")
        try:
            if kind == "error":
                value = float(raw)
                if not 0.0 < value <= 1.0:
                    raise ValueError
            else:
                value = _parse_duration(raw)
                if value < 0:
                    raise ValueError
        except ValueError as exc:
            raise FaultSpecError(
                f"bad fault value {raw!r} in {part!r}") from exc
        rules.append(Rule(service, op, kind, value))
    return rules


def format_spec(rules: list[Rule]) -> str:
    """Inverse of parse_spec (round-trips through parse_spec)."""
    parts = []
    for r in rules:
        raw = (_format_duration(r.value) if r.kind == "delay"
               else repr(r.value) if r.value != int(r.value)
               else repr(r.value))
        parts.append(f"{r.service}:{r.op}:{r.kind}={raw}")
    return ",".join(parts)


def op_of(method: str) -> str:
    return "read" if method.upper() in _READ_METHODS else "write"


class FaultRegistry:
    """Seeded, process-wide injection decisions + counters."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._rules: list[Rule] = []
        self._rng = random.Random(0)
        self._counts: dict[tuple[str, str], int] = {}

    def configure(self, spec: str | None, seed: int = 0) -> None:
        rules = parse_spec(spec) if spec else []
        with self._lock:
            self._rules = rules
            self._rng = random.Random(seed)
            self._counts = {}

    @property
    def enabled(self) -> bool:
        return bool(self._rules)

    def decide(self, service: str, op: str) -> tuple[float, bool]:
        """(delay_seconds, inject_error) for one hop.  Deterministic
        for a fixed seed and call sequence."""
        if not self._rules:
            return 0.0, False
        delay = 0.0
        error = False
        with self._lock:
            for r in self._rules:
                if not r.matches(service, op):
                    continue
                if r.kind == "delay":
                    delay = max(delay, r.value)
                elif r.kind == "error" and self._rng.random() < r.value:
                    error = True
            if delay:
                self._counts[(service, "delay")] = \
                    self._counts.get((service, "delay"), 0) + 1
            if error:
                self._counts[(service, "error")] = \
                    self._counts.get((service, "error"), 0) + 1
        return delay, error


class FaultInjected(ConnectionError):
    """Raised by the client-side hook when a rule injects an error.

    Subclasses ConnectionError on purpose: an injected client fault
    models a connection that never carried the request, which is
    exactly the class of failure the retry layer may replay blindly.
    """


_registry = FaultRegistry()


def configure(spec: str | None = None, seed: int | None = None) -> None:
    """Apply -fault.spec / SEAWEEDFS_TPU_FAULT_SPEC.  ``seed`` defaults
    to SEAWEEDFS_TPU_FAULT_SEED or 0 for reproducible runs."""
    if spec is None:
        spec = os.environ.get("SEAWEEDFS_TPU_FAULT_SPEC") or None
    if seed is None:
        seed = int(os.environ.get("SEAWEEDFS_TPU_FAULT_SEED", "0"))
    _registry.configure(spec, seed)


def enabled() -> bool:
    return _registry.enabled


def counts() -> dict[str, int]:
    """{'service:kind': n} injection counters (metrics / assertions)."""
    with _registry._lock:
        return {f"{svc}:{kind}": n
                for (svc, kind), n in sorted(_registry._counts.items())}


def sync_hook(service: str, method: str) -> None:
    """Client-side hook for sync code paths: sleep the injected delay,
    raise FaultInjected for injected errors."""
    if not _registry.enabled:
        return
    delay, error = _registry.decide(service, op_of(method))
    if delay:
        time.sleep(delay)
    if error:
        raise FaultInjected(f"injected fault: {service} {method}")


def middleware(service: str):
    """Server-side injection for rpc/http.App, after the tracing and
    deadline middlewares.

    Injected errors answer 503 + X-Sw-Retryable before the handler
    runs (no state was touched, so it is safe to replay); injected
    delays sleep in front of the handler so every downstream timing
    (client timeout, deadline) sees them.
    """
    from ..rpc.http import text_response
    from . import retry as _retry

    skip = {"/metrics", "/debug/traces", "/debug/breakers", "/status",
            "/healthz"}

    def mw(req, handler):
        if not _registry.enabled or req.path in skip:
            return handler(req)
        delay, error = _registry.decide(service, op_of(req.method))
        if delay:
            time.sleep(delay)
        if error:
            resp = text_response("fault injected\n", status=503)
            resp.headers.update({_retry.RETRYABLE_HEADER: "1",
                                 "Retry-After": "0"})
            return resp
        return handler(req)

    return mw
