"""Async hygiene: no blocking calls inside ``async def`` bodies; the
counterpart of seaweedfs_tpu/analysis/rules/async_hygiene.py.

The reference's gateways are single event loops, where one blocking
call on the loop thread stalls every in-flight request behind it. The
port serves on threads and has no ``async def`` at all, so this rule
guards the shape: an ``async def`` added to gateway or edge code must
not block (``time.sleep``, ``session().<verb>``, ``urlopen``, a socket
connect, a subprocess wait, an unbounded lock acquire). A nested *sync*
``def`` may block — it runs off the loop — so only calls whose
innermost enclosing function is async count.

``blocking_reason`` also serves lock-discipline, which asks it for the
thread's view of the same calls: a blocking call under a lock stalls
every thread waiting for that lock.
"""
from __future__ import annotations

import ast

from ..engine import PKG_PREFIX, Rule, register
from .http_discipline import is_session_verb

SERVING_DIRS = ("server/", "filer/", "s3/", "mount/")
EDGE_MODULES = ("utils/qos.py", "utils/retry.py", "utils/faults.py",
                "utils/ratelimit.py")

LOCKISH = ("lock", "rlock", "mutex", "cond", "cv", "condition", "sem",
           "semaphore")


def lockish_name(expr: ast.expr) -> str | None:
    """Trailing identifier of a lock-looking receiver (``self._lock``,
    ``bucket._cond`` ...), else None."""
    name = None
    if isinstance(expr, ast.Attribute):
        name = expr.attr
    elif isinstance(expr, ast.Name):
        name = expr.id
    if name is None:
        return None
    tail = name.lower().lstrip("_").split("_")[-1]
    return name if tail in LOCKISH else None


def _is_time_sleep(call: ast.Call) -> bool:
    f = call.func
    if isinstance(f, ast.Attribute) and f.attr == "sleep" and \
            isinstance(f.value, ast.Name) and f.value.id in ("time",
                                                            "_time"):
        return True
    return isinstance(f, ast.Name) and f.id == "sleep"


def _is_subprocess_wait(call: ast.Call) -> bool:
    f = call.func
    return (isinstance(f, ast.Attribute)
            and f.attr in ("run", "check_call", "check_output", "call")
            and isinstance(f.value, ast.Name)
            and f.value.id in ("subprocess", "_subprocess"))


def _is_socket_connect(call: ast.Call) -> bool:
    """``socket.create_connection(...)`` or any ``<x>.connect(...)``."""
    f = call.func
    if not isinstance(f, ast.Attribute):
        return False
    if f.attr == "connect":
        return True
    return (f.attr == "create_connection"
            and isinstance(f.value, ast.Name) and f.value.id == "socket")


def _is_urlopen(call: ast.Call) -> bool:
    f = call.func
    return (isinstance(f, ast.Attribute) and f.attr == "urlopen") or \
        (isinstance(f, ast.Name) and f.id == "urlopen")


# (the loop's reason, the lock holder's reason) for each kind of
# blocking call
_REASONS = {
    "sleep": ("time.sleep blocks the event loop; await asyncio.sleep",
              "time.sleep while a lock is held"),
    "http": ("sync HTTP on the event loop; run it on a worker thread",
             "sync HTTP while a lock is held: one slow peer stalls "
             "every thread waiting for the lock"),
    "subprocess": ("blocking subprocess wait on the event loop; use "
                   "asyncio.create_subprocess_exec",
                   "subprocess wait while a lock is held"),
    "connect": ("blocking socket connect on the event loop; use "
                "loop.sock_connect / asyncio streams",
                "socket connect while a lock is held: an unreachable "
                "peer stalls every thread waiting for the lock"),
    "acquire": ("blocking lock acquire on the event loop; acquire on "
                "a worker thread or with a timeout",
                "unbounded lock acquire while a lock is held"),
}


def _blocking_kind(call: ast.Call) -> str | None:
    if _is_time_sleep(call):
        return "sleep"
    if is_session_verb(call) or _is_urlopen(call):
        return "http"
    if _is_subprocess_wait(call):
        return "subprocess"
    if _is_socket_connect(call):
        return "connect"
    f = call.func
    if isinstance(f, ast.Attribute) and f.attr == "acquire" and \
            lockish_name(f.value):
        nonblocking = any(
            kw.arg == "blocking" and isinstance(kw.value, ast.Constant)
            and kw.value.value is False for kw in call.keywords)
        has_timeout = any(kw.arg == "timeout" for kw in call.keywords)
        if not nonblocking and not has_timeout:
            return "acquire"
    return None


def blocking_reason(call: ast.Call, on: str = "loop") -> str | None:
    """Why this call blocks, or None if it doesn't: on the event loop
    (``on="loop"``) or for the threads queued behind a held lock
    (``on="lock"``)."""
    kind = _blocking_kind(call)
    if kind is None:
        return None
    loop_reason, lock_reason = _REASONS[kind]
    return loop_reason if on == "loop" else lock_reason


@register
class AsyncHygieneRule(Rule):
    name = "async-hygiene"
    description = ("no blocking call (sleep, sync HTTP, subprocess, "
                   "socket connect, lock acquire) inside async def in "
                   "gateway/edge code")

    def wants(self, rel: str) -> bool:
        if not rel.startswith(PKG_PREFIX) or not rel.endswith(".py"):
            return False
        sub = rel[len(PKG_PREFIX):]
        return sub.startswith(SERVING_DIRS) or sub in EDGE_MODULES

    def visit_AsyncFunctionDef(self, ctx, node) -> None:
        ctx.run.stats["async_functions"] = \
            ctx.run.stats.get("async_functions", 0) + 1

    def visit_Call(self, ctx, node: ast.Call) -> None:
        if not ctx.in_async():
            return
        reason = blocking_reason(node)
        if reason:
            self.report(ctx, node,
                        f"in async def {ctx.func.name}: {reason}")
