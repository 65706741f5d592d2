"""Context propagation across thread hops and HTTP servers; the
counterpart of seaweedfs_tpu/analysis/rules/context_propagation.py.

The tracing/deadline plane rides contextvars (utils/tracing.py,
utils/retry.py). Two ways to silently drop it:

1. An ``executor.submit(fn, ...)`` / per-request ``Thread(target=...)``
   in traced modules runs ``fn`` on a bare thread — the trace and the
   deadline vanish and the hop becomes invisible in /debug/traces and
   unbounded in time. The sanctioned shape is
   ``pool.submit(contextvars.copy_context().run, fn, ...)``.
   Long-lived service threads (appliers, accept loops) carry no
   request context by design, so only submits — plus Threads created
   inside request handlers or async bodies — are checked.
2. An ``rpc.http.App`` whose ``middlewares=`` leave out the deadline
   middleware (``retry.middleware``, which ``server_middlewares``
   holds) never parses ``X-Sw-Deadline``: every handler behind it does
   dead work for callers that already gave up, and mints no budget for
   its own downstream hops. An App built without ``middlewares=``
   keeps the deadline middleware (rpc/http.py), so it passes.
"""
from __future__ import annotations

import ast

from ..engine import PKG_PREFIX, Rule, register

TRACED_DIRS = ("server/", "filer/", "s3/", "mount/", "webdav/")


def _is_copy_context_run(expr: ast.expr) -> bool:
    """``contextvars.copy_context().run`` (any module alias)."""
    return (isinstance(expr, ast.Attribute) and expr.attr == "run"
            and isinstance(expr.value, ast.Call)
            and isinstance(expr.value.func, ast.Attribute)
            and expr.value.func.attr == "copy_context")


def _is_deadline_middleware(expr: ast.AST) -> bool:
    """``retry.middleware(...)`` or ``server_middlewares(...)``."""
    if not isinstance(expr, ast.Call):
        return False
    f = expr.func
    if isinstance(f, ast.Attribute):
        return (f.attr == "middleware" and isinstance(f.value, ast.Name)
                and f.value.id == "retry") or \
            f.attr == "server_middlewares"
    return isinstance(f, ast.Name) and f.id == "server_middlewares"


@register
class ContextPropagationRule(Rule):
    name = "context-propagation"
    description = ("executor submits in traced modules wrap "
                   "contextvars.copy_context(); every rpc.http.App "
                   "keeps the deadline middleware")

    def wants(self, rel: str) -> bool:
        if not rel.startswith(PKG_PREFIX) or not rel.endswith(".py"):
            return False
        return rel[len(PKG_PREFIX):].startswith(TRACED_DIRS)

    def visit_Call(self, ctx, node: ast.Call) -> None:
        f = node.func
        if isinstance(f, ast.Attribute) and f.attr == "submit":
            recv = f.value
            recv_name = recv.attr if isinstance(recv, ast.Attribute) \
                else recv.id if isinstance(recv, ast.Name) else ""
            if recv_name == "commit" or recv_name.endswith("_commit"):
                # CommitScheduler.submit enqueues a (volume, nbytes)
                # pair, not a callable: no user code crosses the hop
                # and the ack ticket is waited on in the caller's own
                # context, so there is nothing to copy
                return
            ctx.run.stats["submit_sites"] = \
                ctx.run.stats.get("submit_sites", 0) + 1
            if not node.args or not _is_copy_context_run(node.args[0]):
                self.report(ctx, node,
                            "executor.submit without "
                            "contextvars.copy_context().run — the "
                            "trace and deadline are dropped on the "
                            "thread hop")
            return
        if isinstance(f, ast.Attribute) and f.attr == "Thread" or \
                isinstance(f, ast.Name) and f.id == "Thread":
            func = ctx.func
            per_request = func is not None and (
                isinstance(func, ast.AsyncFunctionDef)
                or func.name.startswith("handle_"))
            if not per_request:
                return  # service thread: carries no request context
            target = next((kw.value for kw in node.keywords
                           if kw.arg == "target"), None)
            if target is None or not _is_copy_context_run(target):
                self.report(ctx, node,
                            "per-request Thread(target=...) without "
                            "contextvars.copy_context().run")
            return
        if isinstance(f, ast.Attribute) and f.attr == "App" or \
                isinstance(f, ast.Name) and f.id == "App":
            mw = next((kw.value for kw in node.keywords
                       if kw.arg == "middlewares"), None)
            if mw is None or (isinstance(mw, ast.Constant)
                              and mw.value is None):
                return  # App's default chain is the deadline middleware
            if not any(_is_deadline_middleware(sub)
                       for sub in ast.walk(mw)):
                self.report(ctx, node,
                            "App(middlewares=...) without the deadline "
                            "middleware (retry.middleware or "
                            "server_middlewares) — handlers behind it "
                            "never see X-Sw-Deadline and do dead work "
                            "for callers that gave up")
