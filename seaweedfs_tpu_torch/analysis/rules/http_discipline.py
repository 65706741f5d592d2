"""Sync-HTTP discipline; the counterpart of
seaweedfs_tpu/analysis/rules/http_discipline.py.

All HTTP in the package flows through rpc/httpclient.py's ``session()``
— the one place that enforces timeouts, deadline propagation, retries,
and circuit breaking. The port has no ``requests``: its raw clients are
the standard library's, an ``http.client`` connection or a
``urllib.request`` opener, and one of those outside rpc/httpclient.py
bypasses the whole robustness layer. A ``session()`` call without
``timeout=`` can hang a worker thread forever on one dead peer.
"""
from __future__ import annotations

import ast

from ..engine import PKG_PREFIX, Rule, register

VERBS = {"get", "post", "put", "delete", "head", "patch", "options",
         "request"}
# the standard library's HTTP clients, by the name that builds one
RAW_CLIENTS = {"HTTPConnection", "HTTPSConnection", "urlopen",
               "build_opener"}
# module -> why a raw client is the right one there
ALLOWED_RAW = {
    PKG_PREFIX + "rpc/httpclient.py": "the sanctioned client itself",
    # the reference's pusher PUTs through `requests` under an alias
    # (`_rq.put`, seaweedfs_tpu/utils/metrics.py start_push), outside
    # its session(): a pushgateway is no cluster peer, so no breaker,
    # retry or deadline of the session belongs on it
    PKG_PREFIX + "utils/metrics.py": "the pushgateway loop",
}


def raw_client(call: ast.Call) -> str | None:
    """The name of the raw HTTP client this call builds or opens."""
    f = call.func
    name = f.attr if isinstance(f, ast.Attribute) else \
        f.id if isinstance(f, ast.Name) else ""
    return name if name in RAW_CLIENTS else None


def is_session_verb(call: ast.Call) -> bool:
    """``session().<verb>(...)`` — the pooled-adapter call shape."""
    f = call.func
    return (isinstance(f, ast.Attribute) and f.attr in VERBS
            and isinstance(f.value, ast.Call)
            and isinstance(f.value.func, ast.Name)
            and f.value.func.id == "session")


@register
class RawRequestsRule(Rule):
    name = "raw-requests"
    description = ("a raw http.client / urllib.request client bypasses "
                   "the retry/deadline/breaker layer; use "
                   "rpc.httpclient.session()")

    def wants(self, rel: str) -> bool:
        return (rel.startswith(PKG_PREFIX) and rel.endswith(".py")
                and rel not in ALLOWED_RAW)

    def visit_Call(self, ctx, node: ast.Call) -> None:
        client = raw_client(node)
        if client:
            self.report(ctx, node,
                        f"raw {client}() bypasses the retry/deadline/"
                        "breaker layer; use rpc.httpclient.session()")


@register
class SessionTimeoutRule(Rule):
    name = "session-timeout"
    description = ("every session().<verb>() call must pass an "
                   "explicit timeout= (a hung peer would pin the "
                   "worker forever)")

    def visit_Call(self, ctx, node: ast.Call) -> None:
        if not is_session_verb(node):
            return
        ctx.run.stats["session_calls"] = \
            ctx.run.stats.get("session_calls", 0) + 1
        if not any(kw.arg == "timeout" for kw in node.keywords) and \
                not any(kw.arg is None for kw in node.keywords):
            self.report(ctx, node,
                        f"session().{node.func.attr}() without an "
                        "explicit timeout=")
