"""Resource safety: streamed responses and sockets close on all paths;
the counterpart of seaweedfs_tpu/analysis/rules/resource_safety.py.

A ``stream=True`` response pins a pooled connection until ``close()``
— leak a few on error paths and the shared ``session()`` pool (10
conns) is exhausted, after which every gateway hop serialises. The
sanctioned shapes are ``with session().get(..., stream=True) as r:``
or ``r = ...`` + ``r.close()`` in a ``finally:``.

A raw socket created inside a function must either escape to a
long-lived owner (``self._sock = s``, returned, handed to another
call) or be closed on all paths the same way.
"""
from __future__ import annotations

import ast

from ..engine import Rule, register


def _close_in_finally(scope: ast.AST, name: str) -> bool:
    for node in ast.walk(scope):
        if isinstance(node, ast.Try) and node.finalbody:
            for fin in node.finalbody:
                for sub in ast.walk(fin):
                    if isinstance(sub, ast.Call) and \
                            isinstance(sub.func, ast.Attribute) and \
                            sub.func.attr == "close" and \
                            isinstance(sub.func.value, ast.Name) and \
                            sub.func.value.id == name:
                        return True
    return False


def _escapes(scope: ast.AST, name: str, assign: ast.AST) -> bool:
    """Does `name` escape the function — stored on an object,
    returned, yielded, or passed to another call?"""
    for node in ast.walk(scope):
        if node is assign:
            continue
        if isinstance(node, ast.Assign):
            if isinstance(node.value, ast.Name) and \
                    node.value.id == name and \
                    any(isinstance(t, (ast.Attribute, ast.Subscript))
                        for t in node.targets):
                return True
        elif isinstance(node, (ast.Return, ast.Yield)):
            v = node.value
            if isinstance(v, ast.Name) and v.id == name:
                return True
        elif isinstance(node, ast.Call):
            for a in list(node.args) + [kw.value for kw in node.keywords]:
                if isinstance(a, ast.Name) and a.id == name and not (
                        isinstance(node.func, ast.Attribute)
                        and isinstance(node.func.value, ast.Name)
                        and node.func.value.id == name):
                    return True
    return False


@register
class ResourceSafetyRule(Rule):
    name = "resource-safety"
    description = ("stream=True responses and locally-created sockets "
                   "are closed on all paths (with / finally) or escape "
                   "to a long-lived owner")

    def visit_Call(self, ctx, node: ast.Call) -> None:
        streamed = any(kw.arg == "stream"
                       and isinstance(kw.value, ast.Constant)
                       and kw.value.value is True
                       for kw in node.keywords)
        f = node.func
        sockety = (isinstance(f, ast.Attribute)
                   and f.attr in ("create_connection", "socket")
                   and isinstance(f.value, ast.Name)
                   and f.value.id == "socket")
        if not streamed and not sockety:
            return
        what = "stream=True response" if streamed else "socket"
        if streamed:
            ctx.run.stats["stream_sites"] = \
                ctx.run.stats.get("stream_sites", 0) + 1
        parent = ctx.parent(node)
        # `with session().get(..., stream=True) as r:` — possibly one
        # wrapper deep, e.g. closing(...)
        p = parent
        if isinstance(p, ast.Call):
            p = ctx.parent(p)
        if isinstance(p, ast.withitem):
            return
        scope = ctx.func if ctx.func is not None else ctx.tree
        if sockety and isinstance(parent, ast.Assign) and \
                any(isinstance(t, (ast.Attribute, ast.Subscript))
                    for t in parent.targets):
            return  # stored straight onto a long-lived owner
        if isinstance(parent, ast.Assign) and \
                len(parent.targets) == 1 and \
                isinstance(parent.targets[0], ast.Name):
            name = parent.targets[0].id
            if _close_in_finally(scope, name):
                return
            if sockety and _escapes(scope, name, parent):
                return
        self.report(ctx, node,
                    f"{what} not closed on all paths — use `with` or "
                    f"close() in a finally:")
