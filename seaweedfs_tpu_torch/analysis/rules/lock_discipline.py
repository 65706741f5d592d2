"""Lock discipline for the threaded data/metadata plane; the
counterpart of seaweedfs_tpu/analysis/rules/lock_discipline.py.

Three contracts, all learned the hard way by every storage system:

1. **bare-acquire**: a ``lock.acquire()`` outside ``with`` must have a
   matching ``release()`` in a ``finally`` in the same function — an
   exception between acquire and release otherwise wedges every
   future user of that lock (wrapper classes whose *job* is
   acquire/release — ``__enter__``/``__exit__``/``acquire``/
   ``release`` methods — are exempt).
2. **blocking-under-lock**: no blocking call (sleep, sync HTTP,
   ``urlopen``, subprocess wait, socket connect, unbounded
   ``acquire()``) while a lock is held: every thread that wants the
   lock waits behind the call. A convoy behind one slow peer under
   the filer mutation lock stalls the whole namespace; the deferred
   chunk-free drain in filer/filer.py exists precisely because of
   this rule.
3. **lock-order**: the declared order for the filer locks
   (``_mutation_lock`` outer, ``_hardlink_lock`` inner — documented
   at their construction site) must never invert; an inversion is a
   deadlock waiting for the right interleaving.
4. **commit-fsync**: the group-commit scheduler
   (``storage/commit.py``) must never fsync while holding any lock —
   the whole point of group commit is that writers keep appending
   (under the volume write lock) while the previous batch's fsync is
   in flight; an fsync under a lock in the committer re-serializes
   the pipeline and turns every batch window into a convoy. Any
   ``os.fsync`` / ``.sync()`` / ``.commit_batch()`` call inside a
   ``with <lock>`` block there is a violation.

Condition ``.wait()`` is exempt under its own lock (it releases it),
and nested ``def``s are not scanned (they run elsewhere).
"""
from __future__ import annotations

import ast

from ..engine import PKG_PREFIX, Rule, register
from .async_hygiene import blocking_reason, lockish_name

# functions whose contract IS acquire/release management
WRAPPER_FUNCS = {"acquire", "release", "__enter__", "__exit__",
                 "acquire_async", "locked"}

# declared lock order: (outer, inner) — acquiring `outer` while
# `inner` is held is an inversion
ORDER = [("_mutation_lock", "_hardlink_lock")]

# contract 4: files where durability syscalls may never run under a
# lock, and the calls that count as one
FSYNC_FREE_FILES = ("storage/commit.py",)
FSYNC_CALLS = {"fsync", "sync", "commit_batch"}


def _recv_text(expr: ast.expr) -> str:
    try:
        return ast.unparse(expr)
    except Exception:
        return ""


def _is_nonblocking(call: ast.Call) -> bool:
    for kw in call.keywords:
        if kw.arg == "blocking" and isinstance(kw.value, ast.Constant) \
                and kw.value.value is False:
            return True
        if kw.arg == "timeout":
            return True
    # positional `acquire(blocking, timeout)` — bounded when both are
    # given or blocking is a literal False; a single non-False
    # positional (e.g. `bucket.acquire(n)`) still blocks
    if len(call.args) >= 2:
        return True
    if len(call.args) == 1:
        a = call.args[0]
        return isinstance(a, ast.Constant) and a.value is False
    return False


def _releases_in_finally(func: ast.AST, recv: str) -> bool:
    """Does any `finally:` block in `func` release `recv`?"""
    for node in ast.walk(func):
        if isinstance(node, ast.Try) and node.finalbody:
            for fin in node.finalbody:
                for sub in ast.walk(fin):
                    if isinstance(sub, ast.Call) and \
                            isinstance(sub.func, ast.Attribute) and \
                            sub.func.attr == "release" and \
                            _recv_text(sub.func.value) == recv:
                        return True
    return False


def _lock_of_with(node: ast.With) -> list[tuple[str, str]]:
    """[(lock attr/name tail, full receiver text)] for lockish
    context exprs of this with-statement."""
    out = []
    for item in node.items:
        expr = item.context_expr
        name = lockish_name(expr)
        if name:
            out.append((name, _recv_text(expr)))
    return out


@register
class LockDisciplineRule(Rule):
    name = "lock-discipline"
    description = ("acquire outside with needs release-in-finally; no "
                   "blocking call while a lock is held; declared lock "
                   "order never inverts; the group-commit scheduler "
                   "never fsyncs under a lock")

    def begin_file(self, ctx) -> None:
        self._covered: set[int] = set()

    # -- contract 1: bare acquire ---------------------------------------
    def visit_Call(self, ctx, node: ast.Call) -> None:
        f = node.func
        if not (isinstance(f, ast.Attribute) and f.attr == "acquire"):
            return
        name = lockish_name(f.value)
        if not name:
            return
        func = ctx.func
        if func is not None and func.name in WRAPPER_FUNCS:
            return
        ctx.run.stats["lock_acquires"] = \
            ctx.run.stats.get("lock_acquires", 0) + 1
        recv = _recv_text(f.value)
        scope = func if func is not None else ctx.tree
        if not _releases_in_finally(scope, recv):
            self.report(ctx, node,
                        f"{recv}.acquire() without a matching "
                        f"{recv}.release() in a finally: — an "
                        "exception here wedges the lock; use `with` "
                        "or try/finally")

    # -- contracts 2+3: scanned per top-level lock `with` ---------------
    def visit_With(self, ctx, node: ast.With) -> None:
        if id(node) in self._covered:
            return
        locks = _lock_of_with(node)
        if not locks:
            return
        held = [name for name, _recv in locks]
        self._scan_held(ctx, node.body, held)

    def _scan_held(self, ctx, body: list, held: list[str]) -> None:
        for stmt in body:
            for node in self._walk_no_defs(stmt):
                if isinstance(node, ast.With):
                    self._covered.add(id(node))
                elif isinstance(node, ast.Call):
                    self._check_call_under_lock(ctx, node, held)
        # nested lock-withs: recurse with the extended held set
        for stmt in body:
            for node in self._walk_no_defs(stmt):
                if isinstance(node, ast.With):
                    inner = _lock_of_with(node)
                    for name, _recv in inner:
                        self._check_order(ctx, node, name, held)

    def _check_order(self, ctx, node, acquiring: str,
                     held: list[str]) -> None:
        for outer, inner in ORDER:
            if acquiring == outer and inner in held:
                self.report(ctx, node,
                            f"lock-order inversion: acquiring {outer} "
                            f"while {inner} is held (declared order: "
                            f"{outer} outer, {inner} inner)")

    def _check_call_under_lock(self, ctx, call: ast.Call,
                               held: list[str]) -> None:
        f = call.func
        # Condition.wait releases its lock — the sanctioned shape
        if isinstance(f, ast.Attribute) and f.attr == "wait":
            return
        # contract 4: no durability syscall under a lock in the
        # group-commit scheduler
        if isinstance(f, ast.Attribute) and f.attr in FSYNC_CALLS and \
                any(ctx.rel.endswith(p) for p in FSYNC_FREE_FILES):
            self.report(ctx, call,
                        f"committer fsyncs under {'/'.join(held)}: "
                        f"{_recv_text(f)}() while a lock is held "
                        "re-serializes the group-commit pipeline — "
                        "snapshot the queue under the lock, release, "
                        "then fsync")
            return
        reason = blocking_reason(call, on="lock")
        if reason is None and isinstance(f, ast.Attribute) and \
                f.attr == "acquire" and not _is_nonblocking(call):
            # unbounded acquire of anything (another lock, a token
            # bucket) while holding a lock: convoy or deadlock fuel
            reason = (f"unbounded {_recv_text(f.value)}.acquire() "
                      "while a lock is held")
        if reason:
            self.report(ctx, call,
                        f"while holding {'/'.join(held)}: {reason}")

    @staticmethod
    def _walk_no_defs(root: ast.AST):
        """Walk a statement's subtree without descending into nested
        function bodies (those run on other threads/later)."""
        stack = [root]
        while stack:
            node = stack.pop()
            yield node
            if isinstance(node, (ast.FunctionDef,
                                 ast.AsyncFunctionDef, ast.Lambda)):
                continue  # runs on another thread / later
            stack.extend(ast.iter_child_nodes(node))
