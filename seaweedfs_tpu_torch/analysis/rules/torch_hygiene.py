"""Torch hygiene in compiled code and the staged feed path; the twin of
seaweedfs_tpu/analysis/rules/jax_hygiene.py.

Two contracts:

1. No host-sync primitive — ``torch.cuda.synchronize()``,
   ``.synchronize()``, ``.item()``, ``.cpu()``, ``.tolist()``,
   ``.numpy()``, ``np.asarray``/``np.array`` of a tensor — inside a
   function decorated with ``torch.compile`` or ``torch.jit.script``
   / ``torch.jit.trace``. Under compile each one breaks the graph and
   syncs on every call; under script it does not compile, and under
   trace it freezes a value that should be data-dependent.

2. In the staged feed modules (ops/codec_torch.py, ops/codec_cuda.py,
   ops/codec_mesh.py, models/ec_pipeline.py, ec/probe.py) the overlap
   of upload, kernel and read-back is the whole point: a stray sync
   (the primitives above, or ``.to("cpu")``) on the submit path
   re-serialises the streams and the measured overlap collapses. Sync
   is allowed only in the drain-site functions named below, where
   blocking IS the contract.
"""
from __future__ import annotations

import ast

from ..engine import PKG_PREFIX, Rule, register
from .device_sync import sync_reason

FEED_MODULES = (
    "ops/codec_torch.py",
    "ops/codec_cuda.py",
    "ops/codec_mesh.py",
    "models/ec_pipeline.py",
    "ec/probe.py",
)

# drain sites: functions whose contract is "block here" — the staged
# feed's upload/drain workers (`upload` waits for its ring slot to be
# free, `wait` for a block's read-back event: DeviceLane.wait is the
# drain side of the lane), the host readback helpers (`_readback`
# returns a host array, so it must wait for it), and the
# scheduled-vs-dense measurement probes (run_sched/run_dense and their
# `timed` wrapper time one synchronous kernel each so the chooser
# compares wall clock, never called on the streaming submit path)
ALLOWED_SYNC_FUNCS = {"upload", "drain", "finish", "up", "down",
                      "wait", "_readback", "_collect", "run_sched",
                      "run_dense", "timed"}


def _is_compiled(func: ast.AST) -> bool:
    """Decorated with torch.compile / torch.jit.script / .trace."""
    for dec in getattr(func, "decorator_list", ()):
        for node in ast.walk(dec):
            if isinstance(node, ast.Attribute) and (
                    node.attr == "compile"
                    or node.attr in ("script", "trace")
                    and isinstance(node.value, ast.Attribute)
                    and node.value.attr == "jit"):
                return True
    return False


def _feed_sync_reason(node: ast.Call) -> str | None:
    reason = sync_reason(node)
    if reason:
        return reason
    f = node.func
    if isinstance(f, ast.Attribute) and f.attr == "to" and node.args \
            and isinstance(node.args[0], ast.Constant) \
            and node.args[0].value == "cpu":
        return '.to("cpu")'
    return None


@register
class TorchHygieneRule(Rule):
    name = "torch-hygiene"
    description = ("no host-sync primitives inside compiled functions "
                   "or on the staged feed's submit path (allowlisted "
                   "drain sites only)")

    def wants(self, rel: str) -> bool:
        return rel.startswith(PKG_PREFIX) and rel.endswith(".py")

    def visit_Call(self, ctx, node: ast.Call) -> None:
        reason = _feed_sync_reason(node)
        in_feed = (ctx.in_pkg() or "") in FEED_MODULES
        compiled = [fn for fn in ctx.func_stack if _is_compiled(fn)]
        if compiled:
            f = node.func
            np_conv = (isinstance(f, ast.Attribute)
                       and f.attr in ("asarray", "array")
                       and isinstance(f.value, ast.Name)
                       and f.value.id == "np")
            numpy = isinstance(f, ast.Attribute) and f.attr == "numpy"
            if reason or np_conv or numpy:
                what = reason or (".numpy()" if numpy else "np." + f.attr)
                self.report(ctx, node,
                            f"{what} inside compiled function "
                            f"{compiled[-1].name!r} — syncs the host "
                            "and breaks the graph")
            return
        if not in_feed or reason is None:
            return
        ctx.run.stats["feed_sync_sites"] = \
            ctx.run.stats.get("feed_sync_sites", 0) + 1
        fn_names = {getattr(fn, "name", "") for fn in ctx.func_stack}
        if not fn_names & ALLOWED_SYNC_FUNCS:
            self.report(ctx, node,
                        f"{reason} on the feed path outside the "
                        "allowlisted drain sites "
                        f"({', '.join(sorted(ALLOWED_SYNC_FUNCS))}) — "
                        "re-serialises the upload/compute overlap")
