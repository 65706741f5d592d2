"""No bare device synchronization in serving code; the torch twin of
seaweedfs_tpu/analysis/rules/device_sync.py.

Serving packages (server/, filer/, s3/, mount/) must never touch the
device directly. A ``torch.cuda.synchronize()``, a stream's or event's
``.synchronize()``, or a read-back (``.item()``, ``.cpu()``,
``.tolist()``) stalls a request thread behind the device for the whole
transfer. A device named as a bare ``"cuda"`` (``.cuda()`` with no
index, ``.to("cuda")``, ``device="cuda"``) means whatever device is
current on the calling thread — the torch form of the reference's
uncommitted ``device_put`` — which is how a launch once moved its
caller's current device. All device traffic belongs in the staged feed
(ops/codec_torch.py) behind the measured router (ec/backend.py).
"""
from __future__ import annotations

import ast

from ..engine import PKG_PREFIX, Rule, register

SERVING_DIRS = ("server/", "filer/", "s3/", "mount/")


def sync_reason(call: ast.Call) -> str | None:
    """The host-device sync this call makes, or None."""
    f = call.func
    if not isinstance(f, ast.Attribute):
        return None
    if f.attr == "synchronize":
        cuda = (isinstance(f.value, ast.Attribute)
                and f.value.attr == "cuda"
                and isinstance(f.value.value, ast.Name)
                and f.value.value.id == "torch")
        return "torch.cuda.synchronize()" if cuda else ".synchronize()"
    if f.attr in ("item", "cpu", "tolist") and not call.args \
            and not call.keywords:
        return f".{f.attr}()"
    return None


def _is_bare_cuda(expr: ast.expr) -> bool:
    return isinstance(expr, ast.Constant) and expr.value == "cuda"


def bare_device(call: ast.Call) -> str | None:
    """The bare "cuda" device this call names, or None."""
    f = call.func
    if isinstance(f, ast.Attribute) and f.attr == "cuda" and \
            not call.args and not call.keywords:
        return ".cuda()"
    if isinstance(f, ast.Attribute) and f.attr == "to" and \
            call.args and _is_bare_cuda(call.args[0]):
        return '.to("cuda")'
    if any(kw.arg == "device" and _is_bare_cuda(kw.value)
           for kw in call.keywords):
        return 'device="cuda"'
    return None


@register
class DeviceSyncRule(Rule):
    name = "device-sync"
    description = ("no torch.cuda.synchronize / .synchronize / .item / "
                   ".cpu / .tolist / bare \"cuda\" device in serving "
                   "code")

    def wants(self, rel: str) -> bool:
        if not rel.startswith(PKG_PREFIX) or not rel.endswith(".py"):
            return False
        return rel[len(PKG_PREFIX):].startswith(SERVING_DIRS)

    def visit_Call(self, ctx, node: ast.Call) -> None:
        reason = sync_reason(node)
        if reason:
            self.report(ctx, node, f"{reason} — blocks the request "
                        "thread on the device")
            return
        device = bare_device(node)
        if device:
            self.report(ctx, node, f"{device} names whatever device is "
                        "current on the calling thread; name the "
                        "device with its index")
