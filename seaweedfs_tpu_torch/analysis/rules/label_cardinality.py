"""Label-key cardinality; the counterpart of
seaweedfs_tpu/analysis/rules/label_cardinality.py.

Prometheus memory and the federated /cluster/metrics corpus scale with
the number of distinct label values; a per-request key (path, volume
id, trace id...) turns one family into millions of series. Label dicts
must be literal — inline or a simple ``lab = {...}`` assignment in the
same module — so their keys are statically checkable, and every key
must come from the allowlist below. Adding a key is a deliberate
cardinality decision, reviewed like one.
"""
from __future__ import annotations

import ast

from ..engine import Rule, register
from .metrics_names import called_name

_FUNCS = {"counter_add", "gauge_set", "histogram_observe"}

# Every key is bounded by construction: enum-like (kind, op, stage,
# outcome, method, direction, mode, reason), a fixed deployment set
# (backend, service, handler, collection, instance), HTTP classes and
# erasure-code specs (code: status classes on HTTP metrics; on EC
# metrics the code-family spec, bounded by ec.backend.KNOWN_CODES
# plus whatever -ec.code names — an operator-chosen constant, not
# per-request data), the histogram-internal bound (le), or capped by
# a registry (tenant: -qos.maxTenants + __overflow__; shard: exactly
# -filer.store.shards values; from/to/tier: the tier-state enum in
# master/tiering.py; dir: exactly {offload, recall}; q: the fixed
# quantile points {0.5, 0.9, 0.99} the workload sketches export).
# `stage` also carries the write-commit pipeline's fixed set
# {queue, fsync, replicate, ack} — bounded by the pipeline shape,
# never per-request data. `kernel` names a hand-written device kernel
# (one value per csrc/*.cu; today only coded_matmul), so it is bounded
# by the source tree.
ALLOWED = {
    "backend", "code", "collection", "dir", "direction", "from",
    "handler", "instance", "kernel", "kind", "le", "method", "mode",
    "op", "outcome", "q", "reason", "service", "shard", "stage",
    "tenant", "tier", "to",
}

# `le` is emitted by the histogram renderer itself and `direction` by
# the volume server's manually rendered native_front exposition —
# neither appears at a registry call site, so they may be "unused"
RENDERER_KEYS = {"le", "direction"}


def _labels_node(call: ast.Call) -> ast.expr | None:
    for kw in call.keywords:
        if kw.arg == "labels":
            return kw.value
    if len(call.args) >= 3:
        return call.args[2]
    return None


@register
class LabelCardinalityRule(Rule):
    name = "label-cardinality"
    description = ("metric label dicts must be literal and every key "
                   "allowlisted (bounded cardinality)")

    def __init__(self):
        self._used: set[str] = set()
        self._sites = 0

    def begin_file(self, ctx) -> None:
        self._assigned: dict[str, list[ast.Dict]] = {}
        self._calls: list[ast.Call] = []

    def visit_Assign(self, ctx, node: ast.Assign) -> None:
        if isinstance(node.value, ast.Dict):
            for tgt in node.targets:
                if isinstance(tgt, ast.Name):
                    self._assigned.setdefault(tgt.id, []).append(
                        node.value)

    def visit_Call(self, ctx, node: ast.Call) -> None:
        if called_name(node) in _FUNCS:
            self._calls.append(node)

    def end_file(self, ctx) -> None:
        # resolution happens after the walk so a `lab = {...}`
        # assignment anywhere in the module is visible
        for call in self._calls:
            lab = _labels_node(call)
            if lab is None or (isinstance(lab, ast.Constant)
                               and lab.value is None):
                continue
            self._sites += 1
            if isinstance(lab, ast.Dict):
                dicts = [lab]
            elif isinstance(lab, ast.Name) and lab.id in self._assigned:
                dicts = self._assigned[lab.id]
            else:
                self.report(ctx, call,
                            "labels must be a literal dict (inline or "
                            "a plain `name = {...}` assignment)")
                continue
            for d in dicts:
                for k in d.keys:
                    if k is None:
                        self.report(ctx, call,
                                    "**-unpacking hides label keys")
                    elif not (isinstance(k, ast.Constant)
                              and isinstance(k.value, str)):
                        self.report(ctx, call,
                                    "label keys must be string literals")
                    elif k.value not in ALLOWED:
                        self.report(
                            ctx, call,
                            f"label key {k.value!r} outside the "
                            "cardinality allowlist — if genuinely "
                            "bounded, add it to ALLOWED in "
                            "analysis/rules/label_cardinality.py with "
                            "a justification")
                    else:
                        self._used.add(k.value)

    def finish(self, engine) -> None:
        engine.run.stats["label_sites"] = self._sites
        engine.run.stats["label_keys_unused"] = sorted(
            ALLOWED - self._used - RENDERER_KEYS)
