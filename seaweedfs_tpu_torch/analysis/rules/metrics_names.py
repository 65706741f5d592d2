"""Metric-name discipline; the counterpart of
seaweedfs_tpu/analysis/rules/metrics_names.py.

Every metric name literal registered through utils/metrics.py must be
a valid Prometheus name used with exactly one metric type — a name
emitted both as a counter and a histogram would render a corrupt
exposition — and no name may squat on a histogram family's implicit
``_sum`` / ``_count`` / ``_bucket`` series.
"""
from __future__ import annotations

import ast
import re

from ..engine import Rule, register

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_KIND = {"counter_add": "counter", "gauge_set": "gauge",
         "histogram_observe": "histogram"}


def called_name(call: ast.Call) -> str:
    f = call.func
    if isinstance(f, ast.Attribute):
        return f.attr
    if isinstance(f, ast.Name):
        return f.id
    return ""


@register
class MetricNamesRule(Rule):
    name = "metric-names"
    description = ("metric names must be valid Prometheus names used "
                   "with exactly one metric type")

    def __init__(self):
        # name -> kind -> [(rel, lineno)]
        self._uses: dict[str, dict[str, list]] = {}

    def visit_Call(self, ctx, node: ast.Call) -> None:
        kind = _KIND.get(called_name(node))
        if kind is None or not node.args:
            return
        arg = node.args[0]
        if not (isinstance(arg, ast.Constant)
                and isinstance(arg.value, str)):
            return
        self._uses.setdefault(arg.value, {}).setdefault(kind, []).append(
            (ctx, node.lineno))

    def finish(self, engine) -> None:
        engine.run.stats["metric_names"] = len(self._uses)
        engine.run.stats["metric_name_list"] = sorted(self._uses)
        for name, kinds in sorted(self._uses.items()):
            ctx, lineno = next(iter(kinds.values()))[0]
            if not _NAME_RE.match(name):
                self.report(ctx, None,
                            f"invalid Prometheus metric name {name!r}",
                            line=lineno)
            if len(kinds) > 1:
                self.report(ctx, None,
                            f"metric {name!r} used with multiple types: "
                            f"{sorted(kinds)}", line=lineno)
        hists = {n for n, kinds in self._uses.items()
                 if "histogram" in kinds}
        for n, kinds in sorted(self._uses.items()):
            for h in hists:
                if n != h and n in (h + "_sum", h + "_count",
                                    h + "_bucket"):
                    ctx, lineno = next(iter(kinds.values()))[0]
                    self.report(ctx, None,
                                f"metric {n!r} collides with histogram "
                                f"{h!r}'s implicit series",
                                line=lineno)
