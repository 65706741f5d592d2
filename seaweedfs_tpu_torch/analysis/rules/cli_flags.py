"""CLI flag help; the counterpart of
seaweedfs_tpu/analysis/rules/cli_flags.py, with the reference's
EXPECTED surface unchanged.

Every robustness CLI knob (-repair.*, -fault.*, -retry.*, -qos.*,
-filer.store.*, -filer.cache.*, -filer.native*, -tier.*,
-telemetry.*, -advisor.*, -ec.*, -commit.*) registered in cli.py
must carry non-empty help text — these flags gate chaos / repair /
overload / metadata-plane / tiering / native-front /
workload-telemetry / erasure-code / write-durability behaviour and
an undocumented one is effectively invisible to operators.
"""
from __future__ import annotations

import ast

from ..engine import PKG_PREFIX, Rule, register

PREFIXES = ("-repair.", "-fault.", "-retry.", "-qos.",
            "-filer.store.", "-filer.cache.", "-filer.native",
            "-tier.", "-telemetry.", "-advisor.", "-ec.", "-commit.")

# the documented surface this PR series promises; rot here means a
# flag was dropped without its docs/tests following
EXPECTED = (
    "-repair.enabled", "-repair.interval", "-repair.concurrency",
    "-repair.maxAttempts", "-repair.grace", "-repair.maxBytesPerSec",
    "-repair.partialEc", "-fault.spec", "-fault.seed",
    "-qos.enabled", "-qos.rate", "-qos.burst", "-qos.maxTenants",
    "-qos.maxDelay", "-qos.requestFloor", "-qos.spec",
    "-filer.store.shards", "-filer.cache.entries", "-filer.cache.pages",
    "-filer.native", "-filer.native.workers",
    "-tier.enabled", "-tier.interval", "-tier.concurrency",
    "-tier.sealAfterIdle", "-tier.offloadAfterIdle", "-tier.recallReads",
    "-tier.recallWindow", "-tier.maxAttempts", "-tier.maxBytesPerSec",
    "-tier.remote", "-tier.stateDir",
    "-telemetry.enabled", "-telemetry.alpha", "-telemetry.window",
    "-advisor.sealQuantile", "-advisor.demandQuantile",
    "-advisor.headroom",
    "-ec.backend", "-ec.code", "-ec.mesh.devices", "-ec.mesh.col",
    "-commit.durability", "-commit.maxDelay", "-commit.maxBytes")


@register
class CliFlagHelpRule(Rule):
    name = "cli-flag-help"
    description = ("robustness flags registered in cli.py must carry "
                   "non-empty help text")

    def wants(self, rel: str) -> bool:
        return rel == PKG_PREFIX + "cli.py"

    def begin_file(self, ctx) -> None:
        self._flags: dict[str, list] = {}

    def visit_Call(self, ctx, node: ast.Call) -> None:
        if not (isinstance(node.func, ast.Attribute)
                and node.func.attr == "add_argument"
                and node.args
                and isinstance(node.args[0], ast.Constant)
                and isinstance(node.args[0].value, str)):
            return
        flag = node.args[0].value
        if not flag.startswith(PREFIXES):
            return
        help_text = ""
        for kw in node.keywords:
            if kw.arg == "help" and isinstance(kw.value, ast.Constant):
                help_text = str(kw.value.value)
            elif kw.arg == "help":
                # computed help (f-string, call): accept it
                help_text = "<computed>"
        self._flags.setdefault(flag, []).append(
            (help_text.strip(), node.lineno))

    def end_file(self, ctx) -> None:
        ctx.run.stats["cli_flags_checked"] = len(self._flags)
        for flag, entries in sorted(self._flags.items()):
            for help_text, lineno in entries:
                if not help_text:
                    self.report(ctx, None,
                                f"flag {flag} registered without help "
                                "text", line=lineno)
        for expected in EXPECTED:
            if expected not in self._flags:
                self.report(ctx, None,
                            f"expected flag {expected} missing from "
                            "cli.py (documented surface rotted)",
                            line=1)
