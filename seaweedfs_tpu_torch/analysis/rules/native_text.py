"""Comment-contract checks over the native data plane's C++ source;
the counterpart of seaweedfs_tpu/analysis/rules/native_text.py.

The native fronts are single-threaded-per-IO-thread event loops: any
sleep on an IO thread stalls every connection that thread owns. The
one sanctioned site is the fault gate (``gate_request``), where the
stall IS the failure mode being modelled — its header comment says so
— and chaos runs are the only place fault delays are armed. This rule
pins that contract: ``sleep``/``usleep``/``nanosleep``/``sleep_for``
may appear only inside ``gate_request``'s brace extent.

It also pins FrontStats ownership: the per-role stats blocks are a
static array by design; any ``new FrontStats`` must have a matching
``delete`` of the assigned pointer, else the per-connection churn
leaks.
"""
from __future__ import annotations

import re

from ..engine import PKG_PREFIX, TextRule, register

_SLEEP_RE = re.compile(r"\b(usleep|nanosleep|sleep_for|sleep)\s*\(")
_NEW_STATS_RE = re.compile(r"\b(?:(\w+)\s*=\s*)?new\s+FrontStats\b")
_GATE_RE = re.compile(r"^\s*(?:\w[\w:<>*&\s]*\s)?gate_request\s*\(")


def _function_extent(lines: list[str], start: int) -> tuple[int, int]:
    """(first, last) 0-based line range of the brace-matched body
    starting at the definition on `start`."""
    depth = 0
    opened = False
    for i in range(start, len(lines)):
        for ch in lines[i]:
            if ch == "{":
                depth += 1
                opened = True
            elif ch == "}":
                depth -= 1
                if opened and depth == 0:
                    return (start, i)
    return (start, len(lines) - 1)


def _strip_comment(line: str) -> str:
    return line.split("//", 1)[0]


@register
class NativeTextRule(TextRule):
    name = "dp-faults"
    description = ("dataplane.cc: sleeps only inside the fault gate "
                   "(gate_request); every new'd FrontStats freed")

    def wants(self, rel: str) -> bool:
        return rel.startswith(PKG_PREFIX + "native/") and \
            rel.endswith((".cc", ".h"))

    def check_text(self, ctx) -> None:
        lines = ctx.lines
        allowed: list[tuple[int, int]] = []
        for i, line in enumerate(lines):
            if _GATE_RE.match(line) and not line.rstrip().endswith(";"):
                allowed.append(_function_extent(lines, i))
        ctx.run.stats["dp_sleep_sites"] = \
            ctx.run.stats.get("dp_sleep_sites", 0)
        for i, line in enumerate(lines):
            code = _strip_comment(line)
            if _SLEEP_RE.search(code):
                ctx.run.stats["dp_sleep_sites"] += 1
                if not any(a <= i <= b for a, b in allowed):
                    self.report(ctx, None,
                                "sleep on a native IO thread outside "
                                "the fault gate (gate_request) — stalls "
                                "every conn the thread owns",
                                line=i + 1)
        news = []
        deletes = set()
        for i, line in enumerate(lines):
            code = _strip_comment(line)
            m = _NEW_STATS_RE.search(code)
            if m:
                news.append((i + 1, m.group(1)))
            for d in re.finditer(r"\bdelete(?:\[\])?\s+(\w+)", code):
                deletes.add(d.group(1))
        for lineno, var in news:
            if var is None or var not in deletes:
                self.report(ctx, None,
                            f"new FrontStats never deleted"
                            f"{f' (assigned to {var!r})' if var else ''}"
                            " — per-role stats belong in the static "
                            "front_stats array",
                            line=lineno)
