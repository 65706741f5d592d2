"""The single-pass rule engine; the counterpart of
seaweedfs_tpu/analysis/engine.py, scanning this package.

Every rule is a registered visitor class; the engine parses each file
exactly once per run and dispatches AST nodes to every rule that
declared an interest, sharing scope info (function/class stacks,
parent links) so rules never re-walk the tree themselves. Text rules
(the C++ contract pass over dataplane.cc) see raw source instead of an
AST. The walk skips `_build/`, where the native libraries and the CUDA
kernels are built, so a tree scans the same before and after a build.
Findings flow through per-line ``# sw-lint: disable=<rule>``
suppressions and the checked-in baseline before they are reported.
"""
from __future__ import annotations

import ast
import json
import os
import re
from dataclasses import dataclass, field

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
PKG_PREFIX = "seaweedfs_tpu_torch/"
BASELINE_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "baseline.json")

_SUPPRESS_RE = re.compile(r"#\s*sw-lint:\s*disable=([\w.,\- ]+)")


@dataclass(frozen=True)
class Finding:
    rule: str
    path: str      # repo-relative, forward slashes
    line: int
    message: str
    code: str = ""  # stripped source line, the baseline fingerprint

    def key(self) -> tuple[str, str, str]:
        """Line-number-independent identity used for baselining: a
        finding survives unrelated edits above it."""
        return (self.rule, self.path, self.code)

    def render(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


@dataclass
class RunResult:
    findings: list[Finding] = field(default_factory=list)
    suppressed: list[Finding] = field(default_factory=list)
    baselined: list[Finding] = field(default_factory=list)
    stats: dict = field(default_factory=dict)
    parse_counts: dict = field(default_factory=dict)  # rel -> n parses
    files_scanned: int = 0

    def by_rule(self, name: str) -> list[Finding]:
        return [f for f in self.findings if f.rule == name]


class FileContext:
    """Per-file state shared by every rule during the walk."""

    def __init__(self, run: RunResult, path: str, rel: str, source: str,
                 tree: ast.AST | None):
        self.run = run
        self.path = path
        self.rel = rel
        self.source = source
        self.lines = source.splitlines()
        self.tree = tree
        self.func_stack: list[ast.AST] = []   # FunctionDef/AsyncFunctionDef
        self.class_stack: list[ast.ClassDef] = []
        self.suppressions = self._parse_suppressions()
        self._parents: dict[int, ast.AST] = {}

    def _parse_suppressions(self) -> dict[int, set[str]]:
        out: dict[int, set[str]] = {}
        for i, line in enumerate(self.lines, 1):
            m = _SUPPRESS_RE.search(line)
            if m:
                out[i] = {r.strip() for r in m.group(1).split(",")
                          if r.strip()}
        return out

    # -- walk bookkeeping (engine-maintained) ---------------------------
    def set_parent(self, child: ast.AST, parent: ast.AST) -> None:
        self._parents[id(child)] = parent

    def parent(self, node: ast.AST) -> ast.AST | None:
        return self._parents.get(id(node))

    @property
    def func(self) -> ast.AST | None:
        """Innermost enclosing function at the visit point."""
        return self.func_stack[-1] if self.func_stack else None

    def in_async(self) -> bool:
        """True when the innermost enclosing function is ``async def``
        (a nested sync def shields its body: it runs off-loop)."""
        return isinstance(self.func, ast.AsyncFunctionDef)

    def code_line(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1].strip()
        return ""

    def in_pkg(self) -> str | None:
        """Path inside seaweedfs_tpu_torch/ ('server/x.py'), else
        None."""
        if self.rel.startswith(PKG_PREFIX):
            return self.rel[len(PKG_PREFIX):]
        return None


class Rule:
    """Base class for AST rules. Subclasses register with @register,
    declare ``name``/``description``, scope themselves via ``wants``,
    and implement ``visit_<NodeType>(ctx, node)`` methods; the engine
    calls them during its one walk of each file. ``begin_file``/
    ``end_file``/``finish`` hook per-file and cross-file phases."""

    name = ""
    description = ""
    is_text = False

    def wants(self, rel: str) -> bool:
        return rel.startswith(PKG_PREFIX) and rel.endswith(".py")

    def begin_file(self, ctx: FileContext) -> None:
        pass

    def end_file(self, ctx: FileContext) -> None:
        pass

    def finish(self, engine: "Engine") -> None:
        """Cross-file phase, after every file has been walked."""

    def report(self, ctx: FileContext, node, message: str,
               line: int | None = None) -> None:
        lineno = line if line is not None else getattr(node, "lineno", 0)
        f = Finding(self.name, ctx.rel, lineno, message,
                    ctx.code_line(lineno))
        sup = ctx.suppressions.get(lineno, ())
        if self.name in sup or "all" in sup:
            ctx.run.suppressed.append(f)
        else:
            ctx.run.findings.append(f)


class TextRule(Rule):
    """Raw-text rule (non-Python sources: dataplane.cc). Gets the
    whole source once via ``check_text``; suppressions still apply."""

    is_text = True

    def wants(self, rel: str) -> bool:
        return False

    def check_text(self, ctx: FileContext) -> None:
        raise NotImplementedError


REGISTRY: dict[str, type] = {}


def register(cls):
    assert cls.name and cls.name not in REGISTRY, cls
    REGISTRY[cls.name] = cls
    return cls


def all_rules() -> dict[str, type]:
    from . import rules as _rules  # noqa: F401  (imports register)
    return dict(REGISTRY)


def default_roots() -> list[str]:
    return [os.path.join(REPO_ROOT, "seaweedfs_tpu_torch"),
            os.path.join(REPO_ROOT, "tests")]


def _iter_files(roots: list[str]):
    for root in roots:
        if os.path.isfile(root):
            yield root
            continue
        for base, dirs, files in os.walk(root):
            dirs[:] = sorted(d for d in dirs
                             if d not in ("__pycache__", ".git", "_build"))
            for fn in sorted(files):
                if fn.endswith((".py", ".cc", ".h")):
                    yield os.path.join(base, fn)


def load_baseline(path: str = BASELINE_PATH) -> list[dict]:
    if not os.path.exists(path):
        return []
    with open(path, encoding="utf-8") as f:
        data = json.load(f)
    return list(data.get("findings", []))


def save_baseline(findings: list[Finding],
                  path: str = BASELINE_PATH) -> None:
    rows = [{"rule": f.rule, "path": f.path, "code": f.code}
            for f in sorted(findings,
                            key=lambda f: (f.path, f.rule, f.line))]
    with open(path, "w", encoding="utf-8") as f:
        json.dump({"version": 1, "findings": rows}, f, indent=1)
        f.write("\n")


class Engine:
    def __init__(self, roots: list[str] | None = None,
                 rule_names: list[str] | None = None,
                 baseline_path: str | None = BASELINE_PATH,
                 repo_root: str | None = None):
        classes = all_rules()
        if rule_names is not None:
            unknown = set(rule_names) - set(classes)
            if unknown:
                raise ValueError(f"unknown rules: {sorted(unknown)}")
            classes = {n: c for n, c in classes.items()
                       if n in rule_names}
        self.rules = [cls() for _n, cls in sorted(classes.items())]
        self.roots = roots or default_roots()
        self.baseline_path = baseline_path
        self.repo_root = repo_root or REPO_ROOT
        self.run = RunResult()
        # node-type dispatch table, built once per engine
        self._dispatch: dict[str, list] = {}
        for rule in self.rules:
            for attr in dir(rule):
                if attr.startswith("visit_"):
                    self._dispatch.setdefault(attr[6:], []).append(
                        (rule, getattr(rule, attr)))

    # -- the single pass ------------------------------------------------
    def execute(self) -> RunResult:
        run = self.run
        for path in _iter_files(self.roots):
            rel = os.path.relpath(path, self.repo_root).replace(
                os.sep, "/")
            ast_rules = [r for r in self.rules
                         if not r.is_text and r.wants(rel)]
            text_rules = [r for r in self.rules
                          if r.is_text and r.wants(rel)]
            if not ast_rules and not text_rules:
                continue
            with open(path, encoding="utf-8") as f:
                source = f.read()
            tree = None
            if ast_rules:
                run.parse_counts[rel] = run.parse_counts.get(rel, 0) + 1
                try:
                    tree = ast.parse(source, filename=path)
                except SyntaxError as e:
                    run.findings.append(Finding(
                        "parse-error", rel, e.lineno or 0, str(e.msg)))
                    ast_rules = []
            ctx = FileContext(run, path, rel, source, tree)
            run.files_scanned += 1
            for rule in ast_rules + text_rules:
                rule.begin_file(ctx)
            for rule in text_rules:
                rule.check_text(ctx)
            if tree is not None and ast_rules:
                wanted = set(map(id, ast_rules))
                dispatch = {
                    name: [(r, m) for r, m in pairs if id(r) in wanted]
                    for name, pairs in self._dispatch.items()}
                self._walk(ctx, tree, dispatch)
            for rule in ast_rules + text_rules:
                rule.end_file(ctx)
        for rule in self.rules:
            rule.finish(self)
        self._apply_baseline(run)
        return run

    def _walk(self, ctx: FileContext, node: ast.AST,
              dispatch: dict[str, list]) -> None:
        name = type(node).__name__
        for _rule, method in dispatch.get(name, ()):
            method(ctx, node)
        is_func = isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
        is_class = isinstance(node, ast.ClassDef)
        if is_func:
            ctx.func_stack.append(node)
        if is_class:
            ctx.class_stack.append(node)
        for child in ast.iter_child_nodes(node):
            ctx.set_parent(child, node)
            self._walk(ctx, child, dispatch)
        if is_func:
            ctx.func_stack.pop()
        if is_class:
            ctx.class_stack.pop()

    def _apply_baseline(self, run: RunResult) -> None:
        if not self.baseline_path:
            return
        budget: dict[tuple, int] = {}
        for row in load_baseline(self.baseline_path):
            k = (row.get("rule", ""), row.get("path", ""),
                 row.get("code", ""))
            budget[k] = budget.get(k, 0) + 1
        if not budget:
            return
        kept: list[Finding] = []
        for f in run.findings:
            k = f.key()
            if budget.get(k, 0) > 0:
                budget[k] -= 1
                run.baselined.append(f)
            else:
                kept.append(f)
        run.findings = kept


_cache: dict[tuple, RunResult] = {}


def run_cached(roots: tuple[str, ...] | None = None) -> RunResult:
    """One shared engine pass per interpreter: every lint test reads the
    same RunResult, so ``pytest -m lint`` parses the package once."""
    key = roots or ()
    if key not in _cache:
        _cache[key] = Engine(list(roots) if roots else None).execute()
    return _cache[key]
