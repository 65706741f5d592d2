"""The port's analyzer (seaweedfs_tpu_torch/analysis/) against the
reference's (seaweedfs_tpu/analysis/).

* The reference's rule and engine cases (tests/test_analysis_rules.py,
  tests/test_analysis_engine.py) run with `Engine` bound to a twin that
  writes each mini repo twice — the reference's fixture under
  `seaweedfs_tpu/<sub>`, the same files under `seaweedfs_tpu_torch/<sub>`
  — runs both engines, and asserts the same findings (rule, sub-path,
  line), suppressions and baselined findings. The cases that name a
  construct the port replaced (aiohttp's `web.Application`, `jax.jit`,
  `block_until_ready`) run once, on the reference, and port-idiom
  fixtures stand for them: `rpc.http.App`, `torch.compile`, the torch
  sync primitives, `urlopen` and `http.client`.
* The reference's lint wrappers (tests/test_lint_*.py) run over the
  port's tree with the port's shared pass; the two that count `async
  def` bodies have port twins (the port serves on threads and has
  none).
* The zero-findings gate: `python -m seaweedfs_tpu_torch.analysis`, in
  text and in `--json`, exits 0 with no finding over the port and
  tests/, with an empty baseline; every suppression is listed here.
"""
import ast
import json
import os
import shutil
import subprocess
import sys

import pytest

from seaweedfs_tpu.analysis import engine as ref_engine
from seaweedfs_tpu_torch import analysis as port_analysis
from seaweedfs_tpu_torch.analysis import engine as port_engine
from seaweedfs_tpu_torch.analysis.rules import label_cardinality
from tests import (test_analysis_engine, test_analysis_rules,
                   test_lint_async_sleep, test_lint_cli_flags,
                   test_lint_device_sync, test_lint_label_cardinality,
                   test_lint_metrics_names, test_lint_timeouts)
from tests.torch_port_cases import port_cases, run_case

pytestmark = pytest.mark.lint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_DIR = os.path.join(REPO, "seaweedfs_tpu_torch")
REF, PORT = "seaweedfs_tpu/", "seaweedfs_tpu_torch/"
RULES = ("async-hygiene", "cli-flag-help", "context-propagation",
         "device-sync", "dp-faults", "label-cardinality",
         "lock-discipline", "metric-names", "raw-requests",
         "resource-safety", "session-timeout", "torch-hygiene")
# every `# sw-lint: disable=` in the port, with its reason: the grow
# lock is held across the assign POST as the reference holds its own
# (server/master_server.py:440-475)
SUPPRESSED = [("lock-discipline",
               "seaweedfs_tpu_torch/server/master_server.py")]


# -- the twin engine --------------------------------------------------------

def _to_port(rel: str) -> str:
    return PORT + rel[len(REF):] if rel.startswith(REF) else rel


def _key(f, prefix: str) -> tuple:
    path = f.path[len(prefix):] if f.path.startswith(prefix) else f.path
    return (f.rule, path, f.line)


def _mirror(root: str) -> str:
    """Copy the reference's mini repo to `<root>_port`, its package
    renamed and its baseline's paths with it."""
    twin = root.rstrip("/") + "_port"
    shutil.rmtree(twin, ignore_errors=True)
    for base, _dirs, files in os.walk(root):
        for fn in files:
            src = os.path.join(base, fn)
            rel = os.path.relpath(src, root).replace(os.sep, "/")
            dst = os.path.join(twin, _to_port(rel))
            os.makedirs(os.path.dirname(dst), exist_ok=True)
            if fn == "baseline.json" and rel == fn:
                with open(src) as f:
                    doc = json.load(f)
                for row in doc.get("findings", []):
                    row["path"] = _to_port(row["path"])
                with open(dst, "w") as f:
                    json.dump(doc, f)
            else:
                shutil.copyfile(src, dst)
    return twin


class TwinEngine:
    """Engine(...) of the reference's cases: the reference's engine on
    the mini repo, the port's on its mirror, compared finding for
    finding; returns the reference's RunResult for the case to check."""

    def __init__(self, roots=None, rule_names=None,
                 baseline_path=ref_engine.BASELINE_PATH, repo_root=None):
        self.ref = ref_engine.Engine(roots, rule_names, baseline_path,
                                     repo_root)
        port_engine.Engine(None, rule_names, None, None)  # rule names
        self.args = (roots, rule_names, baseline_path, repo_root)

    def execute(self):
        roots, rule_names, baseline, root = self.args
        assert roots == [root], "a twin run scans one mini repo"
        twin = _mirror(root)
        if baseline is not None:
            rel = os.path.relpath(baseline, root)
            baseline = os.path.join(twin, rel) \
                if not rel.startswith("..") else None
        run = self.ref.execute()
        port = port_engine.Engine([twin], rule_names, baseline,
                                  twin).execute()
        for attr in ("findings", "suppressed", "baselined"):
            assert sorted(_key(f, PORT) for f in getattr(port, attr)) == \
                sorted(_key(f, REF) for f in getattr(run, attr)), attr
        assert port.files_scanned == run.files_scanned
        assert set(port.parse_counts.values()) <= {1}
        return run


# the cases whose fixtures name what the port replaced, and the ones
# that shell out to the reference's module or its tree
REF_ONLY = ("test_bare_web_application_fires",
            "test_sync_in_jitted_function_fires",
            "test_feed_sync_outside_drain_site_fires",
            "test_sync_in_non_feed_module_not_flagged")
ENGINE_SUBPROCESS = ("test_cli_text_and_json_zero_findings_over_repo",
                     "test_cli_list_rules")
RULE_CASES = port_cases(test_analysis_rules, skip=REF_ONLY,
                        Engine=TwinEngine)
ENGINE_CASES = port_cases(test_analysis_engine, skip=ENGINE_SUBPROCESS,
                          Engine=TwinEngine,
                          run_cached=port_analysis.run_cached)
LINT_MODULES = (test_lint_async_sleep, test_lint_cli_flags,
                test_lint_device_sync, test_lint_label_cardinality,
                test_lint_metrics_names, test_lint_timeouts)
ASYNC_COUNTING = ("test_no_blocking_sleep_on_the_event_loop",
                  "test_async_delays_exist_and_are_loop_friendly")
LINT_CASES = {}
for _mod in LINT_MODULES:
    LINT_CASES.update(port_cases(_mod, skip=ASYNC_COUNTING,
                                 run_cached=port_analysis.run_cached,
                                 PKG_DIR=PORT_DIR))


def test_every_reference_case_is_accounted_for():
    assert len(RULE_CASES) + len(REF_ONLY) == 21
    assert len(ENGINE_CASES) + len(ENGINE_SUBPROCESS) == 9
    assert len(LINT_CASES) + len(ASYNC_COUNTING) == 13


@pytest.mark.parametrize("case", sorted(RULE_CASES))
def test_reference_rule_cases_on_both_engines(case, tmp_path):
    run_case(RULE_CASES[case], {"tmp_path": tmp_path})


@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_reference_engine_cases_on_both_engines(case, tmp_path,
                                                monkeypatch):
    run_case(ENGINE_CASES[case], {"tmp_path": tmp_path,
                                  "monkeypatch": monkeypatch})


@pytest.mark.parametrize("case", sorted(LINT_CASES))
def test_reference_lint_cases_on_the_port(case):
    run_case(LINT_CASES[case], {})


def test_the_twin_sees_a_disagreement(tmp_path):
    """A rule that fires in one engine only fails the twin run."""
    src = "def kick(pool, fn):\n    pool.submit(fn)\n"
    (tmp_path / "seaweedfs_tpu/filer").mkdir(parents=True)
    (tmp_path / "seaweedfs_tpu/filer/a.py").write_text(src)
    eng = TwinEngine(roots=[str(tmp_path)], baseline_path=None,
                     repo_root=str(tmp_path))
    real = port_engine.Engine.execute

    def lose_one(self):
        run = real(self)
        run.findings = run.findings[1:]
        return run

    mp = pytest.MonkeyPatch()
    mp.setattr(port_engine.Engine, "execute", lose_one)
    try:
        with pytest.raises(AssertionError, match="findings"):
            eng.execute()
    finally:
        mp.undo()


# -- port-idiom fixtures ----------------------------------------------------

def _run(tmp_path, files: dict, rules=None):
    for rel, src in files.items():
        p = tmp_path / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(src)
    return port_engine.Engine(roots=[str(tmp_path)], rule_names=rules,
                              baseline_path=None,
                              repo_root=str(tmp_path)).execute()


def _lines(run, rule):
    return [f.line for f in run.by_rule(rule)]


def test_raw_http_clients_fire_outside_the_session(tmp_path):
    src = ("import http.client\n"
           "import urllib.request\n"
           "from ..rpc.httpclient import session\n"
           "def bad(url):\n"
           "    urllib.request.urlopen(url, timeout=5)\n"
           "    c = http.client.HTTPConnection('h', 80, timeout=5)\n"
           "    o = urllib.request.build_opener()\n"
           "    return c, o\n"
           "def good(url):\n"
           "    return session().get(url, timeout=5)\n")
    run = _run(tmp_path, {PORT + "filer/a.py": src,
                          PORT + "rpc/httpclient.py": src,
                          PORT + "utils/metrics.py": src},
               rules=["raw-requests", "session-timeout"])
    assert [(f.path, f.line) for f in run.findings] == [
        (PORT + "filer/a.py", 5), (PORT + "filer/a.py", 6),
        (PORT + "filer/a.py", 7)]


def test_async_def_blocking_port_calls_fire(tmp_path):
    run = _run(tmp_path, {PORT + "server/a.py": (
        "import socket, urllib.request\n"
        "async def handle_get(req, sock):\n"
        "    urllib.request.urlopen('http://x', timeout=5)\n"
        "    sock.connect(('h', 1))\n"
        "    socket.create_connection(('h', 1), timeout=2)\n"
        "    def worker():\n"
        "        sock.connect(('h', 1))\n"
        "    return worker\n"
        "def handle_sync(sock):\n"
        "    sock.connect(('h', 1))\n"
    )}, rules=["async-hygiene"])
    assert _lines(run, "async-hygiene") == [3, 4, 5]
    assert "event loop" in run.findings[0].message


def test_blocking_under_a_lock_speaks_of_threads(tmp_path):
    run = _run(tmp_path, {PORT + "server/a.py": (
        "import subprocess, urllib.request\n"
        "from ..rpc.httpclient import session\n"
        "class S:\n"
        "    def bad(self, sock):\n"
        "        with self._lock:\n"
        "            session().post('http://x', timeout=5)\n"
        "            urllib.request.urlopen('http://x', timeout=5)\n"
        "            sock.connect(('h', 1))\n"
        "            subprocess.run(['true'])\n"
        "    def good(self, sock):\n"
        "        with self._lock:\n"
        "            url = self.url\n"
        "        session().post(url, timeout=5)\n"
    )}, rules=["lock-discipline"])
    assert _lines(run, "lock-discipline") == [6, 7, 8, 9]
    for f in run.findings:
        assert "lock is held" in f.message
        assert "event loop" not in f.message


def test_app_without_the_deadline_middleware_fires(tmp_path):
    run = _run(tmp_path, {PORT + "server/a.py": (
        "from ..rpc.http import App, server_middlewares\n"
        "from ..rpc import http\n"
        "from ..utils import retry, tracing\n"
        "def bad():\n"
        "    return App(middlewares=[tracing.middleware('x')])\n"
        "def bad_empty():\n"
        "    return http.App(middlewares=[])\n"
        "def good_default():\n"
        "    return App(max_body=1)\n"
        "def good_none():\n"
        "    return App(middlewares=None)\n"
        "def good_server():\n"
        "    return App(middlewares=server_middlewares('x'))\n"
        "def good_retry():\n"
        "    return http.App(middlewares=[tracing.middleware('x'),\n"
        "                                 retry.middleware('x', edge=True)])\n"
    )}, rules=["context-propagation"])
    assert _lines(run, "context-propagation") == [5, 7]


def test_device_sync_fires_on_torch_primitives(tmp_path):
    src = ("import torch\n"
           "def handle(t, s, ev):\n"
           "    torch.cuda.synchronize()\n"
           "    s.synchronize()\n"
           "    ev.synchronize()\n"
           "    n = t.item()\n"
           "    h = t.cpu()\n"
           "    rows = t.tolist()\n"
           "    a = t.cuda()\n"
           "    b = t.to('cuda')\n"
           "    c = torch.empty(3, device='cuda')\n"
           "    ok = (t.cuda(0), t.to('cuda:1'), torch.empty(\n"
           "        3, device='cuda:0'), t.to('cpu', copy=True))\n"
           "    return n, h, rows, a, b, c, ok\n")
    run = _run(tmp_path, {PORT + "server/a.py": src,
                          PORT + "ops/a.py": src},
               rules=["device-sync"])
    assert [(f.path, f.line) for f in run.findings] == [
        (PORT + "server/a.py", i) for i in range(3, 12)]
    assert "torch.cuda.synchronize()" in run.findings[0].message
    assert "current" in run.findings[-1].message


def test_torch_hygiene_in_compiled_functions(tmp_path):
    run = _run(tmp_path, {PORT + "ops/extra.py": (
        "import numpy as np\n"
        "import torch\n"
        "@torch.compile\n"
        "def bad(x):\n"
        "    return x.sum().item()\n"
        "@torch.jit.script\n"
        "def bad2(x):\n"
        "    return np.asarray(x)\n"
        "@torch.compile(mode='max-autotune')\n"
        "def bad3(x):\n"
        "    return x.numpy()\n"
        "@torch.compile\n"
        "def good(x):\n"
        "    return x + 1\n"
        "def plain(x):\n"
        "    return x.item()\n"
    )}, rules=["torch-hygiene"])
    assert _lines(run, "torch-hygiene") == [5, 8, 11]


def test_torch_feed_sync_outside_drain_site_fires(tmp_path):
    run = _run(tmp_path, {PORT + "ops/codec_torch.py": (
        "import torch\n"
        "def submit_path(dev, stream):\n"
        "    stream.synchronize()\n"
        "    h = dev.to('cpu')\n"
        "    return dev.cpu(), h\n"
        "def _readback(t):\n"
        "    return t.cpu().numpy()\n"
        "class Lane:\n"
        "    def wait(self, ev):\n"
        "        ev.synchronize()\n"
        "    def upload(self, ev):\n"
        "        ev.synchronize()\n"
    ), PORT + "ops/other.py": (
        "def anywhere(dev):\n"
        "    torch.cuda.synchronize()\n"
    )}, rules=["torch-hygiene"])
    assert [(f.path, f.line) for f in run.findings] == [
        (PORT + "ops/codec_torch.py", 3), (PORT + "ops/codec_torch.py", 4),
        (PORT + "ops/codec_torch.py", 5)]
    assert run.stats["feed_sync_sites"] == 6


def test_kernel_label_is_allowlisted(tmp_path):
    assert "kernel" in label_cardinality.ALLOWED
    run = _run(tmp_path, {PORT + "server/a.py": (
        "from ..utils import metrics\n"
        "metrics.gauge_set('cuda_kernel_launches', 1,\n"
        "                  {'kernel': 'coded_matmul'})\n"
        "metrics.gauge_set('x', 1, {'path': '/a'})\n"
    )}, rules=["label-cardinality"])
    assert _lines(run, "label-cardinality") == [4]


def test_build_dir_is_not_scanned(tmp_path):
    bad = ("import time\n"
           "async def handle_x(req):\n"
           "    time.sleep(1)\n")
    run = _run(tmp_path, {PORT + "server/a.py": bad,
                          PORT + "_build/a.py": bad,
                          PORT + "server/_build/b.py": bad})
    assert [f.path for f in run.findings] == [PORT + "server/a.py"]
    assert run.files_scanned == 1


# -- the port's own tree ------------------------------------------------------

def test_port_async_hygiene_guards_a_tree_without_async_def():
    """The reference counts its async bodies (> 50); the port serves on
    threads and has none, so the rule's fixtures above are what prove it
    still fires, and the tree must stay clean of it."""
    run = port_analysis.run_cached()
    assert run.stats.get("async_functions", 0) == 0
    assert not run.by_rule("async-hygiene")
    # the edge modules the rule scopes are where the port's delays live,
    # on threads (a sleep, or a timed wait on a condition): the rule's
    # scope guards real code
    for rel in ("utils/faults.py", "utils/qos.py", "utils/ratelimit.py"):
        with open(os.path.join(PORT_DIR, rel), encoding="utf-8") as f:
            tree = ast.parse(f.read())
        assert not any(isinstance(n, ast.AsyncFunctionDef)
                       for n in ast.walk(tree)), rel
        assert any(isinstance(n, ast.Attribute)
                   and n.attr in ("sleep", "wait")
                   for n in ast.walk(tree)), rel


def test_port_tree_suppressions_are_the_listed_ones():
    run = port_analysis.run_cached()
    assert [(f.rule, f.path) for f in run.suppressed] == SUPPRESSED
    assert run.baselined == []
    with open(os.path.join(PORT_DIR, "analysis", "baseline.json")) as f:
        assert json.load(f) == {"version": 1, "findings": []}


def _analysis(*args):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run(
        [sys.executable, "-m", "seaweedfs_tpu_torch.analysis", *args],
        capture_output=True, text=True, timeout=300, env=env, cwd=REPO)


def test_cli_text_and_json_zero_findings_over_the_port():
    out = _analysis("--json")
    assert out.returncode == 0, out.stdout + out.stderr
    doc = json.loads(out.stdout)
    assert doc["findings"] == [] and doc["baselined"] == 0
    assert doc["suppressed"] == len(SUPPRESSED)
    assert doc["files_scanned"] > 150
    text = _analysis()
    assert text.returncode == 0, text.stdout + text.stderr
    assert "0 finding(s)" in text.stdout


def test_cli_lists_the_twelve_rules():
    out = _analysis("--list-rules")
    assert out.returncode == 0
    names = [line.split()[0] for line in out.stdout.splitlines()]
    assert tuple(names) == RULES


def test_cli_exits_1_on_a_finding(tmp_path, monkeypatch, capsys):
    from seaweedfs_tpu_torch.analysis import __main__ as cli

    (tmp_path / PORT / "server").mkdir(parents=True)
    (tmp_path / PORT / "server/a.py").write_text(
        "import time\nasync def handle_x(req):\n    time.sleep(1)\n")
    monkeypatch.setattr(port_engine, "REPO_ROOT", str(tmp_path))
    assert cli.main([str(tmp_path), "--no-baseline"]) == 1
    out = capsys.readouterr().out
    assert f"{PORT}server/a.py:3: [async-hygiene]" in out
    assert "1 finding(s)" in out
