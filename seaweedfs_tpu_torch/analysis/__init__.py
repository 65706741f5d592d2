"""Static analysis of this package; the counterpart of
seaweedfs_tpu/analysis/.

One parse per file, many rules per parse: the project's lints (timeouts
and raw HTTP clients, blocking calls in async bodies, CLI flag help,
metric names, label cardinality, device sync in serving code) and the
concurrency rules (lock discipline, context propagation, resource
safety, torch hygiene on the staged feed) plus the C++ text-contract
pass over native/dataplane.cc all run as registered visitors over one
shared AST walk. The rules read this package's idioms: threads and the
standard library's HTTP (`rpc.httpclient.session()`, `rpc.http.App`)
where the reference has asyncio and aiohttp, torch where it has JAX.

Surface:

  python -m seaweedfs_tpu_torch.analysis          # text, exit 1 on findings
  python -m seaweedfs_tpu_torch.analysis --json   # machine-readable
  # sw-lint: disable=<rule>[,<rule>...]           # per-line suppression
  seaweedfs_tpu_torch/analysis/baseline.json      # grandfathered findings

The lint tests (tests/test_torch_analysis.py, ``pytest -m lint``) call
:func:`run_cached`, so one engine pass serves every test of a session.
"""
from .engine import (  # noqa: F401
    Engine,
    Finding,
    RunResult,
    all_rules,
    default_roots,
    load_baseline,
    run_cached,
)
