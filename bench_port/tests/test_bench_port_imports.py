"""Nothing of the benchmark imports JAX, the JAX package or `bench.py`,
and the measuring process holds none of them. Module names are compared
by their whole top-level name: the port's `seaweedfs_tpu_torch` begins
with the JAX package's `seaweedfs_tpu` and is not it."""
import ast
import os
import subprocess
import sys

from bench_port import harness
from bench_port.spec import BENCH_DIR, ROOT

FORBIDDEN_SOURCE = set(harness.FORBIDDEN) | {"bench"}


def _imported_tops(path: str) -> set[str]:
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") in (
                "import_module", "__import__") and node.args and isinstance(
                    node.args[0], ast.Constant):
            tops.add(str(node.args[0].value).split(".")[0])
    return tops


def test_no_source_of_the_benchmark_imports_jax_or_the_jax_package():
    seen = set()
    for dirpath, _, files in os.walk(BENCH_DIR):
        for name in files:
            if name.endswith(".py"):
                tops = _imported_tops(os.path.join(dirpath, name))
                assert not tops & FORBIDDEN_SOURCE, (name, tops)
                seen |= tops
    assert "seaweedfs_tpu_torch" in seen and "torch" in seen


def test_forbidden_names_are_compared_whole():
    assert harness.forbidden_modules(
        ["seaweedfs_tpu_torch", "seaweedfs_tpu_torch.ec.encoder", "jaxtyping",
         "flaxen", "torch"]) == []
    assert harness.forbidden_modules(
        ["jax.numpy", "jaxlib", "flax.linen", "seaweedfs_tpu.ec",
         "seaweedfs_tpu_torch"]) == ["flax", "jax", "jaxlib", "seaweedfs_tpu"]


def test_the_measuring_process_loads_no_jax():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from bench_port import harness, drivers, devtrace\n"
            "from bench_port.reference import control, encode\n"
            "from seaweedfs_tpu_torch.ec import backend, encoder, geometry\n"
            "from seaweedfs_tpu_torch.ops import codec_cuda\n"
            "print(harness.forbidden_modules())\n" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         env=dict(os.environ, USE_FLAX="0"))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
