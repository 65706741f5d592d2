"""CPU tests of the benchmark: `python -m pytest bench_port/tests -q`.

Tests that need the card carry the `cuda` marker and skip themselves
elsewhere, deciding inside the test: on the machine with the card,
`python -m pytest bench_port/tests -q -m cuda` runs them.
"""
import os
import sys
import time

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# Sizes a test run holds: a volume with two large-block rows and a padded
# small-block row, 64 KiB chunks.
SMALL_CONFIG = {"volume_bytes": 1536 * 1024 + 777,
                "large_block_bytes": 65536, "small_block_bytes": 16384}
SMALL_TRAFFIC = {"chunk_bytes": 65536}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card; skips itself without one")


def small_spec(cell: str):
    from bench_port.spec import Spec

    spec = Spec(cell)
    spec.config = dict(spec.config, **SMALL_CONFIG)
    spec.traffic = dict(spec.traffic, **{k: v for k, v in SMALL_TRAFFIC.items()
                                         if k in spec.traffic})
    return spec


def run_small(cell: str, seed: int = 2**31 + 99, seconds: float = 0.3,
              control: bool = False):
    """One run of `cell` at the small sizes on the CPU -> result object."""
    from bench_port import harness

    result, _ = harness.run(cell, seed, seconds, False,
                            t_start=time.perf_counter(), device="cpu",
                            control=control, spec=small_spec(cell),
                            log=lambda line: None)
    return result


def _cells() -> tuple[str, ...]:
    import json

    from bench_port.spec import ROOT

    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return tuple(w["name"] for w in json.load(f)["workloads"])


CELLS = _cells()


@pytest.fixture
def small():
    return run_small
