"""Run one cell of the benchmark once.

    python3 bench_port/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the card(s) the cell asks
for. The last line of standard output is the result object; the last
lines of standard error name each number compared with its limit.
Exit codes: 0 a result was printed; 2 no card (or too few); 3 JAX or the
JAX package was loaded; 1 anything else. `--control 1` puts the control
(reference/control.py) in the program's place, to show that the
comparison fails it; the benchmark's own runs never pass it.

Every cache of the program and of PyTorch lives at a fixed path inside
the checkout (`.bench_port_cache/`); the program's own kernel build
directory (`seaweedfs_tpu_torch/_build/`) is inside it already.
"""
import faulthandler
import os
import sys
import time

T_START = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, ".bench_port_cache")


def _environment() -> None:
    os.makedirs(CACHE, exist_ok=True)
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(CACHE, "cuda")
    # the router's measured curve is never swept with backend "cuda"; a
    # path inside the checkout keeps a curve left in HOME from setting
    # the pipeline's depth
    os.environ["SEAWEEDFS_TPU_EC_PROBE_CACHE"] = os.path.join(
        CACHE, "ec_probe.json")
    os.environ["USE_FLAX"] = "0"


def main(argv=None) -> int:
    import argparse
    import json

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    _environment()
    # a run that hangs prints every thread's stack and ends, well inside
    # the time a run is allowed
    faulthandler.dump_traceback_later(args.seconds + 300, exit=True)
    sys.path.insert(0, ROOT)
    from bench_port import harness

    try:
        result, lines = harness.run(args.workload, args.seed, args.seconds,
                                    bool(args.trace), t_start=T_START,
                                    control=bool(args.control))
    except harness.NoDevice as e:
        print(f"bench_port: no result: {e}", file=sys.stderr)
        return 2
    except harness.ForbiddenImport as e:
        print(f"bench_port: no result: {e}", file=sys.stderr)
        return 3
    found = harness.forbidden_modules()
    if found:
        print(f"bench_port: no result: loaded in the measuring process: "
              f"{', '.join(found)}", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
