"""CLI: ``python -m seaweedfs_tpu_torch.analysis [roots...]``.

Exit code 1 when any unsuppressed, non-baselined finding remains —
the lint gate of ``pytest -m lint`` and of chip_smoke.py phase 23.
"""
from __future__ import annotations

import argparse
import json
import sys

from .engine import (BASELINE_PATH, Engine, all_rules, default_roots,
                     save_baseline)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m seaweedfs_tpu_torch.analysis",
        description="single-pass static analysis over the repo")
    ap.add_argument("roots", nargs="*",
                    help="files/dirs to scan (default: "
                         "seaweedfs_tpu_torch/ and tests/)")
    ap.add_argument("--json", action="store_true",
                    help="emit findings as a JSON document")
    ap.add_argument("--rules", default=None,
                    help="comma-separated rule subset")
    ap.add_argument("--list-rules", action="store_true",
                    help="print registered rules and exit")
    ap.add_argument("--baseline", default=BASELINE_PATH,
                    help="baseline file (default: checked-in)")
    ap.add_argument("--no-baseline", action="store_true",
                    help="ignore the baseline entirely")
    ap.add_argument("--write-baseline", action="store_true",
                    help="accept current findings into the baseline")
    ap.add_argument("--stats", action="store_true",
                    help="print engine stats after findings")
    args = ap.parse_args(argv)

    if args.list_rules:
        for name, cls in sorted(all_rules().items()):
            print(f"{name:22s} {cls.description}")
        return 0

    rule_names = ([r.strip() for r in args.rules.split(",") if r.strip()]
                  if args.rules else None)
    baseline = None if (args.no_baseline or args.write_baseline) \
        else args.baseline
    eng = Engine(roots=args.roots or default_roots(),
                 rule_names=rule_names, baseline_path=baseline)
    run = eng.execute()

    if args.write_baseline:
        save_baseline(run.findings, args.baseline)
        print(f"wrote {len(run.findings)} finding(s) to {args.baseline}")
        return 0

    if args.json:
        doc = {
            "findings": [{"rule": f.rule, "path": f.path, "line": f.line,
                          "message": f.message, "code": f.code}
                         for f in run.findings],
            "suppressed": len(run.suppressed),
            "baselined": len(run.baselined),
            "files_scanned": run.files_scanned,
            "stats": run.stats,
        }
        json.dump(doc, sys.stdout, indent=1)
        print()
    else:
        for f in sorted(run.findings,
                        key=lambda f: (f.path, f.line, f.rule)):
            print(f.render())
        print(f"{len(run.findings)} finding(s), "
              f"{len(run.suppressed)} suppressed, "
              f"{len(run.baselined)} baselined, "
              f"{run.files_scanned} files scanned")
        if args.stats:
            for k, v in sorted(run.stats.items()):
                print(f"  {k}: {v}")
    return 1 if run.findings else 0


if __name__ == "__main__":
    sys.exit(main())
