"""repro-lint over the port: run the static-analysis pass over
src/repro_torch.

Usage:
    PYTHONPATH=src python -m repro_torch.analysis [--json OUT] \
        [--baseline analysis_baseline_torch.json] [--src src] \
        [--write-baseline]

Exit codes: 0 clean (or every finding baselined), 1 new findings or a
malformed baseline, 2 usage/internal error. ``--json`` writes the full
machine-readable report (findings, baseline status, per-rule counts).
"""
from __future__ import annotations

import argparse
import json
import sys
from collections import Counter
from pathlib import Path

from repro_torch.analysis import load_project, run_checkers
from repro_torch.analysis.core import (apply_baseline, load_baseline,
                                       write_baseline)

REPO = Path(__file__).resolve().parents[3]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--src", default=str(REPO / "src"),
                    help="source root holding the repro_torch package")
    ap.add_argument("--baseline",
                    default=str(REPO / "analysis_baseline_torch.json"),
                    help="committed baseline of grandfathered findings")
    ap.add_argument("--json", dest="json_out", default=None,
                    help="write the machine-readable report here")
    ap.add_argument("--write-baseline", action="store_true",
                    help="regenerate the baseline from current findings "
                         "(entries still need hand-written "
                         "justifications)")
    args = ap.parse_args(argv)

    project = load_project(Path(args.src))
    findings = run_checkers(project)

    if args.write_baseline:
        write_baseline(Path(args.baseline), findings,
                       justification="TODO: justify or fix")
        print(f"wrote {len(findings)} finding(s) to {args.baseline}; "
              f"every entry needs a real justification before it lands")
        return 0

    try:
        baseline = load_baseline(Path(args.baseline))
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    new, stale = apply_baseline(findings, baseline)

    if args.json_out:
        doc = {
            "findings": [f.to_dict() for f in findings],
            "new": [f.to_dict() for f in new],
            "stale_baseline": stale,
            "by_rule": dict(Counter(f.rule for f in findings)),
            "modules_analyzed": len(project.modules),
            "baseline_entries": len(baseline),
        }
        Path(args.json_out).write_text(json.dumps(doc, indent=2) + "\n")

    for f in new:
        print(f.render())
    for e in stale:
        print(f"warning: stale baseline entry {e.get('fingerprint')} "
              f"({e.get('rule')} {e.get('path')}): no longer fires — "
              f"remove it", file=sys.stderr)
    n_grandfathered = len(findings) - len(new)
    print(f"repro-lint: {len(project.modules)} modules, "
          f"{len(findings)} finding(s) "
          f"({len(new)} new, {n_grandfathered} baselined, "
          f"{len(stale)} stale baseline entr"
          f"{'y' if len(stale) == 1 else 'ies'})")
    return 1 if new else 0


if __name__ == "__main__":
    sys.exit(main())
