"""``python -m repro_torch.analysis`` — the port's contract checker CLI.

Exit status: 0 when every finding is waived or baselined, 1 otherwise
(``--strict`` is the CI spelling of the same gate and additionally fails
when the baseline file itself has gone stale — entries that no longer
match any finding must be deleted, keeping the baseline a ratchet).
"""
from __future__ import annotations

import argparse
import json
import sys

from . import DEFAULT_BASELINE, RULES, Baseline, run_all


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="the port's contract checker: the engine's step "
                    "contracts (DESIGN.md §13)")
    ap.add_argument("--strict", action="store_true",
                    help="fail on new findings AND on stale baseline "
                         "entries (the CI gate)")
    ap.add_argument("--level", type=int, choices=(1, 2), default=None,
                    help="run only the runtime (1) or AST (2) rules; default "
                         "both")
    ap.add_argument("--baseline", default=DEFAULT_BASELINE,
                    help="accepted-findings file (default: "
                         "src/repro_torch/analysis/baseline.json)")
    ap.add_argument("--syncmap", metavar="PATH",
                    help="write the full host-sync inventory (waived "
                         "included) as JSON, e.g. BENCH_syncmap.json")
    ap.add_argument("--json", action="store_true",
                    help="emit findings as JSON instead of text")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule catalog and exit")
    ap.add_argument("--device", default="cuda",
                    help="where level 1 runs (default: the CUDA card; it "
                         "raises without one unless 'cpu' is given)")
    args = ap.parse_args(argv)

    if args.list_rules:
        for rule, desc in RULES.items():
            print(f"{rule:20s} {desc}")
        return 0

    findings, inventory = run_all(level=args.level, device=args.device)
    baseline = Baseline.load(args.baseline)
    new, accepted = baseline.split(findings)
    stale = [e for e in baseline.entries
             if (e["rule"], e["file"], e.get("context", ""))
             not in {f.key for f in findings}]

    if args.syncmap:
        with open(args.syncmap, "w") as f:
            json.dump({"inventory": inventory,
                       "total": len(inventory),
                       "waived": sum(1 for e in inventory if e["waived"])},
                      f, indent=2)
            f.write("\n")
        print(f"syncmap: {len(inventory)} sync sites -> {args.syncmap}")

    if args.json:
        print(json.dumps({"new": [f.to_dict() for f in new],
                          "accepted": [f.to_dict() for f in accepted],
                          "stale_baseline": stale}, indent=2))
    else:
        for f in new:
            print(f.format())
        n_waived = sum(1 for f in accepted if f.waived)
        print(f"repro-lint: {len(new)} new finding(s), "
              f"{len(accepted)} accepted ({n_waived} waived, "
              f"{len(accepted) - n_waived} baselined), "
              f"{len(stale)} stale baseline entr(y/ies)")
        if stale and args.strict:
            for e in stale:
                print(f"  stale baseline entry: {e['rule']} @ {e['file']} "
                      f"({e.get('context', '')!r}) — delete it")

    if new:
        return 1
    if args.strict and stale:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
