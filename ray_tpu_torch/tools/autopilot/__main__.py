"""CLI for the autopilot loop — one command per stage (the counterpart of
``python -m ray_tpu.tools.autopilot``).

    python -m ray_tpu_torch.tools.autopilot attribute [--snapshot FILE]
    python -m ray_tpu_torch.tools.autopilot plan [--budget N] [--format ...]
    python -m ray_tpu_torch.tools.autopilot verdict [--out-dir DIR]

``plan`` prints the bare grid JSON on stdout by default (rationales go
to stderr; ``--format full`` puts the whole graded plan on stdout
instead): the argument a sweep runner over ``python -m
ray_tpu_torch.bench`` will take (ROADMAP.md queue 1).  ``verdict`` exits 1 naming the regressed metrics,
so it gates a run the way pytest gates a merge.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, List, Optional

from ray_tpu_torch.tools.autopilot import attribution, planner, verdict


def _load_snapshot(path: str) -> Dict[str, Any]:
    """A canned snapshot file: either a bare ``{name: block}`` programs
    dict, or an ``engine_stats()`` / dashboard dump carrying
    ``programs`` (and optionally ``device`` and ``kv_scope``) keys."""
    with open(path) as f:
        obj = json.load(f)
    if isinstance(obj.get("programs"), dict):
        return {"programs": obj["programs"],
                "device": obj.get("device"),
                "kv_scope": obj.get("kv_scope")}
    return {"programs": obj, "device": None, "kv_scope": None}


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m ray_tpu_torch.tools.autopilot",
        description="closed-loop perf autopilot: attribute the "
                    "bottleneck, plan the next sweep, file the verdict")
    ap.add_argument("--history", default=None,
                    help="ledger path (default: <repo>/"
                         "BENCH_HISTORY_TORCH.jsonl, env "
                         "RAYTPU_BENCH_HISTORY overrides)")
    ap.add_argument("--baseline", default=None,
                    help="BASELINE.json path")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p_att = sub.add_parser(
        "attribute",
        help="classify programs compute- vs HBM-bound against the "
             "device ridge and name the bottleneck")
    p_att.add_argument("--snapshot", default=None,
                       help="canned programs JSON (engine_stats dump "
                            "or bare snapshot) instead of this "
                            "process's live registry")
    p_att.add_argument("--format", choices=("text", "json"),
                       default="text")

    p_plan = sub.add_parser(
        "plan",
        help="emit the next sweep grid from ledger coverage + "
             "attribution")
    p_plan.add_argument("--budget", type=int, default=8,
                        help="max variants in the grid (default 8)")
    p_plan.add_argument("--snapshot", default=None,
                        help="attribute this canned snapshot first and "
                             "bias the plan toward its bottleneck")
    p_plan.add_argument("--include-fresh", action="store_true",
                        help="keep candidates already measured at the "
                             "current SHA")
    p_plan.add_argument("--format", choices=("grid", "full", "text"),
                        default="grid",
                        help="grid: bare grid JSON on stdout "
                             "(rationales on stderr); full: whole "
                             "graded plan JSON; text: human table")

    p_ver = sub.add_parser(
        "verdict",
        help="file AUTOPILOT.md/.json; exit 1 naming regressed metrics")
    p_ver.add_argument("--tolerance", type=float,
                       default=None,
                       help="relative tolerance band (default 5%%)")
    p_ver.add_argument("--budget", type=int, default=8,
                       help="budget for the embedded next plan")
    p_ver.add_argument("--out-dir", default=None,
                       help="where to write AUTOPILOT.md/.json "
                            "(default: the ledger's directory)")
    p_ver.add_argument("--no-write", action="store_true",
                       help="print the verdict without filing reports")
    p_ver.add_argument("--format", choices=("text", "json"),
                       default="text")
    args = ap.parse_args(argv)

    if args.cmd == "attribute":
        if args.snapshot:
            snap = _load_snapshot(args.snapshot)
            report = attribution.attribute(snap["programs"],
                                           device=snap["device"],
                                           kv_scope=snap["kv_scope"])
        else:
            report = attribution.attribute_registry()
        if args.format == "json":
            print(json.dumps(report, indent=1, sort_keys=True))
        else:
            print(attribution.render_text(report))
        return 0

    if args.cmd == "plan":
        att = None
        if args.snapshot:
            snap = _load_snapshot(args.snapshot)
            att = attribution.attribute(snap["programs"],
                                        device=snap["device"],
                                        kv_scope=snap["kv_scope"])
        p = planner.plan(args.history, args.baseline,
                         budget=args.budget, attribution=att,
                         include_fresh=args.include_fresh)
        if args.format == "full":
            print(json.dumps(p, indent=1, sort_keys=True))
        elif args.format == "text":
            print(planner.render_text(p))
        else:
            print(json.dumps(p["grid"]))
            for g in p["variants"]:
                print(f"autopilot: [{g['status']}] {g['id']} "
                      f"#{g['hash']}: {g['rationale']}",
                      file=sys.stderr)
        if not p["grid"]:
            print("autopilot: plan is empty (all candidates fresh — "
                  "pass --include-fresh to re-run them)",
                  file=sys.stderr)
        return 0

    # verdict
    from ray_tpu_torch.tools import perfledger

    tol = (perfledger.DEFAULT_TOLERANCE if args.tolerance is None
           else args.tolerance)
    v = verdict.build_verdict(args.history, args.baseline,
                              tolerance=tol, budget=args.budget)
    if not args.no_write:
        paths = verdict.write_reports(v, args.out_dir, args.history)
        print(f"autopilot: wrote {paths['md']} and {paths['json']}",
              file=sys.stderr)
    if args.format == "json":
        print(json.dumps(v, indent=1, sort_keys=True))
    else:
        print(verdict.render_markdown(v))
    if v["regressed"]:
        print("autopilot: REGRESSED: " + ", ".join(v["regressed"]),
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
