"""Stage 3 of the autopilot loop: the verdict (the counterpart of
``ray_tpu/tools/autopilot/verdict.py``).

After a sweep or bench run lands in the ledger, this module turns
perfledger ``check`` output into a filed decision: which metric series
regressed / improved / stayed flat vs their previous point and vs the
published ``BASELINE.json`` table, which published baselines have no
live series at all (unmeasured debt), and — because a verdict without
a next step is just a complaint — the next plan, refreshed against the
same ledger.

Reports are written both machine-readable (``AUTOPILOT.json``) and
human-readable (``AUTOPILOT.md``), by default beside the port's ledger
(``BENCH_HISTORY_TORCH.jsonl``'s directory; both names are listed in
.gitignore); the CLI exits non-zero naming the regressed metrics so the
verdict can gate a run the way a test suite gates a merge.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional

from ray_tpu_torch.tools import perfledger
from ray_tpu_torch.tools.autopilot import planner

MD_NAME = "AUTOPILOT.md"
JSON_NAME = "AUTOPILOT.json"


def build_verdict(history: Optional[str] = None,
                  baseline: Optional[str] = None,
                  tolerance: float = perfledger.DEFAULT_TOLERANCE,
                  budget: int = 8,
                  attribution: Optional[Dict[str, Any]] = None
                  ) -> Dict[str, Any]:
    """One verdict block over the whole ledger + the refreshed plan."""
    chk = perfledger.check(history, baseline, tolerance)
    published = perfledger.load_baseline(baseline)
    by_class: Dict[str, List[str]] = {
        "regressed": [], "improved": [], "flat": [], "new": []}
    baseline_regressed: List[str] = []
    for name, v in sorted(chk["verdicts"].items()):
        key = {"regress": "regressed", "improve": "improved"}.get(
            v["verdict"], v["verdict"])
        by_class[key].append(name)
        if v.get("baseline_verdict") == "regress":
            baseline_regressed.append(name)
    unmeasured = sorted(n for n in published
                        if n not in chk["verdicts"])
    next_plan = planner.plan(history, baseline, budget=budget,
                             attribution=attribution)
    regressed = sorted(set(by_class["regressed"])
                       | set(baseline_regressed))
    return {"ok": chk["ok"], "tolerance": tolerance,
            "entries": chk["entries"],
            "git_sha": perfledger.provenance().get("git_sha"),
            "regressed": regressed,
            "baseline_regressed": baseline_regressed,
            "improved": by_class["improved"],
            "flat": by_class["flat"], "new": by_class["new"],
            "unmeasured_baseline": unmeasured,
            "verdicts": chk["verdicts"],
            "attribution": attribution,
            "plan": next_plan}


def render_markdown(v: Dict[str, Any]) -> str:
    """AUTOPILOT.md: the loop's filed state — verdict table, regressed
    metric callout, and the next plan as a copy-pasteable sweep."""
    status = "OK" if v["ok"] else "REGRESSED"
    lines = [
        "# Autopilot verdict",
        "",
        f"Tree `{v['git_sha'] or 'unknown'}` · {v['entries']} ledger "
        f"entries · tolerance ±{v['tolerance']:.0%} · **{status}**",
        "",
    ]
    if v["regressed"]:
        lines += ["## Regressed", ""]
        for name in v["regressed"]:
            d = v["verdicts"].get(name) or {}
            vs = (f" (vs baseline {d.get('baseline')})"
                  if name in v["baseline_regressed"] else "")
            delta = d.get("delta")
            lines.append(
                f"- `{name}`: {d.get('prev')} → {d.get('value')}"
                + (f" ({delta:+.1%})" if isinstance(delta, float)
                   else "") + vs)
        lines.append("")
    for title, key in (("Improved", "improved"), ("New series", "new")):
        if v[key]:
            lines += [f"## {title}", ""]
            lines += [f"- `{n}`" for n in v[key]]
            lines.append("")
    if v["unmeasured_baseline"]:
        lines += ["## Published baselines with no live series", ""]
        lines += [f"- `{n}`" for n in v["unmeasured_baseline"]]
        lines.append("")
    attribution = v.get("attribution")
    if attribution:
        lines += ["## Attribution", "",
                  attribution.get("summary") or "", ""]
    p = v["plan"]
    lines += ["## Next plan", ""]
    if p["variants"]:
        lines += ["| # | id | status | hash | rationale |",
                  "|---|---|---|---|---|"]
        for i, g in enumerate(p["variants"]):
            lines.append(f"| {i} | `{g['id']}` | {g['status']} "
                         f"| `{g['hash']}` | {g['rationale']} |")
        lines += ["",
                  "Grid (a sweep runner over `python -m ray_tpu_torch."
                  "bench` is ROADMAP.md queue 1 work):",
                  "",
                  "```json",
                  json.dumps(p["grid"]),
                  "```", ""]
    else:
        lines += ["Nothing to run — every catalog candidate is fresh "
                  "at this SHA.", ""]
    lines.append("---")
    lines.append("Generated by `python -m ray_tpu_torch.tools.autopilot "
                 "verdict`.")
    return "\n".join(lines) + "\n"


def write_reports(v: Dict[str, Any],
                  out_dir: Optional[str] = None,
                  history: Optional[str] = None) -> Dict[str, str]:
    """File AUTOPILOT.md + AUTOPILOT.json (by default in the directory
    of the ledger the verdict read: ``history``, or the port's default
    ledger); returns the written paths."""
    out_dir = out_dir or os.path.dirname(
        os.path.abspath(perfledger.history_path(history)))
    md_path = os.path.join(out_dir, MD_NAME)
    json_path = os.path.join(out_dir, JSON_NAME)
    with open(json_path, "w") as f:
        json.dump(v, f, indent=1, sort_keys=True)
        f.write("\n")
    with open(md_path, "w") as f:
        f.write(render_markdown(v))
    return {"md": md_path, "json": json_path}


__all__ = ["build_verdict", "render_markdown", "write_reports",
           "MD_NAME", "JSON_NAME"]
