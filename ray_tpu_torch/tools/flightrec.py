"""Postmortem CLI over flight-recorder dumps: a copy of
``ray_tpu/tools/flightrec.py``.

``python -m ray_tpu_torch.tools.flightrec <cmd> <dump.json>`` inspects
the postmortem files the SLO watchdog / engine crash handler / train
health watchdog write (``_private/flightrec.py`` ``dump()``; the dump
format is the JAX package's, so either package's dumps read here):

* ``report``    — human summary: trigger, event counts by kind, drop
  counter, step-duration percentiles, recent sheds/errors, the
  breaching objective's burn rates when the dump carries an SLO
  context, — on fleet dumps (serve/router.py) — the per-replica
  routing table plus the last scale-up/scale-down/drain decisions,
  and — on trainwatch dumps (train/goodput.py) — the train lanes:
  step wall percentiles, the anomaly table (step index + trigger
  metric), recent checkpoint events, and the watchdog's metric trail.
  Exits 0 on a readable dump — scripts gate on it.
* ``events``    — the journal itself, filtered (``--kind``,
  ``--last``, ``--since/--until`` seconds) and printed one JSON
  object per line for ``jq`` piping; the correlate workflow is
  ``--kind slo_breach`` to find the breach time, then
  ``--since/--until`` around it.
* ``trace``     — convert the journal into a chrome-trace
  instant-event lane (and ``--merge`` it into an existing
  ``export_timeline()`` JSON), so decisions
  land on the same Perfetto canvas as the engine spans.
* ``sweepjson`` — summarize the dump into the SWEEPJSON metric-record
  shape ``tools/perfledger.py ingest`` consumes, so postmortems can
  join the ledger's trend series.

Pure stdlib + the chrome-trace builders: it needs nothing but the
dump file, and no card.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, List, Optional

from ray_tpu_torch._private.telemetry import (instant_event,
                                              process_name_event,
                                              summarize,
                                              thread_name_event)

__all__ = ["load_dump", "filter_events", "report_lines",
           "trace_events", "sweepjson_records", "main"]


def load_dump(path: str) -> Dict[str, Any]:
    with open(path) as f:
        doc = json.load(f)
    if "events" not in doc:
        raise ValueError(f"{path} is not a flight-recorder dump "
                         "(no 'events' array)")
    return doc


def filter_events(events: List[Dict[str, Any]], *,
                  kinds: Optional[List[str]] = None,
                  since: Optional[float] = None,
                  until: Optional[float] = None,
                  last: Optional[int] = None,
                  request: Optional[str] = None
                  ) -> List[Dict[str, Any]]:
    """`request` follows ONE request through the journal: events whose
    ``req`` equals it (engine-local id) or whose ``trace`` matches it
    (tracebus id, full or prefix — serve/telemetry.py tags lifecycle
    and kv_* events with the trace in scope)."""
    out = events
    if kinds:
        want = set(kinds)
        out = [e for e in out if e.get("kind") in want]
    if request is not None:
        rid = str(request)
        out = [e for e in out
               if str(e.get("req")) == rid
               or (isinstance(e.get("trace"), str)
                   and e["trace"].startswith(rid))]
    if since is not None:
        out = [e for e in out if e.get("t_s", 0.0) >= since]
    if until is not None:
        out = [e for e in out if e.get("t_s", 0.0) <= until]
    if last is not None:
        out = out[-last:]
    return out


def report_lines(doc: Dict[str, Any]) -> List[str]:
    events = doc.get("events", [])
    lines = [
        f"flight record: {doc.get('source', '?')}"
        f"  reason={doc.get('reason') or '(manual)'}",
        f"created {doc.get('created', '?')}  uptime "
        f"{doc.get('uptime_s', '?')}s  events "
        f"{doc.get('events_retained', len(events))} retained / "
        f"{doc.get('events_recorded', '?')} recorded / "
        f"{doc.get('events_dropped', 0)} dropped",
    ]
    counts = doc.get("counts_by_kind") or {}
    if counts:
        lines.append("events by kind: " + ", ".join(
            f"{k}={v}" for k, v in sorted(counts.items())))
    steps = [e["dur_ms"] for e in events
             if e.get("kind") == "step" and "dur_ms" in e]
    if steps:
        s = summarize(steps)
        lines.append(f"step dur_ms: n={s['count']} mean={s['mean']} "
                     f"p50={s['p50']} p95={s['p95']} max={s['max']}")
    # train lanes (trainwatch dumps, train/goodput.py): step metric
    # trail percentiles plus the anomaly table the watchdog journaled
    tsteps = [e for e in events if e.get("kind") == "train_step"]
    if tsteps:
        walls = [e["wall_ms"] for e in tsteps if "wall_ms" in e]
        losses = [e["loss"] for e in tsteps
                  if isinstance(e.get("loss"), (int, float))]
        line = f"train steps: n={len(tsteps)}"
        if walls:
            s = summarize(walls)
            line += (f"  wall_ms p50={s['p50']} p95={s['p95']} "
                     f"max={s['max']}")
        if losses:
            line += f"  last_loss={losses[-1]}"
        lines.append(line)
    anomalies = [e for e in events if e.get("kind") == "train_anomaly"]
    if anomalies:
        lines.append("train anomalies (step  metric  value  reason):")
        for e in anomalies[-10:]:
            lines.append(f"  {e.get('step')}  {e.get('metric')}  "
                         f"{e.get('value')}  {e.get('reason')}")
    for label, kind in (("checkpoint saves", "ckpt_save"),
                        ("checkpoint restores", "ckpt_restore")):
        tail = filter_events(events, kinds=[kind], last=3)
        if tail:
            lines.append(f"last {label}:")
            for e in tail:
                lines.append("  " + json.dumps(e, sort_keys=True))
    ctx = doc.get("context") or {}
    if ctx.get("trainer"):
        lines.append(
            f"train anomaly: trainer={ctx['trainer']}  "
            f"step={ctx.get('step')}  reason={ctx.get('reason')}  "
            f"{ctx.get('metric')}={ctx.get('value')}")
        trail = ctx.get("trail") or []
        if trail:
            lines.append("metric trail (last "
                         f"{len(trail)} steps):")
            for t in trail[-8:]:
                lines.append("  " + json.dumps(t, sort_keys=True))
    slo = ctx.get("slo")
    if isinstance(slo, dict):
        objective = ctx.get("objective")
        lines.append(
            f"SLO breach: objective={objective or '?'}  "
            f"breaches={slo.get('breaches')}")
        for name, obj in (slo.get("objectives") or {}).items():
            mark = " <-- BREACHED" if obj.get("breached") else ""
            lines.append(
                f"  {name}: target {obj.get('target_ms')}ms  "
                f"attainment {obj.get('attainment')}  "
                f"burn_rate {obj.get('burn_rate')}"
                f" ({obj.get('violations')}/{obj.get('samples')} "
                f"over target){mark}")
    if ctx.get("program"):
        lines.append(f"recompile storm: program={ctx['program']}")
    if ctx.get("error"):
        lines.append(f"engine error: {ctx['error']}")
    # fleet routing table: aggregate the router's `route` events per
    # replica so a postmortem shows where traffic actually landed and
    # why (prefix affinity vs. load fallback vs. round-robin)
    routes = [e for e in events if e.get("kind") == "route"]
    if routes:
        table: Dict[str, Dict[str, Any]] = {}
        for e in routes:
            row = table.setdefault(str(e.get("replica", "?")), {
                "routed": 0, "prefix_affinity": 0, "p2c": 0,
                "round_robin": 0, "matched_blocks": 0,
                "tenants": set()})
            row["routed"] += 1
            policy = str(e.get("policy", "?"))
            if policy in row:
                row[policy] += 1
            row["matched_blocks"] += int(e.get("matched_blocks", 0))
            if e.get("tenant"):
                row["tenants"].add(str(e["tenant"]))
        lines.append("routing table (route events by replica):")
        lines.append("  replica  routed  prefix  p2c  rr  "
                     "matched_blocks  tenants")
        for name in sorted(table):
            row = table[name]
            tenants = ",".join(sorted(row["tenants"])) or "-"
            lines.append(
                f"  {name}  {row['routed']}  "
                f"{row['prefix_affinity']}  {row['p2c']}  "
                f"{row['round_robin']}  {row['matched_blocks']}  "
                f"{tenants}")
    # healthwatch lane (serve/health.py): the liveness state machine's
    # journaled transitions + stall events, aggregated per replica so
    # a postmortem reads "which replica got sick, when, and why"
    # alongside the routing table above
    trans = [e for e in events if e.get("kind") == "health_transition"]
    stalls = [e for e in events if e.get("kind") == "request_stall"]
    if trans or stalls:
        health: Dict[str, Dict[str, Any]] = {}
        for e in trans:
            row = health.setdefault(str(e.get("replica", "?")), {
                "transitions": 0, "suspect": 0, "dead": 0,
                "recovered": 0, "stalls": 0, "last": None,
                "detect_ms": None})
            row["transitions"] += 1
            to = str(e.get("to", "?"))
            if to == "suspect":
                row["suspect"] += 1
            elif to == "dead":
                row["dead"] += 1
            elif to == "healthy":
                row["recovered"] += 1
            row["last"] = (f"{e.get('from')}->{to} "
                           f"({e.get('reason')})")
            if e.get("time_to_detect_ms") is not None:
                row["detect_ms"] = e["time_to_detect_ms"]
        for e in stalls:
            row = health.setdefault(str(e.get("replica", "?")), {
                "transitions": 0, "suspect": 0, "dead": 0,
                "recovered": 0, "stalls": 0, "last": None,
                "detect_ms": None})
            row["stalls"] += 1
        lines.append("health transitions (by replica):")
        lines.append("  replica  transitions  suspect  dead  "
                     "recovered  stalls  detect_ms  last")
        for name in sorted(health):
            row = health[name]
            lines.append(
                f"  {name}  {row['transitions']}  {row['suspect']}  "
                f"{row['dead']}  {row['recovered']}  {row['stalls']}  "
                f"{row['detect_ms'] if row['detect_ms'] is not None else '-'}  "
                f"{row['last'] or '-'}")
        tail = filter_events(events, kinds=["request_stall"], last=3)
        if tail:
            lines.append("last request stalls:")
            for e in tail:
                lines.append("  " + json.dumps(e, sort_keys=True))
    for label, kind in (("scale-ups", "scale_up"),
                        ("scale-downs", "scale_down"),
                        ("drains", "drain")):
        tail = filter_events(events, kinds=[kind], last=3)
        if tail:
            lines.append(f"last {label}:")
            for e in tail:
                lines.append("  " + json.dumps(e, sort_keys=True))
    for label, kind in (("sheds", "shed"), ("errors", "error"),
                        ("requeues", "requeue"),
                        ("pool exhaustions", "kv_exhausted")):
        tail = filter_events(events, kinds=[kind], last=3)
        if tail:
            lines.append(f"last {label}:")
            for e in tail:
                lines.append("  " + json.dumps(e, sort_keys=True))
    return lines


def trace_events(doc: Dict[str, Any],
                 merge: Optional[List[Dict[str, Any]]] = None,
                 pid: int = 90, tid: int = 0) -> List[Dict[str, Any]]:
    """The journal as a chrome-trace instant-event lane.  `merge`
    prepends an existing timeline's events (export_timeline() writes
    a bare event array) — both use relative
    perf_counter origins, so the lanes line up when the dump and the
    timeline came from the same engine."""
    events: List[Dict[str, Any]] = list(merge or [])
    events.append(process_name_event(
        pid, f"flightrec {doc.get('source', '?')}"))
    events.append(thread_name_event(pid, tid, "engine decisions"))
    for e in doc.get("events", []):
        args = {k: v for k, v in e.items()
                if k not in ("kind", "t_s", "seq")}
        args["seq"] = e.get("seq")
        events.append(instant_event(
            str(e.get("kind", "event")), "flightrec",
            float(e.get("t_s", 0.0)), pid, tid, args))
    return events


def sweepjson_records(doc: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Metric-shaped records ({"metric", "value", "unit", "detail"})
    in the SWEEPJSON dialect ``perfledger ingest`` reads."""
    events = doc.get("events", [])
    counts = doc.get("counts_by_kind") or {}
    detail = {"source": doc.get("source"), "reason": doc.get("reason"),
              "created": doc.get("created")}
    recs: List[Dict[str, Any]] = [
        {"metric": "flightrec_events_retained",
         "value": doc.get("events_retained", len(events)),
         "unit": "events", "detail": detail},
        {"metric": "flightrec_events_dropped",
         "value": doc.get("events_dropped", 0),
         "unit": "events", "detail": detail},
    ]
    for kind in ("shed", "error", "requeue", "kv_exhausted",
                 "recompile_storm", "train_anomaly"):
        if counts.get(kind):
            recs.append({"metric": f"flightrec_{kind}_events",
                         "value": counts[kind], "unit": "events",
                         "detail": detail})
    steps = [e["dur_ms"] for e in events
             if e.get("kind") == "step" and "dur_ms" in e]
    if steps:
        s = summarize(steps)
        recs.append({"metric": "flightrec_step_p95_ms",
                     "value": s["p95"], "unit": "ms",
                     "detail": dict(detail, count=s["count"],
                                    p50=s["p50"])})
    slo = (doc.get("context") or {}).get("slo")
    if isinstance(slo, dict):
        for name, obj in (slo.get("objectives") or {}).items():
            if isinstance(obj.get("burn_rate"), (int, float)):
                recs.append({
                    "metric": f"flightrec_{name}_burn_rate",
                    "value": obj["burn_rate"], "unit": "ratio",
                    "detail": dict(detail,
                                   target_ms=obj.get("target_ms"))})
            if isinstance(obj.get("attainment"), (int, float)):
                recs.append({
                    "metric": f"flightrec_{name}_slo_attainment",
                    "value": obj["attainment"], "unit": "fraction",
                    "detail": dict(detail,
                                   target_ms=obj.get("target_ms"))})
    return recs


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m ray_tpu_torch.tools.flightrec",
        description="inspect flight-recorder postmortem dumps")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("report", help="human summary of one dump")
    p.add_argument("dump")

    p = sub.add_parser("events", help="filtered journal, JSONL")
    p.add_argument("dump")
    p.add_argument("--kind", default=None,
                   help="comma-separated event kinds to keep")
    p.add_argument("--last", type=int, default=None,
                   help="keep only the last N (after other filters)")
    p.add_argument("--since", type=float, default=None,
                   help="relative seconds (t_s) lower bound")
    p.add_argument("--until", type=float, default=None,
                   help="relative seconds (t_s) upper bound")
    p.add_argument("--request", default=None,
                   help="follow one request: engine-local id (req "
                        "field) or tracebus trace id / prefix")

    p = sub.add_parser("trace",
                       help="chrome-trace instant-event lane")
    p.add_argument("dump")
    p.add_argument("-o", "--out", default=None,
                   help="write trace JSON here (default: stdout)")
    p.add_argument("--merge", default=None,
                   help="existing timeline JSON to merge the lane "
                        "into (export_timeline)")

    p = sub.add_parser("sweepjson",
                       help="SWEEPJSON records for perfledger ingest")
    p.add_argument("dump")

    args = ap.parse_args(argv)
    try:
        doc = load_dump(args.dump)
    except (OSError, ValueError, json.JSONDecodeError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    if args.cmd == "report":
        for line in report_lines(doc):
            print(line)
        return 0
    if args.cmd == "events":
        kinds = args.kind.split(",") if args.kind else None
        for e in filter_events(doc["events"], kinds=kinds,
                               since=args.since, until=args.until,
                               last=args.last, request=args.request):
            print(json.dumps(e, sort_keys=True))
        return 0
    if args.cmd == "trace":
        merge = None
        if args.merge:
            with open(args.merge) as f:
                merge = json.load(f)
        events = trace_events(doc, merge=merge)
        payload = json.dumps(events)
        if args.out:
            with open(args.out, "w") as f:
                f.write(payload)
            print(f"wrote {len(events)} events to {args.out}")
        else:
            print(payload)
        return 0
    # sweepjson
    for rec in sweepjson_records(doc):
        print(json.dumps(rec, sort_keys=True))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
