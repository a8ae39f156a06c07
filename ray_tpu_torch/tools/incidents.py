"""Cross-replica incident timelines over tracebus/flightrec dumps.

A copy of ``ray_tpu/tools/incidents.py`` for the port; the dump formats
are the JAX package's, so either package's dumps read here.  One
repair: a health transition's two journal copies count once even when
the dump puts them a microsecond apart (``_dedup``), where the JAX tool
can count them twice.

Healthwatch (serve/health.py) journals its liveness transitions into
per-replica flight recorders; SLO burn, autoscale, drain, and chaos
events land in the same journals.  During an incident the operator's
question is singular — "which replica got sick, when was it caught,
and who was hurt" — but the evidence is scattered over N replica
journals plus the fleet router's.  This CLI merges them onto ONE
rebased clock (the tracebus merge pattern: every lane stamps the same
process ``perf_counter``) and answers in three shapes:

* ``report``   — the incident digest: each sick replica with its
  fault-injection instant (when chaos stamped one), SUSPECT/DEAD
  transition times, detection latency, stall/requeue counts and the
  affected request ids, plus the fleet's SLO burn window (first
  ``slo_breach`` → pairing ``slo_recover``) and any autoscale/drain
  decisions inside it.
* ``timeline`` — every incident-relevant event from every lane,
  chronological, one line each — the raw merged story.
* ``export``   — a chrome-trace instant-event lane (pid 95, above
  flightrec's pid-90 convention) composable with ``tracebus export``
  timelines via ``--merge``, so incidents render on the same Perfetto
  canvas as the request spans.

Input is either a tracebus dump (``tracebus.write_dump(collect(...))``
— per-lane journals under ``flightrec`` with absolute timestamps) or a
single flight-recorder dump (``events`` with dump-relative ``t_s``).
Pure stdlib + the chrome-trace builders; it needs nothing but the
dump file, and no card.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, List, Optional

from ray_tpu_torch._private.telemetry import (instant_event,
                                              process_name_event,
                                              thread_name_event)

__all__ = ["load", "merge_events", "extract_incidents",
           "burn_windows", "report_lines", "timeline_lines",
           "trace_events", "main"]

#: journal kinds that tell the incident story (everything else —
#: route, token, kv_* — is request-path detail the tracebus CLI owns)
INCIDENT_KINDS = frozenset({
    "fault_injected", "health_transition", "request_stall",
    "requeue", "slo_breach", "slo_recover", "scale_up", "scale_down",
    "drain", "handoff_dropped", "shed", "error",
})


def load(path: str) -> Dict[str, Any]:
    """Accept a tracebus dump or a bare flight-recorder dump."""
    with open(path) as f:
        doc = json.load(f)
    if "flightrec" not in doc and "events" not in doc:
        raise ValueError(
            f"{path} is neither a tracebus dump (no 'flightrec' "
            "lanes) nor a flight-recorder dump (no 'events')")
    return doc


def merge_events(doc: Dict[str, Any],
                 kinds: Optional[frozenset] = INCIDENT_KINDS
                 ) -> List[Dict[str, Any]]:
    """All lanes' journal events on one rebased clock: each returned
    event carries ``lane`` (recorder name) and ``t`` (seconds from the
    earliest merged event).  ``kinds=None`` keeps everything."""
    raw: List[Dict[str, Any]] = []
    lanes = doc.get("flightrec")
    if isinstance(lanes, dict):  # tracebus dump: absolute timestamps
        for lane_name, lane in lanes.items():
            for e in lane.get("events", ()):
                if kinds is not None and e.get("kind") not in kinds:
                    continue
                ev = dict(e)
                ev["lane"] = lane_name
                ev["_ts"] = float(e.get("ts", e.get("t_s", 0.0)))
                raw.append(ev)
    else:  # single flight-recorder dump: dump-relative t_s
        lane_name = str(doc.get("source", "engine"))
        for e in doc.get("events", ()):
            if kinds is not None and e.get("kind") not in kinds:
                continue
            ev = dict(e)
            ev["lane"] = lane_name
            ev["_ts"] = float(e.get("t_s", 0.0))
            raw.append(ev)
    base = min((e["_ts"] for e in raw), default=0.0)
    for e in raw:
        e["t"] = round(e.pop("_ts") - base, 6)
    raw.sort(key=lambda e: (e["t"], str(e.get("kind"))))
    return raw


#: how far apart a twin's two copies can land: a tracebus dump keeps
#: each lane's times as whole microseconds since that recorder's own t0
#: (rounded once) and merge_events rounds them to microseconds again,
#: so one instant comes back from two lanes up to 1 µs apart
_TWIN_S = 1.5e-6


def _dedup(events: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Health transitions journal to BOTH the fleet recorder and the
    replica's own (two lanes, same instant) — collapse those twins so
    counters don't double.  ``events`` is in time order; an event is a
    twin when the last one kept with its key lies within _TWIN_S."""
    last: Dict[tuple, float] = {}
    out = []
    for e in events:
        key = (e.get("kind"), e.get("replica"), e.get("to"),
               e.get("reason"), e.get("req"))
        if key in last and e["t"] - last[key] <= _TWIN_S:
            continue
        last[key] = e["t"]
        out.append(e)
    return out


def extract_incidents(events: List[Dict[str, Any]]
                      ) -> List[Dict[str, Any]]:
    """Per-replica incident digests from the merged stream: one entry
    per replica that got sick (any transition away from healthy, a
    stamped fault, a stall, or death-requeues), in first-symptom
    order."""
    events = _dedup(events)
    incidents: Dict[str, Dict[str, Any]] = {}

    def inc_for(rep: str) -> Dict[str, Any]:
        return incidents.setdefault(rep, {
            "replica": rep, "fault_t": None, "fault_kind": None,
            "suspect_t": None, "dead_t": None, "recover_t": None,
            "time_to_detect_ms": None, "transitions": 0,
            "stalls": 0, "requeued": 0, "affected": []})

    def touch(inc: Dict[str, Any], req: Any) -> None:
        if req is not None and req not in inc["affected"]:
            inc["affected"].append(req)

    for e in events:
        kind = e.get("kind")
        rep = e.get("replica")
        if kind == "fault_injected" and rep:
            inc = inc_for(rep)
            if inc["fault_t"] is None:
                inc["fault_t"] = e["t"]
                inc["fault_kind"] = e.get("fault")
        elif kind == "health_transition" and rep:
            inc = inc_for(rep)
            inc["transitions"] += 1
            to = e.get("to")
            if to == "suspect" and inc["suspect_t"] is None:
                inc["suspect_t"] = e["t"]
            elif to == "dead" and inc["dead_t"] is None:
                inc["dead_t"] = e["t"]
                inc["time_to_detect_ms"] = e.get("time_to_detect_ms")
            elif to == "healthy":
                inc["recover_t"] = e["t"]
        elif kind == "request_stall" and rep:
            inc = inc_for(rep)
            inc["stalls"] += 1
            touch(inc, e.get("req"))
        elif kind == "requeue" \
                and e.get("reason") == "replica_dead":
            # journaled on the dead replica's own recorder — the lane
            # IS the sick replica
            inc = inc_for(str(e.get("lane")))
            inc["requeued"] += 1
            touch(inc, e.get("req"))
    order = []
    for inc in incidents.values():
        marks = [t for t in (inc["fault_t"], inc["suspect_t"],
                             inc["dead_t"]) if t is not None]
        order.append((min(marks) if marks else float("inf"), inc))
    return [inc for _t, inc in sorted(order, key=lambda p: p[0])]


def burn_windows(events: List[Dict[str, Any]]
                 ) -> List[Dict[str, Any]]:
    """SLO burn windows per (lane, objective): opened by a
    ``slo_breach``, closed by the next ``slo_recover`` on the same
    lane+objective (``end=None`` = still burning at dump time)."""
    open_by_key: Dict[tuple, Dict[str, Any]] = {}
    out: List[Dict[str, Any]] = []
    for e in _dedup(events):
        kind = e.get("kind")
        if kind not in ("slo_breach", "slo_recover"):
            continue
        key = (e.get("lane"), e.get("objective"))
        if kind == "slo_breach":
            if key not in open_by_key:
                win = {"lane": key[0], "objective": key[1],
                       "start": e["t"], "end": None,
                       "burn_rate": e.get("burn_rate"),
                       "target_ms": e.get("target_ms")}
                open_by_key[key] = win
                out.append(win)
        else:
            win = open_by_key.pop(key, None)
            if win is not None:
                win["end"] = e["t"]
    return out


def report_lines(doc: Dict[str, Any]) -> List[str]:
    events = merge_events(doc)
    lines = [
        f"incident report: {doc.get('source', '?')}  "
        f"({len(events)} incident events, clock rebased to the "
        "earliest)",
    ]
    incidents = extract_incidents(events)
    if not incidents:
        lines.append("no incidents: every replica stayed healthy")
    for inc in incidents:
        lines.append(f"replica {inc['replica']}:")
        if inc["fault_t"] is not None:
            lines.append(f"  fault injected: {inc['fault_kind']} "
                         f"@ {inc['fault_t']:.3f}s")
        if inc["suspect_t"] is not None:
            lines.append(f"  SUSPECT @ {inc['suspect_t']:.3f}s")
        if inc["dead_t"] is not None:
            detect = ("  time_to_detect_ms="
                      f"{inc['time_to_detect_ms']}"
                      if inc["time_to_detect_ms"] is not None else "")
            lines.append(f"  DEAD    @ {inc['dead_t']:.3f}s{detect}")
        if inc["recover_t"] is not None:
            lines.append(f"  recovered @ {inc['recover_t']:.3f}s")
        lines.append(
            f"  transitions={inc['transitions']}  "
            f"stalls={inc['stalls']}  "
            f"requeued_on_death={inc['requeued']}")
        if inc["affected"]:
            ids = ", ".join(str(r) for r in inc["affected"][:12])
            more = len(inc["affected"]) - 12
            lines.append(f"  affected requests: {ids}"
                         + (f" (+{more} more)" if more > 0 else ""))
    wins = burn_windows(events)
    if wins:
        for w in wins:
            end = (f"{w['end']:.3f}s" if w["end"] is not None
                   else "(unrecovered)")
            span = (f"  ({round((w['end'] - w['start']) * 1e3, 1)}ms)"
                    if w["end"] is not None else "")
            lines.append(
                f"slo burn window [{w['lane']}/{w['objective']}]: "
                f"{w['start']:.3f}s -> {end}{span}  "
                f"burn_rate={w['burn_rate']}")
    else:
        lines.append("(no slo breach observed)")
    scale = [e for e in _dedup(events)
             if e.get("kind") in ("scale_up", "scale_down", "drain",
                                  "handoff_dropped")]
    if scale:
        lines.append("control-plane decisions in window:")
        for e in scale[-6:]:
            detail = {k: v for k, v in e.items()
                      if k not in ("t", "lane", "t_s", "ts", "seq")}
            lines.append(f"  {e['t']:.3f}s  "
                         + json.dumps(detail, sort_keys=True))
    return lines


def timeline_lines(doc: Dict[str, Any]) -> List[str]:
    lines = []
    for e in merge_events(doc):
        detail = {k: v for k, v in e.items()
                  if k not in ("t", "lane", "kind", "t_s", "ts",
                               "seq")}
        lines.append(f"{e['t']:9.3f}s  {e['lane']:<20}  "
                     f"{str(e.get('kind')):<18}  "
                     + json.dumps(detail, sort_keys=True))
    return lines


def trace_events(doc: Dict[str, Any],
                 merge: Optional[List[Dict[str, Any]]] = None,
                 pid: int = 95, tid: int = 0
                 ) -> List[Dict[str, Any]]:
    """The incident stream as a chrome-trace instant-event lane —
    pid 95 by convention (flightrec's decision lane sits at 90), so
    ``--merge`` with a ``tracebus export`` timeline stacks cleanly."""
    events: List[Dict[str, Any]] = list(merge or [])
    events.append(process_name_event(
        pid, f"incidents {doc.get('source', '?')}"))
    events.append(thread_name_event(pid, tid, "health + slo + chaos"))
    for e in merge_events(doc):
        args = {k: v for k, v in e.items()
                if k not in ("kind", "t", "t_s", "ts", "seq")}
        events.append(instant_event(
            str(e.get("kind", "event")), "incidents",
            float(e["t"]), pid, tid, args))
    return events


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m ray_tpu_torch.tools.incidents",
        description="merged cross-replica incident timelines from "
                    "tracebus / flight-recorder dumps")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("report",
                       help="incident digest: sick replicas, "
                            "detection latency, burn windows")
    p.add_argument("dump")

    p = sub.add_parser("timeline",
                       help="every incident event, merged and "
                            "chronological")
    p.add_argument("dump")

    p = sub.add_parser("export",
                       help="chrome-trace incident lane (pid 95)")
    p.add_argument("dump")
    p.add_argument("-o", "--out", default=None,
                   help="write trace JSON here (default: stdout)")
    p.add_argument("--merge", default=None,
                   help="existing timeline JSON to merge the lane "
                        "into (tracebus export / flightrec trace)")

    args = ap.parse_args(argv)
    try:
        doc = load(args.dump)
    except (OSError, ValueError, json.JSONDecodeError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    if args.cmd == "report":
        for line in report_lines(doc):
            print(line)
        return 0
    if args.cmd == "timeline":
        for line in timeline_lines(doc):
            print(line)
        return 0
    # export
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


if __name__ == "__main__":
    raise SystemExit(main())
