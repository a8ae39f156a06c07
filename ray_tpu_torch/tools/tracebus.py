"""Request tracebus: fleet-wide causal tracing + critical-path CLI.

A copy of ``ray_tpu/tools/tracebus.py`` over the port's engine, fleet
and program registry; the dump format is the JAX package's, so either
package's dumps read here.

The serving stack records WHERE time went in three silos — per-request
lifecycle records (serve/telemetry.py), flight-recorder decision
journals (_private/flightrec.py), and device-observatory program
invokes (_private/device_stats.py).  All three stamp the same process
monotonic clock (``time.perf_counter``), which is the load-bearing
fact this module exploits: ``collect()`` merges them into ONE document
where a request's spans stitch router → replica engine → device
program via parent ids on a single timeline.

* ``collect(fleet_or_engine)`` — snapshot a live ``LLMFleet`` (or a
  single engine instance) into a JSON-able tracebus document:
  request snapshots with per-token timestamps, per-lane flightrec
  journals rebased to absolute clock, and timestamped device program
  invokes.
* ``build_request_spans(req)`` — one request's span tree
  (router.route → engine.queue / kv.reserve / engine.requeue →
  engine.prefill → kv.handoff → engine.decode; kv.handoff appears
  only on disaggregated fleets, covering the prefill-replica export
  through the decode-replica install fence), every span a
  monotonic-clock window with a parent id; ``attach_device_spans``
  parents the matching prefill program dispatch under the request's
  prefill span.
* ``critical_path_table(...)`` — the pXX decomposition
  e2e = router_wait + queue_wait + requeue + prefill + handoff +
  inter_token + spec_rollback (components from serve/telemetry.py
  ``critical_path``, which sum to e2e by construction).
* ``chrome_trace(doc)`` — the merged Perfetto timeline: one pid per
  replica (slot lanes + a flightrec decision lane), a router pid, and
  a device-program pid.

CLI: ``python -m ray_tpu_torch.tools.tracebus <cmd> <dump.json>`` with
``report`` / ``trace <request_id>`` / ``critical-path
--percentile 99`` / ``export`` — dumps are written by
``write_dump(collect(fleet), path)`` (bench/traffic harnesses) so the
CLI, like tools/flightrec.py, reads artifacts without a card.

Caveat: merging assumes one clock domain, i.e. in-process replicas
(build_llm_fleet's model).  Cross-host fleets would need clock-offset
estimation — out of scope here, flagged in docs/observability.md.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, List, Optional

from ray_tpu_torch._private.telemetry import (complete_event,
                                              instant_event, percentile,
                                              process_name_event,
                                              thread_name_event)
from ray_tpu_torch.serve.telemetry import (CRITICAL_PATH_COMPONENTS,
                                           latency_anatomy,
                                           merge_anatomy_samples)

__all__ = ["collect", "write_dump", "load_dump", "COMPONENT_SPANS",
           "build_request_spans", "attach_device_spans",
           "find_request", "critical_path_table", "chrome_trace",
           "report_lines", "trace_lines", "main"]

DUMP_VERSION = 1

#: critical-path component -> the tracebus span that carries it (None
#: for derived legs with no dedicated span: prefill_wait is the gap
#: between prefill chunks, spec_rollback is an attr on engine.decode).
#: tests/test_torch_tracebus.py pins this mapping both ways:
#: every CRITICAL_PATH_COMPONENTS member must appear here, and every
#: named span must still be emitted by build_request_spans below.
COMPONENT_SPANS: Dict[str, Optional[str]] = {
    "router_wait_ms": "router.wait",
    "queue_wait_ms": "engine.queue",
    "requeue_ms": "engine.requeue",
    "kv_fetch_ms": "kv.fetch",
    "prefill_ms": "engine.prefill",
    "prefill_wait_ms": None,
    "handoff_ms": "kv.handoff",
    "inter_token_ms": "engine.decode",
    "spec_rollback_ms": None,
}


# ---------------------------------------------------------------------------
# collection
# ---------------------------------------------------------------------------

def _abs_events(recorder) -> Dict[str, Any]:
    """One flight recorder's journal with timestamps restored to the
    absolute monotonic clock (snapshot() rebases to its t0)."""
    t0 = float(getattr(recorder, "t0", 0.0))
    events = []
    for e in recorder.snapshot():
        e = dict(e)
        e["ts"] = t0 + float(e.get("t_s", 0.0))
        events.append(e)
    return {"t0": t0, "events": events}


def _device_programs(prefix: str = "serve.") -> Dict[str, Any]:
    """Timestamped program invoke/compile windows from the process
    device observatory ({} when the registry is unavailable)."""
    try:
        from ray_tpu_torch._private.device_stats import get_registry

        reg = get_registry()
        return {
            "invokes": {name: [[float(ts), float(d)] for ts, d in evs]
                        for name, evs
                        in reg.invoke_events(prefix).items()},
            "compiles": {name: [[float(ts), float(d)] for ts, d in evs]
                         for name, evs
                         in reg.compile_windows(prefix).items()},
        }
    except Exception:  # noqa: BLE001 - collection is best-effort
        return {"invokes": {}, "compiles": {}}


def collect(target, name: Optional[str] = None) -> Dict[str, Any]:
    """Snapshot a live fleet (``LLMFleet``) or single engine instance
    into a tracebus document.  Duck-typed: a fleet exposes
    ``trace_records`` + per-replica handles; an engine exposes
    ``trace_records`` + ``engine_stats``."""
    doc: Dict[str, Any] = {
        "version": DUMP_VERSION,
        "source": name or getattr(target, "name", None)
        or getattr(target, "deployment", "engine"),
        "clock": "perf_counter",
        "requests": [],
        "flightrec": {},
        "programs": _device_programs(),
    }
    replicas = getattr(target, "_replicas", None)
    if replicas is not None:  # fleet
        doc["requests"] = target.trace_records()
        fleet_tel = getattr(target, "telemetry", None)
        if fleet_tel is not None:
            doc["flightrec"]["router"] = _abs_events(fleet_tel.flightrec)
        for rep in list(replicas) + list(getattr(target, "_retired",
                                                 ())):
            tel = getattr(rep.inst, "_telemetry", None)
            if tel is not None:
                doc["flightrec"][rep.name] = _abs_events(tel.flightrec)
        anatomy = target.latency_anatomy() \
            if hasattr(target, "latency_anatomy") else None
    else:  # single engine
        for snap in target.trace_records():
            snap.setdefault("replica", snap.get("deployment"))
            doc["requests"].append(snap)
        tel = getattr(target, "_telemetry", None)
        if tel is not None:
            doc["flightrec"][tel.deployment] = _abs_events(tel.flightrec)
        samples = (target.anatomy_samples()
                   if hasattr(target, "anatomy_samples") else
                   merge_anatomy_samples([]))
        anatomy = latency_anatomy(samples)
    doc["latency_anatomy"] = anatomy
    return doc


def write_dump(doc: Dict[str, Any], path: str) -> str:
    with open(path, "w") as f:
        json.dump(doc, f)
    return path


def load_dump(path: str) -> Dict[str, Any]:
    with open(path) as f:
        doc = json.load(f)
    if "requests" not in doc:
        raise ValueError(f"{path} is not a tracebus dump "
                         "(no 'requests' array)")
    return doc


# ---------------------------------------------------------------------------
# span trees
# ---------------------------------------------------------------------------

def _tid(req: Dict[str, Any]) -> str:
    return req.get("trace_id") or f"req{req.get('id')}"


def build_request_spans(req: Dict[str, Any]) -> List[Dict[str, Any]]:
    """One request's span tree from its hop timestamps: every span a
    {name, span_id, parent_id, start, end, attrs} dict on the
    monotonic clock.  Router-side spans recorded live on the
    TraceContext are included verbatim; engine-side hops are
    synthesized deterministically from the lifecycle record (ids
    ``<trace>:eN`` so they never collide with the context's ``:N``)."""
    tid = _tid(req)
    root_id = f"{tid}:0"
    end_guess = req.get("finish") or req.get("first_token") \
        or req.get("admit") or req.get("engine_enqueue") \
        or req.get("enqueue") or 0.0
    spans: List[Dict[str, Any]] = [{
        "name": f"request {tid[:10]}",
        "span_id": root_id, "parent_id": None,
        "start": req.get("enqueue") or 0.0, "end": end_guess,
        "attrs": {"request": req.get("request"),
                  "replica": req.get("replica"),
                  "tenant": req.get("tenant"),
                  "status": req.get("status"),
                  "prompt_len": req.get("prompt_len"),
                  "tokens": req.get("tokens")},
    }]
    spans.extend(dict(s) for s in req.get("spans", ()))
    n = 0

    def emit(name, start, end, parent=root_id, **attrs):
        nonlocal n
        n += 1
        sid = f"{tid}:e{n}"
        spans.append({"name": name, "span_id": sid,
                      "parent_id": parent, "start": float(start),
                      "end": float(end), "attrs": attrs})
        return sid

    enq = req.get("enqueue")
    t_eng = req.get("engine_enqueue")
    admit = req.get("admit")
    first = req.get("first_token")
    finish = req.get("finish")
    if enq is not None and t_eng is not None and t_eng > enq:
        emit("router.wait", enq, t_eng)
    if t_eng is not None and admit is not None:
        queue_id = emit("engine.queue", t_eng, admit)
        rq = req.get("requeue_ts")
        if rq is not None:
            emit("engine.requeue", rq, admit, parent=queue_id,
                 requeues=req.get("requeues", 0))
        kv = req.get("kv_reserve")
        if kv:
            emit("kv.reserve", kv[0], kv[1], parent=queue_id,
                 blocks=kv[2] if len(kv) > 2 else None,
                 hit_blocks=kv[3] if len(kv) > 3 else None,
                 evicted=kv[4] if len(kv) > 4 else None,
                 reprefill_waste_tokens=kv[5] if len(kv) > 5
                 else None)
        # host-tier restore (serve/kv_tier.py): evicted prefix blocks
        # re-admitted via H2D copy during this admission — its own
        # span inside queue wait, matching the kv_fetch_ms component
        kf = req.get("kv_fetch")
        if kf:
            emit("kv.fetch", kf[0], kf[1], parent=queue_id,
                 blocks=kf[2] if len(kf) > 2 else None,
                 tokens=kf[3] if len(kf) > 3 else None,
                 bytes=kf[4] if len(kf) > 4 else None)
    if admit is not None and first is not None:
        chunks = req.get("prefill_chunks")
        if chunks:
            # chunked streaming prefill: one child span per chunk so
            # the timeline shows decode waves in the gaps between them
            for ci, c in enumerate(chunks):
                emit("engine.prefill", c[0], c[1],
                     chunk=ci, n_chunks=len(chunks),
                     tokens=int(c[2]), bucket=int(c[3]),
                     slot=req.get("slot"))
        else:
            emit("engine.prefill", admit, first,
                 bucket=req.get("bucket"), slot=req.get("slot"))
    # disaggregated handoff (serve/llm.py role-split fleets): the
    # block move from prefill replica to decode replica — export
    # start through install fence, between the prefill and decode
    # legs, matching the handoff_ms critical-path component
    kh = req.get("kv_handoff")
    if kh:
        emit("kv.handoff", kh[0], kh[1],
             blocks=kh[2] if len(kh) > 2 else None,
             bytes=kh[3] if len(kh) > 3 else None,
             path=kh[4] if len(kh) > 4 else None)
    if first is not None and finish is not None:
        emit("engine.decode", first, finish,
             tokens=req.get("tokens"),
             spec_rounds=req.get("spec_rounds", 0),
             spec_accepted=req.get("spec_accepted", 0),
             spec_rollback_s=req.get("spec_rollback_s", 0.0))
    return spans


def attach_device_spans(spans: List[Dict[str, Any]],
                        req: Dict[str, Any],
                        programs: Dict[str, Any]
                        ) -> List[Dict[str, Any]]:
    """Parent the device-observatory prefill dispatch under the
    request's ``engine.prefill`` span: the prefill program runs once
    per admission, so the invoke (or compile, for a fresh bucket)
    whose window ends closest to the request's first token inside the
    prefill window IS this request's device work.  Decode dispatches
    are pooled across slots and stay on the shared device lane."""
    prefills = [s for s in spans if s["name"] == "engine.prefill"]
    if not prefills:
        return spans
    # chunked prefill emits several engine.prefill spans; the search
    # window covers all of them and the matched dispatch parents under
    # the chunk whose window contains it (falling back to the last
    # chunk, whose dispatch produced the first token).
    lo = min(s["start"] for s in prefills)
    hi = max(s["end"] for s in prefills) + 1e-4
    last = prefills[-1]
    best = None
    for kind_key, kind in (("invokes", "invoke"),
                           ("compiles", "compile")):
        for name, evs in (programs.get(kind_key) or {}).items():
            if "prefill" not in name:
                continue
            for ts, dur in evs:
                if lo <= ts <= hi:
                    gap = abs(last["end"] - ts)
                    if best is None or gap < best[0]:
                        best = (gap, name, ts, dur, kind)
    if best is not None:
        _gap, name, ts, dur, kind = best
        parent = next(
            (s for s in prefills
             if s["start"] <= ts <= s["end"] + 1e-4), last)
        spans.append({
            "name": f"device {name}",
            "span_id": f"{_tid(req)}:dev",
            "parent_id": parent["span_id"],
            "start": max(parent["start"], ts - dur), "end": ts,
            "attrs": {"program": name, "kind": kind,
                      "dur_ms": round(dur * 1e3, 3)},
        })
    return spans


def find_request(doc: Dict[str, Any], request_id: Any
                 ) -> Optional[Dict[str, Any]]:
    """Locate one request in a tracebus document by trace id (full or
    prefix), ``replica:id``, or bare engine-local id."""
    rid = str(request_id)
    rep_hint = None
    if ":" in rid:
        rep_hint, rid = rid.split(":", 1)
    for req in doc.get("requests", []):
        if rep_hint is not None and req.get("replica") != rep_hint:
            continue
        trace = req.get("trace_id") or ""
        if trace == rid or (len(rid) >= 6 and trace.startswith(rid)):
            return req
        if str(req.get("id")) == rid:
            return req
    return None


# ---------------------------------------------------------------------------
# critical path
# ---------------------------------------------------------------------------

def critical_path_table(doc: Dict[str, Any], pct: float = 99.0,
                        tenant: Optional[str] = None
                        ) -> Dict[str, Any]:
    """The pXX latency decomposition over completed requests: each
    component's own pXX (a table of independent percentiles) plus the
    pXX-e2e exemplar request, whose components sum to its measured
    e2e exactly (the per-request invariant the decomposition keeps)."""
    reqs = [r for r in doc.get("requests", [])
            if r.get("critical_path")
            and (tenant is None or r.get("tenant") == tenant)]
    cps = [r["critical_path"] for r in reqs]
    table = {k: percentile(sorted(c[k] for c in cps), pct)
             if cps else None
             for k in ("e2e_ms",) + CRITICAL_PATH_COMPONENTS}
    exemplar = None
    if cps:
        cut = percentile(sorted(c["e2e_ms"] for c in cps), pct)
        cands = [r for r in reqs
                 if r["critical_path"]["e2e_ms"] >= cut]
        exemplar = min(
            cands, key=lambda r: r["critical_path"]["e2e_ms"],
            default=None)
    return {
        "percentile": pct,
        "tenant": tenant,
        "requests": len(cps),
        "components": table,
        "component_sum_ms": round(sum(
            table[k] for k in CRITICAL_PATH_COMPONENTS), 4)
        if cps else None,
        "exemplar": {
            "request": exemplar.get("request"),
            "replica": exemplar.get("replica"),
            "critical_path": exemplar["critical_path"],
        } if exemplar is not None else None,
    }


def critical_path_lines(doc: Dict[str, Any], pct: float = 99.0,
                        tenant: Optional[str] = None) -> List[str]:
    t = critical_path_table(doc, pct, tenant)
    hdr = f"critical path p{pct:g}"
    if tenant:
        hdr += f" tenant={tenant}"
    lines = [f"{hdr}  ({t['requests']} completed requests)"]
    if not t["requests"]:
        return lines + ["  (no completed requests)"]
    comps = t["components"]
    e2e = comps["e2e_ms"] or 0.0
    for k in CRITICAL_PATH_COMPONENTS:
        v = comps[k] or 0.0
        share = (v / e2e * 100.0) if e2e else 0.0
        lines.append(f"  {k:<18} {v:>10.3f} ms  {share:>5.1f}%")
    lines.append(f"  {'e2e_ms':<18} {e2e:>10.3f} ms")
    ex = t["exemplar"]
    if ex:
        cp = ex["critical_path"]
        comp_sum = sum(cp[k] for k in CRITICAL_PATH_COMPONENTS)
        lines.append(
            f"exemplar {ex['request']} on {ex['replica']}: "
            f"e2e {cp['e2e_ms']:.3f} ms, components sum "
            f"{comp_sum:.3f} ms")
        for k in CRITICAL_PATH_COMPONENTS:
            lines.append(f"    {k:<18} {cp[k]:>10.3f} ms")
    return lines


# ---------------------------------------------------------------------------
# chrome-trace export
# ---------------------------------------------------------------------------

def chrome_trace(doc: Dict[str, Any],
                 path: Optional[str] = None) -> List[Dict[str, Any]]:
    """The merged timeline: pid 0 = router (flightrec decision lane),
    one pid per replica (request spans in slot lanes + that replica's
    flightrec lane), and a device pid with one lane per program.
    Span args carry span_id/parent_id so the causal chain survives
    into the exported JSON."""
    t0s: List[float] = []
    for req in doc.get("requests", []):
        if req.get("enqueue") is not None:
            t0s.append(req["enqueue"])
    for lane in doc.get("flightrec", {}).values():
        t0s.extend(e["ts"] for e in lane.get("events", ()))
    base = min(t0s) if t0s else 0.0

    events: List[Dict[str, Any]] = []
    lanes = sorted({req.get("replica") or req.get("deployment")
                    or "engine" for req in doc.get("requests", [])})
    pid_of = {name: i + 1 for i, name in enumerate(lanes)}
    events.append(process_name_event(0, f"router {doc.get('source')}"))
    events.append(thread_name_event(0, 0, "decisions"))
    for name, pid in pid_of.items():
        events.append(process_name_event(pid, f"replica {name}"))
        events.append(thread_name_event(pid, 0, "flightrec"))

    for req in doc.get("requests", []):
        lane = req.get("replica") or req.get("deployment") or "engine"
        pid = pid_of[lane]
        tid_lane = (req.get("slot") if req.get("slot") is not None
                    else 0) + 1
        spans = attach_device_spans(
            build_request_spans(req), req, doc.get("programs", {}))
        for s in spans:
            dur = max(0.0, s["end"] - s["start"])
            args = dict(s["attrs"], span_id=s["span_id"],
                        parent_id=s["parent_id"])
            # router-side spans render on the router pid; the rest on
            # the owning replica's slot lane
            span_pid = 0 if s["name"].startswith("router.") else pid
            events.append(complete_event(
                s["name"], "tracebus", s["start"] - base, dur,
                span_pid, 0 if span_pid == 0 else tid_lane, args))
        for i, ts in enumerate(req.get("token_ts") or ()):
            events.append(instant_event(
                "token", "tracebus", ts - base, pid, tid_lane,
                {"i": i, "request": req.get("request")}))

    for lane_name, lane in doc.get("flightrec", {}).items():
        pid = 0 if lane_name == "router" else pid_of.get(lane_name)
        if pid is None:
            continue
        for e in lane.get("events", ()):
            args = {k: v for k, v in e.items()
                    if k not in ("kind", "ts", "t_s")}
            events.append(instant_event(
                str(e.get("kind", "event")), "flightrec",
                e["ts"] - base, pid, 0, args))

    dev_pid = len(lanes) + 1
    programs = doc.get("programs", {}) or {}
    prog_names = sorted(set(programs.get("invokes", {}))
                        | set(programs.get("compiles", {})))
    if prog_names:
        events.append(process_name_event(dev_pid, "device programs"))
        for t, name in enumerate(prog_names):
            events.append(thread_name_event(dev_pid, t, name))
        for kind_key, cat in (("invokes", "device"),
                              ("compiles", "compile")):
            for name, evs in (programs.get(kind_key) or {}).items():
                t = prog_names.index(name)
                for ts, dur in evs:
                    events.append(complete_event(
                        name, cat, ts - dur - base, dur, dev_pid, t,
                        {"kind": kind_key[:-1]}))

    from ray_tpu_torch._private.telemetry import write_chrome_trace

    return write_chrome_trace(events, path)


# ---------------------------------------------------------------------------
# report / trace rendering
# ---------------------------------------------------------------------------

def report_lines(doc: Dict[str, Any]) -> List[str]:
    reqs = doc.get("requests", [])
    done = [r for r in reqs if r.get("status") == "ok"]
    lines = [
        f"tracebus: {doc.get('source', '?')}  clock="
        f"{doc.get('clock', '?')}",
        f"requests: {len(reqs)} retained / {len(done)} completed",
    ]
    by_lane: Dict[str, int] = {}
    for r in reqs:
        lane = r.get("replica") or r.get("deployment") or "engine"
        by_lane[lane] = by_lane.get(lane, 0) + 1
    if by_lane:
        lines.append("by replica: " + ", ".join(
            f"{k}={v}" for k, v in sorted(by_lane.items())))
    anatomy = doc.get("latency_anatomy")
    if anatomy:
        itl = anatomy.get("itl_ms") or {}
        lines.append(
            f"itl_ms: n={itl.get('count')} p50={itl.get('p50')} "
            f"p95={itl.get('p95')} p99={itl.get('p99')}")
        tpot = anatomy.get("tpot_ms") or {}
        lines.append(
            f"tpot_ms: n={tpot.get('count')} p50={tpot.get('p50')} "
            f"p99={tpot.get('p99')}")
    lines.extend(critical_path_lines(doc, 99.0))
    return lines


def trace_lines(doc: Dict[str, Any], request_id: Any) -> List[str]:
    req = find_request(doc, request_id)
    if req is None:
        return [f"request {request_id!r} not found "
                f"({len(doc.get('requests', []))} retained)"]
    spans = attach_device_spans(
        build_request_spans(req), req, doc.get("programs", {}))
    base = min(s["start"] for s in spans)
    by_parent: Dict[Any, List[Dict[str, Any]]] = {}
    for s in spans:
        by_parent.setdefault(s["parent_id"], []).append(s)
    lines = [f"request {req.get('request')}  replica="
             f"{req.get('replica')}  tenant={req.get('tenant')}  "
             f"status={req.get('status')}"]

    def walk(parent, depth):
        for s in sorted(by_parent.get(parent, ()),
                        key=lambda s: s["start"]):
            dur_ms = (s["end"] - s["start"]) * 1e3
            lines.append(
                f"{'  ' * depth}{s['name']:<24} "
                f"+{(s['start'] - base) * 1e3:>9.3f} ms  "
                f"dur {dur_ms:>9.3f} ms  [{s['span_id']}"
                f" <- {s['parent_id']}]")
            walk(s["span_id"], depth + 1)

    walk(None, 0)
    cp = req.get("critical_path")
    if cp:
        lines.append("critical path:")
        for k in ("e2e_ms",) + CRITICAL_PATH_COMPONENTS:
            lines.append(f"  {k:<18} {cp[k]:>10.3f} ms")
    return lines


# ---------------------------------------------------------------------------
# autopilot evidence
# ---------------------------------------------------------------------------

def request_evidence(doc: Dict[str, Any],
                     pct: float = 99.0) -> Dict[str, Any]:
    """Request-level evidence for autopilot attribution: the pXX
    decomposition overall and per tenant — which lifecycle leg (not
    which program) dominates tail latency, the complement of the
    roofline's program-granularity view."""
    overall = critical_path_table(doc, pct)
    tenants = sorted({r.get("tenant") for r in doc.get("requests", [])
                      if r.get("tenant")})
    comps = overall["components"]
    dominant = None
    if overall["requests"]:
        dominant = max(CRITICAL_PATH_COMPONENTS,
                       key=lambda k: comps[k] or 0.0)
    return {
        "percentile": pct,
        "overall": overall,
        "by_tenant": {t: critical_path_table(doc, pct, tenant=t)
                      for t in tenants},
        "dominant_component": dominant,
    }


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m ray_tpu_torch.tools.tracebus",
        description="inspect tracebus dumps (fleet-wide causal "
                    "request traces)")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("report", help="summary of one dump")
    p.add_argument("dump")

    p = sub.add_parser("trace", help="one request's span tree")
    p.add_argument("dump")
    p.add_argument("request_id",
                   help="trace id (or prefix), replica:id, or "
                        "engine-local id")

    p = sub.add_parser("critical-path",
                       help="pXX latency decomposition table")
    p.add_argument("dump")
    p.add_argument("--percentile", type=float, default=99.0)
    p.add_argument("--tenant", default=None)

    p = sub.add_parser("export",
                       help="merged chrome-trace timeline")
    p.add_argument("dump")
    p.add_argument("-o", "--out", default=None,
                   help="write trace JSON here (default: stdout)")

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
    if args.cmd == "trace":
        lines = trace_lines(doc, args.request_id)
        for line in lines:
            print(line)
        return 0 if not lines[0].endswith("retained)") else 1
    if args.cmd == "critical-path":
        for line in critical_path_lines(doc, args.percentile,
                                        args.tenant):
            print(line)
        return 0
    # export
    events = chrome_trace(doc, args.out)
    if args.out:
        print(f"wrote {len(events)} events to {args.out}")
    else:
        print(json.dumps(events))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
