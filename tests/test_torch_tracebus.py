"""The port's tracebus (``ray_tpu_torch/tools/tracebus.py``) against the
JAX package's.

Synthetic request records on injected clocks go through both packages'
telemetry: the critical-path decomposition gives the same numbers
(exact sums, clamping, chunked prefill, the disaggregated handoff).
The same snapshot documents go through both tracebus modules: span
trees, device stitching, the critical-path table, the rendered lines
and the chrome-trace export are equal.  Then a nano fleet's dump
(``run_traffic_fleet(trace_dump=...)``) stitches router → engine →
device spans on one clock, its exemplar's components sum to its e2e
within 5%, and the CLI's subcommands and exit codes match JAX's on it.
"""

import json

import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from ray_tpu.serve import telemetry as JT  # noqa: E402
from ray_tpu.tools import tracebus as JTB  # noqa: E402
from ray_tpu_torch.serve import telemetry as T  # noqa: E402
from ray_tpu_torch.tools import tracebus as TB  # noqa: E402


def _plain(M):
    tel = M.EngineTelemetry("dep0")
    ctx = M.TraceContext(origin="router", trace_id="a" * 16)
    ctx.span("router.route", 0.5, 1.0, replica="dep0", policy="wfq",
             tenant="a", matched_blocks=0, router_req=7)
    rec = tel.record_enqueue(12, now=1.0, tenant="a", ctx=ctx,
                             engine_now=1.2)
    tel.record_requeue(rec, need=3, reason="pool_exhausted", now=1.3)
    tel.record_kv_reserve(rec, 1.35, 1.4, blocks=4, hit_blocks=1)
    tel.record_admit(rec, bucket=16, slot=0, now=1.5)
    tel.record_first_token(rec, now=2.0)
    tel.record_token(rec, now=2.1)
    tel.record_token(rec, n=2, now=2.3)
    tel.record_spec(rec, proposed=4, accepted=2, dur_s=0.2)
    tel.record_finish(rec, n_tokens=5, now=2.5)
    return rec


def _clamp(M):
    tel = M.EngineTelemetry("d")
    rec = tel.record_enqueue(8, now=5.0,
                             ctx=M.TraceContext(trace_id="b" * 16))
    rec["engine_enqueue"] = 1e6          # wildly out of window
    tel.record_admit(rec, bucket=16, slot=0, now=5.5)
    tel.record_first_token(rec, now=6.0)
    tel.record_finish(rec, n_tokens=2, now=6.5)
    return rec


def _chunked(M):
    tel = M.EngineTelemetry("dep0")
    rec = tel.record_enqueue(96, now=1.0, tenant="a",
                             ctx=M.TraceContext(origin="router",
                                                trace_id="c" * 16),
                             engine_now=1.2)
    tel.record_requeue(rec, need=3, reason="pool_exhausted", now=1.3)
    tel.record_admit(rec, bucket=32, slot=0, now=1.5)
    tel.record_prefill_chunk(rec, 1.5, 1.6, tokens=32, bucket=32)
    tel.record_prefill_chunk(rec, 1.8, 1.9, tokens=32, bucket=32,
                             last=True)
    tel.record_first_token(rec, now=2.0)
    tel.record_token(rec, n=2, now=2.3)
    tel.record_finish(rec, n_tokens=3, now=2.5)
    return rec


def _chunk_clamp(M):
    tel = M.EngineTelemetry("d")
    rec = tel.record_enqueue(64, now=1.0, engine_now=1.0,
                             ctx=M.TraceContext(trace_id="d" * 16))
    tel.record_admit(rec, bucket=32, slot=0, now=1.5)
    tel.record_prefill_chunk(rec, 1.4, 1.7, tokens=32, bucket=32)
    tel.record_prefill_chunk(rec, 1.9, 2.2, tokens=32, bucket=32,
                             last=True)
    tel.record_first_token(rec, now=2.0)
    tel.record_finish(rec, n_tokens=2, now=2.5)
    return rec


def _handoff(M):
    ctx = M.TraceContext(origin="router", trace_id="e" * 16)
    ctx.span("router.route", 0.5, 1.0, replica="fleet/p0",
             policy="disagg_prefill", tenant="a", router_req=7)
    tel = M.EngineTelemetry("fleet/d0", role="decode")
    rec = tel.record_enqueue_handoff(
        {"prompt_len": 12, "enqueue": 1.0, "engine_enqueue": 1.2,
         "admit": 1.5, "first_token": 2.0, "bucket": 16,
         "tenant": "a", "ctx": ctx}, now=2.05)
    tel.record_kv_handoff(rec, 2.0, 2.2, blocks=2, nbytes=4096,
                          path="staged")
    tel.record_admit_handoff(rec, slot=0, now=2.2)
    tel.record_token(rec, now=2.4)
    tel.record_finish(rec, n_tokens=3, now=2.5)
    return rec


def _handoff_clamp(M):
    tel = M.EngineTelemetry("d", role="decode")
    rec = tel.record_enqueue_handoff(
        {"prompt_len": 12, "enqueue": 1.0, "engine_enqueue": 1.2,
         "admit": 1.5, "first_token": 2.0,
         "ctx": M.TraceContext(trace_id="f" * 16)}, now=2.0)
    tel.record_kv_handoff(rec, 1.8, 3.0, blocks=1, nbytes=64,
                          path="fast")
    tel.record_admit_handoff(rec, slot=0, now=2.1)
    tel.record_finish(rec, n_tokens=2, now=2.5)
    return rec


RECORDS = {"plain": _plain, "clamp": _clamp, "chunked": _chunked,
           "chunk_clamp": _chunk_clamp, "handoff": _handoff,
           "handoff_clamp": _handoff_clamp}
#: the reference's pinned numbers (tests/test_tracebus.py)
PINNED = {"plain": dict(e2e_ms=1500.0, router_wait_ms=200.0,
                        requeue_ms=200.0, prefill_ms=500.0,
                        spec_rollback_ms=80.0),
          "chunked": dict(e2e_ms=1500.0, prefill_ms=200.0,
                          prefill_wait_ms=300.0),
          "chunk_clamp": dict(prefill_ms=300.0, prefill_wait_ms=200.0),
          "handoff": dict(e2e_ms=1500.0, router_wait_ms=200.0,
                          queue_wait_ms=300.0, prefill_ms=500.0,
                          handoff_ms=200.0, inter_token_ms=300.0),
          "handoff_clamp": dict(handoff_ms=500.0, inter_token_ms=0.0)}


@pytest.mark.parametrize("kind", list(RECORDS))
def test_critical_path_equals_jax(kind):
    cp = T.critical_path(RECORDS[kind](T))
    assert cp == JT.critical_path(RECORDS[kind](JT))
    assert T.CRITICAL_PATH_COMPONENTS == JT.CRITICAL_PATH_COMPONENTS
    assert all(v >= 0.0 for v in cp.values())
    comp_sum = sum(cp[k] for k in T.CRITICAL_PATH_COMPONENTS)
    assert comp_sum == pytest.approx(cp["e2e_ms"], abs=1e-9)
    for k, v in PINNED.get(kind, {}).items():
        assert cp[k] == pytest.approx(v), k


def _snapshots():
    out = []
    for kind, make in RECORDS.items():
        snap = T.request_snapshot(make(T), deployment="dep0")
        snap["replica"] = "fleet/d0" if "handoff" in kind else "dep0"
        out.append(snap)
    return out


_PROGRAMS = {"invokes": {"serve.paged_prefill": [[1.85, 0.04]],
                         "serve.prefill": [[1.95, 0.3], [5.9, 0.1]],
                         "serve.decode": [[2.2, 0.01]]},
             "compiles": {"serve.prefill": [[1.99, 0.2]]}}


@pytest.mark.parametrize("kind", ["plain", "chunked", "handoff"])
def test_span_trees_equal_jax(kind):
    """One snapshot through both modules: the same span tree, and the
    same device dispatch parented under the same prefill span."""
    snap = _snapshots()[list(RECORDS).index(kind)]
    got = TB.attach_device_spans(TB.build_request_spans(snap), snap,
                                 _PROGRAMS)
    assert got == JTB.attach_device_spans(
        JTB.build_request_spans(snap), snap, _PROGRAMS)
    by_id = {s["span_id"]: s for s in got}
    root = next(s for s in got if s["parent_id"] is None)
    for s in got:
        assert s["parent_id"] is None or s["parent_id"] in by_id
        assert s["end"] >= s["start"] >= 0.0
    pf = [s for s in got if s["name"] == "engine.prefill"]
    assert pf and all(by_id[s["parent_id"]] is root for s in pf)
    dev = [s for s in got if s["name"].startswith("device ")]
    if kind != "handoff":
        assert len(dev) == 1 and by_id[dev[0]["parent_id"]] in pf


def test_component_spans_pin_both_ways():
    """Every critical-path component has an entry, and every named span
    is emitted by build_request_spans on some record."""
    assert set(TB.COMPONENT_SPANS) == set(T.CRITICAL_PATH_COMPONENTS)
    assert TB.COMPONENT_SPANS == JTB.COMPONENT_SPANS
    snaps = _snapshots()
    tel = T.EngineTelemetry("d")
    rec = tel.record_enqueue(8, now=1.0, engine_now=1.5)
    tel.record_kv_fetch(rec, 1.6, 1.7, blocks=1, tokens=16, bytes=64)
    tel.record_admit(rec, bucket=16, slot=0, now=1.8)
    tel.record_first_token(rec, now=2.0)
    tel.record_finish(rec, n_tokens=1, now=2.1)
    snaps.append(T.request_snapshot(rec, deployment="d"))
    names = {s["name"] for snap in snaps
             for s in TB.build_request_spans(snap)}
    for comp, span in TB.COMPONENT_SPANS.items():
        assert span is None or span in names, (comp, span)


def test_document_renderings_equal_jax(tmp_path):
    """The table, the lines, the evidence and the chrome trace of one
    document of the six snapshots are JAX's."""
    doc = {"version": 1, "source": "t", "clock": "perf_counter",
           "requests": _snapshots(), "programs": _PROGRAMS,
           "flightrec": {"router": {"t0": 0.0, "events": [
               {"kind": "route", "ts": 0.9, "t_s": 0.9, "req": 7}]}},
           "latency_anatomy": None}
    for pct in (50.0, 99.0):
        assert TB.critical_path_table(doc, pct) == \
            JTB.critical_path_table(doc, pct)
        assert TB.critical_path_lines(doc, pct, "a") == \
            JTB.critical_path_lines(doc, pct, "a")
    assert TB.report_lines(doc) == JTB.report_lines(doc)
    assert TB.request_evidence(doc) == JTB.request_evidence(doc)
    for rid in ("a" * 8, "dep0:" + str(doc["requests"][1]["id"]), "zz"):
        assert TB.trace_lines(doc, rid) == JTB.trace_lines(doc, rid)
    assert TB.chrome_trace(doc) == JTB.chrome_trace(doc)


# ---------------------------------------------------------------------------
# a nano fleet's dump
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def fleet_dump(tmp_path_factory):
    from ray_tpu_torch.serve.traffic import (TenantSpec, TrafficSpec,
                                             run_traffic_fleet)

    tenants = (TenantSpec("interactive", prefix_groups=(0,)),
               TenantSpec("batch", slo_class="batch", prefix_groups=(1,)))
    spec = TrafficSpec(num_requests=8, seed=0, rate_rps=100.0,
                       num_prefix_groups=2, prefix_len=32, p_shared=0.75,
                       tail_len_mean=6.0, tail_len_max=16, vocab=500,
                       tenants=tenants)
    path = str(tmp_path_factory.mktemp("tracebus") / "dump.json")
    rep = run_traffic_fleet(
        spec, num_replicas=2, family="gpt2", preset="nano",
        kv_block_size=16, max_slots=2, max_new_tokens=4,
        prefill_bucket=16, time_scale=0.0, device="cpu",
        config_overrides={"dtype": torch.float32}, trace_dump=path)
    return rep, path


def test_fleet_dump_stitches_router_engine_device(fleet_dump):
    rep, path = fleet_dump
    assert rep["completed"] == 8
    assert rep["itl_ms_p50"] <= rep["itl_ms_p99"]
    doc = TB.load_dump(path)
    reqs = [r for r in doc["requests"] if r.get("critical_path")]
    assert len(reqs) == 8
    assert len({r["replica"] for r in doc["requests"]}) == 2
    assert "router" in doc["flightrec"] and len(doc["flightrec"]) == 3
    stitched = 0
    for req in reqs:
        spans = TB.attach_device_spans(TB.build_request_spans(req), req,
                                       doc["programs"])
        by_id = {s["span_id"]: s for s in spans}
        route = next(s for s in spans if s["name"] == "router.route")
        root = by_id[route["parent_id"]]
        assert root["parent_id"] is None
        prefill = next(s for s in spans if s["name"] == "engine.prefill")
        assert by_id[prefill["parent_id"]] is root
        dev = next((s for s in spans if s["name"].startswith("device ")),
                   None)
        if dev is not None:
            assert by_id[dev["parent_id"]] is prefill
            stitched += 1
    assert stitched > 0


def test_fleet_dump_critical_path_within_5pct(fleet_dump):
    _, path = fleet_dump
    doc = TB.load_dump(path)
    for req in doc["requests"]:
        cp = req["critical_path"]
        comp_sum = sum(cp[k] for k in T.CRITICAL_PATH_COMPONENTS)
        assert abs(comp_sum - cp["e2e_ms"]) <= 0.05 * cp["e2e_ms"]
    table = TB.critical_path_table(doc, 99.0)
    assert table["requests"] == 8 and table["exemplar"] is not None
    assert table == JTB.critical_path_table(doc, 99.0)


def _cli(main, argv, capsys):
    rc = main(argv)
    return rc, capsys.readouterr().out


def test_cli_subcommands_match_jax(fleet_dump, tmp_path, capsys):
    _, path = fleet_dump
    doc = TB.load_dump(path)
    rid = next(r["request"] for r in doc["requests"])
    for argv in (["report", path], ["trace", path, rid[:8]],
                 ["critical-path", path, "--percentile", "99"],
                 ["critical-path", path, "--tenant", "batch"],
                 ["trace", path, "veryunknown"]):
        got = _cli(TB.main, argv, capsys)
        assert got == _cli(JTB.main, argv, capsys), argv
    assert _cli(TB.main, ["trace", path, "veryunknown"], capsys)[0] == 1
    out = str(tmp_path / "merged.json")
    assert _cli(TB.main, ["export", path, "-o", out], capsys)[0] == 0
    with open(out) as f:
        events = json.load(f)
    assert events == JTB.chrome_trace(doc)
    lanes = {e["args"]["name"] for e in events
             if e.get("name") == "process_name"}
    assert sum(n.startswith("replica ") for n in lanes) == 2


def test_unreadable_dump_exits_2(tmp_path, capsys):
    bad = tmp_path / "bad.json"
    bad.write_text("{}")
    for argv in (["report", str(bad)],
                 ["report", str(tmp_path / "missing.json")]):
        assert TB.main(argv) == JTB.main(argv) == 2
    capsys.readouterr()
