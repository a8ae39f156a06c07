"""The port's operator CLIs against the JAX package's, on the CPU:
``tools/perfledger.py`` (with ``python -m ray_tpu_torch.bench``'s
append), ``tools/kvscope.py`` and ``tools/incidents.py``.

The cases are those of tests/test_perf_observatory.py's perfledger
section, tests/test_kvscope.py's CLI section and the incidents part of
tests/test_healthwatch.py's chaos test, run on the port's modules; each
is also held to the JAX tool on the same file (the JAX tools read the
port's ledger lines, snapshots and dumps: the formats are shared).

Every ledger here is a ``tmp_path`` file (``--history`` or
``RAYTPU_BENCH_HISTORY``): the repo's ``BENCH_HISTORY.jsonl`` and
``BASELINE.json`` are the JAX package's and must be left as they are,
which the bench test checks byte for byte.
"""

import contextlib
import hashlib
import io
import json
import os
import random
from pathlib import Path

import pytest
import torch

from ray_tpu.tools import incidents as jinc
from ray_tpu.tools import kvscope as jkv
from ray_tpu.tools import perfledger as jpl
from ray_tpu_torch.tools import incidents as tinc
from ray_tpu_torch.tools import kvscope as tkv
from ray_tpu_torch.tools import perfledger as tpl

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def fresh_provenance(monkeypatch):
    """The stamp is cached per process: each test reads it anew (torch
    is imported, and this process never initialises CUDA)."""
    monkeypatch.setattr(tpl, "_provenance_cache", None)


def _bench_rec(value, metric="obs_tokens_per_sec"):
    return {"metric": metric, "value": value, "unit": "tok/s",
            "vs_baseline": None, "detail": {}}


def _quiet(fn, *args, **kw):
    """fn's return value and what it printed."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = fn(*args, **kw)
    return rc, out.getvalue()


# ---------------------------------------------------------------------------
# perfledger (tests/test_perf_observatory.py:250-348 on the port)
# ---------------------------------------------------------------------------

def test_perfledger_verdicts_improve_flat_regress(tmp_path):
    hist = str(tmp_path / "hist.jsonl")
    for value, verdict in ((100.0, "new"), (101.0, "flat"),
                           (120.0, "improve"), (80.0, "regress")):
        tpl.append_records([_bench_rec(value)], "bench", path=hist)
        result = tpl.check(hist)
        assert result["verdicts"]["obs_tokens_per_sec"]["verdict"] \
            == verdict
        assert result == jpl.check(hist)
    assert result["ok"] is False


def test_perfledger_latency_direction(tmp_path):
    hist = str(tmp_path / "hist.jsonl")
    for v in (10.0, 20.0):
        tpl.append_records([_bench_rec(v, metric="obs_prefill_ttft_ms")],
                           "bench", path=hist)
    assert tpl.check(hist)["verdicts"][
        "obs_prefill_ttft_ms"]["verdict"] == "regress"
    for name in jpl._SWEEP_FIELDS + ("obs_prefill_ttft_ms", "x_mfu"):
        assert tpl.higher_is_better(name) == jpl.higher_is_better(name)
        assert tpl.explicit_direction(name) == \
            jpl.explicit_direction(name)


def test_perfledger_check_cli_exit_codes(tmp_path):
    """``python -m ray_tpu_torch.tools.perfledger check`` exits nonzero
    on a fixture regression (and zero when clean), printing the JAX
    CLI's verdicts."""
    hist = str(tmp_path / "hist.jsonl")
    tpl.append_records([_bench_rec(100.0)], "bench", path=hist)
    tpl.append_records([_bench_rec(100.0)], "bench", path=hist)
    assert _quiet(tpl.main, ["--history", hist, "check"])[0] == 0
    tpl.append_records([_bench_rec(50.0)], "bench", path=hist)
    rc, out = _quiet(tpl.main, ["--history", hist, "check"])
    assert rc == 1
    assert (rc, out) == _quiet(jpl.main, ["--history", hist, "check"])


def test_perfledger_ingest_sweepjson_and_wrappers(tmp_path):
    sweep = {"sweep": {"mode": "train", "batch_per_chip": 8,
                       "overrides": {}},
             "tok_s_chip": 500.0, "mfu": 0.2, "chips": 8}
    wrapper = {"n": 5, "cmd": "python bench.py",
               "parsed": _bench_rec(77.0)}
    text = ("human noise line\n"
            "SWEEPJSON " + json.dumps(sweep) + "\n"
            + json.dumps(_bench_rec(42.0)) + "\n")
    recs = tpl.parse_text(text)
    assert recs == jpl.parse_text(text) and len(recs) == 2
    recs += tpl.parse_text(json.dumps(wrapper, indent=1))
    assert len(recs) == 3
    hist = str(tmp_path / "hist.jsonl")
    assert tpl.append_records(recs, "ingest", path=hist) == 3
    series = tpl.metric_series(tpl.load_history(hist))
    assert "obs_tokens_per_sec" in series
    assert any(k.startswith("sweep.train.tok_s_chip") for k in series)
    assert series == jpl.metric_series(jpl.load_history(hist))
    # the CLI's ingest: a log file through main
    log = tmp_path / "bench.log"
    log.write_text(text)
    rc, out = _quiet(tpl.main, ["--history", hist, "ingest", str(log)])
    assert rc == 0 and "appended 2 record(s)" in out
    assert len(tpl.load_history(hist)) == 5


def test_perfledger_variant_series_do_not_mix(tmp_path):
    """Different sweep variants form different series: a b24 point
    never gates a b32 point."""
    hist = str(tmp_path / "hist.jsonl")
    a = {"sweep": {"mode": "train", "batch_per_chip": 24,
                   "overrides": {}}, "tok_s_chip": 900.0}
    b = {"sweep": {"mode": "train", "batch_per_chip": 32,
                   "overrides": {}}, "tok_s_chip": 100.0}
    tpl.append_records([a, b], "sweep", path=hist)
    result = tpl.check(hist)
    assert all(v["verdict"] == "new"
               for v in result["verdicts"].values())
    assert result["ok"] and len(result["verdicts"]) == 2
    assert result == jpl.check(hist)


def test_perfledger_report_renders(tmp_path):
    hist = str(tmp_path / "hist.jsonl")
    tpl.append_records([_bench_rec(100.0)], "bench", path=hist)
    tpl.append_records([_bench_rec(80.0)], "bench", path=hist)
    text = tpl.report(hist)
    assert "obs_tokens_per_sec" in text
    assert "regress" in text
    assert "REGRESSIONS DETECTED" in text
    assert text == jpl.report(hist)
    out = tmp_path / "report.md"
    rc, printed = _quiet(tpl.main, ["--history", hist, "report", "--out",
                                    str(out)])
    assert rc == 0 and out.read_text() == text + "\n" == printed


def test_perfledger_default_history_is_the_ports_own(monkeypatch,
                                                     tmp_path):
    """The port never appends to the JAX package's BENCH_HISTORY.jsonl:
    its default is its own file at the repo root (gitignored), and
    RAYTPU_BENCH_HISTORY overrides it."""
    monkeypatch.delenv("RAYTPU_BENCH_HISTORY", raising=False)
    default = tpl.history_path()
    assert os.path.basename(default) == "BENCH_HISTORY_TORCH.jsonl"
    assert os.path.basename(default) != "BENCH_HISTORY.jsonl"
    assert os.path.dirname(default) == str(ROOT)
    assert tpl.history_path() != jpl.history_path()
    ignored = (ROOT / ".gitignore").read_text().split()
    assert "BENCH_HISTORY_TORCH.jsonl" in ignored
    assert tpl.baseline_path() == str(ROOT / "BASELINE.json")
    monkeypatch.setenv("RAYTPU_BENCH_HISTORY", str(tmp_path / "h.jsonl"))
    assert tpl.history_path() == str(tmp_path / "h.jsonl")
    assert tpl.history_path(str(tmp_path / "x")) == str(tmp_path / "x")


def test_perfledger_provenance_names_torch(tmp_path):
    prov = tpl.provenance()
    assert set(prov) == {"git_sha", "torch_version", "cuda_version",
                         "backend", "device_kind", "hostname"}
    assert prov["torch_version"] == str(torch.__version__)
    # this process never initialised CUDA
    assert prov["backend"] == "cpu" and prov["device_kind"] is None
    hist = str(tmp_path / "hist.jsonl")
    tpl.append_records([_bench_rec(1.0)], "bench", path=hist)
    (entry,) = tpl.load_history(hist)
    assert entry["provenance"] == prov
    assert tpl.entry_backend(entry) == "cpu"


def test_perfledger_publish_never_writes_the_repo_baseline(tmp_path):
    hist = str(tmp_path / "hist.jsonl")
    tpl.append_records([_bench_rec(100.0)], "bench", path=hist)
    before = (ROOT / "BASELINE.json").read_bytes()
    with pytest.raises(ValueError, match="read, never written"):
        tpl.publish("latest", history=hist, allow_cpu=True)
    # a dry run computes the diff against it without writing
    res = tpl.publish("latest", history=hist, allow_cpu=True, dry_run=True)
    assert res["diff"] == {"obs_tokens_per_sec": {"old": None,
                                                  "new": 100.0}}
    assert not res["written"]
    base = str(tmp_path / "baseline.json")
    with pytest.raises(ValueError, match="CPU backend"):
        tpl.publish("latest", history=hist, baseline=base)
    res = tpl.publish("latest", history=hist, baseline=base,
                      allow_cpu=True)
    assert res["written"] and json.loads(Path(base).read_text()) == {
        "published": {"obs_tokens_per_sec": 100.0}}
    # the published bar arms check's baseline verdict
    tpl.append_records([_bench_rec(50.0)], "bench", path=hist)
    v = tpl.check(hist, base)["verdicts"]["obs_tokens_per_sec"]
    assert v["baseline_verdict"] == "regress"
    rc, _ = _quiet(tpl.main, ["--history", hist, "publish"])
    assert rc == 2
    assert (ROOT / "BASELINE.json").read_bytes() == before


def _digest(path: Path):
    return hashlib.sha256(path.read_bytes()).hexdigest() \
        if path.exists() else None


def test_bench_appends_to_the_ports_ledger(monkeypatch, tmp_path):
    """``ray_tpu_torch.bench``'s ledger append (bench.py:195's for the
    JAX package): every metric line of the run lands in the ledger
    RAYTPU_BENCH_HISTORY names, source "bench", stamped with the
    port's provenance; --no-ledger appends nothing; the repo's
    BENCH_HISTORY.jsonl, BASELINE.json and the port's default ledger
    are untouched."""
    from ray_tpu_torch import bench as tbench

    files = [ROOT / "BENCH_HISTORY.jsonl", ROOT / "BASELINE.json",
             ROOT / tpl.HISTORY_FILE]
    before = [_digest(f) for f in files]
    hist = tmp_path / "hist.jsonl"
    monkeypatch.setenv("RAYTPU_BENCH_HISTORY", str(hist))
    argv = ["--decode", "--new-tokens", "2"]
    err = io.StringIO()
    with contextlib.redirect_stdout(io.StringIO()), \
            contextlib.redirect_stderr(err):
        tbench.main(tbench.parse_args(argv), device="cpu")
    entries = tpl.load_history(str(hist))
    assert [e["record"]["metric"] for e in entries] == [
        "gpt2_decode_cpu_smoke_prefill_ttft_ms",
        "gpt2_decode_cpu_smoke_tokens_per_sec",
        "gpt2_decode_cpu_smoke_tokens_per_sec_per_chip"]
    assert all(e["source"] == "bench" and e["metrics"] for e in entries)
    assert entries[0]["provenance"]["backend"] == "cpu"
    assert f"3 record(s) appended to {hist}" in err.getvalue()
    with contextlib.redirect_stdout(io.StringIO()):
        tbench.main(tbench.parse_args([*argv, "--no-ledger"]),
                    device="cpu")
    assert len(tpl.load_history(str(hist))) == 3
    assert tpl.check(str(hist))["ok"]
    assert [_digest(f) for f in files] == before


def test_bench_autopilot_still_raises_naming_item_7_12(tmp_path,
                                                        monkeypatch):
    """Item 7.12 is ported: ``--autopilot`` no longer raises; it emits
    ``{"autopilot": attribute_registry()}`` before the ledger append
    (bench.py:179-200), naming bench.train_step with a class and a
    headroom, and the line rides into the ledger."""
    import contextlib
    import io

    from ray_tpu_torch import bench as tbench
    from ray_tpu_torch._private import device_stats as tds

    assert not hasattr(tbench, "AUTOPILOT_ITEM")
    hist = tmp_path / "hist.jsonl"
    monkeypatch.setenv("RAYTPU_BENCH_HISTORY", str(hist))
    # the cost harvest on (tests/conftest.py turns it off by default),
    # and a registry of this run's programs alone
    monkeypatch.setenv("RAYTPU_DEVICE_STATS_COST", "1")
    monkeypatch.setattr(tds, "_registry", tds.ProgramRegistry())
    out = io.StringIO()
    with contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()):
        tbench.main(tbench.parse_args(["--autopilot", "--steps", "1",
                                        "--preset", "nano"]),
                    device="cpu")
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    att = line["autopilot"]
    block = att["programs"]["bench.train_step"]
    assert block["class"] in ("compute-bound", "hbm-bound")
    assert block["headroom"] is not None
    assert att["bottleneck"] == "bench.train_step"
    assert tpl.load_history(str(hist))


# ---------------------------------------------------------------------------
# kvscope (tests/test_kvscope.py:517-560 on the port)
# ---------------------------------------------------------------------------

def _snapshot_doc():
    """A kv_scope block from the port's serve/kvscope.py."""
    from ray_tpu_torch.serve.kvscope import KVScope, hbm_ledger

    scope = KVScope(num_blocks=8, block_size=4, enabled=True)
    scope.sample([1, 2, 3], cached=2)
    scope.sample([1], cached=3)
    scope.note_register((1, 2, 3, 4), "alpha")
    scope.note_evict((1, 2, 3, 4))
    scope.note_register((1, 2, 3, 4), "alpha")
    blk = scope.stats(free=1, cached=3, prefill_tokens=64)
    blk["hbm_ledger"] = hbm_ledger(
        pool_bytes_per_chip=256, program_budget_bytes=64,
        device_stats=[{"id": 0, "platform": "cuda",
                       "bytes_limit": 4096, "bytes_in_use": 1024,
                       "peak_bytes_in_use": 2048}])
    return blk


def test_kvscope_cli_report_timeline_export(tmp_path):
    snap = tmp_path / "snap.json"
    # dashboard-map form: {deployment: {"kv_scope": block}}
    snap.write_text(json.dumps({"llm": {"kv_scope": _snapshot_doc()}}))
    for cmd in ("report", "timeline"):
        rc, out = _quiet(tkv.main, [cmd, str(snap)])
        assert rc == 0 and out
        assert (rc, out) == _quiet(jkv.main, [cmd, str(snap)])
    out = str(tmp_path / "trace.json")
    assert _quiet(tkv.main, ["export", str(snap), "-o", out])[0] == 0
    with open(out) as f:
        events = json.load(f)
    assert events == jkv.chrome_trace(jkv.load_snapshot(str(snap)))
    counters = [e for e in events if e.get("ph") == "C"]
    assert counters, events
    names = {e["name"] for e in counters}
    assert names == {"kv blocks", "kv occupancy", "kv fragmentation"}
    # counter lanes conserve the pool too
    for e in counters:
        if e["name"] == "kv blocks":
            assert e["args"]["in_use"] + e["args"]["cached"] \
                + e["args"]["free"] == 8
    # unreadable snapshot -> exit 2, not a traceback
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"requests": []}))
    with contextlib.redirect_stderr(io.StringIO()):
        assert tkv.main(["report", str(bad)]) == 2


def test_kvscope_load_snapshot_accepts_all_forms(tmp_path):
    blk = _snapshot_doc()
    forms = {"bare": (blk, ["engine"]),
             "eng": ({"deployment": "llm_gpt2_nano", "kv_scope": blk},
                     ["llm_gpt2_nano"]),
             "dash": ({"a": {"kv_scope": blk}, "b": {"error": "down"}},
                      ["a"])}
    for name, (doc, keys) in forms.items():
        path = tmp_path / f"{name}.json"
        path.write_text(json.dumps(doc))
        assert list(tkv.load_snapshot(str(path))) == keys
        assert tkv.load_snapshot(str(path)) == jkv.load_snapshot(str(path))
        assert tkv.report_lines(tkv.load_snapshot(str(path))) == \
            jkv.report_lines(jkv.load_snapshot(str(path)))


# ---------------------------------------------------------------------------
# incidents (tests/test_healthwatch.py:370-395 on the port)
# ---------------------------------------------------------------------------

FROZEN = "t_chaos/r1"


def _chaos_dump(path, t0s=None, shift=0.0):
    """A tracebus dump of a two-replica fleet whose replica 1 froze,
    journaled by the port's HealthMonitor and flight recorders on an
    injected clock (``shift`` plus the times below): the fault, SUSPECT
    then DEAD (detected 110 ms after the fault), two queued requests
    requeued off the dead replica, a stall on it, an SLO burn window on
    the router opened and closed around the incident, a scale-up
    decision inside it, and the recovery heartbeat.  ``t0s`` maps each
    lane ("router" and the replicas) to its recorder's origin; None
    gives every lane the origin 0.0."""
    from ray_tpu_torch._private.flightrec import FlightRecorder
    from ray_tpu_torch.serve.health import HealthConfig, HealthMonitor
    from ray_tpu_torch.tools import tracebus

    def at(s):
        return shift + s

    router = FlightRecorder("t_chaos", capacity=256, enabled=True)
    reps = {n: FlightRecorder(n, capacity=256, enabled=True)
            for n in ("t_chaos/r0", FROZEN)}
    for lane, rec in (("router", router), *reps.items()):
        rec.t0 = 0.0 if t0s is None else t0s[lane]
    m = HealthMonitor(HealthConfig(suspect_ms=30.0, dead_ms=90.0),
                      deployment="t_chaos", recorder=router, enabled=True)
    for name, rec in reps.items():
        m.register(name, recorder=rec, now=at(0.0))
        m.heartbeat(name, now=at(0.0))
    m.note_fault(FROZEN, kind="freeze", now=at(0.01))
    router.record("slo_breach", ts=at(0.02), objective="ttft",
                  burn_rate=3.5, target_ms=5.0)
    m.heartbeat("t_chaos/r0", now=at(0.05))
    m.probe(now=at(0.05))
    reps[FROZEN].record("request_stall", ts=at(0.06), req=7,
                        replica=FROZEN, silent_ms=50.0)
    m.heartbeat("t_chaos/r0", now=at(0.12))
    m.probe(now=at(0.12))
    for req in (11, 12):
        reps[FROZEN].record("requeue", ts=at(0.125), req=req,
                            reason="replica_dead")
    m.note_requeued(2)
    router.record("scale_up", ts=at(0.13), replicas=3, reason="slo_burn")
    router.record("slo_recover", ts=at(0.3), objective="ttft",
                  burn_rate=0.5, target_ms=5.0)
    m.heartbeat(FROZEN, now=at(0.4))
    doc = {"version": tracebus.DUMP_VERSION, "source": "t_chaos",
           "clock": "perf_counter", "requests": [],
           "flightrec": {"router": tracebus._abs_events(router),
                         **{n: tracebus._abs_events(r)
                            for n, r in reps.items()}}}
    tracebus.write_dump(doc, path)
    return m, router


def test_incidents_name_the_frozen_replica_and_its_detection(tmp_path):
    """The digest, timeline and export, each held to the JAX tool's on
    one dump whose lanes share one origin (where the JAX tool's twin
    dedup is exact; lanes of their own origins are the next test's)."""
    dump_path = str(tmp_path / "chaos_dump.json")
    monitor, _ = _chaos_dump(dump_path)
    ttd = monitor.time_to_detect_ms
    assert ttd == pytest.approx(110.0)

    doc = tinc.load(dump_path)
    events = tinc.merge_events(doc)
    assert events == jinc.merge_events(jinc.load(dump_path))
    incs = tinc.extract_incidents(events)
    assert incs == jinc.extract_incidents(events)
    (inc,) = [i for i in incs if i["replica"] == FROZEN]
    assert inc["fault_kind"] == "freeze"
    assert inc["suspect_t"] is not None and inc["dead_t"] is not None
    assert inc["time_to_detect_ms"] == pytest.approx(ttd)
    assert inc["requeued"] == 2 == monitor.requeued_on_death
    assert inc["stalls"] == 1 and inc["affected"] == [7, 11, 12]
    # the transitions journal to the router's lane and the replica's
    # own: the twins count once
    assert inc["transitions"] == 3 == \
        len(monitor.replica_block(FROZEN)["transition_log"])
    wins = tinc.burn_windows(events)
    assert wins == jinc.burn_windows(events)
    assert [(w["lane"], w["objective"]) for w in wins] == \
        [("router", "ttft")]
    assert wins[0]["end"] is not None

    # the CLI report names the sick replica, its detection latency and
    # the burn window, line for line the JAX CLI's
    rc, text = _quiet(tinc.main, ["report", dump_path])
    assert rc == 0
    assert (rc, text) == _quiet(jinc.main, ["report", dump_path])
    assert FROZEN in text
    assert "fault injected: freeze" in text
    assert f"time_to_detect_ms={inc['time_to_detect_ms']}" in text
    assert "slo burn window" in text
    assert "requeued_on_death=2" in text
    assert "scale_up" in text

    # timeline: the merged chronological stream
    rc, text = _quiet(tinc.main, ["timeline", dump_path])
    assert rc == 0
    assert (rc, text) == _quiet(jinc.main, ["timeline", dump_path])
    assert "health_transition" in text and "fault_injected" in text

    # export: a chrome-trace incident lane at pid 95, merged into an
    # existing timeline
    base = str(tmp_path / "base.json")
    Path(base).write_text(json.dumps([{"name": "x", "ph": "i", "ts": 0,
                                       "pid": 1, "tid": 0}]))
    trace_path = str(tmp_path / "incidents_trace.json")
    assert _quiet(tinc.main, ["export", dump_path, "-o", trace_path,
                              "--merge", base])[0] == 0
    with open(trace_path) as f:
        trace = json.load(f)
    assert trace == jinc.trace_events(jinc.load(dump_path),
                                      merge=json.loads(Path(base)
                                                       .read_text()))
    assert trace[0]["name"] == "x"
    assert any(e.get("ph") == "i" and e.get("pid") == 95 for e in trace)


@pytest.mark.parametrize("seed", range(4))
def test_incident_twins_count_once_on_each_lanes_own_clock(tmp_path, seed):
    """Real dumps give each lane its recorder's own origin, so a
    transition's two copies can come back a microsecond apart: over 32
    seeded layouts of origins and clock, the frozen replica's digest
    counts the monitor's transitions once each, with its detection
    latency, requeues, stall and affected requests."""
    rng = random.Random(seed)
    path = str(tmp_path / "chaos_dump.json")
    for _ in range(32):
        shift = rng.uniform(100.0, 10_000.0)
        t0s = {lane: shift - rng.uniform(0.0, 1.0)
               for lane in ("router", "t_chaos/r0", FROZEN)}
        monitor, _ = _chaos_dump(path, t0s=t0s, shift=shift)
        log = monitor.replica_block(FROZEN)["transition_log"]
        incs = tinc.extract_incidents(tinc.merge_events(tinc.load(path)))
        (inc,) = [i for i in incs if i["replica"] == FROZEN]
        assert inc["transitions"] == len(log) == 3, (shift, t0s, inc)
        assert inc["time_to_detect_ms"] == \
            pytest.approx(monitor.time_to_detect_ms)
        assert inc["requeued"] == 2 and inc["stalls"] == 1
        assert inc["affected"] == [7, 11, 12]
        _, text = _quiet(tinc.main, ["report", path])
        assert "transitions=3 " in text


def test_incidents_read_a_flight_recorder_dump(tmp_path):
    """The other input form: one flight recorder's own dump
    (dump-relative t_s), the lane named by its source; a file that is
    neither form exits 2."""
    _, router = _chaos_dump(str(tmp_path / "unused.json"))
    router.dump_dir = str(tmp_path)
    path = router.dump(reason="incident")
    rc, text = _quiet(tinc.main, ["report", path])
    assert rc == 0
    assert (rc, text) == _quiet(jinc.main, ["report", path])
    assert FROZEN in text and "DEAD" in text
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"requests": []}))
    with contextlib.redirect_stderr(io.StringIO()):
        assert tinc.main(["report", str(bad)]) == 2
