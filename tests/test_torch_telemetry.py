"""The port's serving telemetry host modules against the JAX package's.

Each module of ``ray_tpu_torch`` that the serve engine's telemetry
reads is a copy of its ``ray_tpu`` counterpart.  Every test drives the
JAX copy and the port's with the same seeded call script on the same
fake clock and expects equal results: summaries and chrome events,
the flight recorder's snapshots and dumps, metric dumps,
``EngineTelemetry.engine_stats()`` after every ``record_*`` call, the
SLO tracker, the health monitor, the chaos injector, the admission
policy and the HBM ledger.  Only what names the device may differ (the
``device`` roofline block), and what is the process's own (paths,
pids, wall-clock stamps, random trace ids).
"""

import json
import random
import types
import warnings

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from ray_tpu._private import flightrec as jflightrec  # noqa: E402
from ray_tpu._private import telemetry as jcore  # noqa: E402
from ray_tpu.serve import batching as jbatching  # noqa: E402
from ray_tpu.serve import chaos as jchaos  # noqa: E402
from ray_tpu.serve import health as jhealth  # noqa: E402
from ray_tpu.serve import kvscope as jkvscope  # noqa: E402
from ray_tpu.serve import slo as jslo  # noqa: E402
from ray_tpu.serve import telemetry as jtele  # noqa: E402
from ray_tpu.util import metrics as jmetrics  # noqa: E402
from ray_tpu_torch._private import device_stats as tds  # noqa: E402
from ray_tpu_torch._private import flightrec as tflightrec  # noqa: E402
from ray_tpu_torch._private import telemetry as tcore  # noqa: E402
from ray_tpu_torch.serve import batching as tbatching  # noqa: E402
from ray_tpu_torch.serve import chaos as tchaos  # noqa: E402
from ray_tpu_torch.serve import health as thealth  # noqa: E402
from ray_tpu_torch.serve import kvscope as tkvscope  # noqa: E402
from ray_tpu_torch.serve import slo as tslo  # noqa: E402
from ray_tpu_torch.serve import telemetry as ttele  # noqa: E402
from ray_tpu_torch.util import metrics as tmetrics  # noqa: E402

JAX = types.SimpleNamespace(core=jcore, flightrec=jflightrec,
                            batching=jbatching, chaos=jchaos,
                            health=jhealth, kvscope=jkvscope, slo=jslo,
                            tele=jtele, metrics=jmetrics)
PORT = types.SimpleNamespace(core=tcore, flightrec=tflightrec,
                             batching=tbatching, chaos=tchaos,
                             health=thealth, kvscope=tkvscope, slo=tslo,
                             tele=ttele, metrics=tmetrics)
BOTH = pytest.mark.parametrize("seed", [0, 1, 2])


def _both(fn, *args):
    """fn(namespace, *args) on the JAX copy and the port's."""
    return fn(JAX, *args), fn(PORT, *args)


# ---------------------------------------------------------------------------
# _private/telemetry.py
# ---------------------------------------------------------------------------


@BOTH
def test_summarize_percentile_and_chrome_events(seed, tmp_path):
    rs = np.random.RandomState(seed)
    samples = [list(rs.exponential(10.0, n)) for n in (0, 1, 3, 17, 200)]

    def script(m, path):
        out = [m.core.summarize(s) for s in samples]
        out += [m.core.percentile(sorted(s), q) for s in samples if s
                for q in (1, 50, 95, 99, 100)]
        ev = [m.core.complete_event("a", "serve", 0.5, 0.25, 1, 2,
                                    {"k": 1}),
              m.core.complete_event("neg", "serve", 0.5, -1.0, 1, 0),
              m.core.instant_event("i", "serve", 1.5, 1, 3),
              m.core.process_name_event(1, "p"),
              m.core.thread_name_event(1, 2, "t")]
        m.core.write_chrome_trace(ev, str(path))
        return out, ev, json.loads(path.read_text())

    assert script(JAX, tmp_path / "j.json") == \
        script(PORT, tmp_path / "t.json")


# ---------------------------------------------------------------------------
# _private/flightrec.py
# ---------------------------------------------------------------------------


def _dump_view(path):
    doc = json.loads(open(path).read())
    for key in ("created", "uptime_s", "source"):
        doc.pop(key)
    return doc


@BOTH
def test_flight_recorder_snapshots_and_dumps(seed, tmp_path):
    kinds = ("admit", "step", "kv_evict", "finish", "shed")

    def script(m, d):
        rec = m.flightrec.FlightRecorder(f"fr{seed}", capacity=16)
        rec.t0 = 100.0
        rec.dump_dir = str(d)
        rng = random.Random(seed)
        for i in range(40):
            rec.record(rng.choice(kinds), ts=100.0 + i * 0.01, req=i,
                       n=rng.randint(0, 9))
        snap = rec.snapshot()
        path = rec.dump(reason="unit", context={"why": seed})
        off = m.flightrec.FlightRecorder("off", enabled=False)
        off.record("admit", req=1)
        return (snap, rec.counts_by_kind(), rec.recorded, rec.retained,
                rec.dropped, _dump_view(path), off.stats(),
                off.dump(reason="x"), path.startswith(str(d)))

    j, t = script(JAX, tmp_path / "j"), script(PORT, tmp_path / "t")
    assert j == t
    assert t[4] == 24 and t[-1]


def test_flight_recorder_env_knobs(monkeypatch, tmp_path):
    monkeypatch.setenv("RAYTPU_FLIGHTREC_DIR", str(tmp_path))
    assert tflightrec.default_dump_dir() == jflightrec.default_dump_dir() \
        == str(tmp_path)
    monkeypatch.setenv("RAYTPU_FLIGHTREC", "0")
    assert not tflightrec.FlightRecorder("x").enabled
    assert not jflightrec.FlightRecorder("x").enabled


# ---------------------------------------------------------------------------
# util/metrics.py
# ---------------------------------------------------------------------------


@BOTH
def test_metric_dumps(seed):
    rs = np.random.RandomState(seed)
    obs = rs.exponential(30.0, 50)

    def script(m):
        name = f"torch_parity_{seed}_{id(m)}"
        c = m.metrics.Counter(name + "_c", "c", tag_keys=("a",))
        g = m.metrics.Gauge(name + "_g", "g").set_default_tags({"d": "x"})
        h = m.metrics.Histogram(name + "_h", "h",
                                boundaries=(1.0, 10.0, 100.0),
                                tag_keys=("a",))
        empty = m.metrics.Histogram(name + "_e", "e", boundaries=(5.0,))
        for i, v in enumerate(obs):
            tag = {"a": str(i % 3)}
            c.inc(float(v), tags=tag)
            g.set(float(v))
            h.observe(float(v), tags=tag)
        with pytest.raises(ValueError):
            c.inc(-1.0)
        with pytest.raises(ValueError):
            m.metrics.Gauge("Bad-Name")
        snap = m.metrics._registry.snapshot()
        return [snap[name + s] for s in ("_c", "_g", "_h", "_e")] + \
            [empty._dump()]

    assert script(JAX) == script(PORT)


def test_metric_singletons_no_duplicate_warning():
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        for i in range(3):
            ttele.EngineTelemetry(f"t_torch_dup{i}", max_slots=1)
            tslo.SLOTracker(tslo.SLOConfig(ttft_ms=1.0),
                            ttele.EngineTelemetry(f"t_torch_slo{i}"))
            thealth.HealthMonitor()
            tds.ProgramRegistry()


# ---------------------------------------------------------------------------
# serve/telemetry.py
# ---------------------------------------------------------------------------


def _run_script(m, seed, tel=None):
    """Every record_* call of EngineTelemetry on a fake clock: plain,
    spec, chunked, requeued, tier-fetched, handed-off, rejected, shed,
    errored requests, program compiles and a storm, kv blocks and the
    fleet's route/scale/drain.  Returns the telemetry."""
    rng = random.Random(seed)
    tel = tel or m.tele.EngineTelemetry(f"t_script{seed}", max_slots=3,
                                        role="both")
    tel._t0 = 0.0
    tel.flightrec.t0 = 0.0
    t = [0.0]

    def now(dt=None):
        t[0] += rng.uniform(0.001, 0.02) if dt is None else dt
        return t[0]

    recs = []
    for _ in range(6):
        ts = now()
        recs.append(tel.record_enqueue(
            rng.randint(4, 64), now=ts, engine_now=ts,
            tenant=rng.choice([None, "a", "b"])))
    tel.record_program_compile("serve.prefill")
    tel.record_program_compile("serve.decode")
    tel.record_storm("serve.decode")
    tel.record_requeue(recs[0], need=4, reason="pool_exhausted", now=now())
    k0 = now()
    tel.record_kv_fetch(recs[0], k0, now(), blocks=2, tokens=32,
                        bytes=4096)
    tel.record_kv_reserve(recs[0], k0, now(), blocks=4, hit_blocks=1,
                          evicted=1)
    tel.note_kv_waste(recs[0], 16)
    tel.record_prefix_reuse(3, 1)
    tel.record_cow()
    for slot, r in enumerate(recs[:3]):
        tel.record_admit(r, slot, 16 * (1 + slot % 2), now=now())
    c0 = now()
    tel.record_prefill_chunk(recs[2], c0, now(), tokens=16, bucket=16)
    tel.record_prefill_chunk(recs[2], now(), now(), tokens=5, bucket=16,
                             last=True)
    for r in recs[:3]:
        tel.record_first_token(r, now=now())
    for _ in range(5):
        end = now()
        tel.record_step(3, rng.uniform(0.002, 0.01), now=end,
                        n_tokens=rng.randint(3, 9))
        for r in recs[:3]:
            tel.record_spec(r, proposed=4, accepted=rng.randint(0, 4),
                            dur_s=0.004)
            tel.record_token(r, n=rng.randint(1, 5), now=end)
    tel.record_kv_stats({"blocks_in_use": 7, "prefix_hit_rate": 0.5})
    tel.record_kv_scope(m.kvscope.empty_kv_scope())
    tel.record_kv_tier({"enabled": True, "bytes_resident": 10,
                        "hit_rate": 0.5, "tokens_restored": 32})
    tel.record_health(m.health.empty_health())
    tel.record_finish(recs[0], n_tokens=8, now=now())
    tel.record_handoff_out(recs[1], blocks=2, nbytes=2048, path="fast",
                           now=now())
    tel.record_error(recs[2], error="boom", now=now())
    tel.record_reject(recs[3], reason="prompt length 99", now=now(),
                      label="oversized")
    tel.record_reject(recs[4], reason="load shed: queue_full",
                      now=now(), label="shed_queue_full")
    meta = {"prompt_len": 20, "enqueue": now(), "engine_enqueue": t[0],
            "admit": now(), "first_token": now(), "bucket": 32,
            "requeues": 1, "tenant": "a"}
    h = tel.record_enqueue_handoff(meta, now=now())
    tel.record_admit_handoff(h, 0, now=now())
    tel.record_kv_handoff(h, meta["admit"], now(), blocks=2, nbytes=2048,
                          path="staged")
    tel.record_token(h, now=now())
    tel.record_finish(h, n_tokens=3, now=now())
    tel.record_route(0, "r0", "least_loaded")
    tel.record_scale("up", 1, 2, reason="burn")
    tel.record_drain("r0", ok=True)
    return tel


def _stats_view(stats):
    stats = dict(stats)
    stats.pop("uptime_s")
    stats.pop("device")
    return stats


#: journal events stamped with the script's clock; the others are
#: stamped at record time (the process's own clock)
_CLOCKED = {"admit", "first_token", "step", "requeue", "prefill_chunk",
            "handoff_out", "handoff_in", "handoff_admit", "kv_handoff",
            "finish", "health_transition", "fault_injected",
            "request_stall"}


def _journal_view(tel):
    return [{k: v for k, v in e.items() if k != "trace"
             and (k != "t_s" or e["kind"] in _CLOCKED)}
            for e in tel.flightrec.snapshot()]


@BOTH
def test_engine_stats_after_every_record_call(seed):
    j, t = _both(_run_script, seed)
    assert _stats_view(t.engine_stats()) == _stats_view(j.engine_stats())
    assert _journal_view(t) == _journal_view(j)
    assert t.flightrec.counts_by_kind() == j.flightrec.counts_by_kind()
    assert t.slo_samples() == j.slo_samples()
    assert t.anatomy_samples() == j.anatomy_samples()
    assert t.anatomy_samples(tenant="a") == j.anatomy_samples(tenant="a")
    assert t.stalled_requests(5.0, now=10.0) == \
        j.stalled_requests(5.0, now=10.0)


def _snap_view(snap):
    """A request snapshot without its random trace ids."""
    def strip(x):
        if isinstance(x, dict):
            return {k: strip(v) for k, v in x.items()
                    if k not in ("trace_id", "span_id", "parent_id",
                                 "request")}
        if isinstance(x, list):
            return [strip(v) for v in x]
        return x
    return strip(snap)


@BOTH
def test_trace_records_timeline_and_anatomy(seed, tmp_path):
    j, t = _both(_run_script, seed)
    assert _snap_view(t.trace_records()) == _snap_view(j.trace_records())
    assert _snap_view(t.find_request(0)) == _snap_view(j.find_request(0))
    assert t.find_request("nope") is None
    ev_j = j.export_timeline(str(tmp_path / "j.json"))
    ev_t = t.export_timeline(str(tmp_path / "t.json"))
    assert ev_t == ev_j
    assert json.loads((tmp_path / "t.json").read_text()) == ev_t
    rec = t.trace_records()[0]
    assert ttele.critical_path(rec) == jtele.critical_path(rec)
    parts = [t.anatomy_samples(), j.anatomy_samples()]
    assert ttele.latency_anatomy(ttele.merge_anatomy_samples(parts)) == \
        jtele.latency_anatomy(jtele.merge_anatomy_samples(parts))


def test_engine_stats_roofline_names_the_device():
    dev = _run_script(PORT, 0).engine_stats()["device"]
    assert set(dev) == set(_run_script(JAX, 0).engine_stats()["device"])
    if not torch.cuda.is_available():
        assert dev["backend"] == "cpu" and dev["device_kind"] == "cpu"
        assert dev["peak_flops_per_chip"] == 1e12


# ---------------------------------------------------------------------------
# serve/slo.py
# ---------------------------------------------------------------------------


@BOTH
def test_slo_tracker_snapshot_check_and_dumps(seed, tmp_path):
    def script(m, d):
        cfg = m.slo.SLOConfig(ttft_ms=20.0, e2e_ms=60.0,
                              queue_wait_ms=15.0, windows_s=(0.05, 1.0),
                              check_interval_s=0.01, dump_dir=str(d),
                              max_dumps=3)
        tel = _run_script(m, seed)
        tr = m.slo.SLOTracker(cfg, tel, recorder=tel.flightrec)
        tel.slo = tr
        out = [tr.snapshot(now=1.0)]
        for k in range(8):
            out.append(tr.check(now=1.0 + 0.006 * k))
        tel.record_storm("serve.decode")
        out.append(tr.check(now=2.0))
        out.append(tr.check(now=2.001))      # throttled
        out.append(tr.check(now=40.0))       # windows drained: recover
        out.append(m.slo.worst_burn_rate(out[0]))
        out.append(m.slo.worst_burn_rate(None))
        for snap in out:
            if isinstance(snap, dict):
                snap["dumps"] = len(snap["dumps"])
        return out, tr.breaches, len(tr.dumps), _journal_view(tel)

    j, t = script(JAX, tmp_path / "j"), script(PORT, tmp_path / "t")
    assert j == t
    assert t[1] >= 1 and t[2] >= 1


def test_slo_config_validation_matches():
    for kw in ({"objective": 1.0}, {"windows_s": ()},
               {"burn_threshold": 0}, {"min_samples": 0},
               {"ttft_ms": -1.0}):
        with pytest.raises(ValueError) as want:
            jslo.SLOConfig(**kw)
        with pytest.raises(ValueError) as got:
            tslo.SLOConfig(**kw)
        assert str(got.value) == str(want.value)
    assert tslo.SLOConfig(ttft_ms=1.0, e2e_ms=2.0).objectives() == \
        jslo.SLOConfig(ttft_ms=1.0, e2e_ms=2.0).objectives()


def test_slo_breach_profile_writes_a_chrome_trace(tmp_path):
    """The port's own breach capture (the JAX tracker calls its device
    profiler instead): with ``profile_on_breach`` a breach holds a
    torch.profiler window and writes a chrome trace that parses."""
    logdir = tmp_path / "profiles"
    cfg = tslo.SLOConfig(ttft_ms=0.001, windows_s=(0.05, 1.0),
                         check_interval_s=0.01, dump_dir=str(tmp_path),
                         profile_on_breach=True, profile_seconds=0.01,
                         profile_logdir=str(logdir))
    tel = _run_script(PORT, 0)
    tr = tslo.SLOTracker(cfg, tel, recorder=tel.flightrec)
    snap = tr.check(now=1.0)
    assert snap["breached"] and tr.breaches >= 1
    traces = sorted(logdir.glob("slo_profile_*.json"))
    assert len(traces) == tr.breaches
    for path in traces:
        with open(path) as f:
            assert isinstance(json.load(f)["traceEvents"], list)


# ---------------------------------------------------------------------------
# serve/health.py and serve/chaos.py
# ---------------------------------------------------------------------------


def _health_script(m, seed):
    rng = random.Random(seed)
    rec = m.flightrec.FlightRecorder("fleet", enabled=True)
    rec.t0 = 0.0
    mon = m.health.HealthMonitor(
        m.health.HealthConfig(suspect_ms=50.0, dead_ms=200.0,
                              stall_ms=100.0, probe_ms=5.0),
        deployment=f"fleet{seed}", recorder=rec, now=0.0)
    tels = {}
    for i, role in enumerate(("prefill", "decode", "both")):
        tel = m.tele.EngineTelemetry(f"h{seed}_{i}", max_slots=2)
        tels[f"r{i}"] = tel
        mon.register(f"r{i}", role=role, telemetry=tel, now=0.0)
    # a request admitted on r2 that goes token-silent
    r = tels["r2"].record_enqueue(8, now=0.0)
    tels["r2"].record_admit(r, 0, 16, now=0.001)
    tels["r2"].record_first_token(r, now=0.002)
    out, t = [], 0.0
    for _ in range(120):
        t += rng.uniform(0.001, 0.012)
        for name in ("r0", "r1", "r2"):
            roll = rng.random()
            if name == "r1" and 0.3 < t < 0.7:
                continue                     # frozen: no heartbeat
            if roll < 0.6:
                mon.heartbeat(name, now=t)
            elif roll < 0.65:
                mon.note_idle(name, now=t)
        if abs(t - 0.3) < 0.006:
            mon.note_fault("r1", kind="freeze", now=t)
        out.append(mon.maybe_probe(now=t))
    mon.note_requeued(2)
    blocks = [mon.replica_block(n, now=t) for n in ("r0", "r1", "r2")]
    return (out, blocks, mon.fleet_block(now=t), mon.time_to_detect_ms,
            [mon.state(n) for n in ("r0", "r1", "r2", "gone")],
            _journal_view(types.SimpleNamespace(flightrec=rec)))


@BOTH
def test_health_monitor_blocks_across_a_script(seed):
    j, t = _both(_health_script, seed)
    assert j == t
    assert t[1][1]["dead_count"] >= 1 and t[1][1]["recoveries"] >= 1
    assert t[3] is not None


def test_health_disabled_and_empty_blocks(monkeypatch):
    assert thealth.empty_health() == jhealth.empty_health()
    assert thealth.empty_fleet_health() == jhealth.empty_fleet_health()
    monkeypatch.setenv("RAYTPU_HEALTHWATCH", "0")
    assert not thealth.healthwatch_enabled()
    mon = thealth.HealthMonitor()
    mon.register("r")
    assert mon.replica_block("r") == jhealth.empty_health()
    for kw in ({"suspect_ms": 0}, {"dead_ms": 10.0, "suspect_ms": 20.0},
               {"probe_ms": -1}, {"history": 0}):
        with pytest.raises(ValueError) as want:
            jhealth.HealthConfig(**kw)
        with pytest.raises(ValueError) as got:
            thealth.HealthConfig(**kw)
        assert str(got.value) == str(want.value)


@BOTH
def test_chaos_injector_decisions(seed):
    def script(m):
        mon = m.health.HealthMonitor(now=0.0)
        cfg = m.chaos.ChaosConfig(seed=seed, freeze_replica=1,
                                  freeze_after_waves=3, freeze_waves=5,
                                  delay_token_replica="b",
                                  delay_token_ms=7.0, delay_token_waves=4,
                                  drop_handoff_nth=3)
        inj = m.chaos.ChaosInjector(cfg, monitor=mon)
        for name in ("a", "b", "c"):
            inj.bind(name)
            mon.register(name, now=0.0)
        rng = random.Random(seed)
        out = []
        for _ in range(60):
            name = rng.choice("abc")
            out.append((name, inj.frozen(name), inj.token_delay_s(name),
                        inj.should_drop_handoff()))
        return out, inj.stats(), cfg.any_faults(), mon.faults_injected, \
            m.chaos.ChaosConfig().any_faults()

    assert script(JAX) == script(PORT)
    for kw in ({"freeze_waves": -1}, {"freeze_poll_ms": 0},
               {"delay_token_ms": -1.0}, {"drop_handoff_nth": -1}):
        with pytest.raises(ValueError) as want:
            jchaos.ChaosConfig(**kw)
        with pytest.raises(ValueError) as got:
            tchaos.ChaosConfig(**kw)
        assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# serve/batching.py AdmissionPolicy and serve/kvscope.py hbm_ledger
# ---------------------------------------------------------------------------


def _stats_grid():
    for qw in (None, 5.0, 50.0):
        for ttft in (None, 5.0, 500.0):
            for head in (None, 0, 1 << 20, 1 << 40):
                yield {"queue_wait_ms": {"p95": qw},
                       "ttft_ms": {"p95": ttft},
                       "kv_scope": {"hbm_ledger": {
                           "min_headroom_bytes": head}}}
    yield {}


def test_admission_policy_decide_over_a_grid():
    policies = [dict(), dict(max_queue_depth=2),
                dict(queue_wait_slo_ms=10.0, ttft_slo_ms=100.0),
                dict(min_headroom_bytes=1 << 30),
                dict(max_queue_depth=4, queue_wait_slo_ms=1.0,
                     ttft_slo_ms=1.0, min_headroom_bytes=1 << 21)]
    n = 0
    for kw in policies:
        jp, tp = jbatching.AdmissionPolicy(**kw), \
            tbatching.AdmissionPolicy(**kw)
        assert tp.describe() == jp.describe()
        for stats in _stats_grid():
            for depth in (0, 1, 3, 8):
                assert tp.decide(stats, depth) == jp.decide(stats, depth)
                n += tp.decide(stats, depth) is not None
    assert n > 0


@BOTH
def test_hbm_ledger_on_the_same_rows(seed):
    rs = np.random.RandomState(seed)
    rows = [{"id": i, "platform": "gpu",
             "bytes_limit": (None if i == 2 else int(rs.randint(1, 80))
                             << 30),
             "bytes_in_use": (None if i == 1 else int(rs.randint(0, 40))
                              << 30),
             "peak_bytes_in_use": int(rs.randint(0, 60)) << 30}
            for i in range(4)]
    for pool, budget in ((0, 0), (5 << 30, 0), (3 << 30, 1 << 30)):
        kw = dict(pool_bytes_per_chip=pool, device_stats=rows,
                  program_budget_bytes=budget)
        assert tkvscope.hbm_ledger(**kw) == jkvscope.hbm_ledger(**kw)
    assert tkvscope.hbm_ledger() == jkvscope.hbm_ledger()
    assert tkvscope.empty_kv_scope() == jkvscope.empty_kv_scope()
    assert tkvscope.serve_program_budget_bytes() == 0


# ---------------------------------------------------------------------------
# _private/device_stats.py
# ---------------------------------------------------------------------------


def test_registry_counts_compiles_as_the_jax_registry_does():
    """The same calls through both registries: a tensor (an array in
    JAX) keys by shape and dtype, a numpy scalar by dtype, a Python int
    by value, a generator (a PRNG key) by type, None not at all."""
    import jax
    import jax.numpy as jnp

    from ray_tpu._private import device_stats as jds

    now = iter(np.arange(0.0, 100.0, 0.5)).__next__
    regs = {"j": jds.ProgramRegistry(storm_threshold=3, now=now),
            "t": tds.ProgramRegistry(storm_threshold=3, now=now)}
    storms = {"j": [], "t": []}
    fns = {}
    for k, reg in regs.items():
        reg.subscribe_storms(storms[k].append)
        fns[k] = reg.instrument("serve.decode", lambda *a, **kw: 0)
    key = jax.random.PRNGKey(0)
    gen = torch.Generator().manual_seed(0)
    calls = [((4, 8), "float32", 3, np.int32(1), None),
             ((4, 8), "float32", 3, np.int32(2), None),
             ((4, 8), "float32", 4, np.int32(2), None),
             ((4, 16), "float32", 4, np.int32(2), None),
             ((4, 16), "int32", 4, np.int32(5), 0),
             ((4, 8), "float32", 3, np.int32(9), None),
             ((2, 2), "float32", 3, np.int32(9), None)]
    for shape, dtype, py, npi, opt in calls:
        fns["j"]({"w": jnp.zeros(shape, dtype), "b": None}, py, npi, key,
                 opt=opt)
        fns["t"]({"w": torch.zeros(shape, dtype=getattr(torch, dtype)),
                  "b": None}, py, npi, gen, opt=opt)
    sj, st = (regs[k].snapshot() for k in ("j", "t"))
    for name in sj:
        for field in ("compile_events", "invokes", "recompile_storm",
                      "recompile_storms_total"):
            assert st[name][field] == sj[name][field], field
    assert set(st["serve.decode"]) == set(sj["serve.decode"])
    assert st["serve.decode"]["compile_events"] == 5
    assert storms["t"] == storms["j"] == ["serve.decode"]
    assert st["serve.decode"]["mfu"] is None
    assert regs["t"].programs() == regs["j"].programs()


def test_device_memory_stats_and_roofline_on_the_cpu():
    import jax

    from ray_tpu._private import device_stats as jds

    want = jds.device_memory_stats(jax.devices("cpu")[:1])
    got = tds.device_memory_stats([torch.device("cpu")])
    assert got == want
    assert tds.device_roofline("cpu") == {
        "backend": "cpu", "device_kind": "cpu",
        "peak_flops_per_chip": 1e12, "peak_hbm_bytes_per_sec": 100e9,
        "ridge_flops_per_byte": 10.0}
    assert tds.peak_flops_per_chip("cpu") == jds._PEAK_FLOPS_TABLE["cpu"]
    if not torch.cuda.is_available():
        assert tds.device_memory_stats() == []


def test_peak_table_knows_the_h100_sxm_only(monkeypatch):
    names = {"NVIDIA H100 80GB HBM3": (989e12, 3.35e12),
             "NVIDIA A100-SXM4-80GB": (None, None)}
    for name, want in names.items():
        monkeypatch.setattr(tds, "_device_name", lambda d=None, n=name: n)
        assert (tds.peak_flops_per_chip(), tds.peak_hbm_bytes_per_sec()) \
            == want
        rl = tds.device_roofline()
        assert rl["backend"] == "cuda" and rl["device_kind"] == name
    # the figures the bench and the smoke run read
    from ray_tpu_torch import bench

    assert bench.H100_BF16_PEAK_FLOPS == tds.H100_SXM["bf16_flops"] \
        == 989e12
