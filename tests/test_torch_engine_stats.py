"""The port's engine telemetry against the JAX engine's, request for
request.

GPT-2 nano is initialized by JAX, pickled as numpy and served by both
packages' engines (``checkpoint_path``) on the CPU in f32, the same
prompts through each.  For every configuration of
``tests/test_engine_stats_schema.py`` that runs on one device (dense,
paged, each with and without n-gram spec decoding), a prefill/decode
pair, chunked prefill and the batch scheduler: the recursive key tree
of ``engine_stats()`` is the JAX engine's, and so is every count (the
request counts, tokens, steps, prefill buckets and compiles, the
program registry's compile events, rejections, the KV blocks, spec,
handoff and chunk counts, the SLO verdict, the flight recorder's
events by kind).  Timings are compared only as present or None.  Then
the same requests are shed by the same admission policy, a tiny SLO
target breaches and dumps as JAX's does, a health monitor and a chaos
freeze attached as the fleet router attaches them give JAX's
transitions, and the timeline has JAX's events and lanes.

One difference is written down rather than matched: the JAX engine
pads the handoff programs' block ids to max_seq / block_size and
compiles them at construction, so each counts one compile event before
any request; the port moves only a request's filled blocks, and its
``serve.kv_handoff_*`` programs count one event per distinct block
count, at the first handoff of each.
"""

import asyncio
import functools
import json
import pickle

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from ray_tpu._private import device_stats as jds  # noqa: E402
from ray_tpu.models import gpt2 as jgpt2  # noqa: E402
from ray_tpu.serve import batching as jbatching  # noqa: E402
from ray_tpu.serve import chaos as jchaos  # noqa: E402
from ray_tpu.serve import health as jhealth  # noqa: E402
from ray_tpu.serve import llm as jllm  # noqa: E402
from ray_tpu.serve import slo as jslo  # noqa: E402
from ray_tpu_torch._private import device_stats as tds  # noqa: E402
from ray_tpu_torch.serve import batching as tbatching  # noqa: E402
from ray_tpu_torch.serve import chaos as tchaos  # noqa: E402
from ray_tpu_torch.serve import health as thealth  # noqa: E402
from ray_tpu_torch.serve import llm as tllm  # noqa: E402
from ray_tpu_torch.serve import slo as tslo  # noqa: E402

MAX_NEW = 4
_JOVR = {"dtype": jnp.float32, "use_flash": False, "remat": False}
_TOVR = {"dtype": torch.float32}
HANDOFF = ("serve.kv_handoff_export", "serve.kv_handoff_install")


@functools.lru_cache(maxsize=None)
def _jax_params():
    cfg = jgpt2.gpt2_config("nano", **_JOVR)
    return jgpt2.gpt2_init(jax.random.PRNGKey(0), cfg)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ckpt") / "gpt2_nano.pkl")
    with open(path, "wb") as f:
        pickle.dump(jax.tree.map(np.asarray, _jax_params()), f)
    return path


@pytest.fixture(autouse=True)
def fresh_registries(monkeypatch, tmp_path):
    """Each test starts both packages with empty program registries and
    no engine programs seen, and dumps flight records under tmp_path."""
    jds.reset_registry()
    tds.reset_registry()
    monkeypatch.setattr(jllm, "_JIT_CACHE", {})
    monkeypatch.setattr(tllm, "_PROGRAM_CACHE", {})
    monkeypatch.setenv("RAYTPU_FLIGHTREC_DIR", str(tmp_path / "fr"))
    yield
    jds.reset_registry()
    tds.reset_registry()


def _slo(m, **kw):
    kw = kw or dict(ttft_ms=60_000.0, e2e_ms=120_000.0,
                    queue_wait_ms=60_000.0)
    return m.SLOConfig(**kw)


def _kw(kw):
    out = dict(max_new_tokens=MAX_NEW, temperature=0.0,
               kv_block_size=16, prefill_bucket=16, max_slots=2)
    out.update(kw)
    return out


def _engines(path, jkw=None, tkw=None, **kw):
    """(JAX engine, port engine) of one configuration."""
    j = jllm.build_llm_deployment(
        "gpt2", "nano", checkpoint_path=path, config_overrides=_JOVR,
        **_kw(dict(kw, **(jkw or {})))).func_or_class()
    t = tllm.build_llm_deployment(
        "gpt2", "nano", checkpoint_path=path, config_overrides=_TOVR,
        device="cpu", **_kw(dict(kw, **(tkw or {}))))()
    return j, t


def _prompts(seed, lens):
    rs = np.random.RandomState(seed)
    return [rs.randint(2, 500, n).astype(np.int32) for n in lens]


def _drive(engines, prompts, call=None, extra=None):
    """All prompts at once through each of ``engines`` (``call(engine,
    prompt)`` by default awaits ``engine(prompt)``); every exception is
    returned in its request's place.  ``extra`` is a coroutine run
    beside the requests until they are done."""
    call = call or (lambda e, p: e(p))

    async def main():
        try:
            tasks = [asyncio.ensure_future(call(engines[0], p))
                     for p in prompts]
            if extra is not None:
                helper = asyncio.ensure_future(extra(tasks))
            out = await asyncio.gather(*tasks, return_exceptions=True)
            if extra is not None:
                await helper
            return out
        finally:
            for e in engines:
                if getattr(e, "_engine_task", None) is not None:
                    e.shutdown_engine()

    return asyncio.run(main())


def _tree(x):
    """The recursive key tree of a stats dict (lists of dicts by their
    first element's tree; the handoff programs left out)."""
    if isinstance(x, dict):
        return {k: _tree(v) for k, v in x.items() if k not in HANDOFF}
    if isinstance(x, list) and x and isinstance(x[0], dict):
        return [_tree(x[0])]
    return None


def _present(x):
    if isinstance(x, dict):
        return {k: _present(v) for k, v in x.items()}
    return x is not None


def _programs(stats, skip=()):
    return {name: blk["compile_events"]
            for name, blk in stats["programs"].items() if name not in skip}


def _compile_counts(stats, skip=HANDOFF):
    return {k: v for k, v in stats["program_compiles"].items()
            if k not in skip}


def _kinds(engine, skip=("compile",)):
    return {k: v for k, v in
            engine._telemetry.flightrec.counts_by_kind().items()
            if k not in skip}


def _journal_compiles(engine, skip=HANDOFF):
    return [e["program"] for e in engine._telemetry.flightrec.snapshot()
            if e["kind"] == "compile" and e["program"] not in skip]


def _no_timing(block):
    return {k: v for k, v in block.items()
            if not k.endswith("_ms") and not k.endswith("_s")}


def assert_stats_match(j, t, *, skip_programs=()):
    """Key tree, counts, and timings as present/None."""
    js, ts = j.engine_stats(), t.engine_stats()
    assert _tree(ts) == _tree(js)
    for key in ("requests", "tokens_generated", "engine_steps",
                "prefill_buckets", "prefill_compiles",
                "rejections_by_reason", "kv_cache", "handoff",
                "prefill_chunks", "role", "max_slots", "deployment",
                "max_active_slots"):
        assert ts[key] == js[key], key
    assert _compile_counts(ts) == _compile_counts(js)
    assert _programs(ts, skip_programs) == _programs(js, skip_programs)
    assert ts["kv_scope"]["forensics"] == js["kv_scope"]["forensics"]
    assert ts["kv_scope"]["occupancy"]["samples"] == \
        js["kv_scope"]["occupancy"]["samples"]
    assert [_no_timing(r) for r in ts["kv_scope"]["occupancy"]["ring"]] \
        == [_no_timing(r) for r in js["kv_scope"]["occupancy"]["ring"]]
    assert _no_timing(ts["kv_tier"]) == _no_timing(js["kv_tier"])
    assert ts["spec"] == js["spec"]
    assert (ts["slo"] or {}).get("breached") == \
        (js["slo"] or {}).get("breached")
    assert _kinds(t) == _kinds(j)
    assert _journal_compiles(t) == _journal_compiles(j)
    for key in ("ttft_ms", "queue_wait_ms", "request_latency_ms",
                "inter_token_ms", "latency_anatomy"):
        assert _present(ts[key]) == _present(js[key]), key
    ledger = ts["kv_scope"]["hbm_ledger"]
    assert _present(ledger) == _present(js["kv_scope"]["hbm_ledger"])
    return js, ts


CONFIGS = {
    "dense": dict(kv_layout="dense"),
    "paged": dict(kv_layout="paged"),
    "dense-spec": dict(kv_layout="dense", spec="ngram"),
    "paged-spec": dict(kv_layout="paged", spec="ngram"),
    "paged-chunked": dict(kv_layout="paged", prefill_chunk_tokens=32),
}


def _spec_kw(cfg):
    cfg = dict(cfg)
    if cfg.pop("spec", None) is None:
        return cfg, {}, {}
    return (cfg, {"spec_decode": jllm.SpecConfig(draft="ngram", k=2)},
            {"spec_decode": tllm.SpecConfig(draft="ngram", k=2)})


@pytest.mark.parametrize("name", list(CONFIGS))
def test_engine_stats_match_the_jax_engine(ckpt, name):
    kw, jkw, tkw = _spec_kw(CONFIGS[name])
    jkw["slo"], tkw["slo"] = _slo(jslo), _slo(tslo)
    j, t = _engines(ckpt, jkw, tkw, scheduler="continuous", **kw)
    prompts = _prompts(1, (9, 40, 13, 70, 24, 9))
    outs_j = _drive([j], prompts)
    outs_t = _drive([t], prompts)
    for a, b in zip(outs_j, outs_t):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))
    js, ts = assert_stats_match(j, t)
    assert ts["requests"]["finished"] == len(prompts)
    assert ts["slo"]["breached"] is False
    assert set(ts["programs"]) >= {"serve.decode"} or \
        "serve.spec_verify" in ts["programs"]
    # kv_stats() serves the same blocks
    assert t.kv_stats()["kv_cache"] == ts["kv_cache"]
    assert t.metrics_snapshot()["serve_ttft_ms"]["kind"] == "histogram"


def test_prefill_decode_pair_matches_the_jax_pair(ckpt):
    pairs = []
    for m, build, extra in (
            (jllm, lambda **kw: jllm.build_llm_deployment(
                "gpt2", "nano", checkpoint_path=ckpt,
                config_overrides=_JOVR, **_kw(kw)).func_or_class(),
             {}),
            (tllm, lambda **kw: tllm.build_llm_deployment(
                "gpt2", "nano", checkpoint_path=ckpt,
                config_overrides=_TOVR, device="cpu", **_kw(kw))(), {})):
        pre = build(scheduler="continuous", kv_layout="paged",
                    role="prefill")
        dec = build(scheduler="continuous", kv_layout="paged",
                    role="decode")
        pairs.append((pre, dec))
    prompts = _prompts(2, (9, 40, 33, 70))

    async def via(pre, dec, p):
        return await dec.admit_prefilled(await pre(p))

    outs = [_drive([pre, dec], prompts,
                   call=lambda e, p, pre=pre, dec=dec: via(pre, dec, p))
            for pre, dec in pairs]
    for a, b in zip(*outs):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))
    (jpre, jdec), (tpre, tdec) = pairs
    for j, t in ((jpre, tpre), (jdec, tdec)):
        assert_stats_match(j, t, skip_programs=HANDOFF)
    ts = tdec.engine_stats()
    assert ts["handoff"]["handoffs_in"] == len(prompts)
    assert ts["handoff"]["blocks_moved"] == \
        sum(-(-len(p) // 16) for p in prompts)
    assert tpre.engine_stats()["handoff"]["handoffs_out"] == len(prompts)
    # the documented difference: one compile event per distinct block
    # count here, one at construction in the JAX engine
    n_shapes = len({-(-len(p) // 16) for p in prompts})
    progs = _programs(ts)
    assert progs["serve.kv_handoff_export"] == n_shapes
    assert progs["serve.kv_handoff_install"] == n_shapes
    assert _programs(jdec.engine_stats())["serve.kv_handoff_install"] == 1


def test_batch_scheduler_stats_match(ckpt):
    j, t = _engines(ckpt)
    prompts = _prompts(3, (12,) * 4)
    outs = [_drive([e], prompts) for e in (j, t)]
    for a, b in zip(*outs):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))
    js, ts = assert_stats_match(j, t)
    assert ts["requests"]["finished"] == 4 and ts["programs"] == {}
    # an oversized prompt is rejected and counted as JAX counts it
    for e in (j, t):
        with pytest.raises(ValueError):
            asyncio.run(e(np.zeros(0, np.int32)))
    assert t.engine_stats()["rejections_by_reason"] == \
        j.engine_stats()["rejections_by_reason"] == {"oversized": 1}


def test_admission_policy_sheds_the_same_requests(ckpt):
    j, t = _engines(
        ckpt, {"admission_policy": jbatching.AdmissionPolicy(
            max_queue_depth=1)},
        {"admission_policy": tbatching.AdmissionPolicy(
            max_queue_depth=1)}, scheduler="continuous", kv_layout="paged")
    prompts = _prompts(4, (9, 20, 30, 12, 40, 16))
    outs = [_drive([e], prompts) for e in (j, t)]
    shed_j = [isinstance(o, jbatching.OverloadedError) for o in outs[0]]
    shed_t = [isinstance(o, tbatching.OverloadedError) for o in outs[1]]
    assert shed_t == shed_j and 0 < sum(shed_t) < len(prompts)
    for a, b, s in zip(*outs, shed_t):
        if not s:
            np.testing.assert_array_equal(np.asarray(b), np.asarray(a))
    js, ts = assert_stats_match(j, t)
    assert ts["rejections_by_reason"] == {"shed_queue_full": sum(shed_t)}
    assert ts["admission_policy"] == js["admission_policy"]
    # the headroom gate is inert on the CPU (no bytes_limit), as in JAX
    _, t2 = _engines(ckpt, tkw={"admission_policy": tbatching.
                                AdmissionPolicy(min_headroom_bytes=1 << 60)},
                     scheduler="continuous", kv_layout="paged")
    assert not any(isinstance(o, Exception)
                   for o in _drive([t2], prompts[:2]))


def test_slo_breach_dumps_the_flight_record(ckpt, tmp_path):
    tiny = dict(ttft_ms=0.001)
    j, t = _engines(ckpt, {"slo": _slo(jslo, **tiny)},
                    {"slo": _slo(tslo, **tiny)}, scheduler="continuous",
                    kv_layout="paged")
    prompts = _prompts(5, (9, 40, 13))
    for e in (j, t):
        _drive([e], prompts)
    js, ts = j.engine_stats(), t.engine_stats()
    assert ts["slo"]["breached"] is js["slo"]["breached"] is True
    assert ts["slo"]["breaches"] == js["slo"]["breaches"] == 1
    assert len(ts["slo"]["dumps"]) == len(js["slo"]["dumps"]) == 1
    path = ts["slo"]["dumps"][0]
    assert path.startswith(str(tmp_path / "fr"))
    doc = json.loads(open(path).read())
    assert doc["reason"] == "slo_breach_ttft"
    assert "kv_reserve" in doc["counts_by_kind"]
    assert ts["flightrec"]["dumps"] == [path]


def test_health_and_chaos_give_the_jax_transitions(ckpt):
    label = "fleet/r0"
    runs = []
    prompts = _prompts(6, (9, 12, 20))
    for m_health, m_chaos, eng in zip(
            (jhealth, thealth), (jchaos, tchaos),
            _engines(ckpt, scheduler="continuous")):
        # warm: a first wave that compiles (JAX) would stall the loop
        # past dead_ms with a fresh heartbeat, which is not a freeze
        _drive([eng], prompts)
        mon = m_health.HealthMonitor(m_health.HealthConfig(
            suspect_ms=300.0, dead_ms=800.0, stall_ms=60_000.0,
            probe_ms=1.0))
        # a freeze of >= 1.5 s: far past dead_ms however slowly a
        # loaded CPU runs the waves around it
        inj = m_chaos.ChaosInjector(m_chaos.ChaosConfig(
            seed=0, freeze_replica=0, freeze_after_waves=2,
            freeze_waves=300, freeze_poll_ms=5.0), monitor=mon)
        # the fleet router's attach (ray_tpu/serve/router.py:735-746)
        eng._replica_label = label
        eng._health = mon
        mon.register(label, role="both",
                     recorder=eng._telemetry.flightrec,
                     telemetry=eng._telemetry)
        eng._chaos = inj
        inj.bind(label)

        async def prober(tasks, mon=mon):
            # the router's pump: probe while requests are in flight
            while not all(x.done() for x in tasks):
                mon.maybe_probe()
                await asyncio.sleep(0.002)

        outs = _drive([eng], prompts, extra=prober)
        runs.append((outs, eng.engine_stats()["health"]))
    (outs_j, hj), (outs_t, ht) = runs
    for a, b in zip(outs_j, outs_t):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))

    def steps(block):
        return [(x["from"], x["to"], x["reason"])
                for x in block["transition_log"]]

    # the freeze: suspect, dead, recovered, in both.  A wave slower
    # than suspect_ms on a loaded CPU may add a suspect/recover blip
    # elsewhere, in either package, so the episode and not the whole
    # log (nor its counters) is compared
    def episode(block):
        log = steps(block)
        i = log.index(("suspect", "dead", "heartbeat_lost"))
        return log[i - 1:i + 2]

    assert episode(ht) == episode(hj) == [
        ("healthy", "suspect", "heartbeat_stale"),
        ("suspect", "dead", "heartbeat_lost"),
        ("dead", "healthy", "heartbeat_resumed")]
    assert set(ht) == set(hj)
    for block in (ht, hj):
        assert block["enabled"] is True and block["stalls"] == 0
        assert block["dead_count"] >= 1 and block["recoveries"] >= 1
        assert block["time_to_detect_ms"] is not None


def test_timeline_has_the_jax_events_and_lanes(ckpt, tmp_path):
    j, t = _engines(ckpt, scheduler="continuous", kv_layout="paged")
    prompts = _prompts(7, (9, 40, 13))
    for e in (j, t):
        _drive([e], prompts)
    ev_j = j.export_timeline()
    ev_t = t.export_timeline(str(tmp_path / "t.json"))
    assert json.loads((tmp_path / "t.json").read_text()) == ev_t

    def shape(events):
        return sorted((e["name"], e["ph"], e["tid"]) for e in events)

    assert shape(ev_t) == shape(ev_j)
    lanes = {e["args"]["name"] for e in ev_t if e["name"] == "thread_name"}
    assert lanes == {"queue", "slot 0", "slot 1", "engine steps"}
    # the request snapshots carry the same hops
    rec_t, rec_j = t.trace_records(), j.trace_records()
    assert [sorted(r) for r in rec_t] == [sorted(r) for r in rec_j]
    rid = rec_t[0]["request"]
    assert t.request_trace(rid)["id"] == rec_t[0]["id"]
    assert t.request_trace("missing") is None
    assert set(t.anatomy_samples()) == set(j.anatomy_samples())
