"""The port's fleet (``ray_tpu_torch/serve/router.py``) against the JAX
package's.

Host parts first, on stubs and seeded inputs: the weighted fair queue's
pop order, the router's replica choice (``_pick`` / ``_pick_disagg``)
over stub replicas that carry resident prefix keys and inflight counts,
and the WFQ dispatch order of a batch flood then interactive requests
through stub engines, read from the routers' ``route`` events.  Then
real nano fleets in f32 on the CPU, driven one request at a time: the
replies equal JAX's solo ``generate`` token for token, and the routing
counts, each replica's ``routed`` and the pooled prefix hit rate equal
the JAX fleet's on the same prompts (routing is a pure function of
resident keys, inflight counts and the seeded RNG under sequential
drive).  The autoscale episode runs with an injected clock on both.
Nothing here gates on wall-clock latency.
"""

import asyncio
import collections

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from chip_smoke import shared_prefix_mix  # noqa: E402
from ray_tpu.serve import router as jrouter  # noqa: E402
from ray_tpu.serve.health import HealthConfig as JHealthConfig  # noqa: E402
from ray_tpu.serve.slo import SLOConfig as JSLOConfig  # noqa: E402
from ray_tpu_torch.serve import router as trouter  # noqa: E402
from ray_tpu_torch.serve.health import HealthConfig  # noqa: E402
from ray_tpu_torch.serve.slo import SLOConfig  # noqa: E402
from ray_tpu_torch.tools.flightrec import (load_dump,  # noqa: E402
                                           report_lines)
from tests.test_torch_serve_continuous import (  # noqa: E402,F401
    _JOVR, _TOVR, FAMILIES, _assert_oracle, ckpt)

_ENGINE_KW = dict(max_new_tokens=6, temperature=0.0, kv_block_size=16,
                  prefill_bucket=16, max_slots=2)
#: health thresholds no loaded test machine reaches (a JAX compile
#: inside a wave can stall a replica's heartbeat past the default
#: 1 s): routing then depends on keys, counts and the seed only
_CALM = dict(suspect_ms=1e7, dead_ms=2e7, stall_ms=1e9)


def port_fleet(family, path, name, **kw):
    kw.setdefault("health", HealthConfig(**_CALM))
    return trouter.build_llm_fleet(
        family, "nano", fleet_name=name, checkpoint_path=path,
        device="cpu", config_overrides=_TOVR, **{**_ENGINE_KW, **kw})


def jax_fleet(family, path, name, **kw):
    kw.setdefault("health", JHealthConfig(**_CALM))
    return jrouter.build_llm_fleet(
        family, "nano", fleet_name=name, checkpoint_path=path,
        config_overrides=_JOVR, **{**_ENGINE_KW, **kw})


def drive_sequential(fleet, prompts, tenant=None):
    async def main():
        try:
            outs = [await fleet(p, tenant=tenant) for p in prompts]
            return outs, fleet.fleet_stats()
        finally:
            fleet.shutdown()

    outs, st = asyncio.run(main())
    return [np.asarray(o) for o in outs], st


def routing_of(st):
    return {"routed_by_policy": st["router"]["routed_by_policy"],
            "routed": {n.split("/")[-1]: r["routed"]
                       for n, r in st["replicas"].items()},
            "prefix_hit_rate": st["prefix_hit_rate"]}


# ---------------------------------------------------------------------------
# FairQueue
# ---------------------------------------------------------------------------

WEIGHT_SETS = [{"hot": 2.0, "cold": 1.0},
               {"interactive": 8.0, "batch": 1.0, "bulk": 0.5},
               {"a": 1.0, "b": 3.0, "c": 1.5}]


@pytest.mark.parametrize("weights", WEIGHT_SETS,
                         ids=["two", "three", "uneven"])
def test_fair_queue_pop_order_equals_jax(weights):
    """Seeded push/pop sequences (known tenants, an unknown one, None,
    costs 1-3) pop in the same order from both queues."""
    rng = np.random.RandomState(len(weights))
    names = list(weights) + ["mystery", None]
    ops = []
    for i in range(60):
        if rng.rand() < 0.3:
            ops.append(("pop",))
        else:
            ops.append(("push", i, names[rng.randint(len(names))],
                        float(rng.randint(1, 4))))

    def run(mod):
        q = mod.FairQueue({n: mod.TenantClass(n, weight=w)
                           for n, w in weights.items()})
        out = []
        for op in ops:
            if op[0] == "push":
                q.push(op[1], op[2], cost=op[3])
            elif len(q):
                out.append(q.pop())
        while len(q):
            out.append(q.pop())
        return out

    got = run(trouter)
    assert got == run(jrouter)
    assert sorted(got) == [op[1] for op in ops if op[0] == "push"]


def test_fair_queue_unknown_tenant_gets_weight_one():
    """A tenant the queue was not given is served as a weight-1 class,
    as the reference's is: against a named weight-1 tenant the two
    alternate."""
    def run(mod):
        q = mod.FairQueue({"known": mod.TenantClass("known", weight=1.0)})
        for i in range(4):
            q.push(("known", i), "known")
            q.push(("mystery", i), "mystery")
        return [q.pop() for _ in range(len(q))]

    got = run(trouter)
    assert got == run(jrouter)
    assert [t for t, _ in got] == ["known", "mystery"] * 4
    with pytest.raises(ValueError, match="weight must be > 0"):
        trouter.TenantClass("x", weight=0.0)


# ---------------------------------------------------------------------------
# replica choice over stub replicas
# ---------------------------------------------------------------------------

class _StubPager:
    def __init__(self):
        self.keys = set()
        self.available = 0

    def prefix_keys(self):
        return list(self.keys)


class _StubInst:
    def __init__(self, role):
        self.role = role
        self._pager = _StubPager()


def _pick_script(seed, n_reps=4, block=4, steps=40):
    """Per step: each stub replica's resident keys (block-aligned
    prefixes of a few token families), inflight and free blocks, and
    the prompt to route."""
    rng = np.random.RandomState(seed)
    families = [tuple(int(t) for t in rng.randint(2, 50, 4 * block))
                for _ in range(3)]
    script = []
    for _ in range(steps):
        reps = []
        for _ in range(n_reps):
            keys = set()
            for fam in families:
                if rng.rand() < 0.4:
                    depth = int(rng.randint(1, 5))
                    keys.update(fam[:i * block]
                                for i in range(1, depth + 1))
            reps.append((keys, int(rng.randint(0, 4)),
                         int(rng.randint(0, 64))))
        fam = families[rng.randint(len(families))]
        cut = int(rng.randint(0, len(fam) + 1))
        tail = tuple(int(t) for t in rng.randint(50, 99, 3))
        script.append((reps, fam[:cut] + tail))
    return script


def _run_picks(mod, policy, roles, script, disagg):
    reps = [mod.ReplicaHandle(f"f/{i}", _StubInst(r))
            for i, r in enumerate(roles)]
    router = mod.LLMRouter(reps, block_size=4, policy=policy, seed=3)
    out = []
    for state, tokens in script:
        for rep, (keys, inflight, free) in zip(reps, state):
            rep.inst._pager.keys = keys
            rep.inst._pager.available = free
            rep.inflight = inflight
        if disagg:
            pre = router._candidates(
                [r for r in reps if r.role == "prefill"])
            dec = [r for r in reps if r.role in ("decode", "both")]
            rep, how, m = router._pick_disagg(tokens, pre, dec)
            target = router._pick_handoff_target()
            out.append((rep.name, how, m, target.name))
        else:
            rep, how, m = router._pick(tokens, router._candidates())
            out.append((rep.name, how, m))
    return out


@pytest.mark.parametrize("disagg", [False, True], ids=["pick", "disagg"])
@pytest.mark.parametrize("policy", ["prefix", "round_robin"])
def test_router_choices_equal_jax(policy, disagg):
    """The same stub replicas, keys, inflight counts and prompts give
    the same (replica, policy, matched blocks) from both routers, and
    on a split fleet the same handoff target (most free blocks)."""
    roles = (["prefill", "prefill", "decode", "decode"] if disagg
             else ["both"] * 4)
    script = _pick_script(7 if disagg else 5)
    got = _run_picks(trouter, policy, roles, script, disagg)
    assert got == _run_picks(jrouter, policy, roles, script, disagg)
    hows = collections.Counter(g[1] for g in got)
    if policy == "prefix":
        assert hows["prefix_affinity"] > 0
        assert hows["disagg_prefill" if disagg else "p2c"] > 0


# ---------------------------------------------------------------------------
# WFQ dispatch order through stub engines
# ---------------------------------------------------------------------------

class _StubEngine:
    """An engine that answers its prompt after one loop turn."""

    role = "both"

    async def __call__(self, arr, sampling=None, tenant=None,
                       enqueue_ts=None, trace=None):
        await asyncio.sleep(0)
        return arr


@pytest.mark.parametrize("wfq", [True, False], ids=["wfq", "fifo"])
def test_wfq_dispatch_order_equals_jax(wfq):
    """A batch flood of 12 then 3 interactive requests through one
    replica of capacity 1: the routers' route events give the same
    dispatch order; with WFQ the interactive requests overtake the
    batch backlog, without it they wait behind all of it."""
    def run(mod):
        tenants = [mod.TenantClass("interactive", weight=8.0),
                   mod.TenantClass("batch", weight=1.0)]
        reps = [mod.ReplicaHandle("f/r0", _StubEngine())]
        router = mod.LLMRouter(reps, tenants=tenants, wfq=wfq,
                               policy="round_robin",
                               max_inflight_per_replica=1)

        async def main():
            return await asyncio.gather(
                *[router.submit(np.full(3, i), tenant="batch")
                  for i in range(12)],
                *[router.submit(np.full(3, 100 + i),
                                tenant="interactive")
                  for i in range(3)])

        outs = asyncio.run(main())
        assert [int(o[0]) for o in outs] == \
            list(range(12)) + [100, 101, 102]
        return [(e["req"], e["tenant"])
                for e in router.telemetry.flightrec.snapshot()
                if e["kind"] == "route"]

    got = run(trouter)
    assert got == run(jrouter)
    order = [t for _, t in got]
    last_inter = max(i for i, t in enumerate(order) if t == "interactive")
    if wfq:
        assert last_inter < len(order) - 3
    else:
        assert order == ["batch"] * 12 + ["interactive"] * 3


# ---------------------------------------------------------------------------
# nano fleets: replies, routing counts, prefix hit rate
# ---------------------------------------------------------------------------

_RUNS = {}


def _fleet_run(ckpt, family, routing):
    key = (family, routing)
    if key not in _RUNS:
        # two blocks of 16 a prefix, at nano's vocabulary
        prompts = shared_prefix_mix(np, 500, 32)
        name = f"t_{family}_{routing}"
        outs, st = drive_sequential(
            port_fleet(family, ckpt[family], name, num_replicas=2,
                       routing=routing), prompts)
        _, jst = drive_sequential(
            jax_fleet(family, ckpt[family], name, num_replicas=2,
                      routing=routing), prompts)
        _RUNS[key] = prompts, outs, st, jst
    return _RUNS[key]


@pytest.mark.parametrize("routing", ["prefix", "round_robin"])
@pytest.mark.parametrize("family", FAMILIES)
def test_fleet_replies_and_routing_equal_jax(ckpt, family, routing):
    """12 shared-prefix prompts one at a time through two replicas:
    every reply is JAX's solo greedy continuation, and the routing
    counts, each replica's routed count and the pooled prefix hit rate
    are the JAX fleet's."""
    prompts, outs, st, jst = _fleet_run(ckpt, family, routing)
    _assert_oracle(family, prompts, outs)
    assert routing_of(st) == routing_of(jst)
    by = st["router"]["routed_by_policy"]
    if routing == "prefix":
        assert by["prefix_affinity"] > 0 and by["round_robin"] == 0
        assert all(r["routed"] > 0 for r in st["replicas"].values())
        assert st["prefix_hit_rate"] > _fleet_run(
            ckpt, family, "round_robin")[2]["prefix_hit_rate"]
    else:
        assert by["round_robin"] == len(prompts)
    assert all(r["kv_cache"]["blocks_in_use"] == 0
               for r in st["replicas"].values())


def _key_tree(x, path=""):
    if isinstance(x, dict):
        keys = set()
        for k, v in x.items():
            # per-replica and per-program maps are keyed by name
            keys.add(f"{path}/{k}")
            keys |= _key_tree(v, f"{path}/{k}")
        return keys
    return set()


def test_fleet_stats_key_tree_equals_jax(ckpt):
    """fleet_stats() (the dashboard's /api/serve/fleet document) has the
    JAX fleet's key tree, down to every leaf."""
    _, _, st, jst = _fleet_run(ckpt, "gpt2", "prefix")
    assert _key_tree(st) == _key_tree(jst)
    assert st["name"] == jst["name"] == "t_gpt2_prefix"


# ---------------------------------------------------------------------------
# autoscaling with an injected clock
# ---------------------------------------------------------------------------

def _autoscale_episode(mod, build, slo_cls, dump_dir):
    rng = np.random.RandomState(5)
    prompts = [rng.randint(2, 500, 20).astype(np.int32) for _ in range(6)]
    slo = slo_cls(ttft_ms=1e-4, e2e_ms=1e-4, objective=0.5,
                  windows_s=(30.0,), dump_on_breach=False)
    policy = mod.AutoscalePolicy(min_replicas=1, max_replicas=2,
                                 burn_threshold=1.0, queue_high=1e9,
                                 sustain_s=2.0, idle_s=2.0,
                                 up_cooldown_s=0.0, down_cooldown_s=0.0)
    fleet = build(num_replicas=1, slo=slo, autoscale=policy)
    acts = []

    async def main():
        outs = [await fleet(p) for p in prompts[:4]]
        for now in (100.0, 101.0, 102.5):
            acts.append(await fleet.autoscale_step(now=now))
        acts.append(fleet.num_replicas)
        outs += [await fleet(p) for p in prompts[4:]]
        fleet.autoscale_policy = mod.AutoscalePolicy(
            min_replicas=1, max_replicas=2, burn_threshold=1e9,
            queue_high=1e9, sustain_s=2.0, idle_s=2.0,
            up_cooldown_s=0.0, down_cooldown_s=0.0)
        for now in (110.0, 112.5, 120.0):
            acts.append(await fleet.autoscale_step(now=now))
        acts.append(fleet.num_replicas)
        outs.append(await fleet(prompts[0]))
        return outs

    try:
        outs = asyncio.run(main())
        events = fleet.telemetry.flightrec.snapshot()
        fleet.telemetry.flightrec.dump_dir = str(dump_dir)
        dump = fleet.telemetry.flightrec.dump(reason="test/autoscale")
        routed = {n: r["routed"]
                  for n, r in fleet.fleet_stats()["replicas"].items()}
    finally:
        fleet.shutdown()
    kinds = collections.Counter(e["kind"] for e in events)
    return prompts, outs, acts, kinds, routed, dump


def test_autoscale_episode_equals_jax(ckpt, tmp_path):
    """The reference's episode (tests/test_serve_fleet.py): an
    impossible SLO breaches, the fleet scales up past the sustain
    window, the new replica serves, sustained idle drains it back down
    (ok, no block in use), and the floor holds.  Both fleets return the
    same actions, flight-recorder counts and routing; the port's
    flightrec CLI renders the routing table from the journal."""
    got = _autoscale_episode(trouter, lambda **kw: port_fleet(
        "gpt2", ckpt["gpt2"], "t_scale", **kw), SLOConfig, tmp_path)
    ref = _autoscale_episode(jrouter, lambda **kw: jax_fleet(
        "gpt2", ckpt["gpt2"], "t_scale", **kw), JSLOConfig, tmp_path)
    prompts, outs, acts, kinds, routed, dump = got
    assert acts == ref[2]
    assert acts[:2] == [None, None]
    assert acts[2] == {"action": "up", "reason": "burn_rate",
                       "signal": acts[2]["signal"], "n_replicas": 2}
    assert acts[2]["signal"] > 1.0 and acts[3] == 2
    down = acts[5]
    assert down["action"] == "down" and down["n_replicas"] == 1
    assert down["drain"]["ok"] is True
    assert down["drain"]["blocks_in_use"] == 0
    assert acts[4] is None and acts[6] is None and acts[7] == 1
    assert kinds == ref[3]
    assert (kinds["route"], kinds["scale_up"], kinds["scale_down"],
            kinds["drain"]) == (len(outs), 1, 1, 1)
    assert routed == ref[4] and all(routed.values())
    _assert_oracle("gpt2", prompts + [prompts[0]], outs)
    doc = load_dump(dump)
    assert doc["counts_by_kind"] == dict(kinds)
    text = "\n".join(report_lines(doc))
    assert "routing table (route events by replica):" in text
    assert "last scale-ups:" in text and "last drains:" in text
