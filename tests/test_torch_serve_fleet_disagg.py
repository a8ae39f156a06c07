"""The port's disaggregated fleet and its health requeue against the
JAX package's.

The reference's fleet cases of ``tests/test_serve_disagg.py``: cold
traffic through one prefill and one decode replica (fast and staged
handoff), a prefix resident on the decode replica routed straight to
it, the construction errors, and a handoff dropped by chaos and
recovered by re-running the prompt on the decode replica.  Then the
health requeue: a frozen replica's queued prompts are moved to its
peer once a probe at an injected instant (``maybe_probe(now=...)``)
finds it dead.  Nano models in f32 on the CPU; every reply is JAX's
solo greedy continuation, and the routing and handoff counts are the
JAX fleet's on the same prompts.
"""

import asyncio
import time

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from ray_tpu.serve import chaos as jchaos  # noqa: E402
from ray_tpu.serve import health as jhealth  # noqa: E402
from ray_tpu.serve import router as jrouter  # noqa: E402
from ray_tpu_torch.serve import chaos as tchaos  # noqa: E402
from ray_tpu_torch.serve import health as thealth  # noqa: E402
from ray_tpu_torch.serve import router as trouter  # noqa: E402
from tests.test_torch_serve_continuous import (  # noqa: E402,F401
    _assert_oracle, _prompts, ckpt)
from tests.test_torch_serve_fleet import (_ENGINE_KW,  # noqa: E402
                                          jax_fleet, port_fleet)

PORT = (trouter, thealth, tchaos, port_fleet)
JAX = (jrouter, jhealth, jchaos, jax_fleet)


def _split(build, family, path, name, **kw):
    kw.setdefault("num_prefill_replicas", 1)
    kw.setdefault("num_decode_replicas", 1)
    return build(family, path, name, **kw)


def _drive(fleet, waves):
    """Each wave's prompts at once, the waves one after another;
    returns (replies, fleet_stats, the fleet's flight-recorder kinds)."""
    async def main():
        try:
            outs = []
            for wave in waves:
                outs += await asyncio.gather(*(fleet(p) for p in wave))
            return outs, fleet.fleet_stats()
        finally:
            fleet.shutdown()

    outs, st = asyncio.run(main())
    kinds = [e["kind"] for e in fleet.telemetry.flightrec.snapshot()]
    return [np.asarray(o) for o in outs], st, kinds


def _counts(st):
    return {"routed_by_policy": st["router"]["routed_by_policy"],
            "handoffs": st["router"]["handoffs"],
            "handoff": st["handoff"],
            "routed": {n.split("/")[-1]: r["routed"]
                       for n, r in st["replicas"].items()}}


@pytest.mark.parametrize("family,staged", [
    ("gpt2", False), ("llama", False), ("gpt2", True)],
    ids=["gpt2-fast", "llama-fast", "gpt2-staged"])
def test_disagg_cold_equals_jax(ckpt, family, staged):
    """7, 19, 33 and 12-token prompts at once through a 1p+1d fleet:
    each routes to the prefill replica, hands ceil(n / 16) blocks to the
    decode replica and replies with the oracle's tokens."""
    lens = (7, 19, 33, 12)
    prompts = _prompts(0, lens, lo=2)
    runs = [_drive(_split(build, family, ckpt[family], "t_cold",
                          handoff_staged=staged), [prompts])
            for *_, build in (PORT, JAX)]
    outs, st, _ = runs[0]
    _assert_oracle(family, prompts, outs)
    assert _counts(st) == _counts(runs[1][1])
    assert st["router"]["disaggregated"] is True
    assert st["router"]["routed_by_policy"]["disagg_prefill"] == 4
    assert st["router"]["handoffs"] == 4
    h = st["handoff"]
    assert (h["handoffs_out"], h["handoffs_in"]) == (4, 4)
    assert (h["staged"], h["fast_path"]) == ((4, 0) if staged else (0, 4))
    assert h["blocks_moved"] == sum(-(-n // 16) for n in lens)
    assert set(st["kv_scope"]["occupancy_by_role"]) == {"prefill",
                                                        "decode"}


def test_disagg_resident_prefix_routes_straight_to_decode(ckpt):
    """Two prompts sharing a 32-token prefix are handed off; the next
    two find its full blocks resident on the decode replica and route
    there by prefix affinity, skipping the prefill replica."""
    rng = np.random.RandomState(11)
    prefix = rng.randint(2, 500, 32)
    wave1 = [np.concatenate([prefix, rng.randint(2, 500, 3)])
             .astype(np.int32) for _ in range(2)]
    wave2 = [np.concatenate([prefix, rng.randint(2, 500, 4)])
             .astype(np.int32) for _ in range(2)]
    waves = [[p] for p in wave1 + wave2]
    runs = [_drive(_split(build, "gpt2", ckpt["gpt2"], "t_resident"),
                   waves) for *_, build in (PORT, JAX)]
    outs, st, _ = runs[0]
    _assert_oracle("gpt2", wave1 + wave2, outs)
    assert _counts(st) == _counts(runs[1][1])
    by = st["router"]["routed_by_policy"]
    assert by["disagg_prefill"] >= 1 and by["prefix_affinity"] >= 3
    assert st["handoff"]["handoffs_in"] == by["disagg_prefill"]
    assert st["handoff"]["handoffs_in"] < len(waves)


@pytest.mark.parametrize("kw", [
    dict(num_prefill_replicas=1),
    dict(num_prefill_replicas=1, num_decode_replicas=1,
         decode_engine_kw={"kv_block_size": 32})],
    ids=["both", "block-size"])
def test_build_llm_fleet_errors_carry_the_reference_messages(kw):
    def error(mod, **extra):
        with pytest.raises(ValueError) as e:
            mod.build_llm_fleet("gpt2", "nano", **_ENGINE_KW, **kw,
                                **extra)
        return str(e.value)

    assert error(trouter, device="cpu") == error(jrouter)
    with pytest.raises(ValueError, match="num_replicas must be >= 1"):
        trouter.LLMFleet(lambda: None, 0)


def test_dropped_handoff_recovers_to_the_oracle(ckpt):
    """ChaosConfig(drop_handoff_nth=2): the second package is journaled
    as handoff_dropped and its prompt re-run whole on the decode
    replica; every reply is still the oracle's, and the counts are the
    JAX fleet's."""
    prompts = _prompts(3, (7, 19, 33, 12), lo=2)
    runs = []
    for _, _, chaos, build in (PORT, JAX):
        fleet = _split(build, "gpt2", ckpt["gpt2"], "t_drop",
                       chaos=chaos.ChaosConfig(drop_handoff_nth=2))
        runs.append(_drive(fleet, [[p] for p in prompts]))
    outs, st, kinds = runs[0]
    _assert_oracle("gpt2", prompts, outs)
    assert _counts(st) == _counts(runs[1][1])
    assert sorted(kinds) == sorted(runs[1][2])
    assert kinds.count("handoff_dropped") == 1
    assert st["router"]["handoffs"] == len(prompts) - 1
    assert st["health"]["chaos"]["dropped_handoffs"] == 1


def _requeue_run(mods, path):
    """Two replicas of one slot each; replica 0 runs one wave and then
    freezes (chaos) for 200 polls of 1 ms.  Replica 1 is warmed by a
    direct call (its engine loop exists, so it can take requeued work);
    four prompts go round robin: replica 0 admits the first of its two
    and freezes with the second in its engine queue.  A probe at an
    injected instant, with replica 1 heartbeating at it, finds replica
    0 dead; the router's sweep moves that queued prompt to replica 1.
    Replica 0 thaws and finishes the request it holds."""
    router_mod, health_mod, chaos_mod, build = mods
    prompts = _prompts(4, (20, 21, 22, 23, 24), lo=2)
    fleet = build("gpt2", path, "t_requeue", num_replicas=2,
                  routing="round_robin", wfq=False, max_slots=1,
                  max_inflight_per_replica=4,
                  health=health_mod.HealthConfig(
                      suspect_ms=1e7, dead_ms=2e7, stall_ms=1e9,
                      probe_ms=1.0),
                  chaos=chaos_mod.ChaosConfig(
                      freeze_replica=0, freeze_after_waves=1,
                      freeze_waves=200, freeze_poll_ms=1.0))
    r0, r1 = fleet.router._replicas

    async def main():
        try:
            warm = await r1.inst(prompts[0])
            tasks = [asyncio.ensure_future(fleet(p)) for p in prompts[1:]]
            for _ in range(5000):
                await asyncio.sleep(0.001)
                if fleet.chaos.stats()["frozen_polls"].get(r0.name):
                    break
            queued = len(r0.inst._queue)
            t = time.perf_counter() + 3e4
            fleet.health.heartbeat(r1.name, now=t)
            fleet.health.maybe_probe(now=t)
            states = (fleet.health.state(r0.name),
                      fleet.health.state(r1.name))
            fleet.router._health_sweep()
            moved = (len(r0.inst._queue), fleet.router.requeued_on_death)
            outs = await asyncio.gather(*tasks)
            return [warm] + outs, queued, states, moved, fleet.fleet_stats()
        finally:
            fleet.shutdown()

    outs, queued, states, moved, st = asyncio.run(main())
    return prompts, [np.asarray(o) for o in outs], queued, states, \
        moved, st


def test_health_requeue_moves_a_dead_replicas_queue(ckpt):
    got = _requeue_run(PORT, ckpt["gpt2"])
    ref = _requeue_run(JAX, ckpt["gpt2"])
    prompts, outs, queued, states, moved, st = got
    _assert_oracle("gpt2", prompts, outs)
    assert (queued, states, moved) == ref[2:5]
    assert queued == 1 and states == ("dead", "healthy")
    assert moved == (0, 1)
    assert st["health"]["requeued_on_death"] == 1
    assert st["router"]["requeued_on_death"] == 1
    assert st["replicas"]["t_requeue/r0"]["routed"] == 2
    assert ref[5]["health"]["requeued_on_death"] == 1
