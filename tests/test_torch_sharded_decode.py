"""Tensor-parallel decode and mesh-sharded serving of the port against
the JAX package's, following tests/test_sharded_decode.py.

Host-only parts (no rank runs): ``cache_logical_axes``, the
divisibility guard and the parameter and pool placements on a
``fake_mesh``, against the JAX package's on its fake CPU devices.

The rest runs on 2 gloo ranks with tensor=2 (tests/_torch_seq_ranks.py
``prog_tp_decode``, one launch): each family's paged decode and
prefix-reuse prefill on this rank's blocks, the continuous engine's two
admission waves under the mesh (rank 0 serves, rank 1 follows), and a
sharded Data batch.  The oracles are the JAX package's: its dense
generate and prefill, and its continuous engine on a tensor=2 mesh of
two fake CPU devices (which its own test holds to the dense generate).
Greedy tokens must be JAX's; where a token parts, the two tokens must
be at a near-tie of the oracle's own logits (1e-4 of the row's max
|logit|, PERF.md §2): the row-parallel all-reduce sums in another order
than one device does.
"""

import asyncio
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ray_tpu.models import (gpt2_config, gpt2_init, gpt2_logical_axes,
                            llama_config, llama_init, llama_logical_axes)
from ray_tpu.models import gpt2_decode, llama_decode
from ray_tpu.models import decode_common as jdc
from ray_tpu.parallel import MeshSpec as JMeshSpec
from ray_tpu.parallel import fake_mesh as jfake_mesh
from ray_tpu.parallel import sharding as jsh
from ray_tpu_torch.models import decode_common as tdc
from ray_tpu_torch.models import gpt2 as tg
from ray_tpu_torch.models import gpt2_decode as tgd
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.models import llama_decode as tld
from ray_tpu_torch.parallel import MeshSpec, fake_mesh
from ray_tpu_torch.parallel import sharding as tsh
from tests import _torch_mesh_ranks as ranks

BS = 16
TIE = 1e-4
# the prefix-reuse logits (tests/test_sharded_decode.py:186)
LOGIT_ATOL = 1e-4
_OVR = {"dtype": jnp.float32, "use_flash": False, "remat": False}
FAMILIES = ("gpt2", "llama")


def _jax_family(name):
    if name == "gpt2":
        cfg = gpt2_config("nano", **_OVR)
        return (cfg, gpt2_init(jax.random.PRNGKey(0), cfg),
                gpt2_logical_axes(cfg), gpt2_decode.prefill,
                gpt2_decode.init_paged_cache, gpt2_decode.generate)
    cfg = llama_config("nano", **_OVR)
    return (cfg, llama_init(jax.random.PRNGKey(0), cfg),
            llama_logical_axes(cfg), llama_decode.llama_prefill,
            llama_decode.llama_init_paged_cache,
            llama_decode.llama_generate)


def _port_cfg(name):
    import torch

    ovr = dict(dtype=torch.float32, use_flash=False, remat=False)
    return tg.gpt2_config("nano", **ovr) if name == "gpt2" else \
        tl.llama_config("nano", **ovr)


# ---------------------------------------------------------------------------
# host-only: the shardings on a fake mesh
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def meshes():
    return (fake_mesh(8, MeshSpec(data=4, tensor=2)),
            jfake_mesh(8, JMeshSpec(data=4, tensor=2)))


def test_divisibility_guard_as_jax(meshes):
    tmesh, jmesh = meshes
    for shape, axes in (((4, 2, 32), (None, "heads", None)),
                        ((4, 1, 32), (None, "kv_heads", None)),
                        ((3,), ("mlp",)), ((8, 512), ("vocab", None))):
        got = tsh.mesh_axes_for_shape(shape, axes, tmesh, tsh.DECODE_RULES)
        want = jsh.mesh_axes_for_shape(shape, axes, jmesh, jsh.DECODE_RULES)
        assert tuple(got) == tuple(want), (shape, axes)


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_cache_logical_axes_as_jax(layout):
    cache = {"k": 0, "v": 0, "pos": 0, "start": 0}
    if layout == "paged":
        cache["block_tables"] = 0
    assert tdc.cache_logical_axes(cache) == jdc.cache_logical_axes(cache)


def _specs(tree):
    if isinstance(tree, dict):
        return {k: _specs(v) for k, v in tree.items()}
    return tuple(tree.spec)


@pytest.mark.parametrize("family", FAMILIES)
def test_params_and_pool_placements_as_jax(meshes, family):
    """Each parameter's and pool leaf's PartitionSpec under DECODE_RULES
    equals JAX's; llama nano's one KV head replicates (the GQA guard)
    while its two query heads split."""
    import torch

    tmesh, jmesh = meshes
    jcfg, jparams, jaxes, _, jinit_paged, _ = _jax_family(family)
    cfg = _port_cfg(family)
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    tparams = jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)),
                                     np_params)
    got = _specs(tsh.shardings_by_shape(tparams, jaxes, tmesh,
                                        tsh.DECODE_RULES))
    want = _specs(jsh.shardings_by_shape(jparams, jaxes, jmesh,
                                         jsh.DECODE_RULES))
    assert got == want
    init = tgd.init_paged_cache if family == "gpt2" else \
        tld.llama_init_paged_cache
    meta = init(cfg, 2, num_blocks=17, block_size=BS, device="meta")
    jcache = jinit_paged(jcfg, 2, num_blocks=17, block_size=BS, mesh=jmesh)
    got = _specs(tdc.cache_shardings(meta, tmesh))
    want = {k: tuple(v.sharding.spec) for k, v in jcache.items()}
    for k in want:      # JAX prints trailing Nones the port drops
        assert tuple(s for s in want[k] if s) == \
            tuple(s for s in got[k] if s), k
    kspec = got["k"]
    assert kspec == ((None, None, None, "tensor") if family == "gpt2"
                     else ())


# ---------------------------------------------------------------------------
# 2 gloo ranks, tensor=2
# ---------------------------------------------------------------------------

def _cases(tmp_path_factory):
    cases, np_params = {}, {}
    for family in FAMILIES:
        cfg, params, *_ = _jax_family(family)
        np_params[family] = jax.tree_util.tree_map(np.asarray, params)
        path = tmp_path_factory.mktemp("ckpt") / f"{family}.pkl"
        with open(path, "wb") as f:
            pickle.dump(np_params[family], f)
        rng = np.random.RandomState(3)
        prompt = rng.randint(2, cfg.vocab_size, 9).astype(np.int32)
        rng = np.random.RandomState(7)
        shared = rng.randint(2, cfg.vocab_size, 32).astype(np.int32)
        a = np.concatenate([shared, rng.randint(2, cfg.vocab_size, 3)
                            .astype(np.int32)])
        b = np.concatenate([shared, rng.randint(2, cfg.vocab_size, 3)
                            .astype(np.int32)])
        rng = np.random.RandomState(21)
        prompts = [rng.randint(2, 500, n).astype(np.int32)
                   for n in (9, 23, 9, 23, 9, 23)]
        cases[family] = dict(prompt=prompt, new=6, a=a, b=b, reuse_new=4,
                             ckpt=str(path), prompts=prompts, engine_new=5)
    cases["churn"] = _churn_prompts()
    return np_params, cases


def _churn_prompts():
    """tests/test_torch_serve_continuous.py's churn: 6 rotating 48-token
    prefixes and short tails, 3 laps, through a 12-block pool."""
    rng = np.random.RandomState(11)
    prefixes = [rng.randint(2, 300, size=48).astype(np.int32)
                for _ in range(6)]
    return [np.concatenate([prefixes[i], np.int32([i % 7 + 2]),
                            rng.randint(2, 300, size=4).astype(np.int32)])
            for _ in range(3) for i in range(6)]


@pytest.fixture(scope="module")
def tp(tmp_path_factory):
    np_params, cases = _cases(tmp_path_factory)
    outs = ranks.launch("tests._torch_seq_ranks:prog_tp_decode", 2,
                        np_params, cases)
    return cases, outs


def _check_stream(family, prompt, got, want):
    """got == want (the oracle's greedy continuation of ``prompt``) up
    to a parting at a near-tie of the oracle's logits there; nothing
    after a parting is compared (the sequences differ from it on)."""
    got, want = list(got), list(want)
    for i, (g, w) in enumerate(zip(got, want)):
        if g == w:
            continue
        cfg, params, _, prefill, _, _ = _jax_family(family)
        seq = np.concatenate([prompt, np.asarray(want[:i], np.int32)])
        row = np.asarray(prefill(params, jnp.asarray(seq[None]), cfg)[0])[0]
        gap = abs(row[g] - row[w])
        assert gap <= TIE * np.abs(row).max(), (family, i, g, w, gap)
        return
    assert len(got) == len(want)


def _oracle(family, prompts, new):
    cfg, params, *_, generate = _jax_family(family)
    out = np.asarray(generate(params, jnp.asarray(np.stack(prompts)), cfg,
                              max_new_tokens=new, temperature=0.0))
    return [row[len(p):] for row, p in zip(out, prompts)]


@pytest.mark.parametrize("family", FAMILIES)
def test_tp_paged_decode_gives_jax_tokens(tp, family):
    cases, outs = tp
    c = cases[family]
    want = _oracle(family, [c["prompt"]], c["new"])[0]
    for r in range(2):
        got = outs[r][family]["decode"]
        _check_stream(family, c["prompt"], got["stream"], want)
    # the ranks computed on halves: half the pool's heads (gpt2; llama's
    # one KV head whole) and half the vocab rows
    assert outs[0][family]["decode"]["k_heads"] == 1
    assert outs[0][family]["decode"]["wte_rows"] == 256
    for a, b in zip(outs[0][family]["decode"]["logits"],
                    outs[1][family]["decode"]["logits"]):
        np.testing.assert_array_equal(a, b)   # every rank gathers all


@pytest.mark.parametrize("family", FAMILIES)
def test_tp_prefix_reuse_prefill_gives_jax_logits_and_tokens(tp, family):
    cases, outs = tp
    c = cases[family]
    cfg, params, _, prefill, _, _ = _jax_family(family)
    b = c["b"]
    want, _ = prefill(params, jnp.asarray(b[None]), cfg,
                      lengths=jnp.asarray([len(b)]))
    got = outs[0][family]["reuse"]
    np.testing.assert_allclose(got["got"], np.asarray(want)[0],
                               atol=LOGIT_ATOL)
    oracle = _oracle(family, [c["a"], b], c["reuse_new"])
    for row, prompt in enumerate((c["a"], b)):
        _check_stream(family, prompt, got["streams"][row], oracle[row])


def _jax_engine(family, c):
    from ray_tpu.serve.llm import build_llm_deployment as jbuild

    dep = jbuild(family, "nano", max_new_tokens=c["engine_new"],
                 temperature=0.0, scheduler="continuous",
                 kv_layout="paged", kv_block_size=BS, prefill_bucket=16,
                 max_slots=3, mesh=jfake_mesh(2, JMeshSpec(tensor=2)),
                 checkpoint_path=c["ckpt"], config_overrides=_OVR)

    async def main():
        inst = dep.func_or_class()
        try:
            outs = await asyncio.wait_for(
                asyncio.gather(*[inst(p) for p in c["prompts"]]), 300)
            stats = inst.engine_stats()
        finally:
            inst.shutdown_engine()
        return outs, stats

    return asyncio.run(main())


@pytest.mark.parametrize("family", FAMILIES)
def test_continuous_engine_two_waves_under_mesh_as_jax(tp, family):
    """6 requests through 3 slots on the tensor=2 engine (rank 0 serves,
    rank 1 follows and refuses a request of its own): JAX's engine's
    greedy continuations, its engine_stats()["mesh"] block, the pool
    split as JAX's, and the programs under JAX's sharded names."""
    cases, outs = tp
    c = cases[family]
    want_outs, want = _jax_engine(family, c)
    got = outs[0][family]["engine"]
    for p, g, w in zip(c["prompts"], got["outs"], want_outs):
        np.testing.assert_array_equal(g[:len(p)], p)
        _check_stream(family, p, g[len(p):], np.asarray(w)[len(p):])
    assert got["finished"] == want["requests"]["finished"] == 6
    assert set(got["mesh"]) == set(want["mesh"])
    for k in ("axes", "n_devices", "kv_shards"):
        assert got["mesh"][k] == want["mesh"][k], k
    assert len(got["mesh"]["devices"]) == len(want["mesh"]["devices"]) == 2
    assert set(got["mesh"]["devices"][0]) == set(want["mesh"]["devices"][0])
    for k in ("tensor_shards", "pool_bytes", "pool_bytes_per_chip"):
        assert got["kv"][k] == want["kv_cache"][k], k
    assert set(got["programs"]) <= set(want["programs"])
    assert all(p.startswith("serve.sharded_") for p in got["programs"])
    follower = outs[1][family]["engine"]
    assert follower["followed"] > 0
    assert "follow()" in follower["refused"]


def test_sharded_data_batch_gives_each_rank_its_rows(tp):
    _, outs = tp
    for r in range(2):
        batches = outs[r]["batches"]
        assert len(batches) == 3
        for i, b in enumerate(batches):
            x, shape, placements = b["x"]
            assert shape == (4,) and "Shard(dim=0)" in placements
            np.testing.assert_array_equal(
                x, np.arange(4 * i + 2 * r, 4 * i + 2 * r + 2,
                             dtype=np.float32))
            y, shape, _ = b["y"]
            assert shape == (4, 2) and y.dtype == np.float32
            np.testing.assert_array_equal(
                y, np.arange(24).reshape(12, 2)[4 * i + 2 * r:
                                                4 * i + 2 * r + 2])


def test_bench_time_decode_over_the_mesh(tp):
    """time_decode(mesh=) on the tensor=2 mesh: n_chips 2, and the
    greedy tokens of the same call without a mesh."""
    _, outs = tp
    for r in range(2):
        got = outs[r]["bench"]
        assert got["n_chips"] == 2
        np.testing.assert_array_equal(got["tokens"], got["alone"])


def test_run_traffic_over_the_mesh(tp):
    """run_traffic(mesh=) on the tensor=2 mesh: rank 0 drives the
    traffic and reports the engine's mesh block; rank 1 follows and
    returns None."""
    _, outs = tp
    got = outs[0]["traffic"]
    assert got["completed"] == 4
    assert {k: got["mesh"][k] for k in ("axes", "n_devices",
                                        "kv_shards")} == \
        {"axes": {"tensor": 2}, "n_devices": 2, "kv_shards": 2}
    assert outs[1]["traffic"] is None


def test_spec_tier_and_handoff_engines_under_the_mesh(tp):
    """Under the tensor=2 mesh, a speculative engine with the host tier
    and a prefill/decode pair give the replies they give without a mesh
    (rank 0, the same greedy requests), with the tier's spills and
    restores and the pager's counts alike: whole rows leave a split
    pool and the right heads land in one.  Rank 1 followed the three
    engines in one loop."""
    _, outs = tp
    got, want = outs[0]["extras"]["mesh"], outs[0]["extras"]["alone"]
    for g, w in zip(got[0] + got[1], want[0] + want[1]):
        np.testing.assert_array_equal(g, w)
    assert len(got[0]) == 18 and len(got[1]) == 4
    kv, kv_alone = dict(got[2]["kv_cache"]), dict(want[2]["kv_cache"])
    # the pool's heads split two ways: half the bytes on each card
    assert (kv.pop("tensor_shards"), kv_alone.pop("tensor_shards")) == (2, 1)
    assert 2 * kv.pop("pool_bytes_per_chip") == \
        kv_alone.pop("pool_bytes_per_chip")
    assert kv == kv_alone
    for k in ("saves", "hits", "tokens_restored"):
        assert got[2]["kv_tier"][k] == want[2]["kv_tier"][k], k
    assert got[2]["kv_tier"]["hits"] > 0
    assert outs[1]["extras"]["followed"] > 0


def test_graftcheck_sharded_decode_spec_on_the_ranks(tp):
    """graftcheck's gpt2_sharded_decode_step (skipped below 2 ranks in
    the one-process run) on each tensor=2 rank: clean, its
    collectives dispatched, its per-rank peak under the per-chip budget
    and under the whole paged step's (the pool is split)."""
    from ray_tpu_torch.tools.graftcheck.programs import default_programs
    from ray_tpu_torch.tools.graftcheck.trace_audit import audit_program

    _, outs = tp
    whole, = [s for s in default_programs()
              if s.name == "gpt2_paged_decode_step"]
    _, whole_info = audit_program(whole)
    for out in outs:
        g = out["graftcheck"]
        assert g["violations"] == [], g
        info = g["info"]
        assert 0 < info["per_chip_hbm_bytes"] \
            <= info["per_chip_hbm_budget_bytes"]
        assert info["per_chip_hbm_bytes"] < whole_info["peak_hbm_bytes"]
