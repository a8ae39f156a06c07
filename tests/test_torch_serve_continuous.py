"""The port's continuous scheduler against the JAX package's.

GPT-2 nano and llama nano are initialized by JAX, pickled as numpy and
served by the port's engine through ``checkpoint_path`` on the CPU in
f32 (plain attention).  The oracle is the JAX dense solo greedy
``generate`` (``llama_generate``) of each prompt, as in
``tests/test_serve_paged.py``: whatever the pool shares, forks, evicts,
chunks or spills, every request must get that continuation token for
token.  Where the reference's engine can be asked the same (its pager
stats, its stop matching, its rejection message), the JAX continuous
engine runs the same request sequence beside the port's.
"""

import asyncio
import functools
import gc
import pickle
import weakref

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from ray_tpu.models import gpt2 as jgpt2  # noqa: E402
from ray_tpu.models import gpt2_decode as jdec  # noqa: E402
from ray_tpu.models import llama as jllama  # noqa: E402
from ray_tpu.models import llama_decode as jldec  # noqa: E402
from ray_tpu.serve import llm as jllm  # noqa: E402
from ray_tpu_torch.models.decode_common import (SamplingParams,  # noqa: E402
                                                init_pool)
from ray_tpu_torch.models.gpt2 import gpt2_config  # noqa: E402
from ray_tpu_torch.serve import build_llm_deployment  # noqa: E402
from ray_tpu_torch.serve.llm import _engine_fns, _family_fns  # noqa: E402

MAX_NEW = 6
_JOVR = {"dtype": jnp.float32, "use_flash": False, "remat": False}
_TOVR = {"dtype": torch.float32}
FAMILIES = ("gpt2", "llama")


@functools.lru_cache(maxsize=None)
def _jax_model(family):
    if family == "gpt2":
        cfg = jgpt2.gpt2_config("nano", **_JOVR)
        return cfg, jgpt2.gpt2_init(jax.random.PRNGKey(0), cfg)
    cfg = jllama.llama_config("nano", **_JOVR)
    return cfg, jllama.llama_init(jax.random.PRNGKey(0), cfg)


@functools.lru_cache(maxsize=None)
def _jax_generate(family, max_new):
    cfg, _ = _jax_model(family)
    gen = jdec.generate if family == "gpt2" else jldec.llama_generate
    return jax.jit(lambda p, t: gen(p, t, cfg, max_new_tokens=max_new,
                                    temperature=0.0))


_ORACLE = {}


def oracle(family, prompt, max_new=MAX_NEW):
    """JAX dense solo greedy continuation — the parity reference."""
    key = (family, max_new, tuple(int(t) for t in prompt))
    if key not in _ORACLE:
        _, params = _jax_model(family)
        out = _jax_generate(family, max_new)(
            params, jnp.asarray(np.asarray(prompt, np.int32))[None])
        _ORACLE[key] = np.asarray(out)[0]
    return _ORACLE[key]


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    d = tmp_path_factory.mktemp("ckpt")
    paths = {}
    for family in FAMILIES:
        paths[family] = str(d / f"{family}_nano.pkl")
        with open(paths[family], "wb") as f:
            pickle.dump(jax.tree.map(np.asarray, _jax_model(family)[1]), f)
    return paths


def _kw(kw):
    kw.setdefault("max_new_tokens", MAX_NEW)
    kw.setdefault("temperature", 0.0)
    kw.setdefault("scheduler", "continuous")
    kw.setdefault("kv_block_size", 16)
    kw.setdefault("prefill_bucket", 16)
    return kw


def _port(family, path, **kw):
    return build_llm_deployment(family, "nano", checkpoint_path=path,
                                device="cpu", config_overrides=_TOVR,
                                **_kw(kw)).func_or_class()


def _jax_engine(family, path, **kw):
    return jllm.build_llm_deployment(family, "nano", checkpoint_path=path,
                                     config_overrides=_JOVR,
                                     **_kw(kw)).func_or_class()


def _drive(inst, prompts, *, sequential=False, sampling=None):
    """All prompts through one engine instance (concurrently unless
    ``sequential``); ``sampling`` is one SamplingParams (or None) per
    prompt.  Returns the replies; the engine is shut down after."""
    sampling = sampling or [None] * len(prompts)

    async def main():
        try:
            if sequential:
                return [await inst(p, sp) for p, sp in
                        zip(prompts, sampling)]
            return await asyncio.gather(*(inst(p, sp) for p, sp in
                                          zip(prompts, sampling)))
        finally:
            inst.shutdown_engine()

    return [np.asarray(o) for o in asyncio.run(main())]


def _both(family, path, prompts, *, sequential=False, port=None, **kw):
    """The port's engine (``port``, or one built from ``kw``) and the
    JAX engine on the same requests: (the port's engine, its replies,
    JAX's replies, JAX's engine_stats)."""
    port = port or _port(family, path, **kw)
    outs = _drive(port, prompts, sequential=sequential)
    ref = _jax_engine(family, path, **kw)
    ref_outs = _drive(ref, prompts, sequential=sequential)
    return port, outs, ref_outs, ref.engine_stats()


def _assert_oracle(family, prompts, outs, max_new=MAX_NEW):
    for p, o in zip(prompts, outs):
        assert o.dtype == np.int32 and o.shape == (len(p) + max_new,)
        np.testing.assert_array_equal(o, oracle(family, p, max_new))


def _assert_blocks_hold_their_keys(inst):
    """Every block the pager indexes holds what a dense prefill of its
    key writes at the key's last block_size positions (f32, within
    1e-5): the check of block CONTENT that token equality at nano size
    can miss (a nano model's greedy tokens barely move when a few
    positions' K/V are wrong)."""
    pager, cache = inst._pager, inst._cache
    fam = _family_fns("llama" if hasattr(inst.cfg, "n_kv_head")
                      else "gpt2")
    bs = pager.block_size
    assert pager._index
    with torch.no_grad():
        for key, blk in pager._index.items():
            _, dense = fam.prefill(inst.params,
                                   torch.tensor(key, dtype=torch.int32)[None],
                                   inst.cfg)
            for name in ("k", "v"):
                torch.testing.assert_close(
                    cache[name][:, blk], dense[name][:, 0, len(key) - bs:
                                                     len(key)],
                    atol=1e-5, rtol=1e-5)


def _prompts(seed, lengths, lo=1, hi=500):
    rng = np.random.RandomState(seed)
    return [rng.randint(lo, hi, size=n).astype(np.int32) for n in lengths]


# ---------------------------------------------------------------------------
# the slot pool: two waves through fewer slots than requests
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layout", ["dense", "paged"])
@pytest.mark.parametrize("family", FAMILIES)
def test_two_waves_through_three_slots_match_the_jax_oracle(ckpt, family,
                                                            layout):
    """16 ragged requests through max_slots=3: wave 2 is submitted once
    the first reply of wave 1 is back, so it is admitted mid-flight as
    slots free (tests/test_serve_llm.py:125)."""
    prompts = _prompts(1, [3, 9, 5, 7] * 4)
    inst = _port(family, ckpt[family], kv_layout=layout, max_slots=3,
                 prefill_bucket=8)

    async def main():
        try:
            wave1 = [asyncio.ensure_future(inst(p)) for p in prompts[:8]]
            await asyncio.wait(wave1, timeout=120,
                               return_when=asyncio.FIRST_COMPLETED)
            assert 0 < sum(f.done() for f in wave1) < 8
            wave2 = [asyncio.ensure_future(inst(p)) for p in prompts[8:]]
            return await asyncio.wait_for(
                asyncio.gather(*wave1, *wave2), timeout=120)
        finally:
            inst.shutdown_engine()

    _assert_oracle(family, prompts, asyncio.run(main()))
    stats = inst.kv_stats()
    if layout == "paged":
        assert stats["kv_cache"]["blocks_in_use"] == 0
    else:
        assert stats["kv_cache"] is None


# ---------------------------------------------------------------------------
# the block pager through the engine: prefix reuse, COW, exhaustion
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("family", FAMILIES)
def test_shared_prefix_stats_equal_the_jax_engine(ckpt, family):
    """Two requests sharing a 32-token prefix, one after the other:
    the second reuses the first's blocks, both continuations are the
    oracle's, and the pager's stats equal the JAX engine's
    engine_stats()["kv_cache"] (tests/test_serve_paged.py:81)."""
    rng = np.random.RandomState(11)
    shared = rng.randint(2, 500, 32)
    a = np.concatenate([shared, rng.randint(2, 500, 3)]).astype(np.int32)
    b = np.concatenate([shared, rng.randint(2, 500, 2)]).astype(np.int32)
    port, outs, _, ref_stats = _both(family, ckpt[family], [a, b],
                                     sequential=True, kv_layout="paged")
    stats = port.kv_stats()
    _assert_oracle(family, [a, b], outs)
    _assert_blocks_hold_their_keys(port)
    assert stats["kv_cache"] == ref_stats["kv_cache"]
    assert stats["kv_cache"]["prefix_block_hits"] >= 2
    assert stats["kv_cache"]["blocks_in_use"] == 0


def test_identical_prompt_cow_divergence(ckpt):
    """A prompt fully matching a resident one forks the boundary block
    (copy-on-write) instead of writing into it, and still gets the
    oracle's continuation (tests/test_serve_paged.py:113)."""
    p = np.random.RandomState(12).randint(2, 500, 48).astype(np.int32)
    port = _port("gpt2", ckpt["gpt2"], kv_layout="paged")
    forks = []
    copy_block = port._fns.copy_block

    def spy(cache, src, dst):
        forks.append((src, dst))
        return copy_block(cache, src, dst)

    port._fns.copy_block = spy
    port, outs, _, ref_stats = _both("gpt2", ckpt["gpt2"], [p, p],
                                     sequential=True, port=port,
                                     kv_layout="paged")
    stats = port.kv_stats()
    _assert_oracle("gpt2", [p, p], outs)
    assert stats["kv_cache"] == ref_stats["kv_cache"]
    # the fork holds the shared block's first 15 positions (the 16th,
    # token 47, is the tail the second request wrote itself)
    (src, dst), = forks
    for name in ("k", "v"):
        assert torch.equal(port._cache[name][:, dst, :15],
                           port._cache[name][:, src, :15])
    assert stats["kv_cache"]["cow_copies"] >= 1
    assert stats["kv_cache"]["prefix_block_hits"] >= 1


def test_pool_exhaustion_requeues_and_recycles(ckpt):
    """A pool of the minimum legal size (null + 8 blocks) holds one
    5-block request at a time: concurrent admissions requeue at the
    head and later ones evict earlier prompts' cached blocks; every
    reply is the oracle's and the pager ends as the JAX engine's
    (tests/test_serve_paged.py:141)."""
    rng = np.random.RandomState(13)
    prompts = [rng.randint(2, 500, rng.randint(66, 74)).astype(np.int32)
               for _ in range(3)]
    port, outs, _, ref_stats = _both("gpt2", ckpt["gpt2"], prompts,
                                     kv_layout="paged", kv_num_blocks=9,
                                     max_slots=2)
    stats = port.kv_stats()
    _assert_oracle("gpt2", prompts, outs)
    assert stats["kv_cache"] == ref_stats["kv_cache"]
    assert stats["kv_cache"]["evictions"] >= 1
    assert stats["kv_cache"]["blocks_in_use"] == 0
    assert stats["requeues"] >= 1


# ---------------------------------------------------------------------------
# chunked prefill (tests/test_chunked_prefill.py:99,112,145)
# ---------------------------------------------------------------------------


def _chunked(family, path, **kw):
    return _port(family, path, kv_layout="paged", max_slots=4,
                 prefill_chunk_tokens=32, **kw)


@pytest.mark.parametrize("family", FAMILIES)
def test_chunked_cold_prompts_match_the_jax_oracle(ckpt, family):
    """70 → 3 chunks (32/32/6), 9 → one-shot, 100 → 4 chunks, 33 → 2
    chunks (32/1): 9 chunks over 3 requests, 6 of them partial."""
    prompts = _prompts(0, (70, 9, 100, 33), lo=2)
    inst = _chunked(family, ckpt[family])
    _assert_oracle(family, prompts, _drive(inst, prompts))
    kv = inst.kv_stats()["kv_cache"]
    assert kv["partial_fills"] == 6
    assert kv["fill_tokens"] == 70 + 100 + 33
    assert kv["blocks_in_use"] == 0


@pytest.mark.parametrize("family", FAMILIES)
def test_chunked_resident_prefix_matches_the_jax_oracle(ckpt, family):
    """The second request reuses the first's registered prefix blocks,
    so its cursor starts at filled=32: A (72 cold) chunks 32/32/8, B
    fills only its 38-token tail (32/6)."""
    rng = np.random.RandomState(7)
    shared = rng.randint(2, 500, 32)
    a = np.concatenate([shared, rng.randint(2, 500, 40)]).astype(np.int32)
    b = np.concatenate([shared, rng.randint(2, 500, 38)]).astype(np.int32)
    inst = _chunked(family, ckpt[family])
    _assert_oracle(family, [a, b], _drive(inst, [a, b], sequential=True))
    _assert_blocks_hold_their_keys(inst)
    kv = inst.kv_stats()["kv_cache"]
    assert kv["prefix_block_hits"] >= 2
    assert kv["partial_fills"] == 3
    assert kv["fill_tokens"] == 72 + 38


def test_chunk_equal_to_prompt_stays_one_shot(ckpt):
    prompts = _prompts(5, (32, 16, 9), lo=2)
    inst = _chunked("gpt2", ckpt["gpt2"])
    _assert_oracle("gpt2", prompts, _drive(inst, prompts))
    kv = inst.kv_stats()["kv_cache"]
    assert kv["partial_fills"] == 0 and kv["fill_tokens"] == 0


# ---------------------------------------------------------------------------
# the host KV tier: spill on eviction, restore by copy
# ---------------------------------------------------------------------------


def _churn_prompts():
    """6 rotating 48-token (3-block) prefixes + unique short tails, 3
    laps (tests/test_kv_tier.py): a 12-block pool cannot hold the 18
    prefix blocks, so every lap re-admits prefixes the previous lap
    evicted."""
    rng = np.random.RandomState(11)
    prefixes = [rng.randint(2, 300, size=48).astype(np.int32)
                for _ in range(6)]
    prompts = []
    for _ in range(3):
        for i in range(6):
            tail = rng.randint(2, 300, size=4).astype(np.int32)
            prompts.append(np.concatenate(
                [prefixes[i], np.int32([i % 7 + 2]), tail]))
    return prompts


def test_host_tier_spills_and_restores_to_the_oracle(ckpt):
    """Evicted prefix blocks spill to the host tier and later prompts
    restore them by copy instead of re-prefill: replies equal the
    oracle's, and the pager's and the tier's counters equal the JAX
    engine's on the same sequence (copy times aside)."""
    prompts = _churn_prompts()
    port, outs, _, ref_stats = _both(
        "gpt2", ckpt["gpt2"], prompts, sequential=True, kv_layout="paged",
        max_slots=2, max_new_tokens=3, kv_num_blocks=12,
        kv_host_tier_bytes=1 << 24)
    stats = port.kv_stats()
    _assert_oracle("gpt2", prompts, outs, max_new=3)
    assert stats["kv_cache"] == ref_stats["kv_cache"]
    _assert_blocks_hold_their_keys(port)
    tier, ref_tier = stats["kv_tier"], ref_stats["kv_tier"]
    for name in ("h2d_ms", "d2h_ms"):
        tier.pop(name)
        ref_tier.pop(name)
    assert tier == ref_tier
    assert tier["hits"] > 0 and tier["saves"] > 0
    assert tier["tokens_restored"] > 0
    scope = stats["kv_scope"]["forensics"]
    assert scope["tier_hits"] == tier["hits"]
    assert scope["reprefill_waste_tokens"] == \
        ref_stats["kv_scope"]["forensics"]["reprefill_waste_tokens"]


# ---------------------------------------------------------------------------
# stop matching, per-request sampling, the generator, rejection
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_eos_and_stop_sequences_equal_the_jax_engine(ckpt, layout):
    """eos_id and a stop sequence taken from the oracle's own
    continuations, so both fire: the replies (cut short where a stop
    fires) equal the JAX continuous engine's."""
    prompts = _prompts(3, (12, 20, 7, 30))
    o0, o1 = (oracle("gpt2", p) for p in prompts[:2])
    eos = int(o0[12 + 2])
    stop = [int(t) for t in o1[20 + 1:20 + 3]]
    _, outs, ref_outs, _ = _both("gpt2", ckpt["gpt2"], prompts,
                                 kv_layout=layout, max_slots=2,
                                 eos_id=eos, stop_sequences=[stop])
    for got, want in zip(outs, ref_outs):
        np.testing.assert_array_equal(got, want)
    # each reply ends at the first eos or stop sequence it generates
    assert outs[0][-1] == eos and outs[0].shape[0] <= 12 + 3
    assert outs[1][-1] == eos or outs[1][-2:].tolist() == stop
    assert outs[1].shape[0] <= 20 + 3


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_per_request_top_k_1_override_equals_greedy(ckpt, layout):
    """SamplingParams(temperature=1, top_k=1) per request samples from
    the top token alone: greedy, through the logits path and the
    per-SamplingParams sampler, mixed in one pool with default
    requests."""
    prompts = _prompts(1, [3, 9, 5, 7] * 2)
    sp = SamplingParams(temperature=1.0, top_k=1)
    inst = _port("gpt2", ckpt["gpt2"], kv_layout=layout, max_slots=3)
    outs = _drive(inst, prompts, sampling=[sp, None] * 4)
    _assert_oracle("gpt2", prompts, outs)
    # one sampler per distinct SamplingParams of a mixed step
    assert set(inst._samplers) == {sp, SamplingParams()}


def test_sampled_run_repeats_under_one_seed(ckpt):
    """temperature 1, top_k 40: two engines of one seed give the same
    replies; another seed gives others."""
    prompts = _prompts(2, [5, 9, 5, 12, 30, 8])

    def run(seed):
        inst = _port("gpt2", ckpt["gpt2"], kv_layout="paged", max_slots=3,
                     temperature=1.0, top_k=40, seed=seed)
        return _drive(inst, prompts)

    first, again, other = run(7), run(7), run(8)
    for a, b in zip(first, again):
        np.testing.assert_array_equal(a, b)
    assert any(not np.array_equal(a, c) for a, c in zip(first, other))


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_oversized_prompt_raises_the_reference_message(ckpt, layout):
    too_long = np.arange(1, 126, dtype=np.int32)   # 125 + 6 > 128

    def errors(inst):
        async def main():
            try:
                got = await asyncio.gather(
                    inst(too_long), inst(np.zeros(0, np.int32)),
                    inst(np.arange(1, 4, dtype=np.int32)),
                    return_exceptions=True)
            finally:
                inst.shutdown_engine()
            return got

        return asyncio.run(main())

    got = errors(_port("gpt2", ckpt["gpt2"], kv_layout=layout))
    want = errors(_jax_engine("gpt2", ckpt["gpt2"], kv_layout=layout))
    for g, w in zip(got[:2], want[:2]):
        assert isinstance(g, ValueError) and str(g) == str(w)
    assert "prompt length 125 invalid for max_seq=128" in str(got[0])
    # the pool stays healthy for well-sized requests
    np.testing.assert_array_equal(got[2], oracle("gpt2", np.arange(1, 4)))


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_idle_slot_past_max_seq(ckpt, layout):
    """Slot 1 stays idle while two 100-token generations run in slot 0
    one after the other: ~200 pool steps, past max_seq=128.  Parked
    before each step, the idle row raises nothing and the active row's
    replies are the oracle's."""
    prompts = _prompts(4, (8, 8))
    inst = _port("gpt2", ckpt["gpt2"], kv_layout=layout, max_slots=2,
                 max_new_tokens=100)
    outs = _drive(inst, prompts, sequential=True)
    _assert_oracle("gpt2", prompts, outs, max_new=100)


@pytest.mark.parametrize("kw", [
    {"kv_layout": "dense"}, {"kv_layout": "paged"},
    {"kv_layout": "paged", "prefill_chunk_tokens": 32},
    {"kv_layout": "paged", "kv_host_tier_bytes": 1 << 20,
     "kv_num_blocks": 9}], ids=["dense", "paged", "chunk", "tier"])
def test_served_engine_is_freed_on_del(ckpt, kw):
    """A served and shut-down engine is in no reference cycle: dropping
    the last reference frees it (and its device pool) at once, without
    waiting for the cycle collector."""
    gc.disable()
    try:
        inst = _port("gpt2", ckpt["gpt2"], max_slots=2, **kw)
        _drive(inst, _prompts(6, (70, 9, 40, 100)))
        ref = weakref.ref(inst)
        del inst
        assert ref() is None
    finally:
        gc.enable()


# ---------------------------------------------------------------------------
# the engine's device functions
# ---------------------------------------------------------------------------


def test_save_block_copies_and_install_blocks_restores():
    cfg = gpt2_config("nano", dtype=torch.float32)
    fns = _engine_fns(_family_fns("gpt2"), cfg)
    cache = init_pool(cfg, cfg.n_head, 2, 6, 16, "cpu")
    cache["k"].normal_()
    cache["v"].normal_()
    k_rows, v_rows = fns.save_block(cache, 3)
    want_k, want_v = cache["k"][:, 3].clone(), cache["v"][:, 3].clone()
    # a later write into the block must not reach the spilled rows
    cache["k"][:, 3] = 0.0
    cache["v"][:, 3] = 0.0
    assert torch.equal(k_rows, want_k) and torch.equal(v_rows, want_v)
    fns.install_blocks(cache, torch.tensor([5, 3]),
                       torch.stack([k_rows, k_rows]),
                       torch.stack([v_rows, v_rows]))
    for blk in (3, 5):
        assert torch.equal(cache["k"][:, blk], want_k)
        assert torch.equal(cache["v"][:, blk], want_v)


def test_admit_copies_the_prefill_row_and_clear_row_parks():
    cfg = gpt2_config("nano", dtype=torch.float32)
    fam = _family_fns("gpt2")
    fns = _engine_fns(fam, cfg)
    pool = fam.init_cache(cfg, 3, device="cpu")
    row = fam.init_cache(cfg, 1, device="cpu")
    row["k"].normal_()
    row["v"].normal_()
    row["pos"].fill_(7)
    row["start"].fill_(2)
    fns.admit(pool, row, 1)
    assert torch.equal(pool["k"][:, 1], row["k"][:, 0])
    assert pool["pos"].tolist() == [0, 7, 0]
    assert pool["start"].tolist() == [0, 2, 0]
    row["k"].zero_()                   # the pool holds a copy
    assert pool["k"][:, 1].abs().sum() > 0
    paged = init_pool(cfg, cfg.n_head, 2, 6, 16, "cpu")
    paged["block_tables"][1] = torch.arange(1, 9, dtype=torch.int32)
    paged["pos"][1] = 40
    fns.clear_row(paged, 1)
    assert int(paged["block_tables"][1].abs().sum()) == 0
    assert int(paged["pos"][1]) == 0
