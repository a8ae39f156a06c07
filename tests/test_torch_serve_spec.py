"""Speculative decoding through the port's continuous engine.

The counterparts of ``tests/test_spec_decode.py``'s engine cases: GPT-2
nano and llama nano initialized by JAX and served by the port's engine
in f32 on the CPU, with ``spec_decode=SpecConfig(...)``.  At
temperature 0 every request must get the JAX dense solo greedy
``generate`` continuation token for token (the oracle of
``tests/test_torch_serve_continuous.py``), whatever the draft proposes.
Acceptance is counted from outside the engine, by wrapping its
``spec_verify`` and reading the rows that were decoding.
"""

import asyncio

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from ray_tpu.serve import llm as jllm  # noqa: E402
from ray_tpu_torch.serve import (SamplingParams, SpecConfig,  # noqa: E402
                                 build_llm_deployment)
from ray_tpu_torch.serve.llm import _family_fns  # noqa: E402
from tests.test_torch_serve_continuous import (  # noqa: E402,F401
    FAMILIES, MAX_NEW, _assert_oracle, _churn_prompts, _drive, _jax_model,
    _port, _prompts, ckpt, oracle)

K = 4


def _spec(family, path, spec=None, **kw):
    return _port(family, path, spec_decode=spec or SpecConfig(k=K), **kw)


class _Acceptance:
    """Wraps an engine's spec_verify: per round, the drafts proposed
    and accepted over the rows that were decoding, and each decoding
    row's block table (paged)."""

    def __init__(self, inst):
        self.inst, self.proposed, self.accepted = inst, 0, 0
        self.rounds, self.tables = 0, []
        verify = inst._fns.spec_verify

        def spy(params, cache, block, *args):
            rows = [i for i, st in enumerate(inst._slots)
                    if st is not None and st.get("state") != "prefill"]
            if "block_tables" in cache:
                self.tables += [(len(inst._slots[i]["prompt"]),
                                 int((cache["block_tables"][i] > 0).sum()))
                                for i in rows]
            out, n_acc, cache = verify(params, cache, block, *args)
            self.rounds += 1
            self.proposed += (block.shape[1] - 1) * len(rows)
            self.accepted += int(n_acc[rows].sum())
            return out, n_acc, cache

        inst._fns.spec_verify = spy

    @property
    def rate(self):
        return self.accepted / self.proposed


@pytest.mark.parametrize("layout", ["dense", "paged"])
@pytest.mark.parametrize("family", FAMILIES)
def test_spec_ngram_greedy_equals_the_jax_oracle(ckpt, family, layout):
    """n-gram drafts, both families and layouts, 5 requests through 4
    slots: every reply is the oracle's, and (paged) the acceptance
    counted from outside equals the JAX engine's spec counters on the
    same requests (proposed, accepted)."""
    prompts = _prompts(7, (3, 7, 5, 30, 12))
    inst = _spec(family, ckpt[family], kv_layout=layout, max_slots=4)
    acc = _Acceptance(inst)
    _assert_oracle(family, prompts, _drive(inst, prompts))
    assert acc.rounds > 0 and acc.proposed % K == 0
    if layout == "dense":
        return
    ref = jllm.build_llm_deployment(
        family, "nano", checkpoint_path=ckpt[family],
        config_overrides={"dtype": jax.numpy.float32, "use_flash": False,
                          "remat": False},
        max_new_tokens=MAX_NEW, temperature=0.0, scheduler="continuous",
        kv_layout=layout, kv_block_size=16, prefill_bucket=16, max_slots=4,
        spec_decode=jllm.SpecConfig(k=K)).func_or_class()
    _drive(ref, prompts)
    spec = ref.engine_stats()["spec"]
    assert (acc.proposed, acc.accepted) == (spec["proposed"],
                                            spec["accepted"])


@pytest.mark.parametrize("family", FAMILIES)
def test_aligned_model_draft_accepts_every_proposal(ckpt, family):
    """A draft model of the target's family and preset carrying the
    target's (JAX) weights, moved across by models/convert.py, proposes
    the target's argmax every time: acceptance 1.0, replies the
    oracle's."""
    prompts = _prompts(11, (4, 6, 9))
    inst = _spec(family, ckpt[family], SpecConfig(draft=f"{family}:nano",
                                                  k=K), max_slots=2)
    tree = jax.tree.map(np.asarray, _jax_model(family)[1])
    inst._draft_params = _family_fns(family).from_numpy(
        tree, inst._draft_cfg, "cpu")
    acc = _Acceptance(inst)
    _assert_oracle(family, prompts, _drive(inst, prompts))
    assert acc.proposed > 0 and acc.rate == 1.0


def test_stop_sequence_cuts_mid_round(ckpt):
    """A stop sequence from the oracle's own continuation ends the
    reply right after its first match, with and without spec (a round
    emits its tokens one by one against the stops)."""
    p = _prompts(5, (6,))[0]
    cont = [int(t) for t in oracle("gpt2", p)[len(p):]]
    stop = (cont[1], cont[2])
    cut = next(i + 1 for i in range(len(cont))
               if tuple(cont[max(0, i + 1 - len(stop)):i + 1]) == stop)
    assert cut < MAX_NEW
    for spec in (None, SpecConfig(k=K)):
        inst = _port("gpt2", ckpt["gpt2"], stop_sequences=[stop],
                     max_slots=2, spec_decode=spec)
        out, = _drive(inst, [p])
        np.testing.assert_array_equal(out, oracle("gpt2", p)[:len(p) + cut])


def test_eos_mid_round_frees_slots_for_the_queue(ckpt):
    """3 requests through 2 paged slots, eos_id = prompt 0's first
    token: each reply is the oracle's cut at its first eos, and the
    pool ends empty."""
    prompts = _prompts(9, (3, 7, 4))
    eos = int(oracle("gpt2", prompts[0])[len(prompts[0])])
    inst = _spec("gpt2", ckpt["gpt2"], kv_layout="paged", max_slots=2,
                 eos_id=eos)
    outs = _drive(inst, prompts)
    for p, o in zip(prompts, outs):
        cont = list(oracle("gpt2", p)[len(p):])
        cut = cont.index(eos) + 1 if eos in cont else len(cont)
        np.testing.assert_array_equal(o, np.concatenate(
            [p, np.asarray(cont[:cut], np.int32)]))
    assert inst.kv_stats()["kv_cache"]["blocks_in_use"] == 0


def test_chunked_prefill_under_spec(ckpt):
    """Chunked admissions (70 → 32/32/6, 100 → 4 chunks) decode
    speculatively once their last chunk lands (llama; the host-tier
    case below is GPT-2's)."""
    prompts = _prompts(0, (70, 9, 100, 33), lo=2)
    inst = _spec("llama", ckpt["llama"], kv_layout="paged", max_slots=4,
                 prefill_chunk_tokens=32)
    _assert_oracle("llama", prompts, _drive(inst, prompts))
    assert inst.kv_stats()["kv_cache"]["partial_fills"] == 6


def test_host_tier_under_spec(ckpt):
    """The churn of tests/test_torch_serve_continuous.py (a 12-block
    pool, evicted prefixes restored from the host tier) under spec: the
    oracle's replies, tier hits."""
    prompts = _churn_prompts()
    inst = _spec("gpt2", ckpt["gpt2"], kv_layout="paged", max_slots=2,
                 max_new_tokens=3, kv_num_blocks=12,
                 kv_host_tier_bytes=1 << 24)
    _assert_oracle("gpt2", prompts, _drive(inst, prompts, sequential=True),
                   max_new=3)
    assert inst.kv_stats()["kv_tier"]["hits"] > 0


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_headroom_and_the_last_rounds_past_max_seq(ckpt, layout):
    """k = 4: a 42-token prompt whose 48 tokens end on a block boundary,
    and a 122-token one whose last rounds verify past max_seq = 128
    (dense: the writes dropped; paged: routed to the null block).  Both
    replies are the oracle's, and each paged row owned
    ceil(min(n + max_new + k, max_seq) / 16) blocks: its rejected drafts
    land in blocks it holds."""
    prompts = _prompts(21, (42, 122))
    inst = _spec("gpt2", ckpt["gpt2"], kv_layout=layout, max_slots=2)
    acc = _Acceptance(inst)
    _assert_oracle("gpt2", prompts, _drive(inst, prompts))
    if layout == "paged":
        want = {n: -(-min(n + MAX_NEW + K, 128) // 16) for n in (42, 122)}
        assert acc.tables and all(b == want[n] for n, b in acc.tables)


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_idle_slot_past_max_seq_under_spec(ckpt, layout):
    """The spec twin of test_idle_slot_past_max_seq: slot 1 idles while
    two 100-token generations run in slot 0 one after the other, with a
    model draft, so the idle rows of both the target pool and the
    draft pool would run past max_seq = 128 unparked."""
    prompts = _prompts(4, (8, 8))
    inst = _spec("gpt2", ckpt["gpt2"], SpecConfig(draft="gpt2:nano", k=K),
                 kv_layout=layout, max_slots=2, max_new_tokens=100)
    acc = _Acceptance(inst)
    _assert_oracle("gpt2", prompts, _drive(inst, prompts, sequential=True),
                   max_new=100)
    # the idle rows moved K + 1 a round: past max_seq unless parked
    assert acc.rounds * (K + 1) > 128


@pytest.mark.parametrize("draft", ["ngram", "gpt2:nano"])
def test_sampled_spec_repeats_under_one_seed(ckpt, draft):
    """temperature 0.8, top_k 8: rejection sampling against a one-hot q
    (n-gram) or the draft model's distributions.  Replies extend their
    prompts by in-vocabulary tokens; two engines of one seed give the
    same replies, another seed others."""
    prompts = _prompts(2, (5, 9, 12, 30))

    def run(seed):
        inst = _spec("gpt2", ckpt["gpt2"], SpecConfig(draft=draft, k=K),
                     kv_layout="paged", max_slots=3, temperature=0.8,
                     top_k=8, seed=seed)
        return _drive(inst, prompts)

    first, again, other = run(7), run(7), run(8)
    for p, a, b in zip(prompts, first, again):
        assert a.shape == (len(p) + MAX_NEW,) and (a < 512).all()
        np.testing.assert_array_equal(a[:len(p)], p)
        np.testing.assert_array_equal(a, b)
    assert any(not np.array_equal(a, c) for a, c in zip(first, other))


def test_spec_engines_are_freed_on_del(ckpt):
    """A served spec engine with a model draft, and a prefill/decode
    pair, hold no reference cycle: dropping the last reference frees
    them (and their pools) without the cycle collector."""
    import gc
    import weakref

    from tests.test_torch_serve_disagg import _pair, _serve

    gc.disable()
    try:
        inst = _spec("gpt2", ckpt["gpt2"], SpecConfig(draft="gpt2:nano"),
                     kv_layout="paged", max_slots=2)
        _drive(inst, _prompts(6, (70, 9, 40)))
        pre, dec = _pair("gpt2", ckpt["gpt2"], staged=True)
        _serve(pre, dec, _prompts(6, (70, 9)))
        refs = [weakref.ref(e) for e in (inst, pre, dec)]
        del inst, pre, dec
        assert all(r() is None for r in refs)
    finally:
        gc.enable()


def _error(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    raise AssertionError("no ValueError")


@pytest.mark.parametrize("kw", [dict(k=0), dict(draft="bogus"),
                                dict(draft="bert:nano"),
                                dict(ngram_order=0)],
                         ids=["k0", "bogus", "family", "order"])
def test_spec_config_errors_equal_the_reference(kw):
    assert _error(lambda: SpecConfig(**kw)) == \
        _error(lambda: jllm.SpecConfig(**kw))


@pytest.mark.parametrize("kw", [
    dict(scheduler="batch", spec_decode="spec"),
    dict(scheduler="continuous", spec_decode="ngram"),
    dict(scheduler="continuous", spec_decode=object())],
    ids=["batch", "str", "object"])
def test_spec_build_errors_equal_the_reference(kw):
    """A SpecConfig under the batch scheduler, and spec values of other
    types, raise the reference's ValueError."""
    def cls(mod):
        spec = kw["spec_decode"]
        return dict(kw, spec_decode=mod.SpecConfig() if spec == "spec"
                    else spec)
    from ray_tpu_torch.serve import llm as tllm
    assert _error(lambda: build_llm_deployment(
        "gpt2", "nano", device="cpu", **cls(tllm))) == _error(
        lambda: jllm.build_llm_deployment("gpt2", "nano", **cls(jllm)))


@pytest.mark.parametrize("draft,overrides", [
    ("gpt2:gpt2", {}), ("llama:nano", {"max_seq": 256})],
    ids=["vocab", "max_seq"])
def test_draft_model_errors_equal_the_reference(draft, overrides):
    """A draft of another vocabulary, and one whose max_seq is below the
    target's, raise the reference's ValueError when the engine is
    built."""
    spec = dict(spec_decode=None, scheduler="continuous")

    def port():
        build_llm_deployment("gpt2", "nano", device="cpu", **dict(
            spec, spec_decode=SpecConfig(draft=draft),
            config_overrides=dict(overrides, dtype=torch.float32))
        ).func_or_class()

    def ref():
        jllm.build_llm_deployment("gpt2", "nano", **dict(
            spec, spec_decode=jllm.SpecConfig(draft=draft),
            config_overrides=overrides)).func_or_class()

    got = _error(port)
    assert got == _error(ref)
    assert ("vocab" if "max_seq" not in overrides else "max_seq") in got


def test_per_request_sampling_under_spec_raises_the_reference_message(ckpt):
    inst = _spec("gpt2", ckpt["gpt2"])
    ref = jllm.build_llm_deployment(
        "gpt2", "nano", scheduler="continuous", max_new_tokens=2,
        spec_decode=jllm.SpecConfig()).func_or_class()
    p = np.arange(1, 4, dtype=np.int32)
    got, want = (
        _error(lambda: asyncio.run(e(p, sampling=jllm.SamplingParams(
            temperature=0.5) if e is ref else SamplingParams(
                temperature=0.5))))
        for e in (inst, ref))
    assert got == want and "spec_decode" in got
