"""Prefill/decode roles of the port's continuous engine: the KV handoff.

The counterparts of ``tests/test_serve_disagg.py``'s engine cases,
without the router (``serve/router.py``, whose dispatch
``test_torch_serve_fleet_disagg.py`` holds): the test hands each
``role="prefill"`` engine's ``HandoffCursor`` to a ``role="decode"``
engine's ``admit_prefilled`` itself.  GPT-2 nano and llama nano are
initialized by JAX and served in f32 on the CPU; every reply must be
the JAX dense solo greedy ``generate`` continuation token for token,
whether the rows cross on the device (fast) or through host memory
(staged), the prefill was chunked, the decode pool requeued, or the
decode engine decodes speculatively.  The install must leave exactly
``paged_prefill``'s post-state: the rows byte for byte, pos = prompt
length, start 0.
"""

import asyncio

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from ray_tpu.serve import llm as jllm  # noqa: E402
from ray_tpu_torch.serve import (SamplingParams, SpecConfig,  # noqa: E402
                                 build_llm_deployment)
from ray_tpu_torch.serve.batching import HandoffCursor  # noqa: E402
from tests.test_torch_serve_continuous import (  # noqa: E402,F401
    FAMILIES, _assert_oracle, _port, _prompts, ckpt)

_ENGINE = dict(kv_layout="paged", max_slots=2)


def _pair(family, path, *, staged=False, prefill_kw=None, decode_kw=None):
    pre = _port(family, path, role="prefill", handoff_staged=staged,
                **_ENGINE, **(prefill_kw or {}))
    dec = _port(family, path, role="decode", handoff_staged=staged,
                **_ENGINE, **(decode_kw or {}))
    return pre, dec


def _serve(pre, dec, prompts, direct=()):
    """Each prompt through the prefill engine, its HandoffCursor
    through the decode engine (all at once); then the ``direct``
    prompts sent to the decode engine itself, one by one.  Returns
    (replies, packages, direct replies)."""
    pkgs = []

    async def one(p):
        pkg = await pre(p)
        assert isinstance(pkg, HandoffCursor)
        pkgs.append(pkg)
        return await dec.admit_prefilled(pkg)

    async def main():
        try:
            outs = await asyncio.gather(*(one(p) for p in prompts))
            return outs, [await dec(p) for p in direct]
        finally:
            pre.shutdown_engine()
            dec.shutdown_engine()

    outs, more = asyncio.run(main())
    return [np.asarray(o) for o in outs], pkgs, [np.asarray(o) for o in more]


def _assert_empty(*engines):
    for e in engines:
        assert e.kv_stats()["kv_cache"]["blocks_in_use"] == 0


@pytest.mark.parametrize("staged", [False, True], ids=["fast", "staged"])
@pytest.mark.parametrize("family", FAMILIES)
def test_handoff_matches_the_jax_oracle(ckpt, family, staged):
    """Block-boundary-crossing prompts (7, 19, 33, 12 tokens): each
    hands ceil(n / 16) blocks over, on the device or through host
    memory, and the decode engine's reply is the oracle's."""
    lens = (7, 19, 33, 12)
    prompts = _prompts(0, lens, lo=2)
    pre, dec = _pair(family, ckpt[family], staged=staged)
    outs, pkgs, _ = _serve(pre, dec, prompts)
    _assert_oracle(family, prompts, outs)
    assert sum(p.n_blocks for p in pkgs) == sum(-(-n // 16) for n in lens)
    assert all(p.installed and p.path == ("staged" if staged else "fast")
               for p in pkgs)
    assert all(p.k_rows.device.type == "cpu" for p in pkgs)
    assert {p.meta["prompt_len"] for p in pkgs} == set(lens)
    bpb = pre.kv_stats()["kv_cache"]["pool_bytes"] // \
        pre._pager.num_blocks
    assert all(p.nbytes == bpb * p.n_blocks for p in pkgs)
    _assert_empty(pre, dec)


def test_chunked_prefill_side_hands_off_at_its_last_chunk(ckpt):
    """70, 96 and 50-token prompts prefilled in chunks of 32 on the
    prefill side (5 partial fills) hand off when their last chunk
    lands."""
    prompts = _prompts(7, (70, 96, 50), lo=2)
    pre, dec = _pair("gpt2", ckpt["gpt2"], prefill_kw=dict(
        prefill_chunk_tokens=32, prefill_bucket=32))
    outs, pkgs, _ = _serve(pre, dec, prompts)
    _assert_oracle("gpt2", prompts, outs)
    assert len(pkgs) == 3
    assert pre.kv_stats()["kv_cache"]["partial_fills"] == 5
    assert dec.kv_stats()["kv_cache"]["partial_fills"] == 0


def test_decode_pool_exhaustion_requeues_then_completes(ckpt):
    """A decode pool of the least legal size (null + 8 blocks) holds one
    5-block request at a time: arriving packages requeue at the head
    and every one still completes with the oracle's reply."""
    prompts = _prompts(9, (65, 67, 66, 68), lo=2)
    pre, dec = _pair("gpt2", ckpt["gpt2"], decode_kw=dict(kv_num_blocks=9))
    outs, _, _ = _serve(pre, dec, prompts)
    _assert_oracle("gpt2", prompts, outs)
    assert dec.kv_stats()["requeues"] >= 1
    _assert_empty(pre, dec)


@pytest.mark.parametrize("family", FAMILIES)
def test_imported_prefix_hits_on_the_decode_engine(ckpt, family):
    """Two requests sharing a 32-token prefix are handed off; then two
    more sharing it go straight to the decode engine (as the reference's
    router sends a resident prefix): their admissions hit the imported
    full blocks instead of prefilling them, with no re-prefill waste."""
    rng = np.random.RandomState(11)
    prefix = rng.randint(2, 500, 32)
    wave1 = [np.concatenate([prefix, rng.randint(2, 500, 3)]).astype(
        np.int32) for _ in range(2)]
    wave2 = [np.concatenate([prefix, rng.randint(2, 500, 4)]).astype(
        np.int32) for _ in range(2)]
    pre, dec = _pair(family, ckpt[family])
    outs, _, direct = _serve(pre, dec, wave1, direct=wave2)
    _assert_oracle(family, wave1 + wave2, outs + direct)
    kv = dec.kv_stats()
    assert kv["kv_cache"]["prefix_block_hits"] >= 2 * 2
    assert kv["kv_scope"]["forensics"]["reprefill_waste_tokens"] == 0


def test_spec_decode_on_the_decode_side(ckpt):
    """The verify loop starts from the handed-off state: n-gram spec
    (k = 2) on the decode engine, replies the oracle's."""
    prompts = _prompts(5, (9, 21, 33), lo=2)
    pre, dec = _pair("gpt2", ckpt["gpt2"], decode_kw=dict(
        spec_decode=SpecConfig(draft="ngram", k=2)))
    rounds = []
    verify = dec._fns.spec_verify
    dec._fns.spec_verify = lambda *a: rounds.append(1) or verify(*a)
    outs, _, _ = _serve(pre, dec, prompts)
    _assert_oracle("gpt2", prompts, outs)
    assert rounds


@pytest.mark.parametrize("staged", [False, True], ids=["fast", "staged"])
def test_installed_rows_equal_the_exported_rows(ckpt, staged):
    """Before the decode engine's first step, its pool holds the
    exported rows byte for byte in the row's blocks, at pos = prompt
    length and start 0; the package is a copy (the prefill engine
    frees and reuses the blocks, and a later request's prefill leaves
    the package as it was)."""
    prompts = _prompts(3, (40, 37), lo=2)
    pre, dec = _pair("llama", ckpt["llama"], staged=staged)
    seen = []
    install = dec._fns.kv_handoff_install

    def spy(cache, ids, k_rows, v_rows, slot, row_bt, pos):
        before = (k_rows.clone(), v_rows.clone())
        out = install(cache, ids, k_rows, v_rows, slot, row_bt, pos)
        seen.append((before, ids.clone(), int(slot), row_bt.clone(),
                     int(pos), {n: cache[n][:, ids].transpose(0, 1).clone()
                                for n in ("k", "v")},
                     int(cache["pos"][slot]), int(cache["start"][slot]),
                     cache["block_tables"][slot].clone()))
        return out

    dec._fns.kv_handoff_install = spy

    async def main():
        try:
            first = await pre(prompts[0])
            saved = (first.k_rows.clone(), first.v_rows.clone())
            second = await pre(prompts[1])    # reuses the freed blocks
            assert torch.equal(first.k_rows, saved[0])
            assert torch.equal(first.v_rows, saved[1])
            return [np.asarray(await dec.admit_prefilled(p))
                    for p in (first, second)]
        finally:
            pre.shutdown_engine()
            dec.shutdown_engine()

    outs = asyncio.run(main())
    _assert_oracle("llama", prompts, outs)
    assert len(seen) == 2
    for (rows, ids, slot, row_bt, pos, landed, pos_after, start_after,
         table), p in zip(seen, prompts):
        assert torch.equal(landed["k"], rows[0])
        assert torch.equal(landed["v"], rows[1])
        assert pos == pos_after == len(p) and start_after == 0
        assert torch.equal(table, row_bt.to(torch.int32))
        assert torch.equal(table[:len(ids)].long(), ids.long())


def _error(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    raise AssertionError("no ValueError")


@pytest.mark.parametrize("kw", [
    dict(scheduler="continuous", kv_layout="paged", role="oracle"),
    dict(scheduler="continuous", kv_layout="dense", role="prefill"),
    dict(scheduler="batch", role="decode"),
    dict(scheduler="continuous", kv_layout="paged", handoff_staged=True)],
    ids=["unknown", "dense", "batch", "staged-both"])
def test_role_errors_equal_the_reference(kw):
    assert _error(lambda: build_llm_deployment(
        "gpt2", "nano", device="cpu", **kw)) == _error(
        lambda: jllm.build_llm_deployment("gpt2", "nano", **kw))


@pytest.mark.parametrize("case", ["prefill", "dense", "type", "spec"])
def test_admit_prefilled_errors_carry_the_reference_messages(case):
    """The reference's four refusals (ray_tpu/serve/llm.py:1860-1876),
    word for word."""
    kw = dict(scheduler="continuous", max_new_tokens=2, device="cpu")
    pkg = HandoffCursor(prompt=np.arange(3, dtype=np.int32),
                        first_token=1, n_tokens=3, n_blocks=1)
    if case == "prefill":
        kw.update(kv_layout="paged", role="prefill")
        want = ("admit_prefilled needs a decode-capable engine "
                "(role='decode' or 'both'); this replica is "
                "role='prefill'")
    elif case == "dense":
        want = "admit_prefilled requires kv_layout='paged'"
    elif case == "type":
        kw.update(kv_layout="paged")
        pkg = object()
        want = "admit_prefilled takes a HandoffCursor, got object"
    else:
        kw.update(kv_layout="paged", spec_decode=SpecConfig())
        pkg.sampling = SamplingParams(temperature=0.5)
        want = ("per-request sampling overrides are not supported with "
                "spec_decode (the verify program bakes in ONE sampling "
                "config)")
    engine = build_llm_deployment("gpt2", "nano", **kw).func_or_class()
    assert _error(lambda: asyncio.run(engine.admit_prefilled(pkg))) == want
