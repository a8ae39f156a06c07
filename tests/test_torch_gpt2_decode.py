"""The port's GPT-2 decode slice against the JAX package's.

GPT-2 nano in f32.  The JAX package initializes the parameters; they
cross to the port through numpy (models/convert.py), so both packages
run the same weights on the same numpy-made prompts.  The JAX side runs
with use_flash=False (the XLA reference), as its own CPU tests do.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import decode_common as jdc
from ray_tpu.models import gpt2 as jgpt2
from ray_tpu.models import gpt2_decode as jdec
from ray_tpu_torch.models import decode_common as tdc
from ray_tpu_torch.models import gpt2 as tgpt2
from ray_tpu_torch.models import gpt2_decode as tdec
from ray_tpu_torch.models.convert import (gpt2_params_from_numpy,
                                          gpt2_params_to_numpy)

# f32 through 2 layers: the packages' matmuls sum in different orders
# (and the port's flash path runs an online softmax), so logits agree
# to ~1e-6; 1e-4 leaves room without hiding a wrong op
LOGIT_TOL = 1e-4
MAX_NEW = 6


@pytest.fixture(scope="module")
def models():
    jcfg = jgpt2.gpt2_config("nano", dtype=jnp.float32, use_flash=False,
                             remat=False)
    tcfg = tgpt2.gpt2_config("nano", dtype=torch.float32, use_flash=False)
    jparams = jgpt2.gpt2_init(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree.map(np.asarray, jparams)
    tparams = gpt2_params_from_numpy(tree, tcfg, "cpu")
    return jcfg, jparams, tcfg, tparams


def _prompts(ragged: bool):
    rng = np.random.default_rng(7)
    toks = rng.integers(0, 512, size=(3, 12), dtype=np.int32)
    if not ragged:
        return toks, None
    lens = np.array([12, 7, 3], np.int32)
    for i, n in enumerate(lens):
        toks[i, :12 - n] = 0                  # left pads
    return toks, lens


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


def _close(got, want, tol=LOGIT_TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("ragged", [False, True])
def test_prefill_matches_jax(models, ragged):
    jcfg, jparams, tcfg, tparams = models
    toks, lens = _prompts(ragged)
    jl, jc = jdec.prefill(jparams, _j(toks), jcfg, lengths=_j(lens))
    tl, tc = tdec.prefill(tparams, _t(toks), tcfg, lengths=_t(lens))
    _close(tl, jl)
    for name in ("k", "v"):
        _close(tc[name], jc[name])
    for name in ("pos", "start"):
        np.testing.assert_array_equal(tc[name].numpy(),
                                      np.asarray(jc[name]))


@pytest.mark.parametrize("ragged", [False, True])
def test_decode_steps_match_jax(models, ragged):
    jcfg, jparams, tcfg, tparams = models
    toks, lens = _prompts(ragged)
    _, jc = jdec.prefill(jparams, _j(toks), jcfg, lengths=_j(lens))
    _, tc = tdec.prefill(tparams, _t(toks), tcfg, lengths=_t(lens))
    step_toks = np.random.default_rng(8).integers(0, 512, size=(4, 3),
                                                  dtype=np.int32)
    for row in step_toks:
        jl, jc = jdec.decode_step(jparams, jc, _j(row), jcfg)
        tl, tc = tdec.decode_step(tparams, tc, _t(row), tcfg)
        _close(tl, jl)
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))


def test_scan_prefill_matches_jax(models):
    jcfg, jparams, tcfg, tparams = models
    toks, _ = _prompts(False)
    jl, jc = jdec._scan_prefill(jparams, _j(toks), jcfg)
    tl, tc = tdec._scan_prefill(tparams, _t(toks), tcfg)
    _close(tl, jl)
    _close(tc["k"], jc["k"])
    # and the batched prefill agrees with the per-token loop
    bl, _ = tdec.prefill(tparams, _t(toks), tcfg)
    _close(bl, tl)


@pytest.mark.parametrize("ragged", [False, True])
def test_greedy_generate_tokens_identical(models, ragged):
    jcfg, jparams, tcfg, tparams = models
    toks, lens = _prompts(ragged)
    want = jdec.generate(jparams, _j(toks), jcfg, max_new_tokens=MAX_NEW,
                         temperature=0.0, lengths=_j(lens))
    got = tdec.generate(tparams, _t(toks), tcfg, max_new_tokens=MAX_NEW,
                        temperature=0.0, lengths=_t(lens))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_flash_path_matches_jax_reference(models):
    """The port's prefill through flash_attention (its plain version on
    the CPU) against JAX's XLA reference path."""
    jcfg, jparams, _, tparams = models
    fcfg = tgpt2.gpt2_config("nano", dtype=torch.float32, use_flash=True)
    toks, _ = _prompts(False)
    jl, _ = jdec.prefill(jparams, _j(toks), jcfg)
    tl, _ = tdec.prefill(tparams, _t(toks), fcfg)
    _close(tl, jl)
    want = jdec.generate(jparams, _j(toks), jcfg, max_new_tokens=MAX_NEW,
                         temperature=0.0)
    got = tdec.generate(tparams, _t(toks), fcfg, max_new_tokens=MAX_NEW,
                        temperature=0.0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("top_k,top_p", [(0, 1.0), (5, 1.0), (0, 0.9),
                                         (20, 0.8)])
def test_filter_logits_masks_match_jax(models, top_k, top_p):
    jcfg, _, tcfg, _ = models
    logits = np.random.default_rng(9).standard_normal(
        (4, jcfg.padded_vocab)).astype(np.float32) * 3
    want = jdc.filter_logits(jnp.asarray(logits), 0.7,
                             jdc.make_vocab_tail_mask(jcfg), top_k, top_p)
    got = tdc.filter_logits(torch.from_numpy(logits), 0.7,
                            tdc.make_vocab_tail_mask(tcfg, "cpu"), top_k,
                            top_p)
    want = np.asarray(want)
    np.testing.assert_array_equal(got.numpy() <= -1e29, want <= -1e29)
    kept = want > -1e29
    np.testing.assert_allclose(got.numpy()[kept], want[kept], rtol=1e-6)


def test_greedy_ties_go_to_first_index(models):
    jcfg, _, tcfg, _ = models
    logits = np.zeros((2, jcfg.padded_vocab), np.float32)
    logits[0, [3, 9]] = 5.0
    logits[1, [7, 2]] = 1.0
    want = jdc.sample_token(jnp.asarray(logits), None, 0.0,
                            jdc.make_vocab_tail_mask(jcfg))
    got = tdc.sample_token(torch.from_numpy(logits), None, 0.0,
                           tdc.make_vocab_tail_mask(tcfg, "cpu"))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), [3, 2])


def test_sampled_tokens_stay_in_the_kept_set(models):
    _, _, tcfg, _ = models
    logits = torch.from_numpy(np.random.default_rng(10).standard_normal(
        (64, tcfg.padded_vocab)).astype(np.float32))
    tail = tdc.make_vocab_tail_mask(tcfg, "cpu")
    gen = torch.Generator().manual_seed(0)
    tok = tdc.sample_token(logits, gen, 0.8, tail, top_k=3)
    top3 = torch.topk(logits, 3, dim=-1).indices
    assert bool((top3 == tok[:, None].long()).any(dim=-1).all())
    assert int(tok.max()) < tcfg.vocab_size


_BAD_CONFIGS = [
    {"ce_impl": "bogus"},
    {"ce_impl": "pallas", "loss_chunks": 2},
    {"ce_impl": "streaming_xla", "seq_parallel": True},
    {"flash_resident": "maybe"},
    {"use_streaming_ce": True, "ce_impl": "pallas"},
    {"ce_impl": "pallas", "loss_chunks": 4, "seq_parallel": True,
     "flash_resident": "x"},
]


@pytest.mark.parametrize("bad", _BAD_CONFIGS)
def test_config_validation_messages_match_jax(bad):
    with pytest.raises(ValueError) as jerr:
        jgpt2.GPT2Config(**bad)
    with pytest.raises(ValueError) as terr:
        tgpt2.GPT2Config(**bad)
    assert str(terr.value) == str(jerr.value)


def test_streaming_alias_normalizes_like_jax():
    assert tgpt2.GPT2Config(use_streaming_ce=True).ce_impl == \
        jgpt2.GPT2Config(use_streaming_ce=True).ce_impl == "streaming_xla"


@pytest.mark.parametrize("name", sorted(jgpt2._PRESETS))
def test_presets_match_jax(name):
    jc, tc = jgpt2.gpt2_config(name), tgpt2.gpt2_config(name)
    assert tgpt2._PRESETS == jgpt2._PRESETS
    for field in ("vocab_size", "max_seq", "n_layer", "n_head", "d_model",
                  "d_ff", "head_dim", "padded_vocab"):
        assert getattr(tc, field) == getattr(jc, field), field
    assert tgpt2.gpt2_param_count(tc) == jgpt2.gpt2_param_count(jc)
    assert tc.dtype == torch.bfloat16 and tc.param_dtype == torch.float32


def test_init_layout_matches_jax(models):
    jcfg, jparams, tcfg, _ = models
    tparams = tgpt2.gpt2_init(tcfg, torch.Generator().manual_seed(0),
                              "cpu")
    jshapes = jax.tree.map(lambda a: tuple(a.shape), jparams)
    tshapes = jax.tree.map(lambda t: tuple(t.shape), tparams)
    assert tshapes == jshapes
    # the same stds: wte N(0, 0.02), wpe N(0, 0.01)
    assert abs(float(tparams["wte"].std()) - 0.02) < 2e-3
    assert abs(float(tparams["wpe"].std()) - 0.01) < 1e-3


def test_params_round_trip_is_exact(models):
    _, jparams, tcfg, tparams = models
    back = gpt2_params_to_numpy(tparams)
    flat_j = jax.tree_util.tree_leaves_with_path(
        jax.tree.map(np.asarray, jparams))
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_b] == [p for p, _ in flat_j]
    for (_, a), (_, b) in zip(flat_j, flat_b):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    again = gpt2_params_from_numpy(back, tcfg, "cpu")
    for a, b in zip(jax.tree.leaves(again), jax.tree.leaves(tparams)):
        assert torch.equal(a, b)


def test_params_from_numpy_rejects_wrong_layout(models):
    _, jparams, tcfg, _ = models
    tree = jax.tree.map(np.asarray, jparams)
    tree["wte"] = tree["wte"][:-1]
    with pytest.raises(ValueError, match="wte"):
        gpt2_params_from_numpy(tree, tcfg, "cpu")
    del tree["wte"]
    with pytest.raises(ValueError, match="expected keys"):
        gpt2_params_from_numpy(tree, tcfg, "cpu")


def test_generate_guards(models):
    _, _, tcfg, tparams = models
    toks = torch.zeros((1, tcfg.max_seq - 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="exceeds cfg.max_seq"):
        tdec.generate(tparams, toks, tcfg, max_new_tokens=3,
                      temperature=0.0)
    with pytest.raises(ValueError, match="kv_layout"):
        tdec.generate(tparams, toks[:, :4], tcfg, max_new_tokens=3,
                      temperature=0.0, kv_layout="ragged")
    with pytest.raises(ValueError, match="multiple of block_size"):
        tdec.generate(tparams, toks[:, :4], tcfg, max_new_tokens=3,
                      temperature=0.0, kv_layout="paged", kv_block_size=48)


def test_entry_points_need_an_explicit_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tgpt2.gpt2_config("nano")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tgpt2.gpt2_init(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdec.init_cache(cfg, 1)
    assert tdec.init_cache(cfg, 1, device="cpu")["k"].device.type == "cpu"
