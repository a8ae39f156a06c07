"""The port's llama decode slice against the JAX package's.

llama nano in f32 (GQA: two query heads on one KV head), and MHA
(``n_kv_head=2``).  The JAX package initializes the parameters; they
cross to the port through numpy (models/convert.py), so both packages
run the same weights on the same numpy-made prompts.  The JAX side runs
with use_flash=False (the XLA reference), as its own CPU tests do.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import llama as jl
from ray_tpu.models import llama_decode as jld
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.models import llama_decode as tld
from ray_tpu_torch.models.convert import llama_params_from_numpy

# f32 through 2 layers: the packages' matmuls sum in different orders
# (and the port's flash path runs an online softmax), so logits agree
# to ~1e-6; 1e-4 leaves room without hiding a wrong op (the tolerance
# of tests/test_torch_gpt2_decode.py)
LOGIT_TOL = 1e-4
MAX_NEW = 6
HEADS = {"gqa": 1, "mha": 2}


def _models(heads: str, use_flash: bool = False):
    jcfg = jl.llama_config("nano", dtype=jnp.float32, use_flash=False,
                           n_kv_head=HEADS[heads])
    tcfg = tl.llama_config("nano", dtype=torch.float32, use_flash=use_flash,
                           n_kv_head=HEADS[heads])
    jparams = jl.llama_init(jax.random.PRNGKey(0), jcfg)
    tparams = llama_params_from_numpy(jax.tree.map(np.asarray, jparams),
                                      tcfg, "cpu")
    return jcfg, jparams, tcfg, tparams


@pytest.fixture(scope="module", params=sorted(HEADS))
def models(request):
    return _models(request.param)


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
    """Last-token logits and the primed cache: the KV heads only,
    post-RoPE (RoPE at each row's logical positions when ragged)."""
    jcfg, jparams, tcfg, tparams = models
    toks, lens = _prompts(ragged)
    jlog, jc = jld.llama_prefill(jparams, _j(toks), jcfg, lengths=_j(lens))
    tlog, tc = tld.llama_prefill(tparams, _t(toks), tcfg, lengths=_t(lens))
    _close(tlog, jlog)
    assert tuple(tc["k"].shape) == (2, 3, 128, tcfg.n_kv_head, 32)
    for name in ("k", "v"):
        _close(tc[name], jc[name])
    for name in ("pos", "start"):
        np.testing.assert_array_equal(tc[name].numpy(),
                                      np.asarray(jc[name]))


@pytest.mark.parametrize("ragged", [False, True])
def test_decode_steps_match_jax(models, ragged):
    jcfg, jparams, tcfg, tparams = models
    toks, lens = _prompts(ragged)
    _, jc = jld.llama_prefill(jparams, _j(toks), jcfg, lengths=_j(lens))
    _, tc = tld.llama_prefill(tparams, _t(toks), tcfg, lengths=_t(lens))
    step_toks = np.random.default_rng(8).integers(0, 512, size=(4, 3),
                                                  dtype=np.int32)
    for row in step_toks:
        jlog, jc = jld.llama_decode_step(jparams, jc, _j(row), jcfg)
        tlog, tc = tld.llama_decode_step(tparams, tc, _t(row), tcfg)
        _close(tlog, jlog)
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    _close(tc["k"], jc["k"])


def test_scan_prefill_matches_jax(models):
    jcfg, jparams, tcfg, tparams = models
    toks, _ = _prompts(False)
    jlog, jc = jld._scan_prefill(jparams, _j(toks), jcfg)
    tlog, tc = tld._scan_prefill(tparams, _t(toks), tcfg)
    _close(tlog, jlog)
    _close(tc["k"], jc["k"])
    # and the batched prefill agrees with the per-token loop
    blog, _ = tld.llama_prefill(tparams, _t(toks), tcfg)
    _close(blog, tlog)


@pytest.mark.parametrize("ragged", [False, True])
def test_greedy_generate_tokens_identical(models, ragged):
    jcfg, jparams, tcfg, tparams = models
    toks, lens = _prompts(ragged)
    want = jld.llama_generate(jparams, _j(toks), jcfg,
                              max_new_tokens=MAX_NEW, temperature=0.0,
                              lengths=_j(lens))
    got = tld.llama_generate(tparams, _t(toks), tcfg,
                             max_new_tokens=MAX_NEW, temperature=0.0,
                             lengths=_t(lens))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("heads", sorted(HEADS))
def test_flash_path_matches_jax_reference(heads):
    """The port's prefill through flash_attention (its plain version on
    the CPU) with each KV head repeated for its group, against JAX's
    XLA reference path."""
    jcfg, jparams, fcfg, tparams = _models(heads, use_flash=True)
    toks, _ = _prompts(False)
    jlog, _ = jld.llama_prefill(jparams, _j(toks), jcfg)
    tlog, _ = tld.llama_prefill(tparams, _t(toks), fcfg)
    _close(tlog, jlog)
    want = jld.llama_generate(jparams, _j(toks), jcfg,
                              max_new_tokens=MAX_NEW, temperature=0.0)
    got = tld.llama_generate(tparams, _t(toks), fcfg,
                             max_new_tokens=MAX_NEW, temperature=0.0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sampled_generation_stays_in_the_vocab(models):
    _, _, tcfg, tparams = models
    toks, _ = _prompts(False)
    gen = torch.Generator().manual_seed(0)
    out = tld.llama_generate(tparams, _t(toks), tcfg, max_new_tokens=4,
                             temperature=0.9, top_k=20, generator=gen)
    assert out.shape == (3, 16)
    np.testing.assert_array_equal(out[:, :12].numpy(), toks)
    assert int(out.min()) >= 0 and int(out.max()) < tcfg.vocab_size


def test_generate_guards(models):
    _, _, tcfg, tparams = models
    toks = torch.zeros((1, tcfg.max_seq - 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="exceeds cfg.max_seq"):
        tld.llama_generate(tparams, toks, tcfg, max_new_tokens=3,
                           temperature=0.0)
    with pytest.raises(ValueError, match="kv_layout"):
        tld.llama_generate(tparams, toks[:, :4], tcfg, max_new_tokens=3,
                           temperature=0.0, kv_layout="ragged")
    with pytest.raises(ValueError, match="prefill_impl"):
        tld.llama_generate(tparams, toks[:, :4], tcfg, max_new_tokens=3,
                           temperature=0.0, prefill_impl="chunked")
    with pytest.raises(ValueError, match="ragged prompts"):
        tld.llama_generate(tparams, toks[:, :4], tcfg, max_new_tokens=3,
                           temperature=0.0, prefill_impl="scan",
                           lengths=torch.tensor([4], dtype=torch.int32))


def test_entry_points_need_an_explicit_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tl.llama_config("nano")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tld.llama_init_cache(cfg, 1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tld.llama_init_paged_cache(cfg, 1, num_blocks=2, block_size=16)
    assert tld.llama_init_cache(cfg, 1, device="cpu")["k"].device.type \
        == "cpu"
