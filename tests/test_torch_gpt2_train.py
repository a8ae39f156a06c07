"""The port's GPT-2 training forward and loss against the JAX package's.

Nano preset in float32.  The JAX package initializes the parameters;
they cross to the port through numpy (models/convert.py), and both
packages see the same numpy batch.  JAX runs ``use_flash=False`` (its
model passes no ``interpret`` to the flash kernel, so that Pallas
kernel cannot run on the CPU); the port runs both ``use_flash=True``
(the flash autograd Function over the kernels' plain versions) and
``False``.  With flash off the JAX ``mlp_only`` policy is full remat
and every remat policy computes the same function, so one JAX
reference serves every port remat case.  The non-dense CE
implementations get a JAX reference each: ``ce_impl="pallas"`` runs the
JAX fused-CE Pallas kernels in interpret mode (the package picks it off
the TPU), ``"streaming_xla"`` its ``lax.scan``.
"""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import gpt2 as jg
from ray_tpu_torch.models import gpt2 as tg
from ray_tpu_torch.models.convert import gpt2_params_from_numpy
from ray_tpu_torch.train.optim import tree_leaves, tree_unflatten

tfa = importlib.import_module("ray_tpu_torch.ops.flash_attention")

# loss: f32 through 2 layers and a 512-way logsumexp, summed in another
# order; gradients: the JAX package's gradient tolerance
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
B, T = 2, 32


def _batch(form: str):
    rng = np.random.default_rng(0)
    if form == "tokens":
        return {"tokens": rng.integers(0, 512, (B, T + 1)).astype(np.int32)}
    mask = (rng.random((B, T)) < 0.7).astype(np.float32)
    return {"inputs": rng.integers(0, 512, (B, T)).astype(np.int32),
            "targets": rng.integers(0, 512, (B, T)).astype(np.int32),
            "mask": mask}


#: the non-dense CE configurations, as tests/test_fused_ce.py sizes them
CE = {"pallas": dict(ce_impl="pallas", ce_block_n=16, ce_block_v=128),
      "streaming_xla": dict(ce_impl="streaming_xla", vocab_tile=64)}


@functools.lru_cache(maxsize=None)
def _jax_reference(form: str, loss_chunks: int, ce: str = "dense"):
    """(numpy params, loss, numpy grad leaves) of JAX value_and_grad."""
    cfg = jg.gpt2_config("nano", dtype=jnp.float32, use_flash=False,
                         loss_chunks=loss_chunks, **CE.get(ce, {}))
    params = jg.gpt2_init(jax.random.PRNGKey(0), cfg)
    batch = {k: jnp.asarray(v) for k, v in _batch(form).items()}
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jg.gpt2_loss(p, batch, cfg)))(params)
    np_params = jax.tree_util.tree_map(np.asarray, params)
    return np_params, float(loss), [np.asarray(g) for g in
                                    jax.tree_util.tree_leaves(grads)]


def _port_value_and_grad(np_params, form, **cfg_kw):
    cfg = tg.gpt2_config("nano", dtype=torch.float32, **cfg_kw)
    params = gpt2_params_from_numpy(np_params, cfg, device="cpu")
    leaves = [t.requires_grad_(True) for t in tree_leaves(params)]
    batch = {k: torch.from_numpy(v) for k, v in _batch(form).items()}
    loss = tg.gpt2_loss(tree_unflatten(params, leaves), batch, cfg)
    grads = torch.autograd.grad(loss, leaves)
    return float(loss.detach()), [g.numpy() for g in grads]


REMAT = {"full": dict(remat=True, remat_policy="full"),
         "mlp_only": dict(remat=True, remat_policy="mlp_only"),
         "dots": dict(remat=True, remat_policy="dots"),
         "dots_nb": dict(remat=True, remat_policy="dots_nb"),
         "attn_out": dict(remat=True, remat_policy="attn_out"),
         "off": dict(remat=False)}


@pytest.mark.parametrize("form", ["tokens", "masked"])
@pytest.mark.parametrize("use_flash", [True, False])
@pytest.mark.parametrize("remat", sorted(REMAT))
def test_loss_and_grads_match_jax(form, use_flash, remat):
    np_params, want_loss, want_grads = _jax_reference(form, 1)
    loss, grads = _port_value_and_grad(np_params, form, use_flash=use_flash,
                                       **REMAT[remat])
    np.testing.assert_allclose(loss, want_loss, atol=LOSS_TOL,
                               rtol=LOSS_TOL)
    assert len(grads) == len(want_grads) == 16
    for i, (g, w) in enumerate(zip(grads, want_grads)):
        np.testing.assert_allclose(g, w, atol=GRAD_TOL, rtol=GRAD_TOL,
                                   err_msg=f"gradient leaf {i}")


@pytest.mark.parametrize("form", ["tokens", "masked"])
@pytest.mark.parametrize("use_flash", [True, False])
@pytest.mark.parametrize("ce", sorted(CE))
def test_ce_impls_match_jax(form, use_flash, ce):
    """The fused CE (its kernels' plain versions through the autograd
    Function) and the streaming CE against JAX's, loss and every
    gradient leaf, the wte leaf included (its gradient comes back
    through the CE in f32)."""
    np_params, want_loss, want_grads = _jax_reference(form, 1, ce)
    loss, grads = _port_value_and_grad(np_params, form, use_flash=use_flash,
                                       remat_policy="mlp_only", **CE[ce])
    np.testing.assert_allclose(loss, want_loss, atol=LOSS_TOL,
                               rtol=LOSS_TOL)
    assert len(grads) == len(want_grads) == 16
    for i, (g, w) in enumerate(zip(grads, want_grads)):
        np.testing.assert_allclose(g, w, atol=GRAD_TOL, rtol=GRAD_TOL,
                                   err_msg=f"gradient leaf {i}")


@pytest.mark.parametrize("form", ["tokens", "masked"])
@pytest.mark.parametrize("use_flash", [True, False])
def test_chunked_loss_matches_jax(form, use_flash):
    np_params, want_loss, want_grads = _jax_reference(form, 2)
    loss, grads = _port_value_and_grad(np_params, form, use_flash=use_flash,
                                       loss_chunks=2,
                                       remat_policy="mlp_only")
    np.testing.assert_allclose(loss, want_loss, atol=LOSS_TOL,
                               rtol=LOSS_TOL)
    for i, (g, w) in enumerate(zip(grads, want_grads)):
        np.testing.assert_allclose(g, w, atol=GRAD_TOL, rtol=GRAD_TOL,
                                   err_msg=f"gradient leaf {i}")


def test_forward_logits_match_jax():
    np_params = _jax_reference("tokens", 1)[0]
    tokens = _batch("tokens")["tokens"][:, :-1]
    jcfg = jg.gpt2_config("nano", dtype=jnp.float32, use_flash=False)
    want = np.asarray(jg.gpt2_forward(
        jax.tree_util.tree_map(jnp.asarray, np_params),
        jnp.asarray(tokens), jcfg))
    cfg = tg.gpt2_config("nano", dtype=torch.float32, use_flash=True)
    with torch.no_grad():
        got = tg.gpt2_forward(gpt2_params_from_numpy(np_params, cfg,
                                                     device="cpu"),
                              torch.from_numpy(tokens), cfg)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=LOSS_TOL,
                               rtol=LOSS_TOL)


def test_nll_from_logits_matches_jax():
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((2, 5, 640)).astype(np.float32)
    targets = rng.integers(0, 600, (2, 5)).astype(np.int32)
    want = np.asarray(jg.nll_from_logits(jnp.asarray(logits),
                                         jnp.asarray(targets), 600, 640))
    got = tg.nll_from_logits(torch.from_numpy(logits),
                             torch.from_numpy(targets), 600, 640)
    np.testing.assert_allclose(got.numpy(), want, atol=LOSS_TOL,
                               rtol=LOSS_TOL)


@pytest.mark.parametrize("remat,fwd,bwd", [
    ("mlp_only", 2, 2), ("full", 4, 2), ("off", 2, 2), ("dots", 4, 2),
    ("dots_nb", 4, 2), ("attn_out", 4, 2)])
def test_flash_calls_per_step_follow_remat(monkeypatch, remat, fwd, bwd):
    """mlp_only with flash runs the attention forward once per layer;
    full remat reruns it in the backward, and so do the selective
    policies: the flash forward is no op their policy can save, as a
    pallas_call is no dot in JAX (its output under "attn_out" is saved,
    but the backward still needs q, k, v and lse).  Counted on the CPU
    at the wrappers the kernels sit behind (2 layers)."""
    calls = {"fwd": 0, "bwd": 0}
    real_fwd, real_bwd = tfa.flash_attention_fwd, tfa.flash_attention_bwd

    def count(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(tfa, "flash_attention_fwd", count("fwd", real_fwd))
    monkeypatch.setattr(tfa, "flash_attention_bwd", count("bwd", real_bwd))
    np_params = _jax_reference("tokens", 1)[0]
    _port_value_and_grad(np_params, "tokens", use_flash=True,
                         **REMAT[remat])
    assert calls == {"fwd": fwd, "bwd": bwd}


@pytest.mark.parametrize("kw,match", [
    # n_experts (once kw0) runs now: tests/test_torch_moe.py holds GPT-2
    # with experts to the JAX package's.  seq_parallel runs too: without
    # a mesh both packages take causal_attention, so the loss is JAX's
    # (tests/test_torch_gpt2_seq_parallel.py holds it under meshes)
    pytest.param(dict(seq_parallel=True), "seq_parallel",
                 id="kw1-queue 1 item 7"),
])
def test_unported_options_raise(kw, match):
    cfg = tg.gpt2_config("nano", dtype=torch.float32, **kw)
    assert getattr(cfg, match) is True
    np_params = _jax_reference("tokens", 1)[0]
    params = gpt2_params_from_numpy(np_params, cfg, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch("tokens").items()}
    jcfg = jg.gpt2_config("nano", dtype=jnp.float32, use_flash=False, **kw)
    want = float(jg.gpt2_loss(
        jax.tree_util.tree_map(jnp.asarray, np_params),
        {k: jnp.asarray(v) for k, v in _batch("tokens").items()}, jcfg))
    got = float(tg.gpt2_loss(params, batch, cfg))
    assert abs(got - want) <= LOSS_TOL * abs(want)
