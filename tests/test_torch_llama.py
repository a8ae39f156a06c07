"""The port's llama training forward and loss against the JAX package's.

Nano preset in float32.  The JAX package initializes the parameters
(``llama_init``); they cross to the port through numpy
(models/convert.py), and both packages see the same numpy batch.  JAX
runs ``use_flash=False`` (its model passes no ``interpret`` to the
flash kernel, so that Pallas kernel cannot run on the CPU); the port
runs both ``use_flash=True`` (the flash autograd Function over the
kernels' plain versions) and ``False``.  ``ce_impl="pallas"`` runs the
JAX fused-CE Pallas kernels in interpret mode (the package picks it off
the TPU), ``"streaming_xla"`` its ``lax.scan``.  GQA is the nano
preset's one KV head for two query heads, MHA its ``n_kv_head=2``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import llama as jl
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.models.convert import (llama_params_from_numpy,
                                          llama_params_to_numpy)
from ray_tpu_torch.train.optim import tree_leaves, tree_unflatten

# loss: f32 through 2 layers and a 512-way logsumexp, summed in another
# order; gradients: the JAX package's gradient tolerance (the tolerances
# of tests/test_torch_gpt2_train.py)
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
B, T = 2, 32

#: the non-dense CE configurations, as tests/test_fused_ce.py sizes them
CE = {"dense": {},
      "pallas": dict(ce_impl="pallas", ce_block_n=16, ce_block_v=128),
      "streaming_xla": dict(ce_impl="streaming_xla", vocab_tile=64)}
#: attention layouts: GQA (the nano preset, 2 query heads on 1 KV head)
#: and MHA
HEADS = {"gqa": 1, "mha": 2}


def _batch(form: str):
    rng = np.random.default_rng(0)
    if form == "tokens":
        return {"tokens": rng.integers(0, 512, (B, T + 1)).astype(np.int32)}
    mask = (rng.random((B, T)) < 0.7).astype(np.float32)
    return {"inputs": rng.integers(0, 512, (B, T)).astype(np.int32),
            "targets": rng.integers(0, 512, (B, T)).astype(np.int32),
            "mask": mask}


@functools.lru_cache(maxsize=None)
def _jax_reference(form: str, ce: str, heads: str):
    """(numpy params, loss, numpy grad leaves) of JAX value_and_grad."""
    cfg = jl.llama_config("nano", dtype=jnp.float32, use_flash=False,
                          n_kv_head=HEADS[heads], **CE[ce])
    params = jl.llama_init(jax.random.PRNGKey(0), cfg)
    batch = {k: jnp.asarray(v) for k, v in _batch(form).items()}
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jl.llama_loss(p, batch, cfg)))(params)
    np_params = jax.tree_util.tree_map(np.asarray, params)
    return np_params, float(loss), [np.asarray(g) for g in
                                    jax.tree_util.tree_leaves(grads)]


def _port_value_and_grad(np_params, form, **cfg_kw):
    cfg = tl.llama_config("nano", dtype=torch.float32, **cfg_kw)
    params = llama_params_from_numpy(np_params, cfg, device="cpu")
    leaves = [t.requires_grad_(True) for t in tree_leaves(params)]
    batch = {k: torch.from_numpy(v) for k, v in _batch(form).items()}
    loss = tl.llama_loss(tree_unflatten(params, leaves), batch, cfg)
    grads = torch.autograd.grad(loss, leaves)
    return float(loss.detach()), [g.numpy() for g in grads]


def _check(form, ce, heads, **kw):
    np_params, want_loss, want_grads = _jax_reference(form, ce, heads)
    loss, grads = _port_value_and_grad(np_params, form,
                                       n_kv_head=HEADS[heads], **CE[ce],
                                       **kw)
    np.testing.assert_allclose(loss, want_loss, atol=LOSS_TOL,
                               rtol=LOSS_TOL)
    assert len(grads) == len(want_grads) == 12
    for i, (g, w) in enumerate(zip(grads, want_grads)):
        np.testing.assert_allclose(g, w, atol=GRAD_TOL, rtol=GRAD_TOL,
                                   err_msg=f"gradient leaf {i}")


@pytest.mark.parametrize("heads", sorted(HEADS))
@pytest.mark.parametrize("use_flash", [True, False])
@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("ce", sorted(CE))
def test_loss_and_grads_match_jax(ce, remat, use_flash, heads):
    """Loss and every gradient leaf (the lm_head's through the CE, in
    f32) against jax.value_and_grad(llama_loss)."""
    _check("tokens", ce, heads, use_flash=use_flash, remat=remat)


@pytest.mark.parametrize("heads", sorted(HEADS))
@pytest.mark.parametrize("ce", sorted(CE))
def test_masked_loss_and_grads_match_jax(ce, heads):
    _check("masked", ce, heads, use_flash=True, remat=True)


@pytest.mark.parametrize("heads", sorted(HEADS))
@pytest.mark.parametrize("use_flash", [True, False])
def test_forward_logits_match_jax(use_flash, heads):
    np_params = _jax_reference("tokens", "dense", heads)[0]
    tokens = _batch("tokens")["tokens"][:, :-1]
    jcfg = jl.llama_config("nano", dtype=jnp.float32, use_flash=False,
                           n_kv_head=HEADS[heads])
    want = np.asarray(jl.llama_forward(
        jax.tree_util.tree_map(jnp.asarray, np_params),
        jnp.asarray(tokens), jcfg))
    cfg = tl.llama_config("nano", dtype=torch.float32, use_flash=use_flash,
                          n_kv_head=HEADS[heads])
    with torch.no_grad():
        got = tl.llama_forward(llama_params_from_numpy(np_params, cfg,
                                                       device="cpu"),
                               torch.from_numpy(tokens), cfg)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=LOSS_TOL,
                               rtol=LOSS_TOL)


@pytest.mark.parametrize("T,hd,theta", [(128, 32, 1e4), (2048, 64, 1e4),
                                        (300, 128, 5e5)])
def test_rope_frequencies_match_jax(T, hd, theta):
    jc, js = jl.rope_frequencies(T, hd, theta)
    tc, ts = tl.rope_frequencies(T, hd, theta, device="cpu")
    assert tc.dtype == torch.float32 and tuple(tc.shape) == (T, hd // 2)
    # f32 angles up to T rad: one ulp of the inverse frequency moves a
    # cos or sin by up to T * 2**-24
    tol = T * 2.0 ** -24 + 1e-6
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=tol)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=tol)


def test_apply_rope_rotates_interleaved_pairs_like_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 16, 3, 32)).astype(np.float32)
    jcos, jsin = jl.rope_frequencies(16, 32, 1e4)
    want = np.asarray(jl.apply_rope(jnp.asarray(x), jcos, jsin))
    cos, sin = (torch.from_numpy(np.array(t)) for t in (jcos, jsin))
    got = tl.apply_rope(torch.from_numpy(x), cos, sin)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-6)
    # a half-split rotation keeps the norm too but rotates other pairs
    half = torch.cat([torch.from_numpy(x[..., 0::2]),
                      torch.from_numpy(x[..., 1::2])], dim=-1)
    assert not np.allclose(tl.apply_rope(half, cos, sin).numpy(), want,
                           atol=1e-3)
    # bf16 in, bf16 out (the rotation itself runs in f32)
    assert tl.apply_rope(torch.from_numpy(x).bfloat16(), cos,
                         sin).dtype == torch.bfloat16


def test_rmsnorm_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32) * 3
    scale = rng.standard_normal(64).astype(np.float32)
    want = np.asarray(jl._rmsnorm(jnp.asarray(x), jnp.asarray(scale),
                                  1e-5))
    got = tl._rmsnorm(torch.from_numpy(x), torch.from_numpy(scale), 1e-5)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-6)
    assert tl._rmsnorm(torch.from_numpy(x).bfloat16(),
                       torch.from_numpy(scale), 1e-5).dtype == torch.bfloat16


def test_gqa_repeat_is_head_wise():
    """Head j reads KV head j // group, as jnp.repeat(..., axis=2)."""
    x = np.arange(2 * 3 * 4 * 2, dtype=np.float32).reshape(2, 3, 4, 2)
    want = np.asarray(jnp.repeat(jnp.asarray(x), 3, axis=2))
    got = tl.repeat_kv(torch.from_numpy(x), 12)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", sorted(jl._PRESETS))
def test_presets_match_jax(name):
    jc, tc = jl.llama_config(name), tl.llama_config(name)
    assert tl._PRESETS == jl._PRESETS
    for field in ("vocab_size", "max_seq", "n_layer", "n_head",
                  "n_kv_head", "d_model", "d_ff", "head_dim",
                  "padded_vocab", "rope_theta", "rms_eps", "remat",
                  "ce_impl"):
        assert getattr(tc, field) == getattr(jc, field), field
    assert tl.llama_param_count(tc) == jl.llama_param_count(jc)
    assert tc.dtype == torch.bfloat16 and tc.param_dtype == torch.float32


def test_llama_1b_is_the_documented_size():
    cfg = tl.llama_config("llama-1b")
    assert (cfg.n_layer, cfg.n_head, cfg.n_kv_head, cfg.head_dim,
            cfg.d_model, cfg.d_ff, cfg.vocab_size, cfg.max_seq) == \
        (16, 32, 8, 64, 2048, 5504, 32000, 2048)
    assert cfg.padded_vocab == cfg.vocab_size
    assert 830e6 < tl.llama_param_count(cfg) < 850e6


def test_init_layout_matches_jax():
    jcfg = jl.llama_config("nano", dtype=jnp.float32)
    jparams = jl.llama_init(jax.random.PRNGKey(0), jcfg)
    tcfg = tl.llama_config("nano", dtype=torch.float32)
    tparams = tl.llama_init(tcfg, torch.Generator().manual_seed(0), "cpu")
    assert jax.tree.map(lambda t: tuple(t.shape), tparams) == \
        jax.tree.map(lambda a: tuple(a.shape), jparams)
    assert all(t.dtype == torch.float32 for t in tree_leaves(tparams))
    assert abs(float(tparams["lm_head"].std()) - 0.02) < 2e-3
    assert bool((tparams["blocks"]["ln1"]["scale"] == 1).all())
    wo_std = float(tparams["blocks"]["attn"]["wo"].std())
    assert abs(wo_std - 0.02 / 2) < 2e-3      # 0.02 / sqrt(2 * 2 layers)


_BAD_CONFIGS = [
    {"ce_impl": "bogus"},
    {"flash_resident": "maybe"},
    {"ce_impl": "x", "flash_resident": "y"},
]


@pytest.mark.parametrize("bad", _BAD_CONFIGS)
def test_config_validation_messages_match_jax(bad):
    with pytest.raises(ValueError) as jerr:
        jl.LlamaConfig(**bad)
    with pytest.raises(ValueError) as terr:
        tl.LlamaConfig(**bad)
    assert str(terr.value) == str(jerr.value)


def test_kv_heads_must_divide_query_heads_like_jax():
    with pytest.raises(ValueError) as jerr:
        jl.llama_config("tiny", n_kv_head=3)
    with pytest.raises(ValueError) as terr:
        tl.llama_config("tiny", n_kv_head=3)
    assert str(terr.value) == str(jerr.value)


def test_params_round_trip_is_exact():
    np_params = _jax_reference("tokens", "dense", "gqa")[0]
    cfg = tl.llama_config("nano", dtype=torch.float32)
    tparams = llama_params_from_numpy(np_params, cfg, "cpu")
    back = llama_params_to_numpy(tparams)
    flat_j = jax.tree_util.tree_leaves_with_path(np_params)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_b] == [p for p, _ in flat_j]
    for (_, a), (_, b) in zip(flat_j, flat_b):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("leaf", ["wte", "lm_head", "blocks/attn/wk"])
def test_params_from_numpy_rejects_wrong_layout(leaf):
    np_params = _jax_reference("tokens", "dense", "gqa")[0]
    tree = jax.tree.map(lambda a: a, np_params)
    cfg = tl.llama_config("nano", dtype=torch.float32)
    node = tree
    *parents, name = leaf.split("/")
    for p in parents:
        node = node[p]
    # the transposed lm_head, or a KV head too many: both wrong layouts
    node[name] = np.swapaxes(node[name], 0, 1) if name == "lm_head" \
        else np.concatenate([node[name]] * 2, axis=-2 if name == "wk"
                            else 0)
    with pytest.raises(ValueError, match=name):
        llama_params_from_numpy(tree, cfg, "cpu")
    del tree["ln_f"]
    with pytest.raises(ValueError, match="expected keys"):
        llama_params_from_numpy(tree, cfg, "cpu")


def test_entry_points_need_an_explicit_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tl.llama_config("nano")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tl.llama_init(cfg)
    assert tl.llama_init(cfg, device="cpu")["wte"].device.type == "cpu"
