"""The port's mixture-of-experts block and GPT-2 with experts against
the JAX package's (``ray_tpu/models/moe.py``, ``gpt2.py``).

Small sizes in float32.  JAX initializes the parameters; they cross to
the port through numpy, and both packages see the same numpy inputs
made from a seed.  The routing is compared exactly: JAX's queue
positions are read off the ``jax.nn.one_hot`` calls its
``moe_apply`` makes (eagerly, so their arguments are concrete), the
port's off ``moe_route``.  Outputs, the aux loss and gradients are
compared within the JAX package's MoE tolerance (tests/test_moe.py:
rtol = atol = 2e-4).  The block on several ranks is held to these
results in tests/test_torch_parallel.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import gpt2 as jg
from ray_tpu.models import moe as jm
from ray_tpu_torch.models import gpt2 as tg
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.models import moe as tm
from ray_tpu_torch.models.convert import (gpt2_params_from_numpy,
                                          gpt2_params_to_numpy)
from ray_tpu_torch.train.optim import adamw, tree_leaves, tree_unflatten

# tests/test_moe.py:76-78
TOL = 2e-4
AUX_RTOL = 1e-4

#: name -> (MoEConfig keywords, input shape (B, T, d)): top-2 as GPT-2's
#: experts route, top-1 with room for every token, and capacities that
#: drop tokens (0.25: 2 slots an expert for 16 tokens)
CASES = {
    "top2": (dict(d_model=32, d_ff=64, n_experts=4, top_k=2), (2, 16, 32)),
    "top1_roomy": (dict(d_model=8, d_ff=16, n_experts=2, top_k=1,
                        capacity_factor=8.0), (1, 6, 8)),
    "top1_drops": (dict(d_model=8, d_ff=16, n_experts=2, top_k=1,
                        capacity_factor=0.25), (1, 16, 8)),
    "top2_drops": (dict(d_model=16, d_ff=32, n_experts=4, top_k=2,
                        capacity_factor=0.5), (2, 8, 16)),
}


def _inputs(case):
    kw, shape = CASES[case]
    jcfg = jm.MoEConfig(dtype=jnp.float32, **kw)
    tcfg = tm.MoEConfig(dtype=torch.float32, **kw)
    params = jax.tree_util.tree_map(
        np.asarray, jm.moe_init(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(1)
    x = rng.standard_normal(shape).astype(np.float32)
    r = rng.standard_normal(shape).astype(np.float32)
    return jcfg, tcfg, params, x, r


def _jax_positions(monkeypatch, fn):
    """Run ``fn`` eagerly with ``jax.nn.one_hot`` spied on: the
    position array of the last call (the capacity one-hot of
    ``moe.py:104``) as numpy."""
    calls = []
    real = jax.nn.one_hot

    def spy(x, num_classes, **kw):
        calls.append(np.asarray(x))
        return real(x, num_classes, **kw)

    monkeypatch.setattr(jax.nn, "one_hot", spy)
    out = fn()
    monkeypatch.setattr(jax.nn, "one_hot", real)
    return out, calls[-1]


def _port_route(monkeypatch):
    """Capture what the port's moe_apply gets from moe_route."""
    got = {}
    real = tm.moe_route

    def spy(*a, **kw):
        got.update(real(*a, **kw))
        return got

    monkeypatch.setattr(tm, "moe_route", spy)
    return got


def _t(params):
    return {k: torch.from_numpy(v.copy()) for k, v in params.items()}


@pytest.mark.parametrize("case", sorted(CASES))
def test_moe_apply_matches_jax(case, monkeypatch):
    jcfg, tcfg, params, x, _ = _inputs(case)
    (want, want_aux), want_pos = _jax_positions(
        monkeypatch, lambda: jm.moe_apply(
            jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x),
            jcfg))
    route = _port_route(monkeypatch)
    got, got_aux = tm.moe_apply(_t(params), torch.from_numpy(x), tcfg)
    # the dispatch: every assignment's queue position, exactly (int32
    # as JAX casts it for its one-hot), so the same tokens are kept
    np.testing.assert_array_equal(
        route["position"].numpy().astype(np.int32), want_pos)
    cap = int(np.ceil(x.shape[0] * x.shape[1] * tcfg.top_k
                      / tcfg.n_experts * tcfg.capacity_factor))
    kept = (want_pos >= 0) & (want_pos < cap)
    np.testing.assert_array_equal(route["dispatch"].numpy(),
                                  kept.astype(np.float32))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(float(got_aux), float(want_aux),
                               rtol=AUX_RTOL)
    if case.endswith("drops"):
        # dropped assignments: fewer kept than made
        assert kept.sum() < (want_pos >= 0).sum()
        if tcfg.top_k == 1:
            # a token dropped by its only expert gives zeros (the
            # residual carries it), at most E * C tokens are nonzero
            nonzero = (np.abs(got.numpy()).sum(-1) > 1e-6).sum()
            assert nonzero <= tcfg.n_experts * cap


def test_top1_routes_to_the_argmax_expert():
    """tests/test_moe.py's hand reconstruction, on the port: with top_k
    = 1 and room for every token, each token is its argmax expert's
    MLP output scaled by its gate probability."""
    jcfg, tcfg, params, x, _ = _inputs("top1_roomy")
    y, _ = tm.moe_apply(_t(params), torch.from_numpy(x), tcfg)
    p = _t(params)
    toks = torch.from_numpy(x).reshape(-1, 8)
    probs = torch.softmax(toks @ p["gate"], dim=-1)
    want = []
    for i, tok in enumerate(toks):
        e = int(probs[i].argmax())
        h = torch.nn.functional.gelu(tok @ p["w1"][e] + p["b1"][e],
                                     approximate="tanh")
        want.append((h @ p["w2"][e] + p["b2"][e]) * probs[i, e])
    np.testing.assert_allclose(y.reshape(-1, 8).numpy(),
                               torch.stack(want).numpy(), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("case", ["top2", "top2_drops"])
def test_moe_gradients_match_jax_grad(case):
    """d(sum(y * r) + 0.01 * aux) by params and x, against jax.grad."""
    jcfg, tcfg, params, x, r = _inputs(case)

    def jloss(p, xx):
        y, aux = jm.moe_apply(p, xx, jcfg)
        return jnp.sum(y * r) + 0.01 * aux

    want = jax.grad(jloss, argnums=(0, 1))(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x))
    p = {k: v.requires_grad_(True) for k, v in _t(params).items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    y, aux = tm.moe_apply(p, xt, tcfg)
    loss = (y * torch.from_numpy(r)).sum() + 0.01 * aux
    names = sorted(p)
    grads = torch.autograd.grad(loss, [p[k] for k in names] + [xt])
    for k, g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(want[0][k]),
                                   rtol=TOL, atol=TOL, err_msg=k)
    np.testing.assert_allclose(grads[-1].numpy(), np.asarray(want[1]),
                               rtol=TOL, atol=TOL, err_msg="x")


def test_moe_init_and_logical_axes():
    cfg = tm.MoEConfig(d_model=32, d_ff=64, n_experts=4,
                       dtype=torch.float32)
    p = tm.moe_init(cfg, torch.Generator().manual_seed(0), device="cpu")
    want = jm.moe_init(jax.random.PRNGKey(0), jm.MoEConfig(
        d_model=32, d_ff=64, n_experts=4))
    assert {k: tuple(v.shape) for k, v in p.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}
    assert float(p["w1"].std()) == pytest.approx(0.02, rel=0.1)
    assert not p["b1"].any() and not p["b2"].any()
    assert tm.moe_logical_axes(cfg) == jm.moe_logical_axes(cfg)


def test_moe_trains():
    """tests/test_moe.py test_moe_trains on the port: AdamW on a
    regression target with the aux term, the loss falls by 30%."""
    cfg = tm.MoEConfig(d_model=16, d_ff=32, n_experts=4, top_k=2,
                       dtype=torch.float32)
    params = tm.moe_init(cfg, torch.Generator().manual_seed(0),
                         device="cpu")
    x = torch.randn((4, 8, 16), generator=torch.Generator().manual_seed(1))
    tgt = torch.tanh(x.flip(-1) * 0.5)
    tx = adamw(3e-3, weight_decay=0.0)
    state = tx.init(params)
    losses = []
    for _ in range(60):
        live = [t.detach().requires_grad_(True) for t in tree_leaves(params)]
        y, aux = tm.moe_apply(tree_unflatten(params, live), x, cfg)
        loss = ((y - tgt) ** 2).mean() + 0.01 * aux
        tx.update_(params, list(torch.autograd.grad(loss, live)), state)
        losses.append(float(loss.detach()))
    assert losses[-1] < losses[0] * 0.7, (losses[0], losses[-1])


# -- GPT-2 with experts ------------------------------------------------------

B, T = 2, 32
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4


def _batch():
    rng = np.random.default_rng(0)
    return {"tokens": rng.integers(0, 512, (B, T + 1)).astype(np.int32)}


_JAX_MOE = {}


def _jax_moe_reference():
    """(numpy params, loss, numpy grad leaves) of JAX value_and_grad on
    GPT-2 nano with 4 experts (use_flash=False: the JAX flash kernel
    does not run on the CPU)."""
    if not _JAX_MOE:
        cfg = jg.gpt2_config("nano", dtype=jnp.float32, use_flash=False,
                             n_experts=4, moe_top_k=2)
        params = jg.gpt2_init(jax.random.PRNGKey(0), cfg)
        batch = {k: jnp.asarray(v) for k, v in _batch().items()}
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p: jg.gpt2_loss(p, batch, cfg)))(params)
        _JAX_MOE.update(
            params=jax.tree_util.tree_map(np.asarray, params),
            loss=float(loss),
            grads=[np.asarray(g) for g in jax.tree_util.tree_leaves(grads)])
    return _JAX_MOE


@pytest.mark.parametrize("remat", ["full", "dots_nb", "off"])
@pytest.mark.parametrize("use_flash", [True, False])
def test_gpt2_moe_loss_and_grads_match_jax(remat, use_flash):
    ref = _jax_moe_reference()
    cfg = tg.gpt2_config("nano", dtype=torch.float32, use_flash=use_flash,
                         n_experts=4, moe_top_k=2, remat=remat != "off",
                         remat_policy=remat)
    params = gpt2_params_from_numpy(ref["params"], cfg, device="cpu")
    leaves = [t.requires_grad_(True) for t in tree_leaves(params)]
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    loss = tg.gpt2_loss(tree_unflatten(params, leaves), batch, cfg)
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss), ref["loss"], atol=LOSS_TOL,
                               rtol=LOSS_TOL)
    assert len(grads) == len(ref["grads"]) == 17
    for i, (g, w) in enumerate(zip(grads, ref["grads"])):
        np.testing.assert_allclose(g.numpy(), w, atol=GRAD_TOL,
                                   rtol=GRAD_TOL, err_msg=f"leaf {i}")


def test_gpt2_moe_hidden_returns_the_aux_loss():
    ref = _jax_moe_reference()
    jcfg = jg.gpt2_config("nano", dtype=jnp.float32, use_flash=False,
                          n_experts=4)
    tcfg = tg.gpt2_config("nano", dtype=torch.float32, n_experts=4,
                          use_flash=False)
    toks = _batch()["tokens"][:, :-1]
    _, want = jg.gpt2_hidden(jax.tree_util.tree_map(jnp.asarray,
                                                    ref["params"]),
                             jnp.asarray(toks), jcfg, return_aux=True)
    params = gpt2_params_from_numpy(ref["params"], tcfg, device="cpu")
    _, got = tg.gpt2_hidden(params, torch.from_numpy(toks), tcfg,
                            return_aux=True)
    np.testing.assert_allclose(float(got), float(want), rtol=AUX_RTOL)
    # a dense model's aux is 0, as JAX's
    dense = tg.gpt2_config("nano", dtype=torch.float32, use_flash=False)
    dp = tg.gpt2_init(dense, device="cpu")
    assert float(tg.gpt2_hidden(dp, torch.from_numpy(toks), dense,
                                return_aux=True)[1]) == 0.0


def test_gpt2_moe_params_round_trip_and_count():
    """convert.py carries the moe leaves both ways unchanged; the port's
    init has JAX's keys and shapes and gpt2_param_count's size."""
    ref = _jax_moe_reference()
    cfg = tg.gpt2_config("nano", dtype=torch.float32, n_experts=4)
    params = gpt2_params_from_numpy(ref["params"], cfg, device="cpu")
    assert "moe" in params["blocks"] and "mlp" not in params["blocks"]
    back = gpt2_params_to_numpy(params)
    flat = jax.tree_util.tree_leaves(back)
    for a, b in zip(flat, jax.tree_util.tree_leaves(ref["params"])):
        np.testing.assert_array_equal(a, b)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(ref["params"])
    init = tg.gpt2_init(cfg, device="cpu")
    assert [tuple(t.shape) for t in tree_leaves(init)] == \
        [a.shape for a in flat]
    assert sum(t.numel() for t in tree_leaves(init)) == \
        tg.gpt2_param_count(cfg) + (cfg.padded_vocab - cfg.vocab_size) \
        * cfg.d_model


def test_mlp_only_remat_with_experts_raises_as_jax():
    ref = _jax_moe_reference()
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    jcfg = jg.gpt2_config("nano", n_experts=4, remat_policy="mlp_only",
                          use_flash=False)
    with pytest.raises(NotImplementedError) as want:
        jg.gpt2_loss(jax.tree_util.tree_map(jnp.asarray, ref["params"]),
                     {k: jnp.asarray(v) for k, v in _batch().items()}, jcfg)
    cfg = tg.gpt2_config("nano", dtype=torch.float32, n_experts=4,
                         remat_policy="mlp_only")
    params = gpt2_params_from_numpy(ref["params"], cfg, device="cpu")
    with pytest.raises(NotImplementedError) as got:
        tg.gpt2_loss(params, batch, cfg)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("n_experts", [0, 4])
def test_logical_axes_match_jax(n_experts):
    assert tg.gpt2_logical_axes(tg.gpt2_config(
        "nano", n_experts=n_experts)) == jg.gpt2_logical_axes(
        jg.gpt2_config("nano", n_experts=n_experts))
    from ray_tpu.models import llama as jl

    assert tl.llama_logical_axes(tl.llama_config("nano")) == \
        jl.llama_logical_axes(jl.llama_config("nano"))
