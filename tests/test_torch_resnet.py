"""The port's ResNet (``ray_tpu_torch/models/resnet.py``) against the
JAX package's (``ray_tpu/models/resnet.py``) on the CPU.

JAX initialises the parameters and the batch-norm state; both cross to
the port through numpy (``models/convert.py``).  Both packages see the
same seeded numpy images and labels, in float32, at an even and an odd
image size (32 and 33: "SAME" padding at stride 2 is asymmetric, and
at an odd size the 7x7/2 stem pads (3, 3) where an even one pads
(2, 3)).  Two configurations: ``tiny`` (basic blocks, 2 stages) and a
bottleneck one of ResNet-50's shape cut to one block a stage at width
16 (its stride in the middle conv, a projection in both blocks).

Tolerances (float32, the same operations summed in other orders):
logits, loss and the new batch-norm state rtol 1e-5 with an absolute
floor of 1e-6 times the tensor's largest element; every gradient leaf
rtol 1e-4 with the same floor scaled by 10 (the backward of each batch
norm subtracts sums over N, H and W that nearly cancel).  A float64
config's gradient with the batch reversed stays within rtol 1e-12 a
leaf of the forward batch's (1e-15 measured; float32 moves 1e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import resnet as jr
from ray_tpu_torch.models import resnet as tr
from ray_tpu_torch.models.convert import (resnet_params_from_numpy,
                                          resnet_params_to_numpy,
                                          resnet_state_from_numpy)
from ray_tpu_torch.train.optim import tree_leaves, tree_map, tree_unflatten

OUT_RTOL = 1e-5
OUT_ATOL_FRAC = 1e-6
GRAD_RTOL = 1e-4
GRAD_ATOL_FRAC = 1e-5
F64_REVERSED_RTOL = 1e-12
BATCH = 4

#: (preset, overrides)
CASES = {"tiny": ("tiny", {}),
         "bottleneck": ("resnet50", dict(blocks=(1, 1), width=16,
                                         n_classes=10))}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, want, rtol, atol_frac, what):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=atol_frac * np.abs(want).max(),
                               err_msg=what)


def _setup(case, size):
    name, kw = CASES[case]
    jcfg = jr.resnet_config(name, dtype=jnp.float32, **kw)
    tcfg = tr.resnet_config(name, dtype=torch.float32, **kw)
    params, state = (_np(t) for t in jr.resnet_init(jax.random.PRNGKey(0),
                                                    jcfg))
    rng = np.random.default_rng(1)
    x = rng.standard_normal((BATCH, size, size, 3)).astype(np.float32)
    y = rng.integers(0, jcfg.n_classes, BATCH).astype(np.int32)
    return jcfg, tcfg, params, state, x, y


_jit_forward = jax.jit(jr.resnet_forward, static_argnums=(3,))
_jit_eval_forward = jax.jit(
    lambda p, s, x, cfg: jr.resnet_forward(p, s, x, cfg, training=False),
    static_argnums=(3,))
_jit_value_and_grad = jax.jit(jax.value_and_grad(jr.resnet_loss,
                                                 has_aux=True),
                              static_argnums=(3,))


def _pairs(a, b, prefix=""):
    """(path, a leaf, b leaf) over two trees of one layout."""
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), (prefix, sorted(a), sorted(b))
        return [p for k in sorted(a) for p in _pairs(a[k], b[k],
                                                     f"{prefix}/{k}")]
    if isinstance(a, (list, tuple)):
        assert len(a) == len(b), prefix
        return [p for i, (x, y) in enumerate(zip(a, b))
                for p in _pairs(x, y, f"{prefix}/{i}")]
    return [(prefix, a, b)]


def _t2np(tree):
    return jax.tree_util.tree_map(lambda t: t.detach().numpy(), tree)


@pytest.mark.parametrize("size", [32, 33])
@pytest.mark.parametrize("case", sorted(CASES))
def test_training_forward_state_and_gradients_match_jax(case, size):
    jcfg, tcfg, params, state, x, y = _setup(case, size)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    js = jax.tree_util.tree_map(jnp.asarray, state)
    jbatch = {"x": jnp.asarray(x), "y": jnp.asarray(y)}
    jlogits, _ = _jit_forward(jp, js, jbatch["x"], jcfg)
    (jloss, jstate), jgrads = _jit_value_and_grad(jp, js, jbatch, jcfg)

    tp = resnet_params_from_numpy(params, tcfg, device="cpu")
    ts = resnet_state_from_numpy(state, tcfg, device="cpu")
    leaves = [t.requires_grad_(True) for t in tree_leaves(tp)]
    live = tree_unflatten(tp, leaves)
    tbatch = {"x": torch.from_numpy(x), "y": torch.from_numpy(y)}
    tlogits, _ = tr.resnet_forward(live, ts, tbatch["x"], tcfg,
                                   training=True)
    assert tlogits.dtype == torch.float32
    _close(tlogits.detach(), jlogits, OUT_RTOL, OUT_ATOL_FRAC, "logits")
    tloss, tstate = tr.resnet_loss(live, ts, tbatch, tcfg, training=True)
    _close(float(tloss.detach()), float(jloss), OUT_RTOL, 0.0, "loss")
    pairs = _pairs(_t2np(tstate), _np(jstate))
    # the stem, every block conv and every projection has a state
    n_bn = 1 + sum(len(b["bns"]) + ("proj_bn" in b)
                   for b in params["blocks"])
    assert len(pairs) == 2 * n_bn
    for path, got, want in pairs:
        assert got.dtype == np.float32
        _close(got, want, OUT_RTOL, OUT_ATOL_FRAC, f"state {path}")
    # the state moved off its init (mean 0, var 1) and carries no graph
    assert not np.allclose(_t2np(tstate)["stem"]["mean"], 0.0)
    assert not any(t.requires_grad for t in tree_leaves(tstate))
    tgrads = torch.autograd.grad(tloss, leaves)
    gpairs = _pairs(tree_unflatten(tp, [g.numpy() for g in tgrads]),
                    _np(jgrads))
    assert len(gpairs) == len(leaves)
    for path, got, want in gpairs:
        _close(got, want, GRAD_RTOL, GRAD_ATOL_FRAC, f"grad {path}")


@pytest.mark.parametrize("case", sorted(CASES))
def test_float64_config_computes_in_float64(case):
    """A float64 config stays float64 through the batch norms and the
    head (the card's gradient check runs there): float64 logits, the
    loss and every gradient leaf those of the JAX package's float32
    ones within this file's tolerances, and a reversed batch moves each
    leaf by float64 rounding only."""
    jcfg, _, params, state, x, y = _setup(case, 33)
    name, kw = CASES[case]
    cfg = tr.resnet_config(name, dtype=torch.float64,
                           param_dtype=torch.float64, **kw)
    (jloss, _), jgrads = _jit_value_and_grad(
        jax.tree_util.tree_map(jnp.asarray, params),
        jax.tree_util.tree_map(jnp.asarray, state),
        {"x": jnp.asarray(x), "y": jnp.asarray(y)}, jcfg)
    tp = tree_map(torch.Tensor.double,
                  resnet_params_from_numpy(params, cfg, device="cpu"))
    ts = tree_map(torch.Tensor.double,
                  resnet_state_from_numpy(state, cfg, device="cpu"))

    def loss_and_grads(xb, yb):
        leaves = [t.detach().requires_grad_(True) for t in tree_leaves(tp)]
        batch = {"x": torch.from_numpy(np.ascontiguousarray(xb)),
                 "y": torch.from_numpy(np.ascontiguousarray(yb))}
        loss, _ = tr.resnet_loss(tree_unflatten(tp, leaves), ts, batch,
                                 cfg)
        return loss, torch.autograd.grad(loss, leaves)

    with torch.no_grad():
        logits, _ = tr.resnet_forward(tp, ts, torch.from_numpy(x), cfg)
    assert logits.dtype == torch.float64
    tloss, tgrads = loss_and_grads(x, y)
    assert tloss.dtype == torch.float64
    assert all(g.dtype == torch.float64 for g in tgrads)
    _close(float(tloss.detach()), float(jloss), OUT_RTOL, 0.0, "loss")
    gpairs = _pairs(tree_unflatten(tp, [g.numpy() for g in tgrads]),
                    _np(jgrads))
    for path, got, want in gpairs:
        _close(got, want, GRAD_RTOL, GRAD_ATOL_FRAC, f"grad {path}")
    _, rgrads = loss_and_grads(x[::-1], y[::-1])
    for (path, _, _), a, b in zip(gpairs, rgrads, tgrads):
        rel = float((a - b).norm() / b.norm())
        assert rel <= F64_REVERSED_RTOL, (path, rel)


@pytest.mark.parametrize("size", [32, 33])
@pytest.mark.parametrize("case", sorted(CASES))
def test_eval_forward_matches_jax_on_trained_statistics(case, size):
    """Evaluation mode reads the running statistics: those one training
    forward leaves behind (in JAX), so they are not the init's 0 and
    1; the state comes back unchanged."""
    jcfg, tcfg, params, state, x, y = _setup(case, size)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    _, jstate = _jit_forward(jp, jax.tree_util.tree_map(
        jnp.asarray, state), jnp.asarray(x), jcfg)
    jlogits, _ = _jit_eval_forward(jp, jstate, jnp.asarray(x[::-1]), jcfg)
    tp = resnet_params_from_numpy(params, tcfg, device="cpu")
    ts = resnet_state_from_numpy(_np(jstate), tcfg, device="cpu")
    with torch.no_grad():
        tlogits, tsame = tr.resnet_forward(
            tp, ts, torch.from_numpy(np.ascontiguousarray(x[::-1])), tcfg,
            training=False)
    _close(tlogits, jlogits, OUT_RTOL, OUT_ATOL_FRAC, "eval logits")
    assert all(a is b for a, b in zip(tree_leaves(tsame), tree_leaves(ts)))


@pytest.mark.parametrize("size,k,stride,want", [
    (32, 7, 2, (2, 3)), (33, 7, 2, (3, 3)), (16, 3, 2, (0, 1)),
    (17, 3, 2, (1, 1)), (8, 1, 2, (0, 0)), (8, 3, 1, (1, 1))])
def test_same_padding_is_xlas(size, k, stride, want):
    """_same_pads against lax.conv_general_dilated's "SAME": a delta
    image through a kernel of ones shows where the window starts."""
    assert tr._same_pads(size, k, stride) == want
    x = np.zeros((1, size, 1, 1), np.float32)
    x[0, 0] = 1.0
    out = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.ones((k, 1, 1, 1)), (stride, 1),
        ((want[0], want[1]), (0, 0)),
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    same = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.ones((k, 1, 1, 1)), (stride, 1), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    np.testing.assert_array_equal(np.asarray(out), np.asarray(same))


@pytest.mark.parametrize("name", sorted(tr._STAGES))
def test_presets_block_channels_and_logical_axes_match_jax(name):
    tcfg, jcfg = tr.resnet_config(name), jr.resnet_config(name)
    for f in ("blocks", "bottleneck", "n_classes", "width", "bn_momentum"):
        assert getattr(tcfg, f) == getattr(jcfg, f), f
    assert tr._block_channels(tcfg) == jr._block_channels(jcfg)
    assert tr.resnet_logical_axes(tcfg) == jr.resnet_logical_axes(jcfg)


@pytest.mark.parametrize("case", sorted(CASES))
def test_init_layout_and_conversion_round_trip(case):
    name, kw = CASES[case]
    tcfg = tr.resnet_config(name, **kw)
    params, state = tr.resnet_init(torch.Generator().manual_seed(0), tcfg,
                                   device="cpu")
    jparams, jstate = jr.resnet_init(jax.random.PRNGKey(0),
                                     jr.resnet_config(name, **kw))
    for mine, theirs in ((params, jparams), (state, jstate)):
        got = [(p, tuple(a.shape), str(a.dtype).split(".")[-1])
               for p, a, _ in _pairs(mine, _np(theirs))]
        want = [(p, tuple(b.shape), str(b.dtype))
                for p, _, b in _pairs(mine, _np(theirs))]
        assert got == want
    back = resnet_params_from_numpy(resnet_params_to_numpy(params), tcfg,
                                    device="cpu")
    for a, b in zip(tree_leaves(params), tree_leaves(back)):
        assert torch.equal(a, b)
    bad = resnet_params_to_numpy(params)
    del bad["blocks"][-1]["proj"]
    with pytest.raises(ValueError, match="blocks/1"):
        resnet_params_from_numpy(bad, tcfg, device="cpu")
    with pytest.raises(ValueError, match="list of"):
        resnet_state_from_numpy({"stem": resnet_params_to_numpy(state)[
            "stem"], "blocks": []}, tcfg, device="cpu")
