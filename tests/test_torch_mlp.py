"""The port's MLP classifier (``ray_tpu_torch/models/mlp.py``) against
the JAX package's (``ray_tpu/models/mlp.py``).

JAX initializes the parameters; they cross to the port through numpy
(``models/convert.py``'s ``mlp_params_from_numpy``), and both packages
see the same numpy batch made from a seed.  Loss and every gradient
leaf are held to ``jax.value_and_grad(mlp_loss)`` at rtol 1e-5 (f32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import mlp as jm
from ray_tpu_torch.models import mlp as tm
from ray_tpu_torch.models.convert import (mlp_params_from_numpy,
                                          mlp_params_to_numpy)
from ray_tpu_torch.train.optim import tree_leaves, tree_unflatten

RTOL = 1e-5
#: gradients summed over the batch in another order: an absolute floor
#: for elements near zero (f32, a batch of 32)
ATOL = 1e-6

#: (in_dim, hidden, n_classes, batch): the trainer tests' shape, two
#: hidden layers, and the defaults' widths (fashion-MNIST)
SHAPES = {"trainer": (8, (16,), 3, 64), "deep": (12, (24, 20), 5, 32),
          "fashion": (784, (128, 128), 10, 16)}


def _setup(shape):
    in_dim, hidden, n_classes, b = SHAPES[shape]
    jcfg = jm.MLPConfig(in_dim=in_dim, hidden=hidden, n_classes=n_classes)
    tcfg = tm.MLPConfig(in_dim=in_dim, hidden=hidden, n_classes=n_classes)
    params = jax.tree_util.tree_map(np.asarray,
                                    jm.mlp_init(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(1)
    x = rng.standard_normal((b, in_dim)).astype(np.float32)
    y = rng.integers(0, n_classes, b).astype(np.int32)
    return jcfg, tcfg, params, x, y


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_loss_and_gradients_match_jax(shape):
    jcfg, tcfg, params, x, y = _setup(shape)
    jloss, jgrads = jax.value_and_grad(jm.mlp_loss)(
        jax.tree_util.tree_map(jnp.asarray, params),
        {"x": jnp.asarray(x), "y": jnp.asarray(y)}, jcfg)
    tparams = mlp_params_from_numpy(params, tcfg, device="cpu")
    leaves = [t.requires_grad_(True) for t in tree_leaves(tparams)]
    tloss = tm.mlp_loss(tree_unflatten(tparams, leaves),
                        {"x": torch.from_numpy(x), "y": torch.from_numpy(y)},
                        tcfg)
    tgrads = torch.autograd.grad(tloss, leaves)
    np.testing.assert_allclose(float(tloss.detach()), float(jloss),
                               rtol=RTOL)
    jleaves = jax.tree_util.tree_leaves(jgrads)
    assert len(jleaves) == len(tgrads) == 2 * (len(tcfg.hidden) + 1)
    for jg, tg in zip(jleaves, tgrads):
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=RTOL,
                                   atol=ATOL)


def test_forward_matches_jax_on_image_shaped_input():
    """mlp_forward flattens (B, 28, 28) images as the JAX one does."""
    jcfg, tcfg, params, _, _ = _setup("fashion")
    x = np.random.default_rng(2).standard_normal((4, 28, 28)).astype(
        np.float32)
    want = np.asarray(jm.mlp_forward(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x), jcfg))
    got = tm.mlp_forward(mlp_params_from_numpy(params, tcfg, device="cpu"),
                         torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_init_layout_scale_and_logical_axes_match_jax():
    jcfg, tcfg, params, _, _ = _setup("deep")
    t = tm.mlp_init(torch.Generator().manual_seed(0), tcfg, device="cpu")
    assert jax.tree_util.tree_structure(
        mlp_params_to_numpy(t)) == jax.tree_util.tree_structure(params)
    for got, want in zip(tree_leaves(t), jax.tree_util.tree_leaves(params)):
        assert tuple(got.shape) == want.shape
        assert got.dtype == torch.float32 and want.dtype == np.float32
    # He-normal weights: std sqrt(2 / d_in); zero biases
    for layer, (d_in, _) in zip(t["layers"], tm.mlp_dims(tcfg)):
        assert abs(float(layer["w"].std()) / np.sqrt(2.0 / d_in) - 1) < 0.15
        assert not layer["b"].any()
    assert tm.mlp_logical_axes(tcfg) == jm.mlp_logical_axes(jcfg)
    # a seeded generator gives the same weights twice
    again = tm.mlp_init(torch.Generator().manual_seed(0), tcfg, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(t),
                                                tree_leaves(again)))


def test_convert_round_trips_and_names_a_bad_layer():
    _, tcfg, params, _, _ = _setup("trainer")
    back = mlp_params_to_numpy(mlp_params_from_numpy(params, tcfg,
                                                     device="cpu"))
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(a, b)
    bad = {"layers": [dict(params["layers"][0]),
                      {"w": np.zeros((16, 4), np.float32),
                       "b": np.zeros(4, np.float32)}]}
    with pytest.raises(ValueError, match=r"MLP param /layers/1/w"):
        mlp_params_from_numpy(bad, tcfg, device="cpu")
    with pytest.raises(ValueError, match="expected a list of 2"):
        mlp_params_from_numpy({"layers": params["layers"][:1]}, tcfg,
                              device="cpu")
