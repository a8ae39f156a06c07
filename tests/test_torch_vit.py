"""The port's Vision Transformer (``ray_tpu_torch/models/vit.py``)
against the JAX package's (``ray_tpu/models/vit.py``) on the CPU.

JAX initialises the parameters; the zero-initialised head is then set
to seeded non-zero values (with the zero head every backbone gradient
is exactly 0, and a gradient test would check nothing), and the tree
crosses to the port through numpy (``models/convert.py``).  Both
packages see the same seeded numpy images and labels, in float32.  The
port runs ``use_flash=True`` (the flash kernels' plain versions on CPU
tensors) and ``use_flash=False`` (the plain attention); JAX runs its
``use_flash=None``, which on the CPU takes its reference attention.

Tolerances (float32, the same operations summed in other orders):
logits and loss rtol 1e-5; every gradient leaf rtol 1e-4 with an
absolute floor of 1e-6 times the leaf's largest element for elements
near zero (the backward sums over the batch, the tokens and the heads
in another order, through two layers and a LayerNorm each side: an
element that is a small difference of large terms keeps an error of a
few float32 steps of those terms).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import vit as jv
from ray_tpu_torch.models import vit as tv
from ray_tpu_torch.models.convert import (vit_params_from_numpy,
                                          vit_params_to_numpy)
from ray_tpu_torch.train.optim import tree_leaves, tree_unflatten

OUT_RTOL = 1e-5
GRAD_RTOL = 1e-4
GRAD_ATOL_FRAC = 1e-6
BATCH = 3

#: the presets' overrides: tiny (2 layers, 2 heads of 32, patch 8,
#: 32 px) and 4 heads of 16 at the same width
CASES = {"tiny": {}, "heads4": {"n_head": 4}}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _setup(case, remat):
    jcfg = jv.vit_config("tiny", dtype=jnp.float32, remat=remat,
                         **CASES[case])
    params = _np(jv.vit_init(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(1)
    params["head_w"] = (0.1 * rng.standard_normal(
        params["head_w"].shape)).astype(np.float32)
    params["head_b"] = (0.1 * rng.standard_normal(
        params["head_b"].shape)).astype(np.float32)
    s = jcfg.image_size
    images = rng.standard_normal((BATCH, s, s, 3)).astype(np.float32)
    labels = rng.integers(0, jcfg.n_classes, BATCH).astype(np.int32)
    return jcfg, params, images, labels


_jit_forward = jax.jit(jv.vit_forward, static_argnums=(2,))
_jit_value_and_grad = jax.jit(jax.value_and_grad(jv.vit_loss),
                              static_argnums=(2,))


def _tcfg(case, remat, use_flash):
    return tv.vit_config("tiny", dtype=torch.float32, remat=remat,
                         use_flash=use_flash, **CASES[case])


@pytest.mark.parametrize("use_flash", [True, False], ids=["flash", "plain"])
@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no_remat"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_logits_loss_and_gradients_match_jax(case, remat, use_flash):
    jcfg, params, images, labels = _setup(case, remat)
    tcfg = _tcfg(case, remat, use_flash)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jbatch = {"images": jnp.asarray(images), "labels": jnp.asarray(labels)}
    jlogits = _jit_forward(jparams, jbatch["images"], jcfg)
    jloss, jgrads = _jit_value_and_grad(jparams, jbatch, jcfg)

    tparams = vit_params_from_numpy(params, tcfg, device="cpu")
    leaves = [t.requires_grad_(True) for t in tree_leaves(tparams)]
    live = tree_unflatten(tparams, leaves)
    tbatch = {"images": torch.from_numpy(images),
              "labels": torch.from_numpy(labels)}
    tlogits = tv.vit_forward(live, tbatch["images"], tcfg)
    assert tlogits.dtype == torch.float32
    assert tlogits.shape == (BATCH, tcfg.n_classes)
    np.testing.assert_allclose(tlogits.detach().numpy(), np.asarray(jlogits),
                               rtol=OUT_RTOL, atol=1e-6)
    tloss = tv.vit_loss(live, tbatch, tcfg)
    np.testing.assert_allclose(float(tloss.detach()), float(jloss),
                               rtol=OUT_RTOL)
    tgrads = torch.autograd.grad(tloss, leaves)
    jleaves = jax.tree_util.tree_leaves(jgrads)
    assert len(jleaves) == len(tgrads) == 20
    names = [n for n, _ in _flat(params)]
    for name, g, w in zip(names, tgrads, jleaves):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL_FRAC * np.abs(w).max(),
                                   err_msg=name)
    # the non-zero head lets the backbone's gradients through
    assert float(np.abs(np.asarray(jgrads["patch_w"])).sum()) > 0


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in _flat(tree[k],
                                                         f"{prefix}{k}.")]
    return [(prefix[:-1], tree)]


def test_zero_head_gives_log_classes_and_no_backbone_gradient():
    """vit_init's zero head, as the JAX test holds it: uniform logits,
    loss log(n_classes), a gradient on the head and none behind it."""
    cfg = tv.vit_config("tiny", dtype=torch.float32)
    params = tv.vit_init(torch.Generator().manual_seed(0), cfg,
                         device="cpu")
    leaves = [t.requires_grad_(True) for t in tree_leaves(params)]
    live = tree_unflatten(params, leaves)
    rng = np.random.default_rng(2)
    batch = {"images": torch.from_numpy(
        rng.standard_normal((2, 32, 32, 3)).astype(np.float32)),
        "labels": torch.tensor([1, 3])}
    loss = tv.vit_loss(live, batch, cfg)
    assert abs(float(loss.detach()) - np.log(cfg.n_classes)) < 1e-3
    grads = dict(zip([n for n, _ in _flat(params)],
                     torch.autograd.grad(loss, leaves)))
    assert all(bool(g.isfinite().all()) for g in grads.values())
    assert float(grads["head_w"].abs().sum()) > 0
    assert float(grads["patch_w"].abs().sum()) == 0.0


@pytest.mark.parametrize("name", sorted(tv._PRESETS))
def test_presets_param_count_and_logical_axes_match_jax(name):
    tcfg, jcfg = tv.vit_config(name), jv.vit_config(name)
    for f in ("image_size", "patch_size", "n_layer", "n_head", "d_model",
              "d_ff", "n_classes", "remat", "use_flash", "head_dim",
              "n_patches"):
        assert getattr(tcfg, f) == getattr(jcfg, f), f
    assert tv.vit_param_count(tcfg) == jv.vit_param_count(jcfg)
    assert tv.vit_logical_axes(tcfg) == jv.vit_logical_axes(jcfg)


@pytest.mark.parametrize("case", sorted(CASES))
def test_init_shapes_count_and_conversion_round_trip(case):
    cfg = _tcfg(case, True, None)
    params = tv.vit_init(torch.Generator().manual_seed(0), cfg,
                         device="cpu")
    jparams = jv.vit_init(jax.random.PRNGKey(0), jv.vit_config(
        "tiny", **CASES[case]))
    assert [tuple(t.shape) for t in tree_leaves(params)] == \
        [x.shape for x in jax.tree_util.tree_leaves(jparams)]
    assert sum(t.numel() for t in tree_leaves(params)) == \
        tv.vit_param_count(cfg)
    assert float(params["head_w"].abs().sum()) == 0.0
    back = vit_params_from_numpy(vit_params_to_numpy(params), cfg,
                                 device="cpu")
    for a, b in zip(tree_leaves(params), tree_leaves(back)):
        assert torch.equal(a, b)
    bad = vit_params_to_numpy(params)
    bad["blocks"]["attn"]["qkv_w"] = bad["blocks"]["attn"]["qkv_w"][:1]
    with pytest.raises(ValueError, match="blocks/attn/qkv_w"):
        vit_params_from_numpy(bad, cfg, device="cpu")


def test_flash_auto_dispatch_takes_the_plain_route_on_the_cpu(monkeypatch):
    """use_flash=None on CPU tensors runs the plain attention, and
    use_flash=True the flash wrapper (its plain version here)."""
    from ray_tpu_torch.models import vit as mod

    calls = []
    monkeypatch.setattr(mod, "flash_attention",
                        lambda *a, **kw: calls.append(kw) or
                        mod.reference_attention(*a, **kw))
    cfg = tv.vit_config("tiny", dtype=torch.float32)
    params = tv.vit_init(torch.Generator().manual_seed(0), cfg,
                         device="cpu")
    images = torch.zeros((1, 32, 32, 3))
    tv.vit_forward(params, images, cfg)
    assert calls == []
    import dataclasses

    tv.vit_forward(params, images, dataclasses.replace(cfg, use_flash=True))
    assert calls == [{"causal": False}] * cfg.n_layer
