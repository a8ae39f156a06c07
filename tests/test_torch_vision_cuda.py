"""ViT and ResNet on the card: the ViT loss and gradient through the
non-causal flash kernels against the plain attention, with their
launches, and ResNet's on the card against the port on the CPU.

Needs an NVIDIA GPU: every test here is marked ``cuda`` and skips with
a reason where ``torch.cuda.is_available()`` is false.  This file
imports no JAX, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_vision_cuda.py

Tolerances, f32, each gradient leaf as ||card - reference|| /
||reference|| (both sum the same float32 products in other orders; a
dropped ragged key tile or a wrong padding moves them by percents):
ViT those of chip_smoke.py's phase vision (a), the loss within 1e-5
and each leaf within 2e-5 (1.9e-6 measured at 12 layers on an H100);
ResNet tiny, which is better conditioned at B=4 than ResNet-50 at B=2
but still backs every gradient through its batch norms, the loss
within 1e-4 and each leaf, statistic and logit within 1e-3.
"""

import dataclasses
import importlib

import pytest
import torch

from ray_tpu_torch.models import resnet as tr
from ray_tpu_torch.models import vit as tv
from ray_tpu_torch.train.optim import tree_leaves, tree_map, tree_unflatten

VIT_LOSS_TOL = 1e-5
VIT_REL_TOL = 2e-5
LOSS_TOL = 1e-4
REL_TOL = 1e-3


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA): the flash kernels and "
                    "cuDNN run on the card")
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    # f32 products in f32, as on the CPU
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda:0")
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = old


def _rel(got, want):
    return float((got.float() - want.float()).norm()
                 / want.float().norm().clamp_min(1e-30))


def _loss_and_grads(loss_fn, params):
    leaves = [x.detach().requires_grad_(True) for x in tree_leaves(params)]
    out = loss_fn(tree_unflatten(params, leaves))
    loss = out[0] if isinstance(out, tuple) else out
    return out, torch.autograd.grad(loss, leaves)


@pytest.mark.cuda
@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no_remat"])
def test_vit_b16_width_flash_matches_plain_attention(card, remat):
    """ViT-B/16's widths at 224 px (T = 197: a ragged last key tile)
    cut to 2 layers, f32, a seeded non-zero head: the flash kernels'
    loss and every gradient leaf against use_flash=False, and the
    launches of one loss and gradient (forward twice a layer with
    remat)."""
    fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")
    cfg = tv.vit_config("vit-b16", n_layer=2, dtype=torch.float32,
                        remat=remat)
    gen = torch.Generator(device=card).manual_seed(0)
    params = tv.vit_init(gen, cfg, device=card)
    for k in ("head_w", "head_b"):
        params[k] = 0.02 * torch.randn(params[k].shape, generator=gen,
                                       device=card)
    batch = {"images": torch.randn((2, 224, 224, 3), generator=gen,
                                   device=card),
             "labels": torch.randint(0, 1000, (2,), generator=gen,
                                     device=card)}
    results = {}
    for use_flash in (False, True):
        c = dataclasses.replace(cfg, use_flash=use_flash)
        for n in ("FLASH_FWD_LAUNCHES", "FLASH_BWD_DQ_LAUNCHES",
                  "FLASH_BWD_DKV_LAUNCHES"):
            setattr(fa, n, 0)
        loss, grads = _loss_and_grads(
            lambda p: tv.vit_loss(p, batch, c), params)
        torch.cuda.synchronize()
        results[use_flash] = (float(loss.detach()), grads, (
            fa.FLASH_FWD_LAUNCHES, fa.FLASH_BWD_DQ_LAUNCHES,
            fa.FLASH_BWD_DKV_LAUNCHES))
    (pl, pg, pc), (fl, fg, fc) = results[False], results[True]
    assert pc == (0, 0, 0)
    assert fc == ((4 if remat else 2), 2, 2)
    assert abs(fl - pl) <= VIT_LOSS_TOL
    for g, w in zip(fg, pg):
        assert bool(g.isfinite().all())
        assert _rel(g, w) <= VIT_REL_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("size", [32, 33])
def test_resnet_tiny_on_the_card_matches_the_cpu(card, size):
    """ResNet tiny, f32, training mode: logits, loss, the new batch-norm
    state and every gradient leaf on the card against the port on the
    CPU, at an even and an odd image size; evaluation logits too."""
    cfg = tr.resnet_config("tiny", dtype=torch.float32)
    gen = torch.Generator().manual_seed(1)
    params, state = tr.resnet_init(gen, cfg, device="cpu")
    batch = {"x": torch.randn((4, size, size, 3), generator=gen),
             "y": torch.randint(0, cfg.n_classes, (4,), generator=gen)}

    def run(p, s, b):
        (loss, new_state), grads = _loss_and_grads(
            lambda q: tr.resnet_loss(q, s, b, cfg), p)
        with torch.no_grad():
            logits, _ = tr.resnet_forward(p, new_state, b["x"], cfg,
                                          training=False)
        return loss, new_state, grads, logits

    want = run(params, state, batch)
    to = lambda t: t.to(card)  # noqa: E731
    got = run(tree_map(to, params), tree_map(to, state),
              tree_map(to, batch))
    torch.cuda.synchronize()
    assert abs(float(got[0]) - float(want[0])) <= LOSS_TOL
    for g, w in zip(tree_leaves(got[1]), tree_leaves(want[1])):
        assert g.device.type == "cuda" and _rel(g.cpu(), w) <= REL_TOL
    for g, w in zip(got[2], want[2]):
        assert _rel(g.cpu(), w) <= REL_TOL
    assert _rel(got[3].cpu(), want[3]) <= REL_TOL
