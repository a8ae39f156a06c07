"""llama nano on the card, through the flash and fused-CE kernels.

Needs an NVIDIA GPU: every test here is marked ``cuda`` and skips with
a reason where ``torch.cuda.is_available()`` is false.  This file
imports no JAX, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_llama_cuda.py
"""

import dataclasses
import importlib

import pytest
import torch

from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.models import llama_decode as tld
from ray_tpu_torch.train.optim import tree_leaves, tree_unflatten

tfa = importlib.import_module("ray_tpu_torch.ops.flash_attention")
tfc = importlib.import_module("ray_tpu_torch.ops.fused_ce")

# bf16 through 2 layers: the flash kernel keeps P in f32 where plain
# attention rounds it to bf16, so logits (O(1) at this init) differ by a
# few bf16 steps; the loss (~6.2) by far less than its spread over steps
LOGIT_TOL = 5e-2
LOSS_TOL = 1e-2


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA); the kernels have no CPU "
                    "mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _nano(device, **kw):
    cfg = tl.llama_config("nano", **kw)
    params = tl.llama_init(cfg, torch.Generator(device=device).manual_seed(0),
                           device)
    return cfg, params


@pytest.mark.cuda
def test_llama_prefill_and_decode_through_the_flash_kernel(cuda_device):
    cfg, params = _nano(cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (4, 64), generator=gen,
                         device=cuda_device, dtype=torch.int32)
    with torch.inference_mode():
        before = tfa.FLASH_FWD_LAUNCHES
        flash, cache = tld.llama_prefill(params, toks, cfg)
        torch.cuda.synchronize()
        assert tfa.FLASH_FWD_LAUNCHES == before + cfg.n_layer
        plain, _ = tld.llama_prefill(
            params, toks, dataclasses.replace(cfg, use_flash=False))
        assert flash.shape == (4, cfg.padded_vocab)
        assert bool(torch.isfinite(flash).all())
        assert (flash - plain).abs().max().item() <= LOGIT_TOL
        logits, cache = tld.llama_decode_step(params, cache, toks[:, -1],
                                              cfg)
        assert bool(torch.isfinite(logits).all())
        assert cache["pos"].tolist() == [65] * 4
        dense = tld.llama_generate(params, toks, cfg, max_new_tokens=8,
                                   temperature=0.0)
        paged = tld.llama_generate(params, toks, cfg, max_new_tokens=8,
                                   temperature=0.0, kv_layout="paged")
    assert torch.equal(dense, paged)


@pytest.mark.cuda
def test_llama_train_step_through_the_kernels(cuda_device):
    """One loss and gradient with ce_impl="pallas": the flash forward
    twice per layer (remat recomputes the block), dQ and dK/dV once,
    each fused-CE kernel once; the loss agrees with the dense CE's."""
    cfg, params = _nano(cuda_device, ce_impl="pallas")
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (4, 65),
                                     generator=gen, device=cuda_device)}
    names = ("FLASH_FWD_LAUNCHES", "FLASH_BWD_DQ_LAUNCHES",
             "FLASH_BWD_DKV_LAUNCHES")
    ce_names = ("FUSED_CE_FWD_LAUNCHES", "FUSED_CE_BWD_DH_LAUNCHES",
                "FUSED_CE_BWD_DW_LAUNCHES")
    before = [getattr(tfa, n) for n in names] + \
        [getattr(tfc, n) for n in ce_names]
    losses = {}
    for ce in ("pallas", "dense"):
        live = [x.detach().requires_grad_(True) for x in tree_leaves(params)]
        loss = tl.llama_loss(tree_unflatten(params, live), batch,
                             dataclasses.replace(cfg, ce_impl=ce))
        grads = torch.autograd.grad(loss, live)
        torch.cuda.synchronize()
        assert all(bool(torch.isfinite(g).all()) for g in grads)
        losses[ce] = loss.item()
        if ce == "pallas":
            after = [getattr(tfa, n) for n in names] + \
                [getattr(tfc, n) for n in ce_names]
            L = cfg.n_layer
            assert [a - b for a, b in zip(after, before)] == \
                [2 * L, L, L, 1, 1, 1]
    assert abs(losses["pallas"] - losses["dense"]) <= LOSS_TOL
