"""The cost model on the card: the kernels report the work their plain
routes report, and a harvested train step includes its backward.

* a small flash + fused-CE program (causal attention on (B, T, H, D),
  a projection, the fused lm-head CE, forward and backward) harvested
  on the card, through the CUDA kernels, books the same FLOPs as the
  same program harvested on the CPU through the plain routes, exactly;
* a GPT-2 AdamW step built by ``build_train_step`` harvested on the
  card books the written-out step formula (chip_smoke's
  ``gpt2_step_flops``, forward, backward, recompute and kernels),
  which only holds if autograd's device thread, where the backward and
  its kernel entries run on the card, is counted.

Needs an NVIDIA GPU: every test here is marked ``cuda`` and skips with
a reason where ``torch.cuda.is_available()`` is false.  This file
imports no JAX, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_observatory_cuda.py
"""

import importlib

import pytest
import torch

from ray_tpu_torch._private import device_stats as ds
from ray_tpu_torch.ops import flash_attention, fused_lm_ce

pytestmark = [
    pytest.mark.cuda,
    pytest.mark.skipif(not torch.cuda.is_available(),
                       reason="needs an NVIDIA GPU (CUDA): the kernels "
                              "have no interpret mode"),
]

fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")
fc = importlib.import_module("ray_tpu_torch.ops.fused_ce")


def _program(dev):
    g = torch.Generator().manual_seed(0)
    B, T, H, D, V, valid = 2, 256, 4, 64, 1024, 1000
    q, k, v = (torch.randn((B, T, H, D), generator=g).to(dev,
               torch.bfloat16).requires_grad_(True) for _ in range(3))
    wo = torch.randn((H * D, H * D), generator=g).to(dev, torch.bfloat16)
    wte = torch.randn((V, H * D), generator=g).to(dev).requires_grad_(True)
    tgt = torch.randint(0, valid, (B * T,), generator=g).to(dev)

    def run():
        o = flash_attention(q, k, v, causal=True).reshape(B * T, H * D)
        nll = fused_lm_ce(o @ wo, wte, tgt, valid)
        nll.mean().backward()
        return nll.detach()

    return run


def test_card_harvest_equals_the_plain_routes():
    counts = {}
    for dev in ("cuda", "cpu"):
        launches = fa.FLASH_FWD_LAUNCHES + fc.FUSED_CE_BWD_DW_LAUNCHES
        _, cost = ds.harvest_cost(_program(dev))
        counts[dev] = cost
        if dev == "cuda":
            assert fa.FLASH_FWD_LAUNCHES + fc.FUSED_CE_BWD_DW_LAUNCHES \
                == launches + 2            # it went through the kernels
    assert counts["cuda"]["xla_flops"] == counts["cpu"]["xla_flops"] > 0


def test_train_step_harvest_includes_the_backward():
    from chip_smoke import gpt2_step_flops
    from ray_tpu_torch.models.gpt2 import gpt2_config, gpt2_init, gpt2_loss
    from ray_tpu_torch.train import adamw, build_train_step

    cfg = gpt2_config("gpt2", n_layer=2, max_seq=512, ce_impl="pallas",
                      remat_policy="mlp_only")
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = gpt2_init(cfg, gen, device="cuda")
    tx = adamw(3e-4, weight_decay=0.1)
    step = build_train_step(lambda p, b: gpt2_loss(p, b, cfg), tx,
                            telemetry=False)
    opt = tx.init(params)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 513),
                                     generator=gen, device="cuda")}
    dq = fa.FLASH_BWD_DQ_LAUNCHES
    (params, opt, loss), cost = ds.harvest_cost(step, params, opt, batch)
    torch.cuda.synchronize()
    assert fa.FLASH_BWD_DQ_LAUNCHES == dq + cfg.n_layer
    assert cost["xla_flops"] == gpt2_step_flops(
        cfg.n_layer, 2, 512, cfg.d_model, cfg.d_ff, cfg.n_head,
        cfg.vocab_size)
