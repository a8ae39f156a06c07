"""GPT-2 with experts on the card, through the flash and fused-CE
kernels, and the mesh step on a world-1 NCCL group.

Needs an NVIDIA GPU: every test here is marked ``cuda`` and skips with
a reason where ``torch.cuda.is_available()`` is false.  This file
imports no JAX, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_moe_cuda.py
"""

import dataclasses
import importlib
import socket

import pytest
import torch

from ray_tpu_torch.models import gpt2 as tg
from ray_tpu_torch.train import adamw, build_train_step
from ray_tpu_torch.train.optim import tree_leaves, tree_map, tree_unflatten

tfa = importlib.import_module("ray_tpu_torch.ops.flash_attention")
tfc = importlib.import_module("ray_tpu_torch.ops.fused_ce")

# f32 through 2 layers: the kernels and the plain versions sum in other
# orders (the JAX package's gradient tolerance); a near-tie routed the
# other way moves one token's share of the loss, far less than this
LOSS_TOL = 1e-4
GRAD_RTOL = 1e-3
MOE = dict(n_experts=4, moe_top_k=2, remat_policy="full")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA); the kernels have no CPU "
                    "mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _counts():
    return (tfa.FLASH_FWD_LAUNCHES, tfa.FLASH_BWD_DQ_LAUNCHES,
            tfa.FLASH_BWD_DKV_LAUNCHES, tfc.FUSED_CE_FWD_LAUNCHES,
            tfc.FUSED_CE_BWD_DH_LAUNCHES, tfc.FUSED_CE_BWD_DW_LAUNCHES)


def _value_and_grad(params, batch, cfg):
    live = [t.detach().requires_grad_(True) for t in tree_leaves(params)]
    loss = tg.gpt2_loss(tree_unflatten(params, live), batch, cfg)
    return float(loss), torch.autograd.grad(loss, live)


@pytest.mark.cuda
def test_moe_step_through_the_kernels_matches_the_plain_versions(
        cuda_device):
    cfg = tg.gpt2_config("tiny", dtype=torch.float32, ce_impl="pallas",
                         use_flash=True, **MOE)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    params = tg.gpt2_init(cfg, gen, cuda_device)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 129),
                                     generator=gen, device=cuda_device)}
    before = _counts()
    loss, grads = _value_and_grad(params, batch, cfg)
    torch.cuda.synchronize()
    launched = [a - b for a, b in zip(_counts(), before)]
    L = cfg.n_layer
    # whole-block remat runs each block's flash forward again
    assert launched == [2 * L, L, L, 1, 1, 1]
    plain = dataclasses.replace(cfg, use_flash=False, ce_impl="dense")
    want_loss, want = _value_and_grad(params, batch, plain)
    assert abs(loss - want_loss) <= LOSS_TOL
    for i, (g, w) in enumerate(zip(grads, want)):
        rel = float((g - w).norm() / w.norm().clamp_min(1e-30))
        assert rel <= GRAD_RTOL, f"leaf {i}: {rel}"


@pytest.mark.cuda
def test_mesh_step_on_a_world_one_nccl_group_equals_the_step(cuda_device):
    import torch.distributed as dist

    from ray_tpu_torch.parallel import MeshSpec, make_mesh, shard_params

    cfg = tg.gpt2_config("tiny", ce_impl="pallas", **MOE)
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    params = tg.gpt2_init(cfg, gen, cuda_device)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (4, 129),
                                     generator=gen, device=cuda_device)}
    tx = adamw(3e-4)
    ref = tree_map(torch.clone, params)
    ref, _, ref_loss = build_train_step(
        lambda p, b: tg.gpt2_loss(p, b, cfg), tx, telemetry=False)(
        ref, tx.init(ref), batch)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1)
    try:
        mesh = make_mesh(MeshSpec())
        assert mesh.device_type == "cuda" and dist.get_backend() == "nccl"
        axes = tg.gpt2_logical_axes(cfg)
        sp = shard_params(tree_map(torch.clone, params), axes, mesh)
        sp, _, loss = build_train_step(
            lambda p, b: tg.gpt2_loss(p, b, cfg), tx, mesh=mesh,
            logical_axes=axes, telemetry=False)(sp, tx.init(sp), batch)
        assert float(loss) == float(ref_loss)
        for a, b in zip(tree_leaves(sp), tree_leaves(ref)):
            assert torch.equal(a.to_local(), b)
    finally:
        dist.destroy_process_group()
