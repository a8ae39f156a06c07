"""Sequence and pipeline parallelism on the card: Ulysses and the ring
(ops/ring_attention.py) and a one-stage pipeline of GPT-2 blocks
(ops/pipeline.py) on a world-1 NCCL mesh, through the flash kernels.

Needs an NVIDIA GPU: every test here is marked ``cuda`` and skips with
a reason where ``torch.cuda.is_available()`` is false.  This file
imports no JAX, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_seq_pipe_cuda.py

The multi-rank paths are held to the JAX package on gloo ranks on the
CPU (tests/test_torch_ring_attention.py, test_torch_pipeline.py); here
the mesh has one rank, so the checks are what a card adds: the kernels
launch on these routes and agree with the plain PyTorch versions.
"""

import importlib
import socket

import pytest
import torch

from ray_tpu_torch.models import gpt2 as tg
from ray_tpu_torch.ops import (causal_attention, pipeline_apply,
                               reference_attention, ring_attention,
                               ulysses_attention)
from ray_tpu_torch.train.optim import tree_leaves, tree_map

tfa = importlib.import_module("ray_tpu_torch.ops.flash_attention")

# f32: the flash kernels and the plain versions sum in other orders
# (the JAX package's flash and gradient tolerances)
O_TOL = 2e-5
GRAD_TOL = 1e-4
# the pipeline against gpt2_hidden in f32: other microbatch shapes,
# products and sums in other orders
PIPE_TOL = 1e-4


@pytest.fixture
def mesh():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA); the kernels have no CPU "
                    "mode")
    import torch.distributed as dist

    from ray_tpu_torch.parallel import MeshSpec, make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1)
    try:
        yield make_mesh(MeshSpec())
    finally:
        dist.destroy_process_group()


def _counts():
    return (tfa.FLASH_FWD_LAUNCHES, tfa.FLASH_BWD_DQ_LAUNCHES,
            tfa.FLASH_BWD_DKV_LAUNCHES)


def _fwd_bwd(fn, q, k, v, do):
    qs, ks, vs = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
    o = fn(qs, ks, vs)
    o.backward(do)
    return [o.detach(), qs.grad, ks.grad, vs.grad]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ulysses_and_ring_on_the_card(mesh, dtype):
    """Ulysses launches one flash forward, dQ and dK/dV a call and its
    backward, and at world 1 equals the direct flash call bit for bit;
    in f32 both it and the ring equal reference_attention."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, do = (torch.randn((2, 256, 4, 64), generator=gen,
                               device="cuda").to(dtype) for _ in range(4))
    before = _counts()
    uly = _fwd_bwd(lambda a, b, c: ulysses_attention(a, b, c, mesh=mesh),
                   q, k, v, do)
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(_counts(), before)] == [1, 1, 1]
    direct = _fwd_bwd(causal_attention, q, k, v, do)
    assert all(torch.equal(a, b) for a, b in zip(uly, direct))
    if dtype != torch.float32:
        return
    ref = _fwd_bwd(lambda a, b, c: reference_attention(a, b, c,
                                                       causal=True),
                   q, k, v, do)
    ring = _fwd_bwd(lambda a, b, c: ring_attention(a, b, c, mesh=mesh),
                    q, k, v, do)
    for got in (uly, ring):
        torch.testing.assert_close(got[0], ref[0], atol=O_TOL, rtol=O_TOL)
        for g, r in zip(got[1:], ref[1:]):
            torch.testing.assert_close(g, r, atol=GRAD_TOL, rtol=GRAD_TOL)


@pytest.mark.cuda
def test_one_stage_pipeline_of_gpt2_blocks_equals_gpt2_hidden(mesh):
    """GPT-2 tiny's blocks as one pipeline stage, 2 microbatches, remat,
    f32: the hidden states and the blocks' gradients of gpt2_hidden,
    through the flash kernels (2 ticks: 2 forwards a block and a tick
    with the recompute, 1 dQ and 1 dK/dV)."""
    cfg = tg.gpt2_config("tiny", dtype=torch.float32, use_flash=True,
                         remat=True)
    gen = torch.Generator(device="cuda").manual_seed(1)
    params = tg.gpt2_init(cfg, gen, device="cuda")
    T = 128
    tokens = torch.randint(0, cfg.vocab_size, (4, T), generator=gen,
                           device="cuda")
    r = torch.randn((4, T, cfg.d_model), generator=gen, device="cuda")

    def stage_fn(sp, act):
        for lp in tg._layers(sp["blocks"], cfg.n_layer):
            act = tg._block(act, lp, cfg)
        return act

    def run(fn):
        blocks = tree_map(lambda t: t.detach().requires_grad_(True),
                          params["blocks"])
        h = fn(blocks)
        grads = torch.autograd.grad((h * r).sum(), tree_leaves(blocks))
        return h.detach(), grads

    def piped(blocks):
        x = params["wte"][tokens] + params["wpe"][:T]
        y = pipeline_apply(stage_fn, {"blocks": tree_map(
            lambda t: t[None], blocks)}, x, microbatches=2, mesh=mesh)
        return tg._layernorm(y, params["ln_f"]["scale"],
                             params["ln_f"]["bias"])

    before = _counts()
    h_p, g_p = run(piped)
    torch.cuda.synchronize()
    L = cfg.n_layer
    assert [a - b for a, b in zip(_counts(), before)] == \
        [2 * 2 * L, 2 * L, 2 * L]
    h_r, g_r = run(lambda b: tg.gpt2_hidden(dict(params, blocks=b),
                                            tokens, cfg))
    torch.testing.assert_close(h_p, h_r, atol=PIPE_TOL, rtol=PIPE_TOL)
    for g, w in zip(g_p, g_r):
        torch.testing.assert_close(g, w, atol=PIPE_TOL, rtol=PIPE_TOL)
