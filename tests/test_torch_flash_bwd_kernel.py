"""The CUDA flash backward kernels (dQ, dK/dV) against their plain
PyTorch versions.

Needs an NVIDIA GPU: every test here is marked ``cuda`` and skips with
a reason where ``torch.cuda.is_available()`` is false.  This file
imports no JAX, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_flash_bwd_kernel.py
"""

import importlib

import pytest
import torch

tfa = importlib.import_module("ray_tpu_torch.ops.flash_attention")

# kernel vs plain version, elementwise |kernel - plain| <= ATOL + RTOL *
# |plain|, and per tensor ||kernel - plain|| / ||plain|| <= REL_NORM:
# f32: the JAX package's gradient tolerance (tests/test_flash_attention.py);
#   both sum in f32, in different orders, over up to T terms
# bf16: both round P and dS to bf16 before the products and the f32 sums
#   to bf16 at the end; an element whose f32 value differs in the last
#   bits between the two can round one bf16 step (2**-7 relative, under
#   RTOL) apart.  ATOL covers elements near 0, where a P/dS term rounded
#   the other way inside the sum is ~2**-9 of a term of size <~ 1; it is
#   a tenth of a typical dK/dV element at T=1024 (~0.05), so a dropped
#   part of the sum shows.  Few elements round apart, so the relative
#   norm of the difference stays far below one bf16 step (<= 1.4e-4 on
#   an H100 at every shape here; f32 <= 2.5e-7).
TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (5e-3, 2e-2)}
REL_NORM = {torch.float32: 1e-5, torch.bfloat16: 2e-3}
# delta = rowsum(dO * O) from the dQ kernel vs flash_bwd_delta: both sum
# the same D products in f32 in different orders (a bf16 product is
# exact in f32; an f32 one rounds once), so each lies within
# (D + 1) * 2**-24 * sum|dO * O| of the exact sum, and the two within
# twice that
DELTA_ULP = 2.0 ** -24


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA); the kernels have no CPU "
                    "mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(device, BH, T, D, dtype, causal, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    q3, k3, v3, do3 = (torch.randn((BH, T, D), generator=gen,
                                   device=device).to(dtype)
                       for _ in range(4))
    o3, lse = tfa.flash_attention_fwd_reference(q3, k3, v3, scale=D ** -0.5,
                                                causal=causal)
    return q3, k3, v3, o3, lse, do3


def _assert_delta_close(delta, o3, do3):
    want = tfa.flash_bwd_delta(o3, do3)
    D = o3.shape[-1]
    bound = 2 * (D + 1) * DELTA_ULP * (do3.float() * o3.float()).abs().sum(
        dim=-1)[:, None, :]
    err = (delta - want).abs()
    assert delta.shape == want.shape and delta.dtype == torch.float32
    assert bool((err <= bound).all()), (
        f"delta: max|kernel - plain| {err.max().item():.3e}, "
        f"{(err - bound).max().item():.3e} over 2 (D + 1) 2**-24 "
        f"sum|dO O|")


def _assert_close(got, want, dtype, name):
    atol, rtol = TOL[dtype]
    err = (got.float() - want.float()).abs()
    bound = atol + rtol * want.float().abs()
    worst = (err - bound).max().item()
    assert worst <= 0, (f"{name}: max|kernel - plain| "
                        f"{err.max().item():.3e} exceeds {atol} + {rtol} "
                        f"* |plain|")
    rel = (err.norm() / want.float().norm()).item()
    assert rel <= REL_NORM[dtype], (f"{name}: ||kernel - plain|| / ||plain|| "
                                    f"{rel:.3e} exceeds {REL_NORM[dtype]}")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("T", [1024, 1000, 77])
@pytest.mark.parametrize("D", [32, 64, 128])
def test_bwd_kernels_match_plain_version(cuda_device, dtype, causal, T, D):
    q3, k3, v3, o3, lse, do3 = _inputs(cuda_device, 8, T, D, dtype, causal)
    scale = D ** -0.5
    before = (tfa.FLASH_BWD_DQ_LAUNCHES, tfa.FLASH_BWD_DKV_LAUNCHES)
    dq, dk, dv = tfa.flash_attention_bwd(q3, k3, v3, o3, lse, do3,
                                         scale=scale, causal=causal)
    torch.cuda.synchronize()
    assert (tfa.FLASH_BWD_DQ_LAUNCHES, tfa.FLASH_BWD_DKV_LAUNCHES) == \
        (before[0] + 1, before[1] + 1)
    assert dq.dtype == dk.dtype == dv.dtype == dtype
    want = tfa.flash_attention_bwd_reference(q3, k3, v3, o3, lse, do3,
                                             scale=scale, causal=causal)
    for got, ref, name in zip((dq, dk, dv), want, ("dq", "dk", "dv")):
        assert bool(torch.isfinite(got).all()), name
        _assert_close(got, ref, dtype, name)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("T", [1024, 1000, 77])
@pytest.mark.parametrize("D", [32, 64, 128])
def test_dq_kernel_delta_matches_plain_version(cuda_device, dtype, causal, T,
                                               D):
    q3, k3, v3, o3, lse, do3 = _inputs(cuda_device, 8, T, D, dtype, causal)
    dq, delta = tfa.flash_bwd_dq(q3, k3, v3, o3, do3, lse, scale=D ** -0.5,
                                 causal=causal)
    torch.cuda.synchronize()
    _assert_delta_close(delta, o3, do3)
    # dq from the kernel's own delta is the dq of the whole backward
    want, _ = tfa.flash_bwd_dq_reference(q3, k3, v3, o3, do3, lse,
                                         scale=D ** -0.5, causal=causal)
    _assert_close(dq, want, dtype, "dq")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bwd_kernels_are_deterministic(cuda_device, dtype):
    """Every CTA owns its output rows and sums them in one order: two
    calls on the same inputs give bit-equal dq, dk, dv and delta."""
    q3, k3, v3, o3, lse, do3 = _inputs(cuda_device, 24, 1024, 64, dtype,
                                       True, seed=3)
    runs = []
    for _ in range(2):
        dq, delta = tfa.flash_bwd_dq(q3, k3, v3, o3, do3, lse,
                                     scale=0.125, causal=True)
        dk, dv = tfa.flash_bwd_dkv(q3, k3, v3, do3, lse, delta,
                                   scale=0.125, causal=True)
        runs.append((dq, dk, dv, delta))
    torch.cuda.synchronize()
    for a, b, name in zip(*runs, ("dq", "dk", "dv", "delta")):
        assert torch.equal(a, b), name


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("T", [1000, 77])
@pytest.mark.parametrize("D", [32, 64, 128])
def test_bwd_kernels_keep_heads_apart(cuda_device, causal, T, D):
    """T not a multiple of the 64-row tiles: a tile that runs past a
    head's last row must read zeros there, not the next head's first
    rows.  Heads 1 and 3 are scaled by 100, so a leak into heads 0 and
    2 moves their gradients far outside the tolerance (or makes them
    non-finite)."""
    q3, k3, v3, _, _, do3 = _inputs(cuda_device, 4, T, D, torch.bfloat16,
                                    causal, seed=4)
    for x in (q3, k3, v3, do3):
        x[1::2] *= 100
    scale = D ** -0.5
    o3, lse = tfa.flash_attention_fwd_reference(q3, k3, v3, scale=scale,
                                                causal=causal)
    dq, delta = tfa.flash_bwd_dq(q3, k3, v3, o3, do3, lse, scale=scale,
                                 causal=causal)
    dk, dv = tfa.flash_bwd_dkv(q3, k3, v3, do3, lse, delta, scale=scale,
                               causal=causal)
    torch.cuda.synchronize()
    want = tfa.flash_attention_bwd_reference(q3, k3, v3, o3, lse, do3,
                                             scale=scale, causal=causal)
    _assert_delta_close(delta, o3, do3)
    for got, ref, name in zip((dq, dk, dv), want, ("dq", "dk", "dv")):
        assert bool(torch.isfinite(got).all()), name
        for h in (0, 2):
            _assert_close(got[h], ref[h], torch.bfloat16, f"{name} head {h}")


@pytest.mark.cuda
@pytest.mark.parametrize("resident", [True, False])
def test_autograd_runs_both_kernels_once(cuda_device, resident):
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    q, k, v, do = (torch.randn((2, 256, 12, 64), generator=gen,
                               device=cuda_device).to(torch.bfloat16)
                   for _ in range(4))
    for t in (q, k, v):
        t.requires_grad_(True)
    counts = (tfa.FLASH_FWD_LAUNCHES, tfa.FLASH_BWD_DQ_LAUNCHES,
              tfa.FLASH_BWD_DKV_LAUNCHES)
    o = tfa.flash_attention(q, k, v, causal=True, resident_kv=resident)
    dq, dk, dv = torch.autograd.grad(o, (q, k, v), do)
    assert (tfa.FLASH_FWD_LAUNCHES, tfa.FLASH_BWD_DQ_LAUNCHES,
            tfa.FLASH_BWD_DKV_LAUNCHES) == tuple(c + 1 for c in counts)

    # the same (BH, T, D) problem without autograd: the kernels are
    # deterministic, so the Function's transposes and copies must give
    # exactly the direct call's gradients, and the plain version of the
    # backward on the kernel forward's o and lse agrees within TOL
    def to3(x):
        return x.detach().transpose(1, 2).reshape(2 * 12, 256, 64)

    def to4(x):
        return x.reshape(2, 12, 256, 64).transpose(1, 2)

    q3, k3, v3, do3 = (to3(x).contiguous() for x in (q, k, v, do))
    o3, lse = tfa.flash_attention_fwd(q3, k3, v3, causal=True)
    direct = tfa.flash_attention_bwd(q3, k3, v3, o3, lse, do3, causal=True)
    plain = tfa.flash_attention_bwd_reference(q3, k3, v3, o3, lse, do3,
                                              scale=64 ** -0.5, causal=True)
    for got, d3, p3, name in zip((dq, dk, dv), direct, plain,
                                 ("dq", "dk", "dv")):
        assert torch.equal(got, to4(d3)), name
        _assert_close(got, to4(p3), torch.bfloat16, name)


@pytest.mark.cuda
def test_bwd_kernels_reject_what_they_do_not_take(cuda_device):
    q3, k3, v3, o3, lse, do3 = _inputs(cuda_device, 2, 64, 80,
                                       torch.float32, True)
    with pytest.raises(ValueError, match="head_dim"):
        tfa.flash_attention_bwd(q3, k3, v3, o3, lse, do3)
    q3, k3, v3, o3, lse, do3 = _inputs(cuda_device, 2, 64, 64,
                                       torch.float16, True)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tfa.flash_attention_bwd(q3, k3, v3, o3, lse, do3)
    q3, k3, v3, o3, lse, do3 = _inputs(cuda_device, 4, 64, 64,
                                       torch.float32, True)
    with pytest.raises(ValueError, match="contiguous"):
        tfa.flash_attention_bwd(q3, k3, v3, o3, lse, do3.transpose(1, 2))
    with pytest.raises(ValueError, match="dO must match"):
        tfa.flash_attention_bwd(q3, k3, v3, o3, lse, do3[:, :32])
