"""The CUDA fused lm-head + cross-entropy kernels (forward, dH, dW)
against their plain PyTorch versions.

Needs an NVIDIA GPU: every test here is marked ``cuda`` and skips with
a reason where ``torch.cuda.is_available()`` is false.  This file
imports no JAX, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_fused_ce_kernel.py
"""

import importlib

import pytest
import torch

tfc = importlib.import_module("ray_tpu_torch.ops.fused_ce")

# kernel vs plain version.  nll and lse: both sum exact products (bf16
# x bf16 is exact in f32) and exps in f32, in different orders, over D
# and V terms: |kernel - plain| <= 1e-4 + 1e-4 * |plain|, the JAX
# package's f32 tolerance.  dH and dW, elementwise |kernel - plain| <=
# ATOL_FRAC * rms(plain) + RTOL * |plain| and per tensor
# ||kernel - plain|| / ||plain|| <= REL_NORM:
# f32: sums in another order only (the JAX package's gradient
#   tolerance, with atol taken relative to the tensor's scale since
#   these inputs set no common one);
# bf16: both round dlogits to bf16 before the products; where the two
#   f32 dlogits differ in their last bits one rounds a bf16 step (2**-8
#   relative) from the other, which moves a sum of V (dH) or N (dW)
#   terms by far less than one of its terms; few elements do, so the
#   relative norm stays far under one bf16 step, while a dropped tile
#   of the sum moves it by more than 1e-2 (a tenth of the rms of a
#   typical element is the elementwise floor).
OUT_TOL = (1e-4, 1e-4)
GRAD_TOL = {torch.float32: (1e-4, 1e-4, 1e-5),
            torch.bfloat16: (1e-2, 2e-2, 2e-3)}

SHAPES = [
    (33, 130, 123, 64),          # ragged row and vocab tiles, masked tail
    (70, 300, 257, 192),         # D/4 = 48: a strip of 6 n8 tiles
    (1000, 50304, 50257, 768),   # GPT-2 small's head at N = 1000
    (200, 1000, 990, 1024),      # GPT-2 medium's width, the largest D
]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA); the kernels have no CPU "
                    "mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(device, n, v, valid, d, dtype, seed=0):
    """h ~ N(0, 1) and w ~ N(0, 1/D): logits ~ N(0, 1), as a trained
    head gives; targets uniform over the valid vocab; g uniform."""
    gen = torch.Generator(device=device).manual_seed(seed)
    h = torch.randn((n, d), generator=gen, device=device).to(dtype)
    w = (torch.randn((v, d), generator=gen, device=device)
         * d ** -0.5).to(dtype)
    tgt = torch.randint(0, valid, (n,), generator=gen, device=device,
                        dtype=torch.int32)
    g = torch.rand((n,), generator=gen, device=device)
    return h, w, tgt, g


def _assert_out_close(got, want, name):
    atol, rtol = OUT_TOL
    err = (got - want).abs()
    assert bool(torch.isfinite(got).all()), name
    assert (err - atol - rtol * want.abs()).max().item() <= 0, (
        f"{name}: max|kernel - plain| {err.max().item():.3e}")


def _assert_grad_close(got, want, dtype, name):
    frac, rtol, rel_norm = GRAD_TOL[dtype]
    assert bool(torch.isfinite(got).all()), name
    atol = frac * want.square().mean().sqrt().item()
    err = (got - want).abs()
    worst = (err - atol - rtol * want.abs()).max().item()
    assert worst <= 0, (f"{name}: max|kernel - plain| {err.max().item():.3e}"
                        f" exceeds {atol:.3e} + {rtol} * |plain|")
    rel = (err.norm() / want.norm()).item()
    assert rel <= rel_norm, (f"{name}: ||kernel - plain|| / ||plain|| "
                             f"{rel:.3e} exceeds {rel_norm}")


def _counts():
    return (tfc.FUSED_CE_FWD_LAUNCHES, tfc.FUSED_CE_BWD_DH_LAUNCHES,
            tfc.FUSED_CE_BWD_DW_LAUNCHES)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,v,valid,d", SHAPES)
def test_kernels_match_plain_version(cuda_device, dtype, n, v, valid, d):
    h, w, tgt, g = _inputs(cuda_device, n, v, valid, d, dtype)
    before = _counts()
    nll, lse = tfc.fused_ce_fwd(h, w, tgt, valid)
    dh = tfc.fused_ce_bwd_dh(h, w, tgt, lse, g, valid)
    dw = tfc.fused_ce_bwd_dw(h, w, tgt, lse, g, valid)
    torch.cuda.synchronize()
    assert _counts() == tuple(c + 1 for c in before)
    want_nll, want_lse = tfc.fused_ce_fwd_reference(h, w, tgt, valid)
    _assert_out_close(nll, want_nll, "nll")
    _assert_out_close(lse, want_lse, "lse")
    # the backward's plain versions on the kernel's lse, so that each
    # kernel is held alone
    _assert_grad_close(dh, tfc.fused_ce_bwd_dh_reference(
        h, w, tgt, lse, g, valid), dtype, "dh")
    want_dw = tfc.fused_ce_bwd_dw_reference(h, w, tgt, lse, g, valid)
    _assert_grad_close(dw, want_dw, dtype, "dw")
    assert dh.dtype == dw.dtype == torch.float32
    # rows past valid_vocab: exactly zero, as in the plain version
    assert bool((dw[valid:] == 0).all())


@pytest.mark.cuda
def test_autograd_runs_each_kernel_once(cuda_device):
    """bf16 hidden and the f32 master table, as the training step gives
    them: one launch of each kernel, dhidden in bf16, dwte in f32."""
    h, w, tgt, _ = _inputs(cuda_device, 256, 1000, 990, 768, torch.float32)
    hidden = h.to(torch.bfloat16).requires_grad_(True)
    wte = w.requires_grad_(True)
    before = _counts()
    nll = tfc.fused_lm_ce(hidden, wte, tgt.long(), 990)
    nll.mean().backward()
    torch.cuda.synchronize()
    assert _counts() == tuple(c + 1 for c in before)
    assert nll.dtype == torch.float32 and nll.shape == (256,)
    assert hidden.grad.dtype == torch.bfloat16
    assert wte.grad.dtype == torch.float32
    hb, wb = hidden.detach(), wte.detach().to(torch.bfloat16)
    t32 = tgt.to(torch.int32)
    want_nll, lse = tfc.fused_ce_fwd_reference(hb, wb, t32, 990)
    _assert_out_close(nll.detach(), want_nll, "nll")
    g = torch.full((256,), 1.0 / 256, device=cuda_device)
    _assert_grad_close(wte.grad, tfc.fused_ce_bwd_dw_reference(
        hb, wb, t32, lse, g, 990), torch.bfloat16, "dwte")


@pytest.mark.cuda
def test_kernels_reject_what_they_do_not_take(cuda_device):
    h, w, tgt, g = _inputs(cuda_device, 32, 128, 100, 64, torch.float32)
    _, lse = tfc.fused_ce_fwd(h, w, tgt, 100)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tfc.fused_ce_fwd(h.half(), w.half(), tgt, 100)
    with pytest.raises(ValueError, match="contiguous"):
        tfc.fused_ce_fwd(h.t().contiguous().t(), w, tgt, 100)
    with pytest.raises(ValueError, match="int32"):
        tfc.fused_ce_bwd_dh(h, w, tgt.long(), lse, g, 100)
    h96, w96, t96, g96 = _inputs(cuda_device, 32, 128, 100, 96,
                                 torch.float32)
    with pytest.raises(ValueError, match="multiple of 64"):
        tfc.fused_ce_bwd_dw(h96, w96, t96, g96, g96, 100)
    h2k, w2k, t2k, _ = _inputs(cuda_device, 8, 128, 100, 1088,
                               torch.bfloat16)
    with pytest.raises(ValueError, match="multiple of 64"):
        tfc.fused_ce_fwd(h2k, w2k, t2k, 100)
    with pytest.raises(ValueError, match="share the compute dtype"):
        tfc.fused_ce_fwd(h, w.to(torch.bfloat16), tgt, 100)
