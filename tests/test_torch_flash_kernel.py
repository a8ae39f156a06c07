"""The CUDA flash forward kernel against its plain PyTorch version.

Needs an NVIDIA GPU: every test here is marked ``cuda`` and skips with
a reason where ``torch.cuda.is_available()`` is false.  This file
imports no JAX, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_flash_kernel.py
"""

import importlib

import pytest
import torch

tfa = importlib.import_module("ray_tpu_torch.ops.flash_attention")

# kernel vs plain version, max |difference|: f32 O as the JAX package's
# flash tests (summation order differs); bf16 O one rounding to bf16
# apart; LSE (f32) is a log of a sum of up to T terms, magnitude ~10
O_TOL = {torch.float32: 2e-5, torch.bfloat16: 5e-2}
LSE_TOL = 1e-4


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA); the kernel has no CPU "
                    "mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _qkv(device, BH, T, D, dtype, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    return [torch.randn((BH, T, D), generator=gen, device=device).to(dtype)
            for _ in range(3)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,T,D", [(True, 512, 64), (False, 512, 64),
                                        (True, 1000, 64), (True, 77, 32),
                                        (False, 200, 128)])
def test_kernel_matches_plain_version(cuda_device, dtype, causal, T, D):
    q3, k3, v3 = _qkv(cuda_device, 24, T, D, dtype)
    scale = D ** -0.5
    before = tfa.FLASH_FWD_LAUNCHES
    o, lse = tfa.flash_attention_fwd(q3, k3, v3, scale=scale,
                                     causal=causal)
    torch.cuda.synchronize()
    assert tfa.FLASH_FWD_LAUNCHES == before + 1
    assert o.dtype == dtype and lse.shape == (24, 1, T)
    o_ref, lse_ref = tfa.flash_attention_fwd_reference(
        q3, k3, v3, scale=scale, causal=causal)
    assert (o.float() - o_ref.float()).abs().max().item() <= O_TOL[dtype]
    assert (lse - lse_ref).abs().max().item() <= LSE_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("T", [1000, 77])
@pytest.mark.parametrize("D", [32, 64, 128])
def test_kernel_keeps_heads_apart(cuda_device, causal, T, D):
    """T not a multiple of the 64-row tiles: a K/V tile that runs past a
    head's last row must read zeros there (masked), not the next head's
    first rows.  Heads 1 and 3 are scaled by 100, so a leak into heads 0
    and 2 moves their outputs far outside the tolerance."""
    q3, k3, v3 = _qkv(cuda_device, 4, T, D, torch.bfloat16, seed=4)
    for x in (q3, k3, v3):
        x[1::2] *= 100
    scale = D ** -0.5
    o, lse = tfa.flash_attention_fwd(q3, k3, v3, scale=scale, causal=causal)
    torch.cuda.synchronize()
    o_ref, lse_ref = tfa.flash_attention_fwd_reference(
        q3, k3, v3, scale=scale, causal=causal)
    assert bool(torch.isfinite(o.float()).all())
    for h in (0, 2):
        assert (o[h].float() - o_ref[h].float()).abs().max().item() <= \
            O_TOL[torch.bfloat16], f"o head {h}"
        assert (lse[h] - lse_ref[h]).abs().max().item() <= LSE_TOL, \
            f"lse head {h}"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_is_deterministic(cuda_device, dtype):
    """Every CTA owns its query rows and sums them in one order: two calls
    on the same inputs give bit-equal o and lse."""
    q3, k3, v3 = _qkv(cuda_device, 24, 1024, 64, dtype, seed=3)
    runs = [tfa.flash_attention_fwd(q3, k3, v3, scale=0.125, causal=True)
            for _ in range(2)]
    torch.cuda.synchronize()
    for a, b, name in zip(*runs, ("o", "lse")):
        assert torch.equal(a, b), name


@pytest.mark.cuda
@pytest.mark.parametrize("resident", [True, False])
def test_resident_variants_launch_the_same_kernel(cuda_device, resident):
    q, k, v = (x.reshape(2, 12, 256, 64).transpose(1, 2)
               for x in _qkv(cuda_device, 24, 256, 64, torch.bfloat16))
    before = tfa.FLASH_FWD_LAUNCHES
    o = tfa.flash_attention(q, k, v, causal=True, resident_kv=resident)
    assert tfa.FLASH_FWD_LAUNCHES == before + 1
    o_ref = tfa.flash_attention(q.cpu().float(), k.cpu().float(),
                                v.cpu().float(), causal=True)
    assert (o.float().cpu() - o_ref).abs().max().item() <= \
        O_TOL[torch.bfloat16]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_single_sequence_runs_the_kernels(cuda_device, dtype):
    """B = 1 (a solo prefill): the (B, T, H, D) → (BH, T, D) reshape is
    a strided view there, which the kernels once refused.  Forward and
    backward launch, and give bit for bit what the same sequence gets
    as row 0 of a B = 2 batch (each (batch, head) pair is its own
    work: the kernels' arithmetic does not depend on B)."""
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    one = [torch.randn((1, 300, 8, 64), generator=gen,
                       device=cuda_device).to(dtype) for _ in range(3)]
    two = [torch.cat([x, torch.randn_like(x)]) for x in one]
    for x in one + two:
        x.requires_grad_()
    before = (tfa.FLASH_FWD_LAUNCHES, tfa.FLASH_BWD_DQ_LAUNCHES)
    o1 = tfa.flash_attention(*one, causal=True)
    o1.float().sum().backward()
    torch.cuda.synchronize()
    assert (tfa.FLASH_FWD_LAUNCHES, tfa.FLASH_BWD_DQ_LAUNCHES) == \
        (before[0] + 1, before[1] + 1)
    o2 = tfa.flash_attention(*two, causal=True)
    o2[:1].float().sum().backward()
    torch.cuda.synchronize()
    assert torch.equal(o1[0], o2[0])
    for x1, x2 in zip(one, two):
        assert torch.equal(x1.grad[0], x2.grad[0])


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(cuda_device):
    q3, k3, v3 = _qkv(cuda_device, 2, 64, 80, torch.float32)
    with pytest.raises(ValueError, match="head_dim"):
        tfa.flash_attention_fwd(q3, k3, v3)
    q3, k3, v3 = _qkv(cuda_device, 2, 64, 64, torch.float16)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tfa.flash_attention_fwd(q3, k3, v3)
    q3, k3, v3 = (x.transpose(0, 1) for x in
                  _qkv(cuda_device, 64, 64, 64, torch.float32))
    with pytest.raises(ValueError, match="contiguous"):
        tfa.flash_attention_fwd(q3, k3, v3)
