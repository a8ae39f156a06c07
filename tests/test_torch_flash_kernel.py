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
