"""Flash attention forward for Hopper: wrapper, plain version, knobs.

Counterpart of ``ray_tpu/ops/flash_attention.py``, forward only.  The
kernel (``ops/csrc/flash_fwd.cu``: tensor cores for bfloat16, f32 FMA
for float32) computes the online-softmax
recurrence of the JAX package's ``_fwd_kernel`` and ``_fwd_res_kernel``:
one CTA per (batch*head, 64-row query tile) walks the key/value tiles
in a loop that stops at the causal diagonal, keeping m, l and the
output accumulator in f32, so the T x T score matrix never reaches
device memory.

Dispatch is by tensor placement: a CPU tensor takes the plain PyTorch
version (``flash_attention_fwd_reference``), a CUDA tensor launches the
kernel or raises.  There is no fallback between the two.

The backward kernels come with the training slice (ROADMAP.md, queue 1
item 1) as a ``torch.autograd.Function``; until then a call on tensors
that require grad raises.
"""

from __future__ import annotations

import math
import os
from typing import Optional, Tuple

import torch

#: head dims the kernel is instantiated for
SUPPORTED_HEAD_DIMS = (32, 64, 128)

#: launches of the CUDA kernel in this process; only the launch site
#: below adds to it, so a caller can zero it, drive a path, and read
#: whether that path went through the kernel
FLASH_FWD_LAUNCHES = 0

_NEG_INF = -1e30

# Resident-variant tiles of the JAX package, kept so one config names
# the same variant in both packages.  They were sized for a TPU's VMEM
# and do not set the Hopper kernel's tiling (64-row tiles; see the .cu
# source).
RESIDENT_BLOCK_Q = 256
RESIDENT_CHUNK = 512


def resolve_resident_mode(mode: str = "auto"):
    """Per-config resident-kv knob → the flash_attention ``resident_kv``
    tri-state (True/False/None=auto).  The RAYTPU_FLASH_RESIDENT env
    var is a process-wide override ("1" forces on, "0" forces off), as
    in the JAX package."""
    env = os.environ.get("RAYTPU_FLASH_RESIDENT")
    if env == "1":
        return True
    if env == "0":
        return False
    if mode == "on":
        return True
    if mode == "off":
        return False
    return None


def _resident_plan(T: int, causal: bool):
    """The JAX package's auto policy for the resident-kv variant:
    (bq, bk, chunk) for causal T > 2048 that tiles evenly, else None.
    Kept so a config names the same variant in both packages; on
    Hopper both variants launch the same kernel."""
    if not causal:
        return None
    if T % RESIDENT_CHUNK or T % RESIDENT_BLOCK_Q:
        return None
    if T <= 2048:
        return None
    return RESIDENT_BLOCK_Q, RESIDENT_BLOCK_Q, RESIDENT_CHUNK


def auto_blocks(T: int):
    """The JAX package's block policy for the classic kernels:
    (block_q, block_k, block_q_bwd, block_k_bwd).  Kept for config
    parity; it does not set the Hopper tiling."""
    if T <= 2048:
        return min(1024, T), T, 256, T
    return 1024, 1024, 256, 1024


def _check_block(name: str, value: Optional[int]) -> None:
    if value is not None and (not isinstance(value, int) or value < 1):
        raise ValueError(f"{name} must be a positive int or None, "
                         f"got {value!r}")


def flash_attention_fwd_reference(q3, k3, v3, *, scale: float,
                                  causal: bool
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel on f32 scores.

    q3/k3/v3 (BH, T, D) → (o (BH, T, D) in the input dtype,
    lse (BH, 1, T) float32), with the kernel's masking (-1e30) and its
    floor on the softmax denominator (1e-30)."""
    BH, T, _ = q3.shape
    s = torch.matmul(q3.float(), k3.float().transpose(1, 2)) * scale
    if causal:
        keep = torch.ones((T, T), dtype=torch.bool,
                          device=q3.device).tril()
        s = torch.where(keep, s, _NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = (torch.matmul(p, v3.float()) / l).to(q3.dtype)
    lse = (m + torch.log(l)).reshape(BH, 1, T)
    return o, lse


def _launch(q3, k3, v3, *, scale: float, causal: bool):
    global FLASH_FWD_LAUNCHES
    from ray_tpu_torch.ops import _kernels

    BH, T, D = q3.shape
    if D not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"flash kernel supports head_dim in "
                         f"{SUPPORTED_HEAD_DIMS}, got {D}")
    if q3.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"flash kernel takes float32 or bfloat16, got "
                         f"{q3.dtype}")
    if BH > 65535:
        raise ValueError(f"flash kernel takes at most 65535 batch*heads "
                         f"(one grid row each), got {BH}")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0
               for t in (q3, k3, v3)):
        raise ValueError("flash kernel takes contiguous, 16-byte aligned "
                         "(BH, T, D) tensors")
    o = torch.empty_like(q3)
    lse = torch.empty((BH, 1, T), dtype=torch.float32, device=q3.device)
    lib = _kernels.library("flash_fwd")
    with torch.cuda.device(q3.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.flash_fwd(q3.data_ptr(), k3.data_ptr(), v3.data_ptr(),
                            o.data_ptr(), lse.data_ptr(), BH, T, D,
                            float(scale), int(causal),
                            int(q3.dtype == torch.bfloat16), stream)
    _kernels.check(lib, err, "flash_fwd")
    FLASH_FWD_LAUNCHES += 1
    return o, lse


def flash_attention_fwd(q3, k3, v3, *, scale: Optional[float] = None,
                        causal: bool = True
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward on (BH, T, D) tensors → (o (BH, T, D), lse (BH, 1, T)
    float32), the outputs of the JAX package's ``_fwd``.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (float32 or bfloat16, contiguous, head_dim in SUPPORTED_HEAD_DIMS)
    or raise."""
    if not (q3.shape == k3.shape == v3.shape) or q3.dim() != 3:
        raise ValueError(f"q/k/v must share one (BH, T, D) shape, got "
                         f"{tuple(q3.shape)}, {tuple(k3.shape)}, "
                         f"{tuple(v3.shape)}")
    if not (q3.dtype == k3.dtype == v3.dtype):
        raise ValueError("q/k/v must share one dtype")
    if not (q3.device == k3.device == v3.device):
        raise ValueError("q/k/v must share one device")
    scale = scale if scale is not None else 1.0 / math.sqrt(q3.shape[-1])
    if q3.device.type == "cpu":
        return flash_attention_fwd_reference(q3, k3, v3, scale=scale,
                                             causal=causal)
    if q3.device.type != "cuda":
        raise ValueError(f"flash_attention_fwd runs on cpu or cuda, got "
                         f"{q3.device}")
    return _launch(q3, k3, v3, scale=scale, causal=causal)


def flash_attention(q, k, v, *, causal: bool = True,
                    scale: Optional[float] = None,
                    block_q: Optional[int] = None,
                    block_k: Optional[int] = None,
                    block_q_bwd: Optional[int] = None,
                    block_k_bwd: Optional[int] = None,
                    resident_kv: Optional[bool] = None) -> torch.Tensor:
    """Flash attention forward on (B, T, H, D) tensors.

    The block knobs and ``resident_kv`` are accepted and validated as
    in the JAX package, so one config drives both packages.  They do
    not change the Hopper tiling: resident_kv True and False launch
    the same kernel, whose kv loop already runs inside the CTA and
    stops at the causal diagonal (the shape of the JAX resident
    variant), over 64-row tiles whatever the blocks ask.

    Forward only: tensors that require grad raise NotImplementedError
    until the training slice (ROADMAP.md, queue 1 item 1) brings the
    backward kernels."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "flash_attention is forward-only in ray_tpu_torch: the "
            "backward kernels come with the training slice (ROADMAP.md, "
            "queue 1 item 1)")
    for name, value in (("block_q", block_q), ("block_k", block_k),
                        ("block_q_bwd", block_q_bwd),
                        ("block_k_bwd", block_k_bwd)):
        _check_block(name, value)
    if resident_kv not in (None, True, False):
        raise ValueError(f"resident_kv must be True, False or None, got "
                         f"{resident_kv!r}")
    if q.dim() != 4:
        raise ValueError(f"flash_attention takes (B, T, H, D) tensors, "
                         f"got shape {tuple(q.shape)}")
    B, T, H, D = q.shape

    def to3(x):
        return x.transpose(1, 2).reshape(B * H, T, D)

    o3, _ = flash_attention_fwd(to3(q), to3(k), to3(v), scale=scale,
                                causal=causal)
    return o3.reshape(B, H, T, D).transpose(1, 2)
