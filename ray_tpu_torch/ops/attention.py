"""Multi-head causal attention: dispatcher + plain PyTorch reference.

Counterpart of ``ray_tpu/ops/attention.py``.  On CUDA the prefill hot
path is the hand-written flash forward kernel
(``ops/flash_attention.py`` over ``ops/csrc/flash_fwd.cu``); on the CPU
the plain softmax attention below runs, and it doubles as the numerics
oracle for the kernel.  Tensors are (B, T, H, D), as in the JAX
package.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ray_tpu_torch.ops.flash_attention import (SUPPORTED_HEAD_DIMS,
                                              flash_attention,
                                              resolve_resident_mode)

_NEG_INF = -1e30


def reference_attention(q, k, v, *, causal: bool = True,
                        scale: Optional[float] = None) -> torch.Tensor:
    """(B, T, H, D) q/k/v → (B, T, H, D).  Softmax in float32."""
    D = q.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    if causal:
        T, S = scores.shape[-2], scores.shape[-1]
        mask = torch.ones((T, S), dtype=torch.bool,
                          device=q.device).tril(S - T)
        scores = torch.where(mask, scores, _NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def flash_auto_dispatch(T: int, D: int, device) -> bool:
    """The use_flash=None auto rule: the kernel whenever the tensors
    are on CUDA and the shape is within the kernel's own limits (its
    head_dim set; it masks a ragged last tile itself, so any T > 0).

    The JAX rule also requires T >= 1024.  That crossover was measured
    on a TPU against XLA's fused attention and says nothing about this
    card, so the port carries no sequence threshold."""
    return (torch.device(device).type == "cuda" and T > 0
            and D in SUPPORTED_HEAD_DIMS)


def prefill_attention(q, k, v, *, start: Optional[torch.Tensor] = None,
                      use_flash: Optional[bool] = None,
                      scale: Optional[float] = None,
                      resident: str = "auto") -> torch.Tensor:
    """Prompt-phase attention for the decode path: the whole prompt in
    one call.

    start=None is the equal-length fast path, exactly
    causal_attention, so the flash kernel applies under the same
    dispatch rule.  start (B,) int marks each row's left-pad offset for
    ragged batches: key slots < start[b] are masked out on top of
    causality so pad K/V never reach a real token's output.  The
    ragged path runs the plain reference (the kernel is causal-only);
    fully-masked pad query rows softmax to uniform, finite garbage
    that the decode masks keep unread."""
    if start is None:
        return causal_attention(q, k, v, use_flash=use_flash,
                                scale=scale, resident=resident)
    D = q.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    T = q.shape[1]
    idx = torch.arange(T, device=q.device)
    causal = idx[:, None] >= idx[None, :]                 # (Tq, Tk)
    valid = idx[None, :] >= start[:, None]                # (B, Tk)
    mask = causal[None, None, :, :] & valid[:, None, None, :]
    scores = torch.where(mask, scores, _NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def causal_attention(q, k, v, *, use_flash: Optional[bool] = None,
                     scale: Optional[float] = None,
                     resident: str = "auto") -> torch.Tensor:
    """Causal MHA on (B, T, H, D) tensors.

    use_flash: True = the flash kernel (its plain version for CPU
    tensors), False = the plain reference, None = auto
    (flash_auto_dispatch).  resident: "auto" | "on" | "off", the
    per-config resident-kv knob shared with the JAX package
    (RAYTPU_FLASH_RESIDENT still overrides it; see
    flash_attention.resolve_resident_mode).  Ignored on the reference
    path."""
    T, D = q.shape[1], q.shape[-1]
    if use_flash is None:
        use_flash = flash_auto_dispatch(T, D, q.device)
    if use_flash:
        return flash_attention(q, k, v, causal=True, scale=scale,
                               resident_kv=resolve_resident_mode(resident))
    return reference_attention(q, k, v, causal=True, scale=scale)
