"""Flash attention for Hopper: wrappers, plain versions, autograd, knobs.

Counterpart of ``ray_tpu/ops/flash_attention.py``.  Three CUDA kernels
(tensor cores for bfloat16, f32 FMA for float32):

* forward (``ops/csrc/flash_fwd.cu``): the online-softmax recurrence of
  the JAX package's ``_fwd_kernel`` and ``_fwd_res_kernel``; one CTA
  per (batch*head, 64-row query tile) walks the key/value tiles in a
  loop that stops at the causal diagonal, so the T x T score matrix
  never reaches device memory;
* dQ and dK/dV (``ops/csrc/flash_bwd.cu``): ``_bwd_dq_kernel`` /
  ``_bwd_dq_res_kernel`` and ``_bwd_dkv_kernel`` /
  ``_bwd_dkv_res_kernel``; each recomputes P = exp(S - LSE) tile by
  tile from the forward's LSE and owns its output rows, so there are
  no atomics.

For bfloat16 all three are warp-specialised: a producer warpgroup
feeds tiles by TMA through a ring of mbarriers to a consumer warpgroup
that runs ``wgmma``.

Dispatch is by tensor placement: a CPU tensor takes the plain PyTorch
version (``*_reference``), a CUDA tensor launches the kernel or
raises.  There is no fallback between the two.  ``flash_attention`` is
differentiable through a ``torch.autograd.Function`` whose backward is
the two backward kernels and nothing else: delta = rowsum(dO * O),
which the JAX package computes outside Pallas, is computed by the dQ
kernel, which writes it for the dK/dV kernel launched after it.
"""

from __future__ import annotations

import math
import os
from typing import Optional, Tuple

import torch

#: head dims the kernel is instantiated for
SUPPORTED_HEAD_DIMS = (32, 64, 128)

#: launches of each CUDA kernel in this process; only the kernel's
#: launch site below adds to its count, so a caller can zero them,
#: drive a path, and read whether that path went through the kernels
FLASH_FWD_LAUNCHES = 0
FLASH_BWD_DQ_LAUNCHES = 0
FLASH_BWD_DKV_LAUNCHES = 0

_NEG_INF = -1e30

#: tiles of the backward kernels (csrc/flash_bwd.cu), from which a
#: caller computes grids: a bf16 CTA owns BWD_BF16_CTA_ROWS rows (dQ:
#: queries; dK/dV: keys), BWD_CONSUMERS consumer warpgroups of
#: BWD_TILE_ROWS rows each, streams BWD_TILE_ROWS-row tiles (dQ: K and
#: V; dK/dV: Q and dO) through a ring of BWD_STAGES stages, and shares
#: an SM with BWD_BF16_CTAS_PER_SM - 1 others.  CTAs: BH * ceil(T /
#: BWD_BF16_CTA_ROWS).
BWD_TILE_ROWS = 64
BWD_CONSUMERS = 1
BWD_BF16_CTA_ROWS = BWD_CONSUMERS * BWD_TILE_ROWS
BWD_BF16_CTAS_PER_SM = 2
BWD_STAGES = 2
#: the same for the bf16 forward: a CTA owns FWD_BF16_CTA_ROWS queries
#: (FWD_CONSUMERS consumers of FWD_TILE_ROWS), streams K and V tiles of
#: FWD_TILE_ROWS rows and shares an SM with FWD_BF16_CTAS_PER_SM - 1
#: others; CTAs: BH * ceil(T / FWD_BF16_CTA_ROWS)
FWD_TILE_ROWS = 64
FWD_CONSUMERS = 1
FWD_BF16_CTA_ROWS = FWD_CONSUMERS * FWD_TILE_ROWS
FWD_BF16_CTAS_PER_SM = 2

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


def _check_kernel_args(what: str, tensors, BH: int, D: int) -> None:
    """What every flash kernel takes: head_dim in SUPPORTED_HEAD_DIMS,
    float32 or bfloat16, at most 65535 batch*heads (one grid row each),
    contiguous 16-byte aligned tensors."""
    if D not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"{what} kernel supports head_dim in "
                         f"{SUPPORTED_HEAD_DIMS}, got {D}")
    if tensors[0].dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{what} kernel takes float32 or bfloat16, got "
                         f"{tensors[0].dtype}")
    if BH > 65535:
        raise ValueError(f"{what} kernel takes at most 65535 batch*heads "
                         f"(one grid row each), got {BH}")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0
               for t in tensors):
        raise ValueError(f"{what} kernel takes contiguous, 16-byte "
                         f"aligned tensors")


def _launch(lib_name: str, fn_name: str, counter: str, inputs, outputs, *,
            scale: float, causal: bool) -> None:
    """Launch ``fn_name`` of ``csrc/<lib_name>.cu`` on ``inputs`` (the
    first one (BH, T, D)), writing ``outputs``, and add one to the
    module's launch counter named ``counter``.  Every flash launcher
    takes (inputs..., outputs..., BH, T, D, scale, causal, is_bf16,
    stream)."""
    from ray_tpu_torch.ops import _kernels

    q3 = inputs[0]
    BH, T, D = q3.shape
    _check_kernel_args(fn_name, inputs, BH, D)
    _kernels.launch(lib_name, fn_name, (*inputs, *outputs),
                    (BH, T, D, float(scale), int(causal),
                     int(q3.dtype == torch.bfloat16)), q3.device)
    globals()[counter] += 1


def _check_qkv(q3, k3, v3) -> None:
    if not (q3.shape == k3.shape == v3.shape) or q3.dim() != 3:
        raise ValueError(f"q/k/v must share one (BH, T, D) shape, got "
                         f"{tuple(q3.shape)}, {tuple(k3.shape)}, "
                         f"{tuple(v3.shape)}")
    if not (q3.dtype == k3.dtype == v3.dtype):
        raise ValueError("q/k/v must share one dtype")
    if not (q3.device == k3.device == v3.device):
        raise ValueError("q/k/v must share one device")
    if q3.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash attention runs on cpu or cuda, got "
                         f"{q3.device}")


def flash_attention_fwd(q3, k3, v3, *, scale: Optional[float] = None,
                        causal: bool = True
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward on (BH, T, D) tensors → (o (BH, T, D), lse (BH, 1, T)
    float32), the outputs of the JAX package's ``_fwd``.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (float32 or bfloat16, contiguous, head_dim in SUPPORTED_HEAD_DIMS)
    or raise."""
    _check_qkv(q3, k3, v3)
    scale = scale if scale is not None else 1.0 / math.sqrt(q3.shape[-1])
    if q3.device.type == "cpu":
        return flash_attention_fwd_reference(q3, k3, v3, scale=scale,
                                             causal=causal)
    BH, T, _ = q3.shape
    o = torch.empty_like(q3)
    lse = torch.empty((BH, 1, T), dtype=torch.float32, device=q3.device)
    _launch("flash_fwd", "flash_fwd", "FLASH_FWD_LAUNCHES", (q3, k3, v3),
            (o, lse), scale=scale, causal=causal)
    return o, lse


# ---------------------------------------------------------------------------
# Backward
# ---------------------------------------------------------------------------

def _bwd_tiles_reference(q3, k3, v3, do3, lse, delta, *, scale: float,
                         causal: bool):
    """P and dS of the whole (BH, T, T) score matrix in f32, as the
    backward kernels recompute them tile by tile."""
    T = q3.shape[1]
    s = torch.matmul(q3.float(), k3.float().transpose(1, 2)) * scale
    if causal:
        keep = torch.ones((T, T), dtype=torch.bool,
                          device=q3.device).tril()
        s = torch.where(keep, s, _NEG_INF)
    p = torch.exp(s - lse.reshape(-1, T, 1))
    dp = torch.matmul(do3.float(), v3.float().transpose(1, 2))
    ds = p * (dp - delta.reshape(-1, T, 1)) * scale
    return p, ds


def flash_bwd_dq_reference(q3, k3, v3, o3, do3, lse, *, scale: float,
                           causal: bool
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the dQ kernel → (dq, delta): delta =
    ``flash_bwd_delta(o3, do3)``, then dQ = dS K with dS rounded to k's
    dtype (``_bwd_dq_kernel``, flash_attention.py:177) and the f32 sum
    rounded to q's dtype once."""
    delta = flash_bwd_delta(o3, do3)
    _, ds = _bwd_tiles_reference(q3, k3, v3, do3, lse, delta, scale=scale,
                                 causal=causal)
    dq = torch.matmul(ds.to(k3.dtype).float(), k3.float())
    return dq.to(q3.dtype), delta


def flash_bwd_dkv_reference(q3, k3, v3, do3, lse, delta, *, scale: float,
                            causal: bool
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the dK/dV kernel: dV = P^T dO with P
    rounded to dO's dtype, dK = dS^T Q with dS rounded to q's dtype
    (``_bwd_dkv_kernel``, flash_attention.py:213-221)."""
    p, ds = _bwd_tiles_reference(q3, k3, v3, do3, lse, delta, scale=scale,
                                 causal=causal)
    dv = torch.matmul(p.to(do3.dtype).float().transpose(1, 2), do3.float())
    dk = torch.matmul(ds.to(q3.dtype).float().transpose(1, 2), q3.float())
    return dk.to(k3.dtype), dv.to(v3.dtype)


def flash_bwd_delta(o3, do3) -> torch.Tensor:
    """delta = rowsum(dO * O) in f32, (BH, 1, T), which the JAX package
    computes outside Pallas (flash_attention.py:235): the plain version
    of the part of the dQ kernel that computes it."""
    return (do3.float() * o3.float()).sum(dim=-1)[:, None, :]


def flash_attention_bwd_reference(q3, k3, v3, o3, lse, do3, *,
                                  scale: float, causal: bool
                                  ) -> Tuple[torch.Tensor, torch.Tensor,
                                             torch.Tensor]:
    """Plain PyTorch version of the whole backward on (BH, T, D)
    tensors → (dq, dk, dv): recomputes S, P = exp(S - LSE), dP and dS
    on f32 scores with the -1e30 mask (not autograd of the forward)."""
    dq, delta = flash_bwd_dq_reference(q3, k3, v3, o3, do3, lse,
                                       scale=scale, causal=causal)
    dk, dv = flash_bwd_dkv_reference(q3, k3, v3, do3, lse, delta,
                                     scale=scale, causal=causal)
    return dq, dk, dv


def _check_bwd_args(q3, k3, v3, do3, lse, *, o3=None, delta=None) -> None:
    """q/k/v as _check_qkv; dO (and o, where given) like q; lse (and
    delta, where given) (BH, 1, T) float32; all on q's device."""
    _check_qkv(q3, k3, v3)
    BH, T, _ = q3.shape
    mats = {"dO": do3} if o3 is None else {"o": o3, "dO": do3}
    vecs = {"lse": lse} if delta is None else {"lse": lse, "delta": delta}
    for name, t in mats.items():
        if t.shape != q3.shape or t.dtype != q3.dtype:
            raise ValueError(f"{name} must match q's shape and dtype, got "
                             f"{tuple(t.shape)} {t.dtype}")
    for name, t in vecs.items():
        if t.shape != (BH, 1, T) or t.dtype != torch.float32:
            raise ValueError(f"{name} must be (BH, 1, T) float32, got "
                             f"{tuple(t.shape)} {t.dtype}")
    if not all(t.device == q3.device for t in (*mats.values(),
                                               *vecs.values())):
        raise ValueError(f"{'/'.join((*mats, *vecs))} must be on q's "
                         f"device")


def flash_bwd_dq(q3, k3, v3, o3, do3, lse, *, scale: float,
                 causal: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dQ, delta) of the flash backward on (BH, T, D) tensors with the
    forward's o and lse (BH, 1, T) float32; delta = rowsum(dO * O)
    (BH, 1, T) float32, the dK/dV kernel's input.  CPU tensors take the
    plain version; CUDA tensors launch the dQ kernel, which computes
    delta too, or raise."""
    _check_bwd_args(q3, k3, v3, do3, lse, o3=o3)
    if q3.device.type == "cpu":
        return flash_bwd_dq_reference(q3, k3, v3, o3, do3, lse,
                                      scale=scale, causal=causal)
    BH, T, _ = q3.shape
    dq = torch.empty_like(q3)
    delta = torch.empty((BH, 1, T), dtype=torch.float32, device=q3.device)
    _launch("flash_bwd", "flash_bwd_dq", "FLASH_BWD_DQ_LAUNCHES",
            (q3, k3, v3, o3, do3, lse), (delta, dq), scale=scale,
            causal=causal)
    return dq, delta


def flash_bwd_dkv(q3, k3, v3, do3, lse, delta, *, scale: float,
                  causal: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dK, dV) of the flash backward, as flash_bwd_dq: CPU tensors
    take the plain version, CUDA tensors launch the dK/dV kernel or
    raise."""
    _check_bwd_args(q3, k3, v3, do3, lse, delta=delta)
    if q3.device.type == "cpu":
        return flash_bwd_dkv_reference(q3, k3, v3, do3, lse, delta,
                                       scale=scale, causal=causal)
    dk = torch.empty_like(k3)
    dv = torch.empty_like(v3)
    _launch("flash_bwd", "flash_bwd_dkv", "FLASH_BWD_DKV_LAUNCHES",
            (q3, k3, v3, do3, lse, delta), (dk, dv), scale=scale,
            causal=causal)
    return dk, dv


def flash_attention_bwd(q3, k3, v3, o3, lse, do3, *,
                        scale: Optional[float] = None, causal: bool = True
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Backward on (BH, T, D) tensors with the forward's o and lse
    (BH, 1, T) → (dq, dk, dv), the outputs of the JAX package's
    ``_bwd``/``_bwd_res``: the dQ kernel (which also gives delta), then
    the dK/dV kernel on the same stream; their plain versions for CPU
    tensors."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q3.shape[-1])
    if o3.shape != q3.shape or do3.shape != q3.shape:
        raise ValueError(f"o and dO must match q's shape "
                         f"{tuple(q3.shape)}, got {tuple(o3.shape)} and "
                         f"{tuple(do3.shape)}")
    dq, delta = flash_bwd_dq(q3, k3, v3, o3, do3, lse, scale=scale,
                             causal=causal)
    dk, dv = flash_bwd_dkv(q3, k3, v3, do3, lse, delta, scale=scale,
                           causal=causal)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """o = flash(q3, k3, v3): forward kernel, saving (q3, k3, v3, o,
    lse) as the JAX ``_flash_fwd`` does; backward through the dQ and
    dK/dV kernels (``_flash_bwd``/``_flash_res_bwd``)."""

    @staticmethod
    def forward(ctx, q3, k3, v3, scale: float, causal: bool):
        o, lse = flash_attention_fwd(q3, k3, v3, scale=scale, causal=causal)
        ctx.save_for_backward(q3, k3, v3, o, lse)
        ctx.scale, ctx.causal = scale, causal
        return o

    @staticmethod
    def backward(ctx, do):
        q3, k3, v3, o, lse = ctx.saved_tensors
        # the gradient comes through the (B,T,H,D) <-> (BH,T,D)
        # transposes; the kernels take contiguous tensors
        dq, dk, dv = flash_attention_bwd(q3, k3, v3, o, lse,
                                         do.contiguous(), scale=ctx.scale,
                                         causal=ctx.causal)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, *, causal: bool = True,
                    scale: Optional[float] = None,
                    block_q: Optional[int] = None,
                    block_k: Optional[int] = None,
                    block_q_bwd: Optional[int] = None,
                    block_k_bwd: Optional[int] = None,
                    resident_kv: Optional[bool] = None) -> torch.Tensor:
    """Flash attention on (B, T, H, D) tensors, differentiable.

    The block knobs and ``resident_kv`` are accepted and validated as
    in the JAX package, so one config drives both packages.  They do
    not change the Hopper tiling: resident_kv True and False launch
    the same kernels, whose loops already run inside the CTA and stop
    (dQ, forward) or start (dK/dV) at the causal diagonal, the shape
    of the JAX resident variant, over 64-row tiles whatever the blocks
    ask."""
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
    scale = scale if scale is not None else 1.0 / math.sqrt(D)

    def to3(x):
        # at B = 1 the reshape is a strided view, not a copy
        return x.transpose(1, 2).reshape(B * H, T, D).contiguous()

    o3 = _FlashAttention.apply(to3(q), to3(k), to3(v), scale, causal)
    return o3.reshape(B, H, T, D).transpose(1, 2)
