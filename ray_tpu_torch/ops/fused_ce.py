"""Fused lm-head matmul + cross-entropy for Hopper: wrappers, plain
versions, autograd.

Counterpart of ``ray_tpu/ops/fused_ce.py`` (``ce_impl="pallas"``).
Three CUDA kernels in ``ops/csrc/fused_ce.cu`` (tensor cores for
bfloat16, f32 FMA for float32) replace the JAX package's three Pallas
kernels:

* forward (``_fwd_kernel``): per row of h, an online logsumexp over
  vocab tiles of the f32 tile h.w^T, columns >= valid_vocab masked to
  -1e30, the target logit picked in its tile; writes nll and lse;
* dH (``_bwd_dh_kernel``): recomputes each tile's dlogits = g * (exp(
  logits - lse) - onehot), rounds it to w's dtype and sums dlogits.w;
* dW (``_bwd_dw_kernel``): the same dlogits, rounded to h's dtype,
  summed as dlogits^T.h.

The (N, V) logits never reach device memory in either pass.  Dispatch
is by tensor placement, as for the flash kernels: a CPU tensor takes
the plain PyTorch version (``*_reference``), which computes over whole
f32 tensors what the kernels compute tile by tile, with their
roundings; a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

from typing import Tuple

import torch

#: the JAX package's tile sizes, sized for a TPU's VMEM; accepted and
#: validated so one config drives both packages, they do not set the
#: Hopper kernels' tiles (32 x 64, see the .cu source)
DEFAULT_BLOCK_N = 256
DEFAULT_BLOCK_V = 1024

#: launches of each CUDA kernel in this process; only the kernel's
#: launch site below adds to its count
FUSED_CE_FWD_LAUNCHES = 0
FUSED_CE_BWD_DH_LAUNCHES = 0
FUSED_CE_BWD_DW_LAUNCHES = 0

_NEG_INF = -1e30
#: the kernels take d_model a multiple of 64 in [64, MAX_D]
MAX_D = 1024


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def _masked_logits(h, w, valid_vocab: int) -> torch.Tensor:
    """The whole (N, V) f32 logits of compute-dtype h and w (products
    of bf16 values are exact in f32), columns >= valid_vocab at -1e30."""
    logits = h.float() @ w.float().t()
    cols = torch.arange(w.shape[0], device=h.device)
    return logits.masked_fill(cols >= valid_vocab, _NEG_INF)


def _dlogits(h, w, tgt, lse, g, valid_vocab: int) -> torch.Tensor:
    """dlogits = g * (exp(logits - lse) - onehot(target)) in f32, as
    ``_dlog_tile`` (fused_ce.py:155-161) forms it tile by tile."""
    p = torch.exp(_masked_logits(h, w, valid_vocab) - lse[:, None])
    onehot = torch.zeros_like(p).scatter_(1, tgt.long()[:, None], 1.0)
    return (p - onehot) * g.float()[:, None]


def fused_ce_fwd_reference(h, w, tgt, valid_vocab: int
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the forward kernel: (nll, lse), (N,)
    float32 each, of h (N, D) and w (V, D) in the compute dtype."""
    logits = _masked_logits(h, w, valid_vocab)
    m = logits.amax(dim=1)
    lse = m + torch.log(torch.exp(logits - m[:, None]).sum(dim=1))
    target = logits.gather(1, tgt.long()[:, None])[:, 0]
    return lse - target, lse


def fused_ce_bwd_dh_reference(h, w, tgt, lse, g, valid_vocab: int
                              ) -> torch.Tensor:
    """Plain PyTorch version of the dH kernel: dlogits rounded to w's
    dtype (fused_ce.py:177), dH = dlogits . w summed in f32, (N, D)
    float32."""
    dlog = _dlogits(h, w, tgt, lse, g, valid_vocab)
    return dlog.to(w.dtype).float() @ w.float()


def fused_ce_bwd_dw_reference(h, w, tgt, lse, g, valid_vocab: int
                              ) -> torch.Tensor:
    """Plain PyTorch version of the dW kernel: dlogits rounded to h's
    dtype (fused_ce.py:199), dW = dlogits^T . h summed in f32, (V, D)
    float32; rows >= valid_vocab are exactly 0."""
    dlog = _dlogits(h, w, tgt, lse, g, valid_vocab)
    return dlog.to(h.dtype).float().t() @ h.float()


# ---------------------------------------------------------------------------
# Wrappers: CPU -> plain version, CUDA -> kernel or raise
# ---------------------------------------------------------------------------

def _check_args(h, w, tgt, valid_vocab: int, rows=()) -> None:
    if h.dim() != 2 or w.dim() != 2 or h.shape[1] != w.shape[1]:
        raise ValueError(f"h (N, D) and w (V, D) must share D, got "
                         f"{tuple(h.shape)} and {tuple(w.shape)}")
    if h.dtype != w.dtype:
        raise ValueError(f"h and w must share the compute dtype, got "
                         f"{h.dtype} and {w.dtype}")
    if tgt.shape != (h.shape[0],):
        raise ValueError(f"targets must be (N,) = ({h.shape[0]},), got "
                         f"{tuple(tgt.shape)}")
    for name, t in rows:
        if t.shape != (h.shape[0],) or t.dtype != torch.float32:
            raise ValueError(f"{name} must be (N,) float32, got "
                             f"{tuple(t.shape)} {t.dtype}")
    v = w.shape[0]
    if not 0 < valid_vocab <= v:
        raise ValueError(f"valid_vocab={valid_vocab} must be in "
                         f"(0, {v}] for a (V={v}, D) head table")
    devices = {t.device for t in (h, w, tgt, *(t for _, t in rows))}
    if len(devices) != 1:
        raise ValueError(f"fused CE inputs must share one device, got "
                         f"{sorted(map(str, devices))}")
    if h.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused CE runs on cpu or cuda, got {h.device}")


def _launch(fn_name: str, counter: str, inputs, outputs,
            valid_vocab: int) -> None:
    """Launch ``fn_name`` of ``csrc/fused_ce.cu`` on ``inputs`` (h, w,
    tgt, ...), writing ``outputs``, and add one to the module's counter
    ``counter``.  What the kernels take: float32 or bfloat16 h and w,
    D a multiple of 64 in [64, MAX_D], int32 targets, contiguous and
    16-byte aligned tensors."""
    from ray_tpu_torch.ops import _kernels

    h, w, tgt = inputs[:3]
    (N, D), V = h.shape, w.shape[0]
    if h.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{fn_name} kernel takes float32 or bfloat16, got "
                         f"{h.dtype}")
    if D % 64 or not 64 <= D <= MAX_D:
        raise ValueError(f"{fn_name} kernel takes d_model a multiple of 64 "
                         f"in [64, {MAX_D}], got {D}")
    if tgt.dtype != torch.int32:
        raise ValueError(f"{fn_name} kernel takes int32 targets, got "
                         f"{tgt.dtype}")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0
               for t in (*inputs, *outputs)):
        raise ValueError(f"{fn_name} kernel takes contiguous, 16-byte "
                         f"aligned tensors")
    _kernels.launch("fused_ce", fn_name, (*inputs, *outputs),
                    (N, V, D, valid_vocab, int(h.dtype == torch.bfloat16)),
                    h.device)
    globals()[counter] += 1


def fused_ce_fwd(h, w, tgt, valid_vocab: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(nll, lse), (N,) float32 each, of h (N, D) and w (V, D) in the
    compute dtype and int targets (N,): the outputs of the JAX
    package's ``_fwd``.  CPU tensors take the plain version; CUDA
    tensors launch the forward kernel or raise."""
    _check_args(h, w, tgt, valid_vocab)
    if h.device.type == "cpu":
        return fused_ce_fwd_reference(h, w, tgt, valid_vocab)
    nll = torch.empty(h.shape[0], dtype=torch.float32, device=h.device)
    lse = torch.empty_like(nll)
    _launch("fused_ce_fwd", "FUSED_CE_FWD_LAUNCHES", (h, w, tgt),
            (nll, lse), valid_vocab)
    return nll, lse


def fused_ce_bwd_dh(h, w, tgt, lse, g, valid_vocab: int) -> torch.Tensor:
    """dH (N, D) float32 from the forward's lse and the cotangent g,
    (N,) float32 each.  CPU tensors take the plain version; CUDA
    tensors launch the dH kernel or raise."""
    _check_args(h, w, tgt, valid_vocab, (("lse", lse), ("g", g)))
    if h.device.type == "cpu":
        return fused_ce_bwd_dh_reference(h, w, tgt, lse, g, valid_vocab)
    dh = torch.empty(h.shape, dtype=torch.float32, device=h.device)
    _launch("fused_ce_bwd_dh", "FUSED_CE_BWD_DH_LAUNCHES",
            (h, w, tgt, lse, g), (dh,), valid_vocab)
    return dh


def fused_ce_bwd_dw(h, w, tgt, lse, g, valid_vocab: int) -> torch.Tensor:
    """dW (V, D) float32, as fused_ce_bwd_dh: CPU tensors take the
    plain version, CUDA tensors launch the dW kernel or raise."""
    _check_args(h, w, tgt, valid_vocab, (("lse", lse), ("g", g)))
    if h.device.type == "cpu":
        return fused_ce_bwd_dw_reference(h, w, tgt, lse, g, valid_vocab)
    dw = torch.empty(w.shape, dtype=torch.float32, device=h.device)
    _launch("fused_ce_bwd_dw", "FUSED_CE_BWD_DW_LAUNCHES",
            (h, w, tgt, lse, g), (dw,), valid_vocab)
    return dw


class _FusedCE(torch.autograd.Function):
    """nll = fused CE(hidden, wte): the role of the JAX ``custom_vjp``
    (fused_ce.py:259-282).  hidden and wte enter as they are (the f32
    master wte included) and are cast to the compute dtype inside, so
    dW comes back in wte's dtype unrounded; the forward saves the cast
    (h, w), the targets and lse; the backward runs dH, then dW."""

    @staticmethod
    def forward(ctx, hidden, wte, targets, valid_vocab: int,
                compute_dtype):
        h = hidden.to(compute_dtype).contiguous()
        w = wte.to(compute_dtype).contiguous()
        tgt = targets.to(torch.int32).contiguous()
        nll, lse = fused_ce_fwd(h, w, tgt, valid_vocab)
        ctx.save_for_backward(h, w, tgt, lse)
        ctx.valid_vocab = valid_vocab
        ctx.dtypes = (hidden.dtype, wte.dtype)
        return nll

    @staticmethod
    def backward(ctx, g):
        h, w, tgt, lse = ctx.saved_tensors
        g = g.float().contiguous()
        dh = fused_ce_bwd_dh(h, w, tgt, lse, g, ctx.valid_vocab)
        dw = fused_ce_bwd_dw(h, w, tgt, lse, g, ctx.valid_vocab)
        return dh.to(ctx.dtypes[0]), dw.to(ctx.dtypes[1]), None, None, None


def fused_lm_ce(hidden, wte, targets, valid_vocab: int, *,
                block_n: int = DEFAULT_BLOCK_N,
                block_v: int = DEFAULT_BLOCK_V,
                compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Per-token CE of ``hidden @ wte^T`` logits, fused.

    hidden: (N, D) flattened (B*T, D) activations, any float dtype.
    wte: (V, D) vocab-major head table (tied ``wte``, or a transposed
        ``lm_head``), any float dtype; rows >= valid_vocab are masked.
    targets: (N,) int in [0, valid_vocab).

    Returns (N,) float32 nll, differentiable with respect to hidden
    (gradient in hidden's dtype) and wte (in wte's dtype).  The (N, V)
    logits never exist in either pass on the card.  ``block_n`` and
    ``block_v`` are the JAX package's TPU tiles: validated, not used."""
    for name, value in (("block_n", block_n), ("block_v", block_v)):
        if not isinstance(value, int) or value < 1:
            raise ValueError(f"{name} must be a positive int, got {value!r}")
    return _FusedCE.apply(hidden, wte, targets, valid_vocab, compute_dtype)
