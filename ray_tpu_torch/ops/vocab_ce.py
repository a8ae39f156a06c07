"""Streaming (vocab-tiled) cross-entropy for tied-embedding LM heads.

Counterpart of ``ray_tpu/ops/vocab_ce.py`` (``ce_impl="streaming_xla"``):
``mean_ce(h @ wte^T, targets)`` without the whole (N, V) logits.  A
Python loop over vocab tiles keeps one (N, vocab_tile) f32 tile live at
a time, with an online logsumexp (running max and sum) and the target
logit picked by a masked reduction; the backward recomputes each tile,
accumulates dh across tiles and emits dwte tile by tile.

Plain PyTorch by design, as the JAX version is a ``lax.scan`` in XLA
and not a Pallas kernel.  Its conventions differ from the fused CE's
(ops/fused_ce.py) and are kept: the mask is -inf (not -1e30), the table
is padded with zero rows to a tile multiple, and dlogits is rounded to
the compute dtype before both products.
"""

from __future__ import annotations

import torch


def _pad_table(wte, tile: int):
    """Round the table up to a tile multiple with zero rows (they sit
    beyond valid_vocab, so the mask hides them)."""
    v, d = wte.shape
    rem = (-v) % tile
    if rem:
        wte = torch.cat([wte, wte.new_zeros((rem, d))], dim=0)
    return wte, v + rem


def _mm_f32(a, b):
    """a @ b with compute-dtype operands and a float32 result, as
    ``jnp.dot(..., preferred_element_type=float32)``: one
    ``torch.mm(..., out_dtype=float32)`` for bf16 on CUDA; the CPU has
    no such kernel, and bf16 products are exact in f32."""
    if a.dtype == torch.float32:
        return a @ b
    if a.device.type == "cuda":
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def _tile_logits(h, w_tile, base: int, valid_vocab: int):
    logits = _mm_f32(h, w_tile.t())
    col = base + torch.arange(w_tile.shape[0], device=h.device)
    return logits.masked_fill(col >= valid_vocab, float("-inf")), col


def _forward(hidden, wte, targets, valid_vocab: int, vocab_tile: int,
             compute_dtype):
    n = hidden.shape[0]
    wte_p, v = _pad_table(wte, vocab_tile)
    h = hidden.to(compute_dtype)
    tgt_idx = targets.long()[:, None]
    m = torch.full((n,), float("-inf"), dtype=torch.float32,
                   device=hidden.device)
    s = torch.zeros_like(m)
    tgt = torch.zeros_like(m)
    for base in range(0, v, vocab_tile):
        w_tile = wte_p[base:base + vocab_tile].to(compute_dtype)
        logits, col = _tile_logits(h, w_tile, base, valid_vocab)
        new_m = torch.maximum(m, logits.amax(dim=1))
        s = s * torch.exp(m - new_m) + torch.exp(
            logits - new_m[:, None]).sum(dim=1)
        tgt = tgt + torch.where(col == tgt_idx, logits, 0.0).sum(dim=1)
        m = new_m
    lse = m + torch.log(s)
    return lse - tgt, lse


class _StreamingCE(torch.autograd.Function):
    """The JAX ``custom_vjp``: the forward saves (hidden, wte, targets,
    lse); the backward recomputes each tile, dlogits = g * (softmax -
    onehot) rounded to the compute dtype, dh accumulated in f32 across
    tiles and dwte emitted per tile (vocab_ce.py:105-137)."""

    @staticmethod
    def forward(ctx, hidden, wte, targets, valid_vocab: int,
                vocab_tile: int, compute_dtype):
        nll, lse = _forward(hidden, wte, targets, valid_vocab, vocab_tile,
                            compute_dtype)
        ctx.save_for_backward(hidden, wte, targets, lse)
        ctx.args = (valid_vocab, vocab_tile, compute_dtype)
        return nll

    @staticmethod
    def backward(ctx, g):
        hidden, wte, targets, lse = ctx.saved_tensors
        valid_vocab, vocab_tile, compute_dtype = ctx.args
        wte_p, v = _pad_table(wte, vocab_tile)
        h = hidden.to(compute_dtype)
        gf = g.float()[:, None]
        tgt_idx = targets.long()[:, None]
        dh = torch.zeros(hidden.shape, dtype=torch.float32,
                         device=hidden.device)
        dw_tiles = []
        for base in range(0, v, vocab_tile):
            w_tile = wte_p[base:base + vocab_tile].to(compute_dtype)
            logits, col = _tile_logits(h, w_tile, base, valid_vocab)
            p = torch.exp(logits - lse[:, None])
            dlog = torch.where(col == tgt_idx, p - 1.0, p)
            dlog = (dlog * gf).to(compute_dtype)
            dh = dh + _mm_f32(dlog, w_tile)
            dw_tiles.append(_mm_f32(dlog.t(), h))
        dwte = torch.cat(dw_tiles)[:wte.shape[0]]  # drop pad rows
        return (dh.to(hidden.dtype), dwte.to(wte.dtype), None, None, None,
                None)


def streaming_ce(hidden, wte, targets, valid_vocab: int,
                 vocab_tile: int = 8192,
                 compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Per-token cross entropy of tied-head logits, vocab-streamed.

    hidden: (N, D) flattened (B*T, D) activations.
    wte: (V, D) embedding table (V = padded vocab, tiled by vocab_tile).
    targets: (N,) int in [0, valid_vocab).
    valid_vocab: logits at indices >= valid_vocab are masked to -inf.

    Returns (N,) float32 nll, differentiable with respect to hidden and
    wte."""
    return _StreamingCE.apply(hidden, wte, targets, valid_vocab,
                              vocab_tile, compute_dtype)
