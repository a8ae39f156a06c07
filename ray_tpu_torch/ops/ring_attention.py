"""Sequence (context) parallelism: ring attention and Ulysses
all-to-all.  Counterpart of ``ray_tpu/ops/ring_attention.py``.

Both run SPMD on every rank of a mesh axis (default ``"seq"``, of the
active mesh unless ``mesh=`` is given), on this rank's local shards
q/k/v of shape (B, T_local, H, D): rank i of the axis holds sequence
positions [i * T_local, (i + 1) * T_local).  The JAX package calls
them inside ``shard_map``; here each rank calls them on the tensors it
holds, and the communication is ``parallel.collective``'s.

Ring attention: each rank keeps its q shard and passes the k/v shards
round the ring with ``xla_ppermute``.  At each step it attends its q
against the visiting chunk (``_chunk_attend``, plain PyTorch as the
JAX version is XLA einsums) and merges the partial result into a
running (max, sum, accumulator) log-sum-exp state, so the T x T score
matrix never exists on one rank.  The permutation is differentiable
(its backward is the inverse permutation), so autograd's backward is
the reverse ring.  Every rank issues the same permutations in the same
order, in the forward and in the backward.

Ulysses: ``xla_all_to_all`` reshards (seq-sharded, all heads) into
(all positions, H / n heads), attends each head group over the whole
sequence (causal: ``ops.attention.causal_attention``, the flash kernels
on the card; non-causal: ``reference_attention``), and reshards back.
It needs H divisible by the axis size.

Gradients follow the collectives' convention: the sum over the ranks of
each rank's own loss.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ray_tpu_torch.parallel.collective import (axis_index, axis_size,
                                               xla_all_to_all, xla_ppermute)

_NEG_BIG = -1e30


def _chunk_attend(q, k, v, q_off: int, k_off: int, *, causal: bool,
                  scale: float):
    """Blockwise attention of a q chunk against one k/v chunk: the
    UNNORMALISED accumulator and the row statistics the LSE merge
    needs.

    q (B, Tq, H, D); k/v (B, Tk, H, D); the offsets are the global
    positions of element 0.  Returns (acc (B, Tq, H, D) f32,
    m (B, Tq, H) f32, l (B, Tq, H) f32)."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    if causal:
        Tq, Tk = q.shape[1], k.shape[1]
        rows = q_off + torch.arange(Tq, device=q.device)[:, None]
        cols = k_off + torch.arange(Tk, device=q.device)[None, :]
        s = torch.where(rows >= cols, s, _NEG_BIG)
    m = s.amax(dim=-1)                                   # (B, H, Tq)
    p = torch.exp(s - m[..., None])
    # fully masked rows: make their contribution exactly zero
    p = torch.where((m == _NEG_BIG)[..., None], 0.0, p)
    l = p.sum(dim=-1)                                    # (B, H, Tq)
    acc = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v)
    return acc.float(), m.transpose(1, 2), l.transpose(1, 2)


def ring_attention(q, k, v, *, axis_name: str = "seq", causal: bool = True,
                   scale: Optional[float] = None, mesh=None) -> torch.Tensor:
    """MHA over a sequence-sharded mesh axis: q/k/v are this rank's
    LOCAL shards (B, T_local, H, D); returns the local shard of the
    attention output, in q's dtype."""
    B, Tl, H, D = q.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    n = axis_size(axis_name, mesh)
    idx = axis_index(axis_name, mesh)
    q_off = idx * Tl
    m = torch.full((B, Tl, H), _NEG_BIG, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, Tl, H), dtype=torch.float32, device=q.device)
    acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    perm = [(i, (i + 1) % n) for i in range(n)]

    def attend_merge(m, l, acc, kc, vc, s):
        src = (idx - s) % n           # ring step s holds src's shard
        a_s, m_s, l_s = _chunk_attend(q, kc, vc, q_off, src * Tl,
                                      causal=causal, scale=scale)
        m_new = torch.maximum(m, m_s)
        # rescale both the running accumulator and the new partial
        alpha = torch.exp(m - m_new)
        beta = torch.exp(m_s - m_new)
        l = l * alpha + l_s * beta
        acc = acc * alpha[..., None] + a_s * beta[..., None]
        return m_new, l, acc

    kc, vc = k, v
    for s in range(n - 1):
        m, l, acc = attend_merge(m, l, acc, kc, vc, s)
        # pass k/v to the next rank
        kc = xla_ppermute(kc, axis_name, perm, mesh=mesh)
        vc = xla_ppermute(vc, axis_name, perm, mesh=mesh)
    # the last shard is merged outside the loop, so the final (useless)
    # hop is never sent
    m, l, acc = attend_merge(m, l, acc, kc, vc, n - 1)
    l = l.clamp_min(1e-30)
    return (acc / l[..., None]).to(q.dtype)


def ulysses_attention(q, k, v, *, axis_name: str = "seq",
                      causal: bool = True, scale: Optional[float] = None,
                      attend_fn=None, mesh=None) -> torch.Tensor:
    """Head-scatter / seq-gather attention (the Ulysses pattern): the
    local (B, T_local, H, D) shards become (B, T, H / n, D) by one
    all-to-all, ordinary full-sequence attention runs on the local head
    group (``attend_fn(q, k, v)`` if given; causal: ``causal_attention``,
    the flash kernels on the card; else the plain reference), and a
    second all-to-all brings the output back.  Needs H % n == 0."""
    n = axis_size(axis_name, mesh)
    H = q.shape[2]
    if H % n:
        raise ValueError(f"ulysses needs heads ({H}) divisible by the "
                         f"sequence axis size ({n})")

    def scatter(x):   # (B, Tl, H, D) -> (B, T, H/n, D)
        return xla_all_to_all(x, axis_name, split_axis=2, concat_axis=1,
                              mesh=mesh)

    def gather(x):    # (B, T, H/n, D) -> (B, Tl, H, D)
        return xla_all_to_all(x, axis_name, split_axis=1, concat_axis=2,
                              mesh=mesh)

    qf, kf, vf = scatter(q), scatter(k), scatter(v)
    if attend_fn is None:
        from ray_tpu_torch.ops.attention import causal_attention

        of = causal_attention(qf, kf, vf, scale=scale) if causal else \
            _plain(qf, kf, vf, scale)
    else:
        of = attend_fn(qf, kf, vf)
    return gather(of)


def _plain(q, k, v, scale):
    from ray_tpu_torch.ops.attention import reference_attention

    return reference_attention(q, k, v, causal=False, scale=scale)
