"""Mixture-of-Experts feed-forward block, expert-parallel over the
``expert`` mesh axis.  Counterpart of ``ray_tpu/models/moe.py``.

Dense capacity-based dispatch in the Switch/GShard style, with static
shapes: an f32 softmax gate, top-k routing by k argmax rounds, a
capacity of ``ceil(N * k / E * capacity_factor)`` slots per expert over
the N tokens of the (global) batch, overflow dropped (the residual
stream carries a dropped token unchanged), one-hot dispatch and combine
tensors, and three products: tokens into expert slots, the experts'
two-layer GELU MLP, slots back to tokens.  The JAX package writes them
as einsums that XLA compiles; here they are plain matmuls.

Under a mesh (``parallel/mesh.py``: the active one, or ``mesh=``) the
block runs SPMD on this rank's tokens: the batch is split over the
mesh axes the rules give "batch" (data, fsdp), so a token's queue
position counts the tokens of the ranks before it (their per-expert
counts gathered), and the expert slots are summed over those ranks.
With the experts split over the ``expert`` axis (``w1`` holding this
rank's E / ep of them), each rank runs its own experts on every slot
and the outputs are summed over the axis.  The result equals the block
on one device over the whole batch, as JAX's GSPMD program does.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ray_tpu_torch.device import DeviceLike, resolve_device
from ray_tpu_torch.parallel.collective import (axis_size, flat_index,
                                               xla_allgather, xla_allreduce)
from ray_tpu_torch.parallel.mesh import active_mesh
from ray_tpu_torch.parallel.sharding import (DEFAULT_RULES, gather_params,
                                             split_axes)


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    d_model: int = 256
    d_ff: int = 512
    n_experts: int = 4
    top_k: int = 2
    #: capacity per expert = ceil(tokens * top_k / experts) *
    #: capacity_factor
    capacity_factor: float = 1.25
    dtype: Any = torch.bfloat16
    param_dtype: Any = torch.float32


def moe_init(cfg: MoEConfig, generator: Optional[torch.Generator] = None,
             device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """{"gate": (d, E), "w1": (E, d, f), "b1": (E, f), "w2": (E, f, d),
    "b2": (E, d)}, N(0, 0.02) weights and zero biases, as the JAX
    ``moe_init`` (whose jax.random draws differ: tests carry JAX's
    weights across).  ``generator`` must live on ``device``; None seeds
    a fresh one with 0."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    pd = cfg.param_dtype
    E, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff

    def norm(shape):
        return (torch.randn(shape, generator=generator, device=dev,
                            dtype=torch.float32) * 0.02).to(pd)

    return {"gate": norm((d, E)), "w1": norm((E, d, f)),
            "b1": torch.zeros((E, f), dtype=pd, device=dev),
            "w2": norm((E, f, d)),
            "b2": torch.zeros((E, d), dtype=pd, device=dev)}


def moe_logical_axes(cfg: MoEConfig) -> Dict[str, Tuple]:
    return {
        "gate": ("embed", None),
        "w1": ("expert", "embed", "mlp"),
        "b1": ("expert", "mlp"),
        "w2": ("expert", "mlp", "embed"),
        "b2": ("expert", "embed"),
    }


def moe_route(probs: torch.Tensor, cfg: MoEConfig, capacity: int,
              mesh=None, batch_axes: Tuple[str, ...] = ()) -> Dict:
    """Top-k routing of the (N, E) gate probabilities with static
    shapes, as ``moe.py:82-100``: ``top_k`` argmax rounds build the
    dispatch mask and the combine weights, ``position`` is each
    assignment's place in its expert's queue (-1 where there is none),
    and assignments at or past ``capacity`` are dropped.  Over
    ``batch_axes`` of ``mesh`` the queue continues across the ranks'
    tokens in rank order.  Returns {"dispatch", "combine" (both kept
    assignments only), "position"} (N, E) float32."""
    E, K = cfg.n_experts, cfg.top_k
    remaining = probs
    dispatch = torch.zeros_like(probs)
    combine = torch.zeros_like(probs)
    for _ in range(K):
        onehot = F.one_hot(remaining.argmax(dim=-1), E).to(probs.dtype)
        combine = combine + onehot * probs
        dispatch = dispatch + onehot
        remaining = remaining * (1.0 - onehot)
    position = torch.cumsum(dispatch, dim=0)
    if batch_axes:
        # the tokens of the ranks before this one come first in each
        # expert's queue: add their counts
        with torch.no_grad():
            counts = dispatch.sum(dim=0, keepdim=True)
            for a in reversed(batch_axes):
                counts = xla_allgather(counts, a, mesh=mesh)
            before = flat_index(batch_axes, mesh)
            position = position + counts[:before].sum(dim=0)
    position = position * dispatch - 1.0
    keep = ((position >= 0) & (position < capacity)).to(probs.dtype)
    return {"dispatch": dispatch * keep, "combine": combine * keep,
            "position": position}


def moe_apply(params, x: torch.Tensor, cfg: MoEConfig,
              rules=DEFAULT_RULES, mesh=None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, T, d) -> ((B, T, d), aux_loss): the Switch/GShard
    load-balancing term is ``aux_loss`` (add ``aux_weight * aux_loss``,
    typically 1e-2, to the training loss).  Under a mesh (the active
    one, or ``mesh``) ``x`` is this rank's share of the batch and
    ``params`` may be DTensors (``shard_params``): they are gathered
    but for the expert dim, which each rank keeps."""
    mesh = mesh if mesh is not None else active_mesh()
    batch_axes = split_axes("batch", mesh, rules) if mesh is not None \
        else ()
    expert_axes = split_axes("expert", mesh, rules) if mesh is not None \
        else ()
    params = gather_params(params, keep=expert_axes)
    B, T, d = x.shape
    E, K = cfg.n_experts, cfg.top_k
    N = B * T
    n_global = N * (axis_size(batch_axes, mesh) if batch_axes else 1)
    # Each token makes K assignments, so balanced load is K*N/E per
    # expert (GShard capacity definition), N over the whole batch.
    C = int(math.ceil(n_global * K / E * cfg.capacity_factor))
    xf = x.reshape(N, d)

    # Routing in float32 for a stable softmax.
    logits = xf.float() @ params["gate"].float()
    probs = torch.softmax(logits, dim=-1)  # (N, E)
    route = moe_route(probs, cfg, C, mesh, batch_axes)

    # This rank's experts: all E, or its block of the expert axis.
    e_loc = params["w1"].shape[0]
    e0 = 0
    if e_loc != E:
        e0 = flat_index(expert_axes, mesh) * e_loc
    cols = slice(e0, e0 + e_loc)
    # slot[n, e, c] = 1 where token n holds slot c of expert e: the
    # dispatch tensor (a dropped or absent assignment's position is
    # outside [0, C), so its row is all zeros), and, times the combine
    # weight, the combine tensor; both built in the compute dtype, as
    # the JAX version casts them before its products
    pos = route["position"][:, cols].to(torch.int64)
    slot = (pos.unsqueeze(-1) == torch.arange(C, device=x.device)
            ).to(cfg.dtype)                                  # (N, e, C)
    comb = route["combine"][:, cols].to(cfg.dtype).unsqueeze(-1) * slot

    # Expert compute: (e, C, d) slots, summed over the batch's ranks.
    exp_in = (slot.reshape(N, e_loc * C).t() @ xf.to(cfg.dtype)
              ).reshape(e_loc, C, d)
    if batch_axes:
        exp_in = xla_allreduce(exp_in, batch_axes, mesh=mesh)
    w1, w2 = params["w1"].to(cfg.dtype), params["w2"].to(cfg.dtype)
    h = torch.bmm(exp_in, w1) + params["b1"].to(cfg.dtype)[:, None, :]
    h = F.gelu(h, approximate="tanh")  # jax.nn.gelu is the tanh form
    out = torch.bmm(h, w2) + params["b2"].to(cfg.dtype)[:, None, :]
    y = comb.reshape(N, e_loc * C) @ out.reshape(e_loc * C, d)
    if e_loc != E:
        y = xla_allreduce(y, expert_axes, mesh=mesh)

    # Load-balance aux loss (Switch eq. 4): E * sum_e f_e * P_e, the
    # fractions over the whole batch.
    token_sum = route["dispatch"].sum(dim=0)
    prob_sum = probs.sum(dim=0)
    if batch_axes:
        token_sum = xla_allreduce(token_sum, batch_axes, mesh=mesh)
        prob_sum = xla_allreduce(prob_sum, batch_axes, mesh=mesh)
    aux = E * torch.sum((token_sum / n_global) * (prob_sum / n_global)) \
        * (1.0 / K)
    return y.reshape(B, T, d).to(x.dtype), aux.float()
