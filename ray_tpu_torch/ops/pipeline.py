"""Pipeline parallelism over the ``pipeline`` mesh axis.  Counterpart of
``ray_tpu/ops/pipeline.py``.

The scheme is GPipe's microbatching written as one SPMD program, as in
the JAX package:

* per-stage parameters are stacked on a leading ``stage`` axis; each
  rank of the ``pipeline`` axis computes with its own stage only;
* every rank runs the same loop of M + S - 1 ticks: compute its stage
  on the activation it holds, then pass the result one hop along the
  ring (``xla_ppermute``);
* stage 0 takes a fresh microbatch each tick; the last stage collects
  its outputs from tick S - 1 on, and a masked all-reduce hands them to
  every pipeline rank.

The loop is differentiable: autograd's backward runs the reverse ring
(the permutation's adjoint), and ``remat=True`` recomputes each tick's
stage in the backward (``torch.utils.checkpoint``), keeping one
microbatch of activations per stage.  Every rank's graph has the same
collectives in the same order: stage 0 keeps the received activation
as a (zero-gradient) input of its selection, and every rank's output
enters the all-reduce, so each collective's backward runs on all ranks.
"""

from __future__ import annotations

from typing import Any, Callable, Union

import torch
from torch.utils.checkpoint import checkpoint

from ray_tpu_torch.parallel.collective import (axis_index, axis_size,
                                               xla_allreduce, xla_ppermute)
from ray_tpu_torch.parallel.mesh import AXIS_PIPELINE, active_mesh
from ray_tpu_torch.train.optim import tree_map


def _own_stage(leaf, idx: int, axis: str):
    """This rank's stage of one stacked leaf: its local block of a
    DTensor split over ``axis`` (one stage), else row ``idx``."""
    if type(leaf).__name__ == "DTensor":
        names = list(leaf.device_mesh.mesh_dim_names)
        split = leaf.placements[names.index(axis)].is_shard(0)
        local = leaf.to_local()
        return local[0] if split else local[idx]
    return leaf[idx]


def pipeline_apply(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                   stage_params: Any, x: torch.Tensor, *,
                   microbatches: int, mesh=None, axis: str = AXIS_PIPELINE,
                   remat: bool = True) -> torch.Tensor:
    """Run ``x`` through S pipeline stages in M microbatches.

    stage_fn(params_one_stage, act) -> act: one stage; its output has
    its input's shape (residual-stream style).  stage_params: a tree
    whose leaves have a leading stage axis of size S (plain tensors,
    or DTensors split over ``axis``).  x: (batch, ...) the global
    input, the same on every pipeline rank; batch must divide by
    ``microbatches``.

    Returns the last stage's output on every pipeline rank.  Gradients
    follow the collectives' convention (the sum over the ranks of each
    rank's own loss): when every one of the S ranks differentiates the
    same loss of the output, each stage's gradient is S times that
    loss's; differentiate loss / S (as the mesh train step divides by
    the world size) for the JAX package's gradient."""
    mesh = mesh if mesh is not None else active_mesh()
    if mesh is None:
        raise RuntimeError("pipeline_apply needs an active mesh (pass "
                           "mesh= or call it inside mesh_context(mesh))")
    S = axis_size(axis, mesh)
    M = microbatches
    B = x.shape[0]
    if B % M:
        raise ValueError(f"batch {B} not divisible by microbatches {M}")
    xs = x.reshape(M, B // M, *x.shape[1:])
    idx = axis_index(axis, mesh)
    params = tree_map(lambda leaf: _own_stage(leaf, idx, axis),
                      stage_params)
    first = torch.tensor(idx == 0, device=x.device)
    last = 1.0 if idx == S - 1 else 0.0
    perm = [(i, (i + 1) % S) for i in range(S)]

    def body(p, act):
        if remat:
            return checkpoint(stage_fn, p, act, use_reentrant=False,
                              preserve_rng_state=False)
        return stage_fn(p, act)

    state = torch.zeros_like(xs[0])
    outs = []
    for t in range(M + S - 1):
        state = torch.where(first, xs[min(t, M - 1)], state)
        y = body(params, state)
        if t >= S - 1:
            # what the last stage finishes at this tick (microbatch
            # t - (S - 1)); masked to zero on the other ranks below
            outs.append(y)
        state = xla_ppermute(y, axis, perm, mesh=mesh)
    # broadcast the finished microbatches from the last stage to every
    # pipeline rank: zeros elsewhere, summed
    out = xla_allreduce(torch.stack(outs) * last, axis, "sum", mesh=mesh)
    return out.reshape(B, *x.shape[1:])


def stack_stage_params(init_fn: Callable[[torch.Generator], Any],
                       key: Union[torch.Generator, int, None],
                       num_stages: int) -> Any:
    """Initialise S stages' parameters and stack them on a leading stage
    axis.  ``key`` is a seeded ``torch.Generator`` (each stage's
    ``init_fn`` draws from it in turn) or an int seed (a CPU generator
    seeded with it)."""
    gen = key if isinstance(key, torch.Generator) else \
        torch.Generator().manual_seed(int(key or 0))
    trees = [init_fn(gen) for _ in range(num_stages)]
    return _stack(trees)


def _stack(trees):
    head = trees[0]
    if isinstance(head, dict):
        return {k: _stack([t[k] for t in trees]) for k in head}
    if isinstance(head, list):
        return [_stack([t[i] for t in trees]) for i in range(len(head))]
    return torch.stack(trees)
