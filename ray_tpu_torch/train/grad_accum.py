"""Gradient accumulation: fit a large effective batch in bounded device
memory.  Counterpart of ``ray_tpu/train/grad_accum.py``.

Split the batch into microbatches along its leading axis, accumulate
their gradients in float32 buffers and apply ONE optimizer update with
their mean.  The JAX step runs the microbatches as a ``lax.scan``
inside one jitted program; eager PyTorch has no program to put the
loop in, so here it is a Python loop over the microbatches, each one a
forward and ``torch.autograd.grad``.  With ``jit_kwargs``'
``in_shardings`` (a NamedSharding tree for the parameters,
``parallel.sharding.param_shardings``) the step runs SPMD over their
mesh as ``build_train_step(mesh=...)`` does: each microbatch is split
over the batch's mesh axes, and the gradient buffers are DTensors on
the parameters' placements.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import torch

from ray_tpu_torch.train.optim import (tree_leaves, tree_map,
                                       tree_unflatten)
from ray_tpu_torch.train.trainer import (MeshPlan, _copies, _local,
                                         _update, instrument_step)

__all__ = ["accumulated_train_step"]


def _first_sharding(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            got = _first_sharding(v)
            if got is not None:
                return got
        return None
    return tree if hasattr(tree, "placements") else None


def _parse(jit_kwargs: Optional[dict]) -> Tuple[bool, Optional[MeshPlan]]:
    """(donate, mesh plan) of JAX's jit keywords: ``donate_argnums=(0,
    1)`` updates params and optimizer state in place; ``in_shardings``
    = (parameter NamedSharding tree, None, None) puts the step on their
    mesh (``out_shardings`` may repeat them: outputs keep the
    parameters' placements).  Other keywords raise."""
    kw = dict(jit_kwargs or {})
    donate = tuple(kw.pop("donate_argnums", ()))
    ins = kw.pop("in_shardings", None)
    kw.pop("out_shardings", None)
    if kw or donate not in ((), (0, 1)):
        bad = sorted(kw) or [f"donate_argnums={donate}"]
        raise NotImplementedError(
            f"jit_kwargs {bad} are not ported: only donate_argnums=(0, "
            f"1) (an in-place update) and in_/out_shardings are")
    plan = None
    if ins is not None:
        p_shard = ins[0] if isinstance(ins, (tuple, list)) else ins
        first = _first_sharding(p_shard)
        if first is None:
            raise ValueError("in_shardings[0] holds no NamedSharding "
                             "(parallel.sharding.param_shardings)")
        plan = MeshPlan(first.mesh, p_shard)
    return donate == (0, 1), plan


def accumulated_train_step(loss_fn: Callable, tx, *,
                           num_microbatches: int,
                           telemetry: bool = False,
                           telemetry_name: str = "grad_accum",
                           jit_kwargs=None) -> Callable:
    """Build ``step(params, opt_state, batch) -> (params, opt_state,
    loss)`` that averages gradients over ``num_microbatches`` slices of
    the leading batch axis before applying ONE optimizer update; the
    loss is the mean of the microbatch losses.

    loss_fn(params, microbatch) -> scalar loss.  Every leaf of
    ``batch`` must have a leading axis divisible by num_microbatches
    (ValueError otherwise, as in JAX).  Like JAX's step, it leaves its
    inputs unchanged unless ``jit_kwargs={"donate_argnums": (0, 1)}``
    asks for the update in place.

    telemetry=True wraps the step with the same registry + step-time +
    trainwatch stack as ``build_train_step``, under the ``train.step``
    program name; read it back via ``train_stats(telemetry_name)``."""
    n = num_microbatches
    donate, plan = _parse(jit_kwargs)

    def step(params, opt_state, batch) -> Tuple[Any, Any, torch.Tensor]:
        def split(v):
            b = v.shape[0]
            if b % n:
                raise ValueError(
                    f"batch axis {b} not divisible by "
                    f"num_microbatches={n}")
            return v.reshape(n, b // n, *v.shape[1:])

        micro = tree_map(split, batch)
        if plan is not None:
            params, opt_state = plan.place_state(params, opt_state)
        if not donate:
            params, opt_state = _copies(params, opt_state)
        leaves = tree_leaves(params)
        # f32 buffers of each rank's own blocks (gradients come back on
        # their parameters' placements)
        gsum = [torch.zeros_like(_local(p), dtype=torch.float32)
                for p in leaves]
        lsum = torch.zeros((), dtype=torch.float32,
                           device=gsum[0].device)
        for i in range(n):
            mb = tree_map(lambda v: v[i], micro)
            if plan is None:
                live = [t.detach().requires_grad_(True) for t in leaves]
                loss = loss_fn(tree_unflatten(params, live), mb)
                grads = torch.autograd.grad(loss, live)
            else:
                loss, grads = plan.value_and_grad(loss_fn, params,
                                                  plan.local_batch(mb))
            for acc, g in zip(gsum, grads):
                acc.add_(g)
            lsum += loss.detach()
        _update(tx, params, [g.div_(n) for g in gsum], opt_state)
        return params, opt_state, lsum / n

    if not telemetry:
        return step
    return instrument_step(step, telemetry_name)
