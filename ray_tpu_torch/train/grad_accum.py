"""Gradient accumulation: fit a large effective batch in bounded device
memory.  Counterpart of ``ray_tpu/train/grad_accum.py``.

Split the batch into microbatches along its leading axis, accumulate
their gradients in float32 buffers and apply ONE optimizer update with
their mean.  The JAX step runs the microbatches as a ``lax.scan``
inside one jitted program; eager PyTorch has no program to put the
loop in, so here it is a Python loop over the microbatches, each one a
forward and ``torch.autograd.grad``.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import torch

from ray_tpu_torch.train.optim import (tree_leaves, tree_map,
                                       tree_unflatten)
from ray_tpu_torch.train.trainer import _copies, instrument_step

__all__ = ["accumulated_train_step"]


def _donates(jit_kwargs: Optional[dict]) -> bool:
    """Whether ``jit_kwargs`` asks for donation.  Of JAX's jit keywords
    only ``donate_argnums=(0, 1)`` has a meaning here (params and
    optimizer state updated in place); shardings and the rest raise."""
    kw = dict(jit_kwargs or {})
    donate = tuple(kw.pop("donate_argnums", ()))
    if kw or donate not in ((), (0, 1)):
        bad = sorted(kw) or [f"donate_argnums={donate}"]
        raise NotImplementedError(
            f"jit_kwargs {bad} are not ported yet: only "
            f"donate_argnums=(0, 1) (an in-place update) is; shardings "
            f"wait for ROADMAP.md queue 1 item 7 (parallel/)")
    return donate == (0, 1)


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
    donate = _donates(jit_kwargs)

    def step(params, opt_state, batch) -> Tuple[Any, Any, torch.Tensor]:
        def split(v):
            b = v.shape[0]
            if b % n:
                raise ValueError(
                    f"batch axis {b} not divisible by "
                    f"num_microbatches={n}")
            return v.reshape(n, b // n, *v.shape[1:])

        micro = tree_map(split, batch)
        if not donate:
            params, opt_state = _copies(params, opt_state)
        leaves = tree_leaves(params)
        gsum = [torch.zeros_like(p, dtype=torch.float32) for p in leaves]
        lsum = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
        for i in range(n):
            live = [t.detach().requires_grad_(True) for t in leaves]
            loss = loss_fn(tree_unflatten(params, live),
                           tree_map(lambda v: v[i], micro))
            for acc, g in zip(gsum, torch.autograd.grad(loss, live)):
                acc.add_(g)
            lsum += loss.detach()
        tx.update_(params, [g.div_(n) for g in gsum], opt_state)
        return params, opt_state, lsum / n

    if not telemetry:
        return step
    return instrument_step(step, telemetry_name)
