"""The train step: counterpart of ``jax_utils.build_train_step``
(``ray_tpu/train/jax_trainer.py:66``), single device.

Meshes and sharding wait for ROADMAP.md queue 1 items 6-7 (the core
runtime, parallel/); step telemetry for queue 1 item 4.  Each raises
NotImplementedError naming its item.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

import torch

from ray_tpu_torch.train.optim import (AdamW, tree_leaves, tree_map,
                                       tree_unflatten)


def _health(loss, grads) -> Dict[str, torch.Tensor]:
    """The JAX step's health scalars, on the device: loss, global grad
    norm (optax.global_norm) and the count of non-finite gradient
    elements (int32)."""
    sq = torch.stack([g.float().square().sum() for g in grads]).sum()
    nonfinite = torch.stack([(~torch.isfinite(g)).sum() for g in grads])
    return {"loss": loss, "grad_norm": sq.sqrt(),
            "nonfinite": nonfinite.sum().to(torch.int32)}


def build_train_step(loss_fn: Callable, tx: AdamW, mesh=None,
                     logical_axes=None, rules=None, donate: bool = True,
                     telemetry: bool = False,
                     health: bool = False) -> Callable:
    """(params, opt_state, batch) -> (params, opt_state, loss), the
    gradient of ``loss_fn(params, batch)`` applied by ``tx``.

    donate=True (the default, as in JAX) updates ``params`` and
    ``opt_state`` in place and returns the same objects, which is what
    JAX's buffer donation amounts to; the caller must not reuse the
    old values.  donate=False copies them first.  health=True adds a
    4th output, ``{"loss", "grad_norm", "nonfinite"}`` as device
    scalars (no host sync in the step).

    ``mesh``/``logical_axes``/``rules`` (sharding) raise
    NotImplementedError naming ROADMAP.md queue 1 items 6-7;
    ``telemetry=True`` raises naming queue 1 item 4.  Unlike JAX's,
    telemetry defaults to False here, so that the default call runs."""
    if mesh is not None or logical_axes is not None or rules is not None:
        raise NotImplementedError(
            "mesh-sharded train steps are not ported yet: ROADMAP.md "
            "queue 1 items 6-7 (core runtime, parallel/)")
    if telemetry:
        raise NotImplementedError(
            "train-step telemetry is not ported yet: ROADMAP.md queue 1 "
            "item 4 (telemetry)")

    def step(params, opt_state: Dict[str, Any], batch):
        if not donate:
            params = tree_map(lambda t: t.detach().clone(), params)
            opt_state = {"count": opt_state["count"],
                         "mu": tree_map(torch.clone, opt_state["mu"]),
                         "nu": tree_map(torch.clone, opt_state["nu"])}
        leaves = tree_leaves(params)
        live = [t.detach().requires_grad_(True) for t in leaves]
        loss = loss_fn(tree_unflatten(params, live), batch)
        grads = torch.autograd.grad(loss, live)
        loss = loss.detach()
        scalars = _health(loss, grads) if health else None
        tx.update_(params, list(grads), opt_state)
        if not health:
            return params, opt_state, loss
        return params, opt_state, loss, scalars

    return step
