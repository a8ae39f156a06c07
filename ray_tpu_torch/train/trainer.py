"""The train step: counterpart of ``jax_utils.build_train_step``
(``ray_tpu/train/jax_trainer.py:66``), single device, with its
telemetry.

Meshes and sharding wait for ROADMAP.md queue 1 item 7 (parallel/)
and raise NotImplementedError naming it.
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


def _copies(params, opt_state: Dict[str, Any]) -> tuple:
    """Fresh copies of params and the AdamW state, for a step that
    must leave its inputs unchanged (JAX's step without donation)."""
    return (tree_map(lambda t: t.detach().clone(), params),
            {"count": opt_state["count"],
             "mu": tree_map(torch.clone, opt_state["mu"]),
             "nu": tree_map(torch.clone, opt_state["nu"])})


def instrument_step(step: Callable, name: str, health: bool = False
                    ) -> Callable:
    """``step`` wrapped as ``jax_trainer.py:126-150`` stacks its
    observers: the program registry under ``train.step`` first, the
    step-time telemetry next, the trainwatch anatomy (with the health
    watchdog when ``health``) outside; the telemetry and trainwatch
    state are the trainer ``name``'s.  Only health mode adds a
    (deliberate) sync."""
    from ray_tpu_torch._private.device_stats import get_registry
    from ray_tpu_torch.train.goodput import (get_goodput_tracker,
                                             get_health_watchdog,
                                             instrument_trainwatch)
    from ray_tpu_torch.train.telemetry import (get_train_telemetry,
                                               instrument_train_step)

    wrapped = get_registry().instrument("train.step", step)
    wrapped = instrument_train_step(
        wrapped, telemetry=get_train_telemetry(name))
    wrapped = instrument_trainwatch(
        wrapped, tracker=get_goodput_tracker(name),
        watchdog=get_health_watchdog(name) if health else None)
    wrapped._raw_step = step
    return wrapped


def build_train_step(loss_fn: Callable, tx: AdamW, mesh=None,
                     logical_axes=None, rules=None, donate: bool = True,
                     telemetry: bool = True,
                     telemetry_name: str = "jax_trainer",
                     health: bool = False) -> Callable:
    """(params, opt_state, batch) -> (params, opt_state, loss), the
    gradient of ``loss_fn(params, batch)`` applied by ``tx``.

    donate=True (the default, as in JAX) updates ``params`` and
    ``opt_state`` in place and returns the same objects, which is what
    JAX's buffer donation amounts to; the caller must not reuse the
    old values.  donate=False copies them first.

    telemetry=True (the default, as in JAX) wraps the step with the
    program registry's ``train.step`` block, host-side step-time
    histograms, examples/sec gauges and compile-event counters
    (train/telemetry.py: perf_counter pairs, no added device sync) and
    the trainwatch anatomy/goodput recorder (train/goodput.py); read
    them back with ``train_stats(telemetry_name)``.  The wrapped step
    carries the unwrapped one as ``_raw_step``.

    health=True makes the step also return ``{"loss", "grad_norm",
    "nonfinite"}`` as device scalars (computed in the step, no host
    transfer) and, with telemetry, arms the watchdog: reading the
    scalars fences each step (one small device-to-host copy), and a
    NaN/inf or an EWMA spike journals a ``train_anomaly`` and dumps a
    flight-recorder postmortem naming the step, trainer and batch
    signature.

    ``mesh``/``logical_axes``/``rules`` (sharding) raise
    NotImplementedError naming ROADMAP.md queue 1 item 7."""
    if mesh is not None or logical_axes is not None or rules is not None:
        raise NotImplementedError(
            "mesh-sharded train steps are not ported yet: ROADMAP.md "
            "queue 1 item 7 (parallel/)")

    def step(params, opt_state: Dict[str, Any], batch):
        if not donate:
            params, opt_state = _copies(params, opt_state)
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

    if not telemetry:
        return step
    return instrument_step(step, telemetry_name, health=health)


def train_stats(name: str = "jax_trainer") -> Dict[str, Any]:
    """Step-time percentiles, compile counts and the trainwatch blocks
    recorded by ``build_train_step`` steps in this process: the
    counterpart of ``jax_utils.train_stats``."""
    from ray_tpu_torch.train.telemetry import train_stats as _stats

    return _stats(name)
