"""The train step: counterpart of ``jax_utils.build_train_step``
(``ray_tpu/train/jax_trainer.py:66``), with its telemetry.

On one device the step is eager autograd and an in-place AdamW.  With a
``mesh`` (``parallel.make_mesh`` over the ranks of a process group) it
is the same step run SPMD by every rank, as JAX's GSPMD program is:

* parameters and AdamW moments are DTensors placed by the logical-axis
  rules (``parallel.shard_params``; plain tensors are placed on the
  first call);
* each rank takes its rows of the global batch, split over the mesh
  axes the rules give "batch" (data, fsdp);
* the loss function sees plain local tensors: every parameter gathered
  but for the expert dim (``sharding.gather_block``), so the kernels
  launch as they do on one device;
* the local loss divided by the world size is differentiated, and the
  gathered parameters' gradients come back summed onto their own
  placements (reduce-scattered onto fsdp shards, all-reduced where
  replicated): with equal shards that is the gradient of the global
  mean loss, JAX's;
* AdamW updates each rank's shards in place; the returned loss is the
  mean of the ranks' losses.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ray_tpu_torch.train.optim import (AdamW, tree_leaves, tree_map,
                                       tree_unflatten)


def _is_dtensor(t) -> bool:
    return type(t).__name__ == "DTensor"


def _local(t):
    """A DTensor's local block (shares its storage), else ``t``."""
    return t.to_local() if _is_dtensor(t) else t


def _whole_sum(x, p):
    """``x``, a sum over the local block of DTensor ``p``'s gradient,
    summed over the ranks holding its other blocks (its Shard axes; a
    replicated block is counted once)."""
    if not _is_dtensor(p):
        return x
    from ray_tpu_torch.parallel.collective import xla_allreduce

    mesh = p.device_mesh
    axes = tuple(name for name, pl in zip(mesh.mesh_dim_names, p.placements)
                 if pl.is_shard())
    return xla_allreduce(x, axes, mesh=mesh) if axes else x


def _health(loss, grads, params) -> Dict[str, torch.Tensor]:
    """The JAX step's health scalars, on the device: loss, global grad
    norm (optax.global_norm) and the count of non-finite gradient
    elements (int32); under a mesh ``grads`` are the local blocks of
    DTensor ``params``, summed over the ranks."""
    sq = torch.stack([_whole_sum(g.float().square().sum(), p)
                      for g, p in zip(grads, params)]).sum()
    nonfinite = torch.stack([_whole_sum((~torch.isfinite(g)).sum(), p)
                             for g, p in zip(grads, params)])
    return {"loss": loss, "grad_norm": sq.sqrt(),
            "nonfinite": nonfinite.sum().to(torch.int32)}


class MeshPlan:
    """What a train step does under a mesh: place the state, take this
    rank's rows of the batch, differentiate the local loss through
    gathered parameters, and update the local shards (see the module's
    docstring).  ``shardings`` is a NamedSharding tree for the
    parameters (``parallel.sharding.param_shardings``), or None to
    replicate them."""

    def __init__(self, mesh, shardings=None, rules=None):
        from ray_tpu_torch.parallel.mesh import mesh_shape
        from ray_tpu_torch.parallel.sharding import DEFAULT_RULES, split_axes

        if not hasattr(mesh, "mesh_dim_names") or not hasattr(
                mesh, "get_group"):
            raise TypeError(f"mesh must be a DeviceMesh "
                            f"(parallel.make_mesh), got {type(mesh)!r}")
        self.mesh = mesh
        self.shardings = shardings
        self.rules = rules or DEFAULT_RULES
        sizes = mesh_shape(mesh)
        self.world = 1
        for n in sizes.values():
            self.world *= n
        self.batch_axes = split_axes("batch", mesh, self.rules)
        self.keep = split_axes("expert", mesh, self.rules)
        self.axes = tuple(a for a in sizes if sizes[a] > 1)

    def place(self, tree):
        """``tree`` as DTensors: its DTensor leaves as they are, plain
        leaves placed by the shardings (replicated without)."""
        from ray_tpu_torch.parallel.sharding import (NamedSharding,
                                                     PartitionSpec,
                                                     distribute)

        def one(t, sh):
            if _is_dtensor(t):
                return t
            return distribute(t, sh or NamedSharding(self.mesh,
                                                     PartitionSpec()))

        def walk(node, sh):
            if isinstance(node, dict):
                return {k: walk(node[k], sh[k] if isinstance(sh, dict)
                                else None) for k in node}
            if isinstance(node, list):
                return [walk(v, sh[i] if isinstance(sh, list) else None)
                        for i, v in enumerate(node)]
            return one(node, sh)

        return walk(tree, self.shardings)

    def place_state(self, params, opt_state):
        if all(_is_dtensor(t) for t in tree_leaves(params)) and all(
                _is_dtensor(t) for t in tree_leaves(opt_state["mu"])):
            return params, opt_state
        return self.place(params), {"count": opt_state["count"],
                                    "mu": self.place(opt_state["mu"]),
                                    "nu": self.place(opt_state["nu"])}

    def local_batch(self, batch):
        """This rank's rows of the global batch: dim 0 split evenly over
        the batch axes, in mesh order.  A DTensor leaf (a sharded Data
        batch, ``iter_torch_batches(sharding=...)``) is this rank's
        block already: its local tensor."""
        from ray_tpu_torch.parallel.collective import axis_size, flat_index

        n = axis_size(self.batch_axes, self.mesh)
        i = flat_index(self.batch_axes, self.mesh)

        def rows(v):
            if _is_dtensor(v):
                return v.to_local()
            if n == 1:
                return v
            b = v.shape[0]
            if b % n:
                raise ValueError(f"batch axis {b} not divisible by the "
                                 f"{n} ranks of mesh axes "
                                 f"{self.batch_axes}")
            return v[i * (b // n):(i + 1) * (b // n)]

        return tree_map(rows, batch)

    def value_and_grad(self, loss_fn, params, batch) -> Tuple:
        """(mean loss over the ranks, the gradient of each parameter's
        local block): ``params`` a tree of DTensors, ``batch`` this
        rank's rows."""
        from ray_tpu_torch.parallel.collective import xla_allreduce
        from ray_tpu_torch.parallel.mesh import mesh_context
        from ray_tpu_torch.parallel.sharding import gather_block

        placed = tree_leaves(params)
        live = [p.to_local().detach().requires_grad_(True) for p in placed]
        with mesh_context(self.mesh):
            full = [gather_block(t, p.placements, self.mesh, self.keep)
                    for t, p in zip(live, placed)]
            loss = loss_fn(tree_unflatten(params, full), batch)
        scaled = loss / self.world if self.world > 1 else loss
        grads = torch.autograd.grad(scaled, live)
        loss = loss.detach()
        if self.axes:
            loss = xla_allreduce(loss, self.axes, "mean", mesh=self.mesh)
        return loss, grads


def _update(tx: AdamW, params, grads, opt_state) -> None:
    """AdamW in place; on DTensors, on their local blocks (which share
    their storage): every leaf's update is elementwise, so each rank's
    shards update as the whole tensors would."""
    if not any(_is_dtensor(t) for t in tree_leaves(params)):
        tx.update_(params, grads, opt_state)
        return
    local = {"count": opt_state["count"],
             "mu": tree_map(_local, opt_state["mu"]),
             "nu": tree_map(_local, opt_state["nu"])}
    tx.update_(tree_map(_local, params), [_local(g) for g in grads], local)
    opt_state["count"] = local["count"]


def mesh_plan(mesh, logical_axes=None, rules=None) -> Optional[MeshPlan]:
    """The MeshPlan of ``build_train_step``'s keywords, None without a
    mesh (``logical_axes`` without one is ignored, as JAX ignores
    shardings without a mesh)."""
    if mesh is None:
        return None
    from ray_tpu_torch.parallel.sharding import (DEFAULT_RULES,
                                                 param_shardings)

    shardings = (param_shardings(logical_axes, mesh, rules or DEFAULT_RULES)
                 if logical_axes is not None else None)
    return MeshPlan(mesh, shardings, rules)


def _clone(t):
    """A copy of ``t``; of a DTensor, a DTensor over a copy of its local
    block (a DTensor op would run the slow sharding propagation)."""
    if not _is_dtensor(t):
        return t.detach().clone()
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(t.to_local().detach().clone(), t.device_mesh,
                              t.placements, run_check=False, shape=t.shape,
                              stride=t.stride())


def _copies(params, opt_state: Dict[str, Any]) -> tuple:
    """Fresh copies of params and the AdamW state, for a step that
    must leave its inputs unchanged (JAX's step without donation)."""
    return (tree_map(_clone, params),
            {"count": opt_state["count"],
             "mu": tree_map(_clone, opt_state["mu"]),
             "nu": tree_map(_clone, opt_state["nu"])})


def instrument_step(step: Callable, name: str, health: bool = False,
                    n_devices: int = 1) -> Callable:
    """``step`` wrapped as ``jax_trainer.py:126-150`` stacks its
    observers: the program registry under ``train.step`` first, the
    step-time telemetry next, the trainwatch anatomy (with the health
    watchdog when ``health``) outside; the telemetry and trainwatch
    state are the trainer ``name``'s; the registry records the step's
    ``n_devices`` (a mesh's size).  Only health mode adds a
    (deliberate) sync."""
    from ray_tpu_torch._private.device_stats import get_registry
    from ray_tpu_torch.train.goodput import (get_goodput_tracker,
                                             get_health_watchdog,
                                             instrument_trainwatch)
    from ray_tpu_torch.train.telemetry import (get_train_telemetry,
                                               instrument_train_step)

    wrapped = get_registry().instrument("train.step", step,
                                        n_devices=n_devices)
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

    ``mesh`` (a DeviceMesh, ``parallel.make_mesh``), with the
    parameters' ``logical_axes`` and the ``rules`` that place them
    (default ``DEFAULT_RULES``), makes the step SPMD over the mesh's
    ranks (module docstring): every rank calls it with the same global
    batch, and params and opt_state come back as DTensors.  The loss
    function should read the same rules (GPT-2's MoE block splits its
    routing over the "batch" axes)."""
    plan = mesh_plan(mesh, logical_axes, rules)

    def step(params, opt_state: Dict[str, Any], batch):
        if plan is not None:
            params, opt_state = plan.place_state(params, opt_state)
        if not donate:
            params, opt_state = _copies(params, opt_state)
        if plan is None:
            live = [t.detach().requires_grad_(True)
                    for t in tree_leaves(params)]
            loss = loss_fn(tree_unflatten(params, live), batch)
            grads = torch.autograd.grad(loss, live)
            loss = loss.detach()
        else:
            loss, grads = plan.value_and_grad(loss_fn, params,
                                              plan.local_batch(batch))
        scalars = _health(loss, grads, tree_leaves(params)) if health \
            else None
        _update(tx, params, list(grads), opt_state)
        if not health:
            return params, opt_state, loss
        return params, opt_state, loss, scalars

    if not telemetry:
        return step
    return instrument_step(step, telemetry_name, health=health,
                           n_devices=plan.world if plan is not None else 1)


def train_stats(name: str = "jax_trainer") -> Dict[str, Any]:
    """Step-time percentiles, compile counts and the trainwatch blocks
    recorded by ``build_train_step`` steps in this process: the
    counterpart of ``jax_utils.train_stats``."""
    from ray_tpu_torch.train.telemetry import train_stats as _stats

    return _stats(name)
