"""JaxTrainer — the flagship trainer: counterpart of
``ray_tpu/train/jax_trainer.py``, keeping its names.

DataParallelTrainer + JaxConfig, plus worker-side helpers that set up
the mesh and the sharded step where the reference's ``prepare_model``
wraps DDP:

    def loop(cfg):
        mesh = jax_utils.get_mesh()                # over the worker group
        params = jax_utils.shard_pytree(params, axes, mesh)
        step = jax_utils.build_train_step(loss_fn, tx, mesh, axes)
        ...
        session.report({"loss": l}, checkpoint=...)

``get_mesh`` lays ``parallel.make_mesh`` over the default process group,
which ``JaxConfig(distributed="jax")`` forms over the workers.  Where
there is none (modes "store" and "none", or a process outside a
trainer) it first forms a world-1 group over this process alone, NCCL
when it holds a card and gloo otherwise: the counterpart of the
reference's mesh over a worker's local devices.  A
``ScalingConfig(mesh=MeshSpec(...))`` is the spec ``get_mesh()`` lays
when its caller gives none.  ``build_train_step`` is
``train/trainer.py``'s, the counterpart of the reference's.
"""

from __future__ import annotations

import contextvars
from typing import Any, Callable, Dict, Optional

from ray_tpu_torch.air.config import RunConfig, ScalingConfig
from ray_tpu_torch.train.data_parallel_trainer import DataParallelTrainer
from ray_tpu_torch.train.jax_backend import JaxConfig


class JaxTrainer(DataParallelTrainer):
    _default_backend_config = JaxConfig()

    def __init__(self, train_loop_per_worker: Callable, *,
                 train_loop_config: Optional[Dict[str, Any]] = None,
                 jax_config: Optional[JaxConfig] = None,
                 scaling_config: Optional[ScalingConfig] = None,
                 run_config: Optional[RunConfig] = None,
                 datasets: Optional[Dict[str, Any]] = None,
                 resume_from_checkpoint=None):
        super().__init__(
            train_loop_per_worker,
            train_loop_config=train_loop_config,
            backend_config=jax_config or JaxConfig(),
            scaling_config=scaling_config, run_config=run_config,
            datasets=datasets,
            resume_from_checkpoint=resume_from_checkpoint)
        if self.scaling_config.mesh is not None:
            self.train_loop_per_worker = _WithMeshSpec(
                self.train_loop_per_worker, self.scaling_config.mesh)


#: the ScalingConfig's MeshSpec in a worker's train loop
_MESH_SPEC: contextvars.ContextVar = contextvars.ContextVar(
    "ray_tpu_torch_trainer_mesh_spec", default=None)


class _WithMeshSpec:
    """A train loop run with the trainer's MeshSpec as ``get_mesh``'s
    default (set in the loop's own thread)."""

    def __init__(self, loop: Callable, spec):
        from ray_tpu_torch.train._internal.worker_group import (
            _fn_wants_config)

        self.loop, self.spec = loop, spec
        self.wants_config = _fn_wants_config(loop)

    def __call__(self, config):
        _MESH_SPEC.set(self.spec)
        return self.loop(config) if self.wants_config else self.loop()


def _local_group() -> None:
    """A world-1 process group over this process when none exists."""
    import torch
    import torch.distributed as dist

    from ray_tpu_torch.train.jax_backend import (_pick_port,
                                                 _setup_process_group)

    if dist.is_initialized():
        return
    backend = "nccl" if torch.cuda.is_available() else "gloo"
    _setup_process_group(backend, f"tcp://127.0.0.1:{_pick_port()}", 1, 0)


class jax_utils:
    """Worker-side helpers (importable functions grouped for discovery)."""

    @staticmethod
    def get_mesh(spec=None):
        """Mesh over the worker group's process group ("jax" mode), or
        over this process alone (see the module's docstring); ``spec``
        defaults to the trainer's ``ScalingConfig(mesh=...)``."""
        from ray_tpu_torch.parallel import make_mesh

        _local_group()
        return make_mesh(spec if spec is not None else _MESH_SPEC.get())

    @staticmethod
    def shard_pytree(tree, logical_axes, mesh, rules=None):
        from ray_tpu_torch.parallel import sharding

        return sharding.shard_params(
            tree, logical_axes, mesh,
            rules=rules or sharding.DEFAULT_RULES)

    @staticmethod
    def build_train_step(loss_fn, tx, mesh=None, logical_axes=None,
                         rules=None, donate: bool = True,
                         telemetry: bool = True,
                         telemetry_name: str = "jax_trainer",
                         health: bool = False):
        """(params, opt_state, batch) -> (params, opt_state, loss), SPMD
        over ``mesh`` when given: ``train/trainer.py``
        ``build_train_step`` (its docstring has the telemetry, health
        and mesh semantics); read the telemetry back with
        ``jax_utils.train_stats(telemetry_name)``."""
        from ray_tpu_torch.train.trainer import build_train_step

        return build_train_step(loss_fn, tx, mesh=mesh,
                                logical_axes=logical_axes, rules=rules,
                                donate=donate, telemetry=telemetry,
                                telemetry_name=telemetry_name,
                                health=health)

    @staticmethod
    def train_stats(name: str = "jax_trainer"):
        """Step-time percentiles / compile counts recorded by
        ``build_train_step`` steps in THIS process (workers call it
        inside the loop and ``session.report`` it up)."""
        from ray_tpu_torch.train.telemetry import train_stats

        return train_stats(name)

    @staticmethod
    def allreduce_gradients(grads, op: str = "mean",
                            group_name: str = "train"):
        from ray_tpu_torch.train.jax_backend import allreduce_gradients

        return allreduce_gradients(grads, op=op, group_name=group_name)
