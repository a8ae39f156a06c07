"""The backend of ``JaxTrainer``: counterpart of
``ray_tpu/train/jax_backend.py``, on ``torch.distributed`` and the
port's declared collective groups.

The reference has three modes; the port keeps their names:

  "jax"   — where the reference hands rank 0's host to
            ``jax.distributed.initialize`` as coordinator, every worker
            joins a ``torch.distributed`` process group at rank 0's IP
            and a free port (``tcp://`` rendezvous): NCCL when the
            workers were granted cards, gloo otherwise.
            ``jax_utils.get_mesh()`` then spans the group's ranks.  The
            port forms the group for a single worker too (world size
            1, NCCL on its card), where the reference leaves one worker
            alone: the port's mesh lies over a process group's ranks
            (``parallel/mesh.py``), and JAX's over the local devices.
  "store" — the declared group ``parallel.collective.
            init_collective_group(n, rank, group_name=...)`` over the
            runtime's object store and KV; ``allreduce_gradients``
            reduces a tensor tree through it.
  "none"  — workers are independent.

"auto" picks "jax" when the workers were granted cards and there are
more than one, else "store" for more than one worker and "none" for
one.  A worker granted a card that CUDA cannot see fails; an NCCL group
that fails to form fails: neither becomes a gloo group.  ``on_shutdown``
destroys the declared group, as the reference's does; the process
group goes with the worker's process, which the executor kills next,
as ``jax.distributed``'s state does in the reference.
``virtual_devices`` (fake host devices for JAX) has no torch
counterpart and raises ValueError.
"""

from __future__ import annotations

import dataclasses
import socket
from typing import Optional

from ray_tpu_torch.train.backend import Backend, BackendConfig

_MODES = ("auto", "jax", "store", "none")
#: the longest a worker waits for the others at the rendezvous, as
#: the reference's BackendExecutor waits for its gang (120 s)
_INIT_TIMEOUT_S = 120.0


@dataclasses.dataclass
class JaxConfig(BackendConfig):
    distributed: str = "auto"           # "auto"|"jax"|"store"|"none"
    coordinator_port: int = 0           # 0 = pick a free port
    virtual_devices: Optional[int] = None
    group_name: str = "train"

    def __post_init__(self):
        if self.distributed not in _MODES:
            raise ValueError(f"JaxConfig(distributed={self.distributed!r}): "
                             f"expected one of {_MODES}")
        if self.virtual_devices:
            raise ValueError(
                "JaxConfig(virtual_devices=...) asks JAX for fake host "
                "devices, which torch has no counterpart of; test several "
                "ranks with workers on gloo (distributed='jax' without "
                "cards) instead")

    @property
    def backend_cls(self):
        return JaxBackend


def _pick_port() -> int:
    with socket.socket() as s:
        s.bind(("", 0))
        return s.getsockname()[1]


def _get_node_ip() -> str:
    try:
        return socket.gethostbyname(socket.gethostname())
    except OSError:  # a host whose name does not resolve
        return "127.0.0.1"


def _setup_process_group(backend: str, init_method: str, world_size: int,
                         rank: int) -> None:
    """Join the workers' process group (this process's default one)."""
    import datetime
    import os

    import torch
    import torch.distributed as dist

    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"JaxConfig(distributed='jax'): this worker was granted a "
                f"card but CUDA sees none (CUDA_VISIBLE_DEVICES="
                f"{os.environ.get('CUDA_VISIBLE_DEVICES')!r})")
        torch.cuda.set_device(0)
    if not dist.is_initialized():
        dist.init_process_group(
            backend, init_method=init_method, rank=rank,
            world_size=world_size,
            timeout=datetime.timedelta(seconds=_INIT_TIMEOUT_S))


def _setup_store_group(world_size: int, rank: int, group_name: str):
    from ray_tpu_torch.parallel import collective

    collective.init_collective_group(world_size, rank,
                                     group_name=group_name)


def _teardown(group_name: str) -> None:
    from ray_tpu_torch.parallel import collective

    if collective.is_group_initialized(group_name):
        collective.destroy_collective_group(group_name)


class JaxBackend(Backend):
    def on_start(self, worker_group, backend_config: JaxConfig) -> None:
        import ray_tpu_torch

        cfg = backend_config
        n = len(worker_group)
        # decide by what THESE workers were granted, not cluster totals
        cards = getattr(worker_group, "resources_per_worker",
                        {}).get("GPU", 0)
        mode = cfg.distributed
        if mode == "auto":
            mode = "jax" if cards and n > 1 else \
                ("store" if n > 1 else "none")
        self.mode = mode

        if mode == "jax":
            ip = worker_group.execute_single(0, _get_node_ip)
            port = cfg.coordinator_port or \
                worker_group.execute_single(0, _pick_port)
            backend = "nccl" if cards else "gloo"
            ray_tpu_torch.get(
                [w.execute.remote(_setup_process_group, backend,
                                  f"tcp://{ip}:{port}", n, i)
                 for i, w in enumerate(worker_group.workers)],
                timeout=_INIT_TIMEOUT_S + 30)
        elif mode == "store" and n > 1:
            ray_tpu_torch.get([w.execute.remote(_setup_store_group, n, i,
                                                cfg.group_name)
                               for i, w in enumerate(worker_group.workers)],
                              timeout=_INIT_TIMEOUT_S)

    def on_shutdown(self, worker_group, backend_config: JaxConfig) -> None:
        try:
            worker_group.execute(_teardown, backend_config.group_name)
        except Exception:  # noqa: BLE001 - workers may be dead
            pass


def allreduce_gradients(grads, *, op: str = "mean",
                        group_name: str = "train"):
    """Allreduce a gradient tree (nested dicts and lists of tensors)
    across the train worker group (store mode); each reduced tensor
    comes back on its own tensor's device.  Under "jax" mode, use the
    mesh step (``jax_utils.build_train_step(mesh=...)``) instead — this
    helper is the path for workers without a process group."""
    from ray_tpu_torch.parallel import collective
    from ray_tpu_torch.train.optim import tree_leaves, tree_unflatten

    reduced = [collective.allreduce(leaf, op=op, group_name=group_name)
               for leaf in tree_leaves(grads)]
    return tree_unflatten(grads, reduced)
