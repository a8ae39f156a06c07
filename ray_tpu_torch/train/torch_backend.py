"""Torch backend + TorchTrainer: data-parallel training on a
``torch.distributed`` process group.

Role-equivalent of the reference's Torch Train backend (reference
``train/torch/config.py:29 TorchConfig``, ``:70
_setup_torch_process_group`` = ``dist.init_process_group``; loop utils
``train/torch/train_loop_utils.py:28 prepare_model`` wrapping DDP).

A copy of ``ray_tpu/train/torch_backend.py``.  ``backend`` stays
"gloo" by default, as the reference's; pass "nccl" for workers granted
cards (``ScalingConfig(use_gpu=True)``), whose models the loop puts on
its card.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

from ray_tpu_torch.air.config import RunConfig, ScalingConfig
from ray_tpu_torch.train.backend import Backend, BackendConfig
from ray_tpu_torch.train.data_parallel_trainer import DataParallelTrainer
from ray_tpu_torch.train.jax_backend import _get_node_ip, _pick_port


@dataclasses.dataclass
class TorchConfig(BackendConfig):
    backend: str = "gloo"            # "nccl" on CUDA deployments
    init_timeout_s: float = 120.0

    @property
    def backend_cls(self):
        return TorchBackend


def _setup_torch_process_group(backend: str, init_method: str,
                               rank: int, world_size: int,
                               timeout_s: float, local_rank: int = 0,
                               local_world_size: int = 1):
    """Reference: train/torch/config.py:70 _setup_torch_process_group."""
    import datetime
    import os

    import torch.distributed as dist

    # torchrun-style env vars: accelerate/transformers detect
    # distributed mode through LOCAL_RANK/WORLD_SIZE (env-gated, NOT
    # by probing the process group), so without these a
    # HuggingFaceTrainer gang would silently train unsynchronized
    # single-process copies.  LOCAL_RANK is the rank WITHIN the node
    # (device placement / local-process-zero gating on multi-node
    # gangs), computed by the backend from worker node placement.
    os.environ["RANK"] = str(rank)
    os.environ["WORLD_SIZE"] = str(world_size)
    os.environ["LOCAL_RANK"] = str(local_rank)
    os.environ["LOCAL_WORLD_SIZE"] = str(local_world_size)
    host_port = init_method.removeprefix("tcp://")
    if ":" in host_port:
        host, _, port = host_port.rpartition(":")
        os.environ.setdefault("MASTER_ADDR", host)
        os.environ.setdefault("MASTER_PORT", port)
    if dist.is_initialized():
        return
    dist.init_process_group(
        backend=backend, init_method=init_method, rank=rank,
        world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout_s))


def _teardown_torch_process_group():
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


class TorchBackend(Backend):
    def on_start(self, worker_group, backend_config: TorchConfig) -> None:
        n = len(worker_group)
        if n <= 1:
            return
        import ray_tpu_torch

        ip = worker_group.execute_single(0, _get_node_ip)
        port = worker_group.execute_single(0, _pick_port)
        init_method = f"tcp://{ip}:{port}"
        # node-local ranks: group workers by their node ip
        ips = ray_tpu_torch.get([w.execute.remote(_get_node_ip)
                                 for w in worker_group.workers],
                                timeout=backend_config.init_timeout_s)
        seen: Dict[str, int] = {}
        local_ranks = []
        for wip in ips:
            local_ranks.append(seen.get(wip, 0))
            seen[wip] = seen.get(wip, 0) + 1
        ray_tpu_torch.get([w.execute.remote(
            _setup_torch_process_group, backend_config.backend,
            init_method, i, n, backend_config.init_timeout_s,
            local_ranks[i], seen[ips[i]])
            for i, w in enumerate(worker_group.workers)],
            timeout=backend_config.init_timeout_s + 30)

    def on_shutdown(self, worker_group, backend_config) -> None:
        try:
            worker_group.execute(_teardown_torch_process_group)
        except Exception:  # noqa: BLE001 - workers may be dead
            pass


class TorchTrainer(DataParallelTrainer):
    """DataParallelTrainer + TorchConfig (reference: TorchTrainer)."""

    _default_backend_config = TorchConfig()

    def __init__(self, train_loop_per_worker: Callable, *,
                 train_loop_config: Optional[Dict[str, Any]] = None,
                 torch_config: Optional[TorchConfig] = None,
                 scaling_config: Optional[ScalingConfig] = None,
                 run_config: Optional[RunConfig] = None,
                 datasets: Optional[Dict[str, Any]] = None,
                 resume_from_checkpoint=None):
        super().__init__(
            train_loop_per_worker,
            train_loop_config=train_loop_config,
            backend_config=torch_config or TorchConfig(),
            scaling_config=scaling_config, run_config=run_config,
            datasets=datasets,
            resume_from_checkpoint=resume_from_checkpoint)


# -- worker-side loop utils (reference: train_loop_utils.py) ---------------

def prepare_model(model):
    """Wrap in DistributedDataParallel when a process group is active
    (reference: train/torch/train_loop_utils.py:28 prepare_model)."""
    import torch.distributed as dist

    if dist.is_initialized() and dist.get_world_size() > 1:
        from torch.nn.parallel import DistributedDataParallel

        return DistributedDataParallel(model)
    return model


def prepare_data_loader(loader):
    """Shard a DataLoader across workers with a DistributedSampler
    (reference: train_loop_utils.py prepare_data_loader)."""
    import torch.distributed as dist

    if not (dist.is_initialized() and dist.get_world_size() > 1):
        return loader
    from torch.utils.data import DataLoader
    from torch.utils.data.distributed import DistributedSampler

    return DataLoader(loader.dataset, batch_size=loader.batch_size,
                      sampler=DistributedSampler(loader.dataset),
                      num_workers=0, collate_fn=loader.collate_fn,
                      drop_last=loader.drop_last)
