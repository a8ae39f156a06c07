"""Run/scaling configuration dataclasses.

Reference analogs: air/config.py:79 ScalingConfig, :640 RunConfig,
:452 FailureConfig, :511 CheckpointConfig.

A copy of ``ray_tpu/air/config.py`` for the port.  ``ScalingConfig``
asks for cards: ``use_gpu`` and ``num_gpus_per_worker`` (the runtime's
``"GPU"`` resource) where the reference asks for ``use_tpu`` and
``num_tpus_per_worker``; given the TPU names it raises the ValueError
that ``remote(num_tpus=...)`` raises.  ``topology`` (a slice name) and
``mesh`` (a ``parallel.MeshSpec``) are stored as the reference stores
them; ``JaxTrainer`` lays its workers' mesh by ``mesh``
(``jax_utils.get_mesh``), and nothing reads ``topology``: a TPU slice
name means nothing to a card.  FailureConfig, CheckpointConfig and
RunConfig are the reference's.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Union

@dataclasses.dataclass(init=False)
class ScalingConfig:
    """How many workers, what each gets, and how they form a mesh."""

    num_workers: int = 1
    use_gpu: bool = False
    num_cpus_per_worker: float = 1.0
    num_gpus_per_worker: float = 0.0
    resources_per_worker: Optional[Dict[str, float]] = None
    placement_strategy: str = "PACK"
    topology: Optional[str] = None
    mesh: Optional[Any] = None

    def __init__(self, num_workers: int = 1, use_gpu: bool = False,
                 num_cpus_per_worker: float = 1.0,
                 num_gpus_per_worker: float = 0.0,
                 resources_per_worker: Optional[Dict[str, float]] = None,
                 placement_strategy: str = "PACK",
                 topology: Optional[str] = None, mesh: Optional[Any] = None,
                 **kwargs):
        tpu = sorted(k for k in kwargs
                     if k in ("use_tpu", "num_tpus_per_worker"))
        if tpu:
            raise ValueError(
                f"{', '.join(tpu)}: TPUs are the JAX package's resource; "
                f"the port's accelerator resource is num_gpus (whole "
                f"cards): use_gpu / num_gpus_per_worker")
        if kwargs:
            raise TypeError(f"ScalingConfig got unexpected keyword "
                            f"arguments {sorted(kwargs)}")
        self.num_workers = num_workers
        self.use_gpu = use_gpu
        self.num_cpus_per_worker = num_cpus_per_worker
        self.num_gpus_per_worker = num_gpus_per_worker
        self.resources_per_worker = resources_per_worker
        self.placement_strategy = placement_strategy
        self.topology = topology
        self.mesh = mesh
        if self.use_gpu and not self.num_gpus_per_worker:
            self.num_gpus_per_worker = 1.0

    @property
    def _trainer_resources(self) -> Dict[str, float]:
        res: Dict[str, float] = {"CPU": float(self.num_cpus_per_worker)}
        if self.num_gpus_per_worker:
            res["GPU"] = float(self.num_gpus_per_worker)
        for k, v in (self.resources_per_worker or {}).items():
            res[k] = float(v)
        return res

    def as_placement_group_bundles(self):
        return [dict(self._trainer_resources)
                for _ in range(self.num_workers)]


@dataclasses.dataclass
class FailureConfig:
    """max_failures: -1 = unlimited restarts, 0 = fail fast (reference
    air/config.py:452)."""

    max_failures: int = 0


@dataclasses.dataclass
class CheckpointConfig:
    """Retention policy for checkpoints (reference air/config.py:511)."""

    num_to_keep: Optional[int] = None
    checkpoint_score_attribute: Optional[str] = None
    checkpoint_score_order: str = "max"
    checkpoint_frequency: int = 0
    checkpoint_at_end: bool = False

    def __post_init__(self):
        if self.checkpoint_score_order not in ("max", "min"):
            raise ValueError("checkpoint_score_order must be 'max' or 'min'")


@dataclasses.dataclass
class RunConfig:
    """Experiment-level config (reference air/config.py:640)."""

    name: Optional[str] = None
    storage_path: Optional[str] = None
    failure_config: Optional[FailureConfig] = None
    checkpoint_config: Optional[CheckpointConfig] = None
    stop: Optional[Union[Dict[str, Any], int]] = None
    verbose: int = 1
    #: tune.Callback instances fired on trial lifecycle events; when
    #: None, Tuner attaches the default CSV/JSON/TensorBoard loggers
    #: (reference air/config.py RunConfig.callbacks + DEFAULT_LOGGERS).
    callbacks: Optional[list] = None
    #: remote URI (kv:// / s3:// / mem://, via the Data filesystem seam)
    #: the experiment directory syncs to (reference: tune/syncer.py
    #: SyncConfig cloud upload).
    sync_to: Optional[str] = None
