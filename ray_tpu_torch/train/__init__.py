"""Distributed training orchestration (reference analog:
python/ray/train), the counterpart of ``ray_tpu/train/``.

Stack (reference call path 3.4 in SURVEY.md): Trainer.fit → a
one-trial Tuner → training_loop → BackendExecutor → WorkerGroup of
actors → Backend process-group setup → user train_loop_per_worker with
air.session.  Beside it: the AdamW of optax, the train step and its
telemetry, gradient accumulation and checkpoints.

Importing the package imports no torch: the names of the modules that
do (the step, AdamW, telemetry, accumulation, checkpoints) load at
first use.  ``GBDTTrainer``, ``GBDTModel``, ``XGBoostTrainer``,
``LightGBMTrainer`` and ``HuggingFaceTrainer`` are not ported yet:
constructing one raises NotImplementedError naming their ROADMAP
item.
"""

import importlib

from ray_tpu_torch.air import session  # re-export: train.session.report
from ray_tpu_torch.air.checkpoint import Checkpoint
from ray_tpu_torch.air.config import (CheckpointConfig, FailureConfig,
                                      RunConfig, ScalingConfig)
from ray_tpu_torch.air.result import Result
from ray_tpu_torch.train.backend import Backend, BackendConfig
from ray_tpu_torch.train.backend_executor import (BackendExecutor,
                                                  TrainingWorkerError)
from ray_tpu_torch.train.base_trainer import BaseTrainer
from ray_tpu_torch.train.data_parallel_trainer import DataParallelTrainer
from ray_tpu_torch.train.jax_backend import JaxConfig
from ray_tpu_torch.train.jax_trainer import JaxTrainer, jax_utils
from ray_tpu_torch.train.torch_backend import (TorchConfig, TorchTrainer,
                                               prepare_data_loader,
                                               prepare_model)

#: names whose modules import torch, imported at first use: the
#: orchestration above runs in trial actors that hold no card and load
#: no torch
_LAZY = {
    "AdamW": "optim", "adamw": "optim", "build_train_step": "trainer",
    "accumulated_train_step": "grad_accum", "train_stats": "telemetry",
    "GoodputTracker": "goodput", "HealthWatchdog": "goodput",
    "get_goodput_tracker": "goodput", "get_health_watchdog": "goodput",
    "get_train_recorder": "goodput", "watch_data": "goodput",
    "worker_skew": "goodput", "save_sharded": "checkpointing",
    "restore_sharded": "checkpointing", "latest_step": "checkpointing",
    "sharded_checkpoint_to_air": "checkpointing",
}


def __getattr__(name):
    module = _LAZY.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}")
    value = getattr(importlib.import_module(f"{__name__}.{module}"), name)
    globals()[name] = value
    return value


#: the ROADMAP item the GBDT and Hugging Face trainers wait for
GBDT_HF_ITEM = ("ROADMAP.md queue 1 item 7.8b (train/gbdt_trainer.py and "
                "train/huggingface.py)")


def _not_ported(name: str) -> type:
    def __init__(self, *args, **kwargs):
        raise NotImplementedError(f"{name} is not ported yet: "
                                  f"{GBDT_HF_ITEM}")

    return type(name, (), {"__init__": __init__, "__module__": __name__})


GBDTTrainer = _not_ported("GBDTTrainer")
GBDTModel = _not_ported("GBDTModel")
XGBoostTrainer = _not_ported("XGBoostTrainer")
LightGBMTrainer = _not_ported("LightGBMTrainer")
HuggingFaceTrainer = _not_ported("HuggingFaceTrainer")

__all__ = [
    "AdamW", "adamw", "build_train_step",
    "accumulated_train_step",
    "GoodputTracker", "HealthWatchdog", "get_goodput_tracker",
    "get_health_watchdog", "get_train_recorder", "watch_data",
    "worker_skew", "train_stats",
    "save_sharded", "restore_sharded", "latest_step",
    "sharded_checkpoint_to_air",
    "session", "Checkpoint", "ScalingConfig", "RunConfig", "FailureConfig",
    "CheckpointConfig", "Result", "Backend", "BackendConfig",
    "BackendExecutor", "TrainingWorkerError", "BaseTrainer",
    "DataParallelTrainer", "JaxConfig", "JaxTrainer", "jax_utils",
    "TorchConfig", "TorchTrainer", "prepare_model", "prepare_data_loader",
    "GBDTTrainer", "GBDTModel", "XGBoostTrainer", "LightGBMTrainer",
    "HuggingFaceTrainer",
]
