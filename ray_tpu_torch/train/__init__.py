"""Training of the port: the AdamW of optax, the train step and its
telemetry, gradient accumulation and checkpoints."""

from ray_tpu_torch.train.checkpointing import (latest_step, restore_sharded,
                                               save_sharded,
                                               sharded_checkpoint_to_air)
from ray_tpu_torch.train.goodput import (GoodputTracker, HealthWatchdog,
                                         get_goodput_tracker,
                                         get_health_watchdog,
                                         get_train_recorder, watch_data,
                                         worker_skew)
from ray_tpu_torch.train.grad_accum import accumulated_train_step
from ray_tpu_torch.train.optim import AdamW, adamw
from ray_tpu_torch.train.telemetry import train_stats
from ray_tpu_torch.train.trainer import build_train_step

__all__ = [
    "AdamW", "adamw", "build_train_step",
    "accumulated_train_step",
    "GoodputTracker", "HealthWatchdog", "get_goodput_tracker",
    "get_health_watchdog", "get_train_recorder", "watch_data",
    "worker_skew", "train_stats",
    "save_sharded", "restore_sharded", "latest_step",
    "sharded_checkpoint_to_air",
]
