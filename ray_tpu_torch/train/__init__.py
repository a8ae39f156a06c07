"""Training of the port: the AdamW of optax and the train step."""

from ray_tpu_torch.train.optim import AdamW, adamw
from ray_tpu_torch.train.trainer import build_train_step

__all__ = ["AdamW", "adamw", "build_train_step"]
