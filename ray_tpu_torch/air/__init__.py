"""Shared ML plumbing (reference analog: python/ray/air/).

The port's counterpart of ``ray_tpu/air/``: `Checkpoint` (dict ⇄
directory ⇄ object-store interconvertible artifact, torch tensors on
the host), `session` (worker-side report/context API), `BatchPredictor`
over a Dataset on an actor pool, and the config dataclasses consumed by
Train/Tune (`ScalingConfig` with cards, `RunConfig`, `FailureConfig`,
`CheckpointConfig`).  Importing it imports neither torch, pyarrow nor
pandas.
"""

from ray_tpu_torch.air.batch_predictor import BatchPredictor, Predictor
from ray_tpu_torch.air.checkpoint import Checkpoint
from ray_tpu_torch.air.config import (CheckpointConfig, FailureConfig,
                                      RunConfig, ScalingConfig)
from ray_tpu_torch.air.result import Result
from ray_tpu_torch.air import session

__all__ = ["Checkpoint", "BatchPredictor", "Predictor", "ScalingConfig",
           "RunConfig", "FailureConfig", "CheckpointConfig", "Result",
           "session"]
