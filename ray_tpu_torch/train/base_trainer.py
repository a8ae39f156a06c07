"""BaseTrainer (reference analog: train/base_trainer.py:38; its fit()
at :338 routes through a single-trial Tuner — ours does the same once
ray_tpu_torch.tune is present, falling back to direct execution).

A copy of ``ray_tpu/train/base_trainer.py``.
"""

from __future__ import annotations

import abc
from typing import Any, Dict, Optional

from ray_tpu_torch.air.config import RunConfig, ScalingConfig
from ray_tpu_torch.air.result import Result


class BaseTrainer(abc.ABC):
    def __init__(self, *, scaling_config: Optional[ScalingConfig] = None,
                 run_config: Optional[RunConfig] = None,
                 datasets: Optional[Dict[str, Any]] = None,
                 resume_from_checkpoint=None):
        self.scaling_config = scaling_config or ScalingConfig()
        self.run_config = run_config or RunConfig()
        self.datasets = datasets or {}
        self.resume_from_checkpoint = resume_from_checkpoint

    @abc.abstractmethod
    def training_loop(self) -> Result:
        """Run the training; called inside the trial."""

    def fit(self) -> Result:
        """Run to completion as a one-trial tune experiment (reference
        base_trainer.py:338,353: fit() routes through a Tuner)."""
        from ray_tpu_torch.tune.trainable_adapter import fit_via_tune

        return fit_via_tune(self)

    def as_trainable(self):
        """Wrap as a tune function-trainable (reference
        base_trainer.py:405 TrainTrainable)."""
        trainer = self

        def train_func(config):
            t = trainer
            if config:
                import copy

                t = copy.copy(trainer)
                t._apply_trial_config(config)
            result = t.training_loop()
            return result

        train_func.__name__ = type(self).__name__
        return train_func

    def _apply_trial_config(self, config: Dict[str, Any]) -> None:
        """Tune param overrides; subclasses merge into their loop config."""
