"""DataParallelTrainer (reference analog:
train/data_parallel_trainer.py:51, training_loop :324): run one
train_loop_per_worker function on N ranks via BackendExecutor, pump
reported results, keep the latest checkpoint, restart the gang on worker
failure up to FailureConfig.max_failures.

A copy of ``ray_tpu/train/data_parallel_trainer.py``.
"""

from __future__ import annotations

import logging
import uuid
from typing import Any, Callable, Dict, Optional

from ray_tpu_torch.air.checkpoint import Checkpoint
from ray_tpu_torch.air.config import FailureConfig, RunConfig, ScalingConfig
from ray_tpu_torch.air.result import Result
from ray_tpu_torch.train.backend import BackendConfig
from ray_tpu_torch.train.backend_executor import (BackendExecutor,
                                                  TrainingWorkerError)
from ray_tpu_torch.train.base_trainer import BaseTrainer

logger = logging.getLogger(__name__)


class DataParallelTrainer(BaseTrainer):
    _default_backend_config: BackendConfig = BackendConfig()

    def __init__(self, train_loop_per_worker: Callable, *,
                 train_loop_config: Optional[Dict[str, Any]] = None,
                 backend_config: Optional[BackendConfig] = None,
                 scaling_config: Optional[ScalingConfig] = None,
                 run_config: Optional[RunConfig] = None,
                 datasets: Optional[Dict[str, Any]] = None,
                 resume_from_checkpoint=None):
        super().__init__(scaling_config=scaling_config,
                         run_config=run_config, datasets=datasets,
                         resume_from_checkpoint=resume_from_checkpoint)
        self.train_loop_per_worker = train_loop_per_worker
        self.train_loop_config = dict(train_loop_config or {})
        self.backend_config = backend_config or \
            type(self)._default_backend_config

    def _apply_trial_config(self, config: Dict[str, Any]) -> None:
        merged = dict(self.train_loop_config)
        merged.update(config)
        self.train_loop_config = merged

    def training_loop(self) -> Result:
        sc = self.scaling_config
        fc = (self.run_config.failure_config or FailureConfig())
        executor = BackendExecutor(
            self.backend_config,
            num_workers=sc.num_workers,
            resources_per_worker=sc._trainer_resources,
            max_restarts=fc.max_failures,
            placement_strategy=sc.placement_strategy)
        trial_id = uuid.uuid4().hex[:8]
        trial_name = self.run_config.name or \
            f"{type(self).__name__}_{trial_id}"

        history = []
        final_error: Optional[BaseException] = None
        checkpoint = self.resume_from_checkpoint
        executor.start()
        try:
            while True:
                try:
                    executor.start_training(
                        self.train_loop_per_worker,
                        config=self.train_loop_config,
                        datasets=self.datasets,
                        checkpoint=checkpoint,
                        trial_name=trial_name, trial_id=trial_id)
                    while True:
                        round_results = executor.fetch_next_result()
                        if round_results is None:
                            break
                        metrics = dict(round_results[0].metrics or {})
                        metrics["_round"] = len(history)
                        history.append(metrics)
                    break  # clean finish
                except TrainingWorkerError as e:
                    if fc.max_failures == 0:
                        final_error = e
                        break
                    checkpoint = executor.latest_checkpoint
                    try:
                        executor.restart()
                    except TrainingWorkerError as e2:
                        final_error = e2
                        break
        finally:
            latest = executor.latest_checkpoint
            executor.shutdown()

        return Result(metrics=history[-1] if history else None,
                      checkpoint=latest, error=final_error,
                      metrics_history=history)
