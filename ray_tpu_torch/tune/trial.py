"""Trial bookkeeping (reference analog: tune/experiment/trial.py).

A copy of ``ray_tpu/tune/trial.py``.
"""

from __future__ import annotations

import dataclasses
import uuid
from typing import Any, Dict, List, Optional

PENDING = "PENDING"
RUNNING = "RUNNING"
TERMINATED = "TERMINATED"
ERROR = "ERROR"
STOPPED = "STOPPED"  # early-stopped by a scheduler
#: checkpointed + released resources, awaiting a scheduler resume
#: (HyperBand rung barriers — reference: trial PAUSED state)
PAUSED = "PAUSED"


@dataclasses.dataclass
class Trial:
    config: Dict[str, Any]
    trial_id: str = dataclasses.field(
        default_factory=lambda: uuid.uuid4().hex[:8])
    status: str = PENDING
    metrics_history: List[Dict[str, Any]] = dataclasses.field(
        default_factory=list)
    last_result: Optional[Dict[str, Any]] = None
    checkpoint: Optional[Any] = None
    #: checkpoint to restore from at (re)launch — set by experiment
    #: resume and by PBT exploitation.
    restore_checkpoint: Optional[Any] = None
    error: Optional[BaseException] = None
    iteration: int = 0
    #: per-trial artifact directory (progress.csv / result.json /
    #: tfevents) — assigned by the runner at first launch.
    logdir: Optional[str] = None
    #: crash-restart count consumed against FailureConfig.max_failures
    num_failures: int = 0

    @property
    def is_finished(self) -> bool:
        return self.status in (TERMINATED, ERROR, STOPPED)

    def best_metric(self, metric: str, mode: str = "max"):
        vals = [m[metric] for m in self.metrics_history if metric in m]
        if not vals:
            return None
        return max(vals) if mode == "max" else min(vals)
