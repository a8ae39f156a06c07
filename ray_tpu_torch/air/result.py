"""Result of a training run / trial (reference analog: air/result.py).
A copy of ``ray_tpu/air/result.py``."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

from ray_tpu_torch.air.checkpoint import Checkpoint


@dataclasses.dataclass
class Result:
    metrics: Optional[Dict[str, Any]] = None
    checkpoint: Optional[Checkpoint] = None
    error: Optional[BaseException] = None
    metrics_history: Optional[List[Dict[str, Any]]] = None

    @property
    def ok(self) -> bool:
        return self.error is None
