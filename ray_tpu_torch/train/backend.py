"""Backend plugin interface (reference analog: train/_internal/backend.py
Backend/BackendConfig — per-framework process-group setup hooks).

A copy of ``ray_tpu/train/backend.py``.
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING

if TYPE_CHECKING:
    from ray_tpu_torch.train._internal.worker_group import WorkerGroup


@dataclasses.dataclass
class BackendConfig:
    @property
    def backend_cls(self):
        return Backend


class Backend:
    """Hooks called by BackendExecutor around the worker group's life."""

    def on_start(self, worker_group: "WorkerGroup",
                 backend_config: BackendConfig) -> None:
        pass

    def on_training_start(self, worker_group: "WorkerGroup",
                          backend_config: BackendConfig) -> None:
        pass

    def on_shutdown(self, worker_group: "WorkerGroup",
                    backend_config: BackendConfig) -> None:
        pass
