"""BackendExecutor: owns the worker group and the training lifecycle.

Reference analog: train/_internal/backend_executor.py:42 (:93 start,
:275 start_training) — create worker gang (placement-group PACK), run
the Backend's process-group setup, install per-rank sessions, launch the
user loop, and pump results; on worker failure tear down and restart the
whole gang (SPMD meshes can't lose a member — SURVEY.md §7 "hard parts").

A copy of ``ray_tpu/train/backend_executor.py``.  ``_shard_datasets``
splits a port ``Dataset`` with its ``split`` (``data/dataset.py``).
A worker whose process died (``RayActorError``, ``WorkerCrashedError``
from its ``next_result``) raises ``TrainingWorkerError``, so the gang
restarts from the latest checkpoint as this module's docstring says;
the reference lets that error escape ``fit()``, with the rounds that
had completed.
"""

from __future__ import annotations

import logging
from typing import Any, Callable, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.air.checkpoint import Checkpoint
from ray_tpu_torch.exceptions import RayActorError, WorkerCrashedError
from ray_tpu_torch.train.backend import Backend, BackendConfig
from ray_tpu_torch.train._internal.session import TrainingResult
from ray_tpu_torch.train._internal.worker_group import WorkerGroup

logger = logging.getLogger(__name__)


class TrainingWorkerError(RuntimeError):
    pass


class BackendExecutor:
    def __init__(self, backend_config: BackendConfig, *,
                 num_workers: int = 1,
                 resources_per_worker: Optional[Dict[str, float]] = None,
                 max_restarts: int = 0,
                 placement_strategy: str = "PACK"):
        self._config = backend_config
        self._backend: Backend = backend_config.backend_cls()
        self._num_workers = num_workers
        self._resources = resources_per_worker or {"CPU": 1.0}
        self._max_restarts = max_restarts
        self._placement_strategy = placement_strategy
        self._restarts = 0
        self._pg = None
        self.worker_group: Optional[WorkerGroup] = None
        self.latest_checkpoint: Optional[Checkpoint] = None

    # -- lifecycle --------------------------------------------------------
    def start(self) -> None:
        # Gang-reserve the whole worker set atomically so two concurrent
        # trainers can't each grab half a cluster and deadlock (reference
        # backend_executor.py:137-160 _create_placement_group).
        from ray_tpu_torch.util.placement_group import (placement_group,
                                                        remove_placement_group)

        if self._pg is None and self._num_workers > 1:
            pg = placement_group(
                [dict(self._resources) for _ in range(self._num_workers)],
                strategy=self._placement_strategy)
            try:
                pg.ready(timeout=120.0)
            except Exception:
                remove_placement_group(pg)
                raise
            self._pg = pg
        self.worker_group = WorkerGroup(self._num_workers, self._resources,
                                        placement_group=self._pg)
        self._backend.on_start(self.worker_group, self._config)

    def start_training(self, train_fn: Callable,
                       config: Optional[Dict[str, Any]] = None,
                       datasets: Optional[Dict[str, Any]] = None,
                       checkpoint: Optional[Checkpoint] = None,
                       trial_name: str = "", trial_id: str = "") -> None:
        assert self.worker_group is not None, "call start() first"
        if checkpoint is not None:
            self.latest_checkpoint = checkpoint
        shards = _shard_datasets(datasets or {}, self._num_workers)
        init_refs = []
        for rank, w in enumerate(self.worker_group.workers):
            init_refs.append(w.init_session.remote(
                world_rank=rank, local_rank=rank,
                world_size=self._num_workers,
                trial_name=trial_name, trial_id=trial_id,
                config=config or {},
                dataset_shards=shards[rank],
                checkpoint=self.latest_checkpoint))
        ray_tpu_torch.get(init_refs, timeout=120)
        self._backend.on_training_start(self.worker_group, self._config)
        ray_tpu_torch.get([w.start_training.remote(train_fn)
                           for w in self.worker_group.workers], timeout=120)

    def fetch_next_result(self) -> Optional[List[TrainingResult]]:
        """One lockstep round: next_result from every worker.

        Returns per-rank results for a "report" round, or None when all
        workers finished.  Raises TrainingWorkerError on worker failure.
        """
        assert self.worker_group is not None
        try:
            results = ray_tpu_torch.get([w.next_result.remote()
                                         for w in self.worker_group.workers],
                                        timeout=600)
        except (RayActorError, WorkerCrashedError) as e:
            # a worker's process died: the gang restarts as for an error
            # its loop raised (the reference lets this escape fit())
            raise TrainingWorkerError(
                f"a train worker's process died: {e!r}") from e
        types = {r.type for r in results}
        if "error" in types:
            errs = [r.error for r in results if r.type == "error"]
            tb = getattr(errs[0], "_train_traceback", "")
            raise TrainingWorkerError(
                f"training failed on a worker: {errs[0]!r}\n{tb}") \
                from errs[0]
        if types == {"done"}:
            return None
        if "done" in types:
            raise TrainingWorkerError(
                "workers out of sync: some finished while others "
                "reported (every rank must call session.report the same "
                "number of times)")
        ckpt = next((r.checkpoint for r in results
                     if r.checkpoint is not None), None)
        if ckpt is not None:
            self.latest_checkpoint = ckpt
        return results

    def restart(self) -> None:
        """Tear down and rebuild the gang (elastic recovery; reference
        backend_executor.py:512 _restart)."""
        self._restarts += 1
        if self._restarts > self._max_restarts >= 0:
            raise TrainingWorkerError(
                f"exceeded max_restarts={self._max_restarts}")
        logger.warning("restarting worker group (attempt %d/%d)",
                       self._restarts, self._max_restarts)
        self.shutdown()
        self.start()

    def shutdown(self) -> None:
        if self.worker_group is not None:
            try:
                self._backend.on_shutdown(self.worker_group, self._config)
            except Exception:  # noqa: BLE001
                pass
            self.worker_group.shutdown()
            self.worker_group = None
        if self._pg is not None:
            from ray_tpu_torch.util.placement_group import \
                remove_placement_group

            try:
                remove_placement_group(self._pg)
            except Exception:  # noqa: BLE001
                pass
            self._pg = None


def _shard_datasets(datasets: Dict[str, Any],
                    num_workers: int) -> List[Dict[str, Any]]:
    """Split each dataset across workers.  A dataset may be: a Dataset
    (ray_tpu_torch.data) — split via .split(); a list/array — strided
    slices; or a callable(rank, world) -> shard."""
    shards: List[Dict[str, Any]] = [{} for _ in range(num_workers)]
    for name, ds in datasets.items():
        if hasattr(ds, "split"):
            parts = ds.split(num_workers)
            for r in range(num_workers):
                shards[r][name] = parts[r]
        elif callable(ds):
            for r in range(num_workers):
                shards[r][name] = ds(r, num_workers)
        elif isinstance(ds, dict):  # dict of columns: stride each array
            for r in range(num_workers):
                shards[r][name] = {k: v[r::num_workers]
                                   for k, v in ds.items()}
        else:
            for r in range(num_workers):
                shards[r][name] = ds[r::num_workers] \
                    if hasattr(ds, "__getitem__") else ds
    return shards
