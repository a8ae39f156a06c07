"""WorkerGroup: a gang of train-worker actors.

Reference analog: train/_internal/worker_group.py:92 WorkerGroup / :17
RayTrainWorker.  Each worker is a ray_tpu_torch actor pinned to its resource
bundle; the group runs arbitrary functions on all members in parallel
(`execute`), which is how the Backend plugins do their per-worker setup.

A copy of ``ray_tpu/train/_internal/worker_group.py``.  A ``"GPU"`` in
a worker's resources becomes ``num_gpus`` (whole cards, granted
through ``CUDA_VISIBLE_DEVICES``) where the reference maps ``"TPU"`` to
``num_tpus``; a ``"TPU"`` key is passed on as ``num_tpus``, which the
port's ``remote`` refuses with its ValueError.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.train._internal.session import (_TrainSession,
                                                   TrainingResult)


class RayTrainWorker:
    """Actor hosting one training process (one rank)."""

    def __init__(self):
        self._session: Optional[_TrainSession] = None

    def execute(self, fn: Callable, *args, **kwargs):
        """Run an arbitrary function in the worker process."""
        return fn(*args, **kwargs)

    def init_session(self, *, world_rank: int, local_rank: int,
                     world_size: int, trial_name: str, trial_id: str,
                     config: Dict[str, Any],
                     dataset_shards: Dict[str, Any],
                     checkpoint) -> None:
        self._session = _TrainSession(
            world_rank=world_rank, local_rank=local_rank,
            world_size=world_size, trial_name=trial_name,
            trial_id=trial_id, config=config,
            dataset_shards=dataset_shards, checkpoint=checkpoint)

    def start_training(self, train_fn: Callable) -> None:
        assert self._session is not None, "init_session first"
        sess = self._session
        cfg = sess.config
        if _fn_wants_config(train_fn):
            self._session.start(lambda: train_fn(cfg))
        else:
            self._session.start(train_fn)

    def next_result(self) -> TrainingResult:
        assert self._session is not None
        return self._session.next_result()

    def shutdown(self) -> bool:
        return True


def _fn_wants_config(fn: Callable) -> bool:
    import inspect

    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):
        return False
    required = [p for p in sig.parameters.values()
                if p.default is p.empty and p.kind in
                (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)]
    return len(required) >= 1


class WorkerGroup:
    def __init__(self, num_workers: int,
                 resources_per_worker: Optional[Dict[str, float]] = None,
                 placement_group=None):
        self.num_workers = num_workers
        self.resources_per_worker = dict(resources_per_worker
                                         or {"CPU": 1.0})
        self.placement_group = placement_group
        res = dict(self.resources_per_worker)
        opts: Dict[str, Any] = {
            "num_cpus": res.pop("CPU", 1.0),
        }
        if "GPU" in res:
            opts["num_gpus"] = res.pop("GPU")
        if "TPU" in res:  # refused by remote(): a ValueError
            opts["num_tpus"] = res.pop("TPU")
        if res:
            opts["resources"] = res
        if placement_group is not None:
            opts["placement_group"] = placement_group
        self.workers = []
        for i in range(num_workers):
            o = dict(opts)
            if placement_group is not None:
                o["placement_group_bundle_index"] = i
            self.workers.append(
                ray_tpu_torch.remote(**o)(RayTrainWorker).remote())

    def execute_async(self, fn: Callable, *args, **kwargs) -> List:
        return [w.execute.remote(fn, *args, **kwargs) for w in self.workers]

    def execute(self, fn: Callable, *args, **kwargs) -> List[Any]:
        return ray_tpu_torch.get(self.execute_async(fn, *args, **kwargs),
                                 timeout=300)

    def execute_single(self, rank: int, fn: Callable, *args, **kwargs):
        return ray_tpu_torch.get(
            [self.workers[rank].execute.remote(fn, *args, **kwargs)],
            timeout=300)[0]

    def shutdown(self):
        try:
            ray_tpu_torch.get([w.shutdown.remote() for w in self.workers],
                              timeout=30)
        except Exception:  # noqa: BLE001 - best-effort teardown
            pass
        for w in self.workers:
            try:
                ray_tpu_torch.kill(w)
            except Exception:  # noqa: BLE001
                pass
        self.workers = []

    def __len__(self):
        return len(self.workers)
