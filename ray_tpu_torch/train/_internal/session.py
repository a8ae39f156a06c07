"""Worker-side train session: runs the user loop in a thread and hands
results to the driver one report at a time.

Reference analog: train/_internal/session.py:58 _TrainSession (:295
report) — same rendezvous semantics (report blocks until the driver
consumes the result) so workers and driver advance in lockstep.

A copy of ``ray_tpu/train/_internal/session.py``.  ``report`` moves
CUDA tensors among the metrics to the host (``air.checkpoint._to_host``)
before they leave the worker, as a JAX device array pickles as its host
value: the trial actor that reads them holds no card.  A checkpoint
given as a dict goes through ``Checkpoint.from_dict``, which does the
same.
"""

from __future__ import annotations

import queue
import threading
import traceback
from typing import Any, Callable, Dict, Optional

from ray_tpu_torch.air import session as air_session
from ray_tpu_torch.air.checkpoint import Checkpoint, _to_host


class TrainingResult:
    __slots__ = ("type", "metrics", "checkpoint", "error")

    def __init__(self, type: str, metrics=None, checkpoint=None, error=None):
        self.type = type            # "report" | "done" | "error"
        self.metrics = metrics
        self.checkpoint = checkpoint
        self.error = error


class _TrainSession:
    def __init__(self, *, world_rank: int, local_rank: int, world_size: int,
                 trial_name: str = "", trial_id: str = "",
                 config: Optional[Dict[str, Any]] = None,
                 dataset_shards: Optional[Dict[str, Any]] = None,
                 checkpoint: Optional[Checkpoint] = None):
        self.world_rank = world_rank
        self.local_rank = local_rank
        self.world_size = world_size
        self.trial_name = trial_name
        self.trial_id = trial_id
        self.config = config or {}
        self.dataset_shards = dataset_shards or {}
        self.loaded_checkpoint = checkpoint
        self._result_q: "queue.Queue[TrainingResult]" = queue.Queue(maxsize=1)
        self._continue = threading.Semaphore(0)
        self._thread: Optional[threading.Thread] = None
        self.finished = False

    # -- called from the user loop thread ---------------------------------
    def report(self, metrics: Dict[str, Any], *, checkpoint=None) -> None:
        if checkpoint is not None and not isinstance(checkpoint, Checkpoint):
            checkpoint = Checkpoint.from_dict(checkpoint)
        self._result_q.put(TrainingResult("report",
                                          metrics=_to_host(dict(metrics)),
                                          checkpoint=checkpoint))
        self._continue.acquire()  # block until driver consumed it

    def get_dataset_shard(self, name: str):
        if name not in self.dataset_shards:
            raise KeyError(
                f"no dataset {name!r} registered with the trainer "
                f"(have {sorted(self.dataset_shards)})")
        return self.dataset_shards[name]

    # -- called from the actor (driver-facing) ----------------------------
    def start(self, train_fn: Callable[[], Any]) -> None:
        def runner():
            air_session._set_session(self)
            try:
                train_fn()
                self._result_q.put(TrainingResult("done"))
            except BaseException as e:  # noqa: BLE001 - forwarded to driver
                tb = traceback.format_exc()
                e._train_traceback = tb  # type: ignore[attr-defined]
                self._result_q.put(TrainingResult("error", error=e))
            finally:
                air_session._set_session(None)

        self._thread = threading.Thread(target=runner, daemon=True,
                                        name="train_loop")
        self._thread.start()

    def next_result(self, timeout: Optional[float] = None) -> TrainingResult:
        res = self._result_q.get(timeout=timeout)
        if res.type == "report":
            self._continue.release()
        else:
            self.finished = True
        return res
