"""Worker-side training session API.

User train loops call ``session.report(metrics, checkpoint=...)`` /
``session.get_checkpoint()`` / ``session.get_world_rank()`` etc.
(reference analog: air/session.py:12 report, :241 get_dataset_shard;
backed by train/_internal/session.py:58 _TrainSession).  The active
session is process-global, installed by the train worker before running
the user loop.

A copy of ``ray_tpu/air/session.py``: with no session set every call
raises the reference's RuntimeError.  ``train/_internal/session.py``'s
``_TrainSession`` installs one in a train worker (and a tune trial's
actor) while the user loop runs.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Optional

_session_lock = threading.Lock()
_active_session = None


def _set_session(s) -> None:
    global _active_session
    with _session_lock:
        _active_session = s


def _get_session():
    if _active_session is None:
        raise RuntimeError(
            "no active training session; session.* APIs are only valid "
            "inside a train loop launched by a Trainer")
    return _active_session


def report(metrics: Dict[str, Any], *, checkpoint=None) -> None:
    """Ship metrics (+ optional Checkpoint) to the trial driver; blocks
    until consumed so workers stay in lockstep with the driver loop."""
    _get_session().report(metrics, checkpoint=checkpoint)


def get_checkpoint():
    """Latest committed Checkpoint (for resume-from-failure), or None."""
    return _get_session().loaded_checkpoint


def get_dataset_shard(name: str = "train"):
    """This worker's shard of the dataset registered with the Trainer."""
    return _get_session().get_dataset_shard(name)


def get_world_size() -> int:
    return _get_session().world_size


def get_world_rank() -> int:
    return _get_session().world_rank


def get_local_rank() -> int:
    return _get_session().local_rank


def get_trial_name() -> str:
    return _get_session().trial_name


def get_trial_id() -> str:
    return _get_session().trial_id


def get_config() -> Dict[str, Any]:
    """The train_loop_config / trial config for this run."""
    return _get_session().config
