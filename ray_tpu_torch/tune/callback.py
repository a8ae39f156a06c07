"""User callback hooks on the tune trial lifecycle.

Reference analog: ``tune/callback.py`` ``Callback`` — the runner invokes
these at every lifecycle edge; loggers (``tune/logger.py`` here) are
implemented as callbacks, exactly as the reference's ``LoggerCallback``
family is.  Hooks never abort the experiment: the runner wraps each
invocation and logs callback errors instead of raising.

A copy of ``ray_tpu/tune/callback.py``.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, List

logger = logging.getLogger(__name__)


class Callback:
    """Base class; subclass and override any subset of hooks.

    Every hook receives the live ``Trial`` object.  ``iteration`` in
    ``on_trial_result`` is the trial's own report counter.
    """

    def setup(self, experiment_dir: str | None) -> None:
        """Called once before any trial starts."""

    def on_trial_start(self, trial) -> None:
        """Trial actor launched (also after a PBT restart / retry)."""

    def on_trial_result(self, trial, result: Dict[str, Any]) -> None:
        """A result was reported by the trial."""

    def on_checkpoint(self, trial, checkpoint: Any) -> None:
        """The trial saved a checkpoint."""

    def on_trial_error(self, trial, error: BaseException) -> None:
        """The trial crashed (may be retried per FailureConfig)."""

    def on_trial_complete(self, trial) -> None:
        """Trial reached a terminal status (TERMINATED/STOPPED/ERROR)."""

    def on_experiment_end(self, trials: List) -> None:
        """The whole run loop finished."""


class CallbackList:
    """Fan-out wrapper the runner drives; isolates callback failures."""

    def __init__(self, callbacks: List[Callback]):
        self.callbacks = list(callbacks)

    def _fire(self, hook: str, *args) -> None:
        for cb in self.callbacks:
            try:
                getattr(cb, hook)(*args)
            except Exception:  # noqa: BLE001 - callback bug != run abort
                logger.exception("tune callback %s.%s failed",
                                 type(cb).__name__, hook)

    def setup(self, experiment_dir):
        self._fire("setup", experiment_dir)

    def on_trial_start(self, trial):
        self._fire("on_trial_start", trial)

    def on_trial_result(self, trial, result):
        self._fire("on_trial_result", trial, result)

    def on_checkpoint(self, trial, checkpoint):
        self._fire("on_checkpoint", trial, checkpoint)

    def on_trial_error(self, trial, error):
        self._fire("on_trial_error", trial, error)

    def on_trial_complete(self, trial):
        self._fire("on_trial_complete", trial)

    def on_experiment_end(self, trials):
        self._fire("on_experiment_end", trials)
