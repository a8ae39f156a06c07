"""TrialRunner: the tune event loop.

Reference analog: tune/execution/trial_runner.py:236 TrialRunner (:867
step).  Each trial runs its function-trainable inside a RayTrainWorker
actor (the same session machinery Train uses — reference function
trainables share this shape via function_runner.py).  The runner keeps up
to ``max_concurrent`` trials in flight, pumps one result at a time per
trial via next_result, applies scheduler decisions (ASHA early stop), and
records checkpoints.

A copy of ``ray_tpu/tune/trial_runner.py``.  A trial's ``"GPU"``
resource becomes the actor's ``num_gpus`` (whole cards) where the
reference maps ``"TPU"`` to ``num_tpus``; a ``"TPU"`` key is passed on as
``num_tpus``, which the port's ``remote`` refuses with its ValueError.
Experiment state pickles through the vendored cloudpickle.  The
default ``max_concurrent`` counts CPUs only, as the reference's does:
trials that each ask for a card need ``max_concurrent_trials``.
"""

from __future__ import annotations

import logging
import os
from typing import Any, Callable, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.tune import trial as trial_mod
from ray_tpu_torch.tune.schedulers import (CONTINUE, PAUSE, RESTART, STOP,
                                           TrialScheduler)
from ray_tpu_torch.tune.trial import Trial

logger = logging.getLogger(__name__)

_STATE_FILE = "experiment_state.pkl"


class TrialRunner:
    def __init__(self, trainable: Callable, trials: List[Trial], *,
                 scheduler: Optional[TrialScheduler] = None,
                 max_concurrent: int = 0,
                 stop: Optional[Dict[str, Any]] = None,
                 resources_per_trial: Optional[Dict[str, float]] = None,
                 experiment_dir: Optional[str] = None,
                 failure_config=None,
                 searcher=None, num_samples: int = 0,
                 callbacks=None, sync_to: Optional[str] = None):
        self.trainable = trainable
        self.trials = trials
        self.scheduler = scheduler or TrialScheduler()
        self.scheduler.set_trials(self.trials)
        self.stop_criteria = stop or {}
        self.resources = resources_per_trial or {"CPU": 1.0}
        self.experiment_dir = experiment_dir
        from ray_tpu_torch.air.config import FailureConfig

        self.failure_config = failure_config or FailureConfig()
        #: model-based searcher: proposes trial configs one at a time up
        #: to ``num_samples`` total, conditioned on completed results
        #: (reference: trial generation via SearchGenerator).
        self.searcher = searcher
        self.num_samples = num_samples
        if max_concurrent <= 0:
            cpus = ray_tpu_torch.cluster_resources().get("CPU", 1)
            per = self.resources.get("CPU", 1.0) or 1.0
            max_concurrent = max(1, int(cpus // per))
        self.max_concurrent = max_concurrent
        self._actors: Dict[str, Any] = {}     # trial_id -> worker actor
        self._inflight: Dict[Any, Trial] = {}  # next_result ref -> trial
        self._pending: List[Trial] = []       # (re)launch queue, see run()
        #: failed trials waiting out their backoff: (monotonic_due, trial)
        self._retry_at: List[tuple] = []
        self._searcher_done = False
        #: trials paused at a scheduler barrier (HyperBand rungs):
        #: checkpointed, actor released, waiting on scheduler.actions()
        self._paused: Dict[str, Trial] = {}
        #: seconds the loop has idled with only paused trials left
        self._paused_idle = 0.0
        from ray_tpu_torch.tune.callback import CallbackList

        self.callbacks = CallbackList(callbacks or [])
        #: remote experiment sync (reference: tune/syncer.py cloud
        #: upload) — pushed on every throttled experiment checkpoint
        self._syncer = None
        if sync_to and self.experiment_dir:
            from ray_tpu_torch.tune.syncer import Syncer

            self._syncer = Syncer(self.experiment_dir, sync_to)

    # -- experiment-level checkpoint/resume -------------------------------
    # (reference: trial_runner.py save/restore + Tuner.restore)

    def save_state(self, force: bool = False) -> None:
        if not self.experiment_dir:
            return
        # Throttle: a full-experiment snapshot per report would serialize
        # every trial's whole history on the hot result loop (reference
        # throttles experiment checkpoints the same way).
        import time as _time

        now = _time.monotonic()
        if not force and now - getattr(self, "_last_save", 0.0) < 5.0:
            return
        self._last_save = now
        from ray_tpu_torch._private._vendor import cloudpickle

        os.makedirs(self.experiment_dir, exist_ok=True)
        snap = []
        for t in self.trials:
            snap.append({
                "config": t.config, "trial_id": t.trial_id,
                "status": t.status,
                "metrics_history": t.metrics_history,
                "last_result": t.last_result, "checkpoint": t.checkpoint,
                "iteration": t.iteration,
                "num_failures": t.num_failures,
                "error": repr(t.error) if t.error else None,
            })
        tmp = os.path.join(self.experiment_dir, _STATE_FILE + ".tmp")
        with open(tmp, "wb") as f:
            cloudpickle.dump(snap, f)
        os.replace(tmp, os.path.join(self.experiment_dir, _STATE_FILE))
        if self._syncer is not None:
            # directory-backed checkpoints live OUTSIDE the experiment
            # dir: the remote copy cannot restore them — warn loudly
            # rather than fail silently after a head loss
            if not getattr(self, "_warned_dir_ckpt", False):
                for t in self.trials:
                    p = getattr(t.checkpoint, "_path", None)
                    if p and not str(p).startswith(
                            str(self.experiment_dir)):
                        self._warned_dir_ckpt = True
                        logger.warning(
                            "sync_to is set but trial %s uses a "
                            "directory checkpoint outside the "
                            "experiment dir (%s): it will NOT be in "
                            "the remote copy; use dict checkpoints or "
                            "checkpoint under the experiment dir for "
                            "full head-loss recovery", t.trial_id, p)
                        break
            try:
                self._syncer.sync_up()
            except Exception:  # noqa: BLE001 - remote hiccup: next tick
                logger.warning("experiment sync_up failed",
                               exc_info=True)

    @staticmethod
    def load_trials(experiment_dir: str) -> List[Trial]:
        """Rebuild the trial table from a saved experiment.  Unfinished
        trials come back PENDING with restore_checkpoint set to their
        last checkpoint, so run() re-executes only them."""
        from ray_tpu_torch._private._vendor import cloudpickle

        with open(os.path.join(experiment_dir, _STATE_FILE), "rb") as f:
            snap = cloudpickle.load(f)
        out = []
        for s in snap:
            t = Trial(config=s["config"], trial_id=s["trial_id"])
            t.metrics_history = s["metrics_history"]
            t.last_result = s["last_result"]
            t.checkpoint = s["checkpoint"]
            t.iteration = s["iteration"]
            t.num_failures = s.get("num_failures", 0)
            if s["status"] in (trial_mod.TERMINATED, trial_mod.STOPPED):
                t.status = s["status"]
            else:  # PENDING/RUNNING/ERROR -> rerun from last checkpoint
                t.status = trial_mod.PENDING
                t.restore_checkpoint = s["checkpoint"]
            out.append(t)
        return out

    # -- lifecycle --------------------------------------------------------
    def run(self) -> List[Trial]:
        import time as _time

        self.callbacks.setup(self.experiment_dir)
        self._pending.extend(
            t for t in self.trials if not t.is_finished)
        pending = self._pending
        try:
            while (pending or self._inflight or self._retry_at
                   or self._paused or self._searcher_pending()):
                # promote failed trials whose backoff has expired
                now = _time.monotonic()
                due = [t for at, t in self._retry_at if at <= now]
                self._retry_at = [(at, t) for at, t in self._retry_at
                                  if at > now]
                pending.extend(due)
                # scheduler barrier decisions (HyperBand rung close)
                resume, stop = self.scheduler.actions()
                for t in stop:
                    self._paused.pop(t.trial_id, None)
                    self._finish(t, trial_mod.STOPPED)
                for t in resume:
                    if self._paused.pop(t.trial_id, None) is not None:
                        t.status = trial_mod.PENDING
                        pending.append(t)
                if (self._paused and not pending and not self._inflight
                        and not self._retry_at and not resume
                        and not stop):
                    # barrier can't progress without us: wait briefly
                    # for the scheduler; a wedged barrier (>60s with
                    # zero movement) force-resumes everyone rather than
                    # hanging the experiment
                    self._paused_idle += 0.05
                    _time.sleep(0.05)
                    if self._paused_idle > 60.0:
                        logger.warning(
                            "scheduler barrier stuck; force-resuming "
                            "%d paused trials", len(self._paused))
                        for t in list(self._paused.values()):
                            # resume from the rung checkpoint — a
                            # from-scratch restart would poison the
                            # bracket with untrained-model scores
                            t.restore_checkpoint = t.checkpoint
                            t.status = trial_mod.PENDING
                            pending.append(t)
                        self._paused.clear()
                    continue
                self._paused_idle = 0.0
                while (self._searcher_pending()
                       and len(self._actors) + len(pending)
                       < self.max_concurrent):
                    trial = Trial(config={})
                    cfg = self.searcher.suggest(trial.trial_id)
                    if cfg is None:
                        # exhausted: latch, or the outer loop spins on
                        # _searcher_pending() forever
                        self._searcher_done = True
                        break
                    trial.config = cfg
                    self.trials.append(trial)
                    self.scheduler.set_trials(self.trials)
                    pending.append(trial)
                while pending and len(self._actors) < self.max_concurrent:
                    trial = pending.pop(0)
                    try:
                        self._launch(trial)
                    except Exception as e:  # noqa: BLE001 - isolate trial
                        logger.warning("trial %s failed to launch: %s",
                                       trial.trial_id, e)
                        self._handle_failure(trial, e)
                if self._inflight:
                    self._pump()
                elif self._retry_at and not pending:
                    # nothing running: wait out the nearest backoff
                    # without spinning
                    _time.sleep(max(0.0, min(
                        at for at, _ in self._retry_at)
                        - _time.monotonic()) + 0.01)
        finally:
            # never leak trial actors, whatever aborted the loop
            for trial in self.trials:
                if trial.trial_id in self._actors:
                    self._finish(trial, trial.status if trial.is_finished
                                 else trial_mod.ERROR,
                                 trial.error or RuntimeError(
                                     "experiment aborted"))
            self.save_state(force=True)
            self.callbacks.on_experiment_end(self.trials)
        return self.trials

    def _launch(self, trial: Trial) -> None:
        from ray_tpu_torch.train._internal.worker_group import RayTrainWorker

        if trial.logdir is None and self.experiment_dir:
            trial.logdir = os.path.join(self.experiment_dir,
                                        f"trial_{trial.trial_id}")
        opts: Dict[str, Any] = {"num_cpus": self.resources.get("CPU", 1.0)}
        if self.resources.get("GPU"):
            opts["num_gpus"] = self.resources["GPU"]
        if "TPU" in self.resources:  # refused by remote(): a ValueError
            opts["num_tpus"] = self.resources["TPU"]
        actor = ray_tpu_torch.remote(**opts)(RayTrainWorker).remote()
        ckpt = trial.restore_checkpoint
        trial.restore_checkpoint = None
        ray_tpu_torch.get([actor.init_session.remote(
            world_rank=0, local_rank=0, world_size=1,
            trial_name=f"trial_{trial.trial_id}", trial_id=trial.trial_id,
            config=trial.config, dataset_shards={}, checkpoint=ckpt)],
            timeout=60)
        ray_tpu_torch.get([actor.start_training.remote(self.trainable)],
                          timeout=60)
        trial.status = trial_mod.RUNNING
        self._actors[trial.trial_id] = actor
        self._inflight[actor.next_result.remote()] = trial
        self.callbacks.on_trial_start(trial)

    def _searcher_pending(self) -> bool:
        return (self.searcher is not None
                and not getattr(self, "_searcher_done", False)
                and len(self.trials) < self.num_samples)

    def _finish(self, trial: Trial, status: str,
                error: Optional[BaseException] = None) -> None:
        trial.status = status
        trial.error = error
        actor = self._actors.pop(trial.trial_id, None)
        if actor is not None:
            try:
                ray_tpu_torch.kill(actor)
            except Exception:  # noqa: BLE001
                pass
        if self.searcher is not None and trial.is_finished:
            try:
                # config passed so restored trials (whose ids the
                # searcher never suggested) still inform the model;
                # error flag so crash-prone configs count as bad, not as
                # their deceptively-good last report
                self.searcher.on_trial_complete(
                    trial.trial_id, trial.last_result,
                    error=status == trial_mod.ERROR, config=trial.config)
            except Exception:  # noqa: BLE001 - searcher bug ≠ run abort
                logger.exception("searcher on_trial_complete failed")
        if trial.is_finished:
            try:
                self.scheduler.on_trial_complete(trial)
            except Exception:  # noqa: BLE001 - scheduler bug ≠ run abort
                logger.exception("scheduler on_trial_complete failed")
            self.callbacks.on_trial_complete(trial)

    def _handle_failure(self, trial: Trial, error: BaseException) -> None:
        """Crash path: requeue the trial to restart from its last
        checkpoint while FailureConfig.max_failures allows (reference:
        tune/execution/trial_runner.py:236 _process_trial_failure —
        -1 = unlimited, 0 = fail fast).  The trial goes onto the
        ``_retry_at`` backoff queue (NOT straight back to pending): the
        run loop promotes it only after the backoff expires, so a
        persistently failing launch can't monopolize the loop or block
        pumping of healthy trials — no sleeping here."""
        import time as _time

        self.callbacks.on_trial_error(trial, error)
        mf = self.failure_config.max_failures
        if mf != -1 and trial.num_failures >= mf:
            self._finish(trial, trial_mod.ERROR, error)
            return
        trial.num_failures += 1
        logger.warning(
            "trial %s failed (restart %d/%s): %s",
            trial.trial_id, trial.num_failures,
            "inf" if mf == -1 else mf, error)
        # drop the dead actor without finishing the trial
        actor = self._actors.pop(trial.trial_id, None)
        if actor is not None:
            try:
                ray_tpu_torch.kill(actor)
            except Exception:  # noqa: BLE001
                pass
        trial.status = trial_mod.PENDING
        trial.restore_checkpoint = trial.checkpoint
        backoff = min(2.0, 0.05 * trial.num_failures)
        self._retry_at.append((_time.monotonic() + backoff, trial))

    def _pump(self) -> None:
        if not self._inflight:
            return
        ready, _ = ray_tpu_torch.wait(list(self._inflight), num_returns=1,
                                      timeout=600.0)
        for ref in ready:
            trial = self._inflight.pop(ref)
            try:
                res = ray_tpu_torch.get([ref], timeout=60)[0]
            except Exception as e:  # noqa: BLE001 - actor died (crash,
                # node loss, OOM kill): retriable per FailureConfig
                self._handle_failure(trial, e)
                continue
            if res.type == "done":
                self._finish(trial, trial_mod.TERMINATED)
            elif res.type == "error":
                # the trainable itself raised: also retriable (reference
                # retries on any trial failure class)
                self._handle_failure(trial, res.error)
            else:
                self._on_report(trial, res)

    def _on_report(self, trial: Trial, res) -> None:
        trial.iteration += 1
        metrics = dict(res.metrics or {})
        metrics.setdefault("training_iteration", trial.iteration)
        trial.metrics_history.append(metrics)
        trial.last_result = metrics
        if res.checkpoint is not None:
            trial.checkpoint = res.checkpoint
            self.callbacks.on_checkpoint(trial, res.checkpoint)
        self.callbacks.on_trial_result(trial, metrics)
        self.save_state()

        decision = CONTINUE if self._should_stop(metrics) is False else STOP
        if decision is CONTINUE:
            decision = self.scheduler.on_trial_result(trial, metrics)
        if decision == STOP:
            self._finish(trial, trial_mod.STOPPED)
            return
        if decision == PAUSE:
            # scheduler barrier (HyperBand rung): checkpointed already
            # (the scheduler pauses AT a report), release the actor and
            # park until scheduler.actions() resumes or stops us
            trial.status = trial_mod.PAUSED
            actor = self._actors.pop(trial.trial_id, None)
            if actor is not None:
                try:
                    ray_tpu_torch.kill(actor)
                except Exception:  # noqa: BLE001
                    pass
            self._paused[trial.trial_id] = trial
            return
        if decision == RESTART:
            # PBT exploitation: replace the trial's actor with one running
            # the (mutated) config from the donor's checkpoint (reference:
            # pbt.py _exploit -> trial restart).
            self._finish(trial, trial_mod.PENDING)
            try:
                self._launch(trial)
            except Exception as e:  # noqa: BLE001
                self._finish(trial, trial_mod.ERROR, e)
            return
        actor = self._actors[trial.trial_id]
        self._inflight[actor.next_result.remote()] = trial

    def _should_stop(self, metrics: Dict[str, Any]) -> bool:
        for key, bound in self.stop_criteria.items():
            v = metrics.get(key)
            if v is not None and v >= bound:
                return True
        return False
