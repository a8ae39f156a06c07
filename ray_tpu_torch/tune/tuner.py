"""Tuner — the public tune API (reference analog: tune/tuner.py:220
Tuner.fit; tune/tune.py:130 run).

A copy of ``ray_tpu/tune/tuner.py``.  An RLlib algorithm launched by
name resolves through the port's registry (``rllib/registry.py``: an
algorithm not ported yet raises NotImplementedError naming its ROADMAP
item); results default to ``~/ray_tpu_torch_results`` (the reference's
``~/ray_tpu_results``), or ``RAYTPU_RESULTS_DIR``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional

from ray_tpu_torch.air.config import RunConfig
from ray_tpu_torch.air.result import Result
from ray_tpu_torch.tune.schedulers import TrialScheduler
from ray_tpu_torch.tune.search import BasicVariantGenerator
from ray_tpu_torch.tune.trial import Trial
from ray_tpu_torch.tune.trial_runner import TrialRunner


@dataclasses.dataclass
class TuneConfig:
    metric: Optional[str] = None
    mode: str = "min"
    num_samples: int = 1
    max_concurrent_trials: int = 0
    scheduler: Optional[TrialScheduler] = None
    #: model-based searcher (e.g. search.TPESearcher()); requires
    #: ``metric``.  When set, trials are proposed one at a time
    #: conditioned on completed results instead of pre-expanded.
    search_alg: Optional[Any] = None
    seed: Optional[int] = None


class ResultGrid:
    def __init__(self, trials: List[Trial]):
        self.trials = trials

    def __len__(self):
        return len(self.trials)

    def __iter__(self):
        return iter(self._results())

    def _results(self) -> List[Result]:
        return [Result(metrics=t.last_result, checkpoint=t.checkpoint,
                       error=t.error, metrics_history=t.metrics_history)
                for t in self.trials]

    def get_best_result(self, metric: str, mode: str = "min") -> Result:
        scored = [(t.best_metric(metric, mode), t) for t in self.trials
                  if t.best_metric(metric, mode) is not None]
        if not scored:
            raise ValueError(f"no trial reported metric {metric!r}")
        best = (max if mode == "max" else min)(scored, key=lambda s: s[0])[1]
        return Result(metrics=best.last_result, checkpoint=best.checkpoint,
                      error=best.error,
                      metrics_history=best.metrics_history)

    @property
    def errors(self) -> List[BaseException]:
        return [t.error for t in self.trials if t.error is not None]


class Tuner:
    def __init__(self, trainable: Callable, *,
                 param_space: Optional[Dict[str, Any]] = None,
                 tune_config: Optional[TuneConfig] = None,
                 run_config: Optional[RunConfig] = None,
                 resources_per_trial: Optional[Dict[str, float]] = None):
        from ray_tpu_torch.train.base_trainer import BaseTrainer

        if isinstance(trainable, str):
            # launch-by-name (reference tune.run("PPO", ...)): resolve
            # through the RLlib algorithm registry
            self._trainable = _algorithm_trainable(trainable)
            resources_per_trial = resources_per_trial or {"CPU": 0.5}
        elif isinstance(trainable, BaseTrainer):
            # Trainer-in-Tuner: each trial runs trainer.training_loop with
            # the trial config merged into its loop config (reference
            # base_trainer.py:353 routes fit() here).
            self._trainable = trainable.as_trainable()
            resources_per_trial = resources_per_trial or {"CPU": 0.5}
        else:
            self._trainable = trainable
        self.param_space = param_space or {}
        self.tune_config = tune_config or TuneConfig()
        self.run_config = run_config or RunConfig()
        self.resources_per_trial = resources_per_trial

    def _experiment_dir(self) -> Optional[str]:
        import os
        import time

        cached = getattr(self, "_experiment_dir_cache", None)
        if cached:
            return cached
        # Default storage mirrors the reference's ~/ray_results so
        # Tuner.fit always leaves tailable per-trial artifacts
        # (override with RunConfig.storage_path / RAYTPU_RESULTS_DIR).
        # Unnamed experiments get a timestamped dir so two runs never
        # interleave their trial artifacts / experiment state.
        root = (self.run_config.storage_path
                or os.environ.get("RAYTPU_RESULTS_DIR")
                or os.path.expanduser("~/ray_tpu_torch_results"))
        name = self.run_config.name or time.strftime(
            "tune_%Y-%m-%d_%H-%M-%S")
        self._experiment_dir_cache = os.path.join(root, name)
        return self._experiment_dir_cache

    def fit(self) -> ResultGrid:
        trials = getattr(self, "_restored_trials", None)
        searcher = self.tune_config.search_alg
        if searcher is not None:
            if not self.tune_config.metric:
                raise ValueError("search_alg requires "
                                 "TuneConfig.metric to be set")
            searcher.setup(self.param_space, self.tune_config.metric,
                           self.tune_config.mode,
                           seed=self.tune_config.seed)
            if trials:  # resumed experiment: re-seed the model
                for t in trials:
                    if t.is_finished and t.last_result:
                        searcher.observe(t.config, t.last_result)
        if trials is None:
            if searcher is not None:
                trials = []  # proposed one at a time by the searcher
            else:
                gen = BasicVariantGenerator(
                    self.param_space,
                    num_samples=self.tune_config.num_samples,
                    seed=self.tune_config.seed)
                trials = [Trial(config=c) for c in gen.variants()]
        return self._run(trials)

    def _run(self, trials: List[Trial]) -> ResultGrid:
        stop = self.run_config.stop if isinstance(self.run_config.stop,
                                                  dict) else None
        from ray_tpu_torch.tune.logger import DEFAULT_LOGGERS, LoggerCallback

        callbacks = list(self.run_config.callbacks or [])
        if not any(isinstance(cb, LoggerCallback) for cb in callbacks):
            # reference semantics: user callbacks ADD to the default
            # loggers unless the user supplies their own LoggerCallback
            callbacks += [cls() for cls in DEFAULT_LOGGERS]
        runner = TrialRunner(
            self._trainable, trials,
            scheduler=self.tune_config.scheduler,
            max_concurrent=self.tune_config.max_concurrent_trials,
            stop=stop,
            resources_per_trial=self.resources_per_trial,
            experiment_dir=self._experiment_dir(),
            failure_config=self.run_config.failure_config,
            searcher=self.tune_config.search_alg,
            num_samples=self.tune_config.num_samples,
            callbacks=callbacks,
            sync_to=getattr(self.run_config, "sync_to", None))
        runner.run()
        return ResultGrid(runner.trials)

    @classmethod
    def restore(cls, path: str, trainable: Callable,
                **tuner_kwargs) -> "Tuner":
        """Resume an interrupted experiment from its storage dir
        (reference: tune/tuner.py Tuner.restore + trial_runner
        save/restore).  Finished trials keep their results; calling
        .fit() re-runs only the unfinished ones, each from its last
        checkpoint.  ``path`` may be a remote URI (kv:// / s3://):
        the synced experiment downloads to local storage first —
        head-loss recovery through RunConfig.sync_to."""
        import os

        remote_uri = None
        if "://" in path:
            import tempfile

            from ray_tpu_torch.tune.syncer import Syncer

            remote_uri = path
            local = os.path.join(tempfile.mkdtemp(prefix="tune_restore_"),
                                 path.rstrip("/").rsplit("/", 1)[-1])
            os.makedirs(local, exist_ok=True)
            Syncer.sync_down(path, local)
            path = local
        tuner = cls(trainable, **tuner_kwargs)
        if remote_uri and not getattr(tuner.run_config, "sync_to", None):
            # keep syncing the RESUMED run to the same remote — without
            # this a second head loss after restore loses all progress
            # since the first one
            tuner.run_config.sync_to = remote_uri
        tuner.run_config.storage_path = os.path.dirname(path) or "."
        tuner.run_config.name = os.path.basename(path)
        tuner._restored_trials = TrialRunner.load_trials(path)
        return tuner


def _algorithm_trainable(name: str) -> Callable:
    """Function trainable for a registry algorithm — delegates to
    Algorithm.as_trainable (ONE adapter); trial-config keys are the
    algorithm's Config fields plus ``training_iterations`` (default
    10) bounding the loop.  The learner sits on the trial's card
    (``resources_per_trial={"GPU": 1, ...}``) unless the trial config
    sets ``learner_device``; its rollout workers are CPU actors."""
    from ray_tpu_torch.rllib.registry import get_algorithm_class

    cls, cfg_cls = get_algorithm_class(name, return_config=True)
    fn = cls.as_trainable(cfg_cls())
    fn.__name__ = name
    return fn


def run(trainable: Callable, *, config: Optional[Dict[str, Any]] = None,
        num_samples: int = 1, scheduler: Optional[TrialScheduler] = None,
        stop: Optional[Dict[str, Any]] = None,
        metric: Optional[str] = None, mode: str = "min") -> ResultGrid:
    """tune.run-style entry point (reference tune/tune.py:130)."""
    return Tuner(
        trainable, param_space=config,
        tune_config=TuneConfig(num_samples=num_samples,
                               scheduler=scheduler, metric=metric,
                               mode=mode),
        run_config=RunConfig(stop=stop)).fit()
