"""Hyperparameter search / experiment engine (reference analog:
python/ray/tune — Tuner.fit → TrialRunner event loop over trial actors,
searchers + schedulers).

A copy of ``ray_tpu/tune/__init__.py``: host code, no JAX in it.
"""

from ray_tpu_torch.tune.callback import Callback
from ray_tpu_torch.tune.logger import (CSVLoggerCallback, JsonLoggerCallback,
                                       LoggerCallback, TBXLoggerCallback)
from ray_tpu_torch.tune.schedulers import (ASHAScheduler, FIFOScheduler,
                                           HyperBandForBOHB,
                                           MedianStoppingRule, PB2,
                                           PopulationBasedTraining,
                                           TrialScheduler)
from ray_tpu_torch.tune.search import (Searcher, TPESearcher, choice,
                                       grid_search, loguniform, randint,
                                       uniform)
from ray_tpu_torch.tune.trial import Trial
from ray_tpu_torch.tune.tuner import ResultGrid, TuneConfig, Tuner, run

__all__ = [
    "Tuner", "TuneConfig", "ResultGrid", "run", "Trial",
    "grid_search", "choice", "uniform", "loguniform", "randint",
    "Searcher", "TPESearcher",
    "TrialScheduler", "FIFOScheduler", "ASHAScheduler", "MedianStoppingRule",
    "PopulationBasedTraining", "PB2", "HyperBandForBOHB",
    "Callback", "LoggerCallback", "CSVLoggerCallback",
    "JsonLoggerCallback", "TBXLoggerCallback",
]
