"""Trial schedulers: FIFO and ASHA (async successive halving).

Reference analog: tune/schedulers/{trial_scheduler.py,async_hyperband.py}.
ASHA keeps rungs at r, r*rf, r*rf², …; when a trial reaches a rung it
continues only if its metric is in the top 1/rf of results recorded at
that rung so far (asynchronous — no waiting for full brackets).

A copy of ``ray_tpu/tune/schedulers.py``.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

CONTINUE = "CONTINUE"
STOP = "STOP"
#: restart the trial's actor with trial.config + trial.restore_checkpoint
#: (PBT exploitation).
RESTART = "RESTART"
#: checkpoint + release the trial's resources; the scheduler resumes it
#: later via actions() (HyperBand rung barriers).
PAUSE = "PAUSE"


class TrialScheduler:
    def set_trials(self, trials) -> None:
        """Runner hands the full population to schedulers that need it."""

    def on_trial_result(self, trial, result: Dict[str, Any]) -> str:
        return CONTINUE

    def on_trial_complete(self, trial) -> None:
        """Runner hook on terminal trial states (barrier schedulers
        must re-evaluate rungs a dead member can no longer report to)."""

    def actions(self):
        """Polled by the runner each loop tick: (resume, stop) lists of
        PAUSED trials the scheduler has decided about."""
        return [], []


class FIFOScheduler(TrialScheduler):
    pass


class ASHAScheduler(TrialScheduler):
    def __init__(self, metric: str = "loss", mode: str = "min",
                 max_t: int = 100, grace_period: int = 1,
                 reduction_factor: int = 4,
                 time_attr: str = "training_iteration"):
        if mode not in ("min", "max"):
            raise ValueError("mode must be min or max")
        self.metric = metric
        self.mode = mode
        self.max_t = max_t
        self.grace_period = grace_period
        self.rf = reduction_factor
        self.time_attr = time_attr
        # rung milestones: grace, grace*rf, grace*rf^2, ... < max_t
        self.milestones: List[int] = []
        t = grace_period
        while t < max_t:
            self.milestones.append(t)
            t *= reduction_factor
        self._rungs: Dict[int, List[float]] = {m: [] for m in
                                               self.milestones}
        self._recorded: Dict[str, set] = {}  # trial_id -> rungs entered

    def on_trial_result(self, trial, result: Dict[str, Any]) -> str:
        t = result.get(self.time_attr, trial.iteration)
        val = result.get(self.metric)
        if val is None:
            return CONTINUE
        if t >= self.max_t:
            return STOP
        decision = CONTINUE
        seen = self._recorded.setdefault(trial.trial_id, set())
        # a trial enters each rung the first time it reaches (or passes)
        # the milestone — reports need not land exactly on it
        for m in self.milestones:
            if t >= m and m not in seen:
                seen.add(m)
                rung = self._rungs[m]
                rung.append(float(val))
                if len(rung) >= self.rf:
                    k = max(1, math.floor(len(rung) / self.rf))
                    ordered = sorted(rung, reverse=(self.mode == "max"))
                    cutoff = ordered[k - 1]
                    good = (val >= cutoff if self.mode == "max"
                            else val <= cutoff)
                    if not good:
                        decision = STOP
        return decision


class PopulationBasedTraining(TrialScheduler):
    """PBT (reference: tune/schedulers/pbt.py PopulationBasedTraining).

    Every ``perturbation_interval`` iterations a trial compares itself to
    the population: if it sits in the bottom quantile it EXPLOITS a top-
    quantile trial (clone its latest checkpoint) and EXPLORES its config
    (resample or perturb each mutable hyperparameter).  The runner
    restarts the trial's actor with the new config + donor checkpoint.
    """

    def __init__(self, metric: str = "loss", mode: str = "min", *,
                 perturbation_interval: int = 4,
                 hyperparam_mutations: Optional[Dict[str, Any]] = None,
                 quantile_fraction: float = 0.25,
                 resample_probability: float = 0.25,
                 perturbation_factors=(0.8, 1.2),
                 seed: Optional[int] = None):
        if mode not in ("min", "max"):
            raise ValueError("mode must be min or max")
        if not hyperparam_mutations:
            raise ValueError("hyperparam_mutations is required")
        self.metric = metric
        self.mode = mode
        self.interval = perturbation_interval
        self.mutations = hyperparam_mutations
        self.quantile = quantile_fraction
        self.resample_p = resample_probability
        self.factors = perturbation_factors
        import random as _random

        self._rng = _random.Random(seed)
        self._trials: List = []
        self._last_perturb: Dict[str, int] = {}
        self.num_exploits = 0  # observability / tests

    def set_trials(self, trials) -> None:
        self._trials = list(trials)

    def _score(self, trial) -> Optional[float]:
        if not trial.last_result:
            return None
        v = trial.last_result.get(self.metric)
        return None if v is None else float(v)

    def _explore(self, config: Dict[str, Any]) -> Dict[str, Any]:
        out = dict(config)
        for key, spec in self.mutations.items():
            resample = self._rng.random() < self.resample_p
            if callable(spec):
                if resample or key not in out:
                    out[key] = spec()
                    continue
                spec_choices = None
            elif isinstance(spec, (list, tuple)):
                spec_choices = list(spec)
            else:
                raise ValueError(
                    f"mutation for {key!r} must be a list or callable")
            cur = out.get(key)
            if spec_choices is not None:
                if resample or cur not in spec_choices:
                    out[key] = self._rng.choice(spec_choices)
                else:
                    # shift one step within the sorted choice list
                    idx = spec_choices.index(cur)
                    idx += self._rng.choice((-1, 1))
                    out[key] = spec_choices[max(0, min(len(spec_choices)
                                                       - 1, idx))]
            elif isinstance(cur, (int, float)):
                f = self._rng.choice(self.factors)
                out[key] = type(cur)(cur * f)
        return out

    def on_trial_result(self, trial, result: Dict[str, Any]) -> str:
        t = result.get("training_iteration", trial.iteration)
        last = self._last_perturb.get(trial.trial_id, 0)
        if t - last < self.interval:
            return CONTINUE
        scored = [(s, tr) for tr in self._trials
                  if (s := self._score(tr)) is not None]
        if len(scored) < 2:
            # Nothing to compare against yet (population still starting) —
            # keep the perturbation slot so the comparison happens as soon
            # as a peer reports, not a full interval later.
            return CONTINUE
        self._last_perturb[trial.trial_id] = t
        scored.sort(key=lambda x: x[0], reverse=(self.mode == "max"))
        k = max(1, int(len(scored) * self.quantile))
        top = [tr for _, tr in scored[:k]]
        bottom = {tr.trial_id for _, tr in scored[-k:]}
        if trial.trial_id not in bottom or trial in top:
            return CONTINUE
        donors = [tr for tr in top
                  if tr.checkpoint is not None
                  and tr.trial_id != trial.trial_id]
        if not donors:
            return CONTINUE
        donor = self._rng.choice(donors)
        trial.config = self._explore(donor.config)
        trial.restore_checkpoint = donor.checkpoint
        self.num_exploits += 1
        return RESTART


class HyperBandForBOHB(TrialScheduler):
    """Synchronous HyperBand with rung barriers (reference:
    tune/schedulers/hb_bohb.py:14 HyperBandForBOHB).  Trials round-robin
    into brackets; within a bracket every trial PAUSES (checkpoint +
    resources released) when it reaches the current rung budget, and
    once the whole rung has reported, the top 1/eta resume into the next
    rung while the rest stop.  Pair with a model-based searcher
    (e.g. search.TPESearcher) for BOHB: the searcher proposes configs,
    this scheduler allocates budgets.
    """

    def __init__(self, metric: str = "loss", mode: str = "min", *,
                 max_t: int = 81, reduction_factor: int = 3,
                 num_brackets: int = 1,
                 time_attr: str = "training_iteration"):
        if mode not in ("min", "max"):
            raise ValueError("mode must be min or max")
        self.metric = metric
        self.mode = mode
        self.max_t = max_t
        self.eta = reduction_factor
        self.num_brackets = max(1, num_brackets)
        self.time_attr = time_attr
        #: bracket index -> {"rung": k, "budget": t, "members": set,
        #:  "reported": {trial_id: score}, "paused": {trial_id: trial}}
        self._brackets: List[Dict[str, Any]] = []
        levels = int(math.log(self.max_t, self.eta))
        self._start_budget = max(1, int(
            self.max_t / (self.eta ** max(0, levels))))
        for s in range(self.num_brackets):
            # bracket s starts at budget max_t / eta^(levels-s)
            start = max(1, int(self.max_t
                               / (self.eta ** max(0, levels - s))))
            self._brackets.append({
                "rung": 0, "budget": start, "members": set(),
                "reported": {}, "paused": {}})
        self._assigned: Dict[str, int] = {}
        self._resume: List = []
        self._stop: List = []

    def _bracket_of(self, trial) -> Dict[str, Any]:
        b = self._assigned.get(trial.trial_id)
        if b is None:
            # join only rung-0 brackets: a late-arriving trial (model-
            # based searchers trickle suggestions) must compete from the
            # first rung, not parachute into an advanced budget
            open_brackets = [i for i, br in enumerate(self._brackets)
                             if br["rung"] == 0]
            if not open_brackets:
                self._brackets.append({
                    "rung": 0, "budget": self._start_budget,
                    "members": set(), "reported": {}, "paused": {}})
                open_brackets = [len(self._brackets) - 1]
            b = open_brackets[len(self._assigned) % len(open_brackets)]
            self._assigned[trial.trial_id] = b
            self._brackets[b]["members"].add(trial.trial_id)
        return self._brackets[b]

    def on_trial_result(self, trial, result: Dict[str, Any]) -> str:
        t = result.get(self.time_attr, trial.iteration)
        val = result.get(self.metric)
        if val is None:
            return CONTINUE
        br = self._bracket_of(trial)
        if t >= self.max_t:
            return STOP
        if t < br["budget"]:
            return CONTINUE
        # rung boundary: record the score and pause at the barrier
        br["reported"][trial.trial_id] = float(val)
        br["paused"][trial.trial_id] = trial
        self._maybe_close_rung(br)
        return PAUSE

    def on_trial_complete(self, trial) -> None:
        """Runner hook: a bracket member finished WITHOUT pausing at the
        rung (errored out, hit stop_criteria) — re-evaluate the rung or
        the remaining paused members would wait on it forever."""
        b = self._assigned.get(trial.trial_id)
        if b is not None:
            br = self._brackets[b]
            br["paused"].pop(trial.trial_id, None)
            self._maybe_close_rung(br)

    def _finished(self, tid: str) -> bool:
        for t in getattr(self, "_trials", []):
            if t.trial_id == tid:
                return t.is_finished
        return False

    def set_trials(self, trials) -> None:
        self._trials = list(trials)
        # assign brackets UP FRONT: membership must exist before any
        # trial reports, or the first reporter closes a one-member rung
        # and elimination never happens
        for t in trials:
            if not t.is_finished:
                self._bracket_of(t)

    def _maybe_close_rung(self, br) -> None:
        # the rung closes when every live member has reported
        pending = [tid for tid in br["members"]
                   if tid not in br["reported"]
                   and not self._finished(tid)]
        if pending:
            return
        scored = sorted(br["reported"].items(), key=lambda kv: kv[1],
                        reverse=(self.mode == "max"))
        keep = max(1, len(scored) // self.eta)
        winners = {tid for tid, _ in scored[:keep]}
        for tid, trial in list(br["paused"].items()):
            if tid in winners:
                trial.restore_checkpoint = trial.checkpoint
                self._resume.append(trial)
            else:
                br["members"].discard(tid)
                self._stop.append(trial)
        br["paused"].clear()
        br["reported"].clear()
        br["rung"] += 1
        br["budget"] = min(self.max_t, br["budget"] * self.eta)
        br["members"] &= winners

    def actions(self):
        resume, self._resume = self._resume, []
        stop, self._stop = self._stop, []
        return resume, stop


class PB2(PopulationBasedTraining):
    """Population Based Bandits (reference: tune/schedulers/pb2.py:210
    PB2) — PBT's exploit/explore loop, but explore selects new
    hyperparameter values by maximizing a GP-UCB acquisition fit to the
    population's observed (config, reward-change) history instead of
    random perturbation.  Data-efficient at small population sizes.

    ``hyperparam_bounds`` maps each mutable key to ``[low, high]``
    (continuous).  The GP is an RBF-kernel regression on normalized
    configs; the acquisition is maximized over a random candidate sweep
    — both pure numpy, matching the reference's GPy-free spirit at this
    scale.
    """

    def __init__(self, metric: str = "loss", mode: str = "min", *,
                 perturbation_interval: int = 4,
                 hyperparam_bounds: Optional[Dict[str, Any]] = None,
                 quantile_fraction: float = 0.25,
                 seed: Optional[int] = None):
        if not hyperparam_bounds:
            raise ValueError("hyperparam_bounds is required")
        super().__init__(
            metric, mode, perturbation_interval=perturbation_interval,
            hyperparam_mutations={k: (lambda lo=lo, hi=hi: lo)
                                  for k, (lo, hi) in
                                  hyperparam_bounds.items()},
            quantile_fraction=quantile_fraction, seed=seed)
        self.bounds = {k: (float(lo), float(hi))
                       for k, (lo, hi) in hyperparam_bounds.items()}
        #: (normalized config vector, reward delta) observations
        self._obs_x: List[List[float]] = []
        self._obs_y: List[float] = []
        self._last_score: Dict[str, float] = {}

    def _norm(self, config: Dict[str, Any]) -> List[float]:
        out = []
        for k, (lo, hi) in self.bounds.items():
            v = float(config.get(k, lo))
            out.append((v - lo) / (hi - lo) if hi > lo else 0.0)
        return out

    def on_trial_result(self, trial, result: Dict[str, Any]) -> str:
        # record reward deltas for the GP before the PBT decision
        s = result.get(self.metric)
        if s is not None:
            s = float(s) if self.mode == "max" else -float(s)
            prev = self._last_score.get(trial.trial_id)
            self._last_score[trial.trial_id] = s
            if prev is not None:
                self._obs_x.append(self._norm(trial.config))
                self._obs_y.append(s - prev)
                if len(self._obs_y) > 512:  # bound the GP solve
                    self._obs_x.pop(0)
                    self._obs_y.pop(0)
        decision = super().on_trial_result(trial, result)
        if decision == RESTART:
            # the next report comes from the donor's checkpoint: its
            # score jump reflects the exploit, not the explored config —
            # don't let it contaminate the GP observations
            self._last_score.pop(trial.trial_id, None)
        return decision

    def _explore(self, config: Dict[str, Any]) -> Dict[str, Any]:
        import numpy as np

        out = dict(config)
        keys = list(self.bounds)
        if len(self._obs_y) < 4:
            for k in keys:  # cold start: uniform in bounds
                lo, hi = self.bounds[k]
                out[k] = lo + (hi - lo) * self._rng.random()
            return out
        X = np.asarray(self._obs_x)
        y = np.asarray(self._obs_y)
        ystd = y.std() or 1.0
        y = (y - y.mean()) / ystd
        # RBF GP posterior over 256 random candidates; UCB selection
        ls, noise = 0.3, 1e-2
        K = np.exp(-0.5 * ((X[:, None] - X[None]) ** 2).sum(-1) / ls**2)
        Kinv_y = np.linalg.solve(K + noise * np.eye(len(X)), y)
        cand = np.asarray([[self._rng.random() for _ in keys]
                           for _ in range(256)])
        Kc = np.exp(-0.5 * ((cand[:, None] - X[None]) ** 2).sum(-1)
                    / ls**2)
        mu = Kc @ Kinv_y
        var = 1.0 - (Kc * np.linalg.solve(
            K + noise * np.eye(len(X)), Kc.T).T).sum(-1)
        ucb = mu + 2.0 * np.sqrt(np.maximum(var, 0.0))
        best = cand[int(ucb.argmax())]
        for i, k in enumerate(keys):
            lo, hi = self.bounds[k]
            v = lo + (hi - lo) * float(best[i])
            out[k] = type(config[k])(v) if isinstance(
                config.get(k), int) else v
        return out


class MedianStoppingRule(TrialScheduler):
    """Stop a trial whose running-best metric is worse than the median of
    other trials' running averages at the same step (reference:
    tune/schedulers/median_stopping_rule.py, after the Vizier rule).
    """

    def __init__(self, metric: str = "loss", mode: str = "min",
                 grace_period: int = 1, min_samples_required: int = 3,
                 time_attr: str = "training_iteration"):
        if mode not in ("min", "max"):
            raise ValueError("mode must be min or max")
        self.metric = metric
        self.mode = mode
        self.grace_period = grace_period
        self.min_samples = min_samples_required
        self.time_attr = time_attr
        #: trial_id -> list of (time_attr value, metric value) reports
        self._history: Dict[str, List[Tuple[float, float]]] = {}

    def _running_avg(self, trial_id: str, upto_t: float
                     ) -> Optional[float]:
        vals = [v for t, v in self._history.get(trial_id, [])
                if t <= upto_t]
        return sum(vals) / len(vals) if vals else None

    def on_trial_result(self, trial, result: Dict[str, Any]) -> str:
        val = result.get(self.metric)
        if val is None:
            return CONTINUE
        hist = self._history.setdefault(trial.trial_id, [])
        t = float(result.get(self.time_attr, len(hist) + 1))
        hist.append((t, float(val)))
        if t <= self.grace_period:
            return CONTINUE
        # compare against other trials' running averages UP TO the same
        # point on the configured time axis, so fast- and slow-reporting
        # trials align on time_attr rather than report count
        others = [self._running_avg(tid, t)
                  for tid in self._history if tid != trial.trial_id]
        others = [a for a in others if a is not None]
        if len(others) < self.min_samples:
            return CONTINUE
        ordered = sorted(others)
        n = len(ordered)
        median = (ordered[n // 2] if n % 2
                  else (ordered[n // 2 - 1] + ordered[n // 2]) / 2.0)
        vals = [v for _, v in hist]
        best = max(vals) if self.mode == "max" else min(vals)
        worse = best < median if self.mode == "max" else best > median
        return STOP if worse else CONTINUE
