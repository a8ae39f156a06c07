"""The port's tune schedulers and searchers (``ray_tpu_torch/tune/``)
against the JAX package's (``ray_tpu/tune/``), with no actors.

Each case feeds both packages the same report sequences and seeds
through a small stand-in for ``TrialRunner``'s decision handling (its
``_on_report`` and the barrier loop: STOP finishes a trial, PAUSE parks
it until ``actions()`` resumes or stops it, RESTART relaunches it with
the explored config from the donor's checkpoint), and compares every
decision, the configs the schedulers explore and the searchers propose.
The scenarios follow tests/test_tune.py and tests/test_tune_loggers.py:
ASHA on decaying losses, PBT's exploitation, HyperBand's rung barrier,
PB2's GP-UCB exploration, the median stopping rule,
BasicVariantGenerator's grid and samples, TPE on the quadratic fixture
and with crashed trials.
"""

import math

import pytest

from ray_tpu import tune as jtune
from ray_tpu.tune import search as jsearch
from ray_tpu_torch import tune as ttune
from ray_tpu_torch.tune import search as tsearch

PACKAGES = {"jax": (jtune, jsearch), "torch": (ttune, tsearch)}


def _simulate(tune, make_sched, configs, score, max_rounds=40):
    """Run ``configs`` as trials under ``make_sched()``: each round
    every running trial reports once (``score(config, iteration)``,
    with a dict checkpoint), the scheduler decides, and paused trials
    wait for ``actions()``.  Returns the decision log."""
    sched = make_sched()
    trials = [tune.Trial(config=dict(c), trial_id=f"t{i}")
              for i, c in enumerate(configs)]
    sched.set_trials(trials)
    running = list(trials)
    log = []
    for _ in range(max_rounds):
        resume, stop = sched.actions()
        for t in stop:
            t.status = "STOPPED"
            log.append(("stopped at barrier", t.trial_id, t.iteration))
            sched.on_trial_complete(t)
        for t in resume:
            t.status = "RUNNING"
            log.append(("resume", t.trial_id, t.iteration,
                        t.restore_checkpoint))
            running.append(t)
        if not running:
            break
        for t in list(running):
            t.iteration += 1
            metrics = {"score": score(t.config, t.iteration),
                       "training_iteration": t.iteration}
            t.metrics_history.append(metrics)
            t.last_result = metrics
            t.checkpoint = {"owner": t.trial_id, "it": t.iteration}
            d = sched.on_trial_result(t, metrics)
            log.append((t.trial_id, t.iteration, d, dict(t.config),
                        t.restore_checkpoint))
            if d == "STOP":
                t.status = "STOPPED"
                running.remove(t)
                sched.on_trial_complete(t)
            elif d == "PAUSE":
                t.status = "PAUSED"
                running.remove(t)
    log.append(("end", sorted((t.trial_id, t.status, t.iteration)
                              for t in trials)))
    return log, sched


def _both(make, configs, score, **kw):
    out = {}
    for name, (tune, _) in PACKAGES.items():
        out[name] = _simulate(tune, lambda: make(tune), configs, score, **kw)
    return out


def test_asha_decisions_match_jax():
    """tests/test_tune.py::test_asha_stops_bad_trials_early's losses,
    one trial reporting at a time in rounds."""
    runs = _both(lambda t: t.ASHAScheduler(
        metric="score", mode="min", max_t=20, grace_period=2,
        reduction_factor=2),
        [{"q": q} for q in (1.0, 2.0, 4.0, 8.0, 3.0, 0.5)],
        lambda c, i: c["q"] / i)
    assert runs["torch"][0] == runs["jax"][0]
    assert any(e[2] == "STOP" and e[1] < 20 for e in runs["torch"][0][:-1])
    assert runs["torch"][1]._rungs == runs["jax"][1]._rungs


@pytest.mark.parametrize("mode", ["min", "max"])
def test_median_stopping_rule_matches_jax(mode):
    runs = _both(lambda t: t.MedianStoppingRule(
        metric="score", mode=mode, grace_period=2, min_samples_required=2),
        [{"q": q} for q in (1.0, 3.0, 2.0, 5.0, 4.0)],
        lambda c, i: c["q"] * (1 + 0.1 * math.sin(i)) + i * 0.01,
        max_rounds=10)
    assert runs["torch"][0] == runs["jax"][0]
    assert any(e[2] == "STOP" for e in runs["torch"][0][:-1])


def test_hyperband_rung_barriers_match_jax():
    """tests/test_tune_loggers.py::test_hyperband_bohb_rung_barrier's
    scores and scheduler, two brackets."""
    runs = _both(lambda t: t.HyperBandForBOHB(
        metric="score", mode="min", max_t=9, reduction_factor=3,
        num_brackets=2),
        [{"q": q} for q in (1.0, 2.0, 4.0, 8.0, 16.0, 32.0)],
        lambda c, i: c["q"] * (9 - i))
    log = runs["torch"][0]
    assert log == runs["jax"][0]
    assert any(e[2] == "PAUSE" for e in log[:-1] if len(e) == 5)
    assert any(e[0] == "resume" for e in log)
    assert any(e[0] == "stopped at barrier" for e in log)


@pytest.mark.parametrize("quantile", [0.25, 0.5])
def test_pbt_exploits_and_explores_as_jax(quantile):
    """PBT with choice and numeric (callable, perturbed by factors)
    mutations: the same donors, the same explored configs."""
    def make(t):
        return t.PopulationBasedTraining(
            metric="score", mode="max", perturbation_interval=3,
            hyperparam_mutations={"lr": [0.1, 0.3, 1.0],
                                  "momentum": lambda: 0.5},
            quantile_fraction=quantile, resample_probability=0.3, seed=0)

    runs = _both(make, [{"lr": lr, "momentum": m} for lr, m in
                        ((0.1, 0.9), (1.0, 0.5), (0.3, 0.7), (0.1, 0.1))],
                 lambda c, i: c["lr"] * i + c["momentum"], max_rounds=15)
    assert runs["torch"][0] == runs["jax"][0]
    assert runs["torch"][1].num_exploits == runs["jax"][1].num_exploits >= 1


def test_pb2_explores_as_jax():
    """tests/test_tune_loggers.py::test_pb2_learns_toward_optimum's
    bandit: cold-start and GP-UCB explorations equal to the float."""
    def make(t):
        return t.PB2(metric="score", mode="max", perturbation_interval=3,
                     hyperparam_bounds={"lr": [0.0, 1.0]}, seed=7)

    runs = _both(make, [{"lr": lr} for lr in (0.05, 0.9, 0.95, 0.99)],
                 lambda c, i: -((c["lr"] - 0.5) ** 2) * i, max_rounds=12)
    assert runs["torch"][0] == runs["jax"][0]
    t, j = runs["torch"][1], runs["jax"][1]
    assert t.num_exploits == j.num_exploits >= 2
    assert t._obs_x == j._obs_x and t._obs_y == j._obs_y


SPACE = {"a": "grid", "u": ("uniform", -1.0, 3.0),
         "lu": ("loguniform", 1e-4, 1e-1), "ri": ("randint", 2, 9),
         "c": ("choice", ["relu", "gelu", "tanh"]), "fixed": 7}


def _space(search, grid=True):
    out = {}
    for k, v in SPACE.items():
        if v == "grid":
            if grid:
                out[k] = search.grid_search([1, 2, 3])
        elif isinstance(v, tuple):
            out[k] = getattr(search, v[0])(*v[1:])
        else:
            out[k] = v
    return out


@pytest.mark.parametrize("seed", [0, 11])
def test_variant_generator_matches_jax(seed):
    got = {name: s.BasicVariantGenerator(_space(s), num_samples=3,
                                         seed=seed).variants()
           for name, (_, s) in PACKAGES.items()}
    assert got["torch"] == got["jax"]
    assert len(got["torch"]) == 9
    assert {v["a"] for v in got["torch"]} == {1, 2, 3}


def _tpe_run(search, n, objective, crash=None, seed=1):
    tpe = search.TPESearcher(n_initial=6)
    tpe.setup(_space(search, grid=False), "loss", "min", seed=seed)
    out = []
    for i in range(n):
        cfg = tpe.suggest(f"t{i}")
        loss = objective(cfg)
        err = bool(crash and crash(cfg))
        tpe.on_trial_complete(f"t{i}", {"loss": 0.0 if err else loss},
                              error=err)
        out.append(cfg)
    # a restored trial the searcher never suggested
    tpe.on_trial_complete("restored", {"loss": 0.25},
                          config={**out[0], "u": 0.5})
    tpe.observe({**out[1], "u": 2.5}, {"loss": 9.0})
    out.append(tpe.suggest("after"))
    return out, tpe._obs


def _quadratic(cfg):
    return ((cfg["u"] - 2.0) ** 2 + (math.log10(cfg["lu"]) + 2) ** 2
            + (cfg["ri"] - 5) ** 2 * 0.1 + (cfg["c"] != "gelu"))


@pytest.mark.parametrize("crashy", [False, True], ids=["clean", "crashes"])
def test_tpe_suggestions_match_jax(crashy):
    """tests/test_tune.py's TPE fixture over every Domain type; with
    crashes, test_errored_trials_count_as_bad_for_tpe's rule."""
    crash = (lambda c: c["u"] < 0.5) if crashy else None
    got = {name: _tpe_run(s, 30, _quadratic, crash)
           for name, (_, s) in PACKAGES.items()}
    assert got["torch"] == got["jax"]
    assert any(score == math.inf for _, score in got["torch"][1]) == crashy


def test_grid_search_axes_refused_by_tpe_as_in_jax():
    for _, s in PACKAGES.values():
        with pytest.raises(ValueError, match="does not accept grid_search"):
            s.TPESearcher().setup({"a": s.grid_search([1, 2])}, "loss",
                                  "min")
