"""The port's Tuner and ``fit()`` on its runtime (``ray_tpu_torch/tune/
tuner.py``, ``trial_runner.py``, ``trainable_adapter.py``) against the
JAX package's, on both runtimes at once.

Where the ``Result`` is the thing compared, the scenario runs in both
packages (tests/test_tune.py's cases): ``fit()`` through the one-trial
Tuner (metrics_history with ``_round`` and ``training_iteration``, the
checkpoint), a grid search and its best result, ASHA one trial at a
time, a Trainer as the Tuner's trainable.  The rest run on the port
alone with the reference test's assertions: an erroring trial
isolated, a crashed trial retried from its checkpoint, the
experiment's checkpoint and ``Tuner.restore``, whose saved state is
also held to the JAX package's ``TrialRunner.save_state`` on the same
trial table.
"""

import copy
import os
import sys

import cloudpickle
import pytest

import ray_tpu
import ray_tpu_torch
from ray_tpu import train as jtrain
from ray_tpu import tune as jtune
from ray_tpu.tune import trial_runner as jrunner
from ray_tpu_torch import train as ttrain
from ray_tpu_torch import tune as ttune
from ray_tpu_torch._private._vendor import cloudpickle as port_cloudpickle
from ray_tpu_torch.tune import trial_runner as trunner
# autouse: the JAX runtime's loops settle before they stop
from tests.test_torch_jax_teardown import settle_jax_loops  # noqa: F401

port_cloudpickle.register_pickle_by_value(sys.modules[__name__])
cloudpickle.register_pickle_by_value(sys.modules[__name__])

STORE = 128 * 1024 * 1024


@pytest.fixture(scope="module")
def runtimes(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    mp.setenv("RAYTPU_RESULTS_DIR", str(tmp_path_factory.mktemp("results")))
    ray_tpu.init(num_cpus=4, object_store_memory=STORE, log_to_driver=False)
    ray_tpu_torch.init(num_cpus=4, num_gpus=0, object_store_memory=STORE,
                       log_to_driver=False)
    yield {"jax": (jtrain, jtune), "torch": (ttrain, ttune)}
    ray_tpu_torch.shutdown()
    ray_tpu.shutdown()
    mp.undo()


def _session(config):
    import importlib

    return importlib.import_module(config["session"])


def _pkg_config(train):
    return {"session": f"{train.__name__.split('.')[0]}.air.session"}


def _two_round_loop(config):
    """tests/test_tune.py::test_trainer_fit_routes_through_tune's loop."""
    session = _session(config)
    for i in range(2):
        session.report({"step": i, "rank": session.get_world_rank()},
                       checkpoint={"i": i} if i == 1 else None)


def test_fit_routes_through_a_one_trial_tuner_as_jax(runtimes):
    results = {}
    for name, (train, _) in runtimes.items():
        results[name] = train.DataParallelTrainer(
            _two_round_loop, train_loop_config=_pkg_config(train),
            scaling_config=train.ScalingConfig(num_workers=2)).fit()
    got, want = results["torch"], results["jax"]
    assert got.error is None and want.error is None
    assert got.metrics_history == want.metrics_history == [
        {"step": 0, "rank": 0, "_round": 0, "training_iteration": 1},
        {"step": 1, "rank": 0, "_round": 1, "training_iteration": 2}]
    assert got.metrics == want.metrics
    assert got.checkpoint.to_dict() == want.checkpoint.to_dict() == {"i": 1}


def _objective(config):
    session = _session(config)
    for i in range(3):
        session.report({"score": config["x"] * (i + 1)})


def _decaying(config):
    session = _session(config)
    for i in range(8):
        session.report({"loss": config["q"] / (i + 1)})


def _histories(grid):
    return sorted((repr(t.config), t.status, t.iteration, t.metrics_history)
                  for t in grid.trials)


def test_grid_search_and_asha_match_jax(runtimes):
    """tests/test_tune.py's grid search (every trial, the best result)
    and its ASHA case, one trial at a time so that the order of the
    reports, and with it ASHA's decisions, is fixed."""
    out = {}
    for name, (train, tune) in runtimes.items():
        cfg = _pkg_config(train)
        grid = tune.Tuner(_objective, param_space={
            **cfg, "x": tune.grid_search([1, 2, 5])}).fit()
        best = grid.get_best_result("score", mode="max")
        asha = tune.Tuner(
            _decaying,
            param_space={**cfg,
                         "q": tune.grid_search([1.0, 2.0, 4.0, 8.0])},
            tune_config=tune.TuneConfig(
                scheduler=tune.ASHAScheduler(metric="loss", mode="min",
                                             max_t=8, grace_period=2,
                                             reduction_factor=2),
                max_concurrent_trials=1)).fit()
        for g in (grid, asha):
            for t in g.trials:
                t.config.pop("session")
        out[name] = (_histories(grid), best.metrics, best.metrics_history,
                     _histories(asha), len(grid.errors), len(asha.errors))
    assert out["torch"] == out["jax"]
    assert out["torch"][1]["score"] == 15
    stopped = [h for h in out["torch"][3] if h[1] == "STOPPED" and h[2] < 8]
    assert stopped, "ASHA stopped no trial early"


def _flaky(config):
    import ray_tpu_torch.air.session as session
    from ray_tpu_torch.air.checkpoint import Checkpoint

    ckpt = session.get_checkpoint()
    start = ckpt.to_dict()["i"] + 1 if ckpt else 0
    for i in range(start, 6):
        if config.get("crash") and i == 3 and start == 0:
            raise RuntimeError("mid-run crash")
        session.report({"i": i}, checkpoint=Checkpoint.from_dict({"i": i}))


def test_trial_errors_are_isolated_and_retried_from_checkpoints(runtimes):
    """test_trial_error_isolated and
    test_trial_fault_tolerance_retries_from_checkpoint, on the port."""
    grid = ttune.Tuner(
        _flaky, param_space={"crash": ttune.grid_search([False, True])},
    ).fit()
    assert len(grid.errors) == 1
    ok = [t for t in grid.trials if t.error is None]
    assert len(ok) == 1 and ok[0].last_result["i"] == 5
    grid = ttune.Tuner(
        _flaky, param_space={"crash": ttune.grid_search([True, True])},
        run_config=ttrain.RunConfig(
            failure_config=ttrain.FailureConfig(max_failures=2))).fit()
    assert not grid.errors
    for t in grid.trials:
        assert t.metrics_history[-1]["i"] == 5 and t.num_failures == 1


def _lr_loop(config):
    session = _session(config)
    session.report({"lr": config["lr"], "base": config["base"]})


def test_a_trainer_as_the_tuners_trainable_as_jax(runtimes):
    """Tuner(trainer): each trial runs the trainer's training_loop with
    its config merged into the loop's (base_trainer.py's as_trainable
    and _apply_trial_config).  The trial itself reports nothing, in
    both packages: as_trainable returns the Result without reporting
    it."""
    out = {}
    for name, (train, tune) in runtimes.items():
        trainer = train.DataParallelTrainer(
            _lr_loop, train_loop_config={**_pkg_config(train), "lr": 0.0,
                                         "base": 7},
            scaling_config=train.ScalingConfig(num_workers=1))
        merged = copy.copy(trainer)
        merged._apply_trial_config({"lr": 0.1})
        assert merged.train_loop_config["lr"] == 0.1
        assert merged.train_loop_config["base"] == 7
        assert trainer.train_loop_config["lr"] == 0.0
        grid = tune.Tuner(trainer, param_space={
            "lr": tune.grid_search([0.1, 0.2])}).fit()
        out[name] = sorted((t.config["lr"], t.status, t.last_result,
                            t.error) for t in grid.trials)
    assert out["torch"] == out["jax"] == [(0.1, "TERMINATED", None, None),
                                          (0.2, "TERMINATED", None, None)]


def test_experiment_checkpoint_and_restore(runtimes, tmp_path):
    """tests/test_tune.py::test_experiment_checkpoint_and_resume on the
    port: the crashed trial resumes from its checkpoint, the finished
    one is not re-run."""
    rc = ttrain.RunConfig(name="exp1", storage_path=str(tmp_path))
    grid = ttune.Tuner(
        _flaky, param_space={"crash": ttune.grid_search([False, True])},
        run_config=rc).fit()
    assert len(grid.errors) == 1
    restored = ttune.Tuner.restore(str(tmp_path / "exp1"), _flaky)
    grid2 = restored.fit()
    assert not grid2.errors
    for t in grid2.trials:
        assert t.metrics_history[-1]["i"] == 5
    clean = [t for t in grid2.trials if not t.config["crash"]][0]
    assert len(clean.metrics_history) == 6


def _trial_table(trial_mod, ckpt_mod):
    trials = []
    for i, status in enumerate(("TERMINATED", "STOPPED", "ERROR",
                                "RUNNING")):
        t = trial_mod.Trial(config={"x": i}, trial_id=f"t{i}")
        t.status = status
        t.metrics_history = [{"i": j, "training_iteration": j + 1}
                             for j in range(i + 1)]
        t.last_result = t.metrics_history[-1]
        t.checkpoint = ckpt_mod.Checkpoint.from_dict({"i": i})
        t.iteration = i + 1
        t.num_failures = i % 2
        t.error = RuntimeError("boom") if status == "ERROR" else None
        trials.append(t)
    return trials


def _snapshot(trials):
    return [(t.trial_id, t.config, t.status, t.metrics_history,
             t.last_result, t.iteration, t.num_failures,
             t.checkpoint.to_dict(),
             t.restore_checkpoint.to_dict() if t.restore_checkpoint
             else None) for t in trials]


def test_saved_experiment_state_loads_as_the_jax_packages(tmp_path):
    """save_state/load_trials on the same trial table, no actors: the
    same trials come back, unfinished ones PENDING with their
    checkpoint to restore from."""
    from ray_tpu.air import checkpoint as jckpt
    from ray_tpu.tune import trial as jtrial
    from ray_tpu_torch.air import checkpoint as tckpt
    from ray_tpu_torch.tune import trial as ttrial

    loaded = {}
    for name, runner, trial_mod, ckpt in (
            ("jax", jrunner, jtrial, jckpt),
            ("torch", trunner, ttrial, tckpt)):
        exp = str(tmp_path / name)
        r = runner.TrialRunner(lambda config: None,
                               _trial_table(trial_mod, ckpt),
                               max_concurrent=1, experiment_dir=exp)
        r.save_state(force=True)
        assert os.path.exists(os.path.join(exp, "experiment_state.pkl"))
        loaded[name] = _snapshot(runner.TrialRunner.load_trials(exp))
    assert loaded["torch"] == loaded["jax"]
    assert [s[2] for s in loaded["torch"]] == ["TERMINATED", "STOPPED",
                                               "PENDING", "PENDING"]
