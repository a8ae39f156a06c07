"""The port's RLlib on its runtime (``ray_tpu_torch/rllib/algorithm.py``,
``ppo.py``, ``pg.py``, ``worker_set.py``, ``registry.py``; the Tuner's
launch-by-name and the CLI's ``rllib`` subcommands), with the learner
on the CPU (``learner_device="cpu"``; its default is the card).

PPO, PG, A2C and A3C train 2 iterations on CartPole from CPU rollout
actors (no card granted: ``CUDA_VISIBLE_DEVICES`` empty in them) and
report the JAX package's result keys (its ``Algorithm.train`` run here
over in-process workers).  Checkpoints cross both ways: the JAX
package's ``Algorithm.save`` restores in the port with equal greedy
actions, the port's in the JAX package.  ``Tuner("PPO")`` runs a trial
by name; unknown names raise ValueError and unported ones
NotImplementedError naming their ROADMAP item.  The CLI runs in
subprocesses where gymnasium cannot be imported (a blocking package
first on PYTHONPATH, which the runtime's workers inherit).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import ray_tpu_torch as rt
from ray_tpu.rllib import policy as jpolicy
from ray_tpu.rllib import ppo as jppo
from ray_tpu.rllib import registry as jregistry
from ray_tpu.rllib import rollout_worker as jrw
from ray_tpu_torch import tune
from ray_tpu_torch._private._vendor import cloudpickle as port_cloudpickle
from ray_tpu_torch.rllib import A2C, A2CConfig, A3C, A3CConfig
from ray_tpu_torch.rllib import PG, PGConfig, PPO, PPOConfig
from ray_tpu_torch.rllib import registry, rollout_worker, worker_set
from ray_tpu_torch.scripts import cli

port_cloudpickle.register_pickle_by_value(sys.modules[__name__])

ROOT = Path(__file__).resolve().parents[1]
STORE = 128 * 1024 * 1024
WAIT_S = 120
#: CartPole at hidden (8,): two fragments of 2 x 32 steps an iteration
SMALL = dict(env="CartPole-v1", num_envs_per_worker=2,
             rollout_fragment_length=32, train_batch_size=128,
             minibatch_size=64, num_sgd_iter=2, hidden=(8,), seed=0)


class ProbedWorker(rollout_worker.RolloutWorker):
    """A RolloutWorker that says where it runs."""

    def probe(self):
        return {"cuda_visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
                "device": str(self.policy.device)}


@pytest.fixture(scope="module")
def runtime(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    mp.setenv("RAYTPU_RESULTS_DIR", str(tmp_path_factory.mktemp("results")))
    mp.setattr(worker_set, "RolloutWorker", ProbedWorker)
    rt.init(num_cpus=6, num_gpus=0, object_store_memory=STORE,
            log_to_driver=False)
    yield
    rt.shutdown()
    mp.undo()


class _LocalWorkers:
    """The WorkerSet surface over in-process JAX workers: the JAX
    package's Algorithm.train without its runtime."""

    def __init__(self, workers):
        self.workers = workers

    def sample(self):
        return [w.sample() for w in self.workers]

    def sync_weights(self, weights):
        for w in self.workers:
            w.set_weights(weights)

    def episode_returns(self):
        return [r for w in self.workers for r in w.pop_episode_returns()]

    def stop(self):
        pass


@pytest.fixture(scope="module")
def jax_ppo():
    """The JAX package's PPO at SMALL after one train(), its learner on
    the CPU and one in-process worker."""
    cfg = jppo.PPOConfig(num_workers=1, **SMALL)
    jppo._introspect_spaces(cfg)
    algo = object.__new__(jppo.PPO)
    algo.config, algo.iteration = cfg, 0
    algo._timesteps_total, algo._episode_returns = 0, []
    algo.learner_policy = jpolicy.JaxPolicy(cfg.policy_spec(), seed=0)
    algo.workers = _LocalWorkers([jrw.RolloutWorker(
        env=cfg.env, policy_spec=cfg.policy_spec(), num_envs=2,
        rollout_fragment_length=32, seed=1000)])
    algo.workers.sync_weights(algo.learner_policy.get_weights())
    return algo, algo.train()


ALGOS = {"PPO": (PPO, PPOConfig, 2), "PG": (PG, PGConfig, 1),
         "A2C": (A2C, A2CConfig, 1), "A3C": (A3C, A3CConfig, 2)}


@pytest.mark.parametrize("name", list(ALGOS))
def test_algorithm_trains_on_cpu_workers_with_jax_keys(runtime, jax_ppo,
                                                       name):
    cls, cfg_cls, workers = ALGOS[name]
    algo = cls(cfg_cls(num_workers=workers, learner_device="cpu", **SMALL))
    try:
        results = [algo.train() for _ in range(2)]
        probes = rt.get([w.probe.remote() for w in algo.workers.workers],
                        timeout=WAIT_S)
        if name == "A3C":
            # no evaluation worker: the CLI's greedy in-process rollout
            greedy = cli._greedy_rollout_eval(algo, "CartPole-v1", 2)
            assert greedy["episodes"] == 2
            assert np.isfinite(greedy["episode_reward_mean"])
    finally:
        algo.stop()
    assert set(results[-1]) == set(jax_ppo[1]), \
        set(results[-1]) ^ set(jax_ppo[1])
    assert [r["training_iteration"] for r in results] == [1, 2]
    assert results[-1]["timesteps_total"] >= 2 * (
        128 if name != "A3C" else 4 * 64)
    assert all(np.isfinite(results[-1][k]) for k in
               ("policy_loss", "vf_loss", "entropy", "total_loss"))
    assert str(algo.learner_policy.device) == "cpu"
    assert probes == [{"cuda_visible": "", "device": "cpu"}] * workers


def test_checkpoints_cross_between_the_packages(runtime, jax_ppo, tmp_path):
    """The JAX package's checkpoint restores in the port (same state
    keys; greedy actions equal) and the port's in the JAX package; the
    port's save/restore keeps weights, counters and filter state."""
    japgo = jax_ppo[0]
    jpath = japgo.save(str(tmp_path / "jax"))
    obs = np.random.RandomState(0).randn(16, 4).astype(np.float32)
    cfg = PPOConfig(num_workers=1, learner_device="cpu",
                    observation_filter="MeanStdFilter", **SMALL)
    algo = PPO(cfg)
    try:
        algo.restore(jpath)
        assert algo.iteration == japgo.iteration == 1
        np.testing.assert_array_equal(
            algo.learner_policy.compute_deterministic_actions(obs),
            np.asarray(japgo.learner_policy.compute_deterministic_actions(
                obs)))
        algo.train()
        assert algo._filter_state["type"] == "MeanStdFilter"
        path = algo.save(str(tmp_path / "port"))
        evaluation = algo.evaluate()
        want = algo.learner_policy.get_weights()
    finally:
        algo.stop()
    assert evaluation["episodes_this_eval"] == cfg.evaluation_num_episodes
    again = PPO(PPOConfig(num_workers=0, learner_device="cpu", **SMALL))
    try:
        again.restore(path)
        assert again.iteration == 2
        for k, v in algo._filter_state.items():
            np.testing.assert_array_equal(np.asarray(
                again._filter_state[k]), np.asarray(v))
        import jax

        for a, b in zip(jax.tree_util.tree_leaves(
                again.learner_policy.get_weights()),
                jax.tree_util.tree_leaves(want)):
            np.testing.assert_array_equal(a, b)
    finally:
        again.stop()
    japgo.workers = None        # in-process workers: nothing to push to
    japgo.restore(path)
    np.testing.assert_array_equal(
        np.asarray(japgo.learner_policy.compute_deterministic_actions(obs)),
        again.learner_policy.compute_deterministic_actions(obs))
    with pytest.raises(ValueError, match="saved by PPO"):
        A3C.restore(object.__new__(A3C), path)


def test_tuner_by_name_and_the_registry(runtime):
    grid = tune.Tuner("PPO", param_space={
        **SMALL, "num_workers": 1, "learner_device": "cpu",
        "training_iterations": 2}).fit()
    trial = grid.trials[0]
    assert trial.error is None, trial.error
    assert trial.last_result["training_iteration"] == 2
    assert "episode_reward_mean" in trial.last_result
    assert registry.registered_algorithms() == \
        jregistry.registered_algorithms()
    from ray_tpu_torch.tune.tuner import _algorithm_trainable

    with pytest.raises(ValueError, match="unknown algorithm"):
        _algorithm_trainable("NoSuchAlgo")
    for name, part in (("DQN", "b"), ("IMPALA", "b"), ("SAC", "c"),
                       ("MultiAgentPPO", "c"), ("AlphaZero", "d"),
                       ("BanditLinTS", "d")):
        with pytest.raises(NotImplementedError,
                           match=rf"item 7\.13 \({part}\)"):
            tune.Tuner(name)
    import ray_tpu_torch.rllib as rllib

    with pytest.raises(NotImplementedError, match=r"7\.13 \(c\).*td3"):
        rllib.TD3Config
    with pytest.raises(NotImplementedError, match=r"7\.13 \(e\)"):
        PPO(PPOConfig(learner_devices=2, learner_device="cpu", **SMALL))


@pytest.fixture(scope="module")
def no_gym_env(tmp_path_factory):
    """An environment whose PYTHONPATH starts with a gymnasium that
    raises ImportError."""
    blocker = tmp_path_factory.mktemp("blocker")
    (blocker / "gymnasium").mkdir()
    (blocker / "gymnasium" / "__init__.py").write_text(
        "raise ImportError('gymnasium is blocked here')\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(blocker), str(ROOT), env.get("PYTHONPATH", "")])
    return env


def _rllib(env, *args):
    return subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch", "rllib", *args],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)


def test_cli_train_evaluate_algorithms_without_gymnasium(no_gym_env,
                                                         tmp_path):
    config = json.dumps({**SMALL, "hidden": [8], "num_workers": 1,
                         "learner_device": "cpu"})
    ckpt = tmp_path / "ckpt"
    out = _rllib(no_gym_env, "train", "--run", "PPO", "--env",
                 "CartPole-v1", "--stop-iters", "2", "--config", config,
                 "--checkpoint-dir", str(ckpt))
    assert out.returncode == 0, out.stderr[-3000:]
    lines = [json.loads(ln) for ln in out.stdout.splitlines()
             if ln.startswith("{")]
    assert [ln["training_iteration"] for ln in lines] == [1, 2]
    assert set(lines[0]) == {"training_iteration", "timesteps_total",
                             "episode_reward_mean", "episodes_total"}
    assert "checkpoint saved" in out.stdout
    out = _rllib(no_gym_env, "evaluate", str(ckpt), "--run", "PPO",
                 "--env", "CartPole-v1", "--episodes", "2", "--config",
                 config)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads([ln for ln in out.stdout.splitlines()
                         if ln.startswith("{")][-1])
    assert result["episodes_this_eval"] == 2
    out = _rllib(no_gym_env, "algorithms")
    assert out.returncode == 0, out.stderr[-3000:]
    assert tuple(out.stdout.split()) == jregistry.registered_algorithms()
    with pytest.raises(NotImplementedError,
                       match=r"queue 1 item 7\.13 \(c\)"):
        cli.main(["rllib", "train", "--run", "SAC", "--env",
                  "CartPole-v1"])
