"""Classic policy-gradient family: PG (REINFORCE), A2C, A3C.

Reference analogs: rllib/algorithms/pg (plain policy gradient on
monte-carlo returns), rllib/algorithms/a2c (synchronous advantage
actor-critic — one SGD pass per rollout round) and rllib/algorithms/a3c
(asynchronous: each worker's rollout triggers an immediate learner
update and a weight push back to just that worker).

All three ride the PPO stack — the unclipped PPO surrogate evaluated at
the sampling policy IS the vanilla policy-gradient estimator (ratio ==
1 ⇒ ∇ E[ratio·adv] == E[∇logπ·adv]), so a single learner update with
clip_param=∞ and one SGD pass
gives exactly A2C/PG semantics while reusing the PPO update.
A3C keeps its own rollout actors and consumes fragments as they land
(``ray_tpu_torch.wait``) — the asynchrony lives in the task layer, the
update stays one call on the learner's device.  A copy of
``ray_tpu/rllib/pg.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np

import ray_tpu_torch as rt
from ray_tpu_torch.rllib import sample_batch as sb
from ray_tpu_torch.rllib.algorithm import Algorithm
from ray_tpu_torch.rllib.ppo import (PPO, PPOConfig, _introspect_spaces,
                                     standardize_advantages)
from ray_tpu_torch.rllib.policy import JaxPolicy
from ray_tpu_torch.rllib.sample_batch import SampleBatch
from ray_tpu_torch.rllib.worker_set import WorkerSet

#: clip wide enough that the PPO clip term never binds — the surrogate
#: degrades to the plain importance-weighted policy gradient
_NO_CLIP = 1e9


@dataclasses.dataclass
class A2CConfig(PPOConfig):
    """Synchronous advantage actor-critic (reference:
    rllib/algorithms/a2c/a2c.py — PPO's data path with a single
    unclipped SGD pass per round)."""
    clip_param: float = _NO_CLIP
    num_sgd_iter: int = 1
    entropy_coeff: float = 0.01


class A2C(PPO):
    _config_cls = A2CConfig


@dataclasses.dataclass
class PGConfig(PPOConfig):
    """Vanilla REINFORCE (reference: rllib/algorithms/pg/pg.py): the
    gradient signal is the monte-carlo return-to-go, no advantage
    standardization, no value-function term, no entropy bonus."""
    clip_param: float = _NO_CLIP
    num_sgd_iter: int = 1
    vf_coeff: float = 0.0
    entropy_coeff: float = 0.0
    lam: float = 1.0            # GAE(λ=1) ⇒ value_targets = returns


class PG(PPO):
    _config_cls = PGConfig

    def _prepare_batch(self, batch: SampleBatch) -> None:
        # REINFORCE weights log-probs by the raw discounted
        # return-to-go (GAE(1) value targets), not the standardized
        # baseline-subtracted advantage.
        batch[sb.ADVANTAGES] = np.asarray(batch[sb.VALUE_TARGETS],
                                          np.float32)


@dataclasses.dataclass
class A3CConfig(PPOConfig):
    clip_param: float = _NO_CLIP
    num_sgd_iter: int = 1
    #: updates applied per training_step() call (each consumes ONE
    #: worker's fragment as it lands)
    updates_per_iter: int = 4


class A3C(Algorithm):
    """Asynchronous advantage actor-critic (reference:
    rllib/algorithms/a3c/a3c.py sample_and_compute_grads): rollouts are
    in flight on every worker at all times; whichever fragment lands
    first is applied immediately and ONLY that worker gets the fresh
    weights — other workers keep sampling under weights at most one
    update stale (the hogwild trade A3C makes for wall-clock)."""

    _config_cls = A3CConfig

    def setup(self, config: A3CConfig) -> None:
        _introspect_spaces(config)
        spec = config.policy_spec()
        from ray_tpu_torch.rllib.algorithm import learner_mesh

        self.learner_policy = JaxPolicy(
            spec, seed=config.seed,
            mesh=learner_mesh(config.learner_devices),
            device=config.learner_device)
        self.workers = WorkerSet(
            num_workers=config.num_workers, env=config.env,
            env_config=config.env_config, policy_spec=spec,
            num_envs_per_worker=config.num_envs_per_worker,
            rollout_fragment_length=config.rollout_fragment_length,
            gamma=config.gamma, lam=config.lam,
            num_cpus_per_worker=config.num_cpus_per_worker,
            seed=config.seed,
            observation_filter=config.observation_filter)
        self.workers.sync_weights(self.learner_policy.get_weights())
        #: fragment future → worker, kept saturated
        self._inflight = {w.sample.remote(): w
                          for w in self.workers.workers}

    def training_step(self) -> Dict[str, Any]:
        stats: Dict[str, Any] = {}
        steps = 0
        for _ in range(self.config.updates_per_iter):
            ready, _ = rt.wait(list(self._inflight), num_returns=1,
                                    timeout=300.0)
            if not ready:
                raise TimeoutError("no rollout arrived within 300s")
            ref = ready[0]
            worker = self._inflight.pop(ref)
            batch = rt.get(ref, timeout=300.0)
            standardize_advantages(batch)
            stats = self.learner_policy.learn_on_batch(batch)
            steps += batch.count
            # fresh weights to the worker that just reported; relaunch
            worker.set_weights.remote(
                rt.put(self.learner_policy.get_weights()))
            self._inflight[worker.sample.remote()] = worker
        if self.config.observation_filter != "NoFilter":
            self._filter_state = self.workers.sync_filters(
                getattr(self, "_filter_state", None))
        self._episode_returns.extend(self.workers.episode_returns())
        stats["timesteps_this_iter"] = steps
        return stats

    def cleanup(self) -> None:
        self.workers.stop()
