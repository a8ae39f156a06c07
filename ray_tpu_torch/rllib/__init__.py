"""RL library (reference analog: rllib/) — torch policies, CPU rollout
actors, a learner on the card: the counterpart of ``ray_tpu/rllib/``
(ROADMAP.md queue 1 item 7.13 (a)).

PPO, PG, A2C and A3C with their core (sample batches, filters,
connectors, vector envs, replay buffers, the model catalog, the policy,
rollout workers, the worker set, the algorithm and its registry).
Importing the package imports no torch: its names load at first use,
so the CLI's ``rllib algorithms`` and Tune's launch-by-name resolve a
name without it.  The JAX package's other names (IMPALA, DQN, SAC, ...)
raise NotImplementedError naming the ROADMAP item their module waits
for (``registry.UNPORTED``).
"""

import importlib

#: ported name → its module
_LAZY = {
    "Algorithm": "algorithm", "AlgorithmConfig": "algorithm",
    "JaxPolicy": "policy", "PPO": "ppo", "PPOConfig": "ppo",
    "PG": "pg", "PGConfig": "pg", "A2C": "pg", "A2CConfig": "pg",
    "A3C": "pg", "A3CConfig": "pg",
    "ReplayBuffer": "replay_buffer",
    "PrioritizedReplayBuffer": "replay_buffer",
    "SampleBatch": "sample_batch",
    "AsyncSampler": "rollout_worker", "RolloutWorker": "rollout_worker",
    "TrajectoryWorker": "rollout_worker", "WorkerSet": "worker_set",
}


def __getattr__(name):
    module = _LAZY.get(name)
    if module is None:
        from ray_tpu_torch.rllib.registry import unported_item

        item = unported_item(name)
        if item is not None:
            raise NotImplementedError(
                f"ray_tpu_torch.rllib.{name} is not ported yet: {item}")
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}")
    value = getattr(importlib.import_module(f"{__name__}.{module}"), name)
    globals()[name] = value
    return value


__all__ = list(_LAZY)
