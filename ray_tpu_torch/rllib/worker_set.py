"""WorkerSet: the gang of remote RolloutWorker actors plus a local
learner-side policy (reference analog: rllib/evaluation/worker_set.py:64).

A copy of ``ray_tpu/rllib/worker_set.py`` on the port's runtime: the
workers are CPU actors granted no card (``num_gpus=0``), so their
processes start with ``CUDA_VISIBLE_DEVICES=""`` whoever creates them
(a driver or a Tune trial holding the card)."""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import ray_tpu_torch as rt
from ray_tpu_torch.rllib.policy import PolicySpec
from ray_tpu_torch.rllib.rollout_worker import RolloutWorker
from ray_tpu_torch.rllib.sample_batch import SampleBatch


class WorkerSet:
    def __init__(self, *, num_workers: int, env: Any,
                 env_config: Optional[Dict] = None,
                 policy_spec: PolicySpec,
                 num_envs_per_worker: int = 1,
                 rollout_fragment_length: int = 200,
                 gamma: float = 0.99, lam: float = 0.95,
                 num_cpus_per_worker: float = 1.0, seed: int = 0,
                 observation_filter: str = "NoFilter",
                 worker_cls: Optional[type] = None,
                 async_sampling: bool = False):
        self.num_workers = num_workers
        kwargs = dict(env=env, env_config=env_config,
                      policy_spec=policy_spec,
                      num_envs=num_envs_per_worker, gamma=gamma, lam=lam,
                      rollout_fragment_length=rollout_fragment_length,
                      observation_filter=observation_filter,
                      async_sampling=async_sampling,
                      num_threads=max(1, int(num_cpus_per_worker)))
        remote_cls = rt.remote(num_cpus=num_cpus_per_worker, num_gpus=0)(
            worker_cls or RolloutWorker)
        self.workers = [remote_cls.remote(seed=seed + 1000 * (i + 1),
                                          **kwargs)
                        for i in range(num_workers)]

    def sample(self, timeout: float = 300.0) -> List[SampleBatch]:
        """reference rollout_ops.py:36 synchronous_parallel_sample."""
        return rt.get([w.sample.remote() for w in self.workers],
                      timeout=timeout)

    def sync_weights(self, weights, timeout: float = 60.0) -> None:
        """Broadcast learner weights via one object-store put."""
        ref = rt.put(weights)
        rt.get([w.set_weights.remote(ref) for w in self.workers],
               timeout=timeout)

    def episode_returns(self, timeout: float = 60.0) -> List[float]:
        parts = rt.get(
            [w.pop_episode_returns.remote() for w in self.workers],
            timeout=timeout)
        return [r for p in parts for r in p]

    def sync_filters(self, global_state, timeout: float = 60.0):
        """Pull each worker's since-last-sync DELTA, merge into the
        coordinator's global state, broadcast the merged state back;
        returns the new global state (reference:
        FilterManager.synchronize — deltas, never full states, so shared
        history is counted exactly once)."""
        from ray_tpu_torch.rllib.filters import merge_filter_states

        deltas = rt.get(
            [w.pop_filter_delta.remote() for w in self.workers],
            timeout=timeout)
        merged = merge_filter_states(
            ([global_state] if global_state else []) + deltas)
        if merged.get("type") == "NoFilter":
            return global_state
        rt.get([w.set_filter_state.remote(merged) for w in self.workers],
               timeout=timeout)
        return merged

    def stop(self) -> None:
        for w in self.workers:
            try:
                rt.kill(w)
            except Exception:  # noqa: BLE001
                pass
        self.workers = []
