"""RolloutWorker: CPU actor that steps envs with the current policy and
emits GAE-processed SampleBatches.

Reference analog: rllib/evaluation/rollout_worker.py:134 (:779 sample)
with the SyncSampler loop (evaluation/sampler.py:145).  The sampling
loop is fully batched: a VectorEnv steps all copies in one call
(vector_env.py — natively-batched numpy physics where available), a
connector pipeline (connectors.py) adapts obs/actions in (N, ...)
arrays, and the policy runs ONE forward per timestep.  No per-env
python inside the hot loop — the card never appears here either; rollout
workers are the horizontally-scaled CPU half of the design.

A copy of ``ray_tpu/rllib/rollout_worker.py``.  The worker's policy
runs on the CPU (``device="cpu"``, where the JAX package forces
``JAX_PLATFORMS=cpu``); a WorkerSet starts workers as actors with no
card granted.  ``_make_env`` builds the in-repo envs as single envs
(``_SingleEnv`` over a one-copy VectorEnv) and imports gymnasium only
for an env id that is not in the repo.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from ray_tpu_torch.rllib import sample_batch as sb
from ray_tpu_torch.rllib.connectors import (ObsFilter,
                                            default_action_pipeline,
                                            default_obs_pipeline)
from ray_tpu_torch.rllib.policy import (JaxPolicy, PolicySpec, STATE_C,
                                        STATE_H)
from ray_tpu_torch.rllib.sample_batch import SampleBatch, compute_gae
from ray_tpu_torch.rllib.vector_env import make_vector_env


#: env ids the repo implements (make_vector_env builds them natively)
IN_REPO_ENVS = ("CartPole-v1", "MinAtarBreakout", "RepeatPrev")


class _SingleEnv:
    """gymnasium's single-env ``reset``/``step`` over a one-copy
    VectorEnv (an in-repo env id).  The vector env resets a finished
    copy inside ``step``; a caller stops at ``terminated``/``truncated``
    or calls ``reset`` as with a gym env."""

    def __init__(self, venv: Any):
        self.venv = venv
        self.observation_space = venv.observation_space
        self.action_space = venv.action_space

    def reset(self, seed: Optional[int] = None):
        return self.venv.vector_reset(seed=seed)[0], {}

    def step(self, action):
        obs, rew, term, trunc, _ = self.venv.vector_step(
            np.asarray(action)[None])
        return obs[0], float(rew[0]), bool(term[0]), bool(trunc[0]), {}

    def close(self) -> None:
        self.venv.close()


def _make_env(env_name_or_creator, env_config):
    if callable(env_name_or_creator):
        return env_name_or_creator(env_config or {})
    if env_name_or_creator in IN_REPO_ENVS:
        return _SingleEnv(make_vector_env(env_name_or_creator, env_config,
                                          1))
    import gymnasium as gym

    return gym.make(env_name_or_creator)


class AsyncSampler:
    """Background-thread fragment collector (reference analog:
    rllib/evaluation/sampler.py:317 AsyncSampler): env stepping runs in
    a daemon thread that keeps a small bounded queue of completed
    fragments, so the worker's sample() RPC hands back a READY fragment
    instead of stepping envs inline — the env walltime overlaps the
    learner round-trip.  Weight updates swap the policy's param pytree
    between forward calls (an atomic reference assignment), so a popped
    fragment can lag the latest set_weights by up to queue_size+1 weight
    syncs — the off-policyness the reference's async sampler accepts."""

    def __init__(self, sample_fn, queue_size: int = 2):
        import queue as _queue
        import threading

        self._q: Any = _queue.Queue(maxsize=queue_size)
        self._stop = threading.Event()
        self._sample_fn = sample_fn
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while not self._stop.is_set():
            try:
                batch = self._sample_fn()
            except BaseException as e:  # noqa: BLE001 — surface to caller
                self._put_until_stopped(e)
                return
            if not self._put_until_stopped(batch):
                return

    def _put_until_stopped(self, item) -> bool:
        import queue as _queue

        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.5)
                return True
            except _queue.Full:
                continue
        return False

    def get_batch(self, timeout: float = 300.0) -> SampleBatch:
        out = self._q.get(timeout=timeout)
        if isinstance(out, BaseException):
            # the sampler thread died — re-raise its error promptly
            # instead of timing out on an empty queue forever
            raise out
        return out

    def stop(self):
        self._stop.set()


class RolloutWorker:
    def __init__(self, *, env: Any, env_config: Optional[Dict] = None,
                 policy_spec: PolicySpec, num_envs: int = 1,
                 gamma: float = 0.99, lam: float = 0.95,
                 rollout_fragment_length: int = 200, seed: int = 0,
                 observation_filter: str = "NoFilter",
                 async_sampling: bool = False,
                 num_threads: Optional[int] = None):
        """``num_threads``: torch's intra-op threads in this process, the
        CPUs an actor was granted (WorkerSet passes them).  torch's
        default, a thread per core in each worker and in the learner,
        oversubscribes the host: the policy's per-step forward is a few
        small products, and two MinAtar workers sampled an order of
        magnitude slower with it."""
        if num_threads:
            import torch

            torch.set_num_threads(num_threads)
        self.venv = make_vector_env(env, env_config, num_envs, seed=seed)
        self.num_envs = self.venv.num_envs
        self._env_spec = (env, env_config, seed)  # for the lazy eval env
        self._eval_env = None
        self.policy = JaxPolicy(policy_spec, seed=seed, device="cpu")
        continuous = getattr(policy_spec, "continuous", False)

        self.gamma = gamma
        self.lam = lam
        self.fragment = rollout_fragment_length
        if getattr(self.policy, "needs_sequences", False):
            L = self.policy.spec.max_seq_len
            if rollout_fragment_length % L:
                raise ValueError(
                    f"rollout_fragment_length {rollout_fragment_length} "
                    f"must be a multiple of max_seq_len {L} for "
                    "recurrent/attention policies")
        self._raw_obs = self.venv.vector_reset(seed=seed)
        self._ep_rewards = np.zeros(self.num_envs, np.float64)
        self.episode_returns: List[float] = []
        policy_obs_shape = getattr(policy_spec, "obs_shape_", None) or \
            (getattr(policy_spec, "obs_dim", 0),)
        self.obs_pipeline = default_obs_pipeline(
            np.shape(self._raw_obs[0]), observation_filter,
            preserve_shape=len(policy_obs_shape) == 3)
        self.action_pipeline = default_action_pipeline(
            self.venv.action_space, continuous)
        if async_sampling and observation_filter not in (
                None, "", "NoFilter"):
            # the sampler thread and filter-sync RPCs would mutate the
            # running statistics concurrently (torn deltas)
            raise ValueError(
                "async_sampling does not compose with observation "
                "filters; normalize in the env wrapper instead")
        self._async_wanted = async_sampling
        self._async_sampler: Optional[AsyncSampler] = None

    def set_weights(self, weights) -> None:
        self.policy.set_weights(weights)

    def sample(self) -> SampleBatch:
        """Next fragment: from the background AsyncSampler thread when
        async_sampling is on, else collected inline.  The thread starts
        LAZILY on the first sample() so the initial sync_weights lands
        before any fragment is collected."""
        if self._async_wanted:
            if self._async_sampler is None:
                self._async_sampler = AsyncSampler(self._collect)
            return self._async_sampler.get_batch()
        return self._collect()

    def _collect(self) -> SampleBatch:
        """One fragment per env copy, GAE-postprocessed + concatenated.
        Every step is batched: connector → one policy forward →
        one vector_step."""
        n_env = self.num_envs
        T = self.fragment
        continuous = getattr(self.policy.spec, "continuous", False)
        obs0 = self.obs_pipeline(self._raw_obs, update=False)
        obs_buf = np.zeros((T,) + obs0.shape, np.float32)
        if continuous:
            act_buf = np.zeros((T, n_env, self.policy.spec.n_actions),
                               np.float32)
        else:
            act_buf = np.zeros((T, n_env), np.int64)
        rew_buf = np.zeros((T, n_env), np.float32)
        done_buf = np.zeros((T, n_env), np.bool_)
        logp_buf = np.zeros((T, n_env), np.float32)
        vf_buf = np.zeros((T, n_env), np.float32)
        recurrent = self.policy.is_recurrent
        chunked = getattr(self.policy, "needs_sequences", recurrent)
        if recurrent:
            cell = self.policy.spec.lstm_cell_size
            # carry entering each step, recorded so training chunks can
            # start BPTT from the true rollout state (reference:
            # rnn_sequencing state_in columns)
            sh_buf = np.zeros((T, n_env, cell), np.float32)
            sc_buf = np.zeros((T, n_env, cell), np.float32)

        for t in range(T):
            obs = self.obs_pipeline(self._raw_obs)
            if recurrent:
                h, c = self.policy.get_state(n_env)
                sh_buf[t], sc_buf[t] = h, c
            actions, logp, vf = self.policy.compute_actions(obs)
            obs_buf[t] = obs
            act_buf[t] = actions
            logp_buf[t] = logp
            vf_buf[t] = vf
            env_actions = self.action_pipeline(actions) \
                if continuous else actions
            raw2, rews, terms, truncs, infos = \
                self.venv.vector_step(env_actions)
            rew_buf[t] = rews
            self._ep_rewards += rews
            boot = truncs & ~terms
            if boot.any():
                # truncation: fold gamma*V(final_obs) into the reward,
                # then cut the GAE chain — otherwise the next episode's
                # reset value leaks across the boundary
                fin = self.obs_pipeline(infos["final_obs"][boot],
                                        update=False)
                rew_buf[t, boot] += self.gamma * np.asarray(
                    self.policy.value(fin, rows=boot), np.float32)
            done = terms | truncs
            done_buf[t] = done
            if done.any():
                self.episode_returns.extend(
                    self._ep_rewards[done].tolist())
                self._ep_rewards[done] = 0.0
                if chunked:
                    # LSTM: zero carries; attention: advance the
                    # episode-start marker (segment mask alignment)
                    self.policy.reset_state_where(done)
            self._raw_obs = raw2

        last_obs = self.obs_pipeline(self._raw_obs, update=False)
        last_vf = self.policy.value(last_obs)

        parts = []
        for i in range(n_env):
            adv, vt = compute_gae(rew_buf[:, i], vf_buf[:, i],
                                  done_buf[:, i], float(last_vf[i]),
                                  gamma=self.gamma, lam=self.lam)
            data = {
                sb.OBS: obs_buf[:, i], sb.ACTIONS: act_buf[:, i],
                sb.REWARDS: rew_buf[:, i], sb.DONES: done_buf[:, i],
                sb.ACTION_LOGP: logp_buf[:, i], sb.VF_PREDS: vf_buf[:, i],
                sb.ADVANTAGES: adv, sb.VALUE_TARGETS: vt,
            }
            if chunked:
                # chunk the fragment into max_seq_len sequences whose
                # rows are (L, ...) slices; LSTM chunks also carry their
                # recorded initial states (attention context rebuilds
                # from obs + dones alone)
                L = self.policy.spec.max_seq_len
                if T % L:
                    raise ValueError(
                        f"rollout_fragment_length {T} must be a "
                        f"multiple of max_seq_len {L}")
                n_chunks = T // L
                data = {k: v.reshape((n_chunks, L) + v.shape[1:])
                        for k, v in data.items()}
                if recurrent:
                    starts = np.arange(0, T, L)
                    data[STATE_H] = sh_buf[starts, i]
                    data[STATE_C] = sc_buf[starts, i]
            parts.append(SampleBatch(data))
        return SampleBatch.concat_samples(parts)

    def pop_episode_returns(self) -> List[float]:
        out = self.episode_returns
        self.episode_returns = []
        return out

    # -- evaluation --------------------------------------------------------

    def evaluate(self, num_episodes: int,
                 max_steps: int = 10_000) -> Dict[str, float]:
        """Greedy-policy evaluation episodes (reference: the dedicated
        evaluation WorkerSet driven with explore=False,
        algorithm.py evaluate()).  Runs on a separate env so training
        rollout state is untouched; actions are deterministic
        (argmax / Gaussian mean), observations pass through the same
        connector pipeline with filter statistics FROZEN."""
        if getattr(self, "_eval_env", None) is None:
            self._eval_env = make_vector_env(
                self._env_spec[0], self._env_spec[1],
                min(num_episodes, 8), seed=self._env_spec[2] + 77_000)
        venv = self._eval_env
        n = venv.num_envs
        # fixed-seed reset per call: same weights → same eval result
        # (the recurrent eval carry must reset with it)
        self.policy.reset_eval_state()
        raw = venv.vector_reset(seed=self._env_spec[2] + 77_000)
        ep_rew = np.zeros(n, np.float64)
        ep_len = np.zeros(n, np.int64)
        returns: List[float] = []
        lengths: List[int] = []
        continuous = getattr(self.policy.spec, "continuous", False)
        for _ in range(max_steps):
            obs = self.obs_pipeline(raw, update=False)
            actions = self.policy.compute_deterministic_actions(obs)
            env_actions = self.action_pipeline(actions) \
                if continuous else actions
            raw, rews, terms, truncs, _ = venv.vector_step(env_actions)
            ep_rew += rews
            ep_len += 1
            done = terms | truncs
            if done.any():
                returns.extend(ep_rew[done].tolist())
                lengths.extend(ep_len[done].tolist())
                ep_rew[done] = 0.0
                ep_len[done] = 0
                self.policy.reset_eval_state_where(done)
            if len(returns) >= num_episodes:
                break
        returns = returns[:num_episodes]
        lengths = lengths[:num_episodes]
        return {
            "episode_reward_mean": float(np.mean(returns))
            if returns else float("nan"),
            "episode_reward_min": float(np.min(returns))
            if returns else float("nan"),
            "episode_reward_max": float(np.max(returns))
            if returns else float("nan"),
            "episode_len_mean": float(np.mean(lengths))
            if lengths else float("nan"),
            "episodes_this_eval": len(returns),
        }

    # -- observation-filter sync (FilterManager protocol) -----------------

    def _obs_filter(self) -> Optional[ObsFilter]:
        return self.obs_pipeline.find(ObsFilter)

    def pop_filter_delta(self):
        """Return + clear the since-last-sync delta state.  Filterless
        workers return the NoFilter state dict (NOT None) so
        merge_filter_states can consume mixed worker sets."""
        f = self._obs_filter()
        return f.pop_delta() if f is not None else {"type": "NoFilter"}

    def get_filter_state(self):
        f = self._obs_filter()
        return f.get_state() if f is not None else {"type": "NoFilter"}

    def set_filter_state(self, state) -> None:
        f = self._obs_filter()
        if f is not None:
            f.set_state(state)


class TrajectoryWorker(RolloutWorker):
    """Rollout worker emitting raw time-major fragments for off-policy
    learners (IMPALA): no GAE — v-trace runs on the learner with ITS
    values (reference: rollout collection for impala.py's vtrace path)."""

    def __init__(self, **kwargs):
        if kwargs.get("observation_filter", "NoFilter") not in (
                None, "", "NoFilter"):
            raise ValueError(
                "TrajectoryWorker does not apply observation filters; "
                "normalize in the env wrapper for IMPALA")
        super().__init__(**kwargs)

    def sample_trajectory(self) -> Dict[str, np.ndarray]:
        n_env = self.num_envs
        T = self.fragment
        obs0 = self.obs_pipeline(self._raw_obs, update=False)
        obs_buf = np.zeros((T,) + obs0.shape, np.float32)
        act_buf = np.zeros((T, n_env), np.int64)
        rew_buf = np.zeros((T, n_env), np.float32)
        done_buf = np.zeros((T, n_env), np.bool_)
        logp_buf = np.zeros((T, n_env), np.float32)

        for t in range(T):
            obs = self.obs_pipeline(self._raw_obs)
            actions, logp, _ = self.policy.compute_actions(obs)
            obs_buf[t] = obs
            act_buf[t] = actions
            logp_buf[t] = logp
            raw2, rews, terms, truncs, infos = \
                self.venv.vector_step(actions)
            rew_buf[t] = rews
            self._ep_rewards += rews
            boot = truncs & ~terms
            if boot.any():
                fin = self.obs_pipeline(infos["final_obs"][boot],
                                        update=False)
                rew_buf[t, boot] += self.gamma * np.asarray(
                    self.policy.value(fin), np.float32)
            done = terms | truncs
            done_buf[t] = done
            if done.any():
                self.episode_returns.extend(
                    self._ep_rewards[done].tolist())
                self._ep_rewards[done] = 0.0
            self._raw_obs = raw2

        return {
            "obs": obs_buf, "actions": act_buf, "rewards": rew_buf,
            "dones": done_buf, "behaviour_logp": logp_buf,
            "last_obs": self.obs_pipeline(self._raw_obs, update=False),
        }
