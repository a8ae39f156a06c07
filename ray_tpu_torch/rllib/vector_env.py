"""Vectorized environments: N env copies stepped as ONE batched call.

Reference analog: rllib/env/vector_env.py:24 (VectorEnv /
_VectorizedGymEnv).  Redesigned numpy-first instead of list-of-envs
first: the interface speaks (N, ...) arrays end to end, auto-resets
finished sub-envs internally (the pre-reset terminal observation is
surfaced in ``infos["final_obs"]`` for truncation bootstrapping), and
natively-batched envs implement dynamics directly over the batch axis —
one numpy expression steps all N copies, which is where the rollout
samples/s comes from (a python for-loop over gym envs caps a CartPole
worker at ~10k steps/s; the batched physics below does >100k).

A copy of ``ray_tpu/rllib/vector_env.py``.  The in-repo envs build
their spaces from ``Box`` and ``Discrete`` below, the slice of
``gymnasium.spaces`` they use, so they run where gymnasium is not
installed; gymnasium is imported only for an env id that is not in the
repo.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np


class Box:
    """A bounded box of ``shape`` (``gymnasium.spaces.Box``'s
    attributes: ``low`` and ``high`` broadcast to the shape, ``shape``,
    ``dtype``)."""

    def __init__(self, low, high, shape: Tuple[int, ...], dtype=np.float32):
        self.shape = tuple(shape)
        self.dtype = np.dtype(dtype)
        self.low = np.full(self.shape, low, self.dtype)
        self.high = np.full(self.shape, high, self.dtype)

    def __repr__(self):
        return f"Box({self.low.min()}, {self.high.max()}, {self.shape}, " \
               f"{self.dtype})"


class Discrete:
    """``n`` actions 0..n-1 (``gymnasium.spaces.Discrete``'s ``n``,
    ``shape`` () and ``dtype`` int64)."""

    def __init__(self, n: int):
        self.n = np.int64(n)
        self.shape: Tuple[int, ...] = ()
        self.dtype = np.dtype(np.int64)

    def __repr__(self):
        return f"Discrete({self.n})"


class VectorEnv:
    """Batched env interface.

    ``vector_step`` consumes an (N,) or (N, action_dim) action array and
    returns ``(obs, rewards, terminateds, truncateds, infos)`` where the
    first four are (N, ...) arrays.  Sub-envs that finish are reset
    INSIDE the call; ``obs`` rows for finished envs are the fresh
    post-reset observations, and ``infos["final_obs"]`` holds the
    pre-reset terminal observation for every finished row (needed to
    bootstrap truncated episodes with V(s_T))."""

    num_envs: int
    observation_space: Any = None  # single-env spaces
    action_space: Any = None

    def vector_reset(self, seed: Optional[int] = None) -> np.ndarray:
        raise NotImplementedError

    def vector_step(self, actions) -> Tuple[np.ndarray, np.ndarray,
                                            np.ndarray, np.ndarray, Dict]:
        raise NotImplementedError

    def close(self) -> None:
        pass


class SyncVectorEnv(VectorEnv):
    """Fallback vectorization: a python loop over per-copy gym envs, for
    envs without a batched implementation.  Same interface/semantics as
    the native path so workers never branch."""

    def __init__(self, make_env: Callable[[], Any], num_envs: int,
                 first_env: Any = None):
        self.envs = ([first_env] if first_env is not None else []) + \
            [make_env() for _ in range(num_envs
                                       - (first_env is not None))]
        self.num_envs = num_envs
        self.observation_space = getattr(self.envs[0],
                                         "observation_space", None)
        self.action_space = getattr(self.envs[0], "action_space", None)

    def vector_reset(self, seed=None):
        obs = [e.reset(seed=None if seed is None else seed + i)[0]
               for i, e in enumerate(self.envs)]
        return np.asarray(obs, np.float32)

    def vector_step(self, actions):
        n = self.num_envs
        obs_out, rews = [None] * n, np.zeros(n, np.float32)
        terms = np.zeros(n, np.bool_)
        truncs = np.zeros(n, np.bool_)
        final_obs = [None] * n
        for i, env in enumerate(self.envs):
            o2, r, term, trunc, _ = env.step(actions[i])
            rews[i], terms[i], truncs[i] = r, term, trunc
            if term or trunc:
                final_obs[i] = np.asarray(o2, np.float32)
                o2 = env.reset()[0]
            obs_out[i] = o2
        obs_arr = np.asarray(obs_out, np.float32)
        fo = np.array([obs_arr[i] if f is None else f
                       for i, f in enumerate(final_obs)], np.float32)
        return obs_arr, rews, terms, truncs, {"final_obs": fo}

    def close(self):
        for e in self.envs:
            if hasattr(e, "close"):
                e.close()


class CartPoleVecEnv(VectorEnv):
    """Natively-batched CartPole-v1: the classic cart-pole swing-up
    physics (Barto/Sutton/Anderson 1983 equations) over an (N, 4) state
    matrix — every step is a handful of vectorized numpy expressions.

    Matches the gymnasium CartPole-v1 task spec: force ±10 N, Euler
    integration at tau=0.02 s, termination at |x|>2.4 or |theta|>12°,
    truncation at 500 steps, reward 1 per step, uniform(-0.05, 0.05)
    initial state."""

    _GRAVITY = 9.8
    _M_CART = 1.0
    _M_POLE = 0.1
    _LEN = 0.5            # half pole length
    _FORCE = 10.0
    _TAU = 0.02
    _X_LIMIT = 2.4
    _THETA_LIMIT = 12 * np.pi / 180
    _MAX_STEPS = 500

    def __init__(self, num_envs: int, seed: int = 0):
        self.num_envs = num_envs
        self.observation_space = Box(-np.inf, np.inf, (4,), np.float32)
        self.action_space = Discrete(2)
        self._rng = np.random.RandomState(seed)
        self._state = np.zeros((num_envs, 4), np.float64)
        self._steps = np.zeros(num_envs, np.int64)

    def _reset_rows(self, mask: np.ndarray) -> None:
        n = int(mask.sum())
        if n:
            self._state[mask] = self._rng.uniform(
                -0.05, 0.05, size=(n, 4))
            self._steps[mask] = 0

    def vector_reset(self, seed=None):
        if seed is not None:
            self._rng = np.random.RandomState(seed)
        self._reset_rows(np.ones(self.num_envs, np.bool_))
        return self._state.astype(np.float32)

    def vector_step(self, actions):
        x, x_dot, th, th_dot = self._state.T
        force = np.where(np.asarray(actions) == 1, self._FORCE,
                         -self._FORCE)
        cos, sin = np.cos(th), np.sin(th)
        total_m = self._M_CART + self._M_POLE
        pole_ml = self._M_POLE * self._LEN
        temp = (force + pole_ml * th_dot ** 2 * sin) / total_m
        th_acc = (self._GRAVITY * sin - cos * temp) / (
            self._LEN * (4.0 / 3.0 - self._M_POLE * cos ** 2 / total_m))
        x_acc = temp - pole_ml * th_acc * cos / total_m
        # Euler, update-then-integrate order of the classic task
        x = x + self._TAU * x_dot
        x_dot = x_dot + self._TAU * x_acc
        th = th + self._TAU * th_dot
        th_dot = th_dot + self._TAU * th_acc
        self._state = np.stack([x, x_dot, th, th_dot], axis=1)
        self._steps += 1

        terms = (np.abs(x) > self._X_LIMIT) | (np.abs(th)
                                               > self._THETA_LIMIT)
        truncs = ~terms & (self._steps >= self._MAX_STEPS)
        rews = np.ones(self.num_envs, np.float32)
        final_obs = self._state.astype(np.float32)
        done = terms | truncs
        self._reset_rows(done)
        return (self._state.astype(np.float32), rews,
                terms, truncs, {"final_obs": final_obs})


def make_vector_env(env: Any, env_config: Optional[Dict], num_envs: int,
                    seed: int = 0) -> VectorEnv:
    """Build the fastest available VectorEnv for ``env``:

    - an env creator may return a VectorEnv directly (fully native; its
      own num_envs wins over the requested one);
    - known classic-control names get the batched-numpy implementation;
    - anything else is wrapped per-copy in SyncVectorEnv."""
    if callable(env):
        probe = env(env_config or {})
        if isinstance(probe, VectorEnv):
            return probe
        # reuse the probe as the first sub-env — env construction can be
        # expensive (simulators), don't throw one away per worker
        return SyncVectorEnv(lambda: env(env_config or {}), num_envs,
                             first_env=probe)
    if env == "CartPole-v1":
        return CartPoleVecEnv(num_envs, seed=seed)
    if env == "MinAtarBreakout":
        from ray_tpu_torch.rllib.envs import MinAtarBreakoutVecEnv

        return MinAtarBreakoutVecEnv(
            num_envs, size=int((env_config or {}).get("size", 10)),
            seed=seed)
    if env == "RepeatPrev":
        from ray_tpu_torch.rllib.envs import RepeatPrevVecEnv

        return RepeatPrevVecEnv(
            num_envs,
            n_symbols=int((env_config or {}).get("n_symbols", 3)),
            seed=seed)
    import gymnasium as gym

    return SyncVectorEnv(lambda: gym.make(env), num_envs)
