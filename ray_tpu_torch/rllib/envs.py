"""Natively-batched in-repo training environments.

``MinAtarBreakoutVecEnv`` is a MinAtar-class pixel environment (after
Young & Tian's MinAtar breakout): a (H, W, 3) binary image observation
— paddle / ball / brick channels — with batched numpy dynamics, so a
conv policy has something real to learn from without an Atari ROM
dependency.  The reference's RLlib pass bar is PPO on Breakout pixels
(release/rllib_tests/.../ppo-breakoutnoframeskip-v4.yaml); this is the
in-repo equivalent target.

``RepeatPrevVecEnv`` is a minimal memory task (reward for echoing the
previous symbol): feedforward policies cap at chance, recurrent ones
solve it — the LSTM wrapper's discriminative test.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ray_tpu_torch.rllib.vector_env import Box, Discrete, VectorEnv


class MinAtarBreakoutVecEnv(VectorEnv):
    """Batched breakout on an (H, W) board.

    Actions: 0 = noop, 1 = left, 2 = right.  The ball moves one cell
    diagonally per step; bricks fill rows 1..3 and respawn when
    cleared; losing the ball past the paddle terminates the episode.
    Observation channels: 0 paddle, 1 ball, 2 bricks.
    """

    _MAX_STEPS = 500
    _BRICK_ROWS = (1, 2, 3)

    def __init__(self, num_envs: int, size: int = 10, seed: int = 0):
        self.num_envs = num_envs
        self.h = self.w = size
        self.observation_space = Box(0.0, 1.0, (self.h, self.w, 3),
                                     np.float32)
        self.action_space = Discrete(3)
        self._rng = np.random.RandomState(seed)
        n = num_envs
        self._paddle = np.zeros(n, np.int64)
        self._by = np.zeros(n, np.int64)
        self._bx = np.zeros(n, np.int64)
        self._dy = np.zeros(n, np.int64)
        self._dx = np.zeros(n, np.int64)
        self._bricks = np.zeros((n, self.h, self.w), bool)
        self._steps = np.zeros(n, np.int64)

    def _reset_rows(self, mask: np.ndarray) -> None:
        n = int(mask.sum())
        if not n:
            return
        self._paddle[mask] = self.w // 2
        self._by[mask] = len(self._BRICK_ROWS) + 1
        self._bx[mask] = self._rng.randint(1, self.w - 1, size=n)
        self._dy[mask] = 1  # moving down toward the paddle
        self._dx[mask] = self._rng.choice((-1, 1), size=n)
        self._bricks[mask] = False
        for r in self._BRICK_ROWS:
            self._bricks[mask, r, :] = True
        self._steps[mask] = 0

    def _obs(self) -> np.ndarray:
        n = self.num_envs
        obs = np.zeros((n, self.h, self.w, 3), np.float32)
        idx = np.arange(n)
        obs[idx, self.h - 1, self._paddle, 0] = 1.0
        obs[idx, self._by, self._bx, 1] = 1.0
        obs[:, :, :, 2] = self._bricks
        return obs

    def vector_reset(self, seed: Optional[int] = None) -> np.ndarray:
        if seed is not None:
            self._rng = np.random.RandomState(seed)
        self._reset_rows(np.ones(self.num_envs, bool))
        return self._obs()

    def vector_step(self, actions):
        n = self.num_envs
        idx = np.arange(n)
        a = np.asarray(actions)
        self._paddle = np.clip(self._paddle + (a == 2) - (a == 1),
                               0, self.w - 1)
        rew = np.zeros(n, np.float32)

        # side walls reflect horizontally
        nx = self._bx + self._dx
        out = (nx < 0) | (nx >= self.w)
        self._dx[out] *= -1
        nx = self._bx + self._dx
        # top wall reflects vertically
        ny = self._by + self._dy
        top = ny < 0
        self._dy[top] *= -1
        ny = self._by + self._dy

        # brick hits: consume the brick, reward, reflect vertically
        ny_c = np.clip(ny, 0, self.h - 1)
        hit = self._bricks[idx, ny_c, nx] & (ny == ny_c)
        self._bricks[idx[hit], ny_c[hit], nx[hit]] = False
        rew[hit] = 1.0
        self._dy[hit] *= -1
        ny = self._by + self._dy

        # paddle row: bounce if the paddle is under the ball, else lose
        at_bottom = ny >= self.h - 1
        caught = at_bottom & (nx == self._paddle)
        self._dy[caught] *= -1
        ny = np.where(caught, self._by + self._dy, ny)
        terms = at_bottom & ~caught

        self._by = np.clip(ny, 0, self.h - 1)
        self._bx = nx
        # cleared board: respawn bricks (play continues)
        cleared = ~self._bricks.any(axis=(1, 2))
        if cleared.any():
            for r in self._BRICK_ROWS:
                self._bricks[cleared, r, :] = True

        self._steps += 1
        truncs = ~terms & (self._steps >= self._MAX_STEPS)
        final_obs = self._obs()
        done = terms | truncs
        self._reset_rows(done)
        return self._obs(), rew, terms, truncs, {"final_obs": final_obs}


class RepeatPrevVecEnv(VectorEnv):
    """Echo-the-previous-symbol memory task: obs_t is a one-hot symbol,
    reward_t = 1 iff action_t equals symbol_{t-1}.  A feedforward
    policy caps at 1/n_symbols expected reward; one step of memory
    solves it."""

    _EP_LEN = 64

    def __init__(self, num_envs: int, n_symbols: int = 3, seed: int = 0):
        self.num_envs = num_envs
        self.n = n_symbols
        self.observation_space = Box(0.0, 1.0, (n_symbols,), np.float32)
        self.action_space = Discrete(n_symbols)
        self._rng = np.random.RandomState(seed)
        self._sym = np.zeros(num_envs, np.int64)
        self._prev = np.zeros(num_envs, np.int64)
        self._steps = np.zeros(num_envs, np.int64)

    def _reset_rows(self, mask) -> None:
        k = int(mask.sum())
        if k:
            self._sym[mask] = self._rng.randint(0, self.n, size=k)
            self._prev[mask] = self._sym[mask]  # first step: free point
            self._steps[mask] = 0

    def _obs(self):
        obs = np.zeros((self.num_envs, self.n), np.float32)
        obs[np.arange(self.num_envs), self._sym] = 1.0
        return obs

    def vector_reset(self, seed: Optional[int] = None):
        if seed is not None:
            self._rng = np.random.RandomState(seed)
        self._reset_rows(np.ones(self.num_envs, bool))
        return self._obs()

    def vector_step(self, actions):
        rew = (np.asarray(actions) == self._prev).astype(np.float32)
        self._prev = self._sym
        self._sym = self._rng.randint(0, self.n, size=self.num_envs)
        self._steps += 1
        truncs = self._steps >= self._EP_LEN
        terms = np.zeros(self.num_envs, bool)
        final_obs = self._obs()
        self._reset_rows(truncs)
        return self._obs(), rew, terms, truncs, {"final_obs": final_obs}
