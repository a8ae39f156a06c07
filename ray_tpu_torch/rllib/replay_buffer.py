"""Replay buffers: uniform ring + proportional prioritized (sum-tree).

Reference analogs: rllib/utils/replay_buffers/replay_buffer.py
(ReplayBuffer.add/sample) and prioritized_replay_buffer.py (the
proportional variant of Schaul et al. PER, sum-tree backed).  Fresh
numpy implementation; storage is columnar (one preallocated array per
SampleBatch column) so sampling a minibatch is one fancy-index per
column — the host-side cost that feeds the learner.  A copy of
``ray_tpu/rllib/replay_buffer.py``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from ray_tpu_torch.rllib.sample_batch import SampleBatch


class ReplayBuffer:
    """Uniform-sampling ring buffer of transitions."""

    def __init__(self, capacity: int, seed: int = 0):
        self.capacity = int(capacity)
        self._cols: Dict[str, np.ndarray] = {}
        self._next = 0
        self._size = 0
        self._rng = np.random.RandomState(seed)

    def __len__(self) -> int:
        return self._size

    def _ensure_storage(self, batch: SampleBatch) -> None:
        for k, v in batch.items():
            if k not in self._cols:
                self._cols[k] = np.zeros((self.capacity,) + v.shape[1:],
                                         dtype=v.dtype)

    def add(self, batch: SampleBatch) -> np.ndarray:
        """Append a batch of rows; returns the storage indices used."""
        self._ensure_storage(batch)
        n = batch.count
        idx = (self._next + np.arange(n)) % self.capacity
        for k, v in batch.items():
            self._cols[k][idx] = v
        self._next = (self._next + n) % self.capacity
        self._size = min(self._size + n, self.capacity)
        return idx

    def sample(self, num_rows: int) -> SampleBatch:
        idx = self._rng.randint(0, self._size, size=num_rows)
        return self._take(idx)

    def _take(self, idx: np.ndarray) -> SampleBatch:
        return SampleBatch({k: c[idx] for k, c in self._cols.items()})


class PrioritizedReplayBuffer(ReplayBuffer):
    """Proportional prioritized replay (sum-tree, O(log n) updates).

    sample() returns (batch, indices, is_weights); callers feed TD
    errors back through update_priorities(indices, errors).
    """

    def __init__(self, capacity: int, *, alpha: float = 0.6,
                 beta: float = 0.4, eps: float = 1e-6, seed: int = 0):
        super().__init__(capacity, seed=seed)
        self.alpha = alpha
        self.beta = beta
        self.eps = eps
        # binary-heap-layout sum tree over `capacity` leaves
        self._tree_size = 1
        while self._tree_size < self.capacity:
            self._tree_size *= 2
        self._tree = np.zeros(2 * self._tree_size, dtype=np.float64)
        self._max_priority = 1.0

    # -- sum tree ---------------------------------------------------------
    def _set_priorities(self, idx: np.ndarray, prio: np.ndarray) -> None:
        pos = idx + self._tree_size
        self._tree[pos] = prio
        pos //= 2
        while np.any(pos >= 1):
            pos = np.unique(pos[pos >= 1])
            self._tree[pos] = self._tree[2 * pos] + self._tree[2 * pos + 1]
            pos //= 2

    def _prefix_find(self, mass: np.ndarray) -> np.ndarray:
        """Vectorized descent: for each probability mass, the leaf whose
        prefix-sum interval contains it."""
        pos = np.ones(len(mass), dtype=np.int64)
        mass = mass.copy()
        while pos[0] < self._tree_size:
            left = 2 * pos
            left_mass = self._tree[left]
            go_right = mass > left_mass
            mass = np.where(go_right, mass - left_mass, mass)
            pos = np.where(go_right, left + 1, left)
        return pos - self._tree_size

    # -- buffer API -------------------------------------------------------
    def add(self, batch: SampleBatch) -> np.ndarray:
        idx = super().add(batch)
        self._set_priorities(
            idx, np.full(len(idx), self._max_priority ** self.alpha))
        return idx

    def sample(self, num_rows: int
               ) -> Tuple[SampleBatch, np.ndarray, np.ndarray]:
        total = self._tree[1]
        mass = self._rng.uniform(0.0, total, size=num_rows)
        idx = np.clip(self._prefix_find(mass), 0, self._size - 1)
        prios = self._tree[idx + self._tree_size]
        probs = np.maximum(prios, 1e-12) / max(total, 1e-12)
        weights = (self._size * probs) ** (-self.beta)
        weights /= weights.max()
        return self._take(idx), idx, weights.astype(np.float32)

    def update_priorities(self, idx: np.ndarray,
                          td_errors: np.ndarray) -> None:
        prio = (np.abs(td_errors) + self.eps) ** self.alpha
        self._max_priority = max(self._max_priority,
                                 float(np.abs(td_errors).max(initial=0.0)
                                       + self.eps))
        self._set_priorities(np.asarray(idx), prio)
