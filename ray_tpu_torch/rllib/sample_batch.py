"""SampleBatch: columnar trajectory storage (reference analog:
rllib/policy/sample_batch.py — same role, fresh numpy implementation).

A copy of ``ray_tpu/rllib/sample_batch.py``.  A thin dict of
equal-length numpy arrays with the concat/slice/shuffle operations the
training stack needs.  Kept host-side (numpy): batches become torch
tensors only at the learner's ``to_device`` boundary, so rollout
workers never touch the card.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

OBS = "obs"
ACTIONS = "actions"
REWARDS = "rewards"
DONES = "dones"
NEXT_OBS = "next_obs"
ACTION_LOGP = "action_logp"
VF_PREDS = "vf_preds"
ADVANTAGES = "advantages"
VALUE_TARGETS = "value_targets"


class SampleBatch(dict):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        for k, v in list(self.items()):
            if not isinstance(v, np.ndarray):
                self[k] = np.asarray(v)

    @property
    def count(self) -> int:
        for v in self.values():
            return len(v)
        return 0

    def __len__(self) -> int:  # row count, not key count
        return self.count

    @staticmethod
    def concat_samples(batches: Sequence["SampleBatch"]) -> "SampleBatch":
        if not batches:
            return SampleBatch()
        keys = batches[0].keys()
        return SampleBatch({
            k: np.concatenate([np.asarray(b[k]) for b in batches])
            for k in keys})

    def slice(self, start: int, end: int) -> "SampleBatch":
        return SampleBatch({k: v[start:end] for k, v in self.items()})

    def shuffle(self, rng: Optional[np.random.RandomState] = None
                ) -> "SampleBatch":
        rng = rng or np.random
        perm = rng.permutation(self.count)
        return SampleBatch({k: v[perm] for k, v in self.items()})

    def minibatches(self, size: int) -> Iterator["SampleBatch"]:
        for i in range(0, self.count, size):
            yield self.slice(i, i + size)

    def to_device(self, device):
        """numpy → torch tensors on ``device`` (the host→device copy
        happens here; the JAX package's ``jnp.asarray``).  A read-only
        column (a batch fetched zero-copy from the object store) is
        copied first: torch tensors are writable."""
        import torch

        return {k: torch.as_tensor(v if v.flags.writeable else v.copy(),
                                   device=device)
                for k, v in self.items()}

    def __repr__(self):
        return (f"SampleBatch({self.count} rows: "
                f"{sorted(self.keys())})")


def compute_gae(rewards: np.ndarray, values: np.ndarray,
                dones: np.ndarray, last_value: float, *,
                gamma: float = 0.99, lam: float = 0.95):
    """Generalized advantage estimation over one rollout (numpy,
    worker-side).  Returns (advantages, value_targets)."""
    T = len(rewards)
    adv = np.zeros(T, dtype=np.float32)
    gae = 0.0
    next_v = last_value
    for t in range(T - 1, -1, -1):
        nonterminal = 1.0 - float(dones[t])
        delta = rewards[t] + gamma * next_v * nonterminal - values[t]
        gae = delta + gamma * lam * nonterminal * gae
        adv[t] = gae
        next_v = values[t]
    return adv, adv + values.astype(np.float32)
