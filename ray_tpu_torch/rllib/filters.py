"""Observation filters with cross-worker synchronization.

Reference analog: rllib/utils/filter.py (MeanStdFilter over a running
Welford accumulator) + the filter-synchronization step in training
(FilterManager.synchronize: collect worker deltas, merge, broadcast).
Normalizing observations is load-bearing for continuous control; the
filter runs host-side in rollout workers (numpy), so the learner on the
card sees already-normalized batches.  A copy of
``ray_tpu/rllib/filters.py``.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np

__all__ = ["NoFilter", "MeanStdFilter", "merge_filter_states"]


class NoFilter:
    def __call__(self, x: np.ndarray, update: bool = True) -> np.ndarray:
        return x

    def get_state(self) -> Dict[str, Any]:
        return {"type": "NoFilter"}

    def set_state(self, state: Dict[str, Any]) -> None:
        pass


class MeanStdFilter:
    """Running mean/std normalization (Welford; parallel-mergeable)."""

    def __init__(self, shape: Tuple[int, ...], *, clip: float = 10.0,
                 eps: float = 1e-8):
        self.shape = tuple(shape)
        self.clip = clip
        self.eps = eps
        self.count = 0.0
        self.mean = np.zeros(self.shape, np.float64)
        self.m2 = np.zeros(self.shape, np.float64)

    def __call__(self, x: np.ndarray, update: bool = True) -> np.ndarray:
        x = np.asarray(x, np.float64)
        batched = x.ndim == len(self.shape) + 1
        rows = x if batched else x[None]
        if update and len(rows):
            # batched Chan merge: one np.mean/np.var per call instead of
            # a per-row Python Welford loop
            cb = float(len(rows))
            mb = rows.mean(axis=0)
            m2b = rows.var(axis=0) * cb
            delta = mb - self.mean
            tot = self.count + cb
            self.m2 = (self.m2 + m2b
                       + np.square(delta) * self.count * cb / tot)
            self.mean = self.mean + delta * cb / tot
            self.count = tot
        std = self.std
        out = np.clip((x - self.mean) / std, -self.clip, self.clip)
        return out.astype(np.float32)

    @property
    def std(self) -> np.ndarray:
        if self.count < 2:
            return np.ones(self.shape)
        return np.sqrt(self.m2 / (self.count - 1)) + self.eps

    def get_state(self) -> Dict[str, Any]:
        return {"type": "MeanStdFilter", "shape": self.shape,
                "count": self.count, "mean": self.mean.copy(),
                "m2": self.m2.copy(), "clip": self.clip}

    def set_state(self, state: Dict[str, Any]) -> None:
        self.count = float(state["count"])
        self.mean = np.asarray(state["mean"], np.float64).copy()
        self.m2 = np.asarray(state["m2"], np.float64).copy()


def make_filter(name: str, shape) -> Any:
    if name in (None, "NoFilter", ""):
        return NoFilter()
    if name == "MeanStdFilter":
        return MeanStdFilter(tuple(shape))
    raise ValueError(f"unknown observation_filter {name!r}")


def merge_filter_states(states) -> Dict[str, Any]:
    """Chan et al. parallel variance merge of worker filter states —
    the FilterManager.synchronize reduction."""
    states = [s for s in states if s.get("type") == "MeanStdFilter"]
    if not states:
        return {"type": "NoFilter"}
    out = dict(states[0])
    count = float(states[0]["count"])
    mean = np.asarray(states[0]["mean"], np.float64).copy()
    m2 = np.asarray(states[0]["m2"], np.float64).copy()
    for s in states[1:]:
        cb = float(s["count"])
        if cb == 0:
            continue
        mb = np.asarray(s["mean"], np.float64)
        m2b = np.asarray(s["m2"], np.float64)
        delta = mb - mean
        tot = count + cb
        m2 = m2 + m2b + np.square(delta) * count * cb / tot
        mean = mean + delta * cb / tot
        count = tot
    out.update(count=count, mean=mean, m2=m2)
    return out
