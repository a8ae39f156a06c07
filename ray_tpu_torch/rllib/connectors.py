"""Connector pipelines: the pluggable obs→policy and policy→env
transform chains.

Reference analog: rllib/connectors/connector.py:84 (Connector /
ConnectorPipeline, agent+action connectors).  Kept lean and batched:
every connector maps an (N, ...) array to an (N, ...) array, so the
pipeline sits between a VectorEnv and one batched policy forward with
zero per-env python.  Stateful connectors (observation filters) expose
get_state/set_state plus a delta for the cross-worker filter sync.
A copy of ``ray_tpu/rllib/connectors.py``.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence

import numpy as np


class Connector:
    """One batched transform.  ``update=False`` freezes statistics
    (evaluation / bootstrap lookups)."""

    def __call__(self, batch: np.ndarray, update: bool = True):
        raise NotImplementedError

    def get_state(self) -> Any:
        return None

    def set_state(self, state: Any) -> None:
        pass


class CastFlatten(Connector):
    """float32 cast + flatten trailing dims to (N, obs_dim)."""

    def __call__(self, batch, update: bool = True):
        arr = np.asarray(batch, np.float32)
        return arr.reshape(arr.shape[0], -1)


class Cast(Connector):
    """float32 cast, shape-preserving (image observations feeding conv
    stacks must keep their (N, H, W, C) layout)."""

    def __call__(self, batch, update: bool = True):
        return np.asarray(batch, np.float32)


class ObsFilter(Connector):
    """MeanStd observation normalization with the local/delta split the
    cross-worker FilterManager sync protocol needs (rllib/filters.py)."""

    def __init__(self, name: str, shape):
        from ray_tpu_torch.rllib.filters import make_filter

        self._name = name
        self._shape = shape
        self.local = make_filter(name, shape)
        self.delta = make_filter(name, shape)

    def __call__(self, batch, update: bool = True):
        if update:
            self.delta(batch)  # accumulate raw for the next sync
        return self.local(batch, update=update)

    def pop_delta(self):
        from ray_tpu_torch.rllib.filters import make_filter

        state = self.delta.get_state()
        self.delta = make_filter(self._name, self._shape)
        return state

    def get_state(self):
        return self.local.get_state()

    def set_state(self, state):
        self.local.set_state(state)


class ClipReshapeActions(Connector):
    """Box-space action adapter: clip the raw policy sample to the env
    bounds and reshape rows to the env's action shape.  The SampleBatch
    keeps the RAW action so importance ratios refer to what was sampled
    (reference clip_actions semantics)."""

    def __init__(self, action_space):
        self.low = getattr(action_space, "low", None)
        self.high = getattr(action_space, "high", None)
        self.shape = tuple(getattr(action_space, "shape", ()) or ())

    def __call__(self, batch, update: bool = True):
        a = np.asarray(batch, np.float32)
        if self.low is not None:
            a = np.clip(a, self.low, self.high)
        if self.shape:
            a = a.reshape((a.shape[0],) + self.shape)
        return a


class ConnectorPipeline(Connector):
    def __init__(self, connectors: Sequence[Connector]):
        self.connectors: List[Connector] = list(connectors)

    def __call__(self, batch, update: bool = True):
        for c in self.connectors:
            batch = c(batch, update=update)
        return batch

    def get_state(self):
        return [c.get_state() for c in self.connectors]

    def set_state(self, states):
        for c, s in zip(self.connectors, states):
            if s is not None:
                c.set_state(s)

    def find(self, cls) -> Optional[Connector]:
        for c in self.connectors:
            if isinstance(c, cls):
                return c
        return None


def default_obs_pipeline(obs_shape, observation_filter: str = "NoFilter",
                         preserve_shape: bool = False
                         ) -> ConnectorPipeline:
    """env→module chain: cast/flatten (+ MeanStd filter when asked).
    ``preserve_shape`` keeps the env layout (conv policies);
    otherwise rows flatten to (N, prod(obs_shape)).  The filter sits
    after the cast, over whichever shape reaches it."""
    chain: List[Connector] = [Cast() if preserve_shape else CastFlatten()]
    if observation_filter and observation_filter != "NoFilter":
        fshape = (tuple(obs_shape) if preserve_shape
                  else ((int(np.prod(obs_shape)),) if obs_shape else (1,)))
        chain.append(ObsFilter(observation_filter, fshape))
    return ConnectorPipeline(chain)


def default_action_pipeline(action_space,
                            continuous: bool) -> ConnectorPipeline:
    """module→env chain: identity for discrete, clip+reshape for Box."""
    if continuous:
        return ConnectorPipeline([ClipReshapeActions(action_space)])
    return ConnectorPipeline([])
