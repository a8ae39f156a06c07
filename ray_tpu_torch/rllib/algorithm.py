"""Algorithm: the trainable RL loop (reference analog:
rllib/algorithms/algorithm.py:150 Algorithm(Trainable), :728 step).

`train()` runs one training iteration and returns a metrics dict; the
class also works as a tune trainable via `as_trainable()` (iterating
train() and reporting each result), matching how the reference runs
learning tests through tune.

A copy of ``ray_tpu/rllib/algorithm.py`` on the port's runtime.
Checkpoints keep the JAX package's file (``algorithm.pkl``) and state
keys with numpy leaves in its layout, so a checkpoint written by either
package restores in the other.  ``learner_device`` places the learner
(None = the card); a learner over several devices
(``learner_devices > 1``) is not ported (``LEARNER_DEVICES_ITEM``).
"""

from __future__ import annotations

import copy
import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np

import ray_tpu_torch as rt

#: the ROADMAP item a learner over more than one device waits for
LEARNER_DEVICES_ITEM = ("ROADMAP.md queue 1 item 7.13 (e) (a data-parallel "
                        "learner over several cards)")


def _numpy_tree(tree):
    """A weight tree's leaves as numpy arrays (the JAX package's
    ``jax.tree.map(np.asarray, tree)``)."""
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_numpy_tree(v) for v in tree)
    if hasattr(tree, "detach"):
        return tree.detach().cpu().numpy()
    return np.asarray(tree)


@dataclasses.dataclass
class AlgorithmConfig:
    env: Any = None
    env_config: Optional[Dict[str, Any]] = None
    num_workers: int = 2
    num_envs_per_worker: int = 1
    rollout_fragment_length: int = 200
    train_batch_size: int = 4000
    gamma: float = 0.99
    lr: float = 3e-4
    seed: int = 0
    num_cpus_per_worker: float = 1.0
    # learner placement: {"TPU": 1} puts the learner policy on the chip
    learner_resources: Optional[Dict[str, float]] = None
    #: the learner policy's device: None = the card (raises without
    #: one), "cpu" to run the learner on the CPU explicitly
    learner_device: Optional[str] = None
    #: run greedy-policy evaluation every N train() iterations on a
    #: dedicated worker (reference: evaluation_interval +
    #: evaluation WorkerSet, algorithm.py evaluate()); 0 = off
    evaluation_interval: int = 0
    evaluation_num_episodes: int = 10

    def copy(self) -> "AlgorithmConfig":
        return copy.deepcopy(self)

    def update(self, **kwargs) -> "AlgorithmConfig":
        for k, v in kwargs.items():
            if not hasattr(self, k):
                raise AttributeError(f"unknown config field {k!r}")
            setattr(self, k, v)
        return self


class Algorithm:
    _config_cls = AlgorithmConfig

    def __init__(self, config: AlgorithmConfig):
        self.config = config
        self.iteration = 0
        self._timesteps_total = 0
        self._episode_returns: List[float] = []
        self.setup(config)

    # -- subclass surface -------------------------------------------------
    def setup(self, config: AlgorithmConfig) -> None:
        raise NotImplementedError

    def training_step(self) -> Dict[str, Any]:
        raise NotImplementedError

    def cleanup(self) -> None:
        pass

    # -- public API -------------------------------------------------------
    def train(self) -> Dict[str, Any]:
        start = time.monotonic()
        result = self.training_step()
        self.iteration += 1
        self._timesteps_total += result.get("timesteps_this_iter", 0)
        recent = self._episode_returns[-100:]
        result.update({
            "training_iteration": self.iteration,
            "timesteps_total": self._timesteps_total,
            "episode_reward_mean": (sum(recent) / len(recent))
            if recent else float("nan"),
            "episodes_total": len(self._episode_returns),
            "time_this_iter_s": time.monotonic() - start,
        })
        interval = getattr(self.config, "evaluation_interval", 0)
        if interval and self.iteration % interval == 0:
            result["evaluation"] = self.evaluate()
        return result

    def evaluate(self) -> Dict[str, Any]:
        """Greedy-policy evaluation on a dedicated worker (reference:
        Algorithm.evaluate over the evaluation WorkerSet).  Subclasses
        that support it implement ``_make_eval_worker``; the worker is
        created lazily and reused, with weights synced per call."""
        factory = getattr(self, "_make_eval_worker", None)
        if factory is None:
            raise NotImplementedError(
                f"{type(self).__name__} does not support evaluation")
        if getattr(self, "_eval_worker", None) is None:
            self._eval_worker = factory()
        w = self._eval_worker
        rt.get(w.set_weights.remote(self._eval_weights()), timeout=60)
        fs = getattr(self, "_filter_state", None)
        if fs is not None:
            # evaluation must normalize with the TRAINING statistics
            rt.get(w.set_filter_state.remote(fs), timeout=60)
        return rt.get(w.evaluate.remote(
            getattr(self.config, "evaluation_num_episodes", 10)),
            timeout=600)

    def stop(self) -> None:
        self.cleanup()

    # -- checkpointing (reference: Algorithm.save / Algorithm.restore) ----
    _WEIGHT_ATTRS = ("learner_policy", "policy", "net", "main",
                     "exploiter")
    _RAW_ATTRS = ("params", "model_params", "theta")
    #: plain scalar counters driving schedules (epsilon decay, target
    #: sync cadence) — without them a resumed run re-explores from
    #: scratch and re-gates behind learning_starts
    _COUNTER_ATTRS = ("_env_steps", "_last_target_sync")

    def _checkpoint_state(self) -> Dict[str, Any]:
        """Learner state as numpy pytrees — every weight-bearing attr
        this algorithm exposes (policies with get_weights, raw param
        trees, ES/ARS theta vectors)."""
        state: Dict[str, Any] = {}
        for attr in self._WEIGHT_ATTRS:
            obj = getattr(self, attr, None)
            if obj is not None and hasattr(obj, "get_weights"):
                state[attr] = obj.get_weights()
                for tname in ("target", "target_params"):
                    tgt = getattr(obj, tname, None)
                    if tgt is not None:
                        # target nets are saved EXACTLY (structure
                        # varies per policy — SAC's is a critic
                        # subset); a restored off-policy run must not
                        # bootstrap TD from a random target until the
                        # next sync
                        state[f"{attr}::{tname}"] = _numpy_tree(tgt)
        for attr in self._RAW_ATTRS:
            val = getattr(self, attr, None)
            if val is not None:
                state[attr] = _numpy_tree(val)
        if not state:
            raise NotImplementedError(
                f"{type(self).__name__} exposes no checkpointable "
                "state")
        fs = getattr(self, "_filter_state", None)
        if fs is not None:
            # observation-filter statistics are part of the policy:
            # restored weights without them see unnormalized inputs
            state["_filter_state"] = fs
        for attr in self._COUNTER_ATTRS:
            val = getattr(self, attr, None)
            if val is not None:
                state[attr] = val
        return state

    def _restore_state(self, state: Dict[str, Any]) -> None:
        for attr, val in state.items():
            if "::" in attr:
                continue            # applied with its owner below
            obj = getattr(self, attr, None)
            if obj is not None and hasattr(obj, "set_weights"):
                obj.set_weights(val)
                for tname in ("target", "target_params"):
                    tgt = state.get(f"{attr}::{tname}")
                    if tgt is not None:
                        setattr(obj, tname, tgt)
            elif attr in self._WEIGHT_ATTRS:
                # a policy slot the checkpoint fills but this config
                # did not construct (e.g. train_exploiter=False
                # restoring an exploiter-bearing checkpoint): writing
                # the raw dict would explode later — fail loudly now
                raise ValueError(
                    f"checkpoint carries {attr!r} weights but this "
                    f"{type(self).__name__} config did not construct "
                    f"that policy")
            else:
                setattr(self, attr, val)

    def save(self, checkpoint_dir: str) -> str:
        """Write a restorable checkpoint; returns its path."""
        import os
        import pickle

        os.makedirs(checkpoint_dir, exist_ok=True)
        path = os.path.join(checkpoint_dir, "algorithm.pkl")
        # write-then-rename: a crash mid-dump must never truncate the
        # previous good checkpoint at the same path
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            pickle.dump({"state": self._checkpoint_state(),
                         "iteration": self.iteration,
                         "timesteps_total": self._timesteps_total,
                         "algorithm": type(self).__name__}, f)
        os.replace(tmp, path)
        return path

    def restore(self, path: str) -> None:
        """Load weights + counters saved by ``save`` into this
        (already-constructed) algorithm."""
        import os
        import pickle

        if os.path.isdir(path):
            path = os.path.join(path, "algorithm.pkl")
        with open(path, "rb") as f:
            blob = pickle.load(f)
        saved = blob.get("algorithm")
        if saved and saved != type(self).__name__:
            raise ValueError(
                f"checkpoint was saved by {saved}, cannot restore "
                f"into {type(self).__name__}")
        self._restore_state(blob["state"])
        self.iteration = blob.get("iteration", 0)
        self._timesteps_total = blob.get("timesteps_total", 0)
        # rollout workers must act with the restored weights (and the
        # restored observation-filter statistics)
        weights = None
        for attr in ("learner_policy", "policy", "net"):
            obj = getattr(self, attr, None)
            if obj is not None and hasattr(obj, "get_weights"):
                weights = obj.get_weights()
                break
        sync = getattr(self, "workers", None)
        if weights is not None and sync is not None:
            if hasattr(sync, "sync_weights"):      # WorkerSet
                sync.sync_weights(weights)
                # RolloutWorkers (the WorkerSet members) implement
                # set_filter_state; raw-list worker classes
                # (TransitionWorker etc.) do not, and actor handles
                # fabricate methods on attribute access, so the push
                # is gated on the WorkerSet case rather than hasattr
                fs = getattr(self, "_filter_state", None)
                if fs is not None:
                    rt.get(
                        [w.set_filter_state.remote(fs)
                         for w in getattr(sync, "workers", [])],
                        timeout=60.0)
            elif isinstance(sync, (list, tuple)) and sync:
                ref = rt.put(weights)
                rt.get([w.set_weights.remote(ref) for w in sync],
                       timeout=60.0)

    @classmethod
    def as_trainable(cls, base_config: AlgorithmConfig,
                     stop_iters: int = 10) -> Callable:
        """Function trainable for ray_tpu_torch.tune (reference:
        Algorithm IS a Trainable; here the adapter closes over the
        config)."""

        def trainable(config: Dict[str, Any]):
            from ray_tpu_torch.air import session

            overrides = dict(config or {})
            # per-trial loop bound (tune.run("PPO", config={...,
            # "training_iterations": N}) routes through here)
            iters = int(overrides.pop("training_iterations",
                                      stop_iters))
            cfg = base_config.copy().update(**overrides)
            algo = cls(cfg)
            try:
                for _ in range(iters):
                    session.report(algo.train())
            finally:
                algo.stop()

        trainable.__name__ = cls.__name__
        return trainable


def learner_mesh(learner_devices: int):
    """Local data mesh for multi-device learner updates (shared by
    PPO/IMPALA/DQN setup); None when learner_devices <= 1.  A learner
    over several devices is not ported: above 1 it raises naming
    ``LEARNER_DEVICES_ITEM``."""
    if learner_devices <= 1:
        return None
    raise NotImplementedError(
        f"learner_devices={learner_devices}: a learner over several "
        f"devices is not ported yet: {LEARNER_DEVICES_ITEM}")
