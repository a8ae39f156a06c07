"""PPO (reference analog: rllib/algorithms/ppo/ppo.py:401 training_step).

Sync path, learner on the card: parallel rollout sample from CPU
workers → advantage standardization → ONE update call on the learner
policy (epochs × minibatches as a loop on the device — policy.py) →
weight broadcast through the object store.  A copy of
``ray_tpu/rllib/ppo.py``: the learner policy lives on
``config.learner_device`` (None = the card; run the algorithm in a
driver or a ``num_gpus=1`` actor), the workers stay CPU actors.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np

from ray_tpu_torch.rllib import sample_batch as sb
from ray_tpu_torch.rllib.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.policy import JaxPolicy, PolicySpec
from ray_tpu_torch.rllib.sample_batch import SampleBatch
from ray_tpu_torch.rllib.worker_set import WorkerSet


def standardize_advantages(batch: SampleBatch) -> None:
    """In-place zero-mean/unit-std advantages (reference ppo.py
    standardize_fields) — shared by PPO._prepare_batch and A3C."""
    adv = batch[sb.ADVANTAGES]
    batch[sb.ADVANTAGES] = ((adv - adv.mean()) /
                            max(adv.std(), 1e-6)).astype(np.float32)


@dataclasses.dataclass
class PPOConfig(AlgorithmConfig):
    clip_param: float = 0.2
    vf_coeff: float = 0.5
    entropy_coeff: float = 0.01
    num_sgd_iter: int = 6
    minibatch_size: int = 128
    lam: float = 0.95
    grad_clip: float = 0.5
    hidden: Tuple[int, ...] = (64, 64)
    # set from the env when obs/action spaces are introspectable
    obs_dim: Optional[int] = None
    n_actions: Optional[int] = None
    #: full observation shape (rank-3 selects the conv stack from the
    #: model catalog — reference catalog.py _get_filter_config)
    obs_shape: Optional[Tuple[int, ...]] = None
    conv_filters: Optional[Tuple[Tuple[int, int, int], ...]] = None
    use_lstm: bool = False
    lstm_cell_size: int = 64
    max_seq_len: int = 16
    use_attention: bool = False
    attention_dim: int = 64
    attention_heads: int = 4
    #: Box action spaces: diagonal-Gaussian policy (auto-detected)
    continuous: bool = False
    #: >1 (the JAX package's data-parallel learner over local devices)
    #: raises: not ported (algorithm.LEARNER_DEVICES_ITEM)
    learner_devices: int = 1
    #: "MeanStdFilter" = running obs normalization in rollout workers,
    #: synced+merged across workers every training_step
    observation_filter: str = "NoFilter"
    #: True: workers collect fragments on a background AsyncSampler
    #: thread (env stepping overlaps the learner round-trip; fragments
    #: may be one weight-sync stale — reference AsyncSampler semantics)
    sample_async: bool = False

    def policy_spec(self) -> PolicySpec:
        if self.obs_dim is None or self.n_actions is None:
            raise ValueError("obs_dim/n_actions unset; pass them or use "
                             "a gymnasium env id")
        return PolicySpec(
            obs_dim=self.obs_dim, n_actions=self.n_actions,
            hidden=tuple(self.hidden), lr=self.lr,
            clip_param=self.clip_param, vf_coeff=self.vf_coeff,
            entropy_coeff=self.entropy_coeff,
            num_sgd_iter=self.num_sgd_iter,
            minibatch_size=self.minibatch_size, grad_clip=self.grad_clip,
            continuous=self.continuous,
            obs_shape=(tuple(self.obs_shape) if self.obs_shape
                       else None),
            conv_filters=self.conv_filters, use_lstm=self.use_lstm,
            lstm_cell_size=self.lstm_cell_size,
            max_seq_len=self.max_seq_len,
            use_attention=self.use_attention,
            attention_dim=self.attention_dim,
            attention_heads=self.attention_heads)


def _introspect_spaces(cfg: PPOConfig) -> None:
    if cfg.obs_dim is not None and cfg.n_actions is not None:
        return
    from ray_tpu_torch.rllib.vector_env import make_vector_env

    env = make_vector_env(cfg.env, cfg.env_config, 1, seed=0)
    try:
        cfg.obs_dim = int(np.prod(env.observation_space.shape))
        shape = tuple(env.observation_space.shape)
        if getattr(cfg, "obs_shape", None) is None and len(shape) == 3:
            cfg.obs_shape = shape  # pixels: hand the conv stack its layout
        space = env.action_space
        if hasattr(space, "n"):
            cfg.n_actions = int(space.n)
        elif hasattr(cfg, "continuous"):
            # Box: diagonal-Gaussian policy over the action vector
            cfg.n_actions = int(np.prod(space.shape))
            cfg.continuous = True
        else:
            # shared by discrete-only algos (DQN/IMPALA): fail loudly
            # instead of silently building a categorical policy over a
            # Box space
            raise TypeError(
                f"{type(cfg).__name__} supports discrete action spaces "
                f"only; got a continuous space with shape "
                f"{getattr(space, 'shape', '?')} (use PPO for "
                f"continuous control)")
    finally:
        env.close() if hasattr(env, "close") else None


class PPO(Algorithm):
    _config_cls = PPOConfig

    def setup(self, config: PPOConfig) -> None:
        _introspect_spaces(config)
        spec = config.policy_spec()
        from ray_tpu_torch.rllib.algorithm import learner_mesh

        self.learner_policy = JaxPolicy(
            spec, seed=config.seed,
            mesh=learner_mesh(config.learner_devices),
            device=config.learner_device)
        self.workers = WorkerSet(
            num_workers=config.num_workers, env=config.env,
            env_config=config.env_config, policy_spec=spec,
            num_envs_per_worker=config.num_envs_per_worker,
            rollout_fragment_length=config.rollout_fragment_length,
            gamma=config.gamma, lam=config.lam,
            num_cpus_per_worker=config.num_cpus_per_worker,
            seed=config.seed,
            observation_filter=config.observation_filter,
            async_sampling=config.sample_async)
        self.workers.sync_weights(self.learner_policy.get_weights())

    def _prepare_batch(self, batch: SampleBatch) -> None:
        """In-place batch prep before the learner update.  PPO
        standardizes advantages (reference ppo.py standardize_fields);
        variants (PG) override."""
        standardize_advantages(batch)

    def training_step(self) -> Dict[str, Any]:
        batches = []
        steps = 0
        # recurrent batches are rows of max_seq_len-step sequences
        steps_per_row = (self.config.max_seq_len
                         if getattr(self.config, "use_lstm", False)
                         or getattr(self.config, "use_attention", False)
                         else 1)
        while steps < self.config.train_batch_size:
            parts = self.workers.sample()
            batches.extend(parts)
            steps += sum(b.count for b in parts) * steps_per_row
        batch = SampleBatch.concat_samples(batches)
        self._prepare_batch(batch)

        stats = self.learner_policy.learn_on_batch(batch)
        self.workers.sync_weights(self.learner_policy.get_weights())
        if config_filter := getattr(self.config, "observation_filter",
                                    "NoFilter"):
            if config_filter != "NoFilter":
                self._filter_state = self.workers.sync_filters(
                    getattr(self, "_filter_state", None))
        self._episode_returns.extend(self.workers.episode_returns())
        stats["timesteps_this_iter"] = batch.count * steps_per_row
        return stats

    def _make_eval_worker(self):
        import ray_tpu_torch as rt
        from ray_tpu_torch.rllib.rollout_worker import RolloutWorker

        cfg = self.config
        remote_cls = rt.remote(num_cpus=cfg.num_cpus_per_worker,
                               num_gpus=0)(RolloutWorker)
        return remote_cls.remote(
            env=cfg.env, env_config=cfg.env_config,
            policy_spec=cfg.policy_spec(),
            num_envs=max(1, cfg.num_envs_per_worker),
            gamma=cfg.gamma, lam=cfg.lam,
            rollout_fragment_length=cfg.rollout_fragment_length,
            seed=cfg.seed + 424242,
            observation_filter=cfg.observation_filter,
            num_threads=max(1, int(cfg.num_cpus_per_worker)))

    def _eval_weights(self):
        return self.learner_policy.get_weights()

    def cleanup(self) -> None:
        self.workers.stop()
        if getattr(self, "_eval_worker", None) is not None:
            import ray_tpu_torch as rt

            try:
                rt.kill(self._eval_worker)
            except Exception:  # noqa: BLE001
                pass
