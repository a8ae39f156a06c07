"""Torch policies on the card.

The counterpart of ``ray_tpu/rllib/policy.py``; the class keeps the
JAX package's name, ``JaxPolicy``, as ``train.JaxTrainer`` keeps its.
The learner's policy lives on the card (``device=None`` = cuda:0, and
raises without one); rollout workers ask for ``device="cpu"``.  The
PPO update — num_sgd_iter epochs over shuffled minibatches, the JAX
package's one jitted ``lax.scan`` — is a loop on the device that reads
nothing back to the host until it ends: permutations come from the
policy's ``torch.Generator`` on the device (seeded ``seed + 1``, as
``PRNGKey(seed + 1)``), gradients are clipped by their global norm as
optax's ``clip_by_global_norm`` clips them (``max / norm``, no epsilon)
and applied by ``train/optim.py``'s AdamW with ``weight_decay=0``
(optax's ``adam``), and the stats returned are the last minibatch's.

Networks come from the model catalog (models.py — reference analog
rllib/models/catalog.py:195): MLP towers for vector observations, conv
stacks for (H, W, C) pixels, an optional LSTM wrapper
(``PolicySpec.use_lstm``) trained with truncated BPTT over
``max_seq_len`` chunks whose initial recurrent states were recorded at
rollout time (reference: policy/rnn_sequencing.py), and a GTrXL-style
attention block.  Weights cross as numpy trees in the JAX package's
layout (``get_weights``/``set_weights``).  Actions are sampled with the
policy's generator: the draws differ from ``jax.random``'s, the
distributions do not.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ray_tpu_torch.device import resolve_device
from ray_tpu_torch.rllib import sample_batch as sb
from ray_tpu_torch.rllib.models import (Encoder, GTrXLBlock, LSTMCell,
                                        ModelConfig, attention_apply,
                                        lstm_step, mlp_apply, mlp_layers,
                                        module_tree)
from ray_tpu_torch.rllib.sample_batch import SampleBatch
from ray_tpu_torch.train.optim import (AdamW, tree_leaves, tree_map,
                                       tree_unflatten)

#: sequence-batch keys for recurrent policies (chunk-initial states)
STATE_H = "state_h"
STATE_C = "state_c"

#: the update's stats, in the JAX package's order
STAT_KEYS = ("policy_loss", "vf_loss", "entropy", "total_loss")

_HALF_LOG_2PI_E = 0.5 * (math.log(2 * math.pi) + 1.0)


@dataclasses.dataclass(frozen=True)
class PolicySpec:
    obs_dim: int
    #: discrete: number of actions; continuous: action dimensionality
    #: (set continuous=True)
    n_actions: int
    hidden: Tuple[int, ...] = (64, 64)
    lr: float = 3e-4
    clip_param: float = 0.2
    vf_coeff: float = 0.5
    entropy_coeff: float = 0.01
    num_sgd_iter: int = 6
    minibatch_size: int = 128
    grad_clip: float = 0.5
    #: Box action spaces: diagonal-Gaussian policy (state-dependent mean,
    #: state-independent log_std — standard PPO parameterization).
    continuous: bool = False
    #: full observation shape; None → (obs_dim,).  Rank-3 shapes select
    #: the conv stack from the model catalog.
    obs_shape: Optional[Tuple[int, ...]] = None
    #: ((out_ch, kernel, stride), ...); None → catalog default by shape
    conv_filters: Optional[Tuple[Tuple[int, int, int], ...]] = None
    use_lstm: bool = False
    lstm_cell_size: int = 64
    #: BPTT / attention-context chunk length
    max_seq_len: int = 16
    #: GTrXL-style gated causal self-attention over the last
    #: max_seq_len steps (reference: attention_net.py:37 GTrXLNet).
    #: Context is chunk-local (resets every max_seq_len steps and at
    #: episode boundaries) so training replays rollouts EXACTLY.
    use_attention: bool = False
    attention_dim: int = 64
    attention_heads: int = 4

    @property
    def obs_shape_(self) -> Tuple[int, ...]:
        return tuple(self.obs_shape) if self.obs_shape else (self.obs_dim,)

    def model_config(self) -> ModelConfig:
        return ModelConfig(fcnet_hiddens=tuple(self.hidden),
                           conv_filters=self.conv_filters,
                           use_lstm=self.use_lstm,
                           lstm_cell_size=self.lstm_cell_size,
                           max_seq_len=self.max_seq_len)


class _Tower(nn.Module):
    """``{"enc": encoder, "head": linear readout}`` (feedforward)."""

    def __init__(self, enc: Encoder, head: nn.ModuleList):
        super().__init__()
        self.enc = enc
        self.head = head


class PolicyNet(nn.Module):
    """The policy's parameters, in the JAX package's tree: two
    independent towers (pi, vf) for feedforward specs as the
    reference's default (vf_share_layers=False); one shared encoder
    with an LSTM (or an attention block) and linear pi/vf heads for
    recurrent specs (the reference's LSTM wrapper shape,
    recurrent_net.py); ``log_std`` for continuous ones."""

    def __init__(self, spec: PolicySpec, gen: torch.Generator):
        super().__init__()
        if spec.use_lstm and spec.use_attention:
            raise ValueError("use_lstm and use_attention are exclusive")
        shape, mc = spec.obs_shape_, spec.model_config()
        enc = Encoder(shape, mc, gen)
        feat = enc.feature_dim
        if spec.use_lstm:
            cell = spec.lstm_cell_size
            self.enc = enc
            self.lstm = LSTMCell(gen, feat, cell)
            self.pi = mlp_layers(gen, (cell, spec.n_actions))
            self.vf = mlp_layers(gen, (cell, 1))
        elif spec.use_attention:
            dim = spec.attention_dim
            self.enc = enc
            self.att_in = mlp_layers(gen, (feat, dim))
            self.att = GTrXLBlock(gen, dim, spec.attention_heads,
                                  context_len=spec.max_seq_len)
            self.pi = mlp_layers(gen, (dim, spec.n_actions))
            self.vf = mlp_layers(gen, (dim, 1))
        else:
            self.pi = _Tower(enc, mlp_layers(gen, (feat, spec.n_actions)))
            self.vf = _Tower(Encoder(shape, mc, gen),
                             mlp_layers(gen, (feat, 1)))
        if spec.continuous:
            self.log_std = nn.Parameter(torch.zeros(spec.n_actions))


def clip_by_global_norm(grads, max_norm: float):
    """optax.clip_by_global_norm: leave the gradients as they are while
    their global norm is below ``max_norm``, else scale each by
    ``max_norm / norm`` — on the device, with no host read."""
    norm = torch.stack([(g * g).sum() for g in grads]).sum().sqrt()
    keep = norm < max_norm
    return [torch.where(keep, g, g / norm * max_norm) for g in grads]


def _gaussian_logp(mean, log_std, actions):
    std = torch.exp(log_std)
    return torch.sum(
        -0.5 * torch.square((actions - mean) / std)
        - log_std - 0.5 * math.log(2 * math.pi), dim=-1)


class JaxPolicy:
    """Actor-critic policy with a PPO-clip update.

    Parameters live on ``device`` (the card on the learner, the CPU on
    rollout workers); `get_weights`/`set_weights` move numpy trees in
    the JAX package's layout, so weight broadcast rides the object
    store and checkpoints cross between the packages.
    """

    def __init__(self, spec: PolicySpec, seed: int = 0, mesh=None,
                 device=None):
        """``device``: None = the card (raises without one); rollout
        workers pass "cpu".  ``mesh`` (a learner over several devices)
        is not ported."""
        if mesh is not None:
            from ray_tpu_torch.rllib.algorithm import LEARNER_DEVICES_ITEM

            raise NotImplementedError(
                f"a JaxPolicy over a mesh is not ported yet: "
                f"{LEARNER_DEVICES_ITEM}")
        self.mesh = None
        self.spec = spec
        self.device = resolve_device(device)
        self.net = PolicyNet(spec, torch.Generator().manual_seed(seed)
                             ).to(self.device)
        #: runs every encoder tree of the net (they share one config)
        self.encoder = (self.net.pi.enc if isinstance(self.net.pi, _Tower)
                        else self.net.enc)
        self.params = module_tree(self.net)
        self.tx = AdamW(spec.lr, weight_decay=0.0)
        self.opt_state = self.tx.init(self.params)
        self._gen = torch.Generator(device=self.device).manual_seed(
            seed + 1)
        self._loss = (self._ppo_loss_seq if spec.use_lstm
                      else self._ppo_loss_att if spec.use_attention
                      else self._ppo_loss)
        #: live rollout recurrent state (numpy, (N, cell) x2)
        self._state: Optional[Tuple[np.ndarray, np.ndarray]] = None
        self._eval_state: Optional[Tuple[np.ndarray, np.ndarray]] = None
        #: attention rollout memory: encoded-feature ring of the current
        #: chunk, (N, L, dim); _mem_pos is chunk-global (the worker
        #: aligns fragments to max_seq_len), _mem_start[i] marks where
        #: env i's current episode began inside the chunk
        self._mem: Optional[np.ndarray] = None
        self._mem_pos = 0
        self._mem_start: Optional[np.ndarray] = None
        self.reset_eval_state()

    # -- weights ----------------------------------------------------------
    def get_weights(self):
        return tree_map(lambda t: t.detach().cpu().numpy().copy(),
                        self.params)

    def set_weights(self, weights) -> None:
        mine = tree_leaves(self.params)
        theirs = tree_leaves(weights)
        if len(mine) != len(theirs) or any(
                tuple(p.shape) != np.shape(w) for p, w in zip(mine, theirs)):
            raise ValueError(
                "weights do not fit this policy's tree: "
                f"{[tuple(p.shape) for p in mine]} vs "
                f"{[np.shape(w) for w in theirs]}")
        with torch.no_grad():
            for p, w in zip(mine, theirs):
                p.copy_(torch.tensor(np.asarray(w), dtype=p.dtype))

    def _tree_on_device(self, tree):
        return tree_map(lambda w: torch.tensor(
            np.asarray(w), dtype=torch.float32, device=self.device), tree)

    def _tensor(self, x, dtype=torch.float32):
        return torch.as_tensor(np.asarray(x), dtype=dtype,
                               device=self.device)

    # -- recurrent state --------------------------------------------------
    @property
    def is_recurrent(self) -> bool:
        return self.spec.use_lstm

    @property
    def needs_sequences(self) -> bool:
        """Training batches must be (S, max_seq_len, ...) chunks."""
        return self.spec.use_lstm or self.spec.use_attention

    # -- attention memory -------------------------------------------------
    def reset_memory(self, n: int) -> None:
        """New attention chunk: the worker calls this every max_seq_len
        steps so rollout context matches the chunk-local context
        training recomputes."""
        dim = self.spec.attention_dim
        self._mem = np.zeros((n, self.spec.max_seq_len, dim),
                             np.float32)
        self._mem_pos = 0
        self._mem_start = np.zeros(n, np.int64)

    def get_state(self, n: int) -> Tuple[np.ndarray, np.ndarray]:
        """Current rollout carry for n env copies (zero-init)."""
        cell = self.spec.lstm_cell_size
        if self._state is None or self._state[0].shape[0] != n:
            self._state = (np.zeros((n, cell), np.float32),
                           np.zeros((n, cell), np.float32))
        return self._state

    def reset_state_where(self, done: np.ndarray) -> None:
        """Zero the carry rows of finished envs (mirrors the done-mask
        reset inside the training loop); attention policies advance the
        episode-start marker instead (mirrors the segment mask)."""
        if self._state is not None and done.any():
            self._state[0][done] = 0.0
            self._state[1][done] = 0.0
        if self._mem_start is not None and done.any():
            self._mem_start[done] = self._mem_pos

    def reset_eval_state(self) -> None:
        self._eval_state = None
        self._eval_mem = None
        self._eval_pos = 0
        self._eval_start = None

    def reset_eval_state_where(self, done: np.ndarray) -> None:
        """Zero eval carries of finished episodes (the evaluation analog
        of reset_state_where)."""
        if self._eval_state is not None and done.any():
            self._eval_state[0][done] = 0.0
            self._eval_state[1][done] = 0.0
        if self._eval_start is not None and done.any():
            self._eval_start[done] = self._eval_pos

    # -- networks ---------------------------------------------------------
    def _ff_logits_vf(self, params, obs):
        enc = self.encoder
        logits = mlp_apply(params["pi"]["head"],
                           enc.apply(params["pi"]["enc"], obs))
        vf = mlp_apply(params["vf"]["head"],
                       enc.apply(params["vf"]["enc"], obs))[..., 0]
        return logits, vf

    def _rec_step(self, params, carry, obs):
        """One recurrent forward: carry x obs -> (carry', logits, vf)."""
        feats = self.encoder.apply(params["enc"], obs)
        h, c = lstm_step(params["lstm"], carry, feats)
        logits = mlp_apply(params["pi"], h)
        vf = mlp_apply(params["vf"], h)[..., 0]
        return (h, c), logits, vf

    def _att_step(self, params, mem, pos: int, start, obs):
        """Shared context builder for every single-step attention path
        (act / greedy eval / value): encode obs, write slot ``pos``,
        attend causally over [start_i, pos], return the attended
        feature at ``pos`` plus the updated memory."""
        f = mlp_apply(params["att_in"],
                      self.encoder.apply(params["enc"], obs),
                      final_linear=False)
        mem = mem.clone()
        mem[:, pos] = f
        L = mem.shape[1]
        idx = torch.arange(L, device=mem.device)
        valid = (idx[None, :] <= pos) & (idx[None, :] >= start[:, None])
        mask = valid[:, None, :] & valid[:, :, None]   # (N, L, L)
        out = attention_apply(params["att"], mem,
                              self.spec.attention_heads, mask=mask)
        return out[:, pos], mem

    def _sample(self, logits, params, greedy: bool = False):
        if self.spec.continuous:
            log_std = params["log_std"]
            if greedy:
                actions = logits
            else:
                noise = torch.randn(logits.shape, generator=self._gen,
                                    device=logits.device,
                                    dtype=logits.dtype)
                actions = logits + torch.exp(log_std) * noise
            logp = _gaussian_logp(logits, log_std, actions)
        else:
            if greedy:
                actions = torch.argmax(logits, dim=-1)
            else:
                actions = torch.multinomial(
                    torch.softmax(logits, dim=-1), 1,
                    generator=self._gen)[:, 0]
            logp = torch.log_softmax(logits, dim=-1).gather(
                -1, actions[:, None])[:, 0]
        return actions, logp

    # -- losses -----------------------------------------------------------
    def _logp_entropy(self, params, logits, actions):
        if self.spec.continuous:
            log_std = params["log_std"]
            logp = _gaussian_logp(logits, log_std, actions)
            entropy = torch.sum(log_std + _HALF_LOG_2PI_E)
        else:
            logp_all = torch.log_softmax(logits, dim=-1)
            logp = logp_all.gather(-1, actions[..., None].long())[..., 0]
            entropy = -torch.mean(
                torch.sum(torch.exp(logp_all) * logp_all, dim=-1))
        return logp, entropy

    def _ppo_objective(self, logp, entropy, vf, batch):
        spec = self.spec
        ratio = torch.exp(logp - batch[sb.ACTION_LOGP])
        adv = batch[sb.ADVANTAGES]
        surr = torch.minimum(
            ratio * adv,
            torch.clamp(ratio, 1 - spec.clip_param,
                        1 + spec.clip_param) * adv)
        pi_loss = -torch.mean(surr)
        vf_loss = torch.mean(torch.square(vf - batch[sb.VALUE_TARGETS]))
        total = pi_loss + spec.vf_coeff * vf_loss \
            - spec.entropy_coeff * entropy
        return total, {"policy_loss": pi_loss, "vf_loss": vf_loss,
                       "entropy": entropy, "total_loss": total}

    def _ppo_loss(self, params, batch):
        logits, vf = self._ff_logits_vf(params, batch[sb.OBS])
        logp, entropy = self._logp_entropy(params, logits,
                                           batch[sb.ACTIONS])
        return self._ppo_objective(logp, entropy, vf, batch)

    def _ppo_loss_att(self, params, batch):
        """Attention loss over (S, L, ...) chunks: causal attention
        with a segment mask cut at episode boundaries — the exact
        context the rollout used (chunk-local, start-marker resets)."""
        obs = batch[sb.OBS]
        S, L = obs.shape[0], obs.shape[1]
        feats = self.encoder.apply(
            params["enc"], obs.reshape((S * L,) + self.encoder.obs_shape))
        x = mlp_apply(params["att_in"], feats,
                      final_linear=False).reshape(S, L, -1)
        dones = batch[sb.DONES].to(torch.int32)
        # segment id = number of dones BEFORE each position
        seg = torch.cumsum(torch.cat(
            [torch.zeros((S, 1), dtype=torch.int32, device=obs.device),
             dones[:, :-1]], dim=1), dim=1)
        same = seg[:, :, None] == seg[:, None, :]
        out = attention_apply(params["att"], x, self.spec.attention_heads,
                              mask=same)
        logits = mlp_apply(params["pi"], out)
        vf = mlp_apply(params["vf"], out)[..., 0]
        logp, entropy = self._logp_entropy(params, logits,
                                           batch[sb.ACTIONS])
        return self._ppo_objective(logp, entropy, vf, batch)

    def _ppo_loss_seq(self, params, batch):
        """Recurrent loss over (S, L, ...) sequence chunks: encoder on
        the flattened steps, then the cell over time with done-masked
        carry resets (reference: rnn_sequencing + LSTM loss; the JAX
        package's lax.scan)."""
        obs = batch[sb.OBS]
        S, L = obs.shape[0], obs.shape[1]
        feats = self.encoder.apply(
            params["enc"], obs.reshape((S * L,) + self.encoder.obs_shape))
        feats = feats.reshape(S, L, -1)
        keep = 1.0 - batch[sb.DONES].to(feats.dtype)
        carry = (batch[STATE_H], batch[STATE_C])
        hs = []
        for t in range(L):
            h, c = lstm_step(params["lstm"], carry, feats[:, t])
            hs.append(h)
            mask = keep[:, t, None]
            carry = (h * mask, c * mask)
        hs = torch.stack(hs, dim=1)                   # (S, L, cell)
        logits = mlp_apply(params["pi"], hs)
        vf = mlp_apply(params["vf"], hs)[..., 0]
        logp, entropy = self._logp_entropy(params, logits,
                                           batch[sb.ACTIONS])
        return self._ppo_objective(logp, entropy, vf, batch)

    def loss_and_grads(self, batch: Dict[str, torch.Tensor]):
        """(total loss, stats, gradients in ``params``' tree) at the
        current parameters: the JAX package's ``policy._grad``."""
        leaves = tree_leaves(self.params)
        total, stats = self._loss(self.params, batch)
        grads = torch.autograd.grad(total, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        return total, stats, grads

    def _step(self, grads) -> None:
        self.tx.update_(self.params,
                        clip_by_global_norm(grads, self.spec.grad_clip),
                        self.opt_state)

    # -- inference --------------------------------------------------------
    @torch.no_grad()
    def compute_actions(self, obs: np.ndarray):
        obs_t = self._tensor(obs)
        if self.spec.use_attention:
            n = obs.shape[0]
            if self._mem is None or self._mem.shape[0] != n \
                    or self._mem_pos >= self.spec.max_seq_len:
                self.reset_memory(n)
            h, mem = self._att_step(
                self.params, self._tensor(self._mem), self._mem_pos,
                self._tensor(self._mem_start, torch.int64), obs_t)
            logits = mlp_apply(self.params["pi"], h)
            vf = mlp_apply(self.params["vf"], h)[..., 0]
            self._mem = mem.cpu().numpy()
            self._mem_pos += 1
        elif self.spec.use_lstm:
            h, c = self.get_state(obs.shape[0])
            (h2, c2), logits, vf = self._rec_step(
                self.params, (self._tensor(h), self._tensor(c)), obs_t)
            self._state = (h2.cpu().numpy(), c2.cpu().numpy())
        else:
            logits, vf = self._ff_logits_vf(self.params, obs_t)
        actions, logp = self._sample(logits, self.params)
        return (actions.cpu().numpy(), logp.cpu().numpy(),
                vf.cpu().numpy())

    @torch.no_grad()
    def action_probs(self, obs: np.ndarray, params=None) -> np.ndarray:
        """Action distribution at `obs` for feedforward policies —
        optionally under an EXTERNAL weight tree with this policy's
        layout (league snapshot probes)."""
        if self.spec.use_lstm or self.spec.use_attention \
                or self.spec.continuous:
            raise NotImplementedError(
                "action_probs serves feedforward categorical policies")
        obs = np.asarray(obs, np.float32)
        if obs.ndim == 1:
            obs = obs[None]
        tree = self.params if params is None \
            else self._tree_on_device(params)
        logits, _ = self._ff_logits_vf(tree, self._tensor(obs))
        return torch.softmax(logits, dim=-1).cpu().numpy()

    @torch.no_grad()
    def compute_deterministic_actions(self, obs: np.ndarray) -> np.ndarray:
        """Greedy/mean actions for evaluation (reference:
        explore=False in Algorithm.evaluate's policy calls)."""
        obs = np.asarray(obs, np.float32)
        obs_t = self._tensor(obs)
        n = obs.shape[0]
        if self.spec.use_attention:
            L = self.spec.max_seq_len
            if (self._eval_mem is None or self._eval_mem.shape[0] != n
                    or self._eval_pos >= L):
                self._eval_mem = np.zeros(
                    (n, L, self.spec.attention_dim), np.float32)
                self._eval_pos = 0
                self._eval_start = np.zeros(n, np.int64)
            h, mem = self._att_step(
                self.params, self._tensor(self._eval_mem), self._eval_pos,
                self._tensor(self._eval_start, torch.int64), obs_t)
            logits = mlp_apply(self.params["pi"], h)
            self._eval_mem = mem.cpu().numpy()
            self._eval_pos += 1
        elif self.spec.use_lstm:
            cell = self.spec.lstm_cell_size
            if (self._eval_state is None
                    or self._eval_state[0].shape[0] != n):
                self._eval_state = (np.zeros((n, cell), np.float32),
                                    np.zeros((n, cell), np.float32))
            (h, c), logits, _ = self._rec_step(
                self.params, tuple(self._tensor(s) for s in
                                   self._eval_state), obs_t)
            self._eval_state = (h.cpu().numpy(), c.cpu().numpy())
        else:
            logits, _ = self._ff_logits_vf(self.params, obs_t)
        actions, _ = self._sample(logits, self.params, greedy=True)
        return actions.cpu().numpy()

    @torch.no_grad()
    def value(self, obs: np.ndarray, rows=None) -> np.ndarray:
        """State values; for recurrent policies ``rows`` selects which
        env copies' live carries pair with ``obs`` (bootstrapping a
        done subset mid-rollout)."""
        obs = np.asarray(obs, np.float32)
        obs_t = self._tensor(obs)
        n = obs.shape[0]
        if self.spec.use_attention:
            L = self.spec.max_seq_len
            if self._mem is not None and self._mem_pos < L:
                mem, start = self._mem, self._mem_start
                if rows is not None:
                    mem, start = mem[rows], start[rows]
                pos = self._mem_pos
            else:
                # no context yet, or the chunk just filled: the NEXT
                # policy step sees a fresh chunk, so V(s) must be
                # computed in that same fresh context (overwriting the
                # last slot would silently drop obs_{T-1})
                mem = np.zeros((n, L, self.spec.attention_dim),
                               np.float32)
                start = np.zeros(n, np.int64)
                pos = 0
            h, _ = self._att_step(self.params, self._tensor(mem), pos,
                                  self._tensor(start, torch.int64), obs_t)
            return mlp_apply(self.params["vf"], h)[..., 0].cpu().numpy()
        if self.spec.use_lstm:
            if self._state is not None:
                h, c = self._state
                if rows is not None:
                    h, c = h[rows], c[rows]
            else:
                cell = self.spec.lstm_cell_size
                h = np.zeros((n, cell), np.float32)
                c = h
            _, _, vf = self._rec_step(
                self.params, (self._tensor(h), self._tensor(c)), obs_t)
            return vf.cpu().numpy()
        return self._ff_logits_vf(self.params, obs_t)[1].cpu().numpy()

    # -- learning ---------------------------------------------------------
    def compute_gradients(self, batch: SampleBatch):
        """Gradients of the policy loss on `batch` WITHOUT applying
        them (reference: Policy.compute_gradients) — numpy tree +
        stats, so gradients can cross the object store (DDPPO's
        allreduce-style data parallelism)."""
        _, stats, grads = self.loss_and_grads(batch.to_device(self.device))
        return (tree_unflatten(self.params, [
                    g.detach().cpu().numpy() for g in grads]),
                {k: float(v.detach()) for k, v in stats.items()})

    def apply_gradients(self, grads) -> None:
        """Apply externally computed (e.g. worker-averaged) gradients
        through this policy's optimizer (reference:
        Policy.apply_gradients)."""
        self._step(tree_leaves(self._tree_on_device(grads)))

    def _update(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """num_sgd_iter epochs over shuffled minibatches, on the device;
        returns the last minibatch's stats (STAT_KEYS order) as one
        tensor, read by the caller after the loop."""
        spec = self.spec
        n = batch[sb.OBS].shape[0]
        mb_eff = min(spec.minibatch_size, n)  # batches under a minibatch
        n_mb = max(1, n // mb_eff)
        usable = n_mb * mb_eff
        stats = None
        for _ in range(spec.num_sgd_iter):
            perm = torch.randperm(n, generator=self._gen,
                                  device=self.device)[:usable]
            for rows in perm.view(n_mb, mb_eff):
                mini = {k: v[rows] for k, v in batch.items()}
                _, stats, grads = self.loss_and_grads(mini)
                self._step(grads)
        return torch.stack([stats[k].detach() for k in STAT_KEYS])

    def learn_on_batch(self, batch: SampleBatch) -> Dict[str, float]:
        stats = self._update(batch.to_device(self.device))
        return dict(zip(STAT_KEYS, stats.tolist()))
