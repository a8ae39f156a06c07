"""The RLlib learner on the card: its default device, its loss,
gradients and one update on the card against the same policy on the
CPU, and an update loop that makes no synchronising call.

Needs an NVIDIA GPU: every test here is marked ``cuda`` and skips with
a reason where ``torch.cuda.is_available()`` is false.  This file
imports no JAX, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_rllib_cuda.py

Tolerances, f32 with TF32 off (cuDNN's and the CPU's convolutions and
products sum the same terms in other orders): the loss within 1e-5
relative, each gradient leaf within 1e-4 as ||card - cpu|| / ||cpu||
(chip_smoke.py's phase rllib (b) holds the Atari-scale update to the
same), and the parameters after one update within 1e-5 but for
elements whose gradient is within rounding of zero, whose Adam first
step (about lr times its sign) may go either way.
"""

import numpy as np
import pytest
import torch

from ray_tpu_torch.rllib import sample_batch as sb
from ray_tpu_torch.rllib.algorithm import AlgorithmConfig
from ray_tpu_torch.rllib.policy import STATE_C, STATE_H, JaxPolicy, PolicySpec
from ray_tpu_torch.rllib.sample_batch import SampleBatch
from ray_tpu_torch.train.optim import tree_leaves

LOSS_RTOL = 1e-5
GRAD_REL = 1e-4
PARAM_ATOL = 1e-5
LR = 1e-3

KINDS = {
    "conv": dict(obs_dim=192, n_actions=3, hidden=(128,),
                 obs_shape=(8, 8, 3)),
    "atari": dict(obs_dim=84 * 84 * 4, n_actions=4, hidden=(256,),
                  obs_shape=(84, 84, 4)),
    "lstm": dict(obs_dim=3, n_actions=3, hidden=(64,), use_lstm=True,
                 lstm_cell_size=64, max_seq_len=16),
    "attention": dict(obs_dim=3, n_actions=3, hidden=(64,),
                      use_attention=True, attention_dim=64,
                      attention_heads=4, max_seq_len=16),
    "continuous": dict(obs_dim=3, n_actions=2, hidden=(64, 64),
                       continuous=True),
}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA): the learner runs on the "
                    "card")
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda:0")
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = old


def _batch(spec, rng, rows=64):
    seq = spec.use_lstm or spec.use_attention
    lead = (rows // spec.max_seq_len, spec.max_seq_len) if seq else (rows,)
    if seq:
        obs = np.eye(spec.obs_dim, dtype=np.float32)[
            rng.integers(0, spec.obs_dim, lead)]
    else:
        obs = rng.random((*lead, *spec.obs_shape_), dtype=np.float32)
    actions = (rng.standard_normal((*lead, spec.n_actions), np.float32)
               if spec.continuous
               else rng.integers(0, spec.n_actions, lead))
    data = {sb.OBS: obs, sb.ACTIONS: actions,
            sb.ACTION_LOGP: (np.log(1.0 / spec.n_actions) + 0.3
                             * rng.standard_normal(lead)).astype(np.float32),
            sb.ADVANTAGES: rng.standard_normal(lead, np.float32),
            sb.VALUE_TARGETS: rng.standard_normal(lead, np.float32),
            sb.DONES: rng.random(lead) < 0.2}
    if spec.use_lstm:
        for k in (STATE_H, STATE_C):
            data[k] = rng.standard_normal((lead[0], spec.lstm_cell_size),
                                          np.float32)
    return SampleBatch(data)


def _pair(kind, card):
    spec = PolicySpec(**KINDS[kind], lr=LR, num_sgd_iter=1,
                      minibatch_size=4096)
    gpu = JaxPolicy(spec, seed=0, device=card)
    cpu = JaxPolicy(spec, seed=1, device="cpu")
    cpu.set_weights(gpu.get_weights())
    return spec, gpu, cpu


@pytest.mark.cuda
def test_the_learner_defaults_to_the_card(card):
    pol = JaxPolicy(PolicySpec(**KINDS["conv"]))
    assert all(p.device == card for p in pol.net.parameters())
    assert pol._gen.device.type == "cuda"
    assert AlgorithmConfig().learner_device is None
    assert pol.compute_actions(np.zeros((2, 8, 8, 3), np.float32))[0] \
        .shape == (2,)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", list(KINDS))
def test_loss_and_gradients_on_the_card_match_the_cpu(card, kind):
    spec, gpu, cpu = _pair(kind, card)
    batch = _batch(spec, np.random.default_rng(0),
                   rows=32 if kind == "atari" else 64)
    loss, _, grads = gpu.loss_and_grads(batch.to_device(card))
    rloss, _, rgrads = cpu.loss_and_grads(batch.to_device("cpu"))
    assert abs(float(loss.detach()) - float(rloss.detach())) <= \
        LOSS_RTOL * abs(float(rloss.detach()))
    for g, r in zip(grads, rgrads):
        assert g.device == card
        rel = float((g.cpu() - r).norm() / r.norm().clamp_min(1e-30))
        assert rel <= GRAD_REL, rel


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["conv", "lstm", "attention"])
def test_one_update_on_the_card_matches_the_cpu(card, kind):
    spec, gpu, cpu = _pair(kind, card)
    batch = _batch(spec, np.random.default_rng(1))
    _, _, grads = cpu.loss_and_grads(batch.to_device("cpu"))
    before = tree_leaves(cpu.get_weights())
    gstats = gpu.learn_on_batch(batch)
    cstats = cpu.learn_on_batch(batch)
    for k, v in cstats.items():
        assert abs(gstats[k] - v) <= 1e-4 * max(1.0, abs(v)), (k, gstats, v)
    for got, want, b, g in zip(tree_leaves(gpu.get_weights()),
                               tree_leaves(cpu.get_weights()), before,
                               grads):
        g = g.numpy()
        tiny = np.abs(g) <= 1e-6 * max(np.abs(g).max(), 1e-30)
        diff = np.abs(got - want)
        assert np.all((diff <= PARAM_ATOL) | (tiny & (diff <= 2 * LR))), \
            float(diff.max())


@pytest.mark.cuda
def test_the_update_reads_nothing_back_until_it_ends(card):
    """The update loop (epochs of shuffled minibatches, the clip, AdamW)
    makes no synchronising call: torch's sync debug mode raises on one."""
    spec = PolicySpec(**KINDS["conv"], num_sgd_iter=2, minibatch_size=16)
    pol = JaxPolicy(spec, device=card)
    batch = _batch(spec, np.random.default_rng(2)).to_device(card)
    pol._update(batch)                   # warm-up: allocator, cuDNN
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        stats = pol._update(batch)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert stats.device == card and bool(stats.isfinite().all())
