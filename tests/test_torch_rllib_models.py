"""The port's RLlib model catalog and policies (``ray_tpu_torch/rllib/
models.py``, ``policy.py``) against the JAX package's, on the CPU in f32.

Catalog blocks take the same numpy parameters (made by the JAX
package's own init functions): MLP, the conv stacks at MinAtar's and
Atari's shapes (XLA's asymmetric "SAME" pads, the NHWC flatten), the
LSTM cell, the GTrXL block with a segment mask and a fully masked row,
and the Encoder, within atol 1e-5 (ATOL).  Each policy kind (ff, conv,
LSTM, attention, continuous) takes the JAX policy's ``get_weights``
through ``set_weights``, then holds its logits, values and greedy
actions, its loss and every gradient leaf at a fixed minibatch against
``policy._grad`` (rtol 1e-4, atol 1e-5: GRAD_RTOL, ATOL) and its
parameters after one ``learn_on_batch`` whose one minibatch covers the
batch (so the permutation only reorders a mean) within 1e-5; an
element whose gradient is within rounding of zero may take Adam's
first step (about ``lr`` times its sign) the other way, and is held to
one step instead (see ``_adam_first_step_ok``).  Sampled actions are
held to ``softmax(logits)`` by a chi-square test and the Gaussian's to
its mean and std.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats as sstats

from ray_tpu.rllib import models as jm
from ray_tpu.rllib import sample_batch as jsb
from ray_tpu.rllib.policy import JaxPolicy as JPolicy
from ray_tpu.rllib.policy import PolicySpec as JSpec
from ray_tpu_torch.rllib import models as tm
from ray_tpu_torch.rllib import sample_batch as sb
from ray_tpu_torch.rllib.policy import STATE_C, STATE_H, STAT_KEYS
from ray_tpu_torch.rllib.policy import JaxPolicy as TPolicy
from ray_tpu_torch.rllib.policy import PolicySpec as TSpec
from ray_tpu_torch.rllib.sample_batch import SampleBatch
from ray_tpu_torch.train.optim import tree_leaves, tree_map

ATOL = 1e-5
GRAD_RTOL = 1e-4
PARAM_ATOL = 1e-5


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _params(seed, init_fn, *args, **kwargs):
    """Seeded numpy parameters in the tree ``init_fn`` makes (its
    shapes by ``jax.eval_shape``, nothing compiled), every leaf drawn
    non-zero at the init's scale: a weight N(0, 1 / fan_in) (fan_in =
    all but its last axis, as the catalog's inits), a vector N(0,
    0.1**2) (the inits' zero biases, gains and offsets made visible)."""
    rng = np.random.RandomState(seed)
    shapes = jax.eval_shape(
        lambda: init_fn(jax.random.PRNGKey(0), *args, **kwargs))

    def draw(s):
        scale = (0.1 if len(s.shape) == 1
                 else 1.0 / np.sqrt(np.prod(s.shape[:-1])))
        return (scale * rng.randn(*s.shape)).astype(np.float32)

    return jax.tree.map(draw, shapes)


def _t(tree):
    return tree_map(lambda a: torch.tensor(np.asarray(a)), tree)


def _shapes(module):
    """The port module's tree of parameter shapes, as a JAX tree."""
    return jax.tree.map(np.shape, tree_map(
        lambda p: p.detach().numpy(), tm.module_tree(module)))


def _load(module, params):
    """Copy a numpy tree of the JAX layout into ``module``'s parameters."""
    with torch.no_grad():
        for p, w in zip(tree_leaves(tm.module_tree(module)),
                        jax.tree_util.tree_leaves(params)):
            p.copy_(torch.as_tensor(np.asarray(w)))


def _close(got, want, atol=ATOL, rtol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=atol, rtol=rtol)


# ---- catalog blocks -----------------------------------------------------

def test_mlp_matches_jax():
    params = _params(0, jm.mlp_init, (7, 16, 5))
    x = np.random.RandomState(0).randn(6, 7).astype(np.float32)
    for final_linear in (True, False):
        _close(tm.mlp_apply(_t(params), torch.as_tensor(x), final_linear),
               jm.mlp_apply(params, x, final_linear))


@pytest.mark.parametrize("obs_shape,filters", [
    ((8, 8, 3), None),                       # MinAtar size 8: pads 0/1
    ((10, 10, 3), None),                     # MinAtar size 10
    ((84, 84, 4), None),                     # Atari: pads 2/2, 1/2, 1/1
    ((9, 7, 2), ((4, 3, 2), (6, 2, 1))),     # odd sides, even kernel
])
def test_conv_stack_matches_jax(obs_shape, filters):
    filters = filters or jm.default_conv_filters(obs_shape)
    params = _params(1, jm.conv_init, obs_shape[2], filters)
    x = np.random.RandomState(1).rand(3, *obs_shape).astype(np.float32)
    got = tm.conv_apply(_t(params), torch.as_tensor(x), filters)
    want = jax.jit(jm.conv_apply, static_argnums=2)(params, x, filters)
    assert got.shape == want.shape == (
        3, tm.conv_out_dim(obs_shape, filters))
    _close(got, want)


def test_lstm_step_matches_jax():
    params = _params(2, jm.lstm_init, 5, 8)
    rng = np.random.RandomState(2)
    x = rng.randn(4, 5).astype(np.float32)
    h, c = (rng.randn(4, 8).astype(np.float32) for _ in range(2))
    got = tm.lstm_step(_t(params), (torch.as_tensor(h),
                                    torch.as_tensor(c)), torch.as_tensor(x))
    want = jm.lstm_step(params, (h, c), x)
    for g, w in zip(got, want):
        _close(g, w)
    cell = tm.LSTMCell(torch.Generator().manual_seed(0), 5, 8)
    assert {k: tuple(v.shape) for k, v in tm.module_tree(cell).items()} \
        == {k: v.shape for k, v in params.items()}
    init_b = cell.b.detach().clone()
    _load(cell, params)
    with torch.no_grad():
        for g, w in zip(cell((torch.as_tensor(h), torch.as_tensor(c)),
                             torch.as_tensor(x)), want):
            _close(g, w)
    np.testing.assert_array_equal(       # the forget-gate bias of 1
        init_b.numpy(),
        np.repeat([0.0, 1.0, 0.0, 0.0], 8).astype(np.float32))


def test_attention_matches_jax_with_segments_and_a_masked_row():
    dim, heads, T = 16, 4, 6
    params = _params(3, jm.attention_init, dim, heads, context_len=8)
    rng = np.random.RandomState(3)
    x = rng.randn(3, T, dim).astype(np.float32)
    seg = np.array([[0, 0, 1, 1, 1, 2], [0, 0, 0, 0, 0, 0],
                    [0, 1, 2, 3, 4, 5]])
    mask = seg[:, :, None] == seg[:, None, :]
    mask[1, 3, :] = False            # a fully masked row: the diagonal
    for m in (None, mask):
        got = tm.attention_apply(_t(params), torch.as_tensor(x), heads,
                                 None if m is None else torch.as_tensor(m))
        _close(got, jax.jit(jm.attention_apply, static_argnums=2)(
            params, x, heads, mask=m))
    block = tm.GTrXLBlock(torch.Generator().manual_seed(0), dim, heads,
                          context_len=8)
    assert _shapes(block) == jax.tree.map(np.shape, params)
    _load(block, params)
    with torch.no_grad():
        _close(block(torch.as_tensor(x), torch.as_tensor(mask)),
               jax.jit(jm.attention_apply, static_argnums=2)(
                   params, x, heads, mask=mask))


@pytest.mark.parametrize("obs_shape", [(6,), (8, 8, 3)])
def test_encoder_matches_jax(obs_shape):
    cfg = jm.ModelConfig(fcnet_hiddens=(16, 8))
    jenc = jm.Encoder(obs_shape, cfg)
    params = _params(4, lambda key: jenc.init(key))
    tenc = tm.Encoder(obs_shape, tm.ModelConfig(fcnet_hiddens=(16, 8)),
                      torch.Generator().manual_seed(0))
    assert tenc.feature_dim == jenc.feature_dim
    assert _shapes(tenc) == jax.tree.map(np.shape, params)
    x = np.random.RandomState(4).rand(5, *obs_shape).astype(np.float32)
    want = jax.jit(jenc.apply)(params, x)
    _close(tenc.apply(_t(params), torch.as_tensor(x)), want)
    _load(tenc, params)
    with torch.no_grad():
        _close(tenc(torch.as_tensor(x)), want)


# ---- policies -----------------------------------------------------------

KINDS = {
    "ff": dict(obs_dim=4, n_actions=2, hidden=(16, 16)),
    "conv": dict(obs_dim=192, n_actions=3, hidden=(32,),
                 obs_shape=(8, 8, 3)),
    "lstm": dict(obs_dim=3, n_actions=3, hidden=(16,), use_lstm=True,
                 lstm_cell_size=8, max_seq_len=8),
    "attention": dict(obs_dim=3, n_actions=3, hidden=(16,),
                      use_attention=True, attention_dim=16,
                      attention_heads=2, max_seq_len=8),
    "continuous": dict(obs_dim=3, n_actions=2, hidden=(16,),
                       continuous=True),
}
LR = 1e-3
#: one minibatch covers every test batch, one pass: learn_on_batch
#: takes one step whose permutation only reorders a mean
ONE_STEP = dict(lr=LR, num_sgd_iter=1, minibatch_size=1024)


def _pair(kind):
    kw = dict(KINDS[kind], **ONE_STEP)
    jpol = JPolicy(JSpec(**kw), seed=0)
    tpol = TPolicy(TSpec(**kw), seed=0, device="cpu")
    tpol.set_weights(jpol.get_weights())
    return jpol, tpol


@pytest.fixture(scope="module", params=list(KINDS))
def pair(request):
    """(kind, JAX policy, port policy with its weights), shared by the
    kind's tests (they advance both alike); the one update test is the
    only one that steps them."""
    return (request.param, *_pair(request.param))


def _batch(kind, spec, rng, rows=24):
    """A fixed minibatch: ``rows`` steps, or rows // L sequences of L."""
    seq = spec.use_lstm or spec.use_attention
    lead = (rows // spec.max_seq_len, spec.max_seq_len) if seq else (rows,)
    obs = rng.rand(*lead, *spec.obs_shape_).astype(np.float32)
    if kind in ("lstm", "attention"):
        obs = np.eye(spec.obs_dim, dtype=np.float32)[
            rng.randint(0, spec.obs_dim, lead)]
    if spec.continuous:
        actions = rng.randn(*lead, spec.n_actions).astype(np.float32)
    else:
        actions = rng.randint(0, spec.n_actions, lead).astype(np.int64)
    data = {
        sb.OBS: obs, sb.ACTIONS: actions,
        sb.ACTION_LOGP: (np.log(1.0 / spec.n_actions)
                         + 0.3 * rng.randn(*lead)).astype(np.float32),
        sb.ADVANTAGES: rng.randn(*lead).astype(np.float32),
        sb.VALUE_TARGETS: rng.randn(*lead).astype(np.float32),
        sb.DONES: rng.rand(*lead) < 0.2,
    }
    if spec.use_lstm:
        for k in (STATE_H, STATE_C):
            data[k] = rng.randn(lead[0], spec.lstm_cell_size
                                ).astype(np.float32)
    return data


def test_policy_outputs_match_jax(pair):
    kind, jpol, tpol = pair
    spec = tpol.spec
    rng = np.random.RandomState(5)
    obs = rng.rand(6, *spec.obs_shape_).astype(np.float32)
    if kind in ("lstm", "attention"):
        obs = np.eye(spec.obs_dim, dtype=np.float32)[rng.randint(0, 3, 6)]
    if kind in ("ff", "conv", "continuous"):
        tl, tv = tpol._ff_logits_vf(tpol.params, torch.as_tensor(obs))
        jl, jv = jpol._ff_logits_vf(jpol.params, obs)
        _close(tl.detach(), jl)
        _close(tv.detach(), jv)
    # greedy actions and values through several steps (the recurrent
    # carries and the attention memory advance alike)
    for _ in range(3):
        _close(tpol.value(obs), jpol.value(obs))
        got = tpol.compute_deterministic_actions(obs)
        want = jpol.compute_deterministic_actions(obs)
        if spec.continuous:
            _close(got, want)
        else:
            np.testing.assert_array_equal(got, np.asarray(want))
    if kind == "ff":
        _close(tpol.action_probs(obs), jpol.action_probs(obs))
        other = jax.tree.map(lambda a: a * 0.5, jpol.get_weights())
        _close(tpol.action_probs(obs, params=other),
               jpol.action_probs(obs, params=other))


def test_policy_loss_and_gradients_match_jax(pair):
    kind, jpol, tpol = pair
    batch = _batch(kind, tpol.spec, np.random.RandomState(6))
    (jloss, jstats), jgrads = jpol._grad(
        jpol.params, {k: jnp.asarray(v) for k, v in batch.items()})
    tloss, tstats, tgrads = tpol.loss_and_grads(
        SampleBatch(batch).to_device("cpu"))
    _close(tloss.detach(), jloss, rtol=GRAD_RTOL)
    for k in STAT_KEYS:
        _close(tstats[k].detach(), jstats[k], rtol=GRAD_RTOL)
    want = jax.tree_util.tree_leaves(jgrads)
    assert len(tgrads) == len(want)
    for g, w in zip(tgrads, want):
        assert tuple(g.shape) == w.shape
        _close(g, w, rtol=GRAD_RTOL)
    # compute_gradients: the same numbers as a numpy tree in the JAX
    # package's layout
    np_grads, np_stats = tpol.compute_gradients(SampleBatch(batch))
    assert jax.tree.map(np.shape, np_grads) == jax.tree.map(np.shape,
                                                            _np(jgrads))
    assert set(np_stats) == set(STAT_KEYS)


def _adam_first_step_ok(got, want, before, grad, lr=LR):
    """Params within PARAM_ATOL, but for elements whose gradient is
    within rounding of zero (|g| below 1e-6 of the leaf's largest):
    Adam's first step is lr * g / (|g| + eps), about lr times the sign
    of g, so those are held to one step (2 lr) instead."""
    diff = np.abs(got - want)
    tiny = np.abs(grad) <= 1e-6 * max(np.abs(grad).max(), 1e-30)
    assert np.all((diff <= PARAM_ATOL) | (tiny & (diff <= 2 * lr))), \
        float(diff.max())
    # and the step itself went the same way everywhere else
    assert np.all(np.sign(got - before)[~tiny]
                  == np.sign(want - before)[~tiny])


def test_one_update_matches_jax(pair):
    kind, jpol, tpol = pair
    batch = _batch(kind, tpol.spec, np.random.RandomState(7))
    before = jax.tree_util.tree_leaves(jpol.get_weights())
    (_, _), jgrads = jpol._grad(
        jpol.params, {k: jnp.asarray(v) for k, v in batch.items()})
    jstats = jpol.learn_on_batch(jsb.SampleBatch(batch))
    tstats = tpol.learn_on_batch(SampleBatch(batch))
    assert list(tstats) == list(STAT_KEYS)
    for k in STAT_KEYS:
        _close(tstats[k], jstats[k], rtol=GRAD_RTOL)
    for got, want, b, g in zip(tree_leaves(tpol.get_weights()),
                               jax.tree_util.tree_leaves(jpol.get_weights()),
                               before, jax.tree_util.tree_leaves(jgrads)):
        _adam_first_step_ok(got, np.asarray(want), b, np.asarray(g))


def test_sampled_actions_follow_the_distributions():
    """Categorical draws against softmax(logits) (chi-square, p > 1e-3
    for each of 3 observations over 20,000 draws); Gaussian draws'
    mean and std against the policy's mean and exp(log_std)."""
    tpol = TPolicy(TSpec(**KINDS["conv"]), seed=1, device="cpu")
    obs = np.random.RandomState(8).rand(3, 8, 8, 3).astype(np.float32)
    n = 20_000
    probs = tpol.action_probs(obs)
    acts = tpol.compute_actions(np.repeat(obs, n, axis=0))[0].reshape(3, n)
    for i in range(3):
        counts = np.bincount(acts[i], minlength=3)
        p = probs[i].astype(np.float64)
        want = p / p.sum() * n
        assert sstats.chisquare(counts, want).pvalue > 1e-3, \
            (counts, probs[i])
    cpol = TPolicy(TSpec(**KINDS["continuous"]), seed=1, device="cpu")
    with torch.no_grad():
        cpol.params["log_std"].copy_(torch.tensor([-0.5, 0.3]))
    obs = np.random.RandomState(9).rand(1, 3).astype(np.float32)
    mean = cpol.compute_deterministic_actions(obs)[0]
    a, logp, _ = cpol.compute_actions(np.repeat(obs, n, axis=0))
    std = np.exp([-0.5, 0.3])
    z = (a.mean(0) - mean) / (std / np.sqrt(n))
    assert np.all(np.abs(z) < 4.5), z
    np.testing.assert_allclose(a.std(0), std, rtol=0.03)
    want_logp = sstats.norm.logpdf(a, mean, std).sum(-1)
    _close(logp, want_logp, atol=1e-4)


def test_weights_cross_both_ways_and_misfits_raise():
    """The port's tree loads into the JAX policy bit for bit (the JAX
    package's into the port's: every test above); a tree of another
    layout raises."""
    tpol = TPolicy(TSpec(**KINDS["lstm"]), seed=2, device="cpu")
    back = JPolicy(JSpec(**KINDS["lstm"]), seed=3)
    back.set_weights(tpol.get_weights())
    assert jax.tree.map(np.shape, _np(back.get_weights())) == \
        jax.tree.map(np.shape, tpol.get_weights())
    for a, b in zip(jax.tree_util.tree_leaves(back.get_weights()),
                    tree_leaves(tpol.get_weights())):
        np.testing.assert_array_equal(np.asarray(a), b)
    with pytest.raises(ValueError, match="do not fit"):
        tpol.set_weights(TPolicy(TSpec(**KINDS["attention"]),
                                 device="cpu").get_weights())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if torch.cuda.is_available():
            pytest.skip("a card is present: the default device works")
        TPolicy(TSpec(**KINDS["ff"]))
