"""The port's host-side RLlib modules (``ray_tpu_torch/rllib/
sample_batch.py``, ``filters.py``, ``connectors.py``,
``replay_buffer.py``, ``vector_env.py``, ``envs.py``) against the JAX
package's: numpy copies, so every output is held equal exactly on the
same seeded inputs — batches, GAE, filter states and their merge,
connector pipelines, replay samples and priorities, and the three
in-repo vector envs stepped by seeded actions.  The envs build their
spaces from the port's own ``Box``/``Discrete`` with the attributes the
connectors and ``_introspect_spaces`` read; a process where gymnasium
cannot be imported builds and steps them, and only an env id that is
not in the repo reaches gymnasium's ImportError.
"""

import subprocess
import sys
from pathlib import Path

import gymnasium
import numpy as np
import pytest

from ray_tpu.rllib import connectors as jcon
from ray_tpu.rllib import filters as jfil
from ray_tpu.rllib import replay_buffer as jrb
from ray_tpu.rllib import sample_batch as jsb
from ray_tpu.rllib import vector_env as jve
from ray_tpu_torch.rllib import connectors as tcon
from ray_tpu_torch.rllib import filters as tfil
from ray_tpu_torch.rllib import replay_buffer as trb
from ray_tpu_torch.rllib import sample_batch as tsb
from ray_tpu_torch.rllib import vector_env as tve

ROOT = Path(__file__).resolve().parents[1]


def _equal(got, want):
    """Equal trees of arrays, scalars, dicts, lists and tuples."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), (got, want)
        for k in want:
            _equal(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _equal(g, w)
    else:
        g, w = np.asarray(got), np.asarray(want)
        assert g.dtype == w.dtype and g.shape == w.shape, (g, w)
        np.testing.assert_array_equal(g, w)


def _rows(rng, n):
    return {"obs": rng.randn(n, 3).astype(np.float32),
            "actions": rng.randint(0, 4, n),
            "rewards": rng.randn(n).astype(np.float32)}


def test_sample_batch_and_gae_equal_jax():
    rng = np.random.RandomState(0)
    parts = [_rows(rng, n) for n in (5, 3, 4)]
    tb = tsb.SampleBatch.concat_samples([tsb.SampleBatch(p) for p in parts])
    jb = jsb.SampleBatch.concat_samples([jsb.SampleBatch(p) for p in parts])
    assert tb.count == jb.count == 12 and len(tb) == 12
    _equal(dict(tb), dict(jb))
    _equal(dict(tb.slice(2, 7)), dict(jb.slice(2, 7)))
    _equal(dict(tb.shuffle(np.random.RandomState(3))),
           dict(jb.shuffle(np.random.RandomState(3))))
    _equal([dict(m) for m in tb.minibatches(5)],
           [dict(m) for m in jb.minibatches(5)])
    assert repr(tb) == repr(jb)
    assert tsb.SampleBatch.concat_samples([]).count == 0
    dev = tb.to_device("cpu")
    _equal({k: v.numpy() for k, v in dev.items()}, dict(jb))
    for gamma, lam in ((0.99, 0.95), (1.0, 1.0), (0.9, 0.0)):
        r = rng.randn(20).astype(np.float32)
        v = rng.randn(20).astype(np.float32)
        d = rng.rand(20) < 0.2
        _equal(tsb.compute_gae(r, v, d, 0.7, gamma=gamma, lam=lam),
               jsb.compute_gae(r, v, d, 0.7, gamma=gamma, lam=lam))


def test_filters_and_their_merge_equal_jax():
    rng = np.random.RandomState(1)
    states = {}
    for pkg, fil in (("t", tfil), ("j", jfil)):
        f, g = fil.MeanStdFilter((3,)), fil.MeanStdFilter((3,))
        outs = [f(rng_b) for rng_b in
                [np.random.RandomState(s).randn(6, 3) * 4 + 1
                 for s in range(3)]]
        outs.append(f(np.ones(3), update=False))
        outs.append(g(np.random.RandomState(9).randn(3)))
        merged = fil.merge_filter_states(
            [f.get_state(), g.get_state(), {"type": "NoFilter"}])
        h = fil.make_filter("MeanStdFilter", (3,))
        h.set_state(merged)
        outs.append(h(np.full((2, 3), 0.5), update=False))
        states[pkg] = (outs, merged, fil.make_filter("NoFilter", (3,))(
            np.arange(3.0)), fil.merge_filter_states([{"type": "NoFilter"}]))
    _equal(states["t"], states["j"])
    with pytest.raises(ValueError, match="unknown observation_filter"):
        tfil.make_filter("Bogus", (3,))


def test_connectors_equal_jax():
    rng = np.random.RandomState(2)
    obs = rng.rand(4, 5, 5, 2) * 3
    acts = rng.randn(4, 6) * 2
    got, want = [], []
    for con, ve, out in ((tcon, tve, got), (jcon, jve, want)):
        for preserve in (False, True):
            pipe = con.default_obs_pipeline((5, 5, 2), "MeanStdFilter",
                                            preserve_shape=preserve)
            out.append(pipe(obs))
            out.append(pipe(obs * 0.5, update=False))
            flt = pipe.find(con.ObsFilter)
            out.append(flt.pop_delta())
            out.append(pipe.get_state())
        out.append(con.default_obs_pipeline((5,), "NoFilter")(obs[:, 0, 0]))
        # the Box action adapter: clip to the space, reshape rows
        space = (tve.Box(-1.0, 0.5, (6,), np.float32) if ve is tve
                 else gymnasium.spaces.Box(-1.0, 0.5, (6,), np.float32))
        out.append(con.default_action_pipeline(space, True)(acts))
        out.append(con.default_action_pipeline(space, False)(acts))
    _equal(got, want)


def test_replay_buffers_equal_jax():
    got, want = [], []
    for rb, sb, out in ((trb, tsb, got), (jrb, jsb, want)):
        rng = np.random.RandomState(3)
        plain = rb.ReplayBuffer(10, seed=1)
        prio = rb.PrioritizedReplayBuffer(10, alpha=0.7, beta=0.5, seed=2)
        for n in (4, 5, 6):
            batch = sb.SampleBatch(_rows(rng, n))
            out.append(plain.add(batch))
            out.append(prio.add(batch))
        out.append(len(plain))
        out.append(dict(plain.sample(7)))
        batch, idx, w = prio.sample(8)
        out.extend([dict(batch), idx, w])
        prio.update_priorities(idx, rng.randn(8))
        batch, idx, w = prio.sample(8)
        out.extend([dict(batch), idx, w, prio._max_priority])
    _equal(got, want)


@pytest.mark.parametrize("env,config", [
    ("CartPole-v1", None), ("MinAtarBreakout", {"size": 8}),
    ("MinAtarBreakout", None), ("RepeatPrev", {"n_symbols": 4})])
def test_vector_envs_equal_jax_under_seeded_actions(env, config):
    tenv = tve.make_vector_env(env, config, 6, seed=4)
    jenv = jve.make_vector_env(env, config, 6, seed=4)
    for attr in ("shape", "dtype", "low", "high"):
        _equal(getattr(tenv.observation_space, attr),
               getattr(jenv.observation_space, attr))
    assert int(tenv.action_space.n) == int(jenv.action_space.n)
    assert not hasattr(tenv.observation_space, "n")
    _equal(tenv.vector_reset(seed=5), jenv.vector_reset(seed=5))
    rng = np.random.RandomState(6)
    for _ in range(700):            # past the 500-step truncations
        a = rng.randint(0, int(jenv.action_space.n), 6)
        _equal(tenv.vector_step(a), jenv.vector_step(a))


NO_GYM = r"""
import sys
sys.modules["gymnasium"] = None
import numpy as np
from ray_tpu_torch.rllib.rollout_worker import _make_env
from ray_tpu_torch.rllib.vector_env import make_vector_env

for env, cfg in (("CartPole-v1", None), ("MinAtarBreakout", {"size": 8}),
                 ("RepeatPrev", None)):
    venv = make_vector_env(env, cfg, 3, seed=0)
    venv.vector_reset(seed=0)
    out = venv.vector_step(np.zeros(3, np.int64))
    single = _make_env(env, cfg)
    obs, _ = single.reset(seed=1)
    step = single.step(0)
    print("ENV_OK", env, out[0].shape, obs.shape, step[1])
for call in (lambda: make_vector_env("Pendulum-v1", None, 2),
             lambda: _make_env("Pendulum-v1", None)):
    try:
        call()
    except ImportError as e:
        print("IMPORT_ERROR", e)
"""


def test_in_repo_envs_run_with_gymnasium_blocked():
    r = subprocess.run([sys.executable, "-c", NO_GYM], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
    lines = r.stdout.splitlines()
    assert sum(ln.startswith("ENV_OK") for ln in lines) == 3, r.stdout
    assert sum(ln.startswith("IMPORT_ERROR") for ln in lines) == 2, \
        r.stdout


def test_trajectory_and_async_workers_emit_the_jax_columns():
    """TrajectoryWorker's raw time-major fragments and an AsyncSampler
    worker's batches carry the JAX package's columns, shapes and
    dtypes (the draws differ: the policies sample with their own
    generators)."""
    from ray_tpu.rllib import policy as jpolicy
    from ray_tpu.rllib import rollout_worker as jrw
    from ray_tpu_torch.rllib import policy as tpolicy
    from ray_tpu_torch.rllib import rollout_worker as trw

    kw = dict(env="CartPole-v1", num_envs=3, rollout_fragment_length=8,
              seed=0)
    spec = dict(obs_dim=4, n_actions=2, hidden=(8,))

    def layout(tree):
        return {k: (np.shape(v), np.asarray(v).dtype)
                for k, v in tree.items()}

    tw = trw.TrajectoryWorker(policy_spec=tpolicy.PolicySpec(**spec), **kw)
    jw = jrw.TrajectoryWorker(policy_spec=jpolicy.PolicySpec(**spec), **kw)
    assert layout(tw.sample_trajectory()) == layout(jw.sample_trajectory())
    tw = trw.RolloutWorker(policy_spec=tpolicy.PolicySpec(**spec),
                           async_sampling=True, **kw)
    try:
        got = [tw.sample() for _ in range(3)]
    finally:
        tw._async_sampler.stop()
    want = jrw.RolloutWorker(policy_spec=jpolicy.PolicySpec(**spec),
                             **kw).sample()
    assert all(layout(g) == layout(want) for g in got)
    with pytest.raises(ValueError, match="does not apply observation"):
        trw.TrajectoryWorker(policy_spec=tpolicy.PolicySpec(**spec),
                             observation_filter="MeanStdFilter", **kw)
