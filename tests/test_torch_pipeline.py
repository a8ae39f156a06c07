"""The port's ``pipeline_apply`` (``ray_tpu_torch/ops/pipeline.py``)
against the JAX package's, the cases of tests/test_pipeline.py.

The JAX side runs here on the fake CPU devices (tests/conftest.py) on
a pipeline=pp x data mesh; the port's on 4 gloo ranks (tests/
_torch_seq_ranks.py ``prog_pipeline``, one launch for every case), a
pipeline=pp x data=4/pp mesh.  Same seeded numpy stage parameters and
inputs, f32.

Gradient convention: every rank differentiates the same loss of the
broadcast output divided by S (the mesh train step's loss / world), so
the sum of the ranks' gradients of the stacked parameters (each rank's
is its own stage's row) is JAX's gradient of the loss.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from ray_tpu.ops.pipeline import pipeline_apply, stack_stage_params
from ray_tpu.parallel import MeshSpec, make_mesh
from tests import _torch_mesh_ranks as ranks

# tests/test_pipeline.py's tolerances
TOL = 2e-5
GRAD_TOL = 5e-5
N = 4
CASES = [(2, 4), (4, 2), (4, 8)]
# the (4, 2) case again, its stacked params as DTensors split over
# the pipeline axis
DTENSOR_CASE = (4, 2)
TRAIN_STEPS, TRAIN_LR = 30, 1e-2


def _stage_init(key):
    k1, k2 = jax.random.split(key)
    return {"w": jax.random.normal(k1, (16, 16)) * 0.3,
            "b": jax.random.normal(k2, (16,)) * 0.1}


def _stage_fn(p, x):
    return jnp.tanh(x @ p["w"] + p["b"])


def _params(pp):
    return stack_stage_params(_stage_init, jax.random.PRNGKey(0), pp)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _x(rows, seed=1):
    return np.asarray(jax.random.normal(jax.random.PRNGKey(seed),
                                        (rows, 16)))


def _mesh(pp):
    return make_mesh(MeshSpec(pipeline=pp, data=-1),
                     devices=jax.devices()[:8])


def _jax_apply(pp, mb, params, x):
    mesh = _mesh(pp)
    with jax.set_mesh(mesh):
        return np.asarray(jax.jit(lambda p, x: pipeline_apply(
            _stage_fn, p, x, microbatches=mb, mesh=mesh))(params, x))


@pytest.fixture(scope="module")
def port():
    cases = [(pp, mb, _np(_params(pp)), _x(16), False) for pp, mb in CASES]
    pp, mb = DTENSOR_CASE
    cases.append((pp, mb, _np(_params(pp)), _x(16), True))
    grad_case = (4, 4, _np(_params(4)), _x(8),
                 np.asarray(jax.random.normal(jax.random.PRNGKey(2),
                                              (8, 16))))
    train_case = (2, 4, _np(_params(2)), _x(32), TRAIN_STEPS, TRAIN_LR)
    return ranks.launch("tests._torch_seq_ranks:prog_pipeline", N, cases,
                        grad_case, train_case)


@pytest.mark.parametrize("i", range(len(CASES) + 1),
                         ids=[f"pp{pp}-mb{mb}" for pp, mb in CASES]
                         + ["pp4-mb2-dtensor"])
def test_pipeline_equals_jax(port, i):
    pp, mb = (CASES + [DTENSOR_CASE])[i]
    want = _jax_apply(pp, mb, _params(pp), jnp.asarray(_x(16)))
    for r in range(N):          # every pipeline rank holds the output
        np.testing.assert_allclose(port[r]["outs"][i], want, rtol=TOL,
                                   atol=TOL)


def test_pipeline_gradient_equals_jax(port):
    pp, mb = 4, 4
    mesh = _mesh(pp)
    params = _params(pp)
    x = jnp.asarray(_x(8))
    tgt = jax.random.normal(jax.random.PRNGKey(2), (8, 16))

    def loss_pp(p):
        return jnp.mean((pipeline_apply(_stage_fn, p, x, microbatches=mb,
                                        mesh=mesh) - tgt) ** 2)

    with jax.set_mesh(mesh):
        want = jax.jit(jax.grad(loss_pp))(params)
    for name in ("w", "b"):
        got = sum(port[r]["grads"][name] for r in range(N))
        np.testing.assert_allclose(got, np.asarray(want[name]),
                                   rtol=GRAD_TOL, atol=GRAD_TOL,
                                   err_msg=name)
        # each rank's gradient is its own stage's row
        for r in range(N):
            others = np.delete(port[r]["grads"][name], r, axis=0)
            assert not others.any()


def test_pipeline_trains_as_jax(port):
    """A 2-stage pipelined MLP fits the toy regression of tests/
    test_pipeline.py (loss halves); its first loss is JAX's and its
    last within Adam's drift of JAX's."""
    pp, mb = 2, 4
    mesh = _mesh(pp)
    x = jnp.asarray(_x(32))
    tgt = jnp.sin(x)
    tx = optax.adam(TRAIN_LR)
    params = _params(pp)
    opt = tx.init(params)

    @jax.jit
    def step(p, o):
        def loss(p):
            y = pipeline_apply(_stage_fn, p, x, microbatches=mb, mesh=mesh)
            return jnp.mean((y - tgt) ** 2)

        val, g = jax.value_and_grad(loss)(p)
        up, o = tx.update(g, o)
        return optax.apply_updates(p, up), o, val

    want = []
    with jax.set_mesh(mesh):
        for _ in range(TRAIN_STEPS):
            params, opt, val = step(params, opt)
            want.append(float(val))
    got = port[0]["losses"]
    assert got[-1] < got[0] * 0.5, got[::10]
    for r in range(1, N):
        assert port[r]["losses"] == got
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6)
    np.testing.assert_allclose(got, want, rtol=1e-3)
