"""GPT-2 under sequence parallelism (``seq_parallel=True``, ring and
Ulysses) against the JAX package's, as tests/test_gpt2_seq_parallel.py
holds JAX's to the plain model.

The JAX side runs here: ``gpt2_loss`` and ``jax.grad`` of GPT-2 nano
(f32, no flash, remat) with its parameters sharded on a 4-device mesh
of the fake CPU devices.  The port's runs on 4 gloo ranks (tests/
_torch_seq_ranks.py ``prog_seq_gpt2``, one launch for every case): the
mesh train step's ``value_and_grad`` on a mesh of the same shape, each
rank with its rows of the batch and its slice of the sequence, its
local loss divided by the world size and the gradients summed over the
ranks.  That is JAX's global mean loss and its gradient: the loss is
the mean of the ranks' losses.  The two mesh shapes split JAX's fsdp=2
x seq=2 x tensor=2 over 4 ranks: fsdp=2 x seq=2 and seq=2 x tensor=2.

On seq=2 x tensor=2 JAX's Ulysses raises: GSPMD splits nano's two
heads over tensor first, leaving one head a device, which the seq axis
cannot scatter.  The port's step gathers the weights before the loss,
so each rank holds both heads and Ulysses runs; that case is held to
JAX's ring on the same mesh (the same function).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ray_tpu.models import (gpt2_config, gpt2_init, gpt2_logical_axes,
                            gpt2_loss)
from ray_tpu.parallel import MeshSpec, fake_mesh
from ray_tpu.parallel.sharding import shard_params
from tests import _torch_mesh_ranks as ranks

LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
N = 4
MESHES = {"fsdp2-seq2": dict(fsdp=2, seq=2),
          "seq2-tensor2": dict(seq=2, tensor=2)}
CASES = [(mesh, mode) for mesh in MESHES for mode in ("ring", "ulysses")]
IDS = [f"{mesh}-{mode}" for mesh, mode in CASES]


def _cfg(**kw):
    return gpt2_config("nano", use_flash=False, remat=True,
                       dtype=jnp.float32, **kw)


@pytest.fixture(scope="module")
def setup():
    params = gpt2_init(jax.random.PRNGKey(0), _cfg())
    tokens = np.asarray(jax.random.randint(
        jax.random.PRNGKey(1), (4, 33), 0, _cfg().vocab_size), np.int32)
    np_params = jax.tree_util.tree_map(np.asarray, params)
    port = ranks.launch("tests._torch_seq_ranks:prog_seq_gpt2", N,
                        np_params, tokens,
                        [(MESHES[m], mode) for m, mode in CASES])
    return params, tokens, port


def _jax(params, tokens, mesh_name, mode):
    if mode == "ulysses" and MESHES[mesh_name].get("tensor", 1) > 1:
        with pytest.raises(ValueError, match="ulysses needs heads"):
            _jax_value_and_grad(params, tokens, mesh_name, "ulysses")
        mode = "ring"
    return _jax_value_and_grad(params, tokens, mesh_name, mode)


def _jax_value_and_grad(params, tokens, mesh_name, mode):
    sp = _cfg(seq_parallel=True, sp_mode=mode)
    mesh = fake_mesh(N, MeshSpec(**MESHES[mesh_name]))
    batch = {"tokens": jnp.asarray(tokens)}
    with jax.set_mesh(mesh):
        sharded = shard_params(params, gpt2_logical_axes(sp), mesh)
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p: gpt2_loss(p, batch, sp)))(sharded)
    return float(loss), [np.asarray(g) for g in
                         jax.tree_util.tree_leaves(grads)]


@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
def test_seq_parallel_loss_and_grads_equal_jax(setup, i):
    params, tokens, port = setup
    want_loss, want_grads = _jax(params, tokens, *CASES[i])
    for r in range(N):          # every rank returns the mean loss
        assert abs(port[r][i]["loss"] - want_loss) \
            <= LOSS_RTOL * abs(want_loss)
    got = port[0][i]["grads"]
    assert len(got) == len(want_grads)
    names = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_leaves_with_path(params)]
    for name, g, w in zip(names, got, want_grads):
        np.testing.assert_allclose(g, w, rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=name)
