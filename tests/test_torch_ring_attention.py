"""The port's ring and Ulysses attention (``ray_tpu_torch/ops/
ring_attention.py``) against the JAX package's.

The JAX side runs here under ``shard_map`` on a 4-device seq=4 mesh of
the fake CPU devices (tests/conftest.py), as tests/test_ring_attention
.py runs it; the port's runs on 4 gloo ranks (tests/_torch_seq_ranks.py
``prog_ring``, one launch for every case), each rank on its own
sequence shard.  Same seeded numpy inputs, f32.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from ray_tpu.ops.attention import reference_attention
from ray_tpu.ops.ring_attention import ring_attention, ulysses_attention
from ray_tpu.parallel import MeshSpec, fake_mesh
from tests import _torch_mesh_ranks as ranks

TOL = 2e-5
# the ring's gradients (tests/test_ring_attention.py:58-60)
GRAD_TOL = 1e-4
N = 4


def _qkv(seed, B, T, H, D):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, T, H, D)).astype(np.float32)
            for _ in range(3)]


#: (mode, causal, mesh, grad, shape (B, T, H, D), seed)
CASES = [
    ("ring", True, "seq", True, (2, 32, 2, 8), 1),
    ("ring", False, "seq", True, (2, 32, 2, 8), 2),
    ("ulysses", True, "seq", False, (2, 64, 4, 16), 3),
    ("ulysses", False, "seq", False, (2, 64, 4, 16), 4),
    # a seq axis of size 1 (data=4): both are plain attention
    ("ring", True, "data", False, (2, 16, 2, 8), 5),
    ("ulysses", True, "data", False, (2, 16, 2, 8), 6),
    # heads (2) not divisible by the seq axis (4)
    ("ulysses", True, "seq", False, (2, 16, 2, 8), 7),
]
IDS = [f"{m}-{'causal' if c else 'full'}-{mesh}{'-grad' if g else ''}"
       for m, c, mesh, g, _, _ in CASES]


@pytest.fixture(scope="module")
def port():
    cases = [dict(zip("qkv", _qkv(seed, *shape)), mode=mode, causal=causal,
                  mesh=mesh, grad=grad)
             for mode, causal, mesh, grad, shape, seed in CASES]
    return ranks.launch("tests._torch_seq_ranks:prog_ring", N, cases)


def _jax_sharded(fn, causal):
    mesh = fake_mesh(N, MeshSpec(seq=N))
    spec = P(None, "seq", None, None)
    return jax.shard_map(functools.partial(fn, causal=causal), mesh=mesh,
                         in_specs=(spec, spec, spec), out_specs=spec)


def _port_whole(port, i, key):
    """The ranks' shards of output ``key`` of case i, concatenated
    along the sequence (a data-mesh case: rank 0's whole output)."""
    if CASES[i][2] == "data":
        return port[0][i][key]
    return np.concatenate([port[r][i][key] for r in range(N)], axis=1)


@pytest.mark.parametrize("i", range(4), ids=IDS[:4])
def test_outputs_equal_jax_shard_map(port, i):
    mode, causal, _, _, shape, seed = CASES[i]
    q, k, v = map(jnp.asarray, _qkv(seed, *shape))
    fn = ulysses_attention if mode == "ulysses" else ring_attention
    want = np.asarray(jax.jit(_jax_sharded(fn, causal))(q, k, v))
    np.testing.assert_allclose(_port_whole(port, i, "out"), want,
                               atol=TOL, rtol=TOL)


@pytest.mark.parametrize("i", range(2), ids=IDS[:2])
def test_ring_gradients_equal_jax(port, i):
    _, causal, _, _, shape, seed = CASES[i]
    q, k, v = map(jnp.asarray, _qkv(seed, *shape))
    ring = _jax_sharded(ring_attention, causal)
    want = jax.jit(jax.grad(lambda q, k, v: jnp.sum(jnp.sin(ring(q, k, v))),
                            argnums=(0, 1, 2)))(q, k, v)
    for name, w in zip(("dq", "dk", "dv"), want):
        np.testing.assert_allclose(_port_whole(port, i, name),
                                   np.asarray(w), atol=GRAD_TOL,
                                   rtol=GRAD_TOL, err_msg=name)


@pytest.mark.parametrize("i", [4, 5], ids=IDS[4:6])
def test_seq_axis_of_one_is_plain_attention(port, i):
    """With the seq axis at 1 (a data=4 mesh) each rank holds the whole
    sequence: both are JAX's reference attention, on every rank."""
    _, causal, _, _, shape, seed = CASES[i]
    q, k, v = map(jnp.asarray, _qkv(seed, *shape))
    want = np.asarray(reference_attention(q, k, v, causal=causal))
    for r in range(N):
        np.testing.assert_allclose(port[r][i]["out"], want, atol=TOL,
                                   rtol=TOL)


def test_ulysses_heads_not_divisible_raises_as_jax(port):
    _, causal, _, _, shape, seed = CASES[6]
    q, k, v = map(jnp.asarray, _qkv(seed, *shape))
    with pytest.raises(ValueError) as jerr:
        jax.jit(_jax_sharded(ulysses_attention, causal))(q, k, v)
    for r in range(N):
        assert port[r][6] == {"error": str(jerr.value)}
