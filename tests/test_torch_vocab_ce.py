"""The port's streaming cross-entropy (ray_tpu_torch/ops/vocab_ce.py)
against the JAX package's (ray_tpu/ops/vocab_ce.py), on the same numpy
inputs, at the JAX package's tolerances (tests/test_vocab_ce.py):
forward at 1e-5, gradients at rtol 1e-4, atol 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops.vocab_ce import streaming_ce as j_streaming_ce
from ray_tpu_torch.ops.vocab_ce import streaming_ce


def _inputs(seed, n, d, v, valid):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, d).astype(np.float32),
            rng.randn(v, d).astype(np.float32),
            rng.randint(0, valid, n).astype(np.int32))


@pytest.mark.parametrize("n,d,v,valid,tile", [
    (16, 32, 128, 100, 64),    # padded tail masked
    (8, 16, 96, 96, 32),       # exact tiling, no padding
    (4, 8, 50, 50, 64),        # tile > vocab: internal pad rows
])
def test_forward_matches_jax(n, d, v, valid, tile):
    h, w, t = _inputs(0, n, d, v, valid)
    want = j_streaming_ce(jnp.asarray(h), jnp.asarray(w), jnp.asarray(t),
                          valid, tile, jnp.float32)
    got = streaming_ce(torch.from_numpy(h), torch.from_numpy(w),
                       torch.from_numpy(t), valid, tile, torch.float32)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("n,d,v,valid,tile", [
    (12, 24, 160, 150, 64),    # the case of tests/test_vocab_ce.py:39
    (33, 24, 130, 123, 64),    # n and v not divisible by the tile
])
def test_gradients_match_jax(n, d, v, valid, tile):
    h, w, t = _inputs(1, n, d, v, valid)
    gh_j, gw_j = jax.grad(
        lambda a, b: jnp.mean(j_streaming_ce(a, b, jnp.asarray(t), valid,
                                             tile, jnp.float32)),
        argnums=(0, 1))(jnp.asarray(h), jnp.asarray(w))
    ht = torch.from_numpy(h).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    streaming_ce(ht, wt, torch.from_numpy(t), valid, tile,
                 torch.float32).mean().backward()
    np.testing.assert_allclose(ht.grad.numpy(), np.asarray(gh_j),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(gw_j),
                               rtol=1e-4, atol=1e-5)
    # padded-vocab rows get zero gradient
    assert np.abs(wt.grad.numpy()[valid:]).max() < 1e-6


def test_bf16_compute_matches_jax_bf16():
    """bf16 operands with f32 logits; dlogits rounded to bf16 before both
    products in both packages, so they agree to summation order."""
    n, d, v, valid, tile = 32, 64, 200, 180, 64
    h, w, t = _inputs(2, n, d, v, valid)
    loss_j = jax.value_and_grad(
        lambda a, b: jnp.mean(j_streaming_ce(a, b, jnp.asarray(t), valid,
                                             tile, jnp.bfloat16)),
        argnums=(0, 1))
    lj, (gh_j, gw_j) = loss_j(jnp.asarray(h), jnp.asarray(w))
    ht = torch.from_numpy(h).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    loss = streaming_ce(ht, wt, torch.from_numpy(t), valid, tile,
                        torch.bfloat16).mean()
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(lj), rtol=1e-4,
                               atol=1e-4)
    for got, want in ((ht.grad, gh_j), (wt.grad, gw_j)):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-4)
