"""The port's attention dispatcher and references against the JAX
package's, on numpy-made inputs, in f32 on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops import attention as jatt
from ray_tpu_torch.ops import attention as tatt

# the same f32 softmax attention in both packages; only the matmul
# summation order differs
TOL = 1e-5


def _qkv(seed, B=2, T=48, H=2, D=32):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, T, H, D)).astype(np.float32)
            for _ in range(3)]


def _both(arrs):
    return ([jnp.asarray(a) for a in arrs],
            [torch.from_numpy(a) for a in arrs])


@pytest.mark.parametrize("causal", [True, False])
def test_reference_attention_matches_jax(causal):
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(0))
    want = jatt.reference_attention(jq, jk, jv, causal=causal)
    got = tatt.reference_attention(tq, tk, tv, causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


def test_prefill_attention_equal_length_matches_jax():
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(1))
    want = jatt.prefill_attention(jq, jk, jv, use_flash=False)
    got = tatt.prefill_attention(tq, tk, tv, use_flash=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


def test_prefill_attention_ragged_start_matches_jax():
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(2, B=3))
    start = np.array([0, 5, 40], np.int32)
    want = jatt.prefill_attention(jq, jk, jv, start=jnp.asarray(start))
    got = tatt.prefill_attention(tq, tk, tv,
                                 start=torch.from_numpy(start))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


def test_causal_attention_flash_path_matches_jax_reference():
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(3))
    want = jatt.causal_attention(jq, jk, jv, use_flash=False)
    got = tatt.causal_attention(tq, tk, tv, use_flash=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


def test_flash_auto_dispatch_off_for_cpu_tensors():
    assert not tatt.flash_auto_dispatch(1024, 64, "cpu")
    assert not tatt.flash_auto_dispatch(512, 64, torch.device("cpu"))
    # auto on the CPU is exactly the reference path
    _, (tq, tk, tv) = _both(_qkv(4))
    torch.testing.assert_close(
        tatt.causal_attention(tq, tk, tv),
        tatt.reference_attention(tq, tk, tv, causal=True), rtol=0, atol=0)


def test_flash_auto_dispatch_on_cuda_follows_head_dim():
    # a device object is all the rule reads; no card is needed
    cuda = torch.device("cuda")
    assert tatt.flash_auto_dispatch(512, 64, cuda)
    assert tatt.flash_auto_dispatch(1000, 128, cuda)
    assert not tatt.flash_auto_dispatch(512, 80, cuda)
