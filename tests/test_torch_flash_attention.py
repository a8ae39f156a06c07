"""The port's flash attention, forward and backward, against the JAX
package's.

Inputs come from numpy and go to both packages.  On the CPU the port's
wrapper runs its plain version; the JAX kernel runs in Pallas interpret
mode, as the JAX package's own tests run it.  The CUDA kernels
themselves are held against the plain versions by
tests/test_torch_flash_kernel.py and tests/test_torch_flash_bwd_kernel.py
(marked ``cuda``, skipped without a card) and by chip_smoke.py.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# the packages' ops/__init__ export a function of the same name, so the
# modules are looked up by path
jfa = importlib.import_module("ray_tpu.ops.flash_attention")
tfa = importlib.import_module("ray_tpu_torch.ops.flash_attention")

# f32 forward tolerance of the JAX package's own flash tests
# (tests/test_flash_attention.py): same math, different summation order
F32_TOL = 2e-5
# bf16 keeps 8 mantissa bits; the two packages round P and O at
# different places
BF16_TOL = 5e-2


def _qkv(seed, B, T, H, D):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, T, H, D)).astype(np.float32)
            for _ in range(3)]


@pytest.mark.parametrize("causal,T,block", [
    (True, 128, 32), (False, 128, 32), (True, 96, 64), (False, 96, 64)])
def test_flash_forward_matches_jax(causal, T, block):
    q, k, v = _qkv(0, 2, T, 2, 64)
    want = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), causal=causal,
                               block_q=block, block_k=block,
                               interpret=True)
    got = tfa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=causal,
                              block_q=block, block_k=block)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=F32_TOL, rtol=F32_TOL)


@pytest.mark.parametrize("resident", [True, False])
def test_flash_resident_variants_match_jax(resident):
    q, k, v = _qkv(1, 1, 256, 2, 64)
    want = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), causal=True,
                               resident_kv=resident, interpret=True)
    got = tfa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=True,
                              resident_kv=resident)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=F32_TOL, rtol=F32_TOL)


@pytest.mark.parametrize("causal,T", [(True, 128), (False, 128),
                                      (True, 96)])
def test_flash_fwd_lse_matches_jax(causal, T):
    q, k, v = (x.reshape(2, T, 32) for x in _qkv(2, 2, T, 1, 32))
    scale = 1.0 / np.sqrt(32)
    o_j, lse_j = jfa._fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          scale=scale, block_q=32, block_k=32,
                          causal=causal, interpret=True)
    o_t, lse_t = tfa.flash_attention_fwd(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        scale=scale, causal=causal)
    assert lse_t.shape == (2, 1, T) and lse_t.dtype == torch.float32
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j),
                               atol=F32_TOL, rtol=F32_TOL)
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j),
                               atol=F32_TOL, rtol=F32_TOL)


def test_flash_forward_bf16_matches_jax():
    q, k, v = _qkv(3, 1, 128, 2, 64)
    want = jfa.flash_attention(
        *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)), causal=True,
        block_q=64, block_k=64, interpret=True)
    got = tfa.flash_attention(
        *(torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)),
        causal=True, block_q=64, block_k=64)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=BF16_TOL, rtol=BF16_TOL)


# gradient tolerance of the JAX package's own flash tests
# (tests/test_flash_attention.py): same math, summed in another order
GRAD_TOL = 1e-4


def _grads_jax(q, k, v, do, **kw):
    _, vjp = jax.vjp(lambda a, b, c: jfa.flash_attention(
        a, b, c, interpret=True, **kw), *(jnp.asarray(x) for x in (q, k, v)))
    return [np.asarray(g) for g in vjp(jnp.asarray(do))]


def _grads_port(q, k, v, do, **kw):
    qkv = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    o = tfa.flash_attention(*qkv, **kw)
    return [g.numpy() for g in torch.autograd.grad(o, qkv,
                                                   torch.from_numpy(do))]


def test_flash_requires_grad_raises():
    """Inputs that require grad no longer raise: they take the flash
    backward, whose gradients match jax.vjp of the JAX kernel; with
    grad disabled the forward runs as before."""
    q, k, v = _qkv(4, 1, 32, 1, 32)
    do = _qkv(40, 1, 32, 1, 32)[0]
    for got, want, name in zip(_grads_port(q, k, v, do),
                               _grads_jax(q, k, v, do), "qkv"):
        np.testing.assert_allclose(got, want, atol=GRAD_TOL, rtol=GRAD_TOL,
                                   err_msg=f"d{name}")
    qt = torch.from_numpy(q).requires_grad_(True)
    with torch.no_grad():
        out = tfa.flash_attention(qt, torch.from_numpy(k),
                                  torch.from_numpy(v))
    assert out.shape == qt.shape and not out.requires_grad


@pytest.mark.parametrize("B,T,H,D,kw", [
    (1, 64, 2, 32, dict(causal=True, block_q=32, block_k=32)),
    (1, 64, 2, 32, dict(causal=False, block_q=32, block_k=32)),
    (1, 96, 1, 64, dict(causal=True, block_q=64, block_k=64)),
    (1, 256, 2, 32, dict(causal=True, resident_kv=True)),
    (1, 256, 2, 32, dict(causal=True, resident_kv=False)),
    # bq=256/chunk=512: several loop trips with a qi-dependent bound
    (1, 1024, 1, 32, dict(causal=True, resident_kv=True)),
], ids=["causal-T64", "noncausal-T64", "uneven-T96", "resident-T256",
        "classic-T256", "resident-multichunk-T1024"])
def test_flash_gradients_match_jax(B, T, H, D, kw):
    q, k, v = _qkv(7, B, T, H, D)
    do = _qkv(8, B, T, H, D)[0]
    for got, want, name in zip(_grads_port(q, k, v, do, **kw),
                               _grads_jax(q, k, v, do, **kw), "qkv"):
        np.testing.assert_allclose(got, want, atol=GRAD_TOL, rtol=GRAD_TOL,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("causal,T", [(True, 128), (False, 128),
                                      (True, 96)])
def test_flash_bwd_function_matches_jax_bwd(causal, T):
    """(BH, T, D) level: the port's flash_attention_bwd (and its plain
    version) against the JAX package's _bwd on the same residuals."""
    q, k, v, do = (x.reshape(2, T, 32) for x in _qkv(9, 2, T, 1, 32)
                   + [_qkv(10, 2, T, 1, 32)[0]])
    scale = 1.0 / np.sqrt(32)
    o_j, lse_j = jfa._fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          scale=scale, block_q=32, block_k=32,
                          causal=causal, interpret=True)
    want = jfa._bwd((jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), o_j,
                     lse_j), jnp.asarray(do), scale=scale, block_q=32,
                    block_k=32, causal=causal, interpret=True)
    args = [torch.from_numpy(np.array(x)) for x in
            (q, k, v, o_j, lse_j, do)]
    for fn in (tfa.flash_attention_bwd, tfa.flash_attention_bwd_reference):
        got = fn(*args, scale=scale, causal=causal)
        for g, w, name in zip(got, want, "qkv"):
            np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                       atol=GRAD_TOL, rtol=GRAD_TOL,
                                       err_msg=f"{fn.__name__} d{name}")


@pytest.mark.parametrize("causal,T", [(True, 128), (False, 128),
                                      (True, 96)])
def test_flash_bwd_dq_cpu_gives_plain_dq_and_delta_matching_jax(causal, T):
    """flash_bwd_dq on CPU tensors returns (dq, delta): exactly the plain
    dq and flash_bwd_delta's delta, and both agree with the JAX
    package's _bwd (its dq, in interpret mode, and the delta it computes
    before its kernels, flash_attention.py:235) on the same residuals."""
    q, k, v, do = (x.reshape(2, T, 32) for x in _qkv(12, 2, T, 1, 32)
                   + [_qkv(13, 2, T, 1, 32)[0]])
    scale = 1.0 / np.sqrt(32)
    o_j, lse_j = jfa._fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          scale=scale, block_q=32, block_k=32,
                          causal=causal, interpret=True)
    dq_j, _, _ = jfa._bwd((jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           o_j, lse_j), jnp.asarray(do), scale=scale,
                          block_q=32, block_k=32, causal=causal,
                          interpret=True)
    delta_j = jnp.sum(jnp.asarray(do).astype(jnp.float32)
                      * o_j.astype(jnp.float32), axis=-1)[:, None, :]
    q3, k3, v3, o3, lse, do3 = (torch.from_numpy(np.array(x)) for x in
                                (q, k, v, o_j, lse_j, do))
    before = tfa.FLASH_BWD_DQ_LAUNCHES
    dq, delta = tfa.flash_bwd_dq(q3, k3, v3, o3, do3, lse, scale=scale,
                                 causal=causal)
    assert tfa.FLASH_BWD_DQ_LAUNCHES == before
    assert delta.shape == (2, 1, T) and delta.dtype == torch.float32
    dq_ref, delta_ref = tfa.flash_bwd_dq_reference(
        q3, k3, v3, o3, do3, lse, scale=scale, causal=causal)
    assert torch.equal(dq, dq_ref)
    assert torch.equal(delta, delta_ref)
    assert torch.equal(delta, tfa.flash_bwd_delta(o3, do3))
    np.testing.assert_allclose(dq.numpy(), np.asarray(dq_j), atol=GRAD_TOL,
                               rtol=GRAD_TOL, err_msg="dq")
    # both sum the same 32 f32 products, in other orders
    np.testing.assert_allclose(delta.numpy(), np.asarray(delta_j),
                               atol=F32_TOL, rtol=F32_TOL, err_msg="delta")


def test_flash_cpu_backward_launches_no_kernel():
    q, k, v = (torch.from_numpy(x).requires_grad_(True)
               for x in _qkv(11, 1, 64, 2, 32))
    before = (tfa.FLASH_BWD_DQ_LAUNCHES, tfa.FLASH_BWD_DKV_LAUNCHES)
    tfa.flash_attention(q, k, v).sum().backward()
    assert q.grad is not None and k.grad is not None and v.grad is not None
    assert (tfa.FLASH_BWD_DQ_LAUNCHES, tfa.FLASH_BWD_DKV_LAUNCHES) == before


def test_flash_cpu_path_launches_no_kernel():
    q, k, v = (torch.from_numpy(x) for x in _qkv(5, 1, 64, 2, 32))
    before = tfa.FLASH_FWD_LAUNCHES
    tfa.flash_attention(q, k, v)
    assert tfa.FLASH_FWD_LAUNCHES == before


def test_flash_rejects_bad_inputs():
    q, k, v = (torch.from_numpy(x) for x in _qkv(6, 1, 32, 1, 32))
    with pytest.raises(ValueError, match="block_q"):
        tfa.flash_attention(q, k, v, block_q=0)
    with pytest.raises(ValueError, match="resident_kv"):
        tfa.flash_attention(q, k, v, resident_kv="on")
    with pytest.raises(ValueError, match="shape"):
        tfa.flash_attention_fwd(q[0], k[0, :16], v[0])
    meta = torch.empty((2, 32, 32), device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        tfa.flash_attention_fwd(meta, meta, meta)


@pytest.mark.parametrize("T", [512, 1024, 2048, 4096, 3000])
@pytest.mark.parametrize("causal", [True, False])
def test_block_policies_match_jax(T, causal):
    assert tfa._resident_plan(T, causal) == jfa._resident_plan(T, causal)
    assert tfa.auto_blocks(T) == jfa.auto_blocks(T)


@pytest.mark.parametrize("env,mode", [(None, "auto"), (None, "on"),
                                      (None, "off"), ("1", "off"),
                                      ("0", "on")])
def test_resident_mode_matches_jax(monkeypatch, env, mode):
    if env is None:
        monkeypatch.delenv("RAYTPU_FLASH_RESIDENT", raising=False)
    else:
        monkeypatch.setenv("RAYTPU_FLASH_RESIDENT", env)
    assert tfa.resolve_resident_mode(mode) == \
        jfa.resolve_resident_mode(mode)
