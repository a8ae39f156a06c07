"""The port's fused lm-head + cross-entropy (ray_tpu_torch/ops/fused_ce.py)
against the JAX package's (ray_tpu/ops/fused_ce.py).

On the CPU the port's wrappers take the kernels' plain versions, through
the same torch.autograd.Function the card runs; JAX runs its Pallas
kernels in interpret mode.  Both see the same numpy inputs.  Tolerances
are the JAX package's own (tests/test_fused_ce.py): f32 values and
gradients at rtol 1e-4, atol 1e-5 (sums in another order).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops import fused_ce as jfc
from ray_tpu_torch.ops.fused_ce import fused_lm_ce

tfc = importlib.import_module("ray_tpu_torch.ops.fused_ce")

RTOL, ATOL = 1e-4, 1e-5


def _inputs(seed, n, d, v, valid):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, d).astype(np.float32),
            rng.randn(v, d).astype(np.float32),
            rng.randint(0, valid, n).astype(np.int32),
            rng.rand(n).astype(np.float32))


def _jax_value_and_grads(h, w, t, wts, valid, bn, bv, dtype):
    def loss(a, b):
        nll = jfc.fused_lm_ce(a, b, jnp.asarray(t), valid, block_n=bn,
                              block_v=bv, compute_dtype=dtype,
                              interpret=True)
        return jnp.sum(jnp.asarray(wts) * nll), nll

    (_, nll), (gh, gw) = jax.value_and_grad(loss, argnums=(0, 1),
                                            has_aux=True)(
        jnp.asarray(h), jnp.asarray(w))
    return np.asarray(nll), np.asarray(gh), np.asarray(gw)


def _port_value_and_grads(h, w, t, wts, valid, bn, bv, dtype):
    ht = torch.from_numpy(h).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    nll = fused_lm_ce(ht, wt, torch.from_numpy(t), valid, block_n=bn,
                      block_v=bv, compute_dtype=dtype)
    (torch.from_numpy(wts) * nll).sum().backward()
    assert nll.dtype == torch.float32
    assert ht.grad.dtype == ht.dtype and wt.grad.dtype == wt.dtype
    return nll.detach().numpy(), ht.grad.numpy(), wt.grad.numpy()


# the cases of tests/test_fused_ce.py:26-31 and :44-47
CASES = [
    (16, 32, 128, 100, 8, 64),    # padded vocab tail masked
    (8, 16, 96, 96, 8, 32),       # exact tiling, no padding
    (4, 8, 50, 50, 16, 64),       # tile > vocab
    (33, 24, 130, 123, 8, 64),    # n AND v non-divisible by the blocks
]


@pytest.mark.parametrize("n,d,v,valid,bn,bv", CASES)
def test_values_and_grads_match_jax_f32(n, d, v, valid, bn, bv):
    h, w, t, wts = _inputs(1, n, d, v, valid)
    want = _jax_value_and_grads(h, w, t, wts, valid, bn, bv, jnp.float32)
    got = _port_value_and_grads(h, w, t, wts, valid, bn, bv, torch.float32)
    for g_, w_, name in zip(got, want, ("nll", "dhidden", "dwte")):
        np.testing.assert_allclose(g_, w_, rtol=RTOL, atol=ATOL,
                                   err_msg=name)
    if valid < v:
        # rows past valid_vocab are masked: exactly zero gradient
        assert np.abs(got[2][valid:]).max() == 0.0


def test_values_and_grads_match_jax_f32_at_gpt2_large_width():
    """d_model 1280 (gpt2-large), above the 1024 the card's kernels once
    refused.  w ~ N(0, 1/D) keeps the logits ~ N(0, 1), as a trained head
    gives them (the card tests' inputs); with w ~ N(0, 1) their std would
    be ~36, where one f32 rounding step of a logit (7.6e-6 at 100) already
    moves near-one-hot gradients past the JAX package's f32 tolerance in
    either implementation."""
    n, d, v, valid = 16, 1280, 130, 123
    h, w, t, wts = _inputs(2, n, d, v, valid)
    w = (w * d ** -0.5).astype(np.float32)
    want = _jax_value_and_grads(h, w, t, wts, valid, 8, 64, jnp.float32)
    got = _port_value_and_grads(h, w, t, wts, valid, 8, 64, torch.float32)
    for g_, w_, name in zip(got, want, ("nll", "dhidden", "dwte")):
        np.testing.assert_allclose(g_, w_, rtol=RTOL, atol=ATOL,
                                   err_msg=name)
    assert np.abs(got[2][valid:]).max() == 0.0


def test_bf16_compute_matches_jax_bf16():
    """bf16 operands, f32 accumulators (tests/test_fused_ce.py:75-98):
    both round h and w to bf16 and dlogits to bf16 before the products,
    so values and gradients agree to summation order (1e-4)."""
    n, d, v, valid, bn, bv = 32, 64, 200, 180, 16, 128
    h, w, t, _ = _inputs(2, n, d, v, valid)
    wts = np.full((n,), 1.0 / n, np.float32)   # the mean, as the JAX test
    want = _jax_value_and_grads(h, w, t, wts, valid, bn, bv, jnp.bfloat16)
    got = _port_value_and_grads(h, w, t, wts, valid, bn, bv, torch.bfloat16)
    for g_, w_, name in zip(got, want, ("nll", "dhidden", "dwte")):
        assert np.all(np.isfinite(g_)), name
        np.testing.assert_allclose(g_, w_, rtol=1e-4, atol=1e-4,
                                   err_msg=name)


@pytest.mark.parametrize("n,d,v,valid,bn,bv", [CASES[0], CASES[3]])
def test_kernel_functions_match_jax_fwd_and_bwd(n, d, v, valid, bn, bv):
    """Each kernel's counterpart alone (fused_ce_fwd, _bwd_dh, _bwd_dw)
    against the JAX package's _fwd and _bwd on block-padded inputs, as
    fused_lm_ce feeds them."""
    h, w, t, g = _inputs(3, n, d, v, valid)
    n_p = -(-n // bn) * bn
    v_p = -(-v // bv) * bv
    hp = np.pad(h, ((0, n_p - n), (0, 0)))
    wp = np.pad(w, ((0, v_p - v), (0, 0)))
    tp = np.pad(t, (0, n_p - n))
    gp = np.pad(g, (0, n_p - n))
    nll_j, lse_j = jfc._fwd(jnp.asarray(hp), jnp.asarray(wp),
                            jnp.asarray(tp).reshape(1, -1), valid, bn, bv,
                            jnp.float32, True)
    dh_j, dw_j = jfc._bwd(jnp.asarray(hp), jnp.asarray(wp),
                          jnp.asarray(tp).reshape(1, -1), lse_j,
                          jnp.asarray(gp), valid, bn, bv, jnp.float32, True)
    ht, wt, tt = (torch.from_numpy(x) for x in (h, w, t))
    nll, lse = tfc.fused_ce_fwd(ht, wt, tt, valid)
    np.testing.assert_allclose(nll.numpy(), np.asarray(nll_j)[:n],
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j)[:n],
                               rtol=RTOL, atol=ATOL)
    gt = torch.from_numpy(g)
    dh = tfc.fused_ce_bwd_dh(ht, wt, tt, lse, gt, valid)
    dw = tfc.fused_ce_bwd_dw(ht, wt, tt, lse, gt, valid)
    assert dh.dtype == dw.dtype == torch.float32
    np.testing.assert_allclose(dh.numpy(), np.asarray(dh_j)[:n], rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(dw.numpy(), np.asarray(dw_j)[:v], rtol=RTOL,
                               atol=ATOL)


def test_f32_master_table_gets_an_f32_gradient():
    """The f32 wte enters as it is and is cast inside: bf16 compute
    gives a bf16 hidden gradient and an f32, unrounded wte gradient."""
    h, w, t, _ = _inputs(4, 16, 32, 128, 100)
    ht = torch.from_numpy(h).to(torch.bfloat16).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    fused_lm_ce(ht, wt, torch.from_numpy(t), 100).mean().backward()
    assert ht.grad.dtype == torch.bfloat16
    assert wt.grad.dtype == torch.float32
    # not every element is a bf16 value: the gradient was not rounded
    assert not torch.equal(wt.grad, wt.grad.to(torch.bfloat16).float())


def test_invalid_valid_vocab_raises():
    h = torch.zeros((4, 8))
    w = torch.zeros((16, 8))
    t = torch.zeros((4,), dtype=torch.int32)
    with pytest.raises(ValueError, match="valid_vocab"):
        fused_lm_ce(h, w, t, 17)
    with pytest.raises(ValueError, match="valid_vocab"):
        fused_lm_ce(h, w, t, 0)
    with pytest.raises(ValueError, match="block_n"):
        fused_lm_ce(h, w, t, 16, block_n=0)


def test_cpu_tensors_take_the_plain_version():
    """No kernel launches for CPU tensors: every counter stays put."""
    h, w, t, _ = _inputs(5, 8, 16, 96, 96)
    before = (tfc.FUSED_CE_FWD_LAUNCHES, tfc.FUSED_CE_BWD_DH_LAUNCHES,
              tfc.FUSED_CE_BWD_DW_LAUNCHES)
    ht = torch.from_numpy(h).requires_grad_(True)
    fused_lm_ce(ht, torch.from_numpy(w), torch.from_numpy(t), 96,
                compute_dtype=torch.float32).sum().backward()
    assert (tfc.FUSED_CE_FWD_LAUNCHES, tfc.FUSED_CE_BWD_DH_LAUNCHES,
            tfc.FUSED_CE_BWD_DW_LAUNCHES) == before


@pytest.mark.parametrize("d", [64, 768, 1024, 1088, 1280, 2048, 4096, 5120,
                               8192, 8256, 16384])
def test_backward_launch_plan_covers_d(d):
    """fused_ce_bwd_plan, the one plan of the bf16 dH/dW launches: every
    box of 64 columns is owned by exactly one (cluster rank, grid-y
    slice), clusters have at most 8 CTAs (16 only above D = 8192) and
    each CTA at most 12 output boxes; up to D = 1024 the resident
    kernel's slicing is as it was (slices of at most 12 boxes, as even
    as can be, no cluster)."""
    boxes = d // 64
    for rows in (1, 64, 65, 16384):
        plan = tfc.fused_ce_bwd_plan(d, rows)
        # the output boxes of rank q in slice y, as the kernels take them
        owned = [b for q in range(plan.k) for y in range(plan.slices)
                 for b in range(q * plan.sc + y * plan.c,
                                min(q * plan.sc + (y + 1) * plan.c, boxes))]
        assert sorted(owned) == list(range(boxes))
        assert 1 <= plan.k <= (8 if d <= 8192 else tfc.BWD_MAX_CLUSTER)
        assert 1 <= plan.c <= 12
        assert plan.grid == (-(-rows // tfc.BWD_BLOCK_ROWS) * plan.k,
                             plan.slices)
        if d <= 1024:
            slices = -(-boxes // 12)
            assert plan == tfc.BwdPlan("resident", 1, -(-boxes // slices),
                                       slices, boxes, plan.grid)
        else:
            assert plan.kernel == "cluster" and plan.k > 1
            # the cluster's chunks cover D, and at most half of its CTAs
            # hold no column of it
            assert (plan.k // 2) * plan.sc < boxes <= plan.k * plan.sc
            assert (plan.k, plan.c, plan.sc) in tfc._CLUSTER_SHAPES


def test_backward_launch_plan_refuses_what_no_kernel_runs():
    with pytest.raises(ValueError, match="multiple of 64"):
        tfc.fused_ce_bwd_plan(96, 128)
    with pytest.raises(ValueError, match="up to 16384"):
        tfc.fused_ce_bwd_plan(16448, 128)


def test_kernel_tables_are_the_launch_plans():
    """csrc/fused_ce.cu instantiates the bf16 backward from the header
    that kernel_plans_header writes: one resident row (D / 64, c,
    slices) for each D up to 1024, equal to its launch plan, and the
    cluster rows of every plan above it."""
    import re

    text = tfc.kernel_plans_header()
    tables = {name: [tuple(map(int, r.split(", "))) for r in
                     re.findall(r"\{(\d+, \d+, \d+)\}", body)]
              for name, body in re.findall(r"int (\w+)\[\]\[3\] = (.*);",
                                           text)}
    assert [r[0] for r in tables["kResidentPlans"]] == list(range(1, 17))
    for boxes, c, slices in tables["kResidentPlans"]:
        plan = tfc.fused_ce_bwd_plan(64 * boxes, 128)
        assert (plan.kernel, plan.c, plan.slices) == ("resident", c, slices)
    used = {(p.k, p.c, p.sc) for p in (tfc.fused_ce_bwd_plan(64 * b, 128)
                                       for b in range(17, 257))}
    assert used == set(tables["kClusterShapes"])
