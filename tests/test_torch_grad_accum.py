"""The port's gradient accumulation against the JAX package's
``accumulated_train_step``.

llama nano in f32, the JAX package's parameters carried over through
numpy, the same numpy batches, ``optax.adamw`` beside the port's
``adamw``.  The JAX step scans the microbatches inside one jit; the
port's loops over them eagerly; losses, parameters and the telemetry
counts must agree.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from ray_tpu._private import device_stats as jds  # noqa: E402
from ray_tpu.models import llama as jl  # noqa: E402
from ray_tpu.train import telemetry as jtel  # noqa: E402
from ray_tpu.train.grad_accum import accumulated_train_step as jaccum  # noqa: E402
from ray_tpu_torch._private import device_stats as tds  # noqa: E402
from ray_tpu_torch.models import llama as tl  # noqa: E402
from ray_tpu_torch.models.convert import llama_params_from_numpy  # noqa: E402
from ray_tpu_torch.train import accumulated_train_step, adamw  # noqa: E402
from ray_tpu_torch.train import build_train_step, train_stats  # noqa: E402
from ray_tpu_torch.train.goodput import ANATOMY_COMPONENTS  # noqa: E402
from ray_tpu_torch.train.optim import tree_leaves  # noqa: E402
from tests.test_torch_trainwatch import (LOSS_TOL, _nu,  # noqa: E402
                                         assert_params_close,
                                         eps_bound_mask)

LR = 3e-4


def _setup(n_micro, telemetry, name):
    jcfg = jl.llama_config("nano", dtype=jnp.float32, use_flash=False)
    jparams = jl.llama_init(jax.random.PRNGKey(0), jcfg)
    tx = optax.adamw(LR, weight_decay=0.1)
    jstep = jaccum(lambda p, b: jl.llama_loss(p, b, jcfg), tx,
                   num_microbatches=n_micro, telemetry=telemetry,
                   telemetry_name=name)
    cfg = tl.llama_config("nano", dtype=torch.float32)
    params = llama_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), cfg, device="cpu")
    ttx = adamw(LR, weight_decay=0.1)
    step = accumulated_train_step(lambda p, b: tl.llama_loss(p, b, cfg),
                                  ttx, num_microbatches=n_micro,
                                  telemetry=telemetry, telemetry_name=name)
    return (jstep, jparams, tx.init(jparams)), (step, params,
                                                ttx.init(params))


def _batches(n, rows=4, seed=5):
    rng = np.random.default_rng(seed)
    return [{"tokens": rng.integers(0, 512, (rows, 17)).astype(np.int32)}
            for _ in range(n)]


@pytest.mark.parametrize("n_micro", [2, 4])
def test_accumulated_steps_match_jax(n_micro):
    """Two accumulated steps (no telemetry, JAX's step jitted at the
    call site as its docstring asks): losses and parameters."""
    (jstep, jp, js), (step, tp, ts) = _setup(n_micro, False, "unused")
    jstep = jax.jit(jstep)
    mask = None
    for i, b in enumerate(_batches(2)):
        jp, js, jloss = jstep(jp, js, b)
        tp, ts, loss = step(tp, ts, {"tokens": torch.from_numpy(
            b["tokens"])})
        np.testing.assert_allclose(float(loss), float(jloss),
                                   atol=LOSS_TOL, rtol=LOSS_TOL)
        mask = eps_bound_mask(mask, _nu(js), i + 1)
        assert_params_close(
            tree_leaves(tp),
            [np.asarray(x) for x in jax.tree_util.tree_leaves(jp)], mask,
            i + 1, LR, f"step {i + 1}")
    assert int(ts["count"]) == int(js[0].count) == 2


def test_accumulated_step_telemetry_counts_match_jax():
    name = "tga_counts"
    (jstep, jp, js), (step, tp, ts) = _setup(2, True, name)
    jreg0 = jds.get_registry().snapshot().get("train.step", {})
    treg0 = tds.get_registry().snapshot().get("train.step", {})
    for b in _batches(3):
        jp, js, jloss = jstep(jp, js, b)
        tp, ts, loss = step(tp, ts, {"tokens": torch.from_numpy(
            b["tokens"])})
        np.testing.assert_allclose(float(loss), float(jloss),
                                   atol=LOSS_TOL, rtol=LOSS_TOL)
    jst, tst = jtel.train_stats(name), train_stats(name)
    for key in ("steps", "compiles", "examples"):
        assert tst[key] == jst[key], key
    assert (tst["steps"], tst["compiles"]) == (3, 1)
    assert tst["anatomy"]["step_wall_ms"]["count"] == \
        jst["anatomy"]["step_wall_ms"]["count"] == 3
    assert tst["health"]["observed"] == jst["health"]["observed"] == 0
    for rec in step.goodput.last_steps():
        assert sum(rec[c] for c in ANATOMY_COMPONENTS) == pytest.approx(
            rec["step_wall_ms"], rel=1e-9, abs=1e-9)
    jreg = jds.get_registry().snapshot()["train.step"]
    treg = tds.get_registry().snapshot()["train.step"]
    for key in ("compile_events", "invokes"):
        assert treg[key] - treg0.get(key, 0) == \
            jreg[key] - jreg0.get(key, 0), key
    assert step._raw_step is not None


def test_one_microbatch_is_the_plain_step():
    """num_microbatches=1 is build_train_step's step: the same loss and
    parameters, bit for bit (the same eager operations)."""
    cfg = tl.llama_config("nano", dtype=torch.float32)
    params = tl.llama_init(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    tx = adamw(LR)
    loss_fn = lambda p, b: tl.llama_loss(p, b, cfg)  # noqa: E731
    b = {"tokens": torch.from_numpy(_batches(1)[0]["tokens"])}
    p1, _, l1 = accumulated_train_step(loss_fn, tx, num_microbatches=1)(
        params, tx.init(params), b)
    p2, _, l2 = build_train_step(loss_fn, tx, donate=False,
                                 telemetry=False)(params, tx.init(params), b)
    assert torch.equal(l1, l2)
    for a, c in zip(tree_leaves(p1), tree_leaves(p2)):
        assert torch.equal(a, c)


def test_inputs_unchanged_unless_donated():
    cfg = tl.llama_config("nano", dtype=torch.float32)
    params = tl.llama_init(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    tx = adamw(LR)
    state = tx.init(params)
    before = [t.clone() for t in tree_leaves(params)]
    b = {"tokens": torch.from_numpy(_batches(1)[0]["tokens"])}
    loss_fn = lambda p, bb: tl.llama_loss(p, bb, cfg)  # noqa: E731
    new, new_state, _ = accumulated_train_step(
        loss_fn, tx, num_microbatches=2)(params, state, b)
    assert new is not params and int(state["count"]) == 0
    assert int(new_state["count"]) == 1
    assert all(torch.equal(a, c) for a, c in
               zip(tree_leaves(params), before))
    donated = accumulated_train_step(
        loss_fn, tx, num_microbatches=2,
        jit_kwargs={"donate_argnums": (0, 1)})
    out, out_state, _ = donated(params, state, b)
    assert out is params and out_state is state
    for a, c in zip(tree_leaves(params), tree_leaves(new)):
        assert torch.equal(a, c)


def test_indivisible_batch_raises_the_jax_error():
    cfg = tl.llama_config("nano", dtype=torch.float32)
    params = tl.llama_init(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    tx = adamw(LR)
    b = _batches(1, rows=3)[0]
    with pytest.raises(ValueError) as want:
        jaccum(lambda p, bb: 0.0, optax.adamw(LR),
               num_microbatches=2)({}, None, b)
    with pytest.raises(ValueError) as got:
        accumulated_train_step(lambda p, bb: 0.0, tx, num_microbatches=2)(
            params, tx.init(params), {"tokens": torch.from_numpy(
                b["tokens"])})
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("kw", [{"in_shardings": None},
                                {"donate_argnums": (0,)}])
def test_unported_jit_kwargs_raise(kw):
    """Shardings are ported (``in_shardings`` puts the step on their
    mesh, held on gloo ranks in tests/test_torch_parallel.py;
    ``in_shardings=None`` is the one-device step); partial donation
    still raises."""
    if "in_shardings" in kw:
        assert callable(accumulated_train_step(
            lambda p, b: 0.0, adamw(LR), num_microbatches=2, jit_kwargs=kw))
        return
    with pytest.raises(NotImplementedError,
                       match=r"only donate_argnums=\(0, 1\)"):
        accumulated_train_step(lambda p, b: 0.0, adamw(LR),
                               num_microbatches=2, jit_kwargs=kw)
