"""The port's train step and AdamW against the JAX package's
``jax_utils.build_train_step`` with ``optax.adamw``, and the port's
``time_config`` on the CPU.

Nano preset in float32, parameters initialized by JAX and carried over
through numpy, the same numpy batch for both.  JAX runs
``use_flash=False`` (no ``interpret`` reaches its model); the port runs
the flash autograd Function (plain versions on the CPU) and plain
attention.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu.models import gpt2 as jg
from ray_tpu.train.jax_trainer import jax_utils
from ray_tpu_torch.bench import time_config
from ray_tpu_torch.models import gpt2 as tg
from ray_tpu_torch.models.convert import gpt2_params_from_numpy
from ray_tpu_torch.train import adamw, build_train_step
from ray_tpu_torch.train.optim import tree_leaves

# params after each AdamW step: an update is ~lr = 3e-4, and the two
# packages' gradients agree to ~1e-6 relative, so 1e-5 is ~3% of one
# step's update; loss as in the forward parity tests; grad norm: the
# gradient tolerance of the JAX package's tests
PARAM_TOL = 1e-5
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4


@pytest.mark.parametrize("use_flash,remat_policy", [(True, "mlp_only"),
                                                    (False, "full")])
def test_three_adamw_steps_match_optax(use_flash, remat_policy):
    jcfg = jg.gpt2_config("nano", dtype=jnp.float32, use_flash=False)
    jparams = jg.gpt2_init(jax.random.PRNGKey(0), jcfg)
    tx = optax.adamw(3e-4, weight_decay=0.1)
    jstate = tx.init(jparams)
    jstep = jax_utils.build_train_step(
        lambda p, b: jg.gpt2_loss(p, b, jcfg), tx, telemetry=False,
        health=True, donate=False)

    cfg = tg.gpt2_config("nano", dtype=torch.float32, use_flash=use_flash,
                         remat_policy=remat_policy)
    params = gpt2_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), cfg, device="cpu")
    ttx = adamw(3e-4, weight_decay=0.1)
    state = ttx.init(params)
    step = build_train_step(lambda p, b: tg.gpt2_loss(p, b, cfg), ttx,
                            health=True)

    tokens = np.random.default_rng(1).integers(0, 512, (2, 33)).astype(
        np.int32)
    for i in range(3):
        jparams, jstate, jloss, jh = jstep(jparams, jstate,
                                           {"tokens": jnp.asarray(tokens)})
        params, state, loss, h = step(params, state,
                                      {"tokens": torch.from_numpy(tokens)})
        np.testing.assert_allclose(float(loss), float(jloss),
                                   atol=LOSS_TOL, rtol=LOSS_TOL)
        np.testing.assert_allclose(float(h["loss"]), float(jh["loss"]),
                                   atol=LOSS_TOL, rtol=LOSS_TOL)
        np.testing.assert_allclose(float(h["grad_norm"]),
                                   float(jh["grad_norm"]), rtol=GRAD_TOL)
        assert int(h["nonfinite"]) == int(jh["nonfinite"]) == 0
        assert h["nonfinite"].dtype == torch.int32
        want = [np.asarray(x) for x in jax.tree_util.tree_leaves(jparams)]
        for j, (p, w) in enumerate(zip(tree_leaves(params), want)):
            np.testing.assert_allclose(p.numpy(), w, atol=PARAM_TOL,
                                       rtol=PARAM_TOL,
                                       err_msg=f"step {i + 1}, leaf {j}")


def test_adamw_matches_optax_on_every_leaf():
    """Decay reaches every leaf, biases and scales included (optax
    without a mask), over two steps with changing gradients."""
    rng = np.random.default_rng(2)
    tree = {"w": rng.standard_normal((3, 4)).astype(np.float32),
            "ln": {"scale": np.ones(4, np.float32),
                   "bias": np.zeros(4, np.float32)}}
    grads = [jax.tree_util.tree_map(
        lambda x: rng.standard_normal(x.shape).astype(np.float32), tree)
        for _ in range(2)]
    tx = optax.adamw(1e-2, weight_decay=0.1)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    js = tx.init(jp)
    ttx = adamw(1e-2, weight_decay=0.1)
    tp = {"w": torch.from_numpy(tree["w"].copy()),
          "ln": {k: torch.from_numpy(v.copy())
                 for k, v in tree["ln"].items()}}
    ts = ttx.init(tp)
    for g in grads:
        upd, js = tx.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, upd)
        ttx.update_(tp, [torch.from_numpy(x)
                         for x in jax.tree_util.tree_leaves(g)], ts)
    for p, w in zip(tree_leaves(tp), jax.tree_util.tree_leaves(jp)):
        np.testing.assert_allclose(p.numpy(), np.asarray(w), atol=1e-6,
                                   rtol=1e-6)
    assert ts["count"] == 2
    assert adamw(1e-3).weight_decay == 1e-4   # optax's default, not torch's


def test_donate_false_leaves_inputs_untouched():
    cfg = tg.gpt2_config("nano", dtype=torch.float32)
    gen = torch.Generator().manual_seed(0)
    params = tg.gpt2_init(cfg, gen, device="cpu")
    before = [t.clone() for t in tree_leaves(params)]
    tx = adamw(3e-4, weight_decay=0.1)
    state = tx.init(params)
    step = build_train_step(lambda p, b: tg.gpt2_loss(p, b, cfg), tx,
                            donate=False)
    tokens = torch.randint(0, 512, (2, 17), generator=gen)
    new, new_state, loss = step(params, state, {"tokens": tokens})
    assert new is not params and state["count"] == 0
    assert new_state["count"] == 1
    for a, b in zip(tree_leaves(params), before):
        assert torch.equal(a, b)
    assert any(not torch.equal(a, b) for a, b in
               zip(tree_leaves(new), before))


def test_unported_step_options_raise():
    """Meshes are ported (held on gloo ranks in
    tests/test_torch_parallel.py): what is no DeviceMesh is refused.
    The step's telemetry is ported (the JAX default, telemetry=True,
    returns the wrapped step), and a registry program over several
    devices is taken, its count recorded, as the JAX trainer
    instruments a mesh step with the mesh's size."""
    tx = adamw(3e-4)
    with pytest.raises(TypeError, match="DeviceMesh"):
        build_train_step(lambda p, b: 0.0, tx, mesh=object())
    step = build_train_step(lambda p, b: 0.0, tx)
    assert step.goodput is not None and step._raw_step is not None
    from ray_tpu_torch._private.device_stats import ProgramRegistry

    reg = ProgramRegistry()
    wrapped = reg.instrument("train.step", step._raw_step, n_devices=8)
    assert wrapped.__wrapped__ is step._raw_step
    assert reg.devices_of("train.step") == 8


def test_time_config_on_cpu():
    tok_s, mfu, loss, n_chips, cost = time_config(
        2, seq=64, n_steps=2, preset="nano", device="cpu",
        dtype=torch.float32)
    assert tok_s > 0 and n_chips == 1
    assert mfu is None and cost["peak_flops"] is None  # no card, no MFU
    assert cost["device"] == "cpu" and cost["steps_run"] == 3
    cfg = tg.gpt2_config("nano", max_seq=64)
    assert cost["model_flops"] == 6 * tg.gpt2_param_count(cfg) * 2 * 64
    losses = cost["losses"]
    assert len(losses) == 3 and losses[-1] == loss
    assert np.all(np.isfinite(losses)) and losses[-1] < losses[0]
    # without a process group every layout is the one-device step
    # (over gloo ranks: tests/test_torch_parallel.py)
    for mesh in ("fsdp", "data_fsdp"):
        _, _, _, chips, c = time_config(2, seq=64, n_steps=2, preset="nano",
                                        device="cpu", dtype=torch.float32,
                                        mesh=mesh)
        assert chips == 1 and c["losses"] == losses
    # a tensor mesh is the decode's (bench.time_decode, decode_mesh)
    with pytest.raises(ValueError, match="a decode layout"):
        time_config(2, seq=64, preset="nano", device="cpu", mesh="tensor")
    with pytest.raises(ValueError, match="spans the whole group"):
        time_config(2, seq=64, preset="nano", device="cpu", n_devices=2)


def test_time_config_books_bench_train_step():
    """As bench.py:392 and :425-426: one compile event for the warm-up
    step, one invoke of dt / n_steps per timed step."""
    from ray_tpu_torch._private.device_stats import (get_registry,
                                                     reset_registry)

    reset_registry()
    _, _, _, _, cost = time_config(2, seq=32, n_steps=3, preset="nano",
                                   device="cpu", dtype=torch.float32)
    got = get_registry().snapshot()["bench.train_step"]
    assert (got["compile_events"], got["invokes"]) == (1, 3)
    # invoke_ms is summarized to 3 decimals
    assert got["invoke_ms"]["max"] == pytest.approx(cost["step_ms"],
                                                    abs=1e-3)
    assert cost["compile_seconds"] > 0
