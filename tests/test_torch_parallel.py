"""The port's device plane (``ray_tpu_torch/parallel/``) and the
mesh-sharded train step against the JAX package's.

The pure parts (MeshSpec, the rule tables, ``logical_to_mesh_axes``,
``mesh_axes_for_shape``, ``fake_mesh``'s coordinates, the topology
copy) run in this process against ``ray_tpu.parallel`` on the 8
virtual CPU devices of tests/conftest.py.  The SPMD parts run on gloo
ranks started with the ``spawn`` context (tests/_torch_mesh_ranks.py,
which imports no JAX): four launches, each held to what JAX computes
here on the same numpy inputs, or to the port on one rank:

* 4 ranks: each rank's block of ``shard_params`` equals the JAX
  array's addressable shard on the device of the same mesh position;
  the ``xla_*`` collectives equal JAX's under ``shard_map``; the MoE
  block with its experts split over expert=4 equals the block on one
  rank (tests/test_moe.py:62's check); one AdamW step of ViT tiny on
  fsdp=2 x tensor=2 equals the unsharded step;
* 2 ranks, fsdp=2: one AdamW step of GPT-2 nano, an accumulated step
  and ``time_config(mesh="fsdp")`` equal the unsharded ones;
* 4 ranks, data=2 x expert=2: AdamW steps of GPT-2 nano with 4 experts
  equal JAX's steps on the same mesh (tests/test_moe.py:107);
* 2 ranks save a sharded checkpoint that 4 ranks restore onto another
  mesh.

The declared collective group runs over the port's runtime on the CPU
beside the JAX package's.
"""

import functools
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as P

import ray_tpu
import ray_tpu_torch
from ray_tpu import parallel as jp
from ray_tpu.models import gpt2 as jg
from ray_tpu.models import moe as jm
from ray_tpu.parallel import collective as jcol
from ray_tpu_torch import parallel as tp
from ray_tpu_torch._private._vendor import cloudpickle as port_cloudpickle
from ray_tpu_torch.models import gpt2 as tg
from ray_tpu_torch.models import moe as tm
from ray_tpu_torch.models.convert import gpt2_params_from_numpy
from ray_tpu_torch.parallel import sharding as tsh
from ray_tpu_torch.train import (accumulated_train_step, adamw,
                                 build_train_step, restore_sharded)
from ray_tpu_torch.train.optim import tree_leaves, tree_unflatten
from tests import _torch_mesh_ranks as ranks
from tests.test_torch_jax_teardown import settle_jax_loops  # noqa: F401
from tests.test_torch_trainwatch import assert_params_close, eps_bound_mask

# the port's runtime workers unpickle this module's actor by value
port_cloudpickle.register_pickle_by_value(sys.modules[__name__])

# params after an AdamW step and losses (tests/test_torch_train_step.py)
PARAM_TOL = 1e-5
LOSS_TOL = 1e-5
# the MoE block (tests/test_moe.py:76-78)
MOE_TOL = 2e-4
WAIT_S = 120


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# -- the pure parts ----------------------------------------------------------

SPECS = [dict(data=-1), dict(data=-1, tensor=2), dict(fsdp=4, tensor=2),
         dict(data=2, expert=-1), dict(pipeline=2, seq=2, fsdp=-1),
         dict(data=3), dict(data=-1, fsdp=-1), dict(expert=8)]


@pytest.mark.parametrize("kw", SPECS, ids=str)
def test_meshspec_resolves_as_jax(kw):
    def run(mod):
        try:
            s = mod.MeshSpec(**kw).resolve(8)
            return ("ok", s.axis_sizes(), s.nontrivial_axes(), s.n_devices)
        except ValueError as e:
            return ("error", str(e))

    assert run(tp) == run(jp)


AXES = [("batch", "seq", "embed"), ("embed", "mlp"), ("vocab", "embed"),
        (None, "embed", None, "heads", "head_dim"),
        (None, "expert", "embed", "mlp"), ("batch", "seq", "heads",
                                           "head_dim"),
        ("kv_heads", "embed"), (), ("batch", "embed", "batch")]


@pytest.mark.parametrize("rules", ["DEFAULT_RULES", "DECODE_RULES"])
@pytest.mark.parametrize("axes", AXES, ids=str)
def test_logical_to_mesh_axes_as_jax(axes, rules):
    assert getattr(tsh, rules) == getattr(jp, rules)
    got = tp.logical_to_mesh_axes(axes, getattr(tsh, rules))
    want = jp.logical_to_mesh_axes(axes, getattr(jp, rules))
    assert tuple(got) == tuple(want)
    assert repr(got) == repr(want)


SHAPES = [((8, 6), ("embed", "mlp")), ((6, 8), ("embed", "mlp")),
          ((4, 16, 8), ("batch", "seq", "embed")),
          ((2, 64, 3, 2, 32), (None, "embed", None, "heads", "head_dim")),
          ((2, 4, 64, 256), (None, "expert", "embed", "mlp")),
          ((512, 64), ("vocab", "embed")), ((5,), ("embed",))]


@pytest.mark.parametrize("kw", [dict(fsdp=4, tensor=2), dict(data=8),
                                dict(data=2, expert=4),
                                dict(fsdp=2, seq=2, tensor=2)], ids=str)
@pytest.mark.parametrize("shape,axes", SHAPES, ids=str)
def test_mesh_axes_for_shape_as_jax(shape, axes, kw):
    got = tp.mesh_axes_for_shape(shape, axes,
                                 tp.fake_mesh(8, tp.MeshSpec(**kw)))
    want = jp.mesh_axes_for_shape(shape, axes,
                                  jp.fake_mesh(8, jp.MeshSpec(**kw)))
    assert tuple(got) == tuple(want)


@pytest.mark.parametrize("kw", [dict(data=8), dict(data=2, fsdp=2,
                                                   tensor=2),
                                dict(pipeline=2, expert=2, seq=2)], ids=str)
def test_fake_mesh_shape_and_coordinates_as_jax(kw):
    got = tp.fake_mesh(8, tp.MeshSpec(**kw))
    want = jp.fake_mesh(8, jp.MeshSpec(**kw))
    assert got.shape == dict(want.shape)
    assert got.axis_names == tuple(want.axis_names)
    ids = np.vectorize(lambda d: d.id)(want.devices)
    np.testing.assert_array_equal(got.devices, ids)
    for r in range(8):
        pos = np.argwhere(ids == r)[0]
        assert got.coordinate(r) == dict(zip(want.axis_names,
                                             map(int, pos)))
    assert tp.fake_mesh(4).shape["data"] == 4


def test_named_sharding_shard_shape_as_jax():
    tmesh = tp.fake_mesh(8, tp.MeshSpec(fsdp=4, tensor=2))
    jmesh = jp.fake_mesh(8, jp.MeshSpec(fsdp=4, tensor=2))
    params = {"w": jnp.ones((8, 4)), "b": jnp.zeros((4,))}
    axes = {"w": ("embed", "mlp"), "b": ("mlp",)}
    sharded = jp.shard_params(params, axes, jmesh)
    for k in params:
        want = sharded[k].sharding.shard_shape(params[k].shape)
        got = tsh.NamedSharding(tmesh, tp.logical_to_mesh_axes(
            axes[k])).shard_shape(params[k].shape)
        assert got == want
    # tests/test_parallel.py test_shard_params: (8, 4) -> (2, 2)
    assert got == (2,) and want == (2,)


@pytest.mark.parametrize("kw", [dict(fsdp=4, tensor=2),
                                dict(data=2, expert=4)], ids=str)
def test_shardings_by_shape_and_param_shardings_as_jax(kw):
    """The NamedSharding trees (by their specs) for GPT-2 nano with
    experts: the shape-guarded one and the rules' own."""
    tmesh = tp.fake_mesh(8, tp.MeshSpec(**kw))
    jmesh = jp.fake_mesh(8, jp.MeshSpec(**kw))
    cfg = jg.gpt2_config("nano", n_experts=4)
    params = _nano_params(n_experts=4)
    axes = jg.gpt2_logical_axes(cfg)
    got = dict(_flat(tsh.shardings_by_shape(
        {k: v for k, v in params.items()}, axes, tmesh)))
    from ray_tpu.parallel import sharding as jsh

    want = dict(_flat(jsh.shardings_by_shape(params, axes, jmesh)))
    assert {k: tuple(v.spec) for k, v in got.items()} == \
        {k: tuple(v.spec) for k, v in want.items()}
    got = dict(_flat(tsh.param_shardings(axes, tmesh)))
    want = dict(_flat(jax.tree_util.tree_map(
        lambda s: s, jsh.param_shardings(axes, jmesh))))
    assert {k: tuple(v.spec) for k, v in got.items()} == \
        {k: tuple(v.spec) for k, v in want.items()}


def test_topology_copy_as_jax():
    from ray_tpu.parallel import topology as jt
    from ray_tpu_torch.parallel import topology as tt

    for acc in ("v5e-8", "v4-32", "v3-32", "v6e-256"):
        a, b = tt.parse_accelerator_type(acc), jt.parse_accelerator_type(acc)
        assert (a.num_chips, a.num_hosts, a.mesh_shape2d(), str(a)) == \
            (b.num_chips, b.num_hosts, b.mesh_shape2d(), str(b))
        assert tt.mfu(1e4, 10**9, a) == jt.mfu(1e4, 10**9, b)
    assert tt.parse_topology("v4", "4x4x4").num_chips == 64
    with pytest.raises(ValueError, match="unrecognized"):
        tt.parse_accelerator_type("h100-8")


def test_no_mesh_without_a_process_group():
    """make_mesh spans the default process group's ranks; without one
    it says how to make one, and with_logical_constraint is the
    identity without a mesh."""
    import torch.distributed as dist

    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="init_process_group"):
        tp.make_mesh()
    x = torch.ones(2)
    assert tp.with_logical_constraint(x, ("batch",)) is x
    assert tp.active_mesh() is None
    with tp.mesh_context("m"):
        assert tp.active_mesh() == "m"
    assert tp.active_mesh() is None


# -- 4 ranks: shard_params, the xla_* collectives, expert-parallel MoE -----

SHARD_CASES = [
    (dict(fsdp=4), (8, 4), ("embed", "mlp")),
    (dict(fsdp=2, tensor=2), (8, 4), ("embed", "mlp")),
    (dict(data=2, fsdp=2), (8, 6), ("batch", None)),
    (dict(expert=4), (4, 8, 6), ("expert", "embed", "mlp")),
    (dict(data=4), (8, 4), ("embed", "mlp")),
    (dict(tensor=4), (16, 8), ("vocab", "embed")),
]
MOE_KW = dict(d_model=32, d_ff=64, n_experts=4, top_k=2)


def _shard_arrays():
    rng = np.random.default_rng(3)
    return [rng.standard_normal(shape).astype(np.float32)
            for _, shape, _ in SHARD_CASES]


def _moe_inputs():
    jcfg = jm.MoEConfig(dtype=jnp.float32, **MOE_KW)
    params = _np(jm.moe_init(jax.random.PRNGKey(0), jcfg))
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (2, 16, 32)))
    return jcfg, params, x


@pytest.fixture(scope="module")
def device_plane():
    arrays = _shard_arrays()
    cases = [(kw, a, axes) for (kw, _, axes), a in zip(SHARD_CASES, arrays)]
    _, params, x = _moe_inputs()
    return ranks.launch("prog_device_plane", 4, cases,
                        (MOE_KW, params, x), _vit_inputs())


VIT_LR = 1e-3


def _vit_inputs():
    """ViT tiny's JAX-initialised parameters with a seeded non-zero head
    (the zero head would stop every backbone gradient), 4 images and
    labels."""
    from ray_tpu.models import vit as jv

    params = _np(jv.vit_init(jax.random.PRNGKey(0), jv.vit_config("tiny")))
    rng = np.random.default_rng(5)
    for k in ("head_w", "head_b"):
        params[k] = (0.1 * rng.standard_normal(params[k].shape)).astype(
            np.float32)
    images = rng.standard_normal((4, 32, 32, 3)).astype(np.float32)
    labels = rng.integers(0, 10, 4).astype(np.int32)
    return params, images, labels, VIT_LR


@pytest.mark.parametrize("i", range(len(SHARD_CASES)))
def test_shard_params_gives_each_rank_jaxs_shard(device_plane, i):
    kw, _, axes = SHARD_CASES[i]
    arr = _shard_arrays()[i]
    mesh = jp.fake_mesh(4, jp.MeshSpec(**kw))
    placed = jp.shard_params({"w": jnp.asarray(arr)}, {"w": axes}, mesh)
    by_device = {s.device.id: np.asarray(s.data)
                 for s in placed["w"].addressable_shards}
    for rank, out in enumerate(device_plane):
        assert not out["jax_loaded"]
        np.testing.assert_array_equal(out["shards"][i], by_device[rank])


@functools.lru_cache(maxsize=None)
def _jax_collectives():
    """Per device of JAX's data=2 x tensor=2 mesh, the same
    collectives under shard_map on x_r = arange(8).reshape(2, 4) + 10r."""
    mesh = jp.fake_mesh(4, jp.MeshSpec(data=2, tensor=2))
    X = np.stack([np.arange(8, dtype=np.float32).reshape(2, 4) + 10 * r
                  for r in range(4)])
    spec = P(("data", "tensor"))

    def body(v):
        v = v[0]
        out = {
            "psum_data": jcol.xla_allreduce(v, "data"),
            "pmean_tensor": jcol.xla_allreduce(v, "tensor", "mean"),
            "pmax_both": jax.lax.pmax(v, ("data", "tensor")),
            "gather_tiled": jcol.xla_allgather(v, "data", gather_axis=1),
            "gather_stacked": jcol.xla_allgather(v, "tensor", tiled=False),
            "scatter": jcol.xla_reducescatter(v, "data", scatter_axis=1),
            "broadcast": jcol.xla_broadcast(v, "tensor", src=1),
            "ppermute": jcol.xla_ppermute(v, "data", [(0, 1)]),
            "all_to_all": jcol.xla_all_to_all(v, "tensor", split_axis=1,
                                              concat_axis=0),
        }
        return {k: o[None] for k, o in out.items()}

    outs = jax.shard_map(body, mesh=mesh, in_specs=(spec,),
                         out_specs=spec)(jnp.asarray(X))
    grad = jax.grad(lambda v: jnp.sum(jax.shard_map(
        lambda u: jcol.xla_allreduce(u * u, "data"), mesh=mesh,
        in_specs=(spec,), out_specs=spec)(v)))(jnp.asarray(X))
    outs = {k: np.asarray(v) for k, v in outs.items()}
    outs["psum_grad"] = np.asarray(grad)
    ids = np.vectorize(lambda d: d.id)(mesh.devices).reshape(-1)
    return outs, [int(i) for i in ids]


OPS = ["psum_data", "pmean_tensor", "pmax_both", "gather_tiled",
       "gather_stacked", "scatter", "broadcast", "ppermute", "all_to_all",
       "psum_grad"]


@pytest.mark.parametrize("op", OPS)
def test_xla_collectives_equal_jax_shard_map(device_plane, op):
    want, ids = _jax_collectives()
    # the port's ranks and JAX's devices sit at the same mesh positions
    assert ids == [0, 1, 2, 3]
    assert device_plane[0]["coords"] == {
        "pipeline": 0, "data": 0, "fsdp": 0, "expert": 0, "seq": 0,
        "tensor": 0}
    assert device_plane[3]["coords"]["data"] == 1 and \
        device_plane[3]["coords"]["tensor"] == 1
    for rank, out in enumerate(device_plane):
        got = out[op]
        np.testing.assert_allclose(got, want[op][rank].reshape(got.shape),
                                   rtol=1e-6, err_msg=f"rank {rank}")


def test_split_batch_routing_is_one_ranks_exactly(device_plane,
                                                  monkeypatch):
    """The batch split over data=2 and the experts over expert=2: the
    queue positions of each rank's tokens, stacked in rank order, are
    the one-rank block's and JAX's exactly (the queues continue across
    the ranks, so the same assignments are dropped); outputs within
    the MoE tolerance, the aux loss the whole batch's."""
    jcfg, params, x = _moe_inputs()
    cfg = tm.MoEConfig(dtype=torch.float32, **MOE_KW)
    got = {}
    real = tm.moe_route
    monkeypatch.setattr(tm, "moe_route",
                        lambda *a, **kw: got.update(real(*a, **kw)) or got)
    one, one_aux = tm.moe_apply({k: torch.from_numpy(v.copy())
                                 for k, v in params.items()},
                                torch.from_numpy(x), cfg)
    calls = []
    jreal = jax.nn.one_hot

    def spy(v, n, **kw):
        calls.append(np.asarray(v))
        return jreal(v, n, **kw)

    monkeypatch.setattr(jax.nn, "one_hot", spy)
    jm.moe_apply(jax.tree_util.tree_map(jnp.asarray, params),
                 jnp.asarray(x), jcfg)
    by_data = {out["split_data"]: out for out in device_plane}
    pos = np.concatenate([by_data[d]["split_position"] for d in (0, 1)])
    np.testing.assert_array_equal(pos, got["position"].numpy())
    np.testing.assert_array_equal(pos.astype(np.int32), calls[-1])
    y = np.concatenate([by_data[d]["split_y"] for d in (0, 1)])
    np.testing.assert_allclose(y, one.numpy(), rtol=MOE_TOL, atol=MOE_TOL)
    for out in device_plane:
        np.testing.assert_allclose(out["split_aux"], float(one_aux),
                                   rtol=1e-4)


def test_vit_step_on_fsdp_tensor_mesh_equals_the_unsharded_step(
        device_plane):
    """ViT tiny's AdamW step through build_train_step(mesh=...) on
    fsdp=2 x tensor=2 (qkv_w's "embed" over fsdp, its "heads" over
    tensor): the loss and the updated parameters of the unsharded
    port step (PARAM_TOL, one update where AdamW's denominator sat near
    eps, and on the key bias: softmax is invariant to adding q . b_k to
    a whole row of scores, so its gradient is 0 but for rounding, and
    the sign of its first AdamW update is the rounding's)."""
    from ray_tpu_torch.models import vit as tv
    from ray_tpu_torch.models.convert import vit_params_from_numpy

    np_params, images, labels, lr = _vit_inputs()
    cfg = tv.vit_config("tiny", dtype=torch.float32)
    params = vit_params_from_numpy(np_params, cfg, device="cpu")
    tx = adamw(lr, weight_decay=0.1)
    step = build_train_step(lambda p, b: tv.vit_loss(p, b, cfg), tx,
                            telemetry=False)
    params, state, loss = step(params, tx.init(params), {
        "images": torch.from_numpy(images),
        "labels": torch.from_numpy(labels)})
    mask = tree_unflatten(params, eps_bound_mask(
        None, [t.numpy() for t in tree_leaves(state["nu"])], 1))
    mask["blocks"]["attn"]["qkv_b"][:, 1] = True
    mask = tree_leaves(mask)
    for out in device_plane:
        got = out["vit"]
        np.testing.assert_allclose(got["loss"], float(loss), rtol=LOSS_TOL)
        assert got["qkv_placements"].count("Shard") == 2
        want = [t.numpy() for t in tree_leaves(params)]
        assert_params_close([torch.from_numpy(a) for a in
                             tree_leaves(got["params"])], want, mask, 1, lr)


def test_expert_parallel_moe_equals_one_rank(device_plane):
    """tests/test_moe.py:62 on the port: the experts split over
    expert=4 (one a rank), the output and aux loss of the block on one
    rank, and JAX's."""
    jcfg, params, x = _moe_inputs()
    cfg = tm.MoEConfig(dtype=torch.float32, **MOE_KW)
    one, one_aux = tm.moe_apply({k: torch.from_numpy(v.copy())
                                 for k, v in params.items()},
                                torch.from_numpy(x), cfg)
    want, want_aux = jm.moe_apply(jax.tree_util.tree_map(jnp.asarray,
                                                         params),
                                  jnp.asarray(x), jcfg)
    for out in device_plane:
        assert out["w1_local"] == 1
        np.testing.assert_allclose(out["moe_y"], one.numpy(), rtol=MOE_TOL,
                                   atol=MOE_TOL)
        np.testing.assert_allclose(out["moe_y"], np.asarray(want),
                                   rtol=MOE_TOL, atol=MOE_TOL)
        np.testing.assert_allclose(out["moe_aux"], float(one_aux),
                                   rtol=1e-4)
        np.testing.assert_allclose(out["moe_aux"], float(want_aux),
                                   rtol=1e-4)


# -- 2 ranks, fsdp=2: the sharded steps against the unsharded ones -----------

FSDP_LR = 3e-4


def _nano_params(n_experts=0):
    cfg = jg.gpt2_config("nano", dtype=jnp.float32, use_flash=False,
                         n_experts=n_experts)
    return _np(jg.gpt2_init(jax.random.PRNGKey(0), cfg))


def _fsdp_tokens():
    return np.random.default_rng(1).integers(0, 512, (4, 33)).astype(
        np.int32)


@pytest.fixture(scope="module")
def fsdp_ranks():
    return ranks.launch("prog_fsdp_step", 2, _nano_params(), _fsdp_tokens(),
                        FSDP_LR)


def _fsdp_full(outs, key):
    """Whole leaves from the 2 fsdp ranks' blocks: each leaf's "embed"
    dim is split in two (DEFAULT_RULES: embed -> fsdp)."""
    cfg = tg.gpt2_config("nano")
    axes = dict(_flat(tg.gpt2_logical_axes(cfg)))
    blocks = [dict(_flat(o[key])) for o in outs]
    full = {}
    for name, ax in axes.items():
        if "embed" not in ax:   # replicated: the same block on both
            np.testing.assert_array_equal(blocks[0][name], blocks[1][name])
            full[name] = blocks[0][name]
            continue
        dim = list(ax).index("embed")
        full[name] = np.concatenate([b[name] for b in blocks], axis=dim)
    return full


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in _flat(tree[k],
                                                         f"{prefix}{k}.")]
    return [(prefix[:-1], tree)]


def _unsharded(step_kind):
    cfg = tg.gpt2_config("nano", dtype=torch.float32)
    params = gpt2_params_from_numpy(_nano_params(), cfg, device="cpu")
    tx = adamw(FSDP_LR, weight_decay=0.1)
    batch = {"tokens": torch.from_numpy(_fsdp_tokens())}
    loss_fn = lambda p, b: tg.gpt2_loss(p, b, cfg)  # noqa: E731
    if step_kind == "step":
        step = build_train_step(loss_fn, tx, telemetry=False, health=True)
        params, state, loss, health = step(params, tx.init(params), batch)
        return params, state, float(loss), health
    step = accumulated_train_step(loss_fn, tx, num_microbatches=2)
    params, state, loss = step(params, tx.init(params), batch)
    return params, state, float(loss), None


def test_fsdp_step_equals_the_unsharded_step(fsdp_ranks):
    params, state, loss, health = _unsharded("step")
    for out in fsdp_ranks:
        np.testing.assert_allclose(out["loss"], loss, rtol=LOSS_TOL)
        np.testing.assert_allclose(out["grad_norm"],
                                   float(health["grad_norm"]), rtol=1e-4)
        assert out["placements"].count("Shard(dim=1)") == 1
    for key, want in (("params", params), ("mu", state["mu"])):
        got = _fsdp_full(fsdp_ranks, key)
        for name, w in _flat({k: v for k, v in want.items()}):
            np.testing.assert_allclose(got[name], w.numpy(), atol=PARAM_TOL,
                                       rtol=PARAM_TOL,
                                       err_msg=f"{key} {name}")


def test_fsdp_accumulated_step_equals_the_unsharded_one(fsdp_ranks):
    params, _, loss, _ = _unsharded("accum")
    got = _fsdp_full(fsdp_ranks, "accum_params")
    for out in fsdp_ranks:
        np.testing.assert_allclose(out["accum_loss"], loss, rtol=LOSS_TOL)
    for name, w in _flat(params):
        np.testing.assert_allclose(got[name], w.numpy(), atol=PARAM_TOL,
                                   rtol=PARAM_TOL, err_msg=name)


def test_time_config_fsdp_over_two_ranks(fsdp_ranks):
    """bench.time_config(mesh="fsdp") on 2 ranks: the losses of the
    one-device run with the same seed, 2 chips."""
    from ray_tpu_torch.bench import time_config

    _, _, _, n_chips, cost = time_config(
        2, seq=32, n_steps=2, preset="nano", mesh="fsdp", device="cpu",
        dtype=torch.float32, use_flash=False)
    assert n_chips == 1
    for out in fsdp_ranks:
        assert out["bench_chips"] == 2
        np.testing.assert_allclose(out["bench_losses"], cost["losses"],
                                   rtol=1e-4)


# -- 4 ranks, data=2 x expert=2: GPT-2 nano MoE against JAX's steps ----------

MOE_LR, MOE_STEPS = 1e-3, 2


def _moe_tokens():
    # tests/test_moe.py:107's batch
    return (np.arange(2 * 33).reshape(2, 33) % 512).astype(np.int32)


def test_gpt2_moe_on_data_expert_mesh_equals_jax():
    """tests/test_moe.py:107: GPT-2 nano with 4 experts, optax.adam
    steps under a data=2 x expert=2 mesh; the port's AdamW without
    decay on 4 gloo ranks of the same mesh: each step's loss, and the
    parameters after the first (the expert leaves split over expert=2;
    an element whose Adam denominator sat near eps is held to one
    update, as tests/test_torch_trainwatch.py holds it)."""
    np_params = _nano_params(n_experts=4)
    cfg = jg.gpt2_config("nano", n_experts=4, moe_top_k=2, use_flash=False,
                         dtype=jnp.float32)
    mesh = jp.fake_mesh(4, jp.MeshSpec(data=2, expert=2))
    tx = optax.adam(MOE_LR)
    toks = {"tokens": jnp.asarray(_moe_tokens())}
    with jax.set_mesh(mesh):
        params = jp.shard_params(jax.tree_util.tree_map(jnp.asarray,
                                                        np_params),
                                 jg.gpt2_logical_axes(cfg), mesh)
        state = tx.init(params)

        @jax.jit
        def step(params, state):
            loss, grads = jax.value_and_grad(
                lambda p: jg.gpt2_loss(p, toks, cfg))(params)
            updates, state = tx.update(grads, state, params)
            return optax.apply_updates(params, updates), state, loss

        losses = []
        for i in range(MOE_STEPS):
            params, state, loss = step(params, state)
            losses.append(float(loss))
            if i == 0:
                want = dict(_flat(_np(params)))
                nu = dict(_flat(_np(state[0].nu)))

    outs = ranks.launch("prog_moe_step", 4, np_params, _moe_tokens(), MOE_LR,
                        MOE_STEPS)
    for out in outs:
        np.testing.assert_allclose(out["losses"], losses, rtol=LOSS_TOL,
                                   atol=LOSS_TOL)
        assert out["w1_shape"][1] == 2   # 4 experts over expert=2
    for name, w in want.items():
        blocks = [dict(_flat(o["params"]))[name] for o in outs]
        if ".moe." in name and not name.endswith("gate"):
            # rank r at (data, expert) = divmod(r, 2): experts on dim 1
            got = np.concatenate(blocks[:2], axis=1)
            np.testing.assert_array_equal(blocks[0], blocks[2])
        else:
            got = blocks[0]
            for b in blocks[1:]:
                np.testing.assert_array_equal(b, got)
        mask = eps_bound_mask(None, [nu[name]], 1)
        assert_params_close([torch.from_numpy(got)], [w], mask, 1, MOE_LR,
                            msg=name)


# -- a 2-rank save restored onto 4 ranks -------------------------------------

def test_restore_sharded_reshards_two_ranks_onto_four(tmp_path):
    np_params = _nano_params()
    path = str(tmp_path / "ckpt")
    saved = ranks.launch("prog_save", 2, path, np_params)
    assert saved[0] == saved[1] == str(tmp_path / "ckpt" / "step_3")
    outs = ranks.launch("prog_restore", 4, path)
    want = dict(_flat(np_params))
    axes = dict(_flat(tg.gpt2_logical_axes(tg.gpt2_config("nano"))))
    for out in outs:
        # data=2 x fsdp=2: embed dims split in two, by the fsdp index
        f = out["coords"]["fsdp"]
        for name, w in want.items():
            block = w
            if "embed" in axes[name]:
                dim = list(axes[name]).index("embed")
                half = w.shape[dim] // 2
                block = np.take(w, range(f * half, (f + 1) * half),
                                axis=dim)
            np.testing.assert_array_equal(dict(_flat(out["params"]))[name],
                                          block, err_msg=name)
        assert "Shard(dim=1)" in out["wte_placements"]
    # the same checkpoint restored whole on one device, no process group
    whole = restore_sharded(path, step=3, device="cpu")
    for name, t in _flat(whole):
        np.testing.assert_array_equal(t.numpy(), want[name], err_msg=name)


# -- the declared group over the port's runtime -----------------------------

class Member:
    """A group member on the port's runtime (unpickled by value: the
    worker imports neither this test module nor JAX)."""

    def __init__(self, rank):
        from ray_tpu_torch.parallel import collective

        collective.init_collective_group(2, rank, group_name="g2")
        self.rank = rank

    def run(self):
        import numpy as np
        import torch

        from ray_tpu_torch.parallel import collective as col

        x = torch.full((4,), float(self.rank + 1))
        out = {"allreduce": col.allreduce(x, group_name="g2"),
               "allreduce_np": col.allreduce(np.full(4, self.rank + 1.0),
                                             group_name="g2"),
               "allgather": torch.stack(col.allgather(x, group_name="g2")),
               "broadcast": col.broadcast(torch.full((2,), float(self.rank)),
                                          src_rank=1, group_name="g2"),
               "reducescatter": col.reducescatter(
                   torch.arange(4.0) * (self.rank + 1), group_name="g2")}
        if self.rank == 0:
            col.send(torch.arange(3.0), 1, group_name="g2")
        else:
            out["recv"] = col.recv(0, group_name="g2", like=x)
        col.barrier(group_name="g2")
        return {k: (v.numpy() if hasattr(v, "numpy") else v)
                for k, v in out.items()}


def test_declared_group_over_the_ports_runtime():
    """Two actors, the JAX package's test_parallel.py pair on the port:
    tensors in, tensors out; the JAX package's group on the same
    arrays for the allreduce and the broadcast."""
    ray_tpu_torch.init(num_cpus=2, num_gpus=0, object_store_memory=2**27)
    try:
        actor = ray_tpu_torch.remote(Member)
        a, b = actor.remote(0), actor.remote(1)
        r0, r1 = ray_tpu_torch.get([a.run.remote(), b.run.remote()],
                                   timeout=WAIT_S)
    finally:
        ray_tpu_torch.shutdown()
    for r in (r0, r1):
        np.testing.assert_allclose(r["allreduce"], np.full(4, 3.0))
        np.testing.assert_allclose(r["allreduce_np"], np.full(4, 3.0))
        np.testing.assert_allclose(r["allgather"],
                                   [np.full(4, 1.0), np.full(4, 2.0)])
        np.testing.assert_allclose(r["broadcast"], np.full(2, 1.0))
    np.testing.assert_allclose(r0["reducescatter"], [0.0, 3.0])
    np.testing.assert_allclose(r1["reducescatter"], [6.0, 9.0])
    np.testing.assert_allclose(r1["recv"], [0.0, 1.0, 2.0])

    ray_tpu.init(num_cpus=2)
    try:
        @ray_tpu.remote
        class JaxMember:
            def __init__(self, rank):
                jcol.init_collective_group(2, rank, group_name="g2")
                self.rank = rank

            def run(self):
                return (jcol.allreduce(np.full(4, self.rank + 1.0),
                                       group_name="g2"),
                        jcol.broadcast(np.full(2, float(self.rank)),
                                       src_rank=1, group_name="g2"))

        ja, jb = JaxMember.remote(0), JaxMember.remote(1)
        (w0, wb0), (w1, wb1) = ray_tpu.get([ja.run.remote(),
                                            jb.run.remote()],
                                           timeout=WAIT_S)
    finally:
        ray_tpu.shutdown()
    np.testing.assert_allclose(r0["allreduce_np"], w0)
    np.testing.assert_allclose(r1["broadcast"], wb1)
