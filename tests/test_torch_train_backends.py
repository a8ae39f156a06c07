"""The port's Train backends on its runtime: TorchTrainer's DDP over
gloo against the JAX package's, ``JaxConfig(distributed="jax")`` over two
gloo workers (a mesh across both, whose sharded step equals the
unsharded one), the "auto"/"store" modes, a gang restart after a
worker's process dies, and the raises.

The JAX package runs only TorchTrainer here (both packages' workers
run the same torch loop, tests/test_train.py::test_torch_trainer_
ddp_gloo); its other backends have no counterpart to compare with on
the CPU: "jax" mode calls ``jax.distributed.initialize``, and a dead
worker escapes its ``fit()`` as ActorDiedError, with no restart.
"""

import importlib
import sys

import cloudpickle
import jax
import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu_torch
from ray_tpu import train as jtrain
from ray_tpu.models import gpt2 as jg
from ray_tpu_torch import train as ttrain
from ray_tpu_torch import tune as ttune
from ray_tpu_torch._private._vendor import cloudpickle as port_cloudpickle
from ray_tpu_torch.models import gpt2 as tg
from ray_tpu_torch.models.convert import gpt2_params_from_numpy
from ray_tpu_torch.train._internal.worker_group import WorkerGroup
from ray_tpu_torch.train.jax_backend import JaxBackend
from ray_tpu_torch.train.optim import tree_leaves
# autouse: the JAX runtime's loops settle before they stop
from tests.test_torch_jax_teardown import settle_jax_loops  # noqa: F401

port_cloudpickle.register_pickle_by_value(sys.modules[__name__])
cloudpickle.register_pickle_by_value(sys.modules[__name__])

STORE = 128 * 1024 * 1024
WAIT_S = 120
KV = "test_torch_train_backends:"
#: tests/test_torch_parallel.py's tolerances for a sharded AdamW step
LOSS_TOL = PARAM_TOL = 1e-5
MESH_LR = 3e-4


@pytest.fixture(scope="module")
def runtimes(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    mp.setenv("RAYTPU_RESULTS_DIR", str(tmp_path_factory.mktemp("results")))
    ray_tpu.init(num_cpus=4, object_store_memory=STORE, log_to_driver=False)
    ray_tpu_torch.init(num_cpus=4, num_gpus=0, object_store_memory=STORE,
                       log_to_driver=False)
    yield {"jax": jtrain, "torch": ttrain}
    ray_tpu_torch.shutdown()
    ray_tpu.shutdown()
    mp.undo()


def _ddp_loop(config):
    """tests/test_train.py::test_torch_trainer_ddp_gloo's loop, with the
    package's prepare_model and session."""
    import importlib

    import torch
    import torch.distributed as dist

    train = importlib.import_module(f"{config['pkg']}.train")
    session = importlib.import_module(f"{config['pkg']}.air.session")
    torch.manual_seed(0)
    model = train.prepare_model(torch.nn.Linear(4, 1))
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    x = torch.randn(32, 4, generator=torch.Generator().manual_seed(
        session.get_world_rank()))
    y = x.sum(dim=1, keepdim=True)
    for _ in range(5):
        opt.zero_grad()
        loss = torch.nn.functional.mse_loss(model(x), y)
        loss.backward()
        opt.step()
    flat = torch.cat([p.detach().reshape(-1) for p in model.parameters()])
    gathered = [torch.zeros_like(flat) for _ in range(dist.get_world_size())]
    dist.all_gather(gathered, flat)
    import os

    session.report({"loss": float(loss), "world": dist.get_world_size(),
                    "sync_ok": all(torch.equal(g, gathered[0])
                                   for g in gathered),
                    "params": flat.tolist(),
                    "env": [os.environ.get(k) for k in (
                        "RANK", "WORLD_SIZE", "LOCAL_RANK",
                        "LOCAL_WORLD_SIZE")]})


def test_torch_trainer_ddp_over_gloo_matches_jax(runtimes):
    results = {}
    for name, train in runtimes.items():
        pkg = train.__name__.split(".")[0]
        results[name] = train.TorchTrainer(
            _ddp_loop, train_loop_config={"pkg": pkg},
            scaling_config=train.ScalingConfig(num_workers=2)).fit()
    got, want = results["torch"], results["jax"]
    assert got.error is None, got.error
    assert want.error is None, want.error
    assert got.metrics["sync_ok"] is True and got.metrics["world"] == 2
    assert got.metrics["loss"] < 1.0
    assert got.metrics["env"] == ["0", "2", "0", "2"]
    assert got.metrics_history == want.metrics_history


def _nano():
    jcfg = jg.gpt2_config("nano", dtype=jax.numpy.float32)
    init = jax.tree_util.tree_map(np.asarray, jg.gpt2_init(
        jax.random.PRNGKey(0), jcfg))
    tokens = np.random.default_rng(1).integers(
        0, jcfg.vocab_size, (4, 33)).astype(np.int32)
    return init, tokens


def _mesh_loop(config):
    """GPT-2 nano on the mesh of the workers' process group: two AdamW
    steps of the sharded step, the parameters after the first gathered
    into rank 0's checkpoint."""
    import torch
    import torch.distributed as dist

    from ray_tpu_torch.air import session
    from ray_tpu_torch.models import gpt2 as tg
    from ray_tpu_torch.models.convert import gpt2_params_from_numpy
    from ray_tpu_torch.parallel.mesh import mesh_shape
    from ray_tpu_torch.parallel.sharding import gather_params
    from ray_tpu_torch.train import adamw, jax_utils

    cfg = tg.gpt2_config("nano", dtype=torch.float32)
    axes = tg.gpt2_logical_axes(cfg)
    mesh = jax_utils.get_mesh()
    plain = gpt2_params_from_numpy(config["init"], cfg, device="cpu")
    params = jax_utils.shard_pytree(plain, axes, mesh)
    tx = adamw(config["lr"], weight_decay=0.1)
    opt = tx.init(plain)
    step = jax_utils.build_train_step(lambda p, b: tg.gpt2_loss(p, b, cfg),
                                      tx, mesh, axes)
    batch = {"tokens": torch.from_numpy(config["tokens"])}
    for i in range(2):
        params, opt, loss = step(params, opt, batch)
        whole = gather_params(params) if i == 0 else None
        session.report(
            {"loss": float(loss), "rank": session.get_world_rank(),
             "world": dist.get_world_size(),
             "backend": str(dist.get_backend()), "mesh": mesh_shape(mesh),
             "wte_local_rows": params["wte"].to_local().shape[0],
             "steps": jax_utils.train_stats()["steps"]},
            checkpoint={"params": whole} if whole is not None
            and session.get_world_rank() == 0 else None)


def test_jax_mode_meshes_two_gloo_workers_and_equals_the_unsharded_step(
        runtimes):
    init, tokens = _nano()
    res = ttrain.JaxTrainer(
        _mesh_loop, train_loop_config={"init": init, "tokens": tokens,
                                       "lr": MESH_LR},
        jax_config=ttrain.JaxConfig(distributed="jax"),
        scaling_config=ttrain.ScalingConfig(num_workers=2)).fit()
    assert res.error is None, res.error
    hist = res.metrics_history
    assert len(hist) == 2
    m = hist[0]
    assert (m["world"], m["backend"]) == (2, "gloo")
    assert m["mesh"]["data"] == 2 and all(
        v == 1 for k, v in m["mesh"].items() if k != "data")
    # the step the trainer's default telemetry recorded in the worker
    assert [h["steps"] for h in hist] == [1, 2]
    # the unsharded step, here, from the same start on the same batch
    cfg = tg.gpt2_config("nano", dtype=torch.float32)
    params = gpt2_params_from_numpy(init, cfg, device="cpu")
    tx = ttrain.adamw(MESH_LR, weight_decay=0.1)
    opt = tx.init(params)
    step = ttrain.build_train_step(lambda p, b: tg.gpt2_loss(p, b, cfg), tx,
                                   telemetry=False)
    batch = {"tokens": torch.from_numpy(tokens)}
    losses = []
    for i in range(2):
        params, opt, loss = step(params, opt, batch)
        losses.append(float(loss))
        if i == 0:
            after_one = [t.clone() for t in tree_leaves(params)]
    np.testing.assert_allclose([h["loss"] for h in hist], losses,
                               rtol=LOSS_TOL)
    got = tree_leaves(res.checkpoint.to_dict()["params"])
    assert len(got) == len(after_one)
    for g, w in zip(got, after_one):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=PARAM_TOL,
                                   atol=PARAM_TOL)


def _is_member(group):
    from ray_tpu_torch.parallel import collective

    return collective.is_group_initialized(group)


def test_auto_mode_picks_store_for_two_cpu_workers_and_none_for_one(
        runtimes):
    """jax_backend.py:96-102's rule: "store" for several workers without
    cards (a declared group in each, torn down at shutdown), "none" for
    one."""
    for n, mode in ((2, "store"), (1, "none")):
        group = WorkerGroup(n, {"CPU": 1})
        try:
            backend = JaxBackend()
            cfg = ttrain.JaxConfig(group_name=f"auto_{n}")
            backend.on_start(group, cfg)
            assert backend.mode == mode
            assert group.execute(_is_member, f"auto_{n}") == [n > 1] * n
            backend.on_shutdown(group, cfg)
            assert group.execute(_is_member, f"auto_{n}") == [False] * n
        finally:
            group.shutdown()


def _dying_loop(config):
    """Reports step i with its checkpoint; rank 1's process exits
    before step 2 the first time (its marker in the cluster KV).

    It exits only once the executor has collected round 1: ``report``
    returns when the worker's ``next_result`` releases it, before that
    call's reply has left the process, so an exit right after
    ``report(i=1)`` can lose round 1's reply, and the executor then
    rightly restarts from round 0.  Rank 1 waits instead (in the KV,
    with a limit) for rank 0's mark, written after its own
    ``report(i=2)`` returned: the executor asks for round 2 only after
    it holds round 1 from every rank."""
    import os
    import time

    from ray_tpu_torch._private import worker_context
    from ray_tpu_torch.air import session

    cw = worker_context.core_worker()
    ck = session.get_checkpoint()
    start = ck.to_dict()["i"] + 1 if ck is not None else 0
    rank = session.get_world_rank()
    for i in range(start, 4):
        if i == 2 and rank == 1 and \
                cw.kv_get(f"{config['kv']}died") is None:
            deadline = time.monotonic() + WAIT_S
            while cw.kv_get(f"{config['kv']}round2") is None:
                if time.monotonic() > deadline:
                    raise TimeoutError("rank 0 never reported round 2")
                time.sleep(0.01)
            cw.kv_put(f"{config['kv']}died", str(os.getpid()).encode())
            os._exit(1)
        session.report({"i": i, "pid": os.getpid(), "rank": rank},
                       checkpoint={"i": i})
        if i == 2 and rank == 0:
            cw.kv_put(f"{config['kv']}round2", b"1")


def test_a_dead_worker_restarts_the_gang_from_the_latest_checkpoint(
        runtimes):
    res = ttrain.DataParallelTrainer(
        _dying_loop, train_loop_config={"kv": KV},
        scaling_config=ttrain.ScalingConfig(num_workers=2),
        run_config=ttrain.RunConfig(
            failure_config=ttrain.FailureConfig(max_failures=1))).fit()
    assert res.error is None, res.error
    hist = res.metrics_history
    assert [m["i"] for m in hist] == [0, 1, 2, 3]
    assert [m["_round"] for m in hist] == [0, 1, 2, 3]
    assert [m["training_iteration"] for m in hist] == [1, 2, 3, 4]
    assert hist[0]["pid"] == hist[1]["pid"] != hist[2]["pid"] == \
        hist[3]["pid"]
    assert res.checkpoint.to_dict() == {"i": 3}
    # without a restart allowed, the death is the result's error
    res = ttrain.DataParallelTrainer(
        _dying_loop, train_loop_config={"kv": KV + "again:"},
        scaling_config=ttrain.ScalingConfig(num_workers=2)).fit()
    assert isinstance(res.error, ttrain.TrainingWorkerError)
    assert "process died" in str(res.error)
    assert [m["i"] for m in res.metrics_history] == [0, 1]


def test_unported_and_foreign_options_raise(runtimes):
    with pytest.raises(ValueError, match="no counterpart"):
        ttrain.JaxConfig(virtual_devices=8)
    with pytest.raises(ValueError, match="distributed='bogus'"):
        ttrain.JaxConfig(distributed="bogus")
    for name in ("GBDTTrainer", "GBDTModel", "XGBoostTrainer",
                 "LightGBMTrainer", "HuggingFaceTrainer"):
        with pytest.raises(NotImplementedError, match=r"item 7\.8b"):
            getattr(ttrain, name)(lambda config: None)
    with pytest.raises(NotImplementedError, match=r"item 7\.13 \(b\)"):
        ttune.Tuner("DQN")
    with pytest.raises(ValueError, match="num_tpus is the JAX package's"):
        WorkerGroup(1, {"CPU": 1, "TPU": 1})
    grid = ttune.Tuner(lambda config: None,
                       resources_per_trial={"CPU": 1, "TPU": 1}).fit()
    assert len(grid.errors) == 1
    assert "num_tpus is the JAX package's" in str(grid.errors[0])
    # the trainer's own TPU key: the error surfaces in the Result
    res = ttrain.DataParallelTrainer(
        lambda config: None, scaling_config=ttrain.ScalingConfig(
            num_workers=1, resources_per_worker={"TPU": 1})).fit()
    assert "num_tpus is the JAX package's" in str(res.error)
    assert importlib.import_module("ray_tpu_torch.train").GBDT_HF_ITEM
