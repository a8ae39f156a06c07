"""The port's Train (``ray_tpu_torch/train/``) against the JAX
package's (``ray_tpu/train/``): tests/test_train.py's trainer tests on
both runtimes, which are up at once.

- The two-worker MLP in "store" mode: each rank's gradients go through
  ``jax_utils.allreduce_gradients`` (the declared collective group);
  both packages start from the same numpy parameters (JAX's init,
  crossed through ``models/convert.py``) and the same data, and the
  port's loss trail and final checkpoint equal JAX's within 1e-5.
- ``_shard_datasets`` for a dict of columns, a list, a callable and a
  Dataset (each package's own ``data``): the same shards.
- A failure that surfaces after one round, and a resume from a
  checkpoint: the same ``Result``.

The slower scenarios (the process group, DDP, a gang restart, the
raises) are in tests/test_torch_train_backends.py; ``fit()`` through
the one-trial Tuner in tests/test_torch_tune_fit.py.
"""

import sys

import cloudpickle
import jax
import numpy as np
import pytest

import ray_tpu
import ray_tpu_torch
from ray_tpu import data as jdata
from ray_tpu import train as jtrain
from ray_tpu.models import mlp as jmlp
from ray_tpu.train import backend_executor as jexec
from ray_tpu_torch import data as tdata
from ray_tpu_torch import train as ttrain
from ray_tpu_torch._private._vendor import cloudpickle as port_cloudpickle
from ray_tpu_torch.train import backend_executor as texec
# autouse: the JAX runtime's loops settle before they stop
from tests.test_torch_jax_teardown import settle_jax_loops  # noqa: F401

# the loops travel by value: neither runtime's workers import this file
port_cloudpickle.register_pickle_by_value(sys.modules[__name__])
cloudpickle.register_pickle_by_value(sys.modules[__name__])

STORE = 128 * 1024 * 1024
#: tests/test_train.py's MLP: 8 inputs, 16 hidden, 3 classes, 64 rows
MLP = dict(in_dim=8, hidden=(16,), n_classes=3)
#: f32, the same arithmetic in another library
TOL = 1e-5


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


def _jax_mlp_loop(config):
    """tests/test_train.py's _mlp_loop from the given numpy init."""
    import jax
    import jax.numpy as jnp

    from ray_tpu.air import session
    from ray_tpu.models import MLPConfig, mlp_loss
    from ray_tpu.train import jax_utils

    cfg = MLPConfig(**config["mlp"])
    params = jax.tree.map(jnp.asarray, config["init"])
    shard = session.get_dataset_shard("train")
    x, y = jnp.asarray(shard["x"]), jnp.asarray(shard["y"])
    grad_fn = jax.jit(jax.value_and_grad(
        lambda p: mlp_loss(p, {"x": x, "y": y}, cfg)))
    lr = config["lr"]
    for step in range(config["steps"]):
        loss, grads = grad_fn(params)
        if session.get_world_size() > 1:
            grads = jax_utils.allreduce_gradients(grads)
        params = jax.tree.map(lambda p, g: p - lr * g, params, grads)
        ckpt = None
        if step == config["steps"] - 1:
            ckpt = {"params": params, "step": step}
        session.report({"loss": float(loss),
                        "rank": session.get_world_rank()}, checkpoint=ckpt)


def _torch_mlp_loop(config):
    """The same loop on the port: autograd and the store allreduce."""
    import torch

    from ray_tpu_torch.air import session
    from ray_tpu_torch.models import (MLPConfig, mlp_loss,
                                      mlp_params_from_numpy)
    from ray_tpu_torch.train import jax_utils
    from ray_tpu_torch.train.optim import (tree_leaves, tree_map,
                                           tree_unflatten)

    cfg = MLPConfig(**config["mlp"])
    params = mlp_params_from_numpy(config["init"], cfg, device="cpu")
    shard = session.get_dataset_shard("train")
    batch = {"x": torch.as_tensor(shard["x"]),
             "y": torch.as_tensor(shard["y"])}
    lr = config["lr"]
    for step in range(config["steps"]):
        live = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
        loss = mlp_loss(tree_unflatten(params, live), batch, cfg)
        grads = tree_unflatten(params, torch.autograd.grad(loss, live))
        if session.get_world_size() > 1:
            grads = jax_utils.allreduce_gradients(grads)
        params = tree_unflatten(params, [
            p - lr * g for p, g in zip(tree_leaves(params),
                                       tree_leaves(grads))])
        ckpt = None
        if step == config["steps"] - 1:
            ckpt = {"params": tree_map(torch.Tensor.detach, params),
                    "step": step}
        session.report({"loss": float(loss),
                        "rank": session.get_world_rank()}, checkpoint=ckpt)


def _mlp_data():
    rng = np.random.RandomState(0)
    x = rng.randn(64, 8).astype(np.float32)
    y = (x @ rng.randn(8, 3)).argmax(axis=1)
    init = jax.tree_util.tree_map(np.asarray, jmlp.mlp_init(
        jax.random.PRNGKey(0), jmlp.MLPConfig(**MLP)))
    return x, y, init


def test_two_worker_mlp_in_store_mode_matches_jax(runtimes):
    x, y, init = _mlp_data()
    results = {}
    for name, loop in (("jax", _jax_mlp_loop), ("torch", _torch_mlp_loop)):
        train = runtimes[name]
        results[name] = train.JaxTrainer(
            loop, train_loop_config={"lr": 0.3, "steps": 5, "init": init,
                                     "mlp": MLP},
            jax_config=train.JaxConfig(distributed="store"),
            scaling_config=train.ScalingConfig(num_workers=2),
            datasets={"train": {"x": x, "y": y}}).fit()
    got, want = results["torch"], results["jax"]
    assert got.error is None, got.error
    assert want.error is None, want.error
    assert len(got.metrics_history) == 5
    for g, w in zip(got.metrics_history, want.metrics_history):
        assert {k: g[k] for k in ("rank", "_round", "training_iteration")} \
            == {k: w[k] for k in ("rank", "_round", "training_iteration")}
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=TOL)
    assert got.metrics_history[-1]["loss"] < got.metrics_history[0]["loss"]
    ck, jck = got.checkpoint.to_dict(), want.checkpoint.to_dict()
    assert ck["step"] == jck["step"] == 4
    for g, w in zip(jax.tree_util.tree_leaves(ck["params"]),
                    jax.tree_util.tree_leaves(jck["params"])):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=TOL,
                                   atol=TOL)


def _mesh_loop(config):
    from ray_tpu_torch.air import session
    from ray_tpu_torch.parallel.mesh import mesh_shape
    from ray_tpu_torch.train import jax_utils

    session.report({"shape": mesh_shape(jax_utils.get_mesh()),
                    "rank": session.get_world_rank()})


def test_scaling_config_mesh_lays_the_workers_mesh(runtimes):
    """ScalingConfig(mesh=) is the spec jax_utils.get_mesh() lays over
    the workers' process group ("jax" mode, gloo on the CPU): seq=2
    where the default would be data=2.  topology is stored only."""
    from ray_tpu_torch.parallel import MeshSpec

    train = runtimes["torch"]
    sc = train.ScalingConfig(num_workers=2, topology="v5e-8",
                             mesh=MeshSpec(seq=2))
    got = train.JaxTrainer(_mesh_loop,
                           jax_config=train.JaxConfig(distributed="jax"),
                           scaling_config=sc).fit()
    assert got.error is None, got.error
    assert got.metrics["shape"] == {"pipeline": 1, "data": 1, "fsdp": 1,
                                    "expert": 1, "seq": 2, "tensor": 1}
    assert sc.topology == "v5e-8"


def _shards(pkg, kind, data):
    execs = {"jax": jexec, "torch": texec}
    if kind == "dict":
        ds = {"x": np.arange(10), "y": np.arange(10) * 2}
    elif kind == "list":
        ds = list(range(11))
    elif kind == "callable":
        ds = lambda rank, world: {"rank": rank, "world": world}  # noqa
    else:
        ds = data.from_items([{"v": i} for i in range(12)], parallelism=4)
    out = execs[pkg]._shard_datasets({"train": ds, "extra": ds}, 3)
    if kind == "dataset":
        return [{k: sorted(r["v"] for r in v.take_all())
                 for k, v in s.items()} for s in out]
    return out


@pytest.mark.parametrize("kind", ["dict", "list", "callable", "dataset"])
def test_shard_datasets_matches_jax(runtimes, kind):
    got = _shards("torch", kind, tdata)
    want = _shards("jax", kind, jdata)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w) == ["extra", "train"]
        for k in g:
            if kind == "dict":
                assert sorted(g[k]) == sorted(w[k])
                for col in g[k]:
                    np.testing.assert_array_equal(g[k][col], w[k][col])
            else:
                assert g[k] == w[k]


def _failing_loop(config):
    import importlib

    session = importlib.import_module(config["session"])
    session.report({"ok": 1})
    if session.get_world_rank() == 0:
        raise ValueError("boom at rank 0")
    session.report({"ok": 2})


def _resume_loop(config):
    import importlib

    session = importlib.import_module(config["session"])
    ck = session.get_checkpoint()
    start = ck.to_dict()["step"] + 1 if ck is not None else 0
    shard = session.get_dataset_shard("train")
    session.report({"resumed_from": start, "n": len(shard["x"])})


@pytest.mark.parametrize("case", ["failure_after_one_round",
                                  "resume_from_checkpoint"])
def test_result_matches_jax(runtimes, case):
    """tests/test_train.py's test_worker_failure_surfaces_in_result and
    test_resume_from_checkpoint (with a dict-of-arrays dataset) in both
    packages."""
    results = {}
    for name, train in runtimes.items():
        # each package's workers import only their own session module
        loop_cfg = {"session": f"{train.__name__.split('.')[0]}.air.session"}
        if case == "failure_after_one_round":
            trainer = train.DataParallelTrainer(
                _failing_loop, train_loop_config=loop_cfg,
                scaling_config=train.ScalingConfig(num_workers=2),
                run_config=train.RunConfig(
                    failure_config=train.FailureConfig(max_failures=0)))
        else:
            trainer = train.DataParallelTrainer(
                _resume_loop, train_loop_config=loop_cfg,
                scaling_config=train.ScalingConfig(num_workers=1),
                datasets={"train": {"x": np.arange(10)}},
                resume_from_checkpoint=train.Checkpoint.from_dict(
                    {"step": 7}))
        results[name] = trainer.fit()
    got, want = results["torch"], results["jax"]
    assert got.metrics_history == want.metrics_history
    assert len(got.metrics_history) == 1
    if case == "failure_after_one_round":
        assert "boom at rank 0" in str(got.error)
        assert type(got.error).__name__ == type(want.error).__name__
    else:
        assert got.error is None and want.error is None
        assert got.metrics["resumed_from"] == 8 and got.metrics["n"] == 10
