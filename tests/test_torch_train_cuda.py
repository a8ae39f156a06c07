"""Train on the card: a train worker granted the card through
``ScalingConfig(use_gpu=True)``, a gang restart that grants it to a new
worker, and a trial actor that holds no CUDA context.

Needs an NVIDIA GPU: every test here is marked ``cuda`` and skips with
a reason where ``torch.cuda.is_available()`` is false.  This file
imports no JAX, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_train_cuda.py
"""

import json
import sys

import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch._private._vendor import cloudpickle as port_cloudpickle
from ray_tpu_torch.air.config import FailureConfig, RunConfig
from ray_tpu_torch.train import JaxConfig, JaxTrainer, ScalingConfig

port_cloudpickle.register_pickle_by_value(sys.modules[__name__])

KV = "test_torch_train_cuda:"
STEPS = 4


@pytest.fixture(scope="module")
def runtime(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA): the train worker is "
                    "granted the card")
    mp = pytest.MonkeyPatch()
    mp.setenv("RAYTPU_RESULTS_DIR", str(tmp_path_factory.mktemp("results")))
    ray_tpu_torch.init(num_cpus=2, num_gpus=1,
                       object_store_memory=256 * 1024 * 1024,
                       log_to_driver=False)
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()
    mp.undo()


def _kv():
    from ray_tpu_torch._private import worker_context

    return worker_context.core_worker()


def _book(tag):
    import os

    torch_mod = sys.modules.get("torch")
    _kv().kv_put(f"{KV}{tag}:{os.getpid()}", json.dumps({
        "pid": os.getpid(),
        "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
        "cuda_initialized": bool(torch_mod is not None
                                 and torch_mod.cuda.is_initialized()),
    }).encode())


def _books(tag):
    cw = _kv()
    return [json.loads(cw.kv_get(k)) for k in cw.kv_keys(f"{KV}{tag}:")]


class ProbedTrainer(JaxTrainer):
    """Books the trial actor's CUDA state before and after its loop."""

    def training_loop(self):
        _book("trial")
        try:
            return super().training_loop()
        finally:
            _book("trial")


def _mlp_loop(config):
    """The MLP on the worker's card through the mesh step; a failure
    once after step ``fail_after`` (marker in the KV), resumed from the
    checkpoint of that step."""
    import os

    from ray_tpu_torch.air import session
    from ray_tpu_torch.models import (MLPConfig, mlp_init, mlp_logical_axes,
                                      mlp_loss)
    from ray_tpu_torch.train import adamw, jax_utils
    from ray_tpu_torch.train.optim import tree_map

    import torch.distributed as dist

    cfg = MLPConfig(in_dim=16, hidden=(32,), n_classes=4)
    mesh = jax_utils.get_mesh()
    tx = adamw(1e-2)
    step = jax_utils.build_train_step(lambda p, b: mlp_loss(p, b, cfg), tx,
                                      mesh, mlp_logical_axes(cfg),
                                      telemetry=False)
    ckpt = session.get_checkpoint()
    start = 0
    if ckpt is None:
        params = mlp_init(torch.Generator(device="cuda").manual_seed(0), cfg)
    else:
        state = ckpt.to_dict()
        start = state["step"]
        params = tree_map(lambda t: t.cuda(), state["params"])
    opt = tx.init(params)
    g = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn(64, 16, generator=g, device="cuda")
    batch = {"x": x, "y": x[:, :4].argmax(-1)}
    for i in range(start, STEPS):
        params, opt, loss = step(params, opt, batch)
        leaf = params["layers"][0]["w"]
        whole = {"layers": [{k: v.full_tensor() for k, v in layer.items()}
                            for layer in params["layers"]]}
        session.report(
            {"loss": float(loss), "step": i + 1, "pid": os.getpid(),
             "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
             "device": str(leaf.to_local().device),
             "backend": str(dist.get_backend())},
            checkpoint={"params": whole, "step": i + 1})
        if i + 1 == config.get("fail_after") and \
                _kv().kv_get(f"{KV}failed") is None:
            _kv().kv_put(f"{KV}failed", b"1")
            raise RuntimeError("planted failure")


def _fit(**run):
    return ProbedTrainer(
        _mlp_loop, train_loop_config=run.pop("config", {}),
        jax_config=JaxConfig(distributed="jax"),
        scaling_config=ScalingConfig(num_workers=1, use_gpu=True),
        run_config=RunConfig(**run)).fit()


@pytest.mark.cuda
def test_a_worker_granted_the_card_trains_there(runtime):
    for k in _kv().kv_keys(KV):
        _kv().kv_del(k)
    res = _fit()
    assert res.error is None, res.error
    hist = res.metrics_history
    assert [m["step"] for m in hist] == list(range(1, STEPS + 1))
    assert [m["training_iteration"] for m in hist] == list(
        range(1, STEPS + 1))
    assert {m["device"] for m in hist} == {"cuda:0"}
    assert {m["backend"] for m in hist} == {"nccl"}
    assert all(m["visible"] for m in hist)
    losses = [m["loss"] for m in hist]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    # the checkpoint reached the driver on the host
    ck = res.checkpoint.to_dict()
    assert ck["step"] == STEPS
    assert ck["params"]["layers"][0]["w"].device.type == "cpu"
    # the trial actor that hosted the trainer held no card and no CUDA
    trial = _books("trial")
    assert len(trial) == 1 and trial[0]["pid"] != hist[0]["pid"]
    assert trial[0]["visible"] == "" and not trial[0]["cuda_initialized"]


@pytest.mark.cuda
def test_a_restart_grants_the_card_to_a_new_worker(runtime):
    for k in _kv().kv_keys(KV):
        _kv().kv_del(k)
    res = _fit(config={"fail_after": 2},
               failure_config=FailureConfig(max_failures=1))
    assert res.error is None, res.error
    hist = res.metrics_history
    assert [m["step"] for m in hist] == list(range(1, STEPS + 1))
    pids = [m["pid"] for m in hist]
    assert len(set(pids[:2])) == 1 and len(set(pids[2:])) == 1
    assert pids[0] != pids[2]
    assert all(m["visible"] and m["device"] == "cuda:0" for m in hist)
    assert not any(t["cuda_initialized"] for t in _books("trial"))
