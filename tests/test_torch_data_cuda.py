"""The Data layer's batches on the card and a BatchPredictor on a GPU
actor pool.

Needs an NVIDIA GPU: every test here is marked ``cuda`` and skips with
a reason where ``torch.cuda.is_available()`` is false.  This file
imports no JAX, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_data_cuda.py
"""

import importlib
import sys

import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch import air, data
from ray_tpu_torch._private._vendor import cloudpickle as port_cloudpickle

port_cloudpickle.register_pickle_by_value(sys.modules[__name__])

WAIT_S = 120


@pytest.fixture(scope="module")
def runtime():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA): the batches land on the "
                    "card and the predictor's actor holds it")
    ray_tpu_torch.init(num_cpus=2, num_gpus=1,
                       object_store_memory=512 * 1024 * 1024,
                       log_to_driver=False)
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


@pytest.mark.cuda
def test_iter_torch_batches_lands_on_the_card_bit_for_bit(runtime):
    tokens = np.random.default_rng(3).integers(
        0, 50257, (96, 129)).astype(np.int32)
    ds = data.from_numpy({"tokens": tokens, "w": tokens[:, 0] * 0.5},
                         parallelism=4).random_shuffle(seed=0)
    want = list(ds.iter_batches(batch_size=24, drop_last=True))
    got = list(ds.iter_torch_batches(batch_size=24, drop_last=True,
                                     dtypes={"w": torch.bfloat16}))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g["tokens"].device == torch.device("cuda:0")
        assert g["tokens"].dtype == torch.int32
        assert torch.equal(g["tokens"].cpu(), torch.from_numpy(w["tokens"]))
        assert g["w"].dtype == torch.bfloat16 and g["w"].is_cuda
        assert torch.equal(g["w"], torch.from_numpy(w["w"]).cuda().bfloat16())


class NanoPredictor(air.Predictor):
    """GPT-2 nano's next token from a checkpoint's parameters, on the
    card its actor was granted; it reports its process's flash forward
    launches beside each row."""

    def __init__(self, params, cfg):
        self.params, self.cfg = params, cfg
        self.fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")
        self.fa.FLASH_FWD_LAUNCHES = 0

    @classmethod
    def from_checkpoint(cls, ckpt):
        import os

        from ray_tpu_torch import resolve_device
        from ray_tpu_torch.models.gpt2 import gpt2_config
        from ray_tpu_torch.train.optim import tree_map

        if not os.environ.get("CUDA_VISIBLE_DEVICES"):
            raise RuntimeError("the predictor's actor holds no card")
        dev = resolve_device(None)
        return cls(tree_map(lambda x: x.to(dev), ckpt.to_dict()["params"]),
                   gpt2_config("nano", max_seq=128))

    def next_tokens(self, tokens):
        from ray_tpu_torch.models.gpt2_decode import prefill

        with torch.inference_mode():
            logits, _ = prefill(self.params, torch.as_tensor(tokens).cuda(),
                                self.cfg)
            return logits[:, :self.cfg.vocab_size].argmax(-1).cpu().numpy()

    def predict(self, batch):
        import os

        nxt = self.next_tokens(batch["tokens"])
        return {"next": nxt, "pid": np.full(len(nxt), os.getpid()),
                "flash": np.full(len(nxt), self.fa.FLASH_FWD_LAUNCHES)}


@pytest.mark.cuda
def test_nano_batch_predictor_on_a_gpu_actor(runtime):
    from ray_tpu_torch.models.gpt2 import gpt2_config, gpt2_init

    cfg = gpt2_config("nano", max_seq=128)
    params = gpt2_init(cfg, torch.Generator().manual_seed(0), device="cpu")
    ckpt = air.Checkpoint.from_dict({"params": params})
    prompts = np.random.default_rng(4).integers(
        0, cfg.vocab_size, (32, 64)).astype(np.int32)
    rows = air.BatchPredictor.from_checkpoint(ckpt, NanoPredictor).predict(
        data.from_numpy({"tokens": prompts}, parallelism=4),
        compute=data.ActorPoolStrategy(size=1, num_gpus=1)).take_all()
    assert len(rows) == 32 and len({r["pid"] for r in rows}) == 1
    # the actor's flash forwards: n_layer a batch, 4 batches
    assert max(r["flash"] for r in rows) == cfg.n_layer * 4
    from ray_tpu_torch.train.optim import tree_map

    mine = NanoPredictor(tree_map(lambda x: x.cuda(), params), cfg)
    want = np.concatenate([mine.next_tokens(prompts[i:i + 8])
                           for i in range(0, 32, 8)])
    np.testing.assert_array_equal([r["next"] for r in rows], want)
