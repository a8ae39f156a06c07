"""The train step's telemetry on the card adds no device sync, and the
health fence adds exactly one.

Needs an NVIDIA GPU: every test here is marked ``cuda`` and skips with
a reason where ``torch.cuda.is_available()`` is false.  This file
imports no JAX, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_trainwatch_cuda.py
"""

import warnings

import pytest
import torch

from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.train import adamw, build_train_step, train_stats


#: the warning torch.cuda.set_sync_debug_mode("warn") gives for each
#: synchronising call (its first use also warns that the mode is a
#: prototype, which is not a sync)
SYNC_WARNING = "called a synchronizing CUDA operation"


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA); the sync counts are the "
                    "card's")
    return torch.device("cuda")


def _syncs(fn, n=2) -> int:
    """Synchronising CUDA calls made by ``n`` calls of ``fn`` (warned
    under torch.cuda.set_sync_debug_mode)."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for _ in range(n):
                fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return sum(SYNC_WARNING in str(w.message) for w in caught)


@pytest.mark.cuda
def test_telemetry_adds_no_sync_and_the_fence_one(cuda_device):
    cfg = tl.llama_config("nano", n_layer=2)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    params = tl.llama_init(cfg, gen, cuda_device)
    tx = adamw(3e-4, weight_decay=0.1)
    state = tx.init(params)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (4, 65),
                                     generator=gen, device=cuda_device)}
    loss_fn = lambda p, b: tl.llama_loss(p, b, cfg)  # noqa: E731
    steps = {
        "raw": build_train_step(loss_fn, tx, telemetry=False),
        "telemetry": build_train_step(loss_fn, tx,
                                      telemetry_name="tcu_tel"),
        "raw_health": build_train_step(loss_fn, tx, telemetry=False,
                                       health=True),
        "health": build_train_step(loss_fn, tx, health=True,
                                   telemetry_name="tcu_health"),
    }
    for step in steps.values():       # each signature's first call
        step(params, state, batch)
    torch.cuda.synchronize()
    n = 2
    syncs = {k: _syncs(lambda s=s: s(params, state, batch), n)
             for k, s in steps.items()}
    torch.cuda.synchronize()
    assert syncs["telemetry"] == syncs["raw"], syncs
    assert syncs["health"] == syncs["raw_health"] + n, syncs
    st = train_stats("tcu_health")
    assert st["health"]["observed"] == n + 1
    assert st["health"]["anomalies"] == 0
    assert train_stats("tcu_tel")["health"]["observed"] == 0
