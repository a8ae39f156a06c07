"""Timing of the GPT-2 training step on one card: counterpart of
``bench.py:312 time_config``.

    from ray_tpu_torch.bench import time_config
    tok_s, mfu, loss, n_chips, cost = time_config(24, seq=1024, n_steps=20)

Eager PyTorch, one device: the JAX version's meshes over several chips
wait for ROADMAP.md queue 1 item 7 (parallel/).  MFU is stated against
one NVIDIA H100 SXM's dense bf16 peak, 989 TFLOP/s (NVIDIA's data
sheet, at 700 W); a run off the card reports no MFU.
"""

from __future__ import annotations

import time
from typing import Optional

import torch

from ray_tpu_torch._private.device_stats import H100_SXM
from ray_tpu_torch.device import DeviceLike, resolve_device
from ray_tpu_torch.models.gpt2 import (gpt2_config, gpt2_init, gpt2_loss,
                                       gpt2_param_count)
from ray_tpu_torch.train.optim import adamw
from ray_tpu_torch.train.trainer import build_train_step

#: dense bf16 peak of one NVIDIA H100 SXM (data sheet, at 700 W), from
#: the one table of the card's peak rates
H100_BF16_PEAK_FLOPS = H100_SXM["bf16_flops"]


def time_config(batch: int, seq: int = 1024, n_steps: int = 20,
                preset: str = "gpt2", mesh: str = "data",
                n_devices: int = 0, device: DeviceLike = None,
                **overrides):
    """Time ``n_steps`` AdamW steps (``adamw(3e-4, weight_decay=0.1)``
    as ``bench.py:351``) of GPT-2 ``preset`` on a repeated batch of
    seeded random tokens, after one warm-up step.

    Returns (tok_s_per_chip, mfu, final_loss, n_chips, cost) as the
    JAX version does.  ``mfu`` = 6 * params * tokens/s / 989e12, None
    off the card.  ``cost`` holds ``model_flops`` (6 * params *
    tokens per step), ``peak_flops``, ``device``, ``steps_run``
    (warm-up included), ``step_ms`` (the mean of the timed steps) and
    ``losses`` (every step's loss, read after the timed loop so the
    loop has no host sync).

    Only ``mesh="data"`` over one device is ported; other meshes and
    ``n_devices > 1`` raise NotImplementedError naming ROADMAP.md queue
    1 item 7."""
    if mesh != "data" or n_devices > 1:
        raise NotImplementedError(
            f"mesh={mesh!r} over n_devices={n_devices} is not ported yet: "
            f"ROADMAP.md queue 1 item 7 (parallel/); the port times one "
            f"device")
    dev = resolve_device(device)
    cfg = gpt2_config(preset, max_seq=seq, **overrides)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = gpt2_init(cfg, gen, device=dev)
    tx = adamw(3e-4, weight_decay=0.1)
    opt_state = tx.init(params)
    step = build_train_step(lambda p, b: gpt2_loss(p, b, cfg), tx)
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq + 1),
                           generator=gen, device=dev)
    data = {"tokens": tokens}

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    params, opt_state, loss = step(params, opt_state, data)
    losses = [loss]
    sync()
    t0 = time.perf_counter()
    for _ in range(n_steps):
        params, opt_state, loss = step(params, opt_state, data)
        losses.append(loss)
    sync()
    dt = time.perf_counter() - t0

    n_params = gpt2_param_count(cfg)
    tok_s = batch * seq * n_steps / dt
    on_card = dev.type == "cuda"
    mfu: Optional[float] = (6 * n_params * tok_s / H100_BF16_PEAK_FLOPS
                            if on_card else None)
    cost = {"model_flops": float(6 * n_params * batch * seq),
            "peak_flops": H100_BF16_PEAK_FLOPS if on_card else None,
            "device": (torch.cuda.get_device_name(dev) if on_card
                       else str(dev)),
            "steps_run": n_steps + 1,
            "step_ms": dt / n_steps * 1e3,
            "losses": [float(x) for x in losses]}
    return tok_s, mfu, cost["losses"][-1], 1, cost
