"""Timing of the GPT-2 training step on one card: counterparts of
``bench.py:312 time_config`` (a raw step loop) and ``bench.py:1094
main_train_watch`` (the instrumented step, ``--train``).

    from ray_tpu_torch.bench import time_config, train_watch
    tok_s, mfu, loss, n_chips, cost = time_config(24, seq=1024, n_steps=20)
    records = train_watch()   # train_goodput, train_data_wait_ms_p50/p99

Eager PyTorch, one device: the JAX version's meshes over several chips
wait for ROADMAP.md queue 1 item 7 (parallel/).  MFU is stated against
one NVIDIA H100 SXM's dense bf16 peak, 989 TFLOP/s (NVIDIA's data
sheet, at 700 W); a run off the card reports no MFU.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ray_tpu_torch._private.device_stats import H100_SXM, get_registry
from ray_tpu_torch.device import DeviceLike, resolve_device
from ray_tpu_torch.models.gpt2 import (gpt2_config, gpt2_init, gpt2_loss,
                                       gpt2_param_count)
from ray_tpu_torch.train import goodput as gp
from ray_tpu_torch.train.optim import adamw
from ray_tpu_torch.train.telemetry import train_stats
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
    (warm-up included), ``step_ms`` (the mean of the timed steps),
    ``compile_seconds`` (the warm-up step's wall) and ``losses``
    (every step's loss, read after the timed loop so the loop has no
    host sync).

    The step is the raw one (``telemetry=False``), as the JAX version
    times a raw jit; it books ``bench.train_step`` into the program
    registry as ``bench.py:392`` and ``:425-426`` do: one compile event
    for the warm-up step, then one invoke of dt / n_steps per timed
    step.

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
    step = build_train_step(lambda p, b: gpt2_loss(p, b, cfg), tx,
                            telemetry=False)
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq + 1),
                           generator=gen, device=dev)
    data = {"tokens": tokens}

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    reg = get_registry()
    t_c0 = time.perf_counter()
    params, opt_state, loss = step(params, opt_state, data)
    losses = [loss]
    sync()
    compile_s = time.perf_counter() - t_c0
    reg.record_compile("bench.train_step", compile_s)
    t0 = time.perf_counter()
    for _ in range(n_steps):
        params, opt_state, loss = step(params, opt_state, data)
        losses.append(loss)
    sync()
    dt = time.perf_counter() - t0
    for _ in range(n_steps):
        reg.record_invoke("bench.train_step", dt / max(1, n_steps))

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
            "compile_seconds": round(compile_s, 3),
            "losses": [float(x) for x in losses]}
    return tok_s, mfu, cost["losses"][-1], 1, cost


def train_watch(preset: str = "gpt2", batch: int = 8, seq: int = 1024,
                n_steps: int = 20, device: DeviceLike = None
                ) -> List[Dict[str, Any]]:
    """The trainwatch goodput bench (``bench.py:1094
    main_train_watch``, at its TPU configuration by default): the
    instrumented step ``build_train_step(health=True,
    telemetry_name="bench_train")`` fed by a data-wait-probed iterator
    of seeded numpy int32 batches, ``n_steps + 1`` calls (the first
    pays the signature's one-time costs).  Returns the three records
    the JAX bench emits: ``train_goodput`` (productive device time over
    loop wall) and ``train_data_wait_ms_p50``/``_p99``, with their
    ``detail`` keys.  Health mode fences every step, so the device leg
    is device time."""
    dev = resolve_device(device)
    cfg = gpt2_config(preset, max_seq=seq)
    trainer = "bench_train"
    params = gpt2_init(cfg, torch.Generator(device=dev).manual_seed(0),
                       device=dev)
    tx = adamw(3e-4, weight_decay=0.1)
    opt_state = tx.init(params)
    step = build_train_step(lambda p, b: gpt2_loss(p, b, cfg), tx,
                            health=True, telemetry_name=trainer)
    rng = np.random.RandomState(0)

    def batches():
        while True:
            yield {"tokens": rng.randint(
                0, cfg.vocab_size, size=(batch, seq + 1)).astype(np.int32)}

    it = gp.watch_data(batches(), trainer=trainer)
    tracker = gp.get_goodput_tracker(trainer)
    loss = None
    for _ in range(n_steps + 1):
        data = next(it)
        # the batch's copy to the device, timed into the next step's
        # h2d leg: in JAX it hides inside the jitted call
        t0 = time.perf_counter()
        data = {"tokens": torch.from_numpy(data["tokens"]).to(dev)}
        tracker.note_h2d(time.perf_counter() - t0)
        params, opt_state, loss, _health = step(params, opt_state, data)
    stats = train_stats(trainer)
    anatomy = stats["anatomy"]
    detail = {
        "chips": 1, "batch": batch, "seq": seq,
        "preset": preset, "steps": stats["goodput"]["steps"],
        "goodput": stats["goodput"],
        "anatomy_mean_ms": {k: (anatomy[k] or {}).get("mean")
                            for k in anatomy},
        "anomalies": stats["health"]["anomalies"],
        "loss": round(float(loss), 3) if loss is not None else None,
        "backend": dev.type,
        "tpu_error": None,   # the JAX key; the port probes no TPU
    }
    records = [{"metric": "train_goodput",
                "value": stats["goodput"]["ratio"], "unit": "ratio",
                "vs_baseline": None, "detail": detail}]
    dw = anatomy["data_wait_ms"]
    for q in ("p50", "p99"):
        records.append({"metric": f"train_data_wait_ms_{q}",
                        "value": dw[q], "unit": "ms", "vs_baseline": None,
                        "detail": {"count": dw["count"], "preset": preset,
                                   "backend": dev.type}})
    return records
