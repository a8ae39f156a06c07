"""MLP classifier — the fashion-MNIST baseline config (BASELINE.json:
"DataParallelTrainer: fashion-MNIST MLP (2 CPU workers)") and the smoke
model for trainer tests.

The counterpart of ``ray_tpu/models/mlp.py``: the same parameter tree
(``{"layers": [{"w", "b"}, ...]}``), logical axes, forward and loss.
``mlp_init`` draws from an explicit ``torch.Generator`` (the JAX one
splits a PRNG key), so the two packages' initial weights differ; a
tree of numpy arrays crosses over through ``models/convert.py``
(``mlp_params_from_numpy``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Sequence

import torch

from ray_tpu_torch.device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class MLPConfig:
    in_dim: int = 784
    hidden: Sequence[int] = (128, 128)
    n_classes: int = 10
    dtype: Any = torch.float32


def mlp_logical_axes(cfg: MLPConfig) -> Dict[str, Any]:
    n = len(cfg.hidden) + 1
    return {"layers": [{"w": ("embed", "mlp"), "b": ("mlp",)}
                       for _ in range(n)]}


def mlp_dims(cfg: MLPConfig) -> list:
    """(d_in, d_out) of each layer, input to logits."""
    dims = [cfg.in_dim, *cfg.hidden, cfg.n_classes]
    return list(zip(dims[:-1], dims[1:]))


def mlp_init(gen: torch.Generator, cfg: MLPConfig,
             device: DeviceLike = None) -> Dict[str, Any]:
    """He-normal weights (std sqrt(2 / d_in)) and zero biases, drawn from
    ``gen`` in layer order on ``device`` (default the card)."""
    dev = resolve_device(device)
    layers = []
    for d_in, d_out in mlp_dims(cfg):
        w = torch.randn((d_in, d_out), generator=gen, device=dev,
                        dtype=cfg.dtype)
        layers.append({"w": w * math.sqrt(2.0 / d_in),
                       "b": torch.zeros((d_out,), device=dev,
                                        dtype=cfg.dtype)})
    return {"layers": layers}


def mlp_forward(params, x, cfg: MLPConfig) -> torch.Tensor:
    x = x.reshape(x.shape[0], -1).to(cfg.dtype)
    layers = params["layers"]
    for layer in layers[:-1]:
        x = torch.relu(x @ layer["w"] + layer["b"])
    return x @ layers[-1]["w"] + layers[-1]["b"]


def mlp_loss(params, batch, cfg: MLPConfig) -> torch.Tensor:
    logits = mlp_forward(params, batch["x"], cfg)
    logp = torch.log_softmax(logits, dim=-1)
    labels = torch.as_tensor(batch["y"], device=logp.device).long()
    return -logp.gather(-1, labels[:, None]).mean()
