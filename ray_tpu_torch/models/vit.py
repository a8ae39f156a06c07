"""Vision Transformer (ViT): config, presets, parameter init, forward,
loss.

Counterpart of ``ray_tpu/models/vit.py``.  Parameters are a plain dict
of tensors keyed exactly like the JAX pytree (``vit_init``): ``blocks``
stacked on a leading layer axis, ``qkv_w`` (L, d, 3, h, hd), ``o_w``
(L, h, hd, d), a zero-initialised head, so weights cross between the
packages through numpy unchanged (models/convert.py).

The forward is eager PyTorch over the stacked layers, as
``models/gpt2.py``'s: each block's parameters are per-layer views of
the stacked leaves, and ``remat=True`` recomputes the whole block in
the backward (``jax.checkpoint_policies.nothing_saveable``), so a
training step runs the flash forward twice a layer.  Attention is
non-causal: the flash kernels on CUDA (ops/flash_attention.py) or the
plain softmax attention (ops/attention.py).  Images are (B, H, W, 3),
patchified by one reshape and product, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import torch

from ray_tpu_torch.device import DeviceLike, resolve_device
from ray_tpu_torch.models.gpt2 import _checkpoint, _layernorm, _layers, _mlp
from ray_tpu_torch.ops.attention import (flash_auto_dispatch,
                                         reference_attention)
from ray_tpu_torch.ops.flash_attention import flash_attention

_PRESETS = {
    # name: (n_layer, n_head, d_model, patch)
    "tiny": (2, 2, 64, 8),            # test-sized
    "vit-s16": (12, 6, 384, 16),
    "vit-b16": (12, 12, 768, 16),
    "vit-l16": (24, 16, 1024, 16),
}

#: ViT's LayerNorm epsilon (GPT-2's is 1e-5)
LN_EPS = 1e-6


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    """Every field of the JAX ViTConfig, with torch dtypes."""
    image_size: int = 224
    patch_size: int = 16
    n_layer: int = 12
    n_head: int = 12
    d_model: int = 768
    d_ff: int = 3072
    n_classes: int = 1000
    dtype: Any = torch.bfloat16       # activation/compute dtype
    param_dtype: Any = torch.float32  # master weights
    remat: bool = True
    use_flash: Optional[bool] = None  # None = auto (flash on CUDA)

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_head

    @property
    def n_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2


def vit_config(name: str = "vit-b16", **overrides) -> ViTConfig:
    n_layer, n_head, d_model, patch = _PRESETS[name]
    kw: Dict[str, Any] = dict(n_layer=n_layer, n_head=n_head,
                              d_model=d_model, d_ff=4 * d_model,
                              patch_size=patch)
    if name == "tiny":
        kw.update(image_size=32, n_classes=10)
    kw.update(overrides)
    return ViTConfig(**kw)


def vit_param_count(cfg: ViTConfig) -> int:
    d, f, L = cfg.d_model, cfg.d_ff, cfg.n_layer
    per_layer = (4 * d * d + 4 * d) + (2 * d * f + d + f) + 4 * d
    patch_in = cfg.patch_size ** 2 * 3
    return (patch_in * d + d                       # patch embed
            + (cfg.n_patches + 1) * d + d          # pos emb + cls
            + L * per_layer + 2 * d                # blocks + final ln
            + d * cfg.n_classes + cfg.n_classes)   # head


def vit_logical_axes(cfg: ViTConfig) -> Dict[str, Any]:
    """Tree (matching vit_init's) of logical-axis tuples; a leading
    ``None`` on block leaves is the stacked-layer axis.  The rules of
    parallel/sharding.py DEFAULT_RULES map them, as for GPT-2."""
    return {
        "patch_w": (None, "embed"),
        "patch_b": ("embed",),
        "pos": (None, "embed"),
        "cls": (None, "embed"),
        "ln_f": {"scale": ("embed",), "bias": ("embed",)},
        "head_w": ("embed", None),
        "head_b": (None,),
        "blocks": {
            "ln1": {"scale": (None, "embed"), "bias": (None, "embed")},
            "ln2": {"scale": (None, "embed"), "bias": (None, "embed")},
            "attn": {
                "qkv_w": (None, "embed", None, "heads", "head_dim"),
                "qkv_b": (None, None, "heads", "head_dim"),
                "o_w": (None, "heads", "head_dim", "embed"),
                "o_b": (None, "embed"),
            },
            "mlp": {
                "fc_w": (None, "embed", "mlp"),
                "fc_b": (None, "mlp"),
                "proj_w": (None, "mlp", "embed"),
                "proj_b": (None, "embed"),
            },
        },
    }


def vit_init(generator: torch.Generator, cfg: ViTConfig,
             device: DeviceLike = None) -> Dict[str, Any]:
    """Parameters shaped and keyed as the JAX ``vit_init``, drawn from
    ``generator`` (which must live on ``device``, default the card):
    N(0, 0.02) weights, residual projections scaled by 1/sqrt(2 L), the
    patch embedding by 1/sqrt(patch_in), a zero CLS token and a zero
    head (ViT's init: every backbone gradient is 0 at step 0).  The
    draws differ from jax.random's, so cross-package tests carry
    JAX-initialised weights across instead (models/convert.py)."""
    dev = resolve_device(device)
    L, d, f, h, hd = (cfg.n_layer, cfg.d_model, cfg.d_ff, cfg.n_head,
                      cfg.head_dim)
    pd = cfg.param_dtype
    std = 0.02
    res_std = std / math.sqrt(2 * L)
    patch_in = cfg.patch_size ** 2 * 3

    def norm(shape, s=std):
        return (torch.randn(shape, generator=generator, device=dev,
                            dtype=torch.float32) * s).to(pd)

    def ones(*shape):
        return torch.ones(shape, dtype=pd, device=dev)

    def zeros(*shape):
        return torch.zeros(shape, dtype=pd, device=dev)

    return {
        "patch_w": norm((patch_in, d), s=1.0 / math.sqrt(patch_in)),
        "patch_b": zeros(d),
        "pos": norm((cfg.n_patches + 1, d), s=0.01),
        "cls": zeros(1, d),
        "ln_f": {"scale": ones(d), "bias": zeros(d)},
        "head_w": zeros(d, cfg.n_classes),
        "head_b": zeros(cfg.n_classes),
        "blocks": {
            "ln1": {"scale": ones(L, d), "bias": zeros(L, d)},
            "ln2": {"scale": ones(L, d), "bias": zeros(L, d)},
            "attn": {
                "qkv_w": norm((L, d, 3, h, hd)),
                "qkv_b": zeros(L, 3, h, hd),
                "o_w": norm((L, h, hd, d), s=res_std),
                "o_b": zeros(L, d),
            },
            "mlp": {
                "fc_w": norm((L, d, f)),
                "fc_b": zeros(L, f),
                "proj_w": norm((L, f, d), s=res_std),
                "proj_b": zeros(L, d),
            },
        },
    }


def _attention(x, p, cfg: ViTConfig):
    """Non-causal MHA: one flattened (d, 3*h*hd) qkv product, then the
    flash kernels or the plain attention.  ``use_flash=None`` takes the
    port's rule (ops/attention.py ``flash_auto_dispatch``: CUDA tensors
    and a head_dim the kernels take).  The JAX rule also asks for
    T % 128 == 0 and T >= 1024, a crossover measured on a TPU against
    XLA's fused attention that says nothing of the H100, whose kernels
    mask a ragged last tile (ViT-B/16 at 224 px has T = 197)."""
    B, T, d = x.shape
    h, hd = cfg.n_head, cfg.head_dim
    w = p["qkv_w"].to(cfg.dtype).reshape(d, 3 * h * hd)
    qkv = (x @ w).reshape(B, T, 3, h, hd) + p["qkv_b"].to(cfg.dtype)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]  # (B, T, H, hd)
    use_flash = cfg.use_flash
    if use_flash is None:
        use_flash = flash_auto_dispatch(T, hd, x.device)
    if use_flash:
        o = flash_attention(q, k, v, causal=False)
    else:
        o = reference_attention(q, k, v, causal=False)
    wo = p["o_w"].to(cfg.dtype).reshape(h * hd, d)
    return o.reshape(B, T, h * hd) @ wo + p["o_b"].to(cfg.dtype)


def _block(x, p, cfg: ViTConfig):
    """Pre-LN block; the MLP is GPT-2's (tanh GELU, as jax.nn.gelu)."""
    x = x + _attention(_layernorm(x, p["ln1"]["scale"], p["ln1"]["bias"],
                                  LN_EPS), p["attn"], cfg)
    return x + _mlp(_layernorm(x, p["ln2"]["scale"], p["ln2"]["bias"],
                               LN_EPS), p["mlp"], cfg)


def vit_forward(params, images, cfg: ViTConfig) -> torch.Tensor:
    """images (B, H, W, 3) float → logits (B, n_classes) float32.

    Each patch is flattened as (row, col, channel): (B, H/ps, ps, W/ps,
    ps, C) with the two patch-grid axes brought together, as the JAX
    reshape does (a Conv2d patch embedding or F.unfold would flatten
    (channel, row, col) and permute ``patch_w``'s rows)."""
    B, H, W, C = images.shape
    ps = cfg.patch_size
    x = images.to(cfg.dtype).reshape(B, H // ps, ps, W // ps, ps, C)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(B, cfg.n_patches,
                                            ps * ps * C)
    x = x @ params["patch_w"].to(cfg.dtype) + params["patch_b"].to(cfg.dtype)
    cls = params["cls"].to(cfg.dtype).expand(B, 1, cfg.d_model)
    x = torch.cat([cls, x], dim=1) + params["pos"].to(cfg.dtype)
    for p in _layers(params["blocks"], cfg.n_layer):
        x = _checkpoint(_block, x, p, cfg) if cfg.remat else _block(x, p,
                                                                    cfg)
    x = _layernorm(x[:, 0], params["ln_f"]["scale"], params["ln_f"]["bias"],
                   LN_EPS)  # the CLS row
    return (x @ params["head_w"].to(cfg.dtype)
            + params["head_b"].to(cfg.dtype)).float()


def vit_loss(params, batch, cfg: ViTConfig) -> torch.Tensor:
    """batch: {"images": (B, H, W, 3), "labels": (B,)} → the mean
    cross-entropy, a float32 scalar."""
    logits = vit_forward(params, batch["images"], cfg)
    logp = torch.log_softmax(logits, dim=-1)
    labels = torch.as_tensor(batch["labels"], device=logp.device).long()
    return -logp.gather(-1, labels[:, None])[:, 0].mean()
