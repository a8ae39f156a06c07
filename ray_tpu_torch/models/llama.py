"""LLaMA family: config, presets, parameter init, training forward, loss.

Counterpart of ``ray_tpu/models/llama.py``: pre-RMSNorm (no biases),
rotary position embeddings on q and k, a SwiGLU MLP, grouped-query
attention (``n_kv_head`` <= ``n_head`` KV heads, each repeated
head-wise to its query group before the attention kernel) and an
untied lm_head.  Parameters are a plain dict of tensors keyed exactly
like the JAX pytree (``llama_init``), layers stacked on a leading axis,
so weights cross between the packages through numpy unchanged
(models/convert.py).

The forward is eager PyTorch over the stacked layers, as in
``models/gpt2.py``, whose ``_layers``, ``_checkpoint``, ``_logits``,
``lm_head_nll`` and ``nll_from_logits`` it reuses (the JAX file imports
the same from ``gpt2``).  Attention goes through the flash kernels on
CUDA; the loss takes each ``ce_impl``, the non-dense ones against the
transposed (V, D) view of the lm_head.  ``llama_logical_axes`` names
each parameter's logical axes for ``parallel.shard_params``; under the
train step's mesh the forward runs on this rank's share of the batch
with plain local tensors.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from ray_tpu_torch.device import DeviceLike, resolve_device
from ray_tpu_torch.models.gpt2 import (_checkpoint, _layers, _logits,
                                       ce_config_problems, lm_head_nll,
                                       nll_from_logits)
from ray_tpu_torch.ops.attention import causal_attention


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    """Every field of the JAX LlamaConfig, with torch dtypes."""
    vocab_size: int = 32_000
    max_seq: int = 2048
    n_layer: int = 8
    n_head: int = 8
    n_kv_head: int = 4
    d_model: int = 512
    d_ff: int = 1408              # ~ 8/3 d, rounded to a 128-multiple
    rope_theta: float = 10_000.0
    rms_eps: float = 1e-5
    dtype: Any = torch.bfloat16       # activation/compute dtype
    param_dtype: Any = torch.float32  # master weights
    remat: bool = True
    scan_unroll: int = 1
    use_flash: Optional[bool] = None  # None = auto (flash on CUDA)
    vocab_pad_to: int = 128
    #: lm-head + CE implementation (gpt2.CE_IMPLS); the non-dense ones
    #: run against the transposed (V, D) view of lm_head
    ce_impl: str = "dense"
    vocab_tile: int = 8192
    ce_block_n: int = 256
    ce_block_v: int = 1024
    #: resident-kv flash knob (gpt2.FLASH_RESIDENT_MODES)
    flash_resident: str = "auto"

    def __post_init__(self):
        problems = ce_config_problems(self.ce_impl, self.flash_resident)
        if problems:
            raise ValueError("invalid LlamaConfig: " + "; ".join(problems))

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_head

    @property
    def padded_vocab(self) -> int:
        p = self.vocab_pad_to
        return (self.vocab_size + p - 1) // p * p


_PRESETS = {
    # name: (n_layer, n_head, n_kv_head, d_model, d_ff)
    "nano": (2, 2, 1, 64, 192),
    "tiny": (4, 4, 2, 128, 384),
    "llama-s": (12, 12, 4, 768, 2048),     # GPT-2-small-class
    "llama-1b": (16, 32, 8, 2048, 5504),
    "llama-7b": (32, 32, 32, 4096, 11008),
}


def llama_config(name: str = "llama-s", **overrides) -> LlamaConfig:
    L, h, kv, d, f = _PRESETS[name]
    kw: Dict[str, Any] = dict(n_layer=L, n_head=h, n_kv_head=kv,
                              d_model=d, d_ff=f)
    if name in ("nano", "tiny"):
        kw.update(vocab_size=512, max_seq=128)
    kw.update(overrides)
    cfg = LlamaConfig(**kw)
    if cfg.n_head % cfg.n_kv_head:
        raise ValueError(f"n_head {cfg.n_head} must divide by "
                         f"n_kv_head {cfg.n_kv_head}")
    return cfg


def llama_param_count(cfg: LlamaConfig) -> int:
    """Parameters, both embedding tables (wte and lm_head) counted."""
    d, f, L = cfg.d_model, cfg.d_ff, cfg.n_layer
    hd = cfg.head_dim
    attn = d * cfg.n_head * hd + 2 * d * cfg.n_kv_head * hd \
        + cfg.n_head * hd * d
    mlp = 3 * d * f
    per_layer = attn + mlp + 2 * d          # + two rmsnorm scales
    return 2 * cfg.vocab_size * d + L * per_layer + d


def llama_logical_axes(cfg: LlamaConfig) -> Dict[str, Any]:
    """Tree (matching llama_init's) of logical-axis tuples; leading
    None on block leaves is the stacked-layer axis."""
    return {
        "wte": ("vocab", "embed"),
        "lm_head": ("embed", "vocab"),
        "ln_f": {"scale": ("embed",)},
        "blocks": {
            "ln1": {"scale": (None, "embed")},
            "ln2": {"scale": (None, "embed")},
            "attn": {
                "wq": (None, "embed", "heads", "head_dim"),
                "wk": (None, "embed", "kv_heads", "head_dim"),
                "wv": (None, "embed", "kv_heads", "head_dim"),
                "wo": (None, "heads", "head_dim", "embed"),
            },
            "mlp": {
                "w_gate": (None, "embed", "mlp"),
                "w_up": (None, "embed", "mlp"),
                "w_down": (None, "mlp", "embed"),
            },
        },
    }


def llama_init(cfg: LlamaConfig, generator: Optional[torch.Generator] = None,
               device: DeviceLike = None) -> Dict[str, Any]:
    """Initialize parameters (N(0, 0.02), output projections scaled by
    1/sqrt(2*n_layer), RMSNorm scales 1), shaped and keyed as the JAX
    ``llama_init``.  ``generator`` must live on ``device``; None seeds
    a fresh one with 0.  The draws differ from jax.random's, so
    cross-package tests carry JAX-initialized weights across instead
    (models/convert.py)."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    L, d, f = cfg.n_layer, cfg.d_model, cfg.d_ff
    h, kv, hd = cfg.n_head, cfg.n_kv_head, cfg.head_dim
    pd = cfg.param_dtype
    std = 0.02
    res_std = std / math.sqrt(2 * L)

    def norm(shape, s=std):
        return (torch.randn(shape, generator=generator, device=dev,
                            dtype=torch.float32) * s).to(pd)

    def ones(*shape):
        return torch.ones(shape, dtype=pd, device=dev)

    return {
        "wte": norm((cfg.padded_vocab, d)),
        "lm_head": norm((d, cfg.padded_vocab)),
        "ln_f": {"scale": ones(d)},
        "blocks": {
            "ln1": {"scale": ones(L, d)},
            "ln2": {"scale": ones(L, d)},
            "attn": {
                "wq": norm((L, d, h, hd)),
                "wk": norm((L, d, kv, hd)),
                "wv": norm((L, d, kv, hd)),
                "wo": norm((L, h, hd, d), s=res_std),
            },
            "mlp": {
                "w_gate": norm((L, d, f)),
                "w_up": norm((L, d, f)),
                "w_down": norm((L, f, d), s=res_std),
            },
        },
    }


def _rmsnorm(x, scale, eps: float):
    """RMSNorm in float32 against the f32 scale, cast back to x's
    dtype."""
    xf = x.float()
    y = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    return (y * scale).to(x.dtype)


def rope_frequencies(T: int, head_dim: int, theta: float,
                     device: DeviceLike = None):
    """(T, head_dim/2) float32 cos/sin tables on ``device``."""
    device = resolve_device(device)
    inv = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                        device=device) / head_dim))
    ang = torch.arange(T, dtype=torch.float32, device=device)[:, None] \
        * inv[None, :]
    return torch.cos(ang), torch.sin(ang)


def rotate_pairs(x, c, s):
    """Rotate the interleaved pairs (x_2i, x_2i+1) of x's last axis by
    the angles whose cos/sin are c and s (broadcast against x[..., ::2]),
    in float32, cast back to x's dtype."""
    x1 = x[..., 0::2].float()
    x2 = x[..., 1::2].float()
    out = torch.stack([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1)
    return out.reshape(x.shape).to(x.dtype)


def apply_rope(x, cos, sin):
    """x (B, T, H, D) with D even; rotate pairs (x_2i, x_2i+1) by the
    (T, D/2) tables."""
    return rotate_pairs(x, cos[None, :, None, :], sin[None, :, None, :])


def repeat_kv(x, n_head: int):
    """(..., n_kv_head, hd) → (..., n_head, hd): each KV head repeated
    head-wise for its query group (``jnp.repeat(..., axis=-2)``: head j
    reads KV head j // group)."""
    rep = n_head // x.shape[-2]
    return x if rep == 1 else x.repeat_interleave(rep, dim=-2)


def _attention(x, p, cos, sin, cfg: LlamaConfig):
    B, T, d = x.shape
    h, kv, hd = cfg.n_head, cfg.n_kv_head, cfg.head_dim
    xc = x.to(cfg.dtype)
    q = (xc @ p["wq"].to(cfg.dtype).reshape(d, h * hd)).reshape(B, T, h, hd)
    k = (xc @ p["wk"].to(cfg.dtype).reshape(d, kv * hd)).reshape(B, T, kv,
                                                                 hd)
    v = (xc @ p["wv"].to(cfg.dtype).reshape(d, kv * hd)).reshape(B, T, kv,
                                                                 hd)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    # GQA: autograd sums each group's gradients back onto its KV head
    o = causal_attention(q, repeat_kv(k, h), repeat_kv(v, h),
                         use_flash=cfg.use_flash,
                         resident=cfg.flash_resident)
    wo = p["wo"].to(cfg.dtype).reshape(h * hd, d)
    return (o.reshape(B, T, h * hd) @ wo).to(x.dtype)


def _mlp(x, p, cfg: LlamaConfig):
    xc = x.to(cfg.dtype)
    gate = xc @ p["w_gate"].to(cfg.dtype)
    up = xc @ p["w_up"].to(cfg.dtype)
    return ((F.silu(gate) * up) @ p["w_down"].to(cfg.dtype)).to(x.dtype)


def _block(x, p, cos, sin, cfg: LlamaConfig):
    x = x + _attention(_rmsnorm(x, p["ln1"]["scale"], cfg.rms_eps),
                       p["attn"], cos, sin, cfg)
    return x + _mlp(_rmsnorm(x, p["ln2"]["scale"], cfg.rms_eps),
                    p["mlp"], cfg)


def llama_hidden(params, tokens, cfg: LlamaConfig):
    """tokens (B, T) int → post-ln_f hidden states (B, T, d_model) in
    the compute dtype.  ``remat=True`` recomputes the whole block in
    the backward (the JAX ``jax.checkpoint`` with ``nothing_saveable``),
    so the flash forward runs twice per layer per step."""
    B, T = tokens.shape
    x = params["wte"].to(cfg.dtype)[tokens.long()]
    cos, sin = rope_frequencies(T, cfg.head_dim, cfg.rope_theta,
                                tokens.device)
    for p in _layers(params["blocks"], cfg.n_layer):
        if cfg.remat:
            x = _checkpoint(_block, x, p, cos, sin, cfg)
        else:
            x = _block(x, p, cos, sin, cfg)
    return _rmsnorm(x, params["ln_f"]["scale"], cfg.rms_eps)


def llama_forward(params, tokens, cfg: LlamaConfig) -> torch.Tensor:
    """tokens (B, T) int → logits (B, T, padded_vocab) float32 (the
    untied (D, V) lm_head in the compute dtype, f32 output)."""
    x = llama_hidden(params, tokens, cfg)
    return _logits(x, params["lm_head"].to(cfg.dtype).t())


def llama_loss(params, batch, cfg: LlamaConfig) -> torch.Tensor:
    """Next-token cross-entropy, a float32 scalar; batch = {"tokens":
    (B, T+1)} or {"inputs", "targets"}, either with an optional "mask";
    the padded-vocab tail is masked."""
    if "tokens" in batch:
        inputs, targets = batch["tokens"][:, :-1], batch["tokens"][:, 1:]
    else:
        inputs, targets = batch["inputs"], batch["targets"]
    if cfg.ce_impl != "dense":
        hidden = llama_hidden(params, inputs, cfg)
        # (D, V) lm_head → the (V, D) vocab-major view the CE kernels
        # share with gpt2's tied wte; dW comes back through the view
        nll = lm_head_nll(hidden, params["lm_head"].t(), targets, cfg)
    else:
        logits = llama_forward(params, inputs, cfg)
        nll = nll_from_logits(logits, targets, cfg.vocab_size,
                              cfg.padded_vocab)
    mask = batch.get("mask")
    if mask is not None:
        m = mask.to(torch.float32)
        return (nll * m).sum() / m.sum().clamp_min(1.0)
    return nll.mean()
