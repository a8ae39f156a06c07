"""GPT-2 family: config, presets, parameter init and LayerNorm.

Counterpart of ``ray_tpu/models/gpt2.py``.  Parameters are a plain dict
of tensors keyed exactly like the JAX pytree (``gpt2_init``): ``blocks``
stacked on a leading layer axis, ``qkv_w`` (L, d, 3, h, hd), ``o_w``
(L, h, hd, d), ``wte`` padded to ``padded_vocab``, so weights cross
between the packages through numpy unchanged (models/convert.py).

The training forward (``gpt2_hidden``, ``gpt2_forward``, ``gpt2_loss``)
comes with the training slice (ROADMAP.md, queue 1 item 1); the decode
path (models/gpt2_decode.py) needs only what is here.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import torch

from ray_tpu_torch.device import DeviceLike, resolve_device

#: The three lm-head + cross-entropy implementations (GPT2Config.ce_impl),
#: named as in the JAX package: "dense" materializes f32 (B,T,V)
#: logits; "streaming_xla" is the vocab-tiled loop; "pallas" is the
#: fused lm-head + CE kernel (a Hopper kernel in the port's training
#: slice).
CE_IMPLS = ("dense", "streaming_xla", "pallas")
FLASH_RESIDENT_MODES = ("auto", "on", "off")


def ce_config_problems(ce_impl: str, flash_resident: str, *,
                       loss_chunks: int = 1,
                       seq_parallel: bool = False) -> list:
    """Validation shared by GPT2Config/LlamaConfig: returns a list of
    human-readable problems with the CE/attention knob combination (empty
    when valid).  Callers join the list into ONE coherent ValueError so
    an invalid config reports every conflict at once instead of the
    first scattered check to trip."""
    problems = []
    if ce_impl not in CE_IMPLS:
        problems.append(f"ce_impl must be one of {CE_IMPLS} "
                        f"(got {ce_impl!r})")
    else:
        if ce_impl != "dense" and loss_chunks > 1:
            problems.append(
                f"loss_chunks={loss_chunks} requires ce_impl='dense' "
                f"(both bound the logits footprint; pick one)")
        if ce_impl != "dense" and seq_parallel:
            problems.append(
                f"ce_impl={ce_impl!r} needs an unsharded seq axis (the "
                f"(B,T)->(B*T) flatten would reshard under seq "
                f"parallelism)")
    if flash_resident not in FLASH_RESIDENT_MODES:
        problems.append(f"flash_resident must be one of "
                        f"{FLASH_RESIDENT_MODES} (got {flash_resident!r})")
    return problems


@dataclasses.dataclass(frozen=True)
class GPT2Config:
    """Every field of the JAX GPT2Config, with torch dtypes.  Fields
    that only the training path reads (remat, loss chunking, CE tiles,
    sequence parallelism, MoE) are kept so one config dict drives both
    packages."""
    vocab_size: int = 50257
    max_seq: int = 1024
    n_layer: int = 12
    n_head: int = 12
    d_model: int = 768
    d_ff: int = 3072
    dtype: Any = torch.bfloat16       # activation/compute dtype
    param_dtype: Any = torch.float32  # master weights
    remat: bool = True
    remat_policy: str = "full"
    use_flash: Optional[bool] = None  # None = auto (flash on CUDA)
    loss_chunks: int = 1
    scan_unroll: int = 1
    ce_impl: str = "dense"
    #: deprecated alias for ce_impl="streaming_xla", normalized into
    #: ce_impl by __post_init__
    use_streaming_ce: bool = False
    vocab_tile: int = 8192
    ce_block_n: int = 256
    ce_block_v: int = 1024
    #: resident-kv flash variant: "auto" | "on" | "off";
    #: RAYTPU_FLASH_RESIDENT=1/0 in the env overrides it
    flash_resident: str = "auto"
    seq_parallel: bool = False
    sp_mode: str = "ring"
    n_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    moe_aux_weight: float = 0.01
    #: pad the vocab to a multiple of this (the lm-head matmul tiles
    #: cleanly and the padded tail is masked at sampling)
    vocab_pad_to: int = 128

    def __post_init__(self):
        if self.use_streaming_ce and self.ce_impl == "dense":
            object.__setattr__(self, "ce_impl", "streaming_xla")
        problems = ce_config_problems(
            self.ce_impl, self.flash_resident,
            loss_chunks=self.loss_chunks, seq_parallel=self.seq_parallel)
        if self.use_streaming_ce and self.ce_impl == "pallas":
            problems.append(
                "use_streaming_ce is a deprecated alias for "
                "ce_impl='streaming_xla' and conflicts with "
                "ce_impl='pallas'")
        if problems:
            raise ValueError("invalid GPT2Config: " + "; ".join(problems))

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_head

    @property
    def padded_vocab(self) -> int:
        p = self.vocab_pad_to
        return (self.vocab_size + p - 1) // p * p


_PRESETS = {
    # name: (n_layer, n_head, d_model)
    "nano": (2, 2, 64),          # test-sized
    "tiny": (4, 4, 128),
    "gpt2": (12, 12, 768),       # 124M
    "gpt2-medium": (24, 16, 1024),
    "gpt2-large": (36, 20, 1280),
    "gpt2-xl": (48, 25, 1600),
}


def gpt2_config(name: str = "gpt2", **overrides) -> GPT2Config:
    n_layer, n_head, d_model = _PRESETS[name]
    kw: Dict[str, Any] = dict(n_layer=n_layer, n_head=n_head,
                              d_model=d_model, d_ff=4 * d_model)
    if name in ("nano", "tiny"):
        kw.update(vocab_size=512, max_seq=128)
    kw.update(overrides)
    return GPT2Config(**kw)


def gpt2_param_count(cfg: GPT2Config) -> int:
    d, f, L = cfg.d_model, cfg.d_ff, cfg.n_layer
    if cfg.n_experts:
        E = cfg.n_experts
        ff = d * E + E * (2 * d * f + d + f)  # gate + E experts
    else:
        ff = 2 * d * f + d + f
    per_layer = (4 * d * d + 4 * d) + ff + 4 * d  # attn+ff+2ln
    return cfg.vocab_size * d + cfg.max_seq * d + L * per_layer + 2 * d


def gpt2_init(cfg: GPT2Config, generator: Optional[torch.Generator] = None,
              device: DeviceLike = None) -> Dict[str, Any]:
    """Initialize parameters (GPT-2 style: N(0, 0.02), residual
    projections scaled by 1/sqrt(2*n_layer)), shaped and keyed as the
    JAX ``gpt2_init``.  ``generator`` must live on ``device``; None
    seeds a fresh one with 0.  The draws differ from jax.random's, so
    cross-package tests carry JAX-initialized weights across instead
    (models/convert.py)."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    L, d, f, h, hd = (cfg.n_layer, cfg.d_model, cfg.d_ff, cfg.n_head,
                      cfg.head_dim)
    pd = cfg.param_dtype
    std = 0.02
    res_std = std / math.sqrt(2 * L)

    def norm(shape, s=std):
        return (torch.randn(shape, generator=generator, device=dev,
                            dtype=torch.float32) * s).to(pd)

    def ones(*shape):
        return torch.ones(shape, dtype=pd, device=dev)

    def zeros(*shape):
        return torch.zeros(shape, dtype=pd, device=dev)

    if cfg.n_experts:
        E = cfg.n_experts
        ff = {"moe": {
            "gate": norm((L, d, E)),
            "w1": norm((L, E, d, f)),
            "b1": zeros(L, E, f),
            "w2": norm((L, E, f, d), s=res_std),
            "b2": zeros(L, E, d),
        }}
    else:
        ff = {"mlp": {
            "fc_w": norm((L, d, f)),
            "fc_b": zeros(L, f),
            "proj_w": norm((L, f, d), s=res_std),
            "proj_b": zeros(L, d),
        }}
    return {
        "wte": norm((cfg.padded_vocab, d)),
        "wpe": norm((cfg.max_seq, d), s=0.01),
        "ln_f": {"scale": ones(d), "bias": zeros(d)},
        "blocks": {
            "ln1": {"scale": ones(L, d), "bias": zeros(L, d)},
            "ln2": {"scale": ones(L, d), "bias": zeros(L, d)},
            "attn": {
                "qkv_w": norm((L, d, 3, h, hd)),
                "qkv_b": zeros(L, 3, h, hd),
                "o_w": norm((L, h, hd, d), s=res_std),
                "o_b": zeros(L, d),
            },
            **ff,
        },
    }


def _layernorm(x, scale, bias, eps: float = 1e-5):
    # LN in float32 for stability, cast back to compute dtype.
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale + bias).to(x.dtype)
