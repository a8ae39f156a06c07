"""GPT-2 family: config, presets, parameter init, training forward, loss.

Counterpart of ``ray_tpu/models/gpt2.py``.  Parameters are a plain dict
of tensors keyed exactly like the JAX pytree (``gpt2_init``): ``blocks``
stacked on a leading layer axis, ``qkv_w`` (L, d, 3, h, hd), ``o_w``
(L, h, hd, d), ``wte`` padded to ``padded_vocab``, so weights cross
between the packages through numpy unchanged (models/convert.py).

The training forward (``gpt2_hidden``, ``gpt2_forward``, ``gpt2_loss``)
is eager PyTorch over the stacked layers, differentiable with
``torch.autograd``; attention goes through the flash kernels on CUDA
(ops/flash_attention.py).  The loss takes each ``ce_impl``: "dense"
(f32 logits), "streaming_xla" (ops/vocab_ce.py) and "pallas" (the
fused lm-head + CE kernels, ops/fused_ce.py), and each remat policy of
the JAX package ("full", "mlp_only", "dots", "dots_nb", "attn_out").
``n_experts > 0`` replaces every block's MLP with a mixture of experts
(models/moe.py), whose load-balance loss ``gpt2_loss`` adds.  Under a
mesh (the train step's, ``parallel/``) the functions run on this
rank's share of the batch with plain local tensors, so the kernels see
what they see on one device.  ``seq_parallel=True`` under a mesh
whose ``seq`` axis is above 1 is context parallelism: each rank of the
axis takes its slice of the sequence (``gpt2_hidden`` and ``gpt2_loss``
split the global (B, T) tokens themselves; position embeddings at the
slice's global offset), and attention runs over the axis by ring or
Ulysses (``sp_mode``, ops/ring_attention.py).  Without a mesh, or with
``seq`` of 1, the model takes ``causal_attention``, as the JAX one
does.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, List, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ray_tpu_torch.device import DeviceLike, resolve_device
from ray_tpu_torch.ops.attention import causal_attention, flash_auto_dispatch
from ray_tpu_torch.ops.fused_ce import fused_lm_ce
from ray_tpu_torch.ops.vocab_ce import streaming_ce
from ray_tpu_torch.parallel.mesh import AXIS_SEQ, active_mesh, mesh_shape
from ray_tpu_torch.parallel.sharding import DEFAULT_RULES

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


def gpt2_logical_axes(cfg: GPT2Config) -> Dict[str, Any]:
    """Tree (matching gpt2_init's) of logical-axis tuples.  A leading
    ``None`` on block leaves is the stacked-layer axis.  "embed" maps
    to fsdp (ZeRO-3), "heads"/"mlp"/"vocab" to tensor, "expert" to
    expert: parallel/sharding.py DEFAULT_RULES."""
    return {
        "wte": ("vocab", "embed"),
        "wpe": (None, "embed"),
        "ln_f": {"scale": ("embed",), "bias": ("embed",)},
        "blocks": {
            "ln1": {"scale": (None, "embed"), "bias": (None, "embed")},
            "ln2": {"scale": (None, "embed"), "bias": (None, "embed")},
            "attn": {
                "qkv_w": (None, "embed", None, "heads", "head_dim"),
                "qkv_b": (None, None, "heads", "head_dim"),
                "o_w": (None, "heads", "head_dim", "embed"),
                "o_b": (None, "embed"),
            },
            **({"moe": {
                "gate": (None, "embed", None),
                "w1": (None, "expert", "embed", "mlp"),
                "b1": (None, "expert", "mlp"),
                "w2": (None, "expert", "mlp", "embed"),
                "b2": (None, "expert", "embed"),
            }} if cfg.n_experts else {"mlp": {
                "fc_w": (None, "embed", "mlp"),
                "fc_b": (None, "mlp"),
                "proj_w": (None, "mlp", "embed"),
                "proj_b": (None, "embed"),
            }}),
        },
    }


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


# ---------------------------------------------------------------------------
# Training forward
# ---------------------------------------------------------------------------

@torch.library.custom_op("ray_tpu_torch::checkpoint_name", mutates_args=())
def checkpoint_name(x: torch.Tensor, name: str) -> torch.Tensor:
    """The port's ``jax.ad_checkpoint.checkpoint_name``: an identity op
    whose output a selective remat policy can save by ``name`` (the
    policy sees ops, not names).  A custom op may not return its input
    as it is, so it copies: one extra read and write of the tensor,
    paid only where a policy asks for the name."""
    return x.clone()


checkpoint_name.register_fake(lambda x, name: torch.empty_like(x))
checkpoint_name.register_autograd(lambda ctx, grad: (grad, None))

_MATMULS_NO_BATCH = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)
_MATMULS = _MATMULS_NO_BATCH + (torch.ops.aten.bmm.default,
                                torch.ops.aten.baddbmm.default)


def _saves(policy: str):
    """The selective-checkpoint policy function of a JAX remat policy
    (``jax.checkpoint_policies``): ``dots`` saves every matmul output
    (``dots_saveable``), ``dots_nb`` those without a batch dimension
    (``dots_with_no_batch_dims_saveable``: the plain attention's
    einsums reach ``bmm``), ``attn_out`` only the output named
    "attn_out" (``save_only_these_names``).  Everything else is
    recomputed, the flash kernels included: a kernel launched through
    ctypes is no op the policy sees, as a ``pallas_call`` is no dot."""
    def policy_fn(ctx, op, *args, **kwargs):
        if policy == "attn_out":
            keep = (op is torch.ops.ray_tpu_torch.checkpoint_name.default
                    and args[1] == "attn_out")
        else:
            keep = op in (_MATMULS if policy == "dots"
                          else _MATMULS_NO_BATCH)
        return (CheckpointPolicy.MUST_SAVE if keep
                else CheckpointPolicy.PREFER_RECOMPUTE)
    return policy_fn


#: remat policies that save some of the block's tensors
_SELECTIVE = ("dots", "dots_nb", "attn_out")


def _seq_shard(cfg: GPT2Config, mesh):
    """(axis size n, this rank's index) of the ``seq`` axis when the
    config is sequence-parallel under ``mesh`` and the axis is above 1,
    else None."""
    if not cfg.seq_parallel or mesh is None:
        return None
    n = mesh_shape(mesh).get(AXIS_SEQ, 1)
    if n == 1:
        return None
    from ray_tpu_torch.parallel.collective import axis_index

    return n, axis_index(AXIS_SEQ, mesh)


def _local_seq(x, shard):
    """This rank's slice of dim 1 (the sequence) of a global (B, T, ...)
    tensor: columns [i * T / n, (i + 1) * T / n)."""
    if shard is None or x is None:
        return x
    n, i = shard
    T = x.shape[1]
    if T % n:
        raise ValueError(f"sequence length {T} not divisible by the "
                         f"{n} ranks of the seq axis")
    return x[:, i * (T // n):(i + 1) * (T // n)]


def _ring_attention_sharded(q, k, v, cfg: GPT2Config, mesh):
    """Context parallelism: attention over the ``seq`` axis of ``mesh``
    on this rank's sequence slice, by ring or Ulysses (``sp_mode``).
    None when the config is not sequence-parallel, no mesh is given or
    its ``seq`` axis is 1."""
    if _seq_shard(cfg, mesh) is None:
        return None
    from ray_tpu_torch.ops.ring_attention import (ring_attention,
                                                  ulysses_attention)

    fn = ulysses_attention if cfg.sp_mode == "ulysses" else ring_attention
    return fn(q, k, v, axis_name=AXIS_SEQ, causal=True, mesh=mesh)


def _attention(x, p, cfg: GPT2Config, mesh=None):
    """The attention sublayer: one flattened (d, 3*h*hd) qkv product,
    then ring/Ulysses attention under sequence parallelism, else
    ``causal_attention``.  The JAX version keeps a 5-D einsum where the
    mesh shards the heads (``_heads_axis_sharded``, a layout hint for
    GSPMD); the port's mesh step gathers every weight before the loss
    (train/trainer.py), so the product always sees whole weights."""
    B, T, d = x.shape
    h, hd = cfg.n_head, cfg.head_dim
    w = p["qkv_w"].to(cfg.dtype).reshape(d, 3 * h * hd)
    qkv = (x @ w).reshape(B, T, 3, h, hd) + p["qkv_b"].to(cfg.dtype)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]  # (B, T, H, hd)
    o = _ring_attention_sharded(q, k, v, cfg, mesh)
    if o is None:
        o = causal_attention(q, k, v, use_flash=cfg.use_flash,
                             resident=cfg.flash_resident)
    if cfg.remat and cfg.remat_policy == "attn_out":
        o = checkpoint_name(o, "attn_out")
    wo = p["o_w"].to(cfg.dtype).reshape(h * hd, d)
    return o.reshape(B, T, h * hd) @ wo + p["o_b"].to(cfg.dtype)


def _mlp(x, p, cfg: GPT2Config):
    h = x @ p["fc_w"].to(cfg.dtype) + p["fc_b"].to(cfg.dtype)
    h = F.gelu(h, approximate="tanh")  # jax.nn.gelu is the tanh form
    return h @ p["proj_w"].to(cfg.dtype) + p["proj_b"].to(cfg.dtype)


def _attn_half(x, p, cfg: GPT2Config, mesh=None):
    return x + _attention(_layernorm(x, p["ln1"]["scale"],
                                     p["ln1"]["bias"]), p["attn"], cfg,
                          mesh)


def _mlp_half(x, p, cfg: GPT2Config):
    return x + _mlp(_layernorm(x, p["ln2"]["scale"], p["ln2"]["bias"]),
                    p["mlp"], cfg)


def _moe_cfg(cfg: GPT2Config):
    from ray_tpu_torch.models.moe import MoEConfig

    return MoEConfig(d_model=cfg.d_model, d_ff=cfg.d_ff,
                     n_experts=cfg.n_experts, top_k=cfg.moe_top_k,
                     capacity_factor=cfg.moe_capacity_factor,
                     dtype=cfg.dtype, param_dtype=cfg.param_dtype)


def _moe_half(x, p, cfg: GPT2Config, rules, mesh):
    """The MoE feed-forward in place of the MLP: (x + y, aux loss)."""
    from ray_tpu_torch.models.moe import moe_apply

    y, aux = moe_apply(p["moe"], _layernorm(x, p["ln2"]["scale"],
                                            p["ln2"]["bias"]),
                       _moe_cfg(cfg), rules, mesh=mesh)
    return x + y, aux


def _block(x, p, cfg: GPT2Config, rules=DEFAULT_RULES, mesh=None):
    """x after one block; (x, the MoE aux loss) with experts.  The MoE
    routing and sequence-parallel attention run over ``mesh`` (an
    argument, not the active mesh, so a recompute in the backward,
    maybe on autograd's device thread, sees the same one)."""
    x = _attn_half(x, p, cfg, mesh)
    if cfg.n_experts:
        return _moe_half(x, p, cfg, rules, mesh)
    return _mlp_half(x, p, cfg)


def _flash_active(cfg: GPT2Config, T: int, device) -> bool:
    """Whether attention will take the flash kernels at seq T on
    ``device``: the precondition of mlp_only remat (without flash the
    un-rematted attention would save its O(T^2) scores).  Mirrors
    causal_attention's dispatch."""
    if cfg.use_flash is False or cfg.seq_parallel:
        return False
    if cfg.use_flash is True:
        return True
    return flash_auto_dispatch(T, cfg.head_dim, device)


def _layers(blocks, n_layer: int) -> List[Dict[str, Any]]:
    """Per-layer views of the stacked block parameters, one unbind(0)
    per leaf: its backward stacks the layers' gradients once, where
    indexing ``w[i]`` per layer would write a zero-filled gradient the
    size of the whole stack for every layer."""
    per_leaf = {name: {k: v.unbind(0) for k, v in sub.items()}
                for name, sub in blocks.items()}
    return [{name: {k: vs[i] for k, vs in sub.items()}
             for name, sub in per_leaf.items()} for i in range(n_layer)]


def _checkpoint(fn, *args, policy: Optional[str] = None):
    """``fn(*args)`` recomputed in the backward; ``policy`` (one of
    _SELECTIVE) names the tensors saved instead of recomputed."""
    kw = {}
    if policy is not None:
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _saves(policy))
    # no randomness in the model, so no RNG state to stash and restore
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False, **kw)


def gpt2_hidden(params, tokens, cfg: GPT2Config, rules=DEFAULT_RULES,
                return_aux: bool = False):
    """tokens (B, T) int → post-ln_f hidden states (B, T, d_model) in
    the compute dtype; under sequence parallelism (module docstring)
    ``tokens`` are the global ones and the result is this rank's
    (B, T / n, d_model) slice.  ``return_aux=True`` also returns the
    summed MoE load-balance loss (0.0 for dense configs).  ``rules`` are the
    sharding rules the MoE block reads under a mesh.

    Remat, as the JAX ``gpt2_hidden``: ``remat=False`` saves every
    activation; ``remat_policy="mlp_only"`` with flash active
    recomputes only the MLP half of each block (the flash backward
    recomputes its score tiles from O(T) residuals, so the attention
    half is not rerun); ``"dots"``, ``"dots_nb"`` and ``"attn_out"``
    recompute the block but keep what their policy saves (selective
    checkpointing, see ``_saves``); ``"full"`` (and any other name, as
    in JAX), or ``"mlp_only"`` without flash, recomputes the whole
    block in the backward (``torch.utils.checkpoint``)."""
    mesh = active_mesh() if (cfg.n_experts or cfg.seq_parallel) else None
    shard = _seq_shard(cfg, mesh)
    tokens = _local_seq(tokens, shard)
    B, T = tokens.shape
    off = shard[1] * T if shard is not None else 0
    x = params["wte"].to(cfg.dtype)[tokens.long()]
    x = x + params["wpe"].to(cfg.dtype)[off:off + T]
    if cfg.remat and cfg.remat_policy == "mlp_only" and cfg.n_experts:
        raise NotImplementedError(
            "remat_policy='mlp_only' is a dense-MLP recipe; MoE blocks "
            "use remat_policy='full' (or 'dots_nb')")
    mlp_only = (cfg.remat and cfg.remat_policy == "mlp_only"
                and _flash_active(cfg, T, tokens.device))
    policy = cfg.remat_policy if cfg.remat_policy in _SELECTIVE else None
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for p in _layers(params["blocks"], cfg.n_layer):
        if mlp_only:
            x = _checkpoint(_mlp_half, _attn_half(x, p, cfg, mesh), p, cfg)
        elif cfg.remat:
            x = _checkpoint(_block, x, p, cfg, rules, mesh, policy=policy)
        else:
            x = _block(x, p, cfg, rules, mesh)
        if cfg.n_experts:
            x, layer_aux = x
            aux = aux + layer_aux
    out = _layernorm(x, params["ln_f"]["scale"], params["ln_f"]["bias"])
    return (out, aux) if return_aux else out


class _LogitsMatmul(torch.autograd.Function):
    """(N, d) x (V, d)^T in the compute dtype with float32 logits, as
    the JAX ``_tied_logits`` asks (bf16 operands, f32 accumulation, f32
    output).  bf16 on CUDA: one ``torch.mm(..., out_dtype=float32)``;
    the gradients, like an XLA f32 x bf16 product at the TPU's default
    precision, round the f32 cotangent to the compute dtype and run in
    it.  float32 (and the CPU): plain f32 products."""

    @staticmethod
    def forward(ctx, h2, w):
        ctx.save_for_backward(h2, w)
        if h2.dtype == torch.float32:
            return h2 @ w.t()
        if h2.device.type == "cuda":
            return torch.mm(h2, w.t(), out_dtype=torch.float32)
        # the CPU has no mm.dtype kernel; bf16 products are exact in f32
        return h2.float() @ w.float().t()

    @staticmethod
    def backward(ctx, g):
        h2, w = ctx.saved_tensors
        g = g.to(h2.dtype)
        return g @ w, g.t() @ h2


def _logits(hidden, w_c):
    """hidden (..., d), w_c (V, d) in the compute dtype → (..., V) f32."""
    lead = hidden.shape[:-1]
    out = _LogitsMatmul.apply(hidden.reshape(-1, hidden.shape[-1]), w_c)
    return out.reshape(*lead, w_c.shape[0])


def _tied_logits(hidden, wte, cfg: GPT2Config):
    """Tied-embedding projection: compute-dtype operands, float32
    logits (B, T, padded_vocab)."""
    return _logits(hidden, wte.to(cfg.dtype))


def gpt2_forward(params, tokens, cfg: GPT2Config,
                 rules=DEFAULT_RULES) -> torch.Tensor:
    """tokens (B, T) int → logits (B, T, padded_vocab) float32."""
    return _tied_logits(gpt2_hidden(params, tokens, cfg, rules),
                        params["wte"], cfg)


def nll_from_logits(logits, targets, vocab_size: int, padded_vocab: int):
    """Per-token negative log likelihood with the padded-vocab tail
    masked to -1e9 (as the JAX ``nll_from_logits``): logsumexp minus
    the target's logit.  The JAX version picks the target with an
    iota compare for the sake of sharding; a gather picks the same
    value."""
    if padded_vocab != vocab_size:
        cols = torch.arange(padded_vocab, device=logits.device)
        logits = logits.masked_fill(cols >= vocab_size, -1e9)
    lse = torch.logsumexp(logits, dim=-1)
    target = logits.gather(-1, targets.long().unsqueeze(-1)).squeeze(-1)
    return lse - target


def _nll_from_logits(logits, targets, cfg: GPT2Config):
    return nll_from_logits(logits, targets, cfg.vocab_size,
                           cfg.padded_vocab)


def _chunk_sums(hc, wte_c, tc, mc, cfg: GPT2Config):
    nll = _nll_from_logits(_logits(hc, wte_c), tc, cfg)
    return (nll * mc).sum(), mc.sum()


def _chunked_ce(hidden, wte, targets, mask, cfg: GPT2Config):
    """Cross-entropy over ``cfg.loss_chunks`` sequence chunks: only one
    chunk's f32 logits exist at a time, each recomputed in the
    backward (``torch.utils.checkpoint``, as the JAX version's
    ``jax.checkpoint``)."""
    B, T, d = hidden.shape
    C = cfg.loss_chunks
    if T % C:
        raise ValueError(f"loss_chunks={C} must divide T={T}")
    Tc = T // C
    wte_c = wte.to(cfg.dtype)
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    count = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c in range(C):
        cols = slice(c * Tc, (c + 1) * Tc)
        s, n = _checkpoint(_chunk_sums, hidden[:, cols], wte_c,
                           targets[:, cols], mask[:, cols], cfg)
        total = total + s
        count = count + n
    return total / count.clamp_min(1.0)


def lm_head_nll(hidden, w_vocab_major, targets, cfg) -> torch.Tensor:
    """Per-token nll through the non-dense CE implementations (the JAX
    ``lm_head_nll``), for gpt2 and any config carrying ce_impl /
    vocab_size / vocab_tile / ce_block_n / ce_block_v / dtype /
    padded_vocab.  hidden (B, T, D); w_vocab_major (V, D), the tied wte
    (the f32 master as it is: the CE casts it inside, so its gradient
    stays f32) or a transposed lm_head; targets (B, T) int.  "pallas"
    takes the fused lm-head + CE kernels (ops/fused_ce.py), otherwise
    the vocab-streamed loop (ops/vocab_ce.py).  Returns (B, T)
    float32."""
    B, T = targets.shape
    h2 = hidden.reshape(B * T, -1)
    t1 = targets.reshape(-1).to(torch.int32)
    if cfg.ce_impl == "pallas":
        nll = fused_lm_ce(h2, w_vocab_major, t1, cfg.vocab_size,
                          block_n=cfg.ce_block_n,
                          block_v=min(cfg.ce_block_v, cfg.padded_vocab),
                          compute_dtype=cfg.dtype)
    else:
        nll = streaming_ce(h2, w_vocab_major, t1, cfg.vocab_size,
                           min(cfg.vocab_tile, cfg.padded_vocab), cfg.dtype)
    return nll.reshape(B, T)


def gpt2_loss(params, batch, cfg: GPT2Config,
              rules=DEFAULT_RULES) -> torch.Tensor:
    """Next-token cross-entropy, a float32 scalar.  batch =
    {"tokens": (B, T+1) int} or {"inputs": (B, T), "targets": (B, T)},
    either with an optional "mask" (B, T); the padded-vocab tail is
    masked out.  With experts, ``moe_aux_weight`` times the summed
    load-balance loss is added.  Under sequence parallelism (module
    docstring) the batch is the global one, split after the shift, and
    the loss is the mean over this rank's slice: the mesh train step's
    mean over the ranks is then the global mean (exactly so without a
    mask; with one, the mean of the slices' masked means)."""
    if "tokens" in batch:
        inputs, targets = batch["tokens"][:, :-1], batch["tokens"][:, 1:]
    else:
        inputs, targets = batch["inputs"], batch["targets"]
    mask = batch.get("mask")
    if mask is not None:
        mask = mask.to(torch.float32)
    shard = _seq_shard(cfg, active_mesh())
    targets, mask = _local_seq(targets, shard), _local_seq(mask, shard)
    hidden, aux = gpt2_hidden(params, inputs, cfg, rules, return_aux=True)
    loss = _ce(hidden, params["wte"], targets, mask, cfg)
    return loss + cfg.moe_aux_weight * aux if cfg.n_experts else loss


def _ce(hidden, wte, targets, mask, cfg: GPT2Config) -> torch.Tensor:
    """The mean (masked) next-token nll of ``hidden`` through the tied
    head, by ``cfg.ce_impl``."""
    if cfg.ce_impl != "dense":
        nll = lm_head_nll(hidden, wte, targets, cfg)
    elif cfg.loss_chunks > 1:
        if mask is None:
            mask = torch.ones(targets.shape, dtype=torch.float32,
                              device=targets.device)
        return _chunked_ce(hidden, wte, targets, mask, cfg)
    else:
        nll = _nll_from_logits(_tied_logits(hidden, wte, cfg), targets, cfg)
    if mask is not None:
        return (nll * mask).sum() / mask.sum().clamp_min(1.0)
    return nll.mean()
