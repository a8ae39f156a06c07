"""Autoregressive decoding with a KV cache for the GPT-2 family.

Counterpart of ``ray_tpu/models/gpt2_decode.py``, dense layout.  The
prompt goes in with one full-sequence forward (``prefill``) whose
attention is the flash kernel on CUDA; each new token is one
``decode_step`` against the cache.  The layer stack is a Python loop
over the stacked per-layer parameters, eager, with K/V written into
the preallocated cache in place (one cache allocation per generation,
instead of the new cache per step that a functional update would
make).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ray_tpu_torch.device import DeviceLike, resolve_device
from ray_tpu_torch.models.decode_common import (generate_with,
                                                scan_prefill, slot_mask)
from ray_tpu_torch.models.gpt2 import GPT2Config, _layernorm
from ray_tpu_torch.ops.attention import prefill_attention

__all__ = ["init_cache", "prefill", "decode_step", "generate"]

_NEG_INF = -1e30


def init_cache(cfg: GPT2Config, batch: int,
               device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """Preallocated (L, B, S, H, hd) key/value cache + per-sequence
    position vectors (decode_common cache contract)."""
    if cfg.n_experts:
        raise NotImplementedError(
            "KV-cache decoding currently supports dense GPT-2 configs "
            "only (n_experts=0); MoE decode needs per-step routing")
    dev = resolve_device(device)
    shape = (cfg.n_layer, batch, cfg.max_seq, cfg.n_head, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=dev),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=dev),
            "pos": torch.zeros((batch,), dtype=torch.int32, device=dev),
            "start": torch.zeros((batch,), dtype=torch.int32, device=dev)}


def _layer(blocks, i: int):
    """Layer i's slice of the stacked block parameters."""
    return {name: ({k: v[i] for k, v in sub.items()})
            for name, sub in blocks.items()}


def _mlp(x, p, cfg: GPT2Config):
    xm = _layernorm(x, p["ln2"]["scale"], p["ln2"]["bias"])
    # jax.nn.gelu defaults to the tanh approximation
    hmid = F.gelu(xm @ p["mlp"]["fc_w"].to(cfg.dtype)
                  + p["mlp"]["fc_b"].to(cfg.dtype), approximate="tanh")
    return x + (hmid @ p["mlp"]["proj_w"].to(cfg.dtype)
                + p["mlp"]["proj_b"].to(cfg.dtype))


def _logits(params, x, cfg: GPT2Config):
    """Final LayerNorm and the tied lm head: compute dtype, then f32."""
    x = _layernorm(x, params["ln_f"]["scale"], params["ln_f"]["bias"])
    return (x @ params["wte"].to(cfg.dtype).T).float()


def prefill(params, tokens: torch.Tensor, cfg: GPT2Config, *,
            lengths: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-call prompt ingestion: tokens (B, T0) int →
    (last_logits (B, padded_vocab) float32, primed cache).

    One full-sequence forward (flash kernel under the attention
    dispatch rule) writes K/V for all T0 positions.  Ragged batches
    pass ``lengths`` (B,): rows are LEFT-padded, so row b's real
    tokens sit at columns [T0 - lengths[b], T0) and the last real
    token is column T0-1 for every row; logits come from that one
    column, never the full (B, T0, V) tensor."""
    B, T0 = tokens.shape
    d, h, hd = cfg.d_model, cfg.n_head, cfg.head_dim
    dev = tokens.device
    cache = init_cache(cfg, B, device=dev)
    cols = torch.arange(T0, device=dev, dtype=torch.int32)
    if lengths is None:
        start = torch.zeros((B,), dtype=torch.int32, device=dev)
        pos_ids = cols[None, :].expand(B, T0)
    else:
        start = (T0 - lengths.to(device=dev, dtype=torch.int32))
        # pad columns clip to wpe row 0: garbage the attention mask
        # keeps unread
        pos_ids = (cols[None, :] - start[:, None]).clamp_min(0)
    x = params["wte"].to(cfg.dtype)[tokens.long()]       # (B, T0, d)
    x = x + params["wpe"].to(cfg.dtype)[pos_ids.long()]
    attn_start = None if lengths is None else start
    blocks = params["blocks"]
    for i in range(cfg.n_layer):
        p = _layer(blocks, i)
        xa = _layernorm(x, p["ln1"]["scale"], p["ln1"]["bias"])
        w = p["attn"]["qkv_w"].to(cfg.dtype).reshape(d, 3 * h * hd)
        qkv = (xa @ w).reshape(B, T0, 3, h, hd) \
            + p["attn"]["qkv_b"].to(cfg.dtype)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        o = prefill_attention(q, k, v, start=attn_start,
                              use_flash=cfg.use_flash,
                              resident=cfg.flash_resident)
        wo = p["attn"]["o_w"].to(cfg.dtype).reshape(h * hd, d)
        x = x + (o.reshape(B, T0, h * hd) @ wo
                 + p["attn"]["o_b"].to(cfg.dtype))
        x = _mlp(x, p, cfg)
        cache["k"][i, :, :T0] = k       # in place: the cache is
        cache["v"][i, :, :T0] = v       # allocated once above
    cache["pos"].fill_(T0)
    cache["start"] = start
    return _logits(params, x[:, -1], cfg), cache  # left pad ⇒ last real


def decode_step(params, cache, tokens, cfg: GPT2Config
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One token per sequence: tokens (B,) int, row b at cache slot
    cache["pos"][b] (rows may sit at different depths).

    Writes K/V into the cache in place and advances ``pos``; returns
    (logits (B, padded_vocab) float32, the same cache dict)."""
    B = tokens.shape[0]
    d, h, hd = cfg.d_model, cfg.n_head, cfg.head_dim
    pos = cache["pos"]                                   # (B,)
    start = cache["start"]                               # (B,)
    rows = torch.arange(B, device=tokens.device)
    x = params["wte"].to(cfg.dtype)[tokens.long()]       # (B, d)
    x = x + params["wpe"].to(cfg.dtype)[(pos - start).long()]
    # per-slot mask: start[b] <= s <= pos[b] (current token included)
    attn_mask = slot_mask(start, pos + 1, cfg.max_seq)   # (B, S)
    pos_l = pos.long()
    blocks = params["blocks"]
    for i in range(cfg.n_layer):
        p = _layer(blocks, i)
        lk, lv = cache["k"][i], cache["v"][i]            # (B, S, H, hd)
        xa = _layernorm(x, p["ln1"]["scale"], p["ln1"]["bias"])
        w = p["attn"]["qkv_w"].to(cfg.dtype).reshape(d, 3 * h * hd)
        qkv = (xa @ w).reshape(B, 3, h, hd) \
            + p["attn"]["qkv_b"].to(cfg.dtype)
        q, k_new, v_new = qkv[:, 0], qkv[:, 1], qkv[:, 2]  # (B,h,hd)
        lk[rows, pos_l] = k_new                 # in place: row b → slot
        lv[rows, pos_l] = v_new                 # pos[b] of the cache
        scores = torch.einsum("bhd,bshd->bhs", q, lk).float()
        scores = scores / math.sqrt(hd)
        scores = torch.where(attn_mask[:, None, :], scores, _NEG_INF)
        probs = torch.softmax(scores, dim=-1).to(cfg.dtype)
        o = torch.einsum("bhs,bshd->bhd", probs, lv)     # (B,h,hd)
        wo = p["attn"]["o_w"].to(cfg.dtype).reshape(h * hd, d)
        x = x + (o.reshape(B, h * hd) @ wo
                 + p["attn"]["o_b"].to(cfg.dtype))
        x = _mlp(x, p, cfg)
    cache["pos"] = pos + 1
    return _logits(params, x, cfg), cache


def _scan_prefill(params, tokens, cfg, *, lengths=None):
    """prefill-shaped wrapper over the per-token reference loop."""
    if lengths is not None:
        raise ValueError("prefill_impl='scan' is the equal-length "
                         "reference path; ragged prompts need the "
                         "batched prefill")
    return scan_prefill(init_cache, decode_step, params, tokens, cfg)


def generate(params, prompt: torch.Tensor, cfg: GPT2Config, *,
             max_new_tokens: int, temperature: float = 1.0,
             top_k: int = 0, top_p: float = 1.0,
             lengths: Optional[torch.Tensor] = None,
             generator: Optional[torch.Generator] = None,
             prefill_impl: str = "batched",
             kv_layout: str = "dense") -> torch.Tensor:
    """GPT-2 generation (see decode_common.generate_with).  ``lengths``
    marks LEFT-padded ragged prompts; prefill_impl="scan" keeps the
    per-token reference prefill for parity testing."""
    if prefill_impl not in ("batched", "scan"):
        raise ValueError(f"prefill_impl must be 'batched' or 'scan', got "
                         f"{prefill_impl!r}")
    prefill_fn = prefill if prefill_impl == "batched" else _scan_prefill
    return generate_with(prefill_fn, decode_step, params, prompt, cfg,
                         max_new_tokens=max_new_tokens, lengths=lengths,
                         temperature=temperature, top_k=top_k,
                         top_p=top_p, generator=generator,
                         kv_layout=kv_layout)
