"""Autoregressive decoding with a KV cache for the GPT-2 family.

Counterpart of ``ray_tpu/models/gpt2_decode.py``, dense and paged
layouts (decode_common).  The prompt goes in with one full-sequence
forward (``prefill``) whose attention is the flash kernel on CUDA; each
new token is one ``decode_step`` against the cache, either layout.
``paged_prefill`` ingests one sequence's prompt tail against the block
pool, reading a resident prefix instead of recomputing it.  The layer
stack is a Python loop over the stacked per-layer parameters, eager,
with K/V written into the preallocated cache in place (one cache
allocation per generation, instead of the new cache per step that a
functional update would make).  ``verify_step`` (speculative decoding)
is ROADMAP.md queue 1 item 3.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ray_tpu_torch.device import DeviceLike, resolve_device
from ray_tpu_torch.models.decode_common import (generate_with, init_pool,
                                                prompt_positions,
                                                scan_prefill,
                                                set_pool_row, slot_mask,
                                                tail_attention, tail_plan,
                                                update_kv)
from ray_tpu_torch.models.gpt2 import GPT2Config, _layernorm
from ray_tpu_torch.ops.attention import prefill_attention

__all__ = ["init_cache", "init_paged_cache", "prefill", "paged_prefill",
           "decode_step", "generate"]

_NEG_INF = -1e30


def _check_dense_ffn(cfg: GPT2Config) -> None:
    if cfg.n_experts:
        raise NotImplementedError(
            "KV-cache decoding currently supports dense GPT-2 configs "
            "only (n_experts=0); MoE decode needs per-step routing")


def init_cache(cfg: GPT2Config, batch: int,
               device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """Preallocated (L, B, S, H, hd) key/value cache + per-sequence
    position vectors (decode_common cache contract)."""
    _check_dense_ffn(cfg)
    dev = resolve_device(device)
    shape = (cfg.n_layer, batch, cfg.max_seq, cfg.n_head, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=dev),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=dev),
            "pos": torch.zeros((batch,), dtype=torch.int32, device=dev),
            "start": torch.zeros((batch,), dtype=torch.int32, device=dev)}


def init_paged_cache(cfg: GPT2Config, batch: int, *, num_blocks: int,
                     block_size: int,
                     device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """Block-pool cache (decode_common paged contract): K/V pools of
    (L, num_blocks, block_size, H, hd) shared by all rows, per-row
    block tables at the reserved null block 0 (a row holds no storage
    until blocks are assigned to it)."""
    _check_dense_ffn(cfg)
    return init_pool(cfg, cfg.n_head, batch, num_blocks, block_size,
                     resolve_device(device))


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
    start, pos_ids = prompt_positions(lengths, B, T0, dev)
    x = params["wte"].to(cfg.dtype)[tokens.long()]       # (B, T0, d)
    x = x + params["wpe"].to(cfg.dtype)[pos_ids]
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


def paged_prefill(params, cache, tokens: torch.Tensor, cfg: GPT2Config, *,
                  row_bt: torch.Tensor, prefix_len, n_tail, slot
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Prompt-tail ingestion for ONE sequence against the block pool:
    the prefix-reuse path (and, with prefix_len=0, the cold path).

    tokens (1, Tt) int is the prompt tail RIGHT-aligned in its bucket
    (left-padded, so the last real token is column Tt-1); ``n_tail`` of
    them are real and land at logical positions [prefix_len, prefix_len
    + n_tail).  row_bt (max_seq // block_size,) int is the row's full
    block table: the blocks under prefix_len are resident and are read,
    not recomputed.  The tail's K/V are written into the pool in place
    (pad columns into the null block 0); row ``slot``'s table, pos and
    start are set.  Returns (last-token logits (padded_vocab,) float32,
    the same cache dict)."""
    _, Tt = tokens.shape
    d, h, hd = cfg.d_model, cfg.n_head, cfg.head_dim
    plan = tail_plan(cfg, cache["k"].shape[2], Tt, row_bt, prefix_len,
                     n_tail, tokens.device)
    x = params["wte"].to(cfg.dtype)[tokens[0].long()]     # (Tt, d)
    x = x + params["wpe"].to(cfg.dtype)[plan["pos_ids"]]
    blocks = params["blocks"]
    for i in range(cfg.n_layer):
        p = _layer(blocks, i)
        lk, lv = cache["k"][i], cache["v"][i]             # (nb, bs, H, hd)
        xa = _layernorm(x, p["ln1"]["scale"], p["ln1"]["bias"])
        w = p["attn"]["qkv_w"].to(cfg.dtype).reshape(d, 3 * h * hd)
        qkv = (xa @ w).reshape(Tt, 3, h, hd) \
            + p["attn"]["qkv_b"].to(cfg.dtype)
        q, k, v = qkv[:, 0], qkv[:, 1], qkv[:, 2]         # (Tt, h, hd)
        lk[plan["blk"], plan["off"]] = k
        lv[plan["blk"], plan["off"]] = v
        o = tail_attention(
            q, lk[plan["row_bt"]].reshape(cfg.max_seq, h, hd),
            lv[plan["row_bt"]].reshape(cfg.max_seq, h, hd), plan["mask"],
            cfg.dtype)
        wo = p["attn"]["o_w"].to(cfg.dtype).reshape(h * hd, d)
        x = x + (o.reshape(Tt, h * hd) @ wo + p["attn"]["o_b"].to(cfg.dtype))
        x = _mlp(x, p, cfg)
    set_pool_row(cache, slot, row_bt, int(prefix_len) + int(n_tail))
    return _logits(params, x[-1], cfg), cache     # right-aligned ⇒ last


def decode_step(params, cache, tokens, cfg: GPT2Config
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One token per sequence: tokens (B,) int, row b at cache slot
    cache["pos"][b] (rows may sit at different depths).

    Works on both cache layouts (decode_common.is_paged): a dense cache
    takes the token at slot pos[b] of its (B, S, ...) layer; a paged
    one in the row's pool block, attending over the gathered block
    view, which is value-identical to the dense layer.  Writes K/V in
    place and advances ``pos``; returns (logits (B, padded_vocab)
    float32, the same cache dict)."""
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
        xa = _layernorm(x, p["ln1"]["scale"], p["ln1"]["bias"])
        w = p["attn"]["qkv_w"].to(cfg.dtype).reshape(d, 3 * h * hd)
        qkv = (xa @ w).reshape(B, 3, h, hd) \
            + p["attn"]["qkv_b"].to(cfg.dtype)
        q, k_new, v_new = qkv[:, 0], qkv[:, 1], qkv[:, 2]  # (B,h,hd)
        ck, cv = update_kv(cache, i, rows, pos_l, k_new, v_new)
        scores = torch.einsum("bhd,bshd->bhs", q, ck).float()
        scores = scores / math.sqrt(hd)
        scores = torch.where(attn_mask[:, None, :], scores, _NEG_INF)
        probs = torch.softmax(scores, dim=-1).to(cfg.dtype)
        o = torch.einsum("bhs,bshd->bhd", probs, cv)     # (B,h,hd)
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
             kv_layout: str = "dense",
             kv_block_size: int = 16) -> torch.Tensor:
    """GPT-2 generation (see decode_common.generate_with).  ``lengths``
    marks LEFT-padded ragged prompts; prefill_impl="scan" keeps the
    per-token reference prefill for parity testing; kv_layout="paged"
    decodes through the block-pool layout (dense is its oracle)."""
    if prefill_impl not in ("batched", "scan"):
        raise ValueError(f"prefill_impl must be 'batched' or 'scan', got "
                         f"{prefill_impl!r}")
    prefill_fn = prefill if prefill_impl == "batched" else _scan_prefill
    return generate_with(prefill_fn, decode_step, params, prompt, cfg,
                         max_new_tokens=max_new_tokens, lengths=lengths,
                         temperature=temperature, top_k=top_k,
                         top_p=top_p, generator=generator,
                         kv_layout=kv_layout, kv_block_size=kv_block_size)
