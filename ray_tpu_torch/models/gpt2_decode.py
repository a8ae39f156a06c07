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
functional update would make).  ``verify_step`` ingests a (B, k+1)
block of speculative-decoding tokens in one forward.

Under an active mesh whose ``tensor`` axis is above 1 every function
is tensor-parallel on this rank's blocks (decode_common's module
docstring): the local heads (``qkv_w``'s), the local MLP columns, the
vocab block of ``wte``; ``init_cache``/``init_paged_cache`` with
``mesh=`` build this rank's share of the pool.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ray_tpu_torch.device import DeviceLike, resolve_device
from ray_tpu_torch.models.decode_common import (generate_with, init_pool,
                                                partitioned_cache_init,
                                                prompt_positions,
                                                scan_prefill,
                                                set_pool_row, slot_mask,
                                                tail_attention, tail_plan,
                                                tensor_parallel, tp_embed,
                                                tp_logits, tp_sum,
                                                update_kv, verify_plan,
                                                verify_update_kv)
from ray_tpu_torch.models.gpt2 import GPT2Config, _layernorm
from ray_tpu_torch.ops.attention import prefill_attention

__all__ = ["init_cache", "init_paged_cache", "prefill", "paged_prefill",
           "decode_step", "verify_step", "generate"]

_NEG_INF = -1e30


def _check_dense_ffn(cfg: GPT2Config) -> None:
    if cfg.n_experts:
        raise NotImplementedError(
            "KV-cache decoding currently supports dense GPT-2 configs "
            "only (n_experts=0); MoE decode needs per-step routing")


def init_cache(cfg: GPT2Config, batch: int, device: DeviceLike = None,
               mesh=None) -> Dict[str, torch.Tensor]:
    """Preallocated (L, B, S, H, hd) key/value cache + per-sequence
    position vectors (decode_common cache contract).  With ``mesh``,
    born partitioned: this rank's heads only (heads over ``tensor``)."""
    _check_dense_ffn(cfg)
    dev = resolve_device(device)
    shape = (cfg.n_layer, batch, cfg.max_seq, cfg.n_head, cfg.head_dim)

    def build(d):
        return {"k": torch.zeros(shape, dtype=cfg.dtype, device=d),
                "v": torch.zeros(shape, dtype=cfg.dtype, device=d),
                "pos": torch.zeros((batch,), dtype=torch.int32, device=d),
                "start": torch.zeros((batch,), dtype=torch.int32,
                                     device=d)}

    if mesh is None:
        return build(dev)
    return partitioned_cache_init(build, mesh, device=dev)


def init_paged_cache(cfg: GPT2Config, batch: int, *, num_blocks: int,
                     block_size: int, device: DeviceLike = None,
                     mesh=None) -> Dict[str, torch.Tensor]:
    """Block-pool cache (decode_common paged contract): K/V pools of
    (L, num_blocks, block_size, H, hd) shared by all rows, per-row
    block tables at the reserved null block 0 (a row holds no storage
    until blocks are assigned to it).  With ``mesh``, born partitioned:
    the pool's heads over ``tensor``, block tables, pos and start
    whole, so the host pager reads them as it does without one."""
    _check_dense_ffn(cfg)
    dev = resolve_device(device)

    def build(d):
        return init_pool(cfg, cfg.n_head, batch, num_blocks, block_size, d)

    if mesh is None:
        return build(dev)
    return partitioned_cache_init(build, mesh, device=dev)


def _layer(blocks, i: int):
    """Layer i's slice of the stacked block parameters."""
    return {name: ({k: v[i] for k, v in sub.items()})
            for name, sub in blocks.items()}


def _mlp(x, p, cfg: GPT2Config, tp=None):
    xm = _layernorm(x, p["ln2"]["scale"], p["ln2"]["bias"])
    # jax.nn.gelu defaults to the tanh approximation
    fc_w = p["mlp"]["fc_w"]
    hmid = F.gelu(xm @ fc_w.to(cfg.dtype)
                  + p["mlp"]["fc_b"].to(cfg.dtype), approximate="tanh")
    down = tp_sum(hmid @ p["mlp"]["proj_w"].to(cfg.dtype), tp,
                  fc_w.shape[-1] != cfg.d_ff)
    return x + (down + p["mlp"]["proj_b"].to(cfg.dtype))


def _attn_out(x, o, p, cfg: GPT2Config, tp):
    """x plus the output projection of the local heads' o (..., h, hd),
    all-reduced over ``tensor`` where the heads are split, and o_b."""
    h, hd = o.shape[-2], o.shape[-1]
    wo = p["attn"]["o_w"].to(cfg.dtype).reshape(h * hd, cfg.d_model)
    proj = tp_sum(o.reshape(*o.shape[:-2], h * hd) @ wo, tp,
                  h != cfg.n_head)
    return x + (proj + p["attn"]["o_b"].to(cfg.dtype))


def _qkv(xa, p, cfg: GPT2Config, lead):
    """q, k, v (*lead, h, hd) of this rank's heads (h: the local
    ``qkv_w``'s)."""
    w = p["attn"]["qkv_w"]
    d, h, hd = cfg.d_model, w.shape[-2], cfg.head_dim
    qkv = (xa @ w.to(cfg.dtype).reshape(d, 3 * h * hd)).reshape(
        *lead, 3, h, hd) + p["attn"]["qkv_b"].to(cfg.dtype)
    return qkv.unbind(-3)


def _embed(params, tokens, cfg: GPT2Config, tp):
    return tp_embed(params["wte"].to(cfg.dtype), tokens, cfg.padded_vocab,
                    tp)


def _logits(params, x, cfg: GPT2Config, tp=None):
    """Final LayerNorm and the tied lm head: compute dtype, then f32
    (this rank's vocab block all-gathered under tensor parallelism)."""
    x = _layernorm(x, params["ln_f"]["scale"], params["ln_f"]["bias"])
    return tp_logits((x @ params["wte"].to(cfg.dtype).T).float(),
                     cfg.padded_vocab, tp)


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
    dev = tokens.device
    tp = tensor_parallel()
    # the cache holds the heads the parameters do (a replicated draft
    # under a mesh holds them all)
    split = params["blocks"]["attn"]["qkv_w"].shape[-2] != cfg.n_head
    cache = init_cache(cfg, B, device=dev,
                       mesh=tp[0] if tp is not None and split else None)
    start, pos_ids = prompt_positions(lengths, B, T0, dev)
    x = _embed(params, tokens, cfg, tp)                  # (B, T0, d)
    x = x + params["wpe"].to(cfg.dtype)[pos_ids]
    attn_start = None if lengths is None else start
    blocks = params["blocks"]
    for i in range(cfg.n_layer):
        p = _layer(blocks, i)
        xa = _layernorm(x, p["ln1"]["scale"], p["ln1"]["bias"])
        q, k, v = _qkv(xa, p, cfg, (B, T0))
        o = prefill_attention(q, k, v, start=attn_start,
                              use_flash=cfg.use_flash,
                              resident=cfg.flash_resident)
        x = _mlp(_attn_out(x, o, p, cfg, tp), p, cfg, tp)
        cache["k"][i, :, :T0] = k       # in place: the cache is
        cache["v"][i, :, :T0] = v       # allocated once above
    cache["pos"].fill_(T0)
    cache["start"] = start
    # left pad ⇒ last real
    return _logits(params, x[:, -1], cfg, tp), cache


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
    tp = tensor_parallel()
    plan = tail_plan(cfg, cache["k"].shape[2], Tt, row_bt, prefix_len,
                     n_tail, tokens.device)
    x = _embed(params, tokens[0], cfg, tp)                # (Tt, d)
    x = x + params["wpe"].to(cfg.dtype)[plan["pos_ids"]]
    blocks = params["blocks"]
    for i in range(cfg.n_layer):
        p = _layer(blocks, i)
        lk, lv = cache["k"][i], cache["v"][i]             # (nb, bs, h, hd)
        xa = _layernorm(x, p["ln1"]["scale"], p["ln1"]["bias"])
        q, k, v = _qkv(xa, p, cfg, (Tt,))                 # (Tt, h, hd)
        lk[plan["blk"], plan["off"]] = k
        lv[plan["blk"], plan["off"]] = v
        view = (cfg.max_seq,) + tuple(k.shape[1:])
        o = tail_attention(q, lk[plan["row_bt"]].reshape(view),
                           lv[plan["row_bt"]].reshape(view), plan["mask"],
                           cfg.dtype)
        x = _mlp(_attn_out(x, o, p, cfg, tp), p, cfg, tp)
    set_pool_row(cache, slot, row_bt, int(prefix_len) + int(n_tail))
    # right-aligned ⇒ last
    return _logits(params, x[-1], cfg, tp), cache


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
    hd = cfg.head_dim
    tp = tensor_parallel()
    pos = cache["pos"]                                   # (B,)
    start = cache["start"]                               # (B,)
    rows = torch.arange(B, device=tokens.device)
    x = _embed(params, tokens, cfg, tp)                  # (B, d)
    x = x + params["wpe"].to(cfg.dtype)[(pos - start).long()]
    # per-slot mask: start[b] <= s <= pos[b] (current token included)
    attn_mask = slot_mask(start, pos + 1, cfg.max_seq)   # (B, S)
    pos_l = pos.long()
    blocks = params["blocks"]
    for i in range(cfg.n_layer):
        p = _layer(blocks, i)
        xa = _layernorm(x, p["ln1"]["scale"], p["ln1"]["bias"])
        q, k_new, v_new = _qkv(xa, p, cfg, (B,))          # (B, h, hd)
        ck, cv = update_kv(cache, i, rows, pos_l, k_new, v_new)
        scores = torch.einsum("bhd,bshd->bhs", q, ck).float()
        scores = scores / math.sqrt(hd)
        scores = torch.where(attn_mask[:, None, :], scores, _NEG_INF)
        probs = torch.softmax(scores, dim=-1).to(cfg.dtype)
        o = torch.einsum("bhs,bshd->bhd", probs, cv)     # (B, h, hd)
        x = _mlp(_attn_out(x, o, p, cfg, tp), p, cfg, tp)
    cache["pos"] = pos + 1
    return _logits(params, x, cfg, tp), cache


def verify_step(params, cache, block, cfg: GPT2Config
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Speculative-decoding verify forward: T = k+1 tokens per row in
    one forward.  block (B, T) int is [cur, d_1..d_k], the last sampled
    token (no K/V yet) and the draft's k proposals; row b's t-th token
    lands at slot pos[b] + t, and logits[:, t] is the distribution for
    the token after block[:, t], what T sequential decode_step calls
    give.  Both cache layouts; per-row pos/start as decode_step, causal
    within the block.  Writes past max_seq (a request's last rounds)
    go to the null block (paged) or are dropped (dense)
    (decode_common.verify_plan).  pos is NOT advanced: the caller
    (decode_common.make_spec_verify) moves it by the kept count.
    Returns (logits (B, T, padded_vocab) float32, the same cache
    dict)."""
    B, T = block.shape
    hd = cfg.head_dim
    tp = tensor_parallel()
    plan = verify_plan(cache, T, cfg.max_seq)
    x = _embed(params, block, cfg, tp)                   # (B, T, d)
    x = x + params["wpe"].to(cfg.dtype)[plan["pos_ids"]]
    blocks = params["blocks"]
    for i in range(cfg.n_layer):
        p = _layer(blocks, i)
        xa = _layernorm(x, p["ln1"]["scale"], p["ln1"]["bias"])
        q, k_new, v_new = _qkv(xa, p, cfg, (B, T))
        ck, cv = verify_update_kv(cache, i, plan, k_new, v_new)
        scores = torch.einsum("bthd,bshd->bhts", q, ck).float()
        scores = scores / math.sqrt(hd)
        scores = torch.where(plan["mask"][:, None], scores, _NEG_INF)
        probs = torch.softmax(scores, dim=-1).to(cfg.dtype)
        o = torch.einsum("bhts,bshd->bthd", probs, cv)   # (B, T, h, hd)
        x = _mlp(_attn_out(x, o, p, cfg, tp), p, cfg, tp)
    return _logits(params, x, cfg, tp), cache


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
