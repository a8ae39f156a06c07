"""Autoregressive decoding with a KV cache for the LLaMA family.

Counterpart of ``ray_tpu/models/llama_decode.py``, dense and paged
layouts (decode_common), shaped as ``gpt2_decode``: one full-sequence
``llama_prefill`` whose attention is the flash kernel on CUDA, one
``llama_decode_step`` per new token, K/V written into the preallocated
cache in place.  Adapted to the llama block: RMSNorm, RoPE at each
row's logical position, grouped-query attention (the cache holds the
KV heads only, post-RoPE and before the head repeat, so its bytes
scale with n_kv_head), SwiGLU, the untied lm_head.
``llama_verify_step`` ingests a (B, k+1) block of speculative-decoding
tokens in one forward.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from ray_tpu_torch.device import DeviceLike, resolve_device
from ray_tpu_torch.models.decode_common import (generate_with, init_pool,
                                                prompt_positions,
                                                scan_prefill, set_pool_row,
                                                slot_mask, tail_attention,
                                                tail_plan, update_kv,
                                                verify_plan,
                                                verify_update_kv)
from ray_tpu_torch.models.gpt2_decode import _layer
from ray_tpu_torch.models.llama import (LlamaConfig, _mlp, _rmsnorm,
                                        repeat_kv, rope_frequencies,
                                        rotate_pairs)
from ray_tpu_torch.ops.attention import prefill_attention

__all__ = ["llama_init_cache", "llama_init_paged_cache", "llama_prefill",
           "llama_paged_prefill", "llama_decode_step", "llama_verify_step",
           "llama_generate"]

_NEG_INF = -1e30


def llama_init_cache(cfg: LlamaConfig, batch: int,
                     device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """(L, B, S, n_kv_head, hd) key/value cache + per-sequence position
    vectors (decode_common cache contract)."""
    dev = resolve_device(device)
    shape = (cfg.n_layer, batch, cfg.max_seq, cfg.n_kv_head, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=dev),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=dev),
            "pos": torch.zeros((batch,), dtype=torch.int32, device=dev),
            "start": torch.zeros((batch,), dtype=torch.int32, device=dev)}


def llama_init_paged_cache(cfg: LlamaConfig, batch: int, *,
                           num_blocks: int, block_size: int,
                           device: DeviceLike = None
                           ) -> Dict[str, torch.Tensor]:
    """Block-pool cache (decode_common paged contract): K/V pools of
    (L, num_blocks, block_size, n_kv_head, hd) shared by all rows,
    per-row block tables at the reserved null block 0."""
    return init_pool(cfg, cfg.n_kv_head, batch, num_blocks, block_size,
                     resolve_device(device))


def _rope_at(x, cos_t, sin_t):
    """Rotate (B, H, hd) by per-row table rows (B, hd/2)."""
    return rotate_pairs(x, cos_t[:, None, :], sin_t[:, None, :])


def _rope_bt(x, cos_bt, sin_bt):
    """Rotate (B, T, H, hd) by per-row, per-column tables (B, T, hd/2):
    the ragged-prefill form of llama.apply_rope, whose (T, hd/2) tables
    assume every row shares one position ladder."""
    return rotate_pairs(x, cos_bt[:, :, None, :], sin_bt[:, :, None, :])


def _qkv(xa, p, cfg: LlamaConfig, lead):
    """q (*lead, n_head, hd), k and v (*lead, n_kv_head, hd) from the
    normed input in the compute dtype."""
    d, h, kv, hd = cfg.d_model, cfg.n_head, cfg.n_kv_head, cfg.head_dim
    xa = xa.to(cfg.dtype)
    q = (xa @ p["wq"].to(cfg.dtype).reshape(d, h * hd)).reshape(*lead, h,
                                                                hd)
    k = (xa @ p["wk"].to(cfg.dtype).reshape(d, kv * hd)).reshape(*lead, kv,
                                                                 hd)
    v = (xa @ p["wv"].to(cfg.dtype).reshape(d, kv * hd)).reshape(*lead, kv,
                                                                 hd)
    return q, k, v


def _out_and_mlp(x, o, p, cfg: LlamaConfig):
    """The block after attention: the output projection of o (..., h,
    hd) into the residual stream, then the SwiGLU half."""
    h, hd = cfg.n_head, cfg.head_dim
    wo = p["attn"]["wo"].to(cfg.dtype).reshape(h * hd, cfg.d_model)
    x = x + (o.reshape(*o.shape[:-2], h * hd) @ wo).to(x.dtype)
    return x + _mlp(_rmsnorm(x, p["ln2"]["scale"], cfg.rms_eps), p["mlp"],
                    cfg)


def _lm_logits(params, x, cfg: LlamaConfig):
    """Final RMSNorm and the untied lm_head: compute dtype, then f32."""
    x = _rmsnorm(x, params["ln_f"]["scale"], cfg.rms_eps)
    return (x.to(cfg.dtype) @ params["lm_head"].to(cfg.dtype)).float()


def llama_prefill(params, tokens: torch.Tensor, cfg: LlamaConfig, *,
                  lengths: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-call prompt ingestion: tokens (B, T0) int → (last_logits (B,
    padded_vocab) float32, primed cache).

    One full-sequence forward; equal-length batches take the flash
    kernel (prefill_attention) with each KV head repeated for its query
    group.  The cache keeps the KV heads only, post-RoPE and before the
    repeat, which is what llama_decode_step reads.  Ragged rows are
    LEFT-padded with ``lengths`` (B,); RoPE follows each row's logical
    positions (pads clip to position 0), so pads never shift a real
    token's rotation."""
    B, T0 = tokens.shape
    h, hd = cfg.n_head, cfg.head_dim
    dev = tokens.device
    cache = llama_init_cache(cfg, B, device=dev)
    start, pos_ids = prompt_positions(lengths, B, T0, dev)
    x = params["wte"].to(cfg.dtype)[tokens.long()]       # (B, T0, d)
    cos, sin = rope_frequencies(cfg.max_seq, hd, cfg.rope_theta, dev)
    cos_p, sin_p = cos[pos_ids], sin[pos_ids]            # (B, T0, hd/2)
    attn_start = None if lengths is None else start
    blocks = params["blocks"]
    for i in range(cfg.n_layer):
        p = _layer(blocks, i)
        q, k, v = _qkv(_rmsnorm(x, p["ln1"]["scale"], cfg.rms_eps),
                       p["attn"], cfg, (B, T0))
        q = _rope_bt(q, cos_p, sin_p)
        k = _rope_bt(k, cos_p, sin_p)
        o = prefill_attention(q, repeat_kv(k, h), repeat_kv(v, h),
                              start=attn_start, use_flash=cfg.use_flash,
                              resident=cfg.flash_resident)
        x = _out_and_mlp(x, o, p, cfg)
        cache["k"][i, :, :T0] = k       # in place: the cache is
        cache["v"][i, :, :T0] = v       # allocated once above
    cache["pos"].fill_(T0)
    cache["start"] = start
    return _lm_logits(params, x[:, -1], cfg), cache  # left pad ⇒ last real


def llama_paged_prefill(params, cache, tokens: torch.Tensor,
                        cfg: LlamaConfig, *, row_bt: torch.Tensor,
                        prefix_len, n_tail, slot
                        ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Prompt-tail ingestion for ONE sequence against the block pool
    (the contract of gpt2_decode.paged_prefill): tokens (1, Tt)
    RIGHT-aligned tail, the prefix's K/V read from the resident blocks
    of row_bt, the tail's K/V (post-RoPE, KV heads only) written into
    the pool in place (pad columns into the null block 0).  RoPE
    follows logical positions and the KV heads are repeated for
    attention as in llama_prefill.  Returns (last-token logits
    (padded_vocab,) float32, the same cache dict)."""
    _, Tt = tokens.shape
    h, kv, hd = cfg.n_head, cfg.n_kv_head, cfg.head_dim
    dev = tokens.device
    plan = tail_plan(cfg, cache["k"].shape[2], Tt, row_bt, prefix_len,
                     n_tail, dev)
    x = params["wte"].to(cfg.dtype)[tokens[0].long()]    # (Tt, d)
    cos, sin = rope_frequencies(cfg.max_seq, hd, cfg.rope_theta, dev)
    cos_p, sin_p = cos[plan["pos_ids"]], sin[plan["pos_ids"]]
    blocks = params["blocks"]
    for i in range(cfg.n_layer):
        p = _layer(blocks, i)
        lk, lv = cache["k"][i], cache["v"][i]            # (nb, bs, kv, hd)
        q, k, v = _qkv(_rmsnorm(x, p["ln1"]["scale"], cfg.rms_eps),
                       p["attn"], cfg, (Tt,))
        q = _rope_at(q, cos_p, sin_p)
        k = _rope_at(k, cos_p, sin_p)
        lk[plan["blk"], plan["off"]] = k
        lv[plan["blk"], plan["off"]] = v
        views = [repeat_kv(pool[plan["row_bt"]].reshape(cfg.max_seq, kv,
                                                         hd), h)
                 for pool in (lk, lv)]
        o = tail_attention(q, *views, plan["mask"], cfg.dtype)
        x = _out_and_mlp(x, o, p, cfg)
    set_pool_row(cache, slot, row_bt, int(prefix_len) + int(n_tail))
    return _lm_logits(params, x[-1], cfg), cache  # right-aligned ⇒ last


def llama_decode_step(params, cache, tokens, cfg: LlamaConfig
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One token per sequence: tokens (B,) int, row b at cache slot
    cache["pos"][b]; RoPE at each row's logical position pos - start.

    Works on both cache layouts (decode_common.is_paged), as
    gpt2_decode.decode_step.  Grouped-query attention runs against the
    KV-head cache with the query heads reshaped to (kv, group), no
    repeat: head j reads KV head j // group, the pairing of the
    prefill's head repeat.  Writes K/V in place and advances ``pos``;
    returns (logits (B, padded_vocab) float32, the same cache dict)."""
    B = tokens.shape[0]
    kv, hd = cfg.n_kv_head, cfg.head_dim
    g = cfg.n_head // kv
    pos = cache["pos"]                                   # (B,)
    start = cache["start"]                               # (B,)
    dev = tokens.device
    rows = torch.arange(B, device=dev)
    x = params["wte"].to(cfg.dtype)[tokens.long()]       # (B, d)
    cos, sin = rope_frequencies(cfg.max_seq, hd, cfg.rope_theta, dev)
    logical = (pos - start).long()
    cos_t, sin_t = cos[logical], sin[logical]            # (B, hd/2)
    attn_mask = slot_mask(start, pos + 1, cfg.max_seq)   # (B, S)
    pos_l = pos.long()
    blocks = params["blocks"]
    for i in range(cfg.n_layer):
        p = _layer(blocks, i)
        q, k_new, v_new = _qkv(_rmsnorm(x, p["ln1"]["scale"], cfg.rms_eps),
                               p["attn"], cfg, (B,))
        q = _rope_at(q, cos_t, sin_t)
        k_new = _rope_at(k_new, cos_t, sin_t)
        ck, cv = update_kv(cache, i, rows, pos_l, k_new, v_new)
        qg = q.reshape(B, kv, g, hd)
        scores = torch.einsum("bkgd,bskd->bkgs", qg, ck).float()
        scores = scores / math.sqrt(hd)
        scores = torch.where(attn_mask[:, None, None, :], scores, _NEG_INF)
        probs = torch.softmax(scores, dim=-1).to(cfg.dtype)
        o = torch.einsum("bkgs,bskd->bkgd", probs, cv)   # (B, kv, g, hd)
        x = _out_and_mlp(x, o.reshape(B, kv * g, hd), p, cfg)
    cache["pos"] = pos + 1
    return _lm_logits(params, x, cfg), cache


def llama_verify_step(params, cache, block, cfg: LlamaConfig
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Speculative-decoding verify forward, llama flavour (the contract
    of gpt2_decode.verify_step): block (B, T=k+1) int = [cur, d_1..d_k],
    one forward giving logits (B, T, padded_vocab) equal to T sequential
    llama_decode_step calls.  RoPE rotates each (row, column) at its own
    logical position (_rope_bt); GQA attends through the KV-head cache
    with the (kv, group) query reshape.  Writes past max_seq go to the
    null block (paged) or are dropped (dense); pos is NOT advanced."""
    B, T = block.shape
    kv, hd = cfg.n_kv_head, cfg.head_dim
    g = cfg.n_head // kv
    plan = verify_plan(cache, T, cfg.max_seq)
    x = params["wte"].to(cfg.dtype)[block.long()]        # (B, T, d)
    cos, sin = rope_frequencies(cfg.max_seq, hd, cfg.rope_theta,
                                block.device)
    cos_p, sin_p = cos[plan["pos_ids"]], sin[plan["pos_ids"]]
    blocks = params["blocks"]
    for i in range(cfg.n_layer):
        p = _layer(blocks, i)
        q, k_new, v_new = _qkv(_rmsnorm(x, p["ln1"]["scale"], cfg.rms_eps),
                               p["attn"], cfg, (B, T))
        q = _rope_bt(q, cos_p, sin_p)
        k_new = _rope_bt(k_new, cos_p, sin_p)
        ck, cv = verify_update_kv(cache, i, plan, k_new, v_new)
        qg = q.reshape(B, T, kv, g, hd)
        scores = torch.einsum("btkgd,bskd->bkgts", qg, ck).float()
        scores = scores / math.sqrt(hd)
        scores = torch.where(plan["mask"][:, None, None], scores, _NEG_INF)
        probs = torch.softmax(scores, dim=-1).to(cfg.dtype)
        o = torch.einsum("bkgts,bskd->btkgd", probs, cv)
        x = _out_and_mlp(x, o.reshape(B, T, kv * g, hd), p, cfg)
    return _lm_logits(params, x, cfg), cache


def _scan_prefill(params, tokens, cfg, *, lengths=None):
    """prefill-shaped wrapper over the per-token reference loop."""
    if lengths is not None:
        raise ValueError("prefill_impl='scan' is the equal-length "
                         "reference path; ragged prompts need the "
                         "batched prefill")
    return scan_prefill(llama_init_cache, llama_decode_step, params,
                        tokens, cfg)


def llama_generate(params, prompt: torch.Tensor, cfg: LlamaConfig, *,
                   max_new_tokens: int, temperature: float = 1.0,
                   top_k: int = 0, top_p: float = 1.0,
                   lengths: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None,
                   prefill_impl: str = "batched",
                   kv_layout: str = "dense",
                   kv_block_size: int = 16) -> torch.Tensor:
    """LLaMA generation (see decode_common.generate_with).  ``lengths``
    marks LEFT-padded ragged prompts; prefill_impl="scan" keeps the
    per-token reference prefill for parity testing; kv_layout="paged"
    decodes through the block-pool layout (dense is its oracle)."""
    if prefill_impl not in ("batched", "scan"):
        raise ValueError(f"prefill_impl must be 'batched' or 'scan', got "
                         f"{prefill_impl!r}")
    prefill_fn = llama_prefill if prefill_impl == "batched" \
        else _scan_prefill
    return generate_with(prefill_fn, llama_decode_step, params, prompt, cfg,
                         max_new_tokens=max_new_tokens, lengths=lengths,
                         temperature=temperature, top_k=top_k,
                         top_p=top_p, generator=generator,
                         kv_layout=kv_layout, kv_block_size=kv_block_size)
