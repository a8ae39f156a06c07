"""The generation machinery shared by decoder families.

Counterpart of ``ray_tpu/models/decode_common.py``.  A family module
(gpt2_decode, llama_decode) supplies its (init_cache, prefill,
decode_step) functions; this module owns sampling, the generation loop
and the block-paged layout's helpers.

Cache contract (as in the JAX package):

  k, v  : (L, B, S, H, hd) preallocated at cfg.max_seq
  pos   : (B,) int32 — next cache slot each sequence writes
  start : (B,) int32 — first valid slot (the left-pad offset); the
          logical position of the token at slot s is s - start[b]

Slot s is attendable for row b iff start[b] <= s <= pos[b] (after the
current token's K/V lands at slot pos[b]).

Paged layout: K/V live in a pool of fixed-size blocks shared by all
rows,

  k, v          : (L, num_blocks, block_size, ...) preallocated pool
  block_tables  : (B, S // block_size) int32 — row b's j-th entry names
                  the pool block holding slots [j*bs, (j+1)*bs); block 0
                  is the reserved null block (never allocated, absorbs
                  masked pad writes)
  pos, start    : unchanged

A decode step writes the new token at (block_tables[b, pos//bs],
pos % bs) and attends over the row's blocks gathered in table order,
which hold exactly what the dense cache holds slot for slot, so the
attention numerics are bit-identical between layouts and the dense
layout stays the parity oracle.  Where the JAX package updates the pool
functionally (``.at[].set``), the port writes it in place, as the dense
path does.  The host-side pager and the continuous engine that drive
the pool are ROADMAP.md queue 1 item 3.

JAX threads ``jax.random`` keys; the port draws from a
``torch.Generator``.  The two give different numbers from one seed, so
sampled outputs are compared by distribution, greedy ones token for
token.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import torch

_NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Sampling knobs.  top_k=0 disables the top-k filter; top_p=1.0
    disables nucleus filtering; temperature 0 is greedy (filters
    become no-ops since argmax of a superset equals argmax of the kept
    set's union with -inf tails)."""
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0

    def __post_init__(self):
        if self.temperature < 0.0:
            raise ValueError(
                f"temperature must be >= 0, got {self.temperature}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {self.top_k}")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(
                f"top_p must be in (0, 1], got {self.top_p}")


def slot_mask(start: torch.Tensor, end: torch.Tensor,
              max_seq: int) -> torch.Tensor:
    """(B, S) bool — cache slots holding attendable K/V per row:
    start[b] <= s < end[b] (end exclusive)."""
    s = torch.arange(max_seq, device=start.device)
    return (s[None, :] >= start[:, None]) & (s[None, :] < end[:, None])


def make_vocab_tail_mask(cfg, device) -> Optional[torch.Tensor]:
    """(padded_vocab,) bool mask, True on the real vocab, built once per
    generation so sampling is a single torch.where.  None when nothing
    is padded."""
    if cfg.padded_vocab == cfg.vocab_size:
        return None
    return torch.arange(cfg.padded_vocab, device=device) < cfg.vocab_size


def _mask_to_top_k(logits, top_k: int):
    """Keep only entries >= the k-th largest per row (last axis); ties
    at the threshold all survive.  Any leading batch dims."""
    kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
    return torch.where(logits >= kth, logits, _NEG_INF)


def _mask_to_top_p(logits, top_p: float):
    """Nucleus filter over the last axis: keep the smallest
    descending-probability prefix whose mass reaches top_p.  A token
    is kept iff the mass strictly before it is < top_p, so the top-1
    token always survives.  Works on logits already scaled by
    temperature."""
    order = torch.argsort(-logits, dim=-1, stable=True)
    sorted_logits = torch.gather(logits, -1, order)
    probs = torch.softmax(sorted_logits.float(), dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep_sorted = (cum - probs) < top_p
    inv = torch.argsort(order, dim=-1, stable=True)
    keep = torch.gather(keep_sorted, -1, inv)
    return torch.where(keep, logits, _NEG_INF)


def filter_logits(logits, temperature: float,
                  tail_mask: Optional[torch.Tensor],
                  top_k: int = 0, top_p: float = 1.0):
    """Temperature-scale then apply the tail/top-k/top-p masks; returns
    the filtered logits the categorical draw uses.  temperature must be
    > 0."""
    if tail_mask is not None:
        logits = torch.where(tail_mask, logits, _NEG_INF)
    scaled = logits / temperature
    if top_k > 0:
        scaled = _mask_to_top_k(scaled, top_k)
    if top_p < 1.0:
        scaled = _mask_to_top_p(scaled, top_p)
    return scaled


def sample_token(logits, generator: Optional[torch.Generator],
                 temperature: float, tail_mask: Optional[torch.Tensor],
                 top_k: int = 0, top_p: float = 1.0) -> torch.Tensor:
    """(B, padded_vocab) logits → (B,) int32 token; the padded vocab
    tail can never be sampled.  temperature 0 = greedy: argmax, ties to
    the first index as in JAX (the generator and the filters are
    unused).  Otherwise draw from the filtered distribution with
    ``generator``."""
    if temperature == 0.0:
        if tail_mask is not None:
            logits = torch.where(tail_mask, logits, _NEG_INF)
        return torch.argmax(logits, dim=-1).to(torch.int32)
    scaled = filter_logits(logits, temperature, tail_mask, top_k, top_p)
    probs = torch.softmax(scaled.float(), dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
        torch.int32)


def prompt_positions(lengths: Optional[torch.Tensor], B: int, T0: int,
                     dev) -> tuple:
    """(start (B,) int32, position ids (B, T0) int64) of a prompt batch:
    start 0 and positions 0..T0-1 for equal lengths; for LEFT-padded
    ragged rows (``lengths``) start = T0 - lengths and each column's
    logical position, pads clipped to 0 (garbage the attention mask
    keeps unread)."""
    cols = torch.arange(T0, device=dev, dtype=torch.int32)
    if lengths is None:
        start = torch.zeros((B,), dtype=torch.int32, device=dev)
        return start, cols[None, :].expand(B, T0).long()
    start = T0 - lengths.to(device=dev, dtype=torch.int32)
    return start, (cols[None, :] - start[:, None]).clamp_min(0).long()


def is_paged(cache) -> bool:
    """A pool cache carries a block table, a dense cache does not."""
    return "block_tables" in cache


def paged_update_and_view(layer, block_tables, pos, new):
    """One decode-step K (or V) update against a paged pool layer.

    layer (num_blocks, bs, H, hd) is one layer's pool (a view into the
    cache, written in place); block_tables (B, max_blk) int32; pos (B,)
    int32; new (B, H, hd).  Writes new[b] into block
    block_tables[b, pos[b] // bs] at offset pos[b] % bs, then gathers
    each row's blocks into the dense-equivalent (B, max_blk * bs, H, hd)
    view.  Returns (layer, view)."""
    bs = layer.shape[1]
    rows = torch.arange(block_tables.shape[0], device=layer.device)
    pos = pos.long()
    layer[block_tables[rows, pos // bs].long(), pos % bs] = new
    b, nb = block_tables.shape
    view = layer[block_tables.long()]          # (B, max_blk, bs, H, hd)
    return layer, view.reshape(b, nb * bs, *layer.shape[2:])


def dense_to_paged(cache, block_size: int):
    """Re-lay a dense cache into a fresh block pool: row-major block
    tables, block 0 the null block.  The pool holds byte-identical K/V,
    so paged decode continues a dense prefill exactly.  Returns a new
    cache dict (the dense one is left as it is)."""
    L, B, S, *tail = cache["k"].shape
    if S % block_size:
        raise ValueError(f"max_seq={S} must be a multiple of "
                         f"block_size={block_size}")
    nb = S // block_size
    out = dict(cache)
    for name in ("k", "v"):
        pool = cache[name].reshape(L, B * nb, block_size, *tail)
        null = pool.new_zeros((L, 1, block_size, *tail))
        out[name] = torch.cat([null, pool], dim=1)
    out["block_tables"] = 1 + torch.arange(
        B * nb, dtype=torch.int32, device=cache["k"].device).reshape(B, nb)
    return out


def copy_block(cache, src, dst):
    """Copy-on-write fork: duplicate pool block ``src`` into ``dst``
    across every layer of both K and V, in place.  Returns the same
    cache dict."""
    for name in ("k", "v"):
        pool = cache[name]                 # (L, num_blocks, bs, ...)
        pool[:, int(dst)] = pool[:, int(src)]
    return cache


def init_pool(cfg, heads: int, batch: int, num_blocks: int,
              block_size: int, dev) -> Dict[str, torch.Tensor]:
    """A zeroed block-pool cache with ``heads`` K/V heads per slot (the
    init_paged_cache of both families)."""
    if cfg.max_seq % block_size:
        raise ValueError(f"max_seq={cfg.max_seq} must be a multiple of "
                         f"block_size={block_size}")
    shape = (cfg.n_layer, num_blocks, block_size, heads, cfg.head_dim)
    ints = dict(dtype=torch.int32, device=dev)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=dev),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=dev),
            "block_tables": torch.zeros((batch, cfg.max_seq // block_size),
                                        **ints),
            "pos": torch.zeros((batch,), **ints),
            "start": torch.zeros((batch,), **ints)}


def tail_plan(cfg, bs: int, Tt: int, row_bt, prefix_len, n_tail,
              dev) -> Dict[str, torch.Tensor]:
    """Where a right-aligned prompt tail of Tt columns (``n_tail`` real,
    at logical positions [prefix_len, prefix_len + n_tail)) lands in the
    pool: each column's position id (pads clip to 0), its scatter
    target (block, offset), pad columns routed to the null block 0
    because their logical index can alias a live prefix slot, and the
    (Tt, max_seq) attention mask (slot s visible to a real column c iff
    s <= its logical position; pad columns see nothing)."""
    pad = Tt - int(n_tail)
    col = torch.arange(Tt, dtype=torch.int64, device=dev)
    real = col >= pad
    logical = int(prefix_len) + col - pad
    pos_ids = logical.clamp_min(0)
    row_bt = row_bt.to(device=dev, dtype=torch.int64)
    zero = torch.zeros_like(col)
    return {"pos_ids": pos_ids,
            "blk": torch.where(real, row_bt[pos_ids // bs], zero),
            "off": torch.where(real, logical % bs, zero),
            "mask": real[:, None] & (
                torch.arange(cfg.max_seq, device=dev)[None, :]
                <= logical[:, None]),
            "row_bt": row_bt}


def tail_attention(q, kview, vview, mask, dtype):
    """Attention of a tail's Tt queries (Tt, H, hd) over the row's
    gathered pool view (max_seq, H, hd), masked by ``mask`` (Tt,
    max_seq); softmax in f32.  All-masked pad columns softmax to
    uniform: finite garbage that never reaches the pool or the
    logits."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("qhd,khd->hqk", q, kview).float() * scale
    scores = torch.where(mask[None], scores, _NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(dtype)
    return torch.einsum("hqk,khd->qhd", probs, vview)


def set_pool_row(cache, slot, row_bt, length) -> None:
    """Point pool row ``slot`` at its blocks, at ``length`` tokens;
    paged rows start at slot 0 (slot == logical position, the invariant
    that lets sequences share blocks)."""
    slot = int(slot)
    cache["block_tables"][slot] = row_bt.to(torch.int32)
    cache["pos"][slot] = int(length)
    cache["start"][slot] = 0


def update_kv(cache, i: int, rows, pos_l, k_new, v_new):
    """Write one token's K/V per row into layer i of the cache in place
    (dense: slot pos[b] of row b; paged: the row's pool block) and
    return the (B, S, H, hd) K and V the step attends over."""
    lk, lv = cache["k"][i], cache["v"][i]
    if is_paged(cache):
        bt = cache["block_tables"]
        return (paged_update_and_view(lk, bt, pos_l, k_new)[1],
                paged_update_and_view(lv, bt, pos_l, v_new)[1])
    lk[rows, pos_l] = k_new
    lv[rows, pos_l] = v_new
    return lk, lv


def scan_prefill(init_cache_fn, decode_step_fn, params, prompt, cfg):
    """Per-token reference prefill: T0 sequential decode_step calls.
    The numerics oracle for the batched prefill; equal-length prompts
    only.  Returns (last_logits (B, padded_vocab), cache)."""
    B, T0 = prompt.shape
    cache = init_cache_fn(cfg, B, device=prompt.device)
    logits = None
    for t in range(T0):
        logits, cache = decode_step_fn(params, cache, prompt[:, t], cfg)
    return logits, cache


def generate_with(prefill_fn, decode_step_fn, params,
                  prompt: torch.Tensor, cfg, *, max_new_tokens: int,
                  lengths: Optional[torch.Tensor] = None,
                  temperature: float = 1.0,
                  top_k: int = 0, top_p: float = 1.0,
                  generator: Optional[torch.Generator] = None,
                  kv_layout: str = "dense",
                  kv_block_size: int = 16) -> torch.Tensor:
    """The generation loop shared by decoder families: one batched
    prefill, then one decode_step per new token.  prompt (B, T0) int32
    → (B, T0 + max_new_tokens) int32; ``lengths`` (B,) marks ragged
    LEFT-padded prompts (row b's real tokens occupy columns
    [T0 - lengths[b], T0)); temperature 0 = greedy.
    kv_layout="paged" re-lays the prefilled cache into kv_block_size
    blocks and decodes through the block tables; the dense layout is
    its parity oracle."""
    B, T0 = prompt.shape
    if kv_layout not in ("dense", "paged"):
        raise ValueError(f"kv_layout must be 'dense' or 'paged', got "
                         f"{kv_layout!r}")
    if T0 + max_new_tokens > cfg.max_seq:
        raise ValueError(
            f"prompt length {T0} + max_new_tokens {max_new_tokens} "
            f"exceeds cfg.max_seq={cfg.max_seq}")
    tail_mask = make_vocab_tail_mask(cfg, prompt.device)
    logits, cache = prefill_fn(params, prompt, cfg, lengths=lengths)
    if kv_layout == "paged":
        cache = dense_to_paged(cache, kv_block_size)
    new_tokens = []
    for i in range(max_new_tokens):
        tok = sample_token(logits, generator, temperature, tail_mask,
                           top_k, top_p)
        new_tokens.append(tok)
        if i + 1 < max_new_tokens:   # the last token needs no K/V
            logits, cache = decode_step_fn(params, cache, tok, cfg)
    if not new_tokens:
        return prompt
    return torch.cat([prompt, torch.stack(new_tokens, dim=1).to(
        prompt.dtype)], dim=1)
