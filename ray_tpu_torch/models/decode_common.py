"""The generation machinery shared by decoder families.

Counterpart of ``ray_tpu/models/decode_common.py``, dense layout.  A
family module (gpt2_decode) supplies its (init_cache, prefill,
decode_step) functions; this module owns sampling and the generation
loop.

Cache contract (as in the JAX package):

  k, v  : (L, B, S, H, hd) preallocated at cfg.max_seq
  pos   : (B,) int32 — next cache slot each sequence writes
  start : (B,) int32 — first valid slot (the left-pad offset); the
          logical position of the token at slot s is s - start[b]

Slot s is attendable for row b iff start[b] <= s <= pos[b] (after the
current token's K/V lands at slot pos[b]).  The block-paged layout
comes with the continuous scheduler (ROADMAP.md, queue 1 item 3).

JAX threads ``jax.random`` keys; the port draws from a
``torch.Generator``.  The two give different numbers from one seed, so
sampled outputs are compared by distribution, greedy ones token for
token.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

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
                  kv_layout: str = "dense") -> torch.Tensor:
    """The generation loop shared by decoder families: one batched
    prefill, then one decode_step per new token.  prompt (B, T0) int32
    → (B, T0 + max_new_tokens) int32; ``lengths`` (B,) marks ragged
    LEFT-padded prompts (row b's real tokens occupy columns
    [T0 - lengths[b], T0)); temperature 0 = greedy."""
    B, T0 = prompt.shape
    if kv_layout == "paged":
        raise NotImplementedError(
            "kv_layout='paged' comes with the continuous scheduler "
            "(ROADMAP.md, queue 1 item 3); the port decodes dense only")
    if kv_layout != "dense":
        raise ValueError(f"kv_layout must be 'dense' or 'paged', got "
                         f"{kv_layout!r}")
    if T0 + max_new_tokens > cfg.max_seq:
        raise ValueError(
            f"prompt length {T0} + max_new_tokens {max_new_tokens} "
            f"exceeds cfg.max_seq={cfg.max_seq}")
    tail_mask = make_vocab_tail_mask(cfg, prompt.device)
    logits, cache = prefill_fn(params, prompt, cfg, lengths=lengths)
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
