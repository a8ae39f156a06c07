"""kv_tier — tiered host-RAM KV cache (the second-chance store under
`BlockPager`'s LRU eviction).

A copy of ``ray_tpu/serve/kv_tier.py`` (the port keeps its own copy
rather than importing the JAX package).  Device memory holds the hot
working set of paged KV blocks; this module is the warm tier behind
it.  When the pager's LRU eviction claims a registered prefix block,
the engine copies that block's K/V rows device→host and `put()`s them
here under the SAME content-addressed token-tuple key the prefix index
uses — eviction becomes a D2H copy instead of an erasure.  On a later
admission whose device prefix match falls short, the pager probes
this store second-chance (`BlockPager.tier_lookup`): a hit means the
engine allocates fresh blocks, installs the host copy with one H2D
copy, and bumps ``prefix_len`` so ``paged_prefill`` skips those
tokens exactly as it does for resident prefixes.  Content addressing
makes the restore bit-identical to a re-prefill by construction —
same tokens, same K/V rows.

Division of labor:

  * the TIER (this module) is a byte-budgeted, LRU-evicting host
    store — pure bookkeeping over host arrays (CPU tensors in the
    engine: numpy has no bfloat16; anything with ``nbytes`` works),
    no device access, no clocks (the engine feeds measured copy
    seconds into ``note_h2d``/``note_d2h``);
  * the PAGER decides WHEN to spill (its eviction path) and WHAT to
    restore (its second-chance lookup), and keeps the scope
    accounting honest — a tier restore books ``tier_hits`` /
    ``tokens_restored``, never ``reprefill_waste_tokens``;
  * the ENGINE owns every device copy: its block-saver callback
    copies a block's K/V rows to host at spill time, and its
    ``install_blocks`` function writes a restored chain back into the
    pool.
"""

from __future__ import annotations

import collections
from typing import Dict, Optional, Tuple

import torch

__all__ = ["HostKVTier", "empty_kv_tier", "staging_buffers"]


def staging_buffers(maxn: int, row_shape: Tuple[int, ...], dtype,
                    pin: bool = False
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Persistent host staging triple ``(ids, k_rows, v_rows)`` for
    the tier's restore path (serve/llm.py), refilled in place per
    restore instead of re-allocating: ``maxn`` is the most blocks a
    sequence holds (max_seq // block_size), ``row_shape`` the stacked
    per-block row shape ``(maxn, n_layer, block_size, kv_heads,
    head_dim)`` and ``dtype`` the pool's torch dtype.  CPU tensors,
    page-locked when ``pin`` (a CUDA pool), so the H2D copy of a
    chain is one DMA."""
    bufs = (torch.zeros((maxn,), dtype=torch.int64),
            torch.zeros(row_shape, dtype=dtype),
            torch.zeros(row_shape, dtype=dtype))
    return tuple(b.pin_memory() for b in bufs) if pin else bufs


#: one stored block: per-layer K rows, per-layer V rows (host arrays,
#: shape (n_layer, block_size, kv_heads, head_dim)), byte footprint
Entry = Dict[str, object]


class HostKVTier:
    """Byte-budgeted LRU host store of evicted KV blocks, keyed by
    the pager's content-addressed prefix keys (exact token tuples —
    no hash collisions, so a restored block can never be wrong
    content).

    ``put`` spills one block (evicting least-recently-used entries
    until the budget fits; an entry larger than the whole budget is
    dropped on the floor rather than thrashing the store), ``take``
    is the counted second-chance probe, and the ``note_*`` hooks
    absorb engine-measured copy seconds so ``stats()`` can report
    h2d/d2h cost without this module ever reading a clock.
    """

    def __init__(self, bytes_budget: int):
        if int(bytes_budget) <= 0:
            raise ValueError(
                f"bytes_budget={bytes_budget} must be positive")
        self.bytes_budget = int(bytes_budget)
        #: key -> {"k": np, "v": np, "bytes": int}; insertion order ==
        #: LRU order (put/take both move-to-end)
        self._store: "collections.OrderedDict[Tuple[int, ...], Entry]" \
            = collections.OrderedDict()
        self.bytes_resident = 0
        self.hits = 0          # take() probes that found the key
        self.misses = 0        # take() probes that came up empty
        self.saves = 0         # blocks spilled in (D2H copies)
        self.evictions = 0     # entries LRU-dropped to fit the budget
        self.tokens_restored = 0  # token slots re-admitted via H2D
        # engine-fed copy time (seconds accumulate, stats reports ms)
        self._h2d_s = 0.0
        self._d2h_s = 0.0

    def __len__(self) -> int:
        return len(self._store)

    def __contains__(self, key: Tuple[int, ...]) -> bool:
        return key in self._store

    # -- spill / restore -----------------------------------------------

    def put(self, key: Tuple[int, ...], k_rows, v_rows) -> int:
        """Spill one evicted block's host K/V rows under `key`.
        Returns the bytes now resident for the key (0 when the entry
        alone exceeds the whole budget and was skipped).  Re-putting a
        resident key refreshes its rows and its LRU position."""
        nbytes = int(k_rows.nbytes) + int(v_rows.nbytes)
        if nbytes > self.bytes_budget:
            return 0
        old = self._store.pop(key, None)
        if old is not None:
            self.bytes_resident -= int(old["bytes"])
        while self._store and \
                self.bytes_resident + nbytes > self.bytes_budget:
            _, victim = self._store.popitem(last=False)   # LRU
            self.bytes_resident -= int(victim["bytes"])
            self.evictions += 1
        self._store[key] = {"k": k_rows, "v": v_rows, "bytes": nbytes}
        self.bytes_resident += nbytes
        self.saves += 1
        return nbytes

    def refresh(self, key: Tuple[int, ...]) -> int:
        """LRU-touch `key` if resident; returns its byte footprint
        (0 when absent).  The pager's eviction path calls this FIRST:
        content addressing makes the rows under a key immutable, so
        when the key is already resident the D2H gather would copy
        bit-identical bytes — the spill becomes a free LRU refresh.
        Not a probe (take() counts hit/miss) and not a save (no copy
        happened), so the counters stay honest."""
        if key not in self._store:
            return 0
        self._store.move_to_end(key)
        return int(self._store[key]["bytes"])

    def take(self, key: Tuple[int, ...]) -> Optional[Entry]:
        """Second-chance probe: the entry for `key`, or None.  A hit
        refreshes the entry's LRU position but KEEPS it resident —
        the tier is a cache, and the same prefix can be evicted from
        HBM and restored again later."""
        entry = self._store.get(key)
        if entry is None:
            self.misses += 1
            return None
        self._store.move_to_end(key)
        self.hits += 1
        return entry

    # -- engine-fed accounting -----------------------------------------

    def note_restored(self, tokens: int) -> None:
        """The pager registered tier-restored blocks covering
        `tokens` token slots — prefill work the tier just saved."""
        self.tokens_restored += int(tokens)

    def note_h2d(self, seconds: float) -> None:
        """Engine-measured restore (host→device install) seconds."""
        self._h2d_s += max(0.0, float(seconds))

    def note_d2h(self, seconds: float) -> None:
        """Engine-measured spill (device→host gather) seconds."""
        self._d2h_s += max(0.0, float(seconds))

    # -- introspection -------------------------------------------------

    def stats(self) -> Dict[str, object]:
        """The ``kv_tier`` stats block (`empty_kv_tier` is the zeroed
        twin engines without a tier report)."""
        probes = self.hits + self.misses
        return {
            "enabled": True,
            "bytes_budget": self.bytes_budget,
            "bytes_resident": self.bytes_resident,
            "entries": len(self._store),
            "hits": self.hits,
            "misses": self.misses,
            "hit_rate": round(self.hits / probes, 4) if probes
            else 0.0,
            "saves": self.saves,
            "evictions": self.evictions,
            "tokens_restored": self.tokens_restored,
            "h2d_ms": round(self._h2d_s * 1e3, 3),
            "d2h_ms": round(self._d2h_s * 1e3, 3),
        }


def empty_kv_tier() -> Dict[str, object]:
    """The stable zero-shaped ``kv_tier`` block engines WITHOUT a
    host tier report (dense layouts, paged with the knob unset) —
    same keys as a live tier, so callers never branch on
    configuration."""
    return {
        "enabled": False,
        "bytes_budget": 0,
        "bytes_resident": 0,
        "entries": 0,
        "hits": 0,
        "misses": 0,
        "hit_rate": 0.0,
        "saves": 0,
        "evictions": 0,
        "tokens_restored": 0,
        "h2d_ms": 0.0,
        "d2h_ms": 0.0,
    }
