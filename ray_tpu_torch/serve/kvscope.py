"""kvscope — KV-cache & HBM memory observatory (host-side core).

A copy of ``ray_tpu/serve/kvscope.py`` (pure Python; the port keeps its
own copy rather than importing the JAX package).  Three concerns, all
pure host bookkeeping hanging off `BlockPager` (serve/kv_pager.py)
callbacks:

  * **occupancy timelines** — a bounded ring of per-wave pool
    snapshots (free / cached-LRU / in-use / null counts plus a
    fragmentation figure: the largest-contiguous-free-run deficit),
    sampled once per engine wave so a postmortem can replay pool
    pressure around an anomaly without journaling every allocation;
  * **eviction forensics + re-prefill waste** — prefix keys are
    content-addressed token tuples, so an evicted key that later
    re-registers is the SAME prefix being re-filled from scratch.
    Each such re-registration books ``block_size`` tokens of
    `reprefill_waste_tokens` — exactly the tokens the host-RAM KV
    tier (serve/kv_tier.py) saves — broken down per key and per
    tenant.  A key the tier restores instead (``note_tier_hit``)
    books ``tier_hits``/``tokens_restored`` waste-AVOIDED, never
    waste: the forensics split residual churn cost from churn the
    tier absorbed;
  * **unified HBM ledger** (``hbm_ledger``) — one per-card table
    merging the pager's pool bytes, the allocator view
    (``_private/device_stats.device_memory_stats()``) and the serve
    programs' audited peak budget into a single ``headroom_bytes`` that
    an ``AdmissionPolicy(min_headroom_bytes=)`` gate can shed against.
    The budget (``serve_program_budget_bytes``) is the largest of
    graftcheck's serve-path program budgets.

Everything is perf_counter-clocked and kill-switched by ``RAYTPU_KVSCOPE=0``: a
disabled scope costs one attribute check per hook.
"""

from __future__ import annotations

import collections
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["KVScope", "empty_kv_scope", "hbm_ledger",
           "serve_program_budget_bytes"]

#: occupancy ring length — one entry per engine wave, so at the
#: default this is the last ~512 waves of pool history
_RING_CAPACITY = 512
#: evicted-key ledger bound: beyond this the coldest evicted keys are
#: forgotten (counted in ``keys_forgotten``) rather than tracked
_KEY_CAP = 1024
#: per-key waste table bound (top offenders only need so many rows)
_WASTE_KEY_CAP = 256


def _pct(samples: Sequence[float], q: float) -> float:
    if not samples:
        return 0.0
    s = sorted(samples)
    idx = min(len(s) - 1, int(round(q * (len(s) - 1))))
    return s[idx]


class KVScope:
    """Occupancy ring + eviction/re-prefill ledger for one pager.

    The pager owns exactly one of these and calls the ``note_*`` /
    ``sample`` hooks from its own mutation paths; nothing here touches
    the free list or refcounts.  All hooks are O(1) (the fragmentation
    scan is O(free) but runs only on `sample`, once per wave).
    """

    def __init__(self, num_blocks: int, block_size: int, *,
                 ring_capacity: int = _RING_CAPACITY,
                 key_cap: int = _KEY_CAP,
                 enabled: Optional[bool] = None):
        if enabled is None:
            enabled = os.environ.get("RAYTPU_KVSCOPE", "1") != "0"
        self.enabled = bool(enabled)
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self.ring_capacity = int(ring_capacity)
        self._key_cap = int(key_cap)
        #: occupancy ring: dicts of t_s/free/cached/in_use/null/frag
        self._ring: "collections.deque" = collections.deque(
            maxlen=self.ring_capacity)
        #: live block -> tenant attribution (referenced blocks only;
        #: cleared when the block parks or frees — a parked block's
        #: attribution lives on its key, below)
        self._block_tenant: Dict[int, str] = {}
        #: resident prefix key -> tenant that registered it (pruned on
        #: evict, bounded by resident keys <= num_blocks)
        self._key_tenant: Dict[Tuple[int, ...], Optional[str]] = {}
        #: evicted-key ledger: key -> tenant at eviction time, LRU
        #: order == eviction order, bounded by key_cap
        self._evicted: "collections.OrderedDict[Tuple[int, ...], "\
            "Optional[str]]" = collections.OrderedDict()
        self.keys_evicted = 0
        self.keys_forgotten = 0
        self.reprefill_events = 0
        self.reprefill_waste_tokens = 0
        #: host-tier second chances (serve/kv_tier.py): keys restored
        #: via H2D copy instead of re-prefill — waste AVOIDED, kept
        #: beside the residual waste so the split is visible
        self.tier_hits = 0
        self.tokens_restored = 0
        self._waste_by_tenant: Dict[str, int] = {}
        self._waste_by_key: Dict[Tuple[int, ...], int] = {}

    # -- occupancy -----------------------------------------------------

    def sample(self, free_ids: Sequence[int], cached: int) -> None:
        """Append one pool snapshot to the ring (engine calls this
        once per wave).  ``in_use`` counts every block not free and
        not parked — including the reserved null block — so the ring
        invariant ``free + cached + in_use == num_blocks`` holds
        exactly at every sample."""
        if not self.enabled:
            return
        free = len(free_ids)
        in_use = self.num_blocks - free - int(cached)
        self._ring.append({
            "t_s": time.perf_counter(),
            "free": free,
            "cached": int(cached),
            "in_use": in_use,
            "null": 1,
            "frag": self._fragmentation(free_ids),
        })

    def _fragmentation(self, free_ids: Sequence[int]) -> float:
        """Largest-contiguous-run deficit over the free list: 0.0 when
        every free block sits in one contiguous id run (a maximal
        sequence could land without interleaving), approaching 1.0 as
        the free space shatters into single blocks."""
        n = len(free_ids)
        if n <= 1:
            return 0.0
        ids = sorted(free_ids)
        longest = run = 1
        for prev, cur in zip(ids, ids[1:]):
            run = run + 1 if cur == prev + 1 else 1
            if run > longest:
                longest = run
        return round(1.0 - longest / n, 4)

    def occupancy_ratio(self, free: int, cached: int) -> float:
        """Fraction of the usable pool (null excluded) not on the
        free list — in-use plus parked-LRU blocks."""
        usable = max(1, self.num_blocks - 1)
        return round(1.0 - free / usable, 4)

    # -- tenant attribution --------------------------------------------

    def note_alloc(self, block_ids: Sequence[int],
                   tenant: Optional[str]) -> None:
        """Attribute freshly-allocated or revived blocks to the tenant
        in the pager's request context (None drops attribution)."""
        if not self.enabled:
            return
        if tenant:
            for blk in block_ids:
                self._block_tenant[blk] = tenant
        else:
            for blk in block_ids:
                self._block_tenant.pop(blk, None)

    def note_block_released(self, block_id: int) -> None:
        """The block reached refcount 0 (parked or freed) — live
        attribution ends; a parked block's tenant survives on its
        registered key."""
        self._block_tenant.pop(block_id, None)

    # -- eviction forensics + re-prefill waste -------------------------

    def note_register(self, key: Tuple[int, ...],
                      tenant: Optional[str]) -> int:
        """One prefix key became resident.  If the key was previously
        evicted this registration IS a re-prefill of content the pool
        once held: book ``block_size`` waste tokens against the key
        and the registering tenant.  Returns the tokens booked (0 for
        a first-time key) so the pager can journal the event."""
        if not self.enabled:
            return 0
        self._key_tenant[key] = tenant
        if key not in self._evicted:
            return 0
        del self._evicted[key]
        waste = self.block_size
        self.reprefill_events += 1
        self.reprefill_waste_tokens += waste
        if tenant:
            self._waste_by_tenant[tenant] = \
                self._waste_by_tenant.get(tenant, 0) + waste
        if len(self._waste_by_key) < _WASTE_KEY_CAP \
                or key in self._waste_by_key:
            self._waste_by_key[key] = \
                self._waste_by_key.get(key, 0) + waste
        return waste

    def note_tier_hit(self, key: Tuple[int, ...],
                      tenant: Optional[str]) -> None:
        """One prefix key was restored from the host KV tier
        (H2D copy) instead of being re-prefilled.  Consumes the
        evicted-ledger entry WITHOUT booking waste — the later
        ``note_register`` of the same key (the pager re-indexes the
        restored block) must book zero ``reprefill_waste_tokens`` —
        and records the avoided work as ``tokens_restored``."""
        if not self.enabled:
            return
        self.tier_hits += 1
        self.tokens_restored += self.block_size
        self._key_tenant[key] = tenant
        if key in self._evicted:
            del self._evicted[key]

    def note_handoff_import(self, key: Tuple[int, ...],
                            tenant: Optional[str]) -> None:
        """One prefix key became resident via a prefill/decode handoff
        install (block rows copied in from a prefill engine's pool).
        Consumes the evicted-ledger entry WITHOUT booking waste — the
        content arrived by copy, not re-prefill — and without tier
        counters (no host tier was involved)."""
        if not self.enabled:
            return
        self._key_tenant[key] = tenant
        if key in self._evicted:
            del self._evicted[key]

    def note_evict(self, key: Optional[Tuple[int, ...]]
                   ) -> Optional[str]:
        """One registered block was LRU-evicted.  Moves the key into
        the evicted ledger (bounded — the coldest tracked evictions
        are forgotten, not leaked) and returns the owning tenant for
        the pager's journal event."""
        if not self.enabled or key is None:
            return None
        tenant = self._key_tenant.pop(key, None)
        self.keys_evicted += 1
        self._evicted[key] = tenant
        self._evicted.move_to_end(key)
        while len(self._evicted) > self._key_cap:
            self._evicted.popitem(last=False)
            self.keys_forgotten += 1
        return tenant

    # -- introspection -------------------------------------------------

    def blocks_by_tenant(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for tenant in self._block_tenant.values():
            out[tenant] = out.get(tenant, 0) + 1
        return out

    def stats(self, *, free: int, cached: int,
              prefill_tokens: int = 0) -> Dict[str, object]:
        """The ``kv_scope`` occupancy/forensics block."""
        ratios = [self.occupancy_ratio(s["free"], s["cached"])
                  for s in self._ring]
        frags = [s["frag"] for s in self._ring]
        waste = self.reprefill_waste_tokens
        top = sorted(self._waste_by_key.items(),
                     key=lambda kv: -kv[1])[:8]
        return {
            "enabled": self.enabled,
            "occupancy": {
                "ring_capacity": self.ring_capacity,
                "samples": len(self._ring),
                "last": dict(self._ring[-1]) if self._ring else None,
                "occupancy_ratio": self.occupancy_ratio(free, cached),
                "occupancy_p95": _pct(ratios, 0.95),
                "fragmentation": frags[-1] if frags else 0.0,
                # raw ring, oldest first: the CLI's timeline/export
                # feed — bounded by ring_capacity, so a snapshot stays
                # a few tens of KB at the default
                "ring": self.timeline(),
            },
            "forensics": {
                "keys_evicted": self.keys_evicted,
                "keys_tracked": len(self._evicted),
                "keys_forgotten": self.keys_forgotten,
                "reprefill_events": self.reprefill_events,
                "reprefill_waste_tokens": waste,
                "reprefill_waste_frac":
                    round(waste / prefill_tokens, 4)
                    if prefill_tokens else 0.0,
                "prefill_tokens": int(prefill_tokens),
                "tier_hits": self.tier_hits,
                "tokens_restored": self.tokens_restored,
                "waste_by_tenant": dict(self._waste_by_tenant),
                "top_keys": [
                    {"key_prefix": list(k[:8]), "key_len": len(k),
                     "tokens": v} for k, v in top],
            },
            "blocks_by_tenant": self.blocks_by_tenant(),
        }

    def timeline(self) -> List[Dict[str, object]]:
        """The raw occupancy ring, oldest first (CLI/export feed)."""
        return [dict(s) for s in self._ring]


def empty_kv_scope() -> Dict[str, object]:
    """The stable zero-shaped ``kv_scope`` block dense engines (no
    pager) report — same keys as a live paged block, so callers never
    branch on layout."""
    return {
        "enabled": False,
        "occupancy": {
            "ring_capacity": 0,
            "samples": 0,
            "last": None,
            "occupancy_ratio": 0.0,
            "occupancy_p95": 0.0,
            "fragmentation": 0.0,
            "ring": [],
        },
        "forensics": {
            "keys_evicted": 0,
            "keys_tracked": 0,
            "keys_forgotten": 0,
            "reprefill_events": 0,
            "reprefill_waste_tokens": 0,
            "reprefill_waste_frac": 0.0,
            "prefill_tokens": 0,
            "tier_hits": 0,
            "tokens_restored": 0,
            "waste_by_tenant": {},
            "top_keys": [],
        },
        "blocks_by_tenant": {},
        "hbm_ledger": {"per_chip": [], "min_headroom_bytes": None},
    }


def hbm_ledger(*, pool_bytes_per_chip: int = 0,
               device_stats: Optional[Sequence[Dict]] = None,
               program_budget_bytes: int = 0) -> Dict[str, object]:
    """Unified per-chip HBM table: merges the KV pool's resident
    bytes, the live allocator view (`device_memory_stats()` rows), and
    the serve programs' audited peak budget into one
    ``headroom_bytes`` per chip.

    ``headroom = bytes_limit - max(bytes_in_use, pool + budget)`` —
    the allocator view when it is the larger (live activations beyond
    the audited programs), the static commitment when the allocator
    under-reports (CPU backends report no live bytes at all).  Chips
    with no ``bytes_limit`` (CPU) get ``headroom_bytes: None`` and are
    excluded from ``min_headroom_bytes``, so the AdmissionPolicy gate
    is inert off-accelerator by construction."""
    rows: List[Dict[str, object]] = []
    for d in device_stats or []:
        limit = d.get("bytes_limit")
        in_use = d.get("bytes_in_use")
        committed = max(in_use or 0,
                        pool_bytes_per_chip + program_budget_bytes)
        rows.append({
            "id": d.get("id"),
            "platform": d.get("platform"),
            "bytes_limit": limit,
            "bytes_in_use": in_use,
            "peak_bytes_in_use": d.get("peak_bytes_in_use"),
            "kv_pool_bytes": int(pool_bytes_per_chip),
            "program_budget_bytes": int(program_budget_bytes),
            "headroom_bytes":
                int(limit) - int(committed)
                if limit is not None else None,
        })
    vals = [r["headroom_bytes"] for r in rows
            if r["headroom_bytes"] is not None]
    return {"per_chip": rows,
            "min_headroom_bytes": min(vals) if vals else None}


def serve_program_budget_bytes() -> int:
    """Worst-case audited peak over graftcheck's serve-path programs
    (prefill / decode / verify specs of
    ``tools/graftcheck/programs.py``) — the static 'what the programs
    may transiently need' term of the ledger.  Best effort: 0 when
    graftcheck is unimportable (the ledger then leans on the allocator
    view alone)."""
    try:
        from ray_tpu_torch.tools.graftcheck.programs import default_programs

        budgets = [
            (spec.per_chip_hbm_budget_bytes
             or spec.hbm_budget_bytes or 0)
            for spec in default_programs()
            if any(tag in spec.name
                   for tag in ("prefill", "decode", "verify"))]
        return max(budgets, default=0)
    except Exception:  # noqa: BLE001 - observability must not raise
        return 0
