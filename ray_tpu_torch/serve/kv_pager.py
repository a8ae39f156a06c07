"""Host-side block manager for the paged KV cache (the data plane
under serve/llm.py's continuous scheduler).

A copy of ``ray_tpu/serve/kv_pager.py``'s ``BlockPager`` (pure
Python; the port keeps its own copy rather than importing the JAX
package).  The decode functions see only a preallocated block pool
and per-row block tables (decode_common paged contract); everything
that DECIDES which block holds what lives here, on the host:

  * **free-list allocation** — blocks 1..num_blocks-1 start free
    (block 0 is the reserved null block: never allocated, absorbs the
    masked pad writes the decode functions route to it);
  * **refcounts** — a block referenced by several live sequences is
    shared; the last release returns it;
  * **prefix cache** — full prompt-token blocks are content-indexed
    (exact token-tuple keys, no hash collisions → no silent wrong
    reuse), so a request whose prompt extends a resident prefix skips
    re-prefilling those blocks entirely;
  * **cached LRU pool** — released-but-registered blocks stay resident
    (refcount 0) until allocation pressure evicts them
    least-recently-used, so popular prefixes survive across requests;
  * **copy-on-write** — before a sequence writes into a block it
    shares (the tail boundary of a prefix hit), `ensure_private`
    hands it a fresh block and tells the engine to device-copy the
    original (decode_common.copy_block).

Nothing here touches device memory — the pager returns block ids and
the engine passes them to its device functions.  The pool is
allocated once and never reallocated.
"""

from __future__ import annotations

import collections
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ray_tpu_torch.serve.kv_tier import HostKVTier
from ray_tpu_torch.serve.kvscope import KVScope

__all__ = ["BlockPager"]

#: journal events tag evicted/re-registered keys by their first few
#: tokens (enough to eyeball which prefix churned) plus the full
#: length — full keys would bloat the bounded flightrec ring
_KEY_PREFIX_TOKENS = 8


class BlockPager:
    """Allocator + prefix index over a pool of `num_blocks` KV blocks
    of `block_size` token slots each.

    Block ids are ints in [1, num_blocks); 0 is the reserved null
    block.  Every returned block carries a refcount the caller must
    eventually `release`.  `num_blocks` must cover at least one full
    sequence (max_seq // block_size) or admission could never succeed.
    """

    def __init__(self, num_blocks: int, block_size: int, max_seq: int,
                 *, bytes_per_block: int = 0, tensor_shards: int = 1,
                 recorder=None,
                 host_tier: Optional[HostKVTier] = None):
        if max_seq % block_size:
            raise ValueError(f"max_seq={max_seq} must be a multiple of "
                             f"block_size={block_size}")
        if num_blocks < 1 + max_seq // block_size:
            raise ValueError(
                f"num_blocks={num_blocks} cannot hold one full "
                f"sequence ({max_seq // block_size} blocks + null)")
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self.max_seq = int(max_seq)
        # accounting only — the pager never touches device memory.
        # bytes_per_block is the GLOBAL K+V footprint of one block
        # across all layers; tensor_shards is how many ways the pool's
        # head dim is split over the mesh, so stats() can report the
        # per-chip resident bytes a sharded pool actually costs.
        self.bytes_per_block = int(bytes_per_block)
        self.tensor_shards = max(1, int(tensor_shards))
        # LIFO free list: recently-freed blocks are re-used first
        # (warmer HBM pages on real hardware, denser tests)
        self._free: List[int] = list(range(num_blocks - 1, 0, -1))
        self._ref: Dict[int, int] = {}
        #: exact prompt-token prefix -> resident block id.  Keys are
        #: token tuples (content-addressed), so a block evicted and
        #: re-filled with other tokens can never falsely match.
        self._index: Dict[Tuple[int, ...], int] = {}
        self._block_key: Dict[int, Tuple[int, ...]] = {}
        #: refcount-0 registered blocks, insertion order == LRU order
        self._cached: "collections.OrderedDict[int, None]" = \
            collections.OrderedDict()
        self.prefix_hits = 0      # blocks served from the cache
        self.prefix_misses = 0    # blocks that had to be prefilled
        self.cow_copies = 0
        self.evictions = 0
        #: chunked streaming prefill (round 15): fill events the
        #: engine reports as it writes reserved blocks chunk by chunk.
        #: partial_fills counts intermediate chunks (row parked after),
        #: fill_tokens the prompt tokens ingested through fills.
        self.partial_fills = 0
        self.fill_tokens = 0
        #: total keys handed out by prefix_keys() — how much affinity
        #: metadata this pager has published to routers
        self.prefix_keys_exported = 0
        #: optional flight recorder (_private/flightrec.py; the engine
        #: passes its telemetry's): block
        #: reserve / evict / free / COW decisions journal themselves
        #: so a postmortem can replay pool pressure around an anomaly
        self._recorder = recorder
        #: (request_id, trace_id, tenant) the engine sets around one
        #: admission's reservation window, so the kv_* journal events
        #: carry the request/trace/tenant a postmortem filters by and
        #: kvscope can attribute blocks + re-prefill waste per tenant
        self._req_ctx: Tuple[Optional[int], Optional[str],
                             Optional[str]] = (None, None, None)
        #: kvscope (serve/kvscope.py): occupancy ring + eviction
        #: forensics + re-prefill waste ledger over this pool
        self.scope = KVScope(self.num_blocks, self.block_size)
        #: tiered host-RAM KV cache (serve/kv_tier.py): evicted
        #: registered blocks spill device→host instead of vanishing,
        #: and `tier_lookup` gives HBM prefix misses a second chance.
        #: The pager still never touches device memory — the engine
        #: registers a block-saver callback (`set_block_saver`) that
        #: gathers a block's K/V rows to host at spill time.
        self.tier = host_tier
        self._block_saver: Optional[Callable[[int], Tuple]] = None

    def set_block_saver(self, fn: Callable[[int], Tuple]) -> None:
        """Register the engine's D2H gather: ``fn(block_id) ->
        (k_rows, v_rows)`` host arrays for one block across all
        layers.  Required before eviction can spill into the host
        tier; without it (or without a tier) eviction keeps its
        original discard semantics."""
        self._block_saver = fn

    def set_request(self, request_id: Optional[int],
                    trace_id: Optional[str] = None,
                    tenant: Optional[str] = None) -> None:
        """Scope subsequent recorder events to one request — the
        engine brackets each admission's pager calls with
        ``set_request(rec_id, trace_id, tenant)`` / ``set_request(None)``.
        Purely journal/attribution tagging; allocation behavior is
        unchanged."""
        self._req_ctx = (request_id, trace_id, tenant)

    def _ctx_tag(self) -> Dict[str, object]:
        req, trace, tenant = self._req_ctx
        if req is None:
            return {}
        tag: Dict[str, object] = {"req": req}
        if trace is not None:
            tag["trace"] = trace
        if tenant:
            tag["tenant"] = tenant
        return tag

    def _key_tag(self, key: Optional[Tuple[int, ...]]
                 ) -> Dict[str, object]:
        if key is None:
            return {}
        return {"key_prefix": list(key[:_KEY_PREFIX_TOKENS]),
                "key_len": len(key)}

    # -- capacity ------------------------------------------------------

    @property
    def blocks_free(self) -> int:
        """Immediately allocatable blocks (untouched free list)."""
        return len(self._free)

    @property
    def blocks_cached(self) -> int:
        """Refcount-0 registered blocks — evictable on demand."""
        return len(self._cached)

    @property
    def blocks_in_use(self) -> int:
        return self.num_blocks - 1 - len(self._free) - len(self._cached)

    @property
    def available(self) -> int:
        """Blocks an `allocate` call could produce right now."""
        return len(self._free) + len(self._cached)

    def blocks_needed(self, prompt_len: int, max_new_tokens: int,
                      headroom: int = 0) -> int:
        """Blocks a request needs end-to-end.  `headroom` reserves
        extra write positions past the generation budget — spec-decode
        verify rounds scatter up to k draft K/V writes beyond the last
        kept token, and those overshoot writes must land in blocks the
        row OWNS (never a shared prefix block or a block the pager has
        re-handed out).  Capped at max_seq: writes past the sequence
        bound are null-routed on-device and need no backing block."""
        want = min(prompt_len + max_new_tokens + headroom, self.max_seq)
        return -(-want // self.block_size)

    # -- allocation ----------------------------------------------------

    def allocate(self, count: int) -> Optional[List[int]]:
        """`count` private blocks (refcount 1 each), evicting cached
        prefix blocks LRU-first when the free list runs dry.  Returns
        None (allocating nothing) when even eviction cannot cover the
        request — the caller requeues and retries after a retirement.
        """
        if count > self.available:
            if self._recorder is not None and count:
                self._recorder.record("kv_exhausted", need=count,
                                      available=self.available,
                                      **self._ctx_tag())
            return None
        out: List[int] = []
        evicted = 0
        for _ in range(count):
            if not self._free:
                blk, _ = self._cached.popitem(last=False)  # LRU
                # forensics: capture the content key BEFORE the index
                # drops it — the kv_evict journal event and the
                # kvscope re-prefill ledger both need to know WHAT
                # was lost, not just that a block was reclaimed
                key = self._block_key.get(blk)
                owner = self.scope.note_evict(key)
                # tiered host-RAM KV cache: before the block id is
                # recycled, spill its K/V rows device→host so a later
                # admission can restore the prefix via H2D copy
                # instead of re-prefilling it (serve/kv_tier.py)
                spilled = 0
                if self.tier is not None and key is not None \
                        and self._block_saver is not None:
                    # resident key → the gather would copy identical
                    # bytes (content addressing); LRU-touch instead
                    spilled = self.tier.refresh(key)
                    if not spilled:
                        k_rows, v_rows = self._block_saver(blk)
                        spilled = self.tier.put(key, k_rows, v_rows)
                self._deregister(blk)
                self.evictions += 1
                evicted += 1
                self._free.append(blk)
                if self._recorder is not None:
                    # "tenant" names the VICTIM's owner (what was
                    # lost); req/trace still identify the evicting
                    # admission via the request context
                    tag = dict(self._ctx_tag(), **self._key_tag(key))
                    if owner:
                        tag["tenant"] = owner
                    if spilled:
                        tag["tier_bytes"] = spilled
                    self._recorder.record("kv_evict", block=blk,
                                          **tag)
            blk = self._free.pop()
            self._ref[blk] = 1
            out.append(blk)
        self.scope.note_alloc(out, self._req_ctx[2])
        if self._recorder is not None and count:
            self._recorder.record("kv_reserve", blocks=count,
                                  evicted=evicted,
                                  free=len(self._free),
                                  **self._ctx_tag())
        return out

    def release(self, block_ids: Sequence[int]) -> None:
        """Drop one reference on each block.  Zero-ref registered
        blocks park in the cached pool (prefix stays warm); zero-ref
        unregistered blocks return to the free list."""
        freed = 0
        for blk in block_ids:
            ref = self._ref.get(blk, 0) - 1
            if ref > 0:
                self._ref[blk] = ref
                continue
            if ref < 0:
                raise ValueError(f"release of unallocated block {blk}")
            del self._ref[blk]
            self.scope.note_block_released(blk)
            if blk in self._block_key:
                self._cached[blk] = None       # most-recently used
                self._cached.move_to_end(blk)
            else:
                self._free.append(blk)
            freed += 1
        if self._recorder is not None and freed:
            self._recorder.record("kv_free", blocks=freed,
                                  free=len(self._free),
                                  cached=len(self._cached),
                                  **self._ctx_tag())

    def note_fill(self, tokens: int, partial: bool = False) -> None:
        """Journal one prefill chunk writing `tokens` token slots into
        this pager's reserved blocks (chunked streaming prefill —
        serve/llm.py calls this per chunk).  `partial=True` marks an
        intermediate chunk: the row still has unfilled tail blocks and
        is parked until its next chunk window.  Pure accounting — the
        blocks were allocated at admission and ownership is unchanged;
        the counters surface in stats() and the `kv_fill` journal
        event lets a postmortem replay how a long prompt's blocks
        filled between decode waves."""
        self.fill_tokens += int(tokens)
        if partial:
            self.partial_fills += 1
        if self._recorder is not None:
            self._recorder.record("kv_fill", tokens=int(tokens),
                                  partial=bool(partial),
                                  **self._ctx_tag())

    # -- prefix cache --------------------------------------------------

    def match_prefix(self, tokens: Sequence[int]
                     ) -> Tuple[int, List[int]]:
        """Longest resident block-aligned prefix of `tokens`.

        Returns (prefix_len, matched_block_ids); each matched block's
        refcount is raised (cached blocks are revived), so the caller
        owns them and must `release` on retirement or admission
        failure.  prefix_len is capped at len(tokens) - 1: the tail
        prefill must ingest at least one token to produce the first
        logits — a full-prompt match reuses everything but the last
        position (whose recompute lands in a COW fork of the boundary
        block, see `ensure_private`)."""
        tokens = tuple(int(t) for t in tokens)
        n = len(tokens)
        matched: List[int] = []
        for i in range(1, n // self.block_size + 1):
            blk = self._index.get(tokens[:i * self.block_size])
            if blk is None:
                break
            matched.append(blk)
        prefix_len = min(len(matched) * self.block_size, max(n - 1, 0))
        for blk in matched:
            if blk in self._cached:            # revive from LRU pool
                del self._cached[blk]
                self._ref[blk] = 1
            else:
                self._ref[blk] += 1
        self.scope.note_alloc(matched, self._req_ctx[2])
        self.prefix_hits += len(matched)
        self.prefix_misses += self.blocks_needed(n, 0) - len(matched)
        return prefix_len, matched

    def tier_lookup(self, tokens: Sequence[int], matched: int
                    ) -> List[Tuple[Tuple[int, ...], Dict]]:
        """Second-chance prefix lookup against the host tier: walk
        the full-block keys of `tokens` past the first `matched` HBM
        blocks and collect consecutive tier entries, stopping at the
        first miss (same chain discipline as `match_prefix` — a gap
        cannot be skipped, the prefill must be contiguous).  The walk
        is capped where `match_prefix` caps: a reusable block must
        end at or before token ``len(tokens) - 1``, so the tail
        prefill still ingests at least one token.

        Returns ``[(key, entry), ...]`` — probes count into the
        tier's hit/miss stats; entries stay resident (the tier is a
        cache).  The caller allocates fresh blocks, H2D-installs each
        entry, then calls `note_tier_restore` to index them.  Empty
        when no tier is attached."""
        if self.tier is None:
            return []
        tokens = tuple(int(t) for t in tokens)
        n = len(tokens)
        out: List[Tuple[Tuple[int, ...], Dict]] = []
        for i in range(int(matched), max(n - 1, 0) // self.block_size):
            entry = self.tier.take(tokens[:(i + 1) * self.block_size])
            if entry is None:
                break
            out.append((tokens[:(i + 1) * self.block_size], entry))
        return out

    def note_tier_restore(self, pairs: Sequence[Tuple[Tuple[int, ...],
                                                      Dict]],
                          block_ids: Sequence[int]) -> int:
        """The engine H2D-installed `pairs` (from `tier_lookup`) into
        freshly-allocated `block_ids` — index them as resident prefix
        blocks.  Unlike `register_prefix`, this books NO re-prefill
        waste: the content came back via copy, not recompute — scope
        forensics record the saved work as ``tier_hits`` /
        ``tokens_restored`` instead, and each block journals a
        ``kv_fetch`` event naming key/tenant/bytes.  The restored
        blocks count as prefix HITS (served from cache, just a slower
        tier), so ``prefill_tokens`` — the waste-frac denominator —
        keeps meaning 'tokens actually prefilled'.  Returns the token
        slots restored."""
        tenant = self._req_ctx[2]
        restored = 0
        for (key, entry), blk in zip(pairs, block_ids):
            self._index[key] = blk
            self._block_key[blk] = key
            self.scope.note_tier_hit(key, tenant)
            restored += self.block_size
            if self._recorder is not None:
                self._recorder.record(
                    "kv_fetch", block=blk, tokens=self.block_size,
                    bytes=int(entry.get("bytes", 0)),
                    **dict(self._ctx_tag(), **self._key_tag(key)))
        nblocks = len(pairs)
        self.prefix_hits += nblocks
        self.prefix_misses -= nblocks
        if self.tier is not None:
            self.tier.note_restored(restored)
        return restored

    def register_prefix(self, tokens: Sequence[int],
                        block_ids: Sequence[int]) -> int:
        """Index every FULL prompt block of `tokens` (block i holds
        K/V for tokens[i*bs:(i+1)*bs]) so later prompts can match it.
        First writer wins: keys already indexed keep their canonical
        block (the duplicate block simply stays unregistered).

        Returns the re-prefill waste tokens kvscope booked — the sum
        over registered keys that were previously evicted (content
        the pool already held once and had to re-fill from scratch).
        """
        tokens = tuple(int(t) for t in tokens)
        tenant = self._req_ctx[2]
        waste = 0
        for i in range(len(tokens) // self.block_size):
            key = tokens[:(i + 1) * self.block_size]
            blk = block_ids[i]
            if key in self._index or blk in self._block_key:
                continue
            self._index[key] = blk
            self._block_key[blk] = key
            booked = self.scope.note_register(key, tenant)
            if booked:
                waste += booked
                if self._recorder is not None:
                    self._recorder.record(
                        "kv_reprefill", block=blk, tokens=booked,
                        **dict(self._ctx_tag(), **self._key_tag(key)))
        return waste

    def note_handoff_import(self, tokens: Sequence[int],
                            block_ids: Sequence[int]) -> None:
        """Index the FULL prompt blocks a prefill/decode handoff just
        installed: this decode engine received the rows by copy from a
        prefill engine, so unlike ``register_prefix`` nothing was
        recomputed and no probe happened — NO re-prefill waste is
        booked and the prefix hit/miss counters stay untouched.  First
        writer wins, exactly like ``register_prefix``: keys already
        indexed keep their canonical block."""
        tokens = tuple(int(t) for t in tokens)
        tenant = self._req_ctx[2]
        indexed = 0
        for i in range(len(tokens) // self.block_size):
            key = tokens[:(i + 1) * self.block_size]
            blk = block_ids[i]
            if key in self._index or blk in self._block_key:
                continue
            self._index[key] = blk
            self._block_key[blk] = key
            self.scope.note_handoff_import(key, tenant)
            indexed += 1
        if self._recorder is not None and indexed:
            self._recorder.record(
                "kv_handoff_import", blocks=indexed,
                **self._ctx_tag())

    def ensure_private(self, block_id: int
                       ) -> Tuple[int, Optional[int]]:
        """Copy-on-write gate: called before a sequence writes into
        `block_id` (the prefix/tail boundary block of a prefix hit).

        A block is writable in place only when this sequence is its
        sole referent AND it is not indexed (an indexed block's
        content is a promise to future matchers).  Otherwise the
        caller's reference moves to a fresh block and (new_id, src_id)
        is returned — the caller must device-copy src → new before
        the write.  Returns (block_id, None) when no fork was needed;
        raises MemoryError when no block can be allocated (caller
        rolls back + requeues)."""
        shared = self._ref.get(block_id, 0) > 1 \
            or block_id in self._block_key
        if not shared:
            return block_id, None
        fresh = self.allocate(1)
        if fresh is None:
            raise MemoryError("no free block for copy-on-write fork")
        self.release([block_id])       # our ref moves to the fork
        self.cow_copies += 1
        if self._recorder is not None:
            # forensics: the forked block's content key (when it is a
            # registered prefix boundary) names WHICH prefix diverged
            self._recorder.record(
                "kv_cow", src=block_id, fork=fresh[0],
                **dict(self._ctx_tag(),
                       **self._key_tag(self._block_key.get(block_id))))
        return fresh[0], block_id

    def prefix_keys(self) -> List[Tuple[int, ...]]:
        """Resident prefix keys (exact block-aligned token tuples),
        exported as cluster-visible routing metadata.

        A fleet router (serve/router.py) matches an incoming prompt's
        block-aligned prefixes against each replica's exported keys and
        sends the request where the KV blocks already live.  The keys
        are content (token tuples), not block ids — a router on another
        host can match them without sharing this pager's id space.
        Every call bumps `prefix_keys_exported` (surfaced in stats()),
        so dashboards can see how much metadata the replica publishes.
        """
        keys = list(self._index.keys())
        self.prefix_keys_exported += len(keys)
        return keys

    def _deregister(self, block_id: int) -> None:
        key = self._block_key.pop(block_id, None)
        if key is not None:
            self._index.pop(key, None)

    # -- introspection -------------------------------------------------

    def sample_occupancy(self) -> None:
        """Append one kvscope occupancy snapshot — the engine calls
        this once per wave, so the ring replays pool pressure at
        scheduling granularity without journaling every allocation."""
        self.scope.sample(self._free, len(self._cached))

    def kv_scope_stats(self) -> Dict[str, object]:
        """The occupancy/forensics half of ``engine_stats()``'s
        ``kv_scope`` block.  ``prefill_tokens`` (the waste-fraction
        denominator) counts prefilled blocks in token units — the
        same block-granular unit the waste ledger books — so
        ``reprefill_waste_frac`` is exactly 'fraction of prefilled
        blocks that re-filled previously-resident content'.  The HBM
        ledger is composed by the deployment, which owns the device
        view."""
        return self.scope.stats(
            free=len(self._free), cached=len(self._cached),
            prefill_tokens=self.prefix_misses * self.block_size)

    def stats(self) -> Dict[str, float]:
        total = self.prefix_hits + self.prefix_misses
        out = {
            "num_blocks": self.num_blocks,
            "block_size": self.block_size,
            "blocks_in_use": self.blocks_in_use,
            "blocks_cached": self.blocks_cached,
            "blocks_free": self.blocks_free,
            "prefix_block_hits": self.prefix_hits,
            "prefix_block_misses": self.prefix_misses,
            "prefix_hit_rate": round(self.prefix_hits / total, 4)
            if total else 0.0,
            "cow_copies": self.cow_copies,
            "evictions": self.evictions,
            "partial_fills": self.partial_fills,
            "fill_tokens": self.fill_tokens,
            "prefix_keys_resident": len(self._index),
            "prefix_keys_exported": self.prefix_keys_exported,
        }
        if self.bytes_per_block:
            out["pool_bytes"] = self.bytes_per_block * self.num_blocks
            out["pool_bytes_per_chip"] = \
                out["pool_bytes"] // self.tensor_shards
            out["tensor_shards"] = self.tensor_shards
        return out
