"""The port's block pager, host KV tier and kvscope against the JAX
package's.

Seeded random scripts of the engine's own call sequence (match,
allocate or requeue, tier lookup and restore, COW of the write
boundary, register, a decode engine's handoff import, release) run
on ``ray_tpu.serve.kv_pager`` and on ``ray_tpu_torch.serve.kv_pager``
side by side: every call returns the
same thing, and after every call ``stats()``, ``prefix_keys()`` and
the kvscope block are equal.  The same for ``HostKVTier``'s
put/take/refresh under a byte budget.  Then the port's copies of the
cases of ``tests/test_kv_pager.py`` and of the pager/tier cases of
``tests/test_kv_tier.py``.  Pure host logic: no device arrays.
"""

import numpy as np
import pytest

from ray_tpu.serve import kv_pager as jpager
from ray_tpu.serve import kv_tier as jtier
from ray_tpu_torch.serve.kv_pager import BlockPager
from ray_tpu_torch.serve.kv_tier import HostKVTier, empty_kv_tier
from ray_tpu_torch.serve.kvscope import KVScope, empty_kv_scope

# ---------------------------------------------------------------------------
# parity: the same seeded script on both pagers
# ---------------------------------------------------------------------------


def _rows(fill, shape=(1, 4, 1, 2)):
    return np.full(shape, fill, np.float32)


def _scope_view(stats):
    """A kvscope block without its clock readings (perf_counter)."""
    occ = dict(stats["occupancy"])
    ring = [{k: v for k, v in s.items() if k != "t_s"}
            for s in occ.pop("ring")]
    occ.pop("last")
    return dict(stats, occupancy=dict(occ, ring=ring))


class _Twin:
    """Applies each call to the JAX pager and the port's, asserting
    equal results and equal state after it."""

    def __init__(self, num_blocks, block_size, max_seq, tier_budget):
        self.pagers = []
        for pager_cls, tier_cls in ((jpager.BlockPager, jtier.HostKVTier),
                                    (BlockPager, HostKVTier)):
            p = pager_cls(num_blocks, block_size, max_seq,
                          bytes_per_block=64,
                          host_tier=tier_cls(tier_budget)
                          if tier_budget else None)
            p.set_block_saver(lambda blk: (_rows(blk), _rows(-blk)))
            self.pagers.append(p)
        self.calls = 0
        self.imports = 0

    def __call__(self, name, *args, **kw):
        out = []
        for p in self.pagers:
            try:
                out.append(("ok", getattr(p, name)(*args, **kw)))
            except (MemoryError, ValueError) as e:
                out.append((type(e).__name__, str(e)))
        want, got = out
        if name == "tier_lookup":       # entries hold each tier's arrays
            want = (want[0], [k for k, _ in want[1]])
            got = (got[0], [k for k, _ in got[1]])
        assert got == want, (self.calls, name, args)
        self.check()
        self.calls += 1
        return out[1][1], out[0][1]

    def check(self):
        j, t = self.pagers
        assert t.stats() == j.stats()
        assert t.prefix_keys() == j.prefix_keys()
        assert _scope_view(t.kv_scope_stats()) == \
            _scope_view(j.kv_scope_stats())
        if j.tier is not None:
            assert t.tier.stats() == j.tier.stats()
            assert list(t.tier._store) == list(j.tier._store)


def _run_script(seed, *, tier_budget, n_ops=160, bs=4, max_seq=32,
                num_blocks=14):
    """The engine's admission/retirement sequence on random prompts
    built from a few shared prefixes, under pool pressure."""
    rng = np.random.RandomState(seed)
    handoffs = np.random.RandomState(seed + 100)
    twin = _Twin(num_blocks, bs, max_seq, tier_budget)
    prefixes = [list(rng.randint(1, 50, size=rng.randint(4, 17)))
                for _ in range(4)]
    live = []                     # (tokens, blocks) per admitted request
    for _ in range(n_ops):
        if handoffs.rand() < 0.15:
            # a decode engine's handoff admission, beside the script (its
            # own stream): a fresh chain (with spec headroom now and
            # then), no prefix probe, the imported full blocks indexed
            # without booking waste
            base = prefixes[handoffs.randint(len(prefixes))]
            tokens = [int(t) for t in base[:max_seq - 4]]
            twin("set_request", -1, tenant="decode")
            need, _ = twin("blocks_needed", len(tokens), 2,
                           headroom=int(handoffs.randint(0, 3)))
            alloc, _ = twin("allocate", need)
            if alloc is not None:
                twin("note_handoff_import", tokens, alloc)
                twin.imports += 1
                live.append((tokens, alloc))
            twin("set_request", None)
        if live and rng.rand() < 0.4:
            tokens, blocks = live.pop(rng.randint(len(live)))
            twin("release", blocks)
            continue
        base = prefixes[rng.randint(len(prefixes))]
        tokens = base + list(rng.randint(1, 50, size=rng.randint(0, 6)))
        tokens = [int(t) for t in tokens[:max_seq - 4]]
        new = int(rng.randint(1, 5))
        twin("set_request", len(live), tenant=f"t{seed % 3}")
        need, _ = twin("blocks_needed", len(tokens), new)
        (prefix_len, matched), _ = twin("match_prefix", tokens)
        alloc, _ = twin("allocate", need - len(matched))
        if alloc is None:
            twin("release", matched)
            continue
        blocks = matched + alloc
        pairs_t, pairs_j = twin("tier_lookup", tokens, len(matched))
        if pairs_t:
            restored = [p.note_tier_restore(pairs, alloc) for p, pairs in
                        zip(twin.pagers, (pairs_j, pairs_t))]
            assert restored[0] == restored[1]
            twin.check()
            prefix_len += restored[0]
        wb = prefix_len // bs
        if wb < len(matched):
            kind, res = [], []
            for p in twin.pagers:
                try:
                    res.append(p.ensure_private(blocks[wb]))
                    kind.append("ok")
                except MemoryError:
                    kind.append("oom")
            assert kind[0] == kind[1] and res[:1] == res[1:]
            twin.check()
            if kind[0] == "oom":
                twin("release", blocks)
                continue
            blocks[wb] = res[0][0]
        twin("register_prefix", tokens, blocks)
        if rng.rand() < 0.3:
            twin("note_fill", len(tokens), partial=bool(rng.rand() < .5))
        if rng.rand() < 0.5:
            twin("sample_occupancy")
        twin("set_request", None)
        live.append((tokens, blocks))
    for _, blocks in live:
        twin("release", blocks)
    assert twin.imports > 0
    return twin.pagers[1]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pager_script_matches_the_jax_pager(seed):
    pager = _run_script(seed, tier_budget=None)
    st = pager.stats()
    assert st["blocks_in_use"] == 0
    # the script must reach every branch it claims to cover
    assert st["evictions"] > 0 and st["prefix_block_hits"] > 0
    assert st["cow_copies"] > 0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pager_with_tier_script_matches_the_jax_pager(seed):
    # a budget of 12 blocks' rows (2 * 32 bytes each): the tier evicts
    pager = _run_script(seed, tier_budget=12 * 64)
    tier = pager.tier.stats()
    assert tier["saves"] > 0 and tier["hits"] > 0
    assert tier["evictions"] > 0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_host_tier_script_matches_the_jax_tier(seed):
    rng = np.random.RandomState(seed)
    budget = 5 * 64
    tiers = (jtier.HostKVTier(budget), HostKVTier(budget))
    keys = [tuple(range(k, k + 4)) for k in range(9)]
    for step in range(300):
        op = rng.randint(4)
        key = keys[rng.randint(len(keys))]
        if op == 0:
            fill = float(rng.randint(100))
            # an entry past the whole budget now and then: dropped
            shape = (1, 4, 1, 2) if rng.rand() < 0.9 else (1, 4, 1, 64)
            got = [t.put(key, _rows(fill, shape), _rows(-fill, shape))
                   for t in tiers]
        elif op == 1:
            got = [t.take(key) for t in tiers]
            got = [None if e is None else (e["bytes"], e["k"][0, 0, 0, 0])
                   for e in got]
        elif op == 2:
            got = [t.refresh(key) for t in tiers]
        else:
            secs = float(rng.rand()) * 1e-3
            got = []
            for t in tiers:
                t.note_h2d(secs)
                t.note_d2h(secs / 2)
                t.note_restored(4)
                got.append(None)
        assert got[0] == got[1], step
        assert tiers[1].stats() == tiers[0].stats(), step
        assert list(tiers[1]._store) == list(tiers[0]._store), step
    assert tiers[1].evictions > 0 and tiers[1].hits > 0


def test_empty_blocks_match_the_reference_shape():
    assert empty_kv_tier() == jtier.empty_kv_tier()
    want = dict(__import__("ray_tpu.serve.kvscope",
                           fromlist=["x"]).empty_kv_scope())
    assert empty_kv_scope() == want
    # the live block lacks only the HBM ledger, which the engine
    # composes (it owns the device view), as in the reference
    live = KVScope(9, 4).stats(free=8, cached=0)
    assert set(live) | {"hbm_ledger"} == set(empty_kv_scope())


# ---------------------------------------------------------------------------
# the port's copies of tests/test_kv_pager.py
# ---------------------------------------------------------------------------


def _pager(num_blocks=9, block_size=4, max_seq=16):
    return BlockPager(num_blocks, block_size, max_seq)


def test_constructor_validates_geometry():
    with pytest.raises(ValueError, match="multiple"):
        BlockPager(9, block_size=5, max_seq=16)
    with pytest.raises(ValueError, match="full"):
        # needs 4 blocks + null = 5 minimum
        BlockPager(4, block_size=4, max_seq=16)


def test_allocate_release_roundtrip_and_refcounts():
    p = _pager()
    assert p.blocks_free == 8          # block 0 reserved
    blocks = p.allocate(3)
    assert len(blocks) == 3
    assert 0 not in blocks             # null block never allocated
    assert p.blocks_in_use == 3 and p.blocks_free == 5
    p.release(blocks)
    assert p.blocks_in_use == 0 and p.blocks_free == 8
    # double release must blow up, not corrupt the free list
    with pytest.raises(ValueError, match="unallocated"):
        p.release([blocks[0]])


def test_allocate_exhaustion_returns_none_and_allocates_nothing():
    p = _pager()
    assert p.allocate(9) is None       # > 8 available
    assert p.blocks_free == 8          # nothing leaked
    got = p.allocate(8)
    assert len(got) == 8
    assert p.allocate(1) is None
    p.release(got[:1])
    assert p.allocate(1) is not None   # recycled after release


def test_match_prefix_exact_block_aligned_and_capped():
    p = _pager()
    prompt = list(range(10, 22))       # 12 tokens = 3 blocks of 4
    blocks = p.allocate(3)
    p.register_prefix(prompt, blocks)
    p.release(blocks)                  # park in the cached pool
    assert p.blocks_cached == 3
    # identical prompt: full match but capped at n-1
    n, matched = p.match_prefix(prompt)
    assert matched == blocks
    assert n == 11                     # len(prompt) - 1 cap
    p.release(matched)
    # longer prompt extending the prefix: all 3 blocks reusable
    n, matched = p.match_prefix(prompt + [99, 98])
    assert matched == blocks and n == 12
    p.release(matched)
    # diverging in the middle of block 2: only block 1 matches
    div = prompt[:5] + [777] + prompt[6:]
    n, matched = p.match_prefix(div)
    assert matched == blocks[:1] and n == 4
    p.release(matched)
    # content addressing: unrelated tokens match nothing
    n, matched = p.match_prefix([1, 2, 3, 4, 5])
    assert matched == [] and n == 0


def test_match_revives_cached_blocks_and_shares_refcounts():
    p = _pager()
    prompt = list(range(8))            # 2 full blocks
    blocks = p.allocate(2)
    p.register_prefix(prompt, blocks)
    # still live (ref 1) — a second matcher shares via refcount
    _, m1 = p.match_prefix(prompt + [50, 51, 52, 53])
    assert m1 == blocks
    p.release(blocks)                  # original owner retires
    assert p.blocks_cached == 0        # still referenced by matcher
    p.release(m1)
    assert p.blocks_cached == 2        # now parked, not freed


def test_lru_eviction_prefers_coldest_prefix():
    p = _pager(num_blocks=6, block_size=4, max_seq=16)  # 5 usable
    a, b = p.allocate(1), p.allocate(1)
    p.register_prefix([1, 2, 3, 4], a)
    p.register_prefix([5, 6, 7, 8], b)
    p.release(a)                       # a is LRU (parked first)
    p.release(b)
    got = p.allocate(4)                # free list has 3 -> evict 1
    assert len(got) == 4 and p.evictions == 1
    assert a[0] in got                 # the colder prefix went
    # evicted key must not match any more (index deregistered)
    n, matched = p.match_prefix([1, 2, 3, 4, 9])
    assert matched == [] and n == 0
    # b's key survived
    n, matched = p.match_prefix([5, 6, 7, 8, 9])
    assert matched == b
    p.release(matched)
    p.release(got)


def test_ensure_private_cow_semantics():
    p = _pager()
    prompt = list(range(4))
    blocks = p.allocate(1)
    # sole referent + unregistered: write in place, no fork
    blk, src = p.ensure_private(blocks[0])
    assert blk == blocks[0] and src is None and p.cow_copies == 0
    # registered block: fork even at refcount 1
    p.register_prefix(prompt, blocks)
    blk, src = p.ensure_private(blocks[0])
    assert blk != blocks[0] and src == blocks[0]
    assert p.cow_copies == 1
    # our ref moved to the fork; the original parked in the cache
    assert p.blocks_cached == 1
    p.release([blk])
    # shared block (ref 2): second owner's write forks too
    _, m = p.match_prefix(prompt + [9])
    assert m == blocks
    _, m2 = p.match_prefix(prompt + [7])
    blk2, src2 = p.ensure_private(m2[0])
    assert blk2 != m2[0] and src2 == m2[0] and p.cow_copies == 2
    p.release([blk2])
    p.release(m)


def test_ensure_private_raises_when_pool_exhausted():
    p = _pager(num_blocks=5, block_size=4, max_seq=16)  # 4 usable
    blocks = p.allocate(4)
    p.register_prefix([1, 2, 3, 4], blocks[:1])
    with pytest.raises(MemoryError):
        p.ensure_private(blocks[0])


def test_register_prefix_first_writer_wins():
    p = _pager()
    prompt = [1, 2, 3, 4]
    a = p.allocate(1)
    b = p.allocate(1)
    p.register_prefix(prompt, a)
    p.register_prefix(prompt, b)       # duplicate content: ignored
    _, matched = p.match_prefix(prompt + [9])
    assert matched == a
    p.release(matched)
    p.release(a)
    p.release(b)
    # b was never indexed, so its release frees it outright
    assert p.blocks_cached == 1


def test_prefix_keys_export_content_and_counter():
    p = _pager()
    assert p.prefix_keys() == []       # empty index, no keys
    a = p.allocate(1)
    b = p.allocate(1)
    p.register_prefix([1, 2, 3, 4], a)
    p.register_prefix([5, 6, 7, 8], b)
    keys = p.prefix_keys()
    assert sorted(keys) == [(1, 2, 3, 4), (5, 6, 7, 8)]
    assert all(isinstance(k, tuple) for k in keys)
    # the export counter accumulates per call (0 + 2 + 2)
    assert p.prefix_keys_exported == 2
    p.prefix_keys()
    assert p.prefix_keys_exported == 4
    s = p.stats()
    assert s["prefix_keys_resident"] == 2
    assert s["prefix_keys_exported"] == 4
    p.release(a)
    p.release(b)


def test_prefix_keys_track_eviction_and_deregistration():
    p = _pager(num_blocks=6, block_size=4, max_seq=16)  # 5 usable
    a, b = p.allocate(1), p.allocate(1)
    p.register_prefix([1, 2, 3, 4], a)
    p.register_prefix([5, 6, 7, 8], b)
    p.release(a)
    p.release(b)
    got = p.allocate(4)                # evicts the colder prefix (a)
    assert p.evictions == 1
    assert p.prefix_keys() == [(5, 6, 7, 8)]
    p.release(got)


def test_stats_shape_and_hit_rate():
    p = _pager()
    prompt = list(range(8))
    blocks = p.allocate(2)
    p.register_prefix(prompt, blocks)
    p.release(blocks)
    p.match_prefix(prompt + [30, 31, 32, 33])   # 2 hits, 1 miss
    s = p.stats()
    assert s["prefix_block_hits"] == 2
    assert s["prefix_block_misses"] == 1
    assert s["prefix_hit_rate"] == pytest.approx(2 / 3, abs=1e-3)
    for key in ("num_blocks", "block_size", "blocks_in_use",
                "blocks_cached", "blocks_free", "cow_copies",
                "evictions"):
        assert key in s


# ---------------------------------------------------------------------------
# the port's copies of tests/test_kv_tier.py's tier and pager-seam cases
# ---------------------------------------------------------------------------


def test_tier_budget_lru_eviction_and_oversize():
    # each entry is 2 * 32 = 64 bytes; budget fits exactly two
    tier = HostKVTier(128)
    assert tier.put((1,), _rows(1), _rows(-1)) == 64
    assert tier.put((2,), _rows(2), _rows(-2)) == 64
    assert tier.bytes_resident == 128 and len(tier) == 2
    # third entry LRU-evicts the first
    assert tier.put((3,), _rows(3), _rows(-3)) == 64
    assert tier.bytes_resident == 128
    assert (1,) not in tier and (2,) in tier and (3,) in tier
    assert tier.evictions == 1 and tier.saves == 3
    # an entry alone exceeding the whole budget is dropped, not stored
    big = np.zeros((1, 4, 1, 64), np.float32)   # 1024 bytes
    assert tier.put((9,), big, big) == 0
    assert (9,) not in tier and tier.bytes_resident == 128
    # re-putting a resident key refreshes bytes, not duplicates
    assert tier.put((2,), _rows(2), _rows(-2)) == 64
    assert tier.bytes_resident == 128 and len(tier) == 2


def test_tier_take_counts_probes_and_keeps_entry():
    tier = HostKVTier(1 << 10)
    tier.put((1, 2), _rows(7), _rows(-7))
    entry = tier.take((1, 2))
    assert entry is not None and entry["k"][0, 0, 0, 0] == 7
    # the tier is a cache: a hit keeps the entry resident
    assert (1, 2) in tier and tier.take((1, 2)) is not None
    assert tier.take((3, 4)) is None
    st = tier.stats()
    assert st["hits"] == 2 and st["misses"] == 1
    assert st["hit_rate"] == pytest.approx(2 / 3, abs=1e-4)
    # a take-hit refreshes LRU position: (1,2) must outlive newcomers
    tier2 = HostKVTier(128)
    tier2.put((1,), _rows(1), _rows(1))
    tier2.put((2,), _rows(2), _rows(2))
    tier2.take((1,))                      # (2,) is now LRU
    tier2.put((3,), _rows(3), _rows(3))
    assert (1,) in tier2 and (2,) not in tier2


def test_tier_engine_fed_copy_accounting():
    tier = HostKVTier(1 << 10)
    tier.note_h2d(0.002)
    tier.note_h2d(0.001)
    tier.note_d2h(0.004)
    tier.note_restored(32)
    st = tier.stats()
    assert st["h2d_ms"] == pytest.approx(3.0)
    assert st["d2h_ms"] == pytest.approx(4.0)
    assert st["tokens_restored"] == 32


def test_tier_validation_and_empty_shape():
    with pytest.raises(ValueError):
        HostKVTier(0)
    with pytest.raises(ValueError):
        HostKVTier(-1)
    live = HostKVTier(64).stats()
    empty = empty_kv_tier()
    assert set(empty) == set(live)
    assert live["enabled"] is True and empty["enabled"] is False
    assert all(not v for v in empty.values())


def _pager_with_tier(num_blocks=4, bs=4, budget=1 << 12):
    pager = BlockPager(num_blocks=num_blocks, block_size=bs, max_seq=8,
                       host_tier=HostKVTier(budget))
    # fake engine block-saver: rows stamped with the block id so a
    # restore's content provenance is checkable
    pager.set_block_saver(lambda blk: (_rows(blk), _rows(-blk)))
    return pager


def _park(pager, key_tokens):
    """allocate → register → release one single-block prefix."""
    blocks = pager.allocate(1)
    assert blocks is not None
    waste = pager.register_prefix(list(key_tokens), blocks)
    pager.release(blocks)
    return blocks[0], waste


def test_pager_spills_registered_block_on_eviction():
    pager = _pager_with_tier()          # 3 usable blocks + null
    keys = [tuple(range(10 * k, 10 * k + 4)) for k in range(4)]
    blks = {}
    for key in keys[:3]:
        blks[key], _ = _park(pager, key)
    # the 4th allocation evicts the LRU (keys[0]) and spills it first
    _park(pager, keys[3])
    tier = pager.tier
    assert keys[0] in tier and tier.saves == 1
    entry = tier._store[keys[0]]
    assert entry["k"][0, 0, 0, 0] == blks[keys[0]]  # right block's rows


def test_tier_lookup_chain_discipline_and_cap():
    pager = _pager_with_tier(num_blocks=8)
    toks = tuple(range(100, 112))       # 3 full blocks of 4
    k0, k1, k2 = toks[:4], toks[:8], toks[:12]
    tier = pager.tier
    tier.put(k0, _rows(0), _rows(0))
    tier.put(k2, _rows(2), _rows(2))    # gap: k1 missing
    # chain stops at the first miss — a gap cannot be skipped
    got = pager.tier_lookup(list(toks) + [999], 0)
    assert [k for k, _ in got] == [k0]
    assert pager.tier_lookup(list(toks) + [999], 1) == []
    tier.put(k1, _rows(1), _rows(1))
    got = pager.tier_lookup(list(toks) + [999], 0)
    assert [k for k, _ in got] == [k0, k1, k2]
    # the cap: with no tail token the last full block is NOT probed
    got = pager.tier_lookup(list(toks), 0)
    assert [k for k, _ in got] == [k0, k1]


def test_note_tier_restore_books_hits_not_waste():
    pager = _pager_with_tier()
    keys = [tuple(range(10 * k, 10 * k + 4)) for k in range(4)]
    for key in keys:                    # 4 parks through 3 blocks:
        _park(pager, key)               # keys[0] evicted + spilled
    assert keys[0] in pager.tier
    pager.set_request(7, tenant="t0")
    pairs = pager.tier_lookup(list(keys[0]) + [5], 0)
    assert [k for k, _ in pairs] == [keys[0]]
    alloc = pager.allocate(1)
    restored = pager.note_tier_restore(pairs, alloc)
    assert restored == 4
    # re-registering the same prompt books NO waste
    assert pager.register_prefix(list(keys[0]) + [5], alloc) == 0
    fx = pager.kv_scope_stats()["forensics"]
    assert fx["tier_hits"] == 1 and fx["tokens_restored"] == 4
    assert fx["reprefill_waste_tokens"] == 0
    assert pager.tier.tokens_restored == 4
    pager.set_request(None)
