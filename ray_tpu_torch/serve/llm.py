"""LM serving engine: GPT-2 or llama generation behind a scheduler.

Counterpart of ``ray_tpu/serve/llm.py``'s ``build_llm_deployment``.
Two schedulers:

  * "batch" — ``@batch`` micro-batching: concurrent requests are
    collected into one generation and run to completion together.
    Equal-length micro-batches take the fast path (one batched prefill
    through the flash kernel on CUDA); ragged ones are left-padded and
    trimmed back on return.
  * "continuous" — slot-based continuous batching: a fixed pool of
    ``max_slots`` KV-cache rows.  Each admitted request gets one
    prefill into a free slot; all decoding slots then share one decode
    step per token.  Finished sequences free their slot at once and
    queued requests are admitted mid-flight.  With
    ``kv_layout="paged"`` the rows are block tables into one shared
    block pool managed by ``serve/kv_pager.py``: resident prompt
    prefixes are reused instead of re-prefilled, a shared write
    boundary is forked copy-on-write, the LRU evicts cold prefixes,
    long prompts can be prefilled in chunks between decode waves
    (``prefill_chunk_tokens``) and evicted blocks can spill to a host
    RAM tier (``kv_host_tier_bytes``, ``serve/kv_tier.py``).
    ``spec_decode=SpecConfig(...)`` decodes speculatively: a draft
    (n-grams of the request's history, or a small draft model in a
    dense pool of its own) proposes k tokens a slot, and one target
    verify forward a round keeps the accepted ones and one target
    token.  ``role="prefill"`` engines answer with a ``HandoffCursor``
    (the prompt's filled block rows, on the device or staged through
    host memory with ``handoff_staged``) that a ``role="decode"``
    engine's ``admit_prefilled`` splices into its pool and decodes.

The reference's jitted engine programs are plain functions here
(``_engine_fns``) that update the pool in place, registered under the
reference's names in the program registry
(``_private/device_stats.py``).  The engine loop runs the device work
synchronously inside asyncio, as the reference does, and fences the
host once per decode wave.

Both schedulers report every request's lifecycle to an
``EngineTelemetry`` (``serve/telemetry.py``), timed around the host
fences the engine already makes: ``engine_stats()``,
``export_timeline()``, ``trace_records()``/``request_trace()``,
``anatomy_samples()`` and ``metrics_snapshot()`` read it.  The
continuous scheduler also takes ``admission_policy`` (load shedding
with ``OverloadedError``) and ``slo`` (an ``SLOConfig``: burn rates,
and flight-recorder dumps on a breach), and carries the fleet's attach
points ``_health`` (a ``HealthMonitor``), ``_chaos`` (a
``ChaosInjector``) and ``_replica_label``, which a caller sets as the
reference's router does.

``build_llm_deployment`` takes every keyword of the reference's and
validates them in its order: the combinations the reference rejects
raise the same ValueError here.  Under "batch" the keywords only the
continuous scheduler
reads (``stop_sequences``, ``eos_id``, ``max_slots``,
``prefill_bucket``, ``kv_block_size``, ``kv_num_blocks``,
``admission_policy``) are validated and ignored, as in the reference.
``build_llm_deployment`` returns a ``serve.api.Deployment`` record, as
the reference does: ``.func_or_class()`` is an engine, and
``await engine(prompt)`` answers one request.  ``num_replicas`` is
recorded on it; ``serve/router.py``'s fleet builds engines behind its
router, which also forwards a prefill engine's HandoffCursor to a
decode engine.  The continuous engine's ``__call__`` takes the
router's hooks ``enqueue_ts`` and ``trace``.  ``serve.run`` deploys
the record as replica actors on the core runtime (``serve/api.py``);
the device is resolved in the caller and again in the engine's
``__init__``, so ``cuda:0`` in a replica is its granted card and a
replica without a grant fails at construction.

Mesh-sharded serving (``mesh=``, the continuous scheduler only) is
tensor parallelism over the mesh's ``tensor`` axis.  The reference's
mesh is one controller driving every chip; the port's is a process
group, one process a card, so the engine runs SPMD, as the train step
does:

* every rank of the mesh calls ``build_llm_deployment(..., mesh=mesh)``
  with the same arguments and builds the engine, whose parameters and
  KV pool are this rank's blocks under ``DECODE_RULES``
  (models/decode_common.py: Megatron-style on the local blocks, the
  logits all-gathered, so every rank holds them whole);
* the mesh's first rank (the leader) takes every request and
  schedules; each engine program it runs (``_engine_fns``, registered
  as ``serve.sharded_*``) is first broadcast over the default process
  group as its name and host arguments (``_Lockstep``): tensors by
  value, the engine's own parameters, pools and generator by name (the
  generator with its state, so a program that samples draws the same
  numbers on every rank);
* every other rank (a follower) calls ``engine.follow()``, which runs
  each program it is sent on its own blocks until the leader's
  ``shutdown_engine()`` sends the stop message; the leader samples
  from the gathered logits and the next step carries the tokens.

A request sent to a follower raises ValueError.  With ``tensor`` at 1
every collective is the identity and the programs are the meshless
ones.
"""

from __future__ import annotations

import asyncio
import dataclasses
import pickle
import time
import types
import weakref
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ray_tpu_torch._private.device_stats import (device_memory_stats,
                                                 get_registry)
from ray_tpu_torch.device import DeviceLike, resolve_device
from ray_tpu_torch.models import gpt2_decode, llama_decode
from ray_tpu_torch.models.convert import (gpt2_params_from_numpy,
                                          llama_params_from_numpy)
from ray_tpu_torch.models.decode_common import (SamplingParams,
                                                copy_block,
                                                make_draft_propose,
                                                make_spec_verify,
                                                make_vocab_tail_mask,
                                                ngram_propose,
                                                sample_token, set_pool_row)
from ray_tpu_torch.models.decode_common import (gather_kv_heads,
                                                local_kv_heads,
                                                tensor_parallel_params)
from ray_tpu_torch.models.gpt2 import (gpt2_config, gpt2_init,
                                       gpt2_logical_axes)
from ray_tpu_torch.models.llama import (llama_config, llama_init,
                                        llama_logical_axes)
from ray_tpu_torch.serve.api import deployment
from ray_tpu_torch.serve.batching import (ChunkCursor, HandoffCursor,
                                          OverloadedError, RequestQueue)
from ray_tpu_torch.serve.batching import batch as _batch
from ray_tpu_torch.serve.kv_pager import BlockPager
from ray_tpu_torch.serve.kv_tier import HostKVTier, staging_buffers
from ray_tpu_torch.serve.kvscope import (hbm_ledger,
                                         serve_program_budget_bytes)
from ray_tpu_torch.serve.slo import SLOConfig, SLOTracker
from ray_tpu_torch.serve.telemetry import EngineTelemetry


@dataclasses.dataclass(frozen=True)
class SpecConfig:
    """Speculative decoding for the continuous engine (a copy of
    ``ray_tpu/serve/llm.py``'s).

    draft: "ngram" (a host-side draft from each request's own history,
    no weights) or "<family>:<preset>" (a small draft model, e.g.
    "llama:llama-s", whose k + 1 decode steps run each round).  k
    drafted tokens per slot are checked by one target verify forward
    per round.  draft_seed: the draft model's init seed (None: the
    engine's seed, so a draft of the target's family and preset is the
    target itself when the target was initialised from the seed too).
    """
    draft: str = "ngram"
    k: int = 4
    ngram_order: int = 2
    draft_seed: Optional[int] = None

    def __post_init__(self):
        if self.k < 1:
            raise ValueError(f"spec k must be >= 1, got {self.k}")
        if self.draft != "ngram":
            parts = self.draft.split(":")
            if len(parts) != 2 or parts[0] not in ("gpt2", "llama"):
                raise ValueError(
                    f"spec draft must be 'ngram' or "
                    f"'<family>:<preset>' with family gpt2|llama, "
                    f"got {self.draft!r}")
        if self.ngram_order < 1:
            raise ValueError(
                f"ngram_order must be >= 1, got {self.ngram_order}")


def _family_fns(family: str) -> types.SimpleNamespace:
    """The functions of a decoder family that the engine uses (the
    reference's ``_family_fns``)."""
    if family == "gpt2":
        m = gpt2_decode
        return types.SimpleNamespace(
            config=gpt2_config, init=gpt2_init, generate=m.generate,
            from_numpy=gpt2_params_from_numpy, prefill=m.prefill,
            step=m.decode_step, init_cache=m.init_cache,
            init_paged_cache=m.init_paged_cache,
            paged_prefill=m.paged_prefill, verify=m.verify_step,
            logical_axes=gpt2_logical_axes)
    m = llama_decode
    return types.SimpleNamespace(
        config=llama_config, init=llama_init, generate=m.llama_generate,
        from_numpy=llama_params_from_numpy, prefill=m.llama_prefill,
        step=m.llama_decode_step, init_cache=m.llama_init_cache,
        init_paged_cache=m.llama_init_paged_cache,
        paged_prefill=m.llama_paged_prefill, verify=m.llama_verify_step,
        logical_axes=llama_logical_axes)


def _kv_heads(cfg) -> int:
    """The heads a pool slot holds: llama GQA caches n_kv_head, gpt2
    n_head."""
    return getattr(cfg, "n_kv_head", None) or cfg.n_head


def _engine_fns(fam, cfg, sp: Optional[SamplingParams] = None,
                spec: Optional[SpecConfig] = None,
                draft=None) -> types.SimpleNamespace:
    """The continuous engine's device functions, the reference's
    ``_jitted_engine_fns`` (``ray_tpu/serve/llm.py:131-346``) without
    jit: each is a plain function on tensors that updates the pool in
    place and returns the same cache dict.

      prefill_raw / paged_prefill_raw / pool_logits — logits (1 or B,
          padded_vocab) of a dense B=1 prefill, a paged tail prefill,
          a pool decode step
      admit / clear_row / park_rows / copy_block / install_blocks /
          save_block — pool bookkeeping and the host tier's copies
      kv_handoff_export / kv_handoff_install — the prefill/decode
          handoff: a copy of a prefill's filled block rows, and their
          splice (with the row's table, pos and start) into a decode
          engine's pool
      spec_verify / draft_propose / draft_prefill — with ``spec``: the
          verify round at ``sp``'s sampling knobs (decode_common
          make_spec_verify); with a ``draft`` (its family's functions
          and config) too, the draft model's k + 1 steps and its
          prefill (None otherwise)

    The reference also jits sample-included twins (prefill,
    paged_prefill, pool_step) so that its default hot path is one
    dispatch; eager PyTorch gains nothing from that fusion, so the
    engine samples every logits row through its per-SamplingParams
    sampler (``_sampler_for``).  The engine hands the scalar arguments
    of paged_prefill_raw and kv_handoff_install over as numpy int32,
    as the reference does, so that the program registry keys them by
    type and not by value (``_instrumented``).

    Under tensor parallelism the pool holds this rank's KV heads; the
    rows that leave it (save_block, kv_handoff_export) are gathered
    whole over ``tensor``, and the rows that come in (install_blocks,
    kv_handoff_install) are cut to this rank's heads, so the host tier
    and a handoff carry whole rows, as the reference's do."""
    kv_heads = _kv_heads(cfg)

    def whole(rows, dim):
        return gather_kv_heads(rows, dim, kv_heads)

    def mine(rows, dim, pool):
        return local_kv_heads(rows, dim, pool.shape[3])

    def prefill_raw(p, toks, lens):
        return fam.prefill(p, toks, cfg, lengths=lens)

    def paged_prefill_raw(p, cache, toks, row_bt, prefix_len, n_tail,
                          slot):
        logits, cache = fam.paged_prefill(
            p, cache, toks, cfg, row_bt=row_bt,
            prefix_len=int(prefix_len), n_tail=int(n_tail),
            slot=int(slot))
        return logits[None], cache

    def pool_logits(p, cache, toks):
        return fam.step(p, cache, toks, cfg)

    def admit(pool, row, slot):
        # copy the B=1 prefill row into pool row `slot` (L, B, S, ...):
        # a copy, never an alias of the prefill's own cache
        for name in ("k", "v"):
            pool[name][:, slot].copy_(row[name][:, 0])
        for name in ("pos", "start"):
            pool[name][slot] = row[name][0]
        return pool

    def clear_row(cache, slot):
        # retire a row: its table points at the null block, so the
        # (masked, unread) writes of an idle row can never land in a
        # block the pager has handed to someone else
        cache["block_tables"][slot] = 0
        cache["pos"][slot] = 0
        return cache

    def park_rows(cache, draft_cache, idx):
        # idle rows (LLM._park_idle_rows): pos and start 0, a paged
        # row's table at the null block; the draft pool's rows too
        for pool in (cache, draft_cache):
            if pool is not None:
                pool["pos"][idx] = 0
                pool["start"][idx] = 0
        if "block_tables" in cache:
            cache["block_tables"][idx] = 0
        return cache

    def install_blocks(cache, blk_ids, k_stack, v_stack):
        # the host tier's restore: blk_ids (N,), stacks (N, L, bs, H,
        # hd) → pool blocks (L, N, bs, H, hd)
        for name, stack in (("k", k_stack), ("v", v_stack)):
            cache[name][:, blk_ids] = mine(stack, 3,
                                           cache[name]).transpose(0, 1)
        return cache

    def save_block(cache, blk):
        # the host tier's spill: host COPIES of one block's K and V
        # rows (L, bs, H, hd), so a later write into the block can
        # never change a spilled row
        return (whole(cache["k"][:, blk], 2).to("cpu", copy=True),
                whole(cache["v"][:, blk], 2).to("cpu", copy=True))

    def kv_handoff_export(cache, blk_ids):
        # the filled block rows of a finished prefill, (N, L, bs, H,
        # hd): advanced indexing COPIES them out of the pool, so the
        # prefill engine may free and reuse the blocks at once
        return (whole(cache["k"][:, blk_ids].transpose(0, 1), 3),
                whole(cache["v"][:, blk_ids].transpose(0, 1), 3))

    def kv_handoff_install(cache, blk_ids, k_stack, v_stack, slot,
                           row_bt, pos):
        # the decode side: land the rows in this pool's blocks and
        # point row `slot` at them at pos = the prompt length, start 0,
        # exactly the state paged_prefill leaves
        dev = cache["k"].device
        for name, stack in (("k", k_stack), ("v", v_stack)):
            cache[name][:, blk_ids] = mine(stack.to(dev), 3,
                                           cache[name]).transpose(0, 1)
        set_pool_row(cache, int(slot), row_bt, int(pos))
        return cache

    spec_verify = draft_propose = draft_prefill = None
    if spec is not None:
        sp = sp or SamplingParams()
        spec_verify = make_spec_verify(fam.verify, cfg, sp.temperature,
                                       sp.top_k, sp.top_p)
        if draft is not None:
            d_fam, d_cfg = draft
            draft_propose = make_draft_propose(
                d_fam.step, d_cfg, spec.k, sp.temperature, sp.top_k,
                sp.top_p, with_probs=sp.temperature > 0.0)

            def draft_prefill(p, toks, lens):
                return d_fam.prefill(p, toks, d_cfg, lengths=lens)

    return types.SimpleNamespace(
        prefill_raw=prefill_raw, paged_prefill_raw=paged_prefill_raw,
        pool_logits=pool_logits, admit=admit,
        clear_row=clear_row, park_rows=park_rows, copy_block=copy_block,
        install_blocks=install_blocks, save_block=save_block,
        kv_handoff_export=kv_handoff_export,
        kv_handoff_install=kv_handoff_install, spec_verify=spec_verify,
        draft_propose=draft_propose, draft_prefill=draft_prefill)


#: the engine programs the registry watches, under the reference's
#: names (``ray_tpu/serve/llm.py:291-345``); a mesh engine's are
#: ``serve.sharded_*``
_PROGRAMS = (("prefill_raw", "serve.prefill"),
             ("paged_prefill_raw", "serve.paged_prefill"),
             ("pool_logits", "serve.decode"),
             ("spec_verify", "serve.spec_verify"),
             ("draft_propose", "serve.spec_draft"),
             ("kv_handoff_export", "serve.kv_handoff_export"),
             ("kv_handoff_install", "serve.kv_handoff_install"))

#: the instrumented programs of each engine identity.  The reference
#: shares one set of jitted programs among the engines of one identity
#: (its ``_JIT_CACHE``), so a second such engine compiles nothing;
#: sharing the wrappers, and with them their seen signatures, keeps the
#: registry's compile events the reference's.  The wrapped functions
#: close over the family's functions and the configs only, never over
#: an engine.
_PROGRAM_CACHE: Dict[Any, Dict[str, Any]] = {}


def _instrumented(fns: types.SimpleNamespace, key,
                  n_devices: Optional[int] = None) -> types.SimpleNamespace:
    """Swap ``fns``' engine programs for the registry-instrumented
    ones of identity ``key`` (made from these on first sight).
    ``n_devices``: a mesh engine's size; its programs are registered
    as ``serve.sharded_*`` over that many devices."""
    progs = _PROGRAM_CACHE.get(key)
    if progs is None:
        registry = get_registry()
        prefix = "serve." if n_devices is None else "serve.sharded_"
        progs = _PROGRAM_CACHE[key] = {
            attr: registry.instrument(prefix + name[len("serve."):],
                                      getattr(fns, attr),
                                      n_devices=n_devices or 1)
            for attr, name in _PROGRAMS if getattr(fns, attr) is not None}
    for attr, fn in progs.items():
        setattr(fns, attr, fn)
    return fns


def _tier_saver(save_block, cache, tier):
    """The pager's block-saver callback: host copies of one pool
    block's K/V rows at eviction time, the copy timed into the tier's
    d2h bucket (the tier itself reads no clock).  A closure over the
    pool, not a method of the engine: the engine's pager holds it, and
    a bound method would put the engine in a reference cycle that keeps
    its device memory until the collector runs."""

    def save(blk):
        t0 = time.perf_counter()
        rows = save_block(cache, blk)
        tier.note_d2h(time.perf_counter() - t0)
        return rows

    return save


#: the message that asks every rank for its card's allocator stats
_DEVICE_STATS = "__device_stats__"

#: the engine's own objects a program may take, sent by name
_REFS = {"params": "params", "cache": "_cache",
         "draft_params": "_draft_params", "draft_cache": "_draft_cache"}


#: every mesh engine's lockstep in this process, in construction order:
#: the ranks build their engines alike, so an index names one engine on
#: each rank (a prefill/decode pair shares the followers' loop)
_LOCKSTEPS: List["weakref.ref"] = []
#: the leader's view of its followers: following, until a stop message
_FOLLOWERS = {"following": True}


class _Lockstep:
    """A mesh engine's programs (module docstring): on the leader each
    call is broadcast, then run; a follower's ``follow`` runs what it is
    sent, for any mesh engine of its process.  Every program runs under
    the mesh (``mesh_context``), and the last result of each is kept,
    so a later call can name it (the row of a prefill that ``admit``
    copies into the pool).  The engine is held weakly: an engine and
    its programs make no reference cycle."""

    def __init__(self, engine, fns: types.SimpleNamespace, mesh):
        import torch.distributed as dist

        self._engine_ref = weakref.ref(engine)
        self._fns, self._mesh = fns, mesh
        self._last: Dict[str, Any] = {}
        self.leader = int(mesh.mesh.flatten()[0])
        self.is_leader = dist.get_rank() == self.leader
        #: a mesh of one rank has no follower: nothing is sent
        self._solo = dist.get_world_size() == 1
        self._device = (torch.device("cuda", torch.cuda.current_device())
                        if mesh.device_type == "cuda" else None)
        self.index = len(_LOCKSTEPS)
        _LOCKSTEPS.append(weakref.ref(self))

    @property
    def _engine(self):
        return self._engine_ref()

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        fn = getattr(self._fns, name)
        if fn is None:
            return None

        def call(*args):
            if not self._solo:
                _FOLLOWERS["following"] = True
                self._send((self.index, name,
                            [self._encode(a) for a in args]))
            return self._run(name, fn, args)

        return call

    def _send(self, msg):
        import torch.distributed as dist

        objs = [msg]
        dist.broadcast_object_list(objs, src=self.leader,
                                   device=self._device)
        return objs[0]

    def _run(self, name, fn, args):
        from ray_tpu_torch.parallel.mesh import mesh_context

        with mesh_context(self._mesh):
            out = fn(*args)
        self._last[name] = out
        return out

    def _encode(self, a):
        for key, attr in _REFS.items():
            if a is not None and a is getattr(self._engine, attr, None):
                return ("ref", key)
        if isinstance(a, torch.Generator):
            return ("gen", a.get_state())
        for name, res in self._last.items():
            for i, r in enumerate(res if isinstance(res, tuple) else ()):
                if a is r:
                    return ("res", name, i)
        if isinstance(a, torch.Tensor):
            return ("t", a.detach().cpu())
        return ("v", a)

    def _decode(self, a):
        kind = a[0]
        if kind == "ref":
            return getattr(self._engine, _REFS[a[1]])
        if kind == "gen":
            gen = self._engine._generator
            gen.set_state(a[1])
            return gen
        if kind == "res":
            return self._last[a[1]][a[2]]
        if kind == "t":
            return a[1].to(self._engine.device)
        return a[1]

    def follow(self) -> int:
        """A follower's loop: run each program the leader sends, on the
        engine it names (or join its ``device_stats``), until its stop
        message.  Returns the number of programs run."""
        n = 0
        while True:
            msg = self._send(None)
            if msg is None:
                return n
            index, name, args = msg
            step = _LOCKSTEPS[index]()
            if name == _DEVICE_STATS:
                step._all_device_stats()
                continue
            step._run(name, getattr(step._fns, name),
                      [step._decode(a) for a in args])
            n += 1

    def device_stats(self) -> list:
        """Every rank's card's allocator stats, in rank order (the
        reference's per-chip list); the leader's own alone once the
        followers have stopped."""
        if self._solo or not (self.is_leader and _FOLLOWERS["following"]):
            return device_memory_stats([self._engine.device])
        self._send((self.index, _DEVICE_STATS, None))
        return self._all_device_stats()

    def _all_device_stats(self) -> list:
        import torch.distributed as dist

        rows = [None] * dist.get_world_size()
        dist.all_gather_object(rows,
                               device_memory_stats([self._engine.device]))
        return [row for rank_rows in rows for row in rank_rows]

    def stop(self) -> None:
        """The leader's stop message, sent once after the programs of a
        round of following, whichever engine's shutdown sends it (a
        follower calls ``follow`` once a round)."""
        if _FOLLOWERS["following"] and not self._solo:
            _FOLLOWERS["following"] = False
            self._send(None)


def build_llm_deployment(family: str = "gpt2", preset: str = "nano",
                         *, max_new_tokens: int = 16,
                         temperature: float = 0.0,
                         top_k: int = 0, top_p: float = 1.0,
                         stop_sequences=None,
                         eos_id: Optional[int] = None,
                         max_batch_size: int = 8,
                         batch_wait_timeout_s: float = 0.05,
                         checkpoint_path: Optional[str] = None,
                         seed: int = 0, num_replicas: int = 1,
                         scheduler: str = "batch",
                         max_slots: int = 4,
                         prefill_bucket: int = 16,
                         kv_layout: str = "dense",
                         kv_block_size: int = 16,
                         kv_num_blocks: Optional[int] = None,
                         prefill_chunk_tokens: Optional[int] = None,
                         kv_host_tier_bytes: Optional[int] = None,
                         admission_policy=None,
                         slo=None,
                         mesh=None,
                         spec_decode=None,
                         role: str = "both",
                         handoff_staged: bool = False,
                         config_overrides: Optional[Dict[str, Any]]
                         = None,
                         device: DeviceLike = None):
    """An LM engine class generating continuations for int token
    prompts (1-D per request; ragged lengths welcome — each caller gets
    back its own prompt + continuation, pads trimmed, as int32 numpy).

    family: "gpt2" or "llama"; preset: a preset of that family.
    max_new_tokens, temperature, top_k, top_p: generation and sampling
    knobs (greedy at temperature 0).  scheduler: "batch" (``@batch``
    micro-batches of at most max_batch_size, collected for
    batch_wait_timeout_s) or "continuous" (module docstring).
    checkpoint_path: a pickled parameter tree of numpy arrays in the
    JAX package's layout of the family; absent → a fresh init from
    ``seed`` (tests/demos).  config_overrides: GPT2Config or
    LlamaConfig fields (torch dtypes).  device: None = the first CUDA
    device (raises without one); "cpu" must be asked for.

    Continuous scheduler: max_slots KV rows; prompts padded up to
    prefill_bucket multiples (as the reference, which compiles once per
    bucket); stop_sequences / eos_id end a request when its generated
    tokens end with one (its slot and blocks free at once).
    kv_layout "dense" (per-slot rows, the parity oracle) or "paged"
    (kv_block_size-token blocks; kv_num_blocks, default enough for
    every slot plus one sequence of prefix-cache headroom);
    prefill_chunk_tokens (paged: prompt tails longer than this are
    prefilled in chunks of it, a multiple of kv_block_size, one chunk
    between decode waves, round-robin over the slots prefilling);
    kv_host_tier_bytes (paged: evicted prefix blocks spill to a host
    store of this many bytes and are restored by copy instead of
    re-prefill).  A continuous engine's ``__call__`` also takes
    ``sampling=SamplingParams(...)`` per request (not under
    spec_decode) and ``tenant=``.  spec_decode: a SpecConfig (module
    docstring; paged admissions reserve k slots of headroom).  role
    "prefill" | "decode" (paged): a prefill engine's reply is a
    HandoffCursor (rows kept on the device, or staged through host
    memory with handoff_staged) that a decode engine's
    ``admit_prefilled`` turns into prompt + continuation.
    admission_policy (continuous): a ``serve.batching.AdmissionPolicy``
    consulted before each request is queued; a shed request raises
    ``OverloadedError``.  slo (continuous): a ``serve.slo.SLOConfig``
    whose burn rates ``engine_stats()["slo"]`` reports, dumping the
    flight recorder on a breach.

    num_replicas is recorded on the returned Deployment (a fleet of
    engines: ``serve.router.build_llm_fleet``).

    Returns ``deployment(name=f"llm_{family}_{preset}",
    num_replicas=num_replicas)`` of the engine class;
    ``await dep.func_or_class()(prompt)`` answers one request."""
    if family not in ("gpt2", "llama"):
        raise ValueError(f"unknown LM family {family!r}")
    if scheduler not in ("batch", "continuous"):
        raise ValueError(f"unknown scheduler {scheduler!r} "
                         f"(expected 'batch' or 'continuous')")
    if kv_layout not in ("dense", "paged"):
        raise ValueError(f"unknown kv_layout {kv_layout!r} "
                         f"(expected 'dense' or 'paged')")
    # what the reference rejects (ray_tpu/serve/llm.py:479-563), in its
    # order
    if kv_layout == "paged" and scheduler != "continuous":
        raise ValueError("kv_layout='paged' requires "
                         "scheduler='continuous' (the block pager "
                         "lives in the continuous engine)")
    if prefill_chunk_tokens is not None:
        if kv_layout != "paged":
            raise ValueError(
                "prefill_chunk_tokens requires kv_layout='paged' "
                "(chunks fill KV blocks incrementally through "
                "paged_prefill; dense keeps one-shot prefill as the "
                "bit-exactness oracle)")
        if prefill_chunk_tokens < 1 \
                or prefill_chunk_tokens % kv_block_size:
            raise ValueError(
                f"prefill_chunk_tokens={prefill_chunk_tokens} must be "
                f"a positive multiple of kv_block_size="
                f"{kv_block_size} (chunks must end on block "
                "boundaries so prior chunks are resident prefix "
                "blocks)")
    if kv_host_tier_bytes is not None:
        if kv_layout != "paged":
            raise ValueError(
                "kv_host_tier_bytes requires kv_layout='paged' (the "
                "host tier spills and restores the pager's KV "
                "blocks; dense rows are never evicted)")
        if int(kv_host_tier_bytes) <= 0:
            raise ValueError(
                f"kv_host_tier_bytes={kv_host_tier_bytes} must be a "
                "positive byte budget")
    if role not in ("both", "prefill", "decode"):
        raise ValueError(f"unknown role {role!r} (expected 'both', "
                         "'prefill', or 'decode')")
    if role != "both":
        if scheduler != "continuous":
            raise ValueError(
                f"role={role!r} requires scheduler='continuous' "
                "(the handoff parks/admits through the slot-pool "
                "engine loop)")
        if kv_layout != "paged":
            raise ValueError(
                f"role={role!r} requires kv_layout='paged' (the "
                "handoff moves block rows between pagers; dense rows "
                "have no block-granular identity to hand off)")
    if handoff_staged and role == "both":
        raise ValueError(
            "handoff_staged only applies to split roles "
            "(role='prefill' exports through host staging; a "
            "monolithic engine never hands off)")
    if mesh is not None and scheduler != "continuous":
        raise ValueError("mesh-sharded serving requires "
                         "scheduler='continuous' (the batch scheduler "
                         "is single-device)")
    if spec_decode is not None:
        if not isinstance(spec_decode, SpecConfig):
            raise ValueError("spec_decode must be a SpecConfig, got "
                             f"{type(spec_decode).__name__}")
        if scheduler != "continuous":
            raise ValueError("spec_decode requires "
                             "scheduler='continuous' (speculation "
                             "lives in the slot-pool engine loop)")
    if slo is not None:
        if not isinstance(slo, SLOConfig):
            raise ValueError("slo must be a serve.slo.SLOConfig, got "
                             f"{type(slo).__name__}")
        if scheduler != "continuous":
            raise ValueError("slo requires scheduler='continuous' "
                             "(the burn-rate watchdog runs from the "
                             "slot-pool engine loop)")
    # validates the knobs; the engine's default per-request params
    default_sp = SamplingParams(temperature=temperature, top_k=top_k,
                                top_p=top_p)
    stop_seqs = tuple(
        tuple(int(t) for t in np.asarray(s, np.int64).reshape(-1))
        for s in (stop_sequences or ()))
    if any(len(s) == 0 for s in stop_seqs):
        raise ValueError("empty stop sequence")
    if not isinstance(num_replicas, int) or num_replicas < 1:
        raise ValueError(f"num_replicas must be a positive int, got "
                         f"{num_replicas!r}")
    dev = resolve_device(device)
    fam = _family_fns(family)

    class LLM:
        def __init__(self):
            # resolved again where the engine is built: in a replica
            # actor without a GPU grant this raises "no CUDA device" at
            # construction, not a raw CUDA error at the first request
            self.device = resolve_device(dev)
            #: the disaggregated serving role: "prefill" engines answer
            #: with a HandoffCursor, "decode" ones take it through
            #: admit_prefilled, "both" serve whole requests
            self.role = role
            self.cfg = fam.config(preset, **dict(config_overrides or {}))
            if checkpoint_path:
                # a parameter tree this project wrote (see docstring)
                with open(checkpoint_path, "rb") as f:
                    tree = pickle.load(f)
                self.params = fam.from_numpy(tree, self.cfg, dev)
            else:
                self.params = fam.init(
                    self.cfg, torch.Generator(device=dev).manual_seed(seed),
                    dev)
            self.mesh = mesh
            self._lockstep = None
            #: whether this engine takes requests: False on a mesh's
            #: follower ranks (module docstring)
            self.is_leader = True
            if mesh is not None:
                # this rank's blocks under DECODE_RULES, as the
                # reference commits its params to the mesh
                self.params = tensor_parallel_params(
                    self.params, fam.logical_axes(self.cfg), mesh)
            # per-engine sampling stream: without it every sampled
            # request would draw the same "random" continuation
            self._generator = torch.Generator(device=dev).manual_seed(
                seed + 1)
            # host-side lifecycle telemetry (enqueue / admit / first
            # token / step / finish records → metrics, engine_stats,
            # timeline); it reads no device tensor
            self._telemetry = EngineTelemetry(
                f"llm_{family}_{preset}",
                max_slots=(max_slots if scheduler == "continuous"
                           else max_batch_size),
                role=role)
            #: the fleet's health and chaos attach points: a router
            #: (or a caller, until the router is ported) sets these
            #: after construction; a standalone engine keeps them None,
            #: one ``is None`` check a wave
            self._health = None
            self._chaos = None
            self._replica_label = f"llm_{family}_{preset}"
            self._pager = None
            #: the batch scheduler's generate calls, one prefill each
            self._generate_calls = 0
            if scheduler == "continuous":
                self._init_continuous()

        def _oversized(self, n: int) -> ValueError:
            """The reference's rejection of an empty prompt or one
            leaving no room for max_new_tokens."""
            return ValueError(f"prompt length {n} invalid for "
                              f"max_seq={self.cfg.max_seq} with "
                              f"max_new_tokens={max_new_tokens}")

        # ------------------------------------------------------------
        # "batch" scheduler: @batch over (possibly ragged) lists
        # ------------------------------------------------------------

        def _generate(self, toks, lengths=None):
            self._generate_calls += 1
            with torch.inference_mode():
                return fam.generate(
                    self.params, toks, self.cfg,
                    max_new_tokens=max_new_tokens,
                    temperature=temperature, top_k=top_k, top_p=top_p,
                    lengths=lengths, generator=self._generator)

        @_batch(max_batch_size=max_batch_size,
                batch_wait_timeout_s=batch_wait_timeout_s)
        async def _call_batch(self, prompts):
            # host-side prompt normalization (python ints, no device fetch)
            # graftcheck: disable=blocking-call-in-async(host-side int normalization)
            arrs = [np.asarray(p, np.int32).reshape(-1) for p in prompts]
            lens = [int(a.shape[0]) for a in arrs]
            t0 = max(lens)
            if min(lens) == t0:
                # equal-length fast path: no pads, flash-eligible
                toks = torch.from_numpy(np.stack(arrs)).to(self.device)
                out = self._generate(toks).cpu().numpy()
                return [row for row in out]
            padded = np.zeros((len(arrs), t0), np.int32)
            for i, a in enumerate(arrs):
                padded[i, t0 - lens[i]:] = a
            out = self._generate(
                torch.from_numpy(padded).to(self.device),
                torch.tensor(lens, dtype=torch.int32,
                             device=self.device)).cpu().numpy()
            # trim the left pads: each caller sees prompt+continuation
            return [row[t0 - n:] for row, n in zip(out, lens)]

        async def _call_batch_checked(self, prompt, sampling=None):
            if sampling is not None:
                raise ValueError(
                    "per-request sampling requires "
                    "scheduler='continuous' (the batch scheduler runs "
                    "one fused generate per micro-batch)")
            # request-level telemetry wraps the @batch queue, so the
            # recorded latency includes the batch-collection wait; the
            # prompt is a host-side list: its length moves no device data
            # graftcheck: disable=blocking-call-in-async(host-side length probe)
            n_prompt = int(np.asarray(prompt).reshape(-1).shape[0])
            rec = self._telemetry.record_enqueue(n_prompt)
            if n_prompt == 0 or \
                    n_prompt + max_new_tokens > self.cfg.max_seq:
                # validate before batching: an oversized prompt would
                # otherwise fail the whole micro-batch inside generate
                self._telemetry.record_reject(
                    rec, reason=f"prompt length {n_prompt}",
                    label="oversized")
                raise self._oversized(n_prompt)
            try:
                out = await self._call_batch(prompt)
            except Exception as e:  # noqa: BLE001 - caller sees it too
                self._telemetry.record_error(rec, error=repr(e))
                raise
            self._telemetry.record_finish(rec, n_tokens=max_new_tokens)
            return out

        # ------------------------------------------------------------
        # "continuous" scheduler: slot pool with mid-flight admission
        # ------------------------------------------------------------

        def _init_continuous(self):
            cfg = self.cfg
            max_seq = cfg.max_seq
            self._init_spec()
            if kv_layout == "paged":
                max_blk = max_seq // kv_block_size
                # default pool: every slot can hold a full sequence,
                # plus one sequence of headroom so the prefix cache and
                # COW forks survive a fully-occupied pool
                n_blocks = (kv_num_blocks if kv_num_blocks is not None
                            else 1 + (max_slots + 1) * max_blk)
                kv_heads = _kv_heads(cfg)
                bytes_per_block = (2 * cfg.n_layer * kv_block_size
                                   * kv_heads * cfg.head_dim
                                   * cfg.dtype.itemsize)
                host_tier = (HostKVTier(kv_host_tier_bytes)
                             if kv_host_tier_bytes is not None else None)
                self._pager = BlockPager(
                    n_blocks, kv_block_size, max_seq,
                    bytes_per_block=bytes_per_block,
                    tensor_shards=self._kv_shards(),
                    recorder=self._telemetry.flightrec,
                    host_tier=host_tier)
                self._cache = fam.init_paged_cache(
                    cfg, max_slots, num_blocks=n_blocks,
                    block_size=kv_block_size, device=dev, mesh=self.mesh)
                if host_tier is not None:
                    self._pager.set_block_saver(_tier_saver(
                        self._fns.save_block, self._cache, host_tier))
                    # persistent host staging for the restore path,
                    # whole rows (L, bs, kv_heads, hd) as the tier keeps
                    # them under a mesh too
                    rows = (cfg.n_layer, kv_block_size, kv_heads,
                            cfg.head_dim)
                    self._tier_stage = staging_buffers(
                        max_blk, (max_blk,) + rows, cfg.dtype,
                        pin=dev.type == "cuda")
            else:
                self._cache = fam.init_cache(cfg, max_slots, device=dev,
                                             mesh=self.mesh)
            self._cur = np.zeros((max_slots,), np.int32)
            self._slots = [None] * max_slots
            self._queue = RequestQueue()
            self._wake = None           # asyncio.Event, made on-loop
            self._engine_task = None
            self._samplers = {}     # SamplingParams -> sampler
            # round-robin cursor over slots mid-prefill (chunked)
            self._chunk_rr = 0
            self._requeues = 0
            # the registry's compile events count in this engine's
            # program_compiles, and its storm trips reach the flight
            # recorder (and, with an SLO, a dump); held weakly, so a
            # retired engine drops out
            get_registry().subscribe(
                self._telemetry.record_program_compile)
            get_registry().subscribe_storms(self._telemetry.record_storm)
            if slo is not None:
                self._telemetry.slo = SLOTracker(
                    slo, self._telemetry,
                    recorder=self._telemetry.flightrec)

        def _init_spec(self) -> None:
            """The engine's device functions and, with spec_decode, the
            draft: for a model draft its config (the target's vocab, at
            least its max_seq), its weights from draft_seed (default:
            the engine's seed) and a dense pool of max_slots rows."""
            cfg = self.cfg
            draft = None
            self._draft_params = self._draft_cache = None
            self._draft_cfg = None
            if spec_decode is not None:
                # per slot: how many of last round's drafts the target
                # rejected (the draft cache rewinds that many first)
                self._spec_rej = np.zeros((max_slots,), np.int32)
                if spec_decode.draft != "ngram":
                    d_family, d_preset = spec_decode.draft.split(":")
                    d_fam = _family_fns(d_family)
                    # overrides describe THIS family's config fields; a
                    # draft of the other family takes its preset as is
                    d_over = (dict(config_overrides or {})
                              if d_family == family else {})
                    d_cfg = d_fam.config(d_preset, **d_over)
                    if (d_cfg.vocab_size != cfg.vocab_size
                            or d_cfg.padded_vocab != cfg.padded_vocab):
                        raise ValueError(
                            f"spec draft vocab "
                            f"{d_cfg.vocab_size}/{d_cfg.padded_vocab} "
                            f"!= target "
                            f"{cfg.vocab_size}/{cfg.padded_vocab} — "
                            "draft proposals index the target vocab")
                    if d_cfg.max_seq < cfg.max_seq:
                        raise ValueError(
                            f"spec draft max_seq {d_cfg.max_seq} < "
                            f"target max_seq {cfg.max_seq} — the "
                            "draft cache must track every target "
                            "position")
                    d_seed = (spec_decode.draft_seed
                              if spec_decode.draft_seed is not None
                              else seed)
                    self._draft_params = d_fam.init(
                        d_cfg, torch.Generator(device=dev).manual_seed(
                            d_seed), dev)
                    # dense, whatever the target's layout: the draft is
                    # small and a row pool keeps its pos arithmetic plain
                    self._draft_cache = d_fam.init_cache(d_cfg, max_slots,
                                                         device=dev)
                    self._draft_cfg = d_cfg
                    draft = (d_fam, d_cfg)
            # the reference's _JIT_CACHE key (the draft's config follows
            # from spec_decode and the target's)
            self._fns = _instrumented(
                _engine_fns(fam, cfg, default_sp, spec_decode, draft),
                (family, cfg, default_sp, kv_layout, spec_decode, mesh),
                n_devices=mesh.size() if mesh is not None else None)
            if mesh is not None:
                self._fns = self._lockstep = _Lockstep(self, self._fns,
                                                       mesh)
                self.is_leader = self._lockstep.is_leader

        def _kv_shards(self) -> int:
            """How many ways the KV pool's head dim splits on the mesh
            (1 without one, or when the head count does not divide the
            tensor degree: the GQA guard)."""
            if self.mesh is None:
                return 1
            from ray_tpu_torch.parallel.mesh import AXIS_TENSOR, mesh_shape

            t = mesh_shape(self.mesh)[AXIS_TENSOR]
            return t if t > 1 and _kv_heads(self.cfg) % t == 0 else 1

        def follow(self) -> int:
            """A follower rank's part of mesh-sharded serving (module
            docstring): run the leader's programs on this rank's blocks
            until its shutdown_engine(); returns how many ran."""
            if self._lockstep is None or self._lockstep.is_leader:
                raise ValueError(
                    "follow() is for a follower rank of a mesh engine "
                    "(the mesh's first rank takes the requests)")
            with torch.no_grad():
                return self._lockstep.follow()

        def _check_leader(self) -> None:
            if self._lockstep is not None and not self._lockstep.is_leader:
                raise ValueError(
                    "this rank follows the mesh's first rank, which takes "
                    "every request: call follow() here")

        def _fence(self) -> None:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

        def _sampler_for(self, sp):
            """Full-batch sampler of one SamplingParams (None: the
            engine default), cached on the WHOLE SamplingParams (the
            lesson of the reference's _JIT_CACHE: a key on one knob
            would hand a top_k change the old sampler)."""
            sp = sp or default_sp
            fn = self._samplers.get(sp)
            if fn is None:
                tail = make_vocab_tail_mask(self.cfg, dev)

                def fn(logits, gen):
                    return sample_token(logits, gen, sp.temperature, tail,
                                        sp.top_k, sp.top_p)

                self._samplers[sp] = fn
            return fn

        def _hit_stop(self, out) -> bool:
            """Host-side stop matching over the GENERATED tokens (the
            prompt can never trigger a stop)."""
            if eos_id is not None and out[-1] == eos_id:
                return True
            for s in stop_seqs:
                if len(out) >= len(s) and tuple(out[-len(s):]) == s:
                    return True
            return False

        def _set_request(self, rec) -> None:
            ctx = rec.get("ctx")
            self._pager.set_request(
                rec["id"], ctx.trace_id if ctx is not None else None,
                tenant=rec.get("tenant"))

        def _resolve(self, fut, arr, out) -> None:
            if not fut.done():
                fut.set_result(np.concatenate(
                    [arr, np.asarray(out, np.int32)]))

        def _finish_early(self, fut, arr, rec, first) -> None:
            """A request that ends at its first token (max_new_tokens
            1 or a stop hit)."""
            self._telemetry.record_finish(rec, n_tokens=1)
            self._resolve(fut, arr, [first])

        def _draft_admit(self, slot, arr) -> None:
            """Mirror a just-admitted request into the draft pool: a
            draft prefill of the whole prompt (the dense draft pool has
            no prefix cache) copied into row ``slot``.  The target's
            first token stays the row's ``cur``; the draft's is not
            drawn."""
            if spec_decode is None:
                return
            self._spec_rej[slot] = 0
            if self._draft_params is None:
                return
            n = int(arr.shape[0])
            t_pad = -(-n // prefill_bucket) * prefill_bucket
            t_pad = max(n, min(t_pad, self._draft_cfg.max_seq
                               - max_new_tokens))
            padded = np.zeros((1, t_pad), np.int32)
            padded[0, t_pad - n:] = arr
            _, row = self._fns.draft_prefill(
                self._draft_params, torch.from_numpy(padded).to(dev),
                torch.tensor([n], dtype=torch.int32, device=dev))
            self._fns.admit(self._draft_cache, row, slot)

        def _admit_pending(self) -> None:
            """Prefill queued requests into free slots (one prefill
            each; K/V rows land in the pool).  Paged layout: blocks are
            matched/allocated through the pager first — a request the
            pool cannot hold yet goes back to the queue HEAD and
            admission pauses until a retirement frees blocks.  A
            HandoffCursor (admit_prefilled) is spliced in, never
            prefilled."""
            while len(self._queue):
                free = [i for i, s in enumerate(self._slots) if s is None]
                if not free:
                    return
                ((arr, rec, sp), fut), = self._queue.pop(1)
                if isinstance(arr, HandoffCursor):
                    if not self._admit_one_handoff(arr, rec, fut, free[0]):
                        return          # pool exhausted — retry later
                    continue
                n = int(arr.shape[0])
                if n == 0 or n + max_new_tokens > self.cfg.max_seq:
                    self._telemetry.record_reject(
                        rec, reason=f"prompt length {n}",
                        label="oversized")
                    if not fut.done():
                        fut.set_exception(self._oversized(n))
                    continue
                slot = free[0]
                if self._pager is not None:
                    if not self._admit_one_paged(arr, rec, sp, fut, slot):
                        return          # pool exhausted — retry later
                    continue
                # pad up to the bucket, never past the decode headroom
                t_pad = -(-n // prefill_bucket) * prefill_bucket
                t_pad = max(n, min(t_pad,
                                   self.cfg.max_seq - max_new_tokens))
                self._telemetry.record_admit(rec, slot, t_pad)
                padded = np.zeros((1, t_pad), np.int32)
                padded[0, t_pad - n:] = arr
                logits, row = self._fns.prefill_raw(
                    self.params, torch.from_numpy(padded).to(dev),
                    torch.tensor([n], dtype=torch.int32, device=dev))
                tok = self._sampler_for(sp)(logits, self._generator)
                first = int(tok[0].item())      # the prefill's fence
                self._telemetry.record_first_token(rec)
                if max_new_tokens <= 1 or self._hit_stop([first]):
                    self._finish_early(fut, arr, rec, first)
                    continue
                self._fns.admit(self._cache, row, slot)
                self._cur[slot] = first
                self._slots[slot] = {"prompt": arr, "out": [first],
                                     "fut": fut, "rec": rec, "sp": sp}
                self._draft_admit(slot, arr)

        def _requeue(self, arr, rec, sp, fut, need: int,
                     reason: str) -> bool:
            self._pager.set_request(None)
            self._requeues += 1
            self._telemetry.record_requeue(rec, need=need, reason=reason)
            self._queue.push_front((arr, rec, sp), fut)
            return False

        def _admit_one_paged(self, arr, rec, sp, fut, slot) -> bool:
            """Admit one request through the block pager: match the
            longest resident prompt prefix, allocate the remaining
            blocks up front (decode never allocates), restore what the
            host tier holds, COW-fork the write-boundary block if it is
            shared, then prefill only the unmatched tail (or start a
            chunked admission).  Returns False when the pool cannot
            hold the request yet (request requeued at the head)."""
            pager = self._pager
            n = int(arr.shape[0])
            tokens = arr.tolist()
            self._set_request(rec)
            t_kv0 = time.perf_counter()
            ev0 = pager.evictions
            # spec decode: k slots of headroom, so the rejected drafts'
            # K/V of a request's last rounds land in blocks the row owns
            need = pager.blocks_needed(n, max_new_tokens,
                                       headroom=self._headroom())
            prefix_len, matched = pager.match_prefix(tokens)
            alloc = pager.allocate(need - len(matched))
            if alloc is None:
                pager.release(matched)
                return self._requeue(arr, rec, sp, fut, need,
                                     "pool_exhausted")
            blocks = matched + alloc
            # second chance: full blocks the device prefix match missed
            # may survive in the host tier.  Restore each hit into a
            # freshly allocated block, then bump prefix_len so the tail
            # prefill skips those tokens (content-addressed keys make
            # the restored rows the rows a re-prefill would write).
            # Probed only after allocation succeeds — a requeued
            # admission must not double-count tier probes.
            pairs = pager.tier_lookup(tokens, len(matched))
            if pairs:
                t0 = time.perf_counter()
                ids, ek, ev = self._tier_stage
                m = len(pairs)
                ids[:m] = torch.as_tensor(alloc[:m])
                for i, (_, e) in enumerate(pairs):
                    ek[i].copy_(e["k"])
                    ev[i].copy_(e["v"])
                self._fns.install_blocks(
                    self._cache, ids[:m].to(dev, non_blocking=True),
                    ek[:m].to(dev, non_blocking=True),
                    ev[:m].to(dev, non_blocking=True))
                # fence: the staging buffers are refilled next restore,
                # and the h2d bucket times the transfer, not the launch
                self._fence()
                t1 = time.perf_counter()
                pager.tier.note_h2d(t1 - t0)
                restored = pager.note_tier_restore(pairs, alloc)
                prefix_len += restored
                self._telemetry.record_kv_fetch(
                    rec, t0, t1, blocks=m, tokens=restored,
                    bytes=sum(int(e["bytes"]) for _, e in pairs))
            wb = prefix_len // kv_block_size
            if wb < len(matched):
                # the tail's first write lands inside a matched block
                try:
                    new_blk, src = pager.ensure_private(blocks[wb])
                except MemoryError:
                    pager.release(blocks)
                    return self._requeue(arr, rec, sp, fut, need,
                                         "cow_exhausted")
                if src is not None:
                    blocks[wb] = new_blk
                    self._fns.copy_block(self._cache, src, new_blk)
                    self._telemetry.record_cow()
            pager.set_request(None)
            self._telemetry.record_kv_reserve(
                rec, t_kv0, time.perf_counter(), blocks=len(blocks),
                hit_blocks=len(matched), evicted=pager.evictions - ev0)
            # tier-restored blocks count as reuse hits (a slower tier)
            reused = len(matched) + len(pairs)
            self._telemetry.record_prefix_reuse(
                reused, pager.blocks_needed(n, 0) - reused)
            n_tail = n - prefix_len
            row_bt = np.zeros((self.cfg.max_seq // kv_block_size,),
                              np.int32)
            row_bt[:len(blocks)] = blocks
            row_bt = torch.from_numpy(row_bt).to(dev)
            if prefill_chunk_tokens is not None \
                    and n_tail > prefill_chunk_tokens:
                # chunked admission: blocks are reserved (and forked)
                # as above, but the prefill runs chunk by chunk from
                # the engine loop (_prefill_chunk_step), so decode
                # waves interleave with a long prompt
                self._telemetry.record_admit(
                    rec, slot, -(-prefill_chunk_tokens // prefill_bucket)
                    * prefill_bucket)
                self._slots[slot] = {
                    "state": "prefill", "prompt": arr, "out": [],
                    "fut": fut, "rec": rec, "sp": sp, "blocks": blocks,
                    "row_bt": row_bt,
                    "cursor": ChunkCursor(
                        total=n, chunk_tokens=prefill_chunk_tokens,
                        filled=prefix_len)}
                self._telemetry.record_kv_stats(pager.stats())
                return True
            self._telemetry.record_admit(
                rec, slot, self._tail_bucket(n_tail))
            first = self._prefill_tail(slot, arr, sp, row_bt, prefix_len,
                                       n_tail, sample=True)
            self._telemetry.record_first_token(rec)
            self._register(rec, tokens, blocks)
            if max_new_tokens <= 1 or self._hit_stop([first]):
                self._finish_early(fut, arr, rec, first)
                self._retire_paged_row(slot, blocks)
                return True
            if role == "prefill":
                # the decode belongs to a decode engine: hand the filled
                # rows over and free this row (registered full blocks
                # park in the LRU, keeping the prefix warm)
                self._handoff_out(slot, arr, rec, sp, fut, blocks, first)
                return True
            self._cur[slot] = first
            self._slots[slot] = {"prompt": arr, "out": [first],
                                 "fut": fut, "rec": rec, "sp": sp,
                                 "blocks": blocks}
            self._draft_admit(slot, arr)
            self._telemetry.record_kv_stats(pager.stats())
            return True

        def _headroom(self) -> int:
            return spec_decode.k if spec_decode is not None else 0

        def _handoff_out(self, slot, arr, rec, sp, fut, blocks,
                         first) -> None:
            """Prefill role: copy the request's filled block rows out
            of the pool and resolve its future with a HandoffCursor for
            a decode engine's admit_prefilled.  The fast path keeps the
            rows on the device; the staged path copies them to host
            (pinned for a CUDA pool), the hop a package takes between
            processes.  Either way they are the bytes the prefill
            wrote, so the splice recreates the post-prefill state
            exactly.  This engine's row and blocks are freed at once."""
            n = int(arr.shape[0])
            n_blk = -(-n // kv_block_size)
            ids = torch.as_tensor(blocks[:n_blk], device=dev)
            t0 = time.perf_counter()
            k_rows, v_rows = self._fns.kv_handoff_export(self._cache, ids)
            if handoff_staged:
                pin = dev.type == "cuda"
                k_rows, v_rows = (
                    torch.empty(r.shape, dtype=r.dtype,
                                pin_memory=pin).copy_(r)
                    for r in (k_rows, v_rows))
                path = "staged"
            else:
                # fence: the export window is device time, not launch
                self._fence()
                path = "fast"
            t1 = time.perf_counter()
            nbytes = self._pager.bytes_per_block * n_blk
            # the decode engine's record is seeded from this, so the
            # request keeps one clock: enqueue → prefill → handoff →
            # decode, its critical path still summing to e2e
            meta = {key: rec.get(key) for key in (
                "enqueue", "engine_enqueue", "admit", "first_token",
                "bucket", "requeue_ts", "kv_reserve", "kv_fetch",
                "prefill_chunks", "tenant", "ctx")}
            meta.update(prompt_len=n, requeues=rec.get("requeues", 0))
            pkg = HandoffCursor(
                prompt=arr, first_token=int(first), n_tokens=n,
                n_blocks=n_blk, k_rows=k_rows, v_rows=v_rows,
                nbytes=nbytes, path=path, t_export0=t0, t_export1=t1,
                meta=meta, sampling=sp)
            self._telemetry.record_handoff_out(
                rec, blocks=n_blk, nbytes=nbytes, path=path)
            self._retire_paged_row(slot, blocks)
            if not fut.done():
                fut.set_result(pkg)

        def _admit_one_handoff(self, pkg, rec, fut, slot) -> bool:
            """Decode role: admit a HandoffCursor.  Allocate a fresh
            block chain, splice the exported rows and the row's table,
            pos = prompt length and start = 0 into the pool (the state
            paged_prefill leaves), index the imported full blocks, and
            decode from the package's first token.  Returns False when
            the pool cannot hold the chain yet (requeued at the head)."""
            pager = self._pager
            arr = pkg.prompt
            n = int(pkg.n_tokens)
            self._set_request(rec)
            need = pager.blocks_needed(n, max_new_tokens,
                                       headroom=self._headroom())
            alloc = pager.allocate(need)
            if alloc is None:
                return self._requeue(pkg, rec, pkg.sampling, fut, need,
                                     "handoff_pool_exhausted")
            n_blk = int(pkg.n_blocks)
            row_bt = np.zeros((self.cfg.max_seq // kv_block_size,),
                              np.int32)
            row_bt[:need] = alloc
            self._fns.kv_handoff_install(
                self._cache, torch.as_tensor(alloc[:n_blk], device=dev),
                pkg.k_rows, pkg.v_rows, np.int32(slot),
                torch.from_numpy(row_bt).to(dev), np.int32(n))
            # fence: the splice is done when the row is admitted, and
            # the handoff window times the copy, not the launch
            self._fence()
            t_done = time.perf_counter()
            pkg.installed = True
            # later prompts sharing the prefix hit HERE
            pager.note_handoff_import(arr.tolist(), alloc)
            pager.set_request(None)
            self._telemetry.record_kv_handoff(
                rec, pkg.t_export0, t_done, blocks=n_blk,
                nbytes=int(pkg.nbytes), path=pkg.path)
            self._telemetry.record_admit_handoff(rec, slot)
            first = int(pkg.first_token)
            self._cur[slot] = first
            self._slots[slot] = {"prompt": arr, "out": [first],
                                 "fut": fut, "rec": rec,
                                 "sp": pkg.sampling, "blocks": alloc}
            self._draft_admit(slot, arr)
            self._telemetry.record_kv_stats(pager.stats())
            return True

        def _prefill_tail(self, slot, arr, sp, row_bt, filled, c,
                          sample: bool) -> Optional[int]:
            """paged_prefill of prompt tokens [filled, filled + c) into
            row ``slot``, right-aligned in a prefill_bucket multiple.
            Returns the sampled first token (the host fence), or None
            when ``sample`` is False (an intermediate chunk, whose
            logits are discarded: the generator is drawn from once per
            admission, at its final chunk)."""
            t_pad = self._tail_bucket(c)
            toks = np.zeros((1, t_pad), np.int32)
            toks[0, t_pad - c:] = arr[filled:filled + c]
            logits, _ = self._fns.paged_prefill_raw(
                self.params, self._cache, torch.from_numpy(toks).to(dev),
                row_bt, np.int32(filled), np.int32(c), np.int32(slot))
            if not sample:
                return None
            tok = self._sampler_for(sp)(logits, self._generator)
            return int(tok[0].item())

        def _tail_bucket(self, c: int) -> int:
            """The padded length of a c-token paged prefill: the next
            prefill_bucket multiple, at most max_seq."""
            t_pad = -(-c // prefill_bucket) * prefill_bucket
            return max(c, min(t_pad, self.cfg.max_seq))

        def _register(self, rec, tokens, blocks) -> None:
            # the prompt's full blocks now hold exactly its K/V: index
            # them so later prompts can skip this work (kvscope books
            # re-prefill waste here, under the request's tenant)
            self._set_request(rec)
            waste = self._pager.register_prefix(tokens, blocks)
            self._pager.set_request(None)
            if waste:
                self._telemetry.note_kv_waste(rec, waste)

        def _retire_paged_row(self, slot, blocks) -> None:
            """Free a finished row's blocks.  The row's table is
            pointed at the null block FIRST: an idle row's decode step
            still writes (masked garbage), which must never land in a
            block the pager may re-hand out."""
            self._fns.clear_row(self._cache, slot)
            self._pager.release(blocks)
            self._telemetry.record_kv_stats(self._pager.stats())

        def _prefill_chunk_step(self, candidates) -> None:
            """Run AT MOST ONE chunk of pending prefill — the engine
            loop alternates `decode wave → one chunk → decode wave`,
            round-robin over the slots mid-prefill (``candidates``), so
            one huge prompt cannot take consecutive chunk windows.

            Each chunk is paged_prefill with prefix_len = tokens
            already filled (prior chunks are resident prefix blocks),
            so the chunked result equals one-shot prefill by
            construction.  Between chunks the row is PARKED (null block
            table): decode waves write masked garbage into every row at
            its pos, which must land in the null block, never in this
            row's half-filled blocks; the next chunk re-installs
            row_bt/pos/start.  The last chunk's window ends at its host
            fence (the sampled first token); an intermediate chunk is
            not fenced (the reference fences each one), so on a card
            its window is the launch and the next fence absorbs the
            rest."""
            # next candidate strictly after the cursor, cyclically
            i = min(candidates,
                    key=lambda s: ((s - self._chunk_rr) % max_slots)
                    or max_slots)
            self._chunk_rr = i
            st = self._slots[i]
            arr = st["prompt"]
            cur = st["cursor"]
            filled = cur.filled
            c = cur.next_chunk()
            last = filled + c >= int(arr.shape[0])
            t0 = time.perf_counter()
            first = self._prefill_tail(i, arr, st["sp"], st["row_bt"],
                                       filled, c, sample=last)
            t1 = time.perf_counter()
            cur.advance(c)
            rec = st["rec"]
            self._telemetry.record_prefill_chunk(
                rec, t0, t1, tokens=c, bucket=self._tail_bucket(c),
                last=last)
            self._set_request(rec)
            self._pager.note_fill(c, partial=not last)
            self._pager.set_request(None)
            if not last:
                self._fns.clear_row(self._cache, i)
                return
            self._telemetry.record_first_token(rec)
            self._register(rec, arr.tolist(), st["blocks"])
            if max_new_tokens <= 1 or self._hit_stop([first]):
                self._finish_early(st["fut"], arr, rec, first)
                self._slots[i] = None
                self._retire_paged_row(i, st["blocks"])
                return
            if role == "prefill":
                # a chunked prompt hands off at its last chunk
                self._slots[i] = None
                self._handoff_out(i, arr, st["rec"], st["sp"], st["fut"],
                                  st["blocks"], first)
                return
            self._cur[i] = first
            st["state"] = "decode"
            st["out"] = [first]
            self._draft_admit(i, arr)
            self._telemetry.record_kv_stats(self._pager.stats())

        def _finish_slot(self, i, st) -> None:
            """Retire a finished slot NOW — the freed slot (and its
            paged blocks) is admissible in the same engine wave."""
            self._telemetry.record_finish(st["rec"],
                                          n_tokens=len(st["out"]))
            self._resolve(st["fut"], st["prompt"], st["out"])
            self._slots[i] = None           # slot freed NOW
            if self._pager is not None:
                self._retire_paged_row(i, st["blocks"])

        def _park_idle_rows(self, decoding) -> None:
            """Every pool step advances every row's pos, idle ones
            included.  JAX drops the out-of-range writes and clamps the
            gathers of an idle row that has run past max_seq; torch
            indexing raises.  So each row that is not decoding is
            parked before the step: pos and start 0 and (paged) its
            table at the null block, so its masked writes stay in its
            own dense row or the null block.  Admission (admit,
            paged_prefill) sets all three afresh.  Under spec decoding
            a verify round moves every row by up to k + 1 and the draft
            pool's rows by k + 1, so the draft pool's idle rows are
            parked too (and rewind nothing next round)."""
            idle = [i for i in range(max_slots) if i not in decoding]
            if not idle:
                return
            self._fns.park_rows(self._cache, self._draft_cache,
                                torch.tensor(idle, device=dev))
            if spec_decode is not None:
                self._spec_rej[idle] = 0

        def _step(self, decoding):
            """One decode step over the pool: the logits once, then one
            sampler call per DISTINCT SamplingParams among the decoding
            slots (one, unless a request overrides the default), rows
            gathered host-side — the wave's host fence."""
            logits, _ = self._fns.pool_logits(
                self.params, self._cache, torch.from_numpy(self._cur).to(dev))
            toks = np.zeros((max_slots,), np.int32)
            groups: Dict[Any, list] = {}
            for i in decoding:
                groups.setdefault(self._slots[i]["sp"], []).append(i)
            for sp, rows in groups.items():
                full = self._sampler_for(sp)(logits, self._generator)
                toks[rows] = full.cpu().numpy()[rows]
            return toks

        def _spec_round(self, decoding) -> int:
            """One speculative round over the pool: the draft proposes
            k tokens a row (the draft model's k + 1 steps, or n-grams of
            each request's history on the host), ONE target verify
            forward checks all k + 1 positions, and each decoding row
            emits its accepted drafts and one target token, token by
            token against the budget and the stops; the caches move by
            the kept count.  The round's host fence is reading the
            verdict.  Returns the tokens emitted (step telemetry)."""
            t_round = time.perf_counter()
            kd = spec_decode.k
            cur = torch.from_numpy(self._cur).to(dev)
            qprobs = None
            if self._draft_params is not None:
                res = self._fns.draft_propose(
                    self._draft_params, self._draft_cache, cur,
                    torch.from_numpy(self._spec_rej).to(dev),
                    self._generator)
                drafts = res[0]
                if default_sp.temperature > 0.0:
                    qprobs = res[1]     # sampled accept needs q
            else:
                proposals = np.zeros((max_slots, kd), np.int32)
                for i in decoding:
                    st = self._slots[i]
                    proposals[i] = ngram_propose(
                        st["prompt"].tolist() + st["out"], kd,
                        order=spec_decode.ngram_order)
                drafts = torch.from_numpy(proposals).to(dev)
            block = torch.cat([cur[:, None], drafts.to(torch.int32)], dim=1)
            out, n_acc, _ = self._fns.spec_verify(
                self.params, self._cache, block, self._generator, qprobs)
            out, n_acc = out.cpu().numpy(), n_acc.cpu().numpy()
            t_done = time.perf_counter()
            total = 0
            for i in decoding:
                st = self._slots[i]
                n = int(n_acc[i])
                self._telemetry.record_spec(st["rec"], proposed=kd,
                                            accepted=n,
                                            dur_s=t_done - t_round)
                finished = False
                emitted = 0
                for t in out[i, :n + 1]:
                    st["out"].append(int(t))
                    emitted += 1
                    if len(st["out"]) >= max_new_tokens \
                            or self._hit_stop(st["out"]):
                        finished = True
                        break
                total += emitted
                # one verify emitted `emitted` tokens for this row: they
                # share the round's end in the inter-token trail
                self._telemetry.record_token(st["rec"], n=emitted,
                                             now=t_done)
                # the target token is the row's new cur (no K/V yet)
                self._cur[i] = out[i, n]
                self._spec_rej[i] = 0 if finished else kd - n
                if finished:
                    self._finish_slot(i, st)
            return total

        def _decode_wave(self, decoding, prefilling) -> None:
            """One turn of the scheduler after admission: one pooled
            decode step (or one speculative round) over the decoding
            slots → retire finished slots → the SLO watchdog and the
            health probe → one pool snapshot → at most ONE chunk of
            pending chunked prefill.  The step's walltime is timed
            around the host fence the step already makes (no added
            sync)."""
            if decoding and spec_decode is not None:
                self._park_idle_rows(decoding)
                t_step = time.perf_counter()
                n_tokens = self._spec_round(decoding)
                self._telemetry.record_step(
                    len(decoding), time.perf_counter() - t_step,
                    n_tokens=n_tokens)
            elif decoding:
                self._park_idle_rows(decoding)
                t_step = time.perf_counter()
                toks = self._step(decoding)
                t_wave = time.perf_counter()
                self._telemetry.record_step(len(decoding),
                                            t_wave - t_step, now=t_wave)
                for i in decoding:
                    st = self._slots[i]
                    st["out"].append(int(toks[i]))
                    self._telemetry.record_token(st["rec"], now=t_wave)
                    self._cur[i] = toks[i]
                    if len(st["out"]) >= max_new_tokens \
                            or self._hit_stop(st["out"]):
                        self._finish_slot(i, st)
            if self._telemetry.slo is not None:
                # throttled burn-rate watchdog: a breach or a storm
                # dumps the flight record
                self._telemetry.slo.check()
            if self._health is not None:
                # throttled liveness sweep over the fleet's replicas
                self._health.maybe_probe()
            if self._pager is not None:
                # kvscope occupancy ring: one pool snapshot per wave
                self._pager.sample_occupancy()
            if prefilling:
                self._prefill_chunk_step(prefilling)

        def _fail_all(self, e: Exception) -> None:
            """A wave raised: journal it, dump the flight record (the
            journal around the failure, before unwinding changes the
            engine's state) and fail every request in flight and
            queued."""
            self._telemetry.flightrec.record("engine_crash",
                                             error=repr(e)[:200])
            try:
                self._telemetry.flightrec.dump(
                    reason="engine_crash",
                    context={"error": repr(e)[:500]})
            except Exception:  # noqa: BLE001 - the dump is best-effort
                pass
            for i, st in enumerate(self._slots):
                if st is not None:
                    self._telemetry.record_error(st["rec"],
                                                 error=repr(e))
                    if not st["fut"].done():
                        st["fut"].set_exception(e)
                    if self._pager is not None:
                        self._pager.release(st["blocks"])
                self._slots[i] = None
            for (_, rec, _), fut in self._queue.pop(len(self._queue)):
                self._telemetry.record_error(rec, error=repr(e))
                if not fut.done():
                    fut.set_exception(e)

        async def _engine(self):
            """The scheduler loop, in the reference's order: the chaos
            freeze (poll without working or heartbeating), the health
            heartbeat, admission, idle parking (declared idle to the
            health monitor), the chaos token delay, then the decode
            wave; yielding between waves so callers can enqueue
            mid-flight.  A wave that raises fails every request in
            flight and queued, loudly."""
            label = self._replica_label
            while True:
                try:
                    if self._chaos is not None and \
                            self._chaos.frozen(label):
                        await asyncio.sleep(self._chaos.freeze_poll_s)
                        continue
                    if self._health is not None:
                        self._health.heartbeat(label)
                    with torch.no_grad():
                        self._admit_pending()
                    prefilling = [
                        i for i, st in enumerate(self._slots)
                        if st is not None and st.get("state") == "prefill"]
                    decoding = [
                        i for i, st in enumerate(self._slots)
                        if st is not None and st.get("state") != "prefill"]
                    if not prefilling and not decoding:
                        self._wake.clear()
                        if not len(self._queue):
                            if self._health is not None:
                                # parked idle is not a failure
                                self._health.note_idle(label)
                            await self._wake.wait()
                        continue
                    if self._chaos is not None and decoding:
                        delay_s = self._chaos.token_delay_s(label)
                        if delay_s > 0:
                            await asyncio.sleep(delay_s)
                    with torch.no_grad():
                        self._decode_wave(decoding, prefilling)
                except Exception as e:  # noqa: BLE001 - to every caller
                    self._fail_all(e)
                await asyncio.sleep(0)

        async def _call_continuous(self, prompt, sampling=None, *,
                                   tenant=None, enqueue_ts=None,
                                   trace=None):
            """One request: enqueue it and await prompt +
            continuation.  ``sampling`` overrides the engine's
            SamplingParams for this request; ``tenant`` tags it in the
            pager's kvscope attribution and the SLO slices.  With an
            admission_policy a request it sheds raises
            OverloadedError.  ``enqueue_ts`` / ``trace`` are the fleet
            router's hooks (serve/router.py): the router backdates
            ``enqueue_ts`` to the instant the request entered its
            queue, so TTFT/e2e charge the router wait, and ``trace`` is
            the tracebus TraceContext born at router submit (a fresh
            engine-origin one is minted when absent).  Direct callers
            omit both."""
            self._check_leader()
            sp = None
            if sampling is not None:
                if not isinstance(sampling, SamplingParams):
                    raise ValueError(
                        "sampling must be a SamplingParams, got "
                        f"{type(sampling).__name__}")
                if spec_decode is not None:
                    raise ValueError(
                        "per-request sampling overrides are not "
                        "supported with spec_decode (the verify "
                        "program bakes in ONE sampling config; build "
                        "a separate deployment per config)")
                if sampling != default_sp:
                    sp = sampling
            self._ensure_engine()
            # host-side prompt normalization (python ints, no device fetch)
            # graftcheck: disable=blocking-call-in-async(host-side int normalization)
            arr = np.asarray(prompt, np.int32).reshape(-1)
            if admission_policy is not None:
                # telemetry's percentiles decide the shed BEFORE the
                # request costs the engine anything.  The HBM-headroom
                # gate needs a fresh ledger: refreshed only when that
                # gate is armed, so the allocator query stays off the
                # default admission path, and without the segment walk
                # the gate never reads
                if getattr(admission_policy, "min_headroom_bytes",
                           None) is not None and self._pager is not None:
                    self._telemetry.record_kv_scope(
                        self._compose_kv_scope(largest_alloc=False))
                shed = admission_policy.decide(
                    self._telemetry.engine_stats(), len(self._queue))
                if shed is not None:
                    rec = self._telemetry.record_enqueue(
                        int(arr.shape[0]), now=enqueue_ts,
                        tenant=tenant, ctx=trace)
                    self._telemetry.record_reject(
                        rec, reason=f"load shed: {shed}",
                        label=f"shed_{shed}")
                    raise OverloadedError(
                        f"request shed ({shed}): engine over SLO "
                        f"with {len(self._queue)} queued")
            rec = self._telemetry.record_enqueue(
                int(arr.shape[0]), now=enqueue_ts, tenant=tenant,
                ctx=trace)
            fut = self._queue.put((arr, rec, sp))
            self._wake.set()
            return await fut

        def _ensure_engine(self) -> None:
            if self._engine_task is None or self._engine_task.done():
                # a fresh loop (or the first call) gets a fresh event
                self._wake = asyncio.Event()
                self._engine_task = asyncio.get_running_loop(
                ).create_task(self._engine())

        async def admit_prefilled(self, pkg):
            """The decode side of disaggregated serving: take a prefill
            engine's HandoffCursor and answer with prompt +
            continuation.  No prefill runs here: the package's rows are
            spliced into this pool and decoding starts from its first
            token.  The fleet router (serve/router.py) forwards each
            package here; a caller driving two engines by hand hands
            the prefill engine's reply over itself."""
            self._check_leader()
            if role == "prefill":
                raise ValueError(
                    "admit_prefilled needs a decode-capable engine "
                    "(role='decode' or 'both'); this replica is "
                    "role='prefill'")
            if getattr(self, "_pager", None) is None:
                raise ValueError(
                    "admit_prefilled requires kv_layout='paged'")
            if not isinstance(pkg, HandoffCursor):
                raise ValueError(
                    "admit_prefilled takes a HandoffCursor, got "
                    f"{type(pkg).__name__}")
            if pkg.sampling is not None and spec_decode is not None:
                raise ValueError(
                    "per-request sampling overrides are not "
                    "supported with spec_decode (the verify program "
                    "bakes in ONE sampling config)")
            self._ensure_engine()
            # the package's meta seeds a record that keeps the prefill
            # engine's enqueue / admit / first-token clock
            rec = self._telemetry.record_enqueue_handoff(pkg.meta or {})
            fut = self._queue.put((pkg, rec, pkg.sampling))
            self._wake.set()
            return await fut

        def shutdown_engine(self) -> None:
            """Stop the background engine task (a caller running the
            engine on its own event loop calls this so the loop can
            close cleanly; a batch scheduler's engine has none)."""
            task = getattr(self, "_engine_task", None)
            self._engine_task = None
            if task is not None and not task.done():
                task.cancel()
            lockstep = getattr(self, "_lockstep", None)
            if lockstep is not None and lockstep.is_leader:
                # the followers' stop message
                lockstep.stop()

        def kv_stats(self) -> Dict[str, Any]:
            """The continuous engine's KV blocks: ``kv_cache`` (the
            pager's stats; None for dense), ``kv_tier`` and
            ``kv_scope`` (with the HBM ledger), the blocks of
            ``engine_stats()`` of those names, and ``requeues``,
            admissions pushed back because the pool could not hold
            them yet."""
            stats = self.engine_stats()
            return {"kv_cache": stats["kv_cache"],
                    "kv_tier": stats["kv_tier"],
                    "kv_scope": stats["kv_scope"],
                    "requeues": self._requeues}

        # -- telemetry surface (both schedulers) ---------------------

        def _compose_kv_scope(self, largest_alloc=True
                              ) -> Dict[str, Any]:
            """The whole ``engine_stats()["kv_scope"]`` block: the
            pager's occupancy/forensics half plus the HBM ledger (the
            pool's bytes, the allocator view of the pool's device and
            the programs' audited budget → headroom_bytes).
            ``largest_alloc=False`` leaves out the allocator walk that
            only ``largest_alloc_size`` reads (the admission gate's
            refresh)."""
            pager = self._pager
            block = pager.kv_scope_stats()
            block["hbm_ledger"] = hbm_ledger(
                pool_bytes_per_chip=pager.bytes_per_block
                * pager.num_blocks // pager.tensor_shards,
                device_stats=device_memory_stats(
                    [self.device], largest_alloc=largest_alloc),
                program_budget_bytes=serve_program_budget_bytes())
            return block

        def engine_stats(self) -> Dict[str, Any]:
            """p50/p95/p99 TTFT, queue wait and inter-token time,
            throughput, slot utilization, request counts, rejections
            by reason, the paged KV blocks, spec and handoff counts,
            the SLO block, the flight recorder's, the health block,
            the latency anatomy and the registry's ``programs`` block
            (the reference's key tree)."""
            pager = self._pager
            if pager is not None:
                self._telemetry.record_kv_stats(pager.stats())
                self._telemetry.record_kv_scope(self._compose_kv_scope())
                if pager.tier is not None:
                    self._telemetry.record_kv_tier(pager.tier.stats())
            if self._health is not None:
                self._telemetry.record_health(
                    self._health.replica_block(self._replica_label))
            stats = self._telemetry.engine_stats()
            if admission_policy is not None:
                stats["admission_policy"] = admission_policy.describe()
            # the process-wide registry, filtered to the serve programs
            mesh = getattr(self, "mesh", None)
            n_dev = mesh.size() if mesh is not None else 1
            stats["programs"] = get_registry().snapshot(prefix="serve.",
                                                        n_devices=n_dev)
            if mesh is not None:
                from ray_tpu_torch.parallel.mesh import mesh_shape

                stats["mesh"] = {
                    "axes": {a: int(n) for a, n in mesh_shape(mesh).items()
                             if int(n) > 1},
                    "n_devices": n_dev,
                    "kv_shards": self._kv_shards(),
                    # per-card allocator stats, every rank's
                    "devices": self._lockstep.device_stats(),
                }
            return stats

        def export_timeline(self, path=None):
            """Chrome-trace engine timeline (queue lane, per-slot
            occupancy lanes, engine-step lane); writes ``path`` when
            given and returns the event list."""
            return self._telemetry.export_timeline(path)

        def trace_records(self):
            """Request snapshots (hop timestamps, token trail, spans)
            of every retained request."""
            return self._telemetry.trace_records()

        def request_trace(self, request_id):
            """One request's snapshot by trace id (or engine-local
            id); None when this engine does not know it."""
            return self._telemetry.find_request(request_id)

        def anatomy_samples(self, tenant=None):
            """Raw latency-anatomy samples (inter-token gaps, TPOT,
            critical-path components), for a fleet to pool across
            replicas before summarizing."""
            return self._telemetry.anatomy_samples(tenant=tenant)

        def metrics_snapshot(self):
            """This process's serve_* metric dumps (histogram buckets
            included) from the process-local registry."""
            from ray_tpu_torch.util.metrics import _registry

            return {name: dump for name, dump
                    in _registry.snapshot().items()
                    if name.startswith("serve_")}

        def kernel_counts(self, reset: bool = False) -> Dict[str, Any]:
            """This process's launches of each hand-written kernel (the
            wrappers' counts; the JAX engine's Pallas kernels count
            none, so the reference has no such method) and the batch
            scheduler's generate calls, one prefill each; zeroed after
            reading when ``reset``.  A replica reports through it what
            ran in its own process (``handle.method("kernel_counts")``)."""
            import importlib
            import os

            fa = importlib.import_module(
                "ray_tpu_torch.ops.flash_attention")
            fc = importlib.import_module("ray_tpu_torch.ops.fused_ce")
            names = {"flash_fwd": (fa, "FLASH_FWD_LAUNCHES"),
                     "flash_bwd_dq": (fa, "FLASH_BWD_DQ_LAUNCHES"),
                     "flash_bwd_dkv": (fa, "FLASH_BWD_DKV_LAUNCHES"),
                     "fused_ce_fwd": (fc, "FUSED_CE_FWD_LAUNCHES"),
                     "fused_ce_bwd_dh": (fc, "FUSED_CE_BWD_DH_LAUNCHES"),
                     "fused_ce_bwd_dw": (fc, "FUSED_CE_BWD_DW_LAUNCHES")}
            out = {k: getattr(m, a) for k, (m, a) in names.items()}
            out.update(prefills=self._generate_calls, pid=os.getpid(),
                       node_id=os.environ.get("RAYTPU_NODE_ID", ""),
                       worker_id=os.environ.get("RAYTPU_WORKER_ID", ""),
                       visible=os.environ.get("CUDA_VISIBLE_DEVICES"),
                       device=str(self.device))
            if reset:
                for m, a in names.values():
                    setattr(m, a, 0)
                self._generate_calls = 0
            return out

    LLM.__call__ = (LLM._call_continuous if scheduler == "continuous"
                    else LLM._call_batch_checked)
    return deployment(name=f"llm_{family}_{preset}",
                      num_replicas=num_replicas)(LLM)
