"""LM serving engine: GPT-2 generation behind request batching.

Counterpart of the "batch" scheduler of ``ray_tpu/serve/llm.py``'s
``build_llm_deployment``: concurrent requests are collected by
``@batch`` into one generation.  Equal-length micro-batches take the
fast path (one batched prefill through the flash kernel on CUDA);
ragged ones are left-padded and trimmed back on return.

``build_llm_deployment`` takes every keyword of the reference's.  Not
ported yet, each raising NotImplementedError that names its ROADMAP.md
item: the continuous scheduler with paged KV, speculative decoding and
prefill/decode roles (queue 1 item 3), the llama family (item 2), the
serve runtime that wraps engines in deployments and handles, and so
``num_replicas`` > 1 (item 5), and mesh-sharded serving (item 7).
Telemetry (item 4) has no keyword here.  The keywords that only the
continuous scheduler reads (``stop_sequences``, ``eos_id``,
``max_slots``, ``prefill_bucket``, ``kv_block_size``, ``kv_num_blocks``,
``admission_policy``) are validated and ignored under "batch", as in
the reference; the combinations it rejects under "batch" raise the same
ValueError here.  Here the engine class itself is the deployment:
``await engine(prompt)`` answers one request.
"""

from __future__ import annotations

import pickle
from typing import Any, Dict, Optional

import numpy as np
import torch

from ray_tpu_torch.device import DeviceLike, resolve_device
from ray_tpu_torch.models import gpt2_decode
from ray_tpu_torch.models.convert import gpt2_params_from_numpy
from ray_tpu_torch.models.decode_common import SamplingParams
from ray_tpu_torch.models.gpt2 import gpt2_config, gpt2_init
from ray_tpu_torch.serve.batching import batch as _batch

_ROADMAP_ITEM = {
    "continuous": "queue 1 item 3 (continuous scheduler with paged KV)",
    "llama": "queue 1 item 2 (llama family)",
    "runtime": "queue 1 item 5 (the serve runtime: deployments, "
               "replicas, router)",
    "mesh": "queue 1 item 7 (parallel/ and mesh-sharded serving)",
}


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to ray_tpu_torch yet: ROADMAP.md "
        f"{_ROADMAP_ITEM[item]}")


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

    family: "gpt2"; preset: a GPT-2 preset name.  max_new_tokens,
    temperature, top_k, top_p: generation and sampling knobs (greedy
    at temperature 0).  max_batch_size / batch_wait_timeout_s: the
    ``@batch`` micro-batch bounds.  checkpoint_path: a pickled
    parameter tree of numpy arrays in the JAX package's layout; absent
    → a fresh init from ``seed`` (tests/demos).  config_overrides:
    GPT2Config fields (torch dtypes).  device: None = the first CUDA
    device (raises without one); "cpu" must be asked for.
    The reference's continuous-scheduler and fleet keywords are
    accepted with its defaults and validation (module docstring):
    stop_sequences and eos_id (stop matching is the continuous
    scheduler's), max_slots, prefill_bucket, kv_block_size,
    kv_num_blocks, prefill_chunk_tokens and kv_host_tier_bytes (paged
    KV only), admission_policy, slo (continuous only), handoff_staged
    (split roles only), num_replicas (1 here).

    Returns the engine class; ``await Engine()(prompt)`` answers one
    request."""
    if family == "llama":
        raise _not_ported("family='llama'", "llama")
    if family != "gpt2":
        raise ValueError(f"unknown LM family {family!r}")
    if scheduler == "continuous":
        raise _not_ported("scheduler='continuous'", "continuous")
    if scheduler != "batch":
        raise ValueError(f"unknown scheduler {scheduler!r} "
                         f"(expected 'batch' or 'continuous')")
    if kv_layout == "paged":
        raise _not_ported("kv_layout='paged'", "continuous")
    if kv_layout != "dense":
        raise ValueError(f"unknown kv_layout {kv_layout!r} "
                         f"(expected 'dense' or 'paged')")
    if spec_decode is not None:
        raise _not_ported("spec_decode", "continuous")
    if role != "both":
        raise _not_ported(f"role={role!r}", "continuous")
    if mesh is not None:
        raise _not_ported("mesh", "mesh")
    # what the reference rejects under scheduler="batch"
    # (ray_tpu/serve/llm.py:486-563), in its order
    if prefill_chunk_tokens is not None:
        raise ValueError("prefill_chunk_tokens requires kv_layout='paged' "
                         "(chunks fill KV blocks incrementally; dense "
                         "keeps one-shot prefill)")
    if kv_host_tier_bytes is not None:
        raise ValueError("kv_host_tier_bytes requires kv_layout='paged' "
                         "(the host tier spills and restores the pager's "
                         "KV blocks; dense rows are never evicted)")
    if handoff_staged:
        raise ValueError("handoff_staged only applies to split roles "
                         "(role='prefill' exports through host staging; "
                         "a monolithic engine never hands off)")
    if slo is not None:
        raise ValueError("slo requires scheduler='continuous' (the "
                         "burn-rate watchdog runs from the slot-pool "
                         "engine loop)")
    if any(np.asarray(seq).size == 0 for seq in (stop_sequences or ())):
        raise ValueError("empty stop sequence")
    if not isinstance(num_replicas, int) or num_replicas < 1:
        raise ValueError(f"num_replicas must be a positive int, got "
                         f"{num_replicas!r}")
    if num_replicas > 1:
        raise _not_ported(f"num_replicas={num_replicas}", "runtime")
    # validates the sampling knobs
    SamplingParams(temperature=temperature, top_k=top_k, top_p=top_p)
    dev = resolve_device(device)

    class LLM:
        def __init__(self):
            self.device = dev
            self.cfg = gpt2_config(preset, **dict(config_overrides or {}))
            if checkpoint_path:
                # a parameter tree this project wrote (see docstring)
                with open(checkpoint_path, "rb") as f:
                    tree = pickle.load(f)
                self.params = gpt2_params_from_numpy(tree, self.cfg, dev)
            else:
                self.params = gpt2_init(
                    self.cfg, torch.Generator(device=dev).manual_seed(seed),
                    dev)
            # per-engine sampling stream: without it every sampled
            # request would draw the same "random" continuation
            self._generator = torch.Generator(device=dev).manual_seed(
                seed + 1)

        def _generate(self, toks, lengths=None):
            with torch.inference_mode():
                return gpt2_decode.generate(
                    self.params, toks, self.cfg,
                    max_new_tokens=max_new_tokens,
                    temperature=temperature, top_k=top_k, top_p=top_p,
                    lengths=lengths, generator=self._generator)

        @_batch(max_batch_size=max_batch_size,
                batch_wait_timeout_s=batch_wait_timeout_s)
        async def _call_batch(self, prompts):
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

        async def __call__(self, prompt):
            n_prompt = int(np.asarray(prompt).reshape(-1).shape[0])
            if n_prompt == 0 or \
                    n_prompt + max_new_tokens > self.cfg.max_seq:
                # validate before batching: an oversized prompt would
                # otherwise fail the whole micro-batch inside generate
                raise ValueError(
                    f"prompt length {n_prompt} invalid for "
                    f"max_seq={self.cfg.max_seq} with "
                    f"max_new_tokens={max_new_tokens}")
            return await self._call_batch(prompt)

    return LLM
