"""Stage 2 of the autopilot loop: sweep planning (the counterpart of
``ray_tpu/tools/autopilot/planner.py``).

Turns "what do we not know yet" into a concrete grid.  The planner
owns the JAX package's static candidate catalog (ce_impl, remat
policy, flash residency, decode batch, tensor degree, spec_k, kv
layout, block size, prefill buckets) as ``[batch, {overrides}]``
entries — the argument of the repo's ``sweep_tpu.py`` — and grades
each candidate against the port's ledger
(``tools/perfledger.py``, ``BENCH_HISTORY_TORCH.jsonl``):

* **regressed** — the candidate's variant-hash series exists in
  the ledger and its newest point regressed (perfledger
  ``check``): re-measure first, a regression verdict on one stale
  point is noise until confirmed.
* **unmeasured** — no series under the candidate's hash: the A/B has
  never produced a ledger point.
* **stale** — measured, but the newest point's provenance SHA is not
  the current tree (or predates provenance stamping): numbers from a
  different tree don't answer today's question.
* **fresh** — measured at the current SHA; dropped from the plan.

Candidates are mapped to the observatory's program names, so when an
attribution report is supplied the ones targeting *the* bottleneck get
a priority bump — the Ray-paper move of scheduling work from live
metric signals instead of operator intuition.  ``--budget N`` keeps
the emitted grid affordable, highest expected information first.

The grid hash MUST match what a sweep will later record, so
:func:`mirror_variant` reproduces, default-for-default, the exact
variant dict each ``sweep_tpu.py`` mode writes into its SWEEPJSON
record (the JAX package's mirror; tests hold the two equal).  The port
has no sweep runner over ``python -m ray_tpu_torch.bench`` yet
(ROADMAP.md queue 1): the grid is printed, and running it waits for
that runner.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch.tools import perfledger

#: the JAX package's grid entries, in catalog order (ties in priority
#: resolve to this order).  ``programs`` names the observatory
#: programs the knob moves — the hook that lets an attribution report
#: re-rank the catalog around the measured bottleneck.
CANDIDATES: Tuple[Dict[str, Any], ...] = (
    # -- train: fused-CE impl + remat policy + flash residency (r6/r7)
    {"id": "train-ce-fused-b32", "batch": 32,
     "overrides": {"ce_impl": "streaming_xla"},
     "programs": ("train.step", "bench.train_step"),
     "rationale": "round-6 control arm: streaming fused CE at the "
                  "round-5 best batch"},
    {"id": "train-ce-pallas-b24", "batch": 24,
     "overrides": {"ce_impl": "pallas"},
     "programs": ("train.step", "bench.train_step"),
     "rationale": "round-6 queued A/B: pallas CE kernel, smaller batch "
                  "to fit the fused logits"},
    {"id": "train-ce-pallas-b32", "batch": 32,
     "overrides": {"ce_impl": "pallas"},
     "programs": ("train.step", "bench.train_step"),
     "rationale": "pallas CE at the control batch — isolates the "
                  "kernel from the batch effect"},
    {"id": "train-ce-pallas-b48", "batch": 48,
     "overrides": {"ce_impl": "pallas"},
     "programs": ("train.step", "bench.train_step"),
     "rationale": "pallas CE frees logit HBM — test whether the saved "
                  "memory buys a bigger batch"},
    {"id": "train-remat-dots-b32", "batch": 32,
     "overrides": {"remat_policy": "dots_nb"},
     "programs": ("train.step", "bench.train_step"),
     "rationale": "remat dots-no-batch vs default: trade recompute "
                  "for activation HBM"},
    {"id": "train-flash-resident-b32", "batch": 32,
     "overrides": {"flash_resident": "on"},
     "programs": ("train.step", "bench.train_step"),
     "rationale": "flash-resident attention on the train step "
                  "(round-7 queue)"},
    # -- decode: batch scaling + flash residency (r8/r9)
    {"id": "decode-b8", "batch": 8, "overrides": {"mode": "decode"},
     "programs": ("serve.decode", "serve.prefill"),
     "rationale": "decode control arm at batch 8"},
    {"id": "decode-b16", "batch": 16, "overrides": {"mode": "decode"},
     "programs": ("serve.decode", "serve.prefill"),
     "rationale": "decode batch 16 — is steady-state decode still "
                  "HBM-bound at 2x batch?"},
    {"id": "decode-b16-flash", "batch": 16,
     "overrides": {"mode": "decode", "flash_resident": "on"},
     "programs": ("serve.decode", "serve.prefill"),
     "rationale": "flash-resident attention under decode: the kernel "
                  "reads the cache it keeps resident"},
    # -- tensor parallel decode (r9)
    {"id": "decode-sharded-t4", "batch": 8,
     "overrides": {"mode": "decode_sharded", "tensor": 4},
     "programs": ("serve.sharded_decode",),
     "rationale": "tensor degree 4: per-chip KV shrinks 4x, collective "
                  "cost enters the inter-token path"},
    {"id": "decode-sharded-t8", "batch": 8,
     "overrides": {"mode": "decode_sharded", "tensor": 8},
     "programs": ("serve.sharded_decode",),
     "rationale": "tensor degree 8 vs 4: where does the all-gather "
                  "overtake the HBM win?"},
    # -- speculative decoding spec_k (r10)
    {"id": "spec-k2", "batch": 8,
     "overrides": {"mode": "decode_spec", "spec_k": 2},
     "programs": ("serve.spec_verify", "serve.spec_draft"),
     "rationale": "spec_k=2: cheapest draft, dispatch/token floor 0.5"},
    {"id": "spec-k4", "batch": 8,
     "overrides": {"mode": "decode_spec", "spec_k": 4},
     "programs": ("serve.spec_verify", "serve.spec_draft"),
     "rationale": "spec_k=4: the round-10 default arm"},
    {"id": "spec-k8", "batch": 8,
     "overrides": {"mode": "decode_spec", "spec_k": 8},
     "programs": ("serve.spec_verify", "serve.spec_draft"),
     "rationale": "spec_k=8: acceptance decay vs dispatch savings "
                  "crossover"},
    # -- traffic: kv layout, block size, prefill buckets, tensor (r8-11)
    {"id": "traffic-dense", "batch": 8,
     "overrides": {"mode": "traffic", "kv_layout": "dense"},
     "programs": ("serve.decode", "serve.prefill"),
     "rationale": "dense-KV control arm under seeded shared-prefix "
                  "load"},
    {"id": "traffic-paged", "batch": 8,
     "overrides": {"mode": "traffic", "kv_layout": "paged"},
     "programs": ("serve.decode", "serve.paged_prefill"),
     "rationale": "paged KV vs dense: prefix reuse + hit rate vs gather "
                  "overhead"},
    {"id": "traffic-paged-bs32", "batch": 8,
     "overrides": {"mode": "traffic", "kv_layout": "paged",
                   "block_size": 32},
     "programs": ("serve.decode", "serve.paged_prefill"),
     "rationale": "block 32 vs 16: fewer page-table hops per token at "
                  "coarser sharing granularity"},
    {"id": "traffic-paged-bs64", "batch": 8,
     "overrides": {"mode": "traffic", "kv_layout": "paged",
                   "block_size": 64},
     "programs": ("serve.decode", "serve.paged_prefill"),
     "rationale": "block 64: the coarse end of the block-size curve"},
    {"id": "traffic-bucket256", "batch": 8,
     "overrides": {"mode": "traffic", "kv_layout": "paged",
                   "prefill_bucket": 256},
     "programs": ("serve.paged_prefill", "serve.prefill"),
     "rationale": "prefill bucket 256 vs 128: recompile count vs "
                  "padding waste"},
    {"id": "traffic-paged-t4", "batch": 8,
     "overrides": {"mode": "traffic", "kv_layout": "paged",
                   "tensor": 4},
     "programs": ("serve.sharded_decode",
                  "serve.sharded_paged_prefill"),
     "rationale": "sharded engine under live traffic: does the tensor "
                  "win survive scheduling noise?"},
)

#: status -> base priority; fresh candidates fall out of the plan
_STATUS_SCORE = {"regressed": 3.0, "unmeasured": 2.0, "stale": 1.0,
                 "fresh": 0.0}
#: added when the candidate targets the attribution's named bottleneck
_BOTTLENECK_BONUS = 0.5


def mirror_variant(batch: int,
                   overrides: Dict[str, Any]) -> Dict[str, Any]:
    """The exact variant dict ``sweep_tpu.run_sweep`` would record for
    ``[batch, overrides]`` — same keys, same defaults, leftovers under
    ``overrides`` — so ``perfledger._variant_key`` of the mirror equals
    the hash of the future measurement.  Held equal to the JAX
    package's mirror by ``tests/test_torch_autopilot.py``."""
    kw = dict(overrides)
    mode = kw.pop("mode", "train")
    if mode in ("decode", "decode_sharded"):
        prompt_len = kw.pop("prompt_len",
                            kw.pop("max_seq", kw.pop("seq", 128)))
        return {"mode": mode, "batch": batch, "prompt_len": prompt_len,
                "new_tokens": kw.pop("new_tokens", 64),
                "preset": kw.pop("preset", "gpt2"),
                # planner candidates always carry an explicit tensor
                # for the sharded mode (sweep_tpu's default is "all
                # local devices", which the planner cannot know)
                "tensor": kw.pop("tensor", 1), "overrides": kw}
    if mode == "decode_spec":
        return {"mode": mode, "batch": batch,
                "prompt_len": kw.pop("prompt_len", 128),
                "new_tokens": kw.pop("new_tokens", 64),
                "preset": kw.pop("preset", "gpt2"),
                "spec_k": kw.pop("spec_k", kw.pop("k", 4)),
                "spec_draft": kw.pop("spec_draft", "aligned"),
                "kv_layout": kw.pop("kv_layout", "dense"),
                "tensor": kw.pop("tensor", 1), "overrides": kw}
    if mode == "traffic":
        variant = {"mode": mode, "max_slots": batch,
                   "kv_layout": kw.pop("kv_layout", "paged"),
                   "tensor": kw.pop("tensor", 1),
                   "spec_k": kw.pop("spec_k", 0),
                   "requests": kw.pop("requests", 64),
                   "prefix_len": kw.pop("prefix_len", 256),
                   "p_shared": kw.pop("p_shared", 0.75),
                   "rate_rps": kw.pop("rate_rps", 32.0),
                   "preset": kw.pop("preset", "gpt2"),
                   "block_size": kw.pop("block_size", 16),
                   "prefill_bucket": kw.pop("prefill_bucket", 128),
                   # identity keys sweep_tpu records so A/B arms never
                   # hash into one ledger series — mirrored with the
                   # same `or None` normalization (0 = off = default)
                   "prefill_chunk_tokens":
                       kw.pop("prefill_chunk", None) or None,
                   "long_prompt_len": kw.pop("long_prompt_len", None),
                   "kv_host_tier_bytes":
                       kw.pop("kv_host_tier_bytes", None) or None,
                   "kv_num_blocks":
                       kw.pop("kv_num_blocks", None) or None}
        for consumed in ("spec_draft", "ttft_slo_ms", "e2e_slo_ms",
                         "seed", "prefix_groups", "tail_len_mean",
                         "tail_len_max", "vocab", "new_tokens",
                         "time_scale", "latency_slo_ms",
                         "max_queue_depth"):
            kw.pop(consumed, None)
        variant["overrides"] = kw
        return variant
    return {"batch_per_chip": batch,
            "seq": kw.pop("max_seq", kw.pop("seq", 1024)),
            "preset": kw.pop("preset", "gpt2"), "overrides": kw}


def candidate_status(cand: Dict[str, Any],
                     entries: List[Dict[str, Any]],
                     verdicts: Dict[str, Any],
                     current_sha: Optional[str]) -> Dict[str, Any]:
    """Grade one candidate against the ledger: its mirrored variant
    hash, which series exist under it, and whether the newest point is
    regressed / stale / fresh."""
    variant = mirror_variant(cand["batch"], cand["overrides"])
    vhash = perfledger._variant_key(variant)
    suffix = "#" + vhash
    names = [n for n in verdicts if n.endswith(suffix)]
    if not names:
        return {"variant": variant, "hash": vhash,
                "status": "unmeasured", "series": []}
    if any(verdicts[n].get("verdict") == "regress"
           or verdicts[n].get("baseline_verdict") == "regress"
           for n in names):
        return {"variant": variant, "hash": vhash,
                "status": "regressed", "series": names}
    newest = max(verdicts[n]["entry"] for n in names)
    prov = entries[newest].get("provenance") or {}
    sha = prov.get("git_sha")
    if sha is None or current_sha is None or sha != current_sha:
        return {"variant": variant, "hash": vhash, "status": "stale",
                "series": names, "measured_sha": sha}
    return {"variant": variant, "hash": vhash, "status": "fresh",
            "series": names, "measured_sha": sha}


def plan(history: Optional[str] = None,
         baseline: Optional[str] = None,
         budget: int = 8,
         attribution: Optional[Dict[str, Any]] = None,
         include_fresh: bool = False) -> Dict[str, Any]:
    """The next sweep: every catalog candidate graded against the
    ledger, the top ``budget`` by expected information kept.  Returns::

        {"git_sha": ..., "budget": ..., "bottleneck": ...,
         "variants": [{"id", "batch", "overrides", "variant", "hash",
                       "status", "score", "rationale"}],
         "skipped_fresh": [ids],
         "grid": [[batch, overrides], ...]}     # a sweep's argv[1]
    """
    entries = perfledger.load_history(history)
    verdicts = perfledger.check(history, baseline)["verdicts"]
    current_sha = perfledger.provenance().get("git_sha")
    bottleneck = (attribution or {}).get("bottleneck")
    bottleneck_knobs = set()
    if bottleneck and attribution:
        prog = (attribution.get("programs") or {}).get(bottleneck) or {}
        bottleneck_knobs = set(prog.get("knobs") or ())
    graded: List[Dict[str, Any]] = []
    skipped: List[str] = []
    for order, cand in enumerate(CANDIDATES):
        st = candidate_status(cand, entries, verdicts, current_sha)
        score = _STATUS_SCORE[st["status"]]
        targets_bottleneck = bottleneck in (cand.get("programs") or ())
        if targets_bottleneck:
            score += _BOTTLENECK_BONUS
        if st["status"] == "fresh" and not include_fresh:
            skipped.append(cand["id"])
            continue
        reason = cand["rationale"]
        if st["status"] == "regressed":
            reason = (f"REGRESSED in ledger ({', '.join(st['series'])})"
                      f" — re-measure to confirm; " + reason)
        elif st["status"] == "stale":
            reason = (f"stale (measured at "
                      f"{st.get('measured_sha') or 'unknown SHA'}, "
                      f"tree is {current_sha or 'unknown'}); " + reason)
        if targets_bottleneck:
            reason += (f" [targets bottleneck {bottleneck}: "
                       f"{'/'.join(sorted(bottleneck_knobs)) or '-'}]")
        graded.append({"id": cand["id"], "batch": cand["batch"],
                       "overrides": dict(cand["overrides"]),
                       "programs": list(cand.get("programs") or ()),
                       "variant": st["variant"], "hash": st["hash"],
                       "status": st["status"], "score": round(score, 2),
                       "order": order, "rationale": reason})
    graded.sort(key=lambda g: (-g["score"], g["order"]))
    chosen = graded[:max(0, budget)] if budget else graded
    for g in chosen:
        g.pop("order", None)
    return {"git_sha": current_sha, "budget": budget,
            "bottleneck": bottleneck,
            "variants": chosen, "skipped_fresh": skipped,
            "grid": [[g["batch"], g["overrides"]] for g in chosen]}


def render_text(p: Dict[str, Any]) -> str:
    """Human rendering of one plan."""
    lines = [f"plan @ {p['git_sha'] or 'unknown SHA'} — "
             f"{len(p['variants'])} of budget {p['budget']}"
             + (f", bottleneck {p['bottleneck']}" if p["bottleneck"]
                else "")]
    for g in p["variants"]:
        lines.append(f"  [{g['status']:<10s}] {g['id']:<24s} "
                     f"#{g['hash']}  {g['rationale']}")
    if p["skipped_fresh"]:
        lines.append(f"  (fresh, skipped: "
                     f"{', '.join(p['skipped_fresh'])})")
    lines.append("")
    lines.append("grid (a sweep runner over python -m ray_tpu_torch.bench "
                 "is ROADMAP.md queue 1 work): "
                 + json.dumps(p["grid"]))
    return "\n".join(lines)


__all__ = ["CANDIDATES", "mirror_variant", "candidate_status", "plan",
           "render_text"]
