#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (ray_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (any failure exits non-zero):

1. card   — require CUDA; print the card's name and power limit.
2. build  — build every CUDA kernel from ray_tpu_torch/ops/csrc with nvcc;
            print ptxas's registers, spills and wgmma-serialisation
            notes (C75xx) for each kernel.
3. kernel — hold the flash forward kernel against its plain PyTorch
            version at the serve shapes (B=8, H=12, D=64; T=512, 1024
            and an uneven 1000; causal and not; resident_kv on and off;
            bf16 and f32) and at D=32 and 128 (T=512 and 1000), and time
            it beside the plain version, a PyTorch library call
            computing the same function, and the card's bound.
4. kernel-bwd — hold the flash backward kernels (dQ with the delta
            it computes, dK/dV) against their plain PyTorch versions at
            B*H=24, T=1024, 1000 and 77, D=32, 64 and 128, causal and
            not, bf16 and f32, and the whole backward against the two
            kernels called alone (bit-equal), then hold them and the
            forward against their plain versions at the training shape
            (B=24, H=12, T=1024, D=64, causal, bf16), where they are
            timed beside their plain versions and their bounds (the
            share of it each reaches, grids and waves), the whole
            backward against scaled_dot_product_attention's backward
            in turns, and the forward against its forward; forward and
            backward each bit-equal across two calls.
5. kernel-ce — hold the fused lm-head + cross-entropy kernels
            (forward, dH, dW) against their plain PyTorch versions at
            the card tests' shapes (bf16 and f32; D from 64 to 8192,
            the bf16 backward's widest) and at the training
            shape (N=B*T=24576, V=50304, valid 50257, D=768, bf16, g =
            1/N as the mean loss gives), where they are timed beside
            their plain versions, their bounds (and the share of it
            each reaches), their grids and the dense composition (the
            dense CE's logits product, logsumexp and gather; its
            backward for dH and dW together, and the ratio of dH + dW
            to it), a yardstick the fused path never calls; the
            forward bit-equal across two calls; then at gpt2-large's
            head (N=8192, V=50304, D=1280) timed beside their bounds and
            the dense composition.
6. serve  — build the GPT-2-124M engine (full width, seeded random
            weights, bf16 compute) on the card, answer 8 concurrent
            512-token requests and one ragged batch, check the replies,
            check that the prefill went through the kernel (its launch
            counter, zeroed just before), hold the prefill logits
            against plain attention's, the flash kernels against their
            plain versions at the shape the prefill gives them, and
            paged greedy generation against dense (token for token),
            and time prefill and decode.
7. train  — time GPT-2-124M AdamW steps at full width and depth (B=24,
            T=1024, remat mlp_only, dense CE) through
            ray_tpu_torch.bench.time_config; check that every step
            launched the forward and both backward kernels once per
            layer (counters zeroed just before) and that the loss is
            finite and falls on the repeated batch; compare the loss,
            the gradient norm and the qkv_w gradient with those of
            plain attention (use_flash=False) on the same weights and
            batch, time the two steps in turns, and profile one flash
            step (torch.profiler: device time by kernel).
8. train-ce — the same steps with ce_impl="pallas" (the fused CE
            kernels) through time_config: 12 launches of each flash
            kernel and 1 of each fused-CE kernel per step, a finite
            falling loss; one step each of ce_impl "dense", "pallas",
            "streaming_xla" and of remat "dots", "dots_nb", "attn_out"
            on the same weights and batch, checked against each other
            (loss, gradient norm, wte gradient) and for their flash
            launches; the dense and pallas steps timed in turns, the
            peak memory of each step, and a profile of one pallas step;
            then one dense and one pallas step at gpt2-large's width
            (d_model 1280, 2 layers, B=8), checked against each other.
9. serve-llama — phase 6 for llama-1b (16 layers, 32 query heads on 8
            KV heads of 64, d_model 2048, vocab 32,000): 16 flash
            launches per equal-length prefill, flash vs plain prefill
            logits, paged vs dense greedy tokens (B=8, T=512, 16 new);
            as in phase 6, the flash kernels held against their plain
            versions at the shape the prefill gives them (B=8, H=32,
            T=512, D=64).
10. serve-continuous — llama-1b through the continuous scheduler
            (build_llm_deployment(scheduler="continuous")): 16 requests,
            8 sharing a 256-token prefix and 8 cold, 24 new tokens each,
            greedy, in two waves (12, then 4 once the first reply is
            back), through four f32 engines of 4 slots (dense; paged in
            a 65-block pool, which requeues and evicts; the same with
            chunked prefill of 128 tokens; the same with a host KV
            tier), each request held against the solo dense f32
            llama_generate of its prompt (token for token, or parted at
            a near-tie of the oracle's own logits, printed), the pager
            empty after each paged run, prefix hits and requeues in the
            second, tier restores in the fourth; then bf16 timing, 32
            such requests at once through a paged engine of 8 slots and
            through the batch scheduler, in turns: served tokens/s,
            request latency p50/p95, prefix hit rate, evictions; beside
            the phase's clock each continuous engine's own telemetry
            (engine_stats(): TTFT and inter-token p50/p95, decode
            tokens/s).  The engines launch no kernel (their prefills and
            decode are plain PyTorch), which the kernels line records.
11. serve-spec-disagg — speculative decoding and the prefill/decode
            roles on phase 10's request set, oracle and near-tie rule:
            f32 engines (e) paged with n-gram spec (k=4), (f) dense with
            the aligned draft (llama-1b drafting for itself), (g) a
            role="prefill" paged engine handing each request's blocks
            to a role="decode" one on the device, (h) the same pair
            staged through host memory with chunked prefill, (i) the
            pair of (g) with n-gram spec on the decode side; every reply
            held to the oracle; the acceptance rate of each spec engine
            (counted by wrapping its spec_verify and held equal to the
            engine's own engine_stats()["spec"]; the aligned draft's
            must reach 0.9), the blocks handed off (= sum of ceil(n/16),
            and equal to the engines' engine_stats()["handoff"]),
            the decode engine's prefix hits for prompts sent straight
            to it after the handoffs (>= its imported prefix blocks),
            empty pagers; then bf16, 32 requests at once through 8
            slots: plain, n-gram spec and a llama-s draft in turns
            (served tokens/s, latency p50/p95, acceptance rate), and a
            fast and a staged prefill/decode pair (export and install ms
            a request, bytes, GB/s), each engine's own telemetry beside
            the phase's clock.  No kernel launches.
12. serve-telemetry — the engine telemetry on llama-1b, phase 10's
            request set, oracle and near-tie rule: (a) an f32 paged
            engine of 4 slots with a generous SLOConfig: every reply
            held to the oracle, engine_stats() with every top-level key
            of the reference's, requests admitted = finished = 16,
            tokens_generated = the replies' decode tokens, kv_cache =
            kv_stats()'s, no breach, serve.paged_prefill and
            serve.decode compiled, one HBM-ledger row whose limit is the
            card's memory and whose headroom is limit - max(allocated,
            pool), the roofline naming the card, a timeline with a lane
            per slot, the queue's and the steps'; (b) bf16, 32 requests
            at once through 8 slots: served tokens/s by the phase's
            clock and the engine's, TTFT and inter-token p50/p95, slot
            utilization, the share of the wall time spent inside the
            EngineTelemetry methods (wrapped here), every record call
            under torch.cuda.set_sync_debug_mode("error"), the decode
            steps' and the prefills' share, and one run of 8 under
            torch.profiler: the card's busy share; (c) admission_policy:
            a queue bound of 4 (the shed = rejections_by_reason
            ["shed_queue_full"] > 0, the rest reply), a headroom above
            the card's memory (all shed as shed_hbm_headroom), a
            headroom of 1 GiB (none shed); (d) a 0.001 ms TTFT target:
            a breach and a flight-record dump holding the pager's
            kv_reserve events; (e) a HealthMonitor and a ChaosInjector
            freezing the engine for >= 600 ms, attached as the fleet
            router attaches them: suspect, dead, recovered, with
            time_to_detect_ms, f32 replies held to the oracle; (f) the
            batch scheduler, 8 equal-length bf16 requests: 8 finished
            with a latency sample each, 16 flash forward launches (one
            prefill, zeroed just before).
13. train-llama — llama-1b AdamW steps at B=8, T=2048, remat of the
            whole block, ce_impl="pallas": a warm-up and 5 timed steps
            (step ms, tokens/s, MFU, peak memory; 32 flash forwards, 16
            dQ and 16 dK/dV launches and 1 of each fused-CE kernel per
            step; a finite falling loss); one dense-CE and one
            plain-attention step held against the pallas step; dense and
            pallas steps timed in turns; a profile of one pallas step;
            the fused-CE kernels at llama-1b's head (N=16384, V=32000,
            D=2048: dH and dW through the cluster kernel, bit-equal
            across two launches, its clusters and waves) and the flash
            kernels at its attention (B=8, H=32, T=2048, D=64) held
            against their plain versions and timed beside their bounds,
            the dense composition and SDPA.
14. llama-7b — llama-7b's width (d_model 4096, 32 heads of 128) cut to
            2 layers: a dense and a pallas step at B=2, T=2048 checked
            against each other, the flash kernels held against their
            plain versions at the shape these steps give them (B=2,
            H=32, T=2048, D=128), and one prefill, flash vs plain
            attention.

The line before the last is a JSON object describing each kernel; the
line before it is the card's name and power limit; the last line is
{"ok": true, "device": {...}}.  There is no CPU path.
"""

from __future__ import annotations

import asyncio
import dataclasses
import importlib
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path


B, H, D = 8, 12, 64          # serve shape
TRAIN_B, TRAIN_T = 24, 1024  # training shape (bench.py's GPT-2 step)
# kernel vs plain version, max |difference| allowed:
# f32 O: the tolerance of the JAX package's flash tests; the kernel and
#   the plain version sum in different orders
# bf16 O: both compute in f32 and differ by the final rounding to bf16
#   (8 mantissa bits: one step is 2**-7 relative), plus order
# LSE (f32 in both cases): a log of a sum of up to T terms, magnitude
#   ~10, summed in another order
TOL = {("f32", "o"): 2e-5, ("bf16", "o"): 5e-2, ("f32", "lse"): 1e-4,
       ("bf16", "lse"): 1e-4}
# backward kernels vs plain versions, |kernel - plain| <= atol + rtol *
# |plain| elementwise and ||kernel - plain|| / ||plain|| <= BWD_REL_NORM
# per tensor: f32 at the JAX package's gradient tolerance (sums in
# another order); bf16: both round P and dS to bf16 before the products
# and the f32 sums to bf16 once, so an element can land one bf16 step
# (2**-7 relative, under rtol) from the plain version's; atol covers
# elements near 0 (a P/dS term rounded the other way is ~2**-9 of a term
# <~ 1) and is a tenth of a typical dK/dV element at T=1024 (~0.05), so
# a dropped part of a sum shows; few elements round apart, so the
# relative norm stays far below one bf16 step (<= 1.4e-4 on an H100 at
# every shape of phase 4; f32 <= 2.5e-7)
BWD_TOL = {"f32": (1e-4, 1e-4), "bf16": (5e-3, 2e-2)}
BWD_REL_NORM = {"f32": 1e-5, "bf16": 2e-3}
# delta = rowsum(dO * O) from the dQ kernel vs flash_bwd_delta: both sum
# the same D products in f32 in different orders (a bf16 product is exact
# in f32, an f32 one rounds once), so each lies within (D + 1) * 2**-24
# * sum|dO * O| of the exact sum and the two within twice that
DELTA_ULP = 2.0 ** -24
# rounds of the whole backward and SDPA's backward timed in turns
BWD_TURNS = 7
# one GPT-2-124M step, flash kernels vs plain attention on the same
# weights and batch, bf16 through 12 layers (on an H100: loss |diff|
# 4.1e-5, grad-norm relative diff 7.6e-6, q/k/v parts <= 1.53e-2; each
# bound is set well above that): the loss (~10.98 at this init), the global gradient
# norm, relative, and the relative norm of the difference of each of
# the q, k and v parts of the qkv_w gradient, which dq, dk and dv feed
# directly; the plain path rounds the scores and P to bf16 where the
# kernels keep f32, so its gradient differs elementwise by up to a bf16
# step
TRAIN_LOSS_TOL = 1e-3
TRAIN_GRAD_NORM_RTOL = 1e-3
TRAIN_QKV_GRAD_RTOL = 0.1
# prefill last-token logits, flash kernel vs plain attention, bf16
# through 12 layers: the paths round P and O to bf16 at different
# places; logits are O(1) at this init
LOGIT_TOL = 0.1


# fused CE kernels vs plain versions: nll and lse, |kernel - plain| <=
# 1e-4 + 1e-4 * |plain| (both sum exact bf16 products and exps in f32,
# in different orders); dH and dW, |kernel - plain| <= ATOL_FRAC *
# rms(plain) + RTOL * |plain| elementwise and ||kernel - plain|| /
# ||plain|| <= REL_NORM: f32 at the JAX package's gradient tolerance,
# bf16 where both round dlogits to bf16 before the products and an
# element rounded a step apart moves a sum of V or N terms by far less
# than a term (the reasons of tests/test_torch_fused_ce_kernel.py,
# which uses the same numbers); a dropped tile moves the relative norm
# by more than 1e-2
CE_OUT_TOL = (1e-4, 1e-4)
CE_GRAD_TOL = {"f32": (1e-4, 1e-4, 1e-5), "bf16": (1e-2, 2e-2, 2e-3)}
CE_SHAPES = ((33, 130, 123, 64), (70, 300, 257, 192),
             (1000, 50304, 50257, 768), (200, 1000, 990, 1024),
             (65, 1088, 1000, 64), (130, 513, 500, 128),
             # gpt2-large, llama-1b and llama-7b widths: the backward's
             # cluster kernel (2, 4 and 8 CTAs split D); D = 5120 and
             # 8192, past 8 x 8 boxes: two grid-y slices of 8 CTAs (at
             # 5120 three hold no column of D); D = 16384: 16 CTAs
             (300, 4096, 4000, 1280), (200, 2000, 1990, 2048),
             (130, 1000, 990, 4096), (33, 130, 123, 5120),
             (70, 200, 190, 8192), (70, 200, 190, 16384))
# GPT-2-124M's head at the training shape
CE_N, CE_V, CE_VALID, CE_D = TRAIN_B * TRAIN_T, 50304, 50257, 768
# gpt2-large's width (d_model 1280, 20 heads of 64: above the 1024 the
# fused-CE kernels once refused), depth cut to WIDE_LAYERS and the batch
# to WIDE_B x TRAIN_T; its pallas step is held against its dense step
WIDE_PRESET, WIDE_D, WIDE_LAYERS, WIDE_B = "gpt2-large", 1280, 2, 8
# one GPT-2-124M step, other CE or remat vs its reference step on the
# same weights and batch: the loss and the relative gradient norm (the
# tolerances of the flash-vs-plain step) and ||wte grad - reference|| /
# ||reference|| over all rows and over the head-only rows (the rows of
# tokens that are no input of the batch, whose gradient comes from the
# lm head alone).  All rows carry the embedding gradient, where the
# backbone's bf16 backward leaves differences near a bf16 step (6.4e-3
# on an H100 for every pair of CE paths); the head-only rows carry the
# CE's dW alone: against dense, which rounds it to bf16, 1e-2 (1.7e-3
# measured); between paths that keep it f32 (pallas, streaming_xla,
# the remat policies), 1e-4 (7.9e-7 measured; a dW kernel that drops
# its last row tile moves it by 2.9e-3)
CE_LOSS_TOL = 1e-3
CE_GRAD_NORM_RTOL = 1e-3
CE_WTE_GRAD_RTOL = 1e-2
CE_HEAD_GRAD_RTOL = {"dense": 1e-2, "f32": 1e-4}

# kinds of device work in the training-step profile, by kernel name
PROFILE_KINDS = (("flash kernels", ("flash_",)),
                 ("fused CE kernels", ("fused_ce_",)),
                 ("matmuls (cuBLAS)", ("nvjet", "gemm", "cutlass", "xmma")),
                 ("copies and casts", ("Memcpy", "Memset", "copy_kernel")),
                 ("reductions", ("reduce_kernel",)))


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def time_ms(torch, fn, iters: int = 20) -> float:
    """Mean device time of fn() over iters calls (CUDA events), after
    warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def in_turns(torch, fns: dict, rounds: int = BWD_TURNS) -> tuple:
    """Each function's time_ms over `rounds` rounds in turns (a, b, b, a,
    ...): ({name: median}, {name: [ms of each round]})."""
    runs = {name: [] for name in fns}
    for i in range(rounds):
        for name in (list(fns) if i % 2 == 0 else list(fns)[::-1]):
            runs[name].append(time_ms(torch, fns[name]))
    return {k: sorted(v)[len(v) // 2] for k, v in runs.items()}, runs


def bound_ms(nbytes: float, flops: float, dtype: str) -> tuple:
    """(least time on this card in ms, "bytes" or "operations"): the
    larger of the bytes over the memory rate and the operations over
    the peak rate of their type: one H100 SXM's data-sheet rates, from
    the port's table (ray_tpu_torch/_private/device_stats.py)."""
    peak = importlib.import_module(
        "ray_tpu_torch._private.device_stats").H100_SXM
    t_bytes = nbytes / peak["hbm_bytes_per_s"] * 1e3
    t_ops = flops / peak[f"{dtype}_flops"] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def visible_pairs(T: int, causal: bool) -> int:
    return T * (T + 1) // 2 if causal else T * T


def attention_bound_ms(T: int, causal: bool, dtype: str,
                       bh: int = B * H, d: int = D) -> tuple:
    """Least time for one (BH, T, D) attention forward on this card:
    q, k, v read once, o and lse written once; 4*D operations per
    visible (query, key) pair."""
    elem = 2 if dtype == "bf16" else 4
    nbytes = 4 * bh * T * d * elem + bh * T * 4
    return bound_ms(nbytes, 4 * bh * d * visible_pairs(T, causal), dtype)


def bwd_bounds_ms(bh: int, T: int, d: int, causal: bool,
                  dtype: str) -> dict:
    """Least times of the backward's parts, each tensor read or written
    once, per visible (query, key) pair: dQ kernel 6*D operations
    (S, dP, dS.K) and 2*D per row for delta (reads q, k, v, o, dO, lse;
    writes dq, delta), dK/dV kernel 8*D (S, dP, P^T.dO, dS^T.Q; reads
    q, k, v, dO, lse, delta; writes dk, dv), the whole backward 10*D
    and delta (reads q, k, v, o, dO, lse; writes dq, dk, dv)."""
    elem = 2 if dtype == "bf16" else 4
    mat, row = bh * T * d * elem, bh * T * 4
    flops = bh * d * visible_pairs(T, causal)
    delta_flops = 2 * bh * T * d
    return {"dq": bound_ms(6 * mat + 2 * row, 6 * flops + delta_flops,
                           dtype),
            "dkv": bound_ms(6 * mat + 2 * row, 8 * flops, dtype),
            "whole": bound_ms(8 * mat + row, 10 * flops + delta_flops,
                              dtype)}


def bwd_compare(got, want, dtype: str) -> dict:
    """max |got - want|, the relative norm of the difference, and
    whether both are within BWD_TOL and BWD_REL_NORM."""
    atol, rtol = BWD_TOL[dtype]
    err = (got.float() - want.float()).abs()
    excess = (err - atol - rtol * want.float().abs()).max().item()
    rel = (err.norm() / want.float().norm()).item()
    return {"max": err.max().item(), "rel": rel,
            "ok": excess <= 0 and rel <= BWD_REL_NORM[dtype]
            and bool(got.isfinite().all())}


def bwd_report(cmp: dict, names=("dq", "dk", "dv")) -> str:
    return ", ".join(f"{n} max|d| {c['max']:.3e} rel {c['rel']:.3e}"
                     for n, c in zip(names, cmp))


def delta_compare(fa, delta, o3, do3) -> dict:
    """max |delta - plain| (flash_bwd_delta), its largest share of the
    bound 2 (D + 1) 2**-24 sum|dO * O| per row, and whether every row
    is within it."""
    want = fa.flash_bwd_delta(o3, do3)
    bound = 2 * (o3.shape[-1] + 1) * DELTA_ULP * (
        do3.float() * o3.float()).abs().sum(dim=-1)[:, None, :]
    err = (delta - want).abs()
    share = (err / bound.clamp_min(1e-30)).max().item()
    return {"max": err.max().item(), "share": share,
            "ok": delta.shape == want.shape and bool((err <= bound).all())}


COUNTERS = ("FLASH_FWD_LAUNCHES", "FLASH_BWD_DQ_LAUNCHES",
            "FLASH_BWD_DKV_LAUNCHES")
CE_COUNTERS = ("FUSED_CE_FWD_LAUNCHES", "FUSED_CE_BWD_DH_LAUNCHES",
               "FUSED_CE_BWD_DW_LAUNCHES")


def _fc():
    return importlib.import_module("ray_tpu_torch.ops.fused_ce")


def zero_counts(fa) -> None:
    for c in COUNTERS:
        setattr(fa, c, 0)
    for c in CE_COUNTERS:
        setattr(_fc(), c, 0)


def read_counts(fa) -> dict:
    """Launches of the flash kernels; of the fused CE kernels too where
    any ran (the serve and dense paths launch none)."""
    counts = {"flash_fwd": fa.FLASH_FWD_LAUNCHES,
              "flash_bwd_dq": fa.FLASH_BWD_DQ_LAUNCHES,
              "flash_bwd_dkv": fa.FLASH_BWD_DKV_LAUNCHES}
    fc = _fc()
    ce = {"fused_ce_fwd": fc.FUSED_CE_FWD_LAUNCHES,
          "fused_ce_bwd_dh": fc.FUSED_CE_BWD_DH_LAUNCHES,
          "fused_ce_bwd_dw": fc.FUSED_CE_BWD_DW_LAUNCHES}
    if any(ce.values()):
        counts.update(ce)
    return counts


def phase_card(torch) -> tuple:
    if not torch.cuda.is_available():
        fail("no CUDA device (torch.cuda.is_available() is false)")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(f"[card] torch {torch.__version__} cuda {torch.version.cuda}; "
          f"device 0: {name}; nvidia-smi: {card}", flush=True)
    return name, card


def ptxas_report(log: str) -> dict:
    """{kernel: [ptxas lines]} from an nvcc -Xptxas -v log: each entry
    function's registers and spills, and any wgmma-serialisation
    warning (C75xx) that names it; kernels by name and template
    arguments, e.g. flash_bwd_dq_bf16_kernel<64>."""
    def short(mangled):
        # the length-prefixed component that names a kernel, then its
        # template arguments (I Li64E ... E)
        for i in range(len(mangled)):
            for j in (1, 2, 3):
                if not mangled[i:i + j].isdigit():
                    break
                n = int(mangled[i:i + j])
                name = mangled[i + j:i + j + n]
                if name.endswith("_kernel") and name.isidentifier() and \
                        not name[0].isdigit():
                    m = re.match(r"I((?:Li\d+E)+)E", mangled[i + j + n:])
                    args = re.findall(r"Li(\d+)E", m.group(1)) if m else []
                    return name + (f"<{', '.join(args)}>" if args else "")
        return mangled[:60]

    report, current = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(\w+)", line)
        if m:
            current = short(m.group(1))
            continue
        if current and ("registers" in line or "spill" in line):
            report.setdefault(current, []).append(
                line.split(":", 1)[-1].strip())
        elif re.search(r"C75\d\d", line):
            m = re.search(r"'(_Z\w+)'", line)
            report.setdefault(short(m.group(1)) if m else "?", []).append(
                line.strip())
    return report


def phase_build(kernels) -> dict:
    t0 = time.perf_counter()
    paths = kernels.build_all()
    secs = time.perf_counter() - t0
    print(f"[build] {len(paths)} kernel libraries in {secs:.2f} s",
          flush=True)
    reports = {}
    for name, path in paths.items():
        log = path.with_suffix(".so.log")
        reports[name] = ptxas_report(log.read_text() if log.exists()
                                     else "")
        for kernel, lines in reports[name].items():
            print(f"[build] {name}: {kernel}: " + "; ".join(lines))
        serial = sum(bool(re.search(r"C75\d\d", ln))
                     for lines in reports[name].values() for ln in lines)
        print(f"[build] {name}: {serial} wgmma-serialisation notes (C75xx)",
              flush=True)
    return reports


def phase_kernel(torch, fa, card: str) -> dict:
    F = torch.nn.functional
    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev).manual_seed(0)
    dtypes = {"bf16": torch.bfloat16, "f32": torch.float32}
    cases = [(T, causal, dt, D) for T in (512, 1024)
             for causal in (True, False) for dt in ("bf16", "f32")]
    cases += [(1000, True, "bf16", D), (1000, True, "f32", D)]
    # the other head dims the kernel is built for (llama-7b's is 128)
    cases += [(T, causal, dt, d) for d in (32, 128) for T in (512, 1000)
              for causal in (True, False) for dt in ("bf16", "f32")]
    headline = None
    for T, causal, dt, d in cases:
        q4, k4, v4 = (torch.randn((B, T, H, d), generator=gen, device=dev)
                      .to(dtypes[dt]) for _ in range(3))
        q3, k3, v3 = (x.transpose(1, 2).reshape(B * H, T, d)
                      for x in (q4, k4, v4))
        scale = 1.0 / math.sqrt(d)
        o_ref, lse_ref = fa.flash_attention_fwd_reference(
            q3, k3, v3, scale=scale, causal=causal)
        o, lse = fa.flash_attention_fwd(q3, k3, v3, scale=scale,
                                        causal=causal)
        torch.cuda.synchronize()
        err_o = (o.float() - o_ref.float()).abs().max().item()
        err_lse = (lse - lse_ref).abs().max().item()
        o_ref4 = o_ref.reshape(B, H, T, d).transpose(1, 2).float()
        err_res = {}
        for resident in (True, False):
            o4 = fa.flash_attention(q4, k4, v4, causal=causal,
                                    resident_kv=resident)
            err_res[resident] = (o4.float() - o_ref4).abs().max().item()
        torch.cuda.synchronize()
        ok = (max(err_o, *err_res.values()) <= TOL[(dt, "o")]
              and err_lse <= TOL[(dt, "lse")])
        ms = time_ms(torch, lambda: fa.flash_attention_fwd(
            q3, k3, v3, scale=scale, causal=causal))
        bound, bound_by = attention_bound_ms(T, causal, dt, d=d)
        print(f"[kernel] T={T} D={d} causal={causal} {dt}: max|o-plain| "
              f"{err_o:.3e} (resident on {err_res[True]:.3e}, off "
              f"{err_res[False]:.3e}; tol {TOL[(dt, 'o')]:.0e}), "
              f"max|lse-plain| {err_lse:.3e} (tol "
              f"{TOL[(dt, 'lse')]:.0e}); kernel {ms:.4f} ms, bound "
              f"{bound:.4f} ms ({bound_by}) [{card}]", flush=True)
        if not ok:
            fail(f"kernel disagrees with its plain version at T={T} D={d} "
                 f"causal={causal} {dt}")
        if (T, causal, dt, d) == (512, True, "bf16", D):
            # the shape the serve prefill gives the kernel
            plain_ms = time_ms(torch, lambda: fa.
                               flash_attention_fwd_reference(
                                   q3, k3, v3, scale=scale, causal=causal))
            qh, kh, vh = (x.transpose(1, 2).contiguous()
                          for x in (q4, k4, v4))
            library_ms = time_ms(torch, lambda: F.
                                 scaled_dot_product_attention(
                                     qh, kh, vh, is_causal=True))
            headline = {"max_abs_err": err_o, "ms": ms,
                        "plain_ms": plain_ms, "bound_ms": bound,
                        "bound_by": bound_by, "library_ms": library_ms}
            print(f"[kernel] serve shape B={B} T={T} H={H} D={D} causal "
                  f"bf16: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                  f"library (scaled_dot_product_attention) "
                  f"{library_ms:.4f} ms, bound {bound:.4f} ms "
                  f"({bound_by}) [{card}]", flush=True)
        del q4, k4, v4, q3, k3, v3, o, lse, o_ref, lse_ref, o_ref4
    return headline


async def _serve_all(engine, prompts):
    return await asyncio.gather(*(engine(p) for p in prompts))


#: llama's flash-vs-plain bf16 prefill logit tolerance: the paths round
#: P and O to bf16 at different places through 16 layers with a bf16
#: residual stream, logits up to ~4 from the untied head: each bf16 path
#: lies ~0.12 from the f32 logits and the two 0.117 apart on an H100
#: (llama-7b's width at 2 layers: 0.10), so the bound is 0.25.  A bf16
#: forward that drops key tile 0 of the last query block reads 2.87 here,
#: and 0.663 when it does so in one (batch, head) pair only
#: (flash_fault_check.py on an H100); the kernel check at the path's own
#: shape (check_train_shape) is the sharper one: that plant moves o by
#: 0.232 against its 5e-2
LLAMA_LOGIT_TOL = 0.25
#: the same prefill in f32, the f32 flash kernel vs plain f32 attention:
#: each attention output within 2e-5 (TOL) of the other, carried through
#: the layers (on an H100: 3.3e-6 for GPT-2-124M, 2.3e-5 for llama-1b,
#: 2.5e-5 at llama-7b's width); an f32 forward that drops key tile 0 of
#: the last query block reads 2.35 at llama-1b (flash_fault_check.py)
F32_LOGIT_TOL = 1e-3


def serve_family(family: str) -> tuple:
    """(preset, prefill, decode step, generate, flash-vs-plain bf16
    prefill logit tolerance) of a serving phase's family."""
    if family == "gpt2":
        from ray_tpu_torch.models import gpt2_decode as m
        return "gpt2", m.prefill, m.decode_step, m.generate, LOGIT_TOL
    from ray_tpu_torch.models import llama_decode as m
    return ("llama-1b", m.llama_prefill, m.llama_decode_step,
            m.llama_generate, LLAMA_LOGIT_TOL)


def check_prefill_flash(torch, prefill, params, toks, cfg, tol: float,
                        tag: str) -> dict:
    """Prefill last-token logits through the flash kernel against plain
    attention on the same weights, in bf16 (within ``tol``) and in f32
    (the f32 flash kernel against plain f32 attention, within
    F32_LOGIT_TOL); and the bf16 flash logits no further from the f32
    ones than twice the bf16 plain logits are (the flash kernel keeps P
    in f32 where plain attention rounds it to bf16).  Fails otherwise.
    Must run under inference_mode.  Returns the numbers."""
    logits = {}
    for dtype in ("bf16", "f32"):
        for flash in (True, False):
            c = dataclasses.replace(cfg, use_flash=flash, dtype={
                "bf16": torch.bfloat16, "f32": torch.float32}[dtype])
            logits[dtype, flash] = prefill(params, toks, c)[0]
    torch.cuda.synchronize()
    lf = logits["bf16", True]
    ref = logits["f32", False]
    out = {"bf16": (lf - logits["bf16", False]).abs().max().item(),
           "f32": (logits["f32", True] - ref).abs().max().item(),
           "flash_from_f32": (lf - ref).abs().max().item(),
           "plain_from_f32": (logits["bf16", False] - ref).abs().max()
           .item()}
    print(f"[{tag}] prefill last-token logits, flash vs plain attention: "
          f"bf16 max|diff| {out['bf16']:.4e} (tol {tol}; max|logit| "
          f"{ref.abs().max().item():.3f}), f32 max|diff| {out['f32']:.4e} "
          f"(tol {F32_LOGIT_TOL}); bf16 from the f32 logits: flash "
          f"{out['flash_from_f32']:.4e}, plain {out['plain_from_f32']:.4e}"
          f" (flash within twice plain's)", flush=True)
    if lf.shape != (toks.shape[0], cfg.padded_vocab) or \
            not bool(torch.isfinite(lf).all()):
        fail("prefill logits are not finite (B, padded_vocab)")
    if out["bf16"] > tol or out["f32"] > F32_LOGIT_TOL or \
            out["flash_from_f32"] > 2 * out["plain_from_f32"]:
        fail("flash and plain prefill logits disagree")
    return out


def phase_serve(torch, np, fa, card: str, family: str = "gpt2",
                tag: str = "serve") -> dict:
    """The serving main path of ``family``: the engine at full width
    and depth answering 8 concurrent 512-token requests (flash launches
    counted, zeroed just before) and a ragged batch; prefill logits,
    flash against plain attention; the flash kernels against their
    plain versions at the shape the prefill gives them; paged greedy
    generation against dense, token for token; prefill and decode
    timed.  Returns the launch counts and the times."""
    from ray_tpu_torch.serve import build_llm_deployment

    preset, prefill, decode_step, generate, logit_tol = serve_family(family)
    max_new, t_prompt = 16, 512
    t0 = time.perf_counter()
    engine = build_llm_deployment(family, preset, max_new_tokens=max_new,
                                  max_batch_size=8, seed=0)()
    cfg = engine.cfg
    torch.cuda.synchronize()
    print(f"[{tag}] {family} {preset}: {cfg.n_layer} layers, "
          f"d={cfg.d_model}, {cfg.n_head} heads "
          f"({getattr(cfg, 'n_kv_head', cfg.n_head)} KV heads), head_dim "
          f"{cfg.head_dim}, vocab {cfg.padded_vocab}, compute {cfg.dtype}, "
          f"params {cfg.param_dtype}: engine up in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    rng = np.random.default_rng(0)

    def prompts_of(lengths):
        return [rng.integers(0, cfg.vocab_size, size=n, dtype=np.int32)
                for n in lengths]

    def check(prompts, outs):
        for p, o in zip(prompts, outs):
            if o.shape != (len(p) + max_new,) or \
                    not np.array_equal(o[:len(p)], p):
                fail(f"reply of shape {o.shape} does not extend its "
                     f"{len(p)}-token prompt by {max_new} tokens")
            if o.min() < 0 or o.max() >= cfg.vocab_size:
                fail("reply holds a token outside the vocabulary")

    # warm-up: cuBLAS handles and allocator pools, not counted
    warm = prompts_of([t_prompt] * 8)
    check(warm, asyncio.run(_serve_all(engine, warm)))

    # the main path: 8 concurrent equal-length requests, one batch
    prompts = prompts_of([t_prompt] * 8)
    zero_counts(fa)
    t0 = time.perf_counter()
    outs = asyncio.run(_serve_all(engine, prompts))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts(fa)
    launches = counts["flash_fwd"]
    check(prompts, outs)
    if counts != {"flash_fwd": cfg.n_layer, "flash_bwd_dq": 0,
                  "flash_bwd_dkv": 0}:
        fail(f"kernel launches {counts} for the equal-length prefill, "
             f"expected {cfg.n_layer} forward and no backward")
    print(f"[{tag}] 8 x {t_prompt}-token requests: {launches} flash "
          f"kernel launches; {8 * max_new} tokens in {wall * 1e3:.1f} ms "
          f"wall = {8 * max_new / wall:.1f} served tokens/s [{card}]",
          flush=True)

    # a ragged batch: left-padded, plain attention by design
    ragged = prompts_of([512, 300, 100, 17, 450, 64, 256, 8])
    fa.FLASH_FWD_LAUNCHES = 0
    outs = asyncio.run(_serve_all(engine, ragged))
    check(ragged, outs)
    if fa.FLASH_FWD_LAUNCHES != 0:
        fail("the ragged prefill launched the causal-only flash kernel")
    print(f"[{tag}] ragged batch of {len(ragged)} answered (0 kernel "
          f"launches: ragged prefill takes the plain masked attention)",
          flush=True)

    # the kernels at this prefill's shape: (B*H, T, D) of the query heads
    kernel_err = check_train_shape(torch, fa, seed=3, b=len(prompts),
                                   h=cfg.n_head, T=t_prompt,
                                   d=cfg.head_dim, tag=f"{tag} shape")["err"]
    toks = torch.from_numpy(np.stack(prompts)).cuda()
    with torch.inference_mode():
        cfg_flash = dataclasses.replace(cfg, use_flash=True)
        cfg_plain = dataclasses.replace(cfg, use_flash=False)
        flash_check = check_prefill_flash(torch, prefill, engine.params,
                                          toks, cfg, logit_tol, tag)

        # the block-paged layout: greedy tokens equal to dense, token
        # for token (the gathered pool view holds the dense cache's
        # bytes, so every logit is the same)
        kw = dict(max_new_tokens=max_new, temperature=0.0)
        dense = generate(engine.params, toks, cfg, **kw)
        paged = generate(engine.params, toks, cfg, kv_layout="paged",
                         kv_block_size=16, **kw)
        torch.cuda.synchronize()
        same = bool(torch.equal(dense, paged))
        print(f"[{tag}] greedy generation B=8 T={t_prompt} +{max_new}, "
              f"kv_layout paged (16-token blocks) vs dense: "
              f"token-for-token equal {same}", flush=True)
        if not same:
            fail("paged and dense greedy generation disagree")
        del dense, paged

        # prefill with the kernel and with plain attention, in turns
        # (flash, plain, plain, flash, ...) so both see the same host
        prefill_s = {"flash": [], "plain": []}
        for name in ["flash", "plain", "plain", "flash"] * 3:
            c = cfg_flash if name == "flash" else cfg_plain
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, cache = prefill(engine.params, toks, c)
            torch.cuda.synchronize()
            prefill_s[name].append(time.perf_counter() - t0)
        med = {k: sorted(v)[len(v) // 2] * 1e3 for k, v in
               prefill_s.items()}
        step_tok = torch.zeros((8,), dtype=torch.int32, device="cuda")
        decode_step(engine.params, cache, step_tok, cfg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(max_new):
            _, cache = decode_step(engine.params, cache, step_tok, cfg)
        torch.cuda.synchronize()
        decode_ms = (time.perf_counter() - t0) / max_new * 1e3
    print(f"[{tag}] prefill B=8 T={t_prompt}, median of 6: "
          f"{med['flash']:.2f} ms with the flash kernel, "
          f"{med['plain']:.2f} ms with plain attention; decode B=8: "
          f"{decode_ms:.2f} ms/token step [{card}]", flush=True)
    del engine, cache
    torch.cuda.empty_cache()
    return {"counts": counts, "prefill_ms": med["flash"],
            "prefill_plain_ms": med["plain"], "decode_ms": decode_ms,
            "served_tokens_per_s": 8 * max_new / wall,
            "flash_vs_plain_logits": flash_check,
            "kernels_vs_plain": kernel_err}


def check_train_shape(torch, fa, seed: int = 2, b: int = TRAIN_B,
                      h: int = H, T: int = TRAIN_T, d: int = D,
                      tag: str = "training shape") -> dict:
    """Hold the forward kernel (o, lse) and the backward kernels (dq,
    dk, dv) against their plain versions at a training shape (default
    GPT-2-124M's: B=24, H=12, T=1024, D=64; causal, bf16); fail if any
    disagrees.  Returns the inputs and outputs, for timing."""
    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev).manual_seed(seed)
    bh = b * h
    kw = dict(scale=1.0 / math.sqrt(d), causal=True)
    t = dict(zip(("q4", "k4", "v4", "do4"), (
        torch.randn((b, T, h, d), generator=gen, device=dev)
        .to(torch.bfloat16) for _ in range(4))))
    for n in ("q", "k", "v", "do"):
        t[f"{n}3"] = t[f"{n}4"].transpose(1, 2).reshape(bh, T, d)
    with torch.no_grad():
        q3, k3, v3, do3 = (t[n] for n in ("q3", "k3", "v3", "do3"))
        o3, lse = fa.flash_attention_fwd(q3, k3, v3, **kw)
        o_ref, lse_ref = fa.flash_attention_fwd_reference(q3, k3, v3, **kw)
        torch.cuda.synchronize()
        err_o = (o3.float() - o_ref.float()).abs().max().item()
        err_lse = (lse - lse_ref).abs().max().item()
        del o_ref, lse_ref
        print(f"[kernel-bwd] {tag} B={b} T={T} H={h} D={d} "
              f"causal bf16: forward max|o-plain| {err_o:.3e} (tol "
              f"{TOL[('bf16', 'o')]:.0e}), max|lse-plain| {err_lse:.3e} "
              f"(tol {TOL[('bf16', 'lse')]:.0e})", flush=True)
        if err_o > TOL[("bf16", "o")] or err_lse > TOL[("bf16", "lse")]:
            fail(f"the forward kernel disagrees with its plain version at "
                 f"the {tag}")
        dq, delta = fa.flash_bwd_dq(q3, k3, v3, o3, do3, lse, **kw)
        got = (dq, *fa.flash_bwd_dkv(q3, k3, v3, do3, lse, delta, **kw))
        dq_ref, delta_ref = fa.flash_bwd_dq_reference(q3, k3, v3, o3, do3,
                                                      lse, **kw)
        want = (dq_ref, *fa.flash_bwd_dkv_reference(q3, k3, v3, do3, lse,
                                                    delta_ref, **kw))
        torch.cuda.synchronize()
        cmp = [bwd_compare(g, w, "bf16") for g, w in zip(got, want)]
        dcmp = delta_compare(fa, delta, o3, do3)
        del got, want, dq, dq_ref, delta_ref
    print(f"[kernel-bwd] {tag} backward: {bwd_report(cmp)} (tol "
          f"{BWD_TOL['bf16'][0]:.0e} + {BWD_TOL['bf16'][1]:.0e}*|plain|, "
          f"rel {BWD_REL_NORM['bf16']:.0e}); delta from the dQ kernel "
          f"max|d| {dcmp['max']:.3e} ({dcmp['share']:.3f} of its bound "
          f"2 (D + 1) 2**-24 sum|dO O|)", flush=True)
    if not all(c["ok"] for c in cmp) or not dcmp["ok"]:
        fail(f"backward kernels disagree with their plain version at the "
             f"{tag}")
    t.update(o3=o3, lse=lse, delta=delta,
             err={"fwd": err_o, "dq": cmp[0]["max"],
                  "dkv": max(cmp[1]["max"], cmp[2]["max"]),
                  "delta": dcmp["max"], "delta_share": dcmp["share"]})
    return t


def phase_kernel_bwd(torch, fa, card: str, ptxas: dict) -> dict:
    F = torch.nn.functional
    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev).manual_seed(1)
    dtypes = {"bf16": torch.bfloat16, "f32": torch.float32}

    cases = [(T, d, causal, dt) for dt in ("bf16", "f32")
             for causal in (True, False) for T in (1024, 1000, 77)
             for d in (32, 64, 128)]
    with torch.no_grad():
        for T, d, causal, dt in cases:
            q3, k3, v3, do3 = (torch.randn((24, T, d), generator=gen,
                                           device=dev).to(dtypes[dt])
                               for _ in range(4))
            kw = dict(scale=d ** -0.5, causal=causal)
            o3, lse = fa.flash_attention_fwd_reference(q3, k3, v3, **kw)
            want = fa.flash_attention_bwd_reference(q3, k3, v3, o3, lse,
                                                    do3, **kw)
            dq, delta = fa.flash_bwd_dq(q3, k3, v3, o3, do3, lse, **kw)
            dk, dv = fa.flash_bwd_dkv(q3, k3, v3, do3, lse, delta, **kw)
            whole = fa.flash_attention_bwd(q3, k3, v3, o3, lse, do3, **kw)
            torch.cuda.synchronize()
            got = (dq, dk, dv)
            cmp = [bwd_compare(g, w, dt) for g, w in zip(got, want)]
            dcmp = delta_compare(fa, delta, o3, do3)
            same = all(torch.equal(a, b) for a, b in zip(whole, got))
            print(f"[kernel-bwd] BH=24 T={T} D={d} causal={causal} {dt}: "
                  f"{bwd_report(cmp)} (tol {BWD_TOL[dt][0]:.0e} + "
                  f"{BWD_TOL[dt][1]:.0e}*|plain|, rel "
                  f"{BWD_REL_NORM[dt]:.0e}); delta max|d| "
                  f"{dcmp['max']:.3e} ({dcmp['share']:.3f} of its bound); "
                  f"whole backward bit-equal to the kernels alone: {same}",
                  flush=True)
            if not all(c["ok"] for c in cmp) or not dcmp["ok"] or not same:
                fail(f"backward kernels disagree with their plain version "
                     f"at T={T} D={d} causal={causal} {dt}")
            del q3, k3, v3, do3, o3, lse, want, got, whole, dq, dk, dv, delta

    t = check_train_shape(torch, fa)
    q4, k4, v4, do4, q3, k3, v3, do3, o3, lse, delta = (
        t[n] for n in ("q4", "k4", "v4", "do4", "q3", "k3", "v3", "do3",
                       "o3", "lse", "delta"))
    err = t["err"]
    bh, T = TRAIN_B * H, TRAIN_T
    kw = dict(scale=1.0 / math.sqrt(D), causal=True)
    whole_fn = lambda: fa.flash_attention_bwd(q3, k3, v3, o3, lse, do3, **kw)
    with torch.no_grad():
        ms = {"dq": time_ms(torch, lambda: fa.flash_bwd_dq(
                  q3, k3, v3, o3, do3, lse, **kw)),
              "dkv": time_ms(torch, lambda: fa.flash_bwd_dkv(
                  q3, k3, v3, do3, lse, delta, **kw))}
        plain = {"dq": time_ms(torch, lambda: fa.flash_bwd_dq_reference(
                     q3, k3, v3, o3, do3, lse, **kw), iters=5),
                 "dkv": time_ms(torch, lambda: fa.flash_bwd_dkv_reference(
                     q3, k3, v3, do3, lse, delta, **kw), iters=5),
                 "whole": time_ms(torch, lambda: fa.
                                  flash_attention_bwd_reference(
                                      q3, k3, v3, o3, lse, do3, **kw),
                                  iters=5),
                 "fwd": time_ms(torch, lambda: fa.
                                flash_attention_fwd_reference(
                                    q3, k3, v3, **kw), iters=5)}
        # determinism at the training shape: a second call, bit-equal
        first = whole_fn()
        second = whole_fn()
        torch.cuda.synchronize()
        deterministic = all(torch.equal(a, b) for a, b in zip(first,
                                                                second))
        first = fa.flash_attention_fwd(q3, k3, v3, **kw)
        second = fa.flash_attention_fwd(q3, k3, v3, **kw)
        torch.cuda.synchronize()
        fwd_deterministic = all(torch.equal(a, b) for a, b in zip(first,
                                                                    second))
        del first, second
        qh, kh, vh, doh = (x.transpose(1, 2).contiguous()
                           for x in (q4, k4, v4, do4))
        # the forward and SDPA's forward in turns, as the backward below
        fwd_med, fwd_turns = in_turns(torch, {
            "port": lambda: fa.flash_attention_fwd(q3, k3, v3, **kw),
            "sdpa": lambda: F.scaled_dot_product_attention(
                qh, kh, vh, is_causal=True)})
        ms["fwd"], sdpa_fwd = fwd_med["port"], fwd_med["sdpa"]
    print(f"[kernel-bwd]   two calls bit-equal: whole backward (dq, dk, dv) "
          f"{deterministic}, forward (o, lse) {fwd_deterministic}",
          flush=True)
    if not deterministic or not fwd_deterministic:
        fail("the flash kernels gave different results on the same inputs")
    qh, kh, vh = (x.requires_grad_(True) for x in (qh, kh, vh))
    out = F.scaled_dot_product_attention(qh, kh, vh, is_causal=True)
    sdpa_fn = lambda: torch.autograd.grad(out, (qh, kh, vh), doh,
                                          retain_graph=True)
    # the whole backward and SDPA's backward in turns
    med, turns = in_turns(torch, {"port": whole_fn, "sdpa": sdpa_fn})
    ms["whole"] = med["port"]
    bounds = bwd_bounds_ms(bh, T, D, True, "bf16")
    fwd_bound = attention_bound_ms(T, True, "bf16", bh=bh)
    # grids: one CTA per (batch*head, block of rows), as many at once on
    # an SM as their registers allow
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    ctas = bh * -(-T // fa.BWD_BF16_CTA_ROWS)
    waves = ctas / (sms * fa.BWD_BF16_CTAS_PER_SM)
    for name in ("dq", "dkv", "whole"):
        share = bounds[name][0] / ms[name]
        grid = (f", {ctas} CTAs = {waves:.2f} waves of "
                f"{fa.BWD_BF16_CTAS_PER_SM} on each of {sms} SMs"
                if name != "whole" else "")
        print(f"[kernel-bwd]   {name:5s}: kernel {ms[name]:.4f} ms, plain "
              f"{plain[name]:.4f} ms, bound {bounds[name][0]:.4f} ms "
              f"({bounds[name][1]}, {100 * share:.1f}% of it "
              f"reached){grid} [{card}]", flush=True)
    factor = med["port"] / med["sdpa"]
    print(f"[kernel-bwd]   whole backward (dQ with delta, then dK/dV) vs "
          f"scaled_dot_product_attention's backward (dq, dk, dv), "
          f"{BWD_TURNS} rounds in turns: medians {med['port']:.4f} vs "
          f"{med['sdpa']:.4f} ms = {factor:.3f}x; port "
          f"{[round(x, 4) for x in turns['port']]}, sdpa "
          f"{[round(x, 4) for x in turns['sdpa']]} [{card}]", flush=True)
    fwd_ctas = bh * -(-T // fa.FWD_BF16_CTA_ROWS)
    fwd_waves = fwd_ctas / (sms * fa.FWD_BF16_CTAS_PER_SM)
    print(f"[kernel-bwd]   forward: kernel {ms['fwd']:.4f} ms, plain "
          f"{plain['fwd']:.4f} ms, scaled_dot_product_attention "
          f"{sdpa_fwd:.4f} ms ({ms['fwd'] / sdpa_fwd:.3f}x; medians of "
          f"{BWD_TURNS} rounds in turns, port "
          f"{[round(x, 4) for x in fwd_turns['port']]}, sdpa "
          f"{[round(x, 4) for x in fwd_turns['sdpa']]}), bound "
          f"{fwd_bound[0]:.4f} ms ({fwd_bound[1]}, "
          f"{100 * fwd_bound[0] / ms['fwd']:.1f}% of it reached), "
          f"{fwd_ctas} CTAs = {fwd_waves:.2f} waves of "
          f"{fa.FWD_BF16_CTAS_PER_SM} on each of {sms} SMs [{card}]",
          flush=True)
    whole = {"ms": ms["whole"], "plain_ms": plain["whole"],
             "bound_ms": bounds["whole"][0],
             "bound_by": bounds["whole"][1], "library_ms": med["sdpa"],
             "over_library": factor, "turns_ms": turns,
             "library": "backward of F.scaled_dot_product_attention("
                        "is_causal=True): dq, dk, dv; medians of "
                        f"{BWD_TURNS} rounds in turns"}
    kernels = {"dq": "flash_bwd_dq_bf16_kernel<64>",
               "dkv": "flash_bwd_dkv_bf16_kernel<64>"}
    records = {name: {"max_abs_err": err[name], "ms": ms[name],
                      "plain_ms": plain[name], "bound_ms": bounds[name][0],
                      "bound_by": bounds[name][1],
                      # no one PyTorch call computes dQ (or dK/dV) alone;
                      # the library's whole backward is under "whole"
                      "library_ms": None,
                      "bound_share": bounds[name][0] / ms[name],
                      "ctas": ctas, "waves": waves,
                      "ptxas": ptxas.get(kernels[name], []),
                      "whole_backward": whole}
               for name in ("dq", "dkv")}
    records["dq"]["delta_max_abs_err"] = err["delta"]
    records["dq"]["delta_bound_share"] = err["delta_share"]
    records["fwd_train_shape"] = {"ms": ms["fwd"], "plain_ms": plain["fwd"],
                                  "bound_ms": fwd_bound[0],
                                  "bound_by": fwd_bound[1],
                                  "library_ms": sdpa_fwd,
                                  "bound_share": fwd_bound[0] / ms["fwd"],
                                  "over_library": ms["fwd"] / sdpa_fwd,
                                  "turns_ms": fwd_turns,
                                  "ctas": fwd_ctas, "waves": fwd_waves}
    return records


# ---------------------------------------------------------------------------
# fused lm-head + cross-entropy kernels
# ---------------------------------------------------------------------------

def ce_inputs(torch, n, v, valid, d, dtype, seed, g=None):
    """h ~ N(0, 1) and w ~ N(0, 1/D) (logits ~ N(0, 1)), targets uniform
    over the valid vocab, g uniform or the given constant."""
    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev).manual_seed(seed)
    h = torch.randn((n, d), generator=gen, device=dev).to(dtype)
    w = (torch.randn((v, d), generator=gen, device=dev) * d ** -0.5).to(dtype)
    tgt = torch.randint(0, valid, (n,), generator=gen, device=dev,
                        dtype=torch.int32)
    gv = (torch.rand((n,), generator=gen, device=dev) if g is None
          else torch.full((n,), g, device=dev))
    return h, w, tgt, gv


def ce_compare(torch, got, want, dtype: str, kind: str) -> dict:
    """max |got - want|, the relative norm of the difference and whether
    both are within CE_OUT_TOL (kind "out": nll, lse) or CE_GRAD_TOL
    (kind "grad": dh, dw)."""
    err = (got.float() - want.float()).abs()
    rel = (err.norm() / want.float().norm()).item()
    if kind == "out":
        atol, rtol = CE_OUT_TOL
        rel_ok = True
    else:
        frac, rtol, rel_norm = CE_GRAD_TOL[dtype]
        atol = frac * want.float().square().mean().sqrt().item()
        rel_ok = rel <= rel_norm
    excess = (err - atol - rtol * want.float().abs()).max().item()
    return {"max": err.max().item(), "rel": rel,
            "ok": excess <= 0 and rel_ok and bool(got.isfinite().all())}


def check_ce_kernels(torch, fc, n, v, valid, d, dtype: str, seed: int,
                     g=None) -> dict:
    """Run the forward, dH and dW kernels once on seeded inputs and hold
    each against its plain version (dH and dW on the kernel's lse);
    fail on any disagreement.  Returns the inputs, outputs and errors."""
    dt = {"bf16": torch.bfloat16, "f32": torch.float32}[dtype]
    h, w, tgt, gv = ce_inputs(torch, n, v, valid, d, dt, seed, g)
    with torch.no_grad():
        nll, lse = fc.fused_ce_fwd(h, w, tgt, valid)
        dh = fc.fused_ce_bwd_dh(h, w, tgt, lse, gv, valid)
        dw = fc.fused_ce_bwd_dw(h, w, tgt, lse, gv, valid)
        torch.cuda.synchronize()
        want_nll, want_lse = fc.fused_ce_fwd_reference(h, w, tgt, valid)
        cmp = {"nll": ce_compare(torch, nll, want_nll, dtype, "out"),
               "lse": ce_compare(torch, lse, want_lse, dtype, "out")}
        del want_nll, want_lse
        cmp["dh"] = ce_compare(torch, dh, fc.fused_ce_bwd_dh_reference(
            h, w, tgt, lse, gv, valid), dtype, "grad")
        cmp["dw"] = ce_compare(torch, dw, fc.fused_ce_bwd_dw_reference(
            h, w, tgt, lse, gv, valid), dtype, "grad")
        tail_zero = bool((dw[valid:] == 0).all())
    print(f"[kernel-ce] N={n} V={v} valid={valid} D={d} {dtype}: " +
          ", ".join(f"{k} max|d| {c['max']:.3e} rel {c['rel']:.3e}"
                    for k, c in cmp.items()) +
          f"; dW rows past valid_vocab all 0: {tail_zero}", flush=True)
    if not all(c["ok"] for c in cmp.values()) or not tail_zero:
        fail(f"fused CE kernels disagree with their plain versions at N={n}"
             f" V={v} valid={valid} D={d} {dtype}")
    return {"h": h, "w": w, "tgt": tgt, "g": gv, "lse": lse, "cmp": cmp}


def check_ce_train_shape(torch, fc, seed: int = 3) -> dict:
    """The three fused CE kernels against their plain versions at the
    training shape (N=24576, V=50304, valid 50257, D=768, bf16, g=1/N);
    fails on any disagreement."""
    return check_ce_kernels(torch, fc, CE_N, CE_V, CE_VALID, CE_D, "bf16",
                            seed, g=1.0 / CE_N)


def ce_bounds_ms(n: int, v: int, valid: int, d: int) -> dict:
    """Least times of the three kernels on this card, bf16 operands:
    each reads h (N, D), w (valid rows used, D), the targets and
    (backward) lse and g once and writes its outputs once (nll and lse;
    dh (N, D) f32; dw (V, D) f32); the forward does 2*N*valid*D
    operations, dH and dW each 4*N*valid*D (the logits again and their
    own product)."""
    hw = (n + valid) * d * 2
    ops = 2 * n * valid * d
    return {"fwd": bound_ms(hw + n * 4 + 2 * n * 4, ops, "bf16"),
            "dh": bound_ms(hw + 3 * n * 4 + n * d * 4, 2 * ops, "bf16"),
            "dw": bound_ms(hw + 3 * n * 4 + v * d * 4, 2 * ops, "bf16")}


def time_wide_ce(torch, fc, card: str) -> dict:
    """The three kernels at the head shape of the gpt2-large step that
    phase train-ce checks (N = WIDE_B * TRAIN_T, V = 50304, D = 1280,
    bf16; dH and dW through the cluster kernel), held against their
    plain versions and timed beside their bounds and the dense
    composition (its forward for the forward, its backward for dH and
    dW together); {kernel: {"ms", "bound_ms", "bound_by", "shape",
    "max_abs_err", "rel_err", "library_ms", "dense_composition"}}."""
    from ray_tpu_torch.models.gpt2 import _LogitsMatmul, nll_from_logits

    n, d = WIDE_B * TRAIN_T, WIDE_D
    t = check_ce_kernels(torch, fc, n, CE_V, CE_VALID, d, "bf16", seed=4,
                         g=1.0 / n)
    h, w, tgt, g, lse = (t[k] for k in ("h", "w", "tgt", "g", "lse"))
    with torch.no_grad():
        ms = {"fwd": time_ms(torch, lambda: fc.fused_ce_fwd(
                  h, w, tgt, CE_VALID), iters=5),
              "dh": time_ms(torch, lambda: fc.fused_ce_bwd_dh(
                  h, w, tgt, lse, g, CE_VALID), iters=3),
              "dw": time_ms(torch, lambda: fc.fused_ce_bwd_dw(
                  h, w, tgt, lse, g, CE_VALID), iters=3)}
        dense_fwd = time_ms(torch, lambda: nll_from_logits(
            _LogitsMatmul.apply(h, w), tgt, CE_VALID, CE_V), iters=3)
    hg, wg = h.detach().requires_grad_(True), w.detach().requires_grad_(True)
    nll = nll_from_logits(_LogitsMatmul.apply(hg, wg), tgt, CE_VALID, CE_V)
    dense_bwd = time_ms(torch, lambda: torch.autograd.grad(
        nll, (hg, wg), g, retain_graph=True), iters=3)
    del nll, hg, wg
    bounds = ce_bounds_ms(n, CE_V, CE_VALID, d)
    print(f"[kernel-ce]   gpt2-large's head (N={n} V={CE_V} D={d} bf16): " +
          ", ".join(f"{k} {ms[k]:.4f} ms (bound {bounds[k][0]:.4f}, "
                    f"{100 * bounds[k][0] / ms[k]:.1f}%)" for k in ms) +
          f"; dense composition forward {dense_fwd:.4f} ms, backward (dH "
          f"and dW) {dense_bwd:.4f} ms; fused dH + dW "
          f"{(ms['dh'] + ms['dw']) / dense_bwd:.3f}x it [{card}]", flush=True)
    cmp = {"fwd": ("nll", "lse"), "dh": ("dh",), "dw": ("dw",)}
    return {k: {"ms": ms[k], "bound_ms": bounds[k][0],
                "bound_by": bounds[k][1], "shape": [n, CE_V, CE_VALID, d],
                "max_abs_err": max(t["cmp"][c]["max"] for c in cmp[k]),
                "rel_err": max(t["cmp"][c]["rel"] for c in cmp[k]),
                "library_ms": dense_fwd if k == "fwd" else None,
                "dense_composition": {"forward_ms": dense_fwd,
                                      "backward_ms": dense_bwd}}
            for k in ms}


def phase_kernel_ce(torch, fc, card: str, ptxas: dict) -> dict:
    from ray_tpu_torch.models.gpt2 import _LogitsMatmul, nll_from_logits

    for i, (n, v, valid, d) in enumerate(CE_SHAPES):
        for dtype in ("bf16", "f32"):
            check_ce_kernels(torch, fc, n, v, valid, d, dtype, seed=10 + i)
    # the cluster plan of each card-test width above 1024, and how many
    # of its clusters fit on the card at once
    for d in sorted({s[3] for s in CE_SHAPES if s[3] > 1024}):
        plan = fc.fused_ce_bwd_plan(d, fc.BWD_BLOCK_ROWS)
        print(f"[kernel-ce]   D={d}: clusters of {plan.k} CTAs holding "
              f"{plan.sc} boxes, {plan.slices} slice(s); "
              f"{fc.fused_ce_bwd_max_clusters(d, 'dh')} (dH) / "
              f"{fc.fused_ce_bwd_max_clusters(d, 'dw')} (dW) at once "
              f"[{card}]", flush=True)
    t = check_ce_train_shape(torch, fc)
    h, w, tgt, g, lse = (t[k] for k in ("h", "w", "tgt", "g", "lse"))
    a = (h, w, tgt)
    ab = (h, w, tgt, lse, g)
    valid = CE_VALID
    with torch.no_grad():
        ms = {"fwd": time_ms(torch, lambda: fc.fused_ce_fwd(*a, valid),
                             iters=10),
              "dh": time_ms(torch, lambda: fc.fused_ce_bwd_dh(*ab, valid),
                            iters=10),
              "dw": time_ms(torch, lambda: fc.fused_ce_bwd_dw(*ab, valid),
                            iters=10)}
        plain = {"fwd": time_ms(torch, lambda: fc.fused_ce_fwd_reference(
                     *a, valid), iters=2),
                 "dh": time_ms(torch, lambda: fc.fused_ce_bwd_dh_reference(
                     *ab, valid), iters=2),
                 "dw": time_ms(torch, lambda: fc.fused_ce_bwd_dw_reference(
                     *ab, valid), iters=2)}
        # the dense composition, as the dense-CE step runs it: f32
        # logits by torch.mm(out_dtype=float32), the -1e9 tail mask,
        # logsumexp and a gather (a yardstick: the fused path never
        # calls it)
        dense_fwd = time_ms(torch, lambda: nll_from_logits(
            _LogitsMatmul.apply(h, w), tgt, valid, CE_V), iters=5)
        # determinism: a second forward, bit-equal
        first, second = fc.fused_ce_fwd(*a, valid), fc.fused_ce_fwd(*a, valid)
        torch.cuda.synchronize()
        fwd_deterministic = all(torch.equal(x, y) for x, y in zip(first,
                                                                    second))
        del first, second
    print(f"[kernel-ce]   two calls of the forward bit-equal (nll, lse): "
          f"{fwd_deterministic}", flush=True)
    if not fwd_deterministic:
        fail("the fused CE forward gave different results on the same "
             "inputs")
    hg, wg = h.detach().requires_grad_(True), w.detach().requires_grad_(True)
    nll = nll_from_logits(_LogitsMatmul.apply(hg, wg), tgt, valid, CE_V)
    dense_bwd = time_ms(torch, lambda: torch.autograd.grad(
        nll, (hg, wg), g, retain_graph=True), iters=5)
    del nll, hg, wg
    bounds = ce_bounds_ms(CE_N, CE_V, valid, CE_D)
    # how many CTAs each kernel runs (the module's tiles and the
    # backward's launch plan), in waves over the card's SMs
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    # the forward's vocab splits, cut to whole groups of vocab tiles
    tiles = -(-valid // fc.FWD_TILE_ROWS)
    per_split = -(-tiles // fc.fused_ce_fwd_splits(CE_N, valid, sms))
    ctas = {"fwd": -(-CE_N // fc.FWD_BLOCK_ROWS) * -(-tiles // per_split),
            "dh": math.prod(fc.fused_ce_bwd_plan(CE_D, CE_N).grid),
            "dw": math.prod(fc.fused_ce_bwd_plan(CE_D, CE_V).grid)}
    share = {k: bounds[k][0] / ms[k] for k in ms}
    for k in ("fwd", "dh", "dw"):
        print(f"[kernel-ce]   {k:3s}: kernel {ms[k]:.4f} ms, plain "
              f"{plain[k]:.4f} ms, bound {bounds[k][0]:.4f} ms "
              f"({bounds[k][1]}, {100 * share[k]:.1f}% of it reached), "
              f"{ctas[k]} CTAs = {ctas[k] / sms:.2f} waves on {sms} SMs "
              f"[{card}]", flush=True)
    bwd_ratio = (ms["dh"] + ms["dw"]) / dense_bwd
    print(f"[kernel-ce]   dense composition: forward {dense_fwd:.4f} ms, "
          f"backward (dH and dW) {dense_bwd:.4f} ms; fused forward + dH + "
          f"dW {ms['fwd'] + ms['dh'] + ms['dw']:.4f} ms; fused dH + dW "
          f"{ms['dh'] + ms['dw']:.4f} ms = {bwd_ratio:.3f}x the dense "
          f"backward [{card}]", flush=True)
    dense = {"library": "dense CE composition: torch.mm(out_dtype="
                        "float32) logits, logsumexp, gather (dH and dW: "
                        "its backward, together)",
             "forward_ms": dense_fwd, "backward_ms": dense_bwd}
    cmp = t["cmp"]
    del h, w, tgt, g, lse, a, ab, t
    wide = time_wide_ce(torch, fc, card)
    records = {}
    for k, cmp_keys in (("fwd", ("nll", "lse")), ("dh", ("dh",)),
                        ("dw", ("dw",))):
        records[k] = {
            "max_abs_err": max(cmp[c]["max"] for c in cmp_keys),
            "ms": ms[k], "plain_ms": plain[k], "bound_ms": bounds[k][0],
            "bound_by": bounds[k][1],
            "library_ms": dense_fwd if k == "fwd" else None,
            "bound_share": share[k], "dense_composition": dense,
            "ctas": ctas[k], "waves": ctas[k] / sms,
            "wide_shape": wide[k],
            "ptxas": ptxas.get({"fwd": "fused_ce_fwd_bf16_kernel",
                                "dh": "fused_ce_bwd_bf16_kernel<1, 12>",
                                "dw": "fused_ce_bwd_bf16_kernel<2, 12>"}[k],
                               [])}
        if k != "fwd":
            records[k]["dh_plus_dw_over_dense_backward"] = bwd_ratio
    return records


def check_flash_vs_plain_step(torch, cfg) -> tuple:
    """One GPT-2 loss and gradient with the flash kernels and with
    plain attention (use_flash=False) on the same seeded weights and
    batch; fail unless the losses, the gradient norms and the q, k, v
    parts of the qkv_w gradient agree.  Returns (params, batch,
    {"flash": health, "plain": health})."""
    from ray_tpu_torch.models.gpt2 import gpt2_init, gpt2_loss
    from ray_tpu_torch.train.optim import tree_leaves, tree_unflatten

    gen = torch.Generator(device="cuda").manual_seed(0)
    params = gpt2_init(cfg, gen, device="cuda")
    tokens = torch.randint(0, cfg.vocab_size, (TRAIN_B, TRAIN_T + 1),
                           generator=gen, device="cuda")
    batch = {"tokens": tokens}
    health, qkv_grad = {}, {}
    for name, flash in (("flash", True), ("plain", False)):
        c = dataclasses.replace(cfg, use_flash=flash)
        live = [x.detach().requires_grad_(True)
                for x in tree_leaves(params)]
        loss = gpt2_loss(tree_unflatten(params, live), batch, c)
        grads = torch.autograd.grad(loss, live)
        health[name] = {"loss": loss.item(), "grad_norm": torch.stack(
            [g.float().square().sum() for g in grads]).sum().sqrt().item(),
            "nonfinite": sum(int((~g.isfinite()).sum()) for g in grads)}
        qkv_grad[name] = tree_unflatten(params, list(grads))[
            "blocks"]["attn"]["qkv_w"].float()
        del loss, grads, live
    dl = abs(health["flash"]["loss"] - health["plain"]["loss"])
    dg = abs(health["flash"]["grad_norm"] - health["plain"]["grad_norm"]) \
        / health["plain"]["grad_norm"]
    # qkv_w is (L, d, 3, h, hd): its q, k and v columns get their
    # gradient only through dQ, dK and dV, so each part is compared
    # alone (a kernel that dropped dK moves the k part by 1)
    dqkv = {n: ((qkv_grad["flash"][:, :, i] - qkv_grad["plain"][:, :, i])
                .norm() / qkv_grad["plain"][:, :, i].norm()).item()
            for i, n in enumerate("qkv")}
    print(f"[train] one step, flash kernels vs plain attention: loss "
          f"{health['flash']['loss']:.5f} vs {health['plain']['loss']:.5f}"
          f" (|diff| {dl:.3e}, tol {TRAIN_LOSS_TOL}), grad norm "
          f"{health['flash']['grad_norm']:.5f} vs "
          f"{health['plain']['grad_norm']:.5f} (rel diff {dg:.3e}, tol "
          f"{TRAIN_GRAD_NORM_RTOL}), qkv_w gradient ||flash - plain|| / "
          f"||plain|| of its q, k, v parts " + ", ".join(
              f"{n} {x:.3e}" for n, x in dqkv.items()) +
          f" (tol {TRAIN_QKV_GRAD_RTOL}), nonfinite "
          f"{health['flash']['nonfinite']}/{health['plain']['nonfinite']}",
          flush=True)
    if dl > TRAIN_LOSS_TOL or dg > TRAIN_GRAD_NORM_RTOL or \
            max(dqkv.values()) > TRAIN_QKV_GRAD_RTOL or \
            health["flash"]["nonfinite"] or health["plain"]["nonfinite"]:
        fail("the flash and plain-attention steps disagree")
    return params, batch, health


def profile_step(torch, state: dict, name: str, step_ms: float,
                 card: str, tag: str = "train") -> dict:
    """Profile one step of ``state[name]`` ([step, params, opt_state])
    with torch.profiler (CUPTI) and print its device time by kind and
    its largest kernels; returns {kind: ms}."""
    step, p, s = state[name]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        state[name][1:] = step(p, s, state["batch"])[:2]
        torch.cuda.synchronize()
    # kernels and copies themselves, not the host ops that launch them
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in events) / 1e3
    print(f"[{tag}] profile of one {name} step: {device_ms:.2f} ms of "
          f"device time in {len(events)} distinct kernels, "
          f"{device_ms / step_ms:.3f} of the unprofiled median step "
          f"({step_ms:.2f} ms) [{card}]", flush=True)
    kinds = {}
    for e in events:
        kind = next((k for k, marks in PROFILE_KINDS if any(
            m in e.key for m in marks)), "other elementwise")
        kinds[kind] = kinds.get(kind, 0.0) + e.self_device_time_total / 1e3
    print(f"[{tag}]   {name} step by kind: " + ", ".join(
        f"{k} {v:.2f} ms" for k, v in sorted(kinds.items(),
                                              key=lambda kv: -kv[1])),
          flush=True)
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"[{tag}]   {e.self_device_time_total / 1e3:8.3f} ms "
              f"x{e.count:<5d} {e.key[:90]}", flush=True)
    return kinds


def loss_of(cfg):
    """The loss function of cfg's family (gpt2_loss or llama_loss)."""
    from ray_tpu_torch.models.gpt2 import gpt2_loss
    from ray_tpu_torch.models.llama import LlamaConfig, llama_loss

    return llama_loss if isinstance(cfg, LlamaConfig) else gpt2_loss


def head_grad(grads: dict, cfg):
    """The lm head's gradient, vocab-major (V, D) float32: GPT-2's tied
    wte (its input rows carry the embedding's gradient too), llama's
    untied lm_head transposed (all of it comes from the CE)."""
    from ray_tpu_torch.models.llama import LlamaConfig

    if isinstance(cfg, LlamaConfig):
        return grads["lm_head"].t().float()
    return grads["wte"].float()


def interleaved_steps(torch, params, batch, cfgs: dict, order) -> tuple:
    """AdamW steps of each config in ``cfgs``, each from its own copy of
    ``params``, run in ``order`` (names of cfgs); returns (the steps'
    state for profile_step, {name: [wall seconds]})."""
    from ray_tpu_torch.train import adamw, build_train_step
    from ray_tpu_torch.train.optim import tree_map

    tx = adamw(3e-4, weight_decay=0.1)
    state = {"batch": batch}
    for name, c in cfgs.items():
        p = tree_map(torch.clone, params)
        state[name] = [build_train_step(
            lambda p, b, c=c: loss_of(c)(p, b, c), tx), p, tx.init(p)]
    wall = {name: [] for name in cfgs}
    for name in order:
        step, p, s = state[name]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state[name][1:] = step(p, s, batch)[:2]
        torch.cuda.synchronize()
        wall[name].append(time.perf_counter() - t0)
    return state, wall


def run_main_path(torch, fa, card: str, tag: str, per_step: dict,
                  **overrides) -> dict:
    """The main path of a training phase: bench.py's GPT-2 step (B=24,
    T=1024, remat mlp_only, ``overrides``) through time_config, 5 timed
    steps after one warm-up, launch counters zeroed just before and
    read just after (``per_step`` launches of each kernel per step
    expected), the loss finite and falling, the peak memory."""
    from ray_tpu_torch.bench import time_config

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(fa)
    tok_s, mfu, _, _, cost = time_config(
        TRAIN_B, seq=TRAIN_T, n_steps=5, remat_policy="mlp_only",
        **overrides)
    torch.cuda.synchronize()
    counts = read_counts(fa)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    runs = cost["steps_run"]
    losses = cost["losses"]
    want = {k: n * runs for k, n in per_step.items()}
    print(f"[{tag}] GPT-2-124M, B={TRAIN_B} T={TRAIN_T}, remat mlp_only, "
          f"{overrides or 'dense CE'}: {runs} steps launched {counts} "
          f"(expected {per_step} per step); losses "
          f"{[round(x, 4) for x in losses]}", flush=True)
    if counts != want:
        fail(f"kernel launches {counts} over {runs} steps, expected {want}")
    if not all(math.isfinite(x) for x in losses) or \
            not losses[-1] < losses[0]:
        fail(f"the loss is not finite and falling: {losses}")
    print(f"[{tag}] 5 timed steps: {cost['step_ms']:.2f} ms/step, "
          f"{tok_s:.1f} tokens/s, MFU {mfu:.4f} (6*N*tokens/s against "
          f"989 TFLOP/s); peak memory {peak_gib:.2f} GiB "
          f"(max_memory_allocated) [{card}]", flush=True)
    return {"counts": counts, "steps_run": runs,
            "step_ms": cost["step_ms"], "tokens_per_s": tok_s, "mfu": mfu,
            "losses": losses, "peak_gib": peak_gib}


def report_medians(result: dict, wall: dict, tag: str, card: str,
                   n_params: int = 0,
                   tokens: int = TRAIN_B * TRAIN_T) -> None:
    """Median wall time, tokens/s and MFU of each interleaved step
    (default: GPT-2-124M's parameters and batch)."""
    from ray_tpu_torch.bench import H100_BF16_PEAK_FLOPS
    from ray_tpu_torch.models.gpt2 import gpt2_config, gpt2_param_count

    n_params = n_params or gpt2_param_count(gpt2_config("gpt2"))
    for name, secs in wall.items():
        med = sorted(secs)[len(secs) // 2]
        tps = tokens / med
        result[f"{name}_step_ms"] = med * 1e3
        print(f"[{tag}] {name:6s} step, median of {len(secs)} in turns: "
              f"{med * 1e3:.2f} ms, {tps:.1f} tokens/s, MFU "
              f"{6 * n_params * tps / H100_BF16_PEAK_FLOPS:.4f} [{card}]",
              flush=True)


def phase_train(torch, fa, card: str) -> dict:
    from ray_tpu_torch.models.gpt2 import gpt2_config

    cfg = gpt2_config("gpt2", max_seq=TRAIN_T, remat_policy="mlp_only")
    L = cfg.n_layer
    # the main path: bench.py's GPT-2 step (remat mlp_only, dense CE)
    result = run_main_path(torch, fa, card, "train", {
        "flash_fwd": L, "flash_bwd_dq": L, "flash_bwd_dkv": L})
    params, batch, health = check_flash_vs_plain_step(torch, cfg)
    cfgs = {"flash": cfg, "plain": dataclasses.replace(cfg,
                                                       use_flash=False)}
    # the two steps in turns (flash, plain, plain, flash, ...)
    state, wall = interleaved_steps(torch, params, batch, cfgs,
                                    ["flash", "plain", "plain", "flash"] * 2)
    # where one flash step's device time goes (torch.profiler, CUPTI)
    flash_ms = sorted(wall["flash"])[len(wall["flash"]) // 2] * 1e3
    profile_step(torch, state, "flash", flash_ms, card)

    result["health"] = health
    report_medians(result, wall, "train", card)
    return result


def one_step(torch, fa, params, batch, cfg) -> dict:
    """One loss and gradient of ``cfg`` on ``params`` and ``batch``: the
    loss, the global gradient norm, the nonfinite count, the head's
    gradient (head_grad), the kernel launches (counters zeroed just
    before) and the step's peak memory."""
    from ray_tpu_torch.train.optim import tree_leaves, tree_unflatten

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(fa)
    live = [x.detach().requires_grad_(True) for x in tree_leaves(params)]
    loss = loss_of(cfg)(tree_unflatten(params, live), batch, cfg)
    grads = torch.autograd.grad(loss, live)
    torch.cuda.synchronize()
    out = {"loss": loss.item(), "grad_norm": torch.stack(
        [g.float().square().sum() for g in grads]).sum().sqrt().item(),
        "nonfinite": sum(int((~g.isfinite()).sum()) for g in grads),
        "head_grad": head_grad(tree_unflatten(params, list(grads)), cfg),
        "counts": read_counts(fa),
        "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    del loss, grads, live
    return out


#: the steps of phase train-ce: name -> (GPT2Config overrides, the
#: steps it is checked against); every one at B=24, T=1024 on the same
#: weights and batch.  streaming_xla is held against pallas too: both
#: keep the wte gradient in f32.
CE_STEPS = {
    "dense": (dict(ce_impl="dense"), ()),
    "pallas": (dict(ce_impl="pallas"), ("dense",)),
    "streaming_xla": (dict(ce_impl="streaming_xla"), ("dense", "pallas")),
    "dots": (dict(ce_impl="pallas", remat_policy="dots"), ("pallas",)),
    "dots_nb": (dict(ce_impl="pallas", remat_policy="dots_nb"),
                ("pallas",)),
    "attn_out": (dict(ce_impl="pallas", remat_policy="attn_out"),
                 ("pallas",)),
}


def compare_steps(st: dict, r: dict, ref: str, head_only,
                  head_tol=None) -> tuple:
    """One step against its reference step ``r`` (named ``ref``): loss,
    relative gradient norm, ||head grad - reference|| / ||reference||
    over all rows and over the head-only rows.  GPT-2 (``head_only`` a
    row mask of the tied wte): tolerances CE_LOSS_TOL,
    CE_GRAD_NORM_RTOL, CE_WTE_GRAD_RTOL over all rows and
    CE_HEAD_GRAD_RTOL over the head-only rows.  llama (``head_only``
    None: every row of the untied lm_head is the head's): the loss and
    gradient norm tolerances, and ``head_tol`` over the lm_head.
    Returns (the numbers, a line of text, whether all are within)."""
    dl = abs(st["loss"] - r["loss"])
    dg = abs(st["grad_norm"] - r["grad_norm"]) / r["grad_norm"]
    diff = st["head_grad"] - r["head_grad"]
    dw = (diff.norm() / r["head_grad"].norm()).item()
    text = (f"; vs {ref}: loss |diff| {dl:.3e} (tol {CE_LOSS_TOL}), grad "
            f"norm rel diff {dg:.3e} (tol {CE_GRAD_NORM_RTOL}), ")
    ok = dl <= CE_LOSS_TOL and dg <= CE_GRAD_NORM_RTOL
    if head_only is None:
        text += (f"||lm_head grad - {ref}|| / ||{ref}|| {dw:.3e} (tol "
                 f"{head_tol})")
        return ({"loss_diff": dl, "grad_norm_rel": dg,
                 "lm_head_grad_rel": dw}, text, ok and dw <= head_tol)
    dh = (diff[head_only].norm() / r["head_grad"][head_only].norm()).item()
    head_tol = CE_HEAD_GRAD_RTOL["dense" if ref == "dense" else "f32"]
    text += (f"||wte grad - {ref}|| / ||{ref}|| {dw:.3e} (tol "
             f"{CE_WTE_GRAD_RTOL}), on the {int(head_only.sum())} head-only "
             f"rows {dh:.3e} (tol {head_tol})")
    ok = ok and dw <= CE_WTE_GRAD_RTOL and dh <= head_tol
    return ({"loss_diff": dl, "grad_norm_rel": dg, "wte_grad_rel": dw,
             "head_rows_rel": dh}, text, ok)


def check_ce_and_remat_steps(torch, fa, cfg, spec=None,
                             batch_rows: int = TRAIN_B) -> tuple:
    """One step of each ``spec`` entry (default CE_STEPS) on the same
    seeded weights and a batch of ``batch_rows`` x TRAIN_T tokens, each
    against its reference step (loss, gradient norm, wte gradient over
    all rows and over the head-only rows) and for its launches: one of
    each flash kernel per layer under mlp_only, two forwards and one of
    each backward under the selective policies (the per-layer counts of
    the CPU test test_flash_calls_per_step_follow_remat), 1 of each
    fused CE kernel with ce_impl="pallas" and none otherwise.  Returns
    (params, batch, {name: step})."""
    from ray_tpu_torch.models.gpt2 import gpt2_init

    gen = torch.Generator(device="cuda").manual_seed(1)
    params = gpt2_init(cfg, gen, device="cuda")
    batch = {"tokens": torch.randint(0, cfg.vocab_size,
                                     (batch_rows, TRAIN_T + 1),
                                     generator=gen, device="cuda")}
    head_only = torch.ones(cfg.padded_vocab, dtype=torch.bool,
                           device="cuda")
    head_only[batch["tokens"][:, :-1].flatten()] = False
    L = cfg.n_layer
    steps, bad = {}, []
    for name, (kw, refs) in (spec or CE_STEPS).items():
        c = dataclasses.replace(cfg, **kw)
        st = one_step(torch, fa, params, batch, c)
        steps[name] = st
        fwd = 2 * L if c.remat_policy in ("dots", "dots_nb", "attn_out") \
            else L
        want = {"flash_fwd": fwd, "flash_bwd_dq": L, "flash_bwd_dkv": L}
        if c.ce_impl == "pallas":
            want.update(fused_ce_fwd=1, fused_ce_bwd_dh=1,
                        fused_ce_bwd_dw=1)
        line = (f"[train-ce] one step, d_model {c.d_model}, {L} layers, "
                f"B={batch_rows}, ce {c.ce_impl}, remat "
                f"{c.remat_policy}: loss {st['loss']:.5f}, grad norm "
                f"{st['grad_norm']:.5f}, nonfinite {st['nonfinite']}, "
                f"peak memory {st['peak_gib']:.2f} GiB; launches "
                f"{st['counts']}")
        if st["counts"] != want:
            bad.append(f"{name}: launches {st['counts']}, expected {want}")
        if st["nonfinite"]:
            bad.append(f"{name}: {st['nonfinite']} nonfinite gradients")
        st["vs"] = {}
        for ref in refs:
            vs, text, ok = compare_steps(st, steps[ref], ref, head_only)
            st["vs"][ref] = vs
            line += text
            if not ok:
                bad.append(f"{name} disagrees with {ref}")
        print(line, flush=True)
    for st in steps.values():
        del st["head_grad"]
    if bad:
        fail("; ".join(bad))
    return params, batch, steps


#: the steps of the gpt2-large-width check
WIDE_STEPS = {name: CE_STEPS[name] for name in ("dense", "pallas")}


def check_wide_ce_step(torch, fa) -> dict:
    """One dense and one ce_impl="pallas" step of gpt2-large's width at
    reduced depth on the same weights and batch, checked against each
    other as check_ce_and_remat_steps does; fails on a disagreement."""
    from ray_tpu_torch.models.gpt2 import gpt2_config

    cfg = gpt2_config(WIDE_PRESET, n_layer=WIDE_LAYERS, max_seq=TRAIN_T,
                      remat_policy="mlp_only", ce_impl="dense")
    _, _, steps = check_ce_and_remat_steps(torch, fa, cfg, WIDE_STEPS,
                                           WIDE_B)
    return steps


def phase_train_ce(torch, fa, card: str) -> dict:
    from ray_tpu_torch.models.gpt2 import gpt2_config

    cfg = gpt2_config("gpt2", max_seq=TRAIN_T, remat_policy="mlp_only",
                      ce_impl="pallas")
    L = cfg.n_layer
    # the main path: bench.py's GPT-2 step through the fused CE kernels
    result = run_main_path(torch, fa, card, "train-ce", {
        "flash_fwd": L, "flash_bwd_dq": L, "flash_bwd_dkv": L,
        "fused_ce_fwd": 1, "fused_ce_bwd_dh": 1, "fused_ce_bwd_dw": 1},
        ce_impl="pallas")

    params, batch, steps = check_ce_and_remat_steps(
        torch, fa, dataclasses.replace(cfg, ce_impl="dense"))
    cfgs = {"dense": dataclasses.replace(cfg, ce_impl="dense"),
            "pallas": cfg}
    # the two steps in turns (dense, pallas, pallas, dense, ...)
    state, wall = interleaved_steps(torch, params, batch, cfgs,
                                    ["dense", "pallas", "pallas",
                                     "dense"] * 2)
    result["steps"] = steps
    report_medians(result, wall, "train-ce", card)
    result["wide_steps"] = check_wide_ce_step(torch, fa)
    result["profile"] = profile_step(torch, state, "pallas",
                                     result["pallas_step_ms"], card)
    return result


# ---------------------------------------------------------------------------
# the llama family
# ---------------------------------------------------------------------------

#: llama-1b (16 layers, 32 query / 8 KV heads of 64, d_model 2048, d_ff
#: 5504, vocab 32,000) trained at its max_seq: B=8, T=2048, remat of the
#: whole block, ce_impl="pallas"
LLAMA_PRESET, LLAMA_B, LLAMA_T, LLAMA_TIMED_STEPS = "llama-1b", 8, 2048, 5
#: llama-7b's width (d_model 4096, 32/32 heads of 128, d_ff 11008), depth
#: cut to 2 layers, B=2
LLAMA_WIDE_PRESET, LLAMA_WIDE_LAYERS, LLAMA_WIDE_B = "llama-7b", 2, 2
#: the lm_head gradient of one llama step against another on the same
#: weights and batch (compare_steps' head_tol), ||diff|| / ||ref||:
#: "dense" between the fused CE and the dense CE, whose backward rounds
#: dW to bf16 where the fused kernels keep it f32 (the hidden states are
#: the same): each element within a bf16 rounding (2**-9 relative), so
#: the norm well under 1e-2 (1.66e-3 on an H100 at llama-1b and at
#: llama-7b's width); "plain" between flash and plain attention,
#: whose hidden states differ by the bf16 rounding of P in every layer:
#: the bound of the GPT-2 flash-vs-plain step's q, k, v gradient parts
#: (TRAIN_QKV_GRAD_RTOL; 2.7e-2 on an H100 at llama-1b)
LLAMA_HEAD_GRAD_RTOL = {"dense": 1e-2, "plain": TRAIN_QKV_GRAD_RTOL}
#: the steps held against each other: name -> (LlamaConfig overrides,
#: the steps it is checked against)
LLAMA_STEPS = {"pallas": (dict(ce_impl="pallas"), ()),
               "dense": (dict(ce_impl="dense"), ("pallas",)),
               "plain": (dict(ce_impl="pallas", use_flash=False),
                         ("pallas",))}
LLAMA_WIDE_STEPS = {"dense": (dict(ce_impl="dense"), ()),
                    "pallas": (dict(ce_impl="pallas"), ("dense",))}


def llama_step_counts(cfg) -> dict:
    """Kernel launches of one llama loss and gradient: the flash forward
    twice a layer (remat recomputes the whole block), dQ and dK/dV once;
    none with plain attention; each fused-CE kernel once with
    ce_impl="pallas"."""
    L = cfg.n_layer if cfg.use_flash is not False else 0
    want = {"flash_fwd": 2 * L, "flash_bwd_dq": L, "flash_bwd_dkv": L}
    if cfg.ce_impl == "pallas":
        want.update(fused_ce_fwd=1, fused_ce_bwd_dh=1, fused_ce_bwd_dw=1)
    return want


def check_llama_steps(torch, fa, cfg, spec: dict, batch_rows: int,
                      seed: int, tag: str) -> tuple:
    """One loss and gradient of each ``spec`` entry on the same seeded
    llama weights and a batch of ``batch_rows`` x LLAMA_T tokens, each
    checked for its launches (llama_step_counts) and against its
    reference steps (compare_steps over the untied lm_head, tolerance
    LLAMA_HEAD_GRAD_RTOL); fails on any disagreement.  Returns (params,
    batch, {name: step})."""
    from ray_tpu_torch.models.llama import llama_init

    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = llama_init(cfg, gen, device="cuda")
    batch = {"tokens": torch.randint(0, cfg.vocab_size,
                                     (batch_rows, LLAMA_T + 1),
                                     generator=gen, device="cuda")}
    steps, bad = {}, []
    for name, (kw, refs) in spec.items():
        c = dataclasses.replace(cfg, **kw)
        st = one_step(torch, fa, params, batch, c)
        steps[name] = st
        want = llama_step_counts(c)
        line = (f"[{tag}] one step, d_model {c.d_model}, {c.n_layer} "
                f"layers, B={batch_rows} T={LLAMA_T}, ce {c.ce_impl}, "
                f"flash {c.use_flash is not False}: loss {st['loss']:.5f}, "
                f"grad norm {st['grad_norm']:.5f}, nonfinite "
                f"{st['nonfinite']}, peak memory {st['peak_gib']:.2f} GiB; "
                f"launches {st['counts']}")
        if st["counts"] != want:
            bad.append(f"{name}: launches {st['counts']}, expected {want}")
        if st["nonfinite"]:
            bad.append(f"{name}: {st['nonfinite']} nonfinite gradients")
        st["vs"] = {}
        for ref in refs:
            kind = "plain" if "plain" in (name, ref) else "dense"
            vs, text, ok = compare_steps(st, steps[ref], ref, None,
                                         LLAMA_HEAD_GRAD_RTOL[kind])
            st["vs"][ref] = vs
            line += text
            if not ok:
                bad.append(f"{name} disagrees with {ref}")
        print(line, flush=True)
    for st in steps.values():
        del st["head_grad"]
    if bad:
        fail("; ".join(bad))
    return params, batch, steps


def llama_main_path(torch, fa, cfg, card: str) -> dict:
    """The main path of phase train-llama: AdamW steps
    (``adamw(3e-4, weight_decay=0.1)``) of ``cfg`` at B=LLAMA_B,
    T=LLAMA_T on one repeated batch of seeded tokens through
    build_train_step, a warm-up step and LLAMA_TIMED_STEPS timed ones
    (host clock around synchronised steps, as time_config), the launch
    counters zeroed just before and read just after, the loss finite and
    falling, the peak memory."""
    from ray_tpu_torch.bench import H100_BF16_PEAK_FLOPS
    from ray_tpu_torch.models.llama import (llama_init, llama_loss,
                                            llama_param_count)
    from ray_tpu_torch.train import adamw, build_train_step

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = llama_init(cfg, gen, device="cuda")
    tx = adamw(3e-4, weight_decay=0.1)
    opt_state = tx.init(params)
    step = build_train_step(lambda p, b: llama_loss(p, b, cfg), tx)
    batch = {"tokens": torch.randint(0, cfg.vocab_size,
                                     (LLAMA_B, LLAMA_T + 1), generator=gen,
                                     device="cuda")}
    zero_counts(fa)
    params, opt_state, loss = step(params, opt_state, batch)
    losses = [loss]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(LLAMA_TIMED_STEPS):
        params, opt_state, loss = step(params, opt_state, batch)
        losses.append(loss)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = read_counts(fa)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = [float(x) for x in losses]
    runs = LLAMA_TIMED_STEPS + 1
    per_step = llama_step_counts(cfg)
    want = {k: n * runs for k, n in per_step.items()}
    n_params = llama_param_count(cfg)
    tok_s = LLAMA_B * LLAMA_T * LLAMA_TIMED_STEPS / dt
    mfu = 6 * n_params * tok_s / H100_BF16_PEAK_FLOPS
    print(f"[train-llama] {LLAMA_PRESET}, B={LLAMA_B} T={LLAMA_T}, remat "
          f"(whole block), ce {cfg.ce_impl}: {runs} steps launched {counts}"
          f" (expected {per_step} per step); losses "
          f"{[round(x, 4) for x in losses]}", flush=True)
    if counts != want:
        fail(f"kernel launches {counts} over {runs} steps, expected {want}")
    if not all(math.isfinite(x) for x in losses) or \
            not losses[-1] < losses[0]:
        fail(f"the loss is not finite and falling: {losses}")
    print(f"[train-llama] {LLAMA_TIMED_STEPS} timed steps: "
          f"{dt / LLAMA_TIMED_STEPS * 1e3:.2f} ms/step, {tok_s:.1f} "
          f"tokens/s, MFU {mfu:.4f} (6*N*tokens/s against 989 TFLOP/s, N = "
          f"{n_params} counting both embedding tables); peak memory "
          f"{peak_gib:.2f} GiB (max_memory_allocated) [{card}]", flush=True)
    del params, opt_state, step, batch
    torch.cuda.empty_cache()
    return {"counts": counts, "steps_run": runs,
            "step_ms": dt / LLAMA_TIMED_STEPS * 1e3, "tokens_per_s": tok_s,
            "mfu": mfu, "n_params": n_params, "losses": losses,
            "peak_gib": peak_gib}


def time_llama_ce(torch, fc, card: str, cfg) -> dict:
    """The fused-CE kernels at llama-1b's head (N = B*T = 16,384, V =
    valid = 32,000, D = 2048, bf16, g = 1/N; dH and dW through the
    cluster kernel): held against their plain versions, timed beside
    them, their bounds and the dense composition; dH and dW bit-equal
    across two launches; the backward's launch plan, CTAs, clusters that
    fit at once (cudaOccupancyMaxActiveClusters) and waves."""
    from ray_tpu_torch.models.gpt2 import _LogitsMatmul, nll_from_logits

    n, v, d = LLAMA_B * LLAMA_T, cfg.padded_vocab, cfg.d_model
    t = check_ce_kernels(torch, fc, n, v, cfg.vocab_size, d, "bf16",
                         seed=7, g=1.0 / n)
    h, w, tgt, g, lse = (t[k] for k in ("h", "w", "tgt", "g", "lse"))
    a, ab, valid = (h, w, tgt), (h, w, tgt, lse, g), cfg.vocab_size
    with torch.no_grad():
        ms = {"fwd": time_ms(torch, lambda: fc.fused_ce_fwd(*a, valid),
                             iters=5),
              "dh": time_ms(torch, lambda: fc.fused_ce_bwd_dh(*ab, valid),
                            iters=3),
              "dw": time_ms(torch, lambda: fc.fused_ce_bwd_dw(*ab, valid),
                            iters=3)}
        plain = {"fwd": time_ms(torch, lambda: fc.fused_ce_fwd_reference(
                     *a, valid), iters=1),
                 "dh": time_ms(torch, lambda: fc.fused_ce_bwd_dh_reference(
                     *ab, valid), iters=1),
                 "dw": time_ms(torch, lambda: fc.fused_ce_bwd_dw_reference(
                     *ab, valid), iters=1)}
        dense_fwd = time_ms(torch, lambda: nll_from_logits(
            _LogitsMatmul.apply(h, w), tgt, valid, v), iters=3)
    hg, wg = h.detach().requires_grad_(True), w.detach().requires_grad_(True)
    nll = nll_from_logits(_LogitsMatmul.apply(hg, wg), tgt, valid, v)
    dense_bwd = time_ms(torch, lambda: torch.autograd.grad(
        nll, (hg, wg), g, retain_graph=True), iters=3)
    del nll, hg, wg
    # the cluster kernel: each output element is summed in one fixed
    # order (the partials in rank order), so two launches give the same
    # bits
    with torch.no_grad():
        first, again = ((fc.fused_ce_bwd_dh(*ab, valid),
                         fc.fused_ce_bwd_dw(*ab, valid)) for _ in range(2))
        torch.cuda.synchronize()
        bit_equal = all(torch.equal(x, y) for x, y in zip(first, again))
        del first, again
    print(f"[train-llama]   dH and dW at llama-1b's head, two launches "
          f"bit-equal: {bit_equal}", flush=True)
    if not bit_equal:
        fail("the cluster dH/dW kernels gave different bits on the same "
             "inputs")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    launch = {}
    for k, rows in (("dh", n), ("dw", v)):
        plan = fc.fused_ce_bwd_plan(d, rows)
        ctas = math.prod(plan.grid)
        at_once = fc.fused_ce_bwd_max_clusters(d, k) * plan.k
        launch[k] = {"plan": plan._asdict(), "ctas": ctas,
                     "ctas_at_once": at_once, "waves": ctas / at_once}
        print(f"[train-llama]   {k} launch plan: {plan.kernel} kernel, "
              f"{plan.k} CTAs a cluster of {plan.c} boxes each, "
              f"{plan.slices} slice(s), grid {plan.grid}: {ctas} CTAs, "
              f"{at_once} at once on {sms} SMs (max active clusters "
              f"{at_once // plan.k}) = {ctas / at_once:.2f} waves [{card}]",
              flush=True)
    bounds = ce_bounds_ms(n, v, valid, d)
    out = {}
    for k, cmp_keys in (("fwd", ("nll", "lse")), ("dh", ("dh",)),
                        ("dw", ("dw",))):
        out[k] = {"shape": [n, v, valid, d],
                  "max_abs_err": max(t["cmp"][c]["max"] for c in cmp_keys),
                  "ms": ms[k], "plain_ms": plain[k],
                  "bound_ms": bounds[k][0], "bound_by": bounds[k][1],
                  "bound_share": bounds[k][0] / ms[k],
                  "library_ms": dense_fwd if k == "fwd" else None,
                  "dense_composition": {"forward_ms": dense_fwd,
                                        "backward_ms": dense_bwd},
                  **({"launch": launch[k], "bit_equal_relaunch": bit_equal}
                     if k in launch else {})}
        print(f"[train-llama]   {k:3s} at llama-1b's head (N={n} V={v} "
              f"D={d} bf16): kernel {ms[k]:.4f} ms, plain {plain[k]:.4f} "
              f"ms, bound {bounds[k][0]:.4f} ms ({bounds[k][1]}, "
              f"{100 * bounds[k][0] / ms[k]:.1f}% of it reached) [{card}]",
              flush=True)
    print(f"[train-llama]   dense composition at llama-1b's head: forward "
          f"{dense_fwd:.4f} ms, backward (dH and dW) {dense_bwd:.4f} ms; "
          f"fused dH + dW {ms['dh'] + ms['dw']:.4f} ms = "
          f"{(ms['dh'] + ms['dw']) / dense_bwd:.3f}x the dense backward "
          f"[{card}]", flush=True)
    return out


def time_llama_flash(torch, fa, card: str, cfg) -> dict:
    """The flash kernels at llama-1b's attention (B=8, H=32 query heads
    over the repeated KV heads, T=2048, D=64, causal, bf16): held
    against their plain versions (check_train_shape), timed beside them
    and their bounds, the forward and the whole backward against
    scaled_dot_product_attention's in turns."""
    F = torch.nn.functional
    b, h, T, d = LLAMA_B, cfg.n_head, LLAMA_T, cfg.head_dim
    t = check_train_shape(torch, fa, seed=8, b=b, h=h, T=T, d=d,
                          tag="llama-1b shape")
    q4, k4, v4, do4, q3, k3, v3, do3, o3, lse, delta = (
        t[n] for n in ("q4", "k4", "v4", "do4", "q3", "k3", "v3", "do3",
                       "o3", "lse", "delta"))
    kw = dict(scale=1.0 / math.sqrt(d), causal=True)
    with torch.no_grad():
        ms = {"dq": time_ms(torch, lambda: fa.flash_bwd_dq(
                  q3, k3, v3, o3, do3, lse, **kw)),
              "dkv": time_ms(torch, lambda: fa.flash_bwd_dkv(
                  q3, k3, v3, do3, lse, delta, **kw))}
        plain = {"fwd": time_ms(torch, lambda: fa.
                                flash_attention_fwd_reference(q3, k3, v3,
                                                              **kw),
                                iters=1),
                 "whole": time_ms(torch, lambda: fa.
                                  flash_attention_bwd_reference(
                                      q3, k3, v3, o3, lse, do3, **kw),
                                  iters=1)}
        qh, kh, vh, doh = (x.transpose(1, 2).contiguous()
                           for x in (q4, k4, v4, do4))
        fwd_med, fwd_turns = in_turns(torch, {
            "port": lambda: fa.flash_attention_fwd(q3, k3, v3, **kw),
            "sdpa": lambda: F.scaled_dot_product_attention(
                qh, kh, vh, is_causal=True)})
    qh, kh, vh = (x.requires_grad_(True) for x in (qh, kh, vh))
    out = F.scaled_dot_product_attention(qh, kh, vh, is_causal=True)
    med, turns = in_turns(torch, {
        "port": lambda: fa.flash_attention_bwd(q3, k3, v3, o3, lse, do3,
                                               **kw),
        "sdpa": lambda: torch.autograd.grad(out, (qh, kh, vh), doh,
                                            retain_graph=True)})
    ms.update(fwd=fwd_med["port"], whole=med["port"])
    bh = b * h
    bounds = dict(bwd_bounds_ms(bh, T, d, True, "bf16"),
                  fwd=attention_bound_ms(T, True, "bf16", bh=bh, d=d))
    library = {"fwd": fwd_med["sdpa"], "whole": med["sdpa"]}
    recs = {}
    for k in ("fwd", "dq", "dkv", "whole"):
        recs[k] = {"shape": [b, h, T, d], "ms": ms[k],
                   "plain_ms": plain.get(k), "bound_ms": bounds[k][0],
                   "bound_by": bounds[k][1],
                   "bound_share": bounds[k][0] / ms[k],
                   "library_ms": library.get(k),
                   "max_abs_err": t["err"].get(k)}
        lib = (f", scaled_dot_product_attention {library[k]:.4f} ms "
               f"({ms[k] / library[k]:.3f}x, medians of {BWD_TURNS} "
               f"rounds in turns)" if k in library else "")
        pl = f", plain {plain[k]:.4f} ms" if k in plain else ""
        print(f"[train-llama]   flash {k:5s} at B={b} H={h} T={T} D={d}: "
              f"kernel {ms[k]:.4f} ms{pl}, bound {bounds[k][0]:.4f} ms "
              f"({bounds[k][1]}, {100 * bounds[k][0] / ms[k]:.1f}% of it "
              f"reached){lib} [{card}]", flush=True)
    recs["turns_ms"] = {"fwd": fwd_turns, "whole": turns}
    return recs


def phase_train_llama(torch, fa, fc, card: str) -> dict:
    from ray_tpu_torch.models.llama import llama_config

    cfg = llama_config(LLAMA_PRESET, ce_impl="pallas")
    # the main path: llama-1b AdamW steps through the flash and fused-CE
    # kernels
    result = llama_main_path(torch, fa, cfg, card)
    params, batch, steps = check_llama_steps(
        torch, fa, cfg, LLAMA_STEPS, LLAMA_B, seed=1, tag="train-llama")
    cfgs = {"dense": dataclasses.replace(cfg, ce_impl="dense"),
            "pallas": cfg}
    # the dense and pallas steps in turns (dense, pallas, pallas, dense)
    state, wall = interleaved_steps(torch, params, batch, cfgs,
                                    ["dense", "pallas", "pallas",
                                     "dense"] * 2)
    del params
    result["steps"] = steps
    report_medians(result, wall, "train-llama", card,
                   n_params=result["n_params"], tokens=LLAMA_B * LLAMA_T)
    # where one pallas step's device time goes (torch.profiler, CUPTI)
    result["profile"] = profile_step(torch, state, "pallas",
                                     result["pallas_step_ms"], card,
                                     "train-llama")
    del state
    torch.cuda.empty_cache()
    result["kernels"] = {"ce": time_llama_ce(torch, fc, card, cfg),
                         "flash": time_llama_flash(torch, fa, card, cfg)}
    torch.cuda.empty_cache()
    return result


def phase_llama_7b(torch, fa, fc, card: str) -> dict:
    """llama-7b's width at LLAMA_WIDE_LAYERS layers: one dense and one
    ce_impl="pallas" step at B=LLAMA_WIDE_B, T=LLAMA_T checked against
    each other (the flash kernels at D = 128, the cluster dH/dW kernel at
    D = 4096), the flash kernels and the fused-CE kernels against their
    plain versions at the shapes these steps give them, then one
    prefill, flash against plain attention."""
    from ray_tpu_torch.models.llama import llama_config
    from ray_tpu_torch.models.llama_decode import llama_prefill

    cfg = llama_config(LLAMA_WIDE_PRESET, n_layer=LLAMA_WIDE_LAYERS)
    params, batch, steps = check_llama_steps(
        torch, fa, cfg, LLAMA_WIDE_STEPS, LLAMA_WIDE_B, seed=9,
        tag="llama-7b")
    kernel_err = check_train_shape(torch, fa, seed=10, b=LLAMA_WIDE_B,
                                   h=cfg.n_head, T=LLAMA_T, d=cfg.head_dim,
                                   tag="llama-7b shape")["err"]
    # the fused-CE kernels at the pallas step's head (N = B*T, D = 4096:
    # dH and dW through clusters of 8 CTAs)
    n = LLAMA_WIDE_B * LLAMA_T
    t = check_ce_kernels(torch, fc, n, cfg.padded_vocab, cfg.vocab_size,
                         cfg.d_model, "bf16", seed=11, g=1.0 / n)
    ce_err = {k: {"shape": [n, cfg.padded_vocab, cfg.vocab_size,
                            cfg.d_model], **t["cmp"][k]}
              for k in ("nll", "lse", "dh", "dw")}
    del t
    toks = batch["tokens"][:, :LLAMA_T].to(torch.int32)
    with torch.inference_mode():
        fa.FLASH_FWD_LAUNCHES = 0
        llama_prefill(params, toks, cfg)
        launches = fa.FLASH_FWD_LAUNCHES
        print(f"[llama-7b] prefill B={LLAMA_WIDE_B} T={LLAMA_T} (head_dim "
              f"{cfg.head_dim}): {launches} flash kernel launches",
              flush=True)
        if launches != cfg.n_layer:
            fail(f"the llama-7b-width prefill launched the flash forward "
                 f"{launches} times, expected {cfg.n_layer}")
        prefill_check = check_prefill_flash(torch, llama_prefill, params,
                                            toks, cfg, LLAMA_LOGIT_TOL,
                                            "llama-7b")
    del params, batch
    torch.cuda.empty_cache()
    return {"steps": steps, "kernels_vs_plain": kernel_err,
            "ce_kernels_vs_plain": ce_err,
            "prefill_flash_vs_plain": prefill_check}


# phase serve-continuous: llama-1b through the continuous scheduler.
# The request set P: CONT_N requests, half of them a CONT_PREFIX-token
# shared prefix (16 blocks of 16) plus a tail of 16-128 tokens, half cold
# with 64-384 tokens, lengths from a seeded RandomState
# (continuous_prompts); CONT_WAVE1 of them first, the rest once the
# first reply is back.
CONT_N, CONT_WAVE1, CONT_PREFIX = 16, 12, 256
CONT_MAX_NEW, CONT_BUCKET, CONT_BLOCK = 24, 64, 16
#: the f32 gate's engines: 4 slots; paged pools of CONT_F32_BLOCKS blocks
#: hold at most two of the longest requests (26 blocks each), so
#: admission requeues and the LRU evicts.  A pool must hold one full
#: sequence (BlockPager), so the gate cuts the cache to CONT_MAX_SEQ
#: positions (llama-1b's 2048 would need 129 blocks); every prompt and
#: its continuation fits far below it
CONT_SLOTS, CONT_F32_BLOCKS, CONT_MAX_SEQ, CONT_CHUNK = 4, 65, 1024, 128
#: a greedy token may part from the oracle's only at a near-tie: where
#: the oracle's own f32 logits of the two tokens lie within this
#: fraction of the row's max |logit| (the engines' bucket-padded and
#: paged prefills sum in other orders than the solo prefill)
CONT_NEAR_TIE = 1e-4
#: the bf16 timing: requests drawn as P, all submitted at once, through
#: CONT_TIMED_SLOTS slots (default pool, max_seq 2048) and through the
#: batch scheduler (max_batch_size the same), in turns
CONT_TIMED_N, CONT_TIMED_SLOTS, CONT_TURNS = 32, 8, 2


def continuous_prompts(np, vocab: int, n: int, seed: int) -> list:
    """P, in order: a quarter of the shared-prefix prompts, the cold
    half, then the other shared quarter — the prefix comes back after
    a burst of cold traffic has pushed it down the LRU.  The lengths
    are drawn first, so they (and with them the pager's counts) do not
    depend on the vocabulary."""
    rs = np.random.RandomState(seed)
    tails = rs.randint(16, 129, n // 2)
    colds = rs.randint(64, 385, n // 2)
    prefix = rs.randint(0, vocab, CONT_PREFIX)
    shared = [np.concatenate([prefix, rs.randint(0, vocab, t)]).astype(
        np.int32) for t in tails]
    cold = [rs.randint(0, vocab, c).astype(np.int32) for c in colds]
    return shared[:n // 4] + cold + shared[n // 4:]


async def _serve_waves(engine, prompts, wave1: int) -> tuple:
    """prompts[:wave1] at once, the rest once the first reply is back:
    (replies, seconds from each request's submission to its reply).
    A request that raises fails the run."""
    sent, done = {}, {}

    async def one(i):
        sent[i] = time.perf_counter()
        out = await engine(prompts[i])
        done[i] = time.perf_counter()
        return out

    try:
        first = [asyncio.ensure_future(one(i)) for i in range(wave1)]
        rest = []
        if wave1 < len(prompts):
            await asyncio.wait(first, return_when=asyncio.FIRST_COMPLETED)
            rest = [asyncio.ensure_future(one(i))
                    for i in range(wave1, len(prompts))]
        outs = await asyncio.gather(*first, *rest)
    finally:
        if hasattr(engine, "shutdown_engine"):
            engine.shutdown_engine()
    return outs, [done[i] - sent[i] for i in range(len(prompts))]


def check_replies(np, prompts, outs, max_new: int, vocab: int,
                  tag: str) -> None:
    for p, o in zip(prompts, outs):
        if o.shape != (len(p) + max_new,) or \
                not np.array_equal(o[:len(p)], p):
            fail(f"[{tag}] reply of shape {o.shape} does not extend its "
                 f"{len(p)}-token prompt by {max_new} tokens")
        if o.min() < 0 or o.max() >= vocab:
            fail(f"[{tag}] reply holds a token outside the vocabulary")


def oracle_logits(torch, params, cfg, prompt, tokens):
    """The solo dense f32 generation's own logits row at each of its
    steps (its prefill, then decode steps fed its own tokens): the loop
    of decode_common.generate_with, replayed."""
    from ray_tpu_torch.models import llama_decode as m

    toks = torch.from_numpy(prompt)[None].to(params["wte"].device)
    logits, cache = m.llama_prefill(params, toks, cfg)
    rows = [logits[0]]
    for t in tokens[:-1]:
        tok = torch.tensor([int(t)], dtype=torch.int32, device=toks.device)
        logits, cache = m.llama_decode_step(params, cache, tok, cfg)
        rows.append(logits[0])
    return torch.stack(rows)


def gate_against_oracle(torch, np, params, cfg, prompts, outs, oracle,
                        tag: str, phase: str = "serve-continuous") -> list:
    """Each reply token for token equal to the oracle's, or parted at
    a near-tie of the oracle's own logits (printed).  Returns the
    near-ties."""
    ties = []
    for i, (p, o) in enumerate(zip(prompts, outs)):
        want = oracle[i][len(p):]
        got = o[len(p):]
        diff = np.nonzero(got != want)[0]
        if not diff.size:
            continue
        j = int(diff[0])
        row = oracle_logits(torch, params, cfg, p, want)[j]
        a, b = int(want[j]), int(got[j])
        gap = abs(row[a] - row[b]).item()
        scale = row.abs().max().item()
        print(f"[{phase}] {tag} request {i}: token {j} is {b}, "
              f"the oracle's {a}; oracle logits {row[a].item():.6f} vs "
              f"{row[b].item():.6f}, gap {gap:.3e} (near-tie bound "
              f"{CONT_NEAR_TIE * scale:.3e} = {CONT_NEAR_TIE} x max|logit| "
              f"{scale:.3f})", flush=True)
        if gap > CONT_NEAR_TIE * scale:
            fail(f"[{phase}] {tag} request {i} parts from the "
                 f"solo dense oracle at token {j} beyond a near-tie")
        ties.append({"engine": tag, "request": i, "token": j,
                     "gap": gap, "bound": CONT_NEAR_TIE * scale})
    return ties


def _pcts(xs) -> dict:
    s = sorted(xs)
    return {"p50_ms": s[len(s) // 2] * 1e3,
            "p95_ms": s[min(len(s) - 1, round(0.95 * (len(s) - 1)))] * 1e3}


def engine_clock(stats: dict) -> dict:
    """What an engine's own telemetry (engine_stats()) reads: TTFT and
    inter-token (one decode step or spec round) p50/p95 in ms, decode
    tokens/s over its step window, slot utilization."""
    return {"ttft_p50_ms": stats["ttft_ms"]["p50"],
            "ttft_p95_ms": stats["ttft_ms"]["p95"],
            "itl_p50_ms": stats["inter_token_ms"]["p50"],
            "itl_p95_ms": stats["inter_token_ms"]["p95"],
            "tokens_per_sec": stats["tokens_per_sec"],
            "slot_utilization": stats["slot_utilization"]}


def engine_clock_line(stats: dict) -> str:
    c = engine_clock(stats)
    return (f"engine telemetry: TTFT p50 {c['ttft_p50_ms']} ms, p95 "
            f"{c['ttft_p95_ms']} ms; inter-token p50 {c['itl_p50_ms']} ms, "
            f"p95 {c['itl_p95_ms']} ms; {c['tokens_per_sec']} decode "
            f"tokens/s; slot utilization {c['slot_utilization']}")


def phase_serve_continuous(torch, np, fa, card: str, preset="llama-1b",
                           device="cuda", widths=None) -> dict:
    """The continuous scheduler on llama-1b: the f32 correctness gate
    (P through a dense engine and three paged ones: a pool that
    requeues and evicts, the same with chunked prefill, the same with a
    host KV tier), each request held against the solo dense f32
    llama_generate of its prompt; then bf16 timing against the batch
    scheduler.  ``widths`` (config overrides) and ``device`` let the
    phase run cut down elsewhere; the smoke run leaves them.  Returns
    the kernel launches of the engine runs (none expected: the path
    runs plain PyTorch) and the numbers."""
    from ray_tpu_torch.models.llama_decode import llama_generate
    from ray_tpu_torch.serve import build_llm_deployment

    dev = torch.device(device)
    widths = dict(widths or {})

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    launches = {}

    def drive(engine, prompts, wave1):
        zero_counts(fa)
        out = asyncio.run(_serve_waves(engine, prompts, wave1))
        sync()
        for k, v in read_counts(fa).items():
            launches[k] = launches.get(k, 0) + v
        return out

    common = dict(scheduler="continuous", max_new_tokens=CONT_MAX_NEW,
                  prefill_bucket=CONT_BUCKET, seed=0, device=dev)
    f32 = dict(widths, dtype=torch.float32, max_seq=CONT_MAX_SEQ)
    paged = dict(kv_layout="paged", kv_block_size=CONT_BLOCK,
                 kv_num_blocks=CONT_F32_BLOCKS)
    engines = {"a dense": dict(kv_layout="dense"),
               "b paged": paged,
               "c paged+chunk": dict(paged,
                                     prefill_chunk_tokens=CONT_CHUNK),
               "d paged+tier": dict(paged, kv_host_tier_bytes=None)}
    ties, kv = [], {}
    oracle = params = cfg = prompts = None
    for tag, kw in engines.items():
        if tag.startswith("d"):
            # room for every block the pool could ever evict here: all
            # of P's prompt blocks, at the pool's bytes per block
            per_block = kv["b paged"]["kv_cache"]["pool_bytes"] \
                // CONT_F32_BLOCKS
            kw["kv_host_tier_bytes"] = per_block * sum(
                len(p) // CONT_BLOCK for p in prompts)
        engine = build_llm_deployment(
            "llama", preset, max_slots=CONT_SLOTS, config_overrides=f32,
            **common, **kw)()
        if oracle is None:
            cfg, params = engine.cfg, engine.params
            prompts = continuous_prompts(np, cfg.vocab_size, CONT_N, seed=5)
            t0 = time.perf_counter()
            with torch.inference_mode():
                oracle = [llama_generate(
                    params, torch.from_numpy(p)[None].to(dev), cfg,
                    max_new_tokens=CONT_MAX_NEW, temperature=0.0)[0]
                    .cpu().numpy() for p in prompts]
            print(f"[serve-continuous] llama {preset} f32 (max_seq "
                  f"{cfg.max_seq}): {CONT_N} prompts of "
                  f"{min(map(len, prompts))}-{max(map(len, prompts))} "
                  f"tokens ({CONT_N // 2} sharing a {CONT_PREFIX}-token "
                  f"prefix), +{CONT_MAX_NEW}; solo dense oracle in "
                  f"{time.perf_counter() - t0:.2f} s", flush=True)
        t0 = time.perf_counter()
        outs, _ = drive(engine, prompts, CONT_WAVE1)
        wall = time.perf_counter() - t0
        check_replies(np, prompts, outs, CONT_MAX_NEW, cfg.vocab_size, tag)
        ties += gate_against_oracle(torch, np, params, cfg, prompts, outs,
                                    oracle, tag)
        kv[tag] = stats = engine.kv_stats()
        line = (f"[serve-continuous] f32 engine ({tag}): {CONT_N} "
                f"requests in {wall:.2f} s, all equal to the oracle or "
                f"parted at a near-tie; "
                f"{engine_clock_line(engine.engine_stats())}")
        if stats["kv_cache"] is not None:
            c, t = stats["kv_cache"], stats["kv_tier"]
            line += (f"; blocks in use after {c['blocks_in_use']}, prefix "
                     f"block hits {c['prefix_block_hits']} (rate "
                     f"{c['prefix_hit_rate']}), evictions {c['evictions']}"
                     f", requeues {stats['requeues']}, cow copies "
                     f"{c['cow_copies']}, partial fills "
                     f"{c['partial_fills']}; tier saves {t['saves']}, "
                     f"hits {t['hits']}, tokens restored "
                     f"{t['tokens_restored']}")
            if c["blocks_in_use"]:
                fail(f"[serve-continuous] {tag}: {c['blocks_in_use']} "
                     "blocks still in use after every request finished")
        print(line + f" [{card}]", flush=True)
        del engine
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    b, d = kv["b paged"], kv["d paged+tier"]
    if b["kv_cache"]["prefix_block_hits"] < CONT_PREFIX // CONT_BLOCK or \
            b["requeues"] < 1:
        fail("[serve-continuous] run (b) shows "
             f"{b['kv_cache']['prefix_block_hits']} prefix block hits "
             f"and {b['requeues']} requeues; expected >= "
             f"{CONT_PREFIX // CONT_BLOCK} and >= 1")
    if d["kv_tier"]["hits"] < 1:
        fail("[serve-continuous] run (d) restored nothing from the host "
             "tier")
    del params
    timing = time_continuous(torch, np, preset, dev, widths, card, drive,
                             sync)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    print(f"[serve-continuous] kernel launches of the engine runs: "
          f"{launches} (the path runs plain PyTorch) [{card}]", flush=True)
    if any(launches.values()):
        fail("[serve-continuous] the continuous engine launched a kernel; "
             "its prefills (ragged, paged) and decode are plain PyTorch")
    return {"counts": launches, "near_ties": ties,
            "kv": {k: {"kv_cache": v["kv_cache"], "requeues": v["requeues"],
                       "kv_tier": v["kv_tier"]} for k, v in kv.items()},
            "gate": {"prompts": prompts, "oracle": oracle}, **timing}


def time_continuous(torch, np, preset, dev, widths, card, drive,
                    sync) -> dict:
    """bf16: CONT_TIMED_N requests drawn as P, all at once, through a
    fresh paged continuous engine (default pool) and through the batch
    scheduler, in turns (continuous, batch, batch, continuous, ...):
    served tokens/s, request latency p50/p95; prefix hit rate and
    evictions of each continuous run."""
    from ray_tpu_torch.serve import build_llm_deployment

    batch = build_llm_deployment(
        "llama", preset, max_new_tokens=CONT_MAX_NEW,
        max_batch_size=CONT_TIMED_SLOTS, seed=0, device=dev,
        config_overrides=widths)()
    cfg = batch.cfg
    prompts = continuous_prompts(np, cfg.vocab_size, CONT_TIMED_N, seed=6)
    n_tok = CONT_TIMED_N * CONT_MAX_NEW

    def continuous():
        return build_llm_deployment(
            "llama", preset, scheduler="continuous", kv_layout="paged",
            kv_block_size=CONT_BLOCK, max_slots=CONT_TIMED_SLOTS,
            max_new_tokens=CONT_MAX_NEW, prefill_bucket=CONT_BUCKET, seed=0,
            device=dev, config_overrides=widths)()

    # warm-up of both (cuBLAS handles, allocator pools), not timed
    for engine in (continuous(), batch):
        outs, _ = asyncio.run(_serve_waves(engine, prompts[:8], 8))
        check_replies(np, prompts[:8], outs, CONT_MAX_NEW, cfg.vocab_size,
                      "warm-up")
        del engine
    runs = {"continuous": [], "batch": []}
    order = ["continuous", "batch", "batch", "continuous"]
    for name in order * (CONT_TURNS // 2):
        engine = continuous() if name == "continuous" else batch
        sync()
        t0 = time.perf_counter()
        if name == "continuous":
            outs, lat = drive(engine, prompts, CONT_TIMED_N)
        else:
            outs, lat = asyncio.run(_serve_waves(engine, prompts,
                                                 CONT_TIMED_N))
            sync()
        wall = time.perf_counter() - t0
        check_replies(np, prompts, outs, CONT_MAX_NEW, cfg.vocab_size, name)
        run = {"tokens_per_s": n_tok / wall, "wall_s": wall, **_pcts(lat)}
        if name == "continuous":
            stats = engine.engine_stats()
            c = stats["kv_cache"]
            run.update(prefix_hit_rate=c["prefix_hit_rate"],
                       evictions=c["evictions"],
                       prefix_block_hits=c["prefix_block_hits"],
                       engine=engine_clock(stats))
            del engine
        runs[name].append(run)
        print(f"[serve-continuous] bf16 {name}: {CONT_TIMED_N} requests "
              f"(+{CONT_MAX_NEW} each), {run['tokens_per_s']:.1f} served "
              f"tokens/s, request latency p50 {run['p50_ms']:.1f} ms, p95 "
              f"{run['p95_ms']:.1f} ms"
              + (f", prefix hit rate {run['prefix_hit_rate']}, evictions "
                 f"{run['evictions']}; {engine_clock_line(stats)}"
                 if name == "continuous" else "")
              + f" [{card}]", flush=True)
    del batch
    return {"timed": runs}


# phase serve-spec-disagg: speculative decoding and the prefill/decode
# roles of the continuous engine, llama-1b, on phase serve-continuous's
# request set P, oracle and near-tie rule.
SPEC_K = 4
#: the least acceptance rate of the aligned draft (the target itself):
#: below it the verify forward and the decode step disagree
SPEC_ALIGNED_MIN_RATE = 0.9
#: the bf16 timing's model draft: llama-s (12 layers, d 768, llama-1b's
#: vocabulary of 32,000 and max_seq 2048)
SPEC_TIMED_DRAFT = "llama:llama-s"
#: prompts sent straight to the decode engine after the handoffs of
#: engine (g): the shared prefix and a fresh tail each
SPEC_DIRECT = 2


class _Pair:
    """A role="prefill" engine feeding a role="decode" one: a call
    prefills, hands the HandoffCursor over and awaits the decode
    engine's reply (the router's two-stage dispatch, done by hand).
    The install is fenced and timed from outside by wrapping the decode
    engine's kv_handoff_install (a closure over a list, not over the
    pair: a cycle through the engine would keep its memory after the
    phase)."""

    def __init__(self, torch, pre, dec, sync):
        from ray_tpu_torch.serve.batching import HandoffCursor

        self.pre, self.dec, self.pkgs = pre, dec, []
        self.install_s = install_s = []
        self._cursor = HandoffCursor
        install = dec._fns.kv_handoff_install

        def timed(*args):
            sync()
            t0 = time.perf_counter()
            out = install(*args)
            sync()
            install_s.append(time.perf_counter() - t0)
            return out

        dec._fns.kv_handoff_install = timed

    async def __call__(self, prompt):
        pkg = await self.pre(prompt)
        if not isinstance(pkg, self._cursor):
            fail("[serve-spec-disagg] a prefill engine answered a request "
                 "of 24 new tokens without a handoff")
        self.pkgs.append(pkg)
        return await self.dec.admit_prefilled(pkg)

    def shutdown_engine(self):
        self.pre.shutdown_engine()
        self.dec.shutdown_engine()

    def check_engines(self, tag: str) -> None:
        """The engines' own handoff counts (engine_stats()["handoff"])
        equal the packages this pair handed over."""
        want = {"handoffs_out": len(self.pkgs),
                "handoffs_in": len(self.pkgs),
                "blocks_moved": sum(p.n_blocks for p in self.pkgs)}
        got = {"handoffs_out":
               self.pre.engine_stats()["handoff"]["handoffs_out"]}
        dec = self.dec.engine_stats()["handoff"]
        got.update(handoffs_in=dec["handoffs_in"],
                   blocks_moved=dec["blocks_moved"])
        if got != want:
            fail(f"[serve-spec-disagg] {tag}: engine_stats handoff {got} "
                 f"!= the pair's count {want}")

    def handoffs(self) -> dict:
        """Export and install ms per request (means), bytes per request
        and the rate of each leg."""
        n = len(self.pkgs)
        nbytes = sum(p.nbytes for p in self.pkgs)
        export_s = sum(p.t_export1 - p.t_export0 for p in self.pkgs)
        install_s = sum(self.install_s)
        return {"handoffs": n, "path": self.pkgs[0].path if n else None,
                "blocks": sum(p.n_blocks for p in self.pkgs),
                "bytes_per_request": nbytes / max(n, 1),
                "export_ms": 1e3 * export_s / max(n, 1),
                "install_ms": 1e3 * install_s / max(n, 1),
                "export_gb_s": nbytes / export_s / 1e9 if export_s else None,
                "install_gb_s": (nbytes / install_s / 1e9 if install_s
                                 else None)}


class _Acceptance:
    """Counts a spec engine's proposals and acceptances from outside, by
    wrapping its spec_verify: k drafts per row that was decoding, and
    the n_acc of those rows.  The wrapper holds the engine's slot list
    and a counter list, not the engine (no reference cycle)."""

    def __init__(self, engine):
        # rounds, proposed, accepted, rounds x decoding rows
        self.counts = counts = [0, 0, 0, 0]
        verify, slots = engine._fns.spec_verify, engine._slots

        def counted(params, cache, block, *args):
            rows = [i for i, st in enumerate(slots)
                    if st is not None and st.get("state") != "prefill"]
            out, n_acc, cache = verify(params, cache, block, *args)
            counts[0] += 1
            counts[1] += (block.shape[1] - 1) * len(rows)
            counts[2] += int(n_acc[rows].sum())
            counts[3] += len(rows)
            return out, n_acc, cache

        engine._fns.spec_verify = counted

    rounds = property(lambda self: self.counts[0])
    proposed = property(lambda self: self.counts[1])
    accepted = property(lambda self: self.counts[2])
    row_rounds = property(lambda self: self.counts[3])

    def check_engine(self, stats: dict, tag: str) -> None:
        """The engine's own spec counts (engine_stats()["spec"], a
        round counted once per decoding request) equal this count."""
        spec = stats["spec"]
        want = {"proposed": self.proposed, "accepted": self.accepted,
                "rounds": self.row_rounds}
        got = {k: spec[k] for k in want}
        if got != want:
            fail(f"[serve-spec-disagg] {tag}: engine_stats spec {got} != "
                 f"the spec_verify wrapper's {want}")

    @property
    def rate(self) -> float:
        return self.accepted / self.proposed if self.proposed else 0.0


def phase_serve_spec_disagg(torch, np, fa, card: str, gate: dict,
                            preset="llama-1b", device="cuda", widths=None,
                            timed_draft=SPEC_TIMED_DRAFT) -> dict:
    """Speculative decoding and the prefill/decode handoff on llama-1b.
    The f32 gate: P (``gate``: phase serve-continuous's prompts and solo
    oracle) through (e) a paged engine with n-gram spec, (f) a dense one
    with the aligned model draft (the target itself), (g) a prefill
    engine feeding a decode engine on the device, (h) the same pair
    staged through host memory with chunked prefill, (i) the fast pair
    with n-gram spec on the decode side; each reply held to the oracle
    as in serve-continuous, the aligned draft's acceptance >= 0.9, the
    blocks handed off, the decode engine's prefix hits on the imported
    prefix, empty pagers.  Then bf16 timing of 32 requests at once:
    plain, n-gram spec and llama-s-draft spec in turns, and the fast
    and staged handoff.  ``preset``, ``device``, ``widths`` and
    ``timed_draft`` let it run cut down elsewhere."""
    from ray_tpu_torch.serve import SpecConfig, build_llm_deployment

    dev = torch.device(device)
    widths = dict(widths or {})
    prompts, oracle = gate["prompts"], gate["oracle"]

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    launches = {}

    def drive(engine, ps, wave1):
        zero_counts(fa)
        out = asyncio.run(_serve_waves(engine, ps, wave1))
        sync()
        for k, v in read_counts(fa).items():
            launches[k] = launches.get(k, 0) + v
        return out

    common = dict(scheduler="continuous", max_new_tokens=CONT_MAX_NEW,
                  prefill_bucket=CONT_BUCKET, seed=0, device=dev,
                  max_slots=CONT_SLOTS,
                  config_overrides=dict(widths, dtype=torch.float32,
                                        max_seq=CONT_MAX_SEQ))
    paged = dict(kv_layout="paged", kv_block_size=CONT_BLOCK,
                 kv_num_blocks=CONT_F32_BLOCKS)
    ngram = SpecConfig(draft="ngram", k=SPEC_K)

    def build(**kw):
        return build_llm_deployment("llama", preset, **common, **kw)()

    def pair(staged=False, pre_kw=None, dec_kw=None):
        return _Pair(torch,
                     build(role="prefill", handoff_staged=staged, **paged,
                           **(pre_kw or {})),
                     build(role="decode", handoff_staged=staged, **paged,
                           **(dec_kw or {})), sync)

    engines = {
        "e paged+ngram": lambda: build(spec_decode=ngram, **paged),
        "f dense+aligned draft": lambda: build(
            kv_layout="dense",
            spec_decode=SpecConfig(draft=f"llama:{preset}", k=SPEC_K)),
        "g prefill->decode fast": lambda: pair(),
        "h prefill(chunked)->decode staged": lambda: pair(
            staged=True, pre_kw=dict(prefill_chunk_tokens=CONT_CHUNK)),
        "i prefill->decode+ngram": lambda: pair(
            dec_kw=dict(spec_decode=ngram)),
    }
    want_blocks = sum(-(-len(p) // CONT_BLOCK) for p in prompts)
    ties, rates, handoffs, direct_hits = [], {}, {}, None
    params = cfg = None
    for tag, make in engines.items():
        engine = make()
        target = engine.dec if isinstance(engine, _Pair) else engine
        if params is None:
            # the engines' weights are the serve-continuous ones (seed 0)
            cfg, params = target.cfg, target.params
        acc = _Acceptance(target) if target._fns.spec_verify else None
        t0 = time.perf_counter()
        outs, _ = drive(engine, prompts, CONT_WAVE1)
        wall = time.perf_counter() - t0
        check_replies(np, prompts, outs, CONT_MAX_NEW, cfg.vocab_size, tag)
        ties += gate_against_oracle(torch, np, params, cfg, prompts, outs,
                                    oracle, tag, "serve-spec-disagg")
        line = (f"[serve-spec-disagg] f32 engine ({tag}): {CONT_N} requests "
                f"in {wall:.2f} s, all equal to the oracle or parted at a "
                f"near-tie")
        if acc is not None:
            acc.check_engine(target.engine_stats(), tag)
            rates[tag] = {"proposed": acc.proposed, "accepted": acc.accepted,
                          "rounds": acc.rounds, "rate": acc.rate}
            line += (f"; spec rounds {acc.rounds}, accepted {acc.accepted} "
                     f"of {acc.proposed} drafts (rate {acc.rate:.4f}; "
                     f"engine_stats spec equal)")
        line += f"; {engine_clock_line(target.engine_stats())}"
        pagers = []
        if isinstance(engine, _Pair):
            engine.check_engines(tag)
            h = handoffs[tag] = engine.handoffs()
            line += (f"; {h['handoffs']} handoffs ({h['path']}), "
                     f"{h['blocks']} blocks (sum of ceil(n/16): "
                     f"{want_blocks}; engine_stats handoff equal), decode "
                     f"requeues "
                     f"{engine.dec.kv_stats()['requeues']}")
            if h["blocks"] != want_blocks or h["handoffs"] != CONT_N:
                fail(f"[serve-spec-disagg] {tag} handed off {h['handoffs']} "
                     f"requests and {h['blocks']} blocks; expected {CONT_N} "
                     f"and {want_blocks}")
            if tag.startswith("g"):
                direct_hits = _direct_prefix_hits(np, engine.dec, prompts,
                                                  oracle, drive, tag, cfg)
                line += (f"; {SPEC_DIRECT} prompts sent straight to the "
                         f"decode engine hit {direct_hits} imported prefix "
                         f"blocks")
            pagers = [engine.pre, engine.dec]
        elif target._pager is not None:
            pagers = [target]
        for e in pagers:
            used = e.kv_stats()["kv_cache"]["blocks_in_use"]
            if used:
                fail(f"[serve-spec-disagg] {tag}: {used} blocks still in "
                     "use after every request finished")
        print(line + f" [{card}]", flush=True)
        del engine, target, acc
    del params
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    aligned = rates["f dense+aligned draft"]["rate"]
    if aligned < SPEC_ALIGNED_MIN_RATE:
        fail(f"[serve-spec-disagg] the aligned draft's acceptance rate "
             f"{aligned:.4f} < {SPEC_ALIGNED_MIN_RATE}: the verify forward "
             "and the decode step disagree")
    timing = time_spec(torch, np, preset, dev, widths, card, drive, sync,
                       timed_draft)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    print(f"[serve-spec-disagg] kernel launches of the engine runs: "
          f"{launches} (the path runs plain PyTorch) [{card}]", flush=True)
    if any(launches.values()):
        fail("[serve-spec-disagg] a spec or handoff engine launched a "
             "kernel; their verify, draft and handoff are plain PyTorch")
    return {"counts": launches, "near_ties": ties, "acceptance": rates,
            "handoffs": handoffs, "direct_prefix_hits": direct_hits,
            **timing}


def _direct_prefix_hits(np, dec, prompts, oracle, drive, tag, cfg) -> int:
    """After the handoffs, SPEC_DIRECT prompts of P's shared prefix and
    fresh tails go straight to the decode engine, one by one (as the
    reference's router sends a resident prefix, tests/test_serve_disagg.py
    :145): their admissions must hit every full block of the prefix,
    which that engine only holds by note_handoff_import.  Their replies
    are checked for shape (the oracle covers P only)."""
    prefix = prompts[0][:CONT_PREFIX]
    rs = np.random.RandomState(8)
    direct = [np.concatenate([prefix, rs.randint(0, cfg.vocab_size, 16)])
              .astype(np.int32) for _ in range(SPEC_DIRECT)]
    before = dec.kv_stats()["kv_cache"]["prefix_block_hits"]
    for p in direct:
        outs, _ = drive(dec, [p], 1)
        check_replies(np, [p], outs, CONT_MAX_NEW, cfg.vocab_size, tag)
    hits = dec.kv_stats()["kv_cache"]["prefix_block_hits"] - before
    want = SPEC_DIRECT * (CONT_PREFIX // CONT_BLOCK)
    if hits < want:
        fail(f"[serve-spec-disagg] {tag}: prompts sharing the imported "
             f"{CONT_PREFIX}-token prefix hit {hits} blocks on the decode "
             f"engine; expected >= {want}")
    return hits


def time_spec(torch, np, preset, dev, widths, card, drive, sync,
              timed_draft) -> dict:
    """bf16: CONT_TIMED_N requests drawn as P, all at once, through a
    paged engine of CONT_TIMED_SLOTS slots (default pool) without spec,
    with n-gram spec and with ``timed_draft`` as the draft model, in
    turns (and back): served tokens/s, request latency p50/p95 and the
    acceptance rate; then through a fast and a staged prefill/decode
    pair: export and install ms per request, bytes, GB/s."""
    from ray_tpu_torch.models.llama import llama_config
    from ray_tpu_torch.serve import SpecConfig, build_llm_deployment

    kw = dict(scheduler="continuous", kv_layout="paged",
              kv_block_size=CONT_BLOCK, max_slots=CONT_TIMED_SLOTS,
              max_new_tokens=CONT_MAX_NEW, prefill_bucket=CONT_BUCKET, seed=0,
              device=dev, config_overrides=widths)
    specs = {"plain": None, "ngram": SpecConfig(draft="ngram", k=SPEC_K),
             "draft " + timed_draft.split(":")[1]: SpecConfig(
                 draft=timed_draft, k=SPEC_K)}

    def engine(name):
        return build_llm_deployment("llama", preset, spec_decode=specs[name],
                                    **kw)()

    vocab = llama_config(preset, **widths).vocab_size
    prompts = continuous_prompts(np, vocab, CONT_TIMED_N, seed=6)
    n_tok = CONT_TIMED_N * CONT_MAX_NEW
    for name in specs:            # warm-up, not timed
        outs, _ = asyncio.run(_serve_waves(engine(name), prompts[:8], 8))
        check_replies(np, prompts[:8], outs, CONT_MAX_NEW, vocab, "warm-up")
    runs = {name: [] for name in specs}
    for name in list(specs) + list(specs)[::-1]:
        e = engine(name)
        acc = _Acceptance(e) if e._fns.spec_verify else None
        sync()
        t0 = time.perf_counter()
        outs, lat = drive(e, prompts, CONT_TIMED_N)
        wall = time.perf_counter() - t0
        check_replies(np, prompts, outs, CONT_MAX_NEW, vocab, name)
        stats = e.engine_stats()
        if acc is not None:
            acc.check_engine(stats, name)
        run = {"tokens_per_s": n_tok / wall, "wall_s": wall, **_pcts(lat),
               "accept_rate": acc.rate if acc else None,
               "engine": engine_clock(stats)}
        runs[name].append(run)
        print(f"[serve-spec-disagg] bf16 {name}: {CONT_TIMED_N} requests "
              f"(+{CONT_MAX_NEW} each), {run['tokens_per_s']:.1f} served "
              f"tokens/s, request latency p50 {run['p50_ms']:.1f} ms, p95 "
              f"{run['p95_ms']:.1f} ms"
              + (f", acceptance rate {acc.rate:.4f} ({acc.accepted} of "
                 f"{acc.proposed} drafts, {acc.rounds} rounds)" if acc else "")
              + f"; {engine_clock_line(stats)} [{card}]", flush=True)
        del e, acc
    handoff = {}
    for staged in (False, True):
        p = _Pair(torch, *(build_llm_deployment(
            "llama", preset, role=r, handoff_staged=staged, **kw)()
            for r in ("prefill", "decode")), sync)
        outs, _ = drive(p, prompts, CONT_TIMED_N)
        check_replies(np, prompts, outs, CONT_MAX_NEW, vocab, "handoff")
        p.check_engines("handoff")
        h = handoff["staged" if staged else "fast"] = p.handoffs()
        print(f"[serve-spec-disagg] bf16 handoff ({h['path']}): "
              f"{h['handoffs']} requests, {h['bytes_per_request'] / 2**20:.3f}"
              f" MiB a request ({h['blocks']} blocks of 16 tokens), export "
              f"{h['export_ms']:.4f} ms ({h['export_gb_s']:.2f} GB/s), "
              f"install {h['install_ms']:.4f} ms ({h['install_gb_s']:.2f} "
              f"GB/s) per request [{card}]", flush=True)
        del p
    return {"timed": runs, "timed_handoff": handoff}


# phase serve-telemetry: the engine telemetry on llama-1b, phase
# serve-continuous's request set P, oracle and near-tie rule.
#: (b): requests all at once through TELE_SLOTS slots, bf16
TELE_N, TELE_SLOTS = 32, 8
#: (c): the queue bound of the shedding run
TELE_MAX_QUEUE = 4
#: (e): the health monitor's thresholds and the chaos freeze (polls of
#: TELE_POLL_MS: >= 600 ms, past dead_ms however the waves around it
#: run); the prober stands in for the fleet router's pump
TELE_HEALTH = dict(suspect_ms=150.0, dead_ms=400.0, stall_ms=60_000.0,
                   probe_ms=5.0)
TELE_FREEZE_POLLS, TELE_POLL_MS = 120, 5.0
#: (f): equal-length prompts through the batch scheduler
TELE_BATCH_N, TELE_BATCH_T = 8, 128


class _HostCostSpy:
    """Times the host work that the telemetry adds to one engine's run,
    by part: every public method of its EngineTelemetry instance; the
    flight recorder's ``record`` (the pager's journal writes into it
    too); the program registry's bookkeeping around each engine program
    call (``_signature`` over the arguments' leaves, ``record_invoke``
    and ``record_compile``; the wrapper's set lookup under its lock is
    not timed); and the engine's ``pager.stats()`` and
    ``_compose_kv_scope()``, whose results only telemetry reads.  Only
    the outermost timed call counts, so a nested one is not counted
    twice.  Every timed call runs under
    torch.cuda.set_sync_debug_mode("error"), set and reset by the
    wrapper outside the timed window, so a call that synchronizes the
    card raises (``guard``: off where there is no card).  ``restore()``
    takes the process-wide patches (the registry's) off again.  Holds
    the objects it patches, so it is dropped with the engine."""

    PARTS = ("EngineTelemetry methods", "flight recorder", "registry",
             "pager.stats / kv_scope")

    def __init__(self, torch, engine, guard: bool = True):
        from ray_tpu_torch._private import device_stats

        self.by_part = {p: 0.0 for p in self.PARTS}
        self.calls = 0
        self._depth = 0
        self._undo = []
        self._torch, self._guard = torch, guard
        tel = engine._telemetry
        for name in dir(tel):
            if not name.startswith("_") and callable(getattr(tel, name)):
                self._patch(tel, name, self.PARTS[0])
        self._patch(tel.flightrec, "record", self.PARTS[1])
        self._patch(device_stats, "_signature", self.PARTS[2])
        reg = device_stats.get_registry()
        self._patch(reg, "record_invoke", self.PARTS[2])
        self._patch(reg, "record_compile", self.PARTS[2])
        if engine._pager is not None:
            self._patch(engine._pager, "stats", self.PARTS[3])
        self._patch(engine, "_compose_kv_scope", self.PARTS[3])

    def _patch(self, obj, name: str, part: str) -> None:
        fn = getattr(obj, name)
        had = name in getattr(obj, "__dict__", {})
        torch, spy = self._torch, self

        def wrapped(*a, **kw):
            if spy._depth:
                return fn(*a, **kw)
            if spy._guard:
                prev = torch.cuda.get_sync_debug_mode()
                torch.cuda.set_sync_debug_mode("error")
            spy._depth += 1
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                spy.by_part[part] += time.perf_counter() - t0
                spy.calls += 1
                spy._depth -= 1
                if spy._guard:
                    torch.cuda.set_sync_debug_mode(prev)

        setattr(obj, name, wrapped)
        self._undo.append((obj, name, fn if had else None))

    def restore(self) -> None:
        for obj, name, fn in reversed(self._undo):
            if fn is None:
                delattr(obj, name)
            else:
                setattr(obj, name, fn)
        self._undo = []

    @property
    def seconds(self) -> float:
        return sum(self.by_part.values())


#: engine_stats()'s top-level keys (the reference's schema test,
#: tests/test_engine_stats_schema.py:26-34)
ENGINE_STATS_KEYS = {
    "deployment", "uptime_s", "requests", "ttft_ms", "queue_wait_ms",
    "request_latency_ms", "inter_token_ms", "engine_steps",
    "tokens_generated", "tokens_per_sec", "slot_utilization",
    "max_active_slots", "max_slots", "prefill_buckets",
    "prefill_compiles", "program_compiles", "rejections_by_reason",
    "kv_cache", "kv_scope", "kv_tier", "spec", "slo", "flightrec",
    "programs", "latency_anatomy", "prefill_chunks", "role", "handoff",
    "health"}


def profile_serving(torch, np, engine, prompts, card: str) -> dict:
    """One run of ``prompts``, all at once, under torch.profiler (CUPTI):
    the card's busy time (kernels, copies and sets on its one stream)
    over the run's wall time, and the busy time by kind.  The profiler
    slows the host's launches, so the busy share it gives is a lower
    bound of the unprofiled run's."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        asyncio.run(_serve_waves(engine, prompts, len(prompts)))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in events) / 1e6
    kinds = {}
    for e in events:
        kind = next((k for k, marks in PROFILE_KINDS if any(
            m in e.key for m in marks)), "other elementwise")
        kinds[kind] = kinds.get(kind, 0.0) + e.self_device_time_total / 1e3
    launches = sum(e.count for e in events)
    print(f"[serve-telemetry] (b) profiled run, {len(prompts)} requests at "
          f"once: wall {wall:.3f} s, device busy {busy:.3f} s = "
          f"{100 * busy / wall:.1f}% ({launches} device ops, "
          f"{1e6 * busy / max(launches, 1):.1f} us each); busy by kind "
          + ", ".join(f"{k} {v:.1f} ms" for k, v in sorted(
              kinds.items(), key=lambda kv: -kv[1]))
          + f" [{card}]", flush=True)
    return {"wall_s": wall, "busy_s": busy, "busy_share": busy / wall,
            "device_ops": launches, "by_kind_ms": kinds}


def phase_serve_telemetry(torch, np, fa, card: str, gate: dict,
                          preset="llama-1b", device="cuda",
                          widths=None) -> dict:
    """The serving telemetry on llama-1b: (a) an f32 paged engine of 4
    slots with a generous SLOConfig, each reply held to the oracle, its
    engine_stats() key tree, counts, HBM ledger, roofline and timeline
    checked; (b) bf16, 32 requests at once through 8 slots: served
    tokens/s by the phase's clock and the engine's, TTFT and
    inter-token percentiles, slot utilization, telemetry's share of the
    wall time, every record call under sync-debug "error"; (c) three
    admission-policy runs (a queue bound, a headroom above the card's
    memory, a headroom of 1 GiB); (d) a breached SLO dumping the flight
    record; (e) a health monitor and a chaos freeze attached as the
    fleet router attaches them, f32 replies held to the oracle; (f) the
    batch scheduler: 8 equal-length bf16 requests, one prefill through
    the flash forward (16 launches, zeroed just before).  ``preset``,
    ``device`` and ``widths`` let it run cut down elsewhere."""
    import os
    import tempfile

    from ray_tpu_torch.serve import build_llm_deployment
    from ray_tpu_torch.serve.batching import (AdmissionPolicy,
                                              OverloadedError)
    from ray_tpu_torch.serve.chaos import ChaosConfig, ChaosInjector
    from ray_tpu_torch.serve.health import HealthConfig, HealthMonitor
    from ray_tpu_torch.serve.slo import SLOConfig

    dev = torch.device(device)
    on_card = dev.type == "cuda"
    widths = dict(widths or {})
    prompts, oracle = gate["prompts"], gate["oracle"]
    out = {}

    def sync():
        if on_card:
            torch.cuda.synchronize()

    launches = {}

    def drive(engine, ps, wave1, extra=None):
        zero_counts(fa)

        async def run():
            helper = (asyncio.ensure_future(extra())
                      if extra is not None else None)
            try:
                return await _serve_waves(engine, ps, wave1)
            finally:
                if helper is not None:
                    helper.cancel()

        res = asyncio.run(run())
        sync()
        for k, v in read_counts(fa).items():
            launches[k] = launches.get(k, 0) + v
        return res

    f32 = dict(scheduler="continuous", max_new_tokens=CONT_MAX_NEW,
               prefill_bucket=CONT_BUCKET, seed=0, device=dev,
               max_slots=CONT_SLOTS, kv_layout="paged",
               kv_block_size=CONT_BLOCK, kv_num_blocks=CONT_F32_BLOCKS,
               config_overrides=dict(widths, dtype=torch.float32,
                                     max_seq=CONT_MAX_SEQ))
    bf16 = dict(scheduler="continuous", kv_layout="paged",
                kv_block_size=CONT_BLOCK, max_slots=TELE_SLOTS,
                max_new_tokens=CONT_MAX_NEW, prefill_bucket=CONT_BUCKET,
                seed=0, device=dev, config_overrides=widths)

    def build(**kw):
        return build_llm_deployment("llama", preset, **kw)()

    # (a) -------------------------------------------------------------
    engine = build(slo=SLOConfig(ttft_ms=600_000.0, e2e_ms=600_000.0,
                                 queue_wait_ms=600_000.0), **f32)
    params, cfg = engine.params, engine.cfg
    # the registry is process-wide and an earlier phase's engine of the
    # same identity shares these programs: count (a)'s own invokes
    from ray_tpu_torch._private.device_stats import get_registry

    def calls_of(names):
        snap = get_registry().snapshot(prefix="serve.")
        return {n: snap.get(n, {}).get("invokes", 0)
                + snap.get(n, {}).get("compile_events", 0) for n in names}

    served_by = ("serve.paged_prefill", "serve.decode")
    calls0 = calls_of(served_by)
    t0 = time.perf_counter()
    outs, _ = drive(engine, prompts, CONT_WAVE1)
    wall = time.perf_counter() - t0
    calls = {n: c - calls0[n] for n, c in calls_of(served_by).items()}
    check_replies(np, prompts, outs, CONT_MAX_NEW, cfg.vocab_size, "a")
    ties = gate_against_oracle(torch, np, params, cfg, prompts, outs,
                               oracle, "a f32 paged+slo", "serve-telemetry")
    st = engine.engine_stats()
    missing = ENGINE_STATS_KEYS - set(st)
    if missing:
        fail(f"[serve-telemetry] engine_stats() lacks {sorted(missing)}")
    req = st["requests"]
    decoded = sum(len(o) - len(p) - 1 for p, o in zip(prompts, outs))
    checks = {
        "admitted == finished == requests":
            req["admitted"] == req["finished"] == len(prompts),
        "tokens_generated == decode tokens of the replies":
            st["tokens_generated"] == decoded,
        "kv_cache == the pager's stats()": st["kv_cache"] ==
            engine._pager.stats(),
        "slo not breached": st["slo"]["breached"] is False,
        "programs serve.paged_prefill and serve.decode compiled":
            all(st["programs"].get(n, {}).get("compile_events", 0) >= 1
                for n in served_by),
        "serve.paged_prefill and serve.decode called in this run":
            all(c >= 1 for c in calls.values()),
    }
    ledger = st["kv_scope"]["hbm_ledger"]["per_chip"]
    pool = st["kv_cache"]["pool_bytes"]
    if on_card:
        total = torch.cuda.mem_get_info(dev)[1]
        row = ledger[0] if len(ledger) == 1 else {}
        checks.update({
            "one ledger row with the card's total memory":
                row.get("bytes_limit") == total,
            "kv_pool_bytes == the pager's bytes":
                row.get("kv_pool_bytes") == pool,
            "headroom == limit - max(in use, pool)":
                row.get("headroom_bytes") == total - max(
                    row.get("bytes_in_use") or 0, pool),
            "the roofline names the card": st["device"]["device_kind"] ==
                torch.cuda.get_device_name(dev),
        })
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "timeline.json")
        engine.export_timeline(path)
        with open(path) as f:
            events = json.load(f)
    lanes = {e["args"]["name"] for e in events if e["name"] == "thread_name"}
    checks["timeline lanes: a slot each, the queue, the steps"] = lanes == \
        {f"slot {i}" for i in range(CONT_SLOTS)} | {"queue", "engine steps"}
    bad = [k for k, ok in checks.items() if not ok]
    print(f"[serve-telemetry] (a) f32 paged engine, {CONT_SLOTS} slots, "
          f"generous SLO: {len(prompts)} requests in {wall:.2f} s, all equal "
          f"to the oracle or parted at a near-tie; requests {req}; "
          f"tokens_generated {st['tokens_generated']}; programs "
          f"{ {n: b['compile_events'] for n, b in st['programs'].items()} }; "
          f"calls in this run {calls}; "
          f"flightrec {st['flightrec']['recorded']} events; ledger "
          f"{ledger}; roofline {st['device']}; timeline {len(events)} "
          f"events; {engine_clock_line(st)} [{card}]", flush=True)
    if bad:
        fail(f"[serve-telemetry] (a) failed: {bad}")
    out["a"] = {"wall_s": wall, "requests": req, "ledger": ledger,
                "program_calls": calls,
                "engine": engine_clock(st), "programs": {
                    n: b["compile_events"] for n, b in st["programs"].items()}}
    del engine

    # (b) -------------------------------------------------------------
    tprompts = continuous_prompts(np, cfg.vocab_size, TELE_N, seed=6)
    engine = build(**bf16)
    drive(engine, tprompts[:8], 8)          # warm-up, not timed
    engine = build(**bf16)
    spy = _HostCostSpy(torch, engine, guard=on_card)
    sync()
    t0 = time.perf_counter()
    try:
        outs, lat = drive(engine, tprompts, TELE_N)
    finally:
        spy.restore()
    wall = time.perf_counter() - t0
    check_replies(np, tprompts, outs, CONT_MAX_NEW, cfg.vocab_size, "b")
    st = engine.engine_stats()
    recs = engine.trace_records()
    prefill_s = sum(r["first_token"] - r["admit"] for r in recs
                    if r["first_token"] is not None
                    and r["admit"] is not None)
    step_s = st["inter_token_ms"]["mean"] * st["engine_steps"] / 1e3
    served = TELE_N * CONT_MAX_NEW / wall
    b = {"wall_s": wall, "served_tokens_per_s": served, **_pcts(lat),
         "engine": engine_clock(st), "telemetry_s": spy.seconds,
         "telemetry_calls": spy.calls,
         "telemetry_share": spy.seconds / wall,
         "telemetry_ms_by_part": {k: 1e3 * v
                                  for k, v in spy.by_part.items()},
         "decode_step_s": step_s, "decode_step_share": step_s / wall,
         "prefill_s": prefill_s, "prefill_share": prefill_s / wall,
         "engine_steps": st["engine_steps"]}
    print(f"[serve-telemetry] (b) bf16 paged, {TELE_N} requests at once "
          f"through {TELE_SLOTS} slots (+{CONT_MAX_NEW} each): {served:.1f} "
          f"served tokens/s by the phase's clock ({wall:.3f} s; request "
          f"latency p50 {b['p50_ms']:.1f} ms, p95 {b['p95_ms']:.1f} ms); "
          f"{engine_clock_line(st)}; telemetry's host work {spy.calls} "
          f"calls, {spy.seconds * 1e3:.2f} ms = "
          f"{100 * b['telemetry_share']:.3f}% of the wall time ("
          + ", ".join(f"{k} {v:.2f} ms"
                      for k, v in b["telemetry_ms_by_part"].items())
          + "), every timed call under sync-debug 'error'; "
          f"decode steps {st['engine_steps']} taking {step_s:.3f} s "
          f"({100 * step_s / wall:.1f}%), prefill (admit -> first token, "
          f"summed over requests) {prefill_s:.3f} s [{card}]", flush=True)
    if on_card:
        b["profiled"] = profile_serving(torch, np, build(**bf16),
                                        tprompts[:TELE_SLOTS], card)
    out["b"] = b
    del engine, spy

    # (c) -------------------------------------------------------------
    def shed_run(policy, tag):
        engine = build(admission_policy=policy, **bf16)
        # the admission gate's ledger refresh, timed on its own
        scope = [0.0, 0]
        compose = engine._compose_kv_scope

        def timed_scope(*a, **kw):
            t = time.perf_counter()
            try:
                return compose(*a, **kw)
            finally:
                scope[0] += time.perf_counter() - t
                scope[1] += 1

        engine._compose_kv_scope = timed_scope

        async def one(p):
            try:
                return await engine(p)
            except OverloadedError as e:
                return e

        async def run():
            try:
                return await asyncio.gather(*(one(p) for p in tprompts))
            finally:
                engine.shutdown_engine()

        sync()
        t = time.perf_counter()
        res = asyncio.run(run())
        sync()
        wall = time.perf_counter() - t
        del engine._compose_kv_scope
        shed = sum(isinstance(r, OverloadedError) for r in res)
        served = [r for r in res if not isinstance(r, Exception)]
        reasons = engine.engine_stats()["rejections_by_reason"]
        print(f"[serve-telemetry] (c) {tag}: {shed} of {len(tprompts)} "
              f"shed, {len(served)} replied in {wall:.3f} s; the gate's "
              f"ledger refreshes {scope[1]} taking {1e3 * scope[0]:.3f} ms; "
              f"rejections_by_reason {reasons} [{card}]", flush=True)
        runs[tag] = {"wall_s": wall, "ledger_refreshes": scope[1],
                     "ledger_ms": 1e3 * scope[0]}
        for p, r in zip(tprompts, res):
            if not isinstance(r, Exception):
                check_replies(np, [p], [r], CONT_MAX_NEW, cfg.vocab_size,
                              tag)
            elif not isinstance(r, OverloadedError):
                fail(f"[serve-telemetry] (c) {tag}: a request raised {r!r}")
        return shed, len(served), reasons, engine

    def admission_costs(engine, reps=50):
        """The host work an admission_policy adds to each request, by
        part, in us a call: the telemetry read that decide() takes,
        and the headroom gate's ledger refresh (the pager's kvscope
        block, the allocator read) beside the segment walk it leaves
        out."""
        from ray_tpu_torch._private.device_stats import device_memory_stats

        parts = {
            "engine_stats for decide": engine._telemetry.engine_stats,
            "ledger refresh": lambda: engine._compose_kv_scope(
                largest_alloc=False),
            "pager kv_scope_stats": engine._pager.kv_scope_stats,
            "allocator read": lambda: device_memory_stats(
                [dev], largest_alloc=False),
            "allocator read + segment walk": lambda: device_memory_stats(
                [dev]),
        }
        us = {}
        for name, fn in parts.items():
            fn()
            t = time.perf_counter()
            for _ in range(reps):
                fn()
            us[name] = 1e6 * (time.perf_counter() - t) / reps
        print("[serve-telemetry] (c) an admission's host work, us a call ("
              f"{reps} calls each): " + ", ".join(
                  f"{k} {v:.1f}" for k, v in us.items()) + f" [{card}]",
              flush=True)
        return us

    runs = {}
    total = torch.cuda.mem_get_info(dev)[1] if on_card else None
    n, ok, reasons, _ = shed_run(
        AdmissionPolicy(max_queue_depth=TELE_MAX_QUEUE), "max_queue_depth=4")
    if not n or reasons != {"shed_queue_full": n} or n + ok != TELE_N:
        fail(f"[serve-telemetry] (c) the queue bound shed {n} and served "
             f"{ok}; rejections {reasons}")
    out["c"] = {"queue_full_shed": n}
    if on_card:
        n, ok, reasons, _ = shed_run(
            AdmissionPolicy(min_headroom_bytes=2 * total),
            "min_headroom_bytes=2 x the card's memory")
        if n != TELE_N or reasons != {"shed_hbm_headroom": TELE_N}:
            fail(f"[serve-telemetry] (c) a headroom above the card's memory "
                 f"shed {n} of {TELE_N}; rejections {reasons}")
        n, ok, reasons, engine = shed_run(
            AdmissionPolicy(min_headroom_bytes=1 << 30),
            "min_headroom_bytes=1 GiB")
        if n or ok != TELE_N:
            fail(f"[serve-telemetry] (c) a 1 GiB headroom shed {n}")
        out["c"]["admission_us"] = admission_costs(engine)
        del engine
        # the same traffic with no policy: the 1 GiB run's wall beside it
        if shed_run(None, "no admission_policy")[0]:
            fail("[serve-telemetry] (c) a run without a policy shed")
        out["c"]["headroom_runs"] = "all shed / none shed"
    out["c"]["runs"] = runs

    # (d) -------------------------------------------------------------
    old = os.environ.get("RAYTPU_FLIGHTREC_DIR")
    with tempfile.TemporaryDirectory() as d:
        os.environ["RAYTPU_FLIGHTREC_DIR"] = d
        try:
            engine = build(slo=SLOConfig(ttft_ms=0.001), **bf16)
            drive(engine, tprompts[:8], 8)
            blk = engine.engine_stats()["slo"]
            dumps = list(blk["dumps"])
            doc = None
            if dumps and os.path.dirname(dumps[0]) == d:
                with open(dumps[0]) as f:
                    doc = json.load(f)
        finally:
            if old is None:
                os.environ.pop("RAYTPU_FLIGHTREC_DIR", None)
            else:
                os.environ["RAYTPU_FLIGHTREC_DIR"] = old
    kinds = (doc or {}).get("counts_by_kind", {})
    print(f"[serve-telemetry] (d) SLO ttft 0.001 ms: breached "
          f"{blk['breached']}, breaches {blk['breaches']}, {len(dumps)} "
          f"dump(s); the dump's events by kind {kinds} [{card}]", flush=True)
    if not blk["breached"] or not dumps or doc is None \
            or not kinds.get("kv_reserve"):
        fail("[serve-telemetry] (d) the breach did not dump a flight record "
             "holding the pager's kv_reserve events")
    out["d"] = {"breaches": blk["breaches"], "dumps": len(dumps),
                "kinds": kinds}
    del engine

    # (e) -------------------------------------------------------------
    engine = build(**f32)
    label = "fleet/r0"
    mon = HealthMonitor(HealthConfig(**TELE_HEALTH))
    inj = ChaosInjector(ChaosConfig(
        seed=0, freeze_replica=0, freeze_after_waves=4,
        freeze_waves=TELE_FREEZE_POLLS, freeze_poll_ms=TELE_POLL_MS),
        monitor=mon)
    # as the fleet router attaches them (ray_tpu/serve/router.py:735-746)
    engine._replica_label = label
    engine._health = mon
    mon.register(label, role="both", recorder=engine._telemetry.flightrec,
                 telemetry=engine._telemetry)
    engine._chaos = inj
    inj.bind(label)

    async def prober():
        while True:
            mon.maybe_probe()
            await asyncio.sleep(TELE_HEALTH["probe_ms"] / 1e3)

    t0 = time.perf_counter()
    outs, _ = drive(engine, prompts, CONT_WAVE1, extra=prober)
    wall = time.perf_counter() - t0
    check_replies(np, prompts, outs, CONT_MAX_NEW, cfg.vocab_size, "e")
    ties += gate_against_oracle(torch, np, params, cfg, prompts, outs,
                                oracle, "e f32 paged+health+chaos",
                                "serve-telemetry")
    h = engine.engine_stats()["health"]
    log = [(x["from"], x["to"], x["reason"]) for x in h["transition_log"]]
    print(f"[serve-telemetry] (e) health + chaos freeze of "
          f"{TELE_FREEZE_POLLS} polls of {TELE_POLL_MS} ms: {len(prompts)} "
          f"f32 requests in {wall:.2f} s, equal to the oracle or parted at "
          f"a near-tie; transitions {log}; time_to_detect_ms "
          f"{h['time_to_detect_ms']}; chaos {inj.stats()} [{card}]",
          flush=True)
    if ("suspect", "dead", "heartbeat_lost") not in log \
            or log[-1][1] != "healthy" or h["time_to_detect_ms"] is None \
            or not any(t[1] == "suspect" for t in log):
        fail("[serve-telemetry] (e) the monitor did not log the frozen "
             "replica going suspect, dead and recovering")
    out["e"] = {"transitions": log, "time_to_detect_ms":
                h["time_to_detect_ms"], "wall_s": wall}
    del engine, mon, inj, params

    # (f) -------------------------------------------------------------
    batch = build_llm_deployment(
        "llama", preset, max_new_tokens=CONT_MAX_NEW,
        max_batch_size=TELE_BATCH_N, seed=0, device=dev,
        config_overrides=widths)()
    rs = np.random.RandomState(9)
    bprompts = [rs.randint(0, cfg.vocab_size, TELE_BATCH_T).astype(np.int32)
                for _ in range(TELE_BATCH_N)]
    zero_counts(fa)
    outs, _ = asyncio.run(_serve_waves(batch, bprompts, TELE_BATCH_N))
    sync()
    counts = read_counts(fa)
    check_replies(np, bprompts, outs, CONT_MAX_NEW, cfg.vocab_size, "f")
    st = batch.engine_stats()
    print(f"[serve-telemetry] (f) batch scheduler, {TELE_BATCH_N} "
          f"requests of {TELE_BATCH_T} tokens: requests {st['requests']}, "
          f"request latency count {st['request_latency_ms']['count']} p50 "
          f"{st['request_latency_ms']['p50']} ms; kernel launches {counts} "
          f"[{card}]", flush=True)
    want_fwd = cfg.n_layer if on_card else 0
    if st["requests"]["finished"] != TELE_BATCH_N \
            or st["request_latency_ms"]["count"] != TELE_BATCH_N \
            or counts["flash_fwd"] != want_fwd:
        fail(f"[serve-telemetry] (f) expected {TELE_BATCH_N} finished "
             f"requests with a latency sample each and {want_fwd} flash "
             f"forward launches; got {st['requests']} and {counts}")
    for k, v in counts.items():
        launches[k] = launches.get(k, 0) + v
    out["f"] = {"requests": st["requests"], "launches": counts}
    del batch
    if on_card:
        torch.cuda.empty_cache()
    return {"counts": launches, "near_ties": ties, **out}


def main() -> int:
    import numpy as np
    import torch

    name, card = phase_card(torch)
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    kernels = importlib.import_module("ray_tpu_torch.ops._kernels")
    fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")
    fc = _fc()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    ptxas = phase_build(kernels)
    with torch.inference_mode():
        headline = phase_kernel(torch, fa, card)
    headline["ptxas"] = ptxas["flash_fwd"].get("flash_fwd_bf16_kernel<64>",
                                               [])
    bwd = phase_kernel_bwd(torch, fa, card, ptxas["flash_bwd"])
    ce = phase_kernel_ce(torch, fc, card, ptxas["fused_ce"])
    serve_counts = phase_serve(torch, np, fa, card)["counts"]
    train = phase_train(torch, fa, card)
    train_ce = phase_train_ce(torch, fa, card)
    serve_llama = phase_serve(torch, np, fa, card, "llama", "serve-llama")
    with torch.inference_mode():
        serve_cont = phase_serve_continuous(torch, np, fa, card)
        gate = serve_cont.pop("gate")
        serve_spec = phase_serve_spec_disagg(torch, np, fa, card, gate)
        serve_tele = phase_serve_telemetry(torch, np, fa, card, gate)
    train_llama = phase_train_llama(torch, fa, fc, card)
    llama_7b = phase_llama_7b(torch, fa, fc, card)

    def launches(name):
        by_path = {"serve": serve_counts.get(name, 0),
                   "train": train["counts"].get(name, 0),
                   "train_pallas": train_ce["counts"][name],
                   "serve_llama": serve_llama["counts"].get(name, 0),
                   "serve_continuous": serve_cont["counts"].get(name, 0),
                   "serve_spec_disagg": serve_spec["counts"].get(name, 0),
                   "serve_telemetry": serve_tele["counts"].get(name, 0),
                   "train_llama": train_llama["counts"][name]}
        return {"launches": sum(by_path.values()),
                "launches_by_path": by_path,
                "launches_per_train_step":
                    train_ce["counts"][name] / train_ce["steps_run"],
                "launches_per_llama_train_step":
                    train_llama["counts"][name] / train_llama["steps_run"]}

    # each kernel at llama-1b's shapes (phase train-llama)
    at_llama = {"flash_fwd": train_llama["kernels"]["flash"]["fwd"],
                "flash_bwd_dq": train_llama["kernels"]["flash"]["dq"],
                "flash_bwd_dkv": train_llama["kernels"]["flash"]["dkv"],
                "fused_ce_fwd": train_llama["kernels"]["ce"]["fwd"],
                "fused_ce_bwd_dh": train_llama["kernels"]["ce"]["dh"],
                "fused_ce_bwd_dw": train_llama["kernels"]["ce"]["dw"]}

    src = "ray_tpu/ops/flash_attention.py"
    records = [
        {"name": "flash_fwd", "route": "cuda",
         "source": "ray_tpu_torch/ops/csrc/flash_fwd.cu",
         "replaces": f"{src}:68", "also_replaces": f"{src}:294",
         **launches("flash_fwd"), **headline,
         "train_shape": bwd["fwd_train_shape"]},
        {"name": "flash_bwd_dq", "route": "cuda",
         "source": "ray_tpu_torch/ops/csrc/flash_bwd.cu",
         "replaces": f"{src}:148", "also_replaces": f"{src}:358",
         **launches("flash_bwd_dq"), **bwd["dq"]},
        {"name": "flash_bwd_dkv", "route": "cuda",
         "source": "ray_tpu_torch/ops/csrc/flash_bwd.cu",
         "replaces": f"{src}:186", "also_replaces": f"{src}:395",
         **launches("flash_bwd_dkv"), **bwd["dkv"]},
    ]
    src = "ray_tpu/ops/fused_ce.py"
    for kernel, key, line in (("fused_ce_fwd", "fwd", 83),
                              ("fused_ce_bwd_dh", "dh", 164),
                              ("fused_ce_bwd_dw", "dw", 185)):
        records.append({"name": kernel, "route": "cuda",
                        "source": "ray_tpu_torch/ops/csrc/fused_ce.cu",
                        "replaces": f"{src}:{line}", **launches(kernel),
                        **ce[key]})
    for rec in records:
        rec["llama_1b_shape"] = at_llama[rec["name"]]
    for rec, keys in ((records[3], ("nll", "lse")), (records[4], ("dh",)),
                      (records[5], ("dw",))):
        rec["llama_7b_shape"] = {k: llama_7b["ce_kernels_vs_plain"][k]
                                 for k in keys}
    # ptxas's record of the cluster kernel that llama-1b's head runs
    plan = fc.fused_ce_bwd_plan(2048, LLAMA_B * LLAMA_T)
    for rec, mode in ((records[4], 1), (records[5], 2)):
        rec["llama_1b_shape"]["ptxas"] = ptxas["fused_ce"].get(
            f"fused_ce_bwd_bf16_cluster_kernel<{mode}, {plan.k}, {plan.c}, "
            f"{plan.sc}>", [])
    records[1]["llama_1b_shape"]["whole_backward"] = \
        train_llama["kernels"]["flash"]["whole"]
    print(card)
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
