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
            bf16 and f32), and time it beside the plain version, a
            PyTorch library call computing the same function, and the
            card's bound.
4. kernel-bwd — hold the flash backward kernels (dQ with the delta
            it computes, dK/dV) against their plain PyTorch versions at
            B*H=24, T=1024, 1000 and 77, D=32, 64 and 128, causal and
            not, bf16 and f32, and the whole backward against the two
            kernels called alone (bit-equal), then hold them and the
            forward against their plain versions at the training shape
            (B=24, H=12, T=1024, D=64, causal, bf16), where they are
            timed beside their plain versions and their bounds (the
            share of it each reaches, grids and waves), and the whole
            backward against scaled_dot_product_attention's backward
            in turns.
5. kernel-ce — hold the fused lm-head + cross-entropy kernels
            (forward, dH, dW) against their plain PyTorch versions at
            the card tests' shapes (bf16 and f32) and at the training
            shape (N=B*T=24576, V=50304, valid 50257, D=768, bf16, g =
            1/N as the mean loss gives), where they are timed beside
            their plain versions, their bounds (and the share of it
            each reaches), their grids and the dense composition (the
            dense CE's logits product, logsumexp and gather; its
            backward for dH and dW together, and the ratio of dH + dW
            to it), a yardstick the fused path never calls.
6. serve  — build the GPT-2-124M engine (full width, seeded random
            weights, bf16 compute) on the card, answer 8 concurrent
            512-token requests and one ragged batch, check the replies,
            check that the prefill went through the kernel (its launch
            counter, zeroed just before), and time prefill and decode.
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
            peak memory of each step, and a profile of one pallas step.

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

# peak rates of one H100 SXM (NVIDIA data sheet, dense, at 700 W)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}

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
             (65, 1088, 1000, 64), (130, 513, 500, 128))
# GPT-2-124M's head at the training shape
CE_N, CE_V, CE_VALID, CE_D = TRAIN_B * TRAIN_T, 50304, 50257, 768
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


def bound_ms(nbytes: float, flops: float, dtype: str) -> tuple:
    """(least time on this card in ms, "bytes" or "operations"): the
    larger of the bytes over the memory rate and the operations over
    the peak rate of their type."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def visible_pairs(T: int, causal: bool) -> int:
    return T * (T + 1) // 2 if causal else T * T


def attention_bound_ms(T: int, causal: bool, dtype: str,
                       bh: int = B * H) -> tuple:
    """Least time for one (BH, T, D) attention forward on this card:
    q, k, v read once, o and lse written once; 4*D operations per
    visible (query, key) pair."""
    elem = 2 if dtype == "bf16" else 4
    nbytes = 4 * bh * T * D * elem + bh * T * 4
    return bound_ms(nbytes, 4 * bh * D * visible_pairs(T, causal), dtype)


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
    cases = [(T, causal, dt) for T in (512, 1024)
             for causal in (True, False) for dt in ("bf16", "f32")]
    cases += [(1000, True, "bf16"), (1000, True, "f32")]
    headline = None
    for T, causal, dt in cases:
        q4, k4, v4 = (torch.randn((B, T, H, D), generator=gen, device=dev)
                      .to(dtypes[dt]) for _ in range(3))
        q3, k3, v3 = (x.transpose(1, 2).reshape(B * H, T, D)
                      for x in (q4, k4, v4))
        scale = 1.0 / math.sqrt(D)
        o_ref, lse_ref = fa.flash_attention_fwd_reference(
            q3, k3, v3, scale=scale, causal=causal)
        o, lse = fa.flash_attention_fwd(q3, k3, v3, scale=scale,
                                        causal=causal)
        torch.cuda.synchronize()
        err_o = (o.float() - o_ref.float()).abs().max().item()
        err_lse = (lse - lse_ref).abs().max().item()
        o_ref4 = o_ref.reshape(B, H, T, D).transpose(1, 2).float()
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
        bound, bound_by = attention_bound_ms(T, causal, dt)
        print(f"[kernel] T={T} causal={causal} {dt}: max|o-plain| "
              f"{err_o:.3e} (resident on {err_res[True]:.3e}, off "
              f"{err_res[False]:.3e}; tol {TOL[(dt, 'o')]:.0e}), "
              f"max|lse-plain| {err_lse:.3e} (tol "
              f"{TOL[(dt, 'lse')]:.0e}); kernel {ms:.4f} ms, bound "
              f"{bound:.4f} ms ({bound_by}) [{card}]", flush=True)
        if not ok:
            fail(f"kernel disagrees with its plain version at T={T} "
                 f"causal={causal} {dt}")
        if (T, causal, dt) == (512, True, "bf16"):
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


def phase_serve(torch, np, fa, card: str) -> int:
    from ray_tpu_torch.models import gpt2_decode
    from ray_tpu_torch.serve import build_llm_deployment

    max_new, t_prompt = 16, 512
    t0 = time.perf_counter()
    engine = build_llm_deployment("gpt2", "gpt2", max_new_tokens=max_new,
                                  max_batch_size=8, seed=0)()
    cfg = engine.cfg
    torch.cuda.synchronize()
    print(f"[serve] GPT-2 {cfg.n_layer} layers, d={cfg.d_model}, "
          f"{cfg.n_head} heads, vocab {cfg.padded_vocab}, compute "
          f"{cfg.dtype}, params {cfg.param_dtype}: engine up in "
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
    print(f"[serve] 8 x {t_prompt}-token requests: {launches} flash "
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
    print(f"[serve] ragged batch of {len(ragged)} answered (0 kernel "
          f"launches: ragged prefill takes the plain masked attention)",
          flush=True)

    toks = torch.from_numpy(np.stack(prompts)).cuda()
    with torch.inference_mode():
        cfg_flash = dataclasses.replace(cfg, use_flash=True)
        cfg_plain = dataclasses.replace(cfg, use_flash=False)
        lf, _ = gpt2_decode.prefill(engine.params, toks, cfg_flash)
        lp, _ = gpt2_decode.prefill(engine.params, toks, cfg_plain)
        torch.cuda.synchronize()
        if lf.shape != (8, cfg.padded_vocab) or \
                not bool(torch.isfinite(lf).all()):
            fail("prefill logits are not finite (8, padded_vocab)")
        diff = (lf - lp).abs().max().item()
        print(f"[serve] prefill last-token logits, flash vs plain "
              f"attention: max|diff| {diff:.4e} (tol {LOGIT_TOL}; "
              f"max|logit| {lp.abs().max().item():.3f})", flush=True)
        if diff > LOGIT_TOL:
            fail("flash and plain prefill logits disagree")

        # prefill with the kernel and with plain attention, in turns
        # (flash, plain, plain, flash, ...) so both see the same host
        prefill_s = {"flash": [], "plain": []}
        for name in ["flash", "plain", "plain", "flash"] * 3:
            c = cfg_flash if name == "flash" else cfg_plain
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, cache = gpt2_decode.prefill(engine.params, toks, c)
            torch.cuda.synchronize()
            prefill_s[name].append(time.perf_counter() - t0)
        med = {k: sorted(v)[len(v) // 2] * 1e3 for k, v in
               prefill_s.items()}
        step_tok = torch.zeros((8,), dtype=torch.int32, device="cuda")
        gpt2_decode.decode_step(engine.params, cache, step_tok, cfg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(max_new):
            _, cache = gpt2_decode.decode_step(engine.params, cache,
                                               step_tok, cfg)
        torch.cuda.synchronize()
        decode_ms = (time.perf_counter() - t0) / max_new * 1e3
    print(f"[serve] prefill B=8 T={t_prompt}, median of 6: "
          f"{med['flash']:.2f} ms with the flash kernel, "
          f"{med['plain']:.2f} ms with plain attention; decode B=8: "
          f"{decode_ms:.2f} ms/token step [{card}]", flush=True)
    return counts


def check_train_shape(torch, fa, seed: int = 2) -> dict:
    """Hold the forward kernel (o, lse) and the backward kernels (dq,
    dk, dv) against their plain versions at the training shape (B=24,
    H=12, T=1024, D=64, causal, bf16); fail if any disagrees.  Returns
    the inputs and outputs, for timing."""
    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev).manual_seed(seed)
    bh, T = TRAIN_B * H, TRAIN_T
    kw = dict(scale=1.0 / math.sqrt(D), causal=True)
    t = dict(zip(("q4", "k4", "v4", "do4"), (
        torch.randn((TRAIN_B, T, H, D), generator=gen, device=dev)
        .to(torch.bfloat16) for _ in range(4))))
    for n in ("q", "k", "v", "do"):
        t[f"{n}3"] = t[f"{n}4"].transpose(1, 2).reshape(bh, T, D)
    with torch.no_grad():
        q3, k3, v3, do3 = (t[n] for n in ("q3", "k3", "v3", "do3"))
        o3, lse = fa.flash_attention_fwd(q3, k3, v3, **kw)
        o_ref, lse_ref = fa.flash_attention_fwd_reference(q3, k3, v3, **kw)
        torch.cuda.synchronize()
        err_o = (o3.float() - o_ref.float()).abs().max().item()
        err_lse = (lse - lse_ref).abs().max().item()
        del o_ref, lse_ref
        print(f"[kernel-bwd] training shape B={TRAIN_B} T={T} H={H} D={D} "
              f"causal bf16: forward max|o-plain| {err_o:.3e} (tol "
              f"{TOL[('bf16', 'o')]:.0e}), max|lse-plain| {err_lse:.3e} "
              f"(tol {TOL[('bf16', 'lse')]:.0e})", flush=True)
        if err_o > TOL[("bf16", "o")] or err_lse > TOL[("bf16", "lse")]:
            fail("the forward kernel disagrees with its plain version at "
                 "the training shape")
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
    print(f"[kernel-bwd] training shape backward: {bwd_report(cmp)} (tol "
          f"{BWD_TOL['bf16'][0]:.0e} + {BWD_TOL['bf16'][1]:.0e}*|plain|, "
          f"rel {BWD_REL_NORM['bf16']:.0e}); delta from the dQ kernel "
          f"max|d| {dcmp['max']:.3e} ({dcmp['share']:.3f} of its bound "
          f"2 (D + 1) 2**-24 sum|dO O|)", flush=True)
    if not all(c["ok"] for c in cmp) or not dcmp["ok"]:
        fail("backward kernels disagree with their plain version at the "
             "training shape")
    t.update(o3=o3, lse=lse, delta=delta,
             err={"dq": cmp[0]["max"], "dkv": max(cmp[1]["max"],
                                                 cmp[2]["max"]),
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
                  q3, k3, v3, do3, lse, delta, **kw)),
              "fwd": time_ms(torch, lambda: fa.flash_attention_fwd(
                  q3, k3, v3, **kw))}
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
        del first, second
        qh, kh, vh, doh = (x.transpose(1, 2).contiguous()
                           for x in (q4, k4, v4, do4))
        sdpa_fwd = time_ms(torch, lambda: F.scaled_dot_product_attention(
            qh, kh, vh, is_causal=True))
    print(f"[kernel-bwd]   two calls of the whole backward bit-equal (dq, "
          f"dk, dv): {deterministic}", flush=True)
    if not deterministic:
        fail("the backward kernels gave different results on the same "
             "inputs")
    qh, kh, vh = (x.requires_grad_(True) for x in (qh, kh, vh))
    out = F.scaled_dot_product_attention(qh, kh, vh, is_causal=True)
    sdpa_fn = lambda: torch.autograd.grad(out, (qh, kh, vh), doh,
                                          retain_graph=True)
    # the whole backward and SDPA's backward in turns (port, sdpa, sdpa,
    # port, ...), each a mean of 20 calls, medians over the rounds
    turns = {"port": [], "sdpa": []}
    for i in range(BWD_TURNS):
        order = ("port", "sdpa") if i % 2 == 0 else ("sdpa", "port")
        for name in order:
            turns[name].append(time_ms(torch, whole_fn if name == "port"
                                       else sdpa_fn))
    med = {k: sorted(v)[len(v) // 2] for k, v in turns.items()}
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
    print(f"[kernel-bwd]   forward: kernel {ms['fwd']:.4f} ms, plain "
          f"{plain['fwd']:.4f} ms, scaled_dot_product_attention "
          f"{sdpa_fwd:.4f} ms, bound {fwd_bound[0]:.4f} ms "
          f"({fwd_bound[1]}) [{card}]", flush=True)
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
                                  "library_ms": sdpa_fwd}
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


def phase_kernel_ce(torch, fc, card: str) -> dict:
    from ray_tpu_torch.models.gpt2 import _LogitsMatmul, nll_from_logits

    for i, (n, v, valid, d) in enumerate(CE_SHAPES):
        for dtype in ("bf16", "f32"):
            check_ce_kernels(torch, fc, n, v, valid, d, dtype, seed=10 + i)
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
    hg, wg = h.detach().requires_grad_(True), w.detach().requires_grad_(True)
    nll = nll_from_logits(_LogitsMatmul.apply(hg, wg), tgt, valid, CE_V)
    dense_bwd = time_ms(torch, lambda: torch.autograd.grad(
        nll, (hg, wg), g, retain_graph=True), iters=5)
    del nll, hg, wg
    bounds = ce_bounds_ms(CE_N, CE_V, valid, CE_D)
    # how many CTAs each kernel runs (the module's tiles), in waves over
    # the card's SMs
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    slices = -(-CE_D // fc.BWD_SLICE_COLS)
    ctas = {"fwd": -(-CE_N // fc.FWD_BLOCK_ROWS),
            "dh": -(-CE_N // fc.BWD_BLOCK_ROWS) * slices,
            "dw": -(-CE_V // fc.BWD_BLOCK_ROWS) * slices}
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
    records = {}
    for k, cmp_keys in (("fwd", ("nll", "lse")), ("dh", ("dh",)),
                        ("dw", ("dw",))):
        records[k] = {
            "max_abs_err": max(t["cmp"][c]["max"] for c in cmp_keys),
            "ms": ms[k], "plain_ms": plain[k], "bound_ms": bounds[k][0],
            "bound_by": bounds[k][1],
            "library_ms": dense_fwd if k == "fwd" else None,
            "bound_share": share[k], "dense_composition": dense,
            "ctas": ctas[k]}
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
                 card: str) -> dict:
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
    print(f"[train] profile of one {name} step: {device_ms:.2f} ms of "
          f"device time in {len(events)} distinct kernels, "
          f"{device_ms / step_ms:.3f} of the unprofiled median step "
          f"({step_ms:.2f} ms) [{card}]", flush=True)
    kinds = {}
    for e in events:
        kind = next((k for k, marks in PROFILE_KINDS if any(
            m in e.key for m in marks)), "other elementwise")
        kinds[kind] = kinds.get(kind, 0.0) + e.self_device_time_total / 1e3
    print(f"[train]   {name} step by kind: " + ", ".join(
        f"{k} {v:.2f} ms" for k, v in sorted(kinds.items(),
                                              key=lambda kv: -kv[1])),
          flush=True)
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"[train]   {e.self_device_time_total / 1e3:8.3f} ms "
              f"x{e.count:<5d} {e.key[:90]}", flush=True)
    return kinds


def interleaved_steps(torch, params, batch, cfgs: dict, order) -> tuple:
    """AdamW steps of each config in ``cfgs``, each from its own copy of
    ``params``, run in ``order`` (names of cfgs); returns (the steps'
    state for profile_step, {name: [wall seconds]})."""
    from ray_tpu_torch.models.gpt2 import gpt2_loss
    from ray_tpu_torch.train import adamw, build_train_step
    from ray_tpu_torch.train.optim import tree_map

    tx = adamw(3e-4, weight_decay=0.1)
    state = {"batch": batch}
    for name, c in cfgs.items():
        p = tree_map(torch.clone, params)
        state[name] = [build_train_step(lambda p, b, c=c: gpt2_loss(p, b, c),
                                        tx), p, tx.init(p)]
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


def report_medians(result: dict, wall: dict, tag: str, card: str) -> None:
    """Median wall time, tokens/s and MFU of each interleaved step."""
    from ray_tpu_torch.bench import H100_BF16_PEAK_FLOPS
    from ray_tpu_torch.models.gpt2 import gpt2_config, gpt2_param_count

    n_params = gpt2_param_count(gpt2_config("gpt2"))
    for name, secs in wall.items():
        med = sorted(secs)[len(secs) // 2]
        tps = TRAIN_B * TRAIN_T / med
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
    loss, the global gradient norm, the nonfinite count, the wte
    gradient, the kernel launches (counters zeroed just before) and the
    step's peak memory."""
    from ray_tpu_torch.models.gpt2 import gpt2_loss
    from ray_tpu_torch.train.optim import tree_leaves, tree_unflatten

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(fa)
    live = [x.detach().requires_grad_(True) for x in tree_leaves(params)]
    loss = gpt2_loss(tree_unflatten(params, live), batch, cfg)
    grads = torch.autograd.grad(loss, live)
    torch.cuda.synchronize()
    out = {"loss": loss.item(), "grad_norm": torch.stack(
        [g.float().square().sum() for g in grads]).sum().sqrt().item(),
        "nonfinite": sum(int((~g.isfinite()).sum()) for g in grads),
        "wte": tree_unflatten(params, list(grads))["wte"].float(),
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


def check_ce_and_remat_steps(torch, fa, cfg) -> tuple:
    """One step of each CE_STEPS entry on the same seeded weights and
    batch, each against its reference step (loss, gradient norm, wte
    gradient over all rows and over the head-only rows) and for its
    launches: 12 of each flash kernel per step
    under mlp_only, 24 forward and 12 of each backward under the
    selective policies (the per-layer counts of the CPU test
    test_flash_calls_per_step_follow_remat), 1 of each fused CE kernel
    with ce_impl="pallas" and none otherwise.  Returns (params, batch,
    {name: step})."""
    from ray_tpu_torch.models.gpt2 import gpt2_init

    gen = torch.Generator(device="cuda").manual_seed(1)
    params = gpt2_init(cfg, gen, device="cuda")
    batch = {"tokens": torch.randint(0, cfg.vocab_size,
                                     (TRAIN_B, TRAIN_T + 1), generator=gen,
                                     device="cuda")}
    head_only = torch.ones(cfg.padded_vocab, dtype=torch.bool,
                           device="cuda")
    head_only[batch["tokens"][:, :-1].flatten()] = False
    L = cfg.n_layer
    steps, bad = {}, []
    for name, (kw, refs) in CE_STEPS.items():
        c = dataclasses.replace(cfg, **kw)
        st = one_step(torch, fa, params, batch, c)
        steps[name] = st
        fwd = 2 * L if c.remat_policy in ("dots", "dots_nb", "attn_out") \
            else L
        want = {"flash_fwd": fwd, "flash_bwd_dq": L, "flash_bwd_dkv": L}
        if c.ce_impl == "pallas":
            want.update(fused_ce_fwd=1, fused_ce_bwd_dh=1,
                        fused_ce_bwd_dw=1)
        line = (f"[train-ce] one step, ce {c.ce_impl}, remat "
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
            r = steps[ref]
            dl = abs(st["loss"] - r["loss"])
            dg = abs(st["grad_norm"] - r["grad_norm"]) / r["grad_norm"]
            diff = st["wte"] - r["wte"]
            dw = (diff.norm() / r["wte"].norm()).item()
            dh = (diff[head_only].norm()
                  / r["wte"][head_only].norm()).item()
            st["vs"][ref] = {"loss_diff": dl, "grad_norm_rel": dg,
                             "wte_grad_rel": dw, "head_rows_rel": dh}
            head_tol = CE_HEAD_GRAD_RTOL["dense" if ref == "dense"
                                         else "f32"]
            line += (f"; vs {ref}: loss |diff| {dl:.3e} (tol "
                     f"{CE_LOSS_TOL}), grad norm rel diff {dg:.3e} (tol "
                     f"{CE_GRAD_NORM_RTOL}), ||wte grad - {ref}|| / ||"
                     f"{ref}|| {dw:.3e} (tol {CE_WTE_GRAD_RTOL}), on the "
                     f"{int(head_only.sum())} head-only rows {dh:.3e} "
                     f"(tol {head_tol})")
            if dl > CE_LOSS_TOL or dg > CE_GRAD_NORM_RTOL or \
                    dw > CE_WTE_GRAD_RTOL or dh > head_tol:
                bad.append(f"{name} disagrees with {ref}")
        print(line, flush=True)
    for st in steps.values():
        del st["wte"]
    if bad:
        fail("; ".join(bad))
    return params, batch, steps


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
    result["profile"] = profile_step(torch, state, "pallas",
                                     result["pallas_step_ms"], card)
    return result


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
    bwd = phase_kernel_bwd(torch, fa, card, ptxas["flash_bwd"])
    ce = phase_kernel_ce(torch, fc, card)
    serve_counts = phase_serve(torch, np, fa, card)
    train = phase_train(torch, fa, card)
    train_ce = phase_train_ce(torch, fa, card)

    def launches(name):
        by_path = {"serve": serve_counts.get(name, 0),
                   "train": train["counts"].get(name, 0),
                   "train_pallas": train_ce["counts"][name]}
        return {"launches": sum(by_path.values()),
                "launches_by_path": by_path,
                "launches_per_train_step":
                    train_ce["counts"][name] / train_ce["steps_run"]}

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
    print(card)
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
