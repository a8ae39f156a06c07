#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (ray_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (any failure exits non-zero):

1. card   — require CUDA; print the card's name and power limit.
2. build  — build every CUDA kernel from ray_tpu_torch/ops/csrc with nvcc.
3. kernel — hold the flash forward kernel against its plain PyTorch
            version at the serve shapes (B=8, H=12, D=64; T=512, 1024
            and an uneven 1000; causal and not; resident_kv on and off;
            bf16 and f32), and time it beside the plain version, a
            PyTorch library call computing the same function, and the
            card's bound.
4. serve  — build the GPT-2-124M engine (full width, seeded random
            weights, bf16 compute) on the card, answer 8 concurrent
            512-token requests and one ragged batch, check the replies,
            check that the prefill went through the kernel (its launch
            counter, zeroed just before), and time prefill and decode.

The line before the last is a JSON object describing each kernel; the
last line is {"ok": true, "device": {...}}.  There is no CPU path.
"""

from __future__ import annotations

import asyncio
import dataclasses
import importlib
import json
import math
import subprocess
import sys
import time
from pathlib import Path

# peak rates of one H100 SXM (NVIDIA data sheet, dense, at 700 W)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}

B, H, D = 8, 12, 64
# kernel vs plain version, max |difference| allowed:
# f32 O: the tolerance of the JAX package's flash tests; the kernel and
#   the plain version sum in different orders
# bf16 O: both compute in f32 and differ by the final rounding to bf16
#   (8 mantissa bits: one step is 2**-7 relative), plus order
# LSE (f32 in both cases): a log of a sum of up to T terms, magnitude
#   ~10, summed in another order
TOL = {("f32", "o"): 2e-5, ("bf16", "o"): 5e-2, ("f32", "lse"): 1e-4,
       ("bf16", "lse"): 1e-4}
# prefill last-token logits, flash kernel vs plain attention, bf16
# through 12 layers: the paths round P and O to bf16 at different
# places; logits are O(1) at this init
LOGIT_TOL = 0.1


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


def attention_bound_ms(T: int, causal: bool, dtype: str) -> tuple:
    """Least time for one (B, H, T, D) attention forward on this card:
    q, k, v read once, o and lse written once; 4*D operations per
    visible (query, key) pair."""
    elem = 2 if dtype == "bf16" else 4
    nbytes = 4 * B * H * T * D * elem + B * H * T * 4
    pairs = T * (T + 1) // 2 if causal else T * T
    flops = 4 * B * H * D * pairs
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


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


def phase_build(kernels) -> None:
    t0 = time.perf_counter()
    paths = kernels.build_all()
    secs = time.perf_counter() - t0
    print(f"[build] {len(paths)} kernel libraries in {secs:.2f} s",
          flush=True)
    for name, path in paths.items():
        log = path.with_suffix(".so.log")
        lines = log.read_text().splitlines() if log.exists() else []
        for line in lines:
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")


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
    fa.FLASH_FWD_LAUNCHES = 0
    t0 = time.perf_counter()
    outs = asyncio.run(_serve_all(engine, prompts))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fa.FLASH_FWD_LAUNCHES
    check(prompts, outs)
    if launches != cfg.n_layer:
        fail(f"flash kernel launched {launches} times for the "
             f"equal-length prefill, expected {cfg.n_layer}")
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
    return launches


def main() -> int:
    import numpy as np
    import torch

    name, card = phase_card(torch)
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    kernels = importlib.import_module("ray_tpu_torch.ops._kernels")
    fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase_build(kernels)
    with torch.inference_mode():
        headline = phase_kernel(torch, fa, card)
    launches = phase_serve(torch, np, fa, card)

    record = {"name": "flash_fwd", "route": "cuda",
              "source": "ray_tpu_torch/ops/csrc/flash_fwd.cu",
              "replaces": "ray_tpu/ops/flash_attention.py:68",
              "also_replaces": "ray_tpu/ops/flash_attention.py:294",
              "launches": launches, **headline}
    print(json.dumps({"kernels": [record]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
