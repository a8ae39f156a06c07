#!/usr/bin/env python3
"""Where the bf16 flash-attention backward kernels (dQ, dK/dV) spend
their time.

    python3 flash_bwd_limits.py

Builds variants of ray_tpu_torch/ops/csrc/flash_bwd.cu by text edits,
all at once, and times the whole backward (the dQ kernel, then the
dK/dV kernel) and each kernel alone at GPT-2-124M's training shape
(B=24, H=12, T=1024, D=64, causal, bf16), the variants and the backward
of scaled_dot_product_attention in turns, on one NVIDIA GPU:

  as_built      the kernels as they are
  two_consumers two consumer warpgroups of 64 rows per CTA, one CTA an SM
  ungrouped     every head's block of most work first, heads not grouped
  stages_4      a ring of four stages instead of two
  no_exp        P without its exp (wrong results)
  scores_only   no accumulating products (dQ += dS K; dV, dK): S and dP
                only (wrong results)
  no_wgmma      no products at all: the tile stream, the elementwise work
                and the barriers (wrong results)

The design variants are checked against the plain version at the
training shape; the ones with work taken out are timed only.  A variant
with little compute left that takes nearly the time of the kernels as
built says that streaming, latency or the elementwise work holds them.
The variants build into ray_tpu_torch/_build/limits/.  Exits non-zero
without a CUDA device.
"""

from __future__ import annotations

import ctypes
import importlib
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
B, H, T, D = 24, 12, 1024, 64
ROUNDS = 5

# (old, new, times the old text occurs in flash_bwd.cu)
PRODUCTS = ("for (int kk = 0; kk < 4; ++kk)",
            "for (int kk = 0; kk < 0; ++kk)", 3)
SCORES = ("for (int ks = 0; ks < Tl::kKSteps; ++ks)",
          "for (int ks = 0; ks < 0; ++ks)", 4)
VARIANTS = {
    "as_built": [],
    "two_consumers": [("constexpr int kConsumers = 1;",
                       "constexpr int kConsumers = 2;", 1)],
    "ungrouped": [("const int group = max(1, sms * kCtasPerSm / blocks);",
                   "const int group = bh;", 1)],
    "stages_4": [("constexpr int kStages = 2;", "constexpr int kStages = 4;",
                  1)],
    "no_exp": [('asm("ex2.approx.ftz.f32 %0, %1;\\n" : "=f"(y) : "f"(x));',
                "y = x;", 1)],
    "scores_only": [PRODUCTS],
    "no_wgmma": [PRODUCTS, SCORES],
}
#: variants that compute the same gradients as the kernels as built
CHECKED = ("as_built", "two_consumers", "ungrouped", "stages_4")


def start_build(kernels, src: Path, name: str):
    """Write variant `name` of flash_bwd.cu into its own csrc copy and
    start nvcc on it; returns (process, library path)."""
    text = (src / "flash_bwd.cu").read_text()
    for old, new, count in VARIANTS[name]:
        if text.count(old) != count:
            raise SystemExit(f"flash_bwd_limits: variant {name} no longer "
                             f"matches flash_bwd.cu: {old[:50]!r}")
        text = text.replace(old, new)
    csrc = kernels.BUILD_DIR / "limits" / name
    shutil.rmtree(csrc, ignore_errors=True)
    csrc.mkdir(parents=True)
    for header in src.glob("*.cuh"):
        shutil.copy(header, csrc / header.name)
    (csrc / "flash_bwd.cu").write_text(text)
    lib = csrc / "libflash_bwd.so"
    proc = subprocess.Popen(
        [kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", str(lib),
         str(csrc / "flash_bwd.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, lib


def load(kernels, proc, lib: Path, name: str) -> ctypes.CDLL:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise SystemExit(f"flash_bwd_limits: variant {name} does not build:"
                         f"\n{log[-3000:]}")
    notes = [ln.strip() for ln in log.splitlines()
             if "C75" in ln or ("spill" in ln and " 0 bytes spill" not in ln)]
    print(f"[build] {name}: {len(notes)} ptxas notes (spills, C75xx)" +
          "".join(f"\n    {n[:150]}" for n in notes[:2]), flush=True)
    so = ctypes.CDLL(str(lib))
    for fn, argtypes in kernels.SIGNATURES["flash_bwd"].items():
        getattr(so, fn).argtypes = list(argtypes)
        getattr(so, fn).restype = ctypes.c_int
    return so


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("flash_bwd_limits: FAILED: no CUDA device")
    sys.path.insert(0, str(ROOT))
    kernels = importlib.import_module("ray_tpu_torch.ops._kernels")
    fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")
    F = torch.nn.functional
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    builds = {name: start_build(kernels, kernels._CSRC, name)
              for name in VARIANTS}
    libs = {name: load(kernels, *builds[name], name) for name in VARIANTS}

    gen = torch.Generator(device="cuda").manual_seed(2)
    q4, k4, v4, do4 = (torch.randn((B, T, H, D), generator=gen,
                                   device="cuda").bfloat16()
                       for _ in range(4))
    q, k, v, do = (x.transpose(1, 2).reshape(B * H, T, D).contiguous()
                   for x in (q4, k4, v4, do4))
    bh, scale = B * H, D ** -0.5
    o, lse = fa.flash_attention_fwd(q, k, v, scale=scale, causal=True)
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    delta = torch.empty((bh, 1, T), device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    ptr = [x.data_ptr() for x in (q, k, v, o, do, lse, delta, dq, dk, dv)]

    def dq_fn(so):
        return lambda: so.flash_bwd_dq(*ptr[:8], bh, T, D, scale, 1, 1,
                                       stream)

    def dkv_fn(so):
        return lambda: so.flash_bwd_dkv(
            ptr[0], ptr[1], ptr[2], ptr[4], ptr[5], ptr[6], ptr[8], ptr[9],
            bh, T, D, scale, 1, 1, stream)

    want = fa.flash_attention_bwd_reference(q, k, v, o, lse, do,
                                            scale=scale, causal=True)
    for name in CHECKED:
        assert dq_fn(libs[name])() == 0 and dkv_fn(libs[name])() == 0
        torch.cuda.synchronize()
        rel = [((a.float() - b.float()).norm() / b.float().norm()).item()
               for a, b in zip((dq, dk, dv), want)]
        print(f"[check] {name}: ||kernel - plain|| / ||plain|| dq "
              f"{rel[0]:.3e} dk {rel[1]:.3e} dv {rel[2]:.3e} (bound 2e-3)",
              flush=True)
        if max(rel) > 2e-3:
            raise SystemExit(f"flash_bwd_limits: FAILED: {name} disagrees "
                             f"with the plain version")
    del want

    def time_ms(fn, iters: int = 20) -> float:
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

    qh, kh, vh, doh = (x.transpose(1, 2).contiguous() for x in
                       (q4, k4, v4, do4))
    qh, kh, vh = (x.requires_grad_(True) for x in (qh, kh, vh))
    out = F.scaled_dot_product_attention(qh, kh, vh, is_causal=True)
    fns = {name: (lambda d=dq_fn(so), kv=dkv_fn(so): (d(), kv()))
           for name, so in libs.items()}
    fns["sdpa_backward"] = lambda: torch.autograd.grad(
        out, (qh, kh, vh), doh, retain_graph=True)
    names = list(fns)
    whole = {n: [] for n in names}
    for r in range(ROUNDS):
        for n in (names if r % 2 == 0 else names[::-1]):
            whole[n].append(time_ms(fns[n]))
    med = {n: sorted(x)[len(x) // 2] for n, x in whole.items()}
    for n in names:
        split = "" if n == "sdpa_backward" else (
            f"; dQ {time_ms(dq_fn(libs[n])):.4f} ms, dK/dV "
            f"{time_ms(dkv_fn(libs[n])):.4f} ms")
        print(f"[limits] {n:13s}: whole backward {med[n]:.4f} ms (median "
              f"of {ROUNDS} in turns, {med[n] / med['as_built']:.3f}x as "
              f"built){split} [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
