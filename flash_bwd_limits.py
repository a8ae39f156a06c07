#!/usr/bin/env python3
"""Where the bf16 flash-attention kernels spend their time.

    python3 flash_bwd_limits.py            # the backward (dQ, dK/dV)
    python3 flash_bwd_limits.py forward    # the forward

Builds variants of ray_tpu_torch/ops/csrc/flash_bwd.cu (or flash_fwd.cu)
by text edits, all at once, and times the whole backward (the dQ kernel,
then the dK/dV kernel) and each kernel alone (or the forward) at
GPT-2-124M's training shape (B=24, H=12, T=1024, D=64, causal, bf16),
the variants and scaled_dot_product_attention's backward (or forward)
in turns, on one NVIDIA GPU.  Backward variants:

  as_built      the kernels as they are
  two_consumers two consumer warpgroups of 64 rows per CTA, one CTA an SM
  ungrouped     every head's block of most work first, heads not grouped
  stages_4      a ring of four stages instead of two
  no_exp        P without its exp (wrong results)
  scores_only   no accumulating products (dQ += dS K; dV, dK): S and dP
                only (wrong results)
  no_wgmma      no products at all: the tile stream, the elementwise work
                and the barriers (wrong results)

Forward variants:

  as_built      the kernel as it is (one consumer, two CTAs an SM, K/V
                tiles of 128 rows at D = 64)
  two_consumers two consumer warpgroups of 64 query rows, one CTA an SM
  kv_64         K/V tiles of 64 rows
  stages_3      a ring of three stages instead of two
  ungrouped     every head's block of most work first, heads not grouped
  no_exp        P without its exp2 (wrong results)
  no_pv         no O += P V product (wrong results)

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

# (old, new, times the old text occurs in the kernel's source, or in
# sm90.cuh where the edit names it)
NO_EXP = ('asm("ex2.approx.ftz.f32 %0, %1;\\n" : "=f"(y) : "f"(x));',
          "y = x;", 1, "sm90.cuh")
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
    "no_exp": [NO_EXP],
    "scores_only": [PRODUCTS],
    "no_wgmma": [PRODUCTS, SCORES],
}
FWD_VARIANTS = {
    "as_built": [],
    "two_consumers": [("constexpr int kConsumers = 1;",
                       "constexpr int kConsumers = 2;", 1)],
    "kv_64": [("value = D <= 64 ? 128 : 64;", "value = 64;", 1)],
    "stages_3": [("constexpr int kStages = 2;  // ring stages",
                  "constexpr int kStages = 3;  // ring stages", 1)],
    "ungrouped": [("const int group = max(1, sms * kCtasPerSm / blocks);",
                   "const int group = bh;", 1)],
    "no_exp": [NO_EXP],
    "no_pv": [("for (int kk = 0; kk < kN / 16; ++kk)",
               "for (int kk = 0; kk < 0; ++kk)", 1)],
}
#: variants that compute the same results as the kernels as built
CHECKED = ("as_built", "two_consumers", "ungrouped", "stages_4", "kv_64",
           "stages_3")


def start_build(kernels, src: Path, lib_name: str, name: str, edits):
    """Write variant `name` of <lib_name>.cu (and the headers), with
    `edits`, into its own csrc copy and start nvcc on it; returns
    (process, library path)."""
    texts = {f.name: f.read_text() for f in src.glob("*.cuh")}
    texts[f"{lib_name}.cu"] = (src / f"{lib_name}.cu").read_text()
    for old, new, count, *where in edits:
        target = where[0] if where else f"{lib_name}.cu"
        if texts[target].count(old) != count:
            raise SystemExit(f"flash_bwd_limits: variant {name} no longer "
                             f"matches {target}: {old[:50]!r}")
        texts[target] = texts[target].replace(old, new)
    csrc = kernels.BUILD_DIR / "limits" / f"{lib_name}_{name}"
    shutil.rmtree(csrc, ignore_errors=True)
    csrc.mkdir(parents=True)
    for fname, text in texts.items():
        (csrc / fname).write_text(text)
    lib = csrc / f"lib{lib_name}.so"
    proc = subprocess.Popen(
        [kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", str(lib),
         str(csrc / f"{lib_name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, lib


def load(kernels, proc, lib: Path, lib_name: str, name: str) -> ctypes.CDLL:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise SystemExit(f"flash_bwd_limits: variant {name} does not build:"
                         f"\n{log[-3000:]}")
    notes = [ln.strip() for ln in log.splitlines()
             if "C75" in ln or ("spill" in ln and " 0 bytes spill" not in ln)]
    print(f"[build] {name}: {len(notes)} ptxas notes (spills, C75xx)" +
          "".join(f"\n    {n[:150]}" for n in notes[:2]), flush=True)
    so = ctypes.CDLL(str(lib))
    for fn, argtypes in kernels.SIGNATURES[lib_name].items():
        getattr(so, fn).argtypes = list(argtypes)
        getattr(so, fn).restype = ctypes.c_int
    return so


def time_ms(torch, fn, iters: int = 20) -> float:
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


def in_turns(torch, fns: dict) -> dict:
    """Median over ROUNDS of each function's mean time, the functions in
    turns (forwards, then backwards)."""
    names = list(fns)
    runs = {n: [] for n in names}
    for r in range(ROUNDS):
        for n in (names if r % 2 == 0 else names[::-1]):
            runs[n].append(time_ms(torch, fns[n]))
    return {n: sorted(x)[len(x) // 2] for n, x in runs.items()}


def forward(torch, kernels, fa, card: str) -> int:
    """The forward's variants against each other and SDPA's forward."""
    F = torch.nn.functional
    builds = {name: start_build(kernels, kernels._CSRC, "flash_fwd", name,
                                edits)
              for name, edits in FWD_VARIANTS.items()}
    libs = {name: load(kernels, *builds[name], "flash_fwd", name)
            for name in FWD_VARIANTS}
    gen = torch.Generator(device="cuda").manual_seed(2)
    q4, k4, v4 = (torch.randn((B, T, H, D), generator=gen,
                              device="cuda").bfloat16() for _ in range(3))
    q, k, v = (x.transpose(1, 2).reshape(B * H, T, D).contiguous()
               for x in (q4, k4, v4))
    bh, scale = B * H, D ** -0.5
    o = torch.empty_like(q)
    lse = torch.empty((bh, 1, T), device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    ptr = [x.data_ptr() for x in (q, k, v, o, lse)]

    def fwd_fn(so):
        return lambda: so.flash_fwd(*ptr, bh, T, D, scale, 1, 1, stream)

    o_ref, lse_ref = fa.flash_attention_fwd_reference(q, k, v, scale=scale,
                                                      causal=True)
    for name in CHECKED:
        if name not in libs:
            continue
        assert fwd_fn(libs[name])() == 0
        torch.cuda.synchronize()
        err_o = (o.float() - o_ref.float()).abs().max().item()
        err_l = (lse - lse_ref).abs().max().item()
        print(f"[check] {name}: max|o - plain| {err_o:.3e} (tol 5e-2), "
              f"max|lse - plain| {err_l:.3e} (tol 1e-4)", flush=True)
        if err_o > 5e-2 or err_l > 1e-4:
            raise SystemExit(f"flash_bwd_limits: FAILED: {name} disagrees "
                             f"with the plain version")
    qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (q4, k4, v4))
    fns = {name: fwd_fn(so) for name, so in libs.items()}
    fns["sdpa_forward"] = lambda: F.scaled_dot_product_attention(
        qh, kh, vh, is_causal=True)
    med = in_turns(torch, fns)
    for n, ms in med.items():
        print(f"[limits] {n:13s}: forward {ms:.4f} ms (median of {ROUNDS} "
              f"in turns, {ms / med['as_built']:.3f}x as built) [{card}]",
              flush=True)
    return 0


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
    if sys.argv[1:] == ["forward"]:
        return forward(torch, kernels, fa, card)
    builds = {name: start_build(kernels, kernels._CSRC, "flash_bwd", name,
                                edits)
              for name, edits in VARIANTS.items()}
    libs = {name: load(kernels, *builds[name], "flash_bwd", name)
            for name in VARIANTS}

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
    for name in (n for n in CHECKED if n in libs):
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

    qh, kh, vh, doh = (x.transpose(1, 2).contiguous() for x in
                       (q4, k4, v4, do4))
    qh, kh, vh = (x.requires_grad_(True) for x in (qh, kh, vh))
    out = F.scaled_dot_product_attention(qh, kh, vh, is_causal=True)
    fns = {name: (lambda d=dq_fn(so), kv=dkv_fn(so): (d(), kv()))
           for name, so in libs.items()}
    fns["sdpa_backward"] = lambda: torch.autograd.grad(
        out, (qh, kh, vh), doh, retain_graph=True)
    med = in_turns(torch, fns)
    for n in fns:
        split = "" if n == "sdpa_backward" else (
            f"; dQ {time_ms(torch, dq_fn(libs[n])):.4f} ms, dK/dV "
            f"{time_ms(torch, dkv_fn(libs[n])):.4f} ms")
        print(f"[limits] {n:13s}: whole backward {med[n]:.4f} ms (median "
              f"of {ROUNDS} in turns, {med[n] / med['as_built']:.3f}x as "
              f"built){split} [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
