#!/usr/bin/env python3
"""Where the bf16 fused-CE kernels (forward, dH, dW) spend their time.

    python3 fused_ce_limits.py

Builds variants of ray_tpu_torch/ops/csrc/fused_ce.cu for D = 768 only,
each with one part of the work taken out (so their results are wrong on
purpose), and times the forward, dH and dW of each at GPT-2-124M's
training shape (N = 24,576, V = 50,304, valid 50,257, D = 768, bf16),
the variants in turns, twice, on one NVIDIA GPU:

  as_built    the kernels as they are
  s_one_box   dH, dW: S = R . C^T contracted over the first 64 of D's
              columns
  no_product  dH, dW: no second product (acc += dlogits . C)
  no_exp      dH, dW: dlogits without their exp
  s_two_acc   dH, dW: S summed into two accumulators (half the
              dependency chain)
  fwd_no_exp  forward: the online sum without its exp2

The ring still streams every C tile in each variant: a variant with
little compute left that takes nearly the time of the kernel as built
says that the walked operand's stream from L2 is what holds it.  The
variants build into ray_tpu_torch/_build/limits/.  Exits non-zero
without a CUDA device.
"""

from __future__ import annotations

import importlib
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
N, V, VALID, D = 24576, 50304, 50257, 768

# the dispatch of every D / 64, cut to D = 768 so each variant builds fast
ALL_BOXES = """    FUSED_CE_BWD_BOXES(1) FUSED_CE_BWD_BOXES(2) FUSED_CE_BWD_BOXES(3)
    FUSED_CE_BWD_BOXES(4) FUSED_CE_BWD_BOXES(5) FUSED_CE_BWD_BOXES(6)
    FUSED_CE_BWD_BOXES(7) FUSED_CE_BWD_BOXES(8) FUSED_CE_BWD_BOXES(9)
    FUSED_CE_BWD_BOXES(10) FUSED_CE_BWD_BOXES(11) FUSED_CE_BWD_BOXES(12)
    FUSED_CE_BWD_BOXES(13) FUSED_CE_BWD_BOXES(14) FUSED_CE_BWD_BOXES(15)
    FUSED_CE_BWD_BOXES(16)"""
S_ONE_ACC = """      fence_regs(s);
      wgmma_fence();
#pragma unroll
      for (int kb = 0; kb < BOXES; ++kb)
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          wgmma_m64n32k16_ss(s, da + (kb * kRBoxBytes + ks * 32) / 16,
                             db + (kb * kCBoxBytes + ks * 32) / 16,
                             kb > 0 || ks > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);"""
S_TWO_ACC = """      float s2[16];
      fence_regs(s);
      fence_regs(s2);
      wgmma_fence();
#pragma unroll
      for (int kb = 0; kb < BOXES; ++kb)
#pragma unroll
        for (int ks = 0; ks < 4; ks += 2) {
          wgmma_m64n32k16_ss(s, da + (kb * kRBoxBytes + ks * 32) / 16,
                             db + (kb * kCBoxBytes + ks * 32) / 16,
                             kb > 0 || ks > 0);
          wgmma_m64n32k16_ss(s2, da + (kb * kRBoxBytes + ks * 32 + 32) / 16,
                             db + (kb * kCBoxBytes + ks * 32 + 32) / 16,
                             kb > 0 || ks > 0);
        }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(s2);
#pragma unroll
      for (int q = 0; q < 16; ++q) s[q] += s2[q];"""
# (old, new, times the old text occurs in fused_ce.cu): the backward's
# edits also reach the wide kernel (D > 1024), which D = 768 never runs
VARIANTS = {
    "as_built": [],
    "s_one_box": [("for (int kb = 0; kb < BOXES; ++kb)",
                   "for (int kb = 0; kb < 1; ++kb)", 1)],
    "no_product": [("for (int kk = 0; kk < 2; ++kk)",
                    "for (int kk = 0; kk < 0; ++kk)", 2)],
    "no_exp": [("expf(logit - rl[m])", "(logit - rl[m])", 2),
               ("expf(logit - rl[n])", "(logit - rl[n])", 2)],
    "s_two_acc": [(S_ONE_ACC, S_TWO_ACC, 1)],
    "fwd_no_exp": [("sum_b += exp2_approx(s[k] - mn_b);",
                    "sum_b += s[k] - mn_b;", 1),
                   ("sum_a += exp2_approx(s[k] - mn_a);",
                    "sum_a += s[k] - mn_a;", 1)],
}


def build(kernels, src: Path, name: str) -> list:
    """Build variant `name` of src/fused_ce.cu into its own copy of csrc
    and point the kernel loader at it; returns ptxas's spill and wgmma
    notes."""
    text = (src / "fused_ce.cu").read_text()
    for old, new, count in VARIANTS[name] + [
            (ALL_BOXES, "    FUSED_CE_BWD_BOXES(12)", 1)]:
        if text.count(old) != count:
            raise SystemExit(f"fused_ce_limits: variant {name} no longer "
                             f"matches fused_ce.cu: {old[:50]!r}")
        text = text.replace(old, new)
    csrc = kernels.BUILD_DIR / "limits" / name
    shutil.rmtree(csrc, ignore_errors=True)
    csrc.mkdir(parents=True)
    for header in src.glob("*.cuh"):
        shutil.copy(header, csrc / header.name)
    (csrc / "fused_ce.cu").write_text(text)
    return use(kernels, csrc)


def use(kernels, csrc: Path) -> list:
    kernels._CSRC = csrc
    kernels.library.cache_clear()
    kernels.build_all()
    log = kernels._library_path("fused_ce").with_suffix(".so.log")
    return [line.strip() for line in log.read_text().splitlines()
            if "C75" in line or ("spill" in line and " 0 bytes spill" not in line)]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("fused_ce_limits: FAILED: no CUDA device")
    sys.path.insert(0, str(ROOT))
    kernels = importlib.import_module("ray_tpu_torch.ops._kernels")
    fc = importlib.import_module("ray_tpu_torch.ops.fused_ce")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    src, dirs = kernels._CSRC, {}
    for name in VARIANTS:
        notes = build(kernels, src, name)
        dirs[name] = kernels._CSRC
        print(f"[build] {name}: {len(notes)} ptxas notes" +
              "".join(f"\n    {n[:150]}" for n in notes[:2]), flush=True)

    gen = torch.Generator(device="cuda").manual_seed(3)
    h = torch.randn((N, D), generator=gen, device="cuda").bfloat16()
    w = (torch.randn((V, D), generator=gen, device="cuda")
         * D ** -0.5).bfloat16()
    tgt = torch.randint(0, VALID, (N,), generator=gen, device="cuda",
                        dtype=torch.int32)
    g = torch.full((N,), 1.0 / N, device="cuda")
    _, lse = fc.fused_ce_fwd(h, w, tgt, VALID)
    args = (h, w, tgt, lse, g, VALID)

    def time_ms(fn, iters: int = 5) -> float:
        fn(*args)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn(*args)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    fns = {"fwd": lambda *a: fc.fused_ce_fwd(*a[:3], a[5]),
           "dh": fc.fused_ce_bwd_dh, "dw": fc.fused_ce_bwd_dw}
    ms = {name: {k: [] for k in fns} for name in VARIANTS}
    for name in list(VARIANTS) * 2:
        use(kernels, dirs[name])
        for k, fn in fns.items():
            ms[name][k].append(time_ms(fn))
    for name, t in ms.items():
        print(f"[limits] {name:10s}: " + ", ".join(
            f"{k} " + " ".join(f"{x:.3f}" for x in t[k]) + " ms"
            for k in fns) + f" [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
