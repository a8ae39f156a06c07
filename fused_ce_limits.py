#!/usr/bin/env python3
"""Where the bf16 fused-CE kernels (forward, dH, dW) spend their time.

    python3 fused_ce_limits.py          # D = 768: the resident dH/dW
    python3 fused_ce_limits.py --wide   # D = 2048: the cluster dH/dW

Builds variants of ray_tpu_torch/ops/csrc/fused_ce.cu, each with one
part of the work taken out (so their results are wrong on purpose), and
times them in turns, twice, on one NVIDIA GPU.

Default: D = 768 only, at GPT-2-124M's training shape (N = 24,576, V =
50,304, valid 50,257, bf16), the forward, dH and dW of each variant:

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
says that the walked operand's stream from L2 is what holds it.

--wide: the cluster kernel (4 CTAs a cluster, 8 boxes each) at
llama-1b's head (N = 16,384, V = valid = 32,000, D = 2048, bf16, g =
1/N), dH and dW of each variant:

  as_built     the kernel as it is
  remote_arrive  the signal that a CTA has read its exchange buffer as a
               remote mbarrier arrive (release at cluster scope) from
               each CTA instead of a 4-byte st.async
  no_load_ahead  three ring stages, none loading ahead of the pipeline
  lag1         the product one step after the sums (lag 1, not 2)
  no_exchange  each CTA sums only its own partial S (no reduce-scatter
               through distributed shared memory; the dlogits are still
               gathered into every CTA)
  no_product   no second product
  s_only       the partial S and the barrier hand-offs alone: no data
               leaves a CTA and no second product

It then runs chip_smoke's dH/dW check against the plain versions at that
shape, gpt2-large's head (N = 8192, V = 50,304, D = 1280) and llama-7b's
(N = 4096, V = 32,000, D = 4096) on as_built (which must pass) and on
no_exchange (which must fail), and exits non-zero if either does
otherwise.

The variants build into ray_tpu_torch/_build/limits/.  Exits non-zero
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
WIDE_N, WIDE_V, WIDE_VALID, WIDE_D = 16384, 32000, 32000, 2048
# (N, V, valid, D) of the heads where --wide runs chip_smoke's check on
# as_built and no_exchange: llama-1b's, gpt2-large's (N = 8 x 1024) and
# llama-7b's (N = 2 x 2048), clusters of 4, 2 and 8 CTAs
CHECK_HEADS = ((WIDE_N, WIDE_V, WIDE_VALID, WIDE_D),
               (8192, 50304, 50257, 1280), (4096, 32000, 32000, 4096))

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
# the cluster kernel's reduce-scatter cut to each CTA's own partial: its
# pieces all go to itself, and it sums only its own
NO_EXCHANGE = [
    ("const uint32_t to = cluster_addr(mine, q);",
     "const uint32_t to = cluster_addr(mine + (q - j) * NG * P, j);", 1),
    ("const uint32_t to_bar = cluster_addr(&xfull[xs], q);",
     "const uint32_t to_bar = cluster_addr(&xfull[xs], j);", 1),
    ("for (int i = 0; i < P; ++i) v[i] = src[i];",
     "for (int i = 0; i < P; ++i) v[i] = src[j * NG * P + i];", 1),
    ("for (int i = 0; i < P; ++i) v[i] += src[q * NG * P + i];",
     "for (int i = 0; i < P; ++i) v[i] += 0.f;", 1),
    ("st_async_u32(cluster_addr(sig, q), 0, cluster_addr(&xempty[xs], q));",
     "st_async_u32(cluster_addr(sig, j), 0, cluster_addr(&xempty[xs], j));",
     1)]
NO_PRODUCT = [("for (int kk = 0; kk < 2; ++kk)",
               "for (int kk = 0; kk < 0; ++kk)", 2)]
# (old, new, times the old text occurs in fused_ce.cu): the default
# mode's backward edits also reach the cluster kernel (D > 1024), which
# D = 768 never runs
VARIANTS = {
    "as_built": [],
    "s_one_box": [("for (int kb = 0; kb < BOXES; ++kb)",
                   "for (int kb = 0; kb < 1; ++kb)", 1)],
    "no_product": NO_PRODUCT,
    "no_exp": [("expf(logit - rl[m])", "(logit - rl[m])", 2),
               ("expf(logit - rl[n])", "(logit - rl[n])", 2)],
    "s_two_acc": [(S_ONE_ACC, S_TWO_ACC, 1)],
    "fwd_no_exp": [("sum_b += exp2_approx(s[k] - mn_b);",
                    "sum_b += s[k] - mn_b;", 1),
                   ("sum_a += exp2_approx(s[k] - mn_a);",
                    "sum_a += s[k] - mn_a;", 1)],
}
# the "buffer read" signal as a remote mbarrier arrive (release at
# cluster scope) from each CTA instead of a 4-byte st.async: what the
# st.async saves
REMOTE_ARRIVE = [
    ("mbar_init(&xempty[i], 1);", "mbar_init(&xempty[i], K + 1);", 1),
    ("mbar_arrive_expect_tx(&xempty[xs], K * 4);",
     "mbar_arrive(&xempty[xs]);", 1),
    ("st_async_u32(cluster_addr(sig, q), 0, cluster_addr(&xempty[xs], q));",
     'asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, '
     '[%0];" :: "r"(cluster_addr(&xempty[xs], q)) : "memory");', 1)]
# the pipeline at D = 2048 (four stages, lags 1 and 2) with no stage
# loading ahead (three stages), or with lag 1 for the product
NO_LOAD_AHEAD = [
    ("constexpr int kMaxClusterStages = 4;",
     "constexpr int kMaxClusterStages = 3;", 1),
    ("return s >= l2 + (l2 >= 2 ? 2 : 1) ? s : 0;",
     "return s >= l2 + 1 ? s : 0;", 1)]
LAG1 = [("static constexpr int kLag2 = cluster_stages(SC, 2)   ? 2",
         "static constexpr int kLag2 = false ? 2", 1)]
WIDE_VARIANTS = {
    "as_built": [],
    "remote_arrive": REMOTE_ARRIVE,
    "no_load_ahead": NO_LOAD_AHEAD,
    "lag1": LAG1,
    "no_exchange": NO_EXCHANGE,
    "no_product": NO_PRODUCT,
    "s_only": NO_EXCHANGE + NO_PRODUCT + [
        ("const uint32_t to_bar = cluster_addr(&dl_full[ds], q);",
         "const uint32_t to_bar = cluster_addr(&dl_full[ds], j);", 1),
        ("st_async_u32(cluster_addr(dl + i * 128, q), words[i], to_bar);",
         "st_async_u32(cluster_addr(dl + i * 128, j), words[i], to_bar);",
         1)],
}


def build(kernels, fc, src: Path, name: str, edits, plans) -> list:
    """Build variant `name` (its `edits` of src/fused_ce.cu, with the
    backward instantiations of the launch plans `plans` only, so that
    it builds fast) into its own copy of csrc and point the kernel
    loader at it; returns ptxas's spill and wgmma notes."""
    text = (src / "fused_ce.cu").read_text()
    for old, new, count in edits:
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
    return use(kernels, fc, csrc, plans)


def use(kernels, fc, csrc: Path, plans) -> list:
    header = fc.kernel_plans_header(
        resident=tuple(p.sc for p in plans if p.k == 1),
        clusters=tuple((p.k, p.c, p.sc) for p in plans if p.k > 1))
    kernels.GENERATED["fused_ce"] = {"fused_ce_plans.h": lambda: header}
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
    wide = "--wide" in sys.argv[1:]
    sys.path.insert(0, str(ROOT))
    kernels = importlib.import_module("ray_tpu_torch.ops._kernels")
    fc = importlib.import_module("ray_tpu_torch.ops.fused_ce")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    variants = WIDE_VARIANTS if wide else VARIANTS
    n, v, valid, d = ((WIDE_N, WIDE_V, WIDE_VALID, WIDE_D) if wide
                      else (N, V, VALID, D))
    # each variant instantiates only the backward kernels that D = 768
    # and D = 2048 run (both: the header needs a row of each), and those
    # that --wide checks the heads of CHECK_HEADS with
    timed = [fc.fused_ce_bwd_plan(D, N), fc.fused_ce_bwd_plan(WIDE_D, WIDE_N)]
    checked = timed + [fc.fused_ce_bwd_plan(hd[3], hd[0])
                       for hd in CHECK_HEADS[1:]]
    src, dirs = kernels._CSRC, {}
    for name, edits in variants.items():
        plans = (checked if wide and name in ("as_built", "no_exchange")
                 else timed)
        notes = build(kernels, fc, src, name, edits, plans)
        dirs[name] = (kernels._CSRC, plans)
        print(f"[build] {name}: {len(notes)} ptxas notes" +
              "".join(f"\n    {n[:150]}" for n in notes[:2]), flush=True)

    gen = torch.Generator(device="cuda").manual_seed(3)
    h = torch.randn((n, d), generator=gen, device="cuda").bfloat16()
    w = (torch.randn((v, d), generator=gen, device="cuda")
         * d ** -0.5).bfloat16()
    tgt = torch.randint(0, valid, (n,), generator=gen, device="cuda",
                        dtype=torch.int32)
    g = torch.full((n,), 1.0 / n, device="cuda")
    _, lse = fc.fused_ce_fwd(h, w, tgt, valid)
    args = (h, w, tgt, lse, g, valid)

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

    fns = {"dh": fc.fused_ce_bwd_dh, "dw": fc.fused_ce_bwd_dw}
    if not wide:
        fns = {"fwd": lambda *a: fc.fused_ce_fwd(*a[:3], a[5]), **fns}
    ms = {name: {k: [] for k in fns} for name in variants}
    for name in list(variants) * 2:
        use(kernels, fc, *dirs[name])
        for k, fn in fns.items():
            ms[name][k].append(time_ms(fn))
    for name, t in ms.items():
        print(f"[limits] {name:11s}: " + ", ".join(
            f"{k} " + " ".join(f"{x:.3f}" for x in t[k]) + " ms"
            for k in fns) + f" [{card}]", flush=True)
    if not wide:
        return 0

    # chip_smoke's check of the kernels against their plain versions at
    # each head of CHECK_HEADS: as built it passes, without the exchange
    # it fails
    import chip_smoke

    del h, w, tgt, g, lse, args
    wrong = []
    for name, should_pass in (("as_built", True), ("no_exchange", False)):
        use(kernels, fc, *dirs[name])
        for hn, hv, hvalid, hd in CHECK_HEADS:
            try:
                chip_smoke.check_ce_kernels(torch, fc, hn, hv, hvalid, hd,
                                            "bf16", seed=7, g=1.0 / hn)
                passed = True
            except SystemExit as exc:
                print(f"[limits] {name}: {exc}", flush=True)
                passed = False
            torch.cuda.empty_cache()
            print(f"[limits] {name}: chip_smoke's dH/dW check at N={hn} "
                  f"D={hd} {'passes' if passed else 'fails'} (expected to "
                  f"{'pass' if should_pass else 'fail'})", flush=True)
            if passed != should_pass:
                wrong.append(f"{name} at D={hd}")
    if wrong:
        raise SystemExit(f"fused_ce_limits: FAILED: the check did not "
                         f"do as expected on {', '.join(wrong)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
