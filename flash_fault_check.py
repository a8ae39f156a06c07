#!/usr/bin/env python3
"""What the flash-forward checks of chip_smoke.py's llama-1b serving
phase read when the forward kernel drops a K/V tile.

    python3 flash_fault_check.py

Builds planted-fault variants of ray_tpu_torch/ops/csrc/flash_fwd.cu by
text edits, as flash_bwd_limits.py builds its variants (into
ray_tpu_torch/_build/limits/), and runs the kernel as built and each
variant, in place of the built forward, through the two checks that
phase holds the forward to, on one NVIDIA GPU:

  prefill  chip_smoke.check_prefill_flash on the phase's own inputs:
           the llama-1b engine of build_llm_deployment (seed 0) and its
           8 x 512-token prompts, last-token logits of flash against
           plain attention, bf16 within LLAMA_LOGIT_TOL and f32 within
           F32_LOGIT_TOL
  kernel   chip_smoke.check_train_shape at the shape that prefill gives
           the kernel (B=8, H=32, T=512, D=64, causal, bf16)

Each variant drops key tile 0 from the query blocks that see more than
one key tile (so no row is left without keys):

  bf16_drop_tile0       the bf16 kernel, in every such query block
  bf16_drop_tile0_last  the bf16 kernel, in the last query block only
                        (128 rows, the prefill's last token among them)
  bf16_drop_tile0_last_head0
                        the same, in the first (batch, head) pair only
  f32_drop_tile0_last   the f32 kernel, in the last query block only
                        (64 rows)

Prints each check's readings and which checks caught each variant.
Exits non-zero without a CUDA device, if the kernel as built fails a
check, or if a variant passes both.
"""

from __future__ import annotations

import contextlib
import ctypes
import importlib
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
B, T = 8, 512

BF16_SCORE = "float x = s[k] * scale_log2;"
F32_LOOP = "for (int n0 = 0; n0 < kv_end; n0 += kBlockN) {"
# (old, new, times the old text occurs in flash_fwd.cu)
VARIANTS = {
    "as_built": [],
    "bf16_drop_tile0": [(
        BF16_SCORE, "float x = (t == 0 && t_mine > 1) ? kMaskLog2 "
                    ": s[k] * scale_log2;", 1)],
    "bf16_drop_tile0_last": [(
        BF16_SCORE, "float x = (t == 0 && t_mine > 1 && q0 + kCtaRows >= "
                    "seq_len) ? kMaskLog2 : s[k] * scale_log2;", 1)],
    "bf16_drop_tile0_last_head0": [(
        BF16_SCORE, "float x = (t == 0 && t_mine > 1 && q0 + kCtaRows >= "
                    "seq_len && bh == 0) ? kMaskLog2 : s[k] * scale_log2;",
        1)],
    "f32_drop_tile0_last": [(
        F32_LOOP, "for (int n0 = q0 + kBlockM >= seq_len && kv_end > "
                  "kBlockN ? kBlockN : 0; n0 < kv_end; n0 += kBlockN) {",
        1)],
}


def checks(torch, fa, cs, engine, prefill, toks) -> dict:
    """{check: None if it passed, else its failure} for the forward
    that is loaded now."""
    cfg = engine.cfg
    runs = {
        "prefill": lambda: cs.check_prefill_flash(
            torch, prefill, engine.params, toks, cfg, cs.LLAMA_LOGIT_TOL,
            "prefill"),
        "kernel": lambda: cs.check_train_shape(
            torch, fa, seed=3, b=B, h=cfg.n_head, T=T, d=cfg.head_dim,
            tag="serve-llama shape")}
    out = {}
    for name, run in runs.items():
        mode = (torch.inference_mode() if name == "prefill"
                else contextlib.nullcontext())
        try:
            with mode:
                run()
            out[name] = None
        except SystemExit as e:
            out[name] = str(e)
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("flash_fault_check: FAILED: no CUDA device")
    sys.path.insert(0, str(ROOT))
    kernels = importlib.import_module("ray_tpu_torch.ops._kernels")
    fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")
    cs = importlib.import_module("chip_smoke")
    limits = importlib.import_module("flash_bwd_limits")
    from ray_tpu_torch.models.llama_decode import llama_prefill
    from ray_tpu_torch.serve import build_llm_deployment

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    builds = {name: limits.start_build(kernels, kernels._CSRC, "flash_fwd",
                                       name, edits)
              for name, edits in VARIANTS.items()}
    libs = {name: limits.load(kernels, *builds[name], "flash_fwd", name)
            for name in VARIANTS}
    for so in libs.values():
        so.kernel_error_string.argtypes = [ctypes.c_int]
        so.kernel_error_string.restype = ctypes.c_char_p

    # the serve-llama phase's engine and equal-length prompts (its
    # warm-up batch drawn first)
    engine = build_llm_deployment("llama", "llama-1b", max_new_tokens=16,
                                  max_batch_size=8, seed=0)()
    rng = np.random.default_rng(0)
    prompts = [[rng.integers(0, engine.cfg.vocab_size, size=T,
                             dtype=np.int32) for _ in range(B)]
               for _ in range(2)][1]
    toks = torch.from_numpy(np.stack(prompts)).cuda()

    library = kernels.library
    bad = []
    for name, so in libs.items():
        kernels.library = (lambda lib, so=so: so if lib == "flash_fwd"
                           else library(lib))
        print(f"[fault] {name} [{card}]", flush=True)
        got = checks(torch, fa, cs, engine, llama_prefill, toks)
        caught = [c for c, err in got.items() if err]
        print(f"[fault] {name}: caught by {caught or 'no check'}"
              + "".join(f"; {c}: {got[c]}" for c in caught), flush=True)
        if (name == "as_built") == bool(caught):
            bad.append(name)
    kernels.library = library
    if bad:
        raise SystemExit(f"flash_fault_check: FAILED: {bad} (as_built must "
                         f"pass every check, each planted fault fail one)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
