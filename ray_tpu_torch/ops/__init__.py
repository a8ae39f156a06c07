"""Compute ops of the port: attention dispatch, the flash kernels, the
lm-head + cross-entropy implementations (fused kernels, streaming),
sequence-parallel attention (ring, Ulysses) and the pipeline."""

from ray_tpu_torch.ops.attention import (causal_attention,
                                         flash_auto_dispatch,
                                         prefill_attention,
                                         reference_attention)
from ray_tpu_torch.ops.flash_attention import (
    SUPPORTED_HEAD_DIMS, flash_attention, flash_attention_bwd,
    flash_attention_bwd_reference, flash_attention_fwd,
    flash_attention_fwd_reference, resolve_resident_mode)
from ray_tpu_torch.ops.fused_ce import fused_lm_ce
from ray_tpu_torch.ops.pipeline import pipeline_apply, stack_stage_params
from ray_tpu_torch.ops.ring_attention import (ring_attention,
                                              ulysses_attention)
from ray_tpu_torch.ops.vocab_ce import streaming_ce

__all__ = ["causal_attention", "flash_auto_dispatch", "prefill_attention",
           "reference_attention", "SUPPORTED_HEAD_DIMS", "flash_attention",
           "flash_attention_bwd", "flash_attention_bwd_reference",
           "flash_attention_fwd", "flash_attention_fwd_reference",
           "fused_lm_ce", "pipeline_apply", "resolve_resident_mode",
           "ring_attention", "stack_stage_params", "streaming_ce",
           "ulysses_attention"]
