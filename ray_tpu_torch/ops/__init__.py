"""Compute ops of the port: attention dispatch and the flash kernels."""

from ray_tpu_torch.ops.attention import (causal_attention,
                                         flash_auto_dispatch,
                                         prefill_attention,
                                         reference_attention)
from ray_tpu_torch.ops.flash_attention import (
    SUPPORTED_HEAD_DIMS, flash_attention, flash_attention_bwd,
    flash_attention_bwd_reference, flash_attention_fwd,
    flash_attention_fwd_reference, resolve_resident_mode)

__all__ = ["causal_attention", "flash_auto_dispatch", "prefill_attention",
           "reference_attention", "SUPPORTED_HEAD_DIMS", "flash_attention",
           "flash_attention_bwd", "flash_attention_bwd_reference",
           "flash_attention_fwd", "flash_attention_fwd_reference",
           "resolve_resident_mode"]
