"""Serving in the port: the LM engine and request batching."""

from ray_tpu_torch.models.decode_common import SamplingParams
from ray_tpu_torch.serve.batching import batch
from ray_tpu_torch.serve.llm import SpecConfig, build_llm_deployment

__all__ = ["build_llm_deployment", "batch", "SamplingParams", "SpecConfig"]
