"""Serving in the port: deployment records, the LM engine, request
batching, and the fleet (router, autoscaler, seeded traffic).  Running
deployments as actors (``run``, handles, the controller, schemas) needs
the core runtime: ROADMAP.md queue 1 item 6."""

from ray_tpu_torch.models.decode_common import SamplingParams
from ray_tpu_torch.serve.api import Deployment, deployment
from ray_tpu_torch.serve.batching import (AdmissionPolicy, OverloadedError,
                                          batch)
from ray_tpu_torch.serve.kv_pager import BlockPager
from ray_tpu_torch.serve.kv_tier import HostKVTier
from ray_tpu_torch.serve.llm import SpecConfig, build_llm_deployment
from ray_tpu_torch.serve.router import (AutoscalePolicy, LLMFleet,
                                        LLMRouter, TenantClass,
                                        build_llm_fleet)
from ray_tpu_torch.serve.slo import SLOConfig, worst_burn_rate
from ray_tpu_torch.serve.traffic import (TenantSpec, TrafficGenerator,
                                         TrafficSpec, run_traffic,
                                         run_traffic_fleet)

__all__ = ["deployment", "Deployment", "batch", "build_llm_deployment",
           "AdmissionPolicy", "OverloadedError", "BlockPager",
           "HostKVTier", "TrafficSpec", "TrafficGenerator", "run_traffic",
           "SamplingParams", "SpecConfig", "SLOConfig", "worst_burn_rate",
           "TenantSpec", "TenantClass", "AutoscalePolicy", "LLMRouter",
           "LLMFleet", "build_llm_fleet", "run_traffic_fleet"]
