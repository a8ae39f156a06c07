"""Serving in the port: deployment records and ``serve.run`` on the
core runtime (the controller, replica actors, handles), the LM engine,
request batching, the fleet (router, autoscaler, seeded traffic), the
HTTP proxy (``start_http_proxy``) and the declarative config
(``schema.apply``, also ``apply_config``).

Names resolve lazily (PEP 562): the controller and replica actors
import ``ray_tpu_torch.serve.controller``/``.replica`` in their worker
processes, and the package must not drag torch into a process that
serves no model.
"""

import importlib

_EXPORTS = {
    "Deployment": "api", "deployment": "api", "run": "api",
    "delete": "api", "shutdown": "api", "status": "api",
    "engine_stats": "api", "get_deployment_handle": "api",
    "start_http_proxy": "api",
    "ServeApplicationSchema": "schema", "DeploymentSchema": "schema",
    "apply_config": "schema",
    "DeploymentHandle": "handle",
    "SamplingParams": "llm", "SpecConfig": "llm",
    "build_llm_deployment": "llm",
    "AdmissionPolicy": "batching", "OverloadedError": "batching",
    "batch": "batching",
    "BlockPager": "kv_pager", "HostKVTier": "kv_tier",
    "AutoscalePolicy": "router", "LLMFleet": "router",
    "LLMRouter": "router", "TenantClass": "router",
    "build_llm_fleet": "router",
    "SLOConfig": "slo", "worst_burn_rate": "slo",
    "TenantSpec": "traffic", "TrafficGenerator": "traffic",
    "TrafficSpec": "traffic", "run_traffic": "traffic",
    "run_traffic_fleet": "traffic",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(f"{__name__}.{mod}"),
                    "apply" if name == "apply_config" else name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))
