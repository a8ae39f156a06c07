"""Declarative serve config: applications as validated data.

A copy of ``ray_tpu/serve/schema.py``.  Reference analog:
serve/schema.py:1 (ServeApplicationSchema / DeploymentSchema — pydantic
there, plain dataclass validation here: no new dependency) +
serve/api.py:251's REST deploy path.  A config names an import path and
per-deployment overrides; ``apply`` imports the target, overlays the
overrides, and deploys through the normal ``serve.run`` machinery — the
JAX package's dashboard REST endpoint (PUT /api/serve/applications/)
feeds dicts straight into it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

_ALLOWED_DEPLOYMENT_KEYS = {
    "name", "num_replicas", "max_concurrent_queries",
    "ray_actor_options", "autoscaling_config", "route_prefix",
}


@dataclasses.dataclass
class DeploymentSchema:
    """Per-deployment overrides (reference: schema.py DeploymentSchema)."""

    name: str
    num_replicas: Optional[int] = None
    max_concurrent_queries: Optional[int] = None
    ray_actor_options: Optional[Dict[str, Any]] = None
    autoscaling_config: Optional[Dict[str, Any]] = None
    route_prefix: Optional[str] = None

    @classmethod
    def parse(cls, d: Dict[str, Any]) -> "DeploymentSchema":
        if not isinstance(d, dict):
            raise ValueError(f"deployment entry must be a dict, got "
                             f"{type(d).__name__}")
        unknown = set(d) - _ALLOWED_DEPLOYMENT_KEYS
        if unknown:
            raise ValueError(
                f"unknown deployment config keys {sorted(unknown)}; "
                f"allowed: {sorted(_ALLOWED_DEPLOYMENT_KEYS)}")
        if "name" not in d or not isinstance(d["name"], str) or not d["name"]:
            raise ValueError("every deployment entry needs a non-empty "
                             "string 'name'")
        out = cls(**d)
        if out.num_replicas is not None and (
                not isinstance(out.num_replicas, int)
                or out.num_replicas < 0):
            raise ValueError(f"{out.name}: num_replicas must be an int "
                             f">= 0, got {out.num_replicas!r}")
        if out.num_replicas == 0 and not (
                isinstance(out.autoscaling_config, dict)
                and out.autoscaling_config.get("min_replicas") == 0):
            # zero replicas with no autoscaler can never serve a request
            raise ValueError(
                f"{out.name}: num_replicas=0 requires an "
                "autoscaling_config with min_replicas=0 (scale-to-zero); "
                "a fixed zero-replica deployment can never serve")
        if out.max_concurrent_queries is not None and (
                not isinstance(out.max_concurrent_queries, int)
                or out.max_concurrent_queries < 1):
            raise ValueError(f"{out.name}: max_concurrent_queries must "
                             f"be an int >= 1")
        if out.route_prefix is not None and \
                not out.route_prefix.startswith("/"):
            raise ValueError(f"{out.name}: route_prefix must start "
                             f"with '/'")
        if out.autoscaling_config is not None:
            ac = out.autoscaling_config
            lo = ac.get("min_replicas", 1)
            hi = ac.get("max_replicas", 8)
            if lo > hi:
                raise ValueError(f"{out.name}: min_replicas {lo} > "
                                 f"max_replicas {hi}")
        return out


@dataclasses.dataclass
class ServeApplicationSchema:
    """One application: an import path + deployment overrides
    (reference: schema.py ServeApplicationSchema)."""

    import_path: str
    name: str = "default"
    route_prefix: Optional[str] = None
    args: Dict[str, Any] = dataclasses.field(default_factory=dict)
    deployments: List[DeploymentSchema] = dataclasses.field(
        default_factory=list)

    @classmethod
    def parse(cls, d: Dict[str, Any]) -> "ServeApplicationSchema":
        if not isinstance(d, dict):
            raise ValueError("application config must be a dict")
        imp = d.get("import_path")
        if not imp or not isinstance(imp, str) or ":" not in imp:
            raise ValueError(
                "import_path is required, format 'module.sub:attr' "
                f"(got {imp!r})")
        deps = [DeploymentSchema.parse(x)
                for x in d.get("deployments", [])]
        names = [x.name for x in deps]
        if len(names) != len(set(names)):
            raise ValueError(f"duplicate deployment names in config: "
                             f"{names}")
        rp = d.get("route_prefix")
        if rp is not None and not str(rp).startswith("/"):
            raise ValueError("route_prefix must start with '/'")
        return cls(import_path=imp, name=d.get("name", "default"),
                   route_prefix=rp, args=d.get("args", {}) or {},
                   deployments=deps)

    def resolve_target(self):
        """Import the bound deployment the config points at."""
        import importlib

        module, _, attr = self.import_path.partition(":")
        target = importlib.import_module(module)
        for part in attr.split("."):
            target = getattr(target, part)
        if callable(target) and not _is_deployment(target):
            target = target(**self.args)  # app builder function
        if not _is_deployment(target):
            raise ValueError(
                f"{self.import_path} resolved to {type(target).__name__},"
                f" expected a Deployment (use @serve.deployment)")
        return target


def _is_deployment(obj) -> bool:
    from ray_tpu_torch.serve.api import Deployment

    return isinstance(obj, Deployment)


def apply(config: Dict[str, Any]):
    """Validate + deploy a declarative application config; returns the
    root DeploymentHandle.  The REST layer calls exactly this."""
    import dataclasses as dc

    from ray_tpu_torch.serve import api

    schema = ServeApplicationSchema.parse(config)
    target = schema.resolve_target()
    overrides = {
        d.name: {k: v for k, v in dc.asdict(d).items()
                 if k != "name" and v is not None}
        for d in schema.deployments}
    return api.run(target, route_prefix=schema.route_prefix,
                   _overrides=overrides or None)


def status() -> Dict[str, Any]:
    """Shape-stable status document for the REST layer (reference:
    serve/schema.py ServeStatusSchema)."""
    from ray_tpu_torch.serve import api

    return {"applications": api.status()}
