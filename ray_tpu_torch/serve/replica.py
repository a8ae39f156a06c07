"""Replica actor: hosts one copy of a deployment's callable.

Reference analog: serve/_private/replica.py:250 RayServeReplica (:494
handle_request).  The user object is constructed once per replica; sync
callables run on the actor's concurrency slots (max_concurrency >1 gives
intra-replica parallelism, the analog of max_concurrent_queries).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, Optional

from ray_tpu_torch._private._vendor import cloudpickle


class DeploymentHandleMarker:
    """Placeholder for a bound sub-deployment inside init args — the
    deployment-graph edge (reference: serve/deployment_graph.py nodes).
    Resolved to a live DeploymentHandle at replica construction."""

    def __init__(self, name: str):
        self.name = name


def _resolve_markers(obj):
    if isinstance(obj, DeploymentHandleMarker):
        from ray_tpu_torch.serve.api import get_deployment_handle

        return get_deployment_handle(obj.name)
    if isinstance(obj, (list, tuple)):
        return type(obj)(_resolve_markers(x) for x in obj)
    if isinstance(obj, dict):
        return {k: _resolve_markers(v) for k, v in obj.items()}
    return obj


class RayServeReplica:
    def __init__(self, serialized_def: bytes, init_args: tuple,
                 init_kwargs: Dict[str, Any], deployment_name: str):
        target = cloudpickle.loads(serialized_def)
        self.deployment_name = deployment_name
        init_args = _resolve_markers(tuple(init_args))
        init_kwargs = _resolve_markers(dict(init_kwargs or {}))
        if isinstance(target, type):
            self.callable = target(*init_args, **init_kwargs)
        else:
            self.callable = target
        self.num_requests = 0
        self._ongoing = 0
        self._mu = threading.Lock()
        self.started_at = time.time()

    def handle_request(self, *args, _serve_method: str = "__call__",
                       **kwargs):
        with self._mu:
            self.num_requests += 1
            self._ongoing += 1
        try:
            fn = self.callable if _serve_method == "__call__" and \
                callable(self.callable) else getattr(self.callable,
                                                     _serve_method)
            return fn(*args, **kwargs)
        finally:
            with self._mu:
                self._ongoing -= 1

    def ongoing_requests(self) -> int:
        """Autoscaling signal (reference: replica queue metrics feeding
        autoscaling_policy.py:127)."""
        return self._ongoing

    def stats(self) -> Dict[str, Any]:
        return {"deployment": self.deployment_name,
                "num_requests": self.num_requests,
                "ongoing": self._ongoing,
                "uptime_s": time.time() - self.started_at}

    def ping(self) -> bool:
        return True
