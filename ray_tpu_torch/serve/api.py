"""Deployments as records: a copy of the ``Deployment`` dataclass and
the ``@deployment`` decorator of ``ray_tpu/serve/api.py``.

A ``Deployment`` names a callable or class and how many replicas of it
to run; ``build_llm_deployment`` returns one, and the fleet
(``serve/router.py``) builds its replicas from ``func_or_class``.
What runs a deployment as actors (the controller, ``run``, handles,
the HTTP proxy) needs the core runtime and is ROADMAP.md queue 1
item 6.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Union

__all__ = ["Deployment", "deployment"]


@dataclasses.dataclass
class Deployment:
    func_or_class: Union[Callable, type]
    name: str
    num_replicas: int = 1
    ray_actor_options: Optional[Dict[str, Any]] = None
    max_concurrent_queries: int = 8
    autoscaling_config: Optional[Dict[str, Any]] = None
    route_prefix: Optional[str] = None
    init_args: tuple = ()
    init_kwargs: Optional[Dict[str, Any]] = None

    def bind(self, *args, **kwargs) -> "Deployment":
        return dataclasses.replace(self, init_args=args,
                                   init_kwargs=kwargs)

    def options(self, **kwargs) -> "Deployment":
        return dataclasses.replace(self, **kwargs)


def deployment(_func_or_class=None, *, name: Optional[str] = None,
               num_replicas: int = 1,
               ray_actor_options: Optional[Dict[str, Any]] = None,
               max_concurrent_queries: int = 8,
               autoscaling_config: Optional[Dict[str, Any]] = None,
               route_prefix: Optional[str] = None):
    """@serve.deployment decorator.  autoscaling_config (reference:
    serve autoscaling, _private/autoscaling_policy.py): dict with
    min_replicas / max_replicas / target_ongoing_requests /
    upscale_delay_s / downscale_delay_s — replica count then tracks
    queue depth instead of num_replicas."""

    def wrap(target):
        return Deployment(
            target, name or getattr(target, "__name__", "deployment"),
            num_replicas=num_replicas,
            ray_actor_options=ray_actor_options,
            max_concurrent_queries=max_concurrent_queries,
            autoscaling_config=autoscaling_config,
            route_prefix=route_prefix)

    return wrap(_func_or_class) if _func_or_class is not None else wrap
