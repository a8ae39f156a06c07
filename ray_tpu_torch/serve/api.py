"""Public serve API: a copy of ``ray_tpu/serve/api.py`` (reference
analog: serve/api.py:251-277 @serve.deployment, :455 serve.run).

``Deployment`` names a callable or class and how many replicas of it
to run; ``build_llm_deployment`` returns one, and the fleet
(``serve/router.py``) builds its replicas in process from
``func_or_class``.  ``run`` deploys one (or a graph of them) on the
core runtime: a detached ``ServeController`` actor starts one
``RayServeReplica`` actor per replica, and the returned
``DeploymentHandle`` routes calls to them.  A replica that should hold
a card asks for it, ``ray_actor_options={"num_gpus": 1}``; its process
then sees only its granted card as ``cuda:0``.  The HTTP ingress
(``start_http_proxy``, ``run(http=True)``) is a detached
``HTTPProxyActor`` (``serve/http_proxy.py``) on one node or, with
``per_node=True``, on each.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Union

from ray_tpu_torch._private._vendor import cloudpickle
from ray_tpu_torch.serve.controller import CONTROLLER_NAME, ServeController
from ray_tpu_torch.serve.handle import DeploymentHandle

__all__ = ["Deployment", "deployment", "run", "get_deployment_handle",
           "start_http_proxy", "status", "engine_stats", "delete",
           "shutdown"]

_PROXY_NAME = "SERVE_HTTP_PROXY"


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


def _get_or_create_controller():
    import ray_tpu_torch

    ray_tpu_torch._auto_init()
    try:
        return ray_tpu_torch.get_actor(CONTROLLER_NAME)
    except Exception:  # noqa: BLE001 - not created yet
        # concurrency sized for long-poll: every PROCESS parks one
        # listen_for_change call per deployment on a controller slot
        # (handle._SharedListener; parked calls wait on a Condition —
        # threads, not CPU)
        return ray_tpu_torch.remote(
            num_cpus=0.1, lifetime="detached", name=CONTROLLER_NAME,
            max_concurrency=128)(ServeController).remote()


def _graphify(obj, deployed: set, controller, overrides=None):
    """Deployment-graph support (reference: serve/deployment_graph.py on
    Ray DAG): bound deployments nested in init args deploy first and are
    replaced by handle markers the replica resolves at construction."""
    from ray_tpu_torch.serve.replica import DeploymentHandleMarker

    if isinstance(obj, Deployment):
        _deploy_one(obj, deployed, controller, overrides=overrides)
        return DeploymentHandleMarker(obj.name)
    if isinstance(obj, (list, tuple)):
        return type(obj)(_graphify(x, deployed, controller, overrides)
                         for x in obj)
    if isinstance(obj, dict):
        return {k: _graphify(v, deployed, controller, overrides)
                for k, v in obj.items()}
    return obj


def _deploy_one(target: Deployment, deployed: set, controller,
                route_prefix: Optional[str] = None,
                overrides=None) -> None:
    import ray_tpu_torch

    if target.name in deployed:
        return
    deployed.add(target.name)
    ov = (overrides or {}).get(target.name)
    if ov:
        target = target.options(**ov)
    init_args = _graphify(target.init_args, deployed, controller,
                          overrides)
    init_kwargs = _graphify(target.init_kwargs or {}, deployed,
                            controller, overrides)
    ray_tpu_torch.get(controller.deploy.remote(
        target.name, cloudpickle.dumps(target.func_or_class),
        init_args, init_kwargs,
        num_replicas=target.num_replicas,
        ray_actor_options=target.ray_actor_options,
        max_concurrent_queries=target.max_concurrent_queries,
        autoscaling_config=target.autoscaling_config,
        route_prefix=route_prefix or target.route_prefix), timeout=120)


def run(target: Deployment, *, route_prefix: Optional[str] = None,
        http: bool = False, http_port: int = 8000,
        _overrides: Optional[Dict[str, Dict[str, Any]]] = None
        ) -> DeploymentHandle:
    """Deploy (a graph of) deployments and return the root handle
    (reference serve.run, serve/api.py:455; graphs via .bind()
    composition as in serve/deployment_graph.py).  With http=True the
    HTTP ingress proxy is started as well.  ``_overrides`` (the
    declarative-config path, serve/schema.py): per-deployment option
    overlays applied to EVERY deployment in the graph by name."""
    controller = _get_or_create_controller()
    # config-over-code precedence: a declarative route_prefix override
    # on the root deployment wins over the code-level default
    root_ov = (_overrides or {}).get(target.name) or {}
    # route_prefix always defaults to /<name> (reference semantics) so
    # a proxy started later — e.g. the per-node fleet — can route to
    # deployments created before it
    prefix = route_prefix or root_ov.get("route_prefix") or \
        target.route_prefix or f"/{target.name}"
    deployed: set = set()
    _deploy_one(target, deployed, controller, route_prefix=prefix,
                overrides=_overrides)
    if _overrides:
        unmatched = set(_overrides) - deployed
        if unmatched:
            raise ValueError(
                f"config deployments {sorted(unmatched)} matched no "
                f"deployment in the graph (deployed: {sorted(deployed)})")
    if http:
        start_http_proxy(port=http_port)
    return DeploymentHandle(target.name, controller)


def get_deployment_handle(name: str) -> DeploymentHandle:
    return DeploymentHandle(name, _get_or_create_controller())


def start_http_proxy(port: int = 8000, host: str = "127.0.0.1",
                     per_node: bool = False) -> str:
    """Start the HTTP ingress.  ``per_node=True`` starts one proxy actor
    on EVERY alive node, pinned via each node's affinity resource
    (reference: serve/_private/http_state.py HTTPProxyStateManager —
    one proxy per node, node:<ip> affinity), so ingress scales
    horizontally with the cluster and requests enter on the node they
    hit; the i-th node's proxy listens on ``port + i``.  Returns the
    local (first) proxy's address."""
    import ray_tpu_torch
    from ray_tpu_torch.serve.http_proxy import HTTPProxyActor

    controller = _get_or_create_controller()
    if not per_node:
        try:
            proxy = ray_tpu_torch.get_actor(_PROXY_NAME)
        except Exception:  # noqa: BLE001
            proxy = ray_tpu_torch.remote(
                num_cpus=0.1, lifetime="detached", name=_PROXY_NAME)(
                HTTPProxyActor).remote(controller, host, port)
        ray_tpu_torch.get(proxy.ping.remote(), timeout=60)
        return ray_tpu_torch.get(proxy.address.remote(), timeout=30)

    proxies = []
    for i, node in enumerate(n for n in ray_tpu_torch.nodes()
                             if n["Alive"]):
        node_hex = node["NodeID"]
        name = f"{_PROXY_NAME}:{node_hex[:12]}"
        try:
            proxy = ray_tpu_torch.get_actor(name)
        except Exception:  # noqa: BLE001
            proxy = ray_tpu_torch.remote(
                num_cpus=0.1, lifetime="detached", name=name,
                resources={f"node:{node_hex}": 0.01},
            )(HTTPProxyActor).remote(controller, host, port + i)
        proxies.append(proxy)
    addrs = ray_tpu_torch.get([p.address.remote() for p in proxies],
                              timeout=60)
    ray_tpu_torch.get([p.ping.remote() for p in proxies], timeout=60)
    return addrs[0]


def status() -> dict:
    """Cluster serve status: {deployment: {status, replicas, ...}}
    (reference: serve.status())."""
    import ray_tpu_torch

    controller = _get_or_create_controller()
    return ray_tpu_torch.get(controller.status.remote(), timeout=30.0)


def engine_stats(deployment_name: str, timeout: float = 30.0) -> dict:
    """Engine telemetry snapshot from one replica of an LM deployment
    (p50/p95/p99 TTFT + queue wait, throughput, slot utilization —
    serve/telemetry.py).  Raises for deployments without an
    ``engine_stats`` method; the dashboard's ``/api/serve/stats``
    aggregates this across every deployment, skipping those."""
    import ray_tpu_torch

    handle = get_deployment_handle(deployment_name)
    return ray_tpu_torch.get(handle.method("engine_stats").remote(),
                       timeout=timeout)


def delete(name: str) -> None:
    import ray_tpu_torch

    controller = _get_or_create_controller()
    ray_tpu_torch.get(controller.delete_deployment.remote(name), timeout=60)


def shutdown() -> None:
    import ray_tpu_torch

    try:
        controller = ray_tpu_torch.get_actor(CONTROLLER_NAME)
        ray_tpu_torch.get(controller.shutdown.remote(), timeout=60)
        ray_tpu_torch.kill(controller)
    except Exception:  # noqa: BLE001
        pass
    try:
        proxy = ray_tpu_torch.get_actor(_PROXY_NAME)
        ray_tpu_torch.kill(proxy)
    except Exception:  # noqa: BLE001
        pass
