"""ServeController: the serve control plane, one named detached actor.

Reference analog: serve/controller.py:61 ServeController (:410
deploy_app) + _private/deployment_state.py reconciliation.  Owns desired
deployment state, creates/updates replica actors, repairs dead replicas
(background reconcile thread), and hands routing tables to handles —
the pull-based stand-in for the reference's LongPollHost push channel
(serve/_private/long_poll.py:184).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional

CONTROLLER_NAME = "SERVE_CONTROLLER"


def _load_value(v: Any) -> float:
    """Per-replica ongoing load from a probe result: probes historically
    return a bare pending count (float); richer probes return a dict
    carrying at least {"pending": ...}.  Both shapes are accepted
    everywhere loads are consumed so signals can evolve without
    breaking the controller."""
    if isinstance(v, dict):
        return float(v.get("pending", 0.0))
    return float(v)


def _queue_depth_signal(loads: Dict[Any, Any],
                        ac: Dict[str, Any]) -> float:
    """LEGACY DEFAULT load signal: total ongoing requests across
    replicas (the reconcile probe's pending counts).  This is the
    reference autoscaling_policy behavior — desired replicas =
    ceil(total / target_ongoing_requests) — and what every deployment
    gets unless its autoscaling config names another signal."""
    return sum(_load_value(v) for v in loads.values())


def _burn_rate_signal(loads: Dict[Any, Any],
                      ac: Dict[str, Any]) -> float:
    """SLO-aware load signal: queue depth inflated by burn rate.  A
    replica burning its error budget at b× the configured
    ``burn_threshold`` counts as b× its pending load (never less than
    its raw pending), so a fleet meeting SLOs scales exactly like the
    legacy signal while a breaching fleet scales up even at modest
    queue depth.  Probe values must be dicts carrying "burn_rate"
    (worst objective, 30s window — see serve/slo.py worst_burn_rate);
    bare floats degrade to the legacy behavior."""
    threshold = float(ac.get("burn_threshold", 1.0)) or 1.0
    total = 0.0
    for v in loads.values():
        pending = _load_value(v)
        burn = float(v.get("burn_rate", 0.0)) if isinstance(v, dict) \
            else 0.0
        total += pending * max(1.0, burn / threshold)
    return total


#: Pluggable autoscaling load signals, selected per deployment via
#: ``autoscaling_config={"load_signal": "<name>", ...}``.  Values map a
#: per-replica loads dict (probe results) + the autoscaling config to
#: ONE total-load float that feeds desired = ceil(total / target).
#: The in-process fleet autoscaler (serve/router.py) routes its
#: burn-rate decisions through the same "burn_rate" entry.
LOAD_SIGNALS = {
    "queue_depth": _queue_depth_signal,
    "burn_rate": _burn_rate_signal,
}


class ServeController:
    def __init__(self):
        # name -> {config, replicas: [ActorHandle], version}
        self.deployments: Dict[str, Dict[str, Any]] = {}
        self.routes: Dict[str, str] = {}  # route_prefix -> deployment
        self._lock = threading.Lock()
        #: long-poll push channel (reference: serve/_private/long_poll.py
        #: :184 LongPollHost): every replica-set mutation bumps the
        #: deployment version and wakes blocked listen_for_change calls,
        #: so handles learn of changes push-style instead of on a poll
        #: interval.
        self._change = threading.Condition(self._lock)
        self._stop = False
        #: health checks (reference DeploymentConfig defaults:
        #: health_check_timeout_s=30, failure threshold 3)
        self._probe_timeout_s = 30.0
        self._probe_failure_threshold = 3
        self._probe_failures: Dict[Any, int] = {}
        self._last_loads: Dict[Any, float] = {}
        self._reconciler = threading.Thread(target=self._reconcile_loop,
                                            daemon=True,
                                            name="serve_reconcile")
        self._reconciler.start()

    def _bump_locked(self, name: str) -> None:
        """Caller holds self._lock: record a replica-set change and wake
        long-poll listeners."""
        dep = self.deployments.get(name)
        if dep is not None:
            dep["version"] += 1
        self._change.notify_all()

    # -- deploy path ------------------------------------------------------
    def deploy(self, name: str, serialized_def: bytes, init_args: tuple,
               init_kwargs: Dict[str, Any], *, num_replicas: int = 1,
               ray_actor_options: Optional[Dict[str, Any]] = None,
               max_concurrent_queries: int = 8,
               autoscaling_config: Optional[Dict[str, Any]] = None,
               route_prefix: Optional[str] = None) -> bool:
        if autoscaling_config:
            ac = {"min_replicas": 1, "max_replicas": 8,
                  "target_ongoing_requests": 2.0,
                  "upscale_delay_s": 0.0, "downscale_delay_s": 10.0}
            ac.update(autoscaling_config)
            num_replicas = max(num_replicas, ac["min_replicas"])
        else:
            ac = None
        with self._lock:
            old = self.deployments.get(name)
            cfg = {"serialized_def": serialized_def,
                   "init_args": init_args, "init_kwargs": init_kwargs,
                   "num_replicas": num_replicas,
                   "actor_options": ray_actor_options or {},
                   "max_concurrent_queries": max_concurrent_queries,
                   "autoscaling": ac}
            version = (old["version"] + 1) if old else 1
            replicas = [self._start_replica(name, cfg)
                        for _ in range(num_replicas)]
            self.deployments[name] = {"config": cfg, "replicas": replicas,
                                      "version": version,
                                      "scale_pending_since": None}
            self._change.notify_all()
            if route_prefix:
                self.routes[route_prefix] = name
            if old:
                for r in old["replicas"]:
                    self._kill_replica(r)
        return True

    def delete_deployment(self, name: str) -> bool:
        with self._lock:
            dep = self.deployments.pop(name, None)
            self.routes = {p: d for p, d in self.routes.items()
                           if d != name}
            self._change.notify_all()
        if dep:
            for r in dep["replicas"]:
                self._kill_replica(r)
        return dep is not None

    def _start_replica(self, name: str, cfg: Dict[str, Any]):
        import ray_tpu_torch
        from ray_tpu_torch.serve.replica import RayServeReplica

        opts = dict(cfg["actor_options"])
        opts.setdefault("num_cpus", 0.1)
        opts["max_concurrency"] = cfg["max_concurrent_queries"]
        return ray_tpu_torch.remote(**opts)(RayServeReplica).remote(
            cfg["serialized_def"], cfg["init_args"], cfg["init_kwargs"],
            name)

    def _kill_replica(self, replica) -> None:
        import ray_tpu_torch

        try:
            ray_tpu_torch.kill(replica)
        except Exception:  # noqa: BLE001
            pass

    # -- routing ----------------------------------------------------------
    def get_replicas(self, name: str) -> List:
        with self._lock:
            dep = self.deployments.get(name)
            return list(dep["replicas"]) if dep else []

    def listen_for_change(self, name: str, known_version: int,
                          timeout: float = 25.0) -> Dict[str, Any]:
        """Long-poll push channel (reference:
        serve/_private/long_poll.py:184 LongPollHost.listen_for_change):
        blocks until the deployment's replica set differs from the
        caller's ``known_version`` (returning immediately when it
        already does), or until ``timeout`` — the caller re-issues the
        call in a loop, so membership changes propagate push-style with
        no polling interval.  A deleted deployment answers version -1.
        Runs on one of the controller actor's concurrency slots; the
        slot parks in Condition.wait, costing a thread but no CPU.
        Slots are BOUNDED: past ~100 parked listeners the call answers
        immediately with a backoff hint instead of parking, so
        control-plane calls (deploy/delete/status) never queue behind a
        wall of long-polls (the remaining concurrency slots stay
        free)."""
        deadline = time.monotonic() + timeout
        with self._change:
            dep = self.deployments.get(name)
            if dep is None:
                return {"version": -1, "replicas": []}
            if dep["version"] != known_version:
                return {"version": dep["version"],
                        "replicas": list(dep["replicas"])}
            if getattr(self, "_parked", 0) >= 100:
                # saturated: answer now with a backoff hint rather than
                # consuming one of the few remaining slots
                return {"version": known_version, "replicas": None,
                        "backoff": True}
            self._parked = getattr(self, "_parked", 0) + 1
            try:
                while True:
                    dep = self.deployments.get(name)
                    if dep is None:
                        return {"version": -1, "replicas": []}
                    if dep["version"] != known_version:
                        return {"version": dep["version"],
                                "replicas": list(dep["replicas"])}
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        return {"version": known_version,
                                "replicas": None}
                    self._change.wait(remaining)
            finally:
                self._parked -= 1

    def get_routing_table(self) -> Dict[str, Any]:
        with self._lock:
            return {"routes": dict(self.routes),
                    "versions": {n: d["version"]
                                 for n, d in self.deployments.items()}}

    def list_deployments(self) -> List[str]:
        with self._lock:
            return sorted(self.deployments)

    def status(self) -> Dict[str, Any]:
        """Deployment statuses (reference: serve.status() /
        StatusOverview): replica counts, autoscaling mode, route."""
        with self._lock:
            out = {}
            routes = {v: k for k, v in self.routes.items()}
            for name, d in self.deployments.items():
                out[name] = {
                    "status": "HEALTHY" if d["replicas"] else "UNHEALTHY",
                    "replicas": len(d["replicas"]),
                    "target_replicas": d["config"].get("num_replicas",
                                                       len(d["replicas"])),
                    "autoscaling": bool(
                        d["config"].get("autoscaling_config")),
                    "version": d["version"],
                    "route": routes.get(name),
                }
            return out

    # -- reconciliation ---------------------------------------------------
    def configure_health_checks(self, *, probe_timeout_s: float = None,
                                failure_threshold: int = None) -> None:
        """Tune replica health probing (ops/tests; reference analog:
        DeploymentConfig health_check_timeout_s / failure threshold)."""
        if probe_timeout_s is not None:
            self._probe_timeout_s = float(probe_timeout_s)
        if failure_threshold is not None:
            self._probe_failure_threshold = int(failure_threshold)

    def _reconcile_loop(self):
        import ray_tpu_torch

        while not self._stop:
            time.sleep(2.0)
            with self._lock:
                deps = {n: list(d["replicas"])
                        for n, d in self.deployments.items()}
            for name, replicas in deps.items():
                loads: Dict[Any, float] = {}
                # Out-of-band probes: liveness + queue depth in one
                # call, answered on the worker's server loop so a
                # replica saturated with user requests still reports
                # (reference: health checks on the control concurrency
                # group).  All probes go out CONCURRENTLY under one
                # deadline — a single wedged replica must not stall
                # health checks for everything else by timeout×N.
                refs = [(r, r.raytpu_probe.remote()) for r in replicas]
                deadline = time.monotonic() + self._probe_timeout_s
                for r, ref in refs:
                    try:
                        info = ray_tpu_torch.get(
                            ref, timeout=max(
                                0.1, deadline - time.monotonic()))
                        loads[r] = float(info.get("pending", 0))
                        self._probe_failures.pop(r, None)
                        self._last_loads[r] = loads[r]
                    except Exception:  # noqa: BLE001 - maybe dead
                        # Replacement needs CONSECUTIVE failures
                        # (reference: health_check_failure_threshold):
                        # a replica mid-jit-trace can hold the GIL past
                        # one probe window without being dead — tearing
                        # it down also throws away its warm compile
                        # cache and any replica state.  Keyed by the
                        # handle itself (held reference → stable id),
                        # pruned below when replicas leave.
                        n = self._probe_failures.get(r, 0) + 1
                        self._probe_failures[r] = n
                        if n < self._probe_failure_threshold:
                            # still routed + autoscale-visible: carry
                            # the last-known load (default 1.0) so a
                            # busy-but-unprobed replica is neither a
                            # preferred downscale victim (0.0 would
                            # sort it first) nor an upscale trigger
                            loads[r] = self._last_loads.get(r, 1.0)
                            continue
                        self._probe_failures.pop(r, None)
                        with self._lock:
                            dep = self.deployments.get(name)
                            if dep is None or r not in dep["replicas"]:
                                continue
                            dep["replicas"].remove(r)
                            try:
                                dep["replicas"].append(
                                    self._start_replica(name,
                                                        dep["config"]))
                            except Exception:  # noqa: BLE001
                                pass
                            self._bump_locked(name)
                self._autoscale_one(name, loads)
            # prune bookkeeping for replicas no longer deployed
            with self._lock:
                live = {r for d in self.deployments.values()
                        for r in d["replicas"]}
            for table in (self._probe_failures, self._last_loads):
                for r in list(table):
                    if r not in live:
                        table.pop(r, None)

    def _autoscale_one(self, name: str,
                       loads: Optional[Dict[Any, float]] = None) -> None:
        """Replica scaling from a PLUGGABLE load signal (reference:
        autoscaling_policy.py:93 calculate_desired_num_replicas — desired
        = ceil(total_load / target) — and :127's upscale/downscale delay
        smoothing).  ``loads``: per-replica probe results — bare pending
        counts (legacy) or dicts with "pending" and optionally
        "burn_rate".  The signal is chosen by the deployment's
        ``autoscaling_config["load_signal"]`` from LOAD_SIGNALS;
        the default "queue_depth" reproduces the historical raw-queue-
        length behavior exactly, so deployments that don't opt in see
        no change."""
        import math

        with self._lock:
            dep = self.deployments.get(name)
            if dep is None or not dep["config"].get("autoscaling"):
                return
            ac = dep["config"]["autoscaling"]
        signal = LOAD_SIGNALS.get(str(ac.get("load_signal",
                                             "queue_depth")),
                                  _queue_depth_signal)
        total = signal(loads or {}, ac)
        desired = max(ac["min_replicas"],
                      min(ac["max_replicas"],
                          math.ceil(total / ac["target_ongoing_requests"])
                          if total > 0 else ac["min_replicas"]))
        now = time.monotonic()
        with self._lock:
            dep = self.deployments.get(name)
            if dep is None:
                return
            cur = len(dep["replicas"])
            if desired == cur:
                dep["scale_pending_since"] = None
                return
            delay = ac["upscale_delay_s"] if desired > cur else \
                ac["downscale_delay_s"]
            since = dep["scale_pending_since"]
            if since is None:
                dep["scale_pending_since"] = now
                if delay > 0:
                    return
            elif now - since < delay:
                return
            dep["scale_pending_since"] = None
            if desired > cur:
                for _ in range(desired - cur):
                    try:
                        dep["replicas"].append(
                            self._start_replica(name, dep["config"]))
                    except Exception:  # noqa: BLE001
                        break
                self._bump_locked(name)
            else:
                # Prefer least-loaded victims; stop routing to them now
                # (removed from the table), then drain before killing so
                # in-flight requests finish (reference: graceful replica
                # shutdown in deployment_state reconciliation).
                ordered = sorted(
                    dep["replicas"],
                    key=lambda r: _load_value((loads or {}).get(r, 0.0)))
                victims = ordered[:cur - desired]
                dep["replicas"] = [r for r in dep["replicas"]
                                   if r not in victims]
                self._bump_locked(name)
        for r in victims if desired < cur else ():
            threading.Thread(target=self._drain_and_kill, args=(r,),
                             daemon=True).start()

    def _drain_and_kill(self, replica, timeout: float = 30.0) -> None:
        import ray_tpu_torch

        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            try:
                info = ray_tpu_torch.get(replica.raytpu_probe.remote(),
                                         timeout=5)
                if info.get("pending", 0) == 0:
                    break
            except Exception:  # noqa: BLE001 - already dead
                break
            time.sleep(0.5)
        self._kill_replica(replica)

    def shutdown(self) -> bool:
        self._stop = True
        for name in list(self.deployments):
            self.delete_deployment(name)
        return True
