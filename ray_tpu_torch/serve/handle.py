"""DeploymentHandle: client-side router to a deployment's replicas.

Reference analog: serve/handle.py:77 RayServeHandle +
_private/router.py:261 Router (:298 assign_request).  Routing is
least-loaded-of-two (power of two choices by in-flight count tracked
locally).  Replica membership arrives PUSH-style: a daemon listener
thread long-polls the controller's ``listen_for_change`` channel
(reference: serve/_private/long_poll.py:184 LongPollClient) and swaps
the local replica list the moment the controller mutates it — restarts,
autoscaling, and redeploys propagate in one RPC round-trip instead of a
polling interval.  A direct refresh remains the error-path fallback.
"""

from __future__ import annotations

import random
import threading
import time
import zlib
from typing import Any, Dict, List, Optional

_REFRESH_S = 5.0  # fallback staleness bound if the listener dies


class _SharedListener:
    """ONE long-poll loop per (controller, deployment) per process,
    fanned out to every registered handle via weakrefs.  Bounds the
    controller concurrency slots parked on ``listen_for_change`` at
    #processes × #deployments instead of #handles (reference: one
    LongPollClient per router process, not per handle)."""

    def __init__(self, controller, name: str):
        self._controller = controller
        self._name = name
        self._handles: list = []  # weakrefs
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        #: monotonic time of the last successful listen_for_change
        #: round-trip — handles fall back to polling when this goes
        #: stale (listener wedged/dead)
        self.last_ok = 0.0

    def register(self, handle: "DeploymentHandle") -> None:
        import weakref

        with self._lock:
            # dedupe: a handle re-registers on every request while the
            # listener is unhealthy — without this the list grows
            # unboundedly during a controller outage and each update
            # then fans out once per duplicate
            if not any(ref() is handle for ref in self._handles):
                self._handles.append(weakref.ref(handle))
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(
                    target=self._loop, daemon=True,
                    name=f"serve-longpoll-{self._name}")
                self._thread.start()

    def _live_handles(self) -> list:
        with self._lock:
            out = []
            keep = []
            for ref in self._handles:
                h = ref()
                if h is not None and not h._closed:
                    out.append(h)
                    keep.append(ref)
            self._handles = keep
            return out

    def _loop(self) -> None:
        import ray_tpu_torch

        version = 0
        while True:
            if not self._live_handles():
                with self._lock:
                    if self._handles:
                        # register() raced our empty snapshot: a fresh
                        # handle appeared between the check and this
                        # lock — keep looping for it (lost-wakeup fix)
                        continue
                    self._thread = None  # next register restarts us
                    return
            from ray_tpu_torch._private import worker_context

            cw = worker_context.maybe_core_worker()
            if cw is None or getattr(cw, "_closed", False):
                # the cluster shut down under us: a daemon listener
                # retrying forever against a closed client would touch
                # the unmapped shm store (segfault class) — exit
                with self._lock:
                    self._thread = None
                return
            try:
                out = ray_tpu_torch.get(
                    self._controller.listen_for_change.remote(
                        self._name, version),
                    timeout=60)
                self.last_ok = time.monotonic()
            except Exception:  # noqa: BLE001 - controller briefly away
                time.sleep(1.0)
                continue
            if out.get("version") == -1:
                # deployment deleted: drop out of the registry so a
                # redeploy under the same name gets a FRESH listener
                with self._lock:
                    self._thread = None
                with _listeners_lock:
                    for k, v in list(_listeners.items()):
                        if v is self:
                            del _listeners[k]
                return
            if out.get("replicas") is not None:
                version = out["version"]
                for h in self._live_handles():
                    h._apply_membership(list(out["replicas"]), version)
            elif out.get("backoff"):
                # controller long-poll slots saturated: don't hot-loop
                time.sleep(0.5)

    def healthy(self) -> bool:
        return (self._thread is not None and self._thread.is_alive()
                and time.monotonic() - self.last_ok < 90.0)


_listeners: dict = {}
_listeners_lock = threading.Lock()


def _shared_listener(controller, name: str) -> _SharedListener:
    key = (getattr(controller, "_actor_id", None) or id(controller),
           name)
    with _listeners_lock:
        lis = _listeners.get(key)
        if lis is None:
            lis = _SharedListener(controller, name)
            _listeners[key] = lis
        return lis


class DeploymentHandle:
    def __init__(self, deployment_name: str, controller):
        self.deployment_name = deployment_name
        self._controller = controller
        self._replicas: List = []
        self._version = 0
        self._inflight: Dict[Any, int] = {}
        #: (ref, replica) of requests whose completion hasn't been
        #: observed yet — reaped (decrementing _inflight) on every route.
        self._outstanding: List = []
        self._fetched_at = 0.0
        self._listener: Optional[_SharedListener] = None
        #: serializes membership swaps (listener thread) against the
        #: routing counters (request thread)
        self._route_lock = threading.Lock()
        #: power-of-two-choices sampling: seeded per deployment so a
        #: replayed request sequence routes identically run to run
        #: (the process-global `random` module would not)
        self._rng = random.Random(zlib.crc32(deployment_name.encode()))
        self._closed = False

    # -- membership -------------------------------------------------------

    def _ensure_listener(self) -> None:
        if self._listener is not None and self._listener.healthy():
            return
        self._listener = _shared_listener(self._controller,
                                          self.deployment_name)
        self._listener.register(self)

    def close(self) -> None:
        """Detach from the long-poll listener (idempotent)."""
        self._closed = True

    def _apply_membership(self, replicas: List, version: int) -> None:
        # Reset counters on membership change (a freshly restarted
        # replica must not inherit stale load) and drop the matching
        # outstanding entries so they can't decrement the fresh counters.
        with self._route_lock:
            self._replicas = replicas
            self._version = version
            self._inflight = {r: 0 for r in replicas}
            self._outstanding = []
            self._fetched_at = time.monotonic()

    def _refresh(self, force: bool = False) -> None:
        import ray_tpu_torch

        self._ensure_listener()
        if not force and self._replicas and \
                time.monotonic() - self._fetched_at < _REFRESH_S:
            return
        if not force and self._replicas and \
                self._listener is not None and self._listener.healthy():
            return  # live listener keeps us fresh; no poll needed
        # fallback poll: no listener heartbeat (wedged thread, deleted+
        # redeployed deployment) — _REFRESH_S staleness bound applies
        self._apply_membership(ray_tpu_torch.get(
            self._controller.get_replicas.remote(self.deployment_name),
            timeout=30), self._version)

    def _reap(self) -> None:
        """Decrement in-flight counts for completed requests (the router
        equivalent of the reference's completion callback decrementing
        num_queued_queries, _private/router.py:261)."""
        from ray_tpu_torch._private import worker_context

        cw = worker_context.maybe_core_worker()
        if cw is None or not self._outstanding:
            return
        still = []
        for ref, replica in self._outstanding:
            try:
                done = cw.is_ready(ref._info)
            except Exception:  # noqa: BLE001 - store closing
                done = True
            if done:
                self._inflight[replica] = max(
                    0, self._inflight.get(replica, 0) - 1)
            else:
                still.append((ref, replica))
        self._outstanding = still

    def _pick(self):
        if not self._replicas:
            raise RuntimeError(
                f"deployment {self.deployment_name!r} has no replicas")
        if len(self._replicas) == 1:
            return self._replicas[0]
        a, b = self._rng.sample(self._replicas, 2)
        return a if self._inflight.get(a, 0) <= self._inflight.get(b, 0) \
            else b

    def remote(self, *args, _serve_method: str = "__call__", **kwargs):
        """Route one request; returns an ObjectRef."""
        self._refresh()
        with self._route_lock:
            self._reap()
            replica = self._pick()
            self._inflight[replica] = self._inflight.get(replica, 0) + 1
        ref = replica.handle_request.remote(
            *args, _serve_method=_serve_method, **kwargs)
        with self._route_lock:
            self._outstanding.append((ref, replica))
        return ref

    def queue_len(self) -> int:
        """Unfinished requests routed through this handle (autoscaling
        signal)."""
        with self._route_lock:
            self._reap()
            return sum(self._inflight.values())

    def call(self, *args, timeout: float = 60.0, **kwargs):
        """Convenience: route + block for the result, with one retry
        through a table refresh if the replica died."""
        import ray_tpu_torch

        try:
            return ray_tpu_torch.get(self.remote(*args, **kwargs),
                                     timeout=timeout)
        except Exception:  # noqa: BLE001 - replica may be gone; retry once
            self._refresh(force=True)
            return ray_tpu_torch.get(self.remote(*args, **kwargs),
                                     timeout=timeout)

    def method(self, name: str) -> "_MethodCaller":
        return _MethodCaller(self, name)

    def __reduce__(self):
        return (DeploymentHandle, (self.deployment_name,
                                   self._controller))


class _MethodCaller:
    def __init__(self, handle: DeploymentHandle, method: str):
        self._handle = handle
        self._method = method

    def remote(self, *args, **kwargs):
        return self._handle.remote(*args, _serve_method=self._method,
                                   **kwargs)
