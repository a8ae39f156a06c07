"""Actor API: @remote classes, ActorHandle, ActorMethod.

(Reference analog: python/ray/actor.py — :377 ActorClass, :657
ActorClass._remote, :1020 ActorHandle, :92 ActorMethod.)
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Optional

from ray_tpu_torch._private._vendor import cloudpickle

from ray_tpu_torch._private import worker_context
from ray_tpu_torch._private.worker_context import ObjectRef
from ray_tpu_torch.remote_function import _build_resources, _pg_option


class ActorMethod:
    def __init__(self, handle: "ActorHandle", name: str):
        self._handle = handle
        self._name = name

    def remote(self, *args, **kwargs):
        return self._handle._invoke(self._name, args, kwargs,
                                    self._handle._method_opts.get(self._name, {}))

    def options(self, **opts):
        return _BoundMethod(self._handle, self._name, opts)

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"actor method {self._name}() cannot be called directly; "
            f"use .{self._name}.remote().")


class _BoundMethod:
    def __init__(self, handle, name, opts):
        self._handle = handle
        self._name = name
        self._opts = opts

    def remote(self, *args, **kwargs):
        return self._handle._invoke(self._name, args, kwargs, self._opts)


class ActorHandle:
    """Handle to a (possibly remote) actor; picklable — passing a handle to
    a task or actor lets it call methods too (reference: actor handles are
    first-class serializable)."""

    def __init__(self, actor_id: bytes, method_opts: Optional[Dict] = None):
        self._actor_id = actor_id
        self._method_opts = method_opts or {}

    @property
    def actor_id(self) -> bytes:
        return self._actor_id

    def _invoke(self, method: str, args, kwargs, opts):
        cw = worker_context.core_worker()
        num_returns = opts.get("num_returns", 1)
        if num_returns == "dynamic":
            raise ValueError(
                "num_returns='dynamic' is not supported for actor "
                "methods (only stateless tasks); return a list of "
                "ray_tpu_torch.put refs instead")
        refs = cw.submit_actor_task(self._actor_id, method, args, kwargs,
                                    num_returns=num_returns)
        wrapped = [ObjectRef(r) for r in refs]
        if num_returns == 0:
            return None
        return wrapped[0] if num_returns == 1 else wrapped

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        return ActorMethod(self, name)

    def __reduce__(self):
        return (ActorHandle, (self._actor_id, self._method_opts))

    def __repr__(self):
        from ray_tpu_torch._private.ids import ActorID

        return f"ActorHandle({ActorID(self._actor_id).hex()[:16]})"

    def __eq__(self, other):
        return isinstance(other, ActorHandle) and other._actor_id == self._actor_id

    def __hash__(self):
        return hash(self._actor_id)


class ActorClass:
    """Created by ``@ray_tpu_torch.remote`` on a class."""

    def __init__(self, cls, options: Optional[Dict[str, Any]] = None):
        self._cls = cls
        self._options = dict(options or {})
        self._pickled: Optional[bytes] = None
        self._export_lock = threading.Lock()
        self.__name__ = getattr(cls, "__name__", "ActorClass")

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"actor class {self.__name__} cannot be instantiated directly; "
            f"use {self.__name__}.remote().")

    def options(self, **opts) -> "ActorClass":
        merged = dict(self._options)
        merged.update(opts)
        ac = ActorClass(self._cls, merged)
        ac._pickled = self._pickled
        return ac

    def bind(self, *args, **kwargs):
        """Record a lazy actor-construction DAG node (reference:
        ray.dag ClassNode)."""
        from ray_tpu_torch.dag import ClassNode

        return ClassNode(self, args, kwargs)

    def __reduce__(self):
        return (ActorClass, (self._cls, self._options))

    def remote(self, *args, **kwargs) -> ActorHandle:
        from ray_tpu_torch import _auto_init

        _auto_init()
        cw = worker_context.core_worker()
        with self._export_lock:
            if self._pickled is None:
                self._pickled = cloudpickle.dumps(self._cls)
        fid = cw.export_function(self._pickled)
        opts = self._options
        resources = _build_resources(opts)
        actor_id = cw.create_actor(
            fid, args, kwargs,
            resources=resources,
            name=opts.get("name") or "",
            max_restarts=opts.get("max_restarts", 0),
            lifetime=opts.get("lifetime") or "",
            # 0 = unset: the worker raises it for async actors (classes
            # with coroutine methods default to high concurrency so their
            # coroutines interleave — reference async-actor semantics)
            max_concurrency=opts.get("max_concurrency", 0),
            pg=_pg_option(opts),
        )
        # Creation is ASYNC (reference semantics): the handle returns
        # immediately; worker spawn + ctor run in the background and the
        # first method call parks until the actor is ALIVE (or raises
        # ActorDiedError if the ctor failed).  Infeasible shapes still
        # fail fast — the GCS checks feasibility inside actor_register.
        return ActorHandle(actor_id)
