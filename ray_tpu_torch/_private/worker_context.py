"""Process-global worker state: the active CoreWorker, the current task
context, and the public ObjectRef type.

(Reference analog: python/ray/_private/worker.py:405 ``class Worker`` global
plus runtime-context accessors.)
"""

from __future__ import annotations

import threading
from typing import Any, Optional

from ray_tpu_torch._private.ids import ObjectID


class ObjectRefLike:
    """Base marker so the serializer / arg marshaller can recognize refs
    without importing the public module."""

    __slots__ = ("_info",)

    def __init__(self, info):
        self._info = info


class ObjectRef(ObjectRefLike):
    """A reference to a (possibly not yet computed) remote object.

    Reference analog: python/ray/includes/object_ref.pxi:38.  Picklable:
    passing a ref into a task or putting it inside a data structure carries
    (id, owner, owner node) so any process can resolve it.

    Each live instance counts one local reference: construction registers
    with the core worker, GC deregisters; the owner frees the object when
    all processes report zero (reference: reference_count.h:61).
    """

    __slots__ = ("_cw",)

    def __init__(self, info):
        super().__init__(info)
        self._cw = None
        cw = _core_worker
        if cw is not None:
            try:
                cw.add_local_ref(info)
                self._cw = cw  # decref must go to the SAME worker
            except Exception:  # noqa: BLE001 - shutdown race
                pass

    def __del__(self):
        cw = getattr(self, "_cw", None)
        if cw is None:
            return
        try:
            cw.remove_local_ref(self._info)
        except Exception:  # noqa: BLE001 - interpreter teardown
            pass

    def binary(self) -> bytes:
        return self._info.oid

    def hex(self) -> str:
        return self._info.oid.hex()

    def object_id(self) -> ObjectID:
        return ObjectID(self._info.oid)

    @property
    def owner_id(self) -> bytes:
        return self._info.owner

    def __eq__(self, other):
        return isinstance(other, ObjectRef) and other._info.oid == self._info.oid

    def __hash__(self):
        return hash(self._info.oid)

    def __repr__(self):
        return f"ObjectRef({self.hex()})"

    def __reduce__(self):
        i = self._info
        # Surface nested refs to an active serialization scope so task
        # submission can pin them (reference: contained-ObjectRef tracking
        # in serialization.py's SerializationContext).
        collector = getattr(_ser_scope, "refs", None)
        if collector is not None:
            collector.append(i)
        return (_rebuild_ref, (i.oid, i.owner, i.node_address))

    def future(self):
        """concurrent.futures.Future resolving to the object's value."""
        import concurrent.futures

        fut: concurrent.futures.Future = concurrent.futures.Future()

        def _poll():
            from ray_tpu_torch import get

            try:
                fut.set_result(get(self))
            except BaseException as e:  # noqa: BLE001
                fut.set_exception(e)

        threading.Thread(target=_poll, daemon=True).start()
        return fut


def _rebuild_ref(oid: bytes, owner: bytes, node_address: str) -> ObjectRef:
    from ray_tpu_torch._private.client import ObjectRefInfo

    return ObjectRef(ObjectRefInfo(oid, owner, node_address))


#: Thread-local scope used to collect refs encountered while pickling a
#: task argument (set by CoreWorker._marshal_arg).
_ser_scope = threading.local()


class _GlobalState(threading.local):
    pass


_state_lock = threading.Lock()
_core_worker: Optional[Any] = None
_node: Optional[Any] = None
_mode: str = ""
# Per-execution context (current task/actor) for workers.  ContextVars
# behave like thread-locals on plain threads AND isolate per-asyncio-Task
# for async actor methods (each Task runs in its own context copy, so
# interleaved coroutines from different tasks can't clobber each other —
# a bare threading.local could).
import contextvars as _contextvars

_task_id_var = _contextvars.ContextVar("raytpu_task_id", default=b"")
_actor_id_var = _contextvars.ContextVar("raytpu_actor_id", default=b"")


def set_core_worker(cw, node=None, mode: str = "driver"):
    global _core_worker, _node, _mode
    with _state_lock:
        _core_worker = cw
        _node = node
        _mode = mode


def core_worker():
    if _core_worker is None:
        raise RuntimeError(
            "ray_tpu_torch has not been initialized; call ray_tpu_torch.init() first")
    return _core_worker


def maybe_core_worker():
    return _core_worker


def node():
    return _node


def mode() -> str:
    return _mode


def is_initialized() -> bool:
    return _core_worker is not None


def clear():
    global _core_worker, _node, _mode
    with _state_lock:
        _core_worker = None
        _node = None
        _mode = ""


def set_task_context(task_id: bytes, actor_id: bytes = b""):
    _task_id_var.set(task_id)
    _actor_id_var.set(actor_id)


def current_task_id() -> bytes:
    return _task_id_var.get()


def current_actor_id() -> bytes:
    return _actor_id_var.get()
