"""Lazy task/actor DAGs: build once with .bind(), execute many times.

A copy of ``ray_tpu/dag/__init__.py``.  Reference analog:
python/ray/dag/ (dag_node.py:23 DAGNode; function_node.py /
class_node.py; input_node.py InputNode) — the substrate under Serve
deployment graphs.  `fn.bind(*args)` records a node instead of
submitting; `dag.execute(input)` walks the DAG, submitting each task
with its parents' ObjectRefs as arguments, so the whole graph is in
flight at once and intermediate values never pass through the driver.

Shared-subexpression semantics match the reference: a node bound into
two downstream nodes executes ONCE per execute() call (results are
memoized per walk).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

__all__ = ["DAGNode", "FunctionNode", "ClassNode", "ClassMethodNode",
           "InputNode"]


class DAGNode:
    """Base: a recorded, not-yet-submitted invocation."""

    def __init__(self, args: Tuple, kwargs: Dict[str, Any]):
        self._bound_args = args
        self._bound_kwargs = kwargs

    # -- execution ---------------------------------------------------------

    def execute(self, *input_args, **input_kwargs):
        """Submit the whole DAG; returns this node's result handle
        (ObjectRef for task nodes, ActorHandle for class nodes)."""
        cache: Dict[int, Any] = {}
        return self._execute(cache, input_args, input_kwargs)

    def _resolve(self, value, cache, input_args, input_kwargs,
                 depth: int = 0):
        if isinstance(value, DAGNode):
            out = value._execute(cache, input_args, input_kwargs)
            if depth > 0:
                # refs nested inside containers are NOT auto-resolved by
                # the task layer (standard task-arg semantics), so the
                # DAG resolves them here; top-level refs pass through and
                # resolve worker-side with no driver round-trip
                from ray_tpu_torch import ObjectRef, get

                if isinstance(out, ObjectRef):
                    out = get(out)
            return out
        if isinstance(value, (list, tuple)):
            return type(value)(
                self._resolve(v, cache, input_args, input_kwargs,
                              depth + 1)
                for v in value)
        if isinstance(value, dict):
            return {k: self._resolve(v, cache, input_args, input_kwargs,
                                     depth + 1)
                    for k, v in value.items()}
        return value

    def _execute(self, cache, input_args, input_kwargs):
        key = id(self)
        if key not in cache:
            # each actual argument resolves at depth 0: a node in
            # top-level position passes its ObjectRef straight into the
            # downstream .remote() call (worker-side resolution, graph
            # stays in flight); only container-nested refs are get()-ed
            args = tuple(
                self._resolve(a, cache, input_args, input_kwargs, 0)
                for a in self._bound_args)
            kwargs = {
                k: self._resolve(v, cache, input_args, input_kwargs, 0)
                for k, v in self._bound_kwargs.items()}
            cache[key] = self._submit(args, kwargs)
        return cache[key]

    def _submit(self, args, kwargs):
        raise NotImplementedError


class InputNode(DAGNode):
    """Placeholder for execute()-time input (reference:
    dag/input_node.py).  Use as a context manager for parity with the
    reference API, or construct directly."""

    def __init__(self, index: int = 0, key: Optional[str] = None):
        super().__init__((), {})
        self._index = index
        self._key = key

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def _execute(self, cache, input_args, input_kwargs):
        if self._key is not None:
            return input_kwargs[self._key]
        return input_args[self._index]


class FunctionNode(DAGNode):
    def __init__(self, remote_fn, args, kwargs):
        super().__init__(args, kwargs)
        self._fn = remote_fn

    def _submit(self, args, kwargs):
        return self._fn.remote(*args, **kwargs)


class ClassNode(DAGNode):
    """A bound actor construction; method .bind() on it records method
    nodes against the (lazily created, per-execute) actor."""

    def __init__(self, actor_cls, args, kwargs):
        super().__init__(args, kwargs)
        self._cls = actor_cls

    def _submit(self, args, kwargs):
        return self._cls.remote(*args, **kwargs)

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        return _MethodBinder(self, name)


class _MethodBinder:
    def __init__(self, class_node: ClassNode, method: str):
        self._class_node = class_node
        self._method = method

    def bind(self, *args, **kwargs) -> "ClassMethodNode":
        return ClassMethodNode(self._class_node, self._method, args,
                               kwargs)


class ClassMethodNode(DAGNode):
    """The actor handle is just the node's first bound dependency, so
    the shared DAGNode._execute memoize/resolve path covers it (a
    ClassNode resolves to an ActorHandle, which passes through depth-0
    resolution untouched)."""

    def __init__(self, class_node: ClassNode, method: str, args, kwargs):
        super().__init__((class_node,) + tuple(args), kwargs)
        self._method = method

    def _submit(self, args, kwargs):
        handle, *rest = args
        return getattr(handle, self._method).remote(*rest, **kwargs)
