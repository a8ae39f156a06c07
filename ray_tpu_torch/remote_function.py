"""@remote functions (reference analog: python/ray/remote_function.py)."""

from __future__ import annotations

import threading
from typing import Any, Dict, Optional, Tuple

from ray_tpu_torch._private._vendor import cloudpickle

from ray_tpu_torch._private import worker_context
from ray_tpu_torch._private.worker_context import ObjectRef

_DEFAULT_TASK_RESOURCES = {"CPU": 1.0}


def _build_resources(opts: Dict[str, Any]) -> Dict[str, float]:
    if "num_tpus" in opts:
        raise ValueError(
            "num_tpus is the JAX package's resource; the port's "
            "accelerator resource is num_gpus (whole cards)")
    resources: Dict[str, float] = {}
    num_cpus = opts.get("num_cpus")
    num_gpus = opts.get("num_gpus")
    resources["CPU"] = float(num_cpus if num_cpus is not None else 1.0)
    if num_gpus:
        resources["GPU"] = float(num_gpus)
    for k, v in (opts.get("resources") or {}).items():
        resources[k] = float(v)
    if opts.get("memory"):
        resources["memory"] = float(opts["memory"])
    # A worker is handed whole cards via CUDA_VISIBLE_DEVICES, one process
    # per card (the JAX package's rule for TPU chips under libtpu), so a
    # fractional grant would pass ResourceSet admission but share a card
    # between processes that each size their memory to all of it.
    gpu = resources.get("GPU")
    if gpu is not None and gpu != int(gpu):
        raise ValueError(
            f"num_gpus must be a whole number of cards (got {gpu}): a "
            f"card is dedicated to one worker process and cannot be "
            f"fractionally shared the way CPUs can.")
    return resources


def _pg_option(opts: Dict[str, Any]) -> Optional[Tuple[bytes, int]]:
    strategy = opts.get("scheduling_strategy")
    pg = opts.get("placement_group")
    index = opts.get("placement_group_bundle_index", -1)
    if strategy is not None and hasattr(strategy, "placement_group"):
        pg = strategy.placement_group
        index = getattr(strategy, "placement_group_bundle_index", -1) or -1
    if pg is None:
        return None
    pg_id = pg.id.binary() if hasattr(pg, "id") else pg
    return (pg_id, index if index is not None and index >= 0 else 0)


class RemoteFunction:
    """Wrapper created by ``@ray_tpu_torch.remote`` on a function.

    (Reference: python/ray/remote_function.py RemoteFunction._remote.)
    """

    def __init__(self, fn, options: Optional[Dict[str, Any]] = None):
        self._function = fn
        self._options = dict(options or {})
        self._fid: Optional[bytes] = None
        self._pickled: Optional[bytes] = None
        self._export_lock = threading.Lock()
        self.__name__ = getattr(fn, "__name__", "remote_function")
        self.__doc__ = getattr(fn, "__doc__", None)

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"remote function {self.__name__}() cannot be called directly; "
            f"use {self.__name__}.remote().")

    def options(self, **opts) -> "RemoteFunction":
        merged = dict(self._options)
        merged.update(opts)
        rf = RemoteFunction(self._function, merged)
        rf._pickled = self._pickled
        return rf

    def bind(self, *args, **kwargs):
        """Record a lazy DAG node instead of submitting (reference:
        ray.dag — fn.bind builds a FunctionNode)."""
        from ray_tpu_torch.dag import FunctionNode

        return FunctionNode(self, args, kwargs)

    def __reduce__(self):
        # Remote functions captured in closures of other remote functions
        # must travel; rebuild fresh (locks are per-process).
        return (RemoteFunction, (self._function, self._options))

    def _ensure_exported(self, cw) -> bytes:
        with self._export_lock:
            if self._pickled is None:
                self._pickled = cloudpickle.dumps(self._function)
        # Re-export per core-worker (cheap: content-addressed by sha1).
        return cw.export_function(self._pickled)

    def remote(self, *args, **kwargs):
        from ray_tpu_torch import _auto_init

        _auto_init()
        cw = worker_context.core_worker()
        fid = self._ensure_exported(cw)
        opts = self._options
        num_returns = opts.get("num_returns", 1)
        if num_returns == "dynamic":
            # generator task: the count of returns is decided by the
            # task at run time (reference: num_returns="dynamic" /
            # ObjectRefGenerator).  get() on the returned ref yields the
            # list of per-item ObjectRefs.
            num_returns = -1
        refs = cw.submit_task(
            fid, args, kwargs,
            num_returns=num_returns,
            resources=_build_resources(opts),
            name=opts.get("name") or self.__name__,
            max_retries=opts.get("max_retries", 3),
            pg=_pg_option(opts),
        )
        wrapped = [ObjectRef(r) for r in refs]
        if num_returns == 0:
            return None
        if num_returns in (1, -1):
            return wrapped[0]
        return wrapped
