"""@batch: transparent request batching inside a replica.

A copy of ``batch`` and ``_BatchQueue`` from ``ray_tpu/serve/batching.py``
(pure asyncio; the port keeps its own copy rather than importing the
JAX package), which also keeps each running batch task referenced
until it finishes.  Concurrent calls are collected into one list call, so
the model runs one batched generation for many callers.

Usage (async methods only — batching needs an event loop to park
pending callers on):

    class Model:
        @batch(max_batch_size=8, batch_wait_timeout_s=0.01)
        async def __call__(self, inputs):
            return run_model(inputs)      # one result per input

Each caller awaits its own element of the returned list.
"""

from __future__ import annotations

import asyncio
import functools
from typing import Callable, List, Optional, Set


class _BatchQueue:
    def __init__(self, fn: Callable, max_batch_size: int,
                 batch_wait_timeout_s: float):
        self.fn = fn
        self.max_batch = max_batch_size
        self.timeout = batch_wait_timeout_s
        self._pending: List = []  # (arg, future)
        self._flush_task: Optional[asyncio.Task] = None
        # the event loop holds tasks weakly: keep each running batch
        # referenced until it finishes
        self._running: Set[asyncio.Task] = set()

    async def submit(self, instance, arg):
        loop = asyncio.get_running_loop()
        fut = loop.create_future()
        self._pending.append((arg, fut))
        if len(self._pending) >= self.max_batch:
            self._flush(instance)
        elif self._flush_task is None or self._flush_task.done():
            self._flush_task = loop.create_task(
                self._delayed_flush(instance))
        return await fut

    async def _delayed_flush(self, instance):
        await asyncio.sleep(self.timeout)
        self._flush(instance)

    def _flush(self, instance) -> None:
        if not self._pending:
            return
        batch, self._pending = self._pending, []
        if self._flush_task is not None and not self._flush_task.done():
            self._flush_task.cancel()
            self._flush_task = None
        task = asyncio.get_running_loop().create_task(
            self._run(instance, batch))
        self._running.add(task)
        task.add_done_callback(self._running.discard)

    async def _run(self, instance, batch) -> None:
        args = [a for a, _ in batch]
        futs = [f for _, f in batch]
        try:
            if instance is None:
                results = await self.fn(args)
            else:
                results = await self.fn(instance, args)
            if not isinstance(results, (list, tuple)) or \
                    len(results) != len(args):
                raise TypeError(
                    f"@serve.batch function must return a list of "
                    f"{len(args)} results (one per request), got "
                    f"{type(results).__name__}")
            for fut, res in zip(futs, results):
                if not fut.done():
                    fut.set_result(res)
        except Exception as e:  # noqa: BLE001 - propagate to every caller
            for fut in futs:
                if not fut.done():
                    fut.set_exception(e)


def batch(_func: Optional[Callable] = None, *, max_batch_size: int = 8,
          batch_wait_timeout_s: float = 0.01):
    """Decorator turning `async def f(self, item)` call sites into
    batched `f(self, [items])` invocations (reference: serve.batch)."""

    def wrap(fn: Callable):
        if not asyncio.iscoroutinefunction(fn):
            raise TypeError("@serve.batch requires an async function")
        # queue lives ON the instance (unique attr per decorated method):
        # an id()-keyed side table would leak queues and could alias a
        # recycled instance address to a dead instance's pending batch
        attr = f"__serve_batch_queue_{fn.__qualname__}"
        free_queue: List[Optional[_BatchQueue]] = [None]

        @functools.wraps(fn)
        async def wrapper(*args, **kwargs):
            if kwargs:
                raise TypeError("@serve.batch calls take one positional "
                                "argument")
            if len(args) == 2:       # bound method: (self, item)
                instance, item = args
            elif len(args) == 1:     # free function: (item,)
                instance, item = None, args[0]
            else:
                raise TypeError("@serve.batch function must take exactly "
                                "one request argument")
            if instance is None:
                q = free_queue[0]
                if q is None:
                    q = free_queue[0] = _BatchQueue(
                        fn, max_batch_size, batch_wait_timeout_s)
            else:
                q = getattr(instance, attr, None)
                if q is None:
                    q = _BatchQueue(fn, max_batch_size,
                                    batch_wait_timeout_s)
                    setattr(instance, attr, q)
            return await q.submit(instance, item)

        wrapper._ray_tpu_serve_batch = True
        return wrapper

    return wrap(_func) if _func is not None else wrap
