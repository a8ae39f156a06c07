"""Worker process: executes pushed tasks and hosts actors.

Role-equivalent of the reference's worker main loop + task receiver
(reference ``python/ray/_private/workers/default_worker.py:231`` →
``worker.py:755 main_loop`` → ``_raylet.pyx:1392 run_task_loop``; inbound
execution path ``_raylet.pyx:1009 task_execution_handler`` → ``:672
execute_task``).  Each worker runs an RPC server so submitters push tasks
DIRECTLY (the reference's CoreWorkerService::PushTask); actor tasks are
ordered per caller by sequence number (the reference's
ActorSchedulingQueue, transport/actor_scheduling_queue.cc).

The worker exits when its node-manager connection drops (reference analog:
core_worker.cc:780 ExitIfParentRayletDies).
"""

from __future__ import annotations

import asyncio
import logging
import os
import sys
import threading
import time
import traceback
import concurrent.futures
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Optional

from ray_tpu_torch._private._vendor import cloudpickle

from ray_tpu_torch._private import protocol, serialization, worker_context
from ray_tpu_torch._private.client import CoreWorker, ObjectRefInfo
from ray_tpu_torch._private.config import Config
from ray_tpu_torch._private.ids import JobID, ObjectID, TaskID, WorkerID
from ray_tpu_torch import exceptions

logger = logging.getLogger(__name__)


class FunctionCache:
    def __init__(self, cw: CoreWorker):
        self.cw = cw
        self._cache: Dict[bytes, Any] = {}
        self._lock = threading.Lock()

    def get(self, job_id: bytes, fid: bytes):
        with self._lock:
            fn = self._cache.get(fid)
        if fn is None:
            pickled = self.cw.fetch_function(job_id, fid)
            fn = cloudpickle.loads(pickled)
            with self._lock:
                self._cache[fid] = fn
        return fn


class ActorState:
    def __init__(self):
        self.instance: Any = None
        self.actor_id: bytes = b""
        self.max_concurrency = 1
        # Per-caller ordering (reference: per-caller sequence numbers in
        # direct_actor_task_submitter).
        self.next_seqno: Dict[bytes, int] = {}
        self.buffered: Dict[bytes, Dict[int, tuple]] = {}


class WorkerServer:
    def __init__(self):
        self.worker_id = WorkerID.from_hex(os.environ["RAYTPU_WORKER_ID"])
        self.session_dir = os.environ["RAYTPU_SESSION_DIR"]
        self.node_address = os.environ["RAYTPU_NODE_ADDRESS"]
        self.gcs_address = os.environ["RAYTPU_GCS_ADDRESS"]
        self.object_store = os.environ["RAYTPU_OBJECT_STORE"]
        self.config = Config().apply_env()
        self.server = protocol.Server()
        self.server.add_routes(self)
        self.address = os.path.join(self.session_dir, "sockets",
                                    f"worker-{self.worker_id.hex()[:16]}")
        self.cw: Optional[CoreWorker] = None
        self.fns: Optional[FunctionCache] = None
        self.exec_pool = ThreadPoolExecutor(max_workers=1,
                                            thread_name_prefix="task-exec")
        self.actor = ActorState()
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        #: task_id -> executing thread ident, for cancellation delivery.
        self._running_tasks: Dict[bytes, int] = {}
        #: actor requests from arrival to completion (running + queued) —
        #: the raytpu_probe load signal.
        self._actor_pending = 0
        #: cancellations that arrived before their task started executing.
        self._cancelled_pending: set = set()
        #: task ids whose thread got an async exc delivered (not yet raised).
        self._cancel_delivered: set = set()
        #: lazily-started event loop (own thread) for async actor methods
        #: (reference: async actors on boost fibers, fiber.h:17 — here a
        #: shared asyncio loop so concurrent coroutines interleave, which
        #: is what @serve.batch relies on to collect a batch).
        self._user_loop: Optional[asyncio.AbstractEventLoop] = None
        self._user_loop_lock = threading.Lock()
        #: task_id -> concurrent future of a coroutine parked on the
        #: user loop (cancellation target for async methods).
        self._running_async: Dict[bytes, Any] = {}
        #: serializes async-exc delivery against task start/finish so a
        #: cancellation can never land in the NEXT task run by the same
        #: pool thread.
        self._cancel_lock = threading.Lock()
        # Profile events buffered off the hot path, flushed to GCS by a
        # background task (reference: core_worker/profiling.cc batches).
        self._events: list = []

    async def run(self):
        self._loop = asyncio.get_running_loop()
        # Transport matches the node's: unix sockets on a single host,
        # TCP when the node manager itself is TCP (multi-host cluster) —
        # submitters on OTHER machines must be able to dial this worker
        # for direct task push (reference: workers serve
        # CoreWorkerService on ip:port).
        if self.node_address.startswith("/"):
            await self.server.start_unix(self.address)
        else:
            host = os.environ.get("RAYTPU_WORKER_BIND_HOST") or \
                self.node_address.rsplit(":", 1)[0]
            port = await self.server.start_tcp(host, 0)
            self.address = f"{host}:{port}"
        # The CoreWorker runs its own io thread; sync facades work from the
        # execution threads exactly as they do on the driver.
        self.cw = CoreWorker(
            gcs_address=self.gcs_address, node_address=self.node_address,
            object_store_name=self.object_store,
            job_id=JobID.nil(), worker_id=self.worker_id,
            config=self.config, mode="worker")
        self.fns = FunctionCache(self.cw)
        worker_context.set_core_worker(self.cw, mode="worker")
        # Register as a pooled worker; the node-manager connection doubles
        # as the liveness channel.
        # Route node-manager -> worker commands (become_actor, kill, ...)
        # arriving over the registration connection into our handlers.
        worker_loop = self._loop

        async def from_nm(method, payload):
            handler = getattr(self, "rpc_" + method, None)
            if handler is not None:
                # Hop onto the worker server loop (the nm connection lives
                # on the CoreWorker io loop).
                fut = asyncio.run_coroutine_threadsafe(
                    handler(None, payload), worker_loop)
                return await asyncio.wrap_future(fut)
            # Object-plane methods (promote_object, ref_borrow, ...) are
            # handled by the CoreWorker like on any owner process.
            return await self.cw._handle_nm_request(method, payload)

        self.cw.nm.set_request_handler(from_nm)
        await asyncio.get_running_loop().run_in_executor(
            None, lambda: self.cw.io.run(self.cw.nm.call(
                "register_worker",
                {"worker_id": self.worker_id.binary(),
                 "address": self.address})))
        self.cw.nm.on_close = lambda conn: os._exit(1)
        self._loop.create_task(self._flush_events_loop())
        await asyncio.Event().wait()  # serve forever

    async def _flush_events_loop(self):
        idle_sleep = 1.0
        while True:
            await asyncio.sleep(idle_sleep)
            if not self._events:
                # back off while idle: hundreds of workers' 1 Hz ticks
                # add up on small hosts (see _decref_pump)
                idle_sleep = min(idle_sleep * 2, 8.0)
                continue
            idle_sleep = 1.0
            batch, self._events = self._events, []
            try:
                await asyncio.wrap_future(
                    asyncio.run_coroutine_threadsafe(
                        self.cw.gcs.call("task_events_report",
                                         {"events": batch}),
                        self.cw.io.loop))
            except Exception:  # noqa: BLE001 - drop events, never crash
                pass

    # ---- helpers ---------------------------------------------------------

    def _resolve_arg(self, m: dict) -> Any:
        if m["k"] == "v":
            value, is_err = serialization.deserialize(m["d"])
            if is_err:
                raise value if isinstance(value, BaseException) else \
                    exceptions.RayTaskError(repr(value), "")
            return value
        ref = ObjectRefInfo(m["oid"], m["owner"], m["addr"])
        return self.cw.get([ref], timeout=60.0)[0]

    def _ensure_user_loop(self) -> asyncio.AbstractEventLoop:
        with self._user_loop_lock:
            if self._user_loop is None:
                loop = asyncio.new_event_loop()
                t = threading.Thread(target=loop.run_forever,
                                     name="async-actor-loop", daemon=True)
                t.start()
                self._user_loop = loop
            return self._user_loop

    def _build_return_entry(self, oid, value, ret_pins: list) -> dict:
        """Serialize one task return into a reply entry (inline or shm),
        collecting embedded refs into the contained/bridge-pin protocol
        (client.py hold_return_pins / release_return_pins)."""
        ser, collected = self.cw._serialize_collecting(value)
        entry = {"oid": oid.binary()}
        if collected:
            entry["contained"] = [
                (i.oid, i.owner, i.node_address) for i in collected]
            for info in collected:
                self.cw.add_local_ref(info)
            ret_pins.extend(collected)
        if ser.total_size <= self.config.max_inline_object_size:
            entry["d"] = ser.to_bytes()
        else:
            self.cw._put_shm(oid, ser)
            # carry the executing node's address: a cross-node submitter
            # must pull the object to its own store
            entry["in_store"] = True
            entry["node"] = self.cw.node_address
        return entry

    def _execute(self, spec: dict, fn) -> list:
        """Run user code; build the returns list for the RPC reply.
        [HOT LOOP — analog of _raylet.pyx:672 execute_task]."""
        task_id = spec["task_id"]
        num_returns = spec["num_returns"]
        dynamic = num_returns == -1
        return_oids = [ObjectID.for_return(TaskID(task_id), i + 1)
                       for i in range(1 if dynamic else num_returns)]
        # Thread-local so concurrent actor threads don't clobber each other.
        worker_context.set_task_context(task_id, spec.get("actor_id", b""))
        with self._cancel_lock:
            if task_id in self._cancelled_pending:
                # cancelled before it started: never run user code
                self._cancelled_pending.discard(task_id)
                err = exceptions.TaskCancelledError(
                    "task was cancelled before execution")
                data = serialization.serialize_error(err).to_bytes()
                return [{"oid": ObjectID.for_return(
                    TaskID(task_id), i + 1).binary(), "d": data,
                    "err": True} for i in range(1 if dynamic else
                                                num_returns)]
            self._running_tasks[task_id] = threading.get_ident()
        ev = {"task_id": task_id.hex(), "name": spec.get("name", "")
              or spec.get("method", "task"),
              "worker_id": self.worker_id.hex()[:16], "pid": os.getpid(),
              "actor_id": spec.get("actor_id", b"").hex(),
              "start": time.time()}
        try:
            args = [self._resolve_arg(a) for a in spec["args"]]
            kwargs = {k: self._resolve_arg(v)
                      for k, v in spec["kwargs"].items()}
            trace_ctx = spec.get("trace_ctx")
            if trace_ctx:
                from ray_tpu_torch.util import tracing

                with tracing.task_span(ev["name"], trace_ctx):
                    result = fn(*args, **kwargs)
            else:
                result = fn(*args, **kwargs)
            if asyncio.iscoroutine(result):
                # async task/actor method: run on the shared user loop so
                # concurrent invocations interleave (async actor
                # semantics; serve batching depends on this).  The shim
                # re-establishes the task context INSIDE the Task (each
                # asyncio Task gets its own contextvars copy, isolating
                # interleaved coroutines), and the future is registered
                # so rpc_cancel_task can cancel a parked coroutine — the
                # pool thread blocked in .result() can't take an async
                # exception.
                async def _with_ctx(coro=result, _tid=task_id,
                                    _aid=spec.get("actor_id", b"")):
                    worker_context.set_task_context(_tid, _aid)
                    return await coro

                afut = asyncio.run_coroutine_threadsafe(
                    _with_ctx(), self._ensure_user_loop())
                self._running_async[task_id] = afut
                try:
                    result = afut.result()
                except concurrent.futures.CancelledError:
                    raise exceptions.TaskCancelledError(
                        "task was cancelled while awaiting") from None
                finally:
                    self._running_async.pop(task_id, None)
            if num_returns == 0:
                return []
            if dynamic:
                # generator task (num_returns="dynamic"): stream each
                # yielded item into its own caller-owned return
                # for_return(i+2..) AS PRODUCED (peak memory = one item,
                # the point of generator tasks), then emit the primary
                # return as the list of item refs — the nested-return
                # pin/contained machinery keeps items alive until the
                # caller registers.
                import collections.abc

                if not isinstance(result, collections.abc.Iterator):
                    raise TypeError(
                        "num_returns='dynamic' tasks must return a "
                        f"generator/iterator, got {type(result).__name__}")
                from ray_tpu_torch._private.worker_context import ObjectRef

                caller = spec["caller"]
                caller_addr = spec.get("caller_addr", "")
                out = []
                ret_pins = []
                item_refs = []
                for i, item in enumerate(result):
                    oid = ObjectID.for_return(TaskID(task_id), i + 2)
                    out.append(self._build_return_entry(oid, item,
                                                        ret_pins))
                    item_refs.append(ObjectRef(ObjectRefInfo(
                        oid.binary(), caller, caller_addr)))
                out.insert(0, self._build_return_entry(
                    return_oids[0], item_refs, ret_pins))
                if ret_pins:
                    self.cw.hold_return_pins(task_id, ret_pins)
                return out
            values = (result,) if num_returns == 1 else tuple(result)
            if num_returns > 1 and len(values) != num_returns:
                raise ValueError(
                    f"task declared num_returns={num_returns} but returned "
                    f"{len(values)} values")
            out = []
            ret_pins = []
            for oid, value in zip(return_oids, values):
                out.append(self._build_return_entry(oid, value, ret_pins))
            if ret_pins:
                self.cw.hold_return_pins(task_id, ret_pins)
            return out
        except exceptions.TaskCancelledError as e:
            data = serialization.serialize_error(e).to_bytes()
            return [{"oid": oid.binary(), "d": data, "err": True}
                    for oid in return_oids]
        except Exception as e:  # noqa: BLE001 - user code raised
            tb = traceback.format_exc()
            err = e if _picklable(e) else None
            wrapped = exceptions.RayTaskError(repr(e), tb, cause=err)
            data = serialization.serialize_error(wrapped).to_bytes()
            return [{"oid": oid.binary(), "d": data, "err": True}
                    for oid in return_oids]
        finally:
            with self._cancel_lock:
                self._running_tasks.pop(task_id, None)
                if task_id in self._cancel_delivered:
                    # The async exc was delivered but user code finished
                    # first: clear it so it cannot fire inside whatever
                    # this pool thread runs next.
                    self._cancel_delivered.discard(task_id)
                    import ctypes

                    ctypes.pythonapi.PyThreadState_SetAsyncExc(
                        ctypes.c_ulong(threading.get_ident()), None)
            # Ack-before-reply: once every borrow +1 this task posted is
            # registered at its owner, the caller may release its arg pins
            # the moment our reply lands (exact borrower handover).
            self.cw.flush_borrows()
            worker_context.set_task_context(b"", b"")
            ev["end"] = time.time()
            self._events.append(ev)
            if len(self._events) > 10000:  # cap: drop oldest half
                del self._events[:5000]

    # ---- rpc: normal tasks ----------------------------------------------

    async def rpc_push_task(self, conn, spec):
        # Function fetch can hit the GCS; keep it off the server loop.
        fn = await self._loop.run_in_executor(
            None, self.fns.get, spec["job_id"], spec["fid"])
        returns = await self._loop.run_in_executor(
            self.exec_pool, self._execute, spec, fn)
        return {"returns": returns}

    # ---- rpc: actor lifecycle -------------------------------------------

    async def rpc_become_actor(self, conn, payload):
        spec = payload["spec"]
        self.actor.actor_id = payload["actor_id"]
        mc = spec.get("max_concurrency", 0)
        if not mc:
            # unset: async actors (any coroutine method on the class)
            # default to high concurrency so interleaving-dependent
            # patterns (events, serve batching) work out of the box —
            # reference semantics: async actors default max_concurrency
            # 1000 while sync actors stay strictly serial
            cls = self.fns.get(spec["job_id"], spec["fid"])
            has_async = any(
                asyncio.iscoroutinefunction(getattr(cls, n, None))
                for n in dir(cls) if not n.startswith("__"))
            if asyncio.iscoroutinefunction(getattr(cls, "__call__", None)):
                has_async = True
            mc = 100 if has_async else 1
            # Auto-raised concurrency must only benefit coroutine methods
            # (they park on the user loop anyway).  SYNC methods of an
            # auto-detected async actor serialize against EACH OTHER on a
            # single thread (so unsynchronized read-modify-write state
            # stays safe), but — deliberate divergence from the
            # reference, where they run on and block the event loop —
            # they do NOT block coroutine progress.  A user-set
            # max_concurrency opts sync methods into threads explicitly.
            self.actor.sync_serial = has_async
        self.actor.max_concurrency = mc
        if self.actor.max_concurrency > 1:
            self.exec_pool = ThreadPoolExecutor(
                max_workers=self.actor.max_concurrency,
                thread_name_prefix="actor-exec")
            if getattr(self.actor, "sync_serial", False):
                self._sync_exec = ThreadPoolExecutor(
                    max_workers=1, thread_name_prefix="actor-sync")
        try:
            def construct():
                cls = self.fns.get(spec["job_id"], spec["fid"])
                args = [self._resolve_arg(a) for a in spec["args"]]
                kwargs = {k: self._resolve_arg(v)
                          for k, v in spec["kwargs"].items()}
                worker_context.set_task_context(b"", payload["actor_id"])
                instance = cls(*args, **kwargs)
                # Ack-before-ready: the creator releases its ctor-arg pins
                # when GCS reports READY, so our borrows must be registered
                # at their owners before this reply makes the actor READY.
                self.cw.flush_borrows()
                return instance

            self.actor.instance = await self._loop.run_in_executor(
                self.exec_pool, construct)
            return {"ok": True}
        except Exception as e:  # noqa: BLE001 - ctor failed
            return {"ok": False,
                    "error": f"{type(e).__name__}: {e}\n"
                             + traceback.format_exc()}

    async def rpc_push_actor_task(self, conn, spec):
        if spec.get("method") == "raytpu_probe":
            # Out-of-band liveness + load probe: answered on the server
            # loop, NEVER queued behind user method slots (reference:
            # control concurrency group for health checks / metrics,
            # concurrency_group_manager.cc).  pending counts requests
            # from arrival to completion (running + queued).
            ser = serialization.serialize(
                {"ok": True, "pending": self._actor_pending,
                 "actor_id": self.actor.actor_id})
            oid = ObjectID.for_return(TaskID(spec["task_id"]), 1)
            return {"returns": [{"oid": oid.binary(),
                                 "d": ser.to_bytes()}]}
        if self.actor.instance is None:
            raise RuntimeError("not an actor worker")
        self._actor_pending += 1
        try:
            return await self._push_actor_task_ordered(conn, spec)
        finally:
            self._actor_pending -= 1

    async def _push_actor_task_ordered(self, conn, spec):
        caller = spec["caller"]
        seqno = spec["seqno"]
        if self.actor.max_concurrency == 1:
            # In-order per caller: buffer out-of-order arrivals.  The first
            # seqno seen from a caller is the baseline — after an actor
            # restart the replacement worker accepts the caller's current
            # counter instead of demanding 0 (reference analog: actor
            # incarnation/seqno reset in direct_actor_task_submitter).
            nxt = self.actor.next_seqno.setdefault(caller, seqno)
            if seqno != nxt:
                fut = self._loop.create_future()
                self.actor.buffered.setdefault(caller, {})[seqno] = (spec, fut)
                self._loop.call_later(10.0, self._adopt_seqno_gap, caller)
                return await fut
            return await self._run_actor_task(spec)
        return await self._run_actor_task(spec)

    def _adopt_seqno_gap(self, caller: bytes):
        """A seqno was lost in flight (caller's connection broke after
        send): if the head-of-line seqno never arrives, adopt the lowest
        buffered one so the queue doesn't stall forever."""
        buf = self.actor.buffered.get(caller, {})
        if not buf:
            return
        lowest = min(buf)
        if lowest <= self.actor.next_seqno.get(caller, 0):
            return  # progress was made; buffered drain will pick it up
        self.actor.next_seqno[caller] = lowest
        spec, fut = buf.pop(lowest)

        async def run(spec=spec, fut=fut):
            try:
                result = await self._run_actor_task(spec)
                if not fut.done():
                    fut.set_result(result)
            except Exception as e:  # noqa: BLE001
                if not fut.done():
                    fut.set_exception(e)

        self._loop.create_task(run())

    async def _run_actor_task(self, spec):
        caller = spec["caller"]
        try:
            method = getattr(self.actor.instance, spec["method"])
            pool = self.exec_pool
            if (getattr(self.actor, "sync_serial", False)
                    and not asyncio.iscoroutinefunction(method)):
                # sync method of an auto-detected async actor: serialize
                pool = self._sync_exec
            returns = await self._loop.run_in_executor(
                pool, self._execute, spec, method)
            return {"returns": returns}
        finally:
            if self.actor.max_concurrency == 1:
                self.actor.next_seqno[caller] = spec["seqno"] + 1
                buf = self.actor.buffered.get(caller, {})
                nxt = buf.pop(spec["seqno"] + 1, None)
                if nxt is not None:
                    nspec, fut = nxt

                    async def run_buffered(nspec=nspec, fut=fut):
                        try:
                            fut.set_result(await self._run_actor_task(nspec))
                        except Exception as e:  # noqa: BLE001
                            if not fut.done():
                                fut.set_exception(e)

                    self._loop.create_task(run_buffered())

    async def rpc_release_return_pins(self, conn, payload):
        """Caller confirmed it pinned the refs embedded in our returns."""
        self.cw.release_return_pins(payload["task_id"])
        return True

    async def rpc_cancel_task(self, conn, payload):
        """Cancel a task on this worker (reference:
        CoreWorker::HandleCancelTask — interrupt delivery to the executing
        thread; force kills the process).  Not-yet-started tasks are
        marked so they fail before user code runs."""
        if payload.get("force"):
            self._loop.call_later(0.05, os._exit, 1)
            return True
        task_id = payload["task_id"]
        import ctypes

        # async method parked on the user loop: cancel the coroutine —
        # the pool thread is blocked in Future.result() where an async
        # exception cannot be delivered
        afut = self._running_async.get(task_id)
        if afut is not None:
            afut.cancel()
            return True

        with self._cancel_lock:
            tid = self._running_tasks.get(task_id)
            if tid is None:
                # Not running: either finished, or queued/buffered here —
                # mark it so it dies at start if it ever runs.
                self._cancelled_pending.add(task_id)
                return False
            # The CPython analog of the reference's async
            # KeyboardInterrupt delivery into user code.  Under
            # _cancel_lock the target thread cannot move on to another
            # task between the lookup and the delivery.
            n = ctypes.pythonapi.PyThreadState_SetAsyncExc(
                ctypes.c_ulong(tid),
                ctypes.py_object(exceptions.TaskCancelledError))
            if n == 1:
                self._cancel_delivered.add(task_id)
            return n == 1

    async def rpc_exit(self, conn, payload):
        self._loop.call_later(0.05, os._exit, 0)
        return True

    # ---- rpc: health ----------------------------------------------------

    async def rpc_ping(self, conn, payload):
        return {"worker_id": self.worker_id.binary(),
                "actor_id": self.actor.actor_id}


def _picklable(e) -> bool:
    try:
        cloudpickle.loads(cloudpickle.dumps(e))
        return True
    except Exception:  # noqa: BLE001
        return False


def main():
    logging.basicConfig(
        level=os.environ.get("RAYTPU_LOG_LEVEL", "INFO"),
        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    server = WorkerServer()
    try:
        asyncio.run(server.run())
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()
