"""CoreWorker: the distributed-futures runtime living in every driver and
worker process.

Role-equivalent of the reference's core worker library (reference
``src/ray/core_worker/core_worker.h:194``): it owns the in-process memory
store for small objects (``memory_store.h:43``), the shared-memory store
client, task submission with the worker-lease protocol
(``transport/direct_task_transport.h:57 CoreWorkerDirectTaskSubmitter``),
and the direct actor transport with per-caller sequence numbers
(``transport/direct_actor_task_submitter.cc:419 PushActorTask``).

Threading: all network I/O runs on one asyncio loop (a daemon thread for
drivers; the process main loop for workers). Public methods are synchronous
facades that post coroutines to the loop — the analog of the reference's
"the Cython layer releases the GIL and posts to the io_service"
(_raylet.pyx:1798).
"""

from __future__ import annotations

import asyncio
import contextlib
import hashlib
import logging
import threading
import time
from collections import OrderedDict, deque
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ray_tpu_torch._private import protocol, serialization
from ray_tpu_torch._private.config import Config
from ray_tpu_torch._private.ids import (ActorID, JobID, ObjectID, TaskID,
                                        WorkerID, put_object_id)
from ray_tpu_torch._private.object_store import (ObjectStoreClient,
                                                 ObjectStoreError,
                                                 ObjectStoreFull)
from ray_tpu_torch import exceptions

logger = logging.getLogger(__name__)

INLINE_LIMIT_DEFAULT = 100 * 1024
#: the longest EventLoopThread.stop waits for the cancelled tasks to end
_SETTLE_S = 5.0


class EventLoopThread:
    """Daemon thread running the client's asyncio loop."""

    def __init__(self, name="raytpu-io"):
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self._run, name=name, daemon=True)
        self.thread.start()

    def _run(self):
        asyncio.set_event_loop(self.loop)
        self.loop.run_forever()

    def run(self, coro, timeout=None):
        fut = asyncio.run_coroutine_threadsafe(coro, self.loop)
        return fut.result(timeout)

    def post(self, coro):
        return asyncio.run_coroutine_threadsafe(coro, self.loop)

    def stop(self):
        """Stop the loop, first cancelling the tasks still pending on it
        and waiting up to ``_SETTLE_S`` for them to end: a task left
        pending on a stopped loop is reported ("Task was destroyed but
        it is pending!") whenever the loop is collected, into whatever
        runs then (a lease grant or a request handler mid-flight, a
        task push whose lease is on its way back)."""
        if self.thread.is_alive() and \
                threading.current_thread() is not self.thread:
            try:
                self.run(_cancel_pending(_SETTLE_S), timeout=_SETTLE_S + 5)
            except Exception:  # noqa: BLE001 - stop regardless
                pass
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(timeout=5)


async def _cancel_pending(timeout: float) -> None:
    me = asyncio.current_task()
    tasks = [t for t in asyncio.all_tasks() if t is not me]
    for t in tasks:
        t.cancel()
    if tasks:
        await asyncio.wait(tasks, timeout=timeout)


class _SendTurn:
    """One actor call's place in its caller's send order.  Calls to an
    actor are sent in the order they were submitted (reference: the
    sequential actor task submitter sends in seqno order): each push
    takes a ticket as it starts, before its first await, and pushes
    start in submission order (``io.post`` runs them FIFO); it then
    sends only on its turn, whatever order its dependencies and the
    actor's address resolve in, and a call that fails before sending
    passes its turn on.  Without it, calls parked on a starting actor's
    address resumed in the order the GCS answered them, and their
    seqnos (taken at send time) followed that order.  Loop-thread
    only."""

    __slots__ = ("order", "ticket", "done")

    def __init__(self, order: dict):
        self.order = order
        self.ticket = order["issued"]
        order["issued"] += 1
        self.done = False

    async def wait(self) -> None:
        order = self.order
        if order["next"] != self.ticket:
            fut = asyncio.get_running_loop().create_future()
            order["waiters"][self.ticket] = fut
            await fut

    def release(self) -> None:
        if self.done:
            return
        self.done = True
        order = self.order
        order["next"] = self.ticket + 1
        fut = order["waiters"].pop(order["next"], None)
        if fut is not None and not fut.done():
            fut.set_result(None)

    async def pass_on(self) -> None:
        """A call that will not send: wait for its turn, then hand it
        to the next."""
        if not self.done:
            await self.wait()
            self.release()


class MemoryStoreEntry:
    __slots__ = ("data", "is_error", "in_store", "event", "waiters")

    def __init__(self):
        self.data: Optional[bytes] = None
        self.is_error = False
        self.in_store = False  # value lives in the shared-memory store
        self.event = threading.Event()
        self.waiters: List[Tuple[asyncio.AbstractEventLoop, asyncio.Future]] = []

    def _wake(self):
        self.event.set()
        waiters, self.waiters = self.waiters, []
        for loop, fut in waiters:
            loop.call_soon_threadsafe(
                lambda f=fut: f.set_result(None) if not f.done() else None)

    def put(self, data: bytes, is_error: bool):
        self.data = data
        self.is_error = is_error
        self._wake()

    def put_in_store(self):
        self.in_store = True
        self._wake()

    async def ready(self):
        """Await readiness from an asyncio loop (non-blocking)."""
        if self.event.is_set():
            return
        loop = asyncio.get_running_loop()
        fut = loop.create_future()
        self.waiters.append((loop, fut))
        if self.event.is_set() and not fut.done():
            fut.set_result(None)
        await fut


def _shallow_aliasing_arrays(value, region, max_depth: int = 3):
    """numpy arrays inside ``value`` (walking list/tuple/set/dict and
    plain-object ``__dict__``/``__slots__`` up to ``max_depth``) that
    alias the memory ``region``.  Used by the zero-copy get path to tie
    the shared-memory pin to array lifetime."""
    import numpy as np

    out = []
    seen = set()
    stack = [(value, 0)]
    while stack:
        v, d = stack.pop()
        if isinstance(v, np.ndarray):
            # dedupe by identity: pickle memoizes repeated arrays into ONE
            # out-of-band buffer, so counting a duplicate twice would let
            # a buffer hidden in an opaque object slip past the n_oob
            # safety comparison
            if v.size and id(v) not in seen and np.shares_memory(v, region):
                seen.add(id(v))
                out.append(v)
        elif d < max_depth:
            if isinstance(v, (list, tuple, set, frozenset)):
                stack.extend((x, d + 1) for x in v)
            elif isinstance(v, dict):
                stack.extend((x, d + 1) for x in v.values())
            else:
                inst = getattr(v, "__dict__", None)
                if isinstance(inst, dict):
                    stack.extend((x, d + 1) for x in inst.values())
                for slot in getattr(type(v), "__slots__", ()) or ():
                    if isinstance(slot, str) and hasattr(v, slot):
                        stack.append((getattr(v, slot), d + 1))
    return out


def _arrays_cover_spans(arrays, region, spans) -> bool:
    """True iff the walked ``arrays`` account for EVERY out-of-band
    buffer span, one distinct array per span.  A count comparison is not
    enough: a custom reducer can rebuild two views over one buffer while
    another buffer's only view hides in an opaque object — base-address/
    extent matching routes that to the copy path.  Best-effort, not a
    proof: a reducer can still hide a view somewhere the walk cannot see
    (a closure, a C-extension object) while exposing exactly one visible
    sibling per buffer; the ``__dict__``/``__slots__`` walk plus the
    one-array-per-span rule covers every pattern expressible with plain
    Python objects up to the walk depth."""
    import numpy as np

    if len(arrays) != len(spans):
        return False
    base = np.frombuffer(region, dtype=np.uint8).ctypes.data
    unmatched = {i: (base + off, base + off + ln)
                 for i, (off, ln) in enumerate(spans)}
    for a in arrays:
        if not (a.flags["C_CONTIGUOUS"] or a.flags["F_CONTIGUOUS"]):
            return False  # strided view from a custom reducer: copy path
        addr = a.__array_interface__["data"][0]
        end = addr + a.nbytes
        hit = None
        for i, (lo, hi) in unmatched.items():
            if lo <= addr and end <= hi:
                hit = i
                break
        if hit is None:
            return False
        del unmatched[hit]
    return not unmatched


class LeaseState:
    """Per-scheduling-key pool of leased workers with a task queue
    (reference: direct_task_transport task queues keyed by SchedulingKey)."""

    __slots__ = ("queue", "workers", "inflight_requests", "resources", "pg")

    def __init__(self, resources, pg):
        self.queue: List[Tuple[dict, asyncio.Future]] = []
        self.workers: List[dict] = []  # idle leased workers
        self.inflight_requests = 0
        self.resources = resources
        self.pg = pg


class CoreWorker:
    def __init__(self, *, gcs_address: str, node_address: str,
                 object_store_name: str, job_id: JobID,
                 worker_id: Optional[WorkerID] = None,
                 config: Optional[Config] = None,
                 loop_thread: Optional[EventLoopThread] = None,
                 mode: str = "driver"):
        self.config = config or Config()
        self.mode = mode
        self.job_id = job_id
        self.worker_id = worker_id or WorkerID.from_random()
        self.gcs_address = gcs_address
        self.node_address = node_address
        self._own_loop = loop_thread is None
        self.io = loop_thread or EventLoopThread()
        self.store = ObjectStoreClient(object_store_name)
        self.memory_store: Dict[bytes, MemoryStoreEntry] = {}
        # RLock: the free path takes it while holding _ref_lock, and a
        # GC-fired __del__ inside a _ms_lock section may re-enter the
        # refcount machinery on the same thread.
        self._ms_lock = threading.RLock()
        self.gcs: Optional[protocol.Connection] = None
        self.nm: Optional[protocol.Connection] = None
        self._worker_conns: Dict[str, protocol.Connection] = {}
        self._dial_locks: Dict[str, asyncio.Lock] = {}
        self._leases: Dict[bytes, LeaseState] = {}
        self._exported_fns: set[bytes] = set()
        self._fn_lock = threading.Lock()
        self._actor_seqno: Dict[bytes, int] = {}
        #: per actor, the send order of this caller's calls (_SendTurn)
        self._actor_send_order: Dict[bytes, dict] = {}
        self._actor_addr_cache: Dict[bytes, str] = {}
        self._current_task_id = TaskID.for_driver(job_id)
        self._task_counter = 0
        self._closed = False
        self.node_id: bytes = b""
        self._pub_handlers: Dict[str, List[Any]] = {}
        # ---- ownership state (reference: reference_count.h:61) ----
        # RLock: refcount ops nest (drain -> free -> lineage unpin).
        self._ref_lock = threading.RLock()
        #: live python ObjectRef count per oid in THIS process (+ pins for
        #: in-flight task args and lineage deps).
        self._local_refs: Dict[bytes, int] = {}
        #: releases queued from ObjectRef.__del__.  The GC can fire __del__
        #: while ANY lock is held (allocations trigger collection), so the
        #: release path must never block on a lock: it appends here
        #: (deque.append is atomic) and the queue is drained at safe
        #: points + by a periodic io-loop timer.
        self._decref_queue: deque = deque()
        #: owner side: oid -> {borrower worker id: acquire-release balance}.
        self._borrowers: Dict[bytes, Dict[bytes, int]] = {}
        #: owner side: return oid -> task lineage for re-execution,
        #: insertion-ordered for byte-budget eviction (reference:
        #: task_manager.h:85 lineage resubmission).
        self._lineage: "OrderedDict[bytes, dict]" = OrderedDict()
        self._lineage_bytes = 0
        #: reconstructions in flight (oid -> attempts used).
        self._recovering: Dict[bytes, int] = {}
        #: oids freed by refcount; late task replies for them are dropped.
        self._freed: "OrderedDict[bytes, None]" = OrderedDict()
        #: outer oid -> refs contained in its serialized value; the outer
        #: object keeps them pinned (reference: contained-object-ref
        #: tracking in serialization + reference_count.cc AddNestedObjectIds).
        self._contained: Dict[bytes, List["ObjectRefInfo"]] = {}
        #: in-flight borrow +1 registrations (concurrent futures).  Flushed
        #: before a task reply is sent so the owner has this process's
        #: borrow on record before the caller releases its pins — the exact
        #: closure of the borrow race (reference: borrower lists merged on
        #: the task reply, reference_count.cc).
        self._borrow_acks: set = set()
        #: worker side: task_id -> pins backing refs embedded in that
        #: task's returns, held until the caller confirms it re-pinned them
        #: (release_return_pins) or a crash-fallback timer fires.
        self._return_pins: Dict[bytes, List["ObjectRefInfo"]] = {}
        #: submitter side: task_id -> worker address, while the push RPC is
        #: in flight (so cancel() can reach the executing worker).
        self._inflight_tasks: Dict[bytes, str] = {}
        #: task ids cancelled before dispatch; checked at dispatch time.
        #: Insertion-ordered so the bound evicts the OLDEST (long-finished)
        #: ids, never live cancellation state.
        self._cancelled: "OrderedDict[bytes, None]" = OrderedDict()
        #: store deletions deferred off the refcount locks (the shm call
        #: blocks; _maybe_free_owned runs under _ref_lock / in GC context).
        self._store_delete_q: deque = deque()
        #: True while _flush_store_deletes is inside store calls on an
        #: executor thread (shutdown waits on it before unmapping).
        self._flushing = False
        #: threads currently inside shm-store calls; shutdown drains
        #: this before unmapping the store.  Lock-guarded: '+=' is NOT
        #: atomic under the GIL, and a lost increment here is exactly
        #: the unmap-during-read segfault this exists to prevent.
        self._store_readers = 0
        self._store_readers_lock = threading.Lock()
        # Workers get the full worker-start window to connect: on a
        # saturated host the head answers registration late, and a
        # worker that gives up at the short RPC timeout wastes the whole
        # spawn (the node manager kills+retries it anyway at ITS
        # deadline).  Drivers keep the short timeout — a human is
        # waiting on init() errors.
        connect_timeout = (
            max(self.config.rpc_connect_timeout_s,
                self.config.worker_start_timeout_s)
            if mode == "worker" else self.config.rpc_connect_timeout_s)
        self.io.run(self._connect(), timeout=connect_timeout + 5)
        self.io.post(self._decref_pump())

    async def _decref_pump(self):
        """Periodic drain so refs dropped by GC free promptly even when no
        other API call comes along to drain the queue.

        The tick BACKS OFF exponentially (50ms → 2s) while the queues
        stay empty: the pump is only the fallback for lock-contended
        drains (every queue append also drains inline), and a fixed
        20 Hz tick is ruinous in aggregate — measured: ~350 idle actor
        workers' pumps alone saturated a CI core, stretching each new
        worker spawn to seconds."""
        idle_sleep = 0.05
        while not self._closed:
            await asyncio.sleep(idle_sleep)
            busy = False
            if self._decref_queue and not self._closed:
                self._drain_decrefs(block=False)
                busy = True
            if self._store_delete_q and not self._closed:
                await asyncio.get_running_loop().run_in_executor(
                    None, self._flush_store_deletes)
                busy = True
            idle_sleep = 0.05 if busy else min(idle_sleep * 2, 2.0)

    def _flush_store_deletes(self):
        # Runs on an executor thread: it must never touch the store after
        # shutdown() unmaps it.  _flushing lets shutdown wait for an
        # in-flight pass (use-after-munmap = segfault in the C store).
        self._flushing = True
        try:
            while not self._closed:
                try:
                    oid = self._store_delete_q.popleft()
                except IndexError:
                    return
                try:
                    self.store.delete(ObjectID(oid))
                except Exception:  # noqa: BLE001 - already gone
                    pass
                try:
                    self.spill.delete(oid)
                except Exception:  # noqa: BLE001
                    pass
        finally:
            self._flushing = False

    # ---- bootstrap -------------------------------------------------------

    async def _dial(self, addr: str) -> protocol.Connection:
        if addr.startswith("/"):
            return await protocol.connect_unix(addr)
        host, port = addr.rsplit(":", 1)
        return await protocol.connect_tcp(host, int(port))

    async def _connect(self):
        self.gcs = await self._dial(self.gcs_address)
        self.gcs.set_push_handler(self._on_push)
        self.nm = await self._dial(self.node_address)
        self.nm.set_request_handler(self._handle_nm_request)
        reply = await self.nm.call("register_core_worker",
                                   {"worker_id": self.worker_id.binary()})
        self.node_id = reply["node_id"]
        from ray_tpu_torch._private.spill import SpillManager

        self.spill = SpillManager(self.store, reply.get("spill_dir", ""))

    def _on_push(self, method: str, payload):
        if method.startswith("pub."):
            channel = method[4:]
            for fn in self._pub_handlers.get(channel, []):
                try:
                    fn(payload)
                except Exception:  # noqa: BLE001 - user callback
                    logger.exception("pubsub handler failed")

    def subscribe(self, channel: str, handler):
        self._pub_handlers.setdefault(channel, []).append(handler)
        self.io.run(self.gcs.call("sub_subscribe", {"channels": [channel]}))

    async def _handle_nm_request(self, method: str, payload):
        if method == "promote_object":
            return self._promote_object(payload["oid"])
        if method == "ref_borrow":
            self.on_borrow_change(payload["oid"], payload["borrower"],
                                  payload["delta"])
            return True
        if method == "object_unavailable":
            # A borrower cannot obtain one of our objects anywhere (its
            # storing node died): re-execute from lineage (reference:
            # ObjectRecoveryManager reacting to location loss,
            # object_recovery_manager.h:41).
            return self.on_object_unavailable(payload["oid"])
        raise protocol.RpcError(f"unknown method {method!r}")

    def on_object_unavailable(self, oid: bytes) -> bool:
        with self._ref_lock:
            if oid in self._freed:
                return False
        if self.store.contains(ObjectID(oid)) or self.spill.contains(oid):
            return True  # a live copy exists right here; borrower retries
        entry = self.memory_store.get(oid)
        if entry is not None:
            if entry.data is not None:
                return True  # inline copy; promote path serves it
            if not entry.event.is_set():
                # The producing task is still RUNNING (no reply yet):
                # recovery here would duplicate-execute it.  The borrower
                # keeps polling; production will land.
                return True
        return self._try_recover(oid)

    def _promote_object(self, oid: bytes):
        """Write a memory-store object into the shared store so another
        process can read it (reference: inline object promotion to plasma)."""
        entry = self.memory_store.get(oid)
        if entry is not None and entry.in_store:
            return {"in_store": True}
        if entry is None or entry.data is None:
            raise RuntimeError(f"owner does not have object {oid.hex()[:16]}")
        with self._store_access():
            if not self.store.contains(ObjectID(oid)):
                try:
                    self.store.put_bytes(ObjectID(oid), entry.data)
                except Exception as e:  # noqa: BLE001
                    if "exists" not in str(e):
                        raise
        return {"in_store": True}

    def shutdown(self):
        if self._closed:
            return
        self._closed = True

        async def _close():
            # the pump, like every task still pending, ends when the
            # loop stops (EventLoopThread.stop)
            for c in list(self._worker_conns.values()):
                await c.close()
            if self.gcs:
                await self.gcs.close()
            if self.nm:
                await self.nm.close()

        try:
            self.io.run(_close(), timeout=5)
        except Exception:  # noqa: BLE001
            pass
        if self._own_loop:
            self.io.stop()
        # An in-flight delete pass on the executor thread must leave the
        # store before we unmap it (it checks _closed per iteration), and
        # so must any thread inside a store read (_read_ready's reader
        # count) — a background get() racing the unmap is a segfault.
        deadline = time.monotonic() + 2.0
        while (self._flushing or self._store_readers) and \
                time.monotonic() < deadline:
            time.sleep(0.01)
        self.store.close()

    # ---- distributed reference counting ---------------------------------
    # The owner of an object (the worker that created its ref) frees it when
    # (a) its own process holds no more python refs or in-flight-task pins
    # and (b) no borrower process holds any.  Borrowers report acquire /
    # release to the owner via the owner's node manager, which routes over
    # the owner's registration connection.  (Reference: the borrowing
    # protocol of core_worker/reference_count.h:61, collapsed to
    # per-process balances — order-insensitive counts make the acquire /
    # release races benign.)

    def add_local_ref(self, info: "ObjectRefInfo"):
        if self._closed:
            return
        with self._ref_lock:
            c = self._local_refs.get(info.oid, 0) + 1
            self._local_refs[info.oid] = c
            if c == 1 and info.owner != self.worker_id.binary():
                self._post_borrow(info, +1)
        self._drain_decrefs(block=False)

    def remove_local_ref(self, info: "ObjectRefInfo"):
        """Queue a reference release.  Called from ObjectRef.__del__, which
        the GC may fire at ANY point — including while this or another
        thread holds _ms_lock/_ref_lock — so this never blocks on a lock;
        the actual free happens at the next drain point."""
        if self._closed:
            return
        self._decref_queue.append(info)
        self._drain_decrefs(block=False)

    def _drain_decrefs(self, block: bool = True):
        if not self._decref_queue:
            return
        if block:
            self._ref_lock.acquire()
        elif not self._ref_lock.acquire(blocking=False):
            return  # someone else holds it; they / the pump will drain
        try:
            while True:
                try:
                    info = self._decref_queue.popleft()
                except IndexError:
                    break
                c = self._local_refs.get(info.oid, 0) - 1
                if c > 0:
                    self._local_refs[info.oid] = c
                    continue
                self._local_refs.pop(info.oid, None)
                if info.owner == self.worker_id.binary():
                    self._maybe_free_owned(info.oid)
                else:
                    self._post_borrow(info, -1)
        finally:
            self._ref_lock.release()

    def _post_borrow(self, info: "ObjectRefInfo", delta: int):
        if not info.node_address:
            return
        try:
            fut = self.io.post(self._notify_owner(
                info.oid, info.owner, info.node_address, delta))
        except Exception:  # noqa: BLE001 - loop shut down
            return
        if delta > 0:
            # Track the registration so flush_borrows() can await the
            # owner's ack before a task reply is sent.
            self._borrow_acks.add(fut)
            fut.add_done_callback(self._borrow_acks.discard)

    async def _flush_borrows_async(self, timeout: float = 5.0):
        """Await every in-flight borrow +1 registration's ack."""
        futs = [asyncio.wrap_future(f) for f in list(self._borrow_acks)
                if not f.done()]
        if futs:
            await asyncio.wait(futs, timeout=timeout)

    def flush_borrows(self, timeout: float = 5.0):
        """Block until outstanding borrow +1 registrations are acked by
        their owners.  Called by workers before replying to a task push:
        afterwards the caller can release its arg pins immediately — the
        owner provably knows about this process's borrows (the role of the
        reference's borrower-list merge on task replies)."""
        if not self._borrow_acks:
            return
        try:
            self.io.run(self._flush_borrows_async(timeout),
                        timeout=timeout + 2)
        except Exception:  # noqa: BLE001 - loop shutting down
            pass

    async def _notify_owner(self, oid: bytes, owner: bytes, addr: str,
                            delta: int):
        try:
            conn = self.nm if addr == self.node_address else \
                await self._worker_conn(addr)
            await conn.call("ref_borrow", {
                "oid": oid, "owner": owner, "delta": delta,
                "borrower": self.worker_id.binary()})
        except Exception as e:  # noqa: BLE001 - owner gone: nothing to free
            logger.debug("borrow notify failed for %s: %s",
                         oid.hex()[:16], e)

    def on_borrow_change(self, oid: bytes, borrower: bytes, delta: int):
        """Owner side: a borrower's acquire/release arrived (any order)."""
        with self._ref_lock:
            per = self._borrowers.setdefault(oid, {})
            bal = per.get(borrower, 0) + delta
            if bal == 0:
                per.pop(borrower, None)
            else:
                per[borrower] = bal
            if not per:
                self._borrowers.pop(oid, None)
                if self._local_refs.get(oid, 0) == 0:
                    self._maybe_free_owned(oid)

    def _maybe_free_owned(self, oid: bytes):
        """Free an owned object once nothing references it anywhere.
        Never blocks: the shm delete is deferred to the pump."""
        with self._ref_lock:
            if (self._local_refs.get(oid, 0) > 0
                    or any(self._borrowers.get(oid, {}).values())):
                return
            self._drop_lineage(oid)
            self._freed[oid] = None
            while len(self._freed) > 100_000:
                self._freed.popitem(last=False)
            # release refs the outer value contained
            for info in self._contained.pop(oid, ()):
                self._decref_queue.append(info)
        with self._ms_lock:
            self.memory_store.pop(oid, None)
        self._store_delete_q.append(oid)

    # ---- lineage bookkeeping --------------------------------------------
    # (_drop_lineage/_release_lineage_entry require _ref_lock held;
    #  _record_lineage takes it itself.)

    def _record_lineage(self, task_id: TaskID, num_returns: int, spec: dict,
                        skey: bytes, resources, pg,
                        dep_pins: List["ObjectRefInfo"]):
        """Retain the task spec for re-execution of lost returns, pinning
        its by-reference args for as long as the lineage lives (reference:
        lineage_pinning_enabled, ray_config_def.h:160).  Budget-bounded:
        oldest lineage is evicted past max_lineage_bytes."""
        nbytes = 512 + sum(
            len(m.get("d", b"")) + 64
            for m in list(spec["args"]) + list(spec["kwargs"].values()))
        lin = {"spec": spec, "skey": skey, "resources": resources,
               "pg": pg, "live_returns": 0, "nbytes": nbytes,
               "dep_pins": list(dep_pins)}
        for info in lin["dep_pins"]:
            self.add_local_ref(info)
        with self._ref_lock:
            # dynamic tasks: the primary registers here; item oids
            # attach to the same entry at reply time (_ingest_returns)
            for i in range(1 if num_returns == -1 else num_returns):
                roid = ObjectID.for_return(task_id, i + 1).binary()
                if roid not in self._freed:
                    self._lineage[roid] = lin
                    lin["live_returns"] += 1
            if lin["live_returns"] > 0:
                self._lineage_bytes += lin["nbytes"]
                while (self._lineage_bytes > self.config.max_lineage_bytes
                       and self._lineage):
                    _, old_lin = self._lineage.popitem(last=False)
                    self._release_lineage_entry(old_lin)
            else:
                for info in lin["dep_pins"]:
                    self._decref_queue.append(info)

    def _drop_lineage(self, oid: bytes):
        lin = self._lineage.pop(oid, None)
        if lin is not None:
            self._release_lineage_entry(lin)

    def _release_lineage_entry(self, lin: dict):
        lin["live_returns"] -= 1
        if lin["live_returns"] <= 0:
            self._lineage_bytes -= lin["nbytes"]
            self._recovering.pop(lin["spec"]["task_id"], None)
            for info in lin.pop("dep_pins", []):
                self._decref_queue.append(info)  # deferred unpin

    def _pin_refs(self, marshalled: list,
                  nested: Sequence["ObjectRefInfo"] = ()
                  ) -> List["ObjectRefInfo"]:
        """Pin every by-reference arg of an in-flight task — including refs
        nested inside pickled by-value args — so the objects outlive the
        submission even if the caller drops its python refs (reference:
        TaskManager holds deps of pending tasks)."""
        pins = []
        for m in marshalled:
            if m.get("k") == "r":
                info = ObjectRefInfo(m["oid"], m["owner"], m["addr"])
                self.add_local_ref(info)
                pins.append(info)
        for info in nested:
            self.add_local_ref(info)
            pins.append(info)
        return pins

    def _unpin_now(self, pins: List["ObjectRefInfo"]):
        for info in pins:
            self._decref_queue.append(info)
        self._drain_decrefs(block=False)

    # -- worker-side pins for refs embedded in task returns ----------------
    # The executing worker keeps refs nested in its return values pinned
    # until the caller (the owner of the return object) confirms it has
    # registered its own borrows (release_return_pins), with a timer only
    # as the caller-crashed fallback — if the caller died, the return
    # object is orphaned anyway and third-party nested refs must not leak.

    def hold_return_pins(self, task_id: bytes,
                         pins: List["ObjectRefInfo"]):
        with self._ref_lock:
            self._return_pins.setdefault(task_id, []).extend(pins)
        try:
            self.io.post(self._return_pin_fallback(task_id))
        except Exception:  # noqa: BLE001 - loop shut down
            pass

    async def _return_pin_fallback(self, task_id: bytes):
        await asyncio.sleep(self.config.worker_start_timeout_s)
        self.release_return_pins(task_id)

    def release_return_pins(self, task_id: bytes):
        with self._ref_lock:
            pins = self._return_pins.pop(task_id, None)
        if pins:
            self._unpin_now(pins)

    # ---- object plane ----------------------------------------------------

    def _store_local(self, oid: bytes, data: bytes, is_error: bool):
        with self._ref_lock:
            if oid in self._freed:
                return  # all refs dropped while the task was in flight
        with self._ms_lock:
            entry = self.memory_store.setdefault(oid, MemoryStoreEntry())
        entry.put(data, is_error)

    def _ensure_entry(self, oid: bytes) -> MemoryStoreEntry:
        with self._ms_lock:
            return self.memory_store.setdefault(oid, MemoryStoreEntry())

    def _ctx_task_id(self) -> TaskID:
        """Current task id: thread-local execution context if set (worker
        threads running user code), else this process's root task."""
        from ray_tpu_torch._private import worker_context

        tid = worker_context.current_task_id()
        return TaskID(tid) if tid else self._current_task_id

    def put(self, value: Any, owner_address: str = "") -> "ObjectRefInfo":
        oid = put_object_id(self._ctx_task_id())
        ser, collected = self._serialize_collecting(value)
        if collected:
            # Refs nested inside the value stay pinned by the outer object
            # until it is freed (reference: AddNestedObjectIds).
            self._pin_contained(oid.binary(), collected)
        if ser.total_size <= self.config.max_inline_object_size:
            self._store_local(oid.binary(), ser.to_bytes(), False)
        else:
            self._put_shm(oid, ser)
        return ObjectRefInfo(oid.binary(), self.worker_id.binary(),
                             self.node_address)

    def _serialize_collecting(self, value: Any):
        """serialize(value) while collecting ObjectRefs nested inside it."""
        from ray_tpu_torch._private.worker_context import _ser_scope

        prev = getattr(_ser_scope, "refs", None)
        _ser_scope.refs = collected = []
        try:
            ser = serialization.serialize(value)
        finally:
            _ser_scope.refs = prev
        return ser, collected

    def _pin_contained(self, outer_oid: bytes,
                       infos: List["ObjectRefInfo"]):
        for info in infos:
            self.add_local_ref(info)
        with self._ref_lock:
            if outer_oid in self._freed:
                for info in infos:
                    self._decref_queue.append(info)
            else:
                self._contained.setdefault(outer_oid, []).extend(infos)

    def _put_shm(self, oid: ObjectID, ser: serialization.SerializedObject):
        # writers need the shutdown guard as much as readers: a put
        # racing store.close() would run create/seal against the
        # unmapped segment
        with self._store_access():
            return self._put_shm_inner(oid, ser)

    def _put_shm_inner(self, oid: ObjectID,
                       ser: serialization.SerializedObject):
        if self.spill.enabled and \
                ser.total_size > self.store.stats()["capacity"]:
            # can never fit: skip the futile spill/evict backpressure loop
            # (which would flush the whole working set to disk for
            # nothing) and fallback-allocate immediately
            self.spill.write_direct(oid.binary(), ser.to_bytes())
            return
        try:
            view = self._create_with_backpressure(oid, ser.total_size)
        except ObjectStoreFull:
            # Fallback allocation (reference: plasma CreateAndSpillIfNeeded
            # → fallback allocator writes to disk-backed files): the arena
            # is full of pinned objects (zero-copy views, in-flight task
            # args) that neither spill nor eviction may touch, so the new
            # object goes straight to the spill directory; get() restores
            # it through the normal spill read path.
            if not self.spill.enabled:
                raise
            logger.info("arena full (pinned working set): fallback-"
                        "allocating %d bytes to spill for %s",
                        ser.total_size, oid)
            self.spill.write_direct(oid.binary(), ser.to_bytes())
            return
        if view is None:
            return  # sealed copy already present: idempotent re-create
        try:
            ser.write_into(view)
        finally:
            view.release()
        self.store.seal(oid)

    def _create_with_backpressure(self, oid: ObjectID, size: int):
        """create() with spill-then-evict pressure relief and a bounded
        retry queue when the arena stays full (reference: plasma's
        CreateRequestQueue retries creates instead of failing,
        create_request_queue.cc; spill preferred over eviction,
        local_object_manager.h:206)."""
        deadline = time.monotonic() + self.config.create_retry_timeout_s
        while True:
            try:
                # Spill-first: with a spill dir configured the allocator
                # must NOT silently evict (that destroys data lineage may
                # have to rebuild); we move LRU objects to disk instead.
                return self.store.create(
                    oid, size, allow_evict=not self.spill.enabled)
            except ObjectStoreFull:
                freed = self.spill.spill(size) if self.spill.enabled else 0
                if freed < size:
                    self.store.evict(size - freed)
                if time.monotonic() > deadline:
                    # Final attempt surfaces the real error — still
                    # honoring the no-silent-eviction invariant when
                    # spilling is configured.
                    return self.store.create(
                        oid, size, allow_evict=not self.spill.enabled)
                time.sleep(0.01)
            except ObjectStoreError as e:
                if "exists" not in str(e):
                    raise
                if self.store.contains(oid):
                    return None  # sealed copy present: idempotent
                # created-but-unsealed orphan (crashed writer): abort and
                # retry (os_obj_abort handles unsealed entries)
                try:
                    self.store.abort(oid)
                except Exception:  # noqa: BLE001
                    pass
                if time.monotonic() > deadline:
                    raise
                time.sleep(0.01)

    def _deserialize_store_buffer(self, buf) -> Tuple[Any, bool]:
        """Deserialize a pinned shared-memory object, zero-copy when safe.

        The reference serves numpy views backed by pinned plasma buffers
        (plasma client Get + SerializationContext); the analog here:
        out-of-band buffers deserialize as views over the pinned arena
        region, and the pin is released by weakref finalizers once every
        such array is garbage-collected.  When the value structure hides
        its arrays from the shallow walk (custom objects), fall back to
        the one-copy path — correctness over speed."""
        import weakref

        import numpy as np

        if len(buf.metadata) or not self.config.zero_copy_get:
            with buf:
                return serialization.deserialize(
                    bytes(buf.data) + bytes(buf.metadata))
        try:
            value, is_err, spans = \
                serialization.deserialize_info_spans(buf.data)
        except Exception:
            buf.close()
            raise
        if not spans:
            # pure-pickle value: loads() copied everything already
            buf.close()
            return value, is_err
        arrays = _shallow_aliasing_arrays(value, buf.data)
        if not _arrays_cover_spans(arrays, buf.data, spans):
            # an out-of-band buffer has no (or an ambiguous) visible
            # owner among the shallow-walked arrays — a view may be
            # hidden inside an opaque object.  Re-read through the copy
            # path so no view can outlive the pin.
            with buf:
                return serialization.deserialize(
                    bytes(buf.data) + bytes(buf.metadata))
        lock = threading.Lock()
        left = [len(arrays)]

        def _release_pin():
            with lock:
                left[0] -= 1
                if left[0] == 0:
                    buf.close()

        for a in arrays:
            weakref.finalize(a, _release_pin)
        return value, is_err

    def _read_ready(self, oid: bytes) -> Optional[Tuple[Any, bool]]:
        """Non-blocking read: memory store, then shared store, then the
        node's spill directory (restore-on-get without re-inserting, so a
        read never triggers further spilling).

        Store access is reader-counted against shutdown(): a background
        thread (serve's long-poll listener, a user thread in get())
        reading the shm store while shutdown unmaps it is a segfault in
        the C client — shutdown waits for readers to drain first."""
        entry = self.memory_store.get(oid)
        if entry is not None and entry.event.is_set() and not entry.in_store:
            return serialization.deserialize(entry.data)
        with self._store_access():
            buf = self.store.get(ObjectID(oid), timeout_ms=0)
            if buf is not None:
                return self._deserialize_store_buffer(buf)
        # spill reads are disk/network IO with no shm exposure — keep
        # them OUTSIDE the guard or a slow remote read stalls shutdown
        data = self.spill.read(oid)
        if data is not None:
            return serialization.deserialize(data)
        return None

    @contextlib.contextmanager
    def _store_access(self):
        """Guard around every shm-store call from arbitrary threads:
        registers the caller so shutdown() waits for it before unmapping
        (touching the store after munmap is a segfault in the C
        client), and refuses entry once closed."""
        with self._store_readers_lock:
            self._store_readers += 1
        try:
            if self._closed:
                raise exceptions.RayError("client is shut down")
            yield
        finally:
            with self._store_readers_lock:
                self._store_readers -= 1

    def is_ready(self, ref: "ObjectRefInfo") -> bool:
        entry = self.memory_store.get(ref.oid)
        if entry is not None and entry.event.is_set():
            return True
        with self._store_access():
            return self.store.contains(ObjectID(ref.oid)) or \
                self.spill.contains(ref.oid)

    def get(self, refs: Sequence["ObjectRefInfo"],
            timeout: Optional[float] = None) -> List[Any]:
        deadline = None if timeout is None else time.monotonic() + timeout
        out: List[Any] = [None] * len(refs)
        # Pull requests are re-issued periodically: the first attempt can
        # race object production at the owner (owner replies "don't have
        # it yet"), so one-shot pulling would hang forever.
        pull_last: Dict[int, float] = {}
        # Objects whose owner promised "it's in the shared store" but the
        # store disagrees: if that persists, the object was evicted and
        # (for self-owned objects) cannot be recovered -> ObjectLostError.
        miss_since: Dict[int, float] = {}
        pending = list(range(len(refs)))
        while pending:
            still: List[int] = []
            now = time.monotonic()
            for i in pending:
                ref = refs[i]
                res = self._read_ready(ref.oid)
                if res is None:
                    if (ref.owner != self.worker_id.binary() and
                            now - pull_last.get(i, -1e9) >
                            self.config.pull_retry_interval_s):
                        pull_last[i] = now
                        self.io.post(self._request_pull(ref))
                        # Borrowed object that stays unpullable: tell the
                        # owner so it can reconstruct from lineage (the
                        # storing node may be dead).
                        t0 = miss_since.setdefault(i, now)
                        if now - t0 > self.config.object_miss_grace_s:
                            miss_since[i] = now
                            self.io.post(self._report_unavailable(ref))
                    entry = self.memory_store.get(ref.oid)
                    if (entry is not None and entry.in_store
                            and ref.owner == self.worker_id.binary()):
                        t0 = miss_since.setdefault(i, time.monotonic())
                        if time.monotonic() - t0 > \
                                self.config.object_miss_grace_s:
                            if self._try_recover(ref.oid):
                                miss_since[i] = time.monotonic()
                            else:
                                raise exceptions.ObjectLostError(
                                    f"object {ref.oid.hex()[:16]} was "
                                    "evicted from the local store, has no "
                                    "other copy, and cannot be "
                                    "reconstructed (no lineage or "
                                    "reconstruction attempts exhausted)")
                    still.append(i)
                else:
                    value, is_error = res
                    if is_error:
                        self._raise_error(value)
                    out[i] = value
            pending = still
            if not pending:
                break
            if deadline is not None and time.monotonic() > deadline:
                raise exceptions.GetTimeoutError(
                    f"get() timed out waiting for {len(pending)} objects")
            # Block efficiently on the first pending local future if any;
            # if its event is already set (in_store marker) fall back to a
            # short poll so we never hot-spin.
            first = self.memory_store.get(refs[pending[0]].oid)
            if first is not None and not first.event.is_set():
                wait_s = 0.2 if deadline is None else min(
                    0.2, max(0.0, deadline - time.monotonic()))
                first.event.wait(wait_s)
            else:
                time.sleep(self.config.get_poll_interval_s)
        return out

    def _try_recover(self, oid: bytes) -> bool:
        """Kick off lineage re-execution for a lost owned object.  Returns
        True if a reconstruction is (now) in flight.  Keyed by TASK id so a
        multi-return task with several lost returns re-executes once.
        (Reference: object_recovery_manager.h:41.)"""
        with self._ref_lock:
            lin = self._lineage.get(oid)
            if lin is None:
                return False
            tid = lin["spec"]["task_id"]
            attempts = self._recovering.get(tid, 0)
            if attempts < 0:
                return True  # this task's re-execution already in flight
            if attempts >= self.config.max_lineage_reexecutions:
                return False
            self._recovering[tid] = -(attempts + 1)  # negative = in flight
        logger.warning("lost object %s: re-executing task %s from lineage",
                       oid.hex()[:16], lin["spec"].get("name", "?"))
        self.io.post(self._resubmit_lineage(tid, lin))
        return True

    async def _resubmit_lineage(self, tid: bytes, lin: dict):
        spec = dict(lin["spec"])
        skey = lin["skey"]
        state = self._leases.get(skey)
        if state is None:
            state = LeaseState(lin["resources"], lin["pg"])
            self._leases[skey] = state
        fut = asyncio.get_running_loop().create_future()
        state.queue.append((spec, fut))
        self._maybe_request_lease(skey, state)
        try:
            await fut
        except Exception as e:  # noqa: BLE001 - reconstruction failed
            logger.warning("lineage re-execution of task %s failed: %s",
                           tid.hex()[:12], e)
        finally:
            with self._ref_lock:
                att = self._recovering.get(tid)
                if att is not None:
                    self._recovering[tid] = -att  # mark not-in-flight

    async def _request_pull(self, ref: "ObjectRefInfo"):
        try:
            await self.nm.call("pull_object", {
                "oid": ref.oid, "owner": ref.owner,
                "owner_node_address": ref.node_address}, timeout=60.0)
        except Exception as e:  # noqa: BLE001 - surfaced by get timeout
            logger.debug("pull_object failed for %s: %s", ref.oid.hex()[:16], e)

    async def _report_unavailable(self, ref: "ObjectRefInfo"):
        """Route object_unavailable to the owner via its node manager
        (same path as borrow notifications)."""
        try:
            conn = self.nm if ref.node_address == self.node_address else \
                await self._worker_conn(ref.node_address)
            await conn.call("object_unavailable", {
                "oid": ref.oid, "owner": ref.owner})
        except Exception as e:  # noqa: BLE001 - owner/node gone
            logger.debug("unavailability report failed for %s: %s",
                         ref.oid.hex()[:16], e)

    def wait(self, refs: Sequence["ObjectRefInfo"], num_returns: int,
             timeout: Optional[float], fetch_local: bool = True
             ) -> Tuple[List[int], List[int]]:
        deadline = None if timeout is None else time.monotonic() + timeout
        pull_last: Dict[int, float] = {}
        while True:
            ready, not_yet = [], []
            for i, r in enumerate(refs):
                (ready if self.is_ready(r) else not_yet).append(i)
            if len(ready) >= num_returns or (
                    deadline is not None and time.monotonic() >= deadline):
                ready = ready[:num_returns]
                picked = set(ready)
                not_ready = [i for i in range(len(refs)) if i not in picked]
                return ready, not_ready
            if fetch_local:
                # Borrowed objects only become locally ready if someone
                # pulls them; re-issue pulls like get() does.
                now = time.monotonic()
                for i in not_yet:
                    ref = refs[i]
                    if (ref.owner != self.worker_id.binary() and
                            now - pull_last.get(i, -1e9) >
                            self.config.pull_retry_interval_s):
                        pull_last[i] = now
                        self.io.post(self._request_pull(ref))
            time.sleep(self.config.get_poll_interval_s)

    def free(self, refs: Sequence["ObjectRefInfo"]):
        for ref in refs:
            with self._ref_lock:
                self._drop_lineage(ref.oid)
                self._freed[ref.oid] = None
            with self._ms_lock:
                self.memory_store.pop(ref.oid, None)
            try:
                with self._store_access():
                    self.store.delete(ObjectID(ref.oid))
                    self.spill.delete(ref.oid)
            except Exception:  # noqa: BLE001
                pass

    def _raise_error(self, err: Any):
        if isinstance(err, BaseException):
            raise err
        raise exceptions.RayTaskError(repr(err), "")

    # ---- function export -------------------------------------------------

    def export_function(self, pickled: bytes) -> bytes:
        fid = hashlib.sha1(pickled).digest()
        with self._fn_lock:
            if fid in self._exported_fns:
                return fid
        key = f"fn:{self.job_id.hex()}:{fid.hex()}"
        self.io.run(self.gcs.call("kv_put", {"key": key, "value": pickled}))
        with self._fn_lock:
            self._exported_fns.add(fid)
        return fid

    def fetch_function(self, job_id: bytes, fid: bytes) -> bytes:
        key = f"fn:{JobID(job_id).hex()}:{fid.hex()}"
        pickled = self.io.run(self.gcs.call("kv_get", {"key": key}))
        if pickled is None:
            raise RuntimeError(f"function {fid.hex()[:12]} not found in GCS")
        return pickled

    # ---- argument marshalling -------------------------------------------

    def _marshal_arg(self, arg: Any,
                     nested_out: Optional[list] = None) -> dict:
        from ray_tpu_torch._private.worker_context import ObjectRefLike, _ser_scope

        if isinstance(arg, ObjectRefLike):
            ref = arg._info
            # Inline already-resolved small owner-local values (reference:
            # LocalDependencyResolver inlines <100KiB resolved deps).
            entry = self.memory_store.get(ref.oid)
            if (entry is not None and entry.event.is_set() and not entry.is_error
                    and entry.data is not None
                    and len(entry.data) <= self.config.max_inline_object_size):
                return {"k": "v", "d": entry.data}
            return {"k": "r", "oid": ref.oid, "owner": ref.owner,
                    "addr": ref.node_address}
        # Collect refs nested inside the pickled value so the submitter can
        # pin them for the task's lifetime (they are invisible in the
        # marshalled dict otherwise).
        prev = getattr(_ser_scope, "refs", None)
        _ser_scope.refs = collected = []
        try:
            ser = serialization.serialize(arg)
        finally:
            _ser_scope.refs = prev
        if nested_out is not None:
            nested_out.extend(collected)
        if ser.total_size > self.config.max_inline_object_size:
            # Large pass-by-value arg: put in shm, pass as owned ref.
            oid = put_object_id(self._ctx_task_id())
            self._put_shm(oid, ser)
            return {"k": "r", "oid": oid.binary(),
                    "owner": self.worker_id.binary(),
                    "addr": self.node_address}
        return {"k": "v", "d": ser.to_bytes()}

    def _await_ref_args(self, args, kwargs, timeout=None):
        """Block until every ObjectRef argument is resolvable (owner-local
        ready or in shm) so the leased worker never stalls on deps."""
        from ray_tpu_torch._private.worker_context import ObjectRefLike

        refs = [a for a in list(args) + list(kwargs.values())
                if isinstance(a, ObjectRefLike)]
        for r in refs:
            if r._info.owner == self.worker_id.binary():
                entry = self.memory_store.get(r._info.oid)
                if entry is not None and not entry.event.is_set():
                    entry.event.wait()
                if entry is not None and entry.is_error:
                    value, _ = serialization.deserialize(entry.data)
                    self._raise_error(value)

    async def _async_resolve_deps(self, args, kwargs) -> Optional[bytes]:
        """Await pending self-owned ref deps on the loop (keeps .remote()
        non-blocking so task graphs compose asynchronously).  Returns the
        serialized error bytes of the first failed dependency, if any
        (dependency errors propagate to this task's returns, matching the
        reference's error-on-get semantics)."""
        from ray_tpu_torch._private.worker_context import ObjectRefLike

        for a in list(args) + list(kwargs.values()):
            if not isinstance(a, ObjectRefLike):
                continue
            if a._info.owner != self.worker_id.binary():
                continue
            entry = self.memory_store.get(a._info.oid)
            if entry is None:
                continue
            await entry.ready()
            if entry.is_error:
                return entry.data
        return None

    # ---- normal task submission (lease protocol) ------------------------

    def submit_task(self, fid: bytes, args: tuple, kwargs: dict, *,
                    num_returns: int = 1, resources: Dict[str, float],
                    name: str = "", max_retries: int = 3,
                    pg: Optional[Tuple[bytes, int]] = None
                    ) -> List["ObjectRefInfo"]:
        self._task_counter += 1
        task_id = TaskID.for_task(self.job_id)
        # dynamic (-1): one primary ref now; the items materialize as
        # for_return(i+2) objects reported on the task reply
        n_refs = 1 if num_returns == -1 else num_returns
        return_ids = [ObjectID.for_return(task_id, i + 1).binary()
                      for i in range(n_refs)]
        for oid in return_ids:
            self._ensure_entry(oid)
        skey = self._scheduling_key(resources, pg)
        from ray_tpu_torch.util import tracing

        trace_ctx = tracing.maybe_inject("task", name) \
            if tracing.is_enabled() else None
        self.io.post(self._submit_on_loop(
            skey, task_id, fid, name, args, kwargs, num_returns,
            resources, pg, max_retries, trace_ctx))
        return [ObjectRefInfo(oid, self.worker_id.binary(), self.node_address)
                for oid in return_ids]

    def _scheduling_key(self, resources, pg) -> bytes:
        items = tuple(sorted(resources.items())) + (pg or ())
        return hashlib.sha1(repr(items).encode()).digest()

    async def _submit_on_loop(self, skey, task_id, fid, name, args, kwargs,
                              num_returns, resources, pg, max_retries,
                              trace_ctx=None):
        spec = {
            "task_id": task_id.binary(),
            "job_id": self.job_id.binary(),
            "fid": fid,
            "name": name,
            "num_returns": num_returns,
            "caller": self.worker_id.binary(),
            "caller_addr": self.node_address,
            "retries_left": max_retries,
        }
        if trace_ctx:
            spec["trace_ctx"] = trace_ctx
        pins: List[ObjectRefInfo] = []
        try:
            dep_error = await self._async_resolve_deps(args, kwargs)
            if dep_error is not None:
                for i in range(1 if num_returns == -1 else num_returns):
                    oid = ObjectID.for_return(task_id, i + 1).binary()
                    self._store_local(oid, dep_error, True)
                return
            nested: List[ObjectRefInfo] = []
            spec["args"] = [self._marshal_arg(a, nested) for a in args]
            spec["kwargs"] = {k: self._marshal_arg(v, nested)
                              for k, v in kwargs.items()}
            pins = self._pin_refs(
                list(spec["args"]) + list(spec["kwargs"].values()), nested)
        except Exception as e:  # noqa: BLE001 - marshalling failed
            self._fail_task(spec, e)
            return
        if self.config.lineage_enabled:
            self._record_lineage(task_id, num_returns, spec, skey,
                                 resources, pg, pins)
        state = self._leases.get(skey)
        if state is None:
            state = LeaseState(resources, pg)
            self._leases[skey] = state
        fut = asyncio.get_running_loop().create_future()
        state.queue.append((spec, fut))
        self._maybe_request_lease(skey, state)
        try:
            await fut
        except Exception as e:  # noqa: BLE001 - record as task error
            self._fail_task(spec, e)
        finally:
            # Safe to unpin immediately: the worker acked its borrow
            # registrations to every owner before replying (flush_borrows
            # in _execute), and a crashed worker holds no borrows.
            self._unpin_now(pins)

    def _fail_task(self, spec, exc: Exception):
        # Cancellation (and other framework errors) surface as themselves
        # from get(); only opaque failures are wrapped.
        err = exc if isinstance(exc, exceptions.RayTpuError) else \
            exceptions.RayTaskError(repr(exc), "")
        data = serialization.serialize_error(err).to_bytes()
        for i in range(1 if spec["num_returns"] == -1 else spec["num_returns"]):
            oid = ObjectID.for_return(TaskID(spec["task_id"]), i + 1).binary()
            self._store_local(oid, data, True)

    def _maybe_request_lease(self, skey, state: LeaseState):
        demand = len(state.queue)
        if demand == 0:
            return
        if state.workers:
            self._dispatch(skey, state)
            return
        # Pipelining cap (reference: direct_task_transport's
        # max_pending_lease_requests_per_scheduling_category): in-flight
        # lease requests are bounded, NOT one-per-queued-task.  A 4k-task
        # burst used to issue 4k requests; the node granted every one as
        # workers freed (the client's own reuse raced the node's queue),
        # and the ~4k queued return_worker calls then stalled the loop
        # for tens of seconds after the burst (measured: first actor
        # creation 62s late at 8k tasks).  Granted leases are reused
        # across the whole queue, so a handful of requests suffices.
        if state.inflight_requests >= min(demand,
                                          self.config.max_pending_lease_requests):
            return
        state.inflight_requests += 1
        asyncio.get_running_loop().create_task(self._request_lease(skey, state))

    async def _request_lease(self, skey, state: LeaseState):
        try:
            payload = {"resources": state.resources, "scheduling_key": skey}
            if state.pg is not None:
                payload["pg_id"] = state.pg[0]
                payload["bundle_index"] = state.pg[1]
            last_exc: Optional[BaseException] = None
            # A lease attempt dying mid-flight (target node killed while
            # granting / starting a worker) is retried with a FRESH
            # spillback pick — the GCS will route around the dead node
            # (reference: lease retries in direct_task_transport on raylet
            # failure).  Only persistent failure surfaces to the tasks.
            for attempt in range(5):
                try:
                    lease = await self._lease_once(payload)
                    state.workers.append(lease)
                    self._dispatch(skey, state)
                    if not state.queue:
                        # Every queued task vanished while the lease was
                        # being granted (e.g. cancel()): hand it straight
                        # back or the worker's resources stay held.
                        await self._return_idle(skey, state)
                    return
                except Exception as e:  # noqa: BLE001
                    last_exc = e
                    if not state.queue:
                        return  # nobody waiting anymore
                    logger.warning(
                        "lease attempt %d for %s failed: %s", attempt + 1,
                        state.resources, e)
                    await asyncio.sleep(0.3 * (attempt + 1))
            while state.queue:
                _, fut = state.queue.pop(0)
                if not fut.done():
                    fut.set_exception(last_exc)
        finally:
            state.inflight_requests -= 1
            # A task queued while this request was still counted in
            # flight (say, during the return of a lease granted after
            # the queue drained) asked for no lease of its own: ask now,
            # or it waits forever.  Not when the request was cancelled
            # or the worker is closing: the loop is stopping, and a task
            # started now would be left pending on it.
            if state.queue and not self._closed and \
                    not asyncio.current_task().cancelling():
                self._maybe_request_lease(skey, state)

    async def _lease_once(self, payload) -> dict:
        lease = await self.nm.call("request_worker_lease", payload)
        # Spillback: local node can't fit the shape — re-lease at the
        # node the scheduler pointed us to (reference:
        # direct_task_transport.cc:473 retry at raylet address).
        hops = 0
        while isinstance(lease, dict) and lease.get("spillback"):
            addr = lease["spillback"]
            hops += 1
            if hops > 4:
                raise RuntimeError("spillback loop; cluster resources "
                                   "changing too fast")
            nm = await self._worker_conn(addr)
            lease = await nm.call("request_worker_lease", payload)
            if not lease.get("spillback"):
                lease["nm_addr"] = addr
        return lease

    def _dispatch(self, skey, state: LeaseState):
        while state.queue and state.workers:
            spec, fut = state.queue.pop(0)
            lease = state.workers.pop(0)
            asyncio.get_running_loop().create_task(
                self._push_task(skey, state, lease, spec, fut))
        self._maybe_request_lease(skey, state)

    async def _worker_conn(self, address: str) -> protocol.Connection:
        conn = self._worker_conns.get(address)
        if conn is None or conn.closed:
            lock = self._dial_locks.setdefault(address, asyncio.Lock())
            async with lock:
                conn = self._worker_conns.get(address)
                if conn is None or conn.closed:
                    conn = await self._dial(address)
                    self._worker_conns[address] = conn
        return conn

    async def _push_task(self, skey, state, lease, spec, fut):
        tid = spec["task_id"]
        if tid in self._cancelled:
            self._fail_task(spec, exceptions.TaskCancelledError(
                f"task {spec.get('name', '?')} was cancelled"))
            if not fut.done():
                fut.set_result(None)
            state.workers.append(lease)
            if state.queue:
                self._dispatch(skey, state)
            else:
                await self._return_idle(skey, state)
            return
        try:
            conn = await self._worker_conn(lease["address"])
            self._inflight_tasks[tid] = lease["address"]
            reply = await conn.call("push_task", spec)
            if self._ingest_returns(spec, reply):
                asyncio.get_running_loop().create_task(
                    self._confirm_return_pins(conn, spec["task_id"]))
            if not fut.done():
                fut.set_result(None)
        except protocol.RpcError as e:
            self._fail_task_user_error(spec, e)
            if not fut.done():
                fut.set_result(None)
        except Exception as e:  # noqa: BLE001 - worker died mid-task
            lease = None  # lease is gone with the worker
            if tid in self._cancelled:
                # force-cancel kills the worker: report cancellation, not a
                # crash, and never retry.
                self._fail_task(spec, exceptions.TaskCancelledError(
                    f"task {spec.get('name', '?')} was cancelled"))
                if not fut.done():
                    fut.set_result(None)
            elif spec.get("retries_left", 0) > 0:
                # Retry on a fresh lease (reference: TaskManager resubmits
                # failed tasks up to max_retries, task_manager.h:85).
                spec["retries_left"] -= 1
                logger.warning("retrying task %s after worker failure "
                               "(%d retries left)", spec.get("name", "?"),
                               spec["retries_left"])
                state.queue.append((spec, fut))
            elif not fut.done():
                fut.set_exception(
                    exceptions.WorkerCrashedError(
                        f"worker died executing task: {e}"))
        finally:
            self._inflight_tasks.pop(tid, None)
            if lease is not None:
                state.workers.append(lease)
            if state.queue:
                self._dispatch(skey, state)
            elif lease is not None:
                await self._return_idle(skey, state)

    def _fail_task_user_error(self, spec, e: protocol.RpcError):
        err = exceptions.RayTaskError(str(e), e.remote_traceback)
        data = serialization.serialize_error(err).to_bytes()
        for i in range(1 if spec["num_returns"] == -1 else spec["num_returns"]):
            oid = ObjectID.for_return(TaskID(spec["task_id"]), i + 1).binary()
            self._store_local(oid, data, True)

    async def _return_idle(self, skey, state: LeaseState):
        while state.workers and not state.queue:
            lease = state.workers.pop()
            try:
                nm = self.nm if not lease.get("nm_addr") else \
                    await self._worker_conn(lease["nm_addr"])
                await nm.call("return_worker",
                              {"lease_id": lease["lease_id"]})
            except Exception:  # noqa: BLE001
                pass

    def _ingest_returns(self, spec, reply) -> bool:
        """Record task returns; returns True when any return embedded
        nested ObjectRefs (the worker is then holding pins that must be
        released via release_return_pins once our own borrows are acked)."""
        had_contained = False
        if spec["num_returns"] == -1:
            # dynamic items: key each item oid into the task's lineage
            # entry (registered under the primary at submit) so lost
            # items reconstruct by re-executing the task — re-execution
            # derives the same for_return oids.
            primary = ObjectID.for_return(TaskID(spec["task_id"]),
                                          1).binary()
            with self._ref_lock:
                lin = self._lineage.get(primary)
                if lin is not None:
                    for ret in reply["returns"]:
                        oid = ret["oid"]
                        if oid != primary and oid not in self._lineage \
                                and oid not in self._freed:
                            self._lineage[oid] = lin
                            lin["live_returns"] += 1
        for ret in reply["returns"]:
            oid = ret["oid"]
            with self._ref_lock:
                if oid in self._freed:
                    continue  # every ref was dropped while in flight
            contained = ret.get("contained")
            if contained:
                had_contained = True
                self._pin_contained(oid, [
                    ObjectRefInfo(o, w, a) for o, w, a in contained])
            if "d" in ret:
                self._store_local(oid, ret["d"], bool(ret.get("err")))
                continue
            node = ret.get("node", "")
            if node and node != self.node_address:
                # Large return lives in a REMOTE node's store: have our
                # node manager pull it across before waking getters
                # (reference: ObjectManager pull, pull_manager.h:48).
                asyncio.get_running_loop().create_task(
                    self._pull_return(oid, node))
            else:
                # Large return living in shm; wake blocked getters.
                self._ensure_entry(oid).put_in_store()
        return had_contained

    async def _confirm_return_pins(self, conn, task_id: bytes):
        """Ack our nested-return borrows to their owners, then tell the
        executing worker to drop its bridging pins (exact handover)."""
        try:
            await self._flush_borrows_async()
            await conn.call("release_return_pins", {"task_id": task_id})
        except Exception:  # noqa: BLE001 - worker exited; its fallback runs
            pass

    async def _pull_return(self, oid: bytes, node_addr: str):
        for attempt in range(3):
            try:
                await self.nm.call("pull_object", {
                    "oid": oid, "owner": b"",
                    "owner_node_address": node_addr}, timeout=30.0)
                self._ensure_entry(oid).put_in_store()
                return
            except Exception as e:  # noqa: BLE001 - storing node may be dead
                logger.warning(
                    "cross-node return pull failed for %s (try %d): %s",
                    oid.hex()[:16], attempt + 1, e)
                await asyncio.sleep(0.5 * (attempt + 1))
        # The storing node is gone before we secured a copy: re-execute
        # the producing task from lineage (reference:
        # object_recovery_manager.h:41).  If that's impossible the entry
        # must resolve to an ERROR — dependents await its readiness and
        # would otherwise hang forever.
        if not self._try_recover(oid):
            logger.warning("return object %s unrecoverable",
                           oid.hex()[:16])
            err = exceptions.ObjectLostError(
                f"object {oid.hex()[:16]}'s storing node died before the "
                "owner pulled a copy, and it cannot be reconstructed")
            self._store_local(
                oid, serialization.serialize_error(err).to_bytes(), True)

    # ---- actors ----------------------------------------------------------

    def create_actor(self, fid: bytes, args: tuple, kwargs: dict, *,
                     resources: Dict[str, float], name: str = "",
                     max_restarts: int = 0, lifetime: str = "",
                     max_concurrency: int = 1,
                     pg: Optional[Tuple[bytes, int]] = None) -> bytes:
        self._await_ref_args(args, kwargs)
        actor_id = ActorID.of(self.job_id)
        nested: List[ObjectRefInfo] = []
        spec = {
            "actor_id": actor_id.binary(),
            "job_id": self.job_id.binary(),
            "fid": fid,
            "args": [self._marshal_arg(a, nested) for a in args],
            "kwargs": {k: self._marshal_arg(v, nested)
                       for k, v in kwargs.items()},
            "resources": resources,
            "max_concurrency": max_concurrency,
        }
        # Pin ctor args until the actor is READY or DEAD — not a timer
        # from submission: the actor may sit in the lease queue arbitrarily
        # long before its ctor deserializes the args.  The actor worker
        # flushes its borrow acks before reporting ready, so release on
        # READY is exact.
        pins = self._pin_refs(
            list(spec["args"]) + list(spec["kwargs"].values()), nested)
        if pg is not None:
            spec["placement_group_id"] = pg[0]
            spec["bundle_index"] = pg[1]
        try:
            self.io.run(self.gcs.call("actor_register", {
                "actor_id": actor_id.binary(), "spec": spec,
                "name": name, "max_restarts": max_restarts,
                "lifetime": lifetime}))
        except Exception:
            self._unpin_now(pins)  # actor will never exist
            raise
        # The unpin waiter posts only AFTER registration is acked: its
        # actor_get_info must find the actor and PARK on wait_ready —
        # posted earlier it can race the register frame, get "no such
        # actor", and release the ctor-arg pins while the (now async)
        # creation is still fetching them.
        self.io.post(self._unpin_on_actor_ready(actor_id.binary(), pins))
        return actor_id.binary()

    async def _unpin_on_actor_ready(self, actor_id: bytes,
                                    pins: List["ObjectRefInfo"]):
        try:
            await self.gcs.call("actor_get_info",
                                {"actor_id": actor_id, "wait_ready": True})
        except Exception:  # noqa: BLE001 - GCS gone; release regardless
            pass
        self._unpin_now(pins)

    def wait_actor_ready(self, actor_id: bytes, timeout: float = 120.0) -> dict:
        info = self.io.run(self.gcs.call(
            "actor_get_info", {"actor_id": actor_id, "wait_ready": True}),
            timeout=timeout)
        if info["state"] == "DEAD":
            raise exceptions.ActorDiedError(
                f"actor failed to start: {info['death_cause']}")
        self._actor_addr_cache[actor_id] = info["address"]
        return info

    def get_actor_by_name(self, name: str) -> Optional[dict]:
        return self.io.run(self.gcs.call("actor_get_by_name", {"name": name}))

    def submit_actor_task(self, actor_id: bytes, method: str, args: tuple,
                          kwargs: dict, *, num_returns: int = 1
                          ) -> List["ObjectRefInfo"]:
        task_id = TaskID.for_actor_task(ActorID(actor_id))
        spec = {
            "task_id": task_id.binary(),
            "actor_id": actor_id,
            "method": method,
            "num_returns": num_returns,
            "caller": self.worker_id.binary(),
            "caller_addr": self.node_address,
        }
        from ray_tpu_torch.util import tracing

        if tracing.is_enabled() and method != "raytpu_probe":
            ctx = tracing.maybe_inject("actor", method)
            if ctx:
                spec["trace_ctx"] = ctx
        return_ids = [ObjectID.for_return(task_id, i + 1).binary()
                      for i in range(num_returns)]
        for oid in return_ids:
            self._ensure_entry(oid)
        self.io.post(self._push_actor_task(actor_id, spec, args, kwargs))
        return [ObjectRefInfo(oid, self.worker_id.binary(), self.node_address)
                for oid in return_ids]

    async def _push_actor_task(self, actor_id: bytes, spec: dict,
                               args: tuple, kwargs: dict,
                               dial_retries: int = 3):
        pins: List[ObjectRefInfo] = []
        # out-of-band probes take no turn (they enter no ordered queue)
        turn = None if spec["method"] == "raytpu_probe" else _SendTurn(
            self._actor_send_order.setdefault(
                actor_id, {"issued": 0, "next": 0, "waiters": {}}))
        try:
            try:
                dep_error = await self._async_resolve_deps(args, kwargs)
                if dep_error is not None:
                    for i in range(spec["num_returns"]):
                        oid = ObjectID.for_return(
                            TaskID(spec["task_id"]), i + 1).binary()
                        self._store_local(oid, dep_error, True)
                    return
                nested: List[ObjectRefInfo] = []
                spec["args"] = [self._marshal_arg(a, nested) for a in args]
                spec["kwargs"] = {k: self._marshal_arg(v, nested)
                                  for k, v in kwargs.items()}
                pins = self._pin_refs(
                    list(spec["args"]) + list(spec["kwargs"].values()),
                    nested)
            except Exception as e:  # noqa: BLE001 - marshalling failed
                self._fail_actor_task(spec, e)
                return
            try:
                await self._push_actor_task_inner(actor_id, spec,
                                                  dial_retries, turn)
            finally:
                self._unpin_now(pins)  # worker acked its borrows pre-reply
        finally:
            if turn is not None:
                await turn.pass_on()

    async def _push_actor_task_inner(self, actor_id: bytes, spec: dict,
                                     dial_retries: int = 3, turn=None):
        # Phase 1 — resolve + connect. Safe to retry: nothing was sent yet
        # (a restarting actor resolves to its new address).
        conn = None
        for attempt in range(dial_retries + 1):
            addr = self._actor_addr_cache.get(actor_id)
            try:
                if not addr:
                    info = await self.gcs.call(
                        "actor_get_info",
                        {"actor_id": actor_id, "wait_ready": True})
                    if info["state"] == "DEAD":
                        raise exceptions.ActorDiedError(
                            "actor is dead: " + (info.get("death_cause") or ""))
                    addr = info["address"]
                    self._actor_addr_cache[actor_id] = addr
                conn = await self._worker_conn(addr)
                break
            except exceptions.ActorDiedError as e:
                self._fail_actor_task(spec, e)
                return
            except Exception as e:  # noqa: BLE001 - stale address, retry
                self._actor_addr_cache.pop(actor_id, None)
                if attempt >= dial_retries:
                    self._fail_actor_task(spec, exceptions.ActorDiedError(
                        f"actor unreachable: {e}"))
                    return
                await asyncio.sleep(0.2)
        # Phase 2 — push. The call's turn (_SendTurn) lets one ordered call
        # at a time take its seqno and send, in submission order, however
        # fast each resolved its deps and the actor's address; a call that
        # fails before sending passes its turn on and takes no seqno.  The
        # connection's own send lock keeps a probe's frame whole.  NOT
        # retried after send: the task may have executed (actor tasks
        # default to max_task_retries=0, matching reference
        # ray_option_utils.py:159 semantics).
        if spec["task_id"] in self._cancelled:
            self._fail_actor_task(spec, exceptions.TaskCancelledError(
                "actor task was cancelled"))
            return
        if turn is not None:
            await turn.wait()
        try:
            if turn is None:
                # A probe: answered on the worker's server loop, it never
                # enters the ordered queue — consuming a seqno would leave
                # a permanent gap stalling real calls.
                spec["seqno"] = -1
            else:
                seqno = self._actor_seqno.get(actor_id, 0)
                self._actor_seqno[actor_id] = seqno + 1
                spec["seqno"] = seqno
            try:
                waiter = await conn.call_send("push_actor_task", spec)
            finally:
                if turn is not None:
                    turn.release()
            self._inflight_tasks[spec["task_id"]] = addr
            reply = await waiter
            if self._ingest_returns(spec, reply):
                asyncio.get_running_loop().create_task(
                    self._confirm_return_pins(conn, spec["task_id"]))
        except protocol.RpcError as e:
            self._fail_task_user_error(spec, e)
        except Exception as e:  # noqa: BLE001 - actor died mid-call
            self._actor_addr_cache.pop(actor_id, None)
            self._fail_actor_task(spec, exceptions.ActorDiedError(
                f"actor died while executing task: {e}"))
        finally:
            self._inflight_tasks.pop(spec["task_id"], None)

    def _fail_actor_task(self, spec, err: BaseException):
        data = serialization.serialize_error(err).to_bytes()
        for i in range(spec["num_returns"]):
            oid = ObjectID.for_return(TaskID(spec["task_id"]), i + 1).binary()
            self._store_local(oid, data, True)

    def cancel_task(self, ref: "ObjectRefInfo", force: bool = False,
                    recursive: bool = True):
        """Cancel the task producing ``ref`` (reference: worker.py:2552 +
        CoreWorker::CancelTask).  Dequeues if not yet dispatched, else
        delivers an async TaskCancelledError (or kills the worker when
        force=True)."""
        tid = ObjectID(ref.oid).task_id().binary()
        self.io.run(self._cancel_on_loop(tid, force), timeout=30)

    async def _cancel_on_loop(self, tid: bytes, force: bool):
        self._cancelled[tid] = None
        while len(self._cancelled) > 100_000:
            self._cancelled.popitem(last=False)  # oldest = long-finished
        # Dequeue if still waiting for a lease.
        for state in self._leases.values():
            for i, (spec, fut) in enumerate(list(state.queue)):
                if spec["task_id"] == tid:
                    state.queue.pop(i)
                    spec["retries_left"] = 0
                    self._fail_task(spec, exceptions.TaskCancelledError(
                        f"task {spec.get('name', '?')} was cancelled"))
                    if not fut.done():
                        fut.set_result(None)
                    return
        # Already pushed (normal task on a leased worker, or an actor
        # task): reach into the executing worker.
        addr = self._inflight_tasks.get(tid)
        if addr is None:
            return  # finished (or unknown): nothing to do
        try:
            conn = await self._worker_conn(addr)
            await conn.call("cancel_task",
                            {"task_id": tid, "force": force})
        except Exception as e:  # noqa: BLE001 - worker already gone
            logger.debug("cancel delivery failed for %s: %s",
                         tid.hex()[:12], e)

    def kill_actor(self, actor_id: bytes, no_restart: bool = True):
        self.io.run(self.gcs.call("actor_kill", {
            "actor_id": actor_id, "no_restart": no_restart}))
        self._actor_addr_cache.pop(actor_id, None)

    # ---- cluster introspection ------------------------------------------

    def nodes(self) -> list:
        return self.io.run(self.gcs.call("node_list", {}))

    def cluster_resources(self) -> Dict[str, float]:
        return self.io.run(self.gcs.call("node_total_resources", {}))

    def available_resources(self) -> Dict[str, float]:
        return self.io.run(self.gcs.call("node_available_resources", {}))

    def kv_put(self, key: str, value: bytes, overwrite: bool = True) -> bool:
        return self.io.run(self.gcs.call(
            "kv_put", {"key": key, "value": value, "overwrite": overwrite}))

    def kv_get(self, key: str) -> Optional[bytes]:
        return self.io.run(self.gcs.call("kv_get", {"key": key}))

    def kv_del(self, key: str) -> bool:
        return self.io.run(self.gcs.call("kv_del", {"key": key}))

    def kv_keys(self, prefix: str = "") -> List[str]:
        return self.io.run(self.gcs.call("kv_keys", {"prefix": prefix}))

    def kv_len(self, key: str) -> Optional[int]:
        """Value size in bytes without fetching the payload."""
        return self.io.run(self.gcs.call("kv_len", {"key": key}))


class ObjectRefInfo:
    """The wire-level identity of an object: id + owner + owner's node."""

    __slots__ = ("oid", "owner", "node_address")

    def __init__(self, oid: bytes, owner: bytes, node_address: str):
        self.oid = oid
        self.owner = owner
        self.node_address = node_address

    def __repr__(self):
        return f"ObjectRefInfo({self.oid.hex()[:16]})"
