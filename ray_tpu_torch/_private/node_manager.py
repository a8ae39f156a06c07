"""Per-node manager: worker pool, lease-based local scheduling, object
fetch coordination, placement-group bundle 2PC.

Role-equivalent of the reference raylet's NodeManager (reference
``src/ray/raylet/node_manager.h:144``) with its LocalTaskManager
(``local_task_manager.cc:57 QueueAndScheduleTask`` / ``:99 Dispatch``),
WorkerPool (``worker_pool.h:156``, ``:413 StartWorkerProcess``) and
PlacementGroupResourceManager (2PC prepare/commit,
``placement_group_resource_manager.cc``).

Scheduling follows the reference's worker-lease protocol
(``direct_task_transport.cc:325 RequestNewWorkerIfNeeded``): submitters ask
for a worker lease carrying the task's resource shape; the node manager
grants a (possibly newly forked) worker once resources are free; the
submitter then pushes tasks DIRECTLY to the worker — the node manager is
not on the per-task hot path — and returns the lease when its queue drains.
"""

from __future__ import annotations

import asyncio
import logging
import os
import signal
import subprocess
import sys
import time
from typing import Dict, List, Optional, Tuple

from ray_tpu_torch._private import protocol
from ray_tpu_torch._private.config import Config
from ray_tpu_torch._private.ids import NodeID, WorkerID

logger = logging.getLogger(__name__)


class ResourceSet:
    """Fixed-point-free float resource arithmetic (the reference uses
    fixed-point FixedPoint in cluster_resource_data.cc; floats with an
    epsilon are sufficient here)."""

    EPS = 1e-9

    def __init__(self, resources: Dict[str, float]):
        self.total = dict(resources)
        self.available = dict(resources)

    def fits(self, demand: Dict[str, float]) -> bool:
        return all(self.available.get(k, 0.0) + self.EPS >= v
                   for k, v in demand.items())

    def feasible(self, demand: Dict[str, float]) -> bool:
        return all(self.total.get(k, 0.0) + self.EPS >= v
                   for k, v in demand.items())

    def acquire(self, demand: Dict[str, float]) -> bool:
        if not self.fits(demand):
            return False
        for k, v in demand.items():
            self.available[k] = self.available.get(k, 0.0) - v
        return True

    def release(self, demand: Dict[str, float]) -> None:
        for k, v in demand.items():
            self.available[k] = min(self.total.get(k, 0.0),
                                    self.available.get(k, 0.0) + v)


class WorkerHandle:
    __slots__ = ("worker_id", "pid", "address", "conn", "proc", "state",
                 "actor_id", "lease_id", "started_at", "gpu_grant",
                 "gpus", "_actor_resources", "_actor_bundle",
                 "oom_killed")

    def __init__(self, worker_id: bytes, proc: subprocess.Popen):
        self.worker_id = worker_id
        self.pid = proc.pid
        self.proc = proc
        self.address = ""
        self.conn: Optional[protocol.Connection] = None
        self.state = "starting"  # starting|idle|leased|actor|dead
        self.actor_id: bytes = b""
        self.lease_id: int = 0
        self.started_at = time.monotonic()
        self.gpu_grant = 0.0
        self.gpus: List[int] = []
        self._actor_resources = None
        self._actor_bundle = None
        self.oom_killed = False


def pick_gpus(free: List[int], need: int) -> List[int]:
    """Card selection by the JAX package's chip rule (``pick_tpu_chips``):
    prefer a CONTIGUOUS run of indices, so a multi-card grant takes
    neighbouring cards, and the SMALLEST adequate run, to keep large
    runs intact for future big grants (best-fit, like the allocator in
    objstore.cc).  Falls back to the lowest free indices when no
    contiguous run exists."""
    if need <= 0 or not free:
        return []
    runs: List[List[int]] = []
    ordered = sorted(free)
    run = [ordered[0]]
    for c in ordered[1:]:
        if c == run[-1] + 1:
            run.append(c)
        else:
            runs.append(run)
            run = [c]
    runs.append(run)
    fitting = [r for r in runs if len(r) >= need]
    if fitting:
        best = min(fitting, key=len)  # best-fit: smallest adequate run
        # take from the run's tail so the remainder stays contiguous
        # with lower neighbors; for need==1 this carves an endpoint off
        # the smallest run instead of the head of the free list, keeping
        # large contiguous runs intact for future multi-card grants
        return best[len(best) - need:]
    return ordered[:need]  # fragmented: lowest indices


def pick_oom_victim(workers) -> Optional["WorkerHandle"]:
    """Retriable-LIFO worker killing policy (reference:
    worker_killing_policy.h:58 RetriableLIFOWorkerKillingPolicy).

    Leased task workers are preferred over actors (tasks are retried by
    the submitter's existing retry machinery; an actor kill costs a
    restart and loses its state), and within each group the newest
    worker dies first — the oldest work is the most likely to be the
    critical path, and the newest allocation is the most likely cause of
    the memory spike."""
    leased = [w for w in workers if w.state == "leased"]
    if leased:
        # LIFO by lease order, not process start: workers are reused from
        # the idle pool, so started_at can predate the current task by
        # minutes.  lease_id is monotonic per grant.
        return max(leased, key=lambda w: w.lease_id)
    actors = [w for w in workers if w.state == "actor"]
    if actors:
        return max(actors, key=lambda w: w.started_at)
    return None


class LeaseRequest:
    __slots__ = ("resources", "bundle", "future", "scheduling_key")

    def __init__(self, resources, bundle, future, scheduling_key):
        self.resources = resources
        self.bundle = bundle  # (pg_id, bundle_index) or None
        self.future = future
        self.scheduling_key = scheduling_key


class NodeManager:
    def __init__(self, node_id: NodeID, session_dir: str, config: Config,
                 resources: Dict[str, float], object_store_name: str,
                 gcs_address: str, node_address: str = ""):
        self.node_id = node_id
        self.session_dir = session_dir
        self.config = config
        # per-node affinity resource (reference: the automatic
        # ``node:<ip>`` resource, scheduling_resources.cc) — lets a
        # caller pin an actor to THIS node (serve's per-node proxy
        # fleet, log/metrics agents)
        resources = dict(resources)
        resources.setdefault(f"node:{node_id.hex()}", 1.0)
        self.resources = ResourceSet(resources)
        self.object_store_name = object_store_name
        self.gcs_address = gcs_address
        self.node_address = node_address or os.path.join(
            session_dir, "sockets", "node_manager")
        #: Node-local spill directory, shared by every process on the node
        #: (announced in registration replies).
        self.spill_dir = config.spill_dir or os.path.join(session_dir, "spill")
        self.server = protocol.Server()
        self.server.add_routes(self)
        self.server.on_disconnect = self._on_disconnect
        self.gcs_conn: Optional[protocol.Connection] = None

        self.workers: Dict[bytes, WorkerHandle] = {}
        self.idle_workers: List[WorkerHandle] = []
        # Physical card allocator: card indices handed to workers via
        # CUDA_VISIBLE_DEVICES (one process per card, as libtpu forces
        # one per chip in the JAX package: visibility is partitioned,
        # not just counted).
        self._gpus_free: List[int] = list(
            range(int(resources.get("GPU", 0))))
        #: the card each index names: the node's own CUDA_VISIBLE_DEVICES
        #: when it restricts the cards (the count it offers was taken
        #: through it), else the index itself
        visible = [c.strip() for c in os.environ.get(
            "CUDA_VISIBLE_DEVICES", "").split(",") if c.strip()]
        self._gpu_names: List[str] = (
            visible if len(visible) >= len(self._gpus_free)
            else [str(i) for i in self._gpus_free])
        self._worker_registered: Dict[bytes, asyncio.Future] = {}
        #: throttle concurrent worker-process startups (fork + interpreter
        #: boot are CPU-bound; an unbounded gang start starves every
        #: child through registration — reference: worker_pool.cc:224
        #: maximum_startup_concurrency)
        spawn_width = config.max_concurrent_worker_starts or max(
            2, 2 * (os.cpu_count() or 1))
        self._spawn_sem = asyncio.Semaphore(spawn_width)
        self._lease_queue: List[LeaseRequest] = []
        self._lease_counter = 0
        #: monotonic version for resource reports (syncer ordering)
        self._resource_version = 0
        self._resource_push_task: Optional[asyncio.Task] = None
        self._leases: Dict[int, Tuple[WorkerHandle, Dict[str, float],
                                      Optional[Tuple[bytes, int]]]] = {}
        # Core-worker (driver/worker) connections by worker id, for owner
        # object requests (reference: raylet knows local workers' rpc addrs).
        self.owner_conns: Dict[bytes, protocol.Connection] = {}
        # Placement-group bundles: (pg_id, idx) -> ResourceSet carved out of
        # node resources at prepare time.
        self.bundles: Dict[Tuple[bytes, int], ResourceSet] = {}
        self._bundle_committed: Dict[Tuple[bytes, int], bool] = {}
        self._heartbeat_task: Optional[asyncio.Task] = None
        self._closing = False

    # ---- lifecycle -------------------------------------------------------

    async def start(self):
        if self.node_address.startswith("/"):
            await self.server.start_unix(self.node_address)
        else:
            host, port = self.node_address.rsplit(":", 1)
            real = await self.server.start_tcp(host, int(port))
            self.node_address = f"{host}:{real}"
        if self.gcs_address.startswith("/"):
            self.gcs_conn = await protocol.connect_unix(self.gcs_address)
        else:
            host, port = self.gcs_address.rsplit(":", 1)
            self.gcs_conn = await protocol.connect_tcp(host, int(port))
        self.gcs_conn.set_request_handler(self._handle_gcs_request)
        await self.gcs_conn.call("node_register", {
            "node_id": self.node_id.binary(),
            "resources": self.resources.total,
            "address": self.node_address,
            "object_store": self.object_store_name,
        })
        provider_id = os.environ.get("RAY_TPU_PROVIDER_ID", "")
        if provider_id:
            # cloud-provider handshake: the autoscaler's NodeProvider
            # joins its provider ids to cluster NodeIDs through this key
            # (autoscaler/gcp.py internal_id)
            await self.gcs_conn.call("kv_put", {
                "key": f"autoscaler.provider/{provider_id}",
                "value": self.node_id.binary()})
        self._heartbeat_task = asyncio.get_running_loop().create_task(
            self._heartbeat_loop())
        self._log_monitor_task = asyncio.get_running_loop().create_task(
            self._log_monitor_loop())
        self._memory_monitor_task = None
        if self.config.memory_usage_threshold > 0:
            self._memory_monitor_task = asyncio.get_running_loop(
                ).create_task(self._memory_monitor_loop())

    async def _log_monitor_loop(self):
        """Tail this node's worker log files and publish new lines to the
        GCS "logs" channel so drivers can print them (reference:
        _private/log_monitor.py:100 LogMonitor -> GCS pubsub ->
        log_to_driver)."""
        offsets: Dict[str, int] = {}
        log_dir = os.path.join(self.session_dir, "logs")
        short = self.node_id.hex()[:8]
        while not self._closing:
            await asyncio.sleep(0.5)
            try:
                files = [f for f in os.listdir(log_dir)
                         if f.startswith("worker-")] \
                    if os.path.isdir(log_dir) else []
            except OSError:
                continue
            for fname in files:
                path = os.path.join(log_dir, fname)
                try:
                    size = os.path.getsize(path)
                except OSError:
                    continue
                off = offsets.get(fname, 0)
                if size <= off:
                    continue
                cap = 256 * 1024
                try:
                    with open(path, "rb") as f:
                        f.seek(off)
                        chunk = f.read(min(size - off, cap))
                except OSError:
                    continue
                # only publish complete lines; carry partials forward —
                # except a single line larger than the read cap, which is
                # force-flushed (truncated) so tailing can't stall on it
                cut = chunk.rfind(b"\n")
                if cut < 0:
                    if len(chunk) < cap:
                        continue  # partial line still being written
                    cut = len(chunk) - 1
                # Split on \n ONLY (splitlines would also split \r/\v/\f
                # and desync the byte-offset bookkeeping, e.g. on tqdm
                # \r-progress output).  cut+1 keeps the final byte of a
                # force-flushed cap-sized line.
                raw_lines = chunk[:cut + 1].split(b"\n")
                if raw_lines and raw_lines[-1] == b"":
                    raw_lines.pop()  # trailing element after final \n
                # bound the batch WITHOUT skipping: advance the offset
                # only past what is actually published
                if len(raw_lines) > 200:
                    raw_lines = raw_lines[:200]
                    consumed = sum(len(l) + 1 for l in raw_lines)
                    offsets[fname] = off + consumed
                else:
                    offsets[fname] = off + cut + 1
                lines = [l.decode("utf-8", "replace")
                         for l in raw_lines]
                try:
                    await self.gcs_conn.call("sub_publish", {
                        "channel": "logs",
                        "message": {"worker": fname[len("worker-"):-4],
                                    "node": short,
                                    "lines": lines}}, timeout=5.0)
                except Exception:  # noqa: BLE001 - GCS hiccup; retry next tick
                    offsets[fname] = off  # re-send

    async def _heartbeat_loop(self):
        while not self._closing:
            await asyncio.sleep(self.config.heartbeat_interval_s)
            try:
                reply = await self.gcs_conn.call("node_heartbeat", {
                    "node_id": self.node_id.binary(),
                    "resource_version": self._resource_version,
                    "resources_available": self.resources.available,
                    # Queued lease shapes ride the heartbeat so the
                    # autoscaler sees per-node pending demand (reference:
                    # load metrics in the resource usage report consumed by
                    # StandardAutoscaler).
                    "pending_demand": [
                        req.resources for req in self._lease_queue][:100],
                    # Occupancy signal: zero-resource actors (controllers,
                    # job supervisors) hold no resources but must keep
                    # their node alive for the autoscaler.
                    "num_busy_workers": sum(
                        1 for w in self.workers.values()
                        if w.state in ("leased", "actor")),
                }, timeout=5.0)
                if reply.get("reregister"):
                    # GCS lost us (marked dead / restarted): rejoin
                    # (reference: raylet re-registration on GCS restart).
                    await self.gcs_conn.call("node_register", {
                        "node_id": self.node_id.binary(),
                        "resources": self.resources.total,
                        "address": self.node_address,
                        "object_store": self.object_store_name,
                    })
            except Exception:  # noqa: BLE001 - GCS momentarily unreachable
                if self._closing:
                    return

    # ---- OOM defense -----------------------------------------------------
    # Reference: MemoryMonitor (src/ray/common/memory_monitor.h:48) polls
    # node memory and invokes a WorkerKillingPolicy
    # (raylet/worker_killing_policy.h:30,58) that prefers retriable
    # workers, newest first, so forward progress (the oldest work) is
    # preserved and the killed work is re-run by the existing retry
    # machinery.

    def _node_memory_usage(self) -> float:
        """Used-memory fraction of this node (0.0-1.0)."""
        fake = self.config.memory_monitor_fake_usage_path
        if fake:
            try:
                with open(fake) as f:
                    return float(f.read().strip() or 0.0)
            except Exception:  # noqa: BLE001 - not written yet
                return 0.0
        try:
            info = {}
            with open("/proc/meminfo") as f:
                for line in f:
                    name, _, rest = line.partition(":")
                    info[name] = int(rest.split()[0]) * 1024
            total = info.get("MemTotal", 0)
            avail = info.get("MemAvailable", total)
            return 1.0 - avail / total if total else 0.0
        except Exception:  # noqa: BLE001 - non-Linux fallback
            return 0.0

    def _pick_oom_victim(self) -> Optional[WorkerHandle]:
        return pick_oom_victim(self.workers.values())

    async def _memory_monitor_loop(self):
        while not self._closing:
            await asyncio.sleep(self.config.memory_monitor_interval_s)
            try:
                usage = self._node_memory_usage()
                if usage < self.config.memory_usage_threshold:
                    continue
                victim = self._pick_oom_victim()
                if victim is None:
                    continue
                victim.oom_killed = True
                logger.warning(
                    "memory usage %.0f%% above threshold %.0f%%: OOM-"
                    "killing worker %s (pid=%d, state=%s) — the task/actor "
                    "will be retried/restarted per its retry policy",
                    usage * 100, self.config.memory_usage_threshold * 100,
                    WorkerID(victim.worker_id), victim.pid, victim.state)
                from ray_tpu_torch._private import events

                events.report_event(
                    "raylet", "WORKER_OOM_KILLED",
                    f"worker {WorkerID(victim.worker_id)} killed at "
                    f"{usage * 100:.0f}% node memory",
                    severity="ERROR", pid=victim.pid, state=victim.state)
                # mark_dead=False: _on_disconnect runs the full cleanup
                # (resource release, actor-death report, lease return) so
                # the kill is indistinguishable from a crash to the retry
                # machinery, except for the recorded OOM cause.
                self._kill_worker_process(victim, mark_dead=False)
                # Give the kill time to actually free memory before
                # considering another victim.
                await asyncio.sleep(
                    max(1.0, self.config.memory_monitor_interval_s))
            except Exception:  # noqa: BLE001 - monitor must not die
                if self._closing:
                    return

    async def close(self):
        self._closing = True
        if self._heartbeat_task:
            self._heartbeat_task.cancel()
        if getattr(self, "_log_monitor_task", None):
            self._log_monitor_task.cancel()
        if getattr(self, "_memory_monitor_task", None):
            self._memory_monitor_task.cancel()
        if getattr(self, "_resource_push_task", None):
            self._resource_push_task.cancel()
        # Fail queued lease requests so their handler coroutines (and the
        # remote submitters awaiting them) unwind instead of hanging.
        for req in self._lease_queue:
            if not req.future.done():
                req.future.set_exception(
                    RuntimeError("node shutting down"))
        self._lease_queue.clear()
        for w in list(self.workers.values()):
            self._kill_worker_process(w)
        if self.gcs_conn:
            await self.gcs_conn.close()
        await self.server.close()

    def _kill_worker_process(self, w: WorkerHandle, mark_dead: bool = True):
        """SIGKILL a worker.  ``mark_dead=True`` pre-marks the handle so
        the disconnect handler skips resource release / death reporting
        (callers that do their own cleanup); ``mark_dead=False`` lets
        ``_on_disconnect`` run the full cleanup path."""
        if mark_dead:
            w.state = "dead"
        try:
            w.proc.send_signal(signal.SIGKILL)
        except Exception:  # noqa: BLE001 - already gone
            pass

    # ---- GCS -> node requests -------------------------------------------

    async def _handle_gcs_request(self, method: str, payload):
        handler = getattr(self, "rpc_" + method, None)
        if handler is None:
            raise protocol.RpcError(f"unknown method {method!r}")
        return await handler(self.gcs_conn, payload)

    # ---- worker pool -----------------------------------------------------

    async def _start_worker(self, actor_id: bytes = b"",
                            gpu_grant: float = 0.0) -> WorkerHandle:
        """Fork a worker process (reference: worker_pool.h:413
        StartWorkerProcess). The worker connects back and registers.

        Card visibility is gated by the resource grant — the reference's
        per-worker CUDA_VISIBLE_DEVICES isolation (backend_executor.py:126
        _share_cuda_visible_devices): the variable is set in the new
        interpreter's environment, before anything in it can start CUDA.
        A worker whose task/actor holds no "GPU" resource gets
        CUDA_VISIBLE_DEVICES="", so it can never touch a card.
        """
        async with self._spawn_sem:
            return await self._start_worker_inner(actor_id, gpu_grant)

    async def _start_worker_inner(self, actor_id: bytes = b"",
                                  gpu_grant: float = 0.0) -> WorkerHandle:
        worker_id = WorkerID.from_random()
        env = dict(os.environ)
        gpus: List[int] = []
        if gpu_grant <= 0:
            env["CUDA_VISIBLE_DEVICES"] = ""
        else:
            need = max(1, -int(-gpu_grant // 1))  # ceil
            if len(self._gpus_free) < need:
                self._reclaim_idle_gpus(need)
            if len(self._gpus_free) < need:
                raise RuntimeError(
                    f"no free GPUs for grant {gpu_grant} "
                    f"(free={self._gpus_free})")
            gpus = pick_gpus(self._gpus_free, need)
            for c in gpus:
                self._gpus_free.remove(c)
            env["CUDA_VISIBLE_DEVICES"] = ",".join(
                self._gpu_names[c] for c in gpus)
        env["RAYTPU_GPU_GRANT"] = str(gpu_grant)
        env["RAYTPU_NODE_ADDRESS"] = self.node_address
        if not self.node_address.startswith("/"):
            # TCP cluster: the worker serves task pushes on this node's
            # externally-dialable interface.
            env["RAYTPU_WORKER_BIND_HOST"] = \
                self.node_address.rsplit(":", 1)[0]
        env["RAYTPU_GCS_ADDRESS"] = self.gcs_address
        env["RAYTPU_SESSION_DIR"] = self.session_dir
        env["RAYTPU_OBJECT_STORE"] = self.object_store_name
        env["RAYTPU_WORKER_ID"] = worker_id.hex()
        env["RAYTPU_NODE_ID"] = self.node_id.hex()
        # Make ray_tpu_torch importable in the worker no matter where it
        # runs from.
        import ray_tpu_torch

        pkg_root = os.path.dirname(os.path.dirname(
            os.path.abspath(ray_tpu_torch.__file__)))
        env["PYTHONPATH"] = pkg_root + os.pathsep + env.get("PYTHONPATH", "")
        log_dir = os.path.join(self.session_dir, "logs")
        os.makedirs(log_dir, exist_ok=True)
        out = open(os.path.join(log_dir, f"worker-{worker_id.hex()[:12]}.log"),
                   "ab", buffering=0)
        proc = subprocess.Popen(
            [sys.executable, "-m", "ray_tpu_torch._private.worker_main"],
            env=env, stdout=out, stderr=subprocess.STDOUT,
            start_new_session=False)
        handle = WorkerHandle(worker_id.binary(), proc)
        handle.actor_id = actor_id
        handle.gpu_grant = gpu_grant
        handle.gpus = gpus
        self.workers[worker_id.binary()] = handle
        fut = asyncio.get_running_loop().create_future()
        self._worker_registered[worker_id.binary()] = fut
        try:
            await asyncio.wait_for(fut, self.config.worker_start_timeout_s)
        except asyncio.TimeoutError:
            self._kill_worker_process(handle)
            self._release_gpus(handle)
            raise RuntimeError("worker failed to start in time")
        return handle

    def _release_gpus(self, handle: WorkerHandle) -> None:
        if handle.gpus:
            self._gpus_free.extend(handle.gpus)
            handle.gpus = []

    def _reclaim_idle_gpus(self, need: int) -> None:
        """Free cards held by idle pooled GPU workers by retiring them
        (their CUDA context keeps the card's memory while alive)."""
        for w in list(self.idle_workers):
            if len(self._gpus_free) >= need:
                break
            if w.gpus:
                self.idle_workers.remove(w)
                self._kill_worker_process(w)
                self._release_gpus(w)

    async def rpc_ping(self, conn, payload):
        """GCS liveness probe: answered as soon as the event loop drains
        — proves the process is alive even when the heartbeat task is
        starved behind a task-RPC flood (see GCS._monitor_loop)."""
        return True

    async def rpc_register_worker(self, conn, payload):
        worker_id = payload["worker_id"]
        handle = self.workers.get(worker_id)
        if handle is None:
            raise ValueError("unknown worker")
        handle.conn = conn
        handle.address = payload["address"]
        handle.state = "idle"
        conn._nm_worker_id = worker_id
        self.owner_conns[worker_id] = conn
        fut = self._worker_registered.pop(worker_id, None)
        if fut is not None and not fut.done():
            fut.set_result(handle)
        return {"node_id": self.node_id.binary()}

    async def rpc_register_core_worker(self, conn, payload):
        """Driver (or any non-pooled core worker) registers as an owner so
        the node manager can route object requests back to it."""
        self.owner_conns[payload["worker_id"]] = conn
        conn._nm_owner_id = payload["worker_id"]
        return {"node_id": self.node_id.binary(),
                "object_store": self.object_store_name,
                "spill_dir": self.spill_dir}

    def _on_disconnect(self, conn):
        worker_id = getattr(conn, "_nm_worker_id", None)
        owner_id = getattr(conn, "_nm_owner_id", None)
        if owner_id is not None:
            self.owner_conns.pop(owner_id, None)
        if worker_id is None:
            return
        self.owner_conns.pop(worker_id, None)
        handle = self.workers.pop(worker_id, None)
        if handle is None or self._closing:
            return
        prev_state = handle.state
        handle.state = "dead"
        if handle in self.idle_workers:
            self.idle_workers.remove(handle)
        self._release_gpus(handle)
        try:
            handle.proc.kill()
        except Exception:  # noqa: BLE001
            pass
        if prev_state == "leased" and handle.lease_id in self._leases:
            _, res, bundle = self._leases.pop(handle.lease_id)
            self._release(res, bundle)
            self._pump_leases()
        if prev_state == "actor" and handle.actor_id:
            res = getattr(handle, "_actor_resources", None)
            if res:
                self._release(res, getattr(handle, "_actor_bundle", None))
                self._pump_leases()
            cause = (f"worker process {handle.pid} OOM-killed by the "
                     f"memory monitor" if handle.oom_killed
                     else f"worker process {handle.pid} died")
            asyncio.get_running_loop().create_task(self._report_actor_death(
                handle.actor_id, cause))
        logger.warning("worker %s died (state=%s%s)", WorkerID(worker_id),
                       prev_state, ", oom" if handle.oom_killed else "")

    async def _report_actor_death(self, actor_id: bytes, cause: str):
        try:
            await self.gcs_conn.call("actor_report_death",
                                     {"actor_id": actor_id, "cause": cause})
        except Exception:  # noqa: BLE001
            pass

    # ---- resource acquire/release across node + bundles ------------------

    def _rset(self, bundle: Optional[Tuple[bytes, int]]) -> Optional[ResourceSet]:
        if bundle is None:
            return self.resources
        return self.bundles.get(bundle)

    def _acquire(self, resources, bundle) -> bool:
        rset = self._rset(bundle)
        if rset is None:
            return False
        ok = rset.acquire(resources)
        if ok and resources:
            self._resources_changed()
        return ok

    def _release(self, resources, bundle):
        rset = self._rset(bundle)
        if rset is not None:
            rset.release(resources)
            if resources:
                self._resources_changed()

    # ---- resource syncer (reference: ray_syncer.h — versioned,
    # push-on-change resource reports layered over the heartbeat poll) ---

    def _resources_changed(self) -> None:
        """Bump the report version and schedule a debounced push so the
        GCS's view goes stale by at most resource_report_debounce_s
        instead of a full heartbeat interval."""
        self._resource_version += 1
        if self._resource_push_task is None or \
                self._resource_push_task.done():
            try:
                loop = asyncio.get_running_loop()
            except RuntimeError:
                return  # not on the manager loop (tests poking directly)
            self._resource_push_task = loop.create_task(
                self._push_resource_update())

    async def _push_resource_update(self):
        # loop: changes landing while the RPC is in flight would otherwise
        # be dropped (no new task is scheduled while this one runs) and go
        # stale until the next heartbeat
        while not self._closing and self.gcs_conn is not None:
            await asyncio.sleep(self.config.resource_report_debounce_s)
            if self._closing or self.gcs_conn is None:
                return
            sent = self._resource_version
            try:
                await self.gcs_conn.call("node_resource_update", {
                    "node_id": self.node_id.binary(),
                    "resource_version": sent,
                    "resources_available": self.resources.available,
                }, timeout=5.0)
            except Exception:  # noqa: BLE001 - heartbeat is the fallback
                return
            if self._resource_version == sent:
                return

    # ---- lease protocol --------------------------------------------------

    async def rpc_request_worker_lease(self, conn, payload):
        """Grant a worker lease once resources are available (reference:
        NodeManager::HandleRequestWorkerLease node_manager.cc:1842 ->
        LocalTaskManager dispatch)."""
        resources = payload.get("resources", {"CPU": 1.0})
        bundle = None
        if payload.get("pg_id"):
            bundle = (payload["pg_id"], payload.get("bundle_index", 0))
        fut = asyncio.get_running_loop().create_future()
        req = LeaseRequest(resources, bundle, fut,
                           payload.get("scheduling_key", b""))
        rset = self._rset(bundle)
        if rset is None:
            raise ValueError("unknown placement group bundle")
        if not rset.feasible(resources):
            if bundle is None:
                # Spillback: point the submitter at a node where the shape
                # fits (reference: the Spillback reply with
                # retry_at_raylet_address, direct_task_transport.cc:473).
                # With a live autoscaler, cluster-wide-infeasible shapes
                # are retried for a grace window (the GCS records them as
                # unschedulable demand and a node may be launching right
                # now); without one they fail fast.
                deadline = time.monotonic() + \
                    self.config.infeasible_lease_grace_s
                while True:
                    try:
                        pick = await self.gcs_conn.call(
                            "pick_node_for_lease",
                            {"resources": resources,
                             "exclude": self.node_id.binary()}, timeout=10.0)
                    except Exception:  # noqa: BLE001 - GCS unreachable
                        pick = None
                    if pick is not None:
                        return {"spillback": pick["address"]}
                    if time.monotonic() > deadline or \
                            not await self._autoscaler_alive():
                        break
                    await asyncio.sleep(1.0)
            raise ValueError(
                f"infeasible resource request {resources}; node has "
                f"{rset.total}")
        self._lease_queue.append(req)
        self._pump_leases()
        return await fut

    async def _autoscaler_alive(self) -> bool:
        """True when an autoscaler heartbeat landed in GCS KV recently."""
        try:
            raw = await self.gcs_conn.call(
                "kv_get", {"key": "__autoscaler_alive"}, timeout=5.0)
            return raw is not None and \
                time.time() - float(raw.decode()) < 30.0
        except Exception:  # noqa: BLE001 - GCS unreachable
            return False

    def _pump_leases(self):
        """Grant every queued lease that fits current availability."""
        if self._closing:
            return
        remaining: List[LeaseRequest] = []
        for req in self._lease_queue:
            if req.future.cancelled():
                continue
            if self._acquire(req.resources, req.bundle):
                asyncio.get_running_loop().create_task(self._grant(req))
            else:
                remaining.append(req)
        self._lease_queue = remaining

    async def _grant(self, req: LeaseRequest):
        try:
            want_gpu = req.resources.get("GPU", 0.0)
            need_gpus = max(1, -int(-want_gpu // 1)) if want_gpu > 0 else 0
            handle = None
            for i, w in enumerate(self.idle_workers):
                # pooled workers are reusable only within their GPU-
                # visibility class (a CPU-gated process can't serve a GPU
                # task and vice versa), and only with the same card set
                # size (visibility is fixed at process start)
                if (w.gpu_grant > 0) == (want_gpu > 0) and \
                        len(w.gpus) == need_gpus:
                    handle = self.idle_workers.pop(i)
                    break
            if handle is None:
                handle = await self._start_worker(gpu_grant=want_gpu)
                if handle.state != "idle":
                    raise RuntimeError("worker died during startup")
            self._lease_counter += 1
            lease_id = self._lease_counter
            handle.state = "leased"
            handle.lease_id = lease_id
            self._leases[lease_id] = (handle, req.resources, req.bundle)
            if not req.future.done():
                req.future.set_result({
                    "lease_id": lease_id,
                    "worker_id": handle.worker_id,
                    "address": handle.address,
                })
            else:  # caller gave up while we were starting the worker
                self._return_lease(lease_id)
        except Exception as e:  # noqa: BLE001 - propagate to requester
            self._release(req.resources, req.bundle)
            if not req.future.done():
                req.future.set_exception(e)

    def _return_lease(self, lease_id: int):
        entry = self._leases.pop(lease_id, None)
        if entry is None:
            return
        handle, resources, bundle = entry
        self._release(resources, bundle)
        if handle.state == "leased":
            handle.state = "idle"
            handle.lease_id = 0
            self.idle_workers.append(handle)
        self._pump_leases()

    async def rpc_return_worker(self, conn, payload):
        self._return_lease(payload["lease_id"])
        return True

    # ---- actors ----------------------------------------------------------

    async def rpc_create_actor(self, conn, payload):
        """GCS asks this node to create an actor: dedicated worker process,
        resources held for the actor's lifetime."""
        spec = payload["spec"]
        resources = spec.get("resources", {})
        bundle = None
        if spec.get("placement_group_id"):
            idx = spec.get("bundle_index", -1)
            bundle = (spec["placement_group_id"], idx if idx >= 0 else 0)
        deadline = time.monotonic() + self.config.worker_start_timeout_s
        while not self._acquire(resources, bundle):
            if time.monotonic() > deadline:
                raise RuntimeError(
                    f"timed out acquiring actor resources {resources}")
            await asyncio.sleep(0.02)
        try:
            handle = await self._start_worker(
                actor_id=payload["actor_id"],
                gpu_grant=resources.get("GPU", 0.0))
            handle.state = "actor"
            handle.actor_id = payload["actor_id"]
            handle._actor_resources = resources
            handle._actor_bundle = bundle
            reply = await handle.conn.call("become_actor", {
                "actor_id": payload["actor_id"], "spec": spec})
            if not reply.get("ok", False):
                self._kill_worker_process(handle)
                raise RuntimeError(
                    "actor constructor failed: " + reply.get("error", "?"))
            return {"worker_id": handle.worker_id, "address": handle.address}
        except Exception:
            self._release(resources, bundle)
            raise

    async def rpc_kill_worker(self, conn, payload):
        handle = self.workers.get(payload["worker_id"])
        if handle is None:
            return False
        # mark_dead=False: the disconnect handler must release the
        # worker's lease/actor resources and report actor death (which
        # drives restart when the kill allows it).
        self._kill_worker_process(handle, mark_dead=False)
        return True

    # ---- placement group bundles (2PC) -----------------------------------

    async def rpc_pg_prepare_bundle(self, conn, payload):
        key = (payload["pg_id"], payload["bundle_index"])
        resources = payload["resources"]
        if key in self.bundles:
            return True
        if not self.resources.acquire(resources):
            raise RuntimeError("insufficient resources for bundle")
        self.bundles[key] = ResourceSet(resources)
        self._bundle_committed[key] = False
        return True

    async def rpc_pg_commit_bundle(self, conn, payload):
        key = (payload["pg_id"], payload["bundle_index"])
        if key not in self.bundles:
            raise RuntimeError("bundle not prepared")
        self._bundle_committed[key] = True
        return True

    async def rpc_pg_return_bundle(self, conn, payload):
        key = (payload["pg_id"], payload["bundle_index"])
        rset = self.bundles.pop(key, None)
        self._bundle_committed.pop(key, None)
        if rset is not None:
            self.resources.release(rset.total)
            self._pump_leases()
        return True

    # ---- object plane ----------------------------------------------------

    async def rpc_ref_borrow(self, conn, payload):
        """Route a borrower's acquire/release to the owner core worker on
        this node (reference analog: the owner-addressed borrow messages of
        the reference_count.h borrowing protocol)."""
        return await self._route_to_owner("ref_borrow", payload)

    async def rpc_object_unavailable(self, conn, payload):
        """Route a borrower's lost-object report to the owner (triggers
        lineage reconstruction there)."""
        return await self._route_to_owner("object_unavailable", payload)

    async def _route_to_owner(self, method: str, payload) -> bool:
        owner_conn = self.owner_conns.get(payload["owner"])
        if owner_conn is None or owner_conn.closed:
            return False  # owner gone; its objects die with it anyway
        try:
            await owner_conn.call(method, payload)
        except Exception:  # noqa: BLE001 - owner exiting
            return False
        return True

    async def rpc_pull_object(self, conn, payload):
        """Make an object available in the local shared-memory store.

        Local-owner path: ask the owner core worker to write the value into
        the store (owners keep small objects in their in-process memory
        store; reference analog: plasma promotion of inlined objects).
        Remote-node path (multi-node): fetch chunks from the remote node
        manager (reference: ObjectManager push/pull, object_manager.h:117).
        """
        oid = payload["oid"]
        owner = payload.get("owner", b"")
        owner_conn = self.owner_conns.get(owner)
        if owner_conn is not None and not owner_conn.closed:
            reply = await owner_conn.call("promote_object", {"oid": oid})
            return reply
        remote_addr = payload.get("owner_node_address", "")
        if remote_addr and remote_addr != self.node_address:
            return await self._pull_remote(oid, remote_addr)
        raise RuntimeError(
            f"cannot resolve object owner for {oid.hex()[:16]}")

    def _store(self):
        """Lazily-opened long-lived store client + spill manager for the
        node manager's own object serving."""
        from ray_tpu_torch._private.object_store import ObjectStoreClient
        from ray_tpu_torch._private.spill import SpillManager

        if not hasattr(self, "_store_client"):
            self._store_client = ObjectStoreClient(self.object_store_name)
            self._spill = SpillManager(self._store_client, self.spill_dir)
        return self._store_client

    async def _spill_op(self, fn, *args):
        """Run a spill-manager call from this event loop.  Remote spill
        backends (kv://, s3://) block on network/RPC — and kv:// rides
        the GCS, which on a head node shares THIS loop — so remote ops
        hop to an executor thread; local-disk ops stay inline."""
        self._store()
        if self._spill.is_remote:
            return await asyncio.get_running_loop().run_in_executor(
                None, fn, *args)
        return fn(*args)

    async def _pull_remote(self, oid: bytes, remote_addr: str):
        """Cross-node transfer: stream the object from the remote node
        manager into the local store in bounded chunks with admission
        control (reference: ObjectManager chunked pull,
        pull_manager.h:48 / object_buffer_pool.cc).  Large objects never
        occupy one RPC frame, so a multi-GiB transfer neither hits the
        4-byte frame cap nor head-of-line-blocks this loop."""
        from ray_tpu_torch._private.ids import ObjectID
        from ray_tpu_torch._private.object_store import ObjectStoreError

        store = self._store()
        object_id = ObjectID(oid)
        if store.contains(object_id) or await self._spill_op(
                self._spill.contains, oid):
            return {"in_store": True}
        if remote_addr.startswith("/"):
            peer = await asyncio.wait_for(
                protocol.connect_unix(remote_addr), timeout=5.0)
        else:
            host, port = remote_addr.rsplit(":", 1)
            peer = await asyncio.wait_for(
                protocol.connect_tcp(host, int(port)), timeout=5.0)
        try:
            info = await peer.call("object_info", {"oid": oid},
                                   timeout=15.0)
            size = info["size"]
            chunk = self.config.object_transfer_chunk_bytes
            try:
                view = store.create(object_id, size)
            except ObjectStoreError:
                if store.contains(object_id):
                    return {"in_store": True}  # concurrent pull won
                raise
            try:
                sem = asyncio.Semaphore(
                    self.config.object_transfer_max_inflight_chunks)

                async def fetch(off: int):
                    async with sem:
                        r = await peer.call("read_object_chunk", {
                            "oid": oid, "off": off,
                            "len": min(chunk, size - off)}, timeout=30.0)
                        view[off:off + len(r["data"])] = r["data"]

                tasks = [asyncio.ensure_future(fetch(off))
                         for off in range(0, size, chunk)]
                try:
                    await asyncio.gather(*tasks)
                except BaseException:
                    # Cancel the siblings BEFORE releasing the view, or a
                    # straggler faults writing into released memory.
                    for t in tasks:
                        t.cancel()
                    await asyncio.gather(*tasks, return_exceptions=True)
                    raise
            except BaseException:
                store.abort(object_id)
                raise
            finally:
                view.release()
            store.seal(object_id)
            return {"in_store": True}
        finally:
            await peer.close()

    async def rpc_object_info(self, conn, payload):
        """Size of a local object (store or spill) for a pulling peer."""
        from ray_tpu_torch._private.ids import ObjectID

        oid = payload["oid"]
        store = self._store()
        buf = store.get(ObjectID(oid), timeout_ms=0)
        if buf is not None:
            with buf:
                return {"size": len(buf.data) + len(buf.metadata)}
        size = await self._spill_op(self._spill.size, oid)
        if size is not None:
            return {"size": size}
        # Brief wait: the pull can race the producer's seal.
        buf = store.get(ObjectID(oid), timeout_ms=5000)
        if buf is None:
            raise RuntimeError("object not in store")
        with buf:
            return {"size": len(buf.data) + len(buf.metadata)}

    async def rpc_read_object_chunk(self, conn, payload):
        """Serve one chunk of an object's payload (data ++ metadata)."""
        from ray_tpu_torch._private.ids import ObjectID

        oid, off, length = payload["oid"], payload["off"], payload["len"]
        store = self._store()
        buf = store.get(ObjectID(oid), timeout_ms=0)
        if buf is not None:
            with buf:
                # Slice without materializing the whole payload: the
                # payload is data ++ metadata as two shm views.
                d = len(buf.data)
                parts = []
                if off < d:
                    parts.append(bytes(buf.data[off:min(d, off + length)]))
                if off + length > d:
                    parts.append(bytes(
                        buf.metadata[max(0, off - d):off + length - d]))
                return {"data": b"".join(parts)}
        data = await self._spill_op(self._spill.read_range, oid, off,
                                    length)
        if data is not None:
            return {"data": data}
        raise RuntimeError("object no longer in store")

    async def rpc_read_object(self, conn, payload):
        """Whole-object read (small objects / compatibility path)."""
        from ray_tpu_torch._private.ids import ObjectID

        oid = payload["oid"]
        store = self._store()
        buf = store.get(ObjectID(oid), timeout_ms=5000)
        if buf is not None:
            with buf:
                return {"data": bytes(buf.data) + bytes(buf.metadata)}
        data = await self._spill_op(self._spill.read, oid)
        if data is None:
            raise RuntimeError("object not in store")
        return {"data": data}

    # ---- introspection ---------------------------------------------------

    async def rpc_node_stats(self, conn, payload):
        try:
            store_stats = self._store().stats()
            spilled = await self._spill_op(self._spill.list)
        except Exception:  # noqa: BLE001 - store mid-teardown
            store_stats, spilled = {}, []
        return {
            "node_id": self.node_id.binary(),
            "resources_total": self.resources.total,
            "resources_available": self.resources.available,
            "num_workers": len(self.workers),
            "num_idle": len(self.idle_workers),
            "pending_leases": len(self._lease_queue),
            "object_store": store_stats,
            "spilled_objects": len(spilled),
            "spilled_bytes": sum(s for _, s in spilled),
            "bundles": [
                {"pg_id": k[0], "index": k[1], "resources": v.total,
                 "committed": self._bundle_committed.get(k, False)}
                for k, v in self.bundles.items()],
        }

    async def rpc_shutdown_node(self, conn, payload):
        """Kill this node (chaos tooling: the reference's
        `ray kill-random-node`, scripts.py:1269).  SIGKILL-style: worker
        processes die; the GCS notices via disconnect/heartbeat."""
        asyncio.get_running_loop().call_later(0.05, self._die,
                                              payload.get("exit", True))
        return True

    def _die(self, hard_exit: bool):
        for w in list(self.workers.values()):
            self._kill_worker_process(w)
        if hard_exit and os.environ.get("RAYTPU_NODE_PROCESS"):
            os._exit(1)
        asyncio.get_running_loop().create_task(self.close())
