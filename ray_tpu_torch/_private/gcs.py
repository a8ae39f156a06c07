"""GCS (Global Control Service): cluster metadata authority.

Role-equivalent of the reference's GCS server (reference
``src/ray/gcs/gcs_server/gcs_server.cc:118`` initializes node / actor / job /
KV / placement-group managers). Here it is an asyncio service speaking the
framed msgpack RPC protocol; node managers hold a persistent bidirectional
connection (registered at ``node.register``) that the GCS uses for outbound
scheduling commands — the role of the reference's gRPC client pool back to
raylets (``gcs_actor_scheduler.cc:84 LeaseWorkerFromNode``).

Services & method namespaces:
    kv.*      internal key-value store (function table, named config; the
              reference's GcsKVManager / internal KV, gcs_utils.py:226)
    node.*    node registry + resource view + heartbeats
              (GcsNodeManager / GcsHeartbeatManager / GcsResourceManager)
    job.*     job id allocation (GcsJobManager)
    actor.*   actor lifecycle: register, schedule on a node, restart on
              death, named lookup, kill (GcsActorManager,
              gcs_actor_manager.cc:448 RegisterActor)
    pg.*      placement groups: gang reservation across nodes
              (GcsPlacementGroupManager; 2PC prepare/commit like
              gcs_placement_group_scheduler.h:103)
    sub.*     pubsub channels: actor updates, node updates, logs, errors
              (the reference's GCS pubsub hub, src/ray/pubsub/)
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import Any, Dict, List, Optional, Set, Tuple

from ray_tpu_torch._private import protocol
from ray_tpu_torch._private.ids import ActorID, JobID, NodeID, PlacementGroupID

logger = logging.getLogger(__name__)

# Actor lifecycle states (reference: rpc::ActorTableData state machine).
DEPENDENCIES_UNREADY = "DEPENDENCIES_UNREADY"
PENDING_CREATION = "PENDING_CREATION"
ALIVE = "ALIVE"
RESTARTING = "RESTARTING"
DEAD = "DEAD"


class ActorInfo:
    __slots__ = (
        "actor_id", "name", "state", "node_id", "worker_id", "address",
        "spec", "resources", "max_restarts", "num_restarts", "death_cause",
        "lifetime_detached", "placement_group_id", "bundle_index",
        "creation_attempts",
    )

    def __init__(self, actor_id: bytes, spec: dict, name: str,
                 resources: Dict[str, float], max_restarts: int,
                 lifetime_detached: bool,
                 placement_group_id: bytes = b"", bundle_index: int = -1):
        self.actor_id = actor_id
        self.name = name
        self.state = PENDING_CREATION
        self.node_id: bytes = b""
        self.worker_id: bytes = b""
        self.address: str = ""
        self.spec = spec
        self.resources = resources
        self.max_restarts = max_restarts
        self.num_restarts = 0
        self.death_cause = ""
        self.lifetime_detached = lifetime_detached
        self.creation_attempts = 0
        self.placement_group_id = placement_group_id
        self.bundle_index = bundle_index

    def public(self) -> dict:
        return {
            "actor_id": self.actor_id,
            "name": self.name,
            "state": self.state,
            "node_id": self.node_id,
            "address": self.address,
            "num_restarts": self.num_restarts,
            "max_restarts": self.max_restarts,
            "death_cause": self.death_cause,
            "resources": self.spec.get("resources", {}),
        }


class NodeInfo:
    __slots__ = ("node_id", "conn", "resources_total", "resources_available",
                 "address", "object_store_name", "last_heartbeat", "alive",
                 "labels", "pending_demand", "num_busy_workers",
                 "resource_version", "probe_renewals")

    def __init__(self, node_id: bytes, conn: protocol.Connection,
                 resources: Dict[str, float], address: str,
                 object_store_name: str, labels: Dict[str, str]):
        self.node_id = node_id
        self.conn = conn
        self.resources_total = dict(resources)
        self.resources_available = dict(resources)
        self.address = address
        self.object_store_name = object_store_name
        self.last_heartbeat = time.monotonic()
        self.alive = True
        #: consecutive liveness windows renewed by ping probe alone —
        #: bounded so a wedged heartbeat task can't stay "alive" with
        #: permanently stale resource reports
        self.probe_renewals = 0
        self.labels = labels
        #: queued lease shapes from the node's last heartbeat (autoscaler
        #: demand signal).
        self.pending_demand: List[Dict[str, float]] = []
        #: leased/actor workers on the node (autoscaler occupancy signal —
        #: zero-resource actors must block idle scale-down).
        self.num_busy_workers = 0
        #: last applied resource-report version (reference: RaySyncer
        #: versioned snapshots, ray_syncer.h — late/out-of-order reports
        #: must not overwrite newer state).
        self.resource_version = -1


class PlacementGroupInfo:
    __slots__ = ("pg_id", "name", "bundles", "strategy", "state",
                 "bundle_nodes", "creator_conn")

    def __init__(self, pg_id: bytes, name: str, bundles: List[Dict[str, float]],
                 strategy: str):
        self.pg_id = pg_id
        self.name = name
        self.bundles = bundles
        self.strategy = strategy
        self.state = "PENDING"
        self.bundle_nodes: List[bytes] = [b""] * len(bundles)

    def public(self) -> dict:
        return {"pg_id": self.pg_id, "name": self.name, "bundles": self.bundles,
                "strategy": self.strategy, "state": self.state,
                "bundle_nodes": self.bundle_nodes}


class _WAL:
    """Append-only write-ahead log between snapshots (reference: the
    continuous persistence a Redis-backed GCS store gives,
    store_client/redis_store_client.h:28 — collapsed to a local
    length-prefixed record file).  Records are flushed per append, so a
    killed GCS process loses nothing it acknowledged; a torn tail
    record (killed mid-write) is detected by its length prefix and
    dropped on replay."""

    def __init__(self, path: str):
        self.path = path
        self._f = None

    def append(self, rec: tuple) -> None:
        import pickle
        import struct

        if self._f is None:
            self._f = open(self.path, "ab")
        data = pickle.dumps(rec)
        self._f.write(struct.pack("<I", len(data)) + data)
        self._f.flush()

    def replay(self):
        import os
        import pickle
        import struct

        if not os.path.exists(self.path):
            return
        with open(self.path, "rb") as f:
            while True:
                header = f.read(4)
                if len(header) < 4:
                    return
                (n,) = struct.unpack("<I", header)
                data = f.read(n)
                if len(data) < n:
                    return  # torn tail record: drop
                try:
                    yield pickle.loads(data)
                except Exception:  # noqa: BLE001 - corrupt tail
                    return

    def reset(self) -> None:
        """Truncate after a successful snapshot (its contents are now
        folded into the snapshot)."""
        import os

        if self._f is not None:
            self._f.close()
            self._f = None
        try:
            os.unlink(self.path)
        except OSError:
            pass

    # -- snapshot coordination (crash-safe in every window) -------------
    # rotate(): called on the loop at state-capture time — records so
    # far move to <path>.old, new appends land in a fresh file.
    # commit_rotation(): snapshot write succeeded; the .old records are
    # folded in, delete them.  abort_rotation(): write failed; splice
    # the fresh records back onto .old so nothing is lost.
    # Replay order (.old then current) makes every crash window safe;
    # records are idempotent so a crash between snapshot-rename and
    # commit_rotation only causes a harmless double-apply.

    def rotate(self) -> None:
        import os

        if self._f is not None:
            self._f.close()
            self._f = None
        if os.path.exists(self.path):
            os.replace(self.path, self.path + ".old")

    def commit_rotation(self) -> None:
        import os

        try:
            os.unlink(self.path + ".old")
        except OSError:
            pass

    def abort_rotation(self) -> None:
        import os

        old = self.path + ".old"
        if not os.path.exists(old):
            return
        if self._f is not None:
            self._f.close()
            self._f = None
        with open(old, "ab") as dst:
            try:
                with open(self.path, "rb") as src:
                    dst.write(src.read())
            except OSError:
                pass
        os.replace(old, self.path)

    def replay_all(self):
        """Yield .old records (pre-rotation, possibly mid-snapshot
        crash) then current ones."""
        import os

        old = self.path + ".old"
        if os.path.exists(old):
            yield from _WAL(old).replay()
        yield from self.replay()


class GcsServer:
    def __init__(self, heartbeat_timeout_s: float = 30.0,
                 persist_path: str = ""):
        #: Snapshot file for GCS fault tolerance (reference: the pluggable
        #: RedisStoreClient, store_client/redis_store_client.h:28 — here a
        #: local file store; empty = in-memory only).  State is restored
        #: in start_*() and snapshotted after mutations.
        self.persist_path = persist_path
        self.server = protocol.Server()
        self.server.add_routes(self)
        self.server.on_disconnect = self._on_disconnect
        self.kv: Dict[str, bytes] = {}
        self.nodes: Dict[bytes, NodeInfo] = {}
        self.actors: Dict[bytes, ActorInfo] = {}
        self.named_actors: Dict[str, bytes] = {}
        self.placement_groups: Dict[bytes, PlacementGroupInfo] = {}
        self.task_events: List[dict] = []
        self.max_task_events = 20000
        self.named_pgs: Dict[str, bytes] = {}
        self._job_counter = 0
        self._subscribers: Dict[str, Set[protocol.Connection]] = {}
        self._heartbeat_timeout_s = heartbeat_timeout_s
        self._monitor_task: Optional[asyncio.Task] = None
        # Waiters keyed by actor_id for state transitions out of PENDING.
        self._actor_waiters: Dict[bytes, List[asyncio.Future]] = {}
        self._pg_waiters: Dict[bytes, List[asyncio.Future]] = {}
        self._pg_lock = asyncio.Lock()
        #: shape-tuple -> last-seen time of cluster-wide-infeasible lease
        #: shapes (deduped) — the autoscaler's launch trigger.
        self._unschedulable: Dict[Tuple, float] = {}
        #: actor ids with a monitor-initiated scheduling task in flight.
        self._actor_scheduling: Set[bytes] = set()
        #: snapshot throttle: mutators set this; the monitor loop writes.
        self._dirty = False
        #: continuous persistence: every recoverable mutation appends a
        #: WAL record immediately; snapshots fold + truncate it.
        self._wal = _WAL(persist_path + ".wal") if persist_path else None
        self._closing = False

    def _log(self, *rec) -> None:
        if self._wal is not None:
            try:
                self._wal.append(rec)
            except Exception:  # noqa: BLE001 - disk hiccup: snapshot
                # remains the fallback; don't fail the control call
                logger.warning("GCS WAL append failed", exc_info=True)

    async def start_unix(self, path: str):
        self._restore()
        await self.server.start_unix(path)
        self._monitor_task = asyncio.get_running_loop().create_task(
            self._monitor_loop())

    async def start_tcp(self, host: str, port: int) -> int:
        self._restore()
        port = await self.server.start_tcp(host, port)
        self._monitor_task = asyncio.get_running_loop().create_task(
            self._monitor_loop())
        return port

    # ---- fault-tolerance snapshot/restore --------------------------------

    def snapshot(self) -> None:
        """Durably record recoverable control state: KV, job counter,
        named-actor registry + detached actor specs, placement-group
        metadata.  Live node/worker connections are NOT state — nodes
        re-register after a head restart (reference: raylet reconnect on
        GCS failover, test_gcs_fault_tolerance.py)."""
        if not self.persist_path:
            return
        self._write_snapshot(self._capture_state())

    def _capture_state(self) -> dict:
        """Plain-dict copy of recoverable state; runs ON the event loop
        so it is a consistent point-in-time cut."""
        actors = {}
        for aid, a in self.actors.items():
            if not a.lifetime_detached or a.state == DEAD:
                # killed/errored detached actors must STAY dead across
                # restarts (the WAL's detached_actor_dead analog)
                continue
            actors[aid] = {
                "spec": a.spec, "name": a.name,
                "resources": a.resources, "max_restarts": a.max_restarts,
                "placement_group_id": a.placement_group_id,
                "bundle_index": a.bundle_index,
            }
        return {
            "kv": dict(self.kv),
            "job_counter": self._job_counter,
            "detached_actors": actors,
            "placement_groups": {
                pid: {"name": pg.name, "bundles": pg.bundles,
                      "strategy": pg.strategy}
                for pid, pg in self.placement_groups.items()},
        }

    def _write_snapshot(self, state: dict) -> None:
        import os
        import pickle

        tmp = self.persist_path + ".tmp"
        with open(tmp, "wb") as f:
            pickle.dump(state, f)
        os.replace(tmp, self.persist_path)

    def _restore(self) -> None:
        if not self.persist_path:
            return
        import os
        import pickle

        if not os.path.exists(self.persist_path):
            # crashed before the first snapshot: the WAL alone may still
            # carry acknowledged mutations
            self._replay_wal()
            return
        with open(self.persist_path, "rb") as f:
            state = pickle.load(f)
        self.kv = state.get("kv", {})
        self._job_counter = state.get("job_counter", 0)
        for aid, a in state.get("detached_actors", {}).items():
            info = ActorInfo(aid, a["spec"], a["name"], a["resources"],
                             a["max_restarts"], True,
                             a["placement_group_id"], a["bundle_index"])
            # Comes back RESTARTING: the monitor re-schedules it once a
            # node with capacity registers (its old worker died with the
            # old head).
            info.state = RESTARTING
            self.actors[aid] = info
            if a["name"]:
                self.named_actors[a["name"]] = aid
        for pid, p in state.get("placement_groups", {}).items():
            pg = PlacementGroupInfo(pid, p["name"], p["bundles"],
                                    p["strategy"])
            pg.state = "PENDING"  # re-place on the new cluster
            self.placement_groups[pid] = pg
            if p["name"]:
                self.named_pgs[p["name"]] = pid
        logger.info("GCS restored from %s: %d kv keys, %d detached "
                    "actors, %d placement groups", self.persist_path,
                    len(self.kv), len(state.get("detached_actors", {})),
                    len(state.get("placement_groups", {})))
        self._replay_wal()

    def _replay_wal(self) -> None:
        """Fold WAL records newer than the snapshot back in (mutations
        acknowledged between the last snapshot and the crash)."""
        if self._wal is None:
            return
        n = 0
        for rec in self._wal.replay_all():
            n += 1
            kind = rec[0]
            if kind == "kv_put":
                self.kv[rec[1]] = rec[2]
            elif kind == "kv_del":
                self.kv.pop(rec[1], None)
            elif kind == "kv_del_prefix":
                for k in [k for k in self.kv if k.startswith(rec[1])]:
                    del self.kv[k]
            elif kind == "job_counter":
                self._job_counter = max(self._job_counter, rec[1])
            elif kind == "detached_actor":
                aid, a = rec[1], rec[2]
                info = ActorInfo(aid, a["spec"], a["name"],
                                 a["resources"], a["max_restarts"], True,
                                 a["placement_group_id"],
                                 a["bundle_index"])
                info.state = RESTARTING
                self.actors[aid] = info
                if a["name"]:
                    self.named_actors[a["name"]] = aid
            elif kind == "detached_actor_dead":
                info = self.actors.pop(rec[1], None)
                if info is not None and info.name:
                    self.named_actors.pop(info.name, None)
            elif kind == "pg":
                pid, p = rec[1], rec[2]
                pg = PlacementGroupInfo(pid, p["name"], p["bundles"],
                                        p["strategy"])
                pg.state = "PENDING"
                self.placement_groups[pid] = pg
                if p["name"]:
                    self.named_pgs[p["name"]] = pid
            elif kind == "pg_removed":
                pg = self.placement_groups.pop(rec[1], None)
                if pg is not None and pg.name:
                    self.named_pgs.pop(pg.name, None)
        if n:
            logger.info("GCS WAL replay: %d records", n)

    async def close(self):
        self._closing = True
        if self._monitor_task:
            self._monitor_task.cancel()
        await self.server.close()

    # ---- pubsub ----------------------------------------------------------

    def _publish(self, channel: str, payload: Any):
        for conn in list(self._subscribers.get(channel, ())):
            if conn.closed:
                self._subscribers[channel].discard(conn)
                continue
            asyncio.get_running_loop().create_task(
                conn.push("pub." + channel, payload))

    async def rpc_sub_subscribe(self, conn, payload):
        for channel in payload["channels"]:
            self._subscribers.setdefault(channel, set()).add(conn)
        return True

    async def rpc_sub_publish(self, conn, payload):
        self._publish(payload["channel"], payload["message"])
        return True

    # ---- kv --------------------------------------------------------------

    async def rpc_kv_put(self, conn, payload):
        key = payload["key"]
        overwrite = payload.get("overwrite", True)
        if not overwrite and key in self.kv:
            return False
        self.kv[key] = payload["value"]
        self._dirty = True
        self._log("kv_put", key, payload["value"])
        return True

    async def rpc_kv_get(self, conn, payload):
        return self.kv.get(payload["key"])

    async def rpc_kv_multi_get(self, conn, payload):
        return {k: self.kv[k] for k in payload["keys"] if k in self.kv}

    async def rpc_kv_del(self, conn, payload):
        self._dirty = True
        self._log("kv_del", payload["key"])
        return self.kv.pop(payload["key"], None) is not None

    async def rpc_kv_exists(self, conn, payload):
        return payload["key"] in self.kv

    async def rpc_kv_len(self, conn, payload):
        """Value size without the payload (kv:// filesystem size probes
        — a spill stats poll must not move object bytes)."""
        v = self.kv.get(payload["key"])
        return None if v is None else len(v)

    async def rpc_kv_incr(self, conn, payload):
        """Atomic counter (single-threaded event loop = atomicity).  Used
        for collective-group rendezvous generations."""
        key = payload["key"]
        cur = int(self.kv.get(key, b"0"))
        cur += int(payload.get("by", 1))
        self.kv[key] = str(cur).encode()
        self._dirty = True
        self._log("kv_put", key, self.kv[key])
        return cur

    async def rpc_kv_del_prefix(self, conn, payload):
        prefix = payload["prefix"]
        doomed = [k for k in self.kv if k.startswith(prefix)]
        for k in doomed:
            del self.kv[k]
        if doomed:
            self._dirty = True
            self._log("kv_del_prefix", prefix)
        return len(doomed)

    async def rpc_kv_keys(self, conn, payload):
        prefix = payload.get("prefix", "")
        return [k for k in self.kv if k.startswith(prefix)]

    # ---- jobs ------------------------------------------------------------

    async def rpc_job_register(self, conn, payload):
        self._job_counter += 1
        self._dirty = True
        self._log("job_counter", self._job_counter)
        job_id = JobID.from_int(self._job_counter)
        return {"job_id": job_id.binary()}

    # ---- nodes -----------------------------------------------------------

    async def rpc_node_register(self, conn, payload):
        node_id = payload["node_id"]
        info = NodeInfo(node_id, conn, payload["resources"],
                        payload["address"], payload.get("object_store", ""),
                        payload.get("labels", {}))
        self.nodes[node_id] = info
        conn._gcs_node_id = node_id  # for disconnect detection
        self._publish("node", {"event": "added", "node_id": node_id,
                               "resources": payload["resources"],
                               "address": payload["address"]})
        logger.info("node registered: %s %s", NodeID(node_id), payload["address"])
        return True

    def _apply_resource_report(self, info: "NodeInfo", payload) -> bool:
        """Versioned merge of a node resource report (reference: RaySyncer
        reporter/receiver, ray_syncer.h): reports carry the node's
        monotonic version; anything strictly below the last applied
        version is a reordered duplicate and dropped, while same-version
        reports refresh (they reconcile optimistic debits)."""
        version = payload.get("resource_version", None)
        # strictly-older reports are reordered duplicates and dropped;
        # same-version reports are accepted — they are the node's
        # authoritative state and reconcile any optimistic spillback
        # debits applied since (see _debit)
        if version is not None and version < info.resource_version:
            return False
        if version is not None:
            info.resource_version = version
        if "resources_available" in payload:
            info.resources_available = payload["resources_available"]
        return True

    async def rpc_node_heartbeat(self, conn, payload):
        info = self.nodes.get(payload["node_id"])
        if info is None:
            return {"reregister": True}
        info.last_heartbeat = time.monotonic()
        info.probe_renewals = 0  # a REAL heartbeat resets the probe cap
        self._apply_resource_report(info, payload)
        info.pending_demand = payload.get("pending_demand", [])
        info.num_busy_workers = payload.get("num_busy_workers", 0)
        return {"reregister": False}

    async def rpc_node_resource_update(self, conn, payload):
        """Event-driven resource delta pushed on acquire/release, between
        heartbeats — spillback and actor placement then work from
        sub-second-fresh state instead of the heartbeat interval
        (reference: the syncer's push-on-change vs the polling report)."""
        info = self.nodes.get(payload["node_id"])
        if info is None:
            return {"reregister": True}
        self._apply_resource_report(info, payload)
        return {"reregister": False}

    async def rpc_node_list(self, conn, payload):
        return [
            {"node_id": n.node_id, "address": n.address, "alive": n.alive,
             "resources_total": n.resources_total,
             "resources_available": n.resources_available,
             "num_busy_workers": n.num_busy_workers,
             "object_store": n.object_store_name, "labels": n.labels}
            for n in self.nodes.values()
        ]

    async def rpc_node_total_resources(self, conn, payload):
        out: Dict[str, float] = {}
        for n in self.nodes.values():
            if not n.alive:
                continue
            for k, v in n.resources_total.items():
                out[k] = out.get(k, 0.0) + v
        return out

    async def rpc_node_available_resources(self, conn, payload):
        out: Dict[str, float] = {}
        for n in self.nodes.values():
            if not n.alive:
                continue
            for k, v in n.resources_available.items():
                out[k] = out.get(k, 0.0) + v
        return out

    def _on_disconnect(self, conn):
        node_id = getattr(conn, "_gcs_node_id", None)
        if node_id is not None and node_id in self.nodes:
            asyncio.get_running_loop().create_task(self._handle_node_death(node_id))
        for subs in self._subscribers.values():
            subs.discard(conn)

    async def _monitor_loop(self):
        """Mark nodes dead after missed heartbeats (reference:
        GcsHeartbeatManager, gcs_heartbeat_manager.h:36) and retry pending
        placement groups as resources free up (reference:
        GcsPlacementGroupManager::SchedulePendingPlacementGroups)."""
        while True:
            await asyncio.sleep(1.0)
            now = time.monotonic()
            if self._dirty and self.persist_path:
                self._dirty = False
                # Capture ON the loop (consistent cut) and rotate the
                # WAL at the same instant; the slow pickle+write runs on
                # an executor thread.  Success folds the rotated records
                # into the snapshot (delete); failure splices them back.
                state = self._capture_state()
                if self._wal is not None:
                    self._wal.rotate()
                try:
                    await asyncio.get_running_loop().run_in_executor(
                        None, lambda: self._write_snapshot(state))
                    if self._wal is not None:
                        self._wal.commit_rotation()
                except Exception:  # noqa: BLE001 - disk hiccup; retry next tick
                    self._dirty = True
                    if self._wal is not None:
                        self._wal.abort_rotation()
            stale = [(node_id, info)
                     for node_id, info in list(self.nodes.items())
                     if info.alive and now - info.last_heartbeat
                     > self._heartbeat_timeout_s]
            if stale:
                # Active probe before declaring death: on a saturated
                # host the node's heartbeat task can starve behind a
                # task-RPC flood while the process is perfectly alive
                # (observed: 20k queued tasks on one core).  A direct
                # ping rides the same connection and answers as soon as
                # the node's loop drains; only a broken connection or a
                # wedged loop stays silent (reference:
                # gcs_heartbeat_manager declares on timeout alone — its
                # raylet heartbeats from a dedicated thread, which this
                # runtime's asyncio node manager doesn't).  Probes run
                # CONCURRENTLY so N unreachable nodes cost one 10s
                # window, not N.
                async def probe(node_id, info):
                    try:
                        await asyncio.wait_for(info.conn.call("ping", {}),
                                               timeout=10.0)
                        # ping answers prove the loop is alive, but they
                        # must not substitute for real heartbeats forever
                        # — a permanently wedged heartbeat task means the
                        # node's resource/load reports are stale and the
                        # scheduler is flying blind (bounded here)
                        info.probe_renewals = getattr(
                            info, "probe_renewals", 0) + 1
                        if info.probe_renewals >= 10:
                            logger.warning(
                                "node %s: %d consecutive liveness "
                                "windows renewed by ping probe alone "
                                "(heartbeat task wedged?) — declaring "
                                "dead", NodeID(node_id),
                                info.probe_renewals)
                            await self._handle_node_death(node_id)
                            return
                        if info.probe_renewals >= 3:
                            logger.warning(
                                "node %s heartbeats stalled for %d "
                                "windows; ping probe keeping it alive",
                                NodeID(node_id), info.probe_renewals)
                        info.last_heartbeat = time.monotonic()
                    except Exception:  # noqa: BLE001 - dead for real
                        await self._handle_node_death(node_id)

                await asyncio.gather(
                    *(probe(nid, info) for nid, info in stale),
                    return_exceptions=True)
            for pg in list(self.placement_groups.values()):
                if pg.state in ("PENDING", "INFEASIBLE"):
                    async with self._pg_lock:
                        if pg.state not in ("PENDING", "INFEASIBLE"):
                            continue
                        ok = await self._try_place_pg(pg)
                    if ok:
                        for fut in self._pg_waiters.pop(pg.pg_id, []):
                            if not fut.done():
                                fut.set_result(pg.public())
            # Re-place restored detached actors once a feasible node has
            # registered (GCS-restart recovery; reference:
            # GcsActorManager reconstruction on failover).
            for info in list(self.actors.values()):
                if info.placement_group_id:
                    pg = self.placement_groups.get(info.placement_group_id)
                    if pg is None or pg.state != "CREATED":
                        continue  # wait for the PG to re-place first
                if (info.state in (RESTARTING, PENDING_CREATION)
                        and not info.address and not info.node_id
                        and info.actor_id not in self._actor_scheduling
                        and self._pick_node(info.resources) is not None):
                    self._actor_scheduling.add(info.actor_id)

                    async def resched(info=info):
                        try:
                            await self._schedule_actor(info)
                        finally:
                            self._actor_scheduling.discard(info.actor_id)

                    asyncio.get_running_loop().create_task(resched())

    async def _handle_node_death(self, node_id: bytes):
        info = self.nodes.get(node_id)
        if info is None or not info.alive or self._closing:
            return
        info.alive = False
        logger.warning("node dead: %s", NodeID(node_id))
        from ray_tpu_torch._private import events

        events.report_event("gcs", "NODE_DEAD",
                            f"node {NodeID(node_id)} marked dead",
                            severity="ERROR",
                            node_id=NodeID(node_id).hex())
        self._publish("node", {"event": "removed", "node_id": node_id})
        # Restart or fail actors that lived there (reference:
        # GcsActorManager::OnNodeDead, gcs_actor_manager.h:318).
        for actor in list(self.actors.values()):
            if actor.node_id == node_id and actor.state in (ALIVE, PENDING_CREATION,
                                                            RESTARTING):
                await self._handle_actor_failure(actor, "node died")

    async def rpc_task_events_report(self, conn, payload):
        """Profile-event sink (reference: profile events flow into the GCS
        for ray.timeline, core_worker/profiling.cc)."""
        self.task_events.extend(payload["events"])
        if len(self.task_events) > self.max_task_events:
            del self.task_events[:len(self.task_events)
                                 - self.max_task_events // 2]
        return True

    async def rpc_task_events_list(self, conn, payload):
        limit = payload.get("limit", 10000)
        return self.task_events[-limit:]

    async def rpc_pick_node_for_lease(self, conn, payload):
        """Spillback target selection: a node manager that cannot fit a
        lease locally asks where the shape IS feasible (reference:
        hybrid_scheduling_policy.cc:139 Schedule + the Spillback reply in
        node_manager.cc HandleRequestWorkerLease)."""
        exclude = payload.get("exclude", b"")
        resources = payload["resources"]
        candidates = [n for n in self.nodes.values()
                      if n.alive and n.node_id != exclude and all(
                          n.resources_total.get(k, 0.0) >= v
                          for k, v in resources.items())]
        if not candidates:
            # Cluster-wide infeasible: record as unschedulable demand so
            # the autoscaler can launch a node for it.  Deduped by shape —
            # the grace-window retry loop in the node manager re-asks
            # every second and must not multiply one task into N demand
            # entries (reference: LoadMetrics aggregates demand by shape).
            key = tuple(sorted(resources.items()))
            self._unschedulable[key] = time.monotonic()
            return None
        free = [n for n in candidates if all(
            n.resources_available.get(k, 0.0) >= v
            for k, v in resources.items())]
        pool = free or candidates
        best = max(pool, key=lambda n: sum(n.resources_available.values()))
        # Optimistic local debit until the node's next versioned report:
        # N concurrent spillbacks must not all pick the same "most free"
        # node off the same stale snapshot (reference: the cluster
        # resource scheduler's local view is debited at decision time and
        # reconciled by the syncer).
        self._debit(best, resources)
        return {"node_id": best.node_id, "address": best.address}

    @staticmethod
    def _debit(info: "NodeInfo", resources: Dict[str, float]) -> None:
        for k, v in resources.items():
            # clamp at zero: fallback picks from busy nodes must not push
            # user-facing availability aggregates negative
            info.resources_available[k] = max(
                0.0, info.resources_available.get(k, 0.0) - v)

    async def rpc_autoscaler_demand(self, conn, payload):
        """Aggregate demand for the autoscaler: queued lease shapes from
        node heartbeats, recently-unschedulable shapes, and resources of
        actors stuck pending (reference: the load/demand summary the
        monitor feeds StandardAutoscaler.update)."""
        now = time.monotonic()
        horizon = payload.get("horizon_s", 30.0)
        pending: List[Dict[str, float]] = []
        for n in self.nodes.values():
            if n.alive:
                pending.extend(n.pending_demand)
        for a in self.actors.values():
            if a.state == PENDING_CREATION:
                res = a.spec.get("resources", {})
                if res:
                    pending.append(res)
        for key, seen in list(self._unschedulable.items()):
            if now - seen > horizon:
                del self._unschedulable[key]
        return {"pending": pending,
                "infeasible": [dict(k) for k in self._unschedulable]}

    # ---- actors ----------------------------------------------------------

    def _pick_node(self, resources: Dict[str, float],
                   node_id: Optional[bytes] = None) -> Optional[NodeInfo]:
        """Pack-first node selection for actor creation (the reference GCS
        schedules actor-creation via raylet leases with the same hybrid
        policy; we keep a simple best-fit pack here and let the node's local
        manager queue if resources are momentarily busy)."""
        if node_id:
            n = self.nodes.get(node_id)
            return n if n is not None and n.alive else None
        candidates = [n for n in self.nodes.values() if n.alive and all(
            n.resources_total.get(k, 0.0) >= v for k, v in resources.items())]
        if not candidates:
            return None
        # Prefer nodes that currently have the resources free.
        free = [n for n in candidates if all(
            n.resources_available.get(k, 0.0) >= v for k, v in resources.items())]
        pool = free or candidates
        best = max(pool, key=lambda n: sum(n.resources_available.values()))
        self._debit(best, resources)  # see rpc_pick_node_for_lease
        return best

    async def rpc_actor_register(self, conn, payload):
        actor_id = payload["actor_id"]
        name = payload.get("name") or ""
        if name:
            if name in self.named_actors:
                existing = self.actors.get(self.named_actors[name])
                if existing is not None and existing.state != DEAD:
                    raise ValueError(f"actor name {name!r} already taken")
            self.named_actors[name] = actor_id
        spec = payload["spec"]
        pg_id = spec.get("placement_group_id") or b""
        info = ActorInfo(
            actor_id, spec, name, spec.get("resources", {}),
            payload.get("max_restarts", 0),
            payload.get("lifetime") == "detached",
            placement_group_id=pg_id,
            bundle_index=spec.get("bundle_index", -1),
        )
        self.actors[actor_id] = info
        # Fail-fast feasibility check stays SYNCHRONOUS (typo-sized
        # shapes must error at creation), but scheduling + worker spawn
        # run in the background: actor creation returns a handle
        # immediately and method calls park on actor_get_info
        # wait_ready (reference semantics — GcsActorManager schedules
        # async; ray.remote never blocks on the ctor).
        # dead nodes count as feasible: a node of that shape existed and
        # may be replaced (matches _schedule_actor's queue-vs-fail rule)
        if not info.placement_group_id and self.nodes and not any(
                all(n.resources_total.get(k, 0.0) >= v
                    for k, v in info.resources.items())
                for n in self.nodes.values()):
            info.state = DEAD
            info.death_cause = (
                f"actor shape {info.resources} exceeds every registered "
                f"node (cluster: "
                f"{[n.resources_total for n in self.nodes.values()]})")
            self._actor_state_changed(info)
            raise ValueError(info.death_cause)
        if info.lifetime_detached:
            # durably record AFTER the feasibility gate: an errored
            # registration must not resurrect on restart (or squat its
            # name forever)
            self._dirty = True
            self._log("detached_actor", actor_id, {
                "spec": info.spec, "name": info.name,
                "resources": info.resources,
                "max_restarts": info.max_restarts,
                "placement_group_id": info.placement_group_id,
                "bundle_index": info.bundle_index,
            })
        self._actor_scheduling.add(actor_id)

        async def sched(info=info):
            try:
                await self._schedule_actor(info)
            finally:
                self._actor_scheduling.discard(info.actor_id)

        asyncio.get_running_loop().create_task(sched())
        return True

    async def _schedule_actor(self, info: ActorInfo):
        target_node: Optional[bytes] = None
        if info.placement_group_id:
            pg = self.placement_groups.get(info.placement_group_id)
            if pg is None or pg.state != "CREATED":
                info.state = DEAD
                info.death_cause = "placement group not ready"
                self._actor_state_changed(info)
                return
            idx = info.bundle_index if info.bundle_index >= 0 else 0
            target_node = pg.bundle_nodes[idx]
        node = self._pick_node(info.resources, target_node)
        if node is None:
            fits_some_node = any(
                all(n.resources_total.get(k, 0.0) >= v
                    for k, v in info.resources.items())
                for n in self.nodes.values())
            if fits_some_node or not self.nodes:
                # Momentarily unschedulable (resources leased out, node
                # briefly unhealthy, cluster still forming): stay
                # PENDING_CREATION — the monitor loop retries when a
                # node can host it (reference: GcsActorScheduler queues
                # pending actors instead of failing them).  NOT silent:
                # the shape is recorded as unschedulable demand (the
                # autoscaler's launch trigger, so a dead-forever node
                # gets REPLACED rather than the actor hanging) and an
                # event marks the wait.
                shape = tuple(sorted(info.resources.items()))
                first = shape not in self._unschedulable
                self._unschedulable[shape] = time.monotonic()
                if first:
                    from ray_tpu_torch._private import events

                    events.report_event(
                        "gcs", "ACTOR_PENDING_RESOURCES",
                        f"actor {ActorID(info.actor_id)} waiting for "
                        f"{info.resources} (no alive node can host it "
                        f"now; queued for retry + autoscaler demand)",
                        severity="WARNING",
                        actor_id=ActorID(info.actor_id).hex())
                return
            info.state = DEAD
            info.death_cause = (
                f"actor shape {info.resources} exceeds every registered "
                f"node (cluster: "
                f"{[n.resources_total for n in self.nodes.values()]})")
            self._actor_state_changed(info)
            return
        info.node_id = node.node_id
        try:
            reply = await node.conn.call(
                "create_actor",
                {"actor_id": info.actor_id, "spec": info.spec})
            if info.state == DEAD:
                # killed while creation was in flight (creation is
                # async now): the fresh worker must die, not serve
                try:
                    await node.conn.call(
                        "kill_worker",
                        {"worker_id": reply["worker_id"],
                         "actor_id": info.actor_id})
                except Exception:  # noqa: BLE001 - node mid-death
                    pass
                return
            info.worker_id = reply["worker_id"]
            info.address = reply["address"]
            info.state = ALIVE
        except protocol.RpcError as e:
            # The node answered with a failure.  Worker-spawn hiccups
            # (start timeout under load, transient resource contention)
            # are RETRIED on a fresh scheduling pass instead of killing
            # the actor (reference: GcsActorScheduler reschedules on
            # lease/creation failure); a ctor raise is not retriable —
            # re-running user __init__ would duplicate side effects.
            info.creation_attempts += 1
            retriable = "actor constructor failed" not in str(e)
            if retriable and info.creation_attempts <= 5:
                logger.warning(
                    "actor %s creation attempt %d failed (%s); requeued",
                    ActorID(info.actor_id), info.creation_attempts, e)
                info.node_id = b""
                info.address = ""
                return  # monitor loop reschedules PENDING actors
            info.state = DEAD
            info.death_cause = f"creation failed: {e}"
        except Exception as e:  # noqa: BLE001 - transport-level failure
            # AMBIGUOUS window: the node may have received the dispatch
            # and be running the user ctor.  Requeue only when the node
            # is confirmed dead/gone (its workers died with it, so a
            # re-run cannot double-execute); a healthy node whose reply
            # was lost is fail-stop, like the pre-async path.
            node_info = self.nodes.get(info.node_id)
            node_gone = node_info is None or not node_info.alive
            info.creation_attempts += 1
            if node_gone and info.creation_attempts <= 5 \
                    and info.state != DEAD:
                info.node_id = b""
                info.address = ""
                return
            if info.state != DEAD:
                info.state = DEAD
                info.death_cause = f"creation failed: {e}"
        self._actor_state_changed(info)

    def _actor_state_changed(self, info: ActorInfo):
        self._publish("actor", info.public())
        for fut in self._actor_waiters.pop(info.actor_id, []):
            if not fut.done():
                fut.set_result(info.public())

    async def rpc_actor_get_info(self, conn, payload):
        actor_id = payload["actor_id"]
        wait = payload.get("wait_ready", False)
        info = self.actors.get(actor_id)
        if info is None:
            raise ValueError(f"no such actor {ActorID(actor_id)}")
        if wait and info.state in (PENDING_CREATION, RESTARTING):
            fut = asyncio.get_running_loop().create_future()
            self._actor_waiters.setdefault(actor_id, []).append(fut)
            return await fut
        return info.public()

    async def rpc_actor_get_by_name(self, conn, payload):
        actor_id = self.named_actors.get(payload["name"])
        if actor_id is None:
            return None
        info = self.actors.get(actor_id)
        if info is None or info.state == DEAD:
            return None
        return info.public()

    async def rpc_actor_list(self, conn, payload):
        return [a.public() for a in self.actors.values()]

    async def rpc_actor_report_death(self, conn, payload):
        """Node manager reports an actor worker died (reference: raylet
        notifies GCS of worker failure -> GcsActorManager restart logic)."""
        info = self.actors.get(payload["actor_id"])
        if info is None or info.state == DEAD:
            return True
        await self._handle_actor_failure(info, payload.get("cause", "worker died"))
        return True

    async def _handle_actor_failure(self, info: ActorInfo, cause: str):
        if info.state == DEAD:
            return
        unlimited = info.max_restarts == -1
        if unlimited or info.num_restarts < info.max_restarts:
            info.num_restarts += 1
            info.state = RESTARTING
            info.address = ""
            info.node_id = b""  # monitor-loop requeue keys on this
            self._publish("actor", info.public())
            logger.info("restarting actor %s (%d/%s): %s",
                        ActorID(info.actor_id), info.num_restarts,
                        "inf" if unlimited else info.max_restarts, cause)
            from ray_tpu_torch._private import events

            events.report_event(
                "gcs", "ACTOR_RESTART",
                f"actor {ActorID(info.actor_id)} restarting: {cause}",
                severity="WARNING",
                actor_id=ActorID(info.actor_id).hex(),
                restarts=info.num_restarts)
            await self._schedule_actor(info)
        else:
            info.state = DEAD
            info.death_cause = cause
            self._actor_state_changed(info)

    async def rpc_actor_kill(self, conn, payload):
        actor_id = payload["actor_id"]
        info = self.actors.get(actor_id)
        if info is None:
            return False
        no_restart = payload.get("no_restart", True)
        if no_restart:
            info.max_restarts = info.num_restarts  # exhaust restarts
        node = self.nodes.get(info.node_id)
        if node is not None and node.alive and info.worker_id:
            try:
                await node.conn.call("kill_worker",
                                     {"worker_id": info.worker_id,
                                      "actor_id": actor_id})
            except Exception:  # noqa: BLE001 - node may be mid-death
                pass
        if no_restart and info.state != DEAD:
            info.state = DEAD
            info.death_cause = "killed via kill()"
            if info.name:
                self.named_actors.pop(info.name, None)
            if info.lifetime_detached:
                self._dirty = True
                self._log("detached_actor_dead", actor_id)
            self._actor_state_changed(info)
        return True

    # ---- placement groups ------------------------------------------------

    async def rpc_pg_create(self, conn, payload):
        """Gang reservation with 2-phase prepare/commit across node managers
        (reference: GcsPlacementGroupScheduler 2PC,
        gcs_placement_group_scheduler.h:103-105)."""
        pg_id = payload["pg_id"]
        name = payload.get("name") or ""
        pg = PlacementGroupInfo(pg_id, name, payload["bundles"],
                                payload.get("strategy", "PACK"))
        self.placement_groups[pg_id] = pg
        self._dirty = True
        self._log("pg", pg_id, {"name": name,
                                "bundles": payload["bundles"],
                                "strategy": payload.get("strategy",
                                                        "PACK")})
        if name:
            self.named_pgs[name] = pg_id
        async with self._pg_lock:
            ok = await self._try_place_pg(pg)
        if not ok:
            pg.state = "INFEASIBLE" if not self._pg_feasible(pg) else "PENDING"
        for fut in self._pg_waiters.pop(pg_id, []):
            if not fut.done():
                fut.set_result(pg.public())
        return pg.public()

    def _pg_feasible(self, pg) -> bool:
        return all(
            any(n.alive and all(n.resources_total.get(k, 0) >= v
                                for k, v in bundle.items())
                for n in self.nodes.values())
            for bundle in pg.bundles)

    async def _try_place_pg(self, pg: PlacementGroupInfo) -> bool:
        alive = [n for n in self.nodes.values() if n.alive]
        assignment: List[Tuple[int, NodeInfo]] = []
        avail = {n.node_id: dict(n.resources_available) for n in alive}

        def fits(node, bundle):
            return all(avail[node.node_id].get(k, 0.0) >= v
                       for k, v in bundle.items())

        order = sorted(alive, key=lambda n: -sum(n.resources_available.values()))
        for i, bundle in enumerate(pg.bundles):
            placed = False
            if pg.strategy in ("PACK", "STRICT_PACK"):
                candidates = ([assignment[-1][1]] if assignment else order) \
                    if pg.strategy == "STRICT_PACK" else \
                    ([assignment[-1][1]] + order if assignment else order)
            elif pg.strategy in ("SPREAD", "STRICT_SPREAD"):
                used = {n.node_id for _, n in assignment}
                fresh = [n for n in order if n.node_id not in used]
                candidates = fresh + (order if pg.strategy == "SPREAD" else [])
            else:
                candidates = order
            for node in candidates:
                if fits(node, bundle):
                    assignment.append((i, node))
                    for k, v in bundle.items():
                        avail[node.node_id][k] = avail[node.node_id].get(k, 0.0) - v
                    placed = True
                    break
            if not placed:
                return False
        # Phase 1: prepare on each node; Phase 2: commit. Roll back on failure.
        prepared: List[Tuple[int, NodeInfo]] = []
        try:
            for i, node in assignment:
                await node.conn.call("pg_prepare_bundle", {
                    "pg_id": pg.pg_id, "bundle_index": i,
                    "resources": pg.bundles[i]})
                prepared.append((i, node))
            for i, node in prepared:
                await node.conn.call("pg_commit_bundle", {
                    "pg_id": pg.pg_id, "bundle_index": i})
        except Exception:  # noqa: BLE001 - roll back partial prepare
            for i, node in prepared:
                try:
                    await node.conn.call("pg_return_bundle", {
                        "pg_id": pg.pg_id, "bundle_index": i})
                except Exception:  # noqa: BLE001
                    pass
            return False
        for i, node in assignment:
            pg.bundle_nodes[i] = node.node_id
        pg.state = "CREATED"
        self._publish("pg", pg.public())
        return True

    async def rpc_pg_wait_ready(self, conn, payload):
        pg = self.placement_groups.get(payload["pg_id"])
        if pg is None:
            raise ValueError("no such placement group")
        if pg.state in ("CREATED", "REMOVED", "INFEASIBLE"):
            # INFEASIBLE returns immediately — no node will ever fit it;
            # callers surface the error instead of hanging
            return pg.public()
        fut = asyncio.get_running_loop().create_future()
        self._pg_waiters.setdefault(pg.pg_id, []).append(fut)
        return await fut

    async def rpc_pg_get(self, conn, payload):
        pg = self.placement_groups.get(payload["pg_id"])
        return pg.public() if pg else None

    async def rpc_pg_list(self, conn, payload):
        return [pg.public() for pg in self.placement_groups.values()]

    async def rpc_pg_remove(self, conn, payload):
        pg = self.placement_groups.pop(payload["pg_id"], None)
        if pg is None:
            return False
        self._dirty = True
        self._log("pg_removed", payload["pg_id"])
        if pg.name:
            self.named_pgs.pop(pg.name, None)
        for i, node_id in enumerate(pg.bundle_nodes):
            node = self.nodes.get(node_id)
            if node is not None and node.alive:
                try:
                    await node.conn.call("pg_return_bundle", {
                        "pg_id": pg.pg_id, "bundle_index": i})
                except Exception:  # noqa: BLE001
                    pass
        pg.state = "REMOVED"
        self._publish("pg", pg.public())
        return True
