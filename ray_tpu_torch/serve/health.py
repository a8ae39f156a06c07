"""Healthwatch: the fleet health observatory (replica liveness).

A copy of ``ray_tpu/serve/health.py``.  The fleet router
(``serve/router.py``, ``build_llm_fleet(health=)``) attaches a monitor
to its replicas (``engine._health``, ``engine._replica_label``).

``EngineTelemetry`` measures latency and ``SLOTracker`` judges it;
this module answers the operational question neither can: **which
replica is sick, and since when**.  One :class:`HealthMonitor` per
fleet (serve/router.py attaches it) runs a per-replica liveness state
machine over engine-loop heartbeats:

    HEALTHY --heartbeat older than suspect_ms--> SUSPECT
    SUSPECT --heartbeat older than dead_ms-----> DEAD
    any     --heartbeat resumes----------------> HEALTHY (recovered)

* **Heartbeats** — every wave of the continuous engine loop
  (serve/llm.py ``_engine``) stamps a ``perf_counter`` heartbeat; an
  idle-parked loop declares itself idle instead (an idle replica has
  no outstanding work, so a stale heartbeat there is not a failure).
* **Stall detection** — a request that was admitted but has been
  token-silent past ``stall_ms`` marks its replica SUSPECT and
  journals ``request_stall`` with the flightrec-known resident state
  (slot, tokens emitted, silence), so a wedged single request is
  visible even while the loop itself still heartbeats.
* **Routing consequences** — the router deprioritizes SUSPECT
  replicas, skips DEAD ones, and push_front-requeues a dead replica's
  queued (not-yet-admitted) requests to healthy replicas
  (``record_requeue(reason="replica_dead")``).
* **Detection latency** — chaos injection (serve/chaos.py) stamps the
  fault instant via :meth:`HealthMonitor.note_fault`; the DEAD
  transition then carries ``time_to_detect_ms``, the first-class
  fault-tolerance metric bench/sweep/perfledger track.

Every transition journals a ``health_transition`` event to the fleet
flight recorder (and the replica's own), counts in
``engine_stats()["health"]`` / ``fleet_stats()["health"]`` (per-role
for disaggregated fleets), and publishes the Prometheus
``serve_replica_health_state`` gauge / ``serve_health_transitions_total``
counter.  ``RAYTPU_HEALTHWATCH=0`` kills the whole observatory (the
flightrec/kvscope convention); disabled monitors hand out the same
zero-shaped blocks so consumers never branch.

Clock discipline matches telemetry: monotonic ``perf_counter`` only,
``now`` injectable everywhere for deterministic tests.
"""

from __future__ import annotations

import collections
import dataclasses
import os
import threading
import time
from typing import Any, Dict, List, Optional

__all__ = ["HEALTHY", "SUSPECT", "DEAD", "HealthConfig",
           "HealthMonitor", "empty_health", "empty_fleet_health",
           "healthwatch_enabled"]

HEALTHY = "healthy"
SUSPECT = "suspect"
DEAD = "dead"

#: gauge encoding for serve_replica_health_state (0 reads "fine" on a
#: dashboard; alerts trigger on >= 1)
_STATE_CODE = {HEALTHY: 0, SUSPECT: 1, DEAD: 2}


def healthwatch_enabled() -> bool:
    """Kill switch, same convention as RAYTPU_KVSCOPE /
    RAYTPU_TRACEBUS: set RAYTPU_HEALTHWATCH=0 to disable."""
    return os.environ.get("RAYTPU_HEALTHWATCH", "1") != "0"


_metrics_lock = threading.Lock()
_metrics: Optional[Dict[str, Any]] = None


def _health_metrics() -> Dict[str, Any]:
    """Process-wide serve health metric singletons (same pattern as
    serve/slo.py — one registration per name however many fleets this
    process hosts)."""
    global _metrics
    with _metrics_lock:
        if _metrics is None:
            from ray_tpu_torch.util.metrics import Counter, Gauge

            _metrics = {
                "state": Gauge(
                    "serve_replica_health_state",
                    "replica liveness state "
                    "(0=healthy, 1=suspect, 2=dead)",
                    tag_keys=("deployment", "replica")),
                "transitions": Counter(
                    "serve_health_transitions_total",
                    "liveness state transitions, by entered state",
                    tag_keys=("deployment", "replica", "state")),
                "stalls": Counter(
                    "serve_request_stalls_total",
                    "admitted requests token-silent past stall_ms",
                    tag_keys=("deployment", "replica")),
            }
        return _metrics


@dataclasses.dataclass(frozen=True)
class HealthConfig:
    """Liveness thresholds for one fleet's :class:`HealthMonitor`.

    A replica whose last heartbeat is older than ``suspect_ms`` is
    SUSPECT (deprioritized by the router), older than ``dead_ms`` is
    DEAD (skipped; its queued requests requeue to healthy replicas).
    An admitted request token-silent past ``stall_ms`` marks its
    replica SUSPECT even while the loop heartbeats.  ``probe_ms``
    throttles the state-machine sweep (``maybe_probe``); ``history``
    bounds the retained per-replica transition log."""

    suspect_ms: float = 1000.0
    dead_ms: float = 5000.0
    stall_ms: float = 2000.0
    probe_ms: float = 50.0
    history: int = 64

    def __post_init__(self):
        for name, v in (("suspect_ms", self.suspect_ms),
                        ("dead_ms", self.dead_ms),
                        ("stall_ms", self.stall_ms)):
            if v <= 0:
                raise ValueError(f"{name} must be > 0, got {v}")
        if self.dead_ms <= self.suspect_ms:
            raise ValueError(
                f"dead_ms must exceed suspect_ms, got "
                f"suspect={self.suspect_ms} dead={self.dead_ms}")
        if self.probe_ms < 0:
            raise ValueError(
                f"probe_ms must be >= 0, got {self.probe_ms}")
        if self.history < 1:
            raise ValueError(
                f"history must be >= 1, got {self.history}")


def empty_health() -> Dict[str, Any]:
    """The zero-shaped ``engine_stats()["health"]`` block: same keys
    as a live monitor's :meth:`HealthMonitor.replica_block`, all
    zeroed, ``enabled`` False.  Dense engines, fleets with
    RAYTPU_HEALTHWATCH=0, and standalone engines (no fleet, so no
    monitor) all serve this — consumers never branch on presence."""
    return {
        "enabled": False,
        "state": HEALTHY,
        "suspect_ms": 0.0,
        "dead_ms": 0.0,
        "stall_ms": 0.0,
        "heartbeats": 0,
        "heartbeat_age_ms": 0.0,
        "idle": False,
        "transitions": 0,
        "suspect_count": 0,
        "dead_count": 0,
        "recoveries": 0,
        "stalls": 0,
        "time_to_detect_ms": None,
        "transition_log": [],
    }


def empty_fleet_health() -> Dict[str, Any]:
    """The zero-shaped ``fleet_stats()["health"]`` block (monitor
    disabled) — same keys as :meth:`HealthMonitor.fleet_block`."""
    return {
        "enabled": False,
        "config": {"suspect_ms": 0.0, "dead_ms": 0.0,
                   "stall_ms": 0.0},
        "replicas": {},
        "by_state": {HEALTHY: 0, SUSPECT: 0, DEAD: 0},
        "by_role": {},
        "transitions": 0,
        "stalls": 0,
        "faults_injected": 0,
        "requeued_on_death": 0,
        "time_to_detect_ms": None,
    }


class _ReplicaHealth:
    """Internal per-replica liveness record."""

    __slots__ = ("name", "role", "state", "last_beat", "beats",
                 "idle", "transitions", "suspect_count", "dead_count",
                 "recoveries", "stalls", "fault_ts", "fault_kind",
                 "detect_ms", "recorder", "telemetry", "stalled_ids")

    def __init__(self, name: str, role: str, now: float,
                 recorder=None, telemetry=None, history: int = 64):
        self.name = name
        self.role = role
        self.state = HEALTHY
        self.last_beat = now
        self.beats = 0
        self.idle = True
        self.transitions: collections.deque = collections.deque(
            maxlen=history)
        self.suspect_count = 0
        self.dead_count = 0
        self.recoveries = 0
        self.stalls = 0
        self.fault_ts: Optional[float] = None
        self.fault_kind: Optional[str] = None
        self.detect_ms: Optional[float] = None
        self.recorder = recorder
        self.telemetry = telemetry
        self.stalled_ids: set = set()


class HealthMonitor:
    """Per-fleet liveness state machine over engine heartbeats.

    All mutating methods take an optional ``now`` (seconds, from
    ``time.perf_counter()``) so tests can drive deterministic clocks.
    When disabled (RAYTPU_HEALTHWATCH=0 or ``enabled=False``) every
    method is a cheap no-op and the blocks come back zero-shaped."""

    def __init__(self, config: Optional[HealthConfig] = None, *,
                 deployment: str = "llm_fleet", recorder=None,
                 enabled: Optional[bool] = None,
                 now: Optional[float] = None):
        self.config = config or HealthConfig()
        self.deployment = deployment
        self.enabled = (healthwatch_enabled() if enabled is None
                        else bool(enabled))
        #: the FLEET flight recorder — transitions journal here (with
        #: a replica field, the routing-table idiom) and to each
        #: replica's own recorder
        self._recorder = recorder
        #: reentrant: _transition locks itself, and the write paths
        #: (heartbeat, note_fault, the probe sweep) hold the lock
        #: across their compound updates — heartbeat stamps and chaos
        #: faults arrive from different execution contexts than the
        #: probe/reconcile sweeps that read them back
        self._lock = threading.RLock()
        self._reps: Dict[str, _ReplicaHealth] = {}
        self._last_probe: Optional[float] = None
        self.faults_injected = 0
        self.requeued_on_death = 0
        self._m = _health_metrics() if self.enabled else None

    def _now(self, now: Optional[float]) -> float:
        return time.perf_counter() if now is None else now

    # -- registration --------------------------------------------------

    def register(self, replica: str, *, role: str = "both",
                 recorder=None, telemetry=None,
                 now: Optional[float] = None) -> None:
        """Start watching one replica.  ``recorder`` is the replica's
        own flight recorder (transition copies land there too);
        ``telemetry`` its EngineTelemetry, consulted for the stall
        sweep.  Replicas register idle — the first heartbeat arms the
        staleness clock."""
        if not self.enabled:
            return
        now = self._now(now)
        with self._lock:
            self._reps[replica] = _ReplicaHealth(
                replica, role, now, recorder=recorder,
                telemetry=telemetry, history=self.config.history)
        self._m["state"].set(0, tags={"deployment": self.deployment,
                                      "replica": replica})

    def unregister(self, replica: str) -> None:
        """Stop watching a replica (graceful drain/retirement — a
        stopped loop is not a failure)."""
        with self._lock:
            self._reps.pop(replica, None)

    def replicas(self) -> List[str]:
        with self._lock:
            return list(self._reps)

    # -- hot-path stamps (engine loop) ---------------------------------

    def heartbeat(self, replica: str,
                  now: Optional[float] = None) -> None:
        """One engine-wave liveness stamp.  Hot path: a dict lookup
        and one uncontended lock round-trip; the recovery transition
        only runs after a SUSPECT/DEAD episode.  The lock matters:
        ``beats += 1`` is a read-modify-write racing the probe sweep's
        reads from another thread."""
        if not self.enabled:
            return
        rep = self._reps.get(replica)
        if rep is None:
            return
        with self._lock:
            rep.last_beat = self._now(now)
            rep.beats += 1
            rep.idle = False
            if rep.state != HEALTHY:
                self._transition(rep, HEALTHY, rep.last_beat,
                                 reason="heartbeat_resumed")

    def note_idle(self, replica: str,
                  now: Optional[float] = None) -> None:
        """The engine loop is parking with no outstanding work; a
        stale heartbeat while idle is not a failure, so the probe
        skips idle replicas until the next heartbeat."""
        if not self.enabled:
            return
        rep = self._reps.get(replica)
        if rep is None:
            return
        rep.last_beat = self._now(now)
        rep.idle = True

    # -- fault bookkeeping (chaos + router) ----------------------------

    def note_fault(self, replica: str, kind: str = "freeze",
                   now: Optional[float] = None) -> None:
        """Chaos injection stamps the fault instant here so the DEAD
        transition can carry ``time_to_detect_ms`` (fault → detection,
        the first-class fault-tolerance metric)."""
        if not self.enabled:
            return
        rep = self._reps.get(replica)
        if rep is None:
            return
        now = self._now(now)
        with self._lock:
            # one block: the DEAD transition reads fault_ts/detect_ms
            # as a pair to compute time_to_detect_ms — a probe landing
            # between these stores would see a half-initialized fault
            rep.fault_ts = now
            rep.fault_kind = kind
            rep.detect_ms = None
            self.faults_injected += 1
        if self._recorder is not None:
            self._recorder.record("fault_injected", ts=now,
                                  replica=replica, fault=kind)

    def note_requeued(self, n: int = 1) -> None:
        """The router moved `n` of a dead replica's queued requests to
        healthy replicas."""
        with self._lock:
            self.requeued_on_death += int(n)

    # -- the state machine ---------------------------------------------

    def state(self, replica: str) -> str:
        rep = self._reps.get(replica)
        return rep.state if rep is not None else HEALTHY

    def maybe_probe(self, now: Optional[float] = None
                    ) -> List[Dict[str, Any]]:
        """Throttled :meth:`probe` — the form the engine loop and the
        router pump call (one subtraction when inside the window)."""
        if not self.enabled:
            return []
        now = self._now(now)
        with self._lock:
            # check-then-claim atomically: the engine loop and the
            # router pump both throttle through this window, and an
            # unlocked check would let both run the sweep
            if self._last_probe is not None and \
                    now - self._last_probe < self.config.probe_ms / 1e3:
                return []
            self._last_probe = now
        return self.probe(now=now)

    def probe(self, now: Optional[float] = None
              ) -> List[Dict[str, Any]]:
        """One state-machine sweep: age every replica's heartbeat
        through HEALTHY→SUSPECT→DEAD and run the stall sweep over
        admitted-but-token-silent requests.  Returns the transitions
        this sweep produced."""
        if not self.enabled:
            return []
        now = self._now(now)
        self._last_probe = now
        cfg = self.config
        out: List[Dict[str, Any]] = []
        with self._lock:
            reps = list(self._reps.values())
        for rep in reps:
            for stall in self._stall_sweep(rep, now):
                out.append(stall)
            if rep.idle:
                continue
            age_ms = (now - rep.last_beat) * 1e3
            if age_ms >= cfg.dead_ms and rep.state != DEAD:
                out.append(self._transition(
                    rep, DEAD, now, reason="heartbeat_lost",
                    age_ms=age_ms))
            elif age_ms >= cfg.suspect_ms and rep.state == HEALTHY:
                out.append(self._transition(
                    rep, SUSPECT, now, reason="heartbeat_stale",
                    age_ms=age_ms))
        return out

    def _stall_sweep(self, rep: _ReplicaHealth, now: float
                     ) -> List[Dict[str, Any]]:
        """Outstanding-request stall detection: admitted requests
        token-silent past stall_ms journal ``request_stall`` with the
        flightrec-known resident state and suspect the replica (once
        per request)."""
        out: List[Dict[str, Any]] = []
        tele = rep.telemetry
        if tele is None or rep.state == DEAD:
            return out
        fn = getattr(tele, "stalled_requests", None)
        if fn is None:
            return out
        for stall in fn(self.config.stall_ms, now=now):
            if stall["id"] in rep.stalled_ids:
                continue
            with self._lock:
                rep.stalled_ids.add(stall["id"])
                rep.stalls += 1
            fields = dict(stall, replica=rep.name)
            rid = fields.pop("id")
            if fields.get("trace") is None:
                fields.pop("trace", None)
            if rep.recorder is not None:
                rep.recorder.record("request_stall", ts=now, req=rid,
                                    **fields)
            if self._recorder is not None \
                    and self._recorder is not rep.recorder:
                self._recorder.record("request_stall", ts=now,
                                      req=rid, **fields)
            self._m["stalls"].inc(tags={
                "deployment": self.deployment, "replica": rep.name})
            if rep.state == HEALTHY:
                out.append(self._transition(
                    rep, SUSPECT, now, reason="request_stall",
                    age_ms=stall["silent_ms"]))
        return out

    def _transition(self, rep: _ReplicaHealth, to_state: str,
                    now: float, reason: str,
                    age_ms: Optional[float] = None
                    ) -> Dict[str, Any]:
        # reentrant lock: heartbeat/note_fault call in holding it, the
        # probe sweep calls in bare — either way the state flip, the
        # episode counters, and the transition-log append land as one
        # unit against concurrent stats readers
        with self._lock:
            return self._transition_locked(rep, to_state, now, reason,
                                           age_ms)

    def _transition_locked(self, rep: _ReplicaHealth, to_state: str,
                           now: float, reason: str,
                           age_ms: Optional[float] = None
                           ) -> Dict[str, Any]:
        from_state, rep.state = rep.state, to_state
        if to_state == SUSPECT:
            rep.suspect_count += 1
        elif to_state == DEAD:
            rep.dead_count += 1
            if rep.fault_ts is not None and rep.detect_ms is None:
                rep.detect_ms = round((now - rep.fault_ts) * 1e3, 3)
        else:
            rep.recoveries += 1
            rep.stalled_ids.clear()
        tr = {
            "replica": rep.name,
            "from": from_state,
            "to": to_state,
            "reason": reason,
            "ts": now,
            "heartbeat_age_ms": (round(float(age_ms), 3)
                                 if age_ms is not None else 0.0),
        }
        if to_state == DEAD and rep.detect_ms is not None:
            tr["time_to_detect_ms"] = rep.detect_ms
        rep.transitions.append(tr)
        fields = {k: v for k, v in tr.items() if k != "ts"}
        if self._recorder is not None:
            self._recorder.record("health_transition", ts=now,
                                  **fields)
        if rep.recorder is not None \
                and rep.recorder is not self._recorder:
            rep.recorder.record("health_transition", ts=now, **fields)
        tags = {"deployment": self.deployment, "replica": rep.name}
        self._m["state"].set(_STATE_CODE[to_state], tags=tags)
        self._m["transitions"].inc(tags=dict(tags, state=to_state))
        return tr

    # -- derived metrics -----------------------------------------------

    @property
    def time_to_detect_ms(self) -> Optional[float]:
        """Worst (max) fault→DEAD detection latency observed across
        replicas; None until a noted fault has been detected."""
        with self._lock:
            vals = [r.detect_ms for r in self._reps.values()
                    if r.detect_ms is not None]
        return max(vals) if vals else None

    # -- stats blocks --------------------------------------------------

    def replica_block(self, replica: str,
                      now: Optional[float] = None) -> Dict[str, Any]:
        """The per-engine ``engine_stats()["health"]`` block — same
        keys as :func:`empty_health` always."""
        rep = self._reps.get(replica)
        if not self.enabled or rep is None:
            return empty_health()
        now = self._now(now)
        cfg = self.config
        with self._lock:
            # the transition log grows from the probe sweep's thread;
            # iterate it (and read the counters as one consistent
            # snapshot) under the lock
            return {
                "enabled": True,
                "state": rep.state,
                "suspect_ms": cfg.suspect_ms,
                "dead_ms": cfg.dead_ms,
                "stall_ms": cfg.stall_ms,
                "heartbeats": rep.beats,
                "heartbeat_age_ms": round((now - rep.last_beat) * 1e3,
                                          3),
                "idle": rep.idle,
                "transitions": len(rep.transitions),
                "suspect_count": rep.suspect_count,
                "dead_count": rep.dead_count,
                "recoveries": rep.recoveries,
                "stalls": rep.stalls,
                "time_to_detect_ms": rep.detect_ms,
                "transition_log": [dict(t) for t in rep.transitions],
            }

    def fleet_block(self, now: Optional[float] = None
                    ) -> Dict[str, Any]:
        """The ``fleet_stats()["health"]`` block: per-replica state +
        last-heartbeat age + transition history, pooled state counts
        overall and per role (disaggregated fleets keep prefill and
        decode pools apart, the occupancy_by_role idiom)."""
        if not self.enabled:
            return empty_fleet_health()
        now = self._now(now)
        cfg = self.config
        with self._lock:
            reps = list(self._reps.values())
            faults = self.faults_injected
            requeued = self.requeued_on_death
        by_state = {HEALTHY: 0, SUSPECT: 0, DEAD: 0}
        by_role: Dict[str, Dict[str, int]] = {}
        replicas: Dict[str, Any] = {}
        transitions = stalls = 0
        detect: Optional[float] = None
        for rep in reps:
            by_state[rep.state] += 1
            role = by_role.setdefault(
                rep.role, {HEALTHY: 0, SUSPECT: 0, DEAD: 0})
            role[rep.state] += 1
            transitions += len(rep.transitions)
            stalls += rep.stalls
            if rep.detect_ms is not None:
                detect = (rep.detect_ms if detect is None
                          else max(detect, rep.detect_ms))
            replicas[rep.name] = {
                "state": rep.state,
                "role": rep.role,
                "idle": rep.idle,
                "heartbeats": rep.beats,
                "heartbeat_age_ms": round(
                    (now - rep.last_beat) * 1e3, 3),
                "stalls": rep.stalls,
                "time_to_detect_ms": rep.detect_ms,
                "transitions": [dict(t) for t in rep.transitions],
            }
        return {
            "enabled": True,
            "config": {"suspect_ms": cfg.suspect_ms,
                       "dead_ms": cfg.dead_ms,
                       "stall_ms": cfg.stall_ms},
            "replicas": replicas,
            "by_state": by_state,
            "by_role": by_role,
            "transitions": transitions,
            "stalls": stalls,
            "faults_injected": faults,
            "requeued_on_death": requeued,
            "time_to_detect_ms": detect,
        }
