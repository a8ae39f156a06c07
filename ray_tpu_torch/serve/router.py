"""Fleet control plane: prefix-aware routing, per-tenant weighted
fair queueing, and SLO-driven autoscaling over N continuous engines.

A copy of ``ray_tpu/serve/router.py`` over the port's continuous
engine (``serve/llm.py``): the same names, defaults, errors, routing
decisions and key trees.

One continuous-batching engine (serve/llm.py) cannot serve heavy
traffic alone; this module composes N of them into a horizontally
scalable fleet behind one router, in the shape of Ray Serve's
controller/router split (reference: serve controller.py ServeController
+ router.py assign_request) with the Ray paper's resource-demand
scaling as the autoscaling model:

* **Prefix-affinity routing** — every replica's BlockPager publishes
  its resident prefix keys (`prefix_keys()`, exact block-aligned token
  tuples) as cluster-visible metadata.  The router matches an incoming
  prompt's block prefixes against each replica's export and sends the
  request where the KV blocks already live, so shared-prefix traffic
  concentrates its cache instead of re-prefilling the same system
  prompt on every replica.  On a miss it falls back to
  least-outstanding-requests over two random candidates
  (power-of-two-choices), the classic load-balancing compromise
  between random (no state) and global-least-loaded (herd risk).

* **Weighted fair queueing** — requests carry a tenant; each tenant
  class has a weight, and a virtual-time WFQ (start-time fair
  queueing: tag = max(V, tenant_last_finish) + cost/weight, serve
  min-tag first) decides which queued request dispatches when replica
  capacity frees.  A saturating batch tenant therefore cannot starve
  an interactive tenant's TTFT: the interactive class's small virtual
  cost lets its requests overtake the batch backlog.

* **SLO-driven autoscaling** — `LLMFleet.autoscale_step` reads
  burn-rate (serve/slo.py, 30s window) and queue-depth signals through
  the same pluggable signal seam as ServeController (LOAD_SIGNALS in
  serve/controller.py), scales up on a sustained breach, scales down
  on sustained idle, respects cooldowns and min/max bounds, and
  retires replicas with a graceful drain: stop admitting, finish
  in-flight requests, verify every KV block is freed, then shut the
  engine down.  Every decision journals to the fleet flight recorder
  (`route` / `scale_up` / `scale_down` / `drain` events via
  serve/telemetry.py), so `python -m ray_tpu_torch.tools.flightrec report`
  can reconstruct the routing table post-hoc.

Everything here is host-side control logic — replicas are in-process
engine instances (equal configs share their instrumented programs in
the program registry, so a second replica counts no compile event),
and the router never touches device memory.  The replicas share one
event loop and, on the card, one CUDA stream: their device work runs
one after another.
"""

from __future__ import annotations

import asyncio
import collections
import dataclasses
import heapq
import itertools
import random
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ray_tpu_torch._private import telemetry as _core
from ray_tpu_torch.serve.batching import HandoffCursor
from ray_tpu_torch.serve.chaos import ChaosConfig, ChaosInjector
from ray_tpu_torch.serve.health import (DEAD, HEALTHY, HealthConfig,
                                        HealthMonitor,
                                        empty_fleet_health,
                                        healthwatch_enabled)
from ray_tpu_torch.serve.slo import worst_burn_rate
from ray_tpu_torch.serve.telemetry import (EngineTelemetry,
                                           TraceContext,
                                           _tracebus_enabled,
                                           latency_anatomy,
                                           merge_anatomy_samples)

__all__ = ["TenantClass", "DEFAULT_TENANT", "FairQueue",
           "AutoscalePolicy", "LLMRouter", "LLMFleet",
           "build_llm_fleet", "fleet_registry"]


@dataclasses.dataclass(frozen=True)
class TenantClass:
    """One traffic class: a WFQ weight plus optional latency targets.

    `weight` is the tenant's fair share of router dispatch slots —
    an interactive class with weight 8 overtakes a batch class with
    weight 1 whenever both have queued requests.  `ttft_ms` / `e2e_ms`
    are the per-tenant SLO targets the fleet's `tenant_report()`
    scores attainment against (None = objective not tracked);
    `objective` is the attainment the tenant is promised."""

    name: str
    weight: float = 1.0
    ttft_ms: Optional[float] = None
    e2e_ms: Optional[float] = None
    objective: float = 0.95

    def __post_init__(self):
        if self.weight <= 0:
            raise ValueError(f"tenant {self.name!r}: weight must be "
                             f"> 0, got {self.weight}")
        if not 0.0 < self.objective < 1.0:
            raise ValueError(f"tenant {self.name!r}: objective must "
                             f"be in (0, 1), got {self.objective}")

    def objectives(self) -> Dict[str, float]:
        out = {}
        if self.ttft_ms is not None:
            out["ttft"] = float(self.ttft_ms)
        if self.e2e_ms is not None:
            out["e2e"] = float(self.e2e_ms)
        return out


DEFAULT_TENANT = TenantClass("default", weight=1.0)


class FairQueue:
    """Virtual-time weighted fair queue (start-time fair queueing).

    Each pushed item gets a finish tag ``start + cost/weight`` where
    ``start = max(V, tenant's last finish)``; pop serves the minimum
    finish tag and advances V to the served item's start tag.  With
    unit cost per request, a tenant with weight w receives a w-
    proportional share of pops whenever it is backlogged, and an idle
    tenant's unused share redistributes automatically — no token
    buckets, no timers, fully deterministic given arrival order."""

    def __init__(self, tenants: Optional[Dict[str, TenantClass]] = None):
        self._tenants = dict(tenants or {})
        self._vtime = 0.0
        self._last_finish: Dict[str, float] = {}
        self._heap: List[Tuple[float, int, float, Any]] = []
        self._seq = itertools.count()

    def __len__(self) -> int:
        return len(self._heap)

    def _class_of(self, tenant: Optional[str]) -> TenantClass:
        if tenant is None:
            return DEFAULT_TENANT
        return self._tenants.get(tenant,
                                 TenantClass(tenant, weight=1.0))

    def push(self, item: Any, tenant: Optional[str] = None,
             cost: float = 1.0) -> None:
        tc = self._class_of(tenant)
        start = max(self._vtime,
                    self._last_finish.get(tc.name, 0.0))
        finish = start + float(cost) / tc.weight
        self._last_finish[tc.name] = finish
        heapq.heappush(self._heap,
                       (finish, next(self._seq), start, item))

    def pop(self) -> Any:
        finish, _seq, start, item = heapq.heappop(self._heap)
        self._vtime = max(self._vtime, start)
        return item


@dataclasses.dataclass(frozen=True)
class AutoscalePolicy:
    """Knobs for `LLMFleet.autoscale_step` (see docs/serve.md).

    Scale UP when the worst replica burn rate exceeds `burn_threshold`
    or router backlog per live replica exceeds `queue_high`, sustained
    for `sustain_s`; scale DOWN when the fleet is completely idle (no
    queue, no in-flight, no burn) for `idle_s`.  `up_cooldown_s` /
    `down_cooldown_s` are minimum gaps between same-direction actions
    so one breach cannot thrash the fleet."""

    min_replicas: int = 1
    max_replicas: int = 8
    burn_threshold: float = 1.0
    queue_high: float = 4.0
    sustain_s: float = 5.0
    idle_s: float = 30.0
    up_cooldown_s: float = 10.0
    down_cooldown_s: float = 30.0

    def __post_init__(self):
        if not 1 <= self.min_replicas <= self.max_replicas:
            raise ValueError(
                f"need 1 <= min_replicas <= max_replicas, got "
                f"{self.min_replicas}..{self.max_replicas}")


class ReplicaHandle:
    """Router-side view of one engine replica: identity, role,
    outstanding count, drain flag, and the latest prefix-key
    export."""

    def __init__(self, name: str, inst: Any):
        self.name = name
        self.inst = inst
        #: "both" (monolithic), "prefill", or "decode" — read off the
        #: engine so the router's two-stage scheduler and the fleet's
        #: role-aware pooling never guess from names
        self.role = str(getattr(inst, "role", "both"))
        self.inflight = 0
        self.routed = 0
        self.draining = False
        self._keys: frozenset = frozenset()

    def free_blocks(self) -> int:
        """Blocks this replica's pager could allocate right now — the
        handoff target score (a decode replica must hold the whole
        chain, so free-block headroom beats raw request count)."""
        pager = getattr(self.inst, "_pager", None)
        return int(pager.available) if pager is not None else 0

    def refresh_metadata(self) -> None:
        """Pull the replica's resident prefix keys (the BlockPager
        export) into the router's view.  In-process this is a dict-key
        copy; a cross-host router would receive the same token tuples
        over the metadata channel."""
        pager = getattr(self.inst, "_pager", None)
        self._keys = (frozenset(pager.prefix_keys())
                      if pager is not None else frozenset())

    def prefix_match(self, tokens: Tuple[int, ...],
                     block_size: int) -> int:
        """Longest run of this replica's resident blocks covering a
        prefix of `tokens`, in blocks."""
        n = 0
        for i in range(1, len(tokens) // block_size + 1):
            if tokens[:i * block_size] in self._keys:
                n = i
            else:
                break
        return n

    def engine_stats(self) -> Dict[str, Any]:
        return self.inst.engine_stats()


class LLMRouter:
    """Routes requests over a mutable set of replicas.

    `policy` is "prefix" (affinity by resident prefix keys, p2c
    fallback) or "round_robin" (the baseline the fleet tests compare
    against).  With `wfq=True` queued requests dispatch in weighted-
    fair order per tenant; otherwise strict FIFO.  At most
    `max_inflight_per_replica` requests are outstanding per replica —
    the backlog stays HERE, where WFQ can reorder it, instead of in
    the engines' FIFO queues where it could not."""

    def __init__(self, replicas: List[ReplicaHandle], *,
                 block_size: int = 16,
                 tenants: Optional[Sequence[TenantClass]] = None,
                 policy: str = "prefix", wfq: bool = True,
                 max_inflight_per_replica: Optional[int] = None,
                 seed: int = 0,
                 telemetry: Optional[EngineTelemetry] = None,
                 name: str = "llm_fleet",
                 health: Optional[HealthMonitor] = None,
                 chaos: Optional[ChaosInjector] = None):
        if policy not in ("prefix", "round_robin"):
            raise ValueError(f"unknown routing policy {policy!r}")
        self._replicas = replicas          # shared with LLMFleet
        #: fleet HealthMonitor (None = healthwatch off) — consulted at
        #: every pump so DEAD replicas are skipped and SUSPECT ones
        #: deprioritized without any extra control loop
        self._health = health
        self._chaos = chaos
        #: not-yet-admitted requests rescued off DEAD replicas' engine
        #: queues and push_front-requeued to healthy peers
        self.requeued_on_death = 0
        self._block_size = int(block_size)
        self.tenants: Dict[str, TenantClass] = {
            t.name: t for t in (tenants or ())}
        self.policy = policy
        self._wfq = FairQueue(self.tenants) if wfq else None
        self._fifo: collections.deque = collections.deque()
        self._cap = max_inflight_per_replica
        self._rng = random.Random(seed)
        self._rr = 0
        self._ids = itertools.count()
        self.telemetry = telemetry or EngineTelemetry(name)
        self.routed_by_policy = {"prefix_affinity": 0, "p2c": 0,
                                 "round_robin": 0, "disagg_prefill": 0}
        #: completed second-stage moves (prefill → decode replica)
        self.handoffs = 0

    # -- introspection -------------------------------------------------

    @property
    def live_replicas(self) -> List[ReplicaHandle]:
        return [r for r in self._replicas if not r.draining]

    def queue_depth(self) -> int:
        return len(self._wfq) if self._wfq is not None \
            else len(self._fifo)

    def total_inflight(self) -> int:
        return sum(r.inflight for r in self._replicas)

    # -- submission ----------------------------------------------------

    def _normalize(self, prompt) -> np.ndarray:
        return np.asarray(prompt, np.int32).reshape(-1)

    async def submit(self, prompt, tenant: Optional[str] = None,
                     sampling=None):
        """Route one request and await its completion.  `tenant`
        selects the WFQ class and tags the engine-side record for
        per-tenant SLO slicing; the submit instant is threaded to the
        engine as the request's enqueue time so TTFT/e2e include any
        router queueing."""
        if not self.live_replicas:
            raise RuntimeError("no live replicas to route to")
        arr = self._normalize(prompt)
        t_submit = time.perf_counter()
        # the request's causal identity for the tracebus, born HERE —
        # threaded to the engine alongside enqueue_ts so router wait,
        # engine queue wait, and device work stitch on one clock
        ctx = (TraceContext(origin="router")
               if _tracebus_enabled() else None)
        fut = asyncio.get_running_loop().create_future()
        item = (arr, tenant, sampling, t_submit, fut,
                next(self._ids), ctx)
        if self._wfq is not None:
            self._wfq.push(item, tenant)
        else:
            self._fifo.append(item)
        self._pump()
        return await fut

    # -- dispatch ------------------------------------------------------

    def _state_of(self, rep: ReplicaHandle) -> str:
        return (self._health.state(rep.name)
                if self._health is not None else HEALTHY)

    def _prefer_healthy(self, cands: List[ReplicaHandle]
                        ) -> List[ReplicaHandle]:
        """SUSPECT deprioritization: route to HEALTHY replicas while
        any exist; a fleet that is ALL suspect still serves (suspicion
        is a hint, not a verdict — only DEAD is disqualifying)."""
        if self._health is None:
            return cands
        healthy = [r for r in cands
                   if self._state_of(r) == HEALTHY]
        return healthy or cands

    def _candidates(self, reps: Optional[List[ReplicaHandle]] = None
                    ) -> List[ReplicaHandle]:
        live = self.live_replicas if reps is None \
            else [r for r in reps if not r.draining]
        if self._health is not None:
            live = [r for r in live if self._state_of(r) != DEAD]
        if self._cap is None:
            return live
        return [r for r in live if r.inflight < self._cap]

    @property
    def disaggregated(self) -> bool:
        return any(r.role == "prefill" for r in self.live_replicas)

    def _pick_disagg(self, tokens: Tuple[int, ...],
                     pre: List[ReplicaHandle],
                     dec: List[ReplicaHandle]
                     ) -> Tuple[ReplicaHandle, str, int]:
        """Stage one of disaggregated routing.  Prefix affinity still
        wins, and it wins BIGGER here: a decode replica already
        holding the prompt's prefix blocks serves the request whole —
        its paged prefill of the unmatched tail is exactly the work a
        handoff would have shipped over, so the prefill fleet is
        skipped entirely.  Otherwise the request admits to the
        least-loaded prefill replica and rides the handoff path."""
        if self.policy == "prefix":
            best, best_match = None, 0
            for rep in self._prefer_healthy(dec):
                rep.refresh_metadata()
                m = rep.prefix_match(tokens, self._block_size)
                if m > best_match:
                    best, best_match = rep, m
            if best is not None:
                return best, "prefix_affinity", best_match
        rep = min(self._prefer_healthy(pre),
                  key=lambda r: r.inflight)
        return rep, "disagg_prefill", 0

    def _pick(self, tokens: Tuple[int, ...],
              cands: List[ReplicaHandle]
              ) -> Tuple[ReplicaHandle, str, int]:
        cands = self._prefer_healthy(cands)
        if self.policy == "round_robin":
            rep = cands[self._rr % len(cands)]
            self._rr += 1
            return rep, "round_robin", 0
        best, best_match = None, 0
        for rep in cands:
            rep.refresh_metadata()
            m = rep.prefix_match(tokens, self._block_size)
            if m > best_match:
                best, best_match = rep, m
        if best is not None:
            return best, "prefix_affinity", best_match
        if len(cands) == 1:
            return cands[0], "p2c", 0
        a, b = self._rng.sample(cands, 2)
        rep = a if a.inflight <= b.inflight else b
        return rep, "p2c", 0

    def _health_sweep(self) -> None:
        """Liveness consult at every pump: age heartbeats (throttled
        by the monitor's probe interval) and rescue the engine-queued
        requests of any replica the sweep finds DEAD.  Idempotent —
        a dead replica with an empty queue costs one state read."""
        if self._health is None:
            return
        self._health.maybe_probe()
        for rep in self._replicas:
            if not rep.draining and self._state_of(rep) == DEAD:
                self._requeue_dead(rep)

    def _requeue_dead(self, dead: ReplicaHandle) -> int:
        """Rescue the DEAD replica's not-yet-admitted engine queue:
        every queued prompt is push_front-requeued to a healthy
        compatible replica with its ORIGINAL future and a fresh
        engine-side record backdated to the original enqueue instant,
        so the caller still gets its result and TTFT/e2e still charge
        the full wait.  Requests already admitted to slots are the
        dead engine's to finish (or fail) — recovery proper is ROADMAP
        item 4; this is the detection + queue-rescue substrate.
        Handoff packages stay queued on the dead replica (their KV
        block rows live in ITS pager — nothing to rescue host-side)."""
        q = getattr(dead.inst, "_queue", None)
        if q is None or not len(q):
            return 0
        # role compatibility: "both" replicas take anything; a dead
        # "both" replica's prompts may also land on "decode" peers
        # (decode engines paged-prefill whole requests — the same
        # bypass _pick_disagg's prefix-affinity path uses)
        ok_roles = {"both", dead.role}
        if dead.role == "both":
            ok_roles.add("decode")
        targets = [r for r in self._replicas
                   if not r.draining and r is not dead
                   and r.role in ok_roles
                   and self._state_of(r) == HEALTHY
                   and getattr(r.inst, "_wake", None) is not None]
        items = q.pop(len(q))
        if not targets:
            for (arg, rec, sp), fut in reversed(items):
                q.push_front((arg, rec, sp), fut)
            return 0
        moved = 0
        stay = []
        for (arg, rec, sp), fut in items:
            if isinstance(arg, HandoffCursor):
                stay.append(((arg, rec, sp), fut))
                continue
            dead.inst._telemetry.record_requeue(
                rec, reason="replica_dead")
            target = min(targets, key=lambda r: (
                len(r.inst._queue), r.inflight))
            rec2 = target.inst._telemetry.record_enqueue(
                int(arg.shape[0]), now=rec.get("enqueue"),
                tenant=rec.get("tenant"), ctx=rec.get("ctx"))
            target.inst._queue.push_front((arg, rec2, sp), fut)
            target.inst._wake.set()
            moved += 1
        for (arg, rec, sp), fut in reversed(stay):
            q.push_front((arg, rec, sp), fut)
        if moved:
            self.requeued_on_death += moved
            self._health.note_requeued(moved)
        return moved

    def _pump(self) -> None:
        """Dispatch queued requests while replica capacity is free.
        Synchronous and re-entrant-safe: called on submit, on every
        completion, and when the replica set changes."""
        self._health_sweep()
        while self.queue_depth() > 0:
            live = self.live_replicas
            pre = [r for r in live if r.role == "prefill"]
            if pre:
                # two-stage disaggregated dispatch gates on prefill
                # capacity (the handoff target is chosen later, when
                # the package exists and free-block counts are fresh)
                cands = self._candidates(pre)
                dec = [r for r in live
                       if r.role in ("decode", "both")]
            else:
                cands = self._candidates()
                dec = []
            if not cands:
                return
            if self._wfq is not None:
                item = self._wfq.pop()
            else:
                item = self._fifo.popleft()
            arr, tenant, sampling, t_submit, fut, rid, ctx = item
            tokens = tuple(int(t) for t in arr)
            if pre:
                rep, policy, matched = self._pick_disagg(
                    tokens, cands, dec)
            else:
                rep, policy, matched = self._pick(tokens, cands)
            self.routed_by_policy[policy] += 1
            if ctx is not None:
                # the router hop: submit → dispatch, with the routing
                # decision as span attributes
                ctx.span("router.route", t_submit,
                         time.perf_counter(), replica=rep.name,
                         policy=policy, tenant=tenant,
                         matched_blocks=matched, router_req=rid)
            self.telemetry.record_route(
                req=rid, replica=rep.name, policy=policy,
                tenant=tenant, matched_blocks=matched,
                outstanding=rep.inflight,
                **({"trace": ctx.trace_id} if ctx is not None else {}))
            rep.inflight += 1
            rep.routed += 1
            asyncio.get_running_loop().create_task(
                self._dispatch(rep, arr, tenant, sampling, t_submit,
                               fut, ctx, rid))

    def _pick_handoff_target(self) -> ReplicaHandle:
        """Stage two: the decode replica to install a handoff package
        on — most free pager blocks first (the install must hold the
        request's WHOLE chain), outstanding slots break ties.  A
        package may exceed the inflight cap: the request already won
        its admission at stage one, and the decode engine's own
        queue/requeue machinery absorbs any wait."""
        dec = [r for r in self.live_replicas
               if r.role in ("decode", "both")
               and self._state_of(r) != DEAD]
        if not dec:
            raise RuntimeError(
                "no live decode replicas to hand off to")
        dec = self._prefer_healthy(dec)
        under = [r for r in dec
                 if self._cap is None or r.inflight < self._cap]
        pool = under or dec
        return max(pool, key=lambda r: (r.free_blocks(), -r.inflight))

    async def _forward_handoff(self, pkg, tenant, ctx, rid: int):
        if self._chaos is not None \
                and self._chaos.should_drop_handoff():
            # chaos: the package "got lost on the wire".  Journal the
            # drop and recover by re-running the prompt from scratch
            # on a decode-capable replica (decode engines paged-
            # prefill whole requests) — greedy decoding makes the
            # recovered result bit-identical, only slower.
            self.telemetry.flightrec.record(
                "handoff_dropped", req=rid,
                n_blocks=int(pkg.n_blocks),
                **({"trace": ctx.trace_id} if ctx is not None else {}))
            meta = pkg.meta or {}
            rep = self._pick_handoff_target()
            rep.inflight += 1
            rep.routed += 1
            try:
                return await rep.inst(
                    pkg.prompt, sampling=pkg.sampling, tenant=tenant,
                    enqueue_ts=meta.get("enqueue"), trace=ctx)
            finally:
                rep.inflight -= 1
                self._pump()
        rep = self._pick_handoff_target()
        self.telemetry.record_route(
            req=rid, replica=rep.name, policy="handoff",
            tenant=tenant, matched_blocks=int(pkg.n_blocks),
            outstanding=rep.inflight,
            **({"trace": ctx.trace_id} if ctx is not None else {}))
        rep.inflight += 1
        rep.routed += 1
        try:
            out = await rep.inst.admit_prefilled(pkg)
            self.handoffs += 1
            return out
        finally:
            rep.inflight -= 1
            self._pump()

    async def _dispatch(self, rep: ReplicaHandle, arr, tenant,
                        sampling, t_submit: float, fut,
                        ctx=None, rid: int = -1) -> None:
        released = False
        try:
            out = await rep.inst(arr, sampling=sampling,
                                 tenant=tenant, enqueue_ts=t_submit,
                                 trace=ctx)
            if isinstance(out, HandoffCursor):
                # prefill replica parked the request and freed its
                # slot — release stage-one capacity NOW, before the
                # decode leg, or the prefill fleet would stall for
                # the whole generation
                rep.inflight -= 1
                released = True
                self._pump()
                out = await self._forward_handoff(out, tenant, ctx,
                                                  rid)
            if not fut.done():
                fut.set_result(out)
        except Exception as e:  # noqa: BLE001 - surface to caller
            if not fut.done():
                fut.set_exception(e)
        finally:
            if not released:
                rep.inflight -= 1
                self._pump()

    # -- drain ---------------------------------------------------------

    async def drain(self, rep: ReplicaHandle,
                    timeout_s: float = 30.0) -> Dict[str, Any]:
        """Gracefully drain one replica: stop admitting (the dispatch
        loop skips draining replicas), wait for in-flight requests to
        finish, and verify the engine freed every KV block.  Journals
        a `drain` event; the caller shuts the engine down."""
        rep.draining = True
        n0 = rep.inflight
        deadline = time.perf_counter() + timeout_s
        while rep.inflight > 0 and time.perf_counter() < deadline:
            await asyncio.sleep(0.002)
        stats = rep.engine_stats()
        kv = stats.get("kv_cache") or {}
        blocks = int(kv.get("blocks_in_use", 0))
        ok = rep.inflight == 0 and blocks == 0
        self.telemetry.record_drain(rep.name, ok,
                                    blocks_in_use=blocks,
                                    drained_requests=n0)
        return {"replica": rep.name, "ok": ok,
                "blocks_in_use": blocks, "drained_requests": n0}

    def stats(self) -> Dict[str, Any]:
        return {
            "policy": self.policy,
            "wfq": self._wfq is not None,
            "queue_depth": self.queue_depth(),
            "inflight": self.total_inflight(),
            "routed_by_policy": dict(self.routed_by_policy),
            "disaggregated": self.disaggregated,
            "handoffs": self.handoffs,
            "requeued_on_death": self.requeued_on_death,
            "max_inflight_per_replica": self._cap,
            "tenants": {n: {"weight": t.weight,
                            "objective": t.objective,
                            "targets_ms": t.objectives()}
                        for n, t in self.tenants.items()},
        }


#: live fleets by name — the dashboard's /api/serve/fleet surface
#: (in-process direct-instance fleets: bench, tests, notebooks)
_FLEETS: Dict[str, "LLMFleet"] = {}


def fleet_registry() -> Dict[str, "LLMFleet"]:
    return dict(_FLEETS)


class LLMFleet:
    """N continuous-engine replicas + router + autoscaler, one object.

    Replicas are in-process engine instances from `factory` (all equal
    configs, so they share each instrumented program).
    `await fleet(prompt, tenant=...)` routes a request;
    `await fleet.autoscale_step()` runs one control-loop tick."""

    def __init__(self, factory: Callable[[], Any], num_replicas: int,
                 *, name: str = "llm_fleet", block_size: int = 16,
                 tenants: Optional[Sequence[TenantClass]] = None,
                 policy: str = "prefix", wfq: bool = True,
                 autoscale: Optional[AutoscalePolicy] = None,
                 max_inflight_per_replica: Optional[int] = None,
                 seed: int = 0,
                 prefill_factory: Optional[Callable[[], Any]] = None,
                 num_prefill_replicas: int = 0,
                 health: Optional[HealthConfig] = None,
                 chaos: Optional[ChaosConfig] = None):
        if num_replicas < 1:
            raise ValueError("num_replicas must be >= 1")
        if (prefill_factory is None) != (num_prefill_replicas == 0):
            raise ValueError(
                "prefill_factory and num_prefill_replicas must be "
                "given together (a disaggregated fleet needs both)")
        self.name = name
        self._factory = factory
        self._prefill_factory = prefill_factory
        self.telemetry = EngineTelemetry(name)
        # healthwatch: one monitor per fleet, journaling into the
        # fleet flight recorder; RAYTPU_HEALTHWATCH=0 disables it
        # entirely (self.health is None, engines get no attach)
        self.health = (HealthMonitor(
            health, deployment=name,
            recorder=self.telemetry.flightrec)
            if healthwatch_enabled() else None)
        # chaos: inert unless the caller hands a ChaosConfig — the
        # default fleet attaches nothing to the engine loops
        self.chaos = (ChaosInjector(chaos, monitor=self.health)
                      if chaos is not None else None)
        self._replicas: List[ReplicaHandle] = []
        self._retired: List[ReplicaHandle] = []
        self._next_replica = itertools.count()
        self._next_prefill = itertools.count()
        self.autoscale_policy = autoscale or AutoscalePolicy()
        self._breach_since: Optional[float] = None
        self._idle_since: Optional[float] = None
        self._last_up: Optional[float] = None
        self._last_down: Optional[float] = None
        # prefill replicas first so fleet listings read topology order
        for _ in range(int(num_prefill_replicas)):
            self._add_replica(prefill=True)
        for _ in range(num_replicas):
            self._add_replica()
        self.router = LLMRouter(
            self._replicas, block_size=block_size, tenants=tenants,
            policy=policy, wfq=wfq,
            max_inflight_per_replica=max_inflight_per_replica,
            seed=seed, telemetry=self.telemetry, name=name,
            health=self.health, chaos=self.chaos)
        _FLEETS[name] = self

    # -- replica lifecycle ---------------------------------------------

    @property
    def num_replicas(self) -> int:
        return len([r for r in self._replicas if not r.draining])

    def _add_replica(self, prefill: bool = False) -> ReplicaHandle:
        if prefill:
            rep = ReplicaHandle(
                f"{self.name}/p{next(self._next_prefill)}",
                self._prefill_factory())
        else:
            rep = ReplicaHandle(
                f"{self.name}/r{next(self._next_replica)}",
                self._factory())
        self._replicas.append(rep)
        # healthwatch attach — covers autoscale-added replicas too.
        # The engine heartbeats under its fleet name, and the monitor
        # watches its telemetry for token-silent residents.
        inst = rep.inst
        if hasattr(inst, "_replica_label"):
            inst._replica_label = rep.name
        if self.health is not None and hasattr(inst, "_health"):
            inst._health = self.health
            self.health.register(
                rep.name, role=rep.role,
                recorder=getattr(getattr(inst, "_telemetry", None),
                                 "flightrec", None),
                telemetry=getattr(inst, "_telemetry", None))
        if self.chaos is not None and hasattr(inst, "_chaos"):
            inst._chaos = self.chaos
            self.chaos.bind(rep.name)
        return rep

    async def __call__(self, prompt, tenant: Optional[str] = None,
                       sampling=None):
        return await self.router.submit(prompt, tenant=tenant,
                                        sampling=sampling)

    # -- autoscaling ---------------------------------------------------

    def _signals(self) -> Dict[str, float]:
        live = [r for r in self._replicas if not r.draining]
        burn = 0.0
        for rep in live:
            slo = getattr(rep.inst, "_telemetry", None)
            slo = getattr(slo, "slo", None)
            if slo is not None:
                burn = max(burn, worst_burn_rate(slo.snapshot()))
        backlog = self.router.queue_depth()
        per_rep = backlog / max(1, len(live))
        return {"burn_rate": round(burn, 4),
                "queue_depth": backlog,
                "queue_per_replica": round(per_rep, 4),
                "inflight": self.router.total_inflight()}

    async def autoscale_step(self, now: Optional[float] = None
                             ) -> Optional[Dict[str, Any]]:
        """One control-loop tick: read burn-rate + queue-depth
        signals, apply the policy (sustain windows, cooldowns, min/max
        bounds), and act — returns the action dict when the fleet
        scaled, else None.  `now` is injectable for deterministic
        tests; scale-down AWAITS the victim's graceful drain so a
        returned "down" action implies zero lost requests and zero
        resident KV blocks."""
        p = self.autoscale_policy
        now = time.perf_counter() if now is None else now
        sig = self._signals()
        n = self.num_replicas
        reason = None
        if sig["burn_rate"] > p.burn_threshold:
            reason, value = "burn_rate", sig["burn_rate"]
        elif sig["queue_per_replica"] > p.queue_high:
            reason, value = "queue_depth", sig["queue_per_replica"]
        if reason is not None:
            self._idle_since = None
            if self._breach_since is None:
                self._breach_since = now
            sustained = now - self._breach_since >= p.sustain_s
            cooled = (self._last_up is None
                      or now - self._last_up >= p.up_cooldown_s)
            if sustained and cooled and n < p.max_replicas:
                self._add_replica()
                self._breach_since = None
                self._last_up = now
                self.telemetry.record_scale(
                    "up", n, n + 1, reason, signal=value)
                self.router._pump()
                return {"action": "up", "reason": reason,
                        "signal": value, "n_replicas": n + 1}
            return None
        idle = (sig["queue_depth"] == 0 and sig["inflight"] == 0
                and sig["burn_rate"] <= p.burn_threshold)
        if not idle:
            self._breach_since = None
            self._idle_since = None
            return None
        self._breach_since = None
        if self._idle_since is None:
            self._idle_since = now
        sustained = now - self._idle_since >= p.idle_s
        cooled = (self._last_down is None
                  or now - self._last_down >= p.down_cooldown_s)
        if not (sustained and cooled and n > p.min_replicas):
            return None
        live = [r for r in self._replicas if not r.draining]
        # never drain the prefill fleet on idle — role counts are the
        # operator's chip-split decision, not an autoscaler signal
        decodable = [r for r in live if r.role != "prefill"] or live
        victim = min(reversed(decodable), key=lambda r: r.inflight)
        idle_for = now - self._idle_since
        self._idle_since = None
        self._last_down = now
        self.telemetry.record_scale(
            "down", n, n - 1, "idle", signal=idle_for,
            replica=victim.name)
        drain = await self.router.drain(victim)
        self._replicas.remove(victim)
        self._retired.append(victim)
        if self.health is not None:
            # a drained replica stops heartbeating by design — drop
            # it from the monitor so retirement never reads as death
            self.health.unregister(victim.name)
        victim.inst.shutdown_engine()
        self.router._pump()
        return {"action": "down", "reason": "idle",
                "n_replicas": n - 1, "drain": drain}

    # -- reporting -----------------------------------------------------

    def tenant_report(self) -> Dict[str, Any]:
        """Per-tenant SLO attainment over every request the fleet has
        served (live + retired replicas): for each tenant objective
        with a target, the fraction of samples within target plus
        p50/p95 — the numbers bench/sweep publish as
        `{tenant}_{obj}_slo_attainment`."""
        out: Dict[str, Any] = {}
        reps = self._replicas + self._retired
        for tc in self.router.tenants.values():
            merged: Dict[str, List[float]] = {}
            for rep in reps:
                tele = getattr(rep.inst, "_telemetry", None)
                if tele is None:
                    continue
                for obj, series in tele.slo_samples(
                        tenant=tc.name).items():
                    merged.setdefault(obj, []).extend(
                        v for _ts, v in series)
            objectives = {}
            for obj, target in tc.objectives().items():
                vals = merged.get(obj, [])
                ok = sum(1 for v in vals if v <= target)
                objectives[obj] = {
                    "target_ms": target,
                    "samples": len(vals),
                    "attainment": round(ok / len(vals), 4)
                    if vals else None,
                    "latency_ms": _core.summarize(vals),
                }
            out[tc.name] = {
                "weight": tc.weight,
                "objective": tc.objective,
                "requests": len(merged.get("e2e", [])),
                "objectives": objectives,
            }
        return out

    def fleet_stats(self) -> Dict[str, Any]:
        """The dashboard /api/serve/fleet document: router counters,
        autoscaler state, per-replica engine summaries, and the
        fleet-wide prefix hit rate (pooled over replicas)."""
        hits = misses = 0
        chunks = {"requests": 0, "chunks": 0, "tokens": 0,
                  "max_chunks_per_request": 0}
        # kvscope pooling: waste counters SUM over replicas (each
        # replica's pager thrashes independently), occupancy reports
        # per-replica ratios plus the fleet max/mean — a fleet-wide
        # average would hide one replica's pool running hot
        scope = {"reprefill_waste_tokens": 0, "reprefill_events": 0,
                 "keys_evicted": 0, "prefill_tokens": 0,
                 "tier_hits": 0, "tokens_restored": 0}
        # host-tier pooling (serve/kv_tier.py): counters SUM over
        # replicas (each replica spills/restores its own tier), the
        # pooled hit rate is recomputed over the summed probes
        tier = {"hits": 0, "misses": 0, "saves": 0, "evictions": 0,
                "tokens_restored": 0, "bytes_resident": 0,
                "bytes_budget": 0, "entries": 0, "h2d_ms": 0.0,
                "d2h_ms": 0.0}
        tier_enabled = False
        waste_by_tenant: Dict[str, int] = {}
        occ_by_replica: Dict[str, float] = {}
        occ_p95s: List[float] = []
        # role-aware occupancy pooling: a decode pool's occupancy is a
        # capacity signal (whole resident chains), a prefill pool's is
        # churn (blocks park in the LRU the moment a handoff leaves) —
        # averaging them together would report a meaningless blend
        occ_by_role: Dict[str, List[float]] = {}
        occ_p95_by_role: Dict[str, List[float]] = {}
        handoff = {"handoffs_out": 0, "handoffs_in": 0,
                   "blocks_moved": 0, "fast_path": 0, "staged": 0,
                   "requeues": 0}
        replicas = {}
        for rep in self._replicas + self._retired:
            st = rep.engine_stats()
            for k, v in (st.get("handoff") or {}).items():
                if k in handoff:
                    handoff[k] += int(v)
            kv = st.get("kv_cache") or {}
            hits += int(kv.get("prefix_block_hits", 0))
            misses += int(kv.get("prefix_block_misses", 0))
            pc = st.get("prefill_chunks") or {}
            for k in ("requests", "chunks", "tokens"):
                chunks[k] += int(pc.get(k, 0))
            chunks["max_chunks_per_request"] = max(
                chunks["max_chunks_per_request"],
                int(pc.get("max_chunks_per_request", 0)))
            ks = st.get("kv_scope") or {}
            forensics = ks.get("forensics") or {}
            for k in scope:
                scope[k] += int(forensics.get(k, 0))
            for t, v in (forensics.get("waste_by_tenant")
                         or {}).items():
                waste_by_tenant[t] = waste_by_tenant.get(t, 0) + int(v)
            occ = ks.get("occupancy") or {}
            occ_by_replica[rep.name] = float(
                occ.get("occupancy_ratio", 0.0))
            occ_p95s.append(float(occ.get("occupancy_p95", 0.0)))
            occ_by_role.setdefault(rep.role, []).append(float(
                occ.get("occupancy_ratio", 0.0)))
            occ_p95_by_role.setdefault(rep.role, []).append(float(
                occ.get("occupancy_p95", 0.0)))
            kt = st.get("kv_tier") or {}
            if kt.get("enabled"):
                tier_enabled = True
            for k in tier:
                tier[k] = round(tier[k] + (kt.get(k) or 0), 3) \
                    if k.endswith("_ms") else tier[k] + int(kt.get(k)
                                                           or 0)
            replicas[rep.name] = {
                "role": rep.role,
                "draining": rep.draining,
                "retired": rep in self._retired,
                "inflight": rep.inflight,
                "routed": rep.routed,
                "requests": st.get("requests"),
                "kv_cache": kv,
                "handoff": st.get("handoff"),
                "slo_breached": (st.get("slo") or {}).get("breached")
                if st.get("slo") else None,
            }
        total = hits + misses
        occ_vals = list(occ_by_replica.values())
        kv_scope = dict(
            scope,
            reprefill_waste_frac=round(
                scope["reprefill_waste_tokens"]
                / scope["prefill_tokens"], 4)
            if scope["prefill_tokens"] else 0.0,
            waste_by_tenant=waste_by_tenant,
            occupancy_by_replica=occ_by_replica,
            occupancy_max=max(occ_vals) if occ_vals else 0.0,
            occupancy_mean=round(sum(occ_vals) / len(occ_vals), 4)
            if occ_vals else 0.0,
            # worst replica's ring p95 — the fleet headline occupancy
            # number (an average would hide one pool running hot)
            occupancy_p95=max(occ_p95s) if occ_p95s else 0.0,
            occupancy_by_role={
                role: {
                    "mean": round(sum(vals) / len(vals), 4),
                    "max": max(vals),
                    "p95": max(occ_p95_by_role.get(role) or [0.0]),
                }
                for role, vals in occ_by_role.items() if vals})
        tier_probes = tier["hits"] + tier["misses"]
        kv_tier = dict(
            tier, enabled=tier_enabled,
            hit_rate=round(tier["hits"] / tier_probes, 4)
            if tier_probes else 0.0)
        return {
            "name": self.name,
            "num_replicas": self.num_replicas,
            "router": self.router.stats(),
            "autoscale": dataclasses.asdict(self.autoscale_policy),
            "signals": self._signals(),
            "prefix_hit_rate": round(hits / total, 4) if total
            else 0.0,
            "prefill_chunks": chunks,
            "kv_scope": kv_scope,
            "kv_tier": kv_tier,
            "handoff": handoff,
            "tenants": self.tenant_report(),
            "replicas": replicas,
            "health": self._health_block(),
            "flightrec": self.telemetry.flightrec.stats(),
            "latency_anatomy": self.latency_anatomy(),
        }

    def _health_block(self) -> Dict[str, Any]:
        """Fleet health block — zeroed (enabled=False) when the
        monitor is off, so /api/serve/health consumers never branch
        on presence."""
        if self.health is None:
            return empty_fleet_health()
        block = self.health.fleet_block()
        block["requeued_on_death"] = self.router.requeued_on_death
        if self.chaos is not None:
            block["chaos"] = self.chaos.stats()
        return block

    # -- tracebus (tools/tracebus.py collects these) -------------------

    def anatomy_samples(self, tenant: Optional[str] = None
                        ) -> Dict[str, Any]:
        """Raw latency-anatomy samples pooled over every replica (live
        and retired) — fleet percentiles come from the union of
        per-request samples, never from averaged summaries."""
        parts = []
        for rep in self._replicas + self._retired:
            fn = getattr(rep.inst, "anatomy_samples", None)
            if fn is not None:
                parts.append(fn(tenant=tenant))
        return merge_anatomy_samples(parts)

    def latency_anatomy(self) -> Dict[str, Any]:
        """Fleet-wide ITL/TPOT percentiles + critical-path
        decomposition, overall and per tenant (fleet_stats block)."""
        samples = self.anatomy_samples()
        by_tenant = {
            t: latency_anatomy(self.anatomy_samples(tenant=t))
            for t in samples["tenants"]}
        return dict(latency_anatomy(samples), by_tenant=by_tenant)

    def trace_records(self) -> List[Dict[str, Any]]:
        """Tracebus request snapshots from every replica (replica
        lane name attached)."""
        out: List[Dict[str, Any]] = []
        for rep in self._replicas + self._retired:
            fn = getattr(rep.inst, "trace_records", None)
            if fn is None:
                continue
            for snap in fn():
                snap["replica"] = rep.name
                out.append(snap)
        return out

    def find_request(self, request_id) -> Optional[Dict[str, Any]]:
        """Locate one request across replicas by trace id (or
        engine-local id); None when no replica knows it."""
        for rep in self._replicas + self._retired:
            fn = getattr(rep.inst, "request_trace", None)
            if fn is None:
                continue
            snap = fn(request_id)
            if snap is not None:
                snap["replica"] = rep.name
                return snap
        return None

    def shutdown(self) -> None:
        """Stop every engine (live and retired) and deregister."""
        for rep in self._replicas + self._retired:
            try:
                rep.inst.shutdown_engine()
            except Exception:  # noqa: BLE001 - already dead
                pass
        _FLEETS.pop(self.name, None)


def build_llm_fleet(family: str = "gpt2", preset: str = "nano", *,
                    num_replicas: int = 2,
                    num_prefill_replicas: Optional[int] = None,
                    num_decode_replicas: Optional[int] = None,
                    prefill_engine_kw: Optional[Dict[str, Any]] = None,
                    decode_engine_kw: Optional[Dict[str, Any]] = None,
                    handoff_staged: bool = False,
                    tenants: Optional[Sequence[TenantClass]] = None,
                    routing: str = "prefix", wfq: bool = True,
                    autoscale: Optional[AutoscalePolicy] = None,
                    max_inflight_per_replica: Optional[int] = None,
                    fleet_name: Optional[str] = None, seed: int = 0,
                    health: Optional[HealthConfig] = None,
                    chaos: Optional[ChaosConfig] = None,
                    **engine_kw) -> LLMFleet:
    """Stand up independent continuous-engine replicas (each its own
    weights / BlockPager / SLOTracker) behind an `LLMRouter`.
    `engine_kw` is forwarded to `build_llm_deployment`; the continuous
    scheduler and paged KV layout are forced on (prefix routing needs
    the pager's key export — a dense-layout fleet would route by load
    only).  `max_inflight_per_replica` defaults to the engine's
    `max_slots`, keeping any backlog at the router where WFQ can
    reorder it.

    Homogeneous by default (`num_replicas` role="both" engines).
    Setting BOTH `num_prefill_replicas` and `num_decode_replicas`
    builds a DISAGGREGATED fleet instead: role-typed replica sets with
    block-granular KV handoff (docs/serve.md#disaggregated-serving) —
    the router admits to the least-loaded prefill replica, the prefill
    engine exports the filled block rows at last-chunk completion, and
    a decode replica chosen by free-block headroom splices them in and
    finishes the generation.  `prefill_engine_kw` / `decode_engine_kw`
    overlay per-role engine knobs (mesh degree, batch shape, slot
    count: `mesh`, `prefill_bucket`, `max_slots`, `kv_num_blocks`, …)
    on top of the shared `engine_kw`; `kv_block_size` must stay equal
    across roles — the handoff moves whole blocks.  `handoff_staged`
    forces the D2H→H2D host-staging hop (the cross-process path) even
    in-process.  `spec_decode` applies to decode replicas only
    (drafting is decode-side work).  `engine_kw` carries `device`
    too: None (the default) is the first CUDA device, so a fleet runs
    on the card unless the caller asks for the CPU; every replica holds
    its own weights there."""
    from ray_tpu_torch.serve.llm import build_llm_deployment

    engine_kw.setdefault("scheduler", "continuous")
    engine_kw.setdefault("kv_layout", "paged")
    name = fleet_name or f"fleet_{family}_{preset}"
    disagg = (num_prefill_replicas is not None
              or num_decode_replicas is not None)
    if disagg:
        if not (num_prefill_replicas and num_decode_replicas):
            raise ValueError(
                "a disaggregated fleet needs BOTH "
                "num_prefill_replicas and num_decode_replicas >= 1, "
                f"got {num_prefill_replicas}/{num_decode_replicas}")
        pre_kw = dict(engine_kw)
        pre_kw.update(prefill_engine_kw or {})
        # drafting is decode-side work; the prefill replica's first
        # token is the same with or without a draft model
        pre_kw.pop("spec_decode", None)
        pre_kw.update(role="prefill", handoff_staged=handoff_staged)
        dec_kw = dict(engine_kw)
        dec_kw.update(decode_engine_kw or {})
        dec_kw["role"] = "decode"
        bs_pre = int(pre_kw.get("kv_block_size", 16))
        bs_dec = int(dec_kw.get("kv_block_size", 16))
        if bs_pre != bs_dec:
            raise ValueError(
                "kv_block_size must match across roles (the handoff "
                f"moves whole blocks), got prefill={bs_pre} "
                f"decode={bs_dec}")
        pre_dep = build_llm_deployment(family, preset, **pre_kw)
        dec_dep = build_llm_deployment(family, preset, **dec_kw)
        if max_inflight_per_replica is None:
            max_inflight_per_replica = int(dec_kw.get("max_slots", 4))
        return LLMFleet(
            dec_dep.func_or_class, int(num_decode_replicas),
            prefill_factory=pre_dep.func_or_class,
            num_prefill_replicas=int(num_prefill_replicas),
            name=name, block_size=bs_dec, tenants=tenants,
            policy=routing, wfq=wfq, autoscale=autoscale,
            max_inflight_per_replica=max_inflight_per_replica,
            seed=seed, health=health, chaos=chaos)
    max_slots = int(engine_kw.get("max_slots", 4))
    if max_inflight_per_replica is None:
        max_inflight_per_replica = max_slots
    dep = build_llm_deployment(family, preset, **engine_kw)
    return LLMFleet(
        dep.func_or_class, num_replicas,
        name=name,
        block_size=int(engine_kw.get("kv_block_size", 16)),
        tenants=tenants, policy=routing, wfq=wfq,
        autoscale=autoscale,
        max_inflight_per_replica=max_inflight_per_replica, seed=seed,
        health=health, chaos=chaos)
