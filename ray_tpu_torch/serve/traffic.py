"""Synthetic serve traffic: seeded Poisson arrivals over shared-prefix
prompt mixtures.

A copy of ``ray_tpu/serve/traffic.py`` driving the port's engine and
fleet: one seed gives the JAX package's requests bit for bit (the same
``np.random.RandomState`` draws in the same order).

Serving benchmarks lie unless the offered load looks like production:
requests arrive in bursts (Poisson, not back-to-back), prompts cluster
around a few hot system-prompt prefixes (what the paged KV cache's
prefix reuse exists for), and lengths are ragged.  This module is the
single source of that workload for the port's tests and
``chip_smoke.py``'s phase serve-fleet (the port's ``bench.py
--traffic`` is ROADMAP.md queue 1 item 7.1) — everything is derived from
one integer seed, so a run is reproducible down to the token.

Pieces:

* :class:`TrafficSpec` — the workload knobs (rate, prefix groups,
  length distributions), a frozen dataclass so specs can be shared;
* :class:`TrafficGenerator` — expands a spec into concrete
  ``TrafficRequest`` records (arrival offset + int32 prompt array);
* :func:`drive` — fires the requests at an engine instance on their
  (optionally time-scaled) arrival schedule and measures per-request
  latency, shed count, and SLO attainment;
* :func:`run_traffic` — sync wrapper: builds the LLM deployment,
  drives it, merges ``engine_stats()`` into the report.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional

import numpy as np

from ray_tpu_torch._private.telemetry import summarize
from ray_tpu_torch.device import DeviceLike
from ray_tpu_torch.serve.batching import OverloadedError

__all__ = ["TrafficSpec", "TenantSpec", "TrafficRequest",
           "TrafficGenerator", "drive", "drive_fleet", "run_traffic",
           "run_traffic_fleet"]

#: default WFQ weights by SLO class — interactive overtakes batch
#: whenever both are backlogged at the fleet router
_CLASS_WEIGHTS = {"interactive": 8.0, "batch": 1.0}


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """One traffic class inside a multi-tenant mixture.

    `rate_share` is the tenant's relative share of the spec's offered
    rate (normalized over all tenants); `slo_class` picks the fleet
    router's default WFQ weight ("interactive" | "batch", overridable
    via `weight`); `prefix_groups` restricts the tenant to a subset of
    the spec's shared-prefix pool (its own "system prompts" — empty =
    the whole pool); `ttft_slo_ms` / `e2e_slo_ms` are the per-tenant
    latency targets scored by ``LLMFleet.tenant_report()``.

    `prompt_len` makes this a long-prompt tenant: its requests draw a
    fixed `prompt_len`-token user turn instead of the spec's Poisson
    tail (total prompt = shared prefix + prompt_len when the request
    extends a prefix) — the batch-floods-interactive mixture the
    chunked-prefill A/B needs.  When unset (every legacy spec) the
    draw order is untouched, so the RNG stream stays bit-identical.

    `prefix_pool` makes this a cache-churn tenant: its shared-prefix
    requests rotate round-robin through a private pool of N distinct
    `prefix_len`-token prefixes (drawn from a SEPARATE seeded stream)
    instead of the spec's `num_prefix_groups` — size N past what the
    pager's LRU pool can park and every rotation lap re-prefills
    evicted content, the reproducible thrash kvscope's re-prefill
    waste accounting is tested against.  Mutually exclusive with
    `prefix_groups`; when unset (every legacy spec) the main RNG
    stream stays bit-identical."""

    name: str
    rate_share: float = 1.0
    slo_class: str = "interactive"
    prefix_groups: tuple = ()
    ttft_slo_ms: Optional[float] = None
    e2e_slo_ms: Optional[float] = None
    objective: float = 0.95
    weight: Optional[float] = None
    prompt_len: Optional[int] = None
    prefix_pool: Optional[int] = None

    def __post_init__(self):
        if self.rate_share <= 0:
            raise ValueError(f"tenant {self.name!r}: rate_share must "
                             "be > 0")
        if self.prompt_len is not None and self.prompt_len < 1:
            raise ValueError(f"tenant {self.name!r}: prompt_len must "
                             "be >= 1 when set")
        if self.prefix_pool is not None:
            if self.prefix_pool < 1:
                raise ValueError(
                    f"tenant {self.name!r}: prefix_pool must be >= 1 "
                    "when set")
            if self.prefix_groups:
                raise ValueError(
                    f"tenant {self.name!r}: prefix_pool and "
                    "prefix_groups are mutually exclusive (a churn "
                    "tenant rotates its own private prefixes)")
        if self.slo_class not in _CLASS_WEIGHTS:
            raise ValueError(
                f"tenant {self.name!r}: slo_class must be one of "
                f"{sorted(_CLASS_WEIGHTS)}, got {self.slo_class!r}")
        object.__setattr__(self, "prefix_groups",
                           tuple(int(g) for g in self.prefix_groups))

    def to_class(self):
        """The router-side TenantClass this spec maps to."""
        from ray_tpu_torch.serve.router import TenantClass

        return TenantClass(
            self.name,
            weight=self.weight if self.weight is not None
            else _CLASS_WEIGHTS[self.slo_class],
            ttft_ms=self.ttft_slo_ms, e2e_ms=self.e2e_slo_ms,
            objective=self.objective)


@dataclasses.dataclass(frozen=True)
class TrafficSpec:
    """Knobs for one synthetic workload.  All randomness flows from
    ``seed`` through one ``np.random.RandomState``, so equal specs
    generate equal traffic on any host."""

    num_requests: int = 32
    seed: int = 0
    #: Poisson arrival rate (requests/second of *modeled* time);
    #: ``drive(time_scale=...)`` compresses it for fast tests.
    rate_rps: float = 50.0
    #: distinct shared prefixes ("system prompts") in the mixture
    num_prefix_groups: int = 4
    #: tokens per shared prefix (block-aligned values exercise full
    #: reuse; off-aligned values exercise the COW boundary)
    prefix_len: int = 32
    #: probability a request extends one of the shared prefixes
    #: (otherwise its whole prompt is unique)
    p_shared: float = 0.75
    #: request tail (user turn) length ~ 1 + Poisson(mean - 1)
    tail_len_mean: float = 8.0
    tail_len_max: int = 24
    vocab: int = 256
    #: multi-tenant mixture: each request is assigned a tenant in
    #: proportion to rate_share, drawing its shared prefix from the
    #: tenant's pool.  Empty = legacy single-class traffic (the RNG
    #: stream is then bit-identical to pre-tenant specs).
    tenants: tuple = ()

    def __post_init__(self):
        if self.num_requests < 1:
            raise ValueError("num_requests must be >= 1")
        if self.rate_rps <= 0:
            raise ValueError("rate_rps must be > 0")
        if not 0.0 <= self.p_shared <= 1.0:
            raise ValueError("p_shared must be in [0, 1]")
        object.__setattr__(self, "tenants", tuple(self.tenants))
        names = [t.name for t in self.tenants]
        if len(names) != len(set(names)):
            raise ValueError(f"duplicate tenant names: {names}")
        for t in self.tenants:
            for g in t.prefix_groups:
                if not 0 <= g < self.num_prefix_groups:
                    raise ValueError(
                        f"tenant {t.name!r}: prefix group {g} out of "
                        f"range [0, {self.num_prefix_groups})")


@dataclasses.dataclass
class TrafficRequest:
    arrival_s: float          # offset from the start of the run
    prompt: np.ndarray        # int32 (len,)
    group: int                # shared-prefix group id, -1 = unique
    tenant: str = ""          # traffic class, "" = untagged


class TrafficGenerator:
    """Expands a :class:`TrafficSpec` into a concrete request list."""

    def __init__(self, spec: TrafficSpec):
        self.spec = spec
        self._rng = np.random.RandomState(spec.seed)
        # tokens drawn from [2, vocab): 0/1 stay reserved so traffic
        # never collides with pad/bos conventions in the model zoo
        self.prefixes = [
            self._rng.randint(2, spec.vocab, size=spec.prefix_len)
            .astype(np.int32)
            for _ in range(spec.num_prefix_groups)]
        # churn tenants (prefix_pool=N): each gets a private pool of N
        # prefixes from its own seeded stream, so the main RNG stream
        # above (and therefore every legacy draw) is untouched
        self.tenant_pools: Dict[str, List[np.ndarray]] = {}
        for i, t in enumerate(spec.tenants):
            if t.prefix_pool is None:
                continue
            pool_rng = np.random.RandomState(spec.seed + 7919 * (i + 1))
            self.tenant_pools[t.name] = [
                pool_rng.randint(2, spec.vocab, size=spec.prefix_len)
                .astype(np.int32) for _ in range(t.prefix_pool)]

    def requests(self) -> List[TrafficRequest]:
        spec, rng = self.spec, self._rng
        inter = rng.exponential(1.0 / spec.rate_rps,
                                size=spec.num_requests)
        arrivals = np.cumsum(inter)
        shares = None
        if spec.tenants:
            shares = np.array([t.rate_share for t in spec.tenants],
                              dtype=np.float64)
            shares = np.cumsum(shares / shares.sum())
        out: List[TrafficRequest] = []
        #: per-tenant round-robin cursor over its churn pool — a local
        #: so repeated requests() calls replay identically
        pool_rr: Dict[str, int] = {}
        for i in range(spec.num_requests):
            tenant, pool, plen, churn = "", None, None, None
            if shares is not None:
                idx = min(int(np.searchsorted(shares, rng.rand())),
                          len(spec.tenants) - 1)
                t = spec.tenants[idx]
                tenant = t.name
                pool = t.prefix_groups or None
                plen = t.prompt_len
                churn = self.tenant_pools.get(t.name)
            tail_len = 1 + min(int(rng.poisson(
                max(spec.tail_len_mean - 1.0, 0.0))),
                spec.tail_len_max - 1)
            if plen is not None:
                # long-prompt tenant: the Poisson draw above still
                # happens (keeps the stream aligned with prompt_len
                # unset), only the drawn size changes
                tail_len = plen
            tail = rng.randint(2, spec.vocab,
                               size=tail_len).astype(np.int32)
            if spec.num_prefix_groups > 0 \
                    and rng.rand() < spec.p_shared:
                if churn is not None:
                    # churn tenant: the group draw below still happens
                    # (keeps the stream aligned for co-tenants), but
                    # the prefix comes from the tenant's private pool,
                    # rotated round-robin so a bounded pager pool is
                    # forced through deterministic LRU eviction laps
                    rng.randint(spec.num_prefix_groups)
                    p_idx = pool_rr.get(tenant, 0)
                    pool_rr[tenant] = p_idx + 1
                    group = -2 - (p_idx % len(churn))
                    prompt = np.concatenate(
                        [churn[p_idx % len(churn)], tail])
                elif pool is not None:
                    group = int(pool[rng.randint(len(pool))])
                    prompt = np.concatenate([self.prefixes[group],
                                             tail])
                else:
                    group = int(rng.randint(spec.num_prefix_groups))
                    prompt = np.concatenate([self.prefixes[group],
                                             tail])
            else:
                group, prompt = -1, tail
            out.append(TrafficRequest(float(arrivals[i]), prompt,
                                      group, tenant))
        return out


async def drive(instance, requests: List[TrafficRequest], *,
                time_scale: float = 1.0,
                latency_slo_ms: Optional[float] = None
                ) -> Dict[str, Any]:
    """Fire `requests` at a deployment instance (``async __call__``
    taking one prompt array) on their arrival schedule.

    time_scale scales modeled arrival offsets to wall time (0.01 turns
    a 50 rps modeled workload into a burst for tests); 0 fires
    everything immediately.  Sheds (:class:`OverloadedError`) are
    counted, not raised.  Returns a report dict with latency
    percentiles over completed requests and, when ``latency_slo_ms``
    is set, the fraction that finished inside the SLO."""
    import asyncio

    t0 = time.perf_counter()

    async def one(req: TrafficRequest) -> Dict[str, Any]:
        delay = req.arrival_s * time_scale - (time.perf_counter() - t0)
        if delay > 0:
            await asyncio.sleep(delay)
        start = time.perf_counter()
        try:
            # the tenant tag rides into engine telemetry so per-class
            # anatomy (TTFT p99 by tenant) works without a fleet router
            if req.tenant:
                await instance(req.prompt, tenant=req.tenant)
            else:
                await instance(req.prompt)
        except OverloadedError:
            return {"shed": True, "latency_ms": None}
        return {"shed": False,
                "latency_ms": (time.perf_counter() - start) * 1e3}

    results = await asyncio.gather(*[one(r) for r in requests])
    lat = [r["latency_ms"] for r in results if not r["shed"]]
    shed = sum(1 for r in results if r["shed"])
    report: Dict[str, Any] = {
        "offered": len(requests),
        "completed": len(lat),
        "shed": shed,
        "latency_ms": summarize(lat),
        "wall_s": round(time.perf_counter() - t0, 4),
    }
    if latency_slo_ms is not None:
        report["latency_slo_ms"] = latency_slo_ms
        report["slo_attainment"] = round(
            sum(1 for v in lat if v <= latency_slo_ms) / len(lat), 4) \
            if lat else 0.0
    return report


def run_traffic(spec: TrafficSpec, *, family: str = "gpt2",
                preset: str = "nano", kv_layout: str = "paged",
                kv_block_size: int = 16,
                kv_num_blocks: Optional[int] = None,
                max_slots: int = 4,
                max_new_tokens: int = 8, prefill_bucket: int = 16,
                prefill_chunk_tokens: Optional[int] = None,
                kv_host_tier_bytes: Optional[int] = None,
                time_scale: float = 0.0,
                latency_slo_ms: Optional[float] = None,
                admission_policy=None, slo=None, spec_decode=None,
                mesh=None,
                config_overrides: Optional[Dict[str, Any]] = None,
                trace_dump: Optional[str] = None,
                device: DeviceLike = None
                ) -> Dict[str, Any]:
    """One synthetic-traffic run against a fresh in-process engine
    (no serve cluster: the deployment class is instantiated directly,
    same trick the serve tests use).  Returns the :func:`drive` report
    plus the engine's ``engine_stats()`` snapshot — prefix-hit rate
    and kv_cache occupancy ride along when ``kv_layout="paged"``.
    `mesh` tensor-parallelises the engine (see build_llm_deployment);
    the report then carries the engine's mesh block for per-chip
    normalisation downstream (bench --traffic, SWEEPJSON).

    `latency_slo_ms` keeps the legacy client-side measure: the single
    ``slo_attainment`` fraction of completed requests inside one e2e
    latency bound.  `slo` (a serve.slo.SLOConfig) is the engine-side
    richer form — per-objective (TTFT / e2e / queue-wait) attainment
    lands in ``report["slo"]`` and burn rates in
    ``report["engine"]["slo"]``.  `spec_decode` (a SpecConfig) runs
    the traffic through the speculative engine; accept-rate/rounds
    then ride in ``report["spec_accept_rate"]``/``["spec_rounds"]`` so
    ledger series cover spec+traffic runs.

    `prefill_chunk_tokens` enables chunked streaming prefill (paged
    layout only — see build_llm_deployment); the report then carries
    the engine's ``prefill_chunks`` counter block and per-tenant
    ``{tenant}_ttft_ms_p99`` fields so sweeps can A/B the chunk size
    against interactive-tenant TTFT.

    `kv_host_tier_bytes` enables the tiered host-RAM KV cache (see
    build_llm_deployment); ``report["kv_tier_hit_rate"]`` then rides
    along so sweeps can A/B the tier budget against
    ``reprefill_waste_frac`` on churn traffic.

    `device` is the engine's (None = the first CUDA device; "cpu" must
    be asked for).  Under a mesh of several ranks every rank calls it
    with the same arguments: the mesh's first rank drives the traffic
    and returns the report, the others follow its engine and return
    None (build_llm_deployment's mesh contract)."""
    import asyncio

    from ray_tpu_torch.serve.llm import build_llm_deployment

    dep = build_llm_deployment(
        family, preset, scheduler="continuous", max_slots=max_slots,
        max_new_tokens=max_new_tokens, temperature=0.0,
        prefill_bucket=prefill_bucket, kv_layout=kv_layout,
        kv_block_size=kv_block_size, kv_num_blocks=kv_num_blocks,
        prefill_chunk_tokens=prefill_chunk_tokens,
        kv_host_tier_bytes=kv_host_tier_bytes,
        admission_policy=admission_policy, slo=slo,
        spec_decode=spec_decode, mesh=mesh,
        config_overrides=config_overrides, device=device)
    requests = TrafficGenerator(spec).requests()
    inst = dep.func_or_class()
    if not inst.is_leader:
        inst.follow()
        return None

    async def main():
        try:
            report = await drive(inst, requests,
                                 time_scale=time_scale,
                                 latency_slo_ms=latency_slo_ms)
            report["engine"] = inst.engine_stats()
            if trace_dump:  # tracebus snapshot, pre-shutdown
                from ray_tpu_torch.tools import tracebus

                tracebus.write_dump(tracebus.collect(inst),
                                    trace_dump)
        finally:
            inst.shutdown_engine()
        return report

    report = asyncio.run(main())
    report["spec"] = dataclasses.asdict(spec)
    report["kv_layout"] = kv_layout
    eng = report["engine"]
    kv = eng.get("kv_cache") or {}
    report["prefix_hit_rate"] = kv.get("prefix_hit_rate", 0.0)
    # kvscope headlines: cache pressure (occupancy) and cache-thrash
    # waste (fraction of prefilled tokens that re-filled previously
    # resident prefixes), flattened for SWEEPJSON consumers
    scope_blk = eng.get("kv_scope") or {}
    report["kv_occupancy_p95"] = \
        (scope_blk.get("occupancy") or {}).get("occupancy_p95", 0.0)
    report["reprefill_waste_frac"] = \
        (scope_blk.get("forensics") or {}).get(
            "reprefill_waste_frac", 0.0)
    # host-tier headline: fraction of second-chance probes that
    # restored a block via H2D instead of re-prefilling (0.0 when the
    # tier is off — the field is always present for sweep identity)
    report["kv_tier_hit_rate"] = \
        (eng.get("kv_tier") or {}).get("hit_rate", 0.0)
    # engine-side SLO: per-objective attainment (TTFT + e2e + queue
    # wait as configured), flattened for SWEEPJSON consumers
    slo_block = eng.get("slo")
    if isinstance(slo_block, dict):
        report["slo"] = {
            name: {"target_ms": obj["target_ms"],
                   "attainment": obj["attainment"],
                   "burn_rate": obj["burn_rate"]}
            for name, obj in slo_block["objectives"].items()}
    if spec_decode is not None:
        sp = eng.get("spec") or {}
        report["spec_accept_rate"] = sp.get("accept_rate")
        report["spec_rounds"] = sp.get("rounds")
    report["prefill_chunk_tokens"] = prefill_chunk_tokens
    if eng.get("prefill_chunks"):
        report["prefill_chunks"] = eng["prefill_chunks"]
    _flatten_anatomy(report, eng.get("latency_anatomy"))
    # per-tenant TTFT percentiles, flattened for SWEEPJSON consumers
    # ({tenant}_ttft_ms_p99 — the chunked-prefill headline metric)
    by_tenant = (eng.get("latency_anatomy") or {}).get(
        "by_tenant") or {}
    for tname, blk in by_tenant.items():
        ttft = blk.get("ttft_ms") or {}
        report[f"{tname}_ttft_ms_p99"] = ttft.get("p99")
    return report


#: TTFT-side legs of the tracebus critical path (everything before the
#: first token; the decode-side legs are inter_token + spec_rollback)
_TTFT_COMPONENTS = ("router_wait_ms", "queue_wait_ms", "requeue_ms",
                    "kv_fetch_ms", "prefill_ms", "prefill_wait_ms")


def _flatten_anatomy(report: Dict[str, Any],
                     anatomy: Optional[Dict[str, Any]]) -> None:
    """Lift the headline tracebus numbers out of a latency_anatomy
    block into top-level report fields (itl_ms_p50/p99 +
    ttft_critical_path) for SWEEPJSON consumers."""
    anatomy = anatomy or {}
    report["latency_anatomy"] = anatomy
    itl = anatomy.get("itl_ms") or {}
    report["itl_ms_p50"] = itl.get("p50")
    report["itl_ms_p99"] = itl.get("p99")
    cp = anatomy.get("critical_path") or {}
    ttft: Dict[str, Any] = {k: (cp.get(k) or {}).get("p99")
                            for k in _TTFT_COMPONENTS}
    vals = [v for v in ttft.values() if v is not None]
    ttft["total_p99_ms"] = round(sum(vals), 3) if vals else None
    report["ttft_critical_path"] = ttft


async def drive_fleet(fleet, requests: List[TrafficRequest], *,
                      time_scale: float = 1.0) -> Dict[str, Any]:
    """:func:`drive` for an :class:`~ray_tpu_torch.serve.router.LLMFleet`:
    requests carry their tenant tag into the router (WFQ class +
    per-tenant SLO slicing).  Client-side latency percentiles are
    reported overall and per tenant; engine-side per-tenant attainment
    comes from ``fleet.tenant_report()`` afterwards."""
    import asyncio

    t0 = time.perf_counter()

    async def one(req: TrafficRequest) -> Dict[str, Any]:
        delay = req.arrival_s * time_scale - (time.perf_counter() - t0)
        if delay > 0:
            await asyncio.sleep(delay)
        start = time.perf_counter()
        try:
            await fleet(req.prompt, tenant=req.tenant or None)
        except OverloadedError:
            return {"shed": True, "tenant": req.tenant,
                    "latency_ms": None}
        return {"shed": False, "tenant": req.tenant,
                "latency_ms": (time.perf_counter() - start) * 1e3}

    results = await asyncio.gather(*[one(r) for r in requests])
    lat = [r["latency_ms"] for r in results if not r["shed"]]
    by_tenant: Dict[str, List[float]] = {}
    for r in results:
        if not r["shed"]:
            by_tenant.setdefault(r["tenant"] or "default",
                                 []).append(r["latency_ms"])
    return {
        "offered": len(requests),
        "completed": len(lat),
        "shed": sum(1 for r in results if r["shed"]),
        "latency_ms": summarize(lat),
        "latency_ms_by_tenant": {t: summarize(v)
                                 for t, v in by_tenant.items()},
        "wall_s": round(time.perf_counter() - t0, 4),
    }


def run_traffic_fleet(spec: TrafficSpec, *, num_replicas: int = 2,
                      num_prefill_replicas: Optional[int] = None,
                      num_decode_replicas: Optional[int] = None,
                      prefill_engine_kw: Optional[Dict[str, Any]] = None,
                      decode_engine_kw: Optional[Dict[str, Any]] = None,
                      handoff_staged: bool = False,
                      family: str = "gpt2", preset: str = "nano",
                      kv_block_size: int = 16,
                      kv_num_blocks: Optional[int] = None,
                      kv_host_tier_bytes: Optional[int] = None,
                      max_slots: int = 4,
                      max_new_tokens: int = 8,
                      prefill_bucket: int = 16,
                      time_scale: float = 0.0,
                      routing: str = "prefix", wfq: bool = True,
                      autoscale=None, slo=None, admission_policy=None,
                      mesh=None,
                      config_overrides: Optional[Dict[str, Any]] = None,
                      trace_dump: Optional[str] = None,
                      health=None, chaos=None,
                      max_inflight_per_replica: Optional[int] = None,
                      device: DeviceLike = None
                      ) -> Dict[str, Any]:
    """One multi-tenant traffic run against a fresh in-process fleet
    (``build_llm_fleet``): N paged continuous engines behind the
    prefix-affinity router with WFQ tenant classes.  The report merges
    the client-side :func:`drive_fleet` numbers with the fleet's own
    stats — ``router_prefix_hit_rate`` (pooled over replicas) and
    ``tenants`` (per-tenant SLO attainment) are the headline fields
    bench/sweep publish.

    Setting both `num_prefill_replicas` and `num_decode_replicas`
    runs the DISAGGREGATED fleet instead (role-split replica sets with
    block-granular KV handoff — see build_llm_fleet); the report then
    carries ``handoff_ms_p99`` (the pooled handoff leg of the critical
    path), the fleet ``handoff`` counter block, and ``{role}_``-
    prefixed pool-utilization lines so a sweep can A/B disagg vs
    homogeneous at equal chip count.  `prefill_engine_kw` /
    `decode_engine_kw` overlay per-role engine knobs (mesh degree,
    batch shape, slot count); `handoff_staged` forces the D2H→H2D
    host-staging hop.

    `health` (a serve.health.HealthConfig) tunes the fleet's
    healthwatch monitor; `chaos` (a serve.chaos.ChaosConfig) injects
    seeded faults mid-traffic — the report then carries
    ``time_to_detect_ms`` (fault instant → DEAD transition) and
    ``requests_requeued_on_death`` so sweeps can track detection
    latency as a first-class metric (Podracer treats it as one).

    `device` is every replica's (None = the first CUDA device).  A
    `mesh` is every replica's; it must be of one rank, else ValueError:
    a mesh's follower ranks run the programs of engines built alike on
    every rank, and a fleet adds and drops replicas on the leader
    alone."""
    import asyncio

    from ray_tpu_torch.serve.router import build_llm_fleet

    if mesh is not None and mesh.size() > 1:
        raise ValueError(
            "run_traffic_fleet takes a mesh of one rank: a fleet adds "
            "and drops replicas on the mesh's first rank alone")

    fleet = build_llm_fleet(
        family, preset, num_replicas=num_replicas,
        num_prefill_replicas=num_prefill_replicas,
        num_decode_replicas=num_decode_replicas,
        prefill_engine_kw=prefill_engine_kw,
        decode_engine_kw=decode_engine_kw,
        handoff_staged=handoff_staged,
        tenants=[t.to_class() for t in spec.tenants],
        routing=routing, wfq=wfq, autoscale=autoscale,
        max_slots=max_slots, max_new_tokens=max_new_tokens,
        temperature=0.0, prefill_bucket=prefill_bucket,
        kv_block_size=kv_block_size, kv_num_blocks=kv_num_blocks,
        kv_host_tier_bytes=kv_host_tier_bytes, slo=slo,
        admission_policy=admission_policy, mesh=mesh,
        config_overrides=config_overrides, health=health, chaos=chaos,
        max_inflight_per_replica=max_inflight_per_replica, device=device)
    requests = TrafficGenerator(spec).requests()

    async def main():
        try:
            report = await drive_fleet(fleet, requests,
                                       time_scale=time_scale)
            report["fleet"] = fleet.fleet_stats()
            if trace_dump:  # tracebus snapshot, pre-shutdown
                from ray_tpu_torch.tools import tracebus

                tracebus.write_dump(tracebus.collect(fleet),
                                    trace_dump)
        finally:
            fleet.shutdown()
        return report

    report = asyncio.run(main())
    report["spec"] = dataclasses.asdict(spec)
    report["num_replicas"] = num_replicas
    report["num_prefill_replicas"] = num_prefill_replicas
    report["num_decode_replicas"] = num_decode_replicas
    report["handoff_staged"] = handoff_staged
    report["routing"] = routing
    report["wfq"] = wfq
    report["router_prefix_hit_rate"] = \
        report["fleet"]["prefix_hit_rate"]
    # fleet-pooled kvscope headlines (see fleet_stats()["kv_scope"])
    fleet_scope = report["fleet"].get("kv_scope") or {}
    report["kv_occupancy_p95"] = \
        fleet_scope.get("occupancy_p95", 0.0)
    report["reprefill_waste_frac"] = \
        fleet_scope.get("reprefill_waste_frac", 0.0)
    # fleet-pooled host-tier headline (see fleet_stats()["kv_tier"])
    report["kv_tier_hit_rate"] = \
        (report["fleet"].get("kv_tier") or {}).get("hit_rate", 0.0)
    # role-aware pool utilization: one `{role}_`-prefixed line per
    # replica role so a disagg run's decode-pool pressure is never
    # averaged into the prefill pools' churn (monolithic fleets emit
    # the single `both_` role)
    for role, occ in (fleet_scope.get("occupancy_by_role")
                      or {}).items():
        report[f"{role}_kv_occupancy_mean"] = occ.get("mean", 0.0)
        report[f"{role}_kv_occupancy_p95"] = occ.get("p95", 0.0)
    # disaggregation headlines: the fleet handoff counter block and
    # the pooled handoff leg of the critical path (0.0 on homogeneous
    # fleets so sweep identity stays stable)
    report["handoff"] = report["fleet"].get("handoff")
    cp_blk = (report["fleet"].get("latency_anatomy") or {}).get(
        "critical_path") or {}
    report["handoff_ms_p99"] = \
        (cp_blk.get("handoff_ms") or {}).get("p99") or 0.0
    # healthwatch headlines: fault-injection detection latency and
    # queue rescues (None/0 on chaos-free runs so sweep identity
    # stays stable — the fields are always present)
    health_blk = report["fleet"].get("health") or {}
    report["time_to_detect_ms"] = health_blk.get("time_to_detect_ms")
    report["requests_requeued_on_death"] = int(
        health_blk.get("requeued_on_death", 0))
    report["tenants"] = report["fleet"]["tenants"]
    #: flattened for SWEEPJSON consumers: {tenant}_{obj}_slo_attainment
    flat: Dict[str, Any] = {}
    for tname, blk in report["tenants"].items():
        for obj, o in blk["objectives"].items():
            flat[f"{tname}_{obj}_slo_attainment"] = o["attainment"]
    report["tenant_slo_attainment"] = flat
    _flatten_anatomy(report, report["fleet"].get("latency_anatomy"))
    by_tenant = (report["fleet"].get("latency_anatomy") or {}).get(
        "by_tenant") or {}
    for tname, blk in by_tenant.items():
        ttft = blk.get("ttft_ms") or {}
        report[f"{tname}_ttft_ms_p99"] = ttft.get("p99")
    return report
