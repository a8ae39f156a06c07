"""Engine telemetry for the LM serving hot path.

A copy of ``ray_tpu/serve/telemetry.py``: the same records, keys,
metric names and env knobs (``RAYTPU_TRACEBUS``), so the port's
``engine_stats()`` compares with the JAX engine's key for key.  Only
the ``device`` (roofline) block names the port's own device.

Every request through ``serve/llm.py`` carries a lifecycle record —
enqueue → admit → prefill-done (first token) → per-decode-step →
finish / reject — and the continuous-batching engine reports each
transition here.  Three sinks hang off those records:

1. **util/metrics.py** Histograms / Counters / Gauges (TTFT, queue
   wait, inter-token latency, slot occupancy, queue depth,
   admissions/rejections, tokens, and a recompile counter keyed by
   prefill bucket) in the process-local registry
   (``metrics_snapshot()``), which the registry's publisher pushes
   to the GCS KV for ``collect_cluster_metrics``.
2. **engine_stats()** — an on-demand snapshot (p50/p95/p99 TTFT and
   queue wait, throughput, slot utilization, request counts) exposed as
   a deployment method and aggregated at ``/api/serve/stats``.
3. **export_timeline()** — a chrome-trace exporter rendering engine
   steps, per-slot occupancy lanes, and per-request spans in the same
   format as the JAX package's task timeline, so engine activity and
   task activity open in one Perfetto view.

A completed request's e2e latency decomposes exactly into the
critical-path components (``critical_path``; ``CRITICAL_PATH_COMPONENTS``):
``router_wait_ms``, ``queue_wait_ms``, ``requeue_ms``, ``kv_fetch_ms``,
``prefill_ms``, ``prefill_wait_ms``, ``handoff_ms``, ``inter_token_ms``
and ``spec_rollback_ms``.

Everything is host-side bookkeeping (dict/deque appends plus a
histogram observe) timed around syncs the engine already performs; the
prefill/decode programs are untouched and no device syncs are added.  When ``util/tracing.py`` is enabled, each request records a
root span at enqueue and a child span at finish, linking the serve
request to its engine work.
"""

from __future__ import annotations

import collections
import itertools
import os
import threading
import time
import uuid
from typing import Any, Deque, Dict, List, Optional

from ray_tpu_torch._private import telemetry as _core
from ray_tpu_torch._private.flightrec import FlightRecorder
from ray_tpu_torch.serve.health import empty_health as _empty_health
from ray_tpu_torch.serve.kv_tier import empty_kv_tier as _empty_kv_tier
from ray_tpu_torch.serve.kvscope import empty_kv_scope as _empty_kv_scope
from ray_tpu_torch.util import tracing

#: ms boundaries for request-level latencies (TTFT, queue wait, total)
_LATENCY_BOUNDS_MS = (1.0, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0,
                      1000.0, 2500.0, 5000.0, 10000.0)
#: ms boundaries for per-decode-step (inter-token) latency
_STEP_BOUNDS_MS = (0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0,
                   500.0, 1000.0)

_metrics_lock = threading.Lock()
_metrics: Optional[Dict[str, Any]] = None

_roofline_cache: Optional[Dict[str, Any]] = None


def _device_roofline() -> Optional[Dict[str, Any]]:
    """This process's roofline constants (peak FLOPs, HBM bandwidth,
    ridge point), cached after first success — engine_stats() is called
    per scrape and the constants cannot change under a live backend.
    None when the lookup itself fails (stats must never raise)."""
    global _roofline_cache
    if _roofline_cache is None:
        try:
            from ray_tpu_torch._private.device_stats import device_roofline

            _roofline_cache = device_roofline()
        except Exception:  # noqa: BLE001 - stats are best-effort
            return None
    return dict(_roofline_cache)


def _engine_metrics() -> Dict[str, Any]:
    """Process-wide metric singletons (one registration per name no
    matter how many deployments/telemetry instances this process hosts
    — the registry warns on duplicate names)."""
    global _metrics
    with _metrics_lock:
        if _metrics is None:
            from ray_tpu_torch.util.metrics import Counter, Gauge, Histogram

            tags = ("deployment",)
            _metrics = {
                "ttft": Histogram(
                    "serve_ttft_ms",
                    "time to first token (enqueue -> prefill sample)",
                    boundaries=_LATENCY_BOUNDS_MS, tag_keys=tags),
                "queue_wait": Histogram(
                    "serve_queue_wait_ms",
                    "request wait in the admission queue",
                    boundaries=_LATENCY_BOUNDS_MS, tag_keys=tags),
                "inter_token": Histogram(
                    "serve_inter_token_ms",
                    "pooled decode step walltime",
                    boundaries=_STEP_BOUNDS_MS, tag_keys=tags),
                "latency": Histogram(
                    "serve_request_latency_ms",
                    "request latency (enqueue -> finish)",
                    boundaries=_LATENCY_BOUNDS_MS, tag_keys=tags),
                "active_slots": Gauge(
                    "serve_active_slots",
                    "KV slots decoding this engine step", tag_keys=tags),
                "queue_depth": Gauge(
                    "serve_queue_depth",
                    "requests waiting for a slot", tag_keys=tags),
                "slot_utilization": Gauge(
                    "serve_slot_utilization",
                    "time-weighted active/max slot fraction",
                    tag_keys=tags),
                "tokens_per_sec": Gauge(
                    "serve_tokens_per_sec",
                    "decode throughput over the step window",
                    tag_keys=tags),
                "admitted": Counter(
                    "serve_requests_admitted_total",
                    "requests admitted into a slot", tag_keys=tags),
                "finished": Counter(
                    "serve_requests_finished_total",
                    "requests finished", tag_keys=tags),
                "rejected": Counter(
                    "serve_requests_rejected_total",
                    "requests rejected at admission, labeled by reason "
                    "(oversized / shed_* / invalid)",
                    tag_keys=("deployment", "reason")),
                "errors": Counter(
                    "serve_requests_errored_total",
                    "requests failed by an engine error", tag_keys=tags),
                "tokens": Counter(
                    "serve_tokens_generated_total",
                    "decode tokens sampled", tag_keys=tags),
                "prefill_compiles": Counter(
                    "serve_prefill_compiles_total",
                    "first-seen prefill bucket shapes (one compile "
                    "event each)", tag_keys=("deployment", "bucket")),
                "program_compiles": Counter(
                    "serve_program_compile_events_total",
                    "compile events by engine program name "
                    "(prefill / decode / sharded_decode / ...) — the "
                    "recompile counter beyond prefill buckets, fed by "
                    "the device_stats program registry",
                    tag_keys=("deployment", "program")),
                "prefix_hits": Counter(
                    "serve_prefix_blocks_hit_total",
                    "prompt KV blocks served from the prefix cache "
                    "(prefill skipped)", tag_keys=tags),
                "prefix_misses": Counter(
                    "serve_prefix_blocks_miss_total",
                    "prompt KV blocks that had to be prefilled",
                    tag_keys=tags),
                "cow_copies": Counter(
                    "serve_kv_cow_copies_total",
                    "copy-on-write forks of shared KV blocks",
                    tag_keys=tags),
                "kv_blocks_in_use": Gauge(
                    "serve_kv_blocks_in_use",
                    "pool blocks referenced by live sequences",
                    tag_keys=tags),
                "spec_proposed": Counter(
                    "serve_spec_tokens_proposed_total",
                    "draft tokens proposed to the spec-decode "
                    "verifier", tag_keys=tags),
                "spec_accepted": Counter(
                    "serve_spec_tokens_accepted_total",
                    "draft tokens the target model accepted",
                    tag_keys=tags),
                "spec_rounds": Counter(
                    "serve_spec_rounds_total",
                    "speculative propose+verify rounds (one target "
                    "dispatch each)", tag_keys=tags),
                "kv_occupancy": Gauge(
                    "serve_kv_occupancy_ratio",
                    "fraction of the usable KV pool (null block "
                    "excluded) held in-use or parked in the LRU "
                    "cache", tag_keys=tags),
                "kv_fragmentation": Gauge(
                    "serve_kv_fragmentation",
                    "largest-contiguous-free-run deficit of the KV "
                    "pool (0 = one contiguous run, ->1 = shattered)",
                    tag_keys=tags),
                "kv_reprefill_waste": Counter(
                    "serve_kv_reprefill_waste_tokens_total",
                    "prompt tokens re-prefilled into blocks whose "
                    "content key was previously resident and evicted "
                    "(residual churn the host-RAM KV tier did not "
                    "absorb)", tag_keys=tags),
                "kv_tier_bytes": Gauge(
                    "serve_kv_tier_bytes_resident",
                    "bytes of evicted KV blocks resident in the "
                    "host-RAM tier (serve/kv_tier.py)", tag_keys=tags),
                "kv_tier_hit_rate": Gauge(
                    "serve_kv_tier_hit_rate",
                    "fraction of host-tier second-chance probes that "
                    "restored a block via H2D copy", tag_keys=tags),
                "kv_tier_restored": Counter(
                    "serve_kv_tier_tokens_restored_total",
                    "prompt tokens re-admitted from the host tier "
                    "via H2D copy instead of re-prefill",
                    tag_keys=tags),
            }
        return _metrics


def _tracebus_enabled() -> bool:
    """Tracebus bookkeeping (TraceContext + per-token timestamps) is
    always-on unless ``RAYTPU_TRACEBUS=0`` — same opt-out contract as
    the flight recorder, and guarded by the same <5% overhead test."""
    return os.environ.get("RAYTPU_TRACEBUS", "1") != "0"


class TraceContext:
    """Causal identity of one request across router → engine → device.

    Born at ``LLMRouter.submit`` (or at engine enqueue for a request
    that never crossed a router) and threaded alongside the existing
    ``enqueue_ts`` backdating path, so every component that touches the
    request can stamp spans onto one object.  All timestamps are on the
    process monotonic clock (``time.perf_counter``) — the same domain
    as telemetry, flightrec, and the device observatory, which is what
    lets the tracebus collector merge all three onto a single timeline.

    Span ids are ``"<trace_id>:<n>"`` with ``:0`` reserved for the
    implicit request-root span, so parent/child stitching needs no
    shared counter beyond the context itself (requests are pumped from
    a single event loop; the int bump is not contended)."""

    __slots__ = ("trace_id", "origin", "spans", "_n")

    def __init__(self, origin: str = "engine",
                 trace_id: Optional[str] = None):
        self.trace_id = trace_id or uuid.uuid4().hex[:16]
        self.origin = origin  # "router" | "engine"
        self.spans: List[Dict[str, Any]] = []
        self._n = 0

    @property
    def root_id(self) -> str:
        return f"{self.trace_id}:0"

    def span(self, name: str, start: float, end: float,
             parent: Optional[str] = None, **attrs: Any) -> str:
        self._n += 1
        sid = f"{self.trace_id}:{self._n}"
        self.spans.append({
            "name": name, "span_id": sid,
            "parent_id": parent or self.root_id,
            "start": float(start), "end": float(end), "attrs": attrs,
        })
        return sid


#: critical-path components; together with ``e2e_ms`` these are the
#: keys of every decomposition dict, and the components sum to
#: ``e2e_ms`` exactly (modulo float rounding) by construction.
CRITICAL_PATH_COMPONENTS = (
    "router_wait_ms", "queue_wait_ms", "requeue_ms", "kv_fetch_ms",
    "prefill_ms", "prefill_wait_ms", "handoff_ms", "inter_token_ms",
    "spec_rollback_ms")


def critical_path(rec: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    """Decompose one completed request's e2e latency:

        e2e = router_wait + queue_wait + requeue + kv_fetch + prefill
              + prefill_wait + handoff + inter_token + spec_rollback

    * router_wait — submit → engine enqueue (0 without a router);
    * queue_wait  — engine enqueue → admit, minus time spent requeued
      and minus the kv_fetch window below;
    * requeue     — first KV-exhaustion requeue → eventual admit;
    * kv_fetch    — H2D restore of host-tier KV blocks during this
      admission (serve/kv_tier.py; exactly 0 without a tier hit);
    * prefill     — admit → first token, or for chunked-prefill
      admissions the SUM of the per-chunk dispatch windows;
    * prefill_wait — the rest of admit → first token: time a chunked
      prefill spent parked between chunks while decode waves ran
      (exactly 0 for one-shot prefill);
    * handoff     — disaggregated serving only: prefill-side KV
      export → decode-side block install (serve/router.py two-stage
      dispatch), carved out of the decode leg it delays (exactly 0
      for monolithic engines);
    * inter_token — Σ inter-token gaps (first token → finish), minus
      the estimated rollback share below and the handoff window;
    * spec_rollback — decode time attributed to rejected draft
      positions in speculative verify rounds.

    Timestamps are clamped into the [enqueue, finish] window so a
    record driven by a synthetic test clock degrades to zeros instead
    of negative components.  None for incomplete/failed records."""
    if rec.get("finish") is None or rec.get("status") != "ok":
        return None
    if rec.get("admit") is None or rec.get("first_token") is None:
        return None
    enq, fin = rec["enqueue"], rec["finish"]
    e2e = max(0.0, fin - enq)
    t_eng = rec.get("engine_enqueue")
    t_eng = enq if t_eng is None else min(max(t_eng, enq), fin)
    admit = min(max(rec["admit"], t_eng), fin)
    first = min(max(rec["first_token"], admit), fin)
    router_wait = t_eng - enq
    wait = admit - t_eng
    requeue = 0.0
    rq_ts = rec.get("requeue_ts")
    if rq_ts is not None:
        requeue = min(max(0.0, admit - rq_ts), wait)
    # host-tier restore: the H2D window is carved out of the queue
    # leg it ran inside (admission work before record_admit), clamped
    # like every other component so synthetic clocks degrade to 0
    kv_fetch = 0.0
    kf = rec.get("kv_fetch")
    if kf is not None:
        kv_fetch = min(max(0.0, min(float(kf[1]), admit)
                           - max(float(kf[0]), t_eng)),
                       wait - requeue)
    queue_wait = wait - requeue - kv_fetch
    window = first - admit
    chunks = rec.get("prefill_chunks")
    if chunks:
        # chunked prefill: the prefill leg is the sum of the chunk
        # dispatch windows (clamped into [admit, first] so synthetic
        # clocks degrade gracefully); the residual of admit → first is
        # the parked time between chunks — decode waves ran there, so
        # it must not be billed as prefill compute
        prefill = min(window, sum(
            max(0.0, min(float(c[1]), first) - max(float(c[0]), admit))
            for c in chunks))
        prefill_wait = window - prefill
    else:
        prefill = window
        prefill_wait = 0.0
    decode = fin - first
    rollback = min(max(0.0, float(rec.get("spec_rollback_s") or 0.0)),
                   decode)
    # disaggregated handoff: the export→install window sits between
    # the prefill replica's first token and the decode replica's first
    # decode wave, so it is carved out of the decode leg it delayed
    # (clamped into [first, finish] like every other component)
    handoff = 0.0
    kh = rec.get("kv_handoff")
    if kh is not None:
        handoff = min(max(0.0, min(float(kh[1]), fin)
                          - max(float(kh[0]), first)),
                      decode - rollback)
    ms = 1e3
    return {
        "e2e_ms": round(e2e * ms, 4),
        "router_wait_ms": round(router_wait * ms, 4),
        "queue_wait_ms": round(queue_wait * ms, 4),
        "requeue_ms": round(requeue * ms, 4),
        "kv_fetch_ms": round(kv_fetch * ms, 4),
        "prefill_ms": round(prefill * ms, 4),
        "prefill_wait_ms": round(prefill_wait * ms, 4),
        "handoff_ms": round(handoff * ms, 4),
        "inter_token_ms": round((decode - rollback - handoff) * ms, 4),
        "spec_rollback_ms": round(rollback * ms, 4),
    }


def _token_gaps_ms(rec: Dict[str, Any]) -> List[float]:
    """Inter-token gaps (ms) from the per-token timestamp trail.
    Tokens emitted by one spec-verify dispatch share a timestamp, so
    their intra-round gaps are 0 — the single-dispatch reality."""
    ts = rec.get("token_ts")
    if not ts or len(ts) < 2:
        return []
    return [(b - a) * 1e3 for a, b in zip(ts, ts[1:])]


def request_snapshot(rec: Dict[str, Any],
                     deployment: Optional[str] = None
                     ) -> Dict[str, Any]:
    """Plain JSON-able view of one lifecycle record for the tracebus
    collector: hop timestamps, the token trail, router-side spans from
    the TraceContext, and the derived critical-path decomposition."""
    ctx = rec.get("ctx")
    kv = rec.get("kv_reserve")
    return {
        "request": (ctx.trace_id if ctx is not None
                    else f"req{rec['id']}"),
        "trace_id": ctx.trace_id if ctx is not None else None,
        "origin": ctx.origin if ctx is not None else "engine",
        "id": rec["id"],
        "deployment": deployment,
        "tenant": rec.get("tenant"),
        "status": rec.get("status"),
        "prompt_len": rec.get("prompt_len"),
        "tokens": rec.get("tokens", 0),
        "bucket": rec.get("bucket"),
        "slot": rec.get("slot"),
        "enqueue": rec.get("enqueue"),
        "engine_enqueue": rec.get("engine_enqueue"),
        "admit": rec.get("admit"),
        "first_token": rec.get("first_token"),
        "finish": rec.get("finish"),
        "token_ts": (list(rec["token_ts"])
                     if rec.get("token_ts") else None),
        "requeues": rec.get("requeues", 0),
        "requeue_ts": rec.get("requeue_ts"),
        "spec_rounds": rec.get("spec_rounds", 0),
        "spec_proposed": rec.get("spec_proposed", 0),
        "spec_accepted": rec.get("spec_accepted", 0),
        "spec_rollback_s": rec.get("spec_rollback_s", 0.0),
        "kv_reserve": list(kv) if kv is not None else None,
        "kv_fetch": (list(rec["kv_fetch"])
                     if rec.get("kv_fetch") is not None else None),
        "kv_handoff": (list(rec["kv_handoff"])
                       if rec.get("kv_handoff") is not None else None),
        "prefill_chunks": ([list(c) for c in rec["prefill_chunks"]]
                           if rec.get("prefill_chunks") else None),
        "spans": ([dict(s) for s in ctx.spans]
                  if ctx is not None else []),
        "critical_path": critical_path(rec),
        "itl_ms": _token_gaps_ms(rec),
    }


def empty_anatomy_samples() -> Dict[str, Any]:
    return {"itl_ms": [], "tpot_ms": [], "ttft_ms": [],
            "critical_path": {k: [] for k in
                              ("e2e_ms",) + CRITICAL_PATH_COMPONENTS},
            "tenants": []}


def merge_anatomy_samples(parts: List[Dict[str, Any]]
                          ) -> Dict[str, Any]:
    """Pool raw latency-anatomy samples across engines (fleet_stats
    aggregates replicas this way so fleet percentiles are computed
    over the union, not averaged per-replica summaries)."""
    out = empty_anatomy_samples()
    tenants: set = set()
    for p in parts:
        if not p:
            continue
        out["itl_ms"].extend(p.get("itl_ms", ()))
        out["tpot_ms"].extend(p.get("tpot_ms", ()))
        out["ttft_ms"].extend(p.get("ttft_ms", ()))
        for k, vals in p.get("critical_path", {}).items():
            out["critical_path"].setdefault(k, []).extend(vals)
        tenants.update(p.get("tenants", ()))
    out["tenants"] = sorted(tenants)
    return out


def latency_anatomy(samples: Dict[str, Any]) -> Dict[str, Any]:
    """Summarize raw anatomy samples into the stable
    ``engine_stats()["latency_anatomy"]`` shape (sans by_tenant)."""
    return {
        "requests": len(samples["critical_path"]["e2e_ms"]),
        "itl_ms": _core.summarize(samples["itl_ms"]),
        "tpot_ms": _core.summarize(samples["tpot_ms"]),
        "ttft_ms": _core.summarize(samples["ttft_ms"]),
        "critical_path": {k: _core.summarize(v) for k, v
                          in samples["critical_path"].items()},
    }


class EngineTelemetry:
    """Lifecycle recorder for one engine (deployment replica or bench
    harness).  All methods take an optional ``now`` (seconds, from
    ``time.perf_counter()``) so tests can drive deterministic clocks;
    production callers omit it."""

    def __init__(self, deployment: str, max_slots: int = 0,
                 history: int = 4096, role: str = "both"):
        self.deployment = deployment
        self.max_slots = int(max_slots)
        #: disaggregated serving role ("prefill" | "decode" | "both");
        #: surfaced as engine_stats()["role"] so fleet pooling can
        #: keep decode-pool occupancy apart from prefill pools
        self.role = str(role)
        self._m = _engine_metrics()
        self._tags = {"deployment": deployment}
        self._lock = threading.Lock()
        self._ids = itertools.count()
        self._t0 = time.perf_counter()
        #: retired request records (finished / rejected / errored)
        self._done: Deque[Dict[str, Any]] = collections.deque(
            maxlen=history)
        #: (end_ts, dur_s, n_tokens) per pooled decode step (n_tokens
        #: == n_active except spec-decode rounds, which emit several
        #: tokens per slot per dispatch)
        self._steps: Deque[tuple] = collections.deque(maxlen=history)
        self._active: Dict[int, Dict[str, Any]] = {}
        self._counts = {"enqueued": 0, "admitted": 0, "finished": 0,
                        "rejected": 0, "errors": 0}
        self._queue_depth = 0
        self._max_active = 0
        self._n_steps = 0
        self._tokens = 0
        self._busy_slot_s = 0.0     # sum(active * dur) over steps
        self._step_s = 0.0          # sum(dur) over steps
        self._buckets: Dict[int, int] = {}  # prefill bucket -> admits
        self._program_compiles: Dict[str, int] = {}
        self._rejections_by_reason: Dict[str, int] = {}
        self._kv_stats: Optional[Dict[str, Any]] = None
        #: kvscope block (serve/kvscope.py) the deployment composes —
        #: occupancy ring + eviction forensics + HBM ledger; the
        #: waste counter below tracks how much of the cumulative
        #: reprefill_waste_tokens has already been pushed to the
        #: Prometheus counter (counters take deltas, stats are totals)
        self._kv_scope: Optional[Dict[str, Any]] = None
        self._kv_waste_reported = 0
        #: host-RAM KV tier block (serve/kv_tier.py) the deployment
        #: pushes; same delta-tracking idiom for its restored counter
        self._kv_tier: Optional[Dict[str, Any]] = None
        self._kv_tier_restored_reported = 0
        #: round-19 healthwatch block (serve/health.py) the deployment
        #: refreshes from its fleet HealthMonitor — zero-shaped when
        #: no monitor watches this engine (standalone / disabled)
        self._health_block: Optional[Dict[str, Any]] = None
        self._spec = {"proposed": 0, "accepted": 0, "rounds": 0}
        #: chunked streaming prefill (round 15): admissions split into
        #: block-sized chunks interleaved with decode waves
        self._chunks = {"requests": 0, "chunks": 0, "tokens": 0,
                        "max_chunks": 0}
        #: round-18 disaggregated serving: block-granular KV handoffs
        #: between prefill and decode replicas.  Kept OUT of `_counts`
        #: (that dict's keys are a stable "requests" schema contract);
        #: handoffs_out books on the prefill side, everything else on
        #: the decode side.
        self._handoff = {"handoffs_out": 0, "handoffs_in": 0,
                         "blocks_moved": 0, "fast_path": 0,
                         "staged": 0, "requeues": 0}
        #: round-12 flight recorder: every lifecycle transition below
        #: also journals a compact decision event (one deque append)
        #: so postmortems can replay what the engine DID, not just its
        #: percentiles.  The SLO watchdog (serve/slo.py) attaches
        #: itself as `slo` when the deployment configures targets.
        self.flightrec = FlightRecorder(deployment)
        self.slo = None

    def _now(self, now: Optional[float]) -> float:
        return time.perf_counter() if now is None else now

    @staticmethod
    def _trace_tag(rec: Dict[str, Any]) -> Dict[str, str]:
        """Flightrec field tagging the event with the request's trace
        id, when one is in scope — lets postmortems follow a single
        request across the journal ({} keeps untraced events lean)."""
        ctx = rec.get("ctx")
        return {"trace": ctx.trace_id} if ctx is not None else {}

    # -- lifecycle ---------------------------------------------------------

    def record_enqueue(self, prompt_len: int,
                       now: Optional[float] = None,
                       tenant: Optional[str] = None,
                       ctx: Optional[TraceContext] = None,
                       engine_now: Optional[float] = None
                       ) -> Dict[str, Any]:
        """`tenant` tags the record for per-tenant SLO slicing (fleet
        router traffic classes); `now` may be BACKDATED to the instant
        the request entered the fleet router, so TTFT/e2e/queue-wait
        series charge router queueing to the request — the fleet-level
        latency a client actually observed, not just engine wait.
        `ctx` is the TraceContext born at router submit (a fresh
        engine-origin one is minted here when absent and the tracebus
        is enabled); `engine_now` is the instant the ENGINE saw the
        request, kept separate from the backdated `now` so the
        critical-path decomposition can split router wait from engine
        queue wait."""
        backdated = now is not None
        now = self._now(now)
        t_eng = self._now(engine_now) if backdated else now
        if ctx is None and _tracebus_enabled():
            ctx = TraceContext(origin="engine")
        rec: Dict[str, Any] = {
            "id": next(self._ids), "prompt_len": int(prompt_len),
            "enqueue": now, "engine_enqueue": t_eng, "admit": None,
            "first_token": None, "finish": None, "slot": None,
            "bucket": None, "tokens": 0,
            "spec_proposed": 0, "spec_accepted": 0,
            "spec_rounds": 0, "spec_rollback_s": 0.0,
            "requeues": 0, "requeue_ts": None, "kv_reserve": None,
            "kv_fetch": None, "prefill_chunks": None,
            "token_ts": [] if ctx is not None else None,
            "status": "queued", "trace": None, "tenant": tenant,
            "ctx": ctx,
        }
        if tracing.is_enabled():
            rec["trace"] = tracing.record_span(
                f"serve {self.deployment}.request", start=now)
        with self._lock:
            self._counts["enqueued"] += 1
            self._queue_depth += 1
        self._m["queue_depth"].set(self._queue_depth, tags=self._tags)
        return rec

    def record_admit(self, rec: Dict[str, Any], slot: int, bucket: int,
                     now: Optional[float] = None) -> None:
        now = self._now(now)
        rec["admit"] = now
        rec["slot"] = int(slot)
        rec["bucket"] = int(bucket)
        rec["status"] = "active"
        with self._lock:
            self._counts["admitted"] += 1
            self._queue_depth = max(0, self._queue_depth - 1)
            self._active[rec["id"]] = rec
            first_seen = bucket not in self._buckets
            self._buckets[bucket] = self._buckets.get(bucket, 0) + 1
        self._m["admitted"].inc(tags=self._tags)
        self._m["queue_depth"].set(self._queue_depth, tags=self._tags)
        self._m["queue_wait"].observe(
            (now - rec["enqueue"]) * 1e3, tags=self._tags)
        self.flightrec.record(
            "admit", ts=now, req=rec["id"], slot=int(slot),
            bucket=int(bucket),
            wait_ms=round((now - rec["enqueue"]) * 1e3, 3),
            **self._trace_tag(rec))
        if first_seen:
            # a never-seen padded prompt shape means one compile
            # event of the prefill program for this bucket
            self._m["prefill_compiles"].inc(
                tags=dict(self._tags, bucket=str(int(bucket))))

    def record_program_compile(self, program: str) -> None:
        """One compile event of a named engine program (``serve.decode``,
        ``serve.sharded_decode``, ...) observed while this engine is
        live — usually subscribed to the ``device_stats`` program
        registry, so decode-path shape churn shows up next to the
        prefill-bucket counter instead of staying invisible."""
        with self._lock:
            self._program_compiles[program] = \
                self._program_compiles.get(program, 0) + 1
        self._m["program_compiles"].inc(
            tags=dict(self._tags, program=program))
        self.flightrec.record("compile", program=program)

    def record_storm(self, program: str) -> None:
        """One recompile-storm trip from the device_stats registry
        watchdog (``subscribe_storms``): journaled, and queued for the
        SLO tracker's next check so the anomaly auto-dumps a
        postmortem."""
        self.flightrec.record("recompile_storm", program=program)
        if self.slo is not None:
            self.slo.note_storm(program)

    def record_first_token(self, rec: Dict[str, Any],
                           now: Optional[float] = None) -> None:
        now = self._now(now)
        rec["first_token"] = now
        rec["tokens"] = max(1, rec["tokens"])
        if rec.get("token_ts") is not None:
            rec["token_ts"].append(now)
        self._m["ttft"].observe(
            (now - rec["enqueue"]) * 1e3, tags=self._tags)
        self.flightrec.record(
            "first_token", ts=now, req=rec["id"],
            ttft_ms=round((now - rec["enqueue"]) * 1e3, 3),
            **self._trace_tag(rec))

    def record_token(self, rec: Dict[str, Any], n: int = 1,
                     now: Optional[float] = None) -> None:
        """Stamp `n` decode tokens for one request at one instant (a
        spec-verify dispatch emits several tokens in one device round
        trip, so they legitimately share a timestamp).  The trail
        feeds per-request ITL/TPOT and the inter-token leg of the
        critical path; a no-op when the tracebus is disabled."""
        ts = rec.get("token_ts")
        if ts is None:
            return
        now = self._now(now)
        if n == 1:
            ts.append(now)
        else:
            ts.extend([now] * int(n))

    def record_step(self, n_active: int, dur_s: float,
                    now: Optional[float] = None,
                    n_tokens: Optional[int] = None) -> None:
        """One pooled decode step: `n_active` slots sampled in `dur_s`
        seconds of host walltime.  `n_tokens` overrides the tokens
        credited to the step (spec-decode rounds emit up to k+1 per
        slot per dispatch); default one per active slot."""
        now = self._now(now)
        n_tokens = int(n_active) if n_tokens is None else int(n_tokens)
        with self._lock:
            self._steps.append((now, float(dur_s), n_tokens))
            self._n_steps += 1
            self._tokens += n_tokens
            self._max_active = max(self._max_active, int(n_active))
            self._busy_slot_s += n_active * dur_s
            self._step_s += dur_s
            util = (self._busy_slot_s / (self.max_slots * self._step_s)
                    if self.max_slots and self._step_s else 0.0)
        self._m["inter_token"].observe(dur_s * 1e3, tags=self._tags)
        self._m["active_slots"].set(n_active, tags=self._tags)
        self._m["tokens"].inc(n_tokens, tags=self._tags)
        self._m["slot_utilization"].set(round(util, 4), tags=self._tags)
        if dur_s > 0:
            self._m["tokens_per_sec"].set(
                round(n_tokens / dur_s, 1), tags=self._tags)
        self.flightrec.record(
            "step", ts=now, n_active=int(n_active),
            dur_ms=round(dur_s * 1e3, 3), tokens=n_tokens)

    def record_spec(self, rec: Dict[str, Any], proposed: int,
                    accepted: int,
                    dur_s: Optional[float] = None) -> None:
        """One speculative verify round for one request: the draft
        proposed `proposed` tokens, the target accepted `accepted` of
        them (0 <= accepted <= proposed; the +1 correction/bonus token
        every round also emits is counted by record_step, not here).
        Feeds the per-request acceptance-rate percentiles in
        engine_stats()["spec"] and the serve_spec_* counters.  `dur_s`
        is the round's host walltime; the rejected-position share of
        it accumulates as the request's spec_rollback critical-path
        leg (rejected / (k+1) of the dispatch bought nothing)."""
        proposed, accepted = int(proposed), int(accepted)
        rec["spec_proposed"] += proposed
        rec["spec_accepted"] += accepted
        rec["spec_rounds"] = rec.get("spec_rounds", 0) + 1
        if dur_s and proposed > accepted:
            rec["spec_rollback_s"] = (
                rec.get("spec_rollback_s", 0.0)
                + float(dur_s) * (proposed - accepted) / (proposed + 1))
        with self._lock:
            self._spec["proposed"] += proposed
            self._spec["accepted"] += accepted
            self._spec["rounds"] += 1
        self._m["spec_proposed"].inc(proposed, tags=self._tags)
        self._m["spec_accepted"].inc(accepted, tags=self._tags)
        self._m["spec_rounds"].inc(tags=self._tags)
        self.flightrec.record("spec_round", req=rec["id"],
                              proposed=proposed, accepted=accepted,
                              **self._trace_tag(rec))

    def record_requeue(self, rec: Dict[str, Any], need: int = 0,
                       reason: str = "pool_exhausted",
                       now: Optional[float] = None) -> None:
        """Admission bounced the request back to the queue head (KV
        pool or COW exhaustion).  First bounce stamps `requeue_ts` so
        the critical path can charge the exhaustion stall separately
        from ordinary queue wait."""
        now = self._now(now)
        rec["requeues"] = rec.get("requeues", 0) + 1
        if rec.get("requeue_ts") is None:
            rec["requeue_ts"] = now
        if reason.startswith("handoff"):
            # decode-side pool exhaustion bouncing an arriving handoff
            # back to the queue head — surfaced in the handoff block
            with self._lock:
                self._handoff["requeues"] += 1
        self.flightrec.record(
            "requeue", ts=now, req=rec["id"], need=int(need),
            reason=reason, **self._trace_tag(rec))

    def record_kv_reserve(self, rec: Dict[str, Any], start: float,
                          end: float, blocks: int = 0,
                          hit_blocks: int = 0, evicted: int = 0,
                          reprefill_waste_tokens: int = 0) -> None:
        """The BlockPager reservation window for one admission
        (prefix match + allocate + COW), kept on the record so the
        tracebus can render it as its own span inside queue wait.
        `evicted` counts resident prefixes this reservation pushed
        out; `reprefill_waste_tokens` (patched post-prefill via
        `note_kv_waste` — registration happens after the window)
        counts tokens this admission re-filled that were previously
        resident, so a trace can show WHO thrashed the cache."""
        rec["kv_reserve"] = (float(start), float(end), int(blocks),
                             int(hit_blocks), int(evicted),
                             int(reprefill_waste_tokens))

    def note_kv_waste(self, rec: Dict[str, Any], tokens: int) -> None:
        """Patch the re-prefill waste this admission booked onto its
        kv_reserve tuple — known only at `register_prefix` time, after
        the reservation window closed."""
        kv = rec.get("kv_reserve")
        if kv is not None and tokens:
            rec["kv_reserve"] = kv[:5] + (int(tokens),)

    def record_kv_fetch(self, rec: Dict[str, Any], start: float,
                        end: float, blocks: int = 0, tokens: int = 0,
                        bytes: int = 0) -> None:
        """The host-tier restore window of one admission
        (serve/kv_tier.py): `blocks` evicted prefix blocks re-admitted
        via H2D copy over [start, end] instead of being re-prefilled.
        Kept on the record so critical_path() can carve the window
        out of queue wait as the ``kv_fetch_ms`` component and the
        tracebus can render a ``kv.fetch`` span; per-block journal
        events (key/tenant/bytes) come from the pager itself."""
        rec["kv_fetch"] = (float(start), float(end), int(blocks),
                           int(tokens), int(bytes))

    def record_prefill_chunk(self, rec: Dict[str, Any], start: float,
                             end: float, tokens: int, bucket: int,
                             last: bool = False) -> None:
        """One chunk of a chunked (streaming) prefill: `tokens` prompt
        tokens ingested through the paged_prefill program padded to
        `bucket`, dispatched over [start, end] on the perf_counter
        clock.  The windows accumulate on the record — critical_path()
        bills their sum as the prefill leg and the parked remainder of
        admit → first token as prefill_wait — and the final chunk
        (``last=True``) is the one whose sample becomes the first
        token.  One-shot admissions never call this, so their records
        (and the decomposition) are unchanged."""
        chunks = rec.get("prefill_chunks")
        if chunks is None:
            chunks = rec["prefill_chunks"] = []
            with self._lock:
                self._chunks["requests"] += 1
        chunks.append((float(start), float(end), int(tokens),
                       int(bucket)))
        with self._lock:
            self._chunks["chunks"] += 1
            self._chunks["tokens"] += int(tokens)
            self._chunks["max_chunks"] = max(
                self._chunks["max_chunks"], len(chunks))
        self.flightrec.record(
            "prefill_chunk", ts=end, req=rec["id"],
            chunk=len(chunks) - 1, tokens=int(tokens),
            bucket=int(bucket), last=bool(last),
            dur_ms=round((end - start) * 1e3, 3),
            **self._trace_tag(rec))

    # -- disaggregated prefill/decode handoff (round 18) -------------------

    def record_handoff_out(self, rec: Dict[str, Any], blocks: int = 0,
                           nbytes: int = 0, path: str = "fast",
                           now: Optional[float] = None) -> None:
        """Prefill-side retirement of a handed-off request: this
        engine finished the prompt's last chunk, exported the filled
        KV block rows, and the DECODE replica now owns the request's
        lifecycle.  The record leaves the active set but is NOT
        retired into ``_done`` and books none of the request counters
        — the decode-side record (``record_enqueue_handoff``) is the
        authoritative one, and keeping a second first-token-stamped
        record here would double-count TTFT/e2e in fleet pooling."""
        now = self._now(now)
        rec["finish"] = now
        rec["status"] = "handoff"
        with self._lock:
            self._handoff["handoffs_out"] += 1
            if rec["admit"] is None:
                self._queue_depth = max(0, self._queue_depth - 1)
            self._active.pop(rec["id"], None)
        self._m["queue_depth"].set(self._queue_depth, tags=self._tags)
        self.flightrec.record(
            "handoff_out", ts=now, req=rec["id"], blocks=int(blocks),
            bytes=int(nbytes), path=str(path), **self._trace_tag(rec))

    def record_enqueue_handoff(self, meta: Dict[str, Any],
                               now: Optional[float] = None
                               ) -> Dict[str, Any]:
        """Decode-side record for an arriving pre-filled request.  The
        record is pre-populated with the PREFILL replica's timing
        (enqueue/admit/first-token/chunk windows travel with the
        handoff package) so the critical-path decomposition of the
        finished request reads exactly like a monolithic engine's —
        queue wait is the prefill queue, the prefill leg is the chunk
        windows, and the extra export→install cost shows up ONLY as
        the new ``handoff_ms`` component carved from the decode leg."""
        now = self._now(now)
        ctx = meta.get("ctx")
        rec: Dict[str, Any] = {
            "id": next(self._ids),
            "prompt_len": int(meta.get("prompt_len", 0)),
            "enqueue": meta.get("enqueue", now),
            "engine_enqueue": meta.get("engine_enqueue",
                                       meta.get("enqueue", now)),
            "admit": meta.get("admit"),
            "first_token": meta.get("first_token"),
            "finish": None, "slot": None,
            "bucket": meta.get("bucket"), "tokens": 1,
            "spec_proposed": 0, "spec_accepted": 0,
            "spec_rounds": 0, "spec_rollback_s": 0.0,
            "requeues": int(meta.get("requeues", 0)),
            "requeue_ts": meta.get("requeue_ts"),
            "kv_reserve": meta.get("kv_reserve"),
            "kv_fetch": meta.get("kv_fetch"),
            "kv_handoff": None,
            "prefill_chunks": meta.get("prefill_chunks"),
            "token_ts": ([meta["first_token"]]
                         if ctx is not None
                         and meta.get("first_token") is not None
                         else ([] if ctx is not None else None)),
            "status": "queued", "trace": None,
            "tenant": meta.get("tenant"), "ctx": ctx,
        }
        with self._lock:
            self._counts["enqueued"] += 1
            self._handoff["handoffs_in"] += 1
            self._queue_depth += 1
        self._m["queue_depth"].set(self._queue_depth, tags=self._tags)
        self.flightrec.record(
            "handoff_in", ts=now, req=rec["id"],
            prompt_len=rec["prompt_len"], **self._trace_tag(rec))
        return rec

    def record_admit_handoff(self, rec: Dict[str, Any], slot: int,
                             now: Optional[float] = None) -> None:
        """Admit an arriving handoff into a decode slot.  Unlike
        ``record_admit`` this must NOT overwrite ``admit`` (the
        prefill replica's admission instant is the one the
        decomposition needs) and must not observe queue-wait or
        prefill-bucket metrics — the prefill side already did."""
        now = self._now(now)
        rec["slot"] = int(slot)
        rec["status"] = "active"
        with self._lock:
            self._counts["admitted"] += 1
            self._queue_depth = max(0, self._queue_depth - 1)
            self._active[rec["id"]] = rec
        self._m["admitted"].inc(tags=self._tags)
        self._m["queue_depth"].set(self._queue_depth, tags=self._tags)
        self.flightrec.record(
            "handoff_admit", ts=now, req=rec["id"], slot=int(slot),
            **self._trace_tag(rec))

    def record_kv_handoff(self, rec: Dict[str, Any], start: float,
                          end: float, blocks: int = 0, nbytes: int = 0,
                          path: str = "fast") -> None:
        """The export→install window of one handoff: `blocks` filled
        KV block rows moved from the prefill replica's pool into this
        decode replica's over [start, end] (`path` is "fast" for the
        same-process device copy, "staged" for the D2H→H2D hop through
        host staging buffers).  Kept on the record so critical_path()
        can carve the window out of the decode leg as ``handoff_ms``
        and the tracebus can render a ``kv.handoff`` span."""
        rec["kv_handoff"] = (float(start), float(end), int(blocks),
                             int(nbytes), str(path))
        with self._lock:
            self._handoff["blocks_moved"] += int(blocks)
            if path == "fast":
                self._handoff["fast_path"] += 1
            else:
                self._handoff["staged"] += 1
        self.flightrec.record(
            "kv_handoff", ts=end, req=rec["id"], blocks=int(blocks),
            bytes=int(nbytes), path=str(path),
            dur_ms=round((end - start) * 1e3, 3),
            **self._trace_tag(rec))

    def record_finish(self, rec: Dict[str, Any],
                      n_tokens: Optional[int] = None,
                      now: Optional[float] = None) -> None:
        now = self._now(now)
        rec["finish"] = now
        if n_tokens is not None:
            rec["tokens"] = int(n_tokens)
        rec["status"] = "ok"
        self._retire(rec, "finished")
        self._m["finished"].inc(tags=self._tags)
        self._m["latency"].observe(
            (now - rec["enqueue"]) * 1e3, tags=self._tags)
        self.flightrec.record(
            "finish", ts=now, req=rec["id"], slot=rec["slot"],
            tokens=rec["tokens"],
            latency_ms=round((now - rec["enqueue"]) * 1e3, 3),
            **self._trace_tag(rec))
        if rec["trace"] is not None:
            trace_id, span_id = rec["trace"]
            start = (rec["admit"] if rec["admit"] is not None
                     else rec["enqueue"])
            tracing.record_span(f"engine {self.deployment}.generate",
                                trace_id=trace_id, parent_id=span_id,
                                start=start,
                                duration=max(0.0, now - start))

    def record_reject(self, rec: Dict[str, Any], reason: str = "",
                      now: Optional[float] = None,
                      label: str = "invalid") -> None:
        """`reason` is the free-form human string kept on the request
        record; `label` is the LOW-CARDINALITY metric tag ("oversized",
        "shed_queue_full", ...) — never put request-specific text in a
        metric label."""
        rec["finish"] = self._now(now)
        rec["status"] = "rejected"
        rec["reason"] = reason
        with self._lock:
            self._rejections_by_reason[label] = \
                self._rejections_by_reason.get(label, 0) + 1
        self._retire(rec, "rejected")
        self._m["rejected"].inc(tags=dict(self._tags, reason=label))
        self.flightrec.record(
            "shed" if label.startswith("shed") else "reject",
            req=rec["id"], label=label, reason=reason[:120],
            **self._trace_tag(rec))

    # -- paged KV cache (serve/kv_pager.py feeds these) --------------------

    def record_prefix_reuse(self, hit_blocks: int,
                            miss_blocks: int) -> None:
        """One admission's prefix-cache outcome, in blocks."""
        if hit_blocks:
            self._m["prefix_hits"].inc(int(hit_blocks), tags=self._tags)
        if miss_blocks:
            self._m["prefix_misses"].inc(int(miss_blocks),
                                         tags=self._tags)

    def record_cow(self) -> None:
        self._m["cow_copies"].inc(tags=self._tags)
        self.flightrec.record("cow_fork")

    def record_kv_stats(self, stats: Dict[str, Any]) -> None:
        """Latest BlockPager.stats() snapshot — mirrored into
        engine_stats()["kv_cache"] and the blocks-in-use gauge."""
        with self._lock:
            self._kv_stats = dict(stats)
        self._m["kv_blocks_in_use"].set(
            int(stats.get("blocks_in_use", 0)), tags=self._tags)

    def record_kv_scope(self, block: Dict[str, Any]) -> None:
        """Latest composed kvscope block (occupancy + forensics + HBM
        ledger, see serve/kvscope.py) — mirrored into
        engine_stats()["kv_scope"] and the kvscope gauges; the waste
        Prometheus counter advances by the delta since the last push
        (stats carry totals, counters take increments)."""
        occ = block.get("occupancy") or {}
        forensics = block.get("forensics") or {}
        with self._lock:
            self._kv_scope = block
            waste = int(forensics.get("reprefill_waste_tokens", 0))
            delta = waste - self._kv_waste_reported
            if delta > 0:
                self._kv_waste_reported = waste
        self._m["kv_occupancy"].set(
            float(occ.get("occupancy_ratio", 0.0)), tags=self._tags)
        self._m["kv_fragmentation"].set(
            float(occ.get("fragmentation", 0.0)), tags=self._tags)
        if delta > 0:
            self._m["kv_reprefill_waste"].inc(delta, tags=self._tags)

    def record_kv_tier(self, block: Dict[str, Any]) -> None:
        """Latest HostKVTier.stats() block (serve/kv_tier.py) —
        mirrored into engine_stats()["kv_tier"] and the tier gauges;
        the tokens-restored Prometheus counter advances by the delta
        since the last push (stats carry totals, counters take
        increments)."""
        with self._lock:
            self._kv_tier = dict(block)
            restored = int(block.get("tokens_restored", 0))
            delta = restored - self._kv_tier_restored_reported
            if delta > 0:
                self._kv_tier_restored_reported = restored
        self._m["kv_tier_bytes"].set(
            int(block.get("bytes_resident", 0)), tags=self._tags)
        self._m["kv_tier_hit_rate"].set(
            float(block.get("hit_rate", 0.0)), tags=self._tags)
        if delta > 0:
            self._m["kv_tier_restored"].inc(delta, tags=self._tags)

    def record_health(self, block: Dict[str, Any]) -> None:
        """Latest healthwatch block (serve/health.py
        ``HealthMonitor.replica_block``) — mirrored into
        ``engine_stats()["health"]``.  The monitor publishes its own
        Prometheus gauges/counters at transition time; this is the
        stats-surface mirror only."""
        with self._lock:
            self._health_block = dict(block)

    def stalled_requests(self, stall_ms: float,
                         now: Optional[float] = None
                         ) -> List[Dict[str, Any]]:
        """Admitted-but-token-silent requests: active records whose
        last emitted token (or admission, when no token yet) is older
        than ``stall_ms`` — the healthwatch stall sweep's feed.  Each
        entry carries the flightrec-known resident state (slot,
        tokens emitted, tenant, trace) so the ``request_stall``
        journal entry names exactly what is wedged."""
        now = self._now(now)
        with self._lock:
            recs = list(self._active.values())
        out: List[Dict[str, Any]] = []
        for r in recs:
            if r.get("status") != "active":
                continue
            ts = r.get("token_ts")
            last = ts[-1] if ts else (r.get("first_token")
                                      or r.get("admit"))
            if last is None:
                continue
            silent_ms = (now - last) * 1e3
            if silent_ms < stall_ms:
                continue
            ctx = r.get("ctx")
            out.append({
                "id": r["id"],
                "slot": r.get("slot"),
                "tokens": int(r.get("tokens", 0)),
                "tenant": r.get("tenant"),
                "silent_ms": round(silent_ms, 3),
                "trace": ctx.trace_id if ctx is not None else None,
            })
        return out

    # -- fleet control plane (serve/router.py journals through here) -------

    def record_route(self, req: int, replica: str, policy: str,
                     tenant: Optional[str] = None,
                     matched_blocks: int = 0,
                     outstanding: int = 0,
                     now: Optional[float] = None,
                     trace: Optional[str] = None) -> None:
        """One routing decision: request `req` dispatched to `replica`
        under `policy` ("prefix_affinity" | "p2c" | "round_robin"),
        having matched `matched_blocks` resident prefix blocks there.
        `outstanding` is the replica's in-flight count at dispatch —
        the load the power-of-two-choices fallback compared.  `trace`
        is the request's tracebus id when one is in scope."""
        self.flightrec.record(
            "route", ts=now, req=int(req), replica=str(replica),
            policy=str(policy), tenant=tenant,
            matched_blocks=int(matched_blocks),
            outstanding=int(outstanding),
            **({"trace": trace} if trace is not None else {}))

    def record_scale(self, direction: str, n_before: int, n_after: int,
                     reason: str, signal: float = 0.0,
                     replica: Optional[str] = None,
                     now: Optional[float] = None) -> None:
        """One autoscaling decision.  `direction` is "up" or "down"
        (journaled as the `scale_up` / `scale_down` event kinds),
        `reason` names the tripped signal ("burn_rate" | "queue_depth"
        | "idle"), `signal` its value at the decision."""
        kind = "scale_up" if direction == "up" else "scale_down"
        self.flightrec.record(
            kind, ts=now, n_before=int(n_before), n_after=int(n_after),
            reason=str(reason), signal=round(float(signal), 4),
            replica=replica)

    def record_drain(self, replica: str, ok: bool,
                     blocks_in_use: int = 0, drained_requests: int = 0,
                     now: Optional[float] = None) -> None:
        """Graceful-drain outcome for one replica: admission was
        stopped, `drained_requests` in-flight requests finished, and
        `blocks_in_use` KV blocks remained after retirement (0 on a
        clean drain)."""
        self.flightrec.record(
            "drain", ts=now, replica=str(replica), ok=bool(ok),
            blocks_in_use=int(blocks_in_use),
            drained_requests=int(drained_requests))

    def record_error(self, rec: Dict[str, Any], error: str = "",
                     now: Optional[float] = None) -> None:
        rec["finish"] = self._now(now)
        rec["status"] = "error"
        rec["reason"] = error
        self._retire(rec, "errors")
        self._m["errors"].inc(tags=self._tags)
        self.flightrec.record("error", req=rec["id"],
                              error=error[:200],
                              **self._trace_tag(rec))

    def _retire(self, rec: Dict[str, Any], count_key: str) -> None:
        with self._lock:
            self._counts[count_key] += 1
            if rec["admit"] is None:
                self._queue_depth = max(0, self._queue_depth - 1)
            self._active.pop(rec["id"], None)
            self._done.append(rec)
        self._m["queue_depth"].set(self._queue_depth, tags=self._tags)

    # -- sinks -------------------------------------------------------------

    def slo_samples(self, tenant: Optional[str] = None
                    ) -> Dict[str, List[tuple]]:
        """(event_ts, value_ms) series per SLO objective over the
        retained records — the raw stream serve/slo.py's burn-rate
        windows slice.  Timestamps are the perf_counter instant each
        value became OBSERVABLE (first token, admit, finish), so a
        window query sees exactly what a live observer saw.  With
        `tenant` the series are restricted to that traffic class's
        records (fleet per-tenant attainment); default is all."""
        with self._lock:
            recs = list(self._done) + list(self._active.values())
        if tenant is not None:
            recs = [r for r in recs if r.get("tenant") == tenant]
        out: Dict[str, List[tuple]] = {"ttft": [], "e2e": [],
                                       "queue_wait": []}
        for r in recs:
            if r.get("status") == "handoff":
                # prefill-side shadow of a handed-off request: the
                # decode replica's record is the authoritative one
                continue
            if r["first_token"] is not None:
                out["ttft"].append(
                    (r["first_token"],
                     (r["first_token"] - r["enqueue"]) * 1e3))
            if r["admit"] is not None:
                out["queue_wait"].append(
                    (r["admit"], (r["admit"] - r["enqueue"]) * 1e3))
            if r["finish"] is not None and r["status"] == "ok":
                out["e2e"].append(
                    (r["finish"], (r["finish"] - r["enqueue"]) * 1e3))
        return out

    def anatomy_samples(self, tenant: Optional[str] = None
                        ) -> Dict[str, Any]:
        """Raw latency-anatomy samples over retired records: pooled
        inter-token gaps, per-request TPOT, and the critical-path
        decomposition per component — the un-summarized stream that
        fleet_stats pools across replicas before taking percentiles."""
        with self._lock:
            recs = list(self._done)
        if tenant is not None:
            recs = [r for r in recs if r.get("tenant") == tenant]
        out = empty_anatomy_samples()
        tenants: set = set()
        for r in recs:
            if r.get("status") == "handoff":
                continue
            if r.get("tenant"):
                tenants.add(r["tenant"])
            out["itl_ms"].extend(_token_gaps_ms(r))
            if r.get("first_token") is not None:
                out["ttft_ms"].append(
                    (r["first_token"] - r["enqueue"]) * 1e3)
            cp = critical_path(r)
            if cp is not None:
                for k, v in cp.items():
                    out["critical_path"][k].append(v)
            if (r.get("status") == "ok" and r.get("finish") is not None
                    and r.get("first_token") is not None
                    and r.get("tokens", 0) > 1):
                out["tpot_ms"].append(
                    (r["finish"] - r["first_token"]) * 1e3
                    / (r["tokens"] - 1))
        out["tenants"] = sorted(tenants)
        return out

    def trace_records(self) -> List[Dict[str, Any]]:
        """Tracebus view of every retained request (retired + live) as
        plain dicts — what the fleet collector merges."""
        with self._lock:
            recs = list(self._done) + list(self._active.values())
        return [request_snapshot(r, self.deployment) for r in recs]

    def find_request(self, request_id: Any) -> Optional[Dict[str, Any]]:
        """Locate one request by trace id (full or unambiguous prefix)
        or by engine-local integer id; None when unknown here."""
        rid = str(request_id)
        with self._lock:
            recs = list(self._done) + list(self._active.values())
        for r in recs:
            ctx = r.get("ctx")
            if ctx is not None and (ctx.trace_id == rid
                                    or (len(rid) >= 6
                                        and ctx.trace_id.startswith(rid))):
                return request_snapshot(r, self.deployment)
            if str(r["id"]) == rid:
                return request_snapshot(r, self.deployment)
        return None

    def engine_stats(self) -> Dict[str, Any]:
        """Snapshot of everything ``bench``/dashboards ask the engine:
        percentiles over retained records, counters, throughput, and
        slot occupancy — cheap enough to call per scrape."""
        with self._lock:
            recs = list(self._done) + list(self._active.values())
            n_active = len(self._active)
            steps = list(self._steps)
            counts = dict(self._counts)
            queue_depth = self._queue_depth
            max_active = self._max_active
            n_steps = self._n_steps
            tokens = self._tokens
            busy, step_s = self._busy_slot_s, self._step_s
            buckets = dict(self._buckets)
            program_compiles = dict(self._program_compiles)
            rejections = dict(self._rejections_by_reason)
            kv_stats = (dict(self._kv_stats)
                        if self._kv_stats is not None else None)
            kv_scope = self._kv_scope
            kv_tier = self._kv_tier
            health = self._health_block
            spec = dict(self._spec)
            chunks = dict(self._chunks)
            handoff = dict(self._handoff)
        recs = [r for r in recs if r.get("status") != "handoff"]
        ttft = [(r["first_token"] - r["enqueue"]) * 1e3 for r in recs
                if r["first_token"] is not None]
        qwait = [(r["admit"] - r["enqueue"]) * 1e3 for r in recs
                 if r["admit"] is not None]
        lat = [(r["finish"] - r["enqueue"]) * 1e3 for r in recs
               if r["finish"] is not None and r["status"] == "ok"]
        inter = [d * 1e3 for _, d, _ in steps]
        anatomy = self.anatomy_samples()
        by_tenant = {t: latency_anatomy(self.anatomy_samples(tenant=t))
                     for t in anatomy["tenants"]}
        if steps:
            window = (steps[-1][0] - steps[0][0] + steps[0][1])
            win_tokens = sum(n for _, _, n in steps)
            throughput = win_tokens / window if window > 0 else 0.0
        else:
            throughput = 0.0
        return {
            "deployment": self.deployment,
            # round-18: disaggregated serving role — "prefill" engines
            # park at handoff, "decode" engines admit pre-filled
            # requests, "both" is the monolithic engine
            "role": self.role,
            "uptime_s": round(time.perf_counter() - self._t0, 3),
            "requests": dict(counts, active=n_active,
                             queued=queue_depth),
            "ttft_ms": _core.summarize(ttft),
            "queue_wait_ms": _core.summarize(qwait),
            "request_latency_ms": _core.summarize(lat),
            "inter_token_ms": _core.summarize(inter),
            "engine_steps": n_steps,
            "tokens_generated": tokens,
            "tokens_per_sec": round(throughput, 1),
            "slot_utilization": round(
                busy / (self.max_slots * step_s), 4)
                if self.max_slots and step_s else 0.0,
            "max_active_slots": max_active,
            "max_slots": self.max_slots,
            "prefill_buckets": {str(k): v
                                for k, v in sorted(buckets.items())},
            "prefill_compiles": len(buckets),
            # round-10: compile events keyed by engine program name
            # (device_stats registry subscription) — decode-path
            # recompile churn, not just prefill buckets
            "program_compiles": {k: v for k, v
                                 in sorted(program_compiles.items())},
            # round-8: paged-KV + admission-control surfaces (top-level
            # keys — the "requests" dict shape is a stable contract)
            "rejections_by_reason": rejections,
            "kv_cache": kv_stats,
            # round-16: kvscope — occupancy ring + eviction forensics
            # + unified HBM ledger (stable empty-shaped block on
            # dense engines, which have no pager to observe)
            "kv_scope": (kv_scope if kv_scope is not None
                         else _empty_kv_scope()),
            # round-17: tiered host-RAM KV cache — spill/restore
            # counters + engine-fed H2D/D2H cost (stable zero-shaped
            # block when no tier is configured, dense included)
            "kv_tier": (kv_tier if kv_tier is not None
                        else _empty_kv_tier()),
            # round-19: healthwatch — liveness state machine counters
            # (stable zero-shaped block when no HealthMonitor watches
            # this engine: standalone, dense, or RAYTPU_HEALTHWATCH=0)
            "health": (health if health is not None
                       else _empty_health()),
            # round-11: speculative decoding — engine totals plus
            # per-request acceptance-rate percentiles (requests that
            # saw at least one verify round)
            "spec": {
                "proposed": spec["proposed"],
                "accepted": spec["accepted"],
                "rejected": spec["proposed"] - spec["accepted"],
                "rounds": spec["rounds"],
                "accept_rate": round(
                    spec["accepted"] / spec["proposed"], 4)
                    if spec["proposed"] else None,
                "accept_rate_per_request": _core.summarize(
                    [r["spec_accepted"] / r["spec_proposed"]
                     for r in recs if r.get("spec_proposed", 0)]),
            },
            # round-15: chunked streaming prefill — long prompts
            # admitted as block-sized chunks interleaved with decode
            # waves (all zeros when prefill_chunk_tokens is unset)
            "prefill_chunks": {
                "requests": chunks["requests"],
                "chunks": chunks["chunks"],
                "tokens": chunks["tokens"],
                "max_chunks_per_request": chunks["max_chunks"],
            },
            # round-18: disaggregated prefill/decode handoffs — block
            # moves out of (prefill role) and into (decode role) this
            # engine's pool, by path, plus decode-side pool-exhaustion
            # requeues (all zeros on monolithic engines)
            "handoff": handoff,
            # round-14: per-token latency anatomy — ITL/TPOT
            # percentiles and the critical-path decomposition
            # (e2e = router_wait + queue_wait + requeue + prefill +
            # inter_token + spec_rollback), overall and per tenant
            "latency_anatomy": dict(latency_anatomy(anatomy),
                                    by_tenant=by_tenant),
            # round-12: SLO burn rates (None until the deployment
            # configures an SLOConfig — key presence is the contract)
            # and the flight recorder's ring occupancy/drop counters
            "slo": (self.slo.snapshot() if self.slo is not None
                    else None),
            "flightrec": self.flightrec.stats(),
            # round-13: the roofline constants of THIS engine's device,
            # so a dashboard attributing a remote engine's programs
            # classifies against the remote ridge, not the reader's
            "device": _device_roofline(),
        }

    def export_timeline(self, filename: Optional[str] = None
                        ) -> List[Dict[str, Any]]:
        """Chrome-trace events in the ``ray_tpu.timeline()`` shape:
        lane 0 is the admission queue, lanes 1..max_slots are per-slot
        occupancy (prefill + decode span per request), and the last
        lane carries the pooled engine steps.  Timestamps are relative
        to engine start (chrome-trace origins are arbitrary)."""
        with self._lock:
            recs = list(self._done) + list(self._active.values())
            steps = list(self._steps)
        pid = 1
        base = self._t0
        step_lane = self.max_slots + 1
        events: List[Dict[str, Any]] = [
            _core.process_name_event(
                pid, f"llm-engine {self.deployment}"),
            _core.thread_name_event(pid, 0, "queue"),
            _core.thread_name_event(pid, step_lane, "engine steps"),
        ]
        for slot in range(self.max_slots):
            events.append(
                _core.thread_name_event(pid, slot + 1, f"slot {slot}"))
        now = time.perf_counter()
        for r in recs:
            end = r["finish"] if r["finish"] is not None else now
            admit = r["admit"] if r["admit"] is not None else end
            events.append(_core.complete_event(
                f"queued req{r['id']}", "serve", r["enqueue"] - base,
                admit - r["enqueue"], pid, 0,
                {"request_id": r["id"], "status": r["status"],
                 "prompt_len": r["prompt_len"]}))
            if r["admit"] is None:
                continue
            lane = (r["slot"] + 1) if r["slot"] is not None else 0
            first = (r["first_token"] if r["first_token"] is not None
                     else min(admit, end))
            events.append(_core.complete_event(
                f"prefill req{r['id']}", "serve", admit - base,
                first - admit, pid, lane,
                {"request_id": r["id"], "bucket": r["bucket"],
                 "prompt_len": r["prompt_len"]}))
            events.append(_core.complete_event(
                f"decode req{r['id']}", "serve", first - base,
                end - first, pid, lane,
                {"request_id": r["id"], "tokens": r["tokens"],
                 "status": r["status"]}))
        for end_ts, dur, n_active in steps:
            events.append(_core.complete_event(
                "engine_step", "serve", end_ts - dur - base, dur, pid,
                step_lane, {"active_slots": n_active}))
        return _core.write_chrome_trace(events, filename)
