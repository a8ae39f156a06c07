"""SLO burn-rate engine for the serve telemetry stream.

A copy of ``ray_tpu/serve/slo.py``; the one difference is the opt-in
breach capture, a ``torch.profiler`` window here (``_profile``).

``EngineTelemetry`` measures; this module JUDGES.  A per-deployment
:class:`SLOConfig` names latency targets (TTFT, end-to-end, queue
wait) and an objective ("99% of requests inside the target"), and
:class:`SLOTracker` turns the telemetry stream into multi-window
**burn rates** — the SRE error-budget idiom:

    burn_rate = observed_violation_rate / (1 - objective)

A burn rate of 1.0 means the deployment is consuming its error budget
exactly as fast as the objective allows; above 1.0 it will miss the
SLO if the window's behaviour persists.  Computing the same rate over
a short AND a long window (default 30 s / 300 s) keeps the signal both
fast (the short window trips within seconds of a regression) and
de-noised (the long window confirms it is not a blip).

The tracker is also the **anomaly watchdog**: ``check()`` runs from
the engine loop (throttled), and on a burn-rate breach transition or a
recompile-storm trip (``device_stats`` registry subscription) it dumps
the flight recorder's journal (``_private/flightrec.py``) to a
postmortem file — the "what was the engine doing" answer — and can
opt-in trigger a ``torch.profiler`` capture.  Everything it computes
is exposed through ``engine_stats()["slo"]`` and the ``serve_slo_*``
metrics.

Clock discipline matches telemetry: monotonic ``perf_counter`` only,
``now`` injectable for deterministic tests.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

__all__ = ["SLOConfig", "SLOTracker", "worst_burn_rate"]


def worst_burn_rate(slo_block) -> float:
    """Max burn rate across objectives in an ``SLOTracker.snapshot()``
    / ``engine_stats()["slo"]`` block — the scalar the fleet autoscaler
    (serve/router.py) and the controller's "burn_rate" load signal
    consume.  0.0 for engines without an SLO config (None block) or
    malformed blocks, so callers can feed it unconditionally."""
    if not isinstance(slo_block, dict):
        return 0.0
    worst = 0.0
    for obj in (slo_block.get("objectives") or {}).values():
        try:
            worst = max(worst, float(obj.get("burn_rate", 0.0)))
        except (TypeError, ValueError):
            continue
    return worst

_metrics_lock = threading.Lock()
_metrics: Optional[Dict[str, Any]] = None


def _slo_metrics() -> Dict[str, Any]:
    """Process-wide serve_slo_* metric singletons (same pattern as
    serve/telemetry.py — one registration per name however many
    deployments this process hosts)."""
    global _metrics
    with _metrics_lock:
        if _metrics is None:
            from ray_tpu_torch.util.metrics import Counter, Gauge

            _metrics = {
                "burn_rate": Gauge(
                    "serve_slo_burn_rate",
                    "error-budget burn rate per objective and window "
                    "(>1 = missing the SLO at this pace)",
                    tag_keys=("deployment", "objective", "window")),
                "attainment": Gauge(
                    "serve_slo_attainment",
                    "fraction of retained requests inside the "
                    "objective's latency target",
                    tag_keys=("deployment", "objective")),
                "breaches": Counter(
                    "serve_slo_breaches_total",
                    "burn-rate breach transitions per objective",
                    tag_keys=("deployment", "objective")),
                "dumps": Counter(
                    "serve_flightrec_dumps_total",
                    "postmortem flight-record dumps, by trigger",
                    tag_keys=("deployment", "trigger")),
            }
        return _metrics


@dataclasses.dataclass(frozen=True)
class SLOConfig:
    """Latency SLOs for one deployment.

    Targets are milliseconds; a ``None`` target disables that
    objective.  ``objective`` is the success fraction the SLO promises
    (0.99 → a 1% error budget) and ``windows_s`` the burn-rate
    windows.  An objective breaches when its burn rate exceeds
    ``burn_threshold`` in any window holding at least ``min_samples``
    samples; on the False→True transition the watchdog dumps the
    flight record into ``dump_dir`` (default: the recorder's own,
    see flightrec.default_dump_dir) and, when ``profile_on_breach``,
    holds a ``torch.profiler`` capture for ``profile_seconds`` (a
    chrome trace written to ``profile_logdir``) —
    capture blocks the engine loop for that long, so it is strictly
    opt-in.  ``check_interval_s`` throttles the watchdog; ``max_dumps``
    caps postmortem files per tracker so a flapping SLO cannot fill a
    disk."""

    ttft_ms: Optional[float] = None
    e2e_ms: Optional[float] = None
    queue_wait_ms: Optional[float] = None
    objective: float = 0.99
    windows_s: Tuple[float, ...] = (30.0, 300.0)
    burn_threshold: float = 1.0
    min_samples: int = 1
    check_interval_s: float = 0.25
    dump_on_breach: bool = True
    dump_dir: Optional[str] = None
    max_dumps: int = 8
    profile_on_breach: bool = False
    profile_logdir: Optional[str] = None
    profile_seconds: float = 0.5

    def __post_init__(self):
        if not 0.0 < self.objective < 1.0:
            raise ValueError(
                f"objective must be in (0, 1), got {self.objective}")
        if not self.windows_s or any(w <= 0 for w in self.windows_s):
            raise ValueError(
                f"windows_s must be positive, got {self.windows_s}")
        if self.burn_threshold <= 0:
            raise ValueError("burn_threshold must be > 0")
        if self.min_samples < 1:
            raise ValueError("min_samples must be >= 1")
        for name, v in (("ttft_ms", self.ttft_ms),
                        ("e2e_ms", self.e2e_ms),
                        ("queue_wait_ms", self.queue_wait_ms)):
            if v is not None and v <= 0:
                raise ValueError(f"{name} must be > 0, got {v}")

    def objectives(self) -> Dict[str, float]:
        """objective name -> target_ms, configured entries only."""
        out = {}
        if self.ttft_ms is not None:
            out["ttft"] = float(self.ttft_ms)
        if self.e2e_ms is not None:
            out["e2e"] = float(self.e2e_ms)
        if self.queue_wait_ms is not None:
            out["queue_wait"] = float(self.queue_wait_ms)
        return out


class SLOTracker:
    """Burn-rate computation + anomaly watchdog over one engine's
    telemetry.  Created by the continuous engine when an ``SLOConfig``
    is passed; ``snapshot()`` is the pure read (engine_stats/
    dashboard), ``check()`` the throttled watchdog the engine loop
    drives after each step."""

    def __init__(self, config: SLOConfig, telemetry,
                 recorder=None):
        self.config = config
        self.deployment = telemetry.deployment
        self._telemetry = telemetry
        self._recorder = recorder
        if recorder is not None and config.dump_dir is not None:
            recorder.dump_dir = config.dump_dir
        self._m = _slo_metrics()
        self._lock = threading.Lock()
        self._last_check: Optional[float] = None
        self._breached: Dict[str, bool] = {}
        self._storms: List[str] = []
        self.breaches = 0
        self.dumps: List[str] = []

    # -- storm subscription (device_stats registry) --------------------

    def note_storm(self, program: str) -> None:
        """A recompile storm tripped; the next ``check()`` dumps."""
        with self._lock:
            self._storms.append(program)

    # -- burn rates ----------------------------------------------------

    def snapshot(self, now: Optional[float] = None) -> Dict[str, Any]:
        """The ``engine_stats()["slo"]`` block: per-objective overall
        attainment plus per-window violation counts and burn rates."""
        now = time.perf_counter() if now is None else now
        cfg = self.config
        budget = 1.0 - cfg.objective
        samples = self._telemetry.slo_samples()
        objectives: Dict[str, Any] = {}
        for name, target in cfg.objectives().items():
            series = samples.get(name, [])
            total = len(series)
            viol = sum(1 for _ts, v in series if v > target)
            windows: Dict[str, Any] = {}
            worst = 0.0
            breached = False
            for w in cfg.windows_s:
                vals = [v for ts, v in series if now - ts <= w]
                n = len(vals)
                bad = sum(1 for v in vals if v > target)
                err = bad / n if n else 0.0
                burn = err / budget
                windows[f"{w:g}s"] = {
                    "samples": n, "violations": bad,
                    "attainment": round(1.0 - err, 4),
                    "burn_rate": round(burn, 3),
                }
                if n >= cfg.min_samples:
                    worst = max(worst, burn)
                    if burn > cfg.burn_threshold:
                        breached = True
            objectives[name] = {
                "target_ms": target,
                "samples": total,
                "violations": viol,
                "attainment": round(1.0 - viol / total, 4)
                if total else None,
                "burn_rate": round(worst, 3),
                "breached": breached,
                "windows": windows,
            }
        with self._lock:
            breaches = self.breaches
            dumps = list(self.dumps)
        return {
            "config": {
                "objective": cfg.objective,
                "windows_s": list(cfg.windows_s),
                "burn_threshold": cfg.burn_threshold,
                "targets_ms": cfg.objectives(),
            },
            "objectives": objectives,
            "breached": any(o["breached"]
                            for o in objectives.values()),
            "breaches": breaches,
            "dumps": dumps,
        }

    # -- watchdog ------------------------------------------------------

    def check(self, now: Optional[float] = None
              ) -> Optional[Dict[str, Any]]:
        """Throttled watchdog pass: recompute burn rates, publish the
        serve_slo_* gauges, and on a fresh breach (or a queued
        recompile storm) postmortem-dump the flight record.  Returns
        the snapshot when a pass ran, None when throttled."""
        now = time.perf_counter() if now is None else now
        with self._lock:
            if self._last_check is not None and \
                    now - self._last_check < self.config.check_interval_s:
                return None
            self._last_check = now
            storms, self._storms = self._storms, []
        snap = self.snapshot(now)
        tags = {"deployment": self.deployment}
        for name, obj in snap["objectives"].items():
            otags = dict(tags, objective=name)
            if obj["attainment"] is not None:
                self._m["attainment"].set(obj["attainment"],
                                          tags=otags)
            for win, blk in obj["windows"].items():
                self._m["burn_rate"].set(
                    blk["burn_rate"], tags=dict(otags, window=win))
            fresh = obj["breached"] and not self._breached.get(name)
            cleared = (not obj["breached"]
                       and self._breached.get(name))
            self._breached[name] = obj["breached"]
            if cleared and self._recorder is not None:
                # close the burn window: incidents.py pairs this with
                # the opening slo_breach to bound the incident span
                self._recorder.record(
                    "slo_recover", objective=name,
                    burn_rate=obj["burn_rate"],
                    target_ms=obj["target_ms"])
            if fresh:
                with self._lock:
                    self.breaches += 1
                self._m["breaches"].inc(tags=otags)
                if self._recorder is not None:
                    self._recorder.record(
                        "slo_breach", objective=name,
                        burn_rate=obj["burn_rate"],
                        target_ms=obj["target_ms"])
                self._dump(f"slo_breach_{name}",
                           {"slo": snap, "objective": name})
                self._profile()
        for program in storms:
            self._dump("recompile_storm", {"program": program,
                                           "slo": snap})
        snap["breaches"] = self.breaches
        with self._lock:
            snap["dumps"] = list(self.dumps)
        return snap

    def _dump(self, trigger: str, context: Dict[str, Any]) -> None:
        if self._recorder is None or not self.config.dump_on_breach:
            return
        with self._lock:
            if len(self.dumps) >= self.config.max_dumps:
                return
        try:
            path = self._recorder.dump(reason=trigger, context=context)
        except Exception:  # noqa: BLE001 - watchdog must not kill the engine
            return
        if path is None:
            return
        with self._lock:
            self.dumps.append(path)
        self._m["dumps"].inc(tags={"deployment": self.deployment,
                                   "trigger": trigger})

    def _profile(self) -> None:
        """Opt-in breach capture: hold a ``torch.profiler`` window of
        ``profile_seconds`` (CPU and, when a card is present, CUDA
        activity) and write its chrome trace under ``profile_logdir``
        (default: the recorder's dump dir).  Deliberately synchronous —
        it blocks the engine loop for ``profile_seconds``, which is why
        it defaults off."""
        if not self.config.profile_on_breach:
            return
        try:
            import os

            import torch
            from ray_tpu_torch._private.flightrec import default_dump_dir

            logdir = self.config.profile_logdir or \
                (self._recorder.dump_dir if self._recorder is not None
                 and self._recorder.dump_dir else None) or \
                default_dump_dir()
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            with torch.profiler.profile(activities=acts) as prof:
                time.sleep(self.config.profile_seconds)
            os.makedirs(logdir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(
                logdir, f"slo_profile_{self.deployment}_"
                f"{os.getpid()}_{self.breaches}.json"))
        except Exception:  # noqa: BLE001 - capture is best-effort
            pass
