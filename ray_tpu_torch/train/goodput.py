"""Trainwatch: training goodput anatomy, data-stall attribution, and
the loss/grad health watchdog.  A copy of ``ray_tpu/train/goodput.py``;
only the health fence differs (``instrument_trainwatch``: one
device-to-host copy of the three scalars).

The serve stack answers "where did this request's latency go?" with a
clamped critical-path decomposition (serve/telemetry.py
``critical_path``).  This module is the training-side mirror: every
train step's wall time decomposes into

    data_wait + h2d + dispatch + device_compute + compile + checkpoint

(the legs ``data_wait_ms``, ``h2d_ms``, ``dispatch_ms``,
``device_compute_ms``, ``compile_ms`` and ``checkpoint_ms`` of
``ANATOMY_COMPONENTS``) on the shared ``perf_counter`` clock, with each leg clamped into the
step window so the components sum EXACTLY to the measured wall — a
step that stalls on the input pipeline reads as ``data_wait``
dominance, a recompile storm as ``compile``, a checkpoint pause as
``checkpoint``, and only ``device_compute`` counts as *goodput* (the
Podracer discipline: productive device seconds over loop wall
seconds, compiles and stalls excluded).

Three cooperating pieces:

* ``GoodputTracker`` — per-trainer sample pools + the rolling goodput
  ratio.  Producers feed it through ``note_data_wait`` /
  ``note_h2d`` / ``record_checkpoint`` pending buckets that drain
  into the NEXT ``record_step`` window, so iterator stalls and
  checkpoint pauses land in the goodput denominator without the loop
  having to thread timestamps around.
* ``watch_data(iterable)`` — wraps the batch iterator; ``__next__``
  walltime becomes the ``data_wait`` leg, so input-bound vs
  compute-bound is a read-off from ``train_stats()["anatomy"]``.
* ``HealthWatchdog`` — host-side EWMA z-score spike + NaN/inf
  detector over the cheap device scalars ``build_train_step(...,
  health=True)`` returns (loss, global grad-norm, nonfinite-leaf
  count — all computed inside the step on the device, no host
  transfer).
  Every observation journals a ``train_step`` event into a
  per-trainer flight recorder; an anomaly journals ``train_anomaly``
  and dumps a postmortem (``_private/flightrec.py`` dump path) naming
  the step index, batch signature, and the last-k metric trail.

Clock discipline: ``time.perf_counter()`` only, and every ``record_*``
/ ``observe`` takes an injectable ``now``/``ts`` for deterministic
tests.

Env knobs: ``RAYTPU_TRAINWATCH=0`` disables anatomy/goodput/health
recording process-wide (the wrappers degrade to bare step calls);
the flight-recorder side honors ``RAYTPU_FLIGHTREC`` as usual.
"""

from __future__ import annotations

import collections
import functools
import math
import os
import threading
import time
from typing import Any, Callable, Dict, Iterable, List, Optional

import torch

from ray_tpu_torch._private import telemetry as _core
from ray_tpu_torch._private.flightrec import FlightRecorder

__all__ = [
    "ANATOMY_COMPONENTS", "GoodputTracker", "HealthWatchdog",
    "DataWaitProbe", "watch_data", "get_goodput_tracker",
    "get_health_watchdog", "get_train_recorder", "instrument_trainwatch",
    "trainwatch_blocks", "registered_trainers", "dominant_component",
    "worker_skew",
]

#: the step-anatomy legs; together with ``step_wall_ms`` these are the
#: keys of every anatomy block, and per step the legs sum to
#: ``step_wall_ms`` exactly (modulo float rounding) by construction —
#: the same clamping contract as serve's ``critical_path()``.
ANATOMY_COMPONENTS = ("data_wait_ms", "h2d_ms", "dispatch_ms",
                      "device_compute_ms", "compile_ms", "checkpoint_ms")


def _enabled() -> bool:
    return os.environ.get("RAYTPU_TRAINWATCH", "1").lower() \
        not in ("0", "false", "off")


class GoodputTracker:
    """One trainer's step-anatomy sample pools and goodput window.

    The decomposition unit is one LOOP ITERATION: pending buckets
    (data wait from the iterator probe, h2d from an explicitly timed
    transfer, checkpoint pauses) accumulated since the last step drain
    into the next ``record_step`` call, whose wall is

        wall = pending_data_wait + pending_h2d + pending_checkpoint
               + step_call_duration

    and whose legs are clamped, in stall-first order, into that wall:
    each leg takes at most the remaining budget, and ``dispatch``
    absorbs the residual — so the legs sum to the wall exactly.  On a
    fresh-signature call the step call pays the signature's one-time
    costs (train/telemetry.py), so the call duration lands in
    ``compile`` and goodput's numerator gets nothing.  Otherwise the
    call duration is the ``device_compute`` leg — under CUDA's async
    launches that is launch time until the queue backpressures and
    device time after, exactly the host-side timing contract
    train/telemetry.py documents (health mode fences per step, making
    the leg true device time).
    """

    def __init__(self, name: str = "default", history: int = 4096,
                 window: int = 256, enabled: Optional[bool] = None):
        self.name = name
        self.enabled = _enabled() if enabled is None else bool(enabled)
        self.window = int(window)
        self._lock = threading.Lock()
        self._samples: Dict[str, collections.deque] = {
            comp: collections.deque(maxlen=history)
            for comp in ANATOMY_COMPONENTS}
        self._wall: collections.deque = collections.deque(maxlen=history)
        #: per-step raw decompositions (ms) — the exact-sum invariant
        #: is asserted over these, not over pooled percentiles
        self._last_steps: collections.deque = collections.deque(maxlen=64)
        #: rolling (wall_s, productive_s) pairs for the goodput ratio
        self._window: collections.deque = collections.deque(
            maxlen=self.window)
        self._steps = 0
        self._pending_data_wait = 0.0
        self._pending_h2d = 0.0
        self._pending_ckpt = 0.0
        self._ckpt = {
            "saves": 0, "restores": 0,
            "save_ms": collections.deque(maxlen=history),
            "restore_ms": collections.deque(maxlen=history),
            "bytes_written": 0, "bytes_read": 0, "last_step": None,
        }

    # -- producers -----------------------------------------------------

    def note_data_wait(self, seconds: float) -> None:
        """Batch-iterator stall time since the last step (the
        ``watch_data`` probe calls this per ``__next__``)."""
        if not self.enabled:
            return
        with self._lock:
            self._pending_data_wait += max(0.0, float(seconds))

    def note_h2d(self, seconds: float) -> None:
        """An explicitly timed host→device transfer for the next step
        (e.g. the batch's copy to the card, which the loop times
        itself)."""
        if not self.enabled:
            return
        with self._lock:
            self._pending_h2d += max(0.0, float(seconds))

    def record_checkpoint(self, kind: str, dur_s: float,
                          nbytes: int = 0,
                          step: Optional[int] = None) -> None:
        """One checkpoint ``save``/``restore`` pause of ``dur_s``
        seconds; lands in the next step's ``checkpoint`` leg and the
        goodput denominator, plus the ``checkpoint`` counter block."""
        if not self.enabled:
            return
        dur_s = max(0.0, float(dur_s))
        with self._lock:
            self._pending_ckpt += dur_s
            if kind == "save":
                self._ckpt["saves"] += 1
                self._ckpt["save_ms"].append(dur_s * 1e3)
                self._ckpt["bytes_written"] += int(nbytes)
            else:
                self._ckpt["restores"] += 1
                self._ckpt["restore_ms"].append(dur_s * 1e3)
                self._ckpt["bytes_read"] += int(nbytes)
            if step is not None:
                self._ckpt["last_step"] = int(step)

    def record_step(self, call_s: float, *, compiled: bool = False,
                    device_s: Optional[float] = None,
                    now: Optional[float] = None) -> Optional[Dict[str, Any]]:
        """Close one loop-iteration window around a step call of
        ``call_s`` seconds, draining the pending stall buckets.

        ``compiled`` marks a fresh-signature call (the whole call is
        the ``compile`` leg); ``device_s`` optionally overrides the
        device-compute leg (e.g. from the observatory's ``train.step``
        invoke windows) — anything of the call it does not explain is
        ``dispatch``.  Returns the per-step decomposition dict (ms)
        whose legs sum exactly to ``wall_ms``."""
        if not self.enabled:
            return None
        del now  # accepted for signature symmetry with record_* peers
        call_s = max(0.0, float(call_s))
        with self._lock:
            data_wait = self._pending_data_wait
            h2d = self._pending_h2d
            ckpt = self._pending_ckpt
            self._pending_data_wait = 0.0
            self._pending_h2d = 0.0
            self._pending_ckpt = 0.0

            wall = data_wait + h2d + ckpt + call_s
            budget = wall

            def take(x: float) -> float:
                nonlocal budget
                v = min(max(0.0, x), budget)
                budget -= v
                return v

            # stall-first clamp order: stalls are measured directly,
            # compute legs divide whatever the call actually took
            data_wait = take(data_wait)
            ckpt = take(ckpt)
            h2d = take(h2d)
            if compiled:
                compile_ = take(call_s)
                device = take(0.0)
            else:
                compile_ = take(0.0)
                device = take(call_s if device_s is None else device_s)
            dispatch = budget  # residual — legs now sum to wall exactly
            ms = 1e3
            step_rec = {
                "step_wall_ms": wall * ms,
                "data_wait_ms": data_wait * ms,
                "h2d_ms": h2d * ms,
                "dispatch_ms": dispatch * ms,
                "device_compute_ms": device * ms,
                "compile_ms": compile_ * ms,
                "checkpoint_ms": ckpt * ms,
            }
            self._steps += 1
            self._wall.append(step_rec["step_wall_ms"])
            for comp in ANATOMY_COMPONENTS:
                self._samples[comp].append(step_rec[comp])
            self._last_steps.append(step_rec)
            self._window.append((wall, device))
            return step_rec

    # -- cold readers --------------------------------------------------

    def last_steps(self) -> List[Dict[str, Any]]:
        """The most recent raw per-step decompositions (ms)."""
        with self._lock:
            return [dict(s) for s in self._last_steps]

    def anatomy(self) -> Dict[str, Any]:
        """``train_stats()["anatomy"]``: pooled percentiles per leg
        plus the step wall itself, stable-shaped when never stepped."""
        with self._lock:
            pools = {comp: list(self._samples[comp])
                     for comp in ANATOMY_COMPONENTS}
            wall = list(self._wall)
        out: Dict[str, Any] = {"step_wall_ms": _core.summarize(wall)}
        for comp in ANATOMY_COMPONENTS:
            out[comp] = _core.summarize(pools[comp])
        return out

    def goodput_stats(self) -> Dict[str, Any]:
        """``train_stats()["goodput"]``: productive device seconds
        over loop wall seconds across the rolling window."""
        with self._lock:
            pairs = list(self._window)
            steps = self._steps
        wall = sum(w for w, _ in pairs)
        productive = sum(p for _, p in pairs)
        return {
            "ratio": (round(productive / wall, 4) if wall > 0 else None),
            "productive_s": round(productive, 6),
            "wall_s": round(wall, 6),
            "steps": steps,
            "window": self.window,
        }

    def checkpoint_stats(self) -> Dict[str, Any]:
        """``train_stats()["checkpoint"]`` counter block."""
        with self._lock:
            c = self._ckpt
            save_ms = list(c["save_ms"])
            restore_ms = list(c["restore_ms"])
            out = {"saves": c["saves"], "restores": c["restores"],
                   "bytes_written": c["bytes_written"],
                   "bytes_read": c["bytes_read"],
                   "last_step": c["last_step"]}
        out["save_ms"] = _core.summarize(save_ms)
        out["restore_ms"] = _core.summarize(restore_ms)
        return out


class DataWaitProbe:
    """Iterator wrapper timing ``__next__`` into a tracker's
    ``data_wait`` bucket — wrap the batch source once and input-bound
    steps become visible without touching the loop body."""

    def __init__(self, iterable: Iterable, tracker: GoodputTracker):
        self._it = iter(iterable)
        self.tracker = tracker

    def __iter__(self) -> "DataWaitProbe":
        return self

    def __next__(self) -> Any:
        t0 = time.perf_counter()
        try:
            item = next(self._it)
        finally:
            self.tracker.note_data_wait(time.perf_counter() - t0)
        return item


def watch_data(iterable: Iterable,
               tracker: Optional[GoodputTracker] = None,
               trainer: str = "default") -> DataWaitProbe:
    """Wrap a batch iterator so its stall time lands in the named
    trainer's ``data_wait`` leg."""
    return DataWaitProbe(iterable,
                         tracker or get_goodput_tracker(trainer))


# ---------------------------------------------------------------------------
# health watchdog
# ---------------------------------------------------------------------------

class _Ewma:
    """EWMA mean/variance over finite observations (NaN/inf are
    detected, never folded into the running statistics)."""

    def __init__(self, alpha: float = 0.1):
        self.alpha = alpha
        self.n = 0
        self.mean = 0.0
        self.var = 0.0
        self.last: Optional[float] = None

    def z(self, x: float) -> Optional[float]:
        if self.n < 1 or self.var <= 0:
            return None
        return (x - self.mean) / math.sqrt(self.var + 1e-12)

    def update(self, x: float) -> None:
        self.last = x
        if self.n == 0:
            self.mean = x
        else:
            d = x - self.mean
            self.mean += self.alpha * d
            self.var = (1 - self.alpha) * (self.var
                                           + self.alpha * d * d)
        self.n += 1

    def stats(self) -> Dict[str, Any]:
        return {"last": self.last,
                "ewma": round(self.mean, 6) if self.n else None,
                "ewma_std": (round(math.sqrt(max(0.0, self.var)), 6)
                             if self.n else None)}


class HealthWatchdog:
    """Host-side detector over the per-step health scalars.

    Triggers: non-finite loss, non-finite grad norm, any non-finite
    gradient leaf elements, and EWMA z-score spikes of loss or grad
    norm past ``z_threshold`` (after ``warmup`` finite observations).
    Every observation journals ``train_step``; an anomaly journals
    ``train_anomaly`` and dumps a flight-recorder postmortem naming
    the step, trainer, batch signature, and the last-k metric trail
    — at most one dump per ``dump_cooldown`` steps so a NaN'd run
    does not flood the dump dir."""

    def __init__(self, trainer: str = "default", *,
                 ewma_alpha: float = 0.1, z_threshold: float = 6.0,
                 warmup: int = 8, trail: int = 32,
                 dump_cooldown: int = 50,
                 recorder: Optional[FlightRecorder] = None):
        self.trainer = trainer
        self.z_threshold = float(z_threshold)
        self.warmup = int(warmup)
        self.dump_cooldown = int(dump_cooldown)
        self.recorder = recorder or get_train_recorder(trainer)
        self._lock = threading.Lock()
        self._loss = _Ewma(ewma_alpha)
        self._grad = _Ewma(ewma_alpha)
        self._trail: collections.deque = collections.deque(maxlen=trail)
        self.observed = 0
        self.anomalies = 0
        self.last_anomaly: Optional[Dict[str, Any]] = None
        self.dumps: List[str] = []
        self._last_dump_step: Optional[int] = None

    def _detect(self, loss: float, grad_norm: Optional[float],
                nonfinite: int) -> List[Dict[str, Any]]:
        reasons: List[Dict[str, Any]] = []
        if not math.isfinite(loss):
            reasons.append({"reason": "nonfinite_loss",
                            "metric": "loss", "value": repr(loss)})
        elif self._loss.n >= self.warmup:
            z = self._loss.z(loss)
            if z is not None and abs(z) > self.z_threshold:
                reasons.append({"reason": "loss_spike",
                                "metric": "loss", "value": loss,
                                "z": round(z, 2)})
        if nonfinite:
            reasons.append({"reason": "nonfinite_grads",
                            "metric": "nonfinite_leaf_elems",
                            "value": int(nonfinite)})
        if grad_norm is not None:
            if not math.isfinite(grad_norm):
                reasons.append({"reason": "nonfinite_grad_norm",
                                "metric": "grad_norm",
                                "value": repr(grad_norm)})
            elif self._grad.n >= self.warmup:
                z = self._grad.z(grad_norm)
                if z is not None and abs(z) > self.z_threshold:
                    reasons.append({"reason": "grad_spike",
                                    "metric": "grad_norm",
                                    "value": grad_norm,
                                    "z": round(z, 2)})
        return reasons

    def observe(self, step: int, loss: float,
                grad_norm: Optional[float] = None, nonfinite: int = 0,
                signature: Optional[str] = None,
                wall_ms: Optional[float] = None,
                now: Optional[float] = None
                ) -> Optional[Dict[str, Any]]:
        """Feed one step's scalars; returns the anomaly dict when the
        detector fires, else None.  ``now`` is an injectable
        perf_counter timestamp for deterministic tests."""
        loss = float(loss)
        grad_norm = None if grad_norm is None else float(grad_norm)
        nonfinite = int(nonfinite)
        self.recorder.record(
            "train_step", ts=now, step=int(step),
            loss=(round(loss, 6) if math.isfinite(loss)
                  else repr(loss)),
            grad_norm=(None if grad_norm is None else
                       (round(grad_norm, 6)
                        if math.isfinite(grad_norm)
                        else repr(grad_norm))),
            nonfinite=nonfinite,
            **({"wall_ms": round(wall_ms, 3)}
               if wall_ms is not None else {}))
        with self._lock:
            self.observed += 1
            reasons = self._detect(loss, grad_norm, nonfinite)
            if math.isfinite(loss):
                self._loss.update(loss)
            if grad_norm is not None and math.isfinite(grad_norm):
                self._grad.update(grad_norm)
            self._trail.append({
                "step": int(step),
                "loss": loss if math.isfinite(loss) else repr(loss),
                "grad_norm": (grad_norm
                              if grad_norm is None
                              or math.isfinite(grad_norm)
                              else repr(grad_norm)),
                "nonfinite": nonfinite})
            if not reasons:
                return None
            self.anomalies += 1
            first = reasons[0]
            anomaly = {"trainer": self.trainer, "step": int(step),
                       "reason": first["reason"],
                       "metric": first["metric"],
                       "value": first["value"],
                       "reasons": reasons,
                       "signature": signature}
            self.last_anomaly = anomaly
            trail = list(self._trail)
            cooled = (self._last_dump_step is None
                      or int(step) - self._last_dump_step
                      >= self.dump_cooldown)
            if cooled:
                self._last_dump_step = int(step)
        self.recorder.record("train_anomaly", ts=now, step=int(step),
                             reason=first["reason"],
                             metric=first["metric"],
                             value=first["value"])
        if cooled:
            path = self.recorder.dump(
                reason=f"train_anomaly_{first['reason']}",
                context={"trainer": self.trainer, "step": int(step),
                         "reason": first["reason"],
                         "metric": first["metric"],
                         "value": first["value"],
                         "signature": signature,
                         "trail": trail})
            if path:
                with self._lock:
                    self.dumps.append(path)
        return anomaly

    def stats(self) -> Dict[str, Any]:
        """``train_stats()["health"]`` block."""
        with self._lock:
            return {"observed": self.observed,
                    "anomalies": self.anomalies,
                    "last_anomaly": (dict(self.last_anomaly)
                                     if self.last_anomaly else None),
                    "loss": self._loss.stats(),
                    "grad_norm": self._grad.stats(),
                    "z_threshold": self.z_threshold,
                    "dumps": list(self.dumps)}


# ---------------------------------------------------------------------------
# per-trainer singletons
# ---------------------------------------------------------------------------

_trackers: Dict[str, GoodputTracker] = {}
_watchdogs: Dict[str, HealthWatchdog] = {}
_recorders: Dict[str, FlightRecorder] = {}
# reentrant: HealthWatchdog.__init__ resolves its recorder through
# get_train_recorder while get_health_watchdog holds this lock
_singleton_lock = threading.RLock()


def get_goodput_tracker(name: str = "default") -> GoodputTracker:
    with _singleton_lock:
        t = _trackers.get(name)
        if t is None:
            t = _trackers[name] = GoodputTracker(name)
        return t


def get_health_watchdog(name: str = "default", **kwargs: Any
                        ) -> HealthWatchdog:
    with _singleton_lock:
        w = _watchdogs.get(name)
        if w is None:
            w = _watchdogs[name] = HealthWatchdog(name, **kwargs)
        return w


def get_train_recorder(name: str = "default") -> FlightRecorder:
    """The named trainer's flight recorder (``train:{name}`` source) —
    the journal ``train_step``/``train_anomaly``/``ckpt_*`` events
    land in, and the postmortem dump path the watchdog uses."""
    with _singleton_lock:
        r = _recorders.get(name)
        if r is None:
            r = _recorders[name] = FlightRecorder(f"train:{name}")
        return r


def registered_trainers() -> List[str]:
    """Every trainer name that has trainwatch or step-telemetry state
    in THIS process (the dashboard's ``/api/train/stats`` key set)."""
    from ray_tpu_torch.train.telemetry import telemetry_names

    with _singleton_lock:
        names = set(_trackers) | set(_watchdogs) | set(_recorders)
    return sorted(names | set(telemetry_names()))


def trainwatch_blocks(name: str = "default") -> Dict[str, Any]:
    """The ``anatomy``/``goodput``/``health``/``checkpoint``/
    ``flightrec`` blocks ``train_stats()`` merges in — stable-shaped
    even for a trainer that never stepped."""
    tracker = get_goodput_tracker(name)
    return {
        "anatomy": tracker.anatomy(),
        "goodput": tracker.goodput_stats(),
        "health": get_health_watchdog(name).stats(),
        "checkpoint": tracker.checkpoint_stats(),
        "flightrec": get_train_recorder(name).stats(),
    }


def dominant_component(anatomy: Dict[str, Any]) -> Optional[str]:
    """The anatomy leg with the largest mean (None when no steps) —
    ``data_wait_ms`` dominance is the input-bound verdict autopilot
    attribution cites."""
    best, best_mean = None, 0.0
    for comp in ANATOMY_COMPONENTS:
        mean = (anatomy.get(comp) or {}).get("mean")
        if isinstance(mean, (int, float)) and mean > best_mean:
            best, best_mean = comp, float(mean)
    return best


def worker_skew(step_ms_by_worker: Dict[str, float],
                threshold: float = 1.25) -> Dict[str, Any]:
    """Multi-worker straggler detection over per-worker mean step
    times (workers ``session.report`` their ``train_stats()`` up; the
    coordinating process feeds ``{worker: step_time_ms_mean}`` here).
    A worker slower than ``threshold`` × the median is flagged."""
    vals = {str(k): float(v) for k, v in step_ms_by_worker.items()
            if isinstance(v, (int, float))}
    if not vals:
        return {"workers": 0, "median_ms": None, "max_ms": None,
                "spread": None, "stragglers": [],
                "threshold": threshold}
    ordered = sorted(vals.values())
    mid = len(ordered) // 2
    # true median (even counts average the middles) — upper-middle
    # would let a 2x straggler in a 2-worker fleet BE the median and
    # never flag
    median = (ordered[mid] if len(ordered) % 2
              else (ordered[mid - 1] + ordered[mid]) / 2.0)
    spread = ((ordered[-1] - ordered[0]) / median) if median > 0 else 0.0
    stragglers = sorted(w for w, v in vals.items()
                        if median > 0 and v > threshold * median)
    return {"workers": len(vals), "median_ms": round(median, 3),
            "max_ms": round(ordered[-1], 3),
            "spread": round(spread, 4), "stragglers": stragglers,
            "threshold": threshold}


# ---------------------------------------------------------------------------
# the step wrapper build_train_step / grad_accum compose in
# ---------------------------------------------------------------------------

_HEALTH_KEYS = ("loss", "grad_norm", "nonfinite")


def _fetch_health(scalars: Dict[str, Any]) -> Dict[str, float]:
    """The health dict's scalars on the host, in ONE device-to-host
    copy: stacked as float64 on their device (exact for the int32
    nonfinite count, where float32 is not above 2**24), then one
    ``tolist()``."""
    keys = [k for k in _HEALTH_KEYS if k in scalars]
    if not keys:
        return {}
    vals = torch.stack([torch.as_tensor(scalars[k]).to(torch.float64)
                        for k in keys]).tolist()
    return dict(zip(keys, vals))


def instrument_trainwatch(step_fn: Callable, *,
                          tracker: Optional[GoodputTracker] = None,
                          watchdog: Optional[HealthWatchdog] = None,
                          trainer: str = "default",
                          batch_arg: int = 2,
                          health_index: int = 3) -> Callable:
    """Wrap a train step with anatomy/goodput recording and, when
    ``watchdog`` is given, per-step health observation.

    Without a watchdog the wrapper adds one ``perf_counter`` pair and
    a dict append — no syncs, preserving async launches.  With one, it
    copies the small health dict the step returns at
    ``out[health_index]`` (three scalars) to the host in one transfer
    (``_fetch_health``), which fences the step — the deliberate
    per-step host fence health mode buys its detection latency with,
    and what makes the ``device_compute`` anatomy leg true device
    time."""
    tracker = tracker or get_goodput_tracker(trainer)
    seen: set = set()
    counter = [0]

    @functools.wraps(step_fn)
    def wrapped(*args: Any, **kwargs: Any) -> Any:
        if not tracker.enabled:
            return step_fn(*args, **kwargs)
        from ray_tpu_torch.train.telemetry import _batch_signature

        batch = args[batch_arg] if len(args) > batch_arg else None
        sig = None
        if batch is not None:
            try:
                sig = _batch_signature(batch)
            except Exception:  # noqa: BLE001 - exotic batch types
                sig = None
        fresh = sig is not None and sig not in seen
        if fresh:
            seen.add(sig)
        t0 = time.perf_counter()
        out = step_fn(*args, **kwargs)
        health = None
        if watchdog is not None and isinstance(out, tuple) \
                and len(out) > health_index:
            # the per-step fence: 3 scalars D2H, counted inside the
            # step window so the device leg is real compute time
            health = _fetch_health(out[health_index])
        call_s = time.perf_counter() - t0
        tracker.record_step(call_s, compiled=fresh)
        step_idx = counter[0]
        counter[0] += 1
        if health is not None:
            watchdog.observe(
                step_idx, float(health.get("loss", float("nan"))),
                grad_norm=(float(health["grad_norm"])
                           if "grad_norm" in health else None),
                nonfinite=int(health.get("nonfinite", 0)),
                signature=str(sig) if sig is not None else None,
                wall_ms=call_s * 1e3)
        return out

    wrapped.__wrapped__ = getattr(step_fn, "__wrapped__", step_fn)
    wrapped.goodput = tracker
    wrapped.watchdog = watchdog
    return wrapped
