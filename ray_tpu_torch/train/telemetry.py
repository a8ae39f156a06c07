"""Step-level telemetry for training loops: a copy of
``ray_tpu/train/telemetry.py``.

``instrument_train_step`` wraps a train step with host-side timing: a
``perf_counter`` pair around the call, no device sync added, so under
CUDA's asynchronous launches the recorded time is launch time until
the launch queue backpressures and device-step time after.  Each
distinct signature of the batch argument (leaf shapes and dtypes)
counts one compile event.  Eager PyTorch compiles no program: the
first call of a signature is where a shape pays its one-time costs
(allocator growth, cuBLAS handles, a kernel's first build), and its
whole wall is booked as the compile, as the JAX package books the
trace and XLA compile.

Metrics land in the port's ``util/metrics.py`` registry and in an
in-process ``stats()`` snapshot shaped as the serve engine's
``engine_stats()``.
"""

from __future__ import annotations

import collections
import functools
import threading
import time
from typing import Any, Callable, Dict, Optional

from ray_tpu_torch._private import telemetry as _core
from ray_tpu_torch.train.optim import tree_leaves

_STEP_BOUNDS_MS = (1.0, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0,
                   1000.0, 2500.0, 5000.0, 10000.0, 30000.0)

_metrics_lock = threading.Lock()
_metrics: Optional[Dict[str, Any]] = None


def _train_metrics() -> Dict[str, Any]:
    global _metrics
    with _metrics_lock:
        if _metrics is None:
            from ray_tpu_torch.util.metrics import Counter, Gauge, Histogram

            tags = ("trainer",)
            _metrics = {
                "step_time": Histogram(
                    "train_step_time_ms",
                    "host walltime per train step call",
                    boundaries=_STEP_BOUNDS_MS, tag_keys=tags),
                "examples_per_sec": Gauge(
                    "train_examples_per_sec",
                    "examples consumed per second (last step)",
                    tag_keys=tags),
                "steps": Counter(
                    "train_steps_total", "train step calls",
                    tag_keys=tags),
                "compiles": Counter(
                    "train_compile_events_total",
                    "distinct batch signatures seen (one compile event "
                    "each)", tag_keys=tags),
            }
        return _metrics


class TrainTelemetry:
    """Per-trainer recorder; cheap enough to call once per step."""

    def __init__(self, name: str = "default", history: int = 4096):
        self.name = name
        self._m = _train_metrics()
        self._tags = {"trainer": name}
        self._lock = threading.Lock()
        self._durs: collections.deque = collections.deque(maxlen=history)
        self._steps = 0
        self._compiles = 0
        self._examples = 0
        self._last_eps = 0.0

    def record_step(self, dur_s: float,
                    examples: Optional[int] = None) -> None:
        with self._lock:
            self._durs.append(float(dur_s))
            self._steps += 1
            if examples:
                self._examples += int(examples)
                if dur_s > 0:
                    self._last_eps = examples / dur_s
        self._m["step_time"].observe(dur_s * 1e3, tags=self._tags)
        self._m["steps"].inc(tags=self._tags)
        if examples and dur_s > 0:
            self._m["examples_per_sec"].set(
                round(examples / dur_s, 1), tags=self._tags)

    def record_compile(self, signature: str = "") -> None:
        with self._lock:
            self._compiles += 1
        self._m["compiles"].inc(tags=self._tags)

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            durs = list(self._durs)
            out = {"trainer": self.name, "steps": self._steps,
                   "compiles": self._compiles,
                   "examples": self._examples,
                   "examples_per_sec": round(self._last_eps, 1)}
        out["step_time_ms"] = _core.summarize([d * 1e3 for d in durs])
        return out


_telemetries: Dict[str, TrainTelemetry] = {}
_telemetries_lock = threading.Lock()


def get_train_telemetry(name: str = "default") -> TrainTelemetry:
    """Process-wide TrainTelemetry singleton per trainer name."""
    with _telemetries_lock:
        tel = _telemetries.get(name)
        if tel is None:
            tel = _telemetries[name] = TrainTelemetry(name)
        return tel


def telemetry_names() -> list:
    """Trainer names with step telemetry in this process."""
    with _telemetries_lock:
        return sorted(_telemetries)


def train_stats(name: str = "default") -> Dict[str, Any]:
    """Snapshot for the named trainer (empty-shaped if never stepped).

    Beyond the step-time block this carries the trainwatch view
    (train/goodput.py): ``anatomy`` (per-step wall decomposed into
    data_wait/h2d/dispatch/device_compute/compile/checkpoint, legs
    summing exactly to the wall), ``goodput`` (rolling productive
    device time over loop wall), ``health`` (watchdog EWMA state and
    anomaly dumps), ``checkpoint`` (save/restore counters), and
    ``flightrec`` (the trainer's journal occupancy)."""
    from ray_tpu_torch.train.goodput import trainwatch_blocks

    out = get_train_telemetry(name).stats()
    out.update(trainwatch_blocks(name))
    return out


def _dtype_name(x: Any) -> str:
    """A leaf's dtype as the JAX package writes it: ``'int32'``, not
    ``'torch.int32'``; a leaf without a dtype by its type's name."""
    dtype = getattr(x, "dtype", None)
    if dtype is None:
        return type(x).__name__
    return str(dtype).replace("torch.", "")


def _batch_signature(batch: Any) -> tuple:
    """Abstract signature of the batch tree: leaf shapes + dtypes
    (tensors and numpy arrays alike).  A fresh signature is a compile
    event."""
    return tuple((tuple(getattr(x, "shape", ())), _dtype_name(x))
                 for x in tree_leaves(batch))


def _leading_dim(batch: Any) -> Optional[int]:
    for leaf in tree_leaves(batch):
        shape = getattr(leaf, "shape", None)
        if shape:
            return int(shape[0])
    return None


def instrument_train_step(step_fn: Callable,
                          telemetry: Optional[TrainTelemetry] = None,
                          batch_arg: int = 2) -> Callable:
    """Wrap a train step with step-time / compile / throughput
    telemetry.  ``batch_arg`` is the positional index of the batch
    tree (2 for the canonical ``step(params, opt_state, batch)``);
    out-of-range indices simply skip the examples/sec gauge."""
    tel = telemetry or get_train_telemetry()
    seen: set = set()

    @functools.wraps(step_fn)
    def wrapped(*args, **kwargs):
        batch = args[batch_arg] if len(args) > batch_arg else None
        examples = None
        if batch is not None:
            try:
                sig = _batch_signature(batch)
                examples = _leading_dim(batch)
            except Exception:  # noqa: BLE001 - exotic batch types
                sig = None
            if sig is not None and sig not in seen:
                seen.add(sig)
                tel.record_compile(str(sig))
        t0 = time.perf_counter()
        out = step_fn(*args, **kwargs)
        tel.record_step(time.perf_counter() - t0, examples=examples)
        return out

    wrapped.__wrapped__ = step_fn
    wrapped.telemetry = tel
    return wrapped
