"""Device-side perf observatory: the program registry, the card's
peak rates and its allocator view.

The parts of ``ray_tpu/_private/device_stats.py`` that the serve
engine reads, for PyTorch on CUDA:

* **program registry** — one process-wide :class:`ProgramRegistry` of
  named engine programs (``serve.prefill``, ``serve.decode``, ...).
  ``instrument(name, fn)`` wraps a function: the first call with a
  never-seen argument signature counts one **compile event**, as the
  JAX registry counts one XLA compile per fresh signature.  In eager
  PyTorch nothing is traced, but that first call is where a shape pays
  its one-time costs (cuBLAS heuristics, kernel builds, allocator
  growth).  A sliding window of compile timestamps trips a
  ``recompile_storm`` when churn crosses the threshold.  Later calls
  record host walltimes, without an added sync, as in JAX.
* **peak rates** — dense bf16 FLOP/s and HBM bytes/s of one card, keyed
  by ``torch.cuda.get_device_name()``; None for a card the table does
  not know.
* **allocator view** — ``device_memory_stats()`` with the JAX key set,
  read from ``torch.cuda.memory_stats`` and ``torch.cuda.mem_get_info``.

XLA's cost harvest (``compiled.cost_analysis()`` FLOPs and bytes,
``memory_analysis()`` peak HBM) has no counterpart in eager PyTorch, so
a program's ``xla_flops``, ``bytes_accessed``, ``arithmetic_intensity``,
``peak_hbm_bytes`` and ``mfu`` stay in its block as None (a cost model
is ROADMAP.md queue 1 item 7).  The rest of the JAX module waits for
the same item.
"""

from __future__ import annotations

import collections
import functools
import threading
import time
import weakref
from typing import Any, Callable, Dict, List, Optional

from ray_tpu_torch._private import telemetry as _core

#: one NVIDIA H100 SXM (data sheet: dense tensor-core bf16, FP32 without
#: tensor cores, HBM3 bandwidth; at its 700 W limit) — the figures the
#: port's bounds and MFU are computed against
H100_SXM = {"bf16_flops": 989e12, "f32_flops": 67e12,
            "hbm_bytes_per_s": 3.35e12}

#: dense bf16 peak FLOP/s of one device, by a lower-case substring of
#: its name; "cpu" is the JAX table's placeholder
_PEAK_FLOPS_TABLE = {
    "h100 80gb hbm3": H100_SXM["bf16_flops"],
    "cpu": 1e12,
}

#: HBM bytes/s of one device, keyed as ``_PEAK_FLOPS_TABLE``
_PEAK_HBM_BW_TABLE = {
    "h100 80gb hbm3": H100_SXM["hbm_bytes_per_s"],
    "cpu": 100e9,
}

_metrics_lock = threading.Lock()
_metrics: Optional[Dict[str, Any]] = None


def _device_metrics() -> Dict[str, Any]:
    """Process-wide metric singletons (one registration per name no
    matter how many registries tests construct)."""
    global _metrics
    with _metrics_lock:
        if _metrics is None:
            from ray_tpu_torch.util.metrics import Counter, Gauge

            tags = ("program",)
            _metrics = {
                "compile_events": Counter(
                    "device_program_compile_events_total",
                    "first calls per named program with a never-seen "
                    "argument signature", tag_keys=tags),
                "compile_seconds": Counter(
                    "device_program_compile_seconds_total",
                    "walltime of those first calls per named program",
                    tag_keys=tags),
                "storms": Counter(
                    "device_recompile_storms_total",
                    "recompile-storm watchdog trips (compile churn over "
                    "the sliding window)", tag_keys=tags),
                "hbm_in_use": Gauge(
                    "device_hbm_bytes_in_use",
                    "allocator bytes_in_use per card (None-reporting "
                    "devices publish nothing)", tag_keys=("device",)),
            }
        return _metrics


def _device_name(device: Any = None) -> Optional[str]:
    """The name the peak tables are keyed by: the CUDA device's name,
    "cpu" for a CPU device (or no card), None when it cannot be read."""
    try:
        import torch

        if device is None:
            if not torch.cuda.is_available():
                return "cpu"
            device = torch.device("cuda", torch.cuda.current_device())
        device = torch.device(device)
        if device.type != "cuda":
            return device.type
        return torch.cuda.get_device_name(device)
    except Exception:  # noqa: BLE001 - no backend
        return None


def _lookup(table: Dict[str, float], device: Any) -> Optional[float]:
    name = _device_name(device)
    if name is None:
        return None
    name = name.lower()
    for key, val in table.items():
        if key in name:
            return val
    return None


def peak_flops_per_chip(device: Any = None) -> Optional[float]:
    """Dense bf16 peak FLOP/s of one device (default: the current CUDA
    card, or the CPU without one); None for a card the table does not
    know."""
    return _lookup(_PEAK_FLOPS_TABLE, device)


def peak_hbm_bytes_per_sec(device: Any = None) -> Optional[float]:
    """HBM bytes/s of one device, as :func:`peak_flops_per_chip`."""
    return _lookup(_PEAK_HBM_BW_TABLE, device)


def device_roofline(device: Any = None) -> Dict[str, Any]:
    """The roofline constants in one JSON-able block: the backend
    ("cuda" | "cpu"), the device's name, peak FLOP/s, HBM bytes/s and
    their ratio, the ridge point in FLOP/byte (None where a rate is
    unknown)."""
    name = _device_name(device)
    backend = None if name is None else (
        "cpu" if name == "cpu" else "cuda")
    flops = peak_flops_per_chip(device)
    bw = peak_hbm_bytes_per_sec(device)
    return {
        "backend": backend,
        "device_kind": name,
        "peak_flops_per_chip": flops,
        "peak_hbm_bytes_per_sec": bw,
        "ridge_flops_per_byte": (round(flops / bw, 1)
                                 if flops and bw else None),
    }


def _leaves(obj, out: list) -> list:
    """The leaves of a nested tuple/list/dict (dict keys sorted, None
    dropped), the order ``jax.tree_util.tree_leaves`` gives."""
    if obj is None:
        return out
    if isinstance(obj, (tuple, list)):
        for x in obj:
            _leaves(x, out)
    elif isinstance(obj, dict):
        for k in sorted(obj):
            _leaves(obj[k], out)
    else:
        out.append(obj)
    return out


def _signature(args: tuple, kwargs: dict) -> tuple:
    """Hashable key of one call, seen as the JAX registry sees a jit
    call: a tensor or numpy array (numpy scalars included) by (shape,
    dtype), a random generator (the JAX engine's PRNG key, a fixed
    shape) by its type, any other leaf (a Python int, ...) by its
    value."""
    import torch

    sig = []
    for leaf in _leaves((args, kwargs), []):
        if isinstance(leaf, torch.Tensor):
            sig.append((tuple(leaf.shape),
                        str(leaf.dtype).replace("torch.", "")))
        elif hasattr(leaf, "shape") and hasattr(leaf, "dtype"):
            sig.append((tuple(leaf.shape), str(leaf.dtype)))
        elif isinstance(leaf, torch.Generator):
            sig.append(("Generator",))
        else:
            sig.append((type(leaf).__name__, repr(leaf)[:32]))
    return tuple(sig)


class ProgramRegistry:
    """Per-process registry of named engine programs.

    ``instrument(name, fn)`` wraps a callable: the wrapper always
    executes the original, and on the side detects compile events by
    argument signature, feeds the recompile watchdog, and records
    invoke walltimes.  All clocks are injectable for deterministic
    tests."""

    def __init__(self, storm_window_s: float = 60.0,
                 storm_threshold: int = 5, invoke_history: int = 512,
                 now: Optional[Callable[[], float]] = None):
        self.storm_window_s = float(storm_window_s)
        self.storm_threshold = int(storm_threshold)
        self._now = now or time.perf_counter
        self._invoke_history = int(invoke_history)
        self._lock = threading.Lock()
        self._m = _device_metrics()
        self._programs: Dict[str, Dict[str, Any]] = {}
        self._subscribers: List[Any] = []
        self._storm_subscribers: List[Any] = []

    # -- bookkeeping -------------------------------------------------------

    def _rec(self, program: str) -> Dict[str, Any]:
        rec = self._programs.get(program)
        if rec is None:
            rec = self._programs[program] = {
                "compile_events": 0,
                "compile_seconds": 0.0,
                "compile_times": collections.deque(maxlen=256),
                "invokes": 0,
                "invoke_s": collections.deque(
                    maxlen=self._invoke_history),
                "storms": 0,
                "storm_active": False,
            }
        return rec

    def record_compile(self, program: str, seconds: float,
                       now: Optional[float] = None) -> None:
        """One compile event of `program` taking `seconds` walltime."""
        ts = self._now() if now is None else now
        with self._lock:
            rec = self._rec(program)
            rec["compile_events"] += 1
            rec["compile_seconds"] += float(seconds)
            rec["compile_times"].append(ts)
            recent = [t for t in rec["compile_times"]
                      if ts - t <= self.storm_window_s]
            storm = len(recent) >= self.storm_threshold
            fresh_storm = storm and not rec["storm_active"]
            rec["storm_active"] = storm
            if fresh_storm:
                rec["storms"] += 1
        self._m["compile_events"].inc(tags={"program": program})
        self._m["compile_seconds"].inc(max(0.0, float(seconds)),
                                       tags={"program": program})
        if fresh_storm:
            self._m["storms"].inc(tags={"program": program})
            self._notify_storms(program)
        self._notify(program)

    def record_invoke(self, program: str, seconds: float) -> None:
        """One steady-state invoke of `program` taking `seconds`."""
        with self._lock:
            rec = self._rec(program)
            rec["invokes"] += 1
            rec["invoke_s"].append(float(seconds))

    # -- subscribers (e.g. EngineTelemetry.record_program_compile) ---------

    def subscribe(self, callback: Callable[[str], None]) -> None:
        """Call `callback(program)` on every compile event.  Bound
        methods are held by WeakMethod so short-lived engines do not
        leak through the process singleton."""
        self._add(self._subscribers, callback)

    def subscribe_storms(self, callback: Callable[[str], None]) -> None:
        """Call `callback(program)` on every FRESH recompile-storm trip
        (inactive → active).  Weakly held like `subscribe`."""
        self._add(self._storm_subscribers, callback)

    def _add(self, subscribers: List[Any], callback) -> None:
        try:
            ref = weakref.WeakMethod(callback)
        except TypeError:
            ref = (lambda cb=callback: cb)  # plain callables held hard
        with self._lock:
            subscribers.append(ref)

    def _notify(self, program: str) -> None:
        self._fanout("_subscribers", program)

    def _notify_storms(self, program: str) -> None:
        self._fanout("_storm_subscribers", program)

    def _fanout(self, attr: str, program: str) -> None:
        with self._lock:
            refs = list(getattr(self, attr))
        dead = []
        for ref in refs:
            cb = ref()
            if cb is None:
                dead.append(ref)
                continue
            try:
                cb(program)
            except Exception:  # noqa: BLE001 - observer must not break
                pass
        if dead:
            with self._lock:
                setattr(self, attr, [r for r in getattr(self, attr)
                                     if r not in dead])

    # -- instrumentation ---------------------------------------------------

    def instrument(self, program: str, fn: Callable) -> Callable:
        """Wrap `fn` with compile detection and invoke timing under
        `program`.  The wrapper executes `fn` itself."""
        registry = self
        seen: set = set()
        seen_lock = threading.Lock()

        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            try:
                sig = _signature(args, kwargs)
            except Exception:  # noqa: BLE001
                sig = None
            fresh = False
            if sig is not None:
                with seen_lock:
                    fresh = sig not in seen
                    if fresh:
                        seen.add(sig)
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            if fresh:
                # the first call with a fresh signature is the compile
                # event: its walltime stays out of the invoke window
                registry.record_compile(program, time.perf_counter() - t0)
            else:
                registry.record_invoke(program, time.perf_counter() - t0)
            return out

        wrapped.__wrapped__ = fn
        return wrapped

    # -- sinks -------------------------------------------------------------

    def snapshot(self, prefix: Optional[str] = None
                 ) -> Dict[str, Dict[str, Any]]:
        """Per-program observability block with the JAX key set:
        ``{compile_events, compile_seconds, invokes, invoke_ms,
        xla_flops, bytes_accessed, arithmetic_intensity,
        peak_hbm_bytes, recompile_storm, recompile_storms_total,
        mfu}``; the cost-model keys and ``mfu`` are None (module
        docstring)."""
        with self._lock:
            items = [(name, dict(rec), list(rec["invoke_s"]))
                     for name, rec in self._programs.items()]
        out: Dict[str, Dict[str, Any]] = {}
        for name, rec, invoke_s in items:
            if prefix and not name.startswith(prefix):
                continue
            out[name] = {
                "compile_events": rec["compile_events"],
                "compile_seconds": round(rec["compile_seconds"], 3),
                "invokes": rec["invokes"],
                "invoke_ms": _core.summarize(
                    [s * 1e3 for s in invoke_s]),
                "xla_flops": None,
                "bytes_accessed": None,
                "arithmetic_intensity": None,
                "peak_hbm_bytes": None,
                "recompile_storm": rec["storm_active"],
                "recompile_storms_total": rec["storms"],
                "mfu": None,
            }
        return out

    def programs(self) -> List[str]:
        with self._lock:
            return sorted(self._programs)

    def reset(self) -> None:
        with self._lock:
            self._programs.clear()
            self._subscribers.clear()


_registry_lock = threading.Lock()
_registry: Optional[ProgramRegistry] = None


def get_registry() -> ProgramRegistry:
    """The process singleton every hook reports through."""
    global _registry
    with _registry_lock:
        if _registry is None:
            _registry = ProgramRegistry()
        return _registry


def reset_registry() -> None:
    """Testing hook: drop all recorded programs and subscribers."""
    with _registry_lock:
        if _registry is not None:
            _registry.reset()


_DEVICE_STAT_KEYS = ("bytes_in_use", "peak_bytes_in_use", "bytes_limit",
                     "largest_alloc_size")


def device_memory_stats(devices: Optional[List[Any]] = None, *,
                        largest_alloc: bool = True
                        ) -> List[Dict[str, Any]]:
    """Per-device allocator snapshot with a STABLE key set: every entry
    carries id/platform/device_kind plus ``bytes_in_use``,
    ``peak_bytes_in_use``, ``bytes_limit`` and ``largest_alloc_size``
    (``None`` where the device reports nothing: a CPU device gives the
    None row JAX's CPU gives).  ``devices``: torch devices or names
    (default: every CUDA card, none without one).

    On a card, "in use" is the caching allocator's ALLOCATED bytes
    (``allocated_bytes.all.current``/``.peak``: what live tensors
    hold), not its reserved bytes (``reserved_bytes.all.current``: the
    segments reserved through cudaMalloc, a second, larger figure that
    includes freed blocks kept for reuse).  ``bytes_limit`` is the
    card's total memory (``torch.cuda.mem_get_info``), and
    ``largest_alloc_size`` the allocator's largest segment (None before
    the first allocation).  Finding that segment walks every block of
    ``torch.cuda.memory_snapshot()``; ``largest_alloc=False`` skips the
    walk and leaves the key None (the admission gate's cheap read)."""
    import torch

    if devices is None:
        if not torch.cuda.is_available():
            return []
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    metrics = _device_metrics()
    out: List[Dict[str, Any]] = []
    for dev in devices:
        dev = torch.device(dev)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        entry: Dict[str, Any] = {
            "id": dev.index if dev.type == "cuda" else 0,
            "platform": "gpu" if dev.type == "cuda" else dev.type,
            "device_kind": _device_name(dev),
        }
        for key in _DEVICE_STAT_KEYS:
            entry[key] = None
        if dev.type == "cuda":
            try:
                stats = torch.cuda.memory_stats(dev)
                entry["bytes_in_use"] = int(
                    stats.get("allocated_bytes.all.current", 0))
                entry["peak_bytes_in_use"] = int(
                    stats.get("allocated_bytes.all.peak", 0))
                entry["bytes_limit"] = int(torch.cuda.mem_get_info(dev)[1])
                if largest_alloc and stats.get("segment.all.current"):
                    entry["largest_alloc_size"] = max(
                        (int(s["total_size"])
                         for s in torch.cuda.memory_snapshot()
                         if s.get("device") == dev.index), default=None)
            except Exception:  # noqa: BLE001 - allocator view best-effort
                pass
        if entry["bytes_in_use"] is not None:
            metrics["hbm_in_use"].set(
                entry["bytes_in_use"], tags={"device": str(entry["id"])})
        out.append(entry)
    return out
