"""Shared telemetry primitives for the serve/train hot paths.

A copy of ``ray_tpu/_private/telemetry.py``.  The engine telemetry
layer (serve/telemetry.py) works on HOST-side timestamps only — nothing
here ever touches a device tensor or forces a sync; producers time
around syncs the hot path already performs (the ``.cpu()`` of a decode
wave's sampled tokens in the engine).

Two shared pieces live here:

* percentile summaries over raw latency samples (the ``engine_stats()``
  p50/p95/p99 blocks), nearest-rank so a 3-sample TTFT series reports
  its actual observations, not interpolated fiction;
* chrome-trace event builders emitting the exact shape the JAX
  package's ``ray_tpu.timeline()`` writes (name/cat/ph/ts/dur/pid/tid/
  args, ts in microseconds) so engine timelines and task timelines open
  in the same chrome://tracing / Perfetto view.
"""

from __future__ import annotations

import json
import math
from typing import Any, Dict, List, Optional, Sequence

#: percentiles every summarize() block reports
PERCENTILES = (50, 95, 99)


def percentile(sorted_values: Sequence[float], q: float) -> float:
    """Nearest-rank percentile over an ascending-sorted sample."""
    if not sorted_values:
        raise ValueError("percentile of an empty sample")
    rank = max(1, math.ceil(q / 100.0 * len(sorted_values)))
    return float(sorted_values[rank - 1])


def summarize(values: Sequence[float]) -> Dict[str, Any]:
    """{count, mean, p50, p95, p99, max} over raw samples (all None
    except count=0 when empty, so JSON consumers see a stable shape)."""
    vals = sorted(float(v) for v in values)
    if not vals:
        return {"count": 0, "mean": None, "p50": None, "p95": None,
                "p99": None, "max": None}
    out: Dict[str, Any] = {
        "count": len(vals),
        "mean": round(sum(vals) / len(vals), 3),
        "max": round(vals[-1], 3),
    }
    for q in PERCENTILES:
        out[f"p{q}"] = round(percentile(vals, q), 3)
    return out


# ---------------------------------------------------------------------------
# chrome-trace builders (the event shape of ray_tpu.timeline())
# ---------------------------------------------------------------------------

def complete_event(name: str, cat: str, ts_s: float, dur_s: float,
                   pid: int, tid: int,
                   args: Optional[Dict[str, Any]] = None
                   ) -> Dict[str, Any]:
    """A chrome-trace "X" (complete) event; ts/dur seconds → µs."""
    return {"name": name, "cat": cat, "ph": "X",
            "ts": ts_s * 1e6, "dur": max(0.0, dur_s) * 1e6,
            "pid": pid, "tid": tid, "args": args or {}}


def instant_event(name: str, cat: str, ts_s: float, pid: int, tid: int,
                  args: Optional[Dict[str, Any]] = None
                  ) -> Dict[str, Any]:
    """A chrome-trace "i" (instant) event."""
    return {"name": name, "cat": cat, "ph": "i", "s": "t",
            "ts": ts_s * 1e6, "pid": pid, "tid": tid, "args": args or {}}


def process_name_event(pid: int, name: str) -> Dict[str, Any]:
    return {"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
            "args": {"name": name}}


def thread_name_event(pid: int, tid: int, name: str) -> Dict[str, Any]:
    return {"name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
            "args": {"name": name}}


def write_chrome_trace(events: List[Dict[str, Any]],
                       filename: Optional[str]) -> List[Dict[str, Any]]:
    """Dump events as chrome-trace JSON (a bare event array, the format
    ray_tpu.timeline() writes); returns the events for chaining."""
    if filename:
        with open(filename, "w") as f:
            json.dump(events, f)
    return events
