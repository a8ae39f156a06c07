"""State/observability API (reference analog:
python/ray/experimental/state/api.py + dashboard/state_aggregator.py:132
StateAPIManager — `ray list actors/tasks/...`, summaries).

A copy of ``ray_tpu/util/state.py``; ``profile_device`` records the
card's side with ``torch.profiler`` where the JAX package uses
``jax.profiler``.
"""

from __future__ import annotations

from collections import Counter
from typing import Any, Dict, List, Optional

from ray_tpu_torch._private import worker_context


def _gcs_call(method: str, payload: Optional[dict] = None):
    import ray_tpu_torch

    ray_tpu_torch._auto_init()
    cw = worker_context.core_worker()
    return cw.io.run(cw.gcs.call(method, payload or {}))


def list_nodes() -> List[Dict[str, Any]]:
    return [{"node_id": n["node_id"].hex(), "alive": n["alive"],
             "address": n["address"], "resources": n["resources_total"],
             "available": n.get("resources_available", {})}
            for n in _gcs_call("node_list")]


def list_actors() -> List[Dict[str, Any]]:
    return [{"actor_id": a["actor_id"].hex(), "name": a["name"],
             "state": a["state"],
             "node_id": a["node_id"].hex() if a.get("node_id") else "",
             "num_restarts": a.get("num_restarts", 0),
             "resources": a.get("resources", {})}
            for a in _gcs_call("actor_list")]


def list_tasks(limit: int = 10000) -> List[Dict[str, Any]]:
    """Finished-task events (start/end/worker); running tasks appear once
    their worker flushes (~1s)."""
    return _gcs_call("task_events_list", {"limit": limit})


def list_placement_groups() -> List[Dict[str, Any]]:
    return [{"pg_id": p["pg_id"].hex(), "name": p["name"],
             "state": p["state"], "strategy": p["strategy"],
             "bundles": p["bundles"]}
            for p in _gcs_call("pg_list")]


def summarize_tasks() -> Dict[str, Any]:
    events = list_tasks()
    by_name = Counter(e["name"] for e in events)
    total_s = sum(e["end"] - e["start"] for e in events)
    return {"total": len(events), "by_func_name": dict(by_name),
            "total_execution_s": round(total_s, 3)}


def summarize_actors() -> Dict[str, Any]:
    actors = list_actors()
    return {"total": len(actors),
            "by_state": dict(Counter(a["state"] for a in actors))}


def timeline(filename: Optional[str] = None) -> List[Dict[str, Any]]:
    """Chrome-trace events for chrome://tracing / Perfetto (reference:
    ray.timeline, _private/state.py:828 chrome_tracing_dump)."""
    events = list_tasks()
    trace = []
    for e in events:
        trace.append({
            "name": e["name"], "cat": "task", "ph": "X",
            "ts": e["start"] * 1e6, "dur": (e["end"] - e["start"]) * 1e6,
            "pid": e["pid"], "tid": e["worker_id"],
            "args": {"task_id": e["task_id"], "actor_id": e["actor_id"]},
        })
    if filename:
        import json

        with open(filename, "w") as f:
            json.dump(trace, f)
    return trace


class profile_device:
    """Capture a device trace alongside the task timeline (reference gap
    noted in SURVEY §5.1: the reference merges Ray task events only;
    the JAX package's ``jax.profiler`` captures the device side, the
    port's ``torch.profiler``).

    Usage:
        with ray_tpu_torch.util.state.profile_device("traces/"):
            train_step(...)
        ray_tpu_torch.timeline("tasks.json")   # task-level chrome trace

    The device trace lands as a chrome trace under ``logdir``
    (``trace_<pid>.json``: the card's kernels where CUDA is up, the
    host's operators always); the task timeline is chrome-trace too.
    The two share wall-clock timestamps, so aligning a slow task with
    its device activity is a same-axis comparison.  Degrades to a
    no-op (with a warning) where the profiler cannot start.
    """

    def __init__(self, logdir: str):
        self.logdir = logdir
        self._prof = None
        #: whether the profiler started (the JAX package's attribute:
        #: the dashboard's profile route reports it)
        self._active = False

    def __enter__(self):
        try:
            import torch

            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            prof.__enter__()
            self._prof = prof
            self._active = True
        except Exception as e:  # noqa: BLE001 - no profiler support
            import logging

            logging.getLogger(__name__).warning(
                "device profiler unavailable (%s); task timeline still "
                "records", e)
        return self

    def __exit__(self, *exc):
        if self._prof is not None:
            import os

            prof, self._prof = self._prof, None
            prof.__exit__(None, None, None)
            os.makedirs(self.logdir, exist_ok=True)
            prof.export_chrome_trace(
                os.path.join(self.logdir, f"trace_{os.getpid()}.json"))
        return False
