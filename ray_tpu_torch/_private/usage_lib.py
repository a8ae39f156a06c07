"""Usage stats: opt-out collection of anonymous cluster facts.

Role-equivalent of the reference's usage-stats subsystem (reference
``python/ray/_private/usage/usage_lib.py:92,266`` — collect cluster
metadata, report periodically, honor an opt-out env/config).  Hermetic
clusters have no egress, so the default *reporter* writes the payload to
``<session_dir>/usage_stats.json``; deployments with connectivity can
install a callable reporter via ``set_reporter`` (the analog of the
reference's usage-stats server endpoint).

Opt out with RAYTPU_USAGE_STATS_ENABLED=0 (reference:
RAY_USAGE_STATS_ENABLED).
"""

from __future__ import annotations

import json
import os
import platform
import sys
import threading
import time
from typing import Any, Callable, Dict, Optional

_reporter: Optional[Callable[[Dict[str, Any]], None]] = None
_thread: Optional[threading.Thread] = None
_stop: Optional[threading.Event] = None
_REPORT_INTERVAL_S = 60.0


def usage_stats_enabled() -> bool:
    return os.environ.get("RAYTPU_USAGE_STATS_ENABLED", "1") not in (
        "0", "false", "False")


def set_reporter(fn: Callable[[Dict[str, Any]], None]) -> None:
    global _reporter
    _reporter = fn


def collect(cw) -> Dict[str, Any]:
    """One usage payload (reference: usage_lib.py:92 cluster metadata +
    library usage)."""
    import ray_tpu_torch

    payload: Dict[str, Any] = {
        "schema_version": 1,
        "timestamp": time.time(),
        "ray_tpu_version": ray_tpu_torch.__version__,
        "python_version": sys.version.split()[0],
        "platform": platform.platform(),
    }
    try:
        payload["total_resources"] = cw.cluster_resources()
        payload["num_nodes"] = len([n for n in cw.nodes()
                                    if n.get("alive", True)])
    except Exception:  # noqa: BLE001 - cluster mid-shutdown
        pass
    if "torch" in sys.modules:
        try:
            torch = sys.modules["torch"]
            payload["torch_version"] = torch.__version__
            payload["cuda_version"] = torch.version.cuda
            # Only name the card if CUDA is ALREADY up in this process:
            # asking earlier would create a CUDA context on the driver
            # as a telemetry side effect, taking memory on a card that
            # the workers own.
            if torch.cuda.is_initialized():
                payload["device_kind"] = torch.cuda.get_device_name(0)
        except Exception:  # noqa: BLE001 - torch internals moved
            pass
    # Which ray_tpu_torch libraries were imported (the reference tracks
    # library_usages the same way).
    libs = []
    for lib in ("train", "tune", "serve", "data", "rllib", "workflow",
                "autoscaler", "job"):
        if f"ray_tpu_torch.{lib}" in sys.modules:
            libs.append(lib)
    payload["library_usages"] = libs
    return payload


def _default_reporter(session_dir: str) -> Callable[[Dict[str, Any]], None]:
    def report(payload: Dict[str, Any]) -> None:
        path = os.path.join(session_dir, "usage_stats.json")
        with open(path + ".tmp", "w") as f:
            json.dump(payload, f, indent=2)
        os.replace(path + ".tmp", path)

    return report


def start_usage_reporter(cw, session_dir: str) -> None:
    """Start the periodic reporter thread (no-op when opted out).
    Re-entrant across shutdown()/init() cycles in one process."""
    global _thread, _stop
    if not usage_stats_enabled():
        return
    stop_usage_reporter()
    # Fresh event per start: a previous thread stuck past the join
    # timeout keeps ITS OWN (set) event and can never resurrect.
    stop = _stop = threading.Event()
    reporter = _reporter or _default_reporter(session_dir)

    def loop():
        while not stop.is_set():
            try:
                reporter(collect(cw))
            except Exception:  # noqa: BLE001 - never disturb the app
                pass
            stop.wait(_REPORT_INTERVAL_S)

    _thread = threading.Thread(target=loop, daemon=True,
                               name="raytpu-usage")
    _thread.start()


def stop_usage_reporter() -> None:
    global _thread
    if _thread is not None:
        if _stop is not None:
            _stop.set()
        _thread.join(timeout=2)
        _thread = None
