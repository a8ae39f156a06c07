"""Structured event export: machine-readable cluster events.

Reference analog: ``src/ray/util/event.h:41`` (RAY_EVENT macro →
per-source ``event_*.log`` JSON-lines files consumed by the dashboard's
event module).  Collapsed to one thread-safe appender: components call
``report_event`` at state transitions (node death, actor restart, job
failure, OOM kill, spill); each event lands as one JSON line in
``<session>/events/event_<source>.log`` and the dashboard serves the
merged tail at ``/api/events``.
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
import time
from typing import Any, Dict, List, Optional

SEVERITIES = ("DEBUG", "INFO", "WARNING", "ERROR", "FATAL")

#: rotate event_<source>.log past this size (previous generation -> .1)
_MAX_FILE_BYTES = 4 * 1024 * 1024

_lock = threading.Lock()
_files: Dict[str, Any] = {}
_dir: Optional[str] = None


def _event_dir() -> str:
    global _dir
    if _dir is None:
        base = os.environ.get("RAYTPU_SESSION_DIR") or os.path.join(
            tempfile.gettempdir(), "raytpu_torch")
        _dir = os.path.join(base, "events")
        os.makedirs(_dir, exist_ok=True)
    return _dir


def report_event(source: str, label: str, message: str, *,
                 severity: str = "INFO", **fields: Any) -> None:
    """Append one structured event.  Never raises (an unreportable event
    must not take down the component reporting it)."""
    if severity not in SEVERITIES:
        severity = "INFO"
    rec = {"timestamp": time.time(), "severity": severity,
           "source": source, "label": label, "message": message,
           "pid": os.getpid()}
    if fields:
        rec["custom_fields"] = fields
    try:
        with _lock:
            f = _files.get(source)
            if f is None or f.closed:
                f = open(os.path.join(_event_dir(),
                                      f"event_{source}.log"), "a")
                _files[source] = f
            f.write(json.dumps(rec) + "\n")
            f.flush()
            # single-generation rotation: a chaotic long-lived cluster
            # must not grow (and make /api/events re-parse) an unbounded
            # file; the previous generation stays readable as .1
            if f.tell() > _MAX_FILE_BYTES:
                f.close()
                path = os.path.join(_event_dir(), f"event_{source}.log")
                os.replace(path, path + ".1")
                _files[source] = open(path, "a")
    except Exception:  # noqa: BLE001 - never fail the caller
        pass


def read_events(limit: int = 200, *,
                severity: Optional[str] = None,
                source: Optional[str] = None) -> List[Dict[str, Any]]:
    """Merged, time-ordered tail of every source's event file."""
    out: List[Dict[str, Any]] = []
    d = _event_dir()
    try:
        names = sorted(
            n for n in os.listdir(d)
            if n.startswith("event_") and (n.endswith(".log")
                                           or n.endswith(".log.1")))
    except OSError:
        return []
    for name in names:
        src = name[len("event_"):].split(".log")[0]
        if source and src != source:
            continue
        try:
            with open(os.path.join(d, name)) as f:
                lines = f.readlines()
        except OSError:
            continue
        matched = []
        # filter BEFORE tailing: old matching events must not be pushed
        # out of the window by newer non-matching ones
        for line in lines:
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if severity and rec.get("severity") != severity:
                continue
            matched.append(rec)
        out.extend(matched[-limit:])
    out.sort(key=lambda r: r.get("timestamp", 0.0))
    return out[-limit:]


def reset_for_tests() -> None:
    global _dir
    with _lock:
        for f in _files.values():
            try:
                f.close()
            except Exception:  # noqa: BLE001
                pass
        _files.clear()
        _dir = None
