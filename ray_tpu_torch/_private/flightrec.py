"""Flight recorder: an always-on ring journal of engine decisions.

A copy of ``ray_tpu/_private/flightrec.py``, with its env knobs.

``engine_stats()`` percentiles answer "how bad was p95 TTFT?"; they
cannot answer "what was the engine DOING when it blew up?".  The
flight recorder keeps the last few thousand structured decision events
— admissions and sheds with their reason, slot admits/frees, pager
block reserves/evictions/COW forks, spec propose/accept rounds,
program compiles and recompile-storm trips, step durations — in a
bounded in-memory ring, cheap enough to leave on in production:

* the hot path is ONE ``deque.append`` of a small tuple (GIL-atomic,
  maxlen-bounded — no lock, no allocation beyond the tuple/dict);
* readers (``snapshot``/``dump``) copy the deque without stopping
  writers; a torn read costs at most one event, never a crash;
* saturation is drop-counted, not blocking: the monotonically
  increasing per-event ``seq`` tells exactly how many events the ring
  has already forgotten.

``dump()`` writes the whole ring plus context as a postmortem JSON
file — the SLO watchdog (serve/slo.py) calls it on burn-rate breaches
and recompile storms, and the engine loop calls it on a crash.  The
dump's format is the JAX package's, so ``python -m
ray_tpu.tools.flightrec`` reads it offline.

Clock discipline: all event timestamps are ``time.perf_counter()``
(same monotonic domain as serve/telemetry.py, so journal events and
telemetry records correlate directly); the only human-readable
wall-time is the ``strftime`` stamp on a dump header.

Env knobs: ``RAYTPU_FLIGHTREC=0`` disables recording process-wide
(record() becomes a cheap early return); ``RAYTPU_FLIGHTREC_DIR``
overrides where postmortem dumps land (default: a ``raytpu_flightrec``
folder under the system temp dir).
"""

from __future__ import annotations

import collections
import json
import os
import tempfile
import threading
import time
from typing import Any, Dict, List, Optional

__all__ = ["FlightRecorder", "default_dump_dir"]

#: ring capacity (events) when the owner doesn't choose one
DEFAULT_CAPACITY = 4096

#: schema version stamped into every dump file
DUMP_VERSION = 1


def default_dump_dir() -> str:
    env = os.environ.get("RAYTPU_FLIGHTREC_DIR")
    if env:
        return env
    return os.path.join(tempfile.gettempdir(), "raytpu_flightrec")


def _enabled() -> bool:
    return os.environ.get("RAYTPU_FLIGHTREC", "1").lower() \
        not in ("0", "false", "off")


class FlightRecorder:
    """One engine's bounded event journal.

    ``record(kind, **fields)`` is the only hot-path entry point; every
    other method is a cold reader.  Events are ``(seq, ts_s, kind,
    fields)`` tuples with ``ts_s`` from ``time.perf_counter()`` —
    relative timestamps (``ts_s - t0``) are what ``snapshot``/``dump``
    expose, matching the engine-timeline convention that trace origins
    are arbitrary."""

    def __init__(self, source: str, capacity: int = DEFAULT_CAPACITY,
                 enabled: Optional[bool] = None):
        self.source = source
        self.capacity = int(capacity)
        self.enabled = _enabled() if enabled is None else bool(enabled)
        self.t0 = time.perf_counter()
        self.dump_dir: Optional[str] = None   # SLOTracker may override
        self.dumps: List[str] = []
        self._events: "collections.deque" = collections.deque(
            maxlen=self.capacity)
        self._n = 0                 # events ever recorded (see note)
        self._dump_lock = threading.Lock()

    # -- hot path ------------------------------------------------------

    def record(self, kind: str, ts: Optional[float] = None,
               **fields: Any) -> None:
        """Append one event.  `ts` is an injectable perf_counter
        timestamp for deterministic tests; production callers omit it.

        Cost: one int increment + one bounded deque append — both
        GIL-atomic, so concurrent writers never need a lock.  The
        counter increment is a benign read-modify-write race across
        threads (the engine loop owns virtually all traffic); a lost
        increment skews the drop COUNT by one, never the events."""
        if not self.enabled:
            return
        self._n += 1
        self._events.append(
            (self._n, time.perf_counter() if ts is None else ts,
             kind, fields))

    # -- cold readers --------------------------------------------------

    @property
    def recorded(self) -> int:
        """Events ever offered to the ring."""
        return self._n

    @property
    def retained(self) -> int:
        return len(self._events)

    @property
    def dropped(self) -> int:
        """Events the ring has already forgotten (saturation)."""
        return max(0, self._n - len(self._events))

    def snapshot(self) -> List[Dict[str, Any]]:
        """The retained events as dicts, oldest first, timestamps
        rebased to seconds since recorder start."""
        return [dict(fields, seq=seq, t_s=round(ts - self.t0, 6),
                     kind=kind)
                for seq, ts, kind, fields in list(self._events)]

    def counts_by_kind(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for _seq, _ts, kind, _f in list(self._events):
            out[kind] = out.get(kind, 0) + 1
        return dict(sorted(out.items()))

    def stats(self) -> Dict[str, Any]:
        """The ``engine_stats()["flightrec"]`` block."""
        return {"enabled": self.enabled, "capacity": self.capacity,
                "recorded": self.recorded, "retained": self.retained,
                "dropped": self.dropped, "dumps": list(self.dumps)}

    # -- postmortem dump ----------------------------------------------

    def dump(self, path: Optional[str] = None, *, reason: str = "",
             context: Optional[Dict[str, Any]] = None) -> Optional[str]:
        """Write the whole ring (plus `context`) as one postmortem
        JSON file and return its path (None when recording is off).

        Default location: ``{dump_dir}/flightrec_{source}_{reason}_
        {stamp}_{pid}_{n}.json`` — pid + per-recorder counter keep
        concurrent engines from colliding on the same second."""
        if not self.enabled:
            return None
        with self._dump_lock:
            if path is None:
                dump_dir = self.dump_dir or default_dump_dir()
                os.makedirs(dump_dir, exist_ok=True)
                stamp = time.strftime("%Y%m%dT%H%M%S")
                safe = "".join(c if c.isalnum() or c in "-_" else "_"
                               for c in f"{self.source}_{reason}")
                path = os.path.join(
                    dump_dir,
                    f"flightrec_{safe}_{stamp}_{os.getpid()}_"
                    f"{len(self.dumps)}.json")
            doc = {
                "version": DUMP_VERSION,
                "source": self.source,
                "reason": reason,
                "created": time.strftime("%Y-%m-%dT%H:%M:%S"),
                "uptime_s": round(time.perf_counter() - self.t0, 3),
                "events_recorded": self.recorded,
                "events_retained": self.retained,
                "events_dropped": self.dropped,
                "counts_by_kind": self.counts_by_kind(),
                "context": context or {},
                "events": self.snapshot(),
            }
            with open(path, "w") as f:
                json.dump(doc, f)
            self.dumps.append(path)
            return path
