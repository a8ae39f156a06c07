"""Spans for task/actor calls, with cross-process context propagation.

A copy of ``ray_tpu/util/tracing.py`` (itself the role-equivalent of
the reference's ``python/ray/util/tracing/tracing_helper.py``: spans
wrap task submission/execution and the trace context rides the task
metadata).  Opt-in per process via ``enable_tracing()``; the serve
engine's telemetry records its request spans through ``record_span``.

Backends, best available first:
* opentelemetry-sdk installed → real OTel spans through any SpanExporter
  (default: in-memory, readable via recorded_spans());
* only opentelemetry-api (or nothing) → a minimal built-in recorder with
  the same surface: spans still link across processes through the
  ``trace_ctx`` carrier on the task spec.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
import uuid
from typing import Any, Dict, List, Optional

_enabled = False
_mode = ""  # "otel" | "fallback"
_memory_spans: Optional[Any] = None


@dataclasses.dataclass
class SpanRecord:
    """Fallback span (surface-compatible with the bits tests read).

    ``start`` is on the process monotonic clock (``time.perf_counter``)
    — the same domain as telemetry, flightrec, and the device
    observatory — so fallback spans can render into a shared timeline.
    ``duration`` is 0.0 for point spans recorded without an end."""

    name: str
    trace_id: str
    span_id: str
    parent_id: Optional[str]
    start: float = 0.0
    duration: float = 0.0


_fallback_spans: List[SpanRecord] = []
_fallback_lock = threading.Lock()


def _try_otel_sdk():
    try:
        from opentelemetry import propagate, trace
        from opentelemetry.sdk.trace import TracerProvider
        from opentelemetry.sdk.trace.export import SimpleSpanProcessor

        return trace, propagate, TracerProvider, SimpleSpanProcessor
    except ImportError:
        return None, None, None, None


def enable_tracing(exporter: Optional[Any] = None) -> bool:
    """Turn on span recording in this process."""
    global _enabled, _mode, _memory_spans
    if _enabled:
        return True
    trace, _prop, TracerProvider, SimpleSpanProcessor = _try_otel_sdk()
    if trace is not None:
        provider = trace.get_tracer_provider()
        if not isinstance(provider, TracerProvider):
            provider = TracerProvider()
            trace.set_tracer_provider(provider)
        if exporter is None:
            from opentelemetry.sdk.trace.export.in_memory_span_exporter \
                import InMemorySpanExporter

            _memory_spans = InMemorySpanExporter()
            exporter = _memory_spans
        provider.add_span_processor(SimpleSpanProcessor(exporter))
        _mode = "otel"
    else:
        _mode = "fallback"
    _enabled = True
    return True


def is_enabled() -> bool:
    return _enabled


def reset_tracing() -> None:
    """Clear all tracing state in this process: the fallback span list,
    the in-memory OTel exporter, and the enabled flag/mode — so tests
    sharing one process don't leak spans or the enabled bit into each
    other (test fixtures call this after every test).

    OTel caveat: the global TracerProvider can't drop an added
    SpanProcessor, so after a reset a re-enable under the otel backend
    attaches a fresh in-memory exporter and the stale processor keeps
    exporting into the cleared (now unreferenced) one — harmless."""
    global _enabled, _mode, _memory_spans
    with _fallback_lock:
        _fallback_spans.clear()
    if _memory_spans is not None:
        try:
            _memory_spans.clear()
        except Exception:  # noqa: BLE001 - exporter already shut down
            pass
    _memory_spans = None
    _enabled = False
    _mode = ""


def record_span(name: str, trace_id: Optional[str] = None,
                parent_id: Optional[str] = None,
                start: Optional[float] = None,
                duration: float = 0.0):
    """Record one standalone span event and return its identity as a
    ``(trace_id, span_id)`` pair (None when tracing is off).  The serve
    engine telemetry uses this to link a request's root span to the
    engine-side work span: pass the returned pair back as
    ``trace_id``/``parent_id`` to record a child.  ``start``/``duration``
    (monotonic seconds) stamp the fallback record so it can render into
    a timeline; under the OTel backend the span carries its own clock
    and the hints are ignored."""
    if not _enabled:
        return None
    if _mode == "otel":
        from opentelemetry import trace

        tracer = trace.get_tracer("ray_tpu_torch")
        with tracer.start_as_current_span(name) as span:
            ctx = span.get_span_context()
        return (format(ctx.trace_id, "032x"),
                format(ctx.span_id, "016x"))
    tid = trace_id or uuid.uuid4().hex
    return (tid, _record(name, tid, parent_id,
                         start=start, duration=duration))


def recorded_spans() -> List[Any]:
    if _mode == "otel" and _memory_spans is not None:
        return list(_memory_spans.get_finished_spans())
    with _fallback_lock:
        return list(_fallback_spans)


def _record(name: str, trace_id: str, parent_id: Optional[str],
            start: Optional[float] = None,
            duration: float = 0.0) -> str:
    span_id = uuid.uuid4().hex[:16]
    if start is None:
        start = time.perf_counter()
    with _fallback_lock:
        _fallback_spans.append(
            SpanRecord(name, trace_id, span_id, parent_id,
                       start, duration))
        if len(_fallback_spans) > 10_000:
            del _fallback_spans[:5_000]
    return span_id


def maybe_inject(kind: str, name: str) -> Optional[Dict[str, str]]:
    """Submitter side: open a submission span and return the carrier to
    ride the task spec (None when tracing is off)."""
    if not _enabled:
        return None
    label = f"{kind} {name}.remote()"
    if _mode == "otel":
        from opentelemetry import propagate, trace

        tracer = trace.get_tracer("ray_tpu_torch")
        with tracer.start_as_current_span(label):
            carrier: Dict[str, str] = {}
            propagate.inject(carrier)
        return carrier or None
    trace_id = uuid.uuid4().hex
    span_id = _record(label, trace_id, None)
    return {"raytpu-trace": f"{trace_id}:{span_id}"}


@contextlib.contextmanager
def task_span(name: str, carrier: Optional[Dict[str, str]]):
    """Executor side: child span around user code, parented by the
    submitter's context from the spec.  Workers lazily enable tracing on
    the first traced task they see."""
    if not carrier:
        yield
        return
    if not _enabled:
        enable_tracing()
    label = f"execute {name}"
    if _mode == "otel" and "raytpu-trace" not in carrier:
        from opentelemetry import propagate, trace

        ctx = propagate.extract(carrier)
        tracer = trace.get_tracer("ray_tpu_torch")
        with tracer.start_as_current_span(label, context=ctx):
            yield
        return
    ref = carrier.get("raytpu-trace", ":")
    trace_id, parent = (ref.split(":") + [""])[:2]
    _record(label, trace_id or uuid.uuid4().hex, parent or None)
    yield
