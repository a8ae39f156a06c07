"""Application-defined metrics: Counter / Gauge / Histogram.

A copy of ``ray_tpu/util/metrics.py`` (role-equivalent of the
reference's custom-metrics API, ``python/ray/util/metrics.py``, and its
per-node Prometheus agent, ``_private/metrics_agent.py:93``): each
process keeps a local registry (``_registry``) and a background
publisher thread flushes its snapshot into the GCS KV
(``metrics:<worker_id>``) every ``_PUBLISH_INTERVAL_S``, encoded by the
vendored msgpack; ``collect_cluster_metrics`` merges every live
snapshot into one Prometheus text page.  Neither imports torch.
"""

from __future__ import annotations

import re
import threading
import time
import warnings
from typing import Dict, List, Optional, Sequence, Tuple

_KV_PREFIX = "metrics:"
_PUBLISH_INTERVAL_S = 5.0

#: Prometheus-safe metric names
_NAME_RE = re.compile(r"^[a-z][a-z0-9_]*$")


class _Registry:
    def __init__(self):
        self.metrics: Dict[str, "Metric"] = {}
        self._lock = threading.Lock()
        self._publisher: Optional[threading.Thread] = None
        self._dup_warned: set = set()

    def register(self, metric: "Metric") -> None:
        with self._lock:
            old = self.metrics.get(metric.name)
            if (old is not None and old is not metric
                    and metric.name not in self._dup_warned):
                # warn ONCE per name instead of silently overwriting:
                # two live instances under one name means one of them
                # publishes and the other's observations vanish
                self._dup_warned.add(metric.name)
                warnings.warn(
                    f"metric {metric.name!r} registered more than once "
                    f"in this process; the newest instance replaces the "
                    f"previous one in the registry (share one instance "
                    f"instead)", RuntimeWarning, stacklevel=4)
            self.metrics[metric.name] = metric
        self._ensure_publisher()

    def _ensure_publisher(self) -> None:
        with self._lock:
            if self._publisher is not None:
                return
            self._publisher = threading.Thread(
                target=self._publish_loop, daemon=True,
                name="raytpu-metrics")
            self._publisher.start()

    def snapshot(self) -> dict:
        with self._lock:
            return {name: m._dump() for name, m in self.metrics.items()}

    def _publish_loop(self) -> None:
        from ray_tpu_torch._private import worker_context
        from ray_tpu_torch._private._vendor import msgpack

        while True:
            time.sleep(_PUBLISH_INTERVAL_S)
            cw = worker_context.maybe_core_worker()
            if cw is None:
                continue
            try:
                cw.kv_put(
                    _KV_PREFIX + cw.worker_id.hex(),
                    msgpack.packb({"ts": time.time(),
                                   "metrics": self.snapshot()}))
            except Exception:  # noqa: BLE001 - shutdown race
                pass


_registry = _Registry()


class Metric:
    """Base: name, help text, tag keys; values tracked per tag-tuple."""

    kind = "gauge"

    def __init__(self, name: str, description: str = "",
                 tag_keys: Sequence[str] = ()):
        if not _NAME_RE.match(name):
            raise ValueError(
                f"invalid metric name {name!r}: must match "
                f"^[a-z][a-z0-9_]*$ (Prometheus-exportable)")
        self.name = name
        self.description = description
        self.tag_keys = tuple(tag_keys)
        self._default_tags: Dict[str, str] = {}
        self._values: Dict[Tuple, float] = {}
        self._lock = threading.Lock()
        _registry.register(self)

    def set_default_tags(self, tags: Dict[str, str]) -> "Metric":
        self._default_tags = dict(tags)
        return self

    def _key(self, tags: Optional[Dict[str, str]]) -> Tuple:
        merged = dict(self._default_tags)
        if tags:
            merged.update(tags)
        return tuple(sorted(merged.items()))

    def _dump(self) -> dict:
        with self._lock:
            return {"kind": self.kind, "desc": self.description,
                    "values": [(list(k), v)
                               for k, v in self._values.items()]}


class Counter(Metric):
    kind = "counter"

    def inc(self, value: float = 1.0,
            tags: Optional[Dict[str, str]] = None) -> None:
        if value < 0:
            raise ValueError("counters only increase")
        k = self._key(tags)
        with self._lock:
            self._values[k] = self._values.get(k, 0.0) + value


class Gauge(Metric):
    kind = "gauge"

    def set(self, value: float,
            tags: Optional[Dict[str, str]] = None) -> None:
        with self._lock:
            self._values[self._key(tags)] = float(value)


class Histogram(Metric):
    """Fixed-boundary histogram (values stored as per-bucket counters +
    sum/count, Prometheus-style)."""

    kind = "histogram"

    def __init__(self, name: str, description: str = "",
                 boundaries: Sequence[float] = (), tag_keys: Sequence[str] = ()):
        if not boundaries:
            raise ValueError("histogram needs bucket boundaries")
        self.boundaries = sorted(float(b) for b in boundaries)
        super().__init__(name, description, tag_keys)

    def observe(self, value: float,
                tags: Optional[Dict[str, str]] = None) -> None:
        base = self._key(tags)
        with self._lock:
            # Prometheus histograms are CUMULATIVE: an observation
            # increments every bucket whose bound >= value, plus +Inf.
            for b in self.boundaries:
                if value <= b:
                    k = base + (("le", str(b)),)
                    self._values[k] = self._values.get(k, 0.0) + 1
            k = base + (("le", "+Inf"),)
            self._values[k] = self._values.get(k, 0.0) + 1
            s = base + (("_stat", "sum"),)
            c = base + (("_stat", "count"),)
            self._values[s] = self._values.get(s, 0.0) + value
            self._values[c] = self._values.get(c, 0.0) + 1

    def _dump(self) -> dict:
        # Emit EVERY configured boundary (zero-filled) plus +Inf and
        # sum/count per tag-set: observe() only touches buckets whose
        # bound >= value, so a raw dump omits the low zero-count
        # buckets and Prometheus histogram_quantile then works on an
        # incomplete cumulative series.  A never-observed histogram
        # still emits one all-zero series under its default tags so the
        # full bucket layout is visible from registration time.
        with self._lock:
            bases = {tuple(t for t in k
                           if t[0] not in ("le", "_stat"))
                     for k in self._values}
            if not bases:
                bases = {self._key(None)}
            values = []
            for base in sorted(bases):
                for b in self.boundaries:
                    k = base + (("le", str(b)),)
                    values.append((list(k), self._values.get(k, 0.0)))
                for suffix in (("le", "+Inf"), ("_stat", "sum"),
                               ("_stat", "count")):
                    k = base + (suffix,)
                    values.append((list(k), self._values.get(k, 0.0)))
            return {"kind": self.kind, "desc": self.description,
                    "boundaries": list(self.boundaries),
                    "values": values}



def collect_cluster_metrics(kv_get, kv_keys, max_age_s: float = 60.0
                            ) -> List[str]:
    """Merge every process's published snapshot into Prometheus text
    lines (what the JAX package's dashboard serves at /metrics)."""
    from ray_tpu_torch._private._vendor import msgpack

    lines: List[str] = []
    seen_help: set = set()
    now = time.time()
    for key in kv_keys(_KV_PREFIX):
        raw = kv_get(key)
        if not raw:
            continue
        try:
            snap = msgpack.unpackb(raw, raw=False)
        except Exception:  # noqa: BLE001
            continue
        if now - snap.get("ts", 0) > max_age_s:
            continue
        wid = key[len(_KV_PREFIX):][:12]
        for name, m in snap.get("metrics", {}).items():
            full = f"raytpu_app_{name}"
            kind = m["kind"]
            if full not in seen_help:
                seen_help.add(full)
                ptype = {"counter": "counter",
                         "histogram": "histogram"}.get(kind, "gauge")
                lines.append(f"# HELP {full} {m.get('desc', '')}")
                lines.append(f"# TYPE {full} {ptype}")
            for tag_list, value in m.get("values", []):
                tags = dict(tag_list)
                stat = tags.pop("_stat", None)
                series = full
                if kind == "histogram":
                    # Prometheus exposition: <name>_bucket{le=...},
                    # <name>_sum, <name>_count.
                    if stat == "sum":
                        series = full + "_sum"
                    elif stat == "count":
                        series = full + "_count"
                    elif "le" in tags:
                        series = full + "_bucket"
                label_str = ",".join(
                    [f'worker="{wid}"'] +
                    [f'{k}="{v}"' for k, v in sorted(tags.items())])
                lines.append(f"{series}{{{label_str}}} {value}")
    return lines
