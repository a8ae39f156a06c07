"""Typed runtime configuration flags.

Equivalent in role to the reference's ``RAY_CONFIG(type, name, default)``
registry (reference ``src/ray/common/ray_config_def.h``): a single place
declaring every tunable, each overridable via environment variable
``RAYTPU_<NAME>`` or via ``init(_system_config={...})``.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field, fields
from typing import Any, Dict

_ENV_PREFIX = "RAYTPU_"


def _coerce(value: str, typ) -> Any:
    if typ is bool:
        return value.lower() in ("1", "true", "yes", "on")
    if typ is int:
        return int(value)
    if typ is float:
        return float(value)
    return value


@dataclass
class Config:
    # --- object store ---
    #: Size of the per-node shared-memory object store arena, bytes.
    object_store_memory: int = 2 * 1024**3
    #: Objects at or under this size are passed inline in RPCs instead of
    #: going through the shared-memory store (reference analog:
    #: max_direct_call_object_size = 100 KiB).
    max_inline_object_size: int = 100 * 1024
    #: Directory for spilled objects (filesystem spill backend); empty =
    #: <session_dir>/spill on each node.
    spill_dir: str = ""
    #: Fraction of the arena above which eviction/spill kicks in.
    object_store_full_fraction: float = 0.95
    #: get() serves numpy arrays as zero-copy views pinned in the arena
    #: (reference: plasma-backed numpy views); the pin is released when
    #: the arrays are garbage-collected.  Off = always copy out.
    zero_copy_get: bool = True
    #: How long a create() queues against a full arena (spilling in the
    #: background) before giving up (reference: plasma CreateRequestQueue).
    create_retry_timeout_s: float = 30.0

    # --- scheduling ---
    #: Number of workers kept warm per node (defaults to num CPUs).
    num_workers: int = 0
    #: Seconds a leased-but-idle worker is kept before being returned.
    idle_worker_keep_s: float = 300.0
    #: Hybrid scheduling threshold: prefer the local node until its critical
    #: resource utilization crosses this fraction, then spread (reference
    #: analog: scheduler_spread_threshold).
    scheduler_spread_threshold: float = 0.5
    #: Max times a task is retried on worker/node failure.
    default_max_retries: int = 3
    #: How long a cluster-wide-infeasible lease keeps retrying spillback
    #: picks (covers autoscaler node-launch latency) before failing.
    infeasible_lease_grace_s: float = 20.0
    #: Pipelining cap on in-flight lease REQUESTS per scheduling key
    #: (reference: max_pending_lease_requests_per_scheduling_category).
    #: Without it a 100k-task burst issues 100k lease requests whose
    #: granted-then-returned churn floods every event loop involved.
    max_pending_lease_requests: int = 16

    #: GCS fault-tolerance snapshot file (empty = in-memory only; the
    #: reference's Redis-backed store, redis_store_client.h:28).
    gcs_persist_path: str = ""

    # --- OOM defense (reference: src/ray/common/memory_monitor.h:48 +
    # raylet/worker_killing_policy.h:30,58 retriable-LIFO policy) ---
    #: Node memory usage fraction above which the worker killer engages.
    #: 0 disables the monitor.
    memory_usage_threshold: float = 0.95
    #: Memory monitor poll interval, seconds (reference:
    #: memory_monitor_refresh_ms = 250).
    memory_monitor_interval_s: float = 0.25
    #: Test hook: when set, the monitor reads the usage fraction from this
    #: file instead of /proc/meminfo (the reference fakes usage in
    #: worker_killing_policy tests the same way).
    memory_monitor_fake_usage_path: str = ""

    #: Debounce for event-driven resource pushes to the GCS (reference:
    #: RaySyncer push-on-change; heartbeats remain the polling fallback).
    resource_report_debounce_s: float = 0.05

    # --- timeouts / liveness ---
    heartbeat_interval_s: float = 1.0
    num_heartbeats_timeout: int = 30
    rpc_connect_timeout_s: float = 10.0
    worker_start_timeout_s: float = 60.0
    #: Bound on concurrently-starting worker processes per node.  A
    #: thousand-actor gang otherwise forks every worker at once and the
    #: children starve each other through interpreter startup (imports
    #: are CPU-bound), tripping registration timeouts (reference:
    #: worker_pool maximum_startup_concurrency, worker_pool.cc:224).
    #: 0 = auto: max(2, 2 x cores) — interpreter boot is CPU-bound, so
    #: wider than the core count only inflates per-spawn latency.
    max_concurrent_worker_starts: int = 0
    #: Poll interval for blocking get() in the driver.
    get_poll_interval_s: float = 0.005
    # How often get()/wait() re-issue a pull for a borrowed object (the
    # first pull can race production at the owner).
    pull_retry_interval_s: float = 0.25

    # --- ownership / recovery ---
    #: Seconds an owner-promised-in-store object may be missing from the
    #: shared store before it is declared evicted (and reconstruction or
    #: ObjectLostError kicks in).
    object_miss_grace_s: float = 2.0
    #: Re-execute lost task returns from their task spec (reference analog:
    #: lineage_pinning_enabled, object_recovery_manager.h:41).
    lineage_enabled: bool = True
    #: Max reconstruction attempts per lost object.
    max_lineage_reexecutions: int = 3
    #: Byte budget for retained task specs; oldest lineage is evicted past
    #: this (reference analog: max_lineage_bytes).
    max_lineage_bytes: int = 64 * 1024 * 1024

    # --- object transfer ---
    #: Chunk size for node-to-node object streaming (reference analog:
    #: object_manager chunked push/pull, push_manager.h:29).
    object_transfer_chunk_bytes: int = 4 * 1024 * 1024
    #: Bound on concurrently in-flight chunks per transfer (admission
    #: control, pull_manager.h:48).
    object_transfer_max_inflight_chunks: int = 8

    # --- logging / observability ---
    log_dir: str = ""
    log_to_driver: bool = True
    event_buffer_size: int = 10000
    #: Record per-task profile events for the timeline.
    enable_timeline: bool = True

    # --- gpu ---
    #: Treat each CUDA card as one unit of the "GPU" resource.
    gpus_per_host: int = 0  # 0 = autodetect
    #: Bound on the card-count probe (torch's import must never hang
    #: node bring-up).
    gpu_detect_timeout_s: float = 60.0

    extras: Dict[str, Any] = field(default_factory=dict)

    def apply_env(self) -> "Config":
        for f in fields(self):
            env = os.environ.get(_ENV_PREFIX + f.name.upper())
            if env is not None:
                setattr(self, f.name, _coerce(env, f.type if isinstance(f.type, type) else type(getattr(self, f.name))))
        return self

    def apply_dict(self, overrides: Dict[str, Any]) -> "Config":
        known = {f.name for f in fields(self)}
        for k, v in (overrides or {}).items():
            if k in known:
                setattr(self, k, v)
            else:
                self.extras[k] = v
        return self

    def to_json(self) -> str:
        d = {f.name: getattr(self, f.name) for f in fields(self) if f.name != "extras"}
        d.update(self.extras)
        return json.dumps(d)

    @classmethod
    def from_json(cls, s: str) -> "Config":
        return cls().apply_dict(json.loads(s))


_global_config: Config | None = None


def global_config() -> Config:
    global _global_config
    if _global_config is None:
        _global_config = Config().apply_env()
    return _global_config


def set_global_config(cfg: Config) -> None:
    global _global_config
    _global_config = cfg
