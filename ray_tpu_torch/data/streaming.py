"""Streaming block execution with bounded in-flight work.

Reference analog: data/_internal/execution/streaming_executor.py (the
operator/backpressure engine behind Dataset.iter_batches).  Collapsed to
the pieces that matter for this runtime: stages are already fused into
one task per block (dataset.py), so streaming =

- a SUBMISSION window: at most ``max_in_flight`` block tasks alive,
  results yield in input order as they (and their predecessors) finish;
- BYTES backpressure: completed-but-unyielded results are counted
  against a bytes budget derived from the object-store capacity — a
  slow consumer (or head-of-line-blocked index 0) stalls submission
  before the store fills and spill-thrashes (reference:
  backpressure_policy / ReservationOpResourceAllocator);
- optional ACTOR-POOL compute: blocks round-robin over a pool of
  long-lived stage actors instead of stateless tasks, still inside the
  same streamed window (reference: ActorPoolMapOperator).

Peak cluster memory is O(window) blocks instead of O(dataset);
first-batch latency is one block's work instead of the whole
pipeline's.

A copy of ``ray_tpu/data/streaming.py`` on the port's runtime: result
sizes are the stored sizes of the port's objects (the serialized
block, its numpy columns as pickle-5 buffers), read from the owner's
memory store or the shared-memory store without fetching the payload.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Iterator, List, Optional

import ray_tpu_torch


class ExecStats:
    """Wall-clock/throughput/memory record of one execution (reference:
    _internal/stats.py DatasetStats, driver-side portion)."""

    def __init__(self, op: str):
        self.op = op
        self.blocks = 0
        self.wall_s = 0.0
        self.first_block_s: Optional[float] = None
        #: bytes of results that flowed through (where sizes were known)
        self.total_bytes = 0
        #: high-water mark of completed-but-unyielded result bytes
        self.peak_inflight_bytes = 0
        #: times submission stalled on the bytes budget
        self.backpressure_stalls = 0

    def summary(self) -> str:
        first = (f", first block {self.first_block_s:.3f}s"
                 if self.first_block_s is not None else "")
        mem = ""
        if self.total_bytes:
            mem = (f", {self.total_bytes / 1e6:.1f}MB through, "
                   f"peak inflight {self.peak_inflight_bytes / 1e6:.1f}MB"
                   + (f", {self.backpressure_stalls} bp-stalls"
                      if self.backpressure_stalls else ""))
        return (f"{self.op}: {self.blocks} blocks in "
                f"{self.wall_s:.3f}s{first}{mem}")


def _object_nbytes(ref) -> Optional[int]:
    """Size of a completed object (memory-store inline or shm), without
    fetching its payload to python."""
    from ray_tpu_torch._private import worker_context
    from ray_tpu_torch._private.ids import ObjectID

    cw = worker_context.maybe_core_worker()
    if cw is None:
        return None
    oid = ref._info.oid
    try:
        entry = cw.memory_store.get(oid)
        if entry is not None and entry.data is not None:
            return len(entry.data)
        buf = cw.store.get(ObjectID(oid), timeout_ms=0)
        if buf is not None:
            with buf:
                return len(buf.data) + len(buf.metadata)
    except Exception:  # noqa: BLE001 - size probe must never break exec
        return None
    return None


def _default_bytes_budget() -> int:
    """~1/4 of the object store: streaming results may occupy at most
    this much before the consumer must drain."""
    from ray_tpu_torch._private import worker_context

    cw = worker_context.maybe_core_worker()
    try:
        cap = cw.store.stats().get("capacity", 0) if cw else 0
    except Exception:  # noqa: BLE001
        cap = 0
    return int(cap * 0.25) if cap else 256 * 1024 * 1024


class StreamingExecutor:
    def __init__(self, max_in_flight: int = 0, max_bytes: int = 0):
        if max_in_flight <= 0:
            cpus = ray_tpu_torch.cluster_resources().get("CPU", 2)
            max_in_flight = max(2, int(cpus) * 2)
        self.max_in_flight = max_in_flight
        self.max_bytes = max_bytes or _default_bytes_budget()

    def execute(self, block_refs: List, stages: List,
                stats: Optional[ExecStats] = None,
                pool: Optional[List] = None,
                stages_ser: Optional[bytes] = None) -> Iterator:
        """Yield one result ref per input block, in input order, with at
        most ``max_in_flight`` stage tasks alive at once and at most
        ``max_bytes`` of completed results waiting to be consumed.
        ``pool``: stage actors (with .run(block, stages_ser)) — blocks
        round-robin over them instead of spawning stateless tasks."""
        from ray_tpu_torch.data.dataset import _run_stages

        t0 = time.perf_counter()
        n = len(block_refs)
        inflight: Dict[Any, int] = {}
        done: Dict[int, Any] = {}
        done_bytes: Dict[int, int] = {}
        inflight_bytes = 0
        completed_total = 0
        completed_count = 0
        submitted = 0
        yielded = 0

        def _est_result_bytes(idx: int) -> int:
            # running tasks' eventual output counts against the budget
            # too: estimate by the running average of completed results,
            # falling back to the input block's size before any finish
            if completed_count:
                return completed_total // completed_count
            return _object_nbytes(block_refs[idx]) or 0

        while yielded < n:
            # window counts submitted-but-UNYIELDED blocks (running +
            # completed-waiting), not just running tasks: under
            # head-of-line blocking (block 0 slow, 1..N fast) counting
            # only running tasks would submit — and materialize — the
            # whole dataset while waiting to yield index 0
            while submitted < n and \
                    submitted - yielded < self.max_in_flight:
                est = inflight_bytes + sum(
                    _est_result_bytes(i) for i in inflight.values())
                if inflight and est >= self.max_bytes:
                    # budget spoken for (completed results waiting +
                    # running tasks' expected output); wait for the
                    # consumer instead of submitting more
                    if stats is not None:
                        stats.backpressure_stalls += 1
                    break
                if pool is not None:
                    ref = pool[submitted % len(pool)].run.remote(
                        block_refs[submitted], stages_ser)
                else:
                    ref = _run_stages.remote(block_refs[submitted],
                                             stages)
                inflight[ref] = submitted
                submitted += 1
            while yielded in done:
                if stats is not None:
                    stats.blocks += 1
                    if stats.first_block_s is None:
                        stats.first_block_s = time.perf_counter() - t0
                    stats.wall_s = time.perf_counter() - t0
                inflight_bytes -= done_bytes.pop(yielded, 0)
                yield done.pop(yielded)
                yielded += 1
            if yielded >= n:
                break
            if not inflight:
                continue
            ready, _ = ray_tpu_torch.wait(list(inflight), num_returns=1,
                                    timeout=600.0)
            for r in ready:
                idx = inflight.pop(r)
                done[idx] = r
                nbytes = _object_nbytes(r) or 0
                done_bytes[idx] = nbytes
                inflight_bytes += nbytes
                completed_total += nbytes
                completed_count += 1
                if stats is not None:
                    stats.total_bytes += nbytes
                    stats.peak_inflight_bytes = max(
                        stats.peak_inflight_bytes, inflight_bytes)
