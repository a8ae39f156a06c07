"""Core micro-benchmarks: latency/throughput of the hot runtime ops.

Role-equivalent of the reference's microbenchmark harness (reference
``python/ray/_private/ray_perf.py:93 main`` — task submit/get, actor
calls, put/get, batched variants — run per release via
``release/microbenchmark/run_microbenchmark.py``).  Prints one JSON
line per op so the release harness can diff against thresholds.
"""

from __future__ import annotations

import json
import time
from typing import Callable, Dict, List

import numpy as np


def _rate(fn: Callable[[], None], n: int, warmup: int = 1) -> float:
    for _ in range(warmup):
        fn()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    return n / (time.perf_counter() - t0)


def main(trials_scale: float = 1.0) -> List[Dict]:
    import ray_tpu_torch

    ray_tpu_torch._auto_init()
    results: List[Dict] = []

    def record(name: str, value: float, unit: str):
        entry = {"benchmark": name, "value": round(value, 2),
                 "unit": unit}
        results.append(entry)
        print(json.dumps(entry), flush=True)

    n = lambda base: max(1, int(base * trials_scale))  # noqa: E731

    # -- put/get small -----------------------------------------------------
    record("put_small", _rate(lambda: ray_tpu_torch.put(b"x" * 100), n(500)),
           "puts/s")
    small_ref = ray_tpu_torch.put(b"y" * 100)
    record("get_small", _rate(lambda: ray_tpu_torch.get(small_ref), n(500)),
           "gets/s")

    # -- put/get 10MB ------------------------------------------------------
    big = np.ones(10 * 1024 * 1024 // 8)
    t0 = time.perf_counter()
    refs = [ray_tpu_torch.put(big) for _ in range(n(20))]
    dt = time.perf_counter() - t0
    record("put_10MB_gbps", len(refs) * big.nbytes / dt / 1e9, "GB/s")
    t0 = time.perf_counter()
    for r in refs:
        ray_tpu_torch.get(r)
    dt = time.perf_counter() - t0
    record("get_10MB_gbps", len(refs) * big.nbytes / dt / 1e9, "GB/s")
    del refs

    # -- tasks -------------------------------------------------------------
    @ray_tpu_torch.remote
    def nop():
        return None

    record("task_roundtrip",
           _rate(lambda: ray_tpu_torch.get(nop.remote()), n(200)), "tasks/s")

    def batch_submit():
        ray_tpu_torch.get([nop.remote() for _ in range(10)])

    record("task_throughput_batch10",
           _rate(batch_submit, n(30)) * 10, "tasks/s")

    # -- actors ------------------------------------------------------------
    @ray_tpu_torch.remote
    class Echo:
        def ping(self, x=None):
            return x

    actor = Echo.remote()
    ray_tpu_torch.get(actor.ping.remote(), timeout=60)
    record("actor_call_roundtrip",
           _rate(lambda: ray_tpu_torch.get(actor.ping.remote()), n(300)),
           "calls/s")

    def actor_batch():
        ray_tpu_torch.get([actor.ping.remote(i) for i in range(10)])

    record("actor_call_throughput_batch10",
           _rate(actor_batch, n(30)) * 10, "calls/s")
    ray_tpu_torch.kill(actor)
    return results


if __name__ == "__main__":
    import sys

    scale = float(sys.argv[1]) if len(sys.argv) > 1 else 1.0
    main(scale)
