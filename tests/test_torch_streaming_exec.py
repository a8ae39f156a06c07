"""The port's streaming executor (``ray_tpu_torch/data/streaming.py``:
bytes backpressure, actor-pool streaming) against the JAX package's.

Mirrors tests/test_streaming_exec.py: the same programs run in both
runtimes, which are up at once.  Results are compared as the reference
orders them; the executor's structural bounds (peak bytes waiting,
backpressure stalls) are held for each.  Result sizes are the stored
sizes of the port's objects: a block of numpy columns, pickle-5
buffers and a header.
"""

import sys
import time

import numpy as np
import pytest

import ray_tpu
import ray_tpu_torch
from ray_tpu import data as jdata
from ray_tpu.data import streaming as jstreaming
from ray_tpu_torch import data as tdata
from ray_tpu_torch._private._vendor import cloudpickle as port_cloudpickle
from ray_tpu_torch.data import streaming as tstreaming
# autouse: the JAX runtime's loops settle before they stop
from tests.test_torch_jax_teardown import settle_jax_loops  # noqa: F401

port_cloudpickle.register_pickle_by_value(sys.modules[__name__])

STORE = 128 * 1024 * 1024
#: the longest a test waits for one result
WAIT_S = 120


@pytest.fixture(scope="module")
def runtimes():
    ray_tpu.init(num_cpus=4, object_store_memory=STORE, log_to_driver=False)
    ray_tpu_torch.init(num_cpus=4, num_gpus=0, object_store_memory=STORE,
                       log_to_driver=False)
    yield {"jax": (ray_tpu, jdata, jstreaming),
           "torch": (ray_tpu_torch, tdata, tstreaming)}
    ray_tpu_torch.shutdown()
    ray_tpu.shutdown()


def both(runtimes, prog, *args):
    """(the JAX package's result, the port's) of ``prog``."""
    return tuple(prog(*runtimes[name], *args) for name in ("jax", "torch"))


def _big_blocks(data, n_blocks=8, rows=20_000):
    # ~160KB per block of float64
    return data.from_items(
        [{"x": float(i)} for i in range(n_blocks * rows)],
        parallelism=n_blocks)


def prog_backpressure(rt, data, streaming):
    ds2 = _big_blocks(data).map_batches(
        lambda b: {"x": np.asarray(b["x"]) * 2})
    stats = streaming.ExecStats("bp-test")
    # budget of ~1.5 blocks: completed-unyielded results must stay near
    # one block's size even though 8 blocks could complete instantly
    ex = streaming.StreamingExecutor(max_in_flight=8, max_bytes=300_000)
    got = 0
    for _ in ex.execute(ds2._block_refs, ds2._stages, stats):
        time.sleep(0.1)  # slow consumer
        got += 1
    return got, stats


def test_bytes_backpressure_bounds_inflight_like_jax(runtimes):
    for got, stats in both(runtimes, prog_backpressure):
        assert got == 8
        assert stats.total_bytes > 0
        assert stats.peak_inflight_bytes <= 2 * 300_000, stats.summary()
        assert stats.backpressure_stalls > 0, stats.summary()


def test_port_counts_the_stored_size_of_a_block(runtimes):
    """The bytes the executor books for a block are its stored size:
    the float64 column's buffer plus a small envelope."""
    ds = tdata.range(1000, parallelism=1).map_batches(
        lambda b: {"x": b["id"].astype(np.float64)})
    stats = tstreaming.ExecStats("size")
    ex = tstreaming.StreamingExecutor(max_in_flight=1)
    refs = list(ex.execute(ds._block_refs, ds._stages, stats))
    assert len(refs) == 1
    assert 8000 <= stats.total_bytes <= 8000 + 2048, stats.total_bytes
    assert tstreaming._object_nbytes(refs[0]) == stats.total_bytes


def prog_unbounded_vs_bounded(rt, data, streaming):
    ds = data.range(1000, parallelism=10)
    doubled = ds.map_batches(lambda b: {"id": np.asarray(b["id"]) * 2})
    return [r["id"] for r in doubled.take_all()]


def test_streaming_unbounded_vs_bounded_same_results_as_jax(runtimes):
    want, got = both(runtimes, prog_unbounded_vs_bounded)
    assert got == want
    assert sorted(got) == [2 * i for i in range(1000)]


def prog_actor_pool(rt, data, streaming):
    def fn(batch):
        return {"y": np.asarray(batch["id"]) + 1}

    ds = data.range(400, parallelism=8).map_batches(
        fn, compute=data.ActorPoolStrategy(size=2, num_cpus=0.5))
    out = []
    for batch in ds.iter_batches(batch_size=50):
        out.extend(np.asarray(batch["y"]).tolist())
    return out, "actor-pool" in ds.stats()


def test_actor_pool_streams_through_window_like_jax(runtimes):
    want, got = both(runtimes, prog_actor_pool)
    assert got == want
    assert sorted(got[0]) == list(range(1, 401)) and got[1]


def prog_stats(rt, data, streaming):
    ds = _big_blocks(data, n_blocks=4)
    batches = list(ds.map_batches(lambda b: b).iter_batches(
        batch_size=10_000))
    return len(batches), ds.stats()


def test_stats_report_bytes_and_stalls_like_jax(runtimes):
    want, got = both(runtimes, prog_stats)
    assert got[0] == want[0] == 8
    for _, s in (want, got):
        assert "MB through" in s, s
    # the same 4 blocks of 20,000 floats through both: ~0.16 MB each
    mb = [float(s.split("blocks in")[1].split("MB through")[0]
                .rsplit(",", 1)[1]) for _, s in (want, got)]
    assert abs(mb[0] - mb[1]) <= 0.1 * mb[0], (want[1], got[1])
