"""The port's Data layer (``ray_tpu_torch.data``) against the JAX
package's (``ray_tpu.data``).

Mirrors tests/test_data.py: the same program runs in both runtimes,
which are up at once, and the results are compared, in order where the
reference's order is fixed (a seeded shuffle, a sort, ``iter_batches``,
``take``, a groupby's output blocks) and as multisets elsewhere.  There
is no float arithmetic on the path, so numeric columns are compared
exactly.  Two of test_data.py's tests are not mirrored:
``test_dataset_feeds_trainer`` (the port's Train is ROADMAP.md queue 1
item 7.8) and the mesh half of ``test_iter_jax_batches_sharded`` (item
7.7); its device-transfer half is held against
``iter_torch_batches(device="cpu")``.  The reference's blocks are
pyarrow Tables and the port's numpy columns: the block tests hold the
port to pyarrow where pyarrow raises and where it returns, and a
subprocess runs a pipeline with pyarrow and pandas blocked.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pyarrow as pa
import pytest
import torch

import ray_tpu
import ray_tpu_torch
from ray_tpu import data as jdata
from ray_tpu.data import block as jblock
from ray_tpu_torch import data as tdata
from ray_tpu_torch._private._vendor import cloudpickle as port_cloudpickle
from ray_tpu_torch.data import block as tblock
# autouse: the JAX runtime's loops settle before they stop
from tests.test_torch_jax_teardown import settle_jax_loops  # noqa: F401

port_cloudpickle.register_pickle_by_value(sys.modules[__name__])

ROOT = Path(__file__).resolve().parents[1]
STORE = 128 * 1024 * 1024
#: the longest a test waits for one result
WAIT_S = 120


@pytest.fixture(scope="module")
def runtimes():
    ray_tpu.init(num_cpus=4, object_store_memory=STORE, log_to_driver=False)
    ray_tpu_torch.init(num_cpus=4, num_gpus=0, object_store_memory=STORE,
                       log_to_driver=False)
    yield {"jax": (ray_tpu, jdata), "torch": (ray_tpu_torch, tdata)}
    ray_tpu_torch.shutdown()
    ray_tpu.shutdown()


def both(runtimes, prog, *args):
    """``prog(rt, data, *args)`` in the JAX runtime, then in the port's:
    (the JAX package's result, the port's)."""
    return tuple(prog(rt, data, *args)
                 for rt, data in (runtimes["jax"], runtimes["torch"]))


def ids(rows, key="id"):
    return [r[key] for r in rows]


# -- programs of tests/test_data.py ----------------------------------------

def prog_range_count_take(rt, data):
    ds = data.range(100, parallelism=4)
    return ds.count(), ds.num_blocks, ds.take(3)


def test_range_count_take_matches_jax(runtimes):
    want, got = both(runtimes, prog_range_count_take)
    assert got == want == (100, 4, [{"id": 0}, {"id": 1}, {"id": 2}])


def prog_map_batches_fused(rt, data):
    ds = data.range(64, parallelism=4) \
        .map_batches(lambda b: {"id": b["id"] * 2}) \
        .map_batches(lambda b: {"id": b["id"] + 1})
    return ds.take_all()


def test_map_batches_fused_matches_jax(runtimes):
    want, got = both(runtimes, prog_map_batches_fused)
    assert got == want
    assert sorted(ids(got)) == [2 * i + 1 for i in range(64)]


def prog_map_filter_flat_map(rt, data):
    ds = data.from_items([{"x": i} for i in range(10)])
    out = ds.map(lambda r: {"x": r["x"] * 10}) \
        .filter(lambda r: r["x"] >= 50) \
        .flat_map(lambda r: [{"x": r["x"]}, {"x": r["x"] + 1}])
    return out.take_all()


def test_map_filter_flat_map_matches_jax(runtimes):
    want, got = both(runtimes, prog_map_filter_flat_map)
    assert got == want
    assert sorted(ids(got, "x")) == sorted(
        [v for i in range(5, 10) for v in (i * 10, i * 10 + 1)])


def prog_split(rt, data):
    shards = data.range(100, parallelism=3).split(4)
    return [s.count() for s in shards], [ids(s.take_all()) for s in shards]


def test_split_equalizes_matches_jax(runtimes):
    want, got = both(runtimes, prog_split)
    assert got == want
    counts = got[0]
    assert sum(counts) == 100 and max(counts) - min(counts) <= 1


def prog_iter_batches(rt, data):
    batches = list(data.range(100, parallelism=4).iter_batches(
        batch_size=32))
    return [b["id"] for b in batches]


def test_iter_batches_batching_matches_jax(runtimes):
    want, got = both(runtimes, prog_iter_batches)
    assert [len(b) for b in got] == [len(b) for b in want] == [32, 32, 32, 4]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype
    assert sorted(np.concatenate(got).tolist()) == list(range(100))


def prog_shuffle_and_sort(rt, data):
    sh = data.range(50, parallelism=2).random_shuffle(seed=0)
    return ids(sh.take_all()), ids(sh.sort("id").take_all())


def test_random_shuffle_and_sort_matches_jax_in_order(runtimes):
    want, got = both(runtimes, prog_shuffle_and_sort)
    assert got == want
    assert got[0] != list(range(50)) and sorted(got[0]) == list(range(50))
    assert got[1] == list(range(50))


def prog_parquet(rt, data, tmp):
    ds = data.from_numpy({"a": np.arange(40), "b": np.arange(40) * 1.5})
    ds.write_parquet(str(tmp / "pq"))
    back = data.read_parquet(str(tmp / "pq"))
    df = back.to_pandas().sort_values("a").reset_index(drop=True)
    return back.count(), df["a"].to_numpy(), df["b"].to_numpy()


def test_parquet_roundtrip_matches_jax(runtimes, tmp_path):
    (tmp_path / "jax").mkdir()
    (tmp_path / "torch").mkdir()
    want = prog_parquet(*runtimes["jax"], tmp_path / "jax")
    got = prog_parquet(*runtimes["torch"], tmp_path / "torch")
    assert got[0] == want[0] == 40
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got[2], np.arange(40) * 1.5)
    # each package reads the other's files
    for rt, data, d in (runtimes["jax"] + (tmp_path / "torch",),
                        runtimes["torch"] + (tmp_path / "jax",)):
        assert sorted(ids(data.read_parquet(str(d / "pq")).take_all(),
                          "a")) == list(range(40))


def prog_distributed_shuffle(rt, data):
    out = data.range(1000, parallelism=4).random_shuffle(seed=0)
    return ids(out.take_all()), out.num_blocks


def test_distributed_random_shuffle_matches_jax_in_order(runtimes):
    want, got = both(runtimes, prog_distributed_shuffle)
    assert got == want
    assert sorted(got[0]) == list(range(1000))
    assert got[0][:50] != list(range(50)) and got[1] == 4


def prog_distributed_sort(rt, data):
    vals = np.random.default_rng(1).permutation(500).astype("int64")
    asc = data.from_numpy({"v": vals}, parallelism=4).sort("v")
    desc = data.from_numpy({"v": vals}, parallelism=4).sort(
        "v", descending=True)
    return ids(asc.take_all(), "v"), ids(desc.take_all(), "v"), vals


def test_distributed_sort_matches_jax(runtimes):
    want, got = both(runtimes, prog_distributed_sort)
    assert got[:2] == want[:2]
    assert got[0] == sorted(got[2].tolist())
    assert got[1] == sorted(got[2].tolist(), reverse=True)


def prog_groupby(rt, data):
    rows = [{"k": i % 3, "v": float(i)} for i in range(30)]
    ds = data.from_items(rows, parallelism=4)
    return ds.groupby("k").sum("v").take_all(), \
        ds.groupby("k").count().take_all(), \
        ds.groupby("k").mean("v").take_all(), \
        ds.groupby("k").std("v").take_all()


def test_groupby_aggregates_match_jax_in_order(runtimes):
    want, got = both(runtimes, prog_groupby)
    assert got == want
    assert {r["k"]: r["sum(v)"] for r in got[0]} == {0: 135.0, 1: 145.0,
                                                     2: 155.0}
    assert {r["k"]: r["count"] for r in got[1]} == {0: 10, 1: 10, 2: 10}


def prog_actor_pool(rt, data):
    class AddModel:
        def __init__(self):
            self.offset = 100  # "expensive" setup happens once per actor

        def __call__(self, batch):
            batch["id"] = batch["id"] + self.offset
            return batch

    ds = data.range(64, parallelism=4).map_batches(
        AddModel, compute=data.ActorPoolStrategy(size=2, num_cpus=0.5))
    return ids(ds.take_all())


def test_map_batches_actor_pool_matches_jax(runtimes):
    want, got = both(runtimes, prog_actor_pool)
    assert got == want
    assert sorted(got) == [i + 100 for i in range(64)]


def test_actor_pool_grants_cards_not_tpus():
    """The pool's accelerator is whole cards (num_gpus); the JAX
    package's num_tpus raises the runtime's ValueError."""
    strat = tdata.ActorPoolStrategy(size=1, num_gpus=1)
    assert (strat.size, strat.num_cpus, strat.num_gpus) == (1, 1.0, 1)
    with pytest.raises(ValueError, match="num_tpus is the JAX package's"):
        tdata.ActorPoolStrategy(size=1, num_tpus=1)
    from ray_tpu_torch.remote_function import _build_resources

    with pytest.raises(ValueError, match="num_tpus is the JAX package's"):
        _build_resources({"num_tpus": 1})
    with pytest.raises(TypeError):
        tdata.ActorPoolStrategy(size=1, num_chips=1)


def prog_pipeline(rt, data):
    pipe = data.range(40, parallelism=4).window(blocks_per_window=2)
    seen = [b["id"].tolist() for b in pipe.iter_batches(batch_size=10)]
    pipe2 = data.range(10, parallelism=2).repeat(3)
    sizes = [len(b["id"]) for b in pipe2.iter_batches(batch_size=5)]
    return seen, sizes, repr(pipe), repr(pipe2)


def test_dataset_pipeline_windows_and_repeat_match_jax(runtimes):
    want, got = both(runtimes, prog_pipeline)
    assert got == want
    assert sorted(x for b in got[0] for x in b) == list(range(40))
    assert sum(got[1]) == 30


def prog_read_json_text_numpy(rt, data, tmp):
    import json as json_mod

    jpath = tmp / "rows.json"
    jpath.write_text("\n".join(json_mod.dumps({"a": i, "s": f"r{i}",
                                               "f": i / 2})
                               for i in range(5)))
    tpath = tmp / "doc.txt"
    tpath.write_text("alpha\nbeta\n")
    npath = tmp / "arr.npy"
    np.save(npath, np.arange(4))
    return (data.read_json(str(jpath)).take_all(),
            data.read_text(str(tpath)).take_all(),
            data.read_numpy(str(npath)).take_all())


def test_read_json_text_numpy_match_jax(runtimes, tmp_path):
    want, got = both(runtimes, prog_read_json_text_numpy, tmp_path)
    assert got == want
    assert ids(got[0], "a") == list(range(5))
    assert ids(got[1], "text") == ["alpha", "beta"]
    assert ids(got[2], "value") == [0, 1, 2, 3]


def prog_groupby_string_keys(rt, data):
    rows = [{"name": n, "v": 1.0} for n in ("alpha", "beta", "gamma") * 20]
    out = data.from_items(rows, parallelism=6).groupby("name").sum("v")
    return out.take_all()


def test_groupby_string_keys_cross_worker_match_jax_in_order(runtimes):
    want, got = both(runtimes, prog_groupby_string_keys)
    assert got == want
    assert {r["name"]: r["sum(v)"] for r in got} == {
        "alpha": 20.0, "beta": 20.0, "gamma": 20.0}
    assert len(got) == 3


def test_iter_torch_batches_matches_iter_jax_batches(runtimes):
    """The device-transfer half of test_iter_jax_batches_sharded: the
    port's iter_torch_batches(device="cpu") gives the values and dtypes
    of iter_jax_batches, with a host-side cast and both drop_last
    settings."""
    arrays = {"x": np.arange(64, dtype=np.float32),
              "y": np.arange(64, dtype=np.int64)}
    jds = jdata.from_numpy(arrays)
    tds = tdata.from_numpy(arrays)
    want = list(jds.iter_jax_batches(batch_size=16))
    got = list(tds.iter_torch_batches(batch_size=16, device="cpu"))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert isinstance(g["x"], torch.Tensor) and g["x"].device.type == "cpu"
        assert g["x"].dtype == torch.float32 and g["y"].dtype == torch.int64
        for k in arrays:
            np.testing.assert_array_equal(g[k].numpy(), np.asarray(w[k]))
    b = next(tds.iter_torch_batches(batch_size=32, device="cpu",
                                    dtypes={"y": torch.float32}))
    jb = next(jds.iter_jax_batches(batch_size=32, dtypes={"y": np.float32}))
    assert b["y"].dtype == torch.float32
    np.testing.assert_array_equal(b["y"].numpy(), np.asarray(jb["y"]))
    # a host tensor may be written: it does not alias the store
    b["x"][0] = -1.0
    tiny_j = jdata.from_numpy({"x": np.arange(5, dtype=np.float32)})
    tiny_t = tdata.from_numpy({"x": np.arange(5, dtype=np.float32)})
    for drop_last in (True, False):
        want = list(tiny_j.iter_jax_batches(batch_size=16,
                                            drop_last=drop_last))
        got = list(tiny_t.iter_torch_batches(batch_size=16, device="cpu",
                                             drop_last=drop_last))
        assert len(got) == len(want) == (0 if drop_last else 1)
    # the reference's iter_torch_batches defaults: drop_last=False
    assert len(list(tiny_t.iter_torch_batches(batch_size=16,
                                              device="cpu"))) == 1
    want = list(jds.iter_torch_batches(batch_size=48, device="cpu"))
    got = list(tds.iter_torch_batches(batch_size=48, device="cpu"))
    assert [len(b["x"]) for b in got] == [len(b["x"]) for b in want]


def test_iter_torch_batches_defaults_to_the_card(runtimes):
    ds = tdata.from_numpy({"x": np.arange(8, dtype=np.float32)})
    if torch.cuda.is_available():
        assert next(ds.iter_torch_batches(batch_size=4))["x"].is_cuda
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            next(ds.iter_torch_batches(batch_size=4))
    # a sharded batch whose rows do not divide the shards raises, as a
    # sharded jax.device_put does (each rank's rows on 2 gloo ranks:
    # tests/test_torch_sharded_decode.py)
    from ray_tpu_torch.parallel import MeshSpec, fake_mesh
    from ray_tpu_torch.parallel.sharding import NamedSharding, PartitionSpec

    rows = NamedSharding(fake_mesh(2, MeshSpec(data=2)),
                         PartitionSpec("data"))
    with pytest.raises(ValueError, match="ragged last batch"):
        next(tdata.from_numpy({"x": np.arange(3, dtype=np.float32)})
             .iter_torch_batches(batch_size=4, sharding=rows))
    assert not hasattr(ds, "iter_jax_batches")


def prog_tensor_columns(rt, data):
    imgs = np.arange(2 * 4 * 4 * 3, dtype=np.float32).reshape(2, 4, 4, 3)
    toks = np.arange(2 * 7, dtype=np.int64).reshape(2, 7)
    ds = data.from_numpy({"img": imgs, "tok": toks,
                          "label": np.array([1, 2])})
    out = next(ds.iter_batches(batch_size=2))
    doubled = ds.map_batches(lambda b: {"img2": b["img"] * 2})
    out2 = next(doubled.iter_batches(batch_size=2))
    return out, out2, ds.take_all()


def test_tensor_columns_roundtrip_match_jax(runtimes):
    want, got = both(runtimes, prog_tensor_columns)
    for g, w in zip(got[:2], want[:2]):
        assert list(g) == list(w)
        for k in g:
            assert g[k].shape == w[k].shape and g[k].dtype == w[k].dtype
            np.testing.assert_array_equal(g[k], w[k])
    assert got[0]["img"].shape == (2, 4, 4, 3)
    assert got[2] == want[2]  # rows as nested lists, as pyarrow's


# -- round 4: streaming execution, push-based shuffle, datasources --------

def prog_streaming_bounds(rt, data, tmp):
    import time

    if data is tdata:
        from ray_tpu_torch.data.streaming import StreamingExecutor
    else:
        from ray_tpu.data.streaming import StreamingExecutor
    marker = str(tmp / f"started_{data.__name__}")

    def slow_stage(table, _m=marker):
        with open(_m, "a") as f:
            f.write("x")
        time.sleep(0.1)
        return table

    ds = data.range(64, parallelism=8)
    it = StreamingExecutor(max_in_flight=2).execute(ds._block_refs,
                                                    [slow_stage])
    first = rt.get(next(it), timeout=WAIT_S)
    with open(marker) as f:
        started_at_first = len(f.read())
    rest = [rt.get(r, timeout=WAIT_S) for r in it]
    return started_at_first, [first.num_rows] + [t.num_rows for t in rest]


def test_streaming_executor_bounds_submission_like_jax(runtimes,
                                                       tmp_path):
    want, got = both(runtimes, prog_streaming_bounds, tmp_path)
    for started, rows in (want, got):
        # window 2 + at most one refill round before the first yield
        assert started <= 3, started
        assert rows == [8] * 8  # every block arrives, in order


def prog_streaming_caches(rt, data, tmp):
    marker = str(tmp / f"executed_{data.__name__}")

    def stage(table, _m=marker):
        with open(_m, "a") as f:
            f.write("x")
        return table

    ds = data.range(64, parallelism=8).map_batches(stage)
    n = len(list(ds.iter_batches(batch_size=8)))
    list(ds.iter_batches(batch_size=8))
    with open(marker) as f:
        return n, len(f.read())


def test_streaming_iter_batches_caches_like_jax(runtimes, tmp_path):
    want, got = both(runtimes, prog_streaming_caches, tmp_path)
    assert got == want == (8, 8)


def prog_streaming_stats(rt, data):
    ds = data.range(20, parallelism=2).map(lambda r: r)
    list(ds.iter_batches(batch_size=10))
    s = ds.stats()
    return "stream" in s, "2 blocks" in s


def test_streaming_stats_recorded_like_jax(runtimes):
    want, got = both(runtimes, prog_streaming_stats)
    assert got == want == (True, True)


def prog_push_shuffle(rt, data):
    if data is tdata:
        from ray_tpu_torch.data import shuffle as sm
    else:
        from ray_tpu.data import shuffle as sm
    out = data.range(400, parallelism=20).random_shuffle(seed=7)
    return sm.PUSH_BASED_THRESHOLD, ids(out.take_all()), out.num_blocks


def test_push_based_shuffle_matches_jax_in_order(runtimes):
    want, got = both(runtimes, prog_push_shuffle)
    assert got == want
    assert got[0] <= 20 and sorted(got[1]) == list(range(400))
    assert got[2] == 20


def prog_push_sort(rt, data):
    rng = np.random.RandomState(0)
    items = [{"k": float(x)} for x in rng.randn(300)]
    out = data.from_items(items).repartition(20).sort("k")
    return ids(out.take_all(), "k"), sorted(r["k"] for r in items)


def test_push_based_sort_matches_jax(runtimes):
    want, got = both(runtimes, prog_push_sort)
    assert got == want
    assert got[0] == got[1]


def prog_push_groupby(rt, data):
    items = [{"g": i % 17, "v": i} for i in range(340)]
    ds = data.from_items(items).repartition(20)
    return ds.groupby("g").count().take_all()


def test_push_based_groupby_matches_jax_in_order(runtimes):
    want, got = both(runtimes, prog_push_groupby)
    assert got == want
    assert {r["g"]: r["count"] for r in got} == {g: 20 for g in range(17)}


def prog_datasources(rt, data, tmp):
    if data is tdata:
        from ray_tpu_torch.data.datasource import Datasource
    else:
        from ray_tpu.data.datasource import Datasource
    ds = data.read_datasource(data.RangeDatasource(100), parallelism=5)

    class CollectSink(Datasource):
        def __init__(self, path):
            self.path = path
            self.total = None

        def write_block(self, block, i, **kw):
            import os

            with open(os.path.join(self.path, f"{i}.txt"), "w") as f:
                f.write(str(block.num_rows))
            return block.num_rows

        def on_write_complete(self, results):
            self.total = sum(results)

    d = tmp / data.__name__
    d.mkdir()
    sink = CollectSink(str(d))
    ds.write_datasource(sink)
    files = {p.name: p.read_text() for p in sorted(d.iterdir())}
    return ds.num_blocks, ids(ds.take_all()), sink.total, files


def test_read_datasource_and_write_datasource_match_jax(runtimes,
                                                        tmp_path):
    want, got = both(runtimes, prog_datasources, tmp_path)
    assert got == want
    assert got[0] == 5 and sorted(got[1]) == list(range(100))
    assert got[2] == 100


def test_custom_read_task_num_rows_metadata_matches_jax():
    for data in (jdata, tdata):
        tasks = data.RangeDatasource(10).get_read_tasks(3)
        assert [t.num_rows for t in tasks] == [4, 4, 2]


def prog_column_ops(rt, data, capsys):
    ds = data.from_items([{"a": i, "b": i * 2, "c": str(i % 3)}
                          for i in range(10)])
    out = {"sel": ds.select_columns(["a", "c"]).take(2),
           "drop": ds.drop_columns(["b"]).take(1),
           "ren": ds.rename_columns({"a": "x"}).take(1),
           "limit": ds.limit(3).take_all(),
           "unique": ds.unique("c")}
    other = data.from_items([{"d": -i} for i in range(10)])
    out["zip"] = ds.zip(other).take_all()
    out["zip2"] = ds.zip(data.from_items([{"a": 100 + i}
                                          for i in range(10)])).take(1)
    ds.show(2)
    out["show"] = capsys.readouterr().out
    with pytest.raises(ValueError, match="equal row counts"):
        ds.zip(data.from_items([{"d": 1}]))
    both_ = data.from_items([{"a_1": 10 + i, "a": 100 + i}
                             for i in range(10)])
    out["zip3"] = ds.zip(both_).take(1)
    return out


def test_column_ops_limit_unique_zip_show_match_jax(runtimes, capsys):
    want, got = both(runtimes, prog_column_ops, capsys)
    assert got == want
    assert set(got["sel"][0]) == {"a", "c"}
    assert set(got["drop"][0]) == {"a", "c"}
    assert set(got["ren"][0]) == {"x", "b", "c"}
    assert ids(got["limit"], "a") == [0, 1, 2]
    assert sorted(got["unique"]) == ["0", "1", "2"]
    assert got["zip"][4] == {"a": 4, "b": 8, "c": "1", "d": -4}
    assert got["zip2"][0]["a_1"] == 100
    assert "'a': 0" in got["show"] and got["show"].count("\n") == 2
    row = got["zip3"][0]
    assert row["a"] == 0 and row["a_1"] == 10 and row["a_2"] == 100


# -- pyarrow's semantics in the cases the reference's programs meet --------

def prog_uneven_and_mixed(rt, data):
    """What raises where pyarrow raises."""
    raised = {}
    for name, items in (("uneven", [{"a": 1, "b": 2}, {"a": 3}]),
                        ("mixed", [{"a": 1}, {"a": "x"}]),
                        ("bool_int", [{"a": True}, {"a": 1}])):
        try:
            data.from_items(items, parallelism=1).take_all()
            raised[name] = None
        except Exception as e:  # noqa: BLE001 - the class is compared
            raised[name] = isinstance(e, ValueError)
    ok = data.from_items([{"a": 1}, {"a": 2.5}, {"a": None}],
                         parallelism=1).take_all()
    return raised, ok


def test_from_items_raises_where_pyarrow_raises(runtimes):
    want, got = both(runtimes, prog_uneven_and_mixed)
    assert got == want
    assert got[0] == {"uneven": True, "mixed": True, "bool_int": True}
    assert got[1] == [{"a": 1.0}, {"a": 2.5}, {"a": None}]


def test_concat_of_blocks_raises_where_pyarrow_raises():
    j = lambda d: jblock.to_table(d)  # noqa: E731
    t = lambda d: tblock.to_table(d)  # noqa: E731
    for a, b in (({"a": [1]}, {"b": [1]}),          # other columns
                 ({"a": [1]}, {"a": [1.5]}),        # other types
                 ({"a": [1], "b": [2]}, {"b": [2], "a": [1]})):  # order
        with pytest.raises(ValueError):
            jblock.concat_tables([j(a), j(b)])
        with pytest.raises(ValueError, match="Schema at index 1"):
            tblock.concat_tables([t(a), t(b)])
    # empty blocks drop out first, in both
    got = tblock.concat_tables([t({"a": [1, 2]}), t({"a": [1]}).slice(0, 0),
                                t({"a": [3]})])
    want = jblock.concat_tables([j({"a": [1, 2]}), j({"a": [1]}).slice(0, 0),
                                 j({"a": [3]})])
    assert got.to_pylist() == want.to_pylist()
    assert tblock.concat_tables([]).num_rows == \
        jblock.concat_tables([]).num_rows == 0
    # a missing column raises KeyError, a wrong rename ValueError, as
    # pyarrow's
    with pytest.raises(KeyError):
        t({"a": [1]}).select(["z"])
    with pytest.raises(KeyError):
        t({"a": [1]}).drop_columns(["z"])
    with pytest.raises(ValueError, match="tried to rename"):
        t({"a": [1]}).rename_columns(["x", "y"])
    with pytest.raises(TypeError, match="cannot make a block"):
        tblock.to_table(3.5)


def test_sort_by_is_stable_both_ways_as_pyarrow():
    rng = np.random.default_rng(3)
    cols = {"k": rng.integers(0, 5, 200), "i": np.arange(200),
            "s": np.array([f"s{x}" for x in rng.integers(0, 4, 200)])}
    t = tblock.to_table(cols)
    a = pa.table(cols)
    for key in ("k", "s"):
        for order in ("ascending", "descending"):
            assert t.sort_by([(key, order)]).to_pylist() == \
                a.sort_by([(key, order)]).to_pylist()


def prog_sort_duplicates(rt, data):
    rng = np.random.default_rng(5)
    ds = data.from_numpy({"k": rng.integers(0, 7, 300),
                          "i": np.arange(300)}, parallelism=6)
    return ds.sort("k").take_all(), ds.sort("k", descending=True).take_all()


def test_sort_with_duplicate_keys_matches_jax_in_order(runtimes):
    want, got = both(runtimes, prog_sort_duplicates)
    assert got == want


def test_format_batch_and_schema_follow_the_reference():
    cols = {"a": np.arange(4, dtype=np.int32), "f": np.linspace(0, 1, 4),
            "s": ["w", "x", "y", "z"],
            "t": np.arange(24, dtype=np.float32).reshape(4, 2, 3)}
    t = tblock.to_table(cols)
    j = jblock.to_table(cols)
    for fmt in ("numpy", "dict", "default"):
        got, want = tblock.format_batch(t, fmt), jblock.format_batch(j, fmt)
        assert list(got) == list(want)
        for k in got:
            assert got[k].shape == want[k].shape
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
    assert t.to_pylist() == j.to_pylist()
    got, want = tblock.format_batch(t, "pandas"), jblock.format_batch(
        j, "pandas")
    assert list(got.columns) == list(want.columns)
    assert got["a"].tolist() == want["a"].tolist()
    assert got["s"].tolist() == want["s"].tolist()
    assert tblock.format_batch(t, "pyarrow").to_pylist() == j.to_pylist()
    # an arrow Table and a DataFrame become blocks, N-D columns whole
    back = tblock.to_table(j)
    assert back.to_pylist() == j.to_pylist()
    assert back.column("t").shape == (4, 2, 3)
    assert tblock.to_table(want).to_pylist() == \
        jblock.to_table(want).to_pylist()
    with pytest.raises(ValueError, match="unknown batch_format"):
        tblock.format_batch(t, "jax")
    sch = t.schema
    assert sch.names == j.schema.names == ["a", "f", "s", "t"]
    assert sch.types == [np.dtype(np.int32), np.dtype(np.float64),
                         np.dtype(object), np.dtype(np.float32)]
    assert sch.shapes == [(), (), (), (2, 3)]
    # nbytes: the numeric buffers and the strings' characters
    assert t.nbytes == (4 * 4 + 4 * 8 + 4 * 8 + 4) + 24 * 4


def prog_schema_and_pandas(rt, data):
    ds = data.from_items([{"a": i, "c": str(i)} for i in range(6)],
                         parallelism=2)
    sch = ds.schema()
    df = data.from_pandas(ds.to_pandas(), parallelism=3)
    arrow = data.from_arrow(pa.table({"a": [1, 2, 3]}), parallelism=2)
    return list(sch.names), df.take_all(), df.num_blocks, \
        arrow.take_all(), arrow.num_blocks


def test_schema_from_pandas_from_arrow_match_jax(runtimes):
    want, got = both(runtimes, prog_schema_and_pandas)
    assert got == want
    sch = tdata.from_items([{"a": 1, "c": "x"}]).schema()
    assert isinstance(sch, tblock.Schema)
    assert sch.types == [np.dtype(np.int64), np.dtype(object)]


def prog_limit_across_blocks(rt, data):
    ds = data.range(30, parallelism=4).map_batches(
        lambda b: {"id": b["id"], "sq": b["id"] ** 2})
    lim = ds.limit(17)
    return lim.num_blocks, lim.take_all(), data.range(5).limit(0).count()


def test_limit_across_blocks_matches_jax(runtimes):
    want, got = both(runtimes, prog_limit_across_blocks)
    assert got == want
    assert got[0] == 3 and ids(got[1]) == list(range(17))


def test_block_pickles_its_columns_out_of_band():
    """A block's numeric columns travel as pickle-5 buffers (no copy
    through the pickle stream): the serialized payload is the buffers
    plus a small header."""
    import pickle

    big = np.arange(1 << 16, dtype=np.int64)
    blk = tblock.to_table({"x": big, "s": ["a"] * (1 << 16)})
    bufs = []
    raw = pickle.dumps(blk, protocol=5, buffer_callback=bufs.append)
    assert sum(memoryview(b).nbytes for b in bufs) >= big.nbytes
    assert len(raw) < big.nbytes
    back = pickle.loads(raw, buffers=bufs)
    assert back == blk


NO_ARROW = r"""
import sys
sys.modules["pyarrow"] = None
sys.modules["pandas"] = None
import numpy as np
import ray_tpu_torch as rt
from ray_tpu_torch import data

rt.init(num_cpus=2, num_gpus=0, object_store_memory=64 * 2**20,
        log_to_driver=False)
try:
    ds = data.range(60, parallelism=4).map_batches(
        lambda b: {"k": b["id"] % 3, "v": b["id"].astype(np.float64)})
    g = ds.random_shuffle(seed=0).groupby("k").sum("v")
    batches = list(g.iter_torch_batches(batch_size=2, device="cpu"))
    rows = sorted(zip(np.concatenate([b["k"].numpy() for b in batches]).tolist(),
                      np.concatenate([b["sum(v)"].numpy() for b in batches]).tolist()))
    assert rows == [(0, 570.0), (1, 590.0), (2, 610.0)], rows

    def mods(batch):
        return {"m": sorted({m.split(".")[0] for m in sys.modules} &
                            {"torch", "pyarrow", "pandas"})}

    assert ds.map_batches(mods).take_all() == [], "a worker imported them"
    for fmt in ("pandas", "pyarrow"):
        try:
            next(ds.iter_batches(batch_format=fmt))
        except ImportError as e:
            print("IMPORT_ERROR", fmt, e)
    with data.MemoryFileSystem().open_output("in/a.parquet") as f:
        f.write(b"PAR1")
    for call in (lambda: data.read_parquet("mem://in"),
                 lambda: data.from_items([{"a": 1}]).write_parquet("mem://x")):
        try:
            call()
        except ImportError as e:
            print("IMPORT_ERROR call", e)
    print("PIPELINE_OK")
finally:
    rt.shutdown()
"""


def test_pipeline_runs_with_pyarrow_and_pandas_blocked():
    """range -> map_batches -> random_shuffle -> groupby().sum() ->
    iter_torch_batches(device="cpu") in a process where pyarrow and
    pandas cannot be imported (a machine without them); the workers
    import none of torch, pyarrow and pandas; the pandas and arrow
    batch formats and parquet raise the ImportError of their import."""
    r = subprocess.run([sys.executable, "-c", NO_ARROW], cwd=ROOT,
                       capture_output=True, text=True, timeout=WAIT_S)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "PIPELINE_OK" in r.stdout
    lines = [ln for ln in r.stdout.splitlines()
             if ln.startswith("IMPORT_ERROR")]
    assert any(ln.startswith("IMPORT_ERROR pandas") for ln in lines), lines
    assert any(ln.startswith("IMPORT_ERROR pyarrow") for ln in lines), lines
    assert sum(ln.startswith("IMPORT_ERROR call") for ln in lines) == 2, \
        r.stdout
