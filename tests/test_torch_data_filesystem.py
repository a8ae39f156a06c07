"""The port's filesystem seam under Data IO and spill
(``ray_tpu_torch/data/filesystem.py``, ``_private/spill.py``'s URI
targets) against the JAX package's.

Mirrors tests/test_data_filesystem.py: the same programs run in both
runtimes, which are up at once, and give the same rows in the same
order; the ``kv://`` spill goes through the port's GCS, under pressure
too.  The reference's last step there, ``iter_jax_batches``, is the
port's ``iter_torch_batches(device="cpu")``.
"""

import sys

import numpy as np
import pytest

import ray_tpu
import ray_tpu_torch
from ray_tpu import data as jdata
from ray_tpu._private import worker_context as jwc
from ray_tpu._private.spill import SpillManager as JaxSpillManager
from ray_tpu.data import filesystem as jfs
from ray_tpu_torch import data as tdata
from ray_tpu_torch._private import worker_context as twc
from ray_tpu_torch._private._vendor import cloudpickle as port_cloudpickle
from ray_tpu_torch._private.spill import SpillManager as PortSpillManager
from ray_tpu_torch.data import filesystem as tfs
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
    yield {"jax": (ray_tpu, jdata, jfs, jwc, JaxSpillManager),
           "torch": (ray_tpu_torch, tdata, tfs, twc, PortSpillManager)}
    ray_tpu_torch.shutdown()
    ray_tpu.shutdown()


def both(runtimes, prog, *args):
    """(the JAX package's result, the port's) of ``prog``."""
    return tuple(prog(*runtimes[name], *args) for name in ("jax", "torch"))


def test_runtime_spills_to_kv_when_its_store_fills():
    """A runtime started with a kv:// spill target (the node manager's
    SpillManager) spills objects out of a small store into the GCS KV
    and serves every get back, bit for bit.  It runs before the module's
    runtimes start."""
    ray_tpu_torch.init(num_cpus=1, num_gpus=0,
                       object_store_memory=32 * 1024 * 1024,
                       log_to_driver=False,
                       _system_config={"spill_dir": "kv://pressure"})
    try:
        cw = twc.core_worker()
        assert cw.spill.is_remote
        arrays = [np.full(1_500_000, i, dtype=np.int64) for i in range(6)]
        refs = [ray_tpu_torch.put(a) for a in arrays]  # 72 MB > 32 MiB
        spilled = cw.spill.list()
        assert spilled, "nothing was spilled"
        assert all(sz > 0 for _, sz in spilled)
        for a, r in zip(arrays, refs):
            np.testing.assert_array_equal(
                ray_tpu_torch.get(r, timeout=WAIT_S), a)
    finally:
        ray_tpu_torch.shutdown()


@pytest.mark.parametrize("fs_mod", [jfs, tfs], ids=["jax", "torch"])
def test_resolve_schemes(fs_mod):
    fs, p = fs_mod.resolve("/tmp/x")
    assert isinstance(fs, fs_mod.LocalFileSystem) and p == "/tmp/x"
    fs, p = fs_mod.resolve("file:///tmp/x")
    assert isinstance(fs, fs_mod.LocalFileSystem) and p == "/tmp/x"
    fs, p = fs_mod.resolve("mem://bucket/a.csv")
    assert isinstance(fs, fs_mod.MemoryFileSystem)
    assert p == "bucket/a.csv"
    fs, p = fs_mod.resolve("kv://spill/x")
    assert isinstance(fs, fs_mod.KVFileSystem) and p == "spill/x"
    assert fs_mod.join("kv://a", "b", "c.npy") == "kv://a/b/c.npy"
    assert fs_mod.join("/a", "b") == "/a/b"


@pytest.mark.parametrize("fs_mod", [jfs, tfs], ids=["jax", "torch"])
def test_register_filesystem_plugin(fs_mod):
    class MyFS(fs_mod.MemoryFileSystem):
        pass

    fs_mod.register_filesystem("myscheme", MyFS)
    fs, p = fs_mod.resolve("myscheme://data/x")
    assert isinstance(fs, MyFS) and p == "data/x"


@pytest.mark.parametrize("fs_mod", [jfs, tfs], ids=["jax", "torch"])
def test_memory_fs_roundtrip(fs_mod):
    fs = fs_mod.MemoryFileSystem()
    with fs.open_output("b/one.txt") as f:
        f.write(b"hello")
    assert fs.exists("b/one.txt")
    with fs.open_input("b/one.txt") as f:
        assert f.read() == b"hello"
    assert fs.list("b", ".txt") == ["b/one.txt"]
    assert fs.size("b/one.txt") == 5
    fs.delete("b/one.txt")
    assert not fs.exists("b/one.txt")
    with pytest.raises(FileNotFoundError):
        fs.open_input("b/one.txt")
    # a failed write publishes nothing
    with pytest.raises(RuntimeError):
        with fs.open_output("b/two.txt") as f:
            f.write(b"partial")
            raise RuntimeError("interrupted")
    assert not fs.exists("b/two.txt")


def test_cloud_schemes_go_through_pyarrow_fs():
    """s3:// gs:// hdfs:// resolve through pyarrow.fs in both packages:
    a bucket-less URI fails the same way."""
    for fs_mod in (jfs, tfs):
        with pytest.raises(ValueError, match="cannot resolve filesystem"):
            fs_mod.resolve("hdfs://")


def prog_mem_scheme(rt, data, fs_mod, wc, sm):
    ds = data.from_items([{"a": i, "b": i * 2} for i in range(10)])
    ds.write_parquet(f"mem://out_{data.__name__}/pq")
    back = data.read_parquet(f"mem://out_{data.__name__}/pq")
    return back.take_all(), back.num_blocks


def test_read_write_mem_scheme_matches_jax(runtimes):
    want, got = both(runtimes, prog_mem_scheme)
    assert got == want
    rows = sorted(got[0], key=lambda r: r["a"])
    assert rows[3] == {"a": 3, "b": 6} and len(rows) == 10


def prog_kv_roundtrip(rt, data, fs_mod, wc, sm):
    """The full loop through a remote scheme: write parquet to the
    cluster KV, read it back via remote tasks (workers resolve kv://
    through the GCS), shuffle, iterate batches."""
    ds = data.from_items([{"x": float(i)} for i in range(32)])
    ds.write_parquet("kv://ds1")
    back = data.read_parquet("kv://ds1")
    shuffled = back.random_shuffle(seed=3)
    got = []
    for batch in shuffled.iter_batches(batch_size=8):
        assert batch["x"].shape == (8,)
        got.extend(batch["x"].tolist())
    return got


def test_kv_scheme_read_shuffle_iter_roundtrip_matches_jax(runtimes):
    want, got = both(runtimes, prog_kv_roundtrip)
    assert got == want  # the seeded shuffle's order
    assert sorted(got) == [float(i) for i in range(32)]
    # the port's device half: iter_torch_batches onto the CPU
    back = tdata.read_parquet("kv://ds1").random_shuffle(seed=3)
    vals = [float(v) for b in back.iter_torch_batches(batch_size=8,
                                                       device="cpu")
            for v in b["x"].tolist()]
    assert vals == want


def prog_file_datasource(rt, data, fs_mod, wc, sm, tmp):
    d = str(tmp / f"csvs_{data.__name__}")
    ds = data.from_items([{"v": i, "s": f"r{i}"} for i in range(6)])
    ds.write_datasource(data.FileDatasource(d, fmt="csv"))
    files = fs_mod.LocalFileSystem().list(d, ".csv")
    back = data.read_datasource(data.FileDatasource(d, fmt="csv"))
    jd = str(tmp / f"json_{data.__name__}")
    ds.write_datasource(data.FileDatasource(jd, fmt="json"))
    jback = data.read_datasource(data.FileDatasource(jd, fmt="json"))
    texts = [open(f).read() for f in fs_mod.LocalFileSystem().list(
        jd, ".json")]
    return [f.rsplit("/", 1)[1] for f in files], back.take_all(), \
        jback.take_all(), texts


def test_file_datasource_read_and_write_matches_jax(runtimes, tmp_path):
    want, got = both(runtimes, prog_file_datasource, tmp_path)
    assert got == want
    assert got[0], "write_datasource produced no files"
    assert sorted(r["v"] for r in got[1]) == list(range(6))
    with pytest.raises(ValueError, match="unknown format"):
        tdata.FileDatasource("/x", fmt="xml")


def prog_text_numpy(rt, data, fs_mod, wc, sm, tmp):
    d = tmp / f"texts_{data.__name__}"
    d.mkdir()
    (d / "a.txt").write_text("one\ntwo\n")
    (d / "b.txt").write_text("three\n")
    nd = tmp / f"np_{data.__name__}"
    nd.mkdir()
    np.save(nd / "x.npy", np.arange(4))
    np.save(nd / "y.npy", np.arange(6, dtype=np.float32).reshape(3, 2))
    return data.read_text(str(d)).take_all(), \
        data.read_numpy(str(nd / "x.npy")).take_all(), \
        data.read_numpy(str(nd / "y.npy")).take_all()


def test_text_and_numpy_via_seam_match_jax(runtimes, tmp_path):
    want, got = both(runtimes, prog_text_numpy, tmp_path)
    assert got == want
    assert [r["text"] for r in got[0]] == ["one", "two", "three"]
    assert [r["value"] for r in got[1]] == [0, 1, 2, 3]
    assert got[2][1] == {"value": [2.0, 3.0]}
    with pytest.raises(FileNotFoundError, match="no .txt files"):
        tdata.read_text(str(tmp_path / "missing"))


def prog_remote_spill_kv(rt, data, fs_mod, wc, sm_cls):
    """Spill targeting a remote scheme: write through, read back, list,
    delete (external_storage.py:445 analog), through the live cluster's
    KV."""
    cw = wc.core_worker()
    sm = sm_cls(cw.store, "kv://spilltest")
    oid = b"\x01" * 28
    sm.write_direct(oid, b"payload-bytes")
    out = [sm.is_remote, sm.contains(oid), sm.read(oid),
           sm.read_range(oid, 8, 5), sm.size(oid), (oid, 13) in sm.list()]
    sm.delete(oid)
    return out + [sm.contains(oid), sm.read(oid)]


def test_remote_spill_kv_matches_jax(runtimes):
    want, got = both(runtimes, prog_remote_spill_kv)
    assert got == want == [True, True, b"payload-bytes", b"bytes", 13, True,
                           False, None]


def prog_remote_spill_pressure(rt, data, fs_mod, wc, sm_cls):
    """A SpillManager with a kv:// dir spills a real object out of the
    shm store, and a get of its ref is served from the KV."""
    cw = wc.core_worker()
    sm = sm_cls(cw.store, f"kv://spill2_{data.__name__}")
    value = np.arange(100_000)
    ref = rt.put(value)
    oid = ref._info.oid
    spilled = None
    for cand, size in cw.store.lru_candidates(1 << 40):
        if cand.binary() == oid:
            spilled = sm._spill_one(cand)
            break
    return spilled, sm.contains(oid), sm.read(oid) is not None, \
        [s for o, s in sm.list() if o == oid]


def test_remote_spill_under_pressure_matches_jax(runtimes):
    want, got = both(runtimes, prog_remote_spill_pressure)
    assert got[0] is want[0] is True, (want, got)
    assert got[1:3] == want[1:3] == (True, True)
    assert len(got[3]) == 1 and got[3][0] > 800_000
