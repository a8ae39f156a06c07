"""Dataset: lazy, fused, block-parallel transforms over the object store.

Reference analogs: python/ray/data/dataset.py (:319 map_batches, :950
split, :2422 iter_batches), read_api.py:227, _internal/plan.py:70
ExecutionPlan with stage fusion (:59 fuse).  A chain of map-style
stages compiles to ONE remote task per block.

A copy of ``ray_tpu/data/dataset.py`` on the port's runtime.  Blocks
are the port's numpy-column blocks (``block.py``: the path needs no
pyarrow), carried by the object store as pickle-5 buffers.
Three changes from the reference: ``ActorPoolStrategy`` grants whole
cards (``num_gpus``; ``num_tpus`` raises, as ``remote()`` does);
``iter_torch_batches`` takes ``iter_jax_batches``'s role, landing each
batch on the card unless the caller asks for the CPU (the port has no
``iter_jax_batches``); ``schema()`` is the port's ``block.Schema``.
``from_pandas``, ``from_arrow``, ``read_parquet``, ``read_csv`` and
``write_parquet`` import pandas or pyarrow when called.
"""

from __future__ import annotations

import builtins
from typing import (Any, Callable, Dict, Iterator, List, Optional,
                    Sequence, Union)

import numpy as np

import ray_tpu_torch
from ray_tpu_torch._private._vendor import cloudpickle
from ray_tpu_torch.data import block as block_util

_DEFAULT_BLOCK_ROWS = 8192


def _fused_apply(table, stages):
    for fn in stages:
        table = fn(table)
    return table


@ray_tpu_torch.remote
def _run_stages(table, stages):
    return _fused_apply(table, stages)


class ActorPoolStrategy:
    """Run a dataset's fused stage chain on a pool of long-lived actors
    instead of one task per block (reference:
    data/_internal/compute.py:173 ActorPoolStrategy — the right choice
    when stages carry expensive setup such as model weights).

    ``num_gpus`` is whole cards a pool actor holds (its process sees
    them through ``CUDA_VISIBLE_DEVICES``); the JAX package's
    ``num_tpus`` raises ValueError."""

    def __init__(self, size: int = 2, num_cpus: float = 1.0,
                 num_gpus: float = 0.0, **kwargs):
        if "num_tpus" in kwargs:
            raise ValueError(
                "num_tpus is the JAX package's resource; the port's "
                "accelerator resource is num_gpus (whole cards)")
        if kwargs:
            raise TypeError(f"ActorPoolStrategy got unexpected keyword "
                            f"arguments {sorted(kwargs)}")
        self.size = size
        self.num_cpus = num_cpus
        self.num_gpus = num_gpus

    def actor_class(self):
        """The pool's stage actor class with this strategy's grant."""
        return ray_tpu_torch.remote(num_cpus=self.num_cpus,
                                    num_gpus=self.num_gpus)(_StageActor)


class _StageActor:
    def __init__(self):
        self._stages_cache: Dict[bytes, Any] = {}

    def run(self, table, stages_ser: bytes):
        stages = self._stages_cache.get(stages_ser)
        if stages is None:
            stages = cloudpickle.loads(stages_ser)
            self._stages_cache[stages_ser] = stages
        return _fused_apply(table, stages)


class Dataset:
    """A list of block ObjectRefs + pending (unfused) stages."""

    def __init__(self, block_refs: List, stages: Optional[List] = None,
                 compute: Optional[ActorPoolStrategy] = None,
                 stats: Optional[List] = None):
        self._block_refs = list(block_refs)
        self._stages: List[Callable] = list(stages or [])
        self._compute = compute
        #: ExecStats records, shared down the transform chain so
        #: ds.map(...).iter_batches(); ds.stats() sees the execution
        self._stats: List = stats if stats is not None else []

    # -- plan -------------------------------------------------------------
    def _with_stage(self, fn: Callable,
                    compute: Optional[ActorPoolStrategy] = None
                    ) -> "Dataset":
        return Dataset(self._block_refs, self._stages + [fn],
                       compute or self._compute, stats=self._stats)

    def materialize(self) -> "Dataset":
        """Execute pending stages: one fused task per block (the stage-
        fusion property: N stages do NOT mean N tasks per block).  The
        result is cached in place, so repeated consumption (count() then
        iter_batches(), ...) never re-runs the pipeline."""
        if not self._stages:
            return self
        import time as _time

        from ray_tpu_torch.data.streaming import ExecStats

        stats = ExecStats(f"materialize[{len(self._stages)} fused stages]")
        t0 = _time.perf_counter()
        if self._compute is not None:
            refs = self._materialize_on_actors()
        else:
            refs = [_run_stages.remote(b, self._stages)
                    for b in self._block_refs]
        stats.blocks = len(refs)
        stats.wall_s = _time.perf_counter() - t0  # submit (+actor wait)
        self._stats.append(stats)
        self._block_refs = refs
        self._stages = []
        self._compute = None
        return self

    def _materialize_on_actors(self) -> List:
        strat = self._compute
        cls = strat.actor_class()
        pool = [cls.remote() for _ in builtins.range(strat.size)]
        ser = cloudpickle.dumps(self._stages)
        refs = [pool[i % len(pool)].run.remote(b, ser)
                for i, b in enumerate(self._block_refs)]
        # Block until EVERY block finished, then retire the pool (the
        # results live in the object store independently of the actors —
        # but killing mid-execution would destroy in-flight blocks).
        remaining = list(refs)
        while remaining:
            _, remaining = ray_tpu_torch.wait(
                remaining, num_returns=len(remaining), timeout=60.0)
        for a in pool:
            try:
                ray_tpu_torch.kill(a)
            except Exception:  # noqa: BLE001
                pass
        return refs

    def _tables(self) -> List:
        ds = self.materialize()
        return ray_tpu_torch.get(list(ds._block_refs), timeout=300)

    # -- transforms (lazy) ------------------------------------------------
    def map_batches(self, fn: Callable, *, batch_format: str = "numpy",
                    compute: Optional[ActorPoolStrategy] = None,
                    **_unused) -> "Dataset":
        """fn over whole blocks.  compute=ActorPoolStrategy(...) runs the
        stage chain on a pool of long-lived actors (amortizes expensive
        fn setup; reference _internal/compute.py:173).  Callable-class
        fns are constructed once per actor."""
        if isinstance(fn, type):
            holder: Dict[str, Any] = {}

            def stage(table, _cls=fn):
                inst = holder.get("i")
                if inst is None:
                    inst = holder["i"] = _cls()
                batch = block_util.format_batch(table, batch_format)
                return block_util.to_table(inst(batch))
        else:
            def stage(table):
                batch = block_util.format_batch(table, batch_format)
                return block_util.to_table(fn(batch))

        return self._with_stage(stage, compute)

    def map(self, fn: Callable) -> "Dataset":
        def stage(table):
            rows = table.to_pylist()
            return block_util.to_table([fn(r) for r in rows])

        return self._with_stage(stage)

    def filter(self, fn: Callable) -> "Dataset":
        def stage(table):
            rows = [r for r in table.to_pylist() if fn(r)]
            if not rows:
                return table.slice(0, 0)
            return block_util.to_table(rows)

        return self._with_stage(stage)

    def flat_map(self, fn: Callable) -> "Dataset":
        def stage(table):
            out = []
            for r in table.to_pylist():
                out.extend(fn(r))
            if not out:
                return table.slice(0, 0)
            return block_util.to_table(out)

        return self._with_stage(stage)

    def add_column(self, name: str, fn: Callable) -> "Dataset":
        def stage(table):
            batch = block_util.format_batch(table, "numpy")
            batch[name] = np.asarray(fn(batch))
            return block_util.to_table(batch)

        return self._with_stage(stage)

    def select_columns(self, cols: List[str]) -> "Dataset":
        """Keep only `cols` (reference: Dataset.select_columns)."""
        cols = list(cols)

        def stage(table, _cols=cols):
            return table.select(_cols)

        return self._with_stage(stage)

    def drop_columns(self, cols: List[str]) -> "Dataset":
        """Remove `cols` (reference: Dataset.drop_columns)."""
        drop = set(cols)

        def stage(table, _drop=drop):
            keep = [c for c in table.column_names if c not in _drop]
            return table.select(keep)

        return self._with_stage(stage)

    def rename_columns(self, mapping: Dict[str, str]) -> "Dataset":
        """Rename columns by dict (reference: Dataset.rename_columns)."""
        m = dict(mapping)

        def stage(table, _m=m):
            return table.rename_columns(
                [_m.get(c, c) for c in table.column_names])

        return self._with_stage(stage)

    def limit(self, n: int) -> "Dataset":
        """First n rows (reference: Dataset.limit).  Materializes only
        as many blocks as the limit needs."""
        out, taken = [], 0
        if n > 0:
            for t in self._iter_tables():
                take = min(n - taken, t.num_rows)
                out.append(ray_tpu_torch.put(t.slice(0, take)))
                taken += take
                if taken >= n:
                    break       # before pulling (executing) more blocks
        return Dataset(out)

    def unique(self, column: str) -> List[Any]:
        """Distinct values of one column (reference: Dataset.unique)."""
        seen: Dict[Any, None] = {}
        for t in self._iter_tables():
            for v in t.column(column).tolist():
                seen.setdefault(v, None)
        return list(seen)

    def zip(self, other: "Dataset") -> "Dataset":
        """Column-wise join of two equal-length datasets (reference:
        Dataset.zip); duplicate names from `other` get a _1 suffix."""
        a = block_util.concat_tables(self._tables())
        b = block_util.concat_tables(other._tables())
        if a.num_rows != b.num_rows:
            raise ValueError(
                f"zip needs equal row counts: {a.num_rows} vs "
                f"{b.num_rows}")
        cols = {c: a.column(c) for c in a.column_names}
        for c in b.column_names:
            name, i = c, 0
            while name in cols:     # first FREE suffix — never clobber
                i += 1
                name = f"{c}_{i}"
            cols[name] = b.column(c)
        return Dataset([ray_tpu_torch.put(block_util.Block(cols))])

    def show(self, limit: int = 20) -> None:
        """Print the first rows (reference: Dataset.show)."""
        for row in self.take(limit):
            print(row)

    # -- geometry ---------------------------------------------------------
    def repartition(self, num_blocks: int) -> "Dataset":
        tables = self._tables()
        big = block_util.concat_tables(tables)
        n = big.num_rows
        sizes = [(n + i) // num_blocks
                 for i in builtins.range(num_blocks)]
        refs, start = [], 0
        for s in sizes:
            refs.append(ray_tpu_torch.put(big.slice(start, s)))
            start += s
        return Dataset(refs)

    def split(self, n: int, *, equal: bool = True) -> List["Dataset"]:
        """Per-consumer shards (reference dataset.py:950; Train ingest
        path train/_internal/dataset_spec.py:66 get_dataset_shards)."""
        ds = self.materialize()
        if equal or len(ds._block_refs) % n:
            ds = ds.repartition(n)  # near-equal row counts per block
        per = len(ds._block_refs) // n
        return [Dataset(ds._block_refs[i * per:(i + 1) * per])
                for i in builtins.range(n)]

    def union(self, *others: "Dataset") -> "Dataset":
        ds = self.materialize()
        refs = list(ds._block_refs)
        for o in others:
            refs.extend(o.materialize()._block_refs)
        return Dataset(refs)

    def random_shuffle(self, *, seed: Optional[int] = None) -> "Dataset":
        """Distributed two-phase shuffle: rows mix across blocks via
        multi-return map tasks + per-partition reduce tasks; no block
        ever rides through the driver (reference:
        _internal/push_based_shuffle.py)."""
        from ray_tpu_torch.data import shuffle as shuffle_mod

        ds = self.materialize()
        n = max(1, len(ds._block_refs))
        # local permutation pass so rows also mix WITHIN output blocks
        shuffled = shuffle_mod.shuffle_blocks(ds._block_refs, n, seed)

        def perm_stage(table, _seed=seed):
            rng = np.random.RandomState(_seed)
            return table.take(rng.permutation(table.num_rows))

        return Dataset(shuffled, [perm_stage]).materialize()

    def sort(self, key: str, descending: bool = False) -> "Dataset":
        """Distributed sample-partitioned sort (reference: data sort_impl
        boundary sampling + per-range reduce)."""
        from ray_tpu_torch.data import shuffle as shuffle_mod

        ds = self.materialize()
        refs = shuffle_mod.sort_blocks(
            ds._block_refs, key, descending,
            max(1, len(ds._block_refs)))
        return Dataset(refs)

    def groupby(self, key: str) -> "GroupedDataset":
        """Hash-partitioned groupby (reference: data groupby —
        equal keys land in one block, aggregates run per block)."""
        return GroupedDataset(self, key)

    # -- consumption ------------------------------------------------------
    def count(self) -> int:
        return sum(t.num_rows for t in self._tables())

    def take(self, n: int = 20) -> List[Dict[str, Any]]:
        out: List[Dict[str, Any]] = []
        for t in self._tables():
            out.extend(t.to_pylist())
            if len(out) >= n:
                break
        return out[:n]

    def take_all(self) -> List[Dict[str, Any]]:
        return [r for t in self._tables() for r in t.to_pylist()]

    def schema(self) -> Optional[block_util.Schema]:
        """Column names with their numpy dtypes (and a tensor column's
        row shape): the port's ``block.Schema``."""
        if not self._block_refs:
            return None
        if self._stages:  # run the fused pipeline on ONE block only
            ref = _run_stages.remote(self._block_refs[0], self._stages)
            return ray_tpu_torch.get([ref], timeout=60)[0].schema
        return ray_tpu_torch.get([self._block_refs[0]], timeout=60)[0].schema

    @property
    def num_blocks(self) -> int:
        return len(self._block_refs)

    def iter_batches(self, *, batch_size: int = 256,
                     batch_format: str = "numpy",
                     drop_last: bool = False) -> Iterator:
        carry = None
        for t in self._iter_tables():
            if carry is not None and carry.num_rows:
                t = block_util.concat_tables([carry, t])
            start = 0
            while t.num_rows - start >= batch_size:
                yield block_util.format_batch(
                    t.slice(start, batch_size), batch_format)
                start += batch_size
            carry = t.slice(start)
        if carry is not None and carry.num_rows and not drop_last:
            yield block_util.format_batch(carry, batch_format)

    def _iter_tables(self) -> Iterator:
        """Streaming table iterator: pending stages execute through the
        bounded-in-flight, bytes-backpressured StreamingExecutor —
        batches flow while later blocks still compute, peak memory = the
        in-flight window, not the dataset (reference:
        streaming_executor.py).  Actor-pool compute streams through the
        SAME window over a pool of stage actors (reference:
        ActorPoolMapOperator) instead of a materialize barrier.  A FULL
        consumption leaves the dataset materialized (cached), same as
        materialize()."""
        if not self._stages:
            yield from self._tables()
            return
        from ray_tpu_torch.data.streaming import ExecStats, StreamingExecutor

        pool = None
        stages_ser = None
        if self._compute is not None:
            strat = self._compute
            cls = strat.actor_class()
            pool = [cls.remote() for _ in builtins.range(strat.size)]
            stages_ser = cloudpickle.dumps(self._stages)
        label = ("actor-pool" if pool is not None else "stream")
        stats = ExecStats(f"{label}[{len(self._stages)} fused stages]")
        out_refs = []
        try:
            for ref in StreamingExecutor().execute(
                    self._block_refs, self._stages, stats,
                    pool=pool, stages_ser=stages_ser):
                out_refs.append(ref)
                yield ray_tpu_torch.get([ref], timeout=600)[0]
        finally:
            if pool is not None:
                for a in pool:
                    try:
                        ray_tpu_torch.kill(a)
                    except Exception:  # noqa: BLE001
                        pass
        self._stats.append(stats)
        self._block_refs = out_refs  # fully consumed: cache in place
        self._stages = []
        self._compute = None

    def stats(self) -> str:
        """Execution summaries recorded on this dataset's lineage
        (reference: Dataset.stats / _internal/stats.py)."""
        if not self._stats:
            return "(no executions recorded)"
        return "\n".join(s.summary() for s in self._stats)

    def iter_torch_batches(self, *, batch_size: int = 256,
                           drop_last: bool = False,
                           dtypes: Optional[Dict[str, Any]] = None,
                           device=None, sharding=None) -> Iterator:
        """Batches as dicts of torch tensors on ``device``: the port's
        ingest bridge, in the role of the reference's
        ``iter_jax_batches`` (``ray_tpu/data/dataset.py:432``, the batch
        on the device) with the defaults of its ``iter_torch_batches``
        (``:464``: ``drop_last=False``, ``batch_size=256``).

        ``device=None`` resolves through ``device.resolve_device``: the
        first card, and RuntimeError where there is none; pass
        ``device="cpu"`` for host tensors.  A batch bound for the card is
        copied into pinned memory and sent without a host sync, so the
        copy queues behind the step that is still running (as
        ``jax.device_put`` does).  ``dtypes``: per-column torch dtypes,
        cast on the device after the copy.

        ``sharding`` (a ``parallel.sharding.NamedSharding``, e.g. over
        the mesh's batch axes) places every column as a DTensor: each
        rank of the mesh, iterating the same dataset, keeps its own
        block of the global batch (its rows), on the mesh's device (its
        card; the CPU for a gloo mesh; ``device`` is then unused), and
        nothing is sent.  The mesh train step takes such a batch as it
        is (``MeshPlan.local_batch`` reads the local block).  As a
        sharded ``jax.device_put``, a batch whose rows do not divide
        the shard count raises ValueError (a ragged last batch: pass
        ``drop_last=True``)."""
        if sharding is not None:
            yield from self._iter_sharded(batch_size, drop_last, dtypes,
                                          sharding)
            return
        import warnings

        import torch

        from ray_tpu_torch.device import resolve_device

        dev = resolve_device(device)
        for batch in self.iter_batches(batch_size=batch_size,
                                       batch_format="numpy",
                                       drop_last=drop_last):
            out = {}
            for k, v in batch.items():
                if not v.flags.writeable and dev.type == "cpu":
                    v = v.copy()  # a host tensor must not alias the store
                with warnings.catch_warnings():
                    # a read-only store view is only read: the copy to
                    # the card is the tensor the caller gets
                    warnings.filterwarnings(
                        "ignore", message="The given NumPy array is not "
                        "writable")
                    t = torch.as_tensor(v)
                if dev.type == "cuda":
                    t = t.pin_memory().to(dev, non_blocking=True)
                else:
                    t = t.to(dev)
                if dtypes and k in dtypes:
                    t = t.to(dtypes[k])
                out[k] = t
            yield out

    def _iter_sharded(self, batch_size, drop_last, dtypes, sharding):
        """``iter_torch_batches(sharding=...)``: each column a DTensor
        of this rank's block (see there)."""
        import torch

        from ray_tpu_torch.parallel.mesh import mesh_shape
        from ray_tpu_torch.parallel.sharding import distribute

        sizes = mesh_shape(sharding.mesh)
        for batch in self.iter_batches(batch_size=batch_size,
                                       batch_format="numpy",
                                       drop_last=drop_last):
            out = {}
            for k, v in batch.items():
                for dim, ax in enumerate(sharding.spec):
                    n = 1
                    for a in ((ax,) if isinstance(ax, str) else ax or ()):
                        n *= sizes[a]
                    if v.shape[dim] % n:
                        raise ValueError(
                            f"column {k!r} of shape {tuple(v.shape)} does "
                            f"not split evenly under {sharding.spec}: dim "
                            f"{dim} over {n} shards (a ragged last batch: "
                            f"pass drop_last=True)")
                t = torch.from_numpy(np.array(v))
                if dtypes and k in dtypes:
                    t = t.to(dtypes[k])
                out[k] = distribute(t, sharding)
            yield out

    def iter_rows(self) -> Iterator[Dict[str, Any]]:
        for t in self._iter_tables():
            yield from t.to_pylist()

    def to_pandas(self):
        """A pandas DataFrame (imports pandas)."""
        return block_util.concat_tables(self._tables()).to_pandas()

    def to_numpy_refs(self) -> List:
        ds = self.materialize()
        return list(ds._block_refs)

    def write_datasource(self, source, **write_args) -> None:
        """Fan blocks out to a Datasource's write_block tasks
        (reference: Dataset.write_datasource)."""
        from ray_tpu_torch.data.datasource import write_datasource

        write_datasource(self, source, **write_args)

    def write_parquet(self, path: str) -> None:
        import pyarrow.parquet as pq

        from ray_tpu_torch.data import filesystem as fs_mod

        for i, t in enumerate(self._tables()):
            fs, p = fs_mod.resolve(
                fs_mod.join(path, f"part-{i:05d}.parquet"))
            with fs.open_output(p) as f:
                pq.write_table(t.to_arrow(), f)

    # -- pipelining -------------------------------------------------------
    def window(self, *, blocks_per_window: int = 2) -> "DatasetPipeline":
        """Stream execution window-by-window (reference:
        data/dataset_pipeline.py — bounds memory to one window of
        blocks instead of the whole dataset)."""
        wins = [Dataset(self._block_refs[i:i + blocks_per_window],
                        list(self._stages), self._compute)
                for i in builtins.range(0, len(self._block_refs),
                                        blocks_per_window)]
        return DatasetPipeline(wins)

    def repeat(self, times: Optional[int] = None) -> "DatasetPipeline":
        return DatasetPipeline([self], repeat=times)

    def __repr__(self):
        return (f"Dataset(num_blocks={self.num_blocks}, "
                f"pending_stages={len(self._stages)})")


class DatasetPipeline:
    """A sequence of Dataset windows executed lazily, one window at a
    time (reference: data/dataset_pipeline.py DatasetPipeline)."""

    def __init__(self, windows: List[Dataset],
                 repeat: Optional[int] = 1):
        self._windows = windows
        self._repeat = repeat  # None = infinite

    def map_batches(self, fn, **kw) -> "DatasetPipeline":
        return DatasetPipeline([w.map_batches(fn, **kw)
                                for w in self._windows], self._repeat)

    def foreach_window(self, fn: Callable[[Dataset], Dataset]
                       ) -> "DatasetPipeline":
        return DatasetPipeline([fn(w) for w in self._windows],
                               self._repeat)

    def repeat(self, times: Optional[int] = None) -> "DatasetPipeline":
        return DatasetPipeline(self._windows, times)

    def iter_batches(self, **kw) -> Iterator:
        epoch = 0
        while self._repeat is None or epoch < self._repeat:
            for w in self._windows:
                # copy: window stages re-run each epoch only if unfused
                yield from Dataset(w._block_refs, list(w._stages),
                                   w._compute).iter_batches(**kw)
            epoch += 1

    def iter_epochs(self) -> Iterator[List[Dataset]]:
        epoch = 0
        while self._repeat is None or epoch < self._repeat:
            yield list(self._windows)
            epoch += 1

    def __repr__(self):
        return (f"DatasetPipeline(windows={len(self._windows)}, "
                f"repeat={self._repeat})")


class GroupedDataset:
    """Aggregations over hash-partitioned groups (reference:
    data/grouped_dataset.py)."""

    _AGGS = {
        "count": lambda v: len(v),
        "sum": lambda v: v.sum(),
        "mean": lambda v: v.mean(),
        "min": lambda v: v.min(),
        "max": lambda v: v.max(),
        "std": lambda v: v.std(),
    }

    def __init__(self, ds: Dataset, key: str):
        self._ds = ds
        self._key = key

    def _aggregate(self, agg: str, on: Optional[str]) -> Dataset:
        from ray_tpu_torch.data import shuffle as shuffle_mod

        ds = self._ds.materialize()
        n = max(1, len(ds._block_refs))
        parts = shuffle_mod.hash_partition_blocks(ds._block_refs,
                                                  self._key, n)
        key, fn = self._key, self._AGGS[agg]
        out_col = f"{agg}({on})" if on else agg

        def stage(table, _key=key, _on=on, _fn=fn, _out=out_col):
            rows: Dict[Any, List] = {}
            keys_col = table.column(_key).tolist()
            vals_col = table.column(_on) if _on \
                else np.zeros(len(keys_col))
            for k_, v_ in zip(keys_col, vals_col):
                rows.setdefault(k_, []).append(v_)
            return block_util.to_table({
                _key: list(rows),
                _out: [float(_fn(np.asarray(v)))
                       for v in rows.values()],
            })

        return Dataset(parts, [stage]).materialize()

    def count(self) -> Dataset:
        return self._aggregate("count", None)

    def sum(self, on: str) -> Dataset:
        return self._aggregate("sum", on)

    def mean(self, on: str) -> Dataset:
        return self._aggregate("mean", on)

    def min(self, on: str) -> Dataset:
        return self._aggregate("min", on)

    def max(self, on: str) -> Dataset:
        return self._aggregate("max", on)

    def std(self, on: str) -> Dataset:
        return self._aggregate("std", on)


# -- creation APIs ---------------------------------------------------------

def _split_rows(n_rows: int, parallelism: int) -> List[builtins.range]:
    per = max(1, n_rows // max(1, parallelism))
    return [builtins.range(i, min(i + per, n_rows))
            for i in builtins.range(0, n_rows, per)]


def from_items(items: Sequence[Any], *, parallelism: int = 8) -> Dataset:
    refs = []
    for rng in _split_rows(len(items), parallelism):
        chunk = [items[i] for i in rng]
        refs.append(ray_tpu_torch.put(block_util.to_table(chunk)))
    return Dataset(refs)


def range(n: int, *, parallelism: int = 8) -> Dataset:
    refs = [ray_tpu_torch.put(block_util.to_table(
        {"id": np.arange(r.start, r.stop, dtype=np.int64)}))
        for r in _split_rows(n, parallelism)]
    return Dataset(refs)


def from_numpy(arrays: Union[np.ndarray, Dict[str, np.ndarray]], *,
               parallelism: int = 8) -> Dataset:
    if isinstance(arrays, np.ndarray):
        arrays = {"value": arrays}
    n = len(next(iter(arrays.values())))
    refs = [ray_tpu_torch.put(block_util.to_table(
        {k: v[r.start:r.stop] for k, v in arrays.items()}))
        for r in _split_rows(n, parallelism)]
    return Dataset(refs)


def from_pandas(df, *, parallelism: int = 8) -> Dataset:
    """A pandas DataFrame's rows, split into blocks (imports pandas
    through the DataFrame handed in)."""
    return _from_block(block_util.to_table(df), parallelism)


def from_arrow(table, *, parallelism: int = 8) -> Dataset:
    """An arrow Table's rows, split into blocks (imports pyarrow)."""
    return _from_block(block_util.from_arrow_table(table), parallelism)


def _from_block(block, parallelism: int) -> Dataset:
    refs = [ray_tpu_torch.put(block.slice(r.start, r.stop - r.start))
            for r in _split_rows(block.num_rows, parallelism)]
    return Dataset(refs)


@ray_tpu_torch.remote
def _read_file_task(fmt: str, path: str):
    """One file -> one block, parsed INSIDE a task so reads parallelize
    across the cluster instead of serializing through the driver
    (reference: read tasks from read_api.py:227 read_datasource).
    The path resolves through the filesystem seam (local / kv:// /
    s3:// …, filesystem.py) — local paths must be readable on every
    node, like the reference's file-based datasources."""
    return _parse_file(fmt, path)


def _parse_file(fmt: str, path: str):
    from ray_tpu_torch.data import filesystem as fs_mod

    fs, p = fs_mod.resolve(path)
    if fmt == "parquet":
        import pyarrow.parquet as pq

        with fs.open_input(p) as f:
            return block_util.from_arrow_table(pq.read_table(f))
    if fmt == "csv":
        from pyarrow import csv as pa_csv

        with fs.open_input(p) as f:
            return block_util.from_arrow_table(pa_csv.read_csv(f))
    if fmt == "json":
        with fs.open_input(p) as f:
            return _json_block(f.read().decode())
    if fmt == "text":
        with fs.open_input(p) as f:
            lines = f.read().decode().splitlines()
        return block_util.to_table({"text": lines})
    if fmt == "numpy":
        import io as _io

        with fs.open_input(p) as f:
            arr = np.load(_io.BytesIO(f.read()))
        return block_util.to_table({"value": arr})
    raise ValueError(f"unknown format {fmt!r}")


def _json_block(text: str):
    """Newline-delimited JSON records as a block, columns in the order
    keys first appear and a key a record lacks read as None (pyarrow's
    json reader, without pyarrow)."""
    import json

    rows = [json.loads(line) for line in text.splitlines() if line.strip()]
    names: Dict[str, None] = {}
    for r in rows:
        names.update(dict.fromkeys(r))
    return block_util.Block({k: block_util._column_from_list(
        [r.get(k) for r in rows]) for k in names})


def _list_files(path: str, suffix: str) -> List[str]:
    from ray_tpu_torch.data import filesystem as fs_mod

    fs, p = fs_mod.resolve(path)
    files = fs.list(p, suffix)
    if not files:
        raise FileNotFoundError(f"no {suffix} files under {path}")
    # re-attach the scheme so worker-side resolve() routes the same way
    if "://" in path and "://" not in files[0]:
        scheme = path.split("://", 1)[0]
        files = [f"{scheme}://{f}" for f in files]
    return files


def _read_files(fmt: str, suffix: str, path: str) -> Dataset:
    """Shared body of the read_* helpers: list via the filesystem seam,
    parse per-file in remote tasks (driver-side for process-local
    mem:// paths, which workers cannot see)."""
    files = _list_files(path, suffix)
    if path.startswith("mem://"):
        return Dataset([ray_tpu_torch.put(_parse_file(fmt, f))
                        for f in files])
    return Dataset([_read_file_task.remote(fmt, f) for f in files])


def read_parquet(path: str) -> Dataset:
    return _read_files("parquet", ".parquet", path)


def read_csv(path: str) -> Dataset:
    return _read_files("csv", ".csv", path)


def read_json(path: str) -> Dataset:
    """Newline-delimited JSON records (reference: read_json)."""
    return _read_files("json", ".json", path)


def read_text(path: str) -> Dataset:
    """One row per line, column "text" (reference: read_text)."""
    return _read_files("text", ".txt", path)


def read_numpy(path: str) -> Dataset:
    """.npy files, column "value" (reference: read_numpy)."""
    return _read_files("numpy", ".npy", path)
