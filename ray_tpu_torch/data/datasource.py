"""Datasource plugin API: custom parallel readers/writers.

Reference analog: data/datasource/datasource.py (Datasource /
ReadTask / write API).  A Datasource describes HOW to read a source as
independent tasks; ``read_datasource`` turns those into object-store
blocks (one remote task per ReadTask — streaming/fusion then apply like
any other dataset), and ``Dataset.write_datasource`` fans blocks out to
``write_block`` tasks.

A copy of ``ray_tpu/data/datasource.py`` over the port's numpy blocks:
a read task may return row dicts, a block or an arrow Table (converted
with pyarrow, imported only then); parquet and csv files are read and
written through pyarrow, imported when asked, json natively.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, List, Optional

import ray_tpu_torch
from ray_tpu_torch._private._vendor import cloudpickle
from ray_tpu_torch.data import block as block_util


class ReadTask:
    """One independently-executable read unit: a zero-arg callable
    returning an iterable of row-dicts (or a block), plus
    optional size metadata for scheduling."""

    def __init__(self, fn: Callable[[], Any],
                 num_rows: Optional[int] = None):
        self.fn = fn
        self.num_rows = num_rows

    def __call__(self):
        return self.fn()


class Datasource:
    """Implement ``get_read_tasks`` for reading; override
    ``write_block`` for writing."""

    def get_read_tasks(self, parallelism: int,
                       **read_args: Any) -> List[ReadTask]:
        raise NotImplementedError

    def write_block(self, block, task_index: int, **write_args) -> Any:
        raise NotImplementedError(
            f"{type(self).__name__} does not support writes")

    def on_write_complete(self, results: List[Any]) -> None:
        """Called on the driver after every block write finished."""


class FileDatasource(Datasource):
    """File-format datasource over the pluggable filesystem seam
    (reference: file_based_datasource.py:181 FileBasedDatasource — every
    path resolves through a filesystem, so local / kv:// / s3:// sources
    all flow through the same read/write tasks).

    ``fmt``: parquet | csv | json | text | numpy.
    """

    _SUFFIX = {"parquet": ".parquet", "csv": ".csv", "json": ".json",
               "text": ".txt", "numpy": ".npy"}

    def __init__(self, path: str, fmt: str = "parquet"):
        if fmt not in self._SUFFIX:
            raise ValueError(f"unknown format {fmt!r}")
        self.path = path
        self.fmt = fmt

    def get_read_tasks(self, parallelism: int,
                       **read_args: Any) -> List[ReadTask]:
        from ray_tpu_torch.data.dataset import _list_files, _parse_file

        files = _list_files(self.path, self._SUFFIX[self.fmt])
        fmt = self.fmt
        return [ReadTask(lambda f=f: _parse_file(fmt, f))
                for f in files]

    def write_block(self, block, task_index: int, **write_args) -> str:
        from ray_tpu_torch.data import filesystem as fs_mod

        out = fs_mod.join(self.path,
                          f"part-{task_index:05d}{self._SUFFIX[self.fmt]}")
        fs, p = fs_mod.resolve(out)
        if self.fmt == "parquet":
            import pyarrow.parquet as pq

            with fs.open_output(p) as f:
                pq.write_table(block.to_arrow(), f)
        elif self.fmt == "csv":
            from pyarrow import csv as pa_csv

            with fs.open_output(p) as f:
                pa_csv.write_csv(block.to_arrow(), f)
        elif self.fmt == "json":
            with fs.open_output(p) as f:
                import json as _json

                for row in block.to_pylist():
                    f.write((_json.dumps(row) + "\n").encode())
        else:
            raise ValueError(
                f"writes not supported for format {self.fmt!r}")
        return out


class RangeDatasource(Datasource):
    """Example/testing datasource: integers [0, n)."""

    def __init__(self, n: int):
        self.n = n

    def get_read_tasks(self, parallelism: int,
                       **read_args: Any) -> List[ReadTask]:
        per = -(-self.n // max(1, parallelism))
        tasks = []
        for lo in range(0, self.n, per):
            hi = min(lo + per, self.n)
            tasks.append(ReadTask(
                lambda lo=lo, hi=hi: [{"id": i} for i in range(lo, hi)],
                num_rows=hi - lo))
        return tasks


@ray_tpu_torch.remote
def _exec_read_task(task: ReadTask):
    out = task()
    if isinstance(out, block_util.Block) or \
            block_util._is_instance_of(out, "pyarrow", ("Table",)):
        return block_util.to_table(out)
    return block_util.to_table(list(out))


def read_datasource(source: Datasource, *, parallelism: int = 8,
                    **read_args) -> "Any":
    """Datasource → Dataset: one remote task per ReadTask; blocks land
    in the object store without routing through the driver."""
    from ray_tpu_torch.data.dataset import Dataset

    tasks = source.get_read_tasks(parallelism, **read_args)
    if not tasks:
        return Dataset([_exec_read_task.remote(
            ReadTask(lambda: []))])
    return Dataset([_exec_read_task.remote(t) for t in tasks])


def write_datasource(ds, source: Datasource, **write_args) -> None:
    """Dataset → Datasource: one write task per block."""
    @ray_tpu_torch.remote
    def _write(table, i, src_ser):
        src = cloudpickle.loads(src_ser)
        return src.write_block(table, i, **write_args)

    mat = ds.materialize()
    ser = cloudpickle.dumps(source)
    results = ray_tpu_torch.get(
        [_write.remote(b, i, ser)
         for i, b in enumerate(mat._block_refs)], timeout=600)
    source.on_write_complete(results)
