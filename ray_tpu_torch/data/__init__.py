"""Distributed datasets (reference analog: python/ray/data/).

The port's counterpart of ``ray_tpu/data/``.  Blocks are numpy-column
tables (``block.Block``; the path needs no pyarrow) living in
the object store as ObjectRefs; transforms build a lazy stage chain
that is FUSED into one remote task per block at execution (the
reference's ExecutionPlan stage fusion, data/_internal/plan.py:59,368).
``Dataset.iter_torch_batches`` lands batches on the card.  Importing
the package imports neither torch, pyarrow nor pandas.
"""

from ray_tpu_torch.data.dataset import (ActorPoolStrategy, Dataset,
                                        DatasetPipeline, GroupedDataset,
                                        from_arrow, from_items, from_numpy,
                                        from_pandas, range as range_,
                                        read_csv, read_json, read_numpy,
                                        read_parquet, read_text)
from ray_tpu_torch.data.datasource import (Datasource, FileDatasource,
                                           RangeDatasource, ReadTask,
                                           read_datasource)
from ray_tpu_torch.data.filesystem import (FileSystem, KVFileSystem,
                                           LocalFileSystem,
                                           MemoryFileSystem,
                                           register_filesystem)

# `range` shadows the builtin only inside this namespace, as in the
# reference's ray.data.range
range = range_

__all__ = ["Dataset", "DatasetPipeline", "GroupedDataset",
           "ActorPoolStrategy", "from_items", "from_numpy",
           "from_pandas", "from_arrow", "range", "read_parquet",
           "read_csv", "read_json", "read_text", "read_numpy",
           "Datasource", "ReadTask", "RangeDatasource",
           "FileDatasource", "read_datasource",
           "FileSystem", "LocalFileSystem", "MemoryFileSystem",
           "KVFileSystem", "register_filesystem"]
