"""Blocks of the port's Data layer: named columns of numpy arrays.

Counterpart of ``ray_tpu/data/block.py``, whose block is a
``pyarrow.Table``.  So that the port's data path needs neither
pyarrow nor pandas, a block here is a :class:`Block`: an ordered dict
of numpy arrays of equal length, with the part of the Table API that
``dataset.py``, ``shuffle.py`` and ``streaming.py`` use (``num_rows``,
``column_names``, ``column``, ``slice``, ``take``, ``select``,
``drop_columns``, ``rename_columns``, ``sort_by``, ``to_pylist``,
``nbytes``, ``schema``).  Where pyarrow raises, a block raises the
same class of error (``ArrowInvalid`` is a ValueError, a missing field
a KeyError); where it returns, a block returns the same rows.

Column types: numbers and booleans are 1-D numpy arrays; strings,
bytes, None-bearing and nested values are object arrays (pyarrow's
``string``, ``binary``, nullable and ``list``/``struct`` columns); an
N-D array is a tensor column (the reference's ``FixedSizeList``
encoding, ``block.py:12-31``): rows keep their shape.  A block pickles
as its arrays, so the object store carries numeric columns as
out-of-band pickle-5 buffers.

``format_batch`` gives the reference's ``"numpy"``/``"dict"``/
``"default"`` batches.  The ``"pandas"`` and ``"pyarrow"`` formats and
``to_table`` of a ``DataFrame`` or an arrow ``Table`` import pandas or
pyarrow when asked, and raise the ImportError of that import where the
package is missing.
"""

from __future__ import annotations

import sys
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np


class Schema:
    """Column names with their numpy dtypes, and for a tensor column the
    shape of one row (the port's counterpart of ``pyarrow.Schema``)."""

    def __init__(self, names: Sequence[str], types: Sequence[np.dtype],
                 shapes: Sequence[Tuple[int, ...]]):
        self.names = list(names)
        self.types = list(types)
        self.shapes = list(shapes)

    def __eq__(self, other) -> bool:
        return (isinstance(other, Schema) and self.names == other.names
                and self.types == other.types and self.shapes == other.shapes)

    def __repr__(self) -> str:
        return "\n".join(
            f"{n}: {t}" + (f"{list(s)}" if s else "")
            for n, t, s in zip(self.names, self.types, self.shapes))


class Block:
    """A table of named numpy columns of equal length."""

    def __init__(self, cols: Optional[Dict[str, np.ndarray]] = None):
        cols = dict(cols or {})
        lens = [len(v) for v in cols.values()]
        if lens and any(n != lens[0] for n in lens):
            names = list(cols)
            bad = next(i for i, n in enumerate(lens) if n != lens[0])
            raise ValueError(f"Column {bad} named {names[bad]} expected "
                             f"length {lens[0]} but got length {lens[bad]}")
        self._cols = cols

    # -- shape ------------------------------------------------------------
    @property
    def num_rows(self) -> int:
        return len(next(iter(self._cols.values()))) if self._cols else 0

    @property
    def column_names(self) -> List[str]:
        return list(self._cols)

    @property
    def columns(self) -> List[np.ndarray]:
        return list(self._cols.values())

    def column(self, name: str) -> np.ndarray:
        if name not in self._cols:
            raise KeyError(f'Field "{name}" does not exist in schema')
        return self._cols[name]

    @property
    def schema(self) -> Schema:
        return Schema(self._cols, [v.dtype for v in self._cols.values()],
                      [tuple(v.shape[1:]) for v in self._cols.values()])

    @property
    def nbytes(self) -> int:
        total = 0
        for v in self._cols.values():
            total += v.nbytes
            if v.dtype == object:
                total += sum(len(x) for x in v.tolist()
                             if isinstance(x, (str, bytes)))
        return total

    # -- rows -------------------------------------------------------------
    def slice(self, offset: int = 0, length: Optional[int] = None
              ) -> "Block":
        """Rows [offset, offset + length): views, no copy."""
        stop = None if length is None else offset + length
        return Block({k: v[offset:stop] for k, v in self._cols.items()})

    def take(self, indices) -> "Block":
        idx = np.asarray(indices, dtype=np.int64)
        return Block({k: v[idx] for k, v in self._cols.items()})

    def sort_indices(self, key: str, descending: bool = False
                     ) -> np.ndarray:
        """A stable order of the rows by ``key`` (pyarrow's
        ``sort_indices``: equal keys keep their order either way)."""
        col = self.column(key)
        if not descending:
            return np.argsort(col, kind="stable")
        n = len(col)
        return (n - 1 - np.argsort(col[::-1], kind="stable"))[::-1]

    def sort_by(self, sorting) -> "Block":
        if isinstance(sorting, str):
            sorting = [(sorting, "ascending")]
        if len(sorting) != 1:
            raise NotImplementedError("sort_by takes one key")
        key, order = sorting[0]
        return self.take(self.sort_indices(key, order == "descending"))

    # -- columns ----------------------------------------------------------
    def select(self, names: Iterable[str]) -> "Block":
        return Block({n: self.column(n) for n in names})

    def drop_columns(self, names: Iterable[str]) -> "Block":
        names = list(names)
        for n in names:
            if n not in self._cols:
                raise KeyError(f"Column '{n}' not found")
        return Block({k: v for k, v in self._cols.items()
                      if k not in names})

    def rename_columns(self, names: Sequence[str]) -> "Block":
        names = list(names)
        if len(names) != len(self._cols):
            raise ValueError(
                f"tried to rename a table of {len(self._cols)} columns but "
                f"only {len(names)} names were provided")
        return Block(dict(zip(names, self._cols.values())))

    # -- conversions ------------------------------------------------------
    def to_pydict(self) -> Dict[str, List[Any]]:
        return {k: v.tolist() for k, v in self._cols.items()}

    def to_pylist(self) -> List[Dict[str, Any]]:
        cols = self.to_pydict()
        names = list(cols)
        return [dict(zip(names, row)) for row in zip(*cols.values())] \
            if names else []

    def to_pandas(self):
        import pandas as pd

        return pd.DataFrame({k: (v if v.ndim == 1 else list(v))
                             for k, v in self._cols.items()})

    def to_arrow(self):
        import pyarrow as pa

        return pa.table({k: _arrow_column(v) for k, v in self._cols.items()})

    def __eq__(self, other) -> bool:
        return (isinstance(other, Block)
                and self.column_names == other.column_names
                and all(np.array_equal(a, b) and a.dtype == b.dtype
                        for a, b in zip(self.columns, other.columns)))

    def __repr__(self) -> str:
        return f"Block({self.num_rows} rows; {self.schema!r})"


# -- construction -----------------------------------------------------------

def _object_array(values: Sequence[Any]) -> np.ndarray:
    out = np.empty(len(values), dtype=object)
    for i, v in enumerate(values):
        out[i] = v
    return out


def _column_from_list(values: Sequence[Any]) -> np.ndarray:
    """A column from Python values, typed as ``pa.array`` types them:
    bools, int64, float64 (ints and floats mixed), and objects for
    strings, bytes, nested values and columns holding None.  Mixed kinds
    pyarrow cannot unify raise ValueError, as its ArrowInvalid does."""
    kinds = set()
    for v in values:
        if v is None:
            kinds.add("null")
        elif isinstance(v, (bool, np.bool_)):
            kinds.add("bool")
        elif isinstance(v, (int, np.integer)):
            kinds.add("int")
        elif isinstance(v, (float, np.floating)):
            kinds.add("float")
        elif isinstance(v, str):
            kinds.add("str")
        elif isinstance(v, bytes):
            kinds.add("bytes")
        else:
            kinds.add("nested")
    if kinds == {"bool"}:
        return np.array(values, dtype=bool)
    if kinds == {"int"}:
        return np.array(values, dtype=np.int64)
    if kinds == {"int", "float"} or kinds == {"float"}:
        return np.array(values, dtype=np.float64)
    present = kinds - {"null"}
    if len(present) > 1 and not present <= {"int", "float"}:
        raise ValueError(f"Could not convert {list(values)[:4]!r}... to one "
                         f"column type: it mixes {sorted(present)}")
    return _object_array(values)


def _column(v) -> np.ndarray:
    """A column from a batch's value: numpy arrays keep their dtype
    (unicode and bytes arrays become object arrays, as pyarrow makes
    them string and binary columns), lists are typed by
    ``_column_from_list``."""
    if isinstance(v, (list, tuple)):
        return _column_from_list(v)
    arr = np.asarray(v)
    if arr.ndim == 0:
        raise TypeError(f"a column must be a sequence, not {type(v)}")
    if arr.dtype.kind in "US":
        return _object_array(arr.tolist()) if arr.ndim == 1 else arr
    return arr


def _is_instance_of(data, module: str, names: Tuple[str, ...]) -> bool:
    """Whether ``data`` is one of ``module``'s ``names``, without
    importing the module: an object of a module that was never imported
    cannot exist."""
    mod = sys.modules.get(module)
    return mod is not None and any(
        isinstance(data, getattr(mod, n)) for n in names if hasattr(mod, n))


def from_arrow_table(table) -> Block:
    """An arrow Table (or RecordBatch) as a block: FixedSizeList columns
    back to their N-D numpy shape, the rest through ``to_numpy``."""
    import pyarrow as pa

    out = {}
    for name, col in zip(table.column_names, table.columns):
        if isinstance(col, pa.ChunkedArray):
            col = col.combine_chunks()
        if pa.types.is_fixed_size_list(col.type):
            dims, inner, flat = [], col.type, col
            while pa.types.is_fixed_size_list(inner):
                dims.append(inner.list_size)
                inner = inner.value_type
            while pa.types.is_fixed_size_list(flat.type):
                flat = flat.flatten()
            out[name] = flat.to_numpy(zero_copy_only=False).reshape(
                (len(col), *dims))
        else:
            arr = col.to_numpy(zero_copy_only=False)
            # nested values as Python lists, as to_pylist gives them
            out[name] = arr if arr.dtype != object else _object_array(
                col.to_pylist())
    return Block(out)


def _densify(x):
    """An object array whose items are arrays of one shape and dtype (at
    any depth: pyarrow's ``to_pandas`` nests a tensor row as arrays of
    arrays) as one N-D array; anything else as it is."""
    if not (isinstance(x, np.ndarray) and x.dtype == object and len(x)
            and all(isinstance(e, np.ndarray) for e in x)):
        return x
    parts = [_densify(e) for e in x]
    if any(p.dtype == object or p.shape != parts[0].shape
           or p.dtype != parts[0].dtype for p in parts):
        return x
    return np.stack(parts)


def _from_pandas(df) -> Block:
    """A DataFrame as a block; a column of equal-shape arrays (what
    ``to_pandas`` makes of a tensor column) becomes a tensor column."""
    return Block({str(k): _column(_densify(df[k].to_numpy()))
                  for k in df.columns})


def _tensor_array(arr: np.ndarray):
    """N-D numpy column -> nested FixedSizeList arrow array (as the
    reference's ``_tensor_array``)."""
    import pyarrow as pa

    flat = pa.array(arr.reshape(-1))
    for dim in reversed(arr.shape[1:]):
        flat = pa.FixedSizeListArray.from_arrays(flat, dim)
    return flat


def _arrow_column(arr: np.ndarray):
    import pyarrow as pa

    if arr.ndim > 1:
        return _tensor_array(arr)
    return pa.array(arr.tolist() if arr.dtype == object else arr)


def to_table(data) -> Block:
    """A block from what a user or a transform hands over: a block, a
    dict of columns, a numpy array (column ``"value"``), a list of row
    dicts (uneven keys raise, as ``pa.table`` does) or of values
    (column ``"value"``), a pandas DataFrame or an arrow Table."""
    if isinstance(data, Block):
        return data
    if isinstance(data, dict):
        return Block({k: _column(v) for k, v in data.items()})
    if isinstance(data, np.ndarray):
        return Block({"value": _column(data)})
    if isinstance(data, list):
        if data and isinstance(data[0], dict):
            cols: Dict[str, List[Any]] = {}
            for row in data:
                for k, v in row.items():
                    cols.setdefault(k, []).append(v)
            return Block({k: _column_from_list(v) for k, v in cols.items()})
        return Block({"value": _column_from_list(data)})
    if _is_instance_of(data, "pandas", ("DataFrame",)):
        return _from_pandas(data)
    if _is_instance_of(data, "pyarrow", ("Table", "RecordBatch")):
        return from_arrow_table(data)
    raise TypeError(f"cannot make a block from {type(data)}")


def format_batch(block: Block, batch_format: str):
    if batch_format in ("pyarrow", "arrow"):
        return block.to_arrow()
    if batch_format == "pandas":
        return block.to_pandas()
    if batch_format in ("numpy", "dict", "default"):
        return dict(zip(block.column_names, block.columns))
    raise ValueError(f"unknown batch_format {batch_format!r}")


def concat_tables(blocks: Sequence[Block]) -> Block:
    """Rows of every non-empty block in order.  Blocks whose columns or
    column types differ raise ValueError, as ``pa.concat_tables`` does
    (a column holding None, an object column, joins any other)."""
    blocks = [b for b in blocks if b.num_rows]
    if not blocks:
        return Block({})
    if len(blocks) == 1:
        return blocks[0]
    first = blocks[0]
    for i, b in enumerate(blocks[1:], 1):
        if b.column_names != first.column_names or any(
                not _joinable(x, y) for x, y in zip(first.columns, b.columns)):
            raise ValueError(f"Schema at index {i} was different: \n"
                             f"{first.schema!r}\nvs\n{b.schema!r}")
    return Block({name: np.concatenate([b.column(name) for b in blocks])
                  for name in first.column_names})


def _joinable(a: np.ndarray, b: np.ndarray) -> bool:
    if a.shape[1:] != b.shape[1:]:
        return False
    return a.dtype == b.dtype or object in (a.dtype, b.dtype)
