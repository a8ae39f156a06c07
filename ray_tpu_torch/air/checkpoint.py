"""Checkpoint: the universal training artifact.

Interconvertible dict ⇄ directory ⇄ object-store forms (reference analog:
python/ray/air/checkpoint.py:61 — same tri-form design, fresh
implementation).

A copy of ``ray_tpu/air/checkpoint.py`` for torch trees.  ``_to_host``
moves CUDA tensors to CPU tensors, where the reference fetches
``jax.Array`` leaves as numpy.  The directory form keeps the
reference's layout: one pickle of the dict, ``_ckpt_payload.pkl``, or
the packed files of a directory-native checkpoint.  A tensor leaf is
pickled as torch pickles it (its storage written by ``torch.save``),
so bf16, which numpy lacks, round-trips bit for bit; numpy arrays
and Python values are pickled as the reference pickles them, so a
directory the JAX package wrote from a tree of numpy arrays reads
here, and weights cross over through AIR.
"""

from __future__ import annotations

import os
import pickle
import shutil
import sys
import tempfile
import uuid
from typing import Any, Dict, Optional

_DICT_FILE = "_ckpt_payload.pkl"
_FILES_KEY = "_packed_files"


def _to_host(tree):
    """CUDA tensor leaves (in nested dicts, lists and tuples) → CPU
    tensors, detached; every other leaf passes through.  Without torch
    imported no tensor can exist, so the walk is skipped."""
    torch = sys.modules.get("torch")
    if torch is None:
        return tree

    def walk(x):
        if isinstance(x, torch.Tensor):
            return x.detach().cpu() if x.device.type != "cpu" else x.detach()
        if isinstance(x, dict):
            return {k: walk(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(walk(v) for v in x)
        return x

    return walk(tree)


class Checkpoint:
    """One of: in-memory dict, local directory, or object-store ref.

    Conversions materialize lazily; repeated to_dict()/to_directory() on
    the same instance reuse the existing form.
    """

    def __init__(self, *, _data: Optional[Dict[str, Any]] = None,
                 _path: Optional[str] = None, _ref=None):
        forms = sum(x is not None for x in (_data, _path, _ref))
        if forms != 1:
            raise ValueError("construct via from_dict / from_directory / "
                             "from_object_ref")
        self._data = _data
        self._path = _path
        self._ref = _ref
        self.id = uuid.uuid4().hex[:16]

    # -- constructors -----------------------------------------------------
    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "Checkpoint":
        if not isinstance(data, dict):
            raise TypeError("checkpoint data must be a dict")
        return cls(_data=_to_host(data))

    @classmethod
    def from_directory(cls, path: str) -> "Checkpoint":
        if not os.path.isdir(path):
            raise FileNotFoundError(path)
        return cls(_path=os.path.abspath(path))

    @classmethod
    def from_object_ref(cls, ref) -> "Checkpoint":
        return cls(_ref=ref)

    # -- conversions ------------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        if self._data is not None:
            return self._data
        if self._ref is not None:
            import ray_tpu_torch

            self._data = ray_tpu_torch.get(self._ref)
            return self._data
        payload = os.path.join(self._path, _DICT_FILE)
        if os.path.exists(payload):
            with open(payload, "rb") as f:
                self._data = pickle.load(f)
        else:  # directory-native checkpoint: pack file contents so the
            # dict form is self-contained across process/node boundaries
            files: Dict[str, bytes] = {}
            for root, _, names in os.walk(self._path):
                for name in names:
                    full = os.path.join(root, name)
                    rel = os.path.relpath(full, self._path)
                    with open(full, "rb") as f:
                        files[rel] = f.read()
            self._data = {_FILES_KEY: files}
        return self._data

    def to_directory(self, path: Optional[str] = None) -> str:
        if path is None:
            path = os.path.join(tempfile.gettempdir(),
                                f"raytpu_torch_ckpt_{self.id}")
        os.makedirs(path, exist_ok=True)
        if self._path is not None:
            if os.path.abspath(path) != self._path:
                shutil.copytree(self._path, path, dirs_exist_ok=True)
            return path
        data = self.to_dict()
        if set(data) == {_FILES_KEY}:  # packed directory checkpoint
            for rel, blob in data[_FILES_KEY].items():
                full = os.path.join(path, rel)
                os.makedirs(os.path.dirname(full) or path, exist_ok=True)
                with open(full, "wb") as f:
                    f.write(blob)
        else:
            with open(os.path.join(path, _DICT_FILE), "wb") as f:
                pickle.dump(data, f)
        return path

    def to_object_ref(self):
        if self._ref is None:
            import ray_tpu_torch

            self._ref = ray_tpu_torch.put(self.to_dict())
        return self._ref

    # -- plumbing ---------------------------------------------------------
    def __reduce__(self):
        # Ship as dict form (directory-form checkpoints pack their file
        # contents into the dict, so the bytes travel with the object).
        return (_rebuild_checkpoint, (self.to_dict(), self.id))

    def __repr__(self):
        form = ("dict" if self._data is not None else
                "directory" if self._path is not None else "object_ref")
        return f"Checkpoint(id={self.id}, form={form})"


def _rebuild_checkpoint(data, cid):
    c = Checkpoint.from_dict(data)
    c.id = cid
    return c
