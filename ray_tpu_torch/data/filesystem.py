"""Pluggable filesystem seam under Data IO and spill.

Reference analog: the pyarrow-filesystem plumbing of
``data/datasource/file_based_datasource.py:181`` (every reader/writer
takes a ``filesystem``) and the smart_open/remote spill path of
``_private/external_storage.py:445``.

Paths carry their scheme: ``/x`` or ``file:///x`` → local disk,
``mem://bucket/x`` → in-process memory store (unit tests),
``kv://x`` → the cluster KV (a REAL remote scheme inside any running
cluster: readable/writable from every worker, no external service
needed), and ``s3:// gs:// hdfs://`` delegate to ``pyarrow.fs`` when
its bindings are available.  ``register_filesystem`` adds schemes —
the plugin hook mirroring the reference's fsspec registry.

A copy of ``ray_tpu/data/filesystem.py`` on the port's runtime
(``kv://`` goes through the port's GCS).  ``pyarrow.fs`` is imported
only when a cloud scheme is resolved.
"""

from __future__ import annotations

import io
import os
import posixpath
from typing import Callable, Dict, List, Optional, Tuple

_REGISTRY: Dict[str, Callable[[], "FileSystem"]] = {}


def register_filesystem(scheme: str,
                        factory: Callable[[], "FileSystem"]) -> None:
    """Plugin hook: map ``scheme://`` paths to a FileSystem factory."""
    _REGISTRY[scheme] = factory


def resolve(path: str) -> Tuple["FileSystem", str]:
    """Split a path into (filesystem, scheme-less path)."""
    if "://" not in path:
        return LocalFileSystem(), path
    scheme, rest = path.split("://", 1)
    if scheme == "file":
        return LocalFileSystem(), "/" + rest.lstrip("/")
    if scheme in _REGISTRY:
        return _REGISTRY[scheme](), rest
    if scheme == "mem":
        return MemoryFileSystem(), rest
    if scheme == "kv":
        return KVFileSystem(), rest
    # cloud schemes: the ArrowFileSystem binds the full URI at
    # construction; the path operand is the URI itself
    return ArrowFileSystem(path), path


class FileSystem:
    """Minimal surface every backend implements; binary IO only."""

    def open_input(self, path: str):
        raise NotImplementedError

    def open_output(self, path: str):
        raise NotImplementedError

    def list(self, path: str, suffix: str = "") -> List[str]:
        """Files under ``path`` (or [path] if it names a file)."""
        raise NotImplementedError

    def delete(self, path: str) -> None:
        raise NotImplementedError

    def exists(self, path: str) -> bool:
        raise NotImplementedError

    def size(self, path: str) -> Optional[int]:
        """Object size in bytes without reading the payload where the
        backend allows; None if absent.  Default falls back to a full
        read — override where metadata is cheap."""
        try:
            with self.open_input(path) as f:
                return len(f.read())
        except FileNotFoundError:
            return None

    def list_tree(self, path: str) -> List[str]:
        """Every file under ``path`` recursively (sync/restore walks).
        Flat-keyed backends (kv/mem) already list recursively."""
        return self.list(path)


class LocalFileSystem(FileSystem):
    def open_input(self, path: str):
        return open(path, "rb")

    def open_output(self, path: str):
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        return open(path, "wb")

    def list(self, path: str, suffix: str = "") -> List[str]:
        if os.path.isdir(path):
            return sorted(
                os.path.join(path, f) for f in os.listdir(path)
                if f.endswith(suffix))
        return [path] if os.path.exists(path) else []

    def delete(self, path: str) -> None:
        try:
            os.unlink(path)
        except OSError:
            pass

    def exists(self, path: str) -> bool:
        return os.path.exists(path)

    def size(self, path: str) -> Optional[int]:
        try:
            return os.path.getsize(path)
        except OSError:
            return None

    def list_tree(self, path: str) -> List[str]:
        if not os.path.isdir(path):
            return [path] if os.path.exists(path) else []
        out = []
        for root, _dirs, files in os.walk(path):
            out.extend(os.path.join(root, f) for f in files)
        return sorted(out)


class _MemFile(io.BytesIO):
    """Write buffer that commits atomically on CLEAN close — an
    exception inside a ``with`` block discards the partial write
    instead of publishing a truncated object (parity with the local
    path's tmp+rename atomicity)."""

    def __init__(self, commit: Callable[[bytes], None]):
        super().__init__()
        self._commit = commit
        self._failed = False

    def __exit__(self, exc_type, exc, tb):
        self._failed = exc_type is not None
        return super().__exit__(exc_type, exc, tb)

    def discard(self):
        self._failed = True
        super().close()

    def close(self):
        if not self.closed and not self._failed:
            self._commit(self.getvalue())
        super().close()


#: process-global store backing mem:// (unit tests / single-process)
_MEM: Dict[str, bytes] = {}


class MemoryFileSystem(FileSystem):
    """In-process bytes store — the mockable 'remote' backend for tests
    (deterministic, inspectable, no disk)."""

    def open_input(self, path: str):
        if path not in _MEM:
            raise FileNotFoundError(f"mem://{path}")
        return io.BytesIO(_MEM[path])

    def open_output(self, path: str):
        return _MemFile(lambda data: _MEM.__setitem__(path, data))

    def list(self, path: str, suffix: str = "") -> List[str]:
        if path in _MEM:
            return [path]
        prefix = path.rstrip("/") + "/"
        return sorted(k for k in _MEM
                      if k.startswith(prefix) and k.endswith(suffix))

    def delete(self, path: str) -> None:
        _MEM.pop(path, None)

    def exists(self, path: str) -> bool:
        return path in _MEM or bool(self.list(path))

    def size(self, path: str) -> Optional[int]:
        data = _MEM.get(path)
        return None if data is None else len(data)


class KVFileSystem(FileSystem):
    """Cluster-KV-backed filesystem: a genuinely remote scheme inside a
    running cluster — every worker reads/writes through the GCS, so
    read tasks and spill work across processes with zero external
    dependencies.  Sized for metadata/modest blocks, not bulk data
    (the KV is in the GCS's memory)."""

    _PREFIX = "fs/"

    def _cw(self):
        from ray_tpu_torch._private import worker_context

        return worker_context.core_worker()

    def open_input(self, path: str):
        raw = self._cw().kv_get(self._PREFIX + path)
        if raw is None:
            raise FileNotFoundError(f"kv://{path}")
        return io.BytesIO(raw)

    def open_output(self, path: str):
        cw = self._cw()
        return _MemFile(
            lambda data: cw.kv_put(self._PREFIX + path, data))

    def list(self, path: str, suffix: str = "") -> List[str]:
        cw = self._cw()
        keys = cw.kv_keys(self._PREFIX + path)
        out = []
        for k in keys:
            rel = k[len(self._PREFIX):]
            if rel == path or (rel.startswith(path.rstrip("/") + "/")
                               and rel.endswith(suffix)):
                out.append(rel)
        return sorted(out)

    def delete(self, path: str) -> None:
        self._cw().kv_del(self._PREFIX + path)

    def exists(self, path: str) -> bool:
        return self._cw().kv_len(self._PREFIX + path) is not None

    def size(self, path: str) -> Optional[int]:
        # metadata-only: a spill stats poll must not move payloads
        # through the control plane
        return self._cw().kv_len(self._PREFIX + path)


class ArrowFileSystem(FileSystem):
    """Cloud schemes (s3:// gs:// hdfs://) through pyarrow.fs —
    the reference's own remote-IO engine (file_based_datasource.py
    resolves paths with pyarrow filesystems the same way).  Import-
    gated: raises a clear error when the bindings are absent.

    The backend client is constructed once from the URI; every method
    takes a scheme-less operand path (as ``resolve`` hands out), so one
    cached instance serves a whole directory of objects — e.g. the
    spill manager's per-object reads never rebuild an S3 client."""

    def __init__(self, uri: str):
        try:
            from pyarrow import fs as pafs
        except ImportError as e:  # pragma: no cover
            raise ImportError(
                f"pyarrow.fs is required for {uri!r}") from e
        try:
            self._fs, self._base = pafs.FileSystem.from_uri(uri)
        except Exception as e:
            raise ValueError(
                f"cannot resolve filesystem for {uri!r}: {e}") from e
        self._scheme = uri.split("://", 1)[0]

    def _op(self, path: str) -> str:
        if "://" in path:  # full URI passed through resolve()
            return path.split("://", 1)[1]
        return path or self._base

    def open_input(self, path: str):
        # open_input_file (seekable): parquet needs random access for
        # the footer, and spill range reads seek
        return self._fs.open_input_file(self._op(path))

    def open_output(self, path: str):
        return self._fs.open_output_stream(self._op(path))

    def list(self, path: str, suffix: str = "") -> List[str]:
        from pyarrow import fs as pafs

        base = self._op(path)
        info = self._fs.get_file_info(base)
        if info.type == pafs.FileType.File:
            return [f"{self._scheme}://{base}"]
        sel = pafs.FileSelector(base, recursive=False,
                                allow_not_found=True)
        # re-prefix the scheme so each listed path resolves back here
        return sorted(f"{self._scheme}://{f.path}"
                      for f in self._fs.get_file_info(sel)
                      if f.type == pafs.FileType.File
                      and f.path.endswith(suffix))

    def delete(self, path: str) -> None:
        self._fs.delete_file(self._op(path))

    def exists(self, path: str) -> bool:
        from pyarrow import fs as pafs

        return (self._fs.get_file_info(self._op(path)).type
                != pafs.FileType.NotFound)

    def size(self, path: str) -> Optional[int]:
        from pyarrow import fs as pafs

        info = self._fs.get_file_info(self._op(path))
        return None if info.type == pafs.FileType.NotFound else info.size

    def list_tree(self, path: str) -> List[str]:
        from pyarrow import fs as pafs

        base = self._op(path)
        info = self._fs.get_file_info(base)
        if info.type == pafs.FileType.File:
            return [f"{self._scheme}://{base}"]
        sel = pafs.FileSelector(base, recursive=True,
                                allow_not_found=True)
        return sorted(f"{self._scheme}://{f.path}"
                      for f in self._fs.get_file_info(sel)
                      if f.type == pafs.FileType.File)


def join(base: str, *parts: str) -> str:
    """Scheme-aware path join (posix semantics for remote schemes)."""
    if "://" in base:
        scheme, rest = base.split("://", 1)
        return f"{scheme}://{posixpath.join(rest, *parts)}"
    return os.path.join(base, *parts)
