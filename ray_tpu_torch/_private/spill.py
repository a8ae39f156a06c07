"""Object spilling: overflow shared-memory objects to local disk.

Role-equivalent of the reference's spill pipeline — the raylet's
LocalObjectManager picking spill victims (reference
``src/ray/raylet/local_object_manager.h:41``, ``:206 SpillObjectsOfSize``)
driving the Python filesystem backend (reference
``python/ray/_private/external_storage.py:72 ExternalStorage``, ``:246``
filesystem impl).  Collapsed design: any store client that hits
ObjectStoreFull spills LRU victims itself (one file per object, atomic
rename), and readers fall back to the spill directory on a store miss.
The spill directory is node-local and shared by every process on the node
(handed out by the node manager at registration, like the object store
name).

A copy of ``ray_tpu/_private/spill.py``: a URI target (``kv://``,
``mem://``, ``s3://``) goes through the port's Data filesystem seam
(``ray_tpu_torch/data/filesystem.py``).
"""

from __future__ import annotations

import logging
import os
import tempfile
from typing import List, Optional, Tuple

from ray_tpu_torch._private.ids import ObjectID
from ray_tpu_torch._private.object_store import ObjectStoreClient

logger = logging.getLogger(__name__)


class SpillManager:
    """Per-process handle on the node's spill directory.

    A plain path spills to node-local disk (mkstemp + atomic rename,
    seekable range reads).  A scheme'd path (``kv://spill``,
    ``mem://…``, ``s3://bucket/spill``) routes through the Data
    filesystem seam instead — the collapsed analog of the reference's
    smart_open remote spill (external_storage.py:445): same
    object-per-file layout, remote bytes."""

    def __init__(self, store: ObjectStoreClient, spill_dir: str):
        self.store = store
        self.dir = spill_dir
        self._ensured = False
        self._remote = "://" in (spill_dir or "")
        #: resolved-once backend for remote schemes (cloud backends are
        #: expensive to construct; never re-resolve on the read path)
        self._fs_cached = None

    @property
    def enabled(self) -> bool:
        return bool(self.dir)

    @property
    def is_remote(self) -> bool:
        return self._remote

    def _fs(self):
        if self._fs_cached is None:
            from ray_tpu_torch.data import filesystem as fs_mod

            self._fs_cached = fs_mod.resolve(self.dir)[0]
        return self._fs_cached

    def _path(self, oid: bytes) -> str:
        if self._remote:
            from ray_tpu_torch.data.filesystem import join

            # scheme-less operand for the cached backend
            return join(self.dir.split("://", 1)[1], oid.hex())
        return os.path.join(self.dir, oid.hex())

    def _ensure_dir(self):
        if not self._remote and not self._ensured:
            os.makedirs(self.dir, exist_ok=True)
            self._ensured = True

    # -- write path --------------------------------------------------------

    def spill(self, nbytes: int) -> int:
        """Move >= nbytes of LRU objects from shm to disk; returns bytes
        freed (0 when nothing could be spilled)."""
        if not self.enabled:
            return 0
        self._ensure_dir()
        freed = 0
        for oid, size in self.store.lru_candidates(nbytes):
            if self._spill_one(oid):
                freed += size
        return freed

    def _spill_one(self, oid: ObjectID) -> bool:
        buf = self.store.get(oid, timeout_ms=0)
        if buf is None:
            return False  # raced with eviction/delete
        try:
            with buf:
                if self._remote:
                    with self._fs().open_output(
                            self._path(oid.binary())) as f:
                        f.write(bytes(buf.data))
                        f.write(bytes(buf.metadata))
                else:
                    fd, tmp = tempfile.mkstemp(dir=self.dir,
                                               suffix=".tmp")
                    try:
                        with os.fdopen(fd, "wb") as f:
                            f.write(buf.data)
                            f.write(buf.metadata)
                        os.rename(tmp, self._path(oid.binary()))
                    except BaseException:
                        try:
                            os.unlink(tmp)
                        except OSError:
                            pass
                        raise
        except Exception as e:  # noqa: BLE001 - remote backends raise
            # their own error types; a failed spill must never crash the
            # allocation path, only report 0 bytes freed
            logger.warning("spill of %s failed: %s", oid, e)
            return False
        self.store.delete(oid)
        return True

    def write_direct(self, oid: bytes, payload: bytes) -> None:
        """Write a serialized object straight to spill storage, bypassing
        the arena — the fallback-allocation path when a create cannot fit
        even after spilling/eviction (reference: plasma
        CreateAndSpillIfNeeded / fallback allocator, client.h:128).
        Readers find it via the normal spill restore-on-get path."""
        if self._remote:
            with self._fs().open_output(self._path(oid)) as f:
                f.write(payload)
            return
        self._ensure_dir()
        fd, tmp = tempfile.mkstemp(dir=self.dir, suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(payload)
            os.rename(tmp, self._path(oid))  # atomic
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    # -- read path ---------------------------------------------------------

    def contains(self, oid: bytes) -> bool:
        if not self.enabled:
            return False
        if self._remote:
            return self._fs().exists(self._path(oid))
        return os.path.exists(self._path(oid))

    def read(self, oid: bytes) -> Optional[bytes]:
        """Raw payload bytes (data ++ metadata) of a spilled object, or
        None.  Served straight from storage — no shm re-insertion, so a
        read cannot trigger further spilling."""
        if not self.enabled:
            return None
        try:
            if self._remote:
                with self._fs().open_input(self._path(oid)) as f:
                    return f.read()
            with open(self._path(oid), "rb") as f:
                return f.read()
        except FileNotFoundError:
            return None

    def read_range(self, oid: bytes, off: int, length: int
                   ) -> Optional[bytes]:
        """One chunk of a spilled object (local: seek; remote: the
        backend stream is read through and sliced)."""
        if not self.enabled:
            return None
        try:
            if self._remote:
                with self._fs().open_input(self._path(oid)) as f:
                    f.seek(off)
                    return f.read(length)
            with open(self._path(oid), "rb") as f:
                f.seek(off)
                return f.read(length)
        except FileNotFoundError:
            return None

    def size(self, oid: bytes) -> Optional[int]:
        if not self.enabled:
            return None
        try:
            if self._remote:
                return self._fs().size(self._path(oid))
            return os.path.getsize(self._path(oid))
        except OSError:
            return None

    def delete(self, oid: bytes) -> None:
        if not self.enabled:
            return
        if self._remote:
            self._fs().delete(self._path(oid))
            return
        try:
            os.unlink(self._path(oid))
        except OSError:
            pass

    def list(self) -> List[Tuple[bytes, int]]:
        """(oid, size) of every spilled object (observability)."""
        if not self.enabled:
            return []
        if self._remote:
            fs = self._fs()
            out = []
            for p in fs.list(self.dir.split("://", 1)[1]):
                name = p.rsplit("/", 1)[-1]
                try:
                    oid = bytes.fromhex(name)
                except ValueError:
                    continue
                sz = self.size(oid)
                if sz is not None:
                    out.append((oid, sz))
            return out
        if not os.path.isdir(self.dir):
            return []
        out = []
        for name in os.listdir(self.dir):
            if name.endswith(".tmp"):
                continue
            try:
                out.append((bytes.fromhex(name),
                            os.path.getsize(os.path.join(self.dir, name))))
            except (ValueError, OSError):
                continue
        return out
