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

A copy of ``ray_tpu/_private/spill.py`` for a local directory.  A URI
target (``kv://``, ``s3://``, ...) goes through the Data filesystem
seam in the JAX package, which the port does not have yet: it raises
NotImplementedError naming ROADMAP.md queue 1 item 7.
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
    """Per-process handle on the node's spill directory: a plain path
    spills to node-local disk (mkstemp + atomic rename, seekable range
    reads)."""

    def __init__(self, store: ObjectStoreClient, spill_dir: str):
        if "://" in (spill_dir or ""):
            raise NotImplementedError(
                f"spilling to {spill_dir!r} needs the Data filesystem "
                f"seam, which is not ported yet: ROADMAP.md queue 1 "
                f"item 7 (data); give a local directory")
        self.store = store
        self.dir = spill_dir
        self._ensured = False

    @property
    def enabled(self) -> bool:
        return bool(self.dir)

    def _path(self, oid: bytes) -> str:
        return os.path.join(self.dir, oid.hex())

    def _ensure_dir(self):
        if not self._ensured:
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
                fd, tmp = tempfile.mkstemp(dir=self.dir, suffix=".tmp")
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
        except Exception as e:  # noqa: BLE001 - a failed spill must
            # never crash the allocation path, only report 0 bytes freed
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
        return os.path.exists(self._path(oid))

    def read(self, oid: bytes) -> Optional[bytes]:
        """Raw payload bytes (data ++ metadata) of a spilled object, or
        None.  Served straight from storage — no shm re-insertion, so a
        read cannot trigger further spilling."""
        if not self.enabled:
            return None
        try:
            with open(self._path(oid), "rb") as f:
                return f.read()
        except FileNotFoundError:
            return None

    def read_range(self, oid: bytes, off: int, length: int
                   ) -> Optional[bytes]:
        """One chunk of a spilled object."""
        if not self.enabled:
            return None
        try:
            with open(self._path(oid), "rb") as f:
                f.seek(off)
                return f.read(length)
        except FileNotFoundError:
            return None

    def size(self, oid: bytes) -> Optional[int]:
        if not self.enabled:
            return None
        try:
            return os.path.getsize(self._path(oid))
        except OSError:
            return None

    def delete(self, oid: bytes) -> None:
        if not self.enabled:
            return
        try:
            os.unlink(self._path(oid))
        except OSError:
            pass

    def list(self) -> List[Tuple[bytes, int]]:
        """(oid, size) of every spilled object (observability)."""
        if not self.enabled:
            return []
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
