"""Python client for the C++ shared-memory object store.

Role-equivalent of the reference's ``PlasmaClient`` (reference
``src/ray/object_manager/plasma/client.h:146`` — Create/Seal/Get/Release/
Delete/Contains) but bound via ctypes directly onto the in-segment store
(the port's copy of ``src/objstore.cc``, ``csrc/objstore.cc``): no
socket protocol, no copies.  ``get`` returns memoryviews aliasing the
shared mapping (zero-copy); the caller must ``release`` when done
(ObjectBuffer does this on close/gc).

The store segment is created once per node by the node manager
(``os_create``); every other process attaches (``os_attach``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional, Tuple

from ray_tpu_torch._private.ids import ObjectID

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_LIB_DIR = os.path.join(_PKG_DIR, "_build")
_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                    "objstore.cc")

OS_OK = 0
OS_ERR_EXISTS = -1
OS_ERR_NOT_FOUND = -2
OS_ERR_FULL = -3
OS_ERR_TIMEOUT = -4
OS_ERR_STATE = -5

_ERR_NAMES = {
    OS_ERR_EXISTS: "already exists",
    OS_ERR_NOT_FOUND: "not found",
    OS_ERR_FULL: "store full",
    OS_ERR_TIMEOUT: "timeout",
    OS_ERR_STATE: "wrong object state",
    -6: "invalid argument",
    -7: "system error",
}


def _err(rc: int) -> str:
    return _ERR_NAMES.get(rc, f"error {rc}")

_build_lock = threading.Lock()


class ObjectStoreError(Exception):
    pass


class ObjectStoreFull(ObjectStoreError):
    pass


class ObjectNotFound(ObjectStoreError):
    pass


class GetTimeout(ObjectStoreError):
    pass


def _lib_path(src: str) -> str:
    """The library's path carries the hash of its source, so an edited
    ``objstore.cc`` builds anew and a stale build is never loaded."""
    with open(src, "rb") as f:
        digest = hashlib.sha1(f.read()).hexdigest()[:12]
    return os.path.join(_LIB_DIR, f"libobjstore_{digest}.so")


def _ensure_built() -> str:
    """Build ``csrc/objstore.cc`` with ``$CXX`` (default g++) into
    ``ray_tpu_torch/_build/`` at first use; the port never loads the JAX
    package's ``libobjstore.so``."""
    src = _SRC
    lib_path = _lib_path(src)
    with _build_lock:
        if os.path.exists(lib_path):
            return lib_path
        os.makedirs(_LIB_DIR, exist_ok=True)
        # Cross-process safe: serialize builds with a file lock, compile to a
        # temp file, and atomically rename — concurrent importers either win
        # the lock and build, or wait and find a complete .so.
        import fcntl

        with open(lib_path + ".lock", "w") as lockf:
            fcntl.flock(lockf, fcntl.LOCK_EX)
            try:
                if os.path.exists(lib_path):
                    return lib_path
                tmp = f"{lib_path}.{os.getpid()}.tmp"
                cmd = [
                    os.environ.get("CXX", "g++"), "-O2", "-g", "-std=c++17",
                    "-fPIC", "-shared", "-o", tmp, src, "-lpthread", "-lrt",
                ]
                subprocess.run(cmd, check=True, capture_output=True)
                os.replace(tmp, lib_path)
            finally:
                fcntl.flock(lockf, fcntl.LOCK_UN)
    return lib_path


def _load_lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(_ensure_built())
    lib.os_create.restype = ctypes.c_void_p
    lib.os_create.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
    lib.os_attach.restype = ctypes.c_void_p
    lib.os_attach.argtypes = [ctypes.c_char_p]
    lib.os_detach.argtypes = [ctypes.c_void_p]
    lib.os_destroy.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.os_base.restype = ctypes.c_void_p
    lib.os_base.argtypes = [ctypes.c_void_p]
    lib.os_capacity.restype = ctypes.c_uint64
    lib.os_capacity.argtypes = [ctypes.c_void_p]
    lib.os_obj_create.restype = ctypes.c_int64
    lib.os_obj_create.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                  ctypes.c_uint64, ctypes.c_uint64]
    lib.os_obj_create2.restype = ctypes.c_int64
    lib.os_obj_create2.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                   ctypes.c_uint64, ctypes.c_uint64,
                                   ctypes.c_int]
    lib.os_obj_seal.restype = ctypes.c_int64
    lib.os_obj_seal.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.os_obj_get.restype = ctypes.c_int64
    lib.os_obj_get.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64,
                               ctypes.POINTER(ctypes.c_uint64),
                               ctypes.POINTER(ctypes.c_uint64)]
    for name in ("os_obj_release", "os_obj_abort", "os_obj_delete",
                 "os_obj_contains"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int64
        fn.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.os_evict.restype = ctypes.c_int64
    lib.os_evict.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.os_lru_candidates.restype = ctypes.c_int64
    lib.os_lru_candidates.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64, ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_uint64), ctypes.c_int64]
    lib.os_stats.argtypes = [ctypes.c_void_p] + [ctypes.POINTER(ctypes.c_uint64)] * 4
    return lib


_lib: Optional[ctypes.CDLL] = None


def get_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        _lib = _load_lib()
    return _lib


class ObjectBuffer:
    """A pinned view of a sealed object's payload. Releases the pin on
    close() / garbage collection. ``data`` and ``metadata`` alias shared
    memory — copy out if you need the bytes to outlive the buffer."""

    def __init__(self, client: "ObjectStoreClient", object_id: ObjectID,
                 data: memoryview, metadata: memoryview):
        self._client = client
        self.object_id = object_id
        self.data = data
        self.metadata = metadata
        self._released = False

    def close(self):
        if not self._released:
            self._released = True
            self.data.release()
            self.metadata.release()
            self._client._release(self.object_id)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 - interpreter shutdown
            pass


class ObjectStoreClient:
    """Attach-mode client used by workers and the driver."""

    def __init__(self, shm_name: str, create: bool = False,
                 capacity: int = 0):
        self._lib = get_lib()
        self.shm_name = shm_name
        self._name_b = shm_name.encode()
        if create:
            self._h = self._lib.os_create(self._name_b, capacity)
            if not self._h:
                raise ObjectStoreError(
                    f"failed to create object store {shm_name} "
                    f"({capacity} bytes)")
        else:
            self._h = self._lib.os_attach(self._name_b)
            if not self._h:
                raise ObjectStoreError(f"failed to attach object store {shm_name}")
        self._owner = create
        base = self._lib.os_base(self._h)
        cap = self._lib.os_capacity(self._h)
        # One big ctypes array over the whole mapping; object views slice it.
        self._arr = memoryview((ctypes.c_ubyte * cap).from_address(base)).cast("B")
        self._closed = False
        self._outstanding = 0  # pinned ObjectBuffers not yet released

    # -- write path --------------------------------------------------------

    def create(self, object_id: ObjectID, data_size: int,
               metadata: bytes = b"", allow_evict: bool = True) -> memoryview:
        """Allocate an object; returns a writable view of the data region.
        Call seal() when filled, or abort() to drop it.  allow_evict=False
        raises ObjectStoreFull instead of silently evicting LRU objects —
        the spill-first path."""
        off = self._lib.os_obj_create2(self._h, object_id.binary(), data_size,
                                       len(metadata), 1 if allow_evict else 0)
        if off == OS_ERR_EXISTS:
            raise ObjectStoreError(f"object {object_id} already exists")
        if off == OS_ERR_FULL:
            raise ObjectStoreFull(
                f"object store full creating {data_size} byte object")
        if off < 0:
            raise ObjectStoreError(f"create failed: {_err(off)}")
        if metadata:
            self._arr[off + data_size: off + data_size + len(metadata)] = metadata
        return self._arr[off: off + data_size]

    def seal(self, object_id: ObjectID) -> None:
        rc = self._lib.os_obj_seal(self._h, object_id.binary())
        if rc != OS_OK:
            raise ObjectStoreError(f"seal failed: {_err(rc)}")

    def put_bytes(self, object_id: ObjectID, data: bytes,
                  metadata: bytes = b"") -> None:
        view = self.create(object_id, len(data), metadata)
        try:
            view[:] = data
        finally:
            view.release()
        self.seal(object_id)

    def abort(self, object_id: ObjectID) -> None:
        """Drop an unsealed create.  A no-op once this client is closed:
        a pull's failure path can run after its node tore the store down
        (a coroutine finalized with its node manager after ``close()``
        detached the handle), and the handle is freed memory then."""
        if self._closed:
            return
        self._lib.os_obj_abort(self._h, object_id.binary())

    # -- read path ---------------------------------------------------------

    def get(self, object_id: ObjectID,
            timeout_ms: int = 0) -> Optional[ObjectBuffer]:
        """Pin + return the object, or None if absent within timeout.
        timeout_ms=-1 waits forever; 0 is non-blocking."""
        dsize = ctypes.c_uint64()
        msize = ctypes.c_uint64()
        off = self._lib.os_obj_get(self._h, object_id.binary(), timeout_ms,
                                   ctypes.byref(dsize), ctypes.byref(msize))
        if off == OS_ERR_TIMEOUT:
            return None
        if off < 0:
            raise ObjectStoreError(f"get failed: {_err(off)}")
        data = self._arr[off: off + dsize.value].toreadonly()
        meta = self._arr[off + dsize.value: off + dsize.value + msize.value].toreadonly()
        self._outstanding += 1
        return ObjectBuffer(self, object_id, data, meta)

    def contains(self, object_id: ObjectID) -> bool:
        if self._closed:
            return False
        return bool(self._lib.os_obj_contains(self._h, object_id.binary()))

    # -- lifecycle ---------------------------------------------------------

    def _release(self, object_id: ObjectID) -> None:
        if not self._closed:
            self._outstanding -= 1
            self._lib.os_obj_release(self._h, object_id.binary())

    def delete(self, object_id: ObjectID) -> bool:
        if self._closed:
            return False  # mapping gone; touching it would segfault
        return self._lib.os_obj_delete(self._h, object_id.binary()) == OS_OK

    def evict(self, nbytes: int) -> int:
        return self._lib.os_evict(self._h, nbytes)

    def lru_candidates(self, nbytes: int, max_out: int = 128
                       ) -> list[tuple[ObjectID, int]]:
        """LRU unpinned sealed objects (oldest first) totaling >= nbytes,
        as (id, size) pairs — the spill victim list (reference:
        local_object_manager.h:206 SpillObjectsOfSize)."""
        id_size = 24  # kIdSize in objstore.cc
        ids = ctypes.create_string_buffer(id_size * max_out)
        sizes = (ctypes.c_uint64 * max_out)()
        n = self._lib.os_lru_candidates(self._h, nbytes, ids, sizes, max_out)
        return [(ObjectID(ids.raw[i * id_size:(i + 1) * id_size]), sizes[i])
                for i in range(n)]

    def stats(self) -> dict:
        used = ctypes.c_uint64()
        nobj = ctypes.c_uint64()
        cap = ctypes.c_uint64()
        ev = ctypes.c_uint64()
        self._lib.os_stats(self._h, ctypes.byref(used), ctypes.byref(nobj),
                           ctypes.byref(cap), ctypes.byref(ev))
        return {"bytes_used": used.value, "num_objects": nobj.value,
                "capacity": cap.value, "evictions": ev.value}

    def close(self, destroy: bool = False) -> None:
        if self._closed:
            return
        self._closed = True
        if self._outstanding > 0:
            # Live ObjectBuffer views still alias the mapping; munmap would
            # turn their next access into a segfault.  Leave the mapping in
            # place (reclaimed at process exit) but still unlink the name
            # when destroying so the segment dies with its last user.
            import warnings

            warnings.warn(
                f"object store client closed with {self._outstanding} "
                "unreleased buffers; deferring unmap to process exit",
                stacklevel=2,
            )
            if destroy or self._owner:
                import ctypes as _c

                _c.CDLL(None).shm_unlink(self._name_b)
            return
        if destroy or self._owner:
            self._lib.os_destroy(self._h, self._name_b)
        else:
            self._lib.os_detach(self._h)

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001
            pass


def default_shm_name(session_id: str) -> str:
    return f"/raytpu_torch_{session_id}"
