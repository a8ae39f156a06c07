"""Cluster-wide storage API: a shared filesystem namespace configured at
init time.

Role-equivalent of the reference's storage API (reference
``python/ray/_private/storage.py:54 get_client``, ``:322 _init_storage``
— ``ray.init(storage=...)`` hands every worker a KV/file client rooted at
a cluster-wide URI).  Filesystem backend only (object-store URIs can be
added as schemes); the root is announced through GCS KV so every process
resolves the same location.
"""

from __future__ import annotations

import os
from typing import List, Optional

_KV_KEY = "__storage_uri"


class KVClient:
    """File-backed KV client under <root>/<prefix> (reference: the same
    class name/surface in _private/storage.py)."""

    def __init__(self, root: str, prefix: str = ""):
        self.root = os.path.join(root, prefix) if prefix else root
        os.makedirs(self.root, exist_ok=True)

    def _path(self, key: str) -> str:
        if ".." in key or key.startswith("/"):
            raise ValueError(f"invalid storage key {key!r}")
        return os.path.join(self.root, key)

    def put(self, key: str, value: bytes) -> None:
        path = self._path(key)
        os.makedirs(os.path.dirname(path) or self.root, exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(value)
        os.replace(tmp, path)

    def get(self, key: str) -> Optional[bytes]:
        try:
            with open(self._path(key), "rb") as f:
                return f.read()
        except FileNotFoundError:
            return None

    def exists(self, key: str) -> bool:
        return os.path.exists(self._path(key))

    def delete(self, key: str) -> bool:
        try:
            os.unlink(self._path(key))
            return True
        except FileNotFoundError:
            return False

    def list(self, prefix: str = "") -> List[str]:
        base = self._path(prefix) if prefix else self.root
        if not os.path.isdir(base):
            return []
        out = []
        for root, _dirs, files in os.walk(base):
            for f in files:
                if f.endswith(".tmp"):
                    continue
                out.append(os.path.relpath(os.path.join(root, f),
                                           self.root))
        return sorted(out)


def _announce(cw, uri: str) -> None:
    cw.kv_put(_KV_KEY, uri.encode())


def _resolve(cw) -> Optional[str]:
    raw = cw.kv_get(_KV_KEY)
    return raw.decode() if raw else None


def get_client(prefix: str = "") -> KVClient:
    """Storage client rooted at the cluster's configured URI (reference:
    storage.py:54).  Raises if init(storage=...) was never given."""
    from ray_tpu_torch._private import worker_context

    cw = worker_context.core_worker()
    uri = _resolve(cw)
    if not uri:
        raise RuntimeError(
            "no cluster storage configured; pass storage=<path> to "
            "ray_tpu_torch.init() on the head")
    if uri.startswith("file://"):
        uri = uri[len("file://"):]
    return KVClient(uri, prefix)
