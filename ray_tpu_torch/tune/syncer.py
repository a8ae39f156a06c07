"""Experiment-directory sync to remote storage.

Reference analog: ``tune/syncer.py`` (SyncConfig + the cloud syncer
that uploads the experiment dir so ``Tuner.restore`` works after losing
the head node).  Rides the Data filesystem seam (kv:// / s3:// /
mem://), so any registered scheme is a sync target.

Incremental: only files whose (size, mtime) changed since the last
sync upload; downloads restore the whole tree.

A copy of ``ray_tpu/tune/syncer.py`` over the port's
``data/filesystem.py``.
"""

from __future__ import annotations

import os
from typing import Dict, Tuple


class Syncer:
    def __init__(self, local_dir: str, remote_uri: str):
        from ray_tpu_torch.data import filesystem as fs_mod

        self.local_dir = local_dir
        self.remote_uri = remote_uri.rstrip("/")
        # resolve ONCE: cloud backends build real clients at
        # construction; per-file re-resolution on the result loop would
        # rebuild them N times per sync tick
        self._fs, self._base = fs_mod.resolve(self.remote_uri)
        self._synced: Dict[str, Tuple[int, float]] = {}

    def sync_up(self) -> int:
        """Upload changed files; returns how many were pushed."""
        import posixpath

        pushed = 0
        for root, _dirs, files in os.walk(self.local_dir):
            for name in files:
                if name.endswith(".tmp"):
                    continue
                path = os.path.join(root, name)
                rel = os.path.relpath(path, self.local_dir)
                try:
                    st = os.stat(path)
                except OSError:
                    continue
                sig = (st.st_size, st.st_mtime)
                if self._synced.get(rel) == sig:
                    continue
                op = posixpath.join(self._base,
                                    rel.replace(os.sep, "/"))
                try:
                    with open(path, "rb") as src, \
                            self._fs.open_output(op) as dst:
                        dst.write(src.read())
                    self._synced[rel] = sig
                    pushed += 1
                except Exception:  # noqa: BLE001 - transient remote
                    # failure: retried on the next sync tick
                    pass
        return pushed

    @staticmethod
    def sync_down(remote_uri: str, local_dir: str) -> int:
        """Restore an experiment tree from remote storage (the
        Tuner.restore-after-head-loss path); returns files pulled."""
        from ray_tpu_torch.data import filesystem as fs_mod

        remote_uri = remote_uri.rstrip("/")
        fs, base = fs_mod.resolve(remote_uri)
        pulled = 0
        for f in fs.list_tree(base):
            op = f.split("://", 1)[1] if "://" in f else f
            rel = op[len(base.split("://", 1)[-1]):].lstrip("/") \
                if op.startswith(base.split("://", 1)[-1]) \
                else op.rsplit("/", 1)[-1]
            dst = os.path.join(local_dir, rel.replace("/", os.sep))
            os.makedirs(os.path.dirname(dst), exist_ok=True)
            with fs.open_input(op) as src, open(dst, "wb") as out:
                out.write(src.read())
            pulled += 1
        return pulled
