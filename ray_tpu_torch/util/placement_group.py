"""Placement groups: gang resource reservation.

Reference analog: python/ray/util/placement_group.py (:128
placement_group(), :33 class PlacementGroup); the GCS side implements the
2PC prepare/commit bundle reservation (reference
gcs_placement_group_scheduler.h:103-105) in ray_tpu_torch/_private/gcs.py.

A copy of ``ray_tpu/util/placement_group.py``.  Bundles name the port's
resources: ``{"GPU": n}`` reserves whole cards, and a STRICT_PACK group
of them keeps a trainer's cards on one host (one NVLink domain).
"""

from __future__ import annotations

from typing import Dict, List, Optional

from ray_tpu_torch._private import worker_context
from ray_tpu_torch._private.ids import PlacementGroupID

_STRATEGIES = ("PACK", "SPREAD", "STRICT_PACK", "STRICT_SPREAD")


class PlacementGroup:
    def __init__(self, pg_id: bytes, bundles: List[Dict[str, float]]):
        self._id = pg_id
        self.bundles = bundles

    @property
    def id(self) -> PlacementGroupID:
        return PlacementGroupID(self._id)

    def ready(self, timeout: float = 60.0) -> "PlacementGroup":
        """Block until all bundles are reserved (2PC committed)."""
        cw = worker_context.core_worker()
        info = cw.io.run(cw.gcs.call("pg_wait_ready", {"pg_id": self._id},
                                     timeout=timeout))
        if info["state"] != "CREATED":
            raise RuntimeError(
                f"placement group not ready: state={info['state']}")
        return self

    @property
    def bundle_count(self) -> int:
        return len(self.bundles)

    def __reduce__(self):
        return (PlacementGroup, (self._id, self.bundles))

    def __repr__(self):
        return f"PlacementGroup({PlacementGroupID(self._id).hex()[:16]})"


def placement_group(bundles: List[Dict[str, float]],
                    strategy: str = "PACK",
                    name: str = "") -> PlacementGroup:
    """Reserve a gang of resource bundles across the cluster."""
    if strategy not in _STRATEGIES:
        raise ValueError(f"strategy must be one of {_STRATEGIES}")
    if not bundles or any(not b for b in bundles):
        raise ValueError("bundles must be a non-empty list of non-empty "
                         "resource dicts")
    import ray_tpu_torch

    ray_tpu_torch._auto_init()
    cw = worker_context.core_worker()
    pg_id = PlacementGroupID.from_random().binary()
    cw.io.run(cw.gcs.call("pg_create", {
        "pg_id": pg_id, "name": name,
        "bundles": [{k: float(v) for k, v in b.items()} for b in bundles],
        "strategy": strategy}))
    return PlacementGroup(pg_id, bundles)


def remove_placement_group(pg: PlacementGroup, timeout: float = 30.0):
    cw = worker_context.core_worker()
    cw.io.run(cw.gcs.call("pg_remove", {"pg_id": pg.id.binary()},
                          timeout=timeout))


def get_placement_group(name: str) -> Optional[PlacementGroup]:
    cw = worker_context.core_worker()
    pgs = cw.io.run(cw.gcs.call("pg_list", {}))
    for info in pgs:
        if info["name"] == name and info["state"] != "REMOVED":
            return PlacementGroup(info["pg_id"], info["bundles"])
    return None
