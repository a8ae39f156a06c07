"""Scheduling strategy objects accepted by @remote(scheduling_strategy=...)
(reference analog: python/ray/util/scheduling_strategies.py); a copy
of ``ray_tpu/util/scheduling_strategies.py``."""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class PlacementGroupSchedulingStrategy:
    placement_group: object
    placement_group_bundle_index: int = -1
    placement_group_capture_child_tasks: bool = False


@dataclasses.dataclass
class NodeAffinitySchedulingStrategy:
    node_id: bytes
    soft: bool = False
