"""In-process multi-node cluster for tests.

Reference analog: python/ray/cluster_utils.py:99 class Cluster — multiple
full nodes (each with its own node manager + shared-memory store) on one
host, registered to one GCS, so cross-node scheduling, spillback, and
object transfer run for real without real machines.

A copy of ``ray_tpu/cluster_utils.py`` with the port's accelerator: the
head offers ``head_num_gpus`` cards (0 by default) and each added node
``num_gpus``.  Every node would otherwise count the host's cards itself
(``detect_num_gpus``), and two nodes on one host that both counted card
0 would grant it twice.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from ray_tpu_torch._private.config import Config
from ray_tpu_torch._private.node import Node


class Cluster:
    def __init__(self, *, head_num_cpus: int = 1, head_num_gpus: int = 0,
                 head_resources: Optional[Dict[str, float]] = None,
                 object_store_memory: int = 128 * 1024 * 1024,
                 config: Optional[Config] = None):
        self.config = config or Config().apply_env()
        self.object_store_memory = object_store_memory
        self.head = Node(head=True, num_cpus=head_num_cpus,
                         num_gpus=head_num_gpus,
                         resources=head_resources,
                         object_store_memory=object_store_memory,
                         config=self.config,
                         gcs_address="127.0.0.1:0")  # TCP: port auto-pick
        self.head.start()
        self.worker_nodes: List[Node] = []

    @property
    def gcs_address(self) -> str:
        return self.head.gcs_address

    def add_node(self, *, num_cpus: int = 1, num_gpus: int = 0,
                 resources: Optional[Dict[str, float]] = None) -> Node:
        node = Node(head=False, num_cpus=num_cpus, num_gpus=num_gpus,
                    resources=resources,
                    object_store_memory=self.object_store_memory,
                    config=self.config, gcs_address=self.gcs_address)
        node.start()
        self.worker_nodes.append(node)
        return node

    def remove_node(self, node: Node) -> None:
        """SIGKILL-equivalent teardown: the node just vanishes; the GCS
        notices via missed heartbeats (failure-detection path)."""
        if node in self.worker_nodes:
            self.worker_nodes.remove(node)
        node.stop()

    def connect(self, **init_kwargs):
        """ray_tpu_torch.init(address=...) against this cluster's head."""
        import ray_tpu_torch

        init_kwargs.setdefault("num_cpus", 0)
        init_kwargs.setdefault("num_gpus", 0)
        return ray_tpu_torch.init(address=self.gcs_address, **init_kwargs)

    def shutdown(self) -> None:
        for n in list(self.worker_nodes):
            self.remove_node(n)
        self.head.stop()
