"""Node bootstrap: brings up the control-plane services for this host.

A copy of ``ray_tpu/_private/node.py`` (role-equivalent of the
reference's Node/services orchestration, ``python/ray/_private/node.py:41
class Node``): the head's GCS and the node manager are asyncio services
on a dedicated IO thread inside the driver process; worker processes
are real subprocesses.  The accelerator is counted as CUDA cards
(``detect_num_gpus``) where the JAX package counts TPU chips.
``python -m ray_tpu_torch start`` (scripts/cli.py) runs the same
services standalone for multi-node clusters; a node joins one with
``head=False`` and the head's ``gcs_address``.
"""

from __future__ import annotations

import logging
import os
import shutil
import sys
import tempfile
import time
from typing import Dict, Optional

from ray_tpu_torch._private.client import EventLoopThread
from ray_tpu_torch._private.config import Config
from ray_tpu_torch._private.gcs import GcsServer
from ray_tpu_torch._private.ids import NodeID
from ray_tpu_torch._private.node_manager import NodeManager
from ray_tpu_torch._private.object_store import ObjectStoreClient, default_shm_name

logger = logging.getLogger(__name__)


def detect_num_gpus(config: Config) -> int:
    """Count local CUDA cards. ``num_gpus`` is the predefined
    accelerator resource (the reference's GPU, scheduling_ids.h:34; the
    JAX package's ``detect_num_tpus`` counts TPU chips the same way).

    ``config.gpus_per_host`` wins when set.  Else
    ``torch.cuda.device_count()``, which honours this process's
    CUDA_VISIBLE_DEVICES and creates no CUDA context; 0 when torch sees
    no CUDA.  Torch is asked in a BOUNDED subprocess, as the JAX package
    asks jax: importing torch here would cost every driver its import
    time, and a hung driver stack must never hang init().
    """
    if config.gpus_per_host:
        return config.gpus_per_host
    if "torch" in sys.modules:
        torch = sys.modules["torch"]
        return torch.cuda.device_count() if torch.cuda.is_available() \
            else 0
    import subprocess

    code = ("import torch; "
            "print(torch.cuda.device_count() "
            "if torch.cuda.is_available() else 0)")
    try:
        r = subprocess.run([sys.executable, "-c", code],
                           capture_output=True, text=True,
                           timeout=config.gpu_detect_timeout_s)
        if r.returncode == 0:
            return int(r.stdout.strip().splitlines()[-1])
    except Exception:  # noqa: BLE001 - no torch / probe timeout
        pass
    logger.warning("GPU detection failed or timed out; assuming 0 cards "
                   "(set gpus_per_host to override)")
    return 0


def _gcs_is_local(gcs_address: str) -> bool:
    if gcs_address.startswith("/"):
        return True
    host = gcs_address.rsplit(":", 1)[0]
    return host in ("127.0.0.1", "localhost", "::1")


def _local_ip_toward(gcs_address: str) -> str:
    """This machine's IP on the route to the GCS (the address other
    nodes should dial us at)."""
    import socket

    host = gcs_address.rsplit(":", 1)[0]
    try:
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
            s.connect((host, 1))  # no traffic; just picks the interface
            return s.getsockname()[0]
    except OSError:
        try:
            return socket.gethostbyname(socket.gethostname())
        except OSError:
            return "127.0.0.1"


class Node:
    """One framework node. With ``head=True`` also hosts the GCS."""

    def __init__(self, *, head: bool = True,
                 num_cpus: Optional[int] = None,
                 num_gpus: Optional[int] = None,
                 resources: Optional[Dict[str, float]] = None,
                 object_store_memory: Optional[int] = None,
                 config: Optional[Config] = None,
                 gcs_address: str = "",
                 session_dir: str = "",
                 node_name: str = ""):
        self.config = config or Config().apply_env()
        self.head = head
        self.node_id = NodeID.from_random()
        sid = self.node_id.hex()[:8]
        self.session_dir = session_dir or os.path.join(
            tempfile.gettempdir(), "raytpu_torch", f"s_{sid}")
        os.makedirs(os.path.join(self.session_dir, "sockets"), exist_ok=True)
        os.makedirs(os.path.join(self.session_dir, "logs"), exist_ok=True)
        if num_cpus is None:
            num_cpus = os.cpu_count() or 1
        if num_gpus is None:
            num_gpus = detect_num_gpus(self.config)
        self.resources: Dict[str, float] = {
            "CPU": float(num_cpus),
            "memory": float(object_store_memory or self.config.object_store_memory),
        }
        if num_gpus:
            self.resources["GPU"] = float(num_gpus)
        for k, v in (resources or {}).items():
            self.resources[k] = float(v)
        self.object_store_memory = int(
            object_store_memory or self.config.object_store_memory)
        self.shm_name = default_shm_name(f"{sid}_{os.getpid()}")
        self.gcs_address = gcs_address or os.path.join(
            self.session_dir, "sockets", "gcs")
        self.io: Optional[EventLoopThread] = None
        self.gcs: Optional[GcsServer] = None
        self.node_manager: Optional[NodeManager] = None
        self.store_owner: Optional[ObjectStoreClient] = None
        self._started = False

    def start(self):
        self.store_owner = ObjectStoreClient(
            self.shm_name, create=True, capacity=self.object_store_memory)
        self.io = EventLoopThread(name="raytpu-node")
        if self.head:
            self.gcs = GcsServer(
                heartbeat_timeout_s=self.config.heartbeat_interval_s
                * self.config.num_heartbeats_timeout,
                persist_path=self.config.gcs_persist_path)
            if self.gcs_address.startswith("/"):
                self.io.run(self.gcs.start_unix(self.gcs_address))
            else:
                host, port = self.gcs_address.rsplit(":", 1)
                real = self.io.run(self.gcs.start_tcp(host, int(port)))
                self.gcs_address = f"{host}:{real}"
        # Transport selection: unix sockets when the whole cluster lives
        # on this machine (GCS on a unix path or loopback); TCP when the
        # GCS is remote — a node manager advertising a unix path could
        # never be dialed by other machines for spillback leases or
        # chunked object pulls.
        node_address = ""
        if not _gcs_is_local(self.gcs_address):
            node_address = f"{_local_ip_toward(self.gcs_address)}:0"
        self.node_manager = NodeManager(
            self.node_id, self.session_dir, self.config,
            dict(self.resources), self.shm_name, self.gcs_address,
            node_address=node_address)
        self.io.run(self.node_manager.start())
        self._started = True
        return self

    @property
    def node_address(self) -> str:
        return self.node_manager.node_address

    def stop(self):
        if not self._started:
            return
        self._started = False
        try:
            self.io.run(self.node_manager.close(), timeout=10)
        except Exception:  # noqa: BLE001
            pass
        if self.gcs is not None:
            try:
                self.io.run(self.gcs.close(), timeout=10)
            except Exception:  # noqa: BLE001
                pass
        self.io.stop()
        try:
            self.store_owner.close(destroy=True)
        except Exception:  # noqa: BLE001
            pass
        shutil.rmtree(os.path.join(self.session_dir, "sockets"),
                      ignore_errors=True)
