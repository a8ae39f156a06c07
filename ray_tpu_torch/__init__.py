"""ray_tpu_torch: the PyTorch/CUDA port of ray_tpu for NVIDIA Hopper.

The JAX package ``ray_tpu`` is the reference and stays unchanged; this
package mirrors its module paths (``ops/attention.py``,
``models/gpt2_decode.py``, ``serve/llm.py``, ``_private/client.py``,
...) so each module's counterpart is easy to find.  It imports torch,
numpy and the standard library only, never jax and never ``ray_tpu``.

Kernels that the JAX package wrote in Pallas for the TPU are written
by hand in CUDA C++ for ``sm_90a`` (``ops/csrc/``), built with nvcc at
first use and bound through ctypes (``ops/_kernels.py``).  Each keeps a
plain PyTorch version beside it: a CPU tensor takes the plain version,
a CUDA tensor launches the kernel or raises.

The core runtime is a copy of the JAX package's: tasks (``@remote``
functions), actors (``@remote`` classes) and objects (immutable values
in a per-node shared-memory store), with ``init``, ``get``/``put``/
``wait`` and the rest of the reference's API, on one node or on a
cluster of them (``python -m ray_tpu_torch start``, ``init(address=
...)``, ``cluster_utils.Cluster``).  The accelerator resource is
``"GPU"`` (``num_gpus``): a worker whose task or actor holds it starts
with ``CUDA_VISIBLE_DEVICES`` set to its granted cards, any other
worker with ``CUDA_VISIBLE_DEVICES=""``.  ``ray_tpu_torch.serve.run``
deploys on it (``serve/controller.py``, replica actors, handles, the
HTTP proxy, ``serve.schema.apply``).  Importing the runtime does not
import torch: a CPU worker never pays for it.

    import ray_tpu_torch
    from ray_tpu_torch import serve

    ray_tpu_torch.init()          # or init(address="host:port")
    h = serve.run(serve.build_llm_deployment("llama", "llama-1b")
                  .options(ray_actor_options={"num_gpus": 1}).bind())
    tokens = ray_tpu_torch.get(h.remote(prompt_ids))
"""

from __future__ import annotations

import atexit
import logging
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

from ray_tpu_torch import exceptions
from ray_tpu_torch._private import worker_context
from ray_tpu_torch._private.config import Config
from ray_tpu_torch._private.worker_context import ObjectRef
from ray_tpu_torch.actor import ActorClass, ActorHandle
from ray_tpu_torch.remote_function import RemoteFunction

__version__ = "0.1.0"

__all__ = [
    "init", "shutdown", "is_initialized", "remote", "get", "put", "wait",
    "kill", "cancel", "get_actor", "nodes", "cluster_resources",
    "available_resources", "ObjectRef", "ActorHandle", "method",
    "get_runtime_context", "exceptions", "timeline", "client",
    "resolve_device", "__version__",
]


def __getattr__(name: str):
    # resolve_device imports torch: reached lazily, so that importing the
    # runtime (every worker process does) leaves torch out
    if name == "resolve_device":
        from ray_tpu_torch.device import resolve_device

        return resolve_device
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


class ClientContext:
    """Handle returned by ``ray_tpu_torch.client(...).connect()``
    (reference: ray.client ClientContext — disconnect() detaches the
    driver)."""

    def __init__(self, info: dict):
        self.address = info.get("gcs_address", "")
        self.session_dir = info.get("session_dir", "")

    def disconnect(self) -> None:
        shutdown()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.disconnect()


class ClientBuilder:
    """``ray_tpu_torch.client("host:port").connect()`` — remote-driver
    attach (reference: python/ray/client_builder.py ClientBuilder).

    The driver protocol is already remote-capable over TCP, so the
    builder is a thin veneer over ``init(address=...)`` with the
    reference's call shape."""

    def __init__(self, address: Optional[str] = None):
        self._address = address
        self._init_kwargs: Dict[str, Any] = {}

    def namespace(self, ns: str) -> "ClientBuilder":
        self._init_kwargs["namespace"] = ns
        return self

    def connect(self) -> ClientContext:
        info = init(address=self._address, **self._init_kwargs)
        return ClientContext(info if isinstance(info, dict) else {})


def client(address: Optional[str] = None) -> ClientBuilder:
    """Remote-driver connection builder; accepts ``ray://host:port`` or
    plain ``host:port`` (reference: ray.client())."""
    if address and address.startswith("ray://"):
        address = address[len("ray://"):]
    return ClientBuilder(address)


def timeline(filename=None):
    """Chrome-trace dump of finished task events (reference:
    ray.timeline, python/ray/_private/state.py:413)."""
    from ray_tpu_torch.util.state import timeline as _timeline

    return _timeline(filename)


logger = logging.getLogger(__name__)
_init_lock = threading.Lock()


def init(address: Optional[str] = None, *,
         num_cpus: Optional[int] = None,
         num_gpus: Optional[int] = None,
         resources: Optional[Dict[str, float]] = None,
         object_store_memory: Optional[int] = None,
         ignore_reinit_error: bool = False,
         namespace: Optional[str] = None,
         log_to_driver: bool = True,
         storage: Optional[str] = None,
         _system_config: Optional[Dict[str, Any]] = None,
         **kwargs):
    """Start (or connect to) a cluster.

    With no address: bootstraps a single-node cluster in-process (GCS +
    node manager on an IO thread, workers as subprocesses) — the analog
    of the reference's ``ray.init()`` local bootstrap (worker.py:1031).
    With ``address="host:port"`` (or ``"ray://host:port"``): attaches
    to a head started by ``python -m ray_tpu_torch start --head``;
    ``"auto"`` and no address read ``RAYTPU_ADDRESS``.

    ``num_gpus`` is the count of cards the node offers as the ``"GPU"``
    resource; ``None`` counts them (``detect_num_gpus``) on a head and
    offers none on an attaching driver's node.
    """
    if "num_tpus" in kwargs:
        raise ValueError("num_tpus is the JAX package's resource; the "
                         "port's accelerator resource is num_gpus")
    with _init_lock:
        if worker_context.is_initialized():
            if ignore_reinit_error:
                return _client_info()
            raise RuntimeError("ray_tpu_torch.init() called twice; pass "
                               "ignore_reinit_error=True to allow")
        config = Config().apply_env()
        if _system_config:
            config.apply_dict(_system_config)
        if object_store_memory:
            config.object_store_memory = object_store_memory

        from ray_tpu_torch._private.client import CoreWorker
        from ray_tpu_torch._private.ids import JobID
        from ray_tpu_torch._private.node import Node

        # Address resolution (reference: worker.py:1092-1110): explicit
        # address wins; "auto"/None fall back to RAYTPU_ADDRESS (set for
        # submitted jobs by the JobSupervisor, like RAY_ADDRESS).
        import os as _os

        if address and "://" in address:
            # Remote-driver URI (reference: ray://host:port goes through
            # the Ray Client proxy).  Attaching drivers here are
            # first-class cluster members over TCP, so the scheme simply
            # strips — no proxy process needed.
            address = address.split("://", 1)[1]
        if address == "auto":
            address = _os.environ.get("RAYTPU_ADDRESS") or None
            if address is None:
                raise ConnectionError(
                    'init(address="auto") but RAYTPU_ADDRESS is not set '
                    "and no running cluster was found")
        elif address is None:
            address = _os.environ.get("RAYTPU_ADDRESS") or None

        if address:
            # Attach to an existing cluster: the driver brings up its own
            # worker node (local store + node manager) registered with the
            # remote GCS — so it always has a local object store and lease
            # target, and its tasks spill to the rest of the cluster.
            # Attaching drivers contribute NO schedulable capacity by
            # default (their host isn't cluster hardware and dies with
            # them); pass num_cpus/num_gpus explicitly to opt in.
            node = Node(head=False,
                        num_cpus=0 if num_cpus is None else num_cpus,
                        num_gpus=0 if num_gpus is None else num_gpus,
                        resources=resources,
                        object_store_memory=object_store_memory,
                        config=config, gcs_address=address)
        else:
            node = Node(head=True, num_cpus=num_cpus, num_gpus=num_gpus,
                        resources=resources,
                        object_store_memory=object_store_memory,
                        config=config)
        node.start()
        cw = CoreWorker(
            gcs_address=node.gcs_address,
            node_address=node.node_address,
            object_store_name=node.shm_name,
            job_id=JobID.from_int(1),
            config=config, mode="driver")
        job = cw.io.run(cw.gcs.call("job_register", {}))
        cw.job_id = JobID(job["job_id"])
        worker_context.set_core_worker(cw, node=node, mode="driver")
        if storage:
            from ray_tpu_torch._private.storage import _announce

            _announce(cw, storage)
        if log_to_driver:
            _start_log_streaming(cw)
        if node.head:
            from ray_tpu_torch._private.usage_lib import \
                start_usage_reporter

            start_usage_reporter(cw, node.session_dir)
        atexit.register(shutdown)
        return _client_info()


def _start_log_streaming(cw) -> None:
    """Print worker stdout/stderr lines on the driver (reference:
    log_to_driver via the LogMonitor -> GCS pubsub pipeline,
    _private/log_monitor.py:100).  Pass log_to_driver=False to opt
    out."""
    import sys

    def on_logs(msg):
        prefix = f"({msg.get('worker', '?')[:8]}, " \
                 f"node={msg.get('node', '?')}) "
        for line in msg.get("lines", []):
            print(prefix + line, file=sys.stderr)

    try:
        cw.subscribe("logs", on_logs)
    except Exception:  # noqa: BLE001 - streaming is best-effort
        logger.debug("log streaming unavailable", exc_info=True)


def _client_info():
    node = worker_context.node()
    return {
        "session_dir": node.session_dir if node else "",
        "node_id": node.node_id.hex() if node else "",
        "gcs_address": node.gcs_address if node else "",
    }


def _auto_init():
    if not worker_context.is_initialized():
        init()


def shutdown():
    with _init_lock:
        from ray_tpu_torch._private.usage_lib import stop_usage_reporter

        stop_usage_reporter()
        cw = worker_context.maybe_core_worker()
        node = worker_context.node()
        worker_context.clear()
        if cw is not None:
            cw.shutdown()
        if node is not None:
            node.stop()
        atexit.unregister(shutdown)


def is_initialized() -> bool:
    return worker_context.is_initialized()


def remote(*args, **kwargs):
    """Decorator turning a function into a task / a class into an actor.

    Usage: ``@remote`` or ``@remote(num_cpus=2, num_gpus=1, ...)``.
    (Reference: worker.py:2694 remote decorator overloads.)
    """
    if len(args) == 1 and not kwargs and callable(args[0]):
        target = args[0]
        if isinstance(target, type):
            return ActorClass(target)
        return RemoteFunction(target)
    if args:
        raise TypeError("@remote takes keyword options only, e.g. "
                        "@remote(num_cpus=2)")

    def deco(target):
        if isinstance(target, type):
            return ActorClass(target, kwargs)
        return RemoteFunction(target, kwargs)

    return deco


def method(**opts):
    """Decorator for actor methods to set per-method defaults
    (``num_returns=...``). Reference: python/ray/actor.py:58 method."""

    def deco(fn):
        fn.__ray_tpu_method_opts__ = opts
        return fn

    return deco


def put(value: Any) -> ObjectRef:
    _auto_init()
    if isinstance(value, ObjectRef):
        raise TypeError("put() of an ObjectRef is not allowed "
                        "(matches reference semantics)")
    cw = worker_context.core_worker()
    return ObjectRef(cw.put(value))


def get(refs: Union[ObjectRef, Sequence[ObjectRef]],
        *, timeout: Optional[float] = None):
    _auto_init()
    cw = worker_context.core_worker()
    single = isinstance(refs, ObjectRef)
    if single:
        refs = [refs]
    refs = list(refs)
    for r in refs:
        if not isinstance(r, ObjectRef):
            raise TypeError(f"get() expects ObjectRef(s), got {type(r)}")
    values = cw.get([r._info for r in refs], timeout=timeout)
    return values[0] if single else values


def wait(refs: Sequence[ObjectRef], *, num_returns: int = 1,
         timeout: Optional[float] = None, fetch_local: bool = True
         ) -> Tuple[List[ObjectRef], List[ObjectRef]]:
    _auto_init()
    if isinstance(refs, ObjectRef):
        raise TypeError("wait() expects a list of ObjectRefs")
    refs = list(refs)
    if num_returns > len(refs):
        raise ValueError(
            f"num_returns={num_returns} exceeds number of refs {len(refs)}")
    cw = worker_context.core_worker()
    ready_idx, not_ready_idx = cw.wait(
        [r._info for r in refs], num_returns, timeout, fetch_local)
    return ([refs[i] for i in ready_idx], [refs[i] for i in not_ready_idx])


def kill(actor: ActorHandle, *, no_restart: bool = True):
    cw = worker_context.core_worker()
    cw.kill_actor(actor._actor_id, no_restart=no_restart)


def cancel(ref: ObjectRef, *, force: bool = False, recursive: bool = True):
    """Cancel the task that produces ``ref`` (reference: worker.py:2552).

    Queued tasks are dequeued and fail with TaskCancelledError.  Running
    tasks (normal or actor) get a TaskCancelledError raised
    asynchronously in their executing thread (best-effort, like the
    reference's KeyboardInterrupt delivery); ``force=True`` kills the
    executing worker process instead.  ``recursive`` is best-effort:
    child tasks the cancelled task already submitted are not chased
    individually — they die with the worker under ``force=True``.
    """
    cw = worker_context.core_worker()
    cw.cancel_task(ref._info, force=force, recursive=recursive)


def get_actor(name: str) -> ActorHandle:
    _auto_init()
    cw = worker_context.core_worker()
    info = cw.get_actor_by_name(name)
    if info is None:
        raise ValueError(f"failed to look up actor with name {name!r}")
    return ActorHandle(info["actor_id"])


def nodes() -> List[dict]:
    cw = worker_context.core_worker()
    out = []
    for n in cw.nodes():
        out.append({
            "NodeID": n["node_id"].hex(),
            "Alive": n["alive"],
            "Address": n["address"],
            "Resources": n["resources_total"],
        })
    return out


def cluster_resources() -> Dict[str, float]:
    return worker_context.core_worker().cluster_resources()


def available_resources() -> Dict[str, float]:
    return worker_context.core_worker().available_resources()


class _RuntimeContext:
    @property
    def job_id(self):
        return worker_context.core_worker().job_id

    @property
    def node_id(self):
        return worker_context.core_worker().node_id

    @property
    def task_id(self) -> bytes:
        return worker_context.current_task_id()

    @property
    def actor_id(self) -> bytes:
        return worker_context.current_actor_id()

    def get_gpu_ids(self) -> List[int]:
        """Physical card indices granted to this worker process through
        its CUDA_VISIBLE_DEVICES (reference: ray.get_gpu_ids,
        worker.py:821); the JAX package's ``get_tpu_ids`` reads
        TPU_VISIBLE_CHIPS the same way."""
        import os

        csv = os.environ.get("CUDA_VISIBLE_DEVICES", "")
        return [int(c) for c in csv.split(",") if c.strip()]

    def get(self) -> dict:
        return {"job_id": self.job_id, "node_id": self.node_id,
                "task_id": self.task_id, "actor_id": self.actor_id,
                "gpu_ids": self.get_gpu_ids()}


def get_runtime_context() -> _RuntimeContext:
    return _RuntimeContext()
