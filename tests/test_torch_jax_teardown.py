"""The JAX runtime's event loops, settled when the port's parity tests
shut it down.

The JAX package's ``EventLoopThread.stop`` (``ray_tpu/_private/
client.py``) stops its loop with tasks still pending on it: the core
worker's ``_decref_pump`` sleeps up to 2 s between drains, and a node's
``_grant`` and ``_handle_request`` tasks may be mid-flight.  When such a
loop is garbage collected, asyncio logs "Task was destroyed but it is
pending!" into whatever test runs then, and under xdist those lines
split the progress lines that count the passes.

The port's parity tests start the JAX runtime beside the port's, so they
settle it without editing the JAX package: :func:`settle_jax_loops`, an
autouse fixture that each of those modules imports, makes every JAX
loop cancel its pending tasks and wait for them before it stops, for the
length of the module.  The tests below hold it to that, and show the
pump the JAX package leaves pending without it.
"""

import asyncio
import contextlib

import pytest

import ray_tpu
from ray_tpu._private import worker_context as jwc
from ray_tpu._private.client import EventLoopThread
# the port's own settling, applied here to the JAX package's loops
from ray_tpu_torch._private.client import _cancel_pending as _settle

STORE = 64 * 1024 * 1024
#: the JAX package's own stop, as imported (before any fixture ran)
_JAX_STOP = EventLoopThread.stop




@contextlib.contextmanager
def jax_loops_settled(timeout: float = 5.0):
    """Within the block, a JAX ``EventLoopThread.stop`` first cancels
    every task pending on its loop and waits up to ``timeout`` s for
    them to end."""
    stop = EventLoopThread.stop

    def settled_stop(self):
        if self.thread.is_alive():
            try:
                self.run(_settle(timeout), timeout=timeout + 5)
            except Exception:  # noqa: BLE001 - stop regardless
                pass
        stop(self)

    EventLoopThread.stop = settled_stop
    try:
        yield
    finally:
        EventLoopThread.stop = stop


@pytest.fixture(scope="module", autouse=True)
def settle_jax_loops():
    with jax_loops_settled():
        yield


def _pending(loop):
    return sorted(t.get_coro().__qualname__ for t in asyncio.all_tasks(loop))


def _runtime_loops():
    cw, node = jwc.maybe_core_worker(), jwc.node()
    return {id(x.io.loop): x.io.loop for x in (cw, node)}.values()


def test_shutdown_leaves_no_pending_task():
    """Settled, ``ray_tpu.shutdown()`` leaves no task on the driver's
    loops (its core worker's and its node's), the pump included."""
    ray_tpu.init(num_cpus=1, object_store_memory=STORE, log_to_driver=False)
    loops = list(_runtime_loops())
    assert ray_tpu.get(ray_tpu.put(7), timeout=60) == 7
    ray_tpu.shutdown()
    assert all(not loop.is_running() for loop in loops)
    assert [_pending(loop) for loop in loops] == [[]] * len(loops)


def test_cluster_shutdown_leaves_no_pending_task():
    """The same for a JAX ``Cluster``'s node loops after a task ran on
    its worker node."""
    from ray_tpu.cluster_utils import Cluster

    c = Cluster(head_num_cpus=0, object_store_memory=STORE)
    c.add_node(num_cpus=1)
    c.connect(log_to_driver=False)
    loops = list(_runtime_loops()) + [
        n.io.loop for n in (c.head, *c.worker_nodes)]
    try:
        assert ray_tpu.get(ray_tpu.remote(lambda: 3).remote(),
                           timeout=120) == 3
    finally:
        ray_tpu.shutdown()
        c.shutdown()
    assert [_pending(loop) for loop in loops] == [[]] * len(loops)


def test_unsettled_shutdown_leaves_the_pump_pending(monkeypatch):
    """Without the settling, the JAX package's shutdown leaves its core
    worker's ``_decref_pump`` pending on the stopped loop (the fault the
    fixture prevents); the test then ends it itself, so that it logs
    nothing when collected."""
    monkeypatch.setattr(EventLoopThread, "stop", _JAX_STOP)
    ray_tpu.init(num_cpus=1, object_store_memory=STORE, log_to_driver=False)
    loop = jwc.maybe_core_worker().io.loop
    ray_tpu.shutdown()
    try:
        assert "CoreWorker._decref_pump" in _pending(loop)
    finally:
        loop.run_until_complete(_settle(5.0))
    assert _pending(loop) == []


def test_port_shutdown_leaves_no_pending_task():
    """The port's own loops settle when they stop
    (``ray_tpu_torch/_private/client.py`` ``EventLoopThread.stop``): a
    cluster shut down right after a burst of tasks, with leases still on
    their way back, and with a task still queued for a lease that no
    node can grant, leaves no task pending on its driver's or its
    nodes' loops (the cancelled lease request asks for no new one)."""
    import ray_tpu_torch
    from ray_tpu_torch._private import worker_context as twc
    from ray_tpu_torch.cluster_utils import Cluster

    c = Cluster(head_num_cpus=0, object_store_memory=STORE)
    c.add_node(num_cpus=2)
    c.connect(log_to_driver=False)
    cw, node = twc.maybe_core_worker(), twc.node()
    loops = {id(x.io.loop): x.io.loop for x in (
        cw, node, c.head, *c.worker_nodes)}.values()
    try:
        sq = ray_tpu_torch.remote(lambda i: i * i)
        assert ray_tpu_torch.get([sq.remote(i) for i in range(6)],
                                 timeout=120) == [i * i for i in range(6)]
        stuck = ray_tpu_torch.remote(resources={"no_such_resource": 1})(
            lambda: 0).remote()
        ready, _ = ray_tpu_torch.wait([stuck], timeout=0.5)
        assert ready == []
    finally:
        ray_tpu_torch.shutdown()
        c.shutdown()
    assert [_pending(loop) for loop in loops] == [[]] * len(loops)
