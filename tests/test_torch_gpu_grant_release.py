"""A killed worker's card goes back to the node at its disconnect.

The port's node manager SIGKILLs a worker (``_kill_worker_process``),
sees its socket close (``_on_disconnect``) and returns its cards there
(``_release_gpus``), before the next grant.  This test traces those
steps with a fake ``GPU`` resource on the CPU (``num_gpus=1``: the
card's index is granted, no CUDA runs): an actor holding the card is
killed and a second one asks for it at once.  The release follows the
SIGKILL within the disconnect, and the second actor gets the same card.
Run with ``-s`` to print the trace (milliseconds after the kill call).
A longer wait on a real card is then the CUDA driver's teardown of the
killed process's context, not a grant the port holds.
"""

import os
import sys
import time

import pytest

import ray_tpu_torch
from ray_tpu_torch._private import node_manager as nmm
from ray_tpu_torch._private._vendor import cloudpickle as port_cloudpickle

# the port's workers unpickle this module's actor by value
port_cloudpickle.register_pickle_by_value(sys.modules[__name__])

#: the release must follow the kill this closely (CPU, no CUDA teardown)
RELEASE_S = 1.0


@pytest.fixture
def trace(monkeypatch):
    events = []

    def record(name):
        real = getattr(nmm.NodeManager, name)

        def wrapped(self, *args, **kwargs):
            handle = args[0] if args else None
            events.append((name, time.monotonic(),
                           list(getattr(handle, "gpus", None) or [])))
            return real(self, *args, **kwargs)

        monkeypatch.setattr(nmm.NodeManager, name, wrapped)

    for name in ("_kill_worker_process", "_on_disconnect", "_release_gpus"):
        record(name)
    real_start = nmm.NodeManager._start_worker_inner

    async def start(self, actor_id=b"", gpu_grant=0.0):
        handle = await real_start(self, actor_id, gpu_grant)
        events.append(("granted", time.monotonic(), list(handle.gpus)))
        return handle

    monkeypatch.setattr(nmm.NodeManager, "_start_worker_inner", start)
    ray_tpu_torch.init(num_cpus=2, num_gpus=1,
                       object_store_memory=64 * 1024 * 1024,
                       log_to_driver=False)
    yield events
    ray_tpu_torch.shutdown()


@ray_tpu_torch.remote(num_gpus=1)
class _Holder:
    def where(self):
        return os.getpid(), os.environ.get("CUDA_VISIBLE_DEVICES")


def test_killed_workers_card_is_released_at_its_disconnect(trace):
    first = _Holder.remote()
    pid1, card1 = ray_tpu_torch.get(first.where.remote(), timeout=120)
    t0 = time.monotonic()
    trace.append(("kill_call", t0, []))
    ray_tpu_torch.kill(first)
    second = _Holder.remote()
    pid2, card2 = ray_tpu_torch.get(second.where.remote(), timeout=120)
    after = [(n, (t - t0) * 1e3, g) for n, t, g in trace if t >= t0]
    for name, ms, gpus in after:
        print(f"{name:22s} {ms:9.2f} ms {gpus}")
    names = [n for n, _, _ in after]
    kill = names.index("_kill_worker_process")
    gone = names.index("_on_disconnect", kill)
    release = names.index("_release_gpus", gone)
    grant = names.index("granted", release)
    # the card is returned in the disconnect handler, before the grant
    assert after[kill][2] == after[release][2] == [0]
    assert after[release][1] - after[kill][1] < RELEASE_S * 1e3
    assert after[grant][2] == [0]
    assert (card1, card2) == ("0", "0") and pid2 != pid1
