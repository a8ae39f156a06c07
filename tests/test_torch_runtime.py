"""The port's core runtime against the JAX package's.

Each case is one small program written against a runtime module
``rt``; it runs through ``ray_tpu`` and then through ``ray_tpu_torch``
and the two results must be equal: values, exception types and
messages, resources.  Both runtimes are up at once in this process (one
of each per module): their session ids, shm names and session
directories are random, so they do not meet.

Grants: with two accelerators on each node, the same sequence of
grants gives the same card indices in the port's CUDA_VISIBLE_DEVICES
as the JAX package's chip indices in TPU_VISIBLE_CHIPS.
"""

import os
import sys
import time

import numpy as np
import pytest

import ray_tpu
import ray_tpu_torch
from ray_tpu._private.node_manager import pick_tpu_chips
from ray_tpu_torch._private._vendor import cloudpickle as port_cloudpickle
from ray_tpu_torch._private.node_manager import pick_gpus
# autouse: the JAX runtime's loops settle before they stop
from tests.test_torch_jax_teardown import settle_jax_loops  # noqa: F401

# what this module defines travels by value to the port's workers, so
# they never import this file (and the JAX package it imports)
port_cloudpickle.register_pickle_by_value(sys.modules[__name__])

STORE = 128 * 1024 * 1024
#: the longest a test waits for one result
WAIT_S = 120


@pytest.fixture(scope="module")
def runtimes():
    ray_tpu.init(num_cpus=4, num_tpus=2, object_store_memory=STORE,
                 log_to_driver=False)
    ray_tpu_torch.init(num_cpus=4, num_gpus=2, object_store_memory=STORE,
                       log_to_driver=False,
                       _system_config={"gpus_per_host": 2})
    yield {"jax": ray_tpu, "torch": ray_tpu_torch}
    ray_tpu_torch.shutdown()
    ray_tpu.shutdown()


def _same(a, b):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return (type(a) is type(b) and a.dtype == b.dtype
                and np.array_equal(a, b))
    if isinstance(a, (list, tuple)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(_same(x, y) for x, y in zip(a, b)))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    return type(a) is type(b) and a == b


# ---- the programs ----------------------------------------------------

def prog_put_get(rt):
    values = [np.arange(12, dtype=np.int32).reshape(3, 4),
              {"a": (1, 2), "b": [b"x", None], "c": 2.5},
              "text", 7, b"raw bytes",
              # past the inline limit: through the shared-memory store
              np.random.default_rng(0).standard_normal((512, 512))]
    return [rt.get(rt.put(v), timeout=WAIT_S) for v in values]


def prog_tasks(rt):
    @rt.remote
    def add(a, b):
        return a + b

    @rt.remote(num_returns=2)
    def split(x):
        return x[:2], x[2:]

    @rt.remote
    def inner(n):
        return np.full(n, n)

    @rt.remote
    def outer(n):
        # a task that submits a task and waits on it
        return rt.get(inner.remote(n), timeout=WAIT_S).sum() + 1

    x = rt.put(np.arange(5.0))
    head, tail = split.remote(x)
    total = add.remote(add.remote(head, head), 1.0)
    return [rt.get(head, timeout=WAIT_S), rt.get(tail, timeout=WAIT_S),
            rt.get(total, timeout=WAIT_S),
            rt.get(outer.remote(4), timeout=WAIT_S),
            rt.get([add.remote(i, i) for i in range(4)], timeout=WAIT_S)]


def prog_task_error(rt):
    @rt.remote
    def boom(x):
        raise ValueError(f"bad input {x}")

    @rt.remote
    def passthrough(v):
        return v

    out = []
    for ref in (boom.remote(3), passthrough.remote(boom.remote(4))):
        try:
            rt.get(ref, timeout=WAIT_S)
            out.append(None)
        except Exception as e:  # noqa: BLE001 - the chain is the result
            chain = [c.__name__ for c in type(e).__mro__
                     if c.__module__.endswith("exceptions")]
            out.append([chain, type(e.cause).__name__, str(e.cause),
                         e.cause_repr, str(e).split("\n")[0]])
    return out


def prog_wait_timeout(rt):
    @rt.remote
    def fast():
        return 1

    @rt.remote
    def slow():
        time.sleep(3)
        return 2

    f, s = fast.remote(), slow.remote()
    ready, rest = rt.wait([f, s], num_returns=1, timeout=60)
    first = ([r == f for r in ready], [r == s for r in rest])
    ready, rest = rt.wait([f, s], num_returns=2, timeout=0.2)
    second = (len(ready), len(rest))
    try:
        rt.get(s, timeout=0.2)
        timed_out = None
    except Exception as e:  # noqa: BLE001
        timed_out = [type(e).__name__, isinstance(e, TimeoutError)]
    return [first, second, timed_out, rt.get(s, timeout=60)]


def prog_actors(rt):
    @rt.remote
    class Counter:
        def __init__(self, start):
            self.n = start

        def inc(self, k=1):
            self.n += k
            return self.n

    c = Counter.options(name="counter").remote(10)
    seq = rt.get([c.inc.remote() for _ in range(3)], timeout=WAIT_S)
    again = rt.get(rt.get_actor("counter").inc.remote(5),
                   timeout=WAIT_S)
    rt.kill(c)
    try:
        rt.get(c.inc.remote(), timeout=60)
        after_kill = None
    except Exception as e:  # noqa: BLE001
        after_kill = type(e).__name__
    return [seq, again, after_kill]


def prog_cluster_resources(rt):
    res = {k: v for k, v in rt.cluster_resources().items()
           if not k.startswith("node:")}
    # the accelerator: the JAX package's TPU chips, the port's cards
    res["accelerator"] = res.pop("TPU", None) or res.pop("GPU", None)
    return [res, len(rt.nodes())]


PROGRAMS = [prog_put_get, prog_tasks, prog_task_error, prog_wait_timeout,
            prog_actors, prog_cluster_resources]


@pytest.mark.parametrize("program", PROGRAMS, ids=lambda p: p.__name__)
def test_program_matches_jax_runtime(runtimes, program):
    want = program(runtimes["jax"])
    got = program(runtimes["torch"])
    assert _same(got, want), (got, want)


# ---- grants ------------------------------------------------------------

def _grant_sequence(rt, key, env):
    """Card (chip) indices each grant sees, in a fixed sequence: two
    one-card tasks (the pooled worker is reused), two one-card actors
    (the second retires the idle task worker to free its card), then,
    with both actors killed, a two-card task."""

    @rt.remote(**{key: 1})
    def one():
        return os.environ[env]

    @rt.remote(**{key: 2})
    def two():
        return os.environ[env]

    @rt.remote(**{key: 1})
    class Holder:
        def visible(self):
            return os.environ[env]

    seq = [rt.get(one.remote(), timeout=WAIT_S),
           rt.get(one.remote(), timeout=WAIT_S)]
    holders = [Holder.remote(), None]
    seq.append(rt.get(holders[0].visible.remote(), timeout=WAIT_S))
    holders[1] = Holder.remote()
    seq.append(rt.get(holders[1].visible.remote(), timeout=WAIT_S))
    for h in holders:
        rt.kill(h)
    seq.append(rt.get(two.remote(), timeout=60))
    return seq


def test_grants_match_jax_chip_grants(runtimes):
    want = _grant_sequence(runtimes["jax"], "num_tpus", "TPU_VISIBLE_CHIPS")
    got = _grant_sequence(runtimes["torch"], "num_gpus",
                          "CUDA_VISIBLE_DEVICES")
    assert got == want
    assert got == ["1", "1", "0", "1", "0,1"]


def test_task_without_grant_sees_no_card(runtimes):
    rt = runtimes["torch"]

    @rt.remote
    def probe():
        return [os.environ.get("CUDA_VISIBLE_DEVICES"),
                rt.get_runtime_context().get_gpu_ids()]

    @rt.remote(num_gpus=1)
    def granted():
        return [os.environ.get("CUDA_VISIBLE_DEVICES"),
                rt.get_runtime_context().get_gpu_ids()]

    assert rt.get(probe.remote(), timeout=WAIT_S) == ["", []]
    visible, ids = rt.get(granted.remote(), timeout=WAIT_S)
    assert [int(c) for c in visible.split(",")] == ids and len(ids) == 1


@pytest.mark.parametrize("free,need", [
    ([0, 1], 1), ([0, 1, 2, 3], 2), ([0, 2, 3], 1), ([0, 2, 3, 5, 6, 7], 2),
    ([1, 3, 5], 2), ([], 1), ([0, 1, 2], 0)])
def test_pick_gpus_is_the_chip_rule(free, need):
    assert pick_gpus(list(free), need) == pick_tpu_chips(list(free), need)


@pytest.mark.parametrize("opts,match", [
    ({"num_gpus": 0.5}, "whole number of cards"),
    ({"num_gpus": 1.5}, "whole number of cards"),
    ({"num_tpus": 1}, "num_gpus"),
])
def test_unsupported_accelerator_options_raise(runtimes, opts, match):
    rt = runtimes["torch"]

    def f():
        return 1

    class A:
        pass

    with pytest.raises(ValueError, match=match):
        rt.remote(**opts)(f).remote()
    with pytest.raises(ValueError, match=match):
        rt.remote(**opts)(A).remote()


def test_init_names_num_gpus_and_unported_parts(runtimes):
    """What still raises: the JAX package's accelerator option names the
    port's, and the rllib CLI names the ROADMAP.md item of an algorithm
    not ported yet.  The dashboard
    starts (on a free port) and answers with this runtime's node
    (test_torch_dashboard.py holds every route to the JAX package's)."""
    import json
    import urllib.request

    from ray_tpu_torch.dashboard import start_dashboard
    from ray_tpu_torch.dashboard.app import DASHBOARD_NAME
    from ray_tpu_torch.scripts import cli

    with pytest.raises(ValueError, match="num_gpus"):
        ray_tpu_torch.init(num_tpus=1)
    for sub, part in ((["train", "--run", "DQN", "--env", "x"], "b"),
                      (["evaluate", "ckpt", "--run", "SAC", "--env", "x"],
                       "c"),
                      (["train", "--run", "Dreamer", "--env", "x"], "d")):
        with pytest.raises(NotImplementedError,
                           match=rf"queue 1 item 7\.13 \({part}\)"):
            cli.main(["rllib", *sub])
    url = start_dashboard(port=0)
    try:
        with urllib.request.urlopen(url + "/api/nodes", timeout=60) as r:
            nodes = json.loads(r.read())
        assert [n["node_id"] for n in nodes] == \
            [n["NodeID"] for n in ray_tpu_torch.nodes()]
    finally:
        ray_tpu_torch.kill(ray_tpu_torch.get_actor(DASHBOARD_NAME))


@pytest.mark.parametrize("visible,names", [
    (None, ["0", "1"]), ("5,7", ["5", "7"]), ("3, 1,2", ["3", "1"]),
    ("", ["0", "1"]), ("4", ["0", "1"])])
def test_grant_names_follow_the_nodes_visible_cards(tmp_path, monkeypatch,
                                                    visible, names):
    """A grant's indices name the cards the node itself sees: through
    its own CUDA_VISIBLE_DEVICES where that lists at least the cards it
    offers, else the indices themselves."""
    from ray_tpu_torch._private.config import Config
    from ray_tpu_torch._private.ids import NodeID
    from ray_tpu_torch._private.node_manager import NodeManager

    if visible is None:
        monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    else:
        monkeypatch.setenv("CUDA_VISIBLE_DEVICES", visible)
    nm = NodeManager(NodeID.from_random(), str(tmp_path), Config(),
                     {"CPU": 1.0, "GPU": 2.0}, "/raytpu_torch_unused",
                     str(tmp_path / "gcs"))
    assert [nm._gpu_names[i] for i in nm._gpus_free] == names


def test_a_lone_task_after_a_drained_burst_gets_a_lease(runtimes,
                                                        monkeypatch):
    """Regression: a lease granted after its burst's queue drained is
    handed back while its request still counts as in flight; a task
    submitted in that window asked for no lease of its own and waited
    forever (tests/test_torch_dag_state.py's lone ``cube`` hung the test
    suite).  Each lease's hand-back is slowed by 0.5 s to hold the window
    open, and lone tasks are submitted one after another across it: each
    must come back within its bound."""
    import asyncio

    from ray_tpu_torch._private import protocol

    call = protocol.Connection.call

    async def slow_hand_back(self, method, payload=None, timeout=None):
        if method == "return_worker":
            await asyncio.sleep(0.5)
        return await call(self, method, payload, timeout)

    monkeypatch.setattr(protocol.Connection, "call", slow_hand_back)

    @ray_tpu_torch.remote
    def nap(i):
        time.sleep(0.05)
        return i

    assert ray_tpu_torch.get([nap.remote(i) for i in range(8)],
                             timeout=WAIT_S) == list(range(8))
    # the burst's leases go back, then the requests queued behind them
    # are granted and go back in turn: lone tasks, one after another,
    # cover that stretch
    t0 = time.monotonic()
    while time.monotonic() - t0 < 2.5:
        assert ray_tpu_torch.get(nap.remote(-1), timeout=10) == -1
