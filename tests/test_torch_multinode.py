"""The port's multi-node runtime against the JAX package's.

Mirrors tests/test_multinode.py: each program runs on an in-process
``Cluster`` of the JAX package (``ray_tpu.cluster_utils``) and on one
of the port's (``ray_tpu_torch.cluster_utils``), several node managers
on this host, a driver attached to each with ``init(address=...)``;
the two results must be equal.  Beside the reference's seven cases:
the accelerator grant across nodes (a node with two fake cards stands
in for the card), a node removed while an object is pulled from it,
and ``init(address="auto")`` through ``RAYTPU_ADDRESS``.
"""

import os
import sys
import threading
import time

import numpy as np
import pytest

import ray_tpu
import ray_tpu_torch
from ray_tpu.cluster_utils import Cluster as JaxCluster
from ray_tpu_torch._private._vendor import cloudpickle as port_cloudpickle
from ray_tpu_torch.cluster_utils import Cluster as PortCluster
# autouse: the JAX runtime's loops settle before they stop
from tests.test_torch_jax_teardown import settle_jax_loops  # noqa: F401

# what this module defines travels by value to the port's workers, so
# they never import this file (and the JAX package it imports)
port_cloudpickle.register_pickle_by_value(sys.modules[__name__])

STORE = 128 * 1024 * 1024
#: the accelerator option and resource of each package
ACCEL = {"jax": ("num_tpus", "TPU"), "torch": ("num_gpus", "GPU")}


def _cluster(kind, nodes=2, accel=0):
    """A head without CPUs, ``nodes`` worker nodes of 2 CPUs (the first
    offering ``accel`` accelerators), a driver attached."""
    key, _ = ACCEL[kind]
    if kind == "jax":
        c = JaxCluster(head_num_cpus=0, object_store_memory=STORE)
    else:
        c = PortCluster(head_num_cpus=0, object_store_memory=STORE)
    for i in range(nodes):
        c.add_node(num_cpus=2, **{key: accel if i == 0 else 0})
    c.connect(log_to_driver=False)
    return c


def _teardown(rt, c):
    rt.shutdown()
    c.shutdown()


@pytest.fixture
def clusters():
    """One cluster of each package, the first worker node offering two
    fake accelerators (the card's stand-in)."""
    out = {}
    try:
        out["jax"] = (ray_tpu, _cluster("jax", accel=2))
        out["torch"] = (ray_tpu_torch, _cluster("torch", accel=2))
        yield out
    finally:
        for rt, c in out.values():
            _teardown(rt, c)


# ---- the programs ------------------------------------------------------

def prog_spill_to_worker_nodes(rt, c):
    """The head has 0 CPUs: every task must spill to a worker node."""

    @rt.remote(num_cpus=1)
    def whoami():
        return os.environ.get("RAYTPU_NODE_ID")

    nodes = set(rt.get([whoami.remote() for _ in range(8)], timeout=120))
    workers = {n.node_id.hex() for n in c.worker_nodes}
    return [len(nodes) >= 1, nodes <= workers,
            c.head.node_id.hex() in nodes]


def prog_large_return_and_arg(rt, c):
    """Large (shm) values travel node to node through the object plane
    in both directions."""

    @rt.remote(num_cpus=1)
    def produce():
        return np.arange(500_000, dtype=np.int64)  # ~4MB, not inline

    @rt.remote(num_cpus=1)
    def consume(arr):
        return int(arr.sum()), str(arr.dtype)

    ref = produce.remote()
    arr = rt.get(ref, timeout=120)
    return [arr.shape, int(arr.sum()), rt.get(consume.remote(ref),
                                              timeout=120)]


def prog_actor_on_remote_node(rt, c):
    @rt.remote(num_cpus=1)
    class Counter:
        def __init__(self):
            self.x = 0

        def bump(self):
            self.x += 1
            return self.x, os.environ.get("RAYTPU_NODE_ID")

    a = Counter.remote()
    # the first call waits for the actor: the JAX package sends calls
    # made while its actor starts in the order their address lookups come
    # back (the port keeps submission order, as the order test below
    # checks), so the rest go to a started actor
    out = [rt.get(a.bump.remote(), timeout=60)]
    out += rt.get([a.bump.remote() for _ in range(4)], timeout=60)
    workers = {n.node_id.hex() for n in c.worker_nodes}
    return [[x for x, _ in out], len({n for _, n in out}),
            out[0][1] in workers]


def prog_infeasible_everywhere(rt, c):
    @rt.remote(num_cpus=64)
    def big():
        return 1

    try:
        rt.get(big.remote(), timeout=5)
        return None
    except Exception as e:  # noqa: BLE001 - the exception is the result
        return [type(e).__name__, isinstance(e, TimeoutError)]


def prog_chunked_transfer(rt, c):
    """A transfer much larger than the 4MiB chunk size streams across
    nodes in bounded chunks (reference: pull_manager.h:48 admission
    control) and arrives intact."""

    @rt.remote(num_cpus=1)
    def produce():
        # ~48MiB: 12 chunks at the default 4MiB chunk size
        rng = np.random.default_rng(7)
        return rng.integers(0, 255, size=48 * 1024 * 1024 // 8,
                            dtype=np.int64)

    @rt.remote(num_cpus=1)
    def digest(arr):
        return int(arr.sum()), arr.shape[0]

    ref = produce.remote()
    arr = rt.get(ref, timeout=300)  # pulled to the driver's node
    got = rt.get(digest.remote(ref), timeout=300)
    return [int(arr.sum()), arr.shape[0], got]


def prog_accelerator_grant(rt, c):
    """A task asking for one accelerator lands on the node that offers
    them and sees one of its cards (chips); tasks elsewhere see none.
    Which of the two a pooled worker holds varies from run to run in
    the JAX package too: the grant sequence's indices are compared in
    test_torch_runtime.py, on one node."""
    kind = "jax" if rt is ray_tpu else "torch"
    key, res = ACCEL[kind]
    env = "TPU_VISIBLE_CHIPS" if kind == "jax" else "CUDA_VISIBLE_DEVICES"

    @rt.remote(**{key: 1})
    def granted():
        return os.environ.get("RAYTPU_NODE_ID"), os.environ.get(env)

    @rt.remote(num_cpus=1)
    def plain():
        return os.environ.get("RAYTPU_NODE_ID"), os.environ.get(env, "")

    home = c.worker_nodes[0].node_id.hex()
    g = rt.get([granted.remote() for _ in range(3)], timeout=120)
    p = rt.get([plain.remote() for _ in range(4)], timeout=120)
    total = rt.cluster_resources().get(res)
    return [total, [n == home for n, _ in g],
            [v in ("0", "1") for _, v in g], sorted({v for _, v in p})]


def prog_node_death_fails_actor(rt, c):
    """Killing a node surfaces as actor death (GCS heartbeat failure
    detection; reference gcs_heartbeat_manager.h:36), with the JAX
    package's exception classes."""
    @rt.remote(num_cpus=1)
    class Pinned:
        def node(self):
            return os.environ.get("RAYTPU_NODE_ID")

        def ping(self):
            return 1

    actors = [Pinned.remote() for _ in range(2)]
    homes = rt.get([a.node.remote() for a in actors], timeout=60)
    victim = next(n for n in c.worker_nodes if n.node_id.hex() in homes)
    actor = actors[homes.index(victim.node_id.hex())]
    c.remove_node(victim)
    deadline = time.monotonic() + 40
    while time.monotonic() < deadline:
        try:
            rt.get(actor.ping.remote(), timeout=10)
        except Exception as e:  # noqa: BLE001 - the death is the result
            return [c.__name__ for c in type(e).__mro__
                    if c.__module__.endswith("exceptions")]
        time.sleep(0.5)
    return None


PROGRAMS = [prog_spill_to_worker_nodes, prog_large_return_and_arg,
            prog_actor_on_remote_node, prog_infeasible_everywhere,
            prog_chunked_transfer, prog_node_death_fails_actor]


@pytest.mark.parametrize("program", PROGRAMS, ids=lambda p: p.__name__)
def test_program_matches_jax_cluster(clusters, program):
    want = program(*clusters["jax"])
    got = program(*clusters["torch"])
    assert got == want
    assert got is not None


def test_accelerator_grant_lands_on_the_node_with_cards(clusters):
    """Two fake cards on the first worker node, none on the head or the
    second: the JAX package's chip grant and the port's card grant land
    alike, and a task with no grant sees an empty visibility variable
    (the port's workers ``CUDA_VISIBLE_DEVICES=""``)."""
    want = prog_accelerator_grant(*clusters["jax"])
    got = prog_accelerator_grant(*clusters["torch"])
    assert got == want
    total, on_home, one_card, plain = got
    assert total == 2.0 and all(on_home) and all(one_card)
    assert plain == [""]


def test_node_removed_mid_pull(caplog):
    """A node removed while the driver pulls a large object from it: the
    chunked pull fails and aborts its unsealed create (the process
    survives it), and the driver's get either re-executes the task on
    the node left (lineage reconstruction) and gets the whole value, or
    raises the runtime's error with no half-written copy in the store;
    the cluster keeps serving."""
    from ray_tpu_torch._private.config import Config

    rt = ray_tpu_torch
    # small chunks, one in flight: the driver's pull takes long enough
    # (12288 round trips) for the node to go in its middle
    slow = {"object_transfer_chunk_bytes": 8 * 1024,
            "object_transfer_max_inflight_chunks": 1}
    config = Config().apply_env()
    config.apply_dict(slow)
    c = PortCluster(head_num_cpus=0, object_store_memory=STORE,
                    config=config)
    for _ in range(2):
        c.add_node(num_cpus=2)
    c.connect(log_to_driver=False, _system_config=slow)
    try:
        @rt.remote(num_cpus=2)
        def produce():
            return np.ones(96 * 1024 * 1024 // 8, dtype=np.int64), \
                os.environ.get("RAYTPU_NODE_ID")

        @rt.remote(num_cpus=1)
        def echo(x):
            return x

        # both returns are sealed together: once the node id is back, the
        # array is whole on its node and nowhere else
        ref, where = produce.options(num_returns=2).remote()
        home = rt.get(where, timeout=120)
        victim = next(n for n in c.worker_nodes
                      if n.node_id.hex() == home)
        errors = []

        def pull():
            try:
                arr = rt.get(ref, timeout=60)
                errors.append(("ok", arr.shape == (96 * 1024 * 1024 // 8,)
                               and bool((arr == 1).all())))
            except Exception as e:  # noqa: BLE001 - the failure is read
                errors.append(("raised", type(e).__name__))

        t = threading.Thread(target=pull)
        t.start()
        time.sleep(0.1)
        c.remove_node(victim)
        t.join(timeout=90)
        assert not t.is_alive()
        assert any("pull failed" in r.getMessage()
                   for r in caplog.records), "the node went after the pull"
        (kind, what), = errors
        from ray_tpu_torch._private import worker_context
        from ray_tpu_torch._private.ids import ObjectID

        store = worker_context.node().store_owner
        if kind == "ok":
            assert what, "the reconstructed value differs"
        else:
            assert what in ("ObjectLostError", "GetTimeoutError",
                            "RayTaskError"), errors
            assert not store.contains(ObjectID(ref.binary()))
        # the rest of the cluster still runs tasks and moves objects
        big = np.arange(300_000, dtype=np.int64)
        assert rt.get(echo.remote(big), timeout=120).sum() == big.sum()
    finally:
        _teardown(rt, c)


def _local_non_loopback_ip():
    """An IPv4 address of this host that is not loopback, read from the
    kernel's table of local addresses (no packet leaves the host)."""
    try:
        with open("/proc/net/fib_trie") as f:
            lines = f.read().splitlines()
    except OSError:
        return None
    for prev, line in zip(lines, lines[1:]):
        if "/32 host LOCAL" in line:
            ip = prev.strip().lstrip("|-+ ").strip()
            if ip and not ip.startswith("127."):
                return ip
    return None


def _tcp_program(rt, node_cls, ip, key):
    head = node_cls(head=True, num_cpus=0, **{key: 0},
                    object_store_memory=STORE, gcs_address=f"{ip}:0")
    head.start()
    worker_node = node_cls(head=False, num_cpus=2, **{key: 0},
                           object_store_memory=STORE,
                           gcs_address=head.gcs_address)
    worker_node.start()
    try:
        rt.init(address=head.gcs_address, log_to_driver=False)

        @rt.remote(num_cpus=1)
        def where():
            return os.environ.get("RAYTPU_NODE_ADDRESS", "")

        @rt.remote(num_cpus=1)
        def big():
            return np.arange(400_000, dtype=np.int64)

        addr = rt.get(where.remote(), timeout=120)
        total = int(rt.get(big.remote(), timeout=120).sum())
        return [head.node_address.startswith("/"),
                worker_node.node_address.startswith("/"),
                addr.startswith("/"), total]
    finally:
        rt.shutdown()
        worker_node.stop()
        head.stop()


def test_tcp_transport_cluster():
    """A cluster whose GCS is on a non-loopback address runs node
    managers AND workers over TCP (unix socket paths cannot be dialed
    across machines), and moves objects over it."""
    from ray_tpu._private.node import Node as JaxNode
    from ray_tpu_torch._private.node import Node as PortNode

    ip = _local_non_loopback_ip()
    if ip is None:
        pytest.skip("no non-loopback interface on this host")
    want = _tcp_program(ray_tpu, JaxNode, ip, "num_tpus")
    got = _tcp_program(ray_tpu_torch, PortNode, ip, "num_gpus")
    assert got == want
    assert got[:3] == [False, False, False]


def _auto_attach(rt, c):
    """init(address="auto") and init() with RAYTPU_ADDRESS attach to the
    cluster; "auto" without it raises ConnectionError."""
    out = []
    old = os.environ.get("RAYTPU_ADDRESS")
    try:
        os.environ["RAYTPU_ADDRESS"] = c.gcs_address
        for addr in ("auto", None):
            info = rt.init(address=addr, log_to_driver=False)
            out.append([info["gcs_address"] == c.gcs_address,
                        len(rt.nodes())])
            rt.shutdown()
        del os.environ["RAYTPU_ADDRESS"]
        try:
            rt.init(address="auto")
            out.append(None)
        except ConnectionError as e:
            out.append(str(e))
    finally:
        if old is not None:
            os.environ["RAYTPU_ADDRESS"] = old
        else:
            os.environ.pop("RAYTPU_ADDRESS", None)
    return out


def test_init_auto_reads_raytpu_address():
    out = {}
    for kind, rt, cls in (("jax", ray_tpu, JaxCluster),
                          ("torch", ray_tpu_torch, PortCluster)):
        c = cls(head_num_cpus=0, object_store_memory=STORE)
        c.add_node(num_cpus=1)
        try:
            out[kind] = _auto_attach(rt, c)
        finally:
            rt.shutdown()
            c.shutdown()
    assert out["torch"] == out["jax"]
    assert out["torch"][0] == [True, 3]


def test_calls_to_a_starting_remote_actor_keep_their_order():
    """Calls submitted while their actor is still starting on another node
    are sent, and so run, in submission order (each takes its turn as it
    is submitted), including calls whose argument is still being
    computed: the reference's sequential actor submitter.  The JAX
    package's copy sends them in the order their address lookups come
    back, so this case holds the port alone."""
    rt = ray_tpu_torch
    c = _cluster("torch", nodes=1)
    try:
        @rt.remote(num_cpus=1)
        class Log:
            def __init__(self):
                time.sleep(0.5)  # the calls below park on its address
                self.seen = []

            def add(self, i):
                self.seen.append(i)
                return list(self.seen)

        @rt.remote(num_cpus=1)
        def late(i):
            time.sleep(0.3)
            return i

        for _ in range(3):
            log = Log.remote()
            refs = [log.add.remote(late.remote(i) if i == 5 else i)
                    for i in range(30)]
            assert rt.get(refs[-1], timeout=120) == list(range(30))
            rt.kill(log)
    finally:
        _teardown(rt, c)
