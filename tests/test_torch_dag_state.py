"""The port's ``dag`` (``.bind()``, ``InputNode``, ``execute``) and
``util/state.py`` (``list_*``, ``summarize_*``, ``timeline``) against
the JAX package's.

Mirrors tests/test_dag.py: the same DAG programs give the same results
in both runtimes (a diamond, a shared node executed once, an actor DAG,
kwargs and nested containers).  After a fixed program, the state API
lists and summarizes alike, and ``timeline()`` writes chrome-trace
events with the same names, categories and phases.  Both runtimes are
up at once.
"""

import json
import sys

import pytest

import ray_tpu
import ray_tpu_torch
from ray_tpu.dag import InputNode as JaxInputNode
from ray_tpu_torch._private._vendor import cloudpickle as port_cloudpickle
from ray_tpu_torch.dag import InputNode as PortInputNode
# autouse: the JAX runtime's loops settle before they stop
from tests.test_torch_jax_teardown import settle_jax_loops  # noqa: F401

port_cloudpickle.register_pickle_by_value(sys.modules[__name__])

STORE = 128 * 1024 * 1024
#: the longest a test waits for one result
WAIT_S = 120


@pytest.fixture(scope="module")
def runtimes():
    ray_tpu.init(num_cpus=4, object_store_memory=STORE, log_to_driver=False)
    ray_tpu_torch.init(num_cpus=4, num_gpus=0, object_store_memory=STORE,
                       log_to_driver=False)
    yield {"jax": (ray_tpu, JaxInputNode), "torch": (ray_tpu_torch,
                                                     PortInputNode)}
    ray_tpu_torch.shutdown()
    ray_tpu.shutdown()


def prog_function_diamond(rt, InputNode, tmp):
    @rt.remote
    def source(x):
        return x + 1

    @rt.remote
    def left(s):
        return s * 2

    @rt.remote
    def right(s):
        return s * 3

    @rt.remote
    def join(a, b):
        return a + b

    with InputNode() as inp:
        s = source.bind(inp)
        dag = join.bind(left.bind(s), right.bind(s))
    # (x+1)*2 + (x+1)*3 = 5x + 5, re-executable with new input
    return [rt.get(dag.execute(4), timeout=WAIT_S),
            rt.get(dag.execute(0), timeout=WAIT_S)]


def prog_shared_node_executes_once(rt, InputNode, tmp):
    @rt.remote
    def effect(path):
        # count executions through the filesystem (workers are
        # separate processes)
        with open(path, "a") as f:
            f.write("1")
        return path

    @rt.remote
    def reader(p1, p2):
        with open(p1) as f:
            return f.read(), p1 == p2

    shared = effect.bind(str(tmp / "count"))
    dag = reader.bind(shared, shared)
    return rt.get(dag.execute(), timeout=WAIT_S)


def prog_actor_dag(rt, InputNode, tmp):
    @rt.remote
    class Accum:
        def __init__(self, start):
            self.total = start

        def add(self, x):
            self.total += x
            return self.total

    with InputNode() as inp:
        acc = Accum.bind(10)
        dag = acc.add.bind(inp)
    # each execute() creates a fresh actor, as in the reference
    return [rt.get(dag.execute(5), timeout=WAIT_S),
            rt.get(dag.execute(7), timeout=WAIT_S)]


def prog_kwargs_and_nested_containers(rt, InputNode, tmp):
    @rt.remote
    def f(x):
        return x * 10

    @rt.remote
    def g(items, scale=1, extra=None):
        return sum(items) * scale + sum(extra.values())

    with InputNode(key="k") as inp:
        dag = g.bind([f.bind(1), f.bind(2)], scale=2,
                     extra={"a": f.bind(inp), "b": 1})
    return rt.get(dag.execute(k=3), timeout=WAIT_S)


PROGRAMS = [prog_function_diamond, prog_shared_node_executes_once,
            prog_actor_dag, prog_kwargs_and_nested_containers]


@pytest.mark.parametrize("program", PROGRAMS, ids=lambda p: p.__name__)
def test_dag_matches_jax(runtimes, program, tmp_path):
    out = {}
    for key, (rt, inp) in runtimes.items():
        d = tmp_path / key
        d.mkdir()
        out[key] = program(rt, inp, d)
    assert out["torch"] == out["jax"]


def test_bind_returns_the_dag_nodes():
    from ray_tpu_torch.dag import ClassNode, ClassMethodNode, FunctionNode

    fn = ray_tpu_torch.remote(lambda x: x)
    node = fn.bind(1)
    assert isinstance(node, FunctionNode)

    class A:
        def m(self, x):
            return x

    cls_node = ray_tpu_torch.remote(A).bind()
    assert isinstance(cls_node, ClassNode)
    assert isinstance(cls_node.m.bind(2), ClassMethodNode)


# ---- the state API after one program --------------------------------

def _state_program(rt):
    """A fixed program: named tasks, a named actor and a placement
    group; then what the state API says about it."""
    import importlib
    import time

    state = importlib.import_module(f"{rt.__name__}.util.state")
    pgmod = importlib.import_module(f"{rt.__name__}.util.placement_group")

    @rt.remote
    def square(x):
        return x * x

    @rt.remote
    def cube(x):
        return x ** 3

    @rt.remote
    class Keeper:
        def __init__(self, v):
            self.v = v

        def get(self):
            return self.v

    # one burst: a lone task submitted right after a burst drained can
    # wait forever in the JAX package's client (a lease request's
    # return of its late lease holds the in-flight count, so the lone
    # task asks for no lease; the port's client asks again)
    squares = [square.remote(i) for i in range(5)]
    cubed = cube.remote(2)
    assert rt.get(squares, timeout=WAIT_S) == [i * i for i in range(5)]
    assert rt.get(cubed, timeout=WAIT_S) == 8
    k = Keeper.options(name="keeper").remote(3)
    assert rt.get(k.get.remote(), timeout=WAIT_S) == 3
    # small bundles: the actor DAG's actors still hold their CPUs
    pg = pgmod.placement_group([{"CPU": 0.25}, {"CPU": 0.25}],
                               strategy="PACK", name="state_pg")
    pg.ready(timeout=60)
    # workers flush their task events about every 1 s
    deadline = time.monotonic() + 20
    while time.monotonic() < deadline:
        tasks = state.summarize_tasks()
        if tasks["by_func_name"].get("square") == 5 and \
                tasks["by_func_name"].get("get") == 1:
            break
        time.sleep(0.2)
    actors = state.summarize_actors()
    nodes = state.list_nodes()
    listed_actors = [a for a in state.list_actors() if a["name"] == "keeper"]
    pgs = [p for p in state.list_placement_groups()
           if p["name"] == "state_pg"]
    pgmod.remove_placement_group(pg)
    rt.kill(k)
    return {
        "tasks_by_name": {n: c for n, c in tasks["by_func_name"].items()
                          if n in ("square", "cube", "get")},
        "task_keys": sorted(tasks),
        "actor_states": sorted(actors["by_state"]),
        "nodes": [[n["alive"], sorted(n), n["resources"]["CPU"]]
                  for n in nodes],
        "actor": [[a["state"], a["num_restarts"], sorted(a)]
                  for a in listed_actors],
        "pg": [[p["state"], p["strategy"], p["bundles"], sorted(p)]
               for p in pgs],
    }


def test_state_lists_and_summaries_match_jax(runtimes):
    want = _state_program(runtimes["jax"][0])
    got = _state_program(runtimes["torch"][0])
    assert got == want
    assert got["tasks_by_name"] == {"square": 5, "cube": 1, "get": 1}


def _timeline(rt, path):
    @rt.remote
    def tick(i):
        return i

    rt.get([tick.remote(i) for i in range(3)], timeout=WAIT_S)
    import time

    deadline = time.monotonic() + 20  # the workers' task-event flush
    while time.monotonic() < deadline:
        events = rt.timeline(str(path))
        if sum(e["name"] == "tick" for e in events) >= 3:
            break
        time.sleep(0.2)
    with open(path) as f:
        on_disk = json.load(f)
    ticks = [e for e in events if e["name"] == "tick"]
    return {"on_disk": on_disk == json.loads(json.dumps(events)),
            "ticks": len(ticks),
            "shape": sorted({(e["cat"], e["ph"], tuple(sorted(e)),
                              tuple(sorted(e["args"]))) for e in ticks}),
            "durations_ok": all(e["dur"] >= 0 for e in ticks)}


def test_timeline_events_match_jax(runtimes, tmp_path):
    want = _timeline(runtimes["jax"][0], tmp_path / "jax.json")
    got = _timeline(runtimes["torch"][0], tmp_path / "torch.json")
    assert got == want
    assert got["ticks"] == 3 and got["on_disk"]
    assert got["shape"] == [("task", "X", ("args", "cat", "dur", "name",
                                           "ph", "pid", "tid", "ts"),
                             ("actor_id", "task_id"))]


def test_profile_device_writes_a_torch_trace(tmp_path):
    """``profile_device`` records with torch.profiler (the JAX package's
    with jax.profiler) and leaves a chrome trace under its logdir."""
    import torch

    from ray_tpu_torch.util.state import profile_device

    with profile_device(str(tmp_path / "trace")):
        (torch.ones(64, 64) @ torch.ones(64, 64)).sum().item()
    files = list((tmp_path / "trace").glob("trace_*.json"))
    assert len(files) == 1
    names = {e.get("name") for e in json.loads(files[0].read_text())
             ["traceEvents"]}
    assert any("mm" in (n or "") for n in names)
