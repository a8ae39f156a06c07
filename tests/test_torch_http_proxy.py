"""The port's HTTP proxy (asyncio streams) against the JAX package's
(aiohttp), on the CPU.

Both runtimes are up at once, each with the same deployments and its
own proxy on a free port; every request goes to both proxies and the
status code and the JSON body must be equal: routes by longest prefix
and the catch-all, the query of a bodiless request, JSON and text
bodies, 404, a deployment's exception (500), a numpy result (its
repr), keep-alive, chunked request bodies and 16 requests at once.
llama nano, served through ``serve.run(http=True)`` from a JAX
checkpoint, answers token for token as the JAX package's does;
``start_http_proxy(per_node=True)`` starts one proxy per node of a
2-node cluster; the proxy's process loads no torch.
"""

import http.client
import json
import pickle
import socket
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu_torch
from ray_tpu import serve as jserve
from ray_tpu.models import llama as jllama
from ray_tpu_torch import serve as tserve
from ray_tpu_torch._private._vendor import cloudpickle as port_cloudpickle
# autouse: the JAX runtime's loops settle before they stop
from tests.test_torch_jax_teardown import settle_jax_loops  # noqa: F401

port_cloudpickle.register_pickle_by_value(sys.modules[__name__])

STORE = 128 * 1024 * 1024
MAX_NEW = 4


def _free_port(n=1):
    """The first of ``n`` consecutive free ports."""
    for _ in range(1000):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            base = s.getsockname()[1]
        try:
            for i in range(1, n):
                with socket.socket() as s:
                    s.bind(("127.0.0.1", base + i))
            return base
        except OSError:
            continue
    raise RuntimeError(f"no {n} consecutive free ports in 1000 tries")


def echo(payload):
    return {"got": payload, "type": type(payload).__name__}


def deeper(payload):
    return {"deeper": payload}


def boom(payload):
    raise ValueError(f"bad payload {payload!r}")


def as_numpy(payload):
    return np.arange(3, dtype=np.int32) * int(payload["k"])


def slow(payload):
    time.sleep(0.2)
    return payload


def root(payload):
    return f"root:{payload!r}"


def _deploy(serve, fn, prefix):
    serve.run(serve.deployment(fn, name=fn.__name__, route_prefix=prefix,
                               max_concurrent_queries=16).bind())


def _per_node(rt, serve, cluster_cls, key):
    c = cluster_cls(head_num_cpus=1, object_store_memory=STORE)
    c.add_node(num_cpus=1, **{key: 0})
    # the driver's node offers a CPU too: its proxy needs 0.1
    c.connect(num_cpus=1, log_to_driver=False)
    try:
        _deploy(serve, echo, "/echo")
        base = _free_port(3)
        first = serve.start_http_proxy(port=base, per_node=True)
        names = sorted(a["name"] for a in
                       (ray_tpu_torch if rt is ray_tpu_torch else
                        ray_tpu).util.state.list_actors()
                       if a["name"].startswith("SERVE_HTTP_PROXY")
                       and a["state"] == "ALIVE")
        nodes = len([n for n in rt.nodes() if n["Alive"]])
        replies = []
        for i in range(nodes):
            addr = f"http://127.0.0.1:{base + i}"
            replies.append(_request(addr, "POST", "/echo", json.dumps(i)))
        return [first == f"http://127.0.0.1:{base}", len(names), nodes,
                replies]
    finally:
        serve.shutdown()
        rt.shutdown()
        c.shutdown()


def test_per_node_proxies_on_a_two_node_cluster():
    """One proxy per alive node (the head, the added node and the
    driver's own), each answering on its port.  It runs before the
    module's shared runtimes start (a cluster needs its own driver)."""
    import ray_tpu.util.state  # noqa: F401 - the JAX side's list_actors
    import ray_tpu_torch.util.state  # noqa: F401
    from ray_tpu.cluster_utils import Cluster as JaxCluster
    from ray_tpu_torch.cluster_utils import Cluster as PortCluster

    want = _per_node(ray_tpu, jserve, JaxCluster, "num_tpus")
    got = _per_node(ray_tpu_torch, tserve, PortCluster, "num_gpus")
    assert got == want
    assert got[:3] == [True, 3, 3]


@pytest.fixture(scope="module")
def proxies():
    ray_tpu.init(num_cpus=4, object_store_memory=STORE, log_to_driver=False)
    ray_tpu_torch.init(num_cpus=4, num_gpus=0, object_store_memory=STORE,
                       log_to_driver=False)
    addrs = {}
    try:
        for key, serve in (("jax", jserve), ("torch", tserve)):
            for fn, prefix in ((echo, "/echo"), (deeper, "/echo/deeper"),
                               (boom, "/boom"), (as_numpy, "/np"),
                               (slow, "/slow")):
                _deploy(serve, fn, prefix)
            addrs[key] = serve.start_http_proxy(port=_free_port())
        yield addrs
    finally:
        tserve.shutdown()
        jserve.shutdown()
        ray_tpu_torch.shutdown()
        ray_tpu.shutdown()


def _request(addr, method, path, body=None, headers=None, conn=None,
             chunked=False):
    host, port = addr.rsplit("//", 1)[1].split(":")
    own = conn is None
    conn = conn or http.client.HTTPConnection(host, int(port), timeout=60)
    try:
        conn.request(method, path, body=body, headers=headers or {},
                     encode_chunked=chunked)
        r = conn.getresponse()
        return r.status, json.loads(r.read())
    finally:
        if own:
            conn.close()


CASES = {
    "json_body": ("POST", "/echo", json.dumps({"x": [1, 2]}),
                  {"Content-Type": "application/json"}),
    "longest_prefix": ("POST", "/echo/deeper/leaf", json.dumps(3), {}),
    "prefix_subpath": ("POST", "/echo/other", json.dumps("s"), {}),
    "query": ("GET", "/echo?a=1&b=two&a=3&c=", None, {}),
    "no_body_no_query": ("GET", "/echo", None, {}),
    "empty_body": ("POST", "/echo?q=1", b"", {}),
    "text_body": ("POST", "/echo", "plain text, not json", {}),
    "missing_route": ("POST", "/nothing/here", json.dumps({}), {}),
    "deployment_raises": ("POST", "/boom", json.dumps({"v": 1}), {}),
    "numpy_result": ("POST", "/np", json.dumps({"k": 2}), {}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_reply_matches_jax_proxy(proxies, case):
    method, path, body, headers = CASES[case]
    got = _request(proxies["torch"], method, path, body, headers)
    want = _request(proxies["jax"], method, path, body, headers)
    if case == "deployment_raises":
        # the error's repr carries the worker's traceback (paths, line
        # numbers): compare the status, the key and the repr's head
        assert got[0] == want[0] == 500
        assert set(got[1]) == set(want[1]) == {"error"}
        head = got[1]["error"].split("\\n")[0]
        assert head == want[1]["error"].split("\\n")[0]
        assert head.startswith("RayTaskError('task raised ValueError(")
        return
    assert got == want
    if case == "missing_route":
        assert got == (404, {"error": "no route for /nothing/here"})


def test_catch_all_route_takes_the_rest(proxies):
    """After a "/" deployment no path 404s: the catch-all takes what no
    longer prefix does."""
    for serve in (jserve, tserve):
        _deploy(serve, root, "/")
    try:
        time.sleep(2.1)  # past the proxies' 2 s route-table TTL
        for path in ("/nothing/here", "/echo", "/"):
            got = _request(proxies["torch"], "POST", path, json.dumps(1))
            want = _request(proxies["jax"], "POST", path, json.dumps(1))
            assert got == want
        assert got == (200, {"result": "root:1"})
    finally:
        for serve in (jserve, tserve):
            serve.delete("root")


def test_keep_alive_serves_several_requests_on_one_connection(proxies):
    out = {}
    for key, addr in proxies.items():
        host, port = addr.rsplit("//", 1)[1].split(":")
        conn = http.client.HTTPConnection(host, int(port), timeout=60)
        try:
            replies = [_request(addr, "POST", "/echo", json.dumps(i),
                                conn=conn) for i in range(3)]
            sock = conn.sock
            replies.append(_request(addr, "GET", "/echo?i=3", conn=conn))
            # the same socket carried every request
            out[key] = (replies, conn.sock is sock and sock is not None)
        finally:
            conn.close()
    assert out["torch"] == out["jax"]
    assert out["torch"][1]


def test_chunked_request_body(proxies):
    """A body sent with Transfer-Encoding: chunked, in several chunks."""
    doc = {"chunks": list(range(50)), "text": "x" * 3000}
    raw = json.dumps(doc).encode()
    out = {}
    for key, addr in proxies.items():
        parts = (raw[i:i + 700] for i in range(0, len(raw), 700))
        out[key] = _request(addr, "POST", "/echo", parts,
                            {"Transfer-Encoding": "chunked"}, chunked=True)
    assert out["torch"] == out["jax"]
    assert out["torch"] == (200, {"result": {"got": doc, "type": "dict"}})


def test_sixteen_requests_at_once(proxies):
    out = {}
    for key, addr in proxies.items():
        replies = [None] * 16

        def send(i):
            replies[i] = _request(addr, "POST", "/slow", json.dumps(
                {"i": i}))

        threads = [threading.Thread(target=send, args=(i,))
                   for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        out[key] = replies
    assert out["torch"] == out["jax"]
    assert out["torch"] == [(200, {"result": {"i": i}}) for i in range(16)]


def _proxy_pids(rt):
    """The worker processes of the port's node that host an actor named
    like a proxy."""
    from ray_tpu_torch._private import worker_context
    from ray_tpu_torch.util import state

    ids = {bytes.fromhex(a["actor_id"]) for a in state.list_actors()
           if a["name"].startswith("SERVE_HTTP_PROXY")
           and a["state"] == "ALIVE"}
    node = worker_context.node()
    return [w.proc.pid for w in node.node_manager.workers.values()
            if w.actor_id in ids]


def _loads_torch(pid):
    with open(f"/proc/{pid}/maps") as f:
        return "libtorch" in f.read()


def test_proxy_process_loads_no_torch(proxies):
    pids = _proxy_pids(ray_tpu_torch)
    assert len(pids) == 1
    assert not _loads_torch(pids[0])


@pytest.fixture(scope="module")
def llama_checkpoint(tmp_path_factory):
    cfg = jllama.llama_config("nano", dtype=jnp.float32, use_flash=False)
    params = jllama.llama_init(jax.random.PRNGKey(4), cfg)
    path = tmp_path_factory.mktemp("ckpt") / "llama_nano.pkl"
    with open(path, "wb") as f:
        pickle.dump(jax.tree.map(np.asarray, params), f)
    return str(path)


def test_llama_over_http_matches_jax(proxies, llama_checkpoint):
    """serve.run(http=True) of llama nano (greedy, f32): each HTTP reply
    is the repr of the engine's int32 array, equal to the JAX
    package's token for token."""
    deps = {
        "jax": jserve.build_llm_deployment(
            "llama", "nano", max_new_tokens=MAX_NEW,
            checkpoint_path=llama_checkpoint,
            config_overrides={"dtype": jnp.float32, "use_flash": False}),
        "torch": tserve.build_llm_deployment(
            "llama", "nano", max_new_tokens=MAX_NEW,
            checkpoint_path=llama_checkpoint, device="cpu",
            config_overrides={"dtype": torch.float32})}
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, 500, size=n).tolist() for n in (9, 9, 5)]
    replies = {}
    for key, serve in (("jax", jserve), ("torch", tserve)):
        port = int(proxies[key].rsplit(":", 1)[1])
        handle = serve.run(deps[key].options(name="llm_http").bind(),
                           route_prefix="/llm", http=True, http_port=port)
        try:
            # the replica's first call builds (and for JAX compiles) the
            # engine, which on a loaded host can outlast the proxy's 60 s
            # call timeout; greedy decoding makes the warm-up harmless
            handle.call(prompts[0], timeout=300)
            time.sleep(2.1)  # past the proxy's 2 s route-table TTL
            replies[key] = [_request(proxies[key], "POST", "/llm",
                                     json.dumps(p)) for p in prompts]
        finally:
            serve.delete("llm_http")
    assert replies["torch"] == replies["jax"]
    for (status, body), p in zip(replies["torch"], prompts):
        assert status == 200 and body["result"].startswith("array([")
        assert "dtype=int32" in body["result"]
        inner = body["result"].split("[", 1)[1].split("]", 1)[0]
        toks = [int(x) for x in inner.replace(",", " ").split()]
        assert toks[:len(p)] == p and len(toks) == len(p) + MAX_NEW
    # the proxy still loads no torch after forwarding llama's replies
    assert not any(_loads_torch(pid) for pid in _proxy_pids(ray_tpu_torch))
