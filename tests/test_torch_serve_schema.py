"""The port's declarative serve config (``serve/schema.py``) against the
JAX package's.

Mirrors tests/test_serve_config.py: every invalid config raises the
same ValueError with the same message in both packages; ``apply``
deploys a class and a builder function with the config's overrides
(replicas, route prefix: config over code), and ``status`` gives the
same document; an override naming no deployment of the graph raises
alike; a redeploy reaches an existing handle through the long poll;
the controller's ``listen_for_change`` answers alike.  Both runtimes
are up at once.
"""

import sys
import threading
import time

import pytest

import ray_tpu
import ray_tpu_torch
from ray_tpu import serve as jserve
from ray_tpu.serve import schema as jschema
from ray_tpu_torch import serve as tserve
from ray_tpu_torch._private._vendor import cloudpickle as port_cloudpickle
from ray_tpu_torch.serve import schema as tschema
# autouse: the JAX runtime's loops settle before they stop
from tests.test_torch_jax_teardown import settle_jax_loops  # noqa: F401

port_cloudpickle.register_pickle_by_value(sys.modules[__name__])

STORE = 128 * 1024 * 1024
MOD = __name__


class _Echo:
    def __call__(self, x):
        return {"echo": x}


# module-level so the import-path machinery can resolve them
JaxEchoApp = jserve.deployment(name="echo_app", route_prefix="/code")(
    type("JaxEcho", (_Echo,), {}))
PortEchoApp = tserve.deployment(name="echo_app", route_prefix="/code")(
    type("PortEcho", (_Echo,), {}))


def build_jax_app(scale: int = 1):
    return JaxEchoApp.options(num_replicas=scale).bind()


def build_port_app(scale: int = 1):
    return PortEchoApp.options(num_replicas=scale).bind()


@pytest.fixture(scope="module")
def sides():
    ray_tpu.init(num_cpus=4, object_store_memory=STORE, log_to_driver=False)
    ray_tpu_torch.init(num_cpus=4, num_gpus=0, object_store_memory=STORE,
                       log_to_driver=False)
    yield {"jax": (ray_tpu, jserve, jschema, "Jax"),
           "torch": (ray_tpu_torch, tserve, tschema, "Port")}
    tserve.shutdown()
    jserve.shutdown()
    ray_tpu_torch.shutdown()
    ray_tpu.shutdown()


BAD = [
    {},
    {"import_path": "no_colon"},
    {"import_path": 7},
    "not a dict",
    {"import_path": "m:a", "deployments": [{"name": "x", "replicas": 3}]},
    {"import_path": "m:a", "deployments": [{"name": "x",
                                            "num_replicas": -1}]},
    {"import_path": "m:a", "deployments": [{"name": "x",
                                            "num_replicas": 0}]},
    {"import_path": "m:a", "deployments": [{"name": "x"}, {"name": "x"}]},
    {"import_path": "m:a", "deployments": [{"name": "x",
                                            "autoscaling_config":
                                            {"min_replicas": 5,
                                             "max_replicas": 2}}]},
    {"import_path": "m:a", "deployments": [{"name": ""}]},
    {"import_path": "m:a", "deployments": ["x"]},
    {"import_path": "m:a", "deployments": [{"name": "x",
                                            "max_concurrent_queries": 0}]},
    {"import_path": "m:a", "deployments": [{"name": "x",
                                            "route_prefix": "nope"}]},
    {"import_path": "m:a", "route_prefix": "nope"},
]


@pytest.mark.parametrize("config", BAD, ids=range(len(BAD)))
def test_schema_validation_errors_match_jax(config):
    msgs = []
    for schema in (jschema, tschema):
        with pytest.raises(ValueError) as e:
            schema.ServeApplicationSchema.parse(config)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_schema_parses_alike():
    config = {"import_path": "m:a", "name": "app", "route_prefix": "/r",
              "args": {"k": 1},
              "deployments": [{"name": "x", "num_replicas": 2,
                               "autoscaling_config": {"min_replicas": 0},
                               "ray_actor_options": {"num_cpus": 1}}]}
    import dataclasses

    j = jschema.ServeApplicationSchema.parse(config)
    t = tschema.ServeApplicationSchema.parse(config)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)


def _status(side, name):
    rt, serve, schema, _ = side
    doc = schema.status()["applications"][name]
    return {k: doc[k] for k in ("replicas", "route")}


def test_apply_config_deploys_and_overrides(sides):
    """The config's replicas win over the code's; its route prefix too."""
    out = {}
    for key, side in sides.items():
        rt, serve, schema, tag = side
        try:
            handle = schema.apply({
                "import_path": f"{MOD}:{tag}EchoApp",
                "route_prefix": "/cfg",
                "deployments": [{"name": "echo_app", "num_replicas": 2}]})
            out[key] = [handle.call("hi"), _status(side, "echo_app")]
        finally:
            serve.shutdown()
    assert out["torch"] == out["jax"]
    assert out["torch"] == [{"echo": "hi"}, {"replicas": 2,
                                             "route": "/cfg"}]


def test_deployment_route_override_beats_code(sides):
    """Without an application route prefix, the deployment entry's
    route_prefix wins over the code's."""
    out = {}
    for key, side in sides.items():
        rt, serve, schema, tag = side
        try:
            schema.apply({
                "import_path": f"{MOD}:{tag}EchoApp",
                "deployments": [{"name": "echo_app",
                                 "route_prefix": "/entry"}]})
            out[key] = _status(side, "echo_app")
        finally:
            serve.shutdown()
    assert out["torch"] == out["jax"] == {"replicas": 1, "route": "/entry"}


def test_apply_config_builder_function(sides):
    out = {}
    for key, side in sides.items():
        rt, serve, schema, tag = side
        try:
            handle = schema.apply({
                "import_path": f"{MOD}:build_{tag.lower()}_app",
                "args": {"scale": 1}})
            out[key] = [handle.call("yo"), _status(side, "echo_app")]
        finally:
            serve.shutdown()
    assert out["torch"] == out["jax"]
    assert out["torch"] == [{"echo": "yo"}, {"replicas": 1,
                                             "route": "/code"}]


@pytest.mark.parametrize("config,match", [
    ({"import_path": "{MOD}:{tag}EchoApp",
      "deployments": [{"name": "ghost", "num_replicas": 2}]},
     "matched no deployment"),
    ({"import_path": "{MOD}:_Echo"}, "expected a Deployment"),
], ids=["unmatched_override", "not_a_deployment"])
def test_apply_errors_match_jax(sides, config, match):
    msgs = []
    for key, side in sides.items():
        rt, serve, schema, tag = side
        cfg = dict(config, import_path=config["import_path"].format(
            MOD=MOD, tag=tag))
        try:
            with pytest.raises(ValueError, match=match) as e:
                schema.apply(cfg)
            msgs.append(str(e.value))
        finally:
            serve.shutdown()
    assert msgs[0] == msgs[1]


def _long_poll(rt, serve):
    @serve.deployment(name="lp")
    class V1:
        def __call__(self, x):
            return "v1"

    handle = serve.run(V1.bind())
    first = handle.call("x")

    @serve.deployment(name="lp")
    class V2:
        def __call__(self, x):
            return "v2"

    serve.run(V2.bind())  # same name: replica set fully replaced
    # the OLD handle picks up the new replicas push-style, well under
    # the old 5 s polling interval
    deadline = time.monotonic() + 4.0
    got = None
    while time.monotonic() < deadline:
        try:
            got = handle.call("x")
            if got == "v2":
                break
        except Exception:  # noqa: BLE001 - transient during swap
            pass
        time.sleep(0.2)
    return [first, got]


def test_long_poll_pushes_membership(sides):
    out = {}
    for key, (rt, serve, _, _) in sides.items():
        try:
            out[key] = _long_poll(rt, serve)
        finally:
            serve.shutdown()
    assert out["torch"] == out["jax"] == ["v1", "v2"]


def _listen_semantics(controller_cls):
    c = controller_cls.__new__(controller_cls)  # no reconcile thread
    c.deployments = {}
    c.routes = {}
    c._lock = threading.Lock()
    c._change = threading.Condition(c._lock)
    c._stop = True
    out = [c.listen_for_change("ghost", 0)["version"]]
    c.deployments["d"] = {"config": {}, "replicas": ["r1"], "version": 3,
                          "scale_pending_since": None}
    out.append(c.listen_for_change("d", 0))   # stale version: immediate
    out.append(c.listen_for_change("d", 3, timeout=0.2))  # blocks

    def mutate():
        time.sleep(0.2)
        with c._lock:
            c.deployments["d"]["replicas"] = ["r1", "r2"]
            c._bump_locked("d")

    t = threading.Thread(target=mutate)
    t.start()
    out.append(c.listen_for_change("d", 3, timeout=5.0))
    t.join(timeout=10)
    assert not t.is_alive()
    return out


def test_listen_for_change_semantics():
    from ray_tpu.serve.controller import ServeController as J
    from ray_tpu_torch.serve.controller import ServeController as T

    want = _listen_semantics(J)
    got = _listen_semantics(T)
    assert got == want
    assert got[0] == -1 and got[1] == {"version": 3, "replicas": ["r1"]}
    assert got[2]["replicas"] is None
    assert got[3] == {"version": 4, "replicas": ["r1", "r2"]}
