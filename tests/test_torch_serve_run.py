"""``serve.run`` of the port against the JAX package's, on the CPU.

JAX-initialized llama nano and GPT-2 nano parameters are written as a
numpy tree; both packages deploy
``serve.run(build_llm_deployment(..., checkpoint_path=...).bind())``
(the port's with ``device="cpu"``) as replica actors on their own
runtime, and every reply through the handle must be equal token for
token (greedy, f32): the batch scheduler on equal-length and ragged
prompts, the continuous one in two waves.  Errors, ``engine_stats``,
``status``/``delete``/``shutdown`` and a two-deployment graph behave
alike.  Both runtimes are up at once (one of each per module).
"""

import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu_torch
from ray_tpu import serve as jserve
from ray_tpu.models import gpt2 as jgpt2
from ray_tpu.models import llama as jllama
from ray_tpu_torch import serve as tserve
from ray_tpu_torch._private._vendor import cloudpickle as port_cloudpickle
# autouse: the JAX runtime's loops settle before they stop
from tests.test_torch_jax_teardown import settle_jax_loops  # noqa: F401

port_cloudpickle.register_pickle_by_value(sys.modules[__name__])

MAX_NEW = 4
STORE = 128 * 1024 * 1024


@pytest.fixture(scope="module")
def sides():
    ray_tpu.init(num_cpus=4, object_store_memory=STORE, log_to_driver=False)
    ray_tpu_torch.init(num_cpus=4, num_gpus=0, object_store_memory=STORE,
                       log_to_driver=False)
    yield {"jax": (ray_tpu, jserve), "torch": (ray_tpu_torch, tserve)}
    tserve.shutdown()
    jserve.shutdown()
    ray_tpu_torch.shutdown()
    ray_tpu.shutdown()


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    out = {}
    for family, cfg, init, key in (
            ("llama", jllama.llama_config("nano", dtype=jnp.float32,
                                          use_flash=False),
             jllama.llama_init, 4),
            ("gpt2", jgpt2.gpt2_config("nano", dtype=jnp.float32,
                                       use_flash=False, remat=False),
             jgpt2.gpt2_init, 3)):
        params = init(jax.random.PRNGKey(key), cfg)
        path = tmp_path_factory.mktemp("ckpt") / f"{family}_nano.pkl"
        with open(path, "wb") as f:
            pickle.dump(jax.tree.map(np.asarray, params), f)
        out[family] = str(path)
    return out


def _deployment(side, family, path, name, **kw):
    _, serve = side
    if serve is jserve:
        overrides = {"dtype": jnp.float32, "use_flash": False}
        if family == "gpt2":
            overrides["remat"] = False
        dep = serve.build_llm_deployment(
            family, "nano", max_new_tokens=MAX_NEW, temperature=0.0,
            checkpoint_path=path, config_overrides=overrides, **kw)
    else:
        dep = serve.build_llm_deployment(
            family, "nano", max_new_tokens=MAX_NEW, temperature=0.0,
            checkpoint_path=path, device="cpu",
            config_overrides={"dtype": torch.float32}, **kw)
    return dep.options(name=name, max_concurrent_queries=16)


def _prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 500, size=n, dtype=np.int32) for n in lens]


def _cause(e):
    cause = getattr(e, "cause", None) or e
    return type(cause).__name__, str(cause).split("\n")[0]


@pytest.fixture(scope="module", params=["llama", "gpt2"])
def batch_handles(request, sides, checkpoints):
    family = request.param
    name = f"{family}_batch"
    handles = {}
    for key, side in sides.items():
        handles[key] = side[1].run(_deployment(
            side, family, checkpoints[family], name,
            batch_wait_timeout_s=0.05, max_batch_size=4).bind())
    yield family, handles
    for side in sides.values():
        side[1].delete(name)


def _replies(sides, handles, prompts):
    return {key: sides[key][0].get([handles[key].remote(p)
                                    for p in prompts], timeout=300)
            for key in handles}


@pytest.mark.parametrize("lens", [[9, 9, 9, 9], [10, 4, 7, 2, 6]],
                         ids=["equal", "ragged"])
def test_batch_scheduler_replies_match_jax(sides, batch_handles, lens):
    family, handles = batch_handles
    prompts = _prompts(len(lens), lens)
    got = _replies(sides, handles, prompts)
    for p, a, b in zip(prompts, got["torch"], got["jax"]):
        assert a.dtype == np.int32 and a.shape == (len(p) + MAX_NEW,)
        np.testing.assert_array_equal(a, b)


def test_oversized_prompt_raises_the_same_error(sides, batch_handles):
    _, handles = batch_handles
    too_long = np.arange(1, 200, dtype=np.int32)
    errors = {}
    for key, h in handles.items():
        with pytest.raises(Exception) as info:
            sides[key][0].get(h.remote(too_long), timeout=120)
        errors[key] = _cause(info.value)
    assert errors["torch"] == errors["jax"]
    assert errors["torch"][0] == "ValueError"
    assert "prompt length" in errors["torch"][1]


def _key_tree(d):
    if isinstance(d, dict):
        return {k: _key_tree(v) for k, v in d.items()}
    return None


def test_engine_stats_have_the_jax_key_tree(sides, batch_handles):
    _, handles = batch_handles
    trees = {}
    for key, h in handles.items():
        rt, serve = sides[key]
        rt.get(h.remote(np.arange(1, 6, dtype=np.int32)), timeout=120)
        trees[key] = _key_tree(serve.engine_stats(h.deployment_name))
    assert trees["torch"] == trees["jax"]


def test_continuous_scheduler_two_waves_match_jax(sides, checkpoints):
    lens = [3, 9, 5, 7, 4, 8, 6, 2] * 2
    prompts = _prompts(21, lens)
    got = {}
    for key, side in sides.items():
        rt, serve = side
        h = serve.run(_deployment(
            side, "llama", checkpoints["llama"], "llama_continuous",
            scheduler="continuous", max_slots=3, prefill_bucket=8).bind())
        wave1 = [h.remote(p) for p in prompts[:8]]
        wave2 = [h.remote(p) for p in prompts[8:]]
        got[key] = rt.get(wave1 + wave2, timeout=300)
        stats = serve.engine_stats("llama_continuous")
        assert stats["requests"]["finished"] == 16
        serve.delete("llama_continuous")
    for p, a, b in zip(prompts, got["torch"], got["jax"]):
        assert a.shape == (len(p) + MAX_NEW,)
        np.testing.assert_array_equal(a, b)


def _graph(serve, rt):
    class Doubler:
        def __call__(self, x):
            return 2 * np.asarray(x)

    class Front:
        def __init__(self, doubler):
            self.doubler = doubler

        def __call__(self, x):
            return rt.get(self.doubler.remote(x), timeout=60) + 1

    doubler = serve.deployment(name="doubler")(Doubler)
    front = serve.deployment(name="front")(Front)
    return front.bind(doubler.bind())


def test_two_deployment_graph_resolves_its_handle(sides):
    out = {}
    for key, (rt, serve) in sides.items():
        h = serve.run(_graph(serve, rt))
        out[key] = rt.get([h.remote(np.arange(i, i + 3))
                           for i in range(3)], timeout=120)
        assert set(serve.status()) >= {"front", "doubler"}
        serve.delete("front")
        serve.delete("doubler")
    for a, b in zip(out["torch"], out["jax"]):
        np.testing.assert_array_equal(a, b)


def test_replica_without_a_grant_fails_with_no_cuda_device(
        sides, monkeypatch):
    """build_llm_deployment resolves its device in the caller; the
    engine resolves it again where it is built.  A replica deployed
    without num_gpus sees no card, so a deployment whose device is the
    card fails at construction, naming it, and never runs on the CPU.
    (This process has no card either: its check is made to pass so
    that the replica's can be seen.)"""
    rt, serve = sides["torch"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    dep = serve.build_llm_deployment("llama", "nano", max_new_tokens=2)
    monkeypatch.undo()
    h = serve.run(dep.options(name="no_grant").bind())
    try:
        with pytest.raises(Exception, match="no CUDA device"):
            rt.get(h.remote(np.arange(1, 5, dtype=np.int32)), timeout=120)
    finally:
        serve.delete("no_grant")


def _ready_state(serve, rt):
    class Echo:
        def __call__(self, x):
            return x

    dep = serve.deployment(name="echo", num_replicas=2)(Echo)
    h = serve.run(dep.bind())
    replies = rt.get([h.remote(i) for i in range(4)], timeout=120)
    status = serve.status()["echo"]
    status.pop("version")
    serve.delete("echo")
    after_delete = serve.status()
    serve.shutdown()
    try:
        rt.get_actor("SERVE_CONTROLLER")
        controller_left = True
    except ValueError:
        controller_left = False
    return [replies, status, after_delete, controller_left]


def test_status_delete_and_shutdown_behave_alike(sides):
    got = {key: _ready_state(serve, rt)
           for key, (rt, serve) in sides.items()}
    assert got["torch"] == got["jax"]
    assert got["torch"][1]["replicas"] == 2 and not got["torch"][3]
