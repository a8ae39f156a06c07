"""The port stands alone: no file of ray_tpu_torch/, and none of
chip_smoke.py, fused_ce_limits.py and flash_bwd_limits.py, imports jax,
jaxlib or the JAX package ray_tpu, nor aiohttp, yaml or pydantic (the
card's machine has none of the three).  A worker process of the port's
runtime has neither in sys.modules, importing its entry module, the
serve control plane (the HTTP proxy among it), the metrics publisher,
the CLI and the rest of the runtime's front door leaves torch out too,
and the object store is built from the port's own copy of its
source.  The Data and AIR layers import neither torch, pyarrow nor
pandas when imported, and a data task's worker holds none of them; the
device plane (parallel/), Train's orchestration and Tune import no
torch when imported.
"""

import ast
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "ray_tpu", "aiohttp", "yaml", "pydantic")


def _port_files():
    files = sorted((ROOT / "ray_tpu_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py", ROOT / "fused_ce_limits.py",
                    ROOT / "flash_bwd_limits.py"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, (node.module or "").split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                    "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield node.lineno, str(node.args[0].value).split(".")[0]


def test_port_files_exist():
    files = _port_files()
    assert all(f.exists() for f in files)
    assert len(files) > 10
    # the llama family, the paged layout's and the continuous
    # scheduler's modules (spec decoding and the prefill/decode
    # handoff among them) and the serving telemetry are scanned too
    names = {str(f.relative_to(ROOT)) for f in files}
    assert {"ray_tpu_torch/models/llama.py",
            "ray_tpu_torch/models/llama_decode.py",
            "ray_tpu_torch/models/gpt2_decode.py",
            "ray_tpu_torch/models/decode_common.py",
            "ray_tpu_torch/serve/batching.py",
            "ray_tpu_torch/serve/llm.py",
            "ray_tpu_torch/serve/kv_pager.py",
            "ray_tpu_torch/serve/kv_tier.py",
            "ray_tpu_torch/serve/kvscope.py",
            # the serving telemetry
            "ray_tpu_torch/_private/telemetry.py",
            "ray_tpu_torch/_private/flightrec.py",
            "ray_tpu_torch/_private/device_stats.py",
            "ray_tpu_torch/util/tracing.py",
            "ray_tpu_torch/util/metrics.py",
            "ray_tpu_torch/serve/health.py",
            "ray_tpu_torch/serve/chaos.py",
            "ray_tpu_torch/serve/slo.py",
            "ray_tpu_torch/serve/telemetry.py",
            # the train step's telemetry and what reports into it
            "ray_tpu_torch/train/telemetry.py",
            "ray_tpu_torch/train/goodput.py",
            "ray_tpu_torch/train/grad_accum.py",
            "ray_tpu_torch/train/checkpointing.py",
            "ray_tpu_torch/tools/flightrec.py",
            # the serve fleet: deployment records, router, traffic and
            # the tracebus
            "ray_tpu_torch/serve/api.py",
            "ray_tpu_torch/serve/router.py",
            "ray_tpu_torch/serve/traffic.py",
            "ray_tpu_torch/tools/tracebus.py",
            # the core runtime, serve on actors and the vendored codecs
            "ray_tpu_torch/__init__.py",
            "ray_tpu_torch/exceptions.py",
            "ray_tpu_torch/actor.py",
            "ray_tpu_torch/remote_function.py",
            "ray_tpu_torch/_private/client.py",
            "ray_tpu_torch/_private/config.py",
            "ray_tpu_torch/_private/events.py",
            "ray_tpu_torch/_private/gcs.py",
            "ray_tpu_torch/_private/ids.py",
            "ray_tpu_torch/_private/logs.py",
            "ray_tpu_torch/_private/node.py",
            "ray_tpu_torch/_private/node_manager.py",
            "ray_tpu_torch/_private/object_store.py",
            "ray_tpu_torch/_private/protocol.py",
            "ray_tpu_torch/_private/ray_perf.py",
            "ray_tpu_torch/_private/serialization.py",
            "ray_tpu_torch/_private/spill.py",
            "ray_tpu_torch/_private/storage.py",
            "ray_tpu_torch/_private/usage_lib.py",
            "ray_tpu_torch/_private/worker_context.py",
            "ray_tpu_torch/_private/worker_main.py",
            "ray_tpu_torch/_private/_vendor/cloudpickle/cloudpickle.py",
            "ray_tpu_torch/_private/_vendor/msgpack/fallback.py",
            "ray_tpu_torch/_private/_vendor/msgpack/ext.py",
            "ray_tpu_torch/_private/_vendor/msgpack/exceptions.py",
            "ray_tpu_torch/serve/controller.py",
            "ray_tpu_torch/serve/replica.py",
            "ray_tpu_torch/serve/handle.py",
            # the front door: multi-node attach, the CLI, the HTTP
            # proxy, declarative apply, jobs, the metrics publisher,
            # dag and the state API
            "ray_tpu_torch/__main__.py",
            "ray_tpu_torch/cluster_utils.py",
            "ray_tpu_torch/dag/__init__.py",
            "ray_tpu_torch/dashboard/__init__.py",
            "ray_tpu_torch/job/__init__.py",
            "ray_tpu_torch/job/manager.py",
            "ray_tpu_torch/runtime_env/__init__.py",
            "ray_tpu_torch/scripts/__init__.py",
            "ray_tpu_torch/scripts/cli.py",
            "ray_tpu_torch/serve/http_proxy.py",
            "ray_tpu_torch/serve/schema.py",
            "ray_tpu_torch/util/placement_group.py",
            "ray_tpu_torch/util/scheduling_strategies.py",
            "ray_tpu_torch/util/state.py",
            # the dashboard on the shared HTTP layer, and the bench CLI
            "ray_tpu_torch/_private/http_server.py",
            "ray_tpu_torch/dashboard/app.py",
            "ray_tpu_torch/dashboard/frontend.py",
            "ray_tpu_torch/bench.py",
            # Data and AIR
            *DATA_AIR_FILES,
            # the device plane and the mixture of experts
            *PARALLEL_FILES, "ray_tpu_torch/models/moe.py",
            # Train and Tune, and the MLP their tests train
            *TRAIN_TUNE_FILES, "ray_tpu_torch/models/mlp.py",
            # RLlib's core
            *RLLIB_FILES} <= names


#: the Data and AIR layers: besides the rest, none of them imports
#: pyarrow or pandas at module level (the layer runs without them)
DATA_AIR_FILES = tuple(
    [f"ray_tpu_torch/data/{m}.py" for m in (
        "__init__", "block", "dataset", "datasource", "filesystem",
        "shuffle", "streaming")] +
    [f"ray_tpu_torch/air/{m}.py" for m in (
        "__init__", "batch_predictor", "checkpoint", "config", "result",
        "session")])


#: the device plane: a copy of the JAX package's parallel/, torch
#: imported only where a mesh or a tensor is used
PARALLEL_FILES = tuple(f"ray_tpu_torch/parallel/{m}.py" for m in (
    "__init__", "topology", "mesh", "sharding", "collective"))


#: Train's orchestration and Tune: copies of the JAX package's, torch
#: imported only where a step or a tensor is used (a trial actor that
#: hosts a trainer loads none)
TRAIN_TUNE_FILES = tuple(
    [f"ray_tpu_torch/train/{m}.py" for m in (
        "__init__", "_internal/__init__", "_internal/session",
        "_internal/worker_group", "backend", "backend_executor",
        "base_trainer", "data_parallel_trainer", "jax_backend",
        "jax_trainer", "torch_backend")] +
    [f"ray_tpu_torch/tune/{m}.py" for m in (
        "__init__", "callback", "logger", "schedulers", "search", "syncer",
        "trainable_adapter", "trial", "trial_runner", "tuner")])


#: RLlib's core: the in-repo envs, PPO and the CLI run where gymnasium
#: is not installed (it is imported only for an env id not in the repo)
RLLIB_FILES = tuple(f"ray_tpu_torch/rllib/{m}.py" for m in (
    "__init__", "algorithm", "connectors", "envs", "filters", "models",
    "pg", "policy", "ppo", "registry", "replay_buffer", "rollout_worker",
    "sample_batch", "vector_env", "worker_set"))


def _module_level_roots(path: Path):
    """The roots a module imports when it is imported: import
    statements outside every def and class body."""
    tree = ast.parse(path.read_text(), filename=str(path))
    todo = list(tree.body)
    while todo:
        node = todo.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            continue
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, (node.module or "").split(".")[0]
        else:
            todo.extend(ast.iter_child_nodes(node))


@pytest.mark.parametrize("rel", DATA_AIR_FILES)
def test_data_and_air_import_no_pyarrow_or_pandas_at_module_level(rel):
    bad = [(line, mod) for line, mod in _module_level_roots(ROOT / rel)
           if mod in ("pyarrow", "pandas", "torch")]
    assert not bad, f"{rel} imports {bad} at module level"


@pytest.mark.parametrize("rel", PARALLEL_FILES)
def test_parallel_imports_no_torch_at_module_level(rel):
    bad = [(line, mod) for line, mod in _module_level_roots(ROOT / rel)
           if mod in ("torch", "jax", "ray_tpu")]
    assert not bad, f"{rel} imports {bad} at module level"


@pytest.mark.parametrize("rel", TRAIN_TUNE_FILES)
def test_train_and_tune_import_no_torch_at_module_level(rel):
    bad = [(line, mod) for line, mod in _module_level_roots(ROOT / rel)
           if mod in ("torch", "jax", "ray_tpu")]
    assert not bad, f"{rel} imports {bad} at module level"


@pytest.mark.parametrize("rel", RLLIB_FILES)
def test_rllib_imports_no_gymnasium_at_module_level(rel):
    bad = [(line, mod) for line, mod in _module_level_roots(ROOT / rel)
           if mod in ("gymnasium", "gym", "jax", "ray_tpu")]
    assert not bad, f"{rel} imports {bad} at module level"


def test_module_level_scanner_skips_function_bodies(tmp_path):
    src = tmp_path / "planted.py"
    src.write_text("import numpy\n"
                   "try:\n"
                   "    import pandas\n"
                   "except ImportError:\n"
                   "    pass\n"
                   "def f():\n"
                   "    import pyarrow\n"
                   "class C:\n"
                   "    import torch\n")
    assert sorted(_module_level_roots(src)) == [(1, "numpy"), (3, "pandas")]


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = [(line, mod) for line, mod in _imported_roots(path)
           if mod in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_scanner_catches_each_import_form(tmp_path):
    src = tmp_path / "planted.py"
    src.write_text("import jax.numpy as jnp\n"
                   "from ray_tpu.ops import attention\n"
                   "import importlib\n"
                   "m = importlib.import_module('jaxlib.xla_client')\n"
                   "from aiohttp import web\n"
                   "import yaml\n"
                   "def f():\n"
                   "    import pydantic.v1 as pd\n")
    found = sorted(_imported_roots(src))
    assert found == [(1, "jax"), (2, "ray_tpu"), (3, "importlib"),
                     (4, "jaxlib"), (5, "aiohttp"), (6, "yaml"),
                     (8, "pydantic")]
    assert sorted(m for _, m in found if m in FORBIDDEN) == sorted(
        FORBIDDEN)


def _fresh_imports(stmt):
    """The roots of sys.modules after ``stmt`` in a fresh interpreter
    run from the repo's root."""
    code = (f"import sys; {stmt}; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout
    return set(ast.literal_eval(out.strip().splitlines()[-1]))


def test_worker_entry_module_imports_no_torch_jax_or_reference():
    roots = _fresh_imports("import ray_tpu_torch._private.worker_main")
    assert "ray_tpu_torch" in roots
    assert not roots & {"torch", "jax", "jaxlib", "ray_tpu"}
    # nor do the runtime's public API and the serve package's names
    roots = _fresh_imports(
        "import ray_tpu_torch; from ray_tpu_torch.serve import "
        "controller, replica, handle, api")
    assert not roots & {"torch", "jax", "jaxlib", "ray_tpu"}
    # nor the front door: the HTTP proxy's and the publisher's modules,
    # the CLI, jobs, dag and the state API
    roots = _fresh_imports(
        "import ray_tpu_torch.__main__, ray_tpu_torch.cluster_utils, "
        "ray_tpu_torch.dag, ray_tpu_torch.job, ray_tpu_torch.runtime_env; "
        "from ray_tpu_torch.serve import http_proxy, schema; "
        "from ray_tpu_torch.util import metrics, state, placement_group; "
        "from ray_tpu_torch.scripts import cli; "
        "metrics.Counter('isolation_probe_total').inc()")
    assert not roots & {"torch", "jax", "jaxlib", "ray_tpu", "aiohttp",
                        "yaml", "pydantic"}


def test_train_and_tune_import_no_torch():
    """What a trial actor imports to host a trainer (the worker class,
    the trainers, the Tuner) loads no torch: the names of the step's
    modules load at first use."""
    roots = _fresh_imports(
        "import ray_tpu_torch.train, ray_tpu_torch.tune; "
        "from ray_tpu_torch.train._internal import worker_group; "
        "from ray_tpu_torch.train import JaxTrainer, TorchTrainer, jax_utils")
    assert "ray_tpu_torch" in roots
    assert not roots & {"torch", "jax", "jaxlib", "ray_tpu"}
    roots = _fresh_imports("from ray_tpu_torch.train import adamw")
    assert "torch" in roots and not roots & {"jax", "ray_tpu"}


def test_rllib_imports_no_torch_until_an_algorithm_is_used():
    """The registry (the CLI's `rllib algorithms`, Tune's launch by
    name) loads neither torch nor gymnasium; an algorithm loads torch
    and still no gymnasium."""
    roots = _fresh_imports(
        "import ray_tpu_torch.rllib; "
        "from ray_tpu_torch.rllib.registry import registered_algorithms")
    assert "ray_tpu_torch" in roots
    assert not roots & {"torch", "gymnasium", "jax", "ray_tpu"}
    roots = _fresh_imports("from ray_tpu_torch.rllib import PPO, A3C")
    assert "torch" in roots
    assert not roots & {"gymnasium", "jax", "ray_tpu"}


def test_data_and_air_import_no_torch_pyarrow_or_pandas():
    roots = _fresh_imports(
        "import ray_tpu_torch.data, ray_tpu_torch.air; "
        "from ray_tpu_torch.data import block, shuffle, streaming, "
        "datasource, filesystem; from ray_tpu_torch._private import spill")
    assert "ray_tpu_torch" in roots
    assert not roots & {"torch", "pyarrow", "pandas", "jax", "jaxlib",
                        "ray_tpu"}


DATA_TASK = r"""
import sys
import ray_tpu_torch as rt
from ray_tpu_torch import data

rt.init(num_cpus=2, num_gpus=0, object_store_memory=64 * 2**20,
        log_to_driver=False)
try:
    def report(batch):
        import os
        mods = sorted({m.split(".")[0] for m in sys.modules} &
                      {"torch", "pyarrow", "pandas", "jax", "ray_tpu"})
        return {"pid": [os.getpid()], "mods": [",".join(mods)]}

    ds = data.range(40, parallelism=4).map_batches(
        lambda b: {"k": b["id"] % 3, "v": b["id"]}).random_shuffle(seed=1)
    rows = ds.groupby("k").count().map_batches(report).take_all()
    print("ROWS", rows)
finally:
    rt.shutdown()
"""


def test_a_data_tasks_worker_imports_no_torch_pyarrow_or_pandas():
    """The port's data tasks (a fused map stage, the shuffle's map and
    reduce tasks, a groupby) run in worker processes that hold none of
    torch, pyarrow and pandas: blocks are numpy columns."""
    out = subprocess.run([sys.executable, "-c", DATA_TASK], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    line = next(ln for ln in out.stdout.splitlines()
                if ln.startswith("ROWS "))
    rows = ast.literal_eval(line[len("ROWS "):])
    assert rows and all(r["mods"] == "" for r in rows), rows


def test_object_store_builds_from_the_ports_source():
    from ray_tpu_torch._private import object_store

    src = Path(object_store._SRC).resolve()
    assert src == ROOT / "ray_tpu_torch/_private/csrc/objstore.cc"
    lib = Path(object_store.get_lib()._name).resolve()
    assert lib.parent == ROOT / "ray_tpu_torch/_build"
    assert lib.name.startswith("libobjstore_")
    assert "ray_tpu/_private/_lib" not in str(lib)


def _pid_alive(pid):
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    # a zombie of an exited child still answers kill(0)
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().split(")")[-1].split()[0] != "Z"
    except OSError:
        return False


def test_port_worker_processes_and_shutdown(monkeypatch):
    """A runtime of the port comes up, runs a task and an actor, whose
    processes hold neither jax nor ray_tpu; after shutdown() no thread,
    worker process, shm segment or atexit hook of it is left for a
    later test file in the same process to meet."""
    import atexit

    import ray_tpu_torch
    import ray_tpu_torch._private.worker_context as wc

    hooks = []
    register, unregister = atexit.register, atexit.unregister

    def record(fn, *args, **kwargs):
        hooks.append(fn)
        return register(fn, *args, **kwargs)

    def drop(fn):
        while fn in hooks:
            hooks.remove(fn)
        return unregister(fn)

    monkeypatch.setattr(atexit, "register", record)
    monkeypatch.setattr(atexit, "unregister", drop)
    before = {t.ident for t in threading.enumerate()}
    ray_tpu_torch.init(num_cpus=1, num_gpus=0,
                       object_store_memory=32 * 1024 * 1024,
                       log_to_driver=False)

    def report():
        return os.getpid(), sorted(
            {m.split(".")[0] for m in sys.modules} &
            {"jax", "jaxlib", "ray_tpu", "torch"})

    task = ray_tpu_torch.remote(report)

    @ray_tpu_torch.remote
    class Actor:
        def report(self):
            return report()

    try:
        (pid_t, mods_t), (pid_a, mods_a) = ray_tpu_torch.get(
            [task.remote(), Actor.remote().report.remote()], timeout=120)
        shm = "/dev/shm" + wc.node().shm_name
        assert os.path.exists(shm)
    finally:
        ray_tpu_torch.shutdown()
    assert mods_t == [] and mods_a == []
    deadline = time.monotonic() + 10
    alive = [pid_t, pid_a]
    while alive and time.monotonic() < deadline:
        alive = [p for p in alive if _pid_alive(p)]
        time.sleep(0.05)
    assert not alive
    assert not os.path.exists(shm)
    assert not ray_tpu_torch.is_initialized()
    assert not [f for f in hooks
                if getattr(f, "__module__", "").startswith("ray_tpu_torch")]
    assert not [t.name for t in threading.enumerate()
                if t.ident not in before and t.name.startswith("raytpu")]
