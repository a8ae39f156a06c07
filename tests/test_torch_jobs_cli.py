"""The port's jobs, runtime_env, CLI and client builder against the JAX
package's.

Mirrors tests/test_job_submission.py (submit, logs, failure, env_vars,
working_dir, a job that attaches to the cluster, stop: the same
statuses and messages in both runtimes), tests/test_runtime_env.py (the
same validation errors, packing, hashes and plugins),
tests/test_cli.py (``python -m ray_tpu_torch start/status/list/submit/
job/stop`` in subprocesses, each run with its own temporary directory
so that the port's address and pid files are its own, never the JAX
CLI's ``/tmp/raytpu/``; ``memory``; the rllib subcommands and the
dashboard name their ROADMAP items) and tests/test_client_builder.py.
"""

import os
import re
import select
import signal
import stat
import subprocess
import sys
import tempfile
import textwrap
import time
from pathlib import Path

import pytest

import ray_tpu
import ray_tpu_torch
from ray_tpu import job as jjob
from ray_tpu import runtime_env as jre
from ray_tpu_torch import job as tjob
from ray_tpu_torch import runtime_env as tre
# autouse: the JAX runtime's loops settle before they stop
from tests.test_torch_jax_teardown import settle_jax_loops  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
STORE = 128 * 1024 * 1024


# ---- runtime_env ---------------------------------------------------------

@pytest.mark.parametrize("env", [
    {"bogus": 1}, {"env_vars": {"A": 1}}, {"env_vars": {1: "a"}}],
    ids=["unknown_field", "env_value_type", "env_key_type"])
def test_validate_errors_match_jax(env):
    msgs = []
    for mod in (jre, tre):
        with pytest.raises(ValueError) as e:
            mod.validate(env)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_validate_accepts_alike():
    env = {"env_vars": {"A": "1"}, "conda": "env1",
           "container": {"image": "x"}, "pip": ["pkg"]}
    assert tre.validate(env) == jre.validate(env) == env
    assert tre.validate(None) == jre.validate(None) == {}


def test_pack_and_materialize_roundtrip(tmp_path):
    src = tmp_path / "pkg"
    (src / "sub").mkdir(parents=True)
    (src / "data.txt").write_text("payload")
    (src / "mod.py").write_text("X = 5")
    (src / "sub" / "deep.txt").write_text("deeper")
    out = {}
    for key, mod in (("jax", jre), ("torch", tre)):
        kv = {}
        packed = mod.pack({"working_dir": str(src),
                           "py_modules": [str(src / "sub")]},
                          lambda k, v: kv.__setitem__(k, v))
        ctx = mod.materialize(packed, kv.get, str(tmp_path / f"c_{key}"))
        env = {"PYTHONPATH": "/base"}
        cwd = ctx.apply(env)
        out[key] = [packed, sorted(kv), sorted(os.listdir(cwd)),
                    [Path(p).name for p in env["PYTHONPATH"].split(":")]]
    assert out["torch"] == out["jax"]
    assert out["torch"][0]["working_dir"].startswith("gcs://runtimeenv/")


def test_env_hash_stable_and_equal():
    a = {"env_vars": {"A": "1", "B": "2"}}
    b = {"env_vars": {"B": "2", "A": "1"}}
    assert tre.env_hash(a) == tre.env_hash(b) == jre.env_hash(a)


def test_custom_plugin(tmp_path):
    for mod in (jre, tre):
        calls = []

        def my_plugin(value, ctx, kv_get, cache_dir):
            calls.append(value)
            ctx.env_vars["PLUGGED"] = str(value)

        mod.register_plugin("myfield", my_plugin)
        try:
            ctx = mod.materialize({"myfield": 7}, lambda k: None,
                                  str(tmp_path))
            assert calls == [7] and ctx.env_vars["PLUGGED"] == "7"
        finally:
            mod.PLUGINS.pop("myfield", None)
        with pytest.raises(RuntimeError, match="no runtime_env plugin"):
            mod.materialize({"myfield": 7}, lambda k: None, str(tmp_path))


def _fake_bin(tmp_path, name, script):
    fake = tmp_path / "bin"
    fake.mkdir(exist_ok=True)
    exe = fake / name
    exe.write_text(script)
    exe.chmod(exe.stat().st_mode | stat.S_IEXEC)
    return fake


def test_conda_plugin_activates_named_env(tmp_path, monkeypatch):
    """A named conda env gives the activation's variables, through a
    fake conda binary (none is installed here)."""
    base = tmp_path / "conda_base"
    (base / "envs" / "myenv" / "bin").mkdir(parents=True)
    fake = _fake_bin(tmp_path, "conda", f"#!/bin/sh\necho {base}\n")
    monkeypatch.setenv("PATH", f"{fake}:{os.environ['PATH']}")
    out = [mod.materialize({"conda": "myenv"}, lambda k: None,
                           str(tmp_path / "cache")).env_vars
           for mod in (jre, tre)]
    assert out[0] == out[1]
    assert out[1]["CONDA_PREFIX"] == str(base / "envs" / "myenv")
    assert out[1]["PATH"].startswith(str(base / "envs" / "myenv" / "bin"))


def test_conda_and_pip_fail_without_a_binary_or_index(tmp_path,
                                                      monkeypatch):
    """No conda binary: the same error.  pip is not run here (it would
    need an index); its plugin is the JAX package's, as is conda's."""
    monkeypatch.setenv("PATH", str(tmp_path))  # nothing on PATH
    msgs = []
    for mod in (jre, tre):
        with pytest.raises(RuntimeError, match="conda") as e:
            mod.materialize({"conda": "x"}, lambda k: None,
                            str(tmp_path / "cache"))
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    assert tre.PLUGINS.keys() == jre.PLUGINS.keys()


def test_container_plugin_builds_command_prefix(tmp_path, monkeypatch):
    fake = _fake_bin(tmp_path, "podman", "#!/bin/sh\nexit 0\n")
    monkeypatch.setenv("PATH", str(fake))
    env = {"container": {"image": "img:tag",
                         "run_options": ["-v", "/data:/data"]}}
    out = [mod.materialize(env, lambda k: None,
                           str(tmp_path / "cache")).command_prefix
           for mod in (jre, tre)]
    assert out[0] == out[1]
    assert out[1][0] == str(fake / "podman") and out[1][-1] == "img:tag"
    for mod in (jre, tre):
        with pytest.raises(RuntimeError, match="image"):
            mod.materialize({"container": {}}, lambda k: None,
                            str(tmp_path / "cache"))


# ---- the CLI -------------------------------------------------------------

def _env(tmp):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    env["TMPDIR"] = tmp  # the CLI's address and pid files live under it
    return env


def _cli(tmp, *args, timeout=120):
    return subprocess.run([sys.executable, "-m", "ray_tpu_torch", *args],
                          env=_env(tmp), cwd=str(REPO), capture_output=True,
                          text=True, timeout=timeout)


def _spawn(tmp, args):
    return subprocess.Popen(
        [sys.executable, "-m", "ray_tpu_torch", *args], env=_env(tmp),
        cwd=str(REPO), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)


def _wait_line(proc, needle, timeout=60):
    deadline = time.monotonic() + timeout
    lines = []
    while time.monotonic() < deadline:
        # readline blocks: wait for output (or the end) at most until the
        # deadline, so a silent node fails here instead of hanging
        ready, _, _ = select.select(
            [proc.stdout], [], [], max(0.0, deadline - time.monotonic()))
        if not ready:
            break
        line = proc.stdout.readline()
        if not line:
            if proc.poll() is not None:
                break
            time.sleep(0.05)
            continue
        lines.append(line)
        if needle in line:
            return line
    raise AssertionError(f"{needle!r} not seen in: {lines}")


@pytest.fixture
def cli_tmp():
    # short: the session's unix socket paths live under it
    d = tempfile.mkdtemp(prefix="rtc")
    yield d
    import shutil

    shutil.rmtree(d, ignore_errors=True)


def test_cli_round_trip(cli_tmp):
    """start --head, start --address (a node with a fake card), a driver
    attached across them, status and list agree, submit a job that
    attaches by RAYTPU_ADDRESS, job list/status/logs, stop: every node
    exits and the pid files are the port's own."""
    small = ["--object-store-memory", str(STORE)]
    head = _spawn(cli_tmp, ["start", "--head", "--host", "127.0.0.1",
                            "--port", "0", "--num-cpus", "0",
                            "--num-gpus", "0", *small])
    worker = None
    try:
        address = _wait_line(head, "GCS at ").strip().split("GCS at ")[-1]
        worker = _spawn(cli_tmp, ["start", "--address", address,
                                  "--num-cpus", "2", "--num-gpus", "1",
                                  *small])
        joined = _wait_line(worker, "joined").split()[1]
        pid_dir = Path(cli_tmp) / "raytpu_torch" / "pids"
        deadline = time.monotonic() + 30  # written just after "joined"
        while len(os.listdir(pid_dir)) < 2 and time.monotonic() < deadline:
            time.sleep(0.05)
        pids = sorted(os.listdir(pid_dir))
        assert [p.split("-")[0] for p in pids] == ["head", "node"]

        ray_tpu_torch.init(address=address, object_store_memory=STORE,
                           log_to_driver=False)
        try:
            @ray_tpu_torch.remote(num_cpus=1)
            def f(x):
                return x * 2, os.environ.get("RAYTPU_NODE_ID")

            @ray_tpu_torch.remote(num_gpus=1)
            def g():
                return os.environ.get("CUDA_VISIBLE_DEVICES")

            val, node = ray_tpu_torch.get(f.remote(21), timeout=60)
            assert val == 42 and node.startswith(joined)
            assert ray_tpu_torch.get(g.remote(), timeout=60) == "0"
            nodes = [n for n in ray_tpu_torch.nodes() if n["Alive"]]
            assert len(nodes) == 3  # head + worker + the driver's own
            assert ray_tpu_torch.cluster_resources()["GPU"] == 1.0
        finally:
            ray_tpu_torch.shutdown()

        st = _cli(cli_tmp, "status")  # the address file: no --address
        assert st.returncode == 0, st.stderr
        assert f"@ {address}" in st.stdout
        assert '"GPU": 1.0' in st.stdout.split("cluster totals:")[1]
        ls = _cli(cli_tmp, "list", "nodes", "--address", address)
        assert ls.returncode == 0, ls.stderr
        alive = {ln.split()[0] for ln in st.stdout.splitlines()
                 if "alive=True" in ln}
        listed = re.findall(r'"node_id": "([0-9a-f]+)",\s+"alive": true',
                            ls.stdout)
        assert joined in alive and any(n.startswith(joined) for n in listed)

        code = ("import os, ray_tpu_torch as r; r.init(address='auto'); "
                "print('JOB', os.environ['E'], r.cluster_resources()"
                "['GPU'])")
        sub = _cli(cli_tmp, "submit", "--address", address, "--env",
                   "E=on", "--", sys.executable, "-c", code, timeout=180)
        assert sub.returncode == 0, sub.stdout + sub.stderr
        assert "JOB on 1.0" in sub.stdout
        jid = re.search(r"submitted job (\S+)", sub.stdout).group(1)
        assert f"job {jid} finished: SUCCEEDED" in sub.stdout
        lst = _cli(cli_tmp, "job", "list", "--address", address)
        assert lst.returncode == 0 and f'"job_id": "{jid}"' in lst.stdout
        assert '"status": "SUCCEEDED"' in lst.stdout
        stj = _cli(cli_tmp, "job", "status", jid, "--address", address)
        assert stj.returncode == 0 and '"SUCCEEDED"' in stj.stdout
        logs = _cli(cli_tmp, "job", "logs", jid, "--address", address)
        assert logs.returncode == 0
        summ = _cli(cli_tmp, "summary", "--address", address)
        assert summ.returncode == 0 and '"tasks"' in summ.stdout
        tl = _cli(cli_tmp, "timeline", "--address", address, "--out",
                  str(Path(cli_tmp) / "tl.json"))
        assert tl.returncode == 0 and (Path(cli_tmp) / "tl.json").exists()
        mem = _cli(cli_tmp, "memory", "--address", address)
        assert mem.returncode == 0, mem.stderr
        assert mem.stdout.count('"store_capacity"') >= 2
        krn = _cli(cli_tmp, "kill-random-node", "--address", address)
        # one host, unix sockets: every node could host the GCS, and the
        # command refuses rather than risk the head (as the JAX CLI)
        assert krn.returncode == 1 and "refusing" in krn.stdout

        stop = _cli(cli_tmp, "stop")
        assert stop.returncode == 0
        assert stop.stdout.strip() == "signalled 2 node process(es)"
        for p in (worker, head):
            assert p.wait(timeout=30) == 0
        assert os.listdir(Path(cli_tmp) / "raytpu_torch" / "pids") == []
    finally:
        for p in (worker, head):
            if p is not None and p.poll() is None:
                p.send_signal(signal.SIGTERM)
                try:  # a node's stop takes up to ~15 s (its closes, IO)
                    p.wait(timeout=30)
                except subprocess.TimeoutExpired:
                    p.kill()


def test_cli_files_are_the_ports_own(cli_tmp):
    """The port's CLI keeps its address and pid files under its own
    directory; its `stop` with no node started signals nothing (and
    never reads the JAX CLI's /tmp/raytpu/pids)."""
    from ray_tpu.scripts import cli as jcli
    from ray_tpu_torch.scripts import cli as tcli

    assert Path(tcli._PID_DIR).parent.name == "raytpu_torch"
    assert Path(tcli._PID_DIR) != Path(jcli._PID_DIR)
    assert Path(tcli._ADDR_FILE) != Path(jcli._ADDR_FILE)
    stop = _cli(cli_tmp, "stop")
    assert stop.returncode == 0
    assert stop.stdout.strip() == "signalled 0 node process(es)"


def test_cli_memory_and_unported_subcommands(cli_tmp):
    """`memory`'s per-node store stats; an rllib algorithm not ported
    yet names what it waits for; the dashboard starts and lists a
    submitted job."""
    import json
    import urllib.request

    from ray_tpu_torch.dashboard import start_dashboard
    from ray_tpu_torch.job import submit_job
    from ray_tpu_torch.scripts import cli

    ray_tpu_torch.init(num_cpus=2, num_gpus=0, object_store_memory=STORE,
                       log_to_driver=False)
    try:
        ray_tpu_torch.get(ray_tpu_torch.put(b"x" * 200_000), timeout=120)
        stats = list(cli._each_node_stats())
        assert stats and stats[0][1]["object_store"]["capacity"] > 0
        assert stats[0][1]["object_store"]["bytes_used"] >= 200_000
        url = start_dashboard(port=0)
        job = submit_job("echo dashboard")
        with urllib.request.urlopen(url + "/api/jobs", timeout=60) as r:
            listed = json.loads(r.read())
        assert job in [j["job_id"] for j in listed]
    finally:
        ray_tpu_torch.shutdown()
    r = _cli(cli_tmp, "rllib", "train", "--run", "DQN", "--env",
             "CartPole-v1")
    assert r.returncode != 0
    assert "queue 1 item 7.13 (b)" in r.stderr


# ---- the client builder ------------------------------------------------

def _client_round_trip(rt):
    ctx = rt.client().connect()
    try:
        up = rt.is_initialized() and bool(ctx.address)

        @rt.remote
        def ping():
            return "pong"

        got = rt.get(ping.remote(), timeout=120)
    finally:
        ctx.disconnect()
    return [up, got, rt.is_initialized()]


def test_client_builder():
    assert _client_round_trip(ray_tpu_torch) == \
        _client_round_trip(ray_tpu) == [True, "pong", False]


def test_client_strips_the_ray_scheme():
    for rt in (ray_tpu, ray_tpu_torch):
        assert rt.client("ray://10.0.0.1:6380")._address == "10.0.0.1:6380"
        assert rt.client("10.0.0.1:6380").namespace("ns")._init_kwargs == \
            {"namespace": "ns"}


# ---- jobs (the module's shared runtimes start here, after the tests
# that start their own) ----------------------------------------------

@pytest.fixture(scope="module")
def job_clusters():
    ray_tpu.init(num_cpus=4, object_store_memory=STORE, log_to_driver=False)
    ray_tpu_torch.init(num_cpus=4, num_gpus=0, object_store_memory=STORE,
                       log_to_driver=False)
    yield {"jax": (jjob, "ray_tpu"), "torch": (tjob, "ray_tpu_torch")}
    ray_tpu_torch.shutdown()
    ray_tpu.shutdown()


def _run_job(job_api, entrypoint, **kw):
    jid = job_api.submit_job(entrypoint, **kw)
    info = job_api.wait_job(jid, timeout=180)
    return jid, info.status, info.message, job_api.get_job_logs(jid)


PY = sys.executable


def test_submit_job_runs_and_streams_logs(job_clusters):
    out = {}
    for key, (job_api, _) in job_clusters.items():
        jid, status, msg, logs = _run_job(
            job_api, f"{PY} -c \"print('hello from job'); print(6*7)\"")
        listed = any(j.job_id == jid for j in job_api.list_jobs())
        out[key] = [status, msg, logs.splitlines(), listed]
    assert out["torch"] == out["jax"]
    assert out["torch"] == ["SUCCEEDED", "", ["hello from job", "42"], True]


def test_job_failure_reported(job_clusters):
    out = {}
    for key, (job_api, _) in job_clusters.items():
        _, status, msg, _ = _run_job(
            job_api, f"{PY} -c 'raise SystemExit(3)'")
        out[key] = [status, msg]
    assert out["torch"] == out["jax"]
    assert out["torch"] == ["FAILED", "entrypoint exited with code 3"]


def test_job_env_vars(job_clusters):
    out = {}
    for key, (job_api, _) in job_clusters.items():
        _, status, _, logs = _run_job(
            job_api, f"{PY} -c \"import os; print('V=' + os.environ"
                     f"['MYVAR'] + ' ' + os.environ['RAYTPU_JOB_ID'][:11])\"",
            runtime_env={"env_vars": {"MYVAR": "gpu-rules"}})
        out[key] = [status, logs]
    assert out["torch"] == out["jax"]
    assert out["torch"] == ["SUCCEEDED", "V=gpu-rules raytpu-job-"]


def test_job_working_dir(job_clusters, tmp_path):
    (tmp_path / "mymod.py").write_text("MAGIC = 'wd-works'\n")
    (tmp_path / "main.py").write_text(textwrap.dedent("""
        import mymod
        print("MAGIC:" + mymod.MAGIC)
    """))
    out = {}
    for key, (job_api, _) in job_clusters.items():
        _, status, msg, logs = _run_job(
            job_api, f"{PY} main.py",
            runtime_env={"working_dir": str(tmp_path)})
        out[key] = [status, msg, logs]
    assert out["torch"] == out["jax"]
    assert out["torch"] == ["SUCCEEDED", "", "MAGIC:wd-works"]


def test_job_can_use_cluster(job_clusters):
    """A submitted script attaches to THIS cluster through RAYTPU_ADDRESS
    (init(address="auto")) and runs tasks on it."""
    out = {}
    for key, (job_api, pkg) in job_clusters.items():
        _, status, msg, logs = _run_job(
            job_api, f"{PY} -c \"import {pkg} as rt\n"
                     "rt.init(address='auto')\n"
                     "f = rt.remote(lambda x: x * 10)\n"
                     "print('RESULT:' + str(rt.get(f.remote(4), timeout=120)))\"")
        out[key] = [status, msg, "RESULT:40" in logs]
    assert out["torch"] == out["jax"]
    assert out["torch"] == ["SUCCEEDED", "", True]


def test_stop_job(job_clusters):
    out = {}
    for key, (job_api, _) in job_clusters.items():
        jid = job_api.submit_job(f"{PY} -c 'import time; time.sleep(600)'")
        deadline = time.monotonic() + 60
        while job_api.get_job_status(jid) == job_api.JobStatus.PENDING:
            assert time.monotonic() < deadline
            time.sleep(0.2)
        stopped = job_api.stop_job(jid)
        info = job_api.wait_job(jid, timeout=60)
        out[key] = [stopped, info.status, info.message]
    assert out["torch"] == out["jax"]
    assert out["torch"] == [True, "STOPPED", "stopped by user"]
