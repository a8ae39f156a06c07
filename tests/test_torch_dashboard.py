"""The port's dashboard (``ray_tpu_torch/dashboard/``, on the port's own
HTTP layer) against the JAX package's (aiohttp), on the CPU.

Both runtimes are up at once, each with its dashboard started by
``start_dashboard`` on a free port, and every request goes to both
dashboards: every GET route, a job submitted by POST with its status,
logs and stop, an ``apply`` by PUT (and a bad one), a trace that is not
there, a profile capture, a 404 and a 405.  Status codes, content types
and JSON bodies must be equal after normalising only what differs by
nature between two runtimes (:func:`_norm`):

* ids: node, actor, task, worker, job and placement-group ids, the
  ``node:<id>`` resource, pids;
* timestamps and durations: ``start``/``end``/``start_time``/
  ``end_time``, ``total_execution_s``, the dashboard actor's timings;
* addresses: node and worker socket paths, URLs, log directories.

``/metrics`` is compared line by line by metric name and labels (the
node label normalised, the test process's own application metrics left
out).  ``/api/perf/autopilot`` is held to an in-process JAX dashboard on
the same empty ledger and fresh program registries;
``/api/workflows/events`` reads a module the port lacks (ROADMAP.md
queue 1 item 7.3): its answer is held to a JAX dashboard whose import
of that module fails.
"""

import http.client
import json
import os
import re
import socket
import sys
import time

import pytest

import ray_tpu
import ray_tpu_torch
from ray_tpu_torch._private._vendor import cloudpickle as port_cloudpickle
# autouse: the JAX runtime's loops settle before they stop
from tests.test_torch_jax_teardown import settle_jax_loops  # noqa: F401

port_cloudpickle.register_pickle_by_value(sys.modules[__name__])

STORE = 128 * 1024 * 1024
#: the longest a test waits for one result or one reply
WAIT_S = 120


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _request(url, method, path, body=None):
    """(status, content type, body: JSON where it is JSON, else text)."""
    host, port = url.split("//", 1)[1].split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=WAIT_S)
    try:
        data = None if body is None else json.dumps(body).encode()
        conn.request(method, path, body=data,
                     headers={"Content-Type": "application/json"}
                     if data is not None else {})
        r = conn.getresponse()
        raw = r.read()
        ctype = r.getheader("Content-Type")
        allow = r.getheader("Allow")
    finally:
        conn.close()
    text = raw.decode()
    try:
        payload = json.loads(text) if ctype.startswith(
            "application/json") else text
    except ValueError:
        payload = text
    return [r.status, ctype, allow, payload]


_ID_KEYS = {"node_id", "actor_id", "task_id", "worker_id", "job_id",
            "placement_group_id", "pg_id", "pid", "owner", "submission_id"}
_TIME_KEYS = {"start", "end", "start_time", "end_time",
              "total_execution_s", "timestamp", "time", "created_at"}
_ADDR_KEYS = {"address", "url", "logdir", "log_path", "socket"}


def _norm(obj, key=None):
    """Ids, timestamps and addresses replaced by placeholders."""
    if isinstance(obj, dict):
        out = {}
        for k, v in obj.items():
            nk = "node:<id>" if isinstance(k, str) and \
                k.startswith("node:") else k
            out[nk] = _norm(v, k)
        return out
    if isinstance(obj, list):
        return [_norm(v, key) for v in obj]
    if key in _ID_KEYS and obj not in (None, ""):
        return "<id>"
    if key in _TIME_KEYS and obj not in (None, 0, 0.0):
        return "<time>"
    if key in _ADDR_KEYS and obj not in (None, ""):
        return "<addr>"
    return obj


def _metric_keys(text, skip_worker=None):
    """{(name, labels)} of a Prometheus text page, the node label
    normalised; the lines of worker ``skip_worker`` (an id's first 12
    characters) left out."""
    keys = set()
    for line in text.splitlines():
        if not line or line.startswith("#") or \
                f'worker="{skip_worker}"' in line:
            continue
        head = line.rsplit(" ", 1)[0]
        head = re.sub(r'node="[0-9a-f]+"', 'node="<id>"', head)
        head = re.sub(r'resource="node:[0-9a-f]+"', 'resource="node:<id>"',
                      head)
        head = re.sub(r'worker="[0-9a-f]+"', 'worker="<id>"', head)
        keys.add(head)
    return keys


@pytest.fixture(scope="module")
def dashboards():
    from ray_tpu.dashboard import start_dashboard as jstart
    from ray_tpu_torch.dashboard import start_dashboard as tstart

    ray_tpu.init(num_cpus=4, object_store_memory=STORE, log_to_driver=False)
    ray_tpu_torch.init(num_cpus=4, num_gpus=0, object_store_memory=STORE,
                       log_to_driver=False)
    try:
        urls = {"jax": jstart(port=_free_port()), "torch": tstart(port=0)}
        yield urls
    finally:
        ray_tpu_torch.shutdown()
        ray_tpu.shutdown()


def _both(urls, method, path, body=None):
    return {k: _request(u, method, path, body) for k, u in urls.items()}


def _program(rt):
    """A fixed program each runtime runs before its dashboard is read:
    three tasks, a named actor called once, a placement group."""
    import importlib

    pgmod = importlib.import_module(f"{rt.__name__}.util.placement_group")
    state = importlib.import_module(f"{rt.__name__}.util.state")

    @rt.remote
    def square(x):
        return x * x

    @rt.remote
    class Keeper:
        def get(self):
            return 3

    assert rt.get([square.remote(i) for i in range(3)],
                  timeout=WAIT_S) == [0, 1, 4]
    keeper = Keeper.options(name="keeper").remote()
    assert rt.get(keeper.get.remote(), timeout=WAIT_S) == 3
    pg = pgmod.placement_group([{"CPU": 0.25}], name="dash_pg")
    pg.ready(timeout=WAIT_S)
    # the workers flush their task events about every 1 s
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        names = state.summarize_tasks()["by_func_name"]
        if names.get("square") == 3 and names.get("get") == 1:
            break
        time.sleep(0.2)
    return keeper


@pytest.fixture(scope="module")
def programs(dashboards):
    return {rt.__name__: _program(rt) for rt in (ray_tpu, ray_tpu_torch)}


def _body(path, body):
    """The normalised body of ``path``'s reply; lists sorted.  The JAX
    package lists its CPU backend among the devices of
    ``/api/perf/programs``, the port only cards (none here)."""
    body = _norm(body)
    if path == "/api/perf/programs" and isinstance(body, dict):
        body["devices"] = [d for d in body["devices"]
                           if d["platform"] != "cpu"]
    if isinstance(body, list):
        body = sorted(body, key=lambda x: json.dumps(x, sort_keys=True))
    return body


ROUTES = [
    ("GET", p, None) for p in (
        "/api/nodes", "/api/actors", "/api/tasks", "/api/placement_groups",
        "/api/summary", "/api/jobs", "/api/serve/applications",
        "/api/serve/stats", "/api/serve/slo", "/api/serve/kvscope",
        "/api/serve/fleet", "/api/serve/health", "/api/train/stats",
        "/api/serve/trace/no-such-request", "/api/perf/programs",
        "/api/events", "/api/events?limit=5&severity=ERROR", "/",
        "/no/such/route", "/api/jobs/", "/api/nodes/")] + [
    ("HEAD", "/api/summary", None),
    ("POST", "/api/nodes", None),
    ("PUT", "/api/jobs", {}),
    ("DELETE", "/api/serve/applications", None),
    ("POST", "/api/jobs", None),
    ("POST", "/api/workflows/events", {"payload": 1}),
    ("PUT", "/api/serve/applications", {"import_path": "m:a",
                                        "route_prefix": "nope"}),
    ("PUT", "/api/serve/applications", {"import_path": "no_such_mod:app"}),
]


@pytest.mark.parametrize("method,path,body", ROUTES,
                         ids=[f"{m} {p}" for m, p, _ in ROUTES])
def test_route_matches_jax(dashboards, programs, method, path, body):
    got = _both(dashboards, method, path, body)
    want, port = got["jax"], got["torch"]
    assert port[:3] == want[:3]
    assert _body(path, port[3]) == _body(path, want[3])


def test_metrics_match_jax_line_by_line(dashboards, programs):
    """/metrics: the same metric names and labels, and the same node
    and resource counts.  The application lines this test process
    publishes (what other test modules run in it registered) are left
    out on each side.  A worker reports its finished tasks up to 8 s
    after they end (its event flush backs off while idle), so the pages
    are read again until the counts agree, for at most 30 s."""
    import importlib

    def values(text, name):
        return sorted(re.sub(r'node="[0-9a-f]+"', "", ln)
                      for ln in text.splitlines() if ln.startswith(name)
                      and "node:" not in ln and "memory" not in ln)

    names = ("raytpu_nodes", "raytpu_resource_total", "raytpu_actors",
             "raytpu_tasks_finished_total")
    deadline = time.monotonic() + 30
    while True:
        got = _both(dashboards, "GET", "/metrics")
        pages = {k: v[3] for k, v in got.items()}
        counts = {k: [values(pages[k], n) for n in names] for k in pages}
        if counts["torch"] == counts["jax"] or \
                time.monotonic() > deadline:
            break
        time.sleep(0.5)
    assert got["torch"][:3] == got["jax"][:3] == \
        [200, "text/plain; charset=utf-8", None]
    me = {k: importlib.import_module(f"{pkg}._private.worker_context")
          .core_worker().worker_id.hex()[:12]
          for k, pkg in (("jax", "ray_tpu"), ("torch", "ray_tpu_torch"))}
    assert _metric_keys(pages["torch"], me["torch"]) == \
        _metric_keys(pages["jax"], me["jax"])
    for name, port, want in zip(names, counts["torch"], counts["jax"]):
        assert port == want, name


def test_job_routes_match_jax(dashboards, programs):
    """A job by POST, its status until it ends, its logs, a stop of the
    ended job, and the list holding it."""
    sub = _both(dashboards, "POST", "/api/jobs",
                {"entrypoint": "echo dashboard-job", "metadata": {"k": "v"}})
    assert sub["torch"][:3] == sub["jax"][:3]
    ids = {k: v[3]["job_id"] for k, v in sub.items()}
    status = {}
    for k, url in dashboards.items():
        deadline = time.monotonic() + WAIT_S
        while time.monotonic() < deadline:
            status[k] = _request(url, "GET", f"/api/jobs/{ids[k]}")
            if status[k][3]["status"] in ("SUCCEEDED", "FAILED", "STOPPED"):
                break
            time.sleep(0.2)
    assert _norm(status["torch"]) == _norm(status["jax"])
    assert status["torch"][3]["status"] == "SUCCEEDED"
    for suffix, method in (("/logs", "GET"), ("/stop", "POST")):
        got = {k: _request(url, method, f"/api/jobs/{ids[k]}{suffix}")
               for k, url in dashboards.items()}
        assert _norm(got["torch"]) == _norm(got["jax"])
    listed = _both(dashboards, "GET", "/api/jobs")
    assert {k: [j["job_id"] for j in v[3]] for k, v in listed.items()} == \
        {k: [ids[k]] for k in ids}


def _key_tree(d):
    if isinstance(d, dict):
        return {k: _key_tree(v) for k, v in d.items()}
    return type(d).__name__ if d is not None else None


def test_serve_apply_by_put_and_stats_match_jax(dashboards, programs):
    """PUT /api/serve/applications deploys GPT-2 nano through each
    package's ``build_llm_deployment`` (the port's on the CPU, its
    counterpart of JAX_PLATFORMS=cpu); after one request the
    applications, stats, slo and kvscope routes answer alike: the same
    status document, the same key tree, the same request counts."""
    import numpy as np

    from ray_tpu import serve as jserve
    from ray_tpu_torch import serve as tserve

    configs = {
        "jax": {"import_path": "ray_tpu.serve.llm:build_llm_deployment",
                "args": {"family": "gpt2", "preset": "nano",
                         "max_new_tokens": 2},
                "deployments": [{"name": "llm_gpt2_nano"}]},
        "torch": {"import_path":
                  "ray_tpu_torch.serve.llm:build_llm_deployment",
                  "args": {"family": "gpt2", "preset": "nano",
                           "max_new_tokens": 2, "device": "cpu"},
                  "deployments": [{"name": "llm_gpt2_nano"}]}}
    serves = {"jax": jserve, "torch": tserve}
    try:
        applied = {k: _request(url, "PUT", "/api/serve/applications",
                               configs[k])
                   for k, url in dashboards.items()}
        assert _norm(applied["torch"]) == _norm(applied["jax"])
        assert applied["torch"][0] == 200
        prompt = np.arange(8, dtype=np.int32)
        for k, serve in serves.items():
            serve.get_deployment_handle("llm_gpt2_nano").call(
                prompt, timeout=WAIT_S)
        for path in ("/api/serve/applications", "/api/serve/stats",
                     "/api/serve/slo", "/api/serve/kvscope"):
            got = _both(dashboards, "GET", path)
            assert got["torch"][:3] == got["jax"][:3] == \
                [200, "application/json; charset=utf-8", None]
            assert _key_tree(got["torch"][3]) == _key_tree(got["jax"][3])
            if path == "/api/serve/stats":
                reqs = {k: v[3]["llm_gpt2_nano"]["requests"]
                        for k, v in got.items()}
                assert reqs["torch"]["finished"] == \
                    reqs["jax"]["finished"] == 1
            if path == "/api/serve/applications":
                assert _norm(got["torch"]) == _norm(got["jax"])
    finally:
        for serve in serves.values():
            serve.shutdown()


def test_profile_capture_matches_jax(dashboards, programs, tmp_path):
    got = {k: _request(url, "POST", "/api/perf/profile",
                       {"seconds": 0.1, "logdir": str(tmp_path / k)})
           for k, url in dashboards.items()}
    assert _norm(got["torch"]) == _norm(got["jax"])
    assert got["torch"][3]["ok"] is True
    assert os.listdir(tmp_path / "torch")


def test_unported_routes_answer_as_jax_when_the_import_fails(
        dashboards, programs, monkeypatch, tmp_path):
    """``/api/perf/autopilot`` (ported: tools/autopilot) against an
    in-process JAX dashboard on the same empty ledger and fresh program
    registries: the same 200 document, with and without ``?budget=``.
    ``/api/workflows/events`` against a JAX dashboard whose import of
    ``workflow.events`` fails: both give aiohttp's 500."""
    from ray_tpu._private import device_stats as jds
    from ray_tpu.dashboard.app import DashboardActor
    from ray_tpu_torch._private import device_stats as tds
    from ray_tpu_torch.dashboard.app import DashboardActor as TDashboard

    monkeypatch.setenv("RAYTPU_BENCH_HISTORY", str(tmp_path / "h.jsonl"))
    monkeypatch.setattr(jds, "_registry", jds.ProgramRegistry())
    monkeypatch.setattr(tds, "_registry", tds.ProgramRegistry())
    monkeypatch.setitem(sys.modules, "ray_tpu.workflow.events", None)
    urls = {"jax": DashboardActor("127.0.0.1", _free_port()).address(),
            "torch": TDashboard("127.0.0.1", 0).address()}
    for path in ("/api/perf/autopilot", "/api/perf/autopilot?budget=2"):
        got = _both(urls, "GET", path)
        assert got["torch"] == got["jax"]
        assert got["torch"][0] == 200
        doc = got["torch"][3]
        assert doc["ok"] is True and doc["entries"] == 0
        assert len(doc["plan"]["variants"]) == (2 if "budget" in path
                                                else 8)
    urls["torch"] = dashboards["torch"]
    got = _both(urls, "POST", "/api/workflows/events", {"name": "go"})
    assert got["torch"] == got["jax"]
    assert got["torch"][0] == 500
