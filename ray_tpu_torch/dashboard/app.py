"""Dashboard server: cluster state as JSON + Prometheus text metrics.

A copy of ``ray_tpu/dashboard/app.py`` (reference analog:
dashboard/head.py:62 DashboardHead, and the metrics agent's Prometheus
re-export, _private/metrics_agent.py:93).  The JAX package's runs on
aiohttp, which the card's machine does not have; this one serves the
same 26 routes on the port's own HTTP layer
(``_private/http_server.py``, shared with the serve proxy) inside a
detached actor, and each route answers as the JAX package's does for
the same request:

  GET /api/nodes | /api/actors | /api/tasks | /api/placement_groups
  GET /api/summary
  GET /metrics          (Prometheus text format)
  POST|GET /api/jobs, GET /api/jobs/{job_id}[/logs],
  POST /api/jobs/{job_id}/stop
  PUT|GET /api/serve/applications
  GET /api/serve/stats | slo | kvscope | fleet | health,
  GET /api/serve/trace/{request_id}, GET /api/train/stats
  GET /api/perf/programs | /api/perf/autopilot, POST /api/perf/profile
  GET /api/events, POST /api/workflows/events, GET /

``/api/perf/autopilot`` runs ``tools/autopilot`` over the merged
program view (``?budget=`` sizes its next plan).
``/api/workflows/events`` reads ``workflow.events``, which the port does
not have yet (ROADMAP.md queue 1 item 7.3): its import fails and the
route answers aiohttp's 500, as the JAX package's answers when that
import fails.
"""

from __future__ import annotations

import asyncio
import json
import os
from dataclasses import asdict
from typing import Any, Callable, Dict

from ray_tpu_torch._private.http_server import (Router, ServerThread,
                                                json_response,
                                                text_response)

DASHBOARD_NAME = "RAYTPU_DASHBOARD"


def _merged_programs():
    """Fleet-wide program view: every live deployment's engine_stats()
    "programs" block merged over this process's own (mostly empty)
    registry — on a name collision the busiest replica view wins.
    Shared by /api/perf/programs and /api/perf/autopilot.  Returns
    (programs, per_deployment_blocks, devices)."""
    from ray_tpu_torch._private import device_stats as ds

    devices = ds.device_memory_stats()
    programs = ds.get_registry().snapshot()
    per_dep = {}
    try:
        from ray_tpu_torch.serve import api as serve_api

        for name in serve_api.status():
            try:
                stats = serve_api.engine_stats(name, timeout=15)
            except Exception:  # noqa: BLE001 - no stats
                continue
            blocks = stats.get("programs")
            if not isinstance(blocks, dict):
                continue
            per_dep[name] = blocks
            for prog, blk in blocks.items():
                cur = programs.get(prog)
                if (cur is None or blk.get(
                        "compile_events", 0) >= cur.get(
                        "compile_events", 0)):
                    programs[prog] = blk
    except Exception:  # noqa: BLE001 - serve not running
        pass
    return programs, per_dep, devices


def _error_text(e: BaseException) -> str:
    return f"{type(e).__name__}: {e}"[:300]


def _per_deployment(pick: Callable[[dict], Any]) -> Dict[str, Any]:
    """``pick(engine_stats())`` of every serve deployment, or its
    error; {} where serve is not running."""
    from ray_tpu_torch.serve import api as serve_api

    out = {}
    try:
        deployments = serve_api.status()
    except Exception:  # noqa: BLE001 - serve not running
        return out
    for name in deployments:
        try:
            out[name] = pick(serve_api.engine_stats(name, timeout=15))
        except Exception as e:  # noqa: BLE001 - no stats
            out[name] = {"error": _error_text(e)}
    return out


def _per_fleet(pick: Callable[[Any], Any]) -> Dict[str, Any]:
    """``pick(fleet)`` of every live ``build_llm_fleet()`` in this
    process, or its error."""
    from ray_tpu_torch.serve.router import fleet_registry

    out = {}
    for name, fleet in fleet_registry().items():
        try:
            out[name] = pick(fleet)
        except Exception as e:  # noqa: BLE001
            out[name] = {"error": _error_text(e)}
    return out


def _find_trace(rid: str):
    """One request's snapshot with its span tree, from a fleet or a
    deployment exposing ``request_trace``; None if none holds it."""
    from ray_tpu_torch.serve.router import fleet_registry
    from ray_tpu_torch.tools import tracebus

    snap = None
    for fleet in fleet_registry().values():
        try:
            snap = fleet.find_request(rid)
        except Exception:  # noqa: BLE001
            snap = None
        if snap is not None:
            break
    if snap is None:
        import ray_tpu_torch
        from ray_tpu_torch.serve import api as serve_api

        try:
            deployments = serve_api.status()
        except Exception:  # noqa: BLE001
            deployments = {}
        for name in deployments:
            try:
                handle = serve_api.get_deployment_handle(name)
                snap = ray_tpu_torch.get(
                    handle.method("request_trace").remote(rid), timeout=15)
            except Exception:  # noqa: BLE001
                snap = None
            if snap is not None:
                snap.setdefault("replica", name)
                break
    if snap is None:
        return None
    spans = tracebus.attach_device_spans(
        tracebus.build_request_spans(snap), snap,
        tracebus._device_programs())
    return dict(snap, spans=spans)


def _autopilot(budget: int = 8) -> dict:
    """``/api/perf/autopilot``'s document (``ray_tpu/dashboard/app.py:
    488-552``): the merged program view pushed through roofline
    attribution (which program is the bottleneck, compute- vs
    HBM-bound), with the tracebus p99 critical path of every live
    fleet's retained requests and a fleet's pooled kvscope and
    host-tier blocks as evidence, plus the ledger verdict and the next
    planned sweep (``tools/autopilot``)."""
    from ray_tpu_torch.tools.autopilot import attribution, verdict

    programs, per_dep, _ = _merged_programs()
    # request-side evidence: the tracebus p99 critical path
    req_ev = None
    try:
        from ray_tpu_torch.serve.router import fleet_registry
        from ray_tpu_torch.tools import tracebus

        reqs = []
        for fleet in fleet_registry().values():
            reqs.extend(fleet.trace_records())
        if reqs:
            req_ev = tracebus.request_evidence({"requests": reqs})
    except Exception:  # noqa: BLE001 - evidence optional
        req_ev = None
    # memory-side evidence: a live fleet's pooled kvscope block
    # (cache-thrash waste) and its host-tier block (churn absorbed)
    kv_ev = tier_ev = None
    try:
        from ray_tpu_torch.serve.router import fleet_registry

        for fleet in fleet_registry().values():
            fs = fleet.fleet_stats()
            ks, kt = fs.get("kv_scope"), fs.get("kv_tier")
            if ks and (ks.get("reprefill_waste_frac")
                       or (kt or {}).get("tokens_restored")):
                kv_ev = ks
                if kt and kt.get("enabled"):
                    tier_ev = kt
                break
    except Exception:  # noqa: BLE001 - evidence optional
        kv_ev = tier_ev = None
    att = attribution.attribute(programs, request_anatomy=req_ev,
                                kv_scope=kv_ev, kv_tier=tier_ev)
    try:
        v = verdict.build_verdict(budget=budget, attribution=att)
    except Exception as e:  # noqa: BLE001 - no ledger
        v = {"error": f"{type(e).__name__}: {e}"[:300],
             "attribution": att}
    v["deployments"] = sorted(per_dep)
    return v


class DashboardActor:
    def __init__(self, host: str = "127.0.0.1", port: int = 8265):
        self.host = host
        # port 0 binds a free port, reported by address()
        self._server = ServerThread(self._router(), host, port,
                                    "dashboard")
        self.port = self._server.port
        self._write_prom_service_discovery()

    def _write_prom_service_discovery(self) -> None:
        """Prometheus file-based service discovery (reference:
        _private/metrics_agent.py:340 PrometheusServiceDiscoveryWriter):
        point prometheus at
        <session_dir>/prom_metrics_service_discovery.json via
        file_sd_configs and it scrapes the cluster's /metrics."""
        from ray_tpu_torch._private import worker_context

        node = worker_context.node()
        # the dashboard usually runs as a remote actor: no Node object in
        # this process, but every worker carries the session dir in env
        session_dir = (node.session_dir if node is not None
                       else os.environ.get("RAYTPU_SESSION_DIR", ""))
        if not session_dir:
            return
        path = os.path.join(session_dir,
                            "prom_metrics_service_discovery.json")
        tmp = path + ".tmp"
        try:
            with open(tmp, "w") as f:
                json.dump([{
                    "labels": {"job": "ray_tpu"},
                    "targets": [f"{self.host}:{self.port}"],
                }], f)
            os.replace(tmp, path)  # atomic: prometheus may be reading
        except OSError:
            pass

    def _metrics_text(self) -> str:
        from ray_tpu_torch._private import worker_context
        from ray_tpu_torch.util import state
        from ray_tpu_torch.util.metrics import collect_cluster_metrics

        lines = []
        nodes = state.list_nodes()
        lines.append("# TYPE raytpu_nodes gauge")
        lines.append(f"raytpu_nodes {sum(n['alive'] for n in nodes)}")
        for n in nodes:
            nid = n["node_id"][:12]
            for res, total in n["resources"].items():
                avail = n["available"].get(res, 0.0)
                name = res.lower().replace("-", "_")
                lines.append(
                    f'raytpu_resource_total{{node="{nid}",resource='
                    f'"{name}"}} {total}')
                lines.append(
                    f'raytpu_resource_available{{node="{nid}",resource='
                    f'"{name}"}} {avail}')
        actors = state.summarize_actors()
        lines.append("# TYPE raytpu_actors gauge")
        for st, count in actors["by_state"].items():
            lines.append(f'raytpu_actors{{state="{st}"}} {count}')
        tasks = state.summarize_tasks()
        lines.append("# TYPE raytpu_tasks_finished_total counter")
        lines.append(f"raytpu_tasks_finished_total {tasks['total']}")
        lines.append("# TYPE raytpu_task_execution_seconds_total counter")
        lines.append(f"raytpu_task_execution_seconds_total "
                     f"{tasks['total_execution_s']}")
        # Application-defined metrics published by every process
        # (ray_tpu_torch.util.metrics -> GCS KV snapshots).
        cw = worker_context.maybe_core_worker()
        if cw is not None:
            try:
                lines.extend(collect_cluster_metrics(cw.kv_get,
                                                     cw.kv_keys))
            except Exception:  # noqa: BLE001 - metrics must not 500
                pass
        return "\n".join(lines) + "\n"

    def _router(self) -> Router:
        from ray_tpu_torch import job as job_api
        from ray_tpu_torch.util import state

        def run(fn):
            return asyncio.get_running_loop().run_in_executor(None, fn)

        def j(fn):
            async def handler(_req):
                return json_response(await run(fn))

            return handler

        r = Router()
        r.add_get("/api/nodes", j(state.list_nodes))
        r.add_get("/api/actors", j(state.list_actors))
        r.add_get("/api/tasks", j(state.list_tasks))
        r.add_get("/api/placement_groups", j(state.list_placement_groups))
        r.add_get("/api/summary", j(lambda: {
            "tasks": state.summarize_tasks(),
            "actors": state.summarize_actors(),
            "nodes": len(state.list_nodes())}))

        async def metrics(_req):
            return text_response(await run(self._metrics_text))

        r.add_get("/metrics", metrics)

        # Job submission REST (reference: dashboard/modules/job routes).
        async def jobs_submit(req):
            body = req.json()
            jid = await run(lambda: job_api.submit_job(
                body["entrypoint"], runtime_env=body.get("runtime_env"),
                metadata=body.get("metadata"), job_id=body.get("job_id")))
            return json_response({"job_id": jid})

        async def jobs_list(_req):
            jobs = await run(job_api.list_jobs)
            return json_response([asdict(i) for i in jobs])

        async def jobs_status(req):
            info = await run(lambda: job_api.get_job_info(
                req.match_info["job_id"]))
            return json_response(asdict(info))

        async def jobs_logs(req):
            text = await run(lambda: job_api.get_job_logs(
                req.match_info["job_id"]))
            return json_response({"logs": text})

        async def jobs_stop(req):
            ok = await run(lambda: job_api.stop_job(
                req.match_info["job_id"]))
            return json_response({"stopped": ok})

        r.add_post("/api/jobs", jobs_submit)
        r.add_get("/api/jobs", jobs_list)
        r.add_get("/api/jobs/{job_id}", jobs_status)
        r.add_get("/api/jobs/{job_id}/logs", jobs_logs)
        r.add_post("/api/jobs/{job_id}/stop", jobs_stop)

        # Declarative serve REST (reference: dashboard serve module,
        # PUT /api/serve/applications/ consuming ServeApplicationSchema).
        async def serve_apply(req):
            from ray_tpu_torch.serve import schema as serve_schema

            body = req.json()
            try:
                await run(lambda: serve_schema.apply(body))
            except (ValueError, TypeError, KeyError, AttributeError,
                    ImportError) as e:
                # config/validation-class errors (bad types, unknown
                # import paths) are the CLIENT's fault: 400, not 500
                return json_response(
                    {"error": f"{type(e).__name__}: {e}"}, 400)
            return json_response(await run(serve_schema.status))

        async def serve_status(_req):
            from ray_tpu_torch.serve import schema as serve_schema

            return json_response(await run(serve_schema.status))

        r.add_put("/api/serve/applications", serve_apply)
        r.add_get("/api/serve/applications", serve_status)

        # Engine telemetry (serve/telemetry.py): one engine_stats()
        # snapshot per deployment; its SLO burn rates and flight
        # recorder (serve/slo.py, _private/flightrec.py); its kvscope
        # and host tier (serve/kvscope.py).
        r.add_get("/api/serve/stats", j(lambda: _per_deployment(
            lambda s: s)))
        r.add_get("/api/serve/slo", j(lambda: _per_deployment(
            lambda s: {"slo": s.get("slo"),
                       "flightrec": s.get("flightrec")})))
        r.add_get("/api/serve/kvscope", j(lambda: _per_deployment(
            lambda s: {"kv_scope": s.get("kv_scope"),
                       "kv_tier": s.get("kv_tier")})))
        # Fleet control plane (serve/router.py) and its healthwatch
        # block (serve/health.py), per live fleet in this process.
        r.add_get("/api/serve/fleet", j(lambda: _per_fleet(
            lambda f: f.fleet_stats())))
        r.add_get("/api/serve/health", j(lambda: _per_fleet(
            lambda f: f._health_block())))

        # Trainwatch (train/telemetry.py + train/goodput.py): one
        # train_stats() snapshot per trainer that has stepped in THIS
        # process.
        def train_view():
            from ray_tpu_torch.train.goodput import registered_trainers
            from ray_tpu_torch.train.telemetry import train_stats

            out = {}
            for name in registered_trainers():
                try:
                    out[name] = train_stats(name)
                except Exception as e:  # noqa: BLE001
                    out[name] = {"error": _error_text(e)}
            return out

        r.add_get("/api/train/stats", j(train_view))

        # Tracebus (tools/tracebus.py): one request's causal span tree
        # by trace id (full or prefix) or engine-local id.
        async def serve_trace(req):
            rid = req.match_info["request_id"]
            data = await run(lambda: _find_trace(rid))
            if data is None:
                return json_response(
                    {"error": f"request {rid!r} not found"}, 404)
            return json_response(data)

        r.add_get("/api/serve/trace/{request_id}", serve_trace)

        # Perf observatory (_private/device_stats.py): per-program
        # compile events and invokes, per-card allocator stats, merged
        # over every live deployment's engine_stats() "programs" block.
        def perf_programs():
            from ray_tpu_torch._private import device_stats as ds

            programs, per_dep, devices = _merged_programs()
            return {"programs": programs, "deployments": per_dep,
                    "devices": devices,
                    "peak_flops_per_chip": ds.peak_flops_per_chip()}

        r.add_get("/api/perf/programs", j(perf_programs))

        async def perf_autopilot(req):
            budget = int(req.query.get("budget", 8))
            return json_response(await run(lambda: _autopilot(budget)))

        r.add_get("/api/perf/autopilot", perf_autopilot)

        # On-demand profiler capture (util/state.py profile_device):
        # POST {"logdir": ..., "seconds": 1.0} traces this process for
        # the window and returns where the trace landed.
        async def perf_profile(req):
            try:
                body = req.json()
            except Exception:  # noqa: BLE001 - empty body is fine
                body = {}
            logdir = str(body.get("logdir", "/tmp/raytpu_profile"))
            seconds = min(60.0, max(0.0, float(body.get("seconds", 1.0))))

            def capture():
                import time as _time

                from ray_tpu_torch.util.state import profile_device

                with profile_device(logdir) as prof:
                    _time.sleep(seconds)
                return bool(prof._active)

            ok = await run(capture)
            return json_response({"ok": ok, "logdir": logdir,
                                  "seconds": seconds})

        r.add_post("/api/perf/profile", perf_profile)

        # Structured events (reference: dashboard event module consuming
        # RAY_EVENT files, src/ray/util/event.h:41).
        async def events_list(req):
            from ray_tpu_torch._private import events as ev

            recs = await run(lambda: ev.read_events(
                limit=int(req.query.get("limit", 200)),
                severity=req.query.get("severity"),
                source=req.query.get("source")))
            return json_response(recs)

        r.add_get("/api/events", events_list)

        # Workflow event provider (reference:
        # workflow/http_event_provider.py); ``workflow`` waits for
        # ROADMAP.md queue 1 item 7.3, so its import fails here.
        async def workflow_post_event(req):
            body = req.json()
            name = body.get("name")
            if not name:
                return json_response({"error": "missing 'name'"}, 400)

            def post():
                from ray_tpu_torch.workflow.events import post_event

                post_event(name, body.get("payload"))

            await run(post)
            return json_response({"posted": name})

        r.add_post("/api/workflows/events", workflow_post_event)

        async def index(_req):
            from ray_tpu_torch.dashboard.frontend import INDEX_HTML

            return text_response(INDEX_HTML, content_type="text/html")

        r.add_get("/", index)
        return r

    def address(self) -> str:
        return f"http://{self.host}:{self.port}"

    def ping(self) -> bool:
        return self._server.started()


def start_dashboard(port: int = 8265, host: str = "127.0.0.1") -> str:
    """Start (or find) the dashboard actor; returns its URL.  Port 0
    binds a free port."""
    import ray_tpu_torch

    ray_tpu_torch._auto_init()
    try:
        actor = ray_tpu_torch.get_actor(DASHBOARD_NAME)
    except Exception:  # noqa: BLE001
        actor = ray_tpu_torch.remote(
            num_cpus=0.1, lifetime="detached",
            name=DASHBOARD_NAME)(DashboardActor).remote(host, port)
    ray_tpu_torch.get(actor.ping.remote(), timeout=60)
    return ray_tpu_torch.get(actor.address.remote(), timeout=30)
