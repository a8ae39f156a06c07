"""JobManager + JobSupervisor actors and the client API (a copy of
``ray_tpu/job/manager.py``).

Reference mapping:
* ``JobManager`` (reference ``dashboard/modules/job/job_manager.py:376``)
  -> a detached named actor owning the job table (persisted in GCS KV so
  it survives the manager actor itself) and spawning supervisors.
* ``JobSupervisor`` (reference ``:128``) -> a detached actor per job that
  runs the entrypoint as a child process inside the job's runtime env,
  streams its output to a log buffer, and reports terminal status.
* ``submit_job`` / status / logs / stop / list (reference ``:520`` and
  the REST routes) -> module-level client functions + dashboard routes.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import threading
import time
import uuid
from dataclasses import asdict, dataclass, field
from typing import Any, Dict, List, Optional

JOB_MANAGER_NAME = "RAYTPU_JOB_MANAGER"
_KV_PREFIX = "job:"


class JobStatus:
    PENDING = "PENDING"
    RUNNING = "RUNNING"
    SUCCEEDED = "SUCCEEDED"
    FAILED = "FAILED"
    STOPPED = "STOPPED"

    TERMINAL = (SUCCEEDED, FAILED, STOPPED)


@dataclass
class JobInfo:
    job_id: str
    entrypoint: str
    status: str = JobStatus.PENDING
    message: str = ""
    runtime_env: Dict[str, Any] = field(default_factory=dict)
    metadata: Dict[str, str] = field(default_factory=dict)
    start_time: float = 0.0
    end_time: float = 0.0


class JobSupervisor:
    """Detached actor running one job's entrypoint as a subprocess.

    The child gets RAYTPU_ADDRESS so `ray_tpu_torch.init(address="auto")`
    in the script attaches to this cluster (reference: the supervisor exports
    RAY_ADDRESS, job_manager.py:128).
    """

    def __init__(self, job_id: str, entrypoint: str,
                 runtime_env: Dict[str, Any], gcs_address: str):
        self.job_id = job_id
        self.entrypoint = entrypoint
        self.runtime_env = runtime_env or {}
        self.gcs_address = gcs_address
        self._logs: List[str] = []
        self._proc: Optional[subprocess.Popen] = None
        self._status = JobStatus.PENDING
        self._message = ""
        self._stop_requested = False
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=f"job-{job_id}")
        self._thread.start()

    def _setup_env(self) -> tuple:
        from ray_tpu_torch import runtime_env as re_mod
        from ray_tpu_torch._private import worker_context

        env = dict(os.environ)
        env["RAYTPU_ADDRESS"] = self.gcs_address
        env["RAYTPU_JOB_ID"] = self.job_id
        cwd = None
        if self.runtime_env:
            cw = worker_context.core_worker()
            cache = os.path.join(
                os.environ.get("RAYTPU_SESSION_DIR") or os.path.join(
                    tempfile.gettempdir(), "raytpu_torch"),
                "runtime_envs")
            ctx = re_mod.materialize(self.runtime_env, cw.kv_get, cache)
            cwd = ctx.apply(env)
            if ctx.command_prefix:
                # container plugin: wrap the shell entrypoint, forwarding
                # the cluster handshake + runtime-env vars INTO the
                # container (the engine child doesn't inherit our env)
                import shlex

                fwd = dict(ctx.env_vars)
                fwd["RAYTPU_ADDRESS"] = env["RAYTPU_ADDRESS"]
                fwd["RAYTPU_JOB_ID"] = env["RAYTPU_JOB_ID"]
                prefix = list(ctx.command_prefix)
                image = prefix.pop()
                for k, v in fwd.items():
                    prefix += ["-e", f"{k}={v}"]
                prefix.append(image)
                self.entrypoint = " ".join(
                    shlex.quote(p) for p in prefix
                ) + " /bin/sh -c " + shlex.quote(self.entrypoint)
        return env, cwd

    def _run(self):
        try:
            env, cwd = self._setup_env()
        except Exception as e:  # noqa: BLE001 - env setup failed
            self._status = JobStatus.FAILED
            self._message = f"runtime_env setup failed: {e}"
            self._logs.append(self._message)
            return
        try:
            self._proc = subprocess.Popen(
                self.entrypoint, shell=True, env=env, cwd=cwd,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True, bufsize=1)
        except Exception as e:  # noqa: BLE001
            self._status = JobStatus.FAILED
            self._message = f"failed to start entrypoint: {e}"
            return
        self._status = JobStatus.RUNNING
        for line in self._proc.stdout:
            self._logs.append(line.rstrip("\n"))
            if len(self._logs) > 100_000:
                del self._logs[:50_000]
        rc = self._proc.wait()
        if self._stop_requested:
            self._status = JobStatus.STOPPED
            self._message = "stopped by user"
        elif rc == 0:
            self._status = JobStatus.SUCCEEDED
        else:
            self._status = JobStatus.FAILED
            self._message = f"entrypoint exited with code {rc}"

    def status(self) -> Dict[str, str]:
        return {"status": self._status, "message": self._message}

    def logs(self, tail: int = -1) -> str:
        lines = self._logs if tail < 0 else self._logs[-tail:]
        return "\n".join(lines)

    def stop(self) -> bool:
        self._stop_requested = True
        if self._proc is not None and self._proc.poll() is None:
            try:
                self._proc.terminate()
                time.sleep(1.0)
                if self._proc.poll() is None:
                    self._proc.kill()
            except Exception:  # noqa: BLE001
                pass
        return True

    def ping(self) -> bool:
        return True


class JobManager:
    """Detached actor owning the job table (GCS-KV-persisted)."""

    def __init__(self):
        import ray_tpu_torch  # noqa: F401 - runs in an initialized worker
        from ray_tpu_torch._private import worker_context

        self._cw = worker_context.core_worker()
        self._supervisors: Dict[str, Any] = {}
        self._gcs_address = os.environ.get("RAYTPU_GCS_ADDRESS", "")

    # -- persistence -------------------------------------------------------

    def _save(self, info: JobInfo):
        self._cw.kv_put(_KV_PREFIX + info.job_id,
                        json.dumps(asdict(info)).encode())

    def _load(self, job_id: str) -> Optional[JobInfo]:
        raw = self._cw.kv_get(_KV_PREFIX + job_id)
        return JobInfo(**json.loads(raw)) if raw else None

    # -- API ---------------------------------------------------------------

    def submit(self, entrypoint: str, runtime_env: Optional[dict] = None,
               metadata: Optional[dict] = None,
               job_id: Optional[str] = None) -> str:
        import ray_tpu_torch
        from ray_tpu_torch import runtime_env as re_mod

        job_id = job_id or f"raytpu-job-{uuid.uuid4().hex[:10]}"
        if self._load(job_id) is not None:
            raise ValueError(f"job {job_id} already exists")
        packed = re_mod.pack(re_mod.validate(runtime_env), self._cw.kv_put)
        info = JobInfo(job_id=job_id, entrypoint=entrypoint,
                       runtime_env=packed, metadata=metadata or {},
                       start_time=time.time())
        self._save(info)
        sup = ray_tpu_torch.remote(num_cpus=0, lifetime="detached",
                             name=f"RAYTPU_JOB_SUP:{job_id}")(
            JobSupervisor).remote(job_id, entrypoint, packed,
                                  self._gcs_address)
        self._supervisors[job_id] = sup
        return job_id

    def _refresh(self, info: JobInfo) -> JobInfo:
        if info.status in JobStatus.TERMINAL:
            return info
        import ray_tpu_torch

        sup = self._supervisors.get(info.job_id)
        if sup is None:
            info.status = JobStatus.FAILED
            info.message = "supervisor lost (job manager restarted)"
        else:
            try:
                st = ray_tpu_torch.get(sup.status.remote(), timeout=30)
                info.status = st["status"]
                info.message = st["message"]
            except Exception as e:  # noqa: BLE001 - supervisor died
                info.status = JobStatus.FAILED
                info.message = f"supervisor died: {e}"
        if info.status in JobStatus.TERMINAL and not info.end_time:
            info.end_time = time.time()
        self._save(info)
        return info

    def status(self, job_id: str) -> dict:
        info = self._load(job_id)
        if info is None:
            raise ValueError(f"no such job {job_id}")
        return asdict(self._refresh(info))

    def logs(self, job_id: str, tail: int = -1) -> str:
        import ray_tpu_torch

        sup = self._supervisors.get(job_id)
        if sup is None:
            return ""
        try:
            return ray_tpu_torch.get(sup.logs.remote(tail), timeout=30)
        except Exception:  # noqa: BLE001
            return ""

    def stop(self, job_id: str) -> bool:
        import ray_tpu_torch

        sup = self._supervisors.get(job_id)
        if sup is None:
            return False
        ok = ray_tpu_torch.get(sup.stop.remote(), timeout=30)
        info = self._load(job_id)
        if info is not None:
            info.status = JobStatus.STOPPED
            info.message = "stopped by user"
            info.end_time = time.time()
            self._save(info)
        return ok

    def list(self) -> List[dict]:
        out = []
        for key in self._cw.kv_keys(_KV_PREFIX):
            raw = self._cw.kv_get(key)
            if raw:
                out.append(asdict(self._refresh(JobInfo(**json.loads(raw)))))
        return sorted(out, key=lambda j: j["start_time"])

    def ping(self) -> bool:
        return True


# ---------------------------------------------------------------------------
# Client API (reference: JobSubmissionClient SDK)
# ---------------------------------------------------------------------------

def _manager():
    import ray_tpu_torch

    ray_tpu_torch._auto_init()
    try:
        return ray_tpu_torch.get_actor(JOB_MANAGER_NAME)
    except ValueError:
        return ray_tpu_torch.remote(num_cpus=0, lifetime="detached",
                              name=JOB_MANAGER_NAME)(JobManager).remote()


def submit_job(entrypoint: str, *, runtime_env: Optional[dict] = None,
               metadata: Optional[dict] = None,
               job_id: Optional[str] = None) -> str:
    import ray_tpu_torch

    m = _manager()
    return ray_tpu_torch.get(m.submit.remote(entrypoint, runtime_env, metadata,
                                       job_id), timeout=120)


def get_job_info(job_id: str) -> JobInfo:
    import ray_tpu_torch

    return JobInfo(**ray_tpu_torch.get(_manager().status.remote(job_id),
                                 timeout=60))


def get_job_status(job_id: str) -> str:
    return get_job_info(job_id).status


def get_job_logs(job_id: str, tail: int = -1) -> str:
    import ray_tpu_torch

    return ray_tpu_torch.get(_manager().logs.remote(job_id, tail), timeout=60)


def list_jobs() -> List[JobInfo]:
    import ray_tpu_torch

    return [JobInfo(**j) for j in
            ray_tpu_torch.get(_manager().list.remote(), timeout=60)]


def stop_job(job_id: str) -> bool:
    import ray_tpu_torch

    return ray_tpu_torch.get(_manager().stop.remote(job_id), timeout=60)


def wait_job(job_id: str, timeout: float = 300.0,
             poll_s: float = 0.5) -> JobInfo:
    """Block until the job reaches a terminal state."""
    deadline = time.monotonic() + timeout
    while True:
        info = get_job_info(job_id)
        if info.status in JobStatus.TERMINAL:
            return info
        if time.monotonic() > deadline:
            raise TimeoutError(
                f"job {job_id} still {info.status} after {timeout}s")
        time.sleep(poll_s)
