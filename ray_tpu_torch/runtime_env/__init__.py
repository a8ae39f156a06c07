"""Runtime environments: per-job / per-actor / per-task execution context
(working_dir, env_vars, py_modules, pip).

A copy of ``ray_tpu/runtime_env/__init__.py``.  Role-equivalent of the
reference's runtime-env system (reference
``python/ray/_private/runtime_env/plugin.py:24 RuntimeEnvPlugin``,
``:116 RuntimeEnvPluginManager``; packaging
``_private/runtime_env/packaging.py``).  Collapsed design:

* the client **packs** local directories into content-addressed zip
  archives stored in GCS KV (``gcs://runtimeenv/<sha1>`` URIs — the role
  of the reference's GCS-backed package URIs);
* the **node manager** materializes URIs into a per-node cache directory
  and starts the worker with the right cwd / PYTHONPATH / env vars (the
  role of the reference's per-node dashboard agent installing envs for
  the raylet, ``dashboard/modules/runtime_env/``);
* plugins are entries in ``PLUGINS`` keyed by the runtime-env field they
  own — third parties can register their own.
"""

from __future__ import annotations

import hashlib
import io
import os
import zipfile
from typing import Any, Callable, Dict, List, Optional

_URI_PREFIX = "gcs://runtimeenv/"
_KV_PREFIX = "runtimeenv:"
MAX_PACKAGE_BYTES = 100 * 1024 * 1024  # reference caps GCS packages at 100MB

KNOWN_FIELDS = ("working_dir", "env_vars", "py_modules", "pip",
                "conda", "container")


def validate(runtime_env: Optional[Dict[str, Any]]) -> Dict[str, Any]:
    """Normalize + validate a runtime env dict (client side)."""
    if not runtime_env:
        return {}
    out = dict(runtime_env)
    for k in out:
        if k not in KNOWN_FIELDS:
            raise ValueError(
                f"unknown runtime_env field {k!r}; known: {KNOWN_FIELDS}")
    ev = out.get("env_vars")
    if ev is not None and not all(
            isinstance(k, str) and isinstance(v, str) for k, v in ev.items()):
        raise ValueError("env_vars must be Dict[str, str]")
    return out


# ---------------------------------------------------------------------------
# Packing (client side)
# ---------------------------------------------------------------------------

def _zip_dir(path: str) -> bytes:
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as z:
        for root, dirs, files in os.walk(path):
            dirs[:] = [d for d in dirs if d not in
                       ("__pycache__", ".git", ".venv", "node_modules")]
            for f in files:
                if f.endswith(".pyc"):
                    continue
                full = os.path.join(root, f)
                z.write(full, os.path.relpath(full, path))
    data = buf.getvalue()
    if len(data) > MAX_PACKAGE_BYTES:
        raise ValueError(
            f"packed dir {path} is {len(data)} bytes "
            f"(cap {MAX_PACKAGE_BYTES}); trim it or use py_modules")
    return data


def upload_dir(kv_put: Callable[[str, bytes], Any], path: str) -> str:
    """Zip ``path`` into GCS KV; returns its content-addressed URI."""
    if not os.path.isdir(path):
        raise ValueError(f"not a directory: {path}")
    data = _zip_dir(path)
    digest = hashlib.sha1(data).hexdigest()
    kv_put(_KV_PREFIX + digest, data)
    return _URI_PREFIX + digest


def pack(runtime_env: Dict[str, Any],
         kv_put: Callable[[str, bytes], Any]) -> Dict[str, Any]:
    """Resolve local paths in a validated runtime env to uploaded URIs —
    after this the dict is location-independent and can ride task/actor
    specs."""
    out = dict(runtime_env)
    wd = out.get("working_dir")
    if wd and not wd.startswith(_URI_PREFIX):
        out["working_dir"] = upload_dir(kv_put, wd)
    mods = out.get("py_modules")
    if mods:
        out["py_modules"] = [
            m if m.startswith(_URI_PREFIX) else upload_dir(kv_put, m)
            for m in mods]
    return out


def env_hash(runtime_env: Dict[str, Any]) -> str:
    """Stable identity of a packed env (worker-pool cache key; reference:
    runtime-env hash in the worker pool, worker_pool.h:156)."""
    import json

    return hashlib.sha1(
        json.dumps(runtime_env, sort_keys=True).encode()).hexdigest()


# ---------------------------------------------------------------------------
# Materialization (node side)
# ---------------------------------------------------------------------------

class RuntimeEnvContext:
    """What a materialized env does to a worker process."""

    def __init__(self):
        self.env_vars: Dict[str, str] = {}
        self.cwd: Optional[str] = None
        self.py_paths: List[str] = []
        #: argv prefix wrapping the launched command (container plugin:
        #: ["docker", "run", ..., image]); empty = run directly.
        self.command_prefix: List[str] = []

    def apply(self, env: Dict[str, str]) -> Optional[str]:
        """Mutate a subprocess env dict; returns the cwd override."""
        env.update(self.env_vars)
        if self.py_paths:
            env["PYTHONPATH"] = os.pathsep.join(
                self.py_paths + [env.get("PYTHONPATH", "")]).rstrip(
                    os.pathsep)
        return self.cwd


def _fetch_uri(kv_get: Callable[[str], Optional[bytes]], uri: str,
               cache_dir: str) -> str:
    """Materialize a gcs:// zip URI into cache_dir; returns the dir."""
    digest = uri[len(_URI_PREFIX):]
    dest = os.path.join(cache_dir, digest)
    if os.path.isdir(dest):
        return dest  # content-addressed: immutable once extracted
    data = kv_get(_KV_PREFIX + digest)
    if data is None:
        raise RuntimeError(f"runtime env package {uri} not found in GCS")
    tmp = dest + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    with zipfile.ZipFile(io.BytesIO(data)) as z:
        z.extractall(tmp)
    try:
        os.rename(tmp, dest)
    except OSError:  # raced another materialization
        import shutil

        shutil.rmtree(tmp, ignore_errors=True)
    return dest


# Plugin registry: field name -> setup(value, ctx, kv_get, cache_dir).
# (Reference: RuntimeEnvPlugin.create/modify_context, plugin.py:24.)

def _setup_env_vars(value, ctx, kv_get, cache_dir):
    ctx.env_vars.update(value)


def _setup_working_dir(value, ctx, kv_get, cache_dir):
    path = _fetch_uri(kv_get, value, cache_dir)
    ctx.cwd = path
    ctx.py_paths.insert(0, path)


def _setup_py_modules(value, ctx, kv_get, cache_dir):
    for uri in value:
        ctx.py_paths.append(_fetch_uri(kv_get, uri, cache_dir))


def _setup_pip(value, ctx, kv_get, cache_dir):
    """pip installs need an index; this build targets hermetic clusters,
    so we create a venv only when the packages are already importable is
    NOT checkable cheaply — instead fail fast with a clear error unless
    the operator pointed RAYTPU_PIP_INDEX at a reachable index/wheelhouse."""
    import subprocess
    import sys

    args = list(value) if isinstance(value, (list, tuple)) else [value]
    key = hashlib.sha1(repr(sorted(args)).encode()).hexdigest()
    venv = os.path.join(cache_dir, f"pip-{key}")
    site = os.path.join(venv, "lib", f"python{sys.version_info.major}."
                        f"{sys.version_info.minor}", "site-packages")
    if not os.path.isdir(venv):
        import venv as venv_mod

        venv_mod.EnvBuilder(with_pip=True,
                            system_site_packages=True).create(venv)
        cmd = [os.path.join(venv, "bin", "python"), "-m", "pip", "install",
               "--quiet"]
        index = os.environ.get("RAYTPU_PIP_INDEX", "")
        if index:
            cmd += ["--index-url", index]
        r = subprocess.run(cmd + args, capture_output=True, text=True,
                           timeout=600)
        if r.returncode != 0:
            import shutil

            shutil.rmtree(venv, ignore_errors=True)
            raise RuntimeError(
                f"runtime_env pip install failed: {r.stderr[-500:]}")
    ctx.py_paths.append(site)


def _conda_base() -> str:
    import shutil
    import subprocess

    exe = shutil.which("conda") or shutil.which("micromamba") or \
        shutil.which("mamba")
    if not exe:
        raise RuntimeError(
            "runtime_env 'conda' needs a conda/mamba binary on PATH "
            "(none found on this host)")
    r = subprocess.run([exe, "info", "--base"], capture_output=True,
                       text=True, timeout=60)
    if r.returncode != 0:
        raise RuntimeError(f"conda info --base failed: {r.stderr[-300:]}")
    return r.stdout.strip().splitlines()[-1]


def _setup_conda(value, ctx, kv_get, cache_dir):
    """Activate a conda env for the launched process (reference:
    _private/runtime_env/conda.py — named env activation or creation
    from an environment-yaml dict, cached by content hash).  Activation
    is the environment-variable effect of ``conda activate``: env bin/
    on PATH + CONDA_PREFIX/CONDA_DEFAULT_ENV set — no shell involved."""
    import shutil
    import subprocess

    base = _conda_base()
    if isinstance(value, str):
        prefix = value if os.sep in value else os.path.join(
            base, "envs", value)
        if not os.path.isdir(prefix):
            raise RuntimeError(f"conda env {value!r} not found at "
                               f"{prefix}")
        name = value
    elif isinstance(value, dict):
        key = hashlib.sha1(repr(sorted(value.items())).encode()
                           ).hexdigest()[:12]
        name = f"raytpu-{key}"
        prefix = os.path.join(base, "envs", name)
        if not os.path.isdir(prefix):
            spec = os.path.join(cache_dir, f"conda-{key}.yml")
            import json as _json

            with open(spec, "w") as f:
                # conda yaml is a JSON subset for the fields we emit
                _json.dump(dict(value, name=name), f)
            exe = shutil.which("conda") or shutil.which("mamba") or \
                shutil.which("micromamba")
            # create into a temp prefix, rename on success: a killed or
            # failed create must never leave a half-built env that later
            # materializations would silently activate
            tmp_prefix = prefix + ".tmp"
            shutil.rmtree(tmp_prefix, ignore_errors=True)
            try:
                r = subprocess.run(
                    [exe, "env", "create", "-f", spec, "-p", tmp_prefix],
                    capture_output=True, text=True, timeout=1800)
            except subprocess.TimeoutExpired:
                shutil.rmtree(tmp_prefix, ignore_errors=True)
                raise RuntimeError("conda env create timed out")
            if r.returncode != 0:
                shutil.rmtree(tmp_prefix, ignore_errors=True)
                raise RuntimeError(
                    f"conda env create failed: {r.stderr[-500:]}")
            os.rename(tmp_prefix, prefix)
    else:
        raise RuntimeError("runtime_env 'conda' must be an env name or "
                           "an environment dict")
    ctx.env_vars["CONDA_PREFIX"] = prefix
    ctx.env_vars["CONDA_DEFAULT_ENV"] = name
    ctx.env_vars["PATH"] = (os.path.join(prefix, "bin") + os.pathsep
                            + os.environ.get("PATH", ""))


def _setup_container(value, ctx, kv_get, cache_dir):
    """Run the launched process inside a container image (reference:
    _private/runtime_env/container.py — worker_process_setup via
    podman).  Scope: JOB entrypoints (the job supervisor applies
    ``command_prefix``); this runtime's forked task workers stay on the
    host, documented divergence from the reference's containerized
    workers."""
    import shutil

    if not isinstance(value, dict) or "image" not in value:
        raise RuntimeError("runtime_env 'container' needs "
                           "{'image': ..., 'run_options': [...]}")
    engine = shutil.which("podman") or shutil.which("docker")
    if not engine:
        raise RuntimeError("runtime_env 'container' needs podman or "
                           "docker on PATH (none found)")
    ctx.command_prefix = [engine, "run", "--rm", "--network=host",
                          *value.get("run_options", []),
                          value["image"]]


PLUGINS: Dict[str, Callable] = {
    "env_vars": _setup_env_vars,
    "working_dir": _setup_working_dir,
    "py_modules": _setup_py_modules,
    "pip": _setup_pip,
    "conda": _setup_conda,
    "container": _setup_container,
}


def register_plugin(field: str, setup: Callable) -> None:
    PLUGINS[field] = setup


def materialize(runtime_env: Dict[str, Any],
                kv_get: Callable[[str], Optional[bytes]],
                cache_dir: str) -> RuntimeEnvContext:
    """Run every plugin for a packed env; returns the worker context.
    (Reference: RuntimeEnvPluginManager driving plugin setup,
    plugin.py:116.)"""
    ctx = RuntimeEnvContext()
    os.makedirs(cache_dir, exist_ok=True)
    for field, value in runtime_env.items():
        plugin = PLUGINS.get(field)
        if plugin is None:
            raise RuntimeError(f"no runtime_env plugin for field {field!r}")
        plugin(value, ctx, kv_get, cache_dir)
    return ctx
