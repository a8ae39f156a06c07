"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface, at first use, and loaded
with ctypes.  The library lands in ``ray_tpu_torch/_build/`` under a
name keyed by a hash of the sources and flags, so a changed source is
rebuilt and an unchanged one is loaded as it is.  ``build_all`` starts
one nvcc per source, all at once, and waits for them.

Nothing here runs at import time: the CPU tests import every module,
and the CPU has no nvcc.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
#: C signature of each kernel's launcher: every launcher returns the
#: cudaError_t of its launch as an int
SIGNATURES: Dict[str, Dict[str, tuple]] = {
    "flash_fwd": {
        # q, k, v, o, lse, BH, T, D, scale, causal, is_bf16, stream
        "flash_fwd": (_P, _P, _P, _P, _P, _I, _I, _I, ctypes.c_float,
                      _I, _I, _P),
    },
    "flash_bwd": {
        # q, k, v, o, dO, lse, delta (written), dq, BH, T, D, scale,
        # causal, is_bf16, stream
        "flash_bwd_dq": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                         ctypes.c_float, _I, _I, _P),
        # q, k, v, dO, lse, delta, dk, dv, BH, T, D, scale, causal,
        # is_bf16, stream
        "flash_bwd_dkv": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                          ctypes.c_float, _I, _I, _P),
    },
    "fused_ce": {
        # h, w, tgt, nll, lse, N, V, D, valid_vocab, is_bf16, stream
        "fused_ce_fwd": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
        # h, w, tgt, lse, g, dh (f32), N, V, D, valid_vocab, is_bf16,
        # stream
        "fused_ce_bwd_dh": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                            _P),
        # h, w, tgt, lse, g, dw (f32), N, V, D, valid_vocab, is_bf16,
        # stream
        "fused_ce_bwd_dw": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                            _P),
    },
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    raise RuntimeError("nvcc not found: the CUDA kernels are built with "
                       "nvcc on the machine that has the card")


def _library_path(name: str) -> Path:
    h = hashlib.sha256()
    for src in sorted(_CSRC.glob("*.cuh")) + [_CSRC / f"{name}.cu"]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build_all() -> Dict[str, Path]:
    """Compile every ``csrc/*.cu`` that has no current library, one
    nvcc process per source, all started together.  Returns
    {name: library path}; raises with nvcc's output if any build
    fails.  nvcc's ``-Xptxas -v`` report is kept beside each library
    as ``<library>.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    names = sorted(p.stem for p in _CSRC.glob("*.cu"))
    paths = {n: _library_path(n) for n in names}
    procs = {}
    for name, out in paths.items():
        if out.exists():
            continue
        # compile to a private name, then rename into place, so two
        # processes building at once never load a half-written file
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        out.with_suffix(".so.log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return paths


@functools.lru_cache(maxsize=None)
def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed,
    with argtypes and restype set from SIGNATURES."""
    path = _library_path(name)
    if not path.exists():
        build_all()
    lib = ctypes.CDLL(str(path))
    for fn_name, argtypes in SIGNATURES[name].items():
        fn = getattr(lib, fn_name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    lib.kernel_error_string.argtypes = [ctypes.c_int]
    lib.kernel_error_string.restype = ctypes.c_char_p
    return lib


def launch(lib_name: str, fn_name: str, tensors, scalars, device) -> None:
    """Call launcher ``fn_name`` of ``csrc/<lib_name>.cu`` with the data
    pointers of ``tensors``, then ``scalars``, then the current stream
    of ``device``, and raise if it returned a CUDA error (a refused
    launch never runs, and a later synchronize would not report it).
    The caller checks what the kernel takes and counts the launch."""
    import torch

    lib = library(lib_name)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
    err = getattr(lib, fn_name)(*(t.data_ptr() for t in tensors),
                                *scalars, stream)
    if err != 0:
        msg = lib.kernel_error_string(err).decode()
        raise RuntimeError(f"{fn_name} launch failed: CUDA error {err} "
                           f"({msg})")
