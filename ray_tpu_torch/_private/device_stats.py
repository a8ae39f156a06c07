"""Device-side perf observatory: the program registry, the card's
peak rates and its allocator view.

The counterpart of ``ray_tpu/_private/device_stats.py``, for PyTorch
on CUDA:

* **program registry** — one process-wide :class:`ProgramRegistry` of
  named engine programs (``serve.prefill``, ``serve.decode``, ...).
  ``instrument(name, fn)`` wraps a function: the first call with a
  never-seen argument signature counts one **compile event**, as the
  JAX registry counts one XLA compile per fresh signature.  In eager
  PyTorch nothing is traced, but that first call is where a shape pays
  its one-time costs (cuBLAS heuristics, kernel builds, allocator
  growth).  A sliding window of compile timestamps trips a
  ``recompile_storm`` when churn crosses the threshold.  Later calls
  record host walltimes, without an added sync, as in JAX.
* **peak rates** — dense bf16 FLOP/s and HBM bytes/s of one card, keyed
  by ``torch.cuda.get_device_name()``; None for a card the table does
  not know.
* **allocator view** — ``device_memory_stats()`` with the JAX key set,
  read from ``torch.cuda.memory_stats`` and ``torch.cuda.mem_get_info``.
* **cost model** — the counterpart of XLA's ``cost_analysis()`` and
  ``memory_analysis()``: the first call with a fresh signature (the
  compile event) runs once under a counting dispatch mode
  (:func:`harvest_cost`), which books the program's ``xla_flops``,
  ``bytes_accessed``, ``arithmetic_intensity``, ``peak_hbm_bytes`` and
  ``argument_bytes``/``output_bytes``/``temp_bytes`` (the JAX key names;
  what each holds in the port is set out at ``harvest_cost``).  The
  kernel entry points report their own analytic work
  (:func:`kernel_work`), so a program counts the same whether its
  kernels or their plain versions ran.  ``snapshot`` turns the FLOPs
  into a live ``mfu`` over the mean invoke wall, as the JAX registry
  does.  ``RAYTPU_DEVICE_STATS_COST=0`` turns the harvest off.

``KNOWN_PROGRAMS`` and ``STATIC_PROGRAM_MAP`` tie graftcheck's program
catalog (``tools/graftcheck/programs.py``) to the runtime names.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import os
import threading
import time
import weakref
from typing import Any, Callable, Dict, List, Optional

from ray_tpu_torch._private import telemetry as _core

#: one NVIDIA H100 SXM (data sheet: dense tensor-core bf16, FP32 without
#: tensor cores, HBM3 bandwidth; at its 700 W limit) — the figures the
#: port's bounds and MFU are computed against
H100_SXM = {"bf16_flops": 989e12, "f32_flops": 67e12,
            "hbm_bytes_per_s": 3.35e12}

#: dense bf16 peak FLOP/s of one device, by a lower-case substring of
#: its name; "cpu" is the JAX table's placeholder
_PEAK_FLOPS_TABLE = {
    "h100 80gb hbm3": H100_SXM["bf16_flops"],
    "cpu": 1e12,
}

#: HBM bytes/s of one device, keyed as ``_PEAK_FLOPS_TABLE``
_PEAK_HBM_BW_TABLE = {
    "h100 80gb hbm3": H100_SXM["hbm_bytes_per_s"],
    "cpu": 100e9,
}

#: runtime program names the observatory hooks register under (the JAX
#: set); graftcheck's ``observatory-mapping`` rule checks
#: STATIC_PROGRAM_MAP's values against it
KNOWN_PROGRAMS = frozenset({
    "serve.prefill", "serve.paged_prefill", "serve.decode",
    "serve.spec_verify", "serve.spec_draft",
    "serve.kv_handoff_export", "serve.kv_handoff_install",
    "serve.sharded_prefill", "serve.sharded_paged_prefill",
    "serve.sharded_decode",
    "serve.sharded_spec_verify", "serve.sharded_spec_draft",
    "serve.sharded_kv_handoff_export",
    "serve.sharded_kv_handoff_install",
    "train.step",
    "bench.train_step",
})

#: graftcheck ProgramSpec name -> runtime registry program name (the JAX
#: map); every spec of tools/graftcheck/programs.py appears here
#: (``observatory-mapping``).  Chunked prefill runs the paged_prefill
#: program once a chunk; the handoff specs are the export gather on a
#: prefill engine and the install splice on a decode engine.
STATIC_PROGRAM_MAP: Dict[str, str] = {
    "gpt2_train_step": "train.step",
    "llama_train_step": "train.step",
    "fused_ce_fwd": "train.step",
    "fused_ce_bwd": "train.step",
    "gpt2_prefill_ragged": "serve.prefill",
    "llama_prefill_ragged": "serve.prefill",
    "gpt2_decode_step": "serve.decode",
    "gpt2_paged_decode_step": "serve.decode",
    "gpt2_sharded_decode_step": "serve.sharded_decode",
    "gpt2_spec_verify_step": "serve.spec_verify",
    "gpt2_chunked_prefill": "serve.paged_prefill",
    "gpt2_kv_handoff_export": "serve.kv_handoff_export",
    "gpt2_kv_handoff_install": "serve.kv_handoff_install",
}

_metrics_lock = threading.Lock()
_metrics: Optional[Dict[str, Any]] = None


def _device_metrics() -> Dict[str, Any]:
    """Process-wide metric singletons (one registration per name no
    matter how many registries tests construct)."""
    global _metrics
    with _metrics_lock:
        if _metrics is None:
            from ray_tpu_torch.util.metrics import Counter, Gauge

            tags = ("program",)
            _metrics = {
                "compile_events": Counter(
                    "device_program_compile_events_total",
                    "first calls per named program with a never-seen "
                    "argument signature", tag_keys=tags),
                "compile_seconds": Counter(
                    "device_program_compile_seconds_total",
                    "walltime of those first calls per named program",
                    tag_keys=tags),
                "storms": Counter(
                    "device_recompile_storms_total",
                    "recompile-storm watchdog trips (compile churn over "
                    "the sliding window)", tag_keys=tags),
                "xla_flops": Gauge(
                    "device_program_xla_flops",
                    "cost-model FLOPs per invocation (products and "
                    "convolutions, kernels by their own count)",
                    tag_keys=tags),
                "peak_hbm": Gauge(
                    "device_program_peak_hbm_bytes",
                    "cost-model peak device bytes per program",
                    tag_keys=tags),
                "mfu": Gauge(
                    "device_program_mfu",
                    "live roofline MFU from cost-model FLOPs over recent "
                    "invoke walltime", tag_keys=tags),
                "hbm_in_use": Gauge(
                    "device_hbm_bytes_in_use",
                    "allocator bytes_in_use per card (None-reporting "
                    "devices publish nothing)", tag_keys=("device",)),
            }
        return _metrics


def _device_name(device: Any = None) -> Optional[str]:
    """The name the peak tables are keyed by: the CUDA device's name,
    "cpu" for a CPU device (or no card), None when it cannot be read."""
    try:
        import torch

        if device is None:
            if not torch.cuda.is_available():
                return "cpu"
            device = torch.device("cuda", torch.cuda.current_device())
        device = torch.device(device)
        if device.type != "cuda":
            return device.type
        return torch.cuda.get_device_name(device)
    except Exception:  # noqa: BLE001 - no backend
        return None


def _lookup(table: Dict[str, float], device: Any) -> Optional[float]:
    name = _device_name(device)
    if name is None:
        return None
    name = name.lower()
    for key, val in table.items():
        if key in name:
            return val
    return None


def peak_flops_per_chip(device: Any = None) -> Optional[float]:
    """Dense bf16 peak FLOP/s of one device (default: the current CUDA
    card, or the CPU without one); None for a card the table does not
    know."""
    return _lookup(_PEAK_FLOPS_TABLE, device)


def peak_hbm_bytes_per_sec(device: Any = None) -> Optional[float]:
    """HBM bytes/s of one device, as :func:`peak_flops_per_chip`."""
    return _lookup(_PEAK_HBM_BW_TABLE, device)


def device_roofline(device: Any = None) -> Dict[str, Any]:
    """The roofline constants in one JSON-able block: the backend
    ("cuda" | "cpu"), the device's name, peak FLOP/s, HBM bytes/s and
    their ratio, the ridge point in FLOP/byte (None where a rate is
    unknown)."""
    name = _device_name(device)
    backend = None if name is None else (
        "cpu" if name == "cpu" else "cuda")
    flops = peak_flops_per_chip(device)
    bw = peak_hbm_bytes_per_sec(device)
    return {
        "backend": backend,
        "device_kind": name,
        "peak_flops_per_chip": flops,
        "peak_hbm_bytes_per_sec": bw,
        "ridge_flops_per_byte": (round(flops / bw, 1)
                                 if flops and bw else None),
    }


# ---------------------------------------------------------------------------
# The cost model
# ---------------------------------------------------------------------------

def cost_capture_enabled() -> bool:
    """The harvest runs one program call under a counting dispatch mode;
    ``RAYTPU_DEVICE_STATS_COST=0`` turns it off process-wide (the JAX
    switch, which there spares a second compile)."""
    return os.environ.get("RAYTPU_DEVICE_STATS_COST", "1") != "0"


#: the product ops: aten name -> (M, N, K, batch) of its operands
_PRODUCTS = {
    "mm": lambda a, b: (a[0], b[1], a[1], 1),
    "addmm": lambda c, a, b: (a[0], b[1], a[1], 1),
    "bmm": lambda a, b: (a[1], b[2], a[2], a[0]),
    "baddbmm": lambda c, a, b: (a[1], b[2], a[2], a[0]),
    "mv": lambda a, b: (a[0], 1, a[1], 1),
    "addmv": lambda c, a, b: (a[0], 1, a[1], 1),
    "dot": lambda a, b: (1, 1, a[0], 1),
    "vdot": lambda a, b: (1, 1, a[0], 1),
}


def _prod(shape) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n


def _conv_flops(x_shape, w_shape, out_shape, transposed: bool) -> int:
    """2 * (each output element's multiply-adds): a convolution's
    output element sums C_in/groups * prod(kernel) products (w's shape
    past its first dim); a transposed one scatters each input element
    over the same count."""
    return 2 * _prod(x_shape if transposed else out_shape) * _prod(
        w_shape[1:])


def _matmul_flops(a, b) -> int:
    """torch.matmul's products: 2*batch*M*N*K with 1-D operands
    promoted and the batch dims broadcast."""
    a, b = tuple(a), tuple(b)
    if len(a) == 1 and len(b) == 1:
        return 2 * a[0]
    if len(a) == 1:
        a = (1,) + a
    if len(b) == 1:
        b = b + (1,)
    lead_a, lead_b = a[:-2], b[:-2]
    n = max(len(lead_a), len(lead_b))
    lead_a = (1,) * (n - len(lead_a)) + lead_a
    lead_b = (1,) * (n - len(lead_b)) + lead_b
    batch = _prod(max(x, y) for x, y in zip(lead_a, lead_b))
    return 2 * batch * a[-2] * b[-1] * a[-1]


def _einsum_flops(equation: str, operands) -> int:
    """2 * the product of every index's size for a contraction of two
    operands (each output element sums over the contracted indices);
    0 for one operand (a transpose or a reduction)."""
    if len(operands) < 2:
        return 0
    lhs = equation.replace(" ", "").split("->")[0].split(",")
    sizes: Dict[str, int] = {}
    for subs, t in zip(lhs, operands):
        shape = tuple(t.shape)
        if "..." in subs:
            head, tail = subs.split("...")
            n_ell = len(shape) - len(head) - len(tail)
            subs = head + "".join(chr(0x100 + i) for i in range(n_ell)) \
                + tail
        for ch, d in zip(subs, shape):
            sizes[ch] = max(sizes.get(ch, 1), int(d))
    return 2 * _prod(sizes.values())


def op_flops(name: str, args, out) -> int:
    """FLOPs the cost model books for one aten op (its overload packet's
    name): 2*M*N*K for each product (mm, addmm, bmm, baddbmm, mv,
    addmv, dot), the convolutions forward and backward; 0 for
    everything else (XLA also counts elementwise work; the port does
    not).  Under ``torch.inference_mode`` the composite ops reach the
    mode whole (matmul, linear, einsum, conv*d): they are counted at
    that level, their decomposition then running unseen, so a program
    counts the same with and without autograd."""
    if name in _PRODUCTS:
        shapes = [tuple(a.shape) for a in args[:3]
                  if hasattr(a, "shape")]
        m, n, k, b = _PRODUCTS[name](*shapes)
        return 2 * b * m * n * k
    if name == "matmul":
        return _matmul_flops(args[0].shape, args[1].shape)
    if name == "linear":
        x, w = args[0].shape, args[1].shape
        return 2 * _prod(x[:-1]) * w[-1] * w[0]
    if name == "einsum":
        return _einsum_flops(args[0], args[1])
    if name in ("conv1d", "conv2d", "conv3d"):
        return _conv_flops(args[0].shape, args[1].shape, out.shape, False)
    if name in ("conv_transpose1d", "conv_transpose2d",
                "conv_transpose3d"):
        return _conv_flops(args[0].shape, args[1].shape, out.shape, True)
    if name == "convolution":
        return _conv_flops(args[0].shape, args[1].shape, out.shape,
                           bool(args[6]))
    if name == "convolution_backward":
        # (grad_out, input, weight, ..., transposed at 7, output_mask)
        mask = args[-1]
        per = _conv_flops(args[1].shape, args[2].shape, args[0].shape,
                          bool(args[7]))
        return per * (int(bool(mask[0])) + int(bool(mask[1])))
    return 0


def _tensors(tree) -> list:
    import torch
    from torch.utils._pytree import tree_flatten

    return [x for x in tree_flatten(tree)[0]
            if isinstance(x, torch.Tensor)]


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _storage(t):
    """t's untyped storage, or None (a tensor without one)."""
    try:
        st = t.untyped_storage()
        st.data_ptr()
        return st
    except Exception:  # noqa: BLE001 - wrapper subclasses, sparse
        return None


def _ptr(t) -> Optional[int]:
    st = _storage(t)
    return None if st is None else st.data_ptr()


class _CostCounter:
    """What one harvest counts; the counting dispatch mode
    (``_mode_class``) feeds it.  Thread-safe: autograd runs a CUDA backward on its device thread,
    where the mode is in force too (autograd carries the thread's
    dispatch modes over)."""

    def __init__(self):
        # reentrant: a storage freed while this thread holds the lock
        # (a collection inside a booking) runs _freed on this thread
        self.lock = threading.RLock()
        self.flops = 0
        self.bytes = 0
        self.ops = 0
        self.kernel_depth = 0
        self.failed: Optional[BaseException] = None
        # storage id -> bytes of every storage alive at the start (the
        # arguments) or made during the call
        self.args: Dict[int, int] = {}
        self.made: Dict[int, int] = {}
        # storages made inside a kernel entry: booked at its exit if
        # still alive (the kernel's outputs; the plain route's internals
        # never exist on the card)
        self.pending: Dict[int, int] = {}
        self.live = 0
        self.peak = 0
        # called as observer(func, args, kwargs, out, in_kernel) for
        # each op (the graftcheck auditor's recorder)
        self.observer: Optional[Callable] = None

    def add_arguments(self, tree) -> None:
        for t in _tensors(tree):
            st = _storage(t)
            if st is not None and id(st) not in self.args:
                self.args[id(st)] = st.nbytes()

    def _freed(self, key: int) -> None:
        with self.lock:
            self.pending.pop(key, None)
            self.live -= self.made.pop(key, 0)

    def _book(self, key: int, n: int) -> None:
        self.made[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)

    def track(self, out) -> None:
        """Book the storages first seen in ``out`` as allocations of
        the call, each until the garbage collector frees it."""
        for t in _tensors(out):
            st = _storage(t)
            if st is None:
                continue
            key = id(st)
            with self.lock:
                if key in self.args or key in self.made \
                        or key in self.pending:
                    continue
                n = st.nbytes()
                if self.kernel_depth:
                    self.pending[key] = n
                else:
                    self._book(key, n)
            weakref.finalize(st, self._freed, key)

    def count(self, func, args, kwargs, out) -> None:
        packet = func.overloadpacket.__name__
        flops = op_flops(packet, args, out)
        nbytes = 0
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        allocation = packet.startswith(("empty", "new_empty"))
        in_ptrs = {_ptr(i) for i in ins} - {None}
        aliased = (not func._schema.is_mutable and outs
                   and all(_ptr(o) in in_ptrs for o in outs))
        if not (func.is_view or allocation or aliased):
            nbytes = sum(_nbytes(t) for t in ins + outs)
        with self.lock:
            self.ops += 1
            if self.kernel_depth == 0:
                self.flops += flops
                self.bytes += nbytes

    @contextlib.contextmanager
    def kernel(self, flops: int, nbytes: int):
        """A kernel entry's own count in place of its ops'."""
        with self.lock:
            outer = self.kernel_depth == 0
            if outer:
                self.flops += int(flops)
                self.bytes += int(nbytes)
                self.ops += 1
            self.kernel_depth += 1
        try:
            yield
        finally:
            with self.lock:
                self.kernel_depth -= 1
                if outer:
                    for key, n in self.pending.items():
                        self._book(key, n)
                    self.pending.clear()

    def summary(self, out) -> Optional[Dict[str, Any]]:
        if self.failed is not None or not self.ops:
            return None
        seen: set = set()
        out_b = 0
        for t in _tensors(out):
            st = _storage(t)
            if st is not None and id(st) in self.made \
                    and id(st) not in seen:
                seen.add(id(st))
                out_b += self.made[id(st)]
        arg_b = sum(self.args.values())
        cost = {"xla_flops": float(self.flops),
                "bytes_accessed": float(self.bytes),
                "argument_bytes": int(arg_b),
                "output_bytes": int(out_b),
                "temp_bytes": int(max(0, self.peak - out_b)),
                "peak_hbm_bytes": int(arg_b + self.peak)}
        if cost["xla_flops"] and cost["bytes_accessed"]:
            cost["arithmetic_intensity"] = round(
                cost["xla_flops"] / cost["bytes_accessed"], 3)
        return cost


@functools.lru_cache(maxsize=None)
def _mode_class():
    """The counting dispatch mode (made at first use: importing this
    module imports no torch)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class CostMode(TorchDispatchMode):
        def __init__(self, counter: _CostCounter):
            super().__init__()
            self.counter = counter

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            c = self.counter
            if c.observer is not None:
                c.observer(func, args, kwargs, out, c.kernel_depth > 0)
            if c.failed is None:
                try:
                    c.count(func, args, kwargs, out)
                    c.track(out)
                except Exception as e:  # noqa: BLE001 - no cost, not no run
                    c.failed = e
            return out

    return CostMode


def active_cost_counter() -> Optional[_CostCounter]:
    """The counter of a harvest in force in this thread, else None.
    It is read from the thread's dispatch-mode stack, which autograd
    carries over to its device thread, where a harvested step's
    backward and its kernel entries run on the card (not from a
    thread-local of this module)."""
    from torch.utils._python_dispatch import \
        _get_current_dispatch_mode_stack

    cls = _mode_class()
    for mode in reversed(_get_current_dispatch_mode_stack()):
        if isinstance(mode, cls):
            return mode.counter
    return None


def kernel_work(flops: int, nbytes: int):
    """Context manager for a kernel entry point: inside a harvest it
    books the kernel's analytic (operations, bytes) — the figures its
    bound is computed from — and keeps the ops of its body (the launch,
    or the plain version on the CPU) out of the count, so both routes
    count the same work; outside one it does nothing."""
    counter = active_cost_counter()
    if counter is None:
        return contextlib.nullcontext()
    return counter.kernel(flops, nbytes)


def harvest_cost(fn: Callable, *args, **kwargs):
    """Run ``fn(*args, **kwargs)`` ONCE under the counting mode and
    return (its result, the cost dict or None).  The program runs
    exactly as it would without the harvest (programs update
    parameters, optimizer state and KV caches in place: it is never
    run twice).  The cost dict holds what the JAX keys hold in the port:

    * ``xla_flops`` — 2*M*N*K for every product the program dispatches
      (mm/addmm/bmm/baddbmm/mv/dot: what linear, matmul and einsum
      decompose to, or those composites whole under inference mode),
      the convolutions forward and backward, and each
      kernel entry's own analytic count (:func:`kernel_work`).
      Elementwise work counts 0 FLOPs (XLA counts it).  Every layer of
      a stack is counted (XLA counts a scanned stack's body once), and
      a backward run inside the program is counted too.
    * ``bytes_accessed`` — the bytes of every tensor input and output of
      every op that moves data (views, allocations and ops returning
      their input's storage count 0), kernels by their own count.
    * ``argument_bytes`` — the storages of the arguments;
      ``peak_hbm_bytes`` — those plus the peak of the bytes allocated
      during the call and still alive (storages tracked by weak
      reference; the allocator's own peak counters are not reset; a
      kernel entry's allocations count from its exit, and only those
      it returns, as the card's kernel allocates nothing else);
      ``output_bytes`` — the result's storages allocated during the
      call; ``temp_bytes`` — the peak less those.
    * ``arithmetic_intensity`` — FLOPs over bytes.

    The cost is None when the program dispatched no tensor op, or when
    counting failed; an exception of ``fn`` itself propagates."""
    return _harvest(fn, args, kwargs)


def _harvest(fn: Callable, args: tuple, kwargs: dict,
             observer: Optional[Callable] = None):
    """harvest_cost, with ``observer(func, args, kwargs, out,
    in_kernel)`` called for every op (graftcheck's program auditor)."""
    counter = _CostCounter()
    counter.observer = observer
    try:
        counter.add_arguments((args, kwargs))
    except Exception as e:  # noqa: BLE001
        counter.failed = e
    with _mode_class()(counter):
        out = fn(*args, **kwargs)
    try:
        cost = counter.summary(out)
    except Exception:  # noqa: BLE001 - observability never breaks a run
        cost = None
    return out, cost


def _leaves(obj, out: list) -> list:
    """The leaves of a nested tuple/list/dict (dict keys sorted, None
    dropped), the order ``jax.tree_util.tree_leaves`` gives."""
    if obj is None:
        return out
    if isinstance(obj, (tuple, list)):
        for x in obj:
            _leaves(x, out)
    elif isinstance(obj, dict):
        for k in sorted(obj):
            _leaves(obj[k], out)
    else:
        out.append(obj)
    return out


def _signature(args: tuple, kwargs: dict) -> tuple:
    """Hashable key of one call, seen as the JAX registry sees a jit
    call: a tensor or numpy array (numpy scalars included) by (shape,
    dtype), a random generator (the JAX engine's PRNG key, a fixed
    shape) by its type, any other leaf (a Python int, ...) by its
    value."""
    import torch

    sig = []
    for leaf in _leaves((args, kwargs), []):
        if isinstance(leaf, torch.Tensor):
            sig.append((tuple(leaf.shape),
                        str(leaf.dtype).replace("torch.", "")))
        elif hasattr(leaf, "shape") and hasattr(leaf, "dtype"):
            sig.append((tuple(leaf.shape), str(leaf.dtype)))
        elif isinstance(leaf, torch.Generator):
            sig.append(("Generator",))
        else:
            sig.append((type(leaf).__name__, repr(leaf)[:32]))
    return tuple(sig)


class ProgramRegistry:
    """Per-process registry of named engine programs.

    ``instrument(name, fn)`` wraps a callable: the wrapper always
    executes the original, and on the side detects compile events by
    argument signature, feeds the recompile watchdog, and records
    invoke walltimes.  All clocks are injectable for deterministic
    tests."""

    def __init__(self, storm_window_s: float = 60.0,
                 storm_threshold: int = 5, invoke_history: int = 512,
                 now: Optional[Callable[[], float]] = None):
        self.storm_window_s = float(storm_window_s)
        self.storm_threshold = int(storm_threshold)
        self._now = now or time.perf_counter
        self._invoke_history = int(invoke_history)
        self._lock = threading.Lock()
        self._m = _device_metrics()
        self._programs: Dict[str, Dict[str, Any]] = {}
        #: program -> the n_devices it was instrumented with
        self._devices: Dict[str, int] = {}
        self._subscribers: List[Any] = []
        self._storm_subscribers: List[Any] = []

    # -- bookkeeping -------------------------------------------------------

    def _rec(self, program: str) -> Dict[str, Any]:
        rec = self._programs.get(program)
        if rec is None:
            rec = self._programs[program] = {
                "compile_events": 0,
                "compile_seconds": 0.0,
                "compile_times": collections.deque(maxlen=256),
                "invokes": 0,
                "invoke_s": collections.deque(
                    maxlen=self._invoke_history),
                # (end_ts, dur_s) on the process monotonic clock —
                # the tracebus reads these to place device work on
                # the same timeline as request spans
                "invoke_events": collections.deque(
                    maxlen=self._invoke_history),
                "cost": {},
                "storms": 0,
                "storm_active": False,
            }
        return rec

    def record_compile(self, program: str, seconds: float,
                       cost: Optional[Dict[str, Any]] = None,
                       now: Optional[float] = None) -> None:
        """One compile event of `program` taking `seconds` walltime;
        `cost` is a :func:`harvest_cost` dict when the harvest ran."""
        ts = self._now() if now is None else now
        with self._lock:
            rec = self._rec(program)
            rec["compile_events"] += 1
            rec["compile_seconds"] += float(seconds)
            rec["compile_times"].append(ts)
            if cost:
                rec["cost"] = dict(cost)
            recent = [t for t in rec["compile_times"]
                      if ts - t <= self.storm_window_s]
            storm = len(recent) >= self.storm_threshold
            fresh_storm = storm and not rec["storm_active"]
            rec["storm_active"] = storm
            if fresh_storm:
                rec["storms"] += 1
        self._m["compile_events"].inc(tags={"program": program})
        self._m["compile_seconds"].inc(max(0.0, float(seconds)),
                                       tags={"program": program})
        if cost:
            if cost.get("xla_flops") is not None:
                self._m["xla_flops"].set(cost["xla_flops"],
                                         tags={"program": program})
            if cost.get("peak_hbm_bytes") is not None:
                self._m["peak_hbm"].set(cost["peak_hbm_bytes"],
                                        tags={"program": program})
        if fresh_storm:
            self._m["storms"].inc(tags={"program": program})
            self._notify_storms(program)
        self._notify(program)

    def record_invoke(self, program: str, seconds: float,
                      now: Optional[float] = None) -> None:
        """One steady-state invoke of `program` taking `seconds`;
        `now` is the invoke's END instant (monotonic), defaulting to
        the registry clock at record time."""
        ts = self._now() if now is None else now
        with self._lock:
            rec = self._rec(program)
            rec["invokes"] += 1
            rec["invoke_s"].append(float(seconds))
            rec["invoke_events"].append((ts, float(seconds)))

    def invoke_events(self, prefix: Optional[str] = None
                      ) -> Dict[str, List[tuple]]:
        """Timestamped invoke windows per program — ``{name:
        [(end_ts, dur_s), ...]}`` on the monotonic clock, optionally
        filtered to names starting with `prefix`.  The tracebus's
        device lane (``tools/tracebus.py``).  A window is the host's
        wall around the program's call: on the card the call returns
        once its work is queued, so it covers the launches, not the
        device time."""
        with self._lock:
            return {name: list(rec["invoke_events"])
                    for name, rec in self._programs.items()
                    if prefix is None or name.startswith(prefix)}

    def compile_windows(self, prefix: Optional[str] = None
                        ) -> Dict[str, List[tuple]]:
        """Per-program compile windows ``{name: [(end_ts, dur_s),
        ...]}`` — compile_times keeps end instants; durations beyond
        the retained ring are approximated by the mean compile cost
        (exact when a program compiled once, the common case)."""
        with self._lock:
            out: Dict[str, List[tuple]] = {}
            for name, rec in self._programs.items():
                if prefix is not None and not name.startswith(prefix):
                    continue
                n = rec["compile_events"]
                mean = (rec["compile_seconds"] / n) if n else 0.0
                out[name] = [(ts, mean) for ts in rec["compile_times"]]
            return out

    # -- subscribers (e.g. EngineTelemetry.record_program_compile) ---------

    def subscribe(self, callback: Callable[[str], None]) -> None:
        """Call `callback(program)` on every compile event.  Bound
        methods are held by WeakMethod so short-lived engines do not
        leak through the process singleton."""
        self._add(self._subscribers, callback)

    def subscribe_storms(self, callback: Callable[[str], None]) -> None:
        """Call `callback(program)` on every FRESH recompile-storm trip
        (inactive → active).  Weakly held like `subscribe`."""
        self._add(self._storm_subscribers, callback)

    def _add(self, subscribers: List[Any], callback) -> None:
        try:
            ref = weakref.WeakMethod(callback)
        except TypeError:
            ref = (lambda cb=callback: cb)  # plain callables held hard
        with self._lock:
            subscribers.append(ref)

    def _notify(self, program: str) -> None:
        self._fanout("_subscribers", program)

    def _notify_storms(self, program: str) -> None:
        self._fanout("_storm_subscribers", program)

    def _fanout(self, attr: str, program: str) -> None:
        with self._lock:
            refs = list(getattr(self, attr))
        dead = []
        for ref in refs:
            cb = ref()
            if cb is None:
                dead.append(ref)
                continue
            try:
                cb(program)
            except Exception:  # noqa: BLE001 - observer must not break
                pass
        if dead:
            with self._lock:
                setattr(self, attr, [r for r in getattr(self, attr)
                                     if r not in dead])

    # -- instrumentation ---------------------------------------------------

    def instrument(self, program: str, fn: Callable,
                   n_devices: int = 1) -> Callable:
        """Wrap `fn` with compile detection, the cost harvest and invoke
        timing under `program`.  The wrapper executes `fn` itself.  The
        first fresh signature's call runs under :func:`harvest_cost`
        (once a wrapper, as JAX harvests its first signature's side
        compile; off with ``RAYTPU_DEVICE_STATS_COST=0``): that call is
        the compile event, so its walltime, the harvest's bookkeeping
        included, lands in ``compile_seconds``.  ``n_devices`` is the
        number of cards a sharded program runs on (a mesh's size),
        recorded per program (``devices_of``); the live MFU gauge
        divides by it."""
        with self._lock:
            self._devices[program] = int(n_devices)
        registry = self
        seen: set = set()
        seen_lock = threading.Lock()
        harvested = [False]

        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            try:
                sig = _signature(args, kwargs)
            except Exception:  # noqa: BLE001
                sig = None
            fresh = do_harvest = False
            if sig is not None:
                with seen_lock:
                    fresh = sig not in seen
                    if fresh:
                        seen.add(sig)
                    # claim the one-shot harvest under the same lock
                    if fresh and not harvested[0] \
                            and cost_capture_enabled():
                        harvested[0] = do_harvest = True
            t0 = time.perf_counter()
            if fresh:
                cost = None
                if do_harvest:
                    out, cost = harvest_cost(fn, *args, **kwargs)
                else:
                    out = fn(*args, **kwargs)
                # the first call with a fresh signature is the compile
                # event: its walltime stays out of the invoke window
                registry.record_compile(
                    program, time.perf_counter() - t0, cost=cost)
                return out
            out = fn(*args, **kwargs)
            registry.record_invoke(program, time.perf_counter() - t0)
            registry._maybe_update_mfu(program, n_devices)
            return out

        wrapped.__wrapped__ = fn
        return wrapped

    def _maybe_update_mfu(self, program: str, n_devices: int) -> None:
        """Refresh the per-program MFU gauge every 64 invokes."""
        with self._lock:
            rec = self._programs.get(program)
            if rec is None or rec["invokes"] % 64:
                return
        snap = self.snapshot(n_devices=n_devices).get(program)
        if snap and snap.get("mfu") is not None:
            self._m["mfu"].set(snap["mfu"], tags={"program": program})

    # -- sinks -------------------------------------------------------------

    def devices_of(self, program: str) -> int:
        """The ``n_devices`` `program` was instrumented with (1 for a
        program never instrumented)."""
        with self._lock:
            return self._devices.get(program, 1)

    def snapshot(self, prefix: Optional[str] = None, n_devices: int = 1,
                 peak_flops: Optional[float] = None
                 ) -> Dict[str, Dict[str, Any]]:
        """Per-program observability block with the JAX key set:
        ``{compile_events, compile_seconds, invokes, invoke_ms,
        xla_flops, bytes_accessed, arithmetic_intensity,
        peak_hbm_bytes, recompile_storm, recompile_storms_total,
        mfu}``.  The cost keys are the harvest's (:func:`harvest_cost`;
        None until one landed).  ``mfu`` is the live roofline as JAX
        computes it: FLOPs per invocation over the mean recent invoke
        walltime, against ``n_devices`` cards of ``peak_flops`` each
        (default: this process's device, :func:`peak_flops_per_chip`);
        None until both a harvest and an invoke landed, or with no
        known peak.  The invoke wall is the host's, without a sync: on
        the card a call that returns before its work is done reads
        fast."""
        if peak_flops is None:
            peak_flops = peak_flops_per_chip()
        with self._lock:
            items = [(name, dict(rec), list(rec["invoke_s"]))
                     for name, rec in self._programs.items()]
        out: Dict[str, Dict[str, Any]] = {}
        for name, rec, invoke_s in items:
            if prefix and not name.startswith(prefix):
                continue
            cost = rec["cost"]
            block: Dict[str, Any] = {
                "compile_events": rec["compile_events"],
                "compile_seconds": round(rec["compile_seconds"], 3),
                "invokes": rec["invokes"],
                "invoke_ms": _core.summarize(
                    [s * 1e3 for s in invoke_s]),
                "xla_flops": cost.get("xla_flops"),
                "bytes_accessed": cost.get("bytes_accessed"),
                "arithmetic_intensity": cost.get(
                    "arithmetic_intensity"),
                "peak_hbm_bytes": cost.get("peak_hbm_bytes"),
                "recompile_storm": rec["storm_active"],
                "recompile_storms_total": rec["storms"],
                "mfu": None,
            }
            flops = cost.get("xla_flops")
            if flops and invoke_s and peak_flops:
                mean_s = sum(invoke_s) / len(invoke_s)
                if mean_s > 0:
                    block["mfu"] = round(
                        flops / mean_s /
                        (max(1, n_devices) * peak_flops), 6)
            out[name] = block
        return out

    def programs(self) -> List[str]:
        with self._lock:
            return sorted(self._programs)

    def reset(self) -> None:
        with self._lock:
            self._programs.clear()
            self._devices.clear()
            self._subscribers.clear()


_registry_lock = threading.Lock()
_registry: Optional[ProgramRegistry] = None


def get_registry() -> ProgramRegistry:
    """The process singleton every hook reports through."""
    global _registry
    with _registry_lock:
        if _registry is None:
            _registry = ProgramRegistry()
        return _registry


def reset_registry() -> None:
    """Testing hook: drop all recorded programs and subscribers."""
    with _registry_lock:
        if _registry is not None:
            _registry.reset()


_DEVICE_STAT_KEYS = ("bytes_in_use", "peak_bytes_in_use", "bytes_limit",
                     "largest_alloc_size")


def device_memory_stats(devices: Optional[List[Any]] = None, *,
                        largest_alloc: bool = True
                        ) -> List[Dict[str, Any]]:
    """Per-device allocator snapshot with a STABLE key set: every entry
    carries id/platform/device_kind plus ``bytes_in_use``,
    ``peak_bytes_in_use``, ``bytes_limit`` and ``largest_alloc_size``
    (``None`` where the device reports nothing: a CPU device gives the
    None row JAX's CPU gives).  ``devices``: torch devices or names
    (default: every CUDA card, none without one).

    On a card, "in use" is the caching allocator's ALLOCATED bytes
    (``allocated_bytes.all.current``/``.peak``: what live tensors
    hold), not its reserved bytes (``reserved_bytes.all.current``: the
    segments reserved through cudaMalloc, a second, larger figure that
    includes freed blocks kept for reuse).  ``bytes_limit`` is the
    card's total memory (``torch.cuda.mem_get_info``), and
    ``largest_alloc_size`` the allocator's largest segment (None before
    the first allocation).  Finding that segment walks every block of
    ``torch.cuda.memory_snapshot()``; ``largest_alloc=False`` skips the
    walk and leaves the key None (the admission gate's cheap read)."""
    import torch

    if devices is None:
        if not torch.cuda.is_available():
            return []
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    metrics = _device_metrics()
    out: List[Dict[str, Any]] = []
    for dev in devices:
        dev = torch.device(dev)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        entry: Dict[str, Any] = {
            "id": dev.index if dev.type == "cuda" else 0,
            "platform": "gpu" if dev.type == "cuda" else dev.type,
            "device_kind": _device_name(dev),
        }
        for key in _DEVICE_STAT_KEYS:
            entry[key] = None
        if dev.type == "cuda":
            try:
                stats = torch.cuda.memory_stats(dev)
                entry["bytes_in_use"] = int(
                    stats.get("allocated_bytes.all.current", 0))
                entry["peak_bytes_in_use"] = int(
                    stats.get("allocated_bytes.all.peak", 0))
                entry["bytes_limit"] = int(torch.cuda.mem_get_info(dev)[1])
                if largest_alloc and stats.get("segment.all.current"):
                    entry["largest_alloc_size"] = max(
                        (int(s["total_size"])
                         for s in torch.cuda.memory_snapshot()
                         if s.get("device") == dev.index), default=None)
            except Exception:  # noqa: BLE001 - allocator view best-effort
                pass
        if entry["bytes_in_use"] is not None:
            metrics["hbm_in_use"].set(
                entry["bytes_in_use"], tags={"device": str(entry["id"])})
        out.append(entry)
    return out
