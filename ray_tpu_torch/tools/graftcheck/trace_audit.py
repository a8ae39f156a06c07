"""The program auditor: static rules over traced hot-path programs.

The counterpart of ``ray_tpu/tools/graftcheck/jaxpr_audit.py``.  Where
the JAX auditor walks the equations of ``jax.make_jaxpr``, this one
runs each canonical program (``programs.py``) once on the CPU, through
the kernels' plain routes, under a recording dispatch mode
(:func:`trace_program`) that sees every aten op the program dispatches
— the forward, a backward it runs, and the ops of collectives — with
its inputs' and outputs' shapes, dtypes and devices.  The cost model's
harvest (``_private/device_stats.harvest_cost``) runs in the same call
and gives the program's peak device bytes.

Rules (ids as reported / suppressed; the JAX package's):

* ``host-transfer`` — no device-to-host read inside a program:
  ``aten._local_scalar_dense`` (``.item()``, ``int(t)``, ``float(t)``),
  a copy to another device, or an op whose output shape depends on the
  data (``nonzero``, ``masked_select``, boolean indexing), each of
  which waits for the card.
* ``f64`` — no float64/complex128 output anywhere.
* ``f32-matmul`` — an f32 x f32 product (mm/bmm/addmm/baddbmm, or
  matmul/linear/einsum whole under inference mode) whose
  largest operand has at least ``F32_MATMUL_MIN_ELEMENTS`` elements,
  unless the spec allows it: the tensor cores run bf16 operands with
  f32 accumulation.
* ``logits-buffer`` — no tensor of ``(..., padded_vocab)`` covering >=
  n_tokens rows (fwd or bwd): the fused and streaming CE exist to keep
  the (B*T, V) f32 tensor out of device memory.
* ``t0-scan`` — a prefill's op count (views aside) must not grow with
  the prompt: the program is traced at T0 and at 2*T0 and the counts
  must be equal (a per-token loop is the one-dispatch-per-token
  regression).
* ``donation`` — buffers a spec declares donated are updated in place:
  each leaf's storage before the call is a storage of the result.  A
  leaf rebound to a new tensor by design is named in the spec's
  ``rebinds`` with the reason; nothing is dropped silently.
* ``hbm-budget`` — the harvest's peak device bytes against the budget
  the program declares.
* ``collectives`` — a tensor-parallel program must dispatch the
  collectives its sharding implies (``require_collectives``: parts of
  the collective ops' names, ``all_reduce``, ``all_gather``) and must
  not materialise a ``forbid_shapes`` tensor (the whole, unsharded
  pool).
* ``per-chip-hbm`` — the rank's harvested peak against
  ``per_chip_hbm_budget_bytes``.

Sharded specs declare ``min_ranks``: below that many ranks of
torch.distributed's default process group the spec is skipped with an
info note (the tensor-parallel rank programs of
``tests/_torch_seq_ranks.py`` run it on their ranks).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Tuple

from ray_tpu_torch.tools.graftcheck.core import Violation

#: f32 x f32 products at or above this many elements (largest operand)
#: are flagged; below it the penalty is noise (the JAX threshold)
F32_MATMUL_MIN_ELEMENTS = 1 << 16

#: ops whose output shape depends on the data they read
DATA_DEPENDENT_OPS = frozenset({"nonzero", "masked_select",
                                "nonzero_static", "unique_dim",
                                "_unique2", "unique_consecutive"})

#: the product ops, and (under inference mode, where they reach the
#: mode whole) the composites that decompose to them
_PRODUCTS = frozenset({"mm", "bmm", "addmm", "baddbmm", "matmul",
                       "linear", "einsum"})


@dataclasses.dataclass
class OpRecord:
    """One dispatched aten op as the auditor sees it."""

    name: str                          # the overload packet's name
    inputs: List[Tuple[tuple, str, str]]   # (shape, dtype, device)
    outputs: List[Tuple[tuple, str, str]]
    bool_index: bool = False           # indexing by a bool/uint8 mask
    in_kernel: bool = False            # inside a kernel entry's body
    is_view: bool = False              # a view: metadata, no work
    product_operands: List[Tuple[tuple, str]] = dataclasses.field(
        default_factory=list)


def _meta(t) -> Tuple[tuple, str, str]:
    return (tuple(t.shape), str(t.dtype).replace("torch.", ""),
            t.device.type)


def _record(func, args, kwargs, out) -> OpRecord:
    import torch
    from torch.utils._pytree import tree_flatten

    ins = [x for x in tree_flatten((args, kwargs))[0]
           if isinstance(x, torch.Tensor)]
    outs = [x for x in tree_flatten(out)[0]
            if isinstance(x, torch.Tensor)]
    name = func.overloadpacket.__name__
    rec = OpRecord(name, [_meta(t) for t in ins], [_meta(t) for t in outs],
                   is_view=bool(func.is_view))
    if name in ("index", "index_put", "index_put_") and len(args) > 1:
        rec.bool_index = any(
            isinstance(i, torch.Tensor)
            and i.dtype in (torch.bool, torch.uint8)
            for i in (args[1] or ()))
    if name in _PRODUCTS:
        operands = (args[1:3] if name in ("addmm", "baddbmm") else
                    args[1] if name == "einsum" else args[:2])
        rec.product_operands = [(tuple(a.shape),
                                 str(a.dtype).replace("torch.", ""))
                                for a in operands
                                if isinstance(a, torch.Tensor)]
    return rec


def trace_program(fn: Callable, args: tuple
                  ) -> Tuple[Any, List[OpRecord], Optional[Dict[str, Any]]]:
    """Run ``fn(*args)`` once under the cost harvest, recording each op
    it dispatches: (its result, the ops in order, the harvest's cost
    dict).  Ops inside a kernel entry (the plain route of a kernel,
    which on the card is one launch) are marked ``in_kernel``."""
    from ray_tpu_torch._private.device_stats import _harvest

    ops: List[OpRecord] = []

    def observe(func, a, kw, out, in_kernel):
        rec = _record(func, a, kw, out)
        rec.in_kernel = in_kernel
        ops.append(rec)

    out, cost = _harvest(fn, args, {}, observer=observe)
    return out, ops, cost


def _outside(ops: List[OpRecord]) -> List[OpRecord]:
    """The ops outside kernel entries: what the program itself puts in
    device memory (a kernel's tiles never reach it)."""
    return [op for op in ops if not op.in_kernel]


def collect_shapes(ops: List[OpRecord]) -> List[Tuple[tuple, str]]:
    """(shape, dtype) of every input and output of every op outside the
    kernel entries."""
    return [(s, dt) for op in _outside(ops)
            for s, dt, _ in op.inputs + op.outputs]


def logits_sized_shapes(ops: List[OpRecord], n_tokens: int,
                        padded_vocab: int) -> List[tuple]:
    """Shapes whose trailing dim is ``padded_vocab`` and whose leading
    dims cover >= ``n_tokens`` rows: (B, T, V)/(B*T, V) logits."""
    return [s for s, _dt in collect_shapes(ops)
            if len(s) >= 2 and s[-1] == padded_vocab
            and math.prod(s[:-1]) >= n_tokens]


# ---------------------------------------------------------------------------
# program specs + the rules
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ProgramSpec:
    """One canonical hot-path program and the invariants it declares.

    ``build()`` returns ``(fn, args)`` — kept lazy so importing the
    auditor never constructs models.  ``build_at(T)``, for the t0-scan
    rule, builds the same program at prompt length T;
    ``forbid_scan_lengths`` are the T0 it is traced at (and at 2*T0).
    ``forbid_logits`` is the ``(n_tokens, padded_vocab)`` pair of the
    logits-buffer rule; ``donate_argnums`` the arguments updated in
    place, ``rebinds`` the leaf paths ("pos", ...) of those a program
    rebinds by design, each with its reason; ``hbm_budget_bytes`` the
    ceiling of the harvested peak."""

    name: str
    build: Callable[[], Tuple[Callable, tuple]]
    forbid_logits: Optional[Tuple[int, int]] = None
    forbid_scan_lengths: Tuple[int, ...] = ()
    build_at: Optional[Callable[[int], Tuple[Callable, tuple]]] = None
    donate_argnums: Tuple[int, ...] = ()
    rebinds: Dict[str, str] = dataclasses.field(default_factory=dict)
    hbm_budget_bytes: Optional[int] = None
    allow_f32_matmul: bool = False
    skip_rules: Tuple[str, ...] = ()
    #: skip the spec (info note, not a failure) below this many ranks
    min_ranks: int = 1
    #: c10d op names the program must dispatch
    require_collectives: Tuple[str, ...] = ()
    #: shapes no tensor of the program may have (an unsharded buffer)
    forbid_shapes: Tuple[tuple, ...] = ()
    per_chip_hbm_budget_bytes: Optional[int] = None


def _check_host_transfer(ops, spec) -> List[Violation]:
    out = []
    for op in ops:
        devs = {d for _, _, d in op.inputs + op.outputs}
        why = None
        if op.name == "_local_scalar_dense":
            why = "reads a tensor's value on the host (.item()/int())"
        elif op.name in DATA_DEPENDENT_OPS:
            why = "output shape depends on the data"
        elif op.bool_index:
            why = "indexes by a boolean mask (a data-dependent shape)"
        elif len(devs) > 1 and op.name in ("_to_copy", "copy_", "to"):
            why = f"copies between devices {sorted(devs)}"
        if why:
            out.append(Violation(
                "host-transfer",
                f"op '{op.name}' {why}: a device-to-host round trip "
                f"inside the program", program=spec.name))
    return out


def _check_f64(ops, spec) -> List[Violation]:
    out, seen = [], set()
    for op in _outside(ops):
        for shape, dtype, _ in op.outputs:
            if dtype in ("float64", "complex128") \
                    and (shape, dtype) not in seen:
                seen.add((shape, dtype))
                out.append(Violation(
                    "f64",
                    f"{dtype} tensor of shape {shape} in the traced "
                    f"program (the dtype policy is bf16 compute / f32 "
                    f"accumulate)", program=spec.name))
    return out


def _check_f32_matmul(ops, spec) -> List[Violation]:
    out = []
    for op in _outside(ops):
        if op.name not in _PRODUCTS or not op.product_operands:
            continue
        if not all(dt == "float32" for _, dt in op.product_operands):
            continue
        biggest = max(math.prod(s) for s, _ in op.product_operands)
        if biggest >= F32_MATMUL_MIN_ELEMENTS:
            out.append(Violation(
                "f32-matmul",
                f"f32 x f32 {op.name} over "
                f"{[s for s, _ in op.product_operands]} (>= "
                f"{F32_MATMUL_MIN_ELEMENTS} elements) — feed the tensor "
                f"cores bf16 operands with f32 accumulation, or allow "
                f"it via allow_f32_matmul", program=spec.name))
    return out


def _check_logits_buffer(ops, spec) -> List[Violation]:
    n_tokens, padded_vocab = spec.forbid_logits
    hits = logits_sized_shapes(ops, n_tokens, padded_vocab)
    if hits:
        return [Violation(
            "logits-buffer",
            f"(>= {n_tokens} tokens, {padded_vocab})-sized tensors "
            f"materialized: {sorted(set(hits))} — the fused/streaming "
            f"CE contract forbids a full logits tensor",
            program=spec.name)]
    return []


def _check_t0_scan(spec) -> Tuple[List[Violation], Dict[str, Any]]:
    out: List[Violation] = []
    counts: Dict[str, Any] = {}
    for t0 in spec.forbid_scan_lengths:
        n = {}
        for t in (t0, 2 * t0):
            fn, args = spec.build_at(t)
            # views are metadata (a full-width slice is elided)
            n[t] = sum(not op.is_view for op in trace_program(fn, args)[1])
        counts[str(t0)] = [n[t0], n[2 * t0]]
        if n[t0] != n[2 * t0]:
            out.append(Violation(
                "t0-scan",
                f"the op count grows with the prompt ({n[t0]} ops at "
                f"T0={t0}, {n[2 * t0]} at {2 * t0}) — prompt processing "
                f"regressed to per-token dispatches",
                program=spec.name))
    return out, counts


def _leaf_paths(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    import torch

    if isinstance(tree, torch.Tensor):
        return [(prefix, tree)]
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in
                _leaf_paths(tree[k], f"{prefix}.{k}" if prefix else str(k))]
    if isinstance(tree, (list, tuple)):
        return [p for i, x in enumerate(tree) for p in
                _leaf_paths(x, f"{prefix}.{i}" if prefix else str(i))]
    return []


def _check_donation(before: Dict[int, List[Tuple[str, int]]], out,
                    spec) -> List[Violation]:
    from ray_tpu_torch._private.device_stats import _ptr

    kept = {_ptr(t) for _, t in _leaf_paths(out)}
    dropped = [f"arg {argnum} leaf '{path}'"
               for argnum, leaves in before.items()
               for path, ptr in leaves
               if ptr not in kept and path not in spec.rebinds]
    if dropped:
        return [Violation(
            "donation",
            f"{len(dropped)} donated buffer(s) not updated in place "
            f"({', '.join(dropped[:4])}) — the result holds a new "
            f"tensor, so the program keeps two copies live", program=
            spec.name)]
    return []


def _check_collectives(ops, spec) -> List[Violation]:
    out = []
    names = {op.name for op in ops}
    for want in spec.require_collectives:
        if not any(want in n for n in names):
            out.append(Violation(
                "collectives",
                f"the program dispatches no '{want}' — the mesh "
                f"sharding this spec declares implies one; the inputs "
                f"are likely no longer partitioned", program=spec.name))
    shapes = {s for s, _ in collect_shapes(ops)}
    for bad in spec.forbid_shapes:
        if tuple(bad) in shapes:
            out.append(Violation(
                "collectives",
                f"the program materializes the forbidden whole-buffer "
                f"shape {tuple(bad)} — a tensor meant to be partitioned "
                f"is whole on this rank", program=spec.name))
    return out


def _world_size() -> int:
    try:
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            return dist.get_world_size()
    except Exception:  # noqa: BLE001
        pass
    return 1


def audit_program(spec: ProgramSpec
                  ) -> Tuple[List[Violation], Dict[str, Any]]:
    """Trace one program and run every rule it doesn't skip.  Returns
    (violations, info): the op count, the harvested peak device bytes
    and its budget, the t0-scan counts."""
    world = _world_size()
    if world < spec.min_ranks:
        return [], {"skipped": f"requires >= {spec.min_ranks} ranks, "
                               f"have {world}"}
    fn, args = spec.build()
    from ray_tpu_torch._private.device_stats import _ptr

    before = {a: [(p, _ptr(t)) for p, t in _leaf_paths(args[a])]
              for a in spec.donate_argnums}
    out, ops, cost = trace_program(fn, args)
    checks = {
        "host-transfer": lambda: _check_host_transfer(ops, spec),
        "f64": lambda: _check_f64(ops, spec),
        "f32-matmul": lambda: ([] if spec.allow_f32_matmul
                               else _check_f32_matmul(ops, spec)),
        "logits-buffer": lambda: (_check_logits_buffer(ops, spec)
                                  if spec.forbid_logits else []),
        "donation": lambda: (_check_donation(before, out, spec)
                             if spec.donate_argnums else []),
        "collectives": lambda: (
            _check_collectives(ops, spec)
            if spec.require_collectives or spec.forbid_shapes else []),
    }
    violations: List[Violation] = []
    for rule, run in checks.items():
        if rule not in spec.skip_rules:
            violations.extend(run())
    info: Dict[str, Any] = {"ops": len(ops)}
    if spec.forbid_scan_lengths and "t0-scan" not in spec.skip_rules:
        vs, info["t0_scan_ops"] = _check_t0_scan(spec)
        violations.extend(vs)
    peak = (cost or {}).get("peak_hbm_bytes")
    if peak is None and (spec.hbm_budget_bytes
                         or spec.per_chip_hbm_budget_bytes):
        violations.append(Violation(
            "hbm-budget", "the cost harvest gave no peak (counting "
            "failed): the budget cannot be checked", program=spec.name))
    if "hbm-budget" not in spec.skip_rules:
        info["peak_hbm_bytes"] = peak
        info["hbm_budget_bytes"] = spec.hbm_budget_bytes
        if spec.hbm_budget_bytes and peak is not None \
                and peak > spec.hbm_budget_bytes:
            violations.append(Violation(
                "hbm-budget",
                f"peak device bytes {peak / 2**20:.2f} MiB exceed the "
                f"declared budget {spec.hbm_budget_bytes / 2**20:.2f} "
                f"MiB", program=spec.name))
    if spec.per_chip_hbm_budget_bytes \
            and "per-chip-hbm" not in spec.skip_rules:
        info["per_chip_hbm_bytes"] = peak
        info["per_chip_hbm_budget_bytes"] = spec.per_chip_hbm_budget_bytes
        if peak is not None and peak > spec.per_chip_hbm_budget_bytes:
            violations.append(Violation(
                "per-chip-hbm",
                f"this rank's peak {peak / 2**20:.2f} MiB exceeds the "
                f"declared per-chip budget "
                f"{spec.per_chip_hbm_budget_bytes / 2**20:.2f} MiB",
                program=spec.name))
    return violations, info


def audit_programs(specs) -> Tuple[List[Violation],
                                   Dict[str, Dict[str, Any]]]:
    """Audit every spec; a program whose build/trace itself crashes is
    reported as an ``audit-error`` violation instead of killing the
    whole run (the other programs' results still matter)."""
    violations: List[Violation] = []
    infos: Dict[str, Dict[str, Any]] = {}
    for spec in specs:
        try:
            vs, info = audit_program(spec)
        except Exception as e:  # noqa: BLE001 - surfaced as a finding
            violations.append(Violation(
                "audit-error",
                f"tracing failed: {type(e).__name__}: {str(e)[:200]}",
                program=spec.name))
            infos[spec.name] = {"error": type(e).__name__}
            continue
        violations.extend(vs)
        infos[spec.name] = info
    return violations, infos
