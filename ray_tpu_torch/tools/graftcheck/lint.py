"""The repo linter: stdlib-``ast`` rules over ray_tpu_torch/ source (the
counterpart of ``ray_tpu/tools/graftcheck/lint.py``).

Where the program auditor proves invariants about traced programs,
this engine catches the host-side habits that erode them: blocking
calls on the async serve path, wall-clock reads in telemetry code that
promised an injectable clock, module-level mutable state shared across
remote invocations, and metric declarations the Prometheus exposition
would reject.  It walks the port's package (not the vendored
``_private/_vendor/``); the repo-level checks read only the port's
files.

Every rule honors ``# graftcheck: disable=<rule>(<reason>)`` on the
offending line or a standalone comment line directly above it
(core.py).  The reason is required: a bare waiver is flagged by
``suppression-reason`` and a waiver that drops nothing by
``stale-suppression`` — suppression is deliberate, explained, and
pruned when the code it excused goes away.

Rule ids:

* ``blocking-call-in-async`` — ``torch.cuda.synchronize()`` and a
  stream's or event's ``.synchronize()`` (the counterparts of
  ``.block_until_ready()``), ``np.asarray(...)``, sync
  ``ray_tpu_torch.get``, and ``time.sleep`` inside ``async def``
  bodies under ``ray_tpu_torch/serve/`` (healthwatch's
  ``serve/health.py``/``serve/chaos.py`` included),
  ``tools/tracebus.py``, ``tools/incidents.py``, or
  ``ray_tpu_torch/tools/autopilot/`` (the dashboard calls the
  autopilot from its event loop): each blocks the event loop (and
  usually the decode engine) on a device or cluster round-trip.  Deliberate host fences carry a disable comment naming
  the reason.
* ``wallclock-in-telemetry`` — ``time.time()`` in ``*/telemetry.py``,
  ``util/tracing.py``, ``_private/flightrec.py``, ``serve/slo.py``,
  ``serve/kv_tier.py`` (the host tier never reads a clock — the
  engine feeds it measured H2D/D2H seconds via ``note_h2d`` /
  ``note_d2h``, the trainwatch idiom),
  ``serve/router.py`` (the fleet router timestamps routing/autoscale
  decisions and measures drain deadlines — interval math like the
  rest), ``serve/health.py``/``serve/chaos.py``/``tools/incidents.py``
  (healthwatch: heartbeat ages, detection latency, and merged
  incident timelines are all perf_counter interval math with
  injectable ``now=``), ``train/goodput.py`` (the trainwatch anatomy
  promises legs
  that sum exactly to the step wall — one wall-clock read breaks the
  invariant), or anywhere under ``ray_tpu_torch/tools/autopilot/``
  (verdicts must be reproducible from ledger contents alone):
  telemetry takes an injectable ``now`` (tests drive deterministic
  clocks) and intervals must use the monotonic ``perf_counter`` —
  the flight-recorder journal and SLO burn-rate windows are interval
  math end to end, so one wall-clock read corrupts them under NTP
  steps.
* ``mutable-global-in-remote`` — a ``@remote`` function or
  remote-actor method mutating a module-level list/dict/set: each
  worker process gets its own copy, so the mutation is a silent no-op
  cross-process and a race within one (heuristic: flags mutating
  calls/subscript-stores only, not reads).
* ``metric-name`` — every ``Counter``/``Gauge``/``Histogram`` from
  ``ray_tpu_torch.util.metrics`` must carry a literal
  ``^[a-z][a-z0-9_]*$`` name.
* ``shared-state-race`` / ``rng-discipline`` — the concurrency and
  determinism passes (races.py): unlocked compound mutations on
  attributes reachable from two execution contexts, and torch draws
  without a generator / entropy-derived seeds / unseeded global RNG
  draws on the serve path.
* ``suppression-reason`` / ``stale-suppression`` — waiver hygiene:
  every disable comment must carry a parenthesized reason naming a
  known rule, and must actually drop a violation on its covered
  lines.
* ``cuda-kernel-test`` (beside the JAX package's
  ``pallas-interpret-test``, which a waiver may still name) — an
  ``ops/*.py`` launching a CUDA kernel (``_kernels.launch``) needs a
  CPU test of its plain version (``tests/test_torch_<module>.py``, not
  ``cuda``-marked) and a ``cuda``-marked test of the kernel naming the
  module: a kernel no test holds to its plain version on the card is
  unverified, and one whose plain version no CPU test runs keeps its
  numerics unverifiable in tier-1.
* ``kernel-exports`` — the public kernel entry points must stay
  exported (and resolvable) from ``ray_tpu_torch.ops``.
* ``observatory-mapping`` — every ProgramSpec in
  ``tools/graftcheck/programs.py`` must map to a runtime program name
  in ``_private/device_stats.py``'s ``STATIC_PROGRAM_MAP`` (and every
  mapping must target a KNOWN_PROGRAMS name): the static auditor's
  catalog of hot-path programs and the runtime perf observatory's must
  not drift apart.
* ``autopilot-attribution`` — every runtime program name
  ``STATIC_PROGRAM_MAP`` targets must have a knob entry in
  ``tools/autopilot/attribution.py``'s ``PROGRAM_KNOBS`` (and every
  knob entry must name a KNOWN_PROGRAMS program): the tuning loop
  cannot name a bottleneck it has no catalogued way to move.
* ``contract-registry`` / ``perfledger-direction`` — the registry
  drift checks (contracts.py): the exact-sum critical-path component
  list must stay pinned in the tracebus span taxonomy, the
  engine-stats golden schema, traffic's TTFT decomposition and the
  docs tables; every perfledger sweep field must resolve to an
  explicit higher/lower-is-better direction.
"""

from __future__ import annotations

import ast
import pathlib
import re
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch.tools.graftcheck.contracts import (contract_registry,
                                                      perfledger_direction)
from ray_tpu_torch.tools.graftcheck.core import (Violation,
                                                 parse_suppressions,
                                                 parse_suppression_entries,
                                                 split_suppressed)
from ray_tpu_torch.tools.graftcheck.races import (rng_discipline,
                                                  shared_state_races)

#: the package the linter walks, and its vendored tree it skips
PACKAGE = "ray_tpu_torch"
VENDORED = "ray_tpu_torch/_private/_vendor/"

_METRIC_CLASSES = {"Counter", "Gauge", "Histogram"}
_METRIC_NAME_RE = re.compile(r"^[a-z][a-z0-9_]*$")
_MUTATORS = {"append", "add", "update", "setdefault", "extend",
             "insert", "remove", "clear", "pop", "popleft",
             "appendleft"}
_MUTABLE_FACTORIES = {"list", "dict", "set", "defaultdict", "deque",
                      "OrderedDict", "Counter"}
#: entry points that must stay exported from ray_tpu_torch.ops
KERNEL_EXPORTS = ("causal_attention", "flash_attention", "fused_lm_ce",
                  "streaming_ce", "ring_attention", "ulysses_attention")

#: every rule id a disable comment may legitimately name — a waiver
#: for anything else is a typo or a removed rule (stale-suppression)
KNOWN_RULES = frozenset({
    # lint per-file rules
    "parse-error", "blocking-call-in-async", "wallclock-in-telemetry",
    "mutable-global-in-remote", "metric-name", "shared-state-race",
    "rng-discipline",
    # repo-level checks ("cuda-kernel-test" is the port's counterpart
    # of "pallas-interpret-test")
    "pallas-interpret-test", "cuda-kernel-test", "kernel-exports",
    "observatory-mapping",
    "autopilot-attribution", "contract-registry",
    "perfledger-direction",
    # hygiene (listed so `disable=all` docs stay honest; the hygiene
    # rules themselves are never suppressable)
    "suppression-reason", "stale-suppression",
    # program auditor rules
    "host-transfer", "f64", "f32-matmul", "logits-buffer", "t0-scan",
    "donation", "collectives", "per-chip-hbm", "hbm-budget",
    "audit-error",
    "all",
})


def _call_label(func: ast.AST) -> str:
    try:
        return ast.unparse(func)
    except Exception:  # noqa: BLE001 - exotic call targets
        return ""


# ---------------------------------------------------------------------------
# per-file rules
# ---------------------------------------------------------------------------

def _blocking_calls_in_async(tree: ast.AST, rel: str) -> List[Violation]:
    rel_posix = rel.replace("\\", "/")
    if not (rel_posix.startswith("ray_tpu_torch/serve/")
            or rel_posix.startswith("ray_tpu_torch/tools/autopilot/")
            or rel_posix.endswith("tools/tracebus.py")
            or rel_posix.endswith("tools/incidents.py")):
        return []
    out: List[Violation] = []

    def walk_async_body(node):
        """Yield calls lexically inside one async def, not descending
        into nested function/class definitions (they run elsewhere)."""
        stack = list(ast.iter_child_nodes(node))
        while stack:
            sub = stack.pop()
            if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.ClassDef)):
                continue
            if isinstance(sub, ast.Call):
                yield sub
            stack.extend(ast.iter_child_nodes(sub))

    for node in ast.walk(tree):
        if not isinstance(node, ast.AsyncFunctionDef):
            continue
        for call in walk_async_body(node):
            label = _call_label(call.func)
            blocking = (
                label.endswith(".synchronize")
                or label in ("np.asarray", "numpy.asarray")
                or label in ("ray.get", "ray_tpu_torch.get")
                or label in ("time.sleep", "_time.sleep"))
            if blocking:
                out.append(Violation(
                    "blocking-call-in-async",
                    f"'{label}(...)' blocks the event loop inside "
                    f"async '{node.name}' on the serve path — await an "
                    f"executor, or mark a deliberate host fence with a "
                    f"disable comment", file=rel, line=call.lineno))
    return out


def _wallclock_in_telemetry(tree: ast.AST, rel: str) -> List[Violation]:
    rel_posix = rel.replace("\\", "/")
    if not (rel_posix.endswith("/telemetry.py")
            or rel_posix.endswith("util/tracing.py")
            or rel_posix.endswith("_private/flightrec.py")
            or rel_posix.endswith("serve/slo.py")
            or rel_posix.endswith("serve/router.py")
            or rel_posix.endswith("serve/kvscope.py")
            or rel_posix.endswith("serve/kv_tier.py")
            or rel_posix.endswith("serve/health.py")
            or rel_posix.endswith("serve/chaos.py")
            or rel_posix.endswith("tools/tracebus.py")
            or rel_posix.endswith("tools/kvscope.py")
            or rel_posix.endswith("tools/incidents.py")
            or rel_posix.endswith("train/goodput.py")
            or rel_posix.startswith("ray_tpu_torch/tools/autopilot/")):
        return []
    out: List[Violation] = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) \
                and _call_label(node.func) in ("time.time", "_time.time"):
            out.append(Violation(
                "wallclock-in-telemetry",
                "time.time() in telemetry code — intervals must use "
                "time.perf_counter() (monotonic) and record_* methods "
                "take an injectable `now` for deterministic tests",
                file=rel, line=node.lineno))
    return out


def _module_mutables(tree: ast.Module) -> set:
    """Module-level names bound to mutable list/dict/set containers."""
    names = set()
    for node in tree.body:
        if isinstance(node, ast.Assign):
            targets, value = node.targets, node.value
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            targets, value = [node.target], node.value
        else:
            continue
        mutable = isinstance(value, (ast.List, ast.Dict, ast.Set)) or (
            isinstance(value, ast.Call)
            and isinstance(value.func, ast.Name)
            and value.func.id in _MUTABLE_FACTORIES)
        if not mutable:
            continue
        for t in targets:
            if isinstance(t, ast.Name):
                names.add(t.id)
    return names


def _is_remote_decorated(node) -> bool:
    for dec in node.decorator_list:
        root = dec.func if isinstance(dec, ast.Call) else dec
        label = _call_label(root)
        if label == "remote" or label.endswith(".remote"):
            return True
    return False


def _mutable_global_in_remote(tree: ast.Module,
                              rel: str) -> List[Violation]:
    mutables = _module_mutables(tree)
    if not mutables:
        return []
    remote_fns: List = []
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and _is_remote_decorated(node):
            remote_fns.append(node)
        elif isinstance(node, ast.ClassDef) and _is_remote_decorated(node):
            remote_fns.extend(
                n for n in node.body
                if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)))
    out: List[Violation] = []
    for fn in remote_fns:
        for sub in ast.walk(fn):
            name = None
            if isinstance(sub, ast.Call) \
                    and isinstance(sub.func, ast.Attribute) \
                    and sub.func.attr in _MUTATORS \
                    and isinstance(sub.func.value, ast.Name):
                name = sub.func.value.id
            elif isinstance(sub, (ast.Assign, ast.AugAssign)):
                targets = (sub.targets if isinstance(sub, ast.Assign)
                           else [sub.target])
                for t in targets:
                    if isinstance(t, ast.Subscript) \
                            and isinstance(t.value, ast.Name):
                        name = t.value.id
            if name and name in mutables:
                out.append(Violation(
                    "mutable-global-in-remote",
                    f"remote '{fn.name}' mutates module-level "
                    f"'{name}' — each worker process has its own copy "
                    f"(cross-process no-op, in-process race); pass "
                    f"state explicitly or use an actor",
                    file=rel, line=sub.lineno))
    return out


def _metric_calls(tree: ast.Module):
    """(lineno, class_label, name_node) for util.metrics constructions
    — bare aliases from ``from ray_tpu_torch.util.metrics import X`` or
    attribute calls on a module imported as ``metrics``."""
    aliases: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) \
                and node.module == "ray_tpu_torch.util.metrics":
            for a in node.names:
                if a.name in _METRIC_CLASSES:
                    aliases[a.asname or a.name] = a.name
    out = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        label = None
        if isinstance(f, ast.Name) and f.id in aliases:
            label = aliases[f.id]
        elif (isinstance(f, ast.Attribute) and f.attr in _METRIC_CLASSES
                and isinstance(f.value, ast.Name)
                and f.value.id == "metrics"):
            label = f.attr
        if label is None:
            continue
        name_node = node.args[0] if node.args else None
        for kw in node.keywords:
            if kw.arg == "name":
                name_node = kw.value
        out.append((node.lineno, label, name_node))
    return out


def _metric_names(tree: ast.Module, rel: str,
                  seen: List[str]) -> List[Violation]:
    out: List[Violation] = []
    for lineno, label, name_node in _metric_calls(tree):
        if not (isinstance(name_node, ast.Constant)
                and isinstance(name_node.value, str)):
            out.append(Violation(
                "metric-name",
                f"{label} name is not a string literal (the Prometheus "
                f"exposition guard can't verify it)",
                file=rel, line=lineno))
            continue
        name = name_node.value
        seen.append(name)
        if not _METRIC_NAME_RE.match(name):
            out.append(Violation(
                "metric-name",
                f"{label} name {name!r} violates ^[a-z][a-z0-9_]*$ "
                f"(Prometheus would reject or mangle it)",
                file=rel, line=lineno))
    return out


def _suppression_hygiene(source: str, rel: str,
                         dropped: List[Violation]) -> List[Violation]:
    """``suppression-reason`` + ``stale-suppression`` for one file:
    every disable entry must name a known rule WITH a parenthesized
    reason, and must have dropped at least one violation on its
    covered lines.  Computed after the split so these are never
    themselves suppressable."""
    out: List[Violation] = []
    dropped_at: Dict[int, set] = {}
    for v in dropped:
        if v.line is not None:
            dropped_at.setdefault(v.line, set()).add(v.rule)
    for entry in parse_suppression_entries(source):
        for rule, reason in entry.rules.items():
            if rule not in KNOWN_RULES:
                out.append(Violation(
                    "stale-suppression",
                    f"disable comment names unknown rule '{rule}' — "
                    f"typo, or a rule this linter no longer has",
                    file=rel, line=entry.line))
                continue
            if reason is None or not reason.strip():
                out.append(Violation(
                    "suppression-reason",
                    f"disable={rule} carries no reason — waivers are "
                    f"reviewable only when they say why: "
                    f"disable={rule}(<reason>)",
                    file=rel, line=entry.line))
            hit = any(
                rule in dropped_at.get(line, ())
                or (rule == "all" and dropped_at.get(line))
                for line in entry.covered)
            if not hit:
                out.append(Violation(
                    "stale-suppression",
                    f"disable={rule} suppresses nothing on line(s) "
                    f"{'/'.join(map(str, entry.covered))} — the code "
                    f"it excused is gone; delete the waiver",
                    file=rel, line=entry.line))
    return out


def lint_source(source: str, rel: str,
                metric_names_seen: List[str] = None
                ) -> Tuple[List[Violation], int]:
    """Lint one file's source; returns (kept violations, n suppressed).
    ``rel`` is the repo-relative posix path — the rules scope on it."""
    try:
        tree = ast.parse(source, filename=rel)
    except SyntaxError as e:
        return [Violation("parse-error", f"file does not parse: {e}",
                          file=rel, line=e.lineno)], 0
    violations: List[Violation] = []
    violations += _blocking_calls_in_async(tree, rel)
    violations += _wallclock_in_telemetry(tree, rel)
    violations += _mutable_global_in_remote(tree, rel)
    violations += _metric_names(
        tree, rel,
        metric_names_seen if metric_names_seen is not None else [])
    violations += shared_state_races(tree, rel)
    violations += rng_discipline(tree, rel)
    kept, dropped = split_suppressed(violations,
                                     parse_suppressions(source))
    kept.extend(_suppression_hygiene(source, rel, dropped))
    return kept, len(dropped)


# ---------------------------------------------------------------------------
# repo-level checks
# ---------------------------------------------------------------------------

def kernel_modules(root: pathlib.Path) -> List[str]:
    """ops/*.py stems that launch a CUDA kernel (``_kernels.launch`` in
    source)."""
    ops_dir = root / PACKAGE / "ops"
    return sorted(
        p.stem for p in ops_dir.glob("*.py")
        if p.name not in ("__init__.py", "_kernels.py")
        and "_kernels.launch" in p.read_text())


def _cuda_kernel_tests(root: pathlib.Path) -> List[Violation]:
    out: List[Violation] = []
    tests_dir = root / "tests"
    texts = {p.name: p.read_text()
             for p in sorted(tests_dir.glob("test_torch_*.py"))}
    for stem in kernel_modules(root):
        rel = f"{PACKAGE}/ops/{stem}.py"
        cpu = texts.get(f"test_torch_{stem}.py")
        if cpu is None or "mark.cuda" in cpu:
            out.append(Violation(
                "cuda-kernel-test",
                f"launches a CUDA kernel but has no CPU test "
                f"tests/test_torch_{stem}.py of its plain version (one "
                f"that runs here, not cuda-marked)", file=rel))
        if not any("mark.cuda" in text and stem in text
                   for text in texts.values()):
            out.append(Violation(
                "cuda-kernel-test",
                f"launches a CUDA kernel but no cuda-marked "
                f"tests/test_torch_*.py names '{stem}' — hold the "
                f"kernel to its plain version on the card",
                file=rel))
    return out


def _kernel_exports() -> List[Violation]:
    out: List[Violation] = []
    try:
        import ray_tpu_torch.ops as ops
    except Exception as e:  # noqa: BLE001 - import failure IS the finding
        return [Violation(
            "kernel-exports",
            f"ray_tpu_torch.ops failed to import: {type(e).__name__}: {e}",
            file="ray_tpu_torch/ops/__init__.py")]
    for name in KERNEL_EXPORTS:
        if name not in getattr(ops, "__all__", ()):
            out.append(Violation(
                "kernel-exports",
                f"'{name}' missing from ray_tpu_torch.ops.__all__",
                file="ray_tpu_torch/ops/__init__.py"))
        elif not callable(getattr(ops, name, None)):
            out.append(Violation(
                "kernel-exports",
                f"ray_tpu_torch.ops.{name} is not callable",
                file="ray_tpu_torch/ops/__init__.py"))
    for name in getattr(ops, "__all__", ()):
        if getattr(ops, name, None) is None:
            out.append(Violation(
                "kernel-exports",
                f"__all__ entry '{name}' does not resolve",
                file="ray_tpu_torch/ops/__init__.py"))
    return out


def _observatory_mapping() -> List[Violation]:
    """Every audited ProgramSpec must have a runtime observatory
    mapping, and every mapping must point at a program name the
    runtime hooks actually register — otherwise the static and
    runtime views of 'the hot-path programs' silently diverge."""
    ds_file = "ray_tpu_torch/_private/device_stats.py"
    try:
        from ray_tpu_torch._private.device_stats import (
            KNOWN_PROGRAMS, STATIC_PROGRAM_MAP)
        from ray_tpu_torch.tools.graftcheck.programs import default_programs

        spec_names = [s.name for s in default_programs()]
    except Exception as e:  # noqa: BLE001 - import failure IS the finding
        return [Violation(
            "observatory-mapping",
            f"observatory mapping unavailable: {type(e).__name__}: {e}",
            file=ds_file)]
    out: List[Violation] = []
    for name in spec_names:
        if name not in STATIC_PROGRAM_MAP:
            out.append(Violation(
                "observatory-mapping",
                f"ProgramSpec '{name}' has no entry in "
                f"STATIC_PROGRAM_MAP — map it to the runtime program "
                f"name the perf observatory registers it under",
                file=ds_file))
    for spec, runtime in STATIC_PROGRAM_MAP.items():
        if runtime not in KNOWN_PROGRAMS:
            out.append(Violation(
                "observatory-mapping",
                f"STATIC_PROGRAM_MAP['{spec}'] -> '{runtime}' is not a "
                f"KNOWN_PROGRAMS runtime name", file=ds_file))
        if spec not in spec_names:
            out.append(Violation(
                "observatory-mapping",
                f"STATIC_PROGRAM_MAP entry '{spec}' matches no "
                f"ProgramSpec in tools/graftcheck/programs.py — stale "
                f"mapping for a removed/renamed spec", file=ds_file))
    return out


def _autopilot_attribution() -> List[Violation]:
    """Every runtime program the observatory can register must have an
    autopilot knob entry (PROGRAM_KNOBS), and every knob entry must
    name a real runtime program — otherwise the tuning loop's
    'attribute' stage silently reports a bottleneck with no catalogued
    way to move it (or grids over a program that can never appear).
    Mirrors the observatory-mapping rule one layer up."""
    ap_file = "ray_tpu_torch/tools/autopilot/attribution.py"
    try:
        from ray_tpu_torch._private.device_stats import (
            KNOWN_PROGRAMS, STATIC_PROGRAM_MAP)
        from ray_tpu_torch.tools.autopilot.attribution import PROGRAM_KNOBS
    except Exception as e:  # noqa: BLE001 - import failure IS the finding
        return [Violation(
            "autopilot-attribution",
            f"autopilot attribution catalog unavailable: "
            f"{type(e).__name__}: {e}", file=ap_file)]
    out: List[Violation] = []
    for spec, runtime in STATIC_PROGRAM_MAP.items():
        if runtime not in PROGRAM_KNOBS:
            out.append(Violation(
                "autopilot-attribution",
                f"runtime program '{runtime}' (ProgramSpec '{spec}') "
                f"has no PROGRAM_KNOBS entry — the autopilot can name "
                f"it as the bottleneck but catalogs no knob to move it",
                file=ap_file))
    for runtime in PROGRAM_KNOBS:
        if runtime not in KNOWN_PROGRAMS:
            out.append(Violation(
                "autopilot-attribution",
                f"PROGRAM_KNOBS entry '{runtime}' is not a "
                f"KNOWN_PROGRAMS runtime name — stale knob catalog for "
                f"a removed/renamed program", file=ap_file))
    return out


def lint_repo(root) -> Tuple[List[Violation], Dict[str, Any]]:
    """Lint every package file under ``root`` plus the repo-level
    checks.  Returns (violations, stats) where stats carries
    ``files``, ``suppressed``, and the literal ``metric_names`` seen
    (so callers can assert the scan isn't vacuous)."""
    root = pathlib.Path(root)
    violations: List[Violation] = []
    metric_names_seen: List[str] = []
    n_files = 0
    n_suppressed = 0
    for path in sorted((root / PACKAGE).rglob("*.py")):
        rel = path.relative_to(root).as_posix()
        if "__pycache__" in path.parts or rel.startswith(VENDORED):
            continue
        kept, dropped = lint_source(path.read_text(), rel,
                                    metric_names_seen)
        violations.extend(kept)
        n_suppressed += dropped
        n_files += 1
    violations.extend(_cuda_kernel_tests(root))
    violations.extend(_kernel_exports())
    violations.extend(_observatory_mapping())
    violations.extend(_autopilot_attribution())
    violations.extend(contract_registry(root))
    violations.extend(perfledger_direction(root))
    stats = {"files": n_files, "suppressed": n_suppressed,
             "metric_names": metric_names_seen}
    return violations, stats


def lint_files(root, rels: List[str]
               ) -> Tuple[List[Violation], Dict[str, Any]]:
    """Per-file lint of an explicit file list (``--changed`` mode):
    the repo-level registry checks are skipped — they can only drift
    via the files that define them, and the full run in CI holds that
    line.  ``rels`` are repo-relative posix paths; non-package or
    vanished paths are ignored (deleted files show up in git ranges)."""
    root = pathlib.Path(root)
    violations: List[Violation] = []
    metric_names_seen: List[str] = []
    n_files = 0
    n_suppressed = 0
    for rel in sorted(set(rels)):
        rel = rel.replace("\\", "/")
        path = root / rel
        if not rel.endswith(".py") or not rel.startswith(PACKAGE + "/") \
                or rel.startswith(VENDORED) or "__pycache__" in rel \
                or not path.exists():
            continue
        kept, dropped = lint_source(path.read_text(), rel,
                                    metric_names_seen)
        violations.extend(kept)
        n_suppressed += dropped
        n_files += 1
    stats = {"files": n_files, "suppressed": n_suppressed,
             "metric_names": metric_names_seen}
    return violations, stats
