"""graftcheck: static enforcement of the port's hot-path invariants
(the counterpart of ``ray_tpu/tools/graftcheck``).

Two engines, one report:

* the **program auditor** (:mod:`.trace_audit` + :mod:`.programs`)
  runs the canonical programs — train step for both model families,
  ragged prefill, pooled decode, spec verify, chunked prefill, the
  handoff programs, fused-CE fwd/bwd — once each on the CPU under a
  recording dispatch mode and proves no host transfer, no f64, no
  materialized logits buffer, no per-token prefill loop, in-place
  updates actually applied, and a harvested peak within each
  program's declared budget;
* the **repo linter** (:mod:`.lint`) walks ``ray_tpu_torch/`` with
  stdlib ``ast`` for the host-side habits that erode those invariants
  (blocking calls on the async serve path, wall-clock telemetry,
  mutable module state under ``@remote``, invalid metric names,
  kernels without tests, unlocked shared-state races across the
  fleet's execution contexts, RNG-discipline breaches on the serve
  path, and registry drift between the critical-path component list
  and its downstream views).

Run both with ``python -m ray_tpu_torch.tools.graftcheck`` (exit 0 iff
clean; ``--format json`` for the machine-readable report, ``--format
github`` for CI annotations, ``--changed <git-range>`` for fast
pre-commit lint of touched files only).  Waive a finding with ``#
graftcheck: disable=<rule>(<reason>)``; bare or no-op waivers are
themselves findings (``suppression-reason`` / ``stale-suppression``).
"""

from __future__ import annotations

import pathlib
from typing import Any, Dict, List

from ray_tpu_torch.tools.graftcheck.core import (
    SuppressionEntry, Violation, make_report, parse_suppression_entries,
    parse_suppressions, render_text, split_suppressed)
from ray_tpu_torch.tools.graftcheck.lint import (KNOWN_RULES,
                                                 kernel_modules,
                                                 lint_files, lint_repo,
                                                 lint_source)
from ray_tpu_torch.tools.graftcheck.races import THREAD_ROOTS
from ray_tpu_torch.tools.graftcheck.trace_audit import (
    ProgramSpec, audit_program, audit_programs, collect_shapes,
    logits_sized_shapes, trace_program)

__all__ = [
    "Violation", "ProgramSpec", "SuppressionEntry", "run_repo_check",
    "run_changed_check", "make_report",
    "render_text", "parse_suppressions", "parse_suppression_entries",
    "split_suppressed",
    "audit_program", "audit_programs", "trace_program", "collect_shapes",
    "logits_sized_shapes",
    "lint_repo", "lint_source", "lint_files", "kernel_modules",
    "KNOWN_RULES", "THREAD_ROOTS",
]


def run_repo_check(root=None, *, skip_trace: bool = False,
                   skip_lint: bool = False) -> Dict[str, Any]:
    """Run both engines over the repo at ``root`` (defaults to the
    checkout containing this package) and return the combined report
    dict (see :func:`core.make_report`).  ``report["ok"]`` is the CLI
    exit status; tier-1 asserts it on every run."""
    if root is None:
        root = pathlib.Path(__file__).resolve().parents[3]
    root = pathlib.Path(root)
    violations = []
    suppressed = 0
    files_scanned = 0
    infos: Dict[str, Dict[str, Any]] = {}
    if not skip_lint:
        lint_violations, stats = lint_repo(root)
        violations.extend(lint_violations)
        suppressed += stats["suppressed"]
        files_scanned = stats["files"]
    if not skip_trace:
        from ray_tpu_torch.tools.graftcheck.programs import default_programs

        trace_violations, infos = audit_programs(default_programs())
        violations.extend(trace_violations)
    return make_report(violations, suppressed=suppressed,
                       files_scanned=files_scanned, programs=infos)


def run_changed_check(root=None, *, rels: List[str]) -> Dict[str, Any]:
    """Per-file lint of an explicit changed-file list (the CLI's
    ``--changed <git-range>`` resolves the range to paths and calls
    this).  Skips the program auditor and the repo-level registry checks
    — this is the fast pre-commit path; the full run holds the line in
    CI."""
    if root is None:
        root = pathlib.Path(__file__).resolve().parents[3]
    violations, stats = lint_files(pathlib.Path(root), rels)
    return make_report(violations, suppressed=stats["suppressed"],
                       files_scanned=stats["files"])
