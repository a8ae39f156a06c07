"""Repo-level registry checks: ``contract-registry`` and
``perfledger-direction`` (the counterpart of
``ray_tpu/tools/graftcheck/contracts.py``, over the port's files).

Same shape as lint.py's observatory-mapping / autopilot-attribution
rules — import the live registries, diff them, and report any drift as
violations (an import failure IS the finding).

``contract-registry`` single-sources the exact-sum critical path:
``serve/telemetry.py``'s ``CRITICAL_PATH_COMPONENTS`` is the registry,
and every member must stay pinned in each downstream view —

* the tracebus span taxonomy (``tools/tracebus.py``'s
  ``COMPONENT_SPANS`` maps every component to its span name, and each
  named span must still be emitted by ``build_request_spans``);
* the engine-stats golden schema
  (``tests/test_torch_engine_stats.py``'s ``CRITICAL_PATH_KEYS`` ==
  components + ``e2e_ms``, read by ast so the test stays the single
  literal);
* traffic's TTFT decomposition (``serve/traffic.py``'s
  ``_TTFT_COMPONENTS`` is a subset);
* the docs tables: the port keeps no docs tree, so its tables are the
  module docstrings of the two registries — ``serve/telemetry.py``
  names every component and ``train/goodput.py`` every trainwatch
  ``ANATOMY_COMPONENTS`` leg verbatim.

``perfledger-direction``: every ``_SWEEP_FIELDS`` entry of the port's
``tools/perfledger.py`` must resolve to an explicit higher/lower
direction token — a field that would only get a direction by
fallthrough fails lint.
"""

from __future__ import annotations

import ast
import pathlib
from typing import List

from ray_tpu_torch.tools.graftcheck.core import Violation

__all__ = ["contract_registry", "perfledger_direction"]


def _schema_critical_path_keys(root: pathlib.Path):
    """CRITICAL_PATH_KEYS set literal out of the golden-schema test,
    by ast — importing a test module would execute pytest plumbing."""
    path = root / "tests" / "test_torch_engine_stats.py"
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in tree.body:
        if isinstance(node, ast.Assign) \
                and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and node.targets[0].id == "CRITICAL_PATH_KEYS":
            return set(ast.literal_eval(node.value))
    return None


def contract_registry(root) -> List[Violation]:
    root = pathlib.Path(root)
    try:
        from ray_tpu_torch.serve.telemetry import CRITICAL_PATH_COMPONENTS
        from ray_tpu_torch.serve.traffic import _TTFT_COMPONENTS
        from ray_tpu_torch.tools.tracebus import COMPONENT_SPANS
        from ray_tpu_torch.train.goodput import ANATOMY_COMPONENTS
    except Exception as e:  # noqa: BLE001 - import failure IS the finding
        return [Violation(
            "contract-registry",
            f"critical-path registry unavailable: "
            f"{type(e).__name__}: {e}",
            file="ray_tpu_torch/serve/telemetry.py")]
    comps = list(CRITICAL_PATH_COMPONENTS)
    out: List[Violation] = []

    # -- tracebus span taxonomy ----------------------------------------
    tb_file = "ray_tpu_torch/tools/tracebus.py"
    for c in comps:
        if c not in COMPONENT_SPANS:
            out.append(Violation(
                "contract-registry",
                f"critical-path component '{c}' has no COMPONENT_SPANS "
                f"entry — map it to its tracebus span (or None for a "
                f"derived leg)", file=tb_file))
    for c, span in COMPONENT_SPANS.items():
        if c not in comps:
            out.append(Violation(
                "contract-registry",
                f"COMPONENT_SPANS entry '{c}' is not a "
                f"CRITICAL_PATH_COMPONENTS member — stale mapping",
                file=tb_file))
    tb_path = root / tb_file
    # a synthetic --root (tests, --changed worktrees) may not carry
    # the source files — the registries above came from the installed
    # package either way, so only the source-text checks are skipped
    tb_src = tb_path.read_text() if tb_path.exists() else None
    for c, span in COMPONENT_SPANS.items():
        # the span name must appear beyond the mapping itself — i.e.
        # build_request_spans still emits it
        if tb_src is not None and span is not None \
                and tb_src.count(f'"{span}"') < 2:
            out.append(Violation(
                "contract-registry",
                f"COMPONENT_SPANS['{c}'] -> '{span}' but "
                f"build_request_spans never emits a '{span}' span — "
                f"the trace view of this leg went dark", file=tb_file))

    # -- engine-stats golden schema ------------------------------------
    schema_file = "tests/test_torch_engine_stats.py"
    keys = None
    if (root / schema_file).exists():
        try:
            keys = _schema_critical_path_keys(root)
        except Exception as e:  # noqa: BLE001 - unreadable IS the finding
            out.append(Violation(
                "contract-registry",
                f"golden schema unreadable: {type(e).__name__}: {e}",
                file=schema_file))
        else:
            if keys is None:
                out.append(Violation(
                    "contract-registry",
                    "golden schema defines no CRITICAL_PATH_KEYS "
                    "literal", file=schema_file))
    if keys is not None:
        want = {"e2e_ms"} | set(comps)
        for c in sorted(want - keys):
            out.append(Violation(
                "contract-registry",
                f"critical-path key '{c}' missing from the golden "
                f"schema's CRITICAL_PATH_KEYS", file=schema_file))
        for c in sorted(keys - want):
            out.append(Violation(
                "contract-registry",
                f"golden-schema key '{c}' is not e2e_ms or a "
                f"CRITICAL_PATH_COMPONENTS member — stale schema",
                file=schema_file))

    # -- traffic TTFT decomposition ------------------------------------
    for c in _TTFT_COMPONENTS:
        if c not in comps:
            out.append(Violation(
                "contract-registry",
                f"_TTFT_COMPONENTS entry '{c}' is not a "
                f"CRITICAL_PATH_COMPONENTS member",
                file="ray_tpu_torch/serve/traffic.py"))

    # -- docs tables: the registries' module docstrings ---------------
    for doc_file, names, what in (
            ("ray_tpu_torch/serve/telemetry.py", comps,
             "critical-path component"),
            ("ray_tpu_torch/train/goodput.py", ANATOMY_COMPONENTS,
             "trainwatch anatomy leg")):
        path = root / doc_file
        if not path.exists():
            continue
        doc = ast.get_docstring(ast.parse(path.read_text())) or ""
        for name in names:
            if f"`{name}`" not in doc:
                out.append(Violation(
                    "contract-registry",
                    f"{what} '{name}' is not documented in {doc_file}'s "
                    f"module docstring — add it to its table",
                    file=doc_file))
    return out


def perfledger_direction(root) -> List[Violation]:
    pl_file = "ray_tpu_torch/tools/perfledger.py"
    try:
        from ray_tpu_torch.tools.perfledger import (_SWEEP_FIELDS,
                                                    explicit_direction)
    except Exception as e:  # noqa: BLE001 - import failure IS the finding
        return [Violation(
            "perfledger-direction",
            f"perfledger direction registry unavailable: "
            f"{type(e).__name__}: {e}", file=pl_file)]
    out: List[Violation] = []
    for field in _SWEEP_FIELDS:
        if explicit_direction(field) is None:
            out.append(Violation(
                "perfledger-direction",
                f"_SWEEP_FIELDS entry '{field}' resolves to no "
                f"explicit higher/lower-is-better token — the ledger "
                f"would call regressions improvements by fallthrough; "
                f"add a token to _LOWER_IS_BETTER / _HIGHER_IS_BETTER "
                f"/ _HIGHER_OVERRIDES", file=pl_file))
    return out
