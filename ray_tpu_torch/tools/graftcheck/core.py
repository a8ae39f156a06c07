"""graftcheck shared machinery: violations, suppressions, reports (the
counterpart of ``ray_tpu/tools/graftcheck/core.py``).

A check (program-audit rule or lint rule) produces :class:`Violation` records;
the runner filters them through per-line ``# graftcheck:
disable=<rule>(<reason>)[,<rule>(<reason>)...]`` suppressions and
assembles one report that both the text renderer and ``--format json``
consume.  Suppression is deliberate and visible: a disable comment on
the offending line (or on a standalone comment line directly above it)
names the rule it waives AND says why in the parenthesized reason, so
every waiver is grep-able and reviewable.  The linter's hygiene rules
(lint.py) flag a bare reason-less waiver (``suppression-reason``) and
a waiver that drops nothing (``stale-suppression``).
"""

from __future__ import annotations

import dataclasses
import io
import re
import tokenize
from typing import Any, Dict, List, Optional, Set, Tuple

#: one disable comment: ``disable=`` then one or more
#: ``<rule>(<reason>)`` entries (the reason is optional at PARSE time —
#: bare entries still suppress, the hygiene rule just flags them)
_DISABLE_RE = re.compile(
    r"#\s*graftcheck:\s*disable="
    r"((?:[a-z][a-z0-9\-]*(?:\([^)\n]*\))?\s*,?\s*)+)",
    re.IGNORECASE)
#: one ``<rule>`` or ``<rule>(<reason>)`` entry inside the group above
_ENTRY_RE = re.compile(r"([a-z][a-z0-9\-]*)(?:\(([^)\n]*)\))?",
                       re.IGNORECASE)


@dataclasses.dataclass
class Violation:
    """One invariant breach, from either engine."""

    rule: str
    message: str
    file: Optional[str] = None     # repo-relative path (lint)
    line: Optional[int] = None
    program: Optional[str] = None  # audited program name (trace)

    def location(self) -> str:
        if self.file is not None:
            where = self.file
            if self.line is not None:
                where += f":{self.line}"
            return where
        return f"<trace:{self.program}>" if self.program else "<repo>"

    def to_dict(self) -> Dict[str, Any]:
        out = {"rule": self.rule, "message": self.message}
        if self.file is not None:
            out["file"] = self.file
        if self.line is not None:
            out["line"] = self.line
        if self.program is not None:
            out["program"] = self.program
        return out

    def __str__(self) -> str:
        return f"{self.location()}: [{self.rule}] {self.message}"


def _parse_entry_group(group: str) -> Dict[str, Optional[str]]:
    """rule id -> reason (None when the entry carries no parens)."""
    return {m.group(1): m.group(2)
            for m in _ENTRY_RE.finditer(group)}


def parse_suppressions(source: str) -> Dict[int, Set[str]]:
    """1-based line -> set of rule ids disabled on that line.

    A disable comment sharing a line with code covers that line; a
    standalone comment line covers itself AND the next line, so wrapped
    statements can carry the waiver above them.  Reasons are accepted
    (``disable=rule(why)``) but not required here — the hygiene rule in
    lint.py enforces them."""
    out: Dict[int, Set[str]] = {}
    for lineno, text in enumerate(source.splitlines(), start=1):
        m = _DISABLE_RE.search(text)
        if not m:
            continue
        rules = set(_parse_entry_group(m.group(1)))
        out.setdefault(lineno, set()).update(rules)
        if text.lstrip().startswith("#"):
            out.setdefault(lineno + 1, set()).update(rules)
    return out


@dataclasses.dataclass
class SuppressionEntry:
    """One disable comment, as the hygiene rules see it."""

    line: int                         # the comment's own line
    covered: Tuple[int, ...]          # lines the waiver applies to
    rules: Dict[str, Optional[str]]   # rule id -> reason (None = bare)


def parse_suppression_entries(source: str) -> List[SuppressionEntry]:
    """Every disable comment in ``source`` with its coverage and
    per-rule reasons.  Token-based (COMMENT tokens only) so disable
    patterns quoted inside docstrings don't register as waivers for
    the hygiene rules; returns [] when the source doesn't tokenize
    (the parse-error violation covers that case)."""
    try:
        toks = list(tokenize.generate_tokens(
            io.StringIO(source).readline))
    except Exception:  # noqa: BLE001 - broken source: linter reports it
        return []
    entries: List[SuppressionEntry] = []
    for tok in toks:
        if tok.type != tokenize.COMMENT:
            continue
        m = _DISABLE_RE.search(tok.string)
        if not m:
            continue
        lineno = tok.start[0]
        standalone = tok.line.lstrip().startswith("#")
        covered = (lineno, lineno + 1) if standalone else (lineno,)
        entries.append(SuppressionEntry(
            line=lineno, covered=covered,
            rules=_parse_entry_group(m.group(1))))
    return entries


def is_suppressed(v: Violation,
                  suppressions: Dict[int, Set[str]]) -> bool:
    if v.line is None:
        return False
    rules = suppressions.get(v.line, ())
    return v.rule in rules or "all" in rules


def split_suppressed(violations: List[Violation],
                     suppressions: Dict[int, Set[str]]):
    """(kept, suppressed) partition of one file's violations."""
    kept, dropped = [], []
    for v in violations:
        (dropped if is_suppressed(v, suppressions) else kept).append(v)
    return kept, dropped


def make_report(violations: List[Violation], *,
                suppressed: int = 0,
                files_scanned: int = 0,
                programs: Optional[Dict[str, Dict[str, Any]]] = None
                ) -> Dict[str, Any]:
    """The machine-readable report (``--format json`` emits exactly
    this)."""
    return {
        "ok": not violations,
        "violations": [v.to_dict() for v in violations],
        "summary": {
            "n_violations": len(violations),
            "n_suppressed": suppressed,
            "files_scanned": files_scanned,
            "rules_failed": sorted({v.rule for v in violations}),
        },
        "programs": programs or {},
    }


def render_text(report: Dict[str, Any]) -> str:
    lines: List[str] = []
    for v in report["violations"]:
        where = v.get("file") or f"<trace:{v.get('program', '?')}>"
        if v.get("line") is not None:
            where += f":{v['line']}"
        lines.append(f"{where}: [{v['rule']}] {v['message']}")
    s = report["summary"]
    for name, info in sorted(report["programs"].items()):
        budget = info.get("hbm_budget_bytes")
        peak = info.get("peak_hbm_bytes")
        extra = ""
        if peak is not None:
            extra = f"  peak_hbm={peak / 2**20:.2f}MiB"
            if budget:
                extra += f" / budget={budget / 2**20:.2f}MiB"
        if info.get("skipped"):
            lines.append(f"skipped {name}: {info['skipped']}")
            continue
        lines.append(f"audited {name}: {info.get('ops', '?')} ops"
                     + extra)
    lines.append(
        f"graftcheck: {s['n_violations']} violation(s), "
        f"{s['n_suppressed']} suppressed, {s['files_scanned']} files, "
        f"{len(report['programs'])} programs audited")
    return "\n".join(lines)
