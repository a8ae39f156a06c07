"""The CLI: ``python -m ray_tpu_torch.tools.graftcheck`` (the
counterpart of ``python -m ray_tpu.tools.graftcheck``).

Exit status 0 iff no un-suppressed violation was found, so the
command drops straight into CI.  ``--format json`` prints the full
machine-readable report (the same dict ``run_repo_check`` returns);
``--format github`` prints ``::error`` workflow annotations.
``--changed <git-range>`` lints only the port's files the range
touches — the fast pre-commit path (repo-level registry checks and the
program auditor are skipped; the full run holds that line).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys


def _changed_files(git_range: str, root) -> list:
    """Repo-relative paths touched in ``git_range`` (``HEAD~1..HEAD``,
    ``main...``, or a single rev — anything diff accepts)."""
    out = subprocess.run(
        ["git", "diff", "--name-only", git_range],
        cwd=root, capture_output=True, text=True, check=True)
    return [line.strip() for line in out.stdout.splitlines()
            if line.strip()]


def _github_escape(text: str) -> str:
    """GitHub workflow-command data escaping (newlines become %0A)."""
    return (text.replace("%", "%25").replace("\r", "%0D")
            .replace("\n", "%0A"))


def render_github(report) -> str:
    """``::error file=...,line=...::[rule] message`` annotations, one
    per violation, plus a trailing notice with the totals."""
    lines = []
    for v in report["violations"]:
        where = ""
        if v.get("file"):
            where = f" file={_github_escape(v['file'])}"
            if v.get("line") is not None:
                where += f",line={v['line']}"
        msg = _github_escape(f"[{v['rule']}] {v['message']}")
        lines.append(f"::error{where}::{msg}")
    s = report["summary"]
    lines.append(
        f"::notice::graftcheck: {s['n_violations']} violation(s), "
        f"{s['n_suppressed']} suppressed, "
        f"{s['files_scanned']} files scanned")
    return "\n".join(lines)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m ray_tpu_torch.tools.graftcheck",
        description="Audit traced hot-path programs and lint the port "
                    "for hot-path invariant violations.")
    parser.add_argument(
        "--root", default=None,
        help="repo root to scan (default: the checkout containing "
             "the ray_tpu_torch package)")
    parser.add_argument(
        "--format", choices=("text", "json", "github"), default="text",
        help="report format (default: text; github emits ::error "
             "workflow annotations)")
    parser.add_argument(
        "--changed", metavar="GIT_RANGE", default=None,
        help="lint only package files touched in this git range "
             "(e.g. HEAD~1..HEAD or main...) — skips the program "
             "auditor and repo-level registry checks for pre-commit "
             "speed")
    parser.add_argument(
        "--skip-trace", action="store_true",
        help="skip the program auditor (lint only; no program runs)")
    parser.add_argument(
        "--skip-lint", action="store_true",
        help="skip the repo linter (programs only)")
    args = parser.parse_args(argv)

    from ray_tpu_torch.tools.graftcheck import (render_text,
                                                run_changed_check,
                                                run_repo_check)

    if args.changed is not None:
        import pathlib

        root = args.root or pathlib.Path(
            __file__).resolve().parents[3]
        try:
            rels = _changed_files(args.changed, root)
        except subprocess.CalledProcessError as e:
            sys.stderr.write(
                f"graftcheck: git diff failed for range "
                f"{args.changed!r}: {e.stderr.strip()}\n")
            return 2
        report = run_changed_check(root, rels=rels)
    else:
        report = run_repo_check(args.root, skip_trace=args.skip_trace,
                                skip_lint=args.skip_lint)
    if args.format == "json":
        json.dump(report, sys.stdout, indent=2, sort_keys=True)
        sys.stdout.write("\n")
    elif args.format == "github":
        print(render_github(report))
    else:
        print(render_text(report))
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
