"""Perf ledger: persistent bench trajectory + regression gates.

A copy of ``ray_tpu/tools/perfledger.py`` for the port.  Every
``python -m ray_tpu_torch.bench`` run prints JSON metric lines, and
``tools/flightrec.py sweepjson`` prints ``SWEEPJSON`` records; this
module gives them a durable home and turns the accumulated trajectory
into CI-style verdicts:

    python -m ray_tpu_torch.tools.perfledger ingest bench_out.log
    python -m ray_tpu_torch.tools.perfledger check     # exit 1 on regress
    python -m ray_tpu_torch.tools.perfledger report    # markdown trends
    python -m ray_tpu_torch.tools.perfledger publish latest --baseline F

The port's ledger is its own file, ``BENCH_HISTORY_TORCH.jsonl`` at the
repo root (listed in .gitignore; ``RAYTPU_BENCH_HISTORY`` overrides
it): the repo's ``BENCH_HISTORY.jsonl`` holds the JAX package's TPU
and CPU series, which the port's numbers are never compared with.
``BASELINE.json`` is read for its ``published`` table, and nothing
here writes to it: ``publish`` takes another ``--baseline`` file.
``python -m ray_tpu_torch.bench`` appends automatically
(``--no-ledger`` opts out).

Ledger entries are one JSON object per line::

    {"recorded_at": ..., "source": "bench"|"sweep"|"ingest",
     "provenance": {"git_sha", "torch_version", "cuda_version",
                    "backend", "device_kind", "hostname"},
     "record": {...original bench/sweep record...},
     "metrics": {name: {"value": v, "unit": u,
                        "higher_is_better": bool}}}

``metrics`` is flattened at append time: bench lines contribute their
``metric`` name directly; sweep records contribute one series per
numeric field, keyed by the variant's canonical hash so e.g. the
``[32, {"remat_policy": "dots_nb"}]`` series never gets compared
against ``[24, {}]``.  Direction is inferred from the name (latencies —
``*_ms`` / ``ttft`` — regress upward; throughput/MFU/hit-rates regress
downward).

``check`` compares the newest point of every series against the
previous point and against ``BASELINE.json``'s ``published`` table
(empty today — the comparison is skipped until someone publishes
numbers) with a relative tolerance band (default 5%), and exits
nonzero when anything regresses — the gate ROADMAP item 3's MFU push
reports through.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import time
from typing import Any, Dict, Iterable, List, Optional, Tuple

DEFAULT_TOLERANCE = 0.05

#: numeric fields of a sweep record that form trend series (anything
#: else in the record is context, not a measurement)
_SWEEP_FIELDS = (
    "tok_s_chip", "mfu", "mfu_xla", "prefill_ttft_ms", "decode_tok_s",
    "decode_tok_s_chip", "prefix_hit_rate", "slo_attainment",
    "ttft_slo_attainment", "e2e_slo_attainment", "spec_accept_rate",
    "latency_p50_ms", "latency_p95_ms",
    # traffic_fleet records: router-pooled hit rate + per-tenant
    # attainment (all fractions — higher is better via the
    # slo_attainment override, including the ttft-named ones)
    "router_prefix_hit_rate",
    "interactive_ttft_slo_attainment",
    "interactive_e2e_slo_attainment",
    "batch_ttft_slo_attainment", "batch_e2e_slo_attainment",
    # tracebus per-token anatomy (itl = inter-token latency, ms →
    # lower is better via the _ms suffix; no override applies)
    "itl_ms_p50", "itl_ms_p99",
    # chunked-prefill A/B (round 14): per-tenant TTFT p99 under the
    # long-prompt mixture — "ttft"/"_ms" mark these lower-is-better
    # (unlike the *_ttft_slo_attainment fractions above)
    "interactive_ttft_ms_p99", "batch_ttft_ms_p99",
    # trainwatch (train/goodput.py): productive-device-time ratio
    # (higher via the goodput override) + input-stall percentiles
    "train_goodput", "train_data_wait_ms_p50", "train_data_wait_ms_p99",
    # kvscope (serve/kvscope.py): KV pool pressure + cache-thrash
    # waste — both fractions where SMALLER is better ("occupancy" /
    # "waste" below; no higher-is-better override contains either)
    "kv_occupancy_p95", "reprefill_waste_frac",
    # tiered host-RAM KV cache (serve/kv_tier.py): fraction of
    # second-chance probes the tier absorbed — higher is better via
    # the "hit_rate" override below
    "kv_tier_hit_rate",
    # disaggregated prefill/decode (traffic_disagg records): tail
    # cost of the block-granular KV handoff hop — "_ms" marks it
    # lower-is-better
    "handoff_ms_p99",
    # healthwatch (serve/health.py, traffic_chaos records): fault
    # injection → DEAD-transition latency — "_ms" marks it
    # lower-is-better (detection latency is the Podracer-style
    # first-class fleet metric)
    "time_to_detect_ms",
)

#: substrings marking a metric where SMALLER is better
_LOWER_IS_BETTER = ("_ms", "ttft", "latency", "_bytes", "compile",
                    "occupancy", "waste")

#: substrings that trump _LOWER_IS_BETTER: "ttft_slo_attainment"
#: contains "ttft" but is a fraction where BIGGER is better,
#: "goodput" is a productive-time fraction regardless of neighbors,
#: and "hit_rate" covers prefix/router/kv-tier cache hit fractions
_HIGHER_OVERRIDES = ("slo_attainment", "accept_rate", "goodput",
                     "hit_rate")

#: substrings marking a metric where BIGGER is better in its own right
#: (throughput and utilization).  Every _SWEEP_FIELDS entry must match
#: at least one token across the three tuples — graftcheck's
#: perfledger-direction rule enforces it, so a new sweep field whose
#: name resolves to no explicit direction (the near-miss class PR
#: 10/13 each fixed by hand) fails lint instead of silently getting
#: "higher" by fallthrough.
_HIGHER_IS_BETTER = ("tok_s", "mfu")


def repo_root() -> str:
    """The repo checkout this installed/source tree lives in (ledger
    and BASELINE.json live at its root)."""
    return os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))


#: the port's default ledger, beside (never instead of) the repo's
#: BENCH_HISTORY.jsonl of the JAX package
HISTORY_FILE = "BENCH_HISTORY_TORCH.jsonl"


def history_path(path: Optional[str] = None) -> str:
    if path:
        return path
    env = os.environ.get("RAYTPU_BENCH_HISTORY")
    if env:
        return env
    return os.path.join(repo_root(), HISTORY_FILE)


def baseline_path(path: Optional[str] = None) -> str:
    return path or os.path.join(repo_root(), "BASELINE.json")


def _is_repo_baseline(path: str) -> bool:
    return os.path.abspath(path) == os.path.abspath(
        os.path.join(repo_root(), "BASELINE.json"))


def higher_is_better(name: str) -> bool:
    low = name.lower()
    if any(tok in low for tok in _HIGHER_OVERRIDES):
        return True
    if any(tok in low for tok in _LOWER_IS_BETTER):
        return False
    # explicit throughput/utilization tokens and the free-form
    # fallthrough both resolve higher; the distinction matters to the
    # perfledger-direction lint, which accepts only explicit matches
    # for _SWEEP_FIELDS entries
    return True


def explicit_direction(name: str) -> Optional[bool]:
    """True/False when ``name`` matches an explicit direction token,
    None when it would only resolve by fallthrough.  graftcheck's
    perfledger-direction rule requires every _SWEEP_FIELDS entry to
    resolve explicitly."""
    low = name.lower()
    if any(tok in low for tok in _HIGHER_OVERRIDES):
        return True
    if any(tok in low for tok in _LOWER_IS_BETTER):
        return False
    if any(tok in low for tok in _HIGHER_IS_BETTER):
        return True
    return None


def _variant_key(variant: Dict[str, Any]) -> str:
    """Stable 8-hex identity for one sweep variant (mode + every knob),
    so series only ever compare like-for-like configurations."""
    canon = json.dumps(variant, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(canon.encode()).hexdigest()[:8]


def extract_metrics(record: Dict[str, Any]) -> Dict[str, Dict[str, Any]]:
    """Flatten one bench / sweep record into named numeric series."""
    out: Dict[str, Dict[str, Any]] = {}
    if "metric" in record and isinstance(
            record.get("value"), (int, float)):
        name = str(record["metric"])
        out[name] = {"value": float(record["value"]),
                     "unit": record.get("unit"),
                     "higher_is_better": higher_is_better(name)}
        return out
    variant = record.get("sweep")
    if isinstance(variant, dict) and "failed" not in record:
        mode = variant.get("mode", "train")
        vk = _variant_key(variant)
        for field in _SWEEP_FIELDS:
            val = record.get(field)
            if isinstance(val, (int, float)):
                name = f"sweep.{mode}.{field}#{vk}"
                out[name] = {"value": float(val), "unit": None,
                             "higher_is_better": higher_is_better(field)}
    return out


# ---------------------------------------------------------------------------
# ingest
# ---------------------------------------------------------------------------

def parse_text(text: str) -> List[Dict[str, Any]]:
    """Recover bench/sweep records from arbitrary captured output:
    bench JSON lines, ``SWEEPJSON``-prefixed lines, whole-file JSON
    (including the historical ``BENCH_rNN.json`` wrappers whose payload
    sits under ``parsed``), or lists of any of those.  Non-records are
    skipped, never fatal."""

    def _norm(obj: Any) -> List[Dict[str, Any]]:
        if isinstance(obj, list):
            return [r for item in obj for r in _norm(item)]
        if not isinstance(obj, dict):
            return []
        if isinstance(obj.get("parsed"), dict):
            return _norm(obj["parsed"])
        if "metric" in obj or "sweep" in obj:
            return [obj]
        return []

    try:
        return _norm(json.loads(text))
    except ValueError:
        pass
    records: List[Dict[str, Any]] = []
    for line in text.splitlines():
        line = line.strip()
        if line.startswith("SWEEPJSON "):
            line = line[len("SWEEPJSON "):]
        if not line.startswith("{"):
            continue
        try:
            records.extend(_norm(json.loads(line)))
        except ValueError:
            continue
    return records


_provenance_cache: Optional[Dict[str, Any]] = None


def provenance() -> Dict[str, Any]:
    """Where/what produced a ledger record: git SHA, torch and CUDA
    versions, backend + device kind, hostname.  Stamped on every entry
    at ``append_records`` time so series across runs are honestly
    comparable — the autopilot's staleness logic keys off the SHA, and
    its CPU-vs-card gating off the backend.  Every field is best-effort
    ``None``.  torch is read only when it is ALREADY imported
    (ingesting a log must not drag it up just to stamp it); the backend
    is "cuda" when this process has initialised CUDA (it ran on the
    card: ``torch.cuda.get_device_name`` of its device is the kind),
    else "cpu".  Cached per process."""
    global _provenance_cache
    if _provenance_cache is not None:
        return dict(_provenance_cache)
    import socket
    import subprocess

    out: Dict[str, Any] = {"git_sha": None, "torch_version": None,
                           "cuda_version": None, "backend": None,
                           "device_kind": None, "hostname": None}
    try:
        r = subprocess.run(["git", "-C", repo_root(), "rev-parse",
                            "--short", "HEAD"],
                           capture_output=True, text=True, timeout=10)
        if r.returncode == 0:
            out["git_sha"] = r.stdout.strip() or None
    except Exception:  # noqa: BLE001 - no git / not a checkout
        pass
    torch = sys.modules.get("torch")
    if torch is not None:
        out["torch_version"] = str(torch.__version__)
        out["cuda_version"] = torch.version.cuda
        try:
            if torch.cuda.is_initialized():
                out["backend"] = "cuda"
                out["device_kind"] = torch.cuda.get_device_name(
                    torch.cuda.current_device())
            else:
                out["backend"] = "cpu"
        except Exception:  # noqa: BLE001 - a broken CUDA install
            pass
    try:
        out["hostname"] = socket.gethostname()
    except Exception:  # noqa: BLE001
        pass
    _provenance_cache = dict(out)
    return out


def append_records(records: Iterable[Dict[str, Any]], source: str,
                   path: Optional[str] = None) -> int:
    """Append each record (with its flattened metric series and the
    process provenance stamp) as one ledger line; returns how many
    lines landed.  Records with no numeric series (audit summaries,
    failures) are kept too — they document the trajectory — but
    contribute nothing to ``check``."""
    path = history_path(path)
    stamp = time.strftime("%Y-%m-%d %H:%M:%S")
    prov = provenance()
    n = 0
    with open(path, "a") as f:
        for rec in records:
            if not isinstance(rec, dict):
                continue
            entry = {"recorded_at": stamp, "source": source,
                     "provenance": prov,
                     "record": rec, "metrics": extract_metrics(rec)}
            f.write(json.dumps(entry, sort_keys=True) + "\n")
            n += 1
    return n


def load_history(path: Optional[str] = None) -> List[Dict[str, Any]]:
    path = history_path(path)
    entries: List[Dict[str, Any]] = []
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    obj = json.loads(line)
                except ValueError:
                    continue
                if isinstance(obj, dict):
                    entries.append(obj)
    except OSError:
        pass
    return entries


def metric_series(entries: List[Dict[str, Any]]
                  ) -> Dict[str, List[Tuple[int, Dict[str, Any]]]]:
    """name -> [(entry_index, {"value", "unit", "higher_is_better"})]
    in ledger order."""
    series: Dict[str, List[Tuple[int, Dict[str, Any]]]] = {}
    for i, entry in enumerate(entries):
        for name, m in (entry.get("metrics") or {}).items():
            if isinstance(m, dict) and isinstance(
                    m.get("value"), (int, float)):
                series.setdefault(name, []).append((i, m))
    return series


# ---------------------------------------------------------------------------
# check
# ---------------------------------------------------------------------------

def _classify(new: float, ref: float, better: bool,
              tolerance: float) -> Tuple[str, float]:
    """(verdict, relative_delta) of `new` vs `ref` under a relative
    tolerance band.  delta is signed in the metric's raw direction."""
    if ref == 0:
        delta = 0.0 if new == 0 else float("inf") * (1 if new > 0 else -1)
    else:
        delta = (new - ref) / abs(ref)
    gain = delta if better else -delta
    if gain < -tolerance:
        return "regress", delta
    if gain > tolerance:
        return "improve", delta
    return "flat", delta


def load_baseline(path: Optional[str] = None) -> Dict[str, float]:
    """BASELINE.json's ``published`` table as {metric: value}; empty
    when nothing is published (the common case today) — then the
    baseline comparison is skipped, not failed."""
    try:
        with open(baseline_path(path)) as f:
            pub = json.load(f).get("published") or {}
    except Exception:  # noqa: BLE001 - missing/invalid baseline file
        return {}
    return {k: float(v) for k, v in pub.items()
            if isinstance(v, (int, float))}


def check(history: Optional[str] = None,
          baseline: Optional[str] = None,
          tolerance: float = DEFAULT_TOLERANCE) -> Dict[str, Any]:
    """Verdict for the newest point of every metric series vs its
    previous point and vs the published baseline.  ``ok`` is False iff
    anything regressed beyond the tolerance band."""
    entries = load_history(history)
    series = metric_series(entries)
    published = load_baseline(baseline)
    verdicts: Dict[str, Any] = {}
    ok = True
    for name, points in sorted(series.items()):
        idx, cur = points[-1]
        v: Dict[str, Any] = {"value": cur["value"],
                             "unit": cur.get("unit"),
                             "higher_is_better": cur["higher_is_better"],
                             "entry": idx, "n_points": len(points)}
        if len(points) >= 2:
            prev = points[-2][1]["value"]
            verdict, delta = _classify(cur["value"], prev,
                                       cur["higher_is_better"],
                                       tolerance)
            v.update(prev=prev, delta=round(delta, 4), verdict=verdict)
        else:
            v.update(prev=None, delta=None, verdict="new")
        if name in published:
            bverdict, bdelta = _classify(cur["value"], published[name],
                                         cur["higher_is_better"],
                                         tolerance)
            v.update(baseline=published[name],
                     vs_baseline=round(bdelta, 4),
                     baseline_verdict=bverdict)
            if bverdict == "regress":
                ok = False
        if v["verdict"] == "regress":
            ok = False
        verdicts[name] = v
    return {"ok": ok, "tolerance": tolerance,
            "entries": len(entries), "verdicts": verdicts}


# ---------------------------------------------------------------------------
# report
# ---------------------------------------------------------------------------

def _fmt(v: Any) -> str:
    if v is None:
        return "—"
    if isinstance(v, float):
        return f"{v:,.4g}" if abs(v) < 1000 else f"{v:,.0f}"
    return str(v)


def report(history: Optional[str] = None,
           baseline: Optional[str] = None,
           tolerance: float = DEFAULT_TOLERANCE) -> str:
    """Markdown trend table over the whole ledger."""
    entries = load_history(history)
    result = check(history, baseline, tolerance)
    lines = [
        "# Perf ledger trend report",
        "",
        f"{len(entries)} ledger entries, "
        f"{len(result['verdicts'])} metric series, "
        f"tolerance ±{tolerance:.0%}.",
        "",
        "| metric | points | previous | latest | delta | verdict |",
        "|---|---:|---:|---:|---:|---|",
    ]
    for name, v in result["verdicts"].items():
        delta = ("—" if v["delta"] is None
                 else f"{v['delta']:+.1%}")
        arrow = {"improve": "improve ✅", "regress": "regress ❌",
                 "flat": "flat", "new": "new"}[v["verdict"]]
        lines.append(f"| `{name}` | {v['n_points']} "
                     f"| {_fmt(v['prev'])} | {_fmt(v['value'])} "
                     f"| {delta} | {arrow} |")
    lines.append("")
    if not any(v.get("baseline") is not None
               for v in result["verdicts"].values()):
        lines.append("No published baselines in BASELINE.json "
                     "(`published: {}`) — verdicts are vs the previous "
                     "ledger point only.")
    lines.append("")
    lines.append("ok" if result["ok"] else
                 "REGRESSIONS DETECTED — see verdicts above.")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# publish
# ---------------------------------------------------------------------------

def entry_backend(entry: Dict[str, Any]) -> Optional[str]:
    """Best available backend label for one ledger entry: the
    provenance stamp when present (post round-12 entries), else the
    bench record's own ``detail.backend``."""
    prov = entry.get("provenance") or {}
    if prov.get("backend"):
        return str(prov["backend"])
    rec = entry.get("record") or {}
    detail = rec.get("detail") if isinstance(rec, dict) else None
    if isinstance(detail, dict) and detail.get("backend"):
        return str(detail["backend"])
    return None


def publish(selector: str = "latest",
            history: Optional[str] = None,
            baseline: Optional[str] = None,
            allow_cpu: bool = False,
            dry_run: bool = False) -> Dict[str, Any]:
    """Promote one ledger entry's metrics into BASELINE.json's
    ``published`` table — the act that arms the baseline gate ``check``
    has been skipping while the table sat empty.

    ``selector`` is a 0-based history index or ``latest`` (the newest
    entry that carries metrics).  CPU-backend entries are refused
    unless ``allow_cpu`` — a laptop smoke number must never become the
    bar the card's runs are graded against.  ``dry_run`` computes
    the diff without writing.  The repo's ``BASELINE.json`` is the JAX
    package's and is never written: a publish that would write it is
    refused (name another ``baseline`` file).  Returns ``{entry,
    backend, diff, written}``; raises ValueError on a bad selector or
    a refused publish."""
    entries = load_history(history)
    with_metrics = [(i, e) for i, e in enumerate(entries)
                    if e.get("metrics")]
    if not with_metrics:
        raise ValueError("ledger has no entries with metrics")
    if selector == "latest":
        idx, entry = with_metrics[-1]
    else:
        idx = int(selector)
        if not 0 <= idx < len(entries):
            raise ValueError(f"history index {idx} out of range "
                             f"(0..{len(entries) - 1})")
        entry = entries[idx]
        if not entry.get("metrics"):
            raise ValueError(f"history entry {idx} carries no metrics "
                             f"(source={entry.get('source')!r})")
    backend = entry_backend(entry)
    if backend == "cpu" and not allow_cpu:
        raise ValueError(
            f"history entry {idx} was measured on the CPU backend — "
            f"refusing to publish a smoke number as the baseline "
            f"(pass --allow-cpu to override)")
    bpath = baseline_path(baseline)
    if not dry_run and _is_repo_baseline(bpath):
        raise ValueError(
            f"{bpath} is the JAX package's baseline and is read, never "
            f"written, by the port: pass --baseline <file> to publish")
    try:
        with open(bpath) as f:
            data = json.load(f)
    except Exception:  # noqa: BLE001 - missing/invalid baseline file
        data = {}
    published = dict(data.get("published") or {})
    diff: Dict[str, Any] = {}
    for name, m in sorted(entry["metrics"].items()):
        if not isinstance(m, dict) or not isinstance(
                m.get("value"), (int, float)):
            continue
        new = float(m["value"])
        old = published.get(name)
        if old != new:
            diff[name] = {"old": old, "new": new}
        published[name] = new
    if not dry_run:
        data["published"] = published
        tmp = bpath + ".tmp"
        with open(tmp, "w") as f:
            json.dump(data, f, indent=2)
            f.write("\n")
        os.replace(tmp, bpath)
    return {"entry": idx, "backend": backend, "diff": diff,
            "published": published, "written": not dry_run,
            "baseline_path": bpath}


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m ray_tpu_torch.tools.perfledger",
        description="persistent bench/sweep trajectory with "
                    "regression gates")
    ap.add_argument("--history", default=None,
                    help=f"ledger path (default: <repo>/{HISTORY_FILE}"
                         ", env RAYTPU_BENCH_HISTORY overrides)")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p_in = sub.add_parser("ingest",
                          help="parse bench/sweep output into the "
                               "ledger")
    p_in.add_argument("files", nargs="*",
                      help="bench logs / JSON files ('-' or empty = "
                           "stdin)")
    p_in.add_argument("--source", default="ingest")
    p_chk = sub.add_parser("check",
                           help="exit 1 when the newest point of any "
                                "series regressed")
    p_chk.add_argument("--baseline", default=None)
    p_chk.add_argument("--tolerance", type=float,
                       default=DEFAULT_TOLERANCE)
    p_rep = sub.add_parser("report", help="markdown trend report")
    p_rep.add_argument("--baseline", default=None)
    p_rep.add_argument("--tolerance", type=float,
                       default=DEFAULT_TOLERANCE)
    p_rep.add_argument("--out", default="",
                       help="write the report here as well as stdout")
    p_pub = sub.add_parser(
        "publish",
        help="promote one entry's metrics into a baseline file's "
             "'published' table (arms the baseline gate; never the "
             "repo's BASELINE.json)")
    p_pub.add_argument("selector", nargs="?", default="latest",
                       help="0-based history index, or 'latest' "
                            "(newest entry with metrics)")
    p_pub.add_argument("--baseline", default=None)
    p_pub.add_argument("--allow-cpu", action="store_true",
                       help="publish even a CPU-backend record "
                            "(refused by default: a smoke number must "
                            "not become the card's bar)")
    p_pub.add_argument("--dry-run", action="store_true",
                       help="print the diff without writing the "
                            "baseline file")
    args = ap.parse_args(argv)

    if args.cmd == "ingest":
        records: List[Dict[str, Any]] = []
        if not args.files or args.files == ["-"]:
            records.extend(parse_text(sys.stdin.read()))
        else:
            for fname in args.files:
                try:
                    with open(fname) as f:
                        records.extend(parse_text(f.read()))
                except OSError as e:
                    print(f"perfledger: skipping {fname}: {e}",
                          file=sys.stderr)
        n = append_records(records, source=args.source,
                           path=args.history)
        print(f"perfledger: appended {n} record(s) to "
              f"{history_path(args.history)}")
        return 0

    if args.cmd == "check":
        result = check(args.history, args.baseline, args.tolerance)
        print(json.dumps(result, indent=1, sort_keys=True))
        return 0 if result["ok"] else 1

    if args.cmd == "publish":
        try:
            res = publish(args.selector, history=args.history,
                          baseline=args.baseline,
                          allow_cpu=args.allow_cpu,
                          dry_run=args.dry_run)
        except ValueError as e:
            print(f"perfledger: publish refused: {e}", file=sys.stderr)
            return 2
        verb = "would publish" if args.dry_run else "published"
        print(f"perfledger: {verb} entry {res['entry']} "
              f"(backend={res['backend']}) -> {res['baseline_path']}")
        for name, d in sorted(res["diff"].items()):
            print(f"  {name}: {_fmt(d['old'])} -> {_fmt(d['new'])}")
        if not res["diff"]:
            print("  (no changes — already published)")
        return 0

    text = report(args.history, args.baseline, args.tolerance)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
