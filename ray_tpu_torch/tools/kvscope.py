"""kvscope CLI — inspect KV-cache & HBM observatory snapshots.

A copy of ``ray_tpu/tools/kvscope.py`` for the port; the snapshot
format is the JAX package's, so either package's snapshots read here.

    python -m ray_tpu_torch.tools.kvscope report   SNAPSHOT
    python -m ray_tpu_torch.tools.kvscope timeline SNAPSHOT [--engine NAME]
    python -m ray_tpu_torch.tools.kvscope export   SNAPSHOT [-o trace.json]

``SNAPSHOT`` is a JSON file carrying one or more ``kv_scope`` blocks
(serve/kvscope.py shape), accepted in any of the forms the stack
emits: a bare block, an ``engine_stats()`` dump, or the dashboard's
``/api/serve/kvscope`` map of ``{deployment: {"kv_scope": ...}}``.

``report`` prints the occupancy / forensics / HBM-ledger summary;
``timeline`` renders the occupancy ring as a text strip chart (one
row per engine wave); ``export`` writes a chrome-trace with counter
lanes (``ph: "C"``) — load it next to a tracebus export and the pool
pressure curve lines up under the request spans that caused it.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, List, Optional

from ray_tpu_torch._private.telemetry import (process_name_event,
                                        write_chrome_trace)


def load_snapshot(path: str) -> Dict[str, Dict[str, Any]]:
    """Normalize any supported snapshot form to ``{name: kv_scope}``.

    Raises ValueError when no kv_scope block can be found, naming the
    keys that were present (the usual failure is passing a tracebus
    dump here by mistake).
    """
    with open(path) as f:
        obj = json.load(f)
    if not isinstance(obj, dict):
        raise ValueError(f"snapshot root must be a JSON object, got "
                         f"{type(obj).__name__}")
    if "occupancy" in obj and "forensics" in obj:   # bare block
        return {"engine": obj}
    if isinstance(obj.get("kv_scope"), dict):       # engine_stats dump
        return {str(obj.get("deployment", "engine")): obj["kv_scope"]}
    out: Dict[str, Dict[str, Any]] = {}             # dashboard map
    for name, blk in obj.items():
        if not isinstance(blk, dict):
            continue
        if isinstance(blk.get("kv_scope"), dict):
            out[str(name)] = blk["kv_scope"]
        elif "occupancy" in blk and "forensics" in blk:
            out[str(name)] = blk
    if not out:
        raise ValueError(
            f"no kv_scope block in snapshot (top-level keys: "
            f"{sorted(obj)[:8]})")
    return out


def _fmt_bytes(n: Optional[int]) -> str:
    if n is None:
        return "-"
    sign, n = ("-", -n) if n < 0 else ("", n)
    for unit in ("B", "KiB", "MiB", "GiB"):
        if n < 1024 or unit == "GiB":
            return (f"{sign}{n:.1f} {unit}" if unit != "B"
                    else f"{sign}{n} B")
        n /= 1024.0
    return f"{sign}{n:.1f} GiB"


# ---------------------------------------------------------------------------
# report
# ---------------------------------------------------------------------------

def report_lines(scopes: Dict[str, Dict[str, Any]]) -> List[str]:
    lines: List[str] = []
    for name, blk in sorted(scopes.items()):
        occ = blk.get("occupancy") or {}
        fx = blk.get("forensics") or {}
        lines.append(
            f"{name}: kvscope "
            f"{'enabled' if blk.get('enabled') else 'DISABLED'}")
        lines.append(
            f"  occupancy: {occ.get('occupancy_ratio', 0.0):.1%} now, "
            f"p95 {occ.get('occupancy_p95', 0.0):.1%} over "
            f"{occ.get('samples', 0)} waves, fragmentation "
            f"{occ.get('fragmentation', 0.0):.1%}")
        waste = fx.get("reprefill_waste_tokens", 0)
        lines.append(
            f"  re-prefill waste: {waste} tokens "
            f"({fx.get('reprefill_waste_frac', 0.0):.1%} of "
            f"{fx.get('prefill_tokens', 0)} prefilled) across "
            f"{fx.get('reprefill_events', 0)} events; "
            f"{fx.get('keys_evicted', 0)} keys evicted "
            f"({fx.get('keys_tracked', 0)} tracked, "
            f"{fx.get('keys_forgotten', 0)} forgotten)")
        by_tenant = fx.get("waste_by_tenant") or {}
        for tenant, tok in sorted(by_tenant.items(),
                                  key=lambda kv: -kv[1]):
            share = tok / waste if waste else 0.0
            lines.append(f"    tenant {tenant:<12} {tok:>8} tokens "
                         f"{share:>6.1%}")
        for row in fx.get("top_keys") or []:
            lines.append(
                f"    key {row.get('key_prefix')}… "
                f"(len {row.get('key_len')}): "
                f"{row.get('tokens')} tokens re-filled")
        blocks = blk.get("blocks_by_tenant") or {}
        if blocks:
            lines.append("  live blocks by tenant: " + ", ".join(
                f"{t}={n}" for t, n in sorted(blocks.items())))
        ledger = blk.get("hbm_ledger") or {}
        rows = ledger.get("per_chip") or []
        if rows:
            lines.append(
                f"  hbm ledger (min headroom "
                f"{_fmt_bytes(ledger.get('min_headroom_bytes'))}):")
            for r in rows:
                lines.append(
                    f"    chip {r.get('id')} [{r.get('platform')}]: "
                    f"limit {_fmt_bytes(r.get('bytes_limit'))}, "
                    f"in use {_fmt_bytes(r.get('bytes_in_use'))}, "
                    f"kv pool {_fmt_bytes(r.get('kv_pool_bytes'))}, "
                    f"program budget "
                    f"{_fmt_bytes(r.get('program_budget_bytes'))}, "
                    f"headroom {_fmt_bytes(r.get('headroom_bytes'))}")
        else:
            lines.append("  hbm ledger: no device rows")
    return lines


# ---------------------------------------------------------------------------
# timeline
# ---------------------------------------------------------------------------

def timeline_lines(scopes: Dict[str, Dict[str, Any]],
                   engine: Optional[str] = None,
                   width: int = 40) -> List[str]:
    """One row per ring sample: wave offset, block counts, and a bar
    of pool occupancy (``#`` in-use, ``+`` parked-LRU, ``.`` free)."""
    lines: List[str] = []
    for name, blk in sorted(scopes.items()):
        if engine is not None and name != engine:
            continue
        ring = (blk.get("occupancy") or {}).get("ring") or []
        lines.append(f"{name}: {len(ring)} occupancy samples")
        if not ring:
            continue
        t0 = ring[0].get("t_s", 0.0)
        total = max(1, sum(int(ring[0].get(k, 0))
                           for k in ("free", "cached", "in_use")))
        for s in ring:
            used = int(s.get("in_use", 0))
            cached = int(s.get("cached", 0))
            n_used = round(width * used / total)
            n_cache = round(width * cached / total)
            bar = ("#" * n_used + "+" * n_cache).ljust(width, ".")
            lines.append(
                f"  +{s.get('t_s', 0.0) - t0:>8.3f}s "
                f"use={used:<4} lru={cached:<4} "
                f"free={s.get('free', 0):<4} "
                f"frag={s.get('frag', 0.0):.2f} |{bar}|")
    return lines


# ---------------------------------------------------------------------------
# chrome-trace export (counter lanes)
# ---------------------------------------------------------------------------

def _counter_event(name: str, ts_s: float, pid: int,
                   args: Dict[str, Any]) -> Dict[str, Any]:
    """A chrome-trace "C" (counter) event — renders as a stacked area
    lane, the right shape for pool occupancy over time."""
    return {"name": name, "cat": "kvscope", "ph": "C",
            "ts": ts_s * 1e6, "pid": pid, "tid": 0, "args": args}


def chrome_trace(scopes: Dict[str, Dict[str, Any]],
                 path: Optional[str] = None) -> List[Dict[str, Any]]:
    """Counter lanes per engine: ``kv blocks`` (in_use / cached / free
    stacked), ``kv occupancy`` and ``kv fragmentation`` ratios.  Times
    are rebased per engine (rings are perf_counter-clocked, which is
    not comparable across processes)."""
    events: List[Dict[str, Any]] = []
    for pid, (name, blk) in enumerate(sorted(scopes.items()), 1):
        occ = blk.get("occupancy") or {}
        ring = occ.get("ring") or []
        events.append(process_name_event(pid, f"kvscope {name}"))
        if not ring:
            continue
        t0 = ring[0].get("t_s", 0.0)
        num_blocks = sum(int(ring[0].get(k, 0))
                         for k in ("free", "cached", "in_use"))
        for s in ring:
            ts = s.get("t_s", 0.0) - t0
            free = int(s.get("free", 0))
            cached = int(s.get("cached", 0))
            events.append(_counter_event(
                "kv blocks", ts, pid,
                {"in_use": int(s.get("in_use", 0)), "cached": cached,
                 "free": free}))
            usable = max(1, num_blocks - 1)
            events.append(_counter_event(
                "kv occupancy", ts, pid,
                {"ratio": round(1.0 - free / usable, 4)}))
            events.append(_counter_event(
                "kv fragmentation", ts, pid,
                {"frag": float(s.get("frag", 0.0))}))
    return write_chrome_trace(events, path)


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m ray_tpu_torch.tools.kvscope",
        description="inspect kvscope snapshots (KV pool occupancy, "
                    "eviction forensics, HBM ledger)")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("report", help="occupancy / waste / ledger "
                                      "summary")
    p.add_argument("snapshot")

    p = sub.add_parser("timeline", help="occupancy ring as a text "
                                        "strip chart")
    p.add_argument("snapshot")
    p.add_argument("--engine", default=None,
                   help="only this deployment's ring")

    p = sub.add_parser("export", help="chrome-trace counter lanes")
    p.add_argument("snapshot")
    p.add_argument("-o", "--out", default=None,
                   help="write trace JSON here (default: stdout)")

    args = ap.parse_args(argv)
    try:
        scopes = load_snapshot(args.snapshot)
    except (OSError, ValueError, json.JSONDecodeError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    if args.cmd == "report":
        for line in report_lines(scopes):
            print(line)
        return 0
    if args.cmd == "timeline":
        for line in timeline_lines(scopes, args.engine):
            print(line)
        return 0
    # export
    events = chrome_trace(scopes, args.out)
    if args.out:
        print(f"wrote {len(events)} events to {args.out}")
    else:
        print(json.dumps(events))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
