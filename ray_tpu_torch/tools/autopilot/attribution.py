"""Stage 1 of the autopilot loop: roofline attribution (the
counterpart of ``ray_tpu/tools/autopilot/attribution.py``).

The perf observatory (``_private/device_stats.py``) records, per named
program, the cost model's FLOP count and bytes accessed (its harvest
of the program's first fresh call) and steady-state invoke
walltimes.  This module turns that wall of gauges
into ONE statement: which program is the bottleneck, which side of the
roofline it sits on, and which knobs move it.

* **classification** — arithmetic intensity (FLOPs/byte from the cost
  model) against the device ridge point
  (``peak_flops / hbm_bandwidth``, ``device_stats.device_roofline()``;
  989 TFLOP/s over 3.35 TB/s on an H100 SXM): below the ridge the
  tensor cores starve on
  HBM no matter how well it is fed (*hbm-bound*), above it the program
  is *compute-bound* and MFU headroom is the whole story.
* **ranking** — headroom-weighted time share: a program that eats 70%
  of the walltime at 90% of its roofline ceiling is LESS interesting
  than one eating 25% at a third of its ceiling.  ``score =
  time_share * headroom`` ranks them; the top entry is named as *the*
  bottleneck.
* **knobs** — ``PROGRAM_KNOBS`` maps every runtime program the
  observatory registers to the sweep-able knobs that move it, which is
  what the planner (stage 2) grids over (the JAX package's table).
  The graftcheck ``autopilot-attribution`` rule pins this catalog to
  the static ProgramSpec catalog, as ``observatory-mapping`` pins the
  runtime names, so a new hot-path program cannot ship without an
  attribution entry.

Inputs are snapshot dicts — ``ProgramRegistry.snapshot()``,
``engine_stats()["programs"]``, or a dashboard ``/api/perf/programs``
dump — so attribution runs equally on the live process and on a canned
JSON file from another machine.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch._private import device_stats as _ds

#: runtime program name -> the sweep-able knobs that move it (the
#: planner's vocabulary).  Keys must stay a subset of
#: ``device_stats.KNOWN_PROGRAMS`` and must cover every
#: ``STATIC_PROGRAM_MAP`` target — both enforced by graftcheck's
#: ``autopilot-attribution`` rule, so the static auditor's hot-path
#: catalog, the runtime observatory, and this attribution table cannot
#: drift apart.
PROGRAM_KNOBS: Dict[str, Tuple[str, ...]] = {
    "train.step": ("batch", "remat_policy", "ce_impl",
                   "flash_resident"),
    "bench.train_step": ("batch", "remat_policy", "ce_impl",
                         "flash_resident"),
    "serve.prefill": ("prefill_bucket", "batch", "flash_resident"),
    "serve.paged_prefill": ("prefill_bucket", "block_size",
                            "flash_resident"),
    "serve.decode": ("batch", "kv_layout", "block_size",
                     "flash_resident"),
    "serve.spec_verify": ("spec_k", "spec_draft", "kv_layout"),
    "serve.spec_draft": ("spec_k", "spec_draft"),
    "serve.kv_handoff_export": ("block_size", "prefill_replicas"),
    "serve.kv_handoff_install": ("block_size", "decode_replicas"),
    "serve.sharded_prefill": ("tensor", "prefill_bucket", "batch"),
    "serve.sharded_paged_prefill": ("tensor", "prefill_bucket",
                                    "block_size"),
    "serve.sharded_decode": ("tensor", "batch", "kv_layout",
                             "block_size"),
    "serve.sharded_spec_verify": ("tensor", "spec_k", "spec_draft"),
    "serve.sharded_spec_draft": ("tensor", "spec_k", "spec_draft"),
    "serve.sharded_kv_handoff_export": ("tensor", "block_size",
                                        "prefill_replicas"),
    "serve.sharded_kv_handoff_install": ("tensor", "block_size",
                                         "decode_replicas"),
}


def classify(intensity: Optional[float],
             ridge: float) -> str:
    """``compute-bound`` / ``hbm-bound`` by arithmetic intensity vs the
    ridge point; ``unmeasured`` when the cost harvest never landed
    (no program call harvested, or ``RAYTPU_DEVICE_STATS_COST=0``)."""
    if not isinstance(intensity, (int, float)):
        return "unmeasured"
    return "compute-bound" if intensity >= ridge else "hbm-bound"


def _busy_ms(block: Dict[str, Any]) -> float:
    """Approximate walltime spent in a program's steady state: mean
    invoke over the recent window times total invokes.  Programs that
    only ever compiled contribute zero — they cannot be the
    steady-state bottleneck."""
    invoke = block.get("invoke_ms") or {}
    mean = invoke.get("mean")
    invokes = block.get("invokes") or 0
    if not isinstance(mean, (int, float)) or not invokes:
        return 0.0
    return float(mean) * int(invokes)


def _headroom(block: Dict[str, Any], cls: str,
              device: Dict[str, Any]) -> Optional[float]:
    """Distance from the program's own roofline ceiling, in [0, 1].

    Compute-bound: ``1 - mfu`` (the ceiling is the peak-FLOPs line).
    HBM-bound: ``1 - achieved_bytes_per_sec / peak_bw`` (the ceiling
    is the bandwidth line — a bandwidth-saturated program has no
    headroom even at terrible MFU).  None when the inputs to either
    ratio are missing."""
    invoke = block.get("invoke_ms") or {}
    mean_ms = invoke.get("mean")
    if cls == "compute-bound":
        mfu = block.get("mfu")
        if isinstance(mfu, (int, float)):
            return round(min(1.0, max(0.0, 1.0 - float(mfu))), 4)
        return None
    if cls == "hbm-bound":
        nbytes = block.get("bytes_accessed")
        bw = device.get("peak_hbm_bytes_per_sec")
        if (isinstance(nbytes, (int, float))
                and isinstance(mean_ms, (int, float)) and mean_ms > 0
                and isinstance(bw, (int, float)) and bw > 0):
            util = float(nbytes) / (float(mean_ms) / 1e3) / float(bw)
            return round(min(1.0, max(0.0, 1.0 - util)), 4)
        return None
    return None


#: re-prefill waste fraction above which the serving bottleneck is
#: called cache thrash: the KV pool is evicting prefixes it re-fills,
#: so prefill compute is going to content the pool already held
CACHE_THRASH_WASTE_FRAC = 0.15


def attribute(programs: Dict[str, Dict[str, Any]],
              device: Optional[Dict[str, Any]] = None,
              request_anatomy: Optional[Dict[str, Any]] = None,
              train_anatomy: Optional[Dict[str, Any]] = None,
              kv_scope: Optional[Dict[str, Any]] = None,
              kv_tier: Optional[Dict[str, Any]] = None
              ) -> Dict[str, Any]:
    """Attribute a programs snapshot against the device roofline.

    ``programs`` is any ``{name: block}`` snapshot the observatory
    emits; ``device`` is a :func:`device_stats.device_roofline` block
    (taken from the snapshot's origin when attributing a remote dump;
    defaults to this process's devices).  ``request_anatomy`` is an
    optional tracebus ``request_evidence()`` block (tools/tracebus.py)
    — the p99 per-request critical-path decomposition — which names
    the dominant *lifecycle* leg (queue wait, prefill, inter-token
    gaps, ...) to complement the roofline's program-granularity view:
    a device bottleneck only matters if the request tail is actually
    spent on device.  ``train_anatomy`` is the trainwatch view — a
    ``train_stats()``-shaped dict (or just its ``anatomy``/``goodput``
    blocks, train/goodput.py): when ``data_wait`` dominates the step
    anatomy the summary cites *input-bound* — sweeping device knobs
    cannot move a loop that is starving on its batch iterator.
    ``kv_scope`` is the kvscope block (``engine_stats()["kv_scope"]``
    or the fleet-pooled variant): when the re-prefill waste fraction
    crosses :data:`CACHE_THRASH_WASTE_FRAC` the summary names the
    serving loop *cache-thrash-bound* — a meaningful share of prefill
    compute is re-filling prefixes the pool already held and evicted,
    so the lever is pool size (or a host-RAM KV tier), not program
    knobs.  ``kv_tier`` is the host-tier block
    (``engine_stats()["kv_tier"]`` or the fleet-pooled variant): when
    the RESIDUAL waste is below threshold but the would-be waste —
    counting tokens the tier re-admitted via H2D as churn that would
    have been re-prefill without it — crosses it, the summary stops
    calling the loop cache-thrash-bound and instead credits the tier
    with absorbing the churn (the lever becomes tier budget, not pool
    size).  Returns::

        {"device": {...roofline...},
         "programs": {name: {"class", "arithmetic_intensity", "mfu",
                             "time_share", "headroom", "score",
                             "busy_ms", "recompile_storm", "knobs"}},
         "ranked": [names, best-score first],
         "bottleneck": name | None,
         "request_anatomy": evidence block | None,
         "summary": one-sentence statement}
    """
    if device is None:
        device = _ds.device_roofline()
    # a card the peak table does not know has no ridge: 1.0, as the
    # JAX code falls back
    ridge = float(device.get("ridge_flops_per_byte") or 1.0)
    busy = {name: _busy_ms(block)
            for name, block in programs.items()}
    total_ms = sum(busy.values())
    out: Dict[str, Dict[str, Any]] = {}
    for name, block in programs.items():
        intensity = block.get("arithmetic_intensity")
        cls = classify(intensity, ridge)
        share = (busy[name] / total_ms) if total_ms > 0 else 0.0
        headroom = _headroom(block, cls, device)
        # unmeasured headroom is treated as full headroom for ranking:
        # "we do not even know" is a reason to look, not to skip
        score = share * (1.0 if headroom is None else headroom)
        out[name] = {
            "class": cls,
            "arithmetic_intensity": intensity,
            "ridge_flops_per_byte": ridge,
            "mfu": block.get("mfu"),
            "busy_ms": round(busy[name], 3),
            "time_share": round(share, 4),
            "headroom": headroom,
            "score": round(score, 4),
            "invokes": block.get("invokes"),
            "recompile_storm": bool(block.get("recompile_storm")),
            "knobs": list(PROGRAM_KNOBS.get(name, ())),
        }
    ranked = sorted(out, key=lambda n: (-out[n]["score"], n))
    bottleneck = next((n for n in ranked if out[n]["score"] > 0), None)
    if bottleneck is not None:
        b = out[bottleneck]
        knobs = "/".join(b["knobs"]) or "(no catalogued knobs)"
        summary = (
            f"bottleneck: {bottleneck} ({b['class']}, "
            f"{b['time_share']:.0%} of program walltime, headroom "
            f"{'unknown' if b['headroom'] is None else b['headroom']})"
            f" — sweep {knobs}")
    elif programs:
        summary = ("no steady-state invokes recorded — programs "
                   "compiled but never ran; nothing to attribute")
    else:
        summary = "no programs registered"
    if request_anatomy and request_anatomy.get("dominant_component"):
        dom = request_anatomy["dominant_component"]
        pct = request_anatomy.get("percentile", 99)
        comps = (request_anatomy.get("overall") or {}).get(
            "components") or {}
        val = comps.get(dom)
        summary += (
            f"; request p{pct:g} tail dominated by {dom}"
            + (f" ({val:.1f} ms)" if isinstance(val, (int, float))
               else ""))
    if train_anatomy:
        from ray_tpu_torch.train.goodput import dominant_component

        anatomy = train_anatomy.get("anatomy") or train_anatomy
        dom = dominant_component(anatomy)
        if dom is not None:
            mean = (anatomy.get(dom) or {}).get("mean")
            ratio = (train_anatomy.get("goodput") or {}).get("ratio")
            gp = (f", goodput {ratio}" if isinstance(
                ratio, (int, float)) else "")
            if dom == "data_wait_ms":
                summary += (
                    f"; training is input-bound: data_wait dominates "
                    f"step anatomy ({mean:.1f} ms mean{gp}) — feed "
                    f"the loop before sweeping device knobs")
            else:
                summary += (f"; train step anatomy dominated by "
                            f"{dom} ({mean:.1f} ms mean{gp})")
    if kv_scope:
        # engine shape nests the waste under "forensics"; the
        # fleet-pooled block (router fleet_stats) is flat
        fx = kv_scope.get("forensics") or kv_scope
        frac = fx.get("reprefill_waste_frac") or 0.0
        # tokens the host tier re-admitted via H2D are churn that
        # WOULD have been re-prefill waste without it — the tier block
        # is authoritative, the kvscope forensics mirror is fallback
        restored = int((kv_tier or {}).get("tokens_restored")
                       or fx.get("tokens_restored") or 0)
        if frac >= CACHE_THRASH_WASTE_FRAC:
            summary += (
                f"; serving is cache-thrash-bound: {frac:.0%} of "
                f"prefill tokens re-filled previously-resident "
                f"prefixes ({fx.get('reprefill_waste_tokens', 0)} "
                f"tokens) — grow the KV pool before sweeping "
                f"program knobs")
            if restored:
                summary += (
                    f" (host KV tier restored {restored} tokens but "
                    f"thrash persists — grow its byte budget too)")
        elif restored:
            prefill = float(fx.get("prefill_tokens") or 0)
            waste = float(fx.get("reprefill_waste_tokens") or 0)
            denom = prefill + restored
            would_be = (waste + restored) / denom if denom > 0 else 0.0
            if would_be >= CACHE_THRASH_WASTE_FRAC:
                hit_rate = (kv_tier or {}).get("hit_rate")
                hr = (f", tier hit rate {hit_rate:.0%}"
                      if isinstance(hit_rate, (int, float)) else "")
                summary += (
                    f"; host KV tier is absorbing cache churn: "
                    f"{restored} tokens re-admitted via H2D instead "
                    f"of re-prefill (would-be waste {would_be:.0%} "
                    f"vs {frac:.0%} residual{hr}) — pool churn is "
                    f"handled, not a bottleneck")
    return {"device": device, "programs": out, "ranked": ranked,
            "bottleneck": bottleneck,
            "request_anatomy": request_anatomy,
            "train_anatomy": train_anatomy, "kv_scope": kv_scope,
            "kv_tier": kv_tier, "summary": summary}


def attribute_registry() -> Dict[str, Any]:
    """Attribute this process's live ``ProgramRegistry`` (the ``python
    -m ray_tpu_torch.bench --autopilot`` / dashboard path) against this
    process's device: the card, or the CPU without one."""
    devices = _ds.device_memory_stats()
    snapshot = _ds.get_registry().snapshot(
        n_devices=max(1, len(devices)))
    return attribute(snapshot)


def _num(v) -> str:
    """A peak rate as JAX prints it, '?' for one the table lacks."""
    return "?" if v is None else format(v, ".3g")


def render_text(report: Dict[str, Any]) -> str:
    """Human rendering of one attribution report."""
    dev = report["device"]
    lines = [
        f"device: {dev.get('device_kind') or dev.get('backend') or '?'}"
        f"  peak {_num(dev.get('peak_flops_per_chip'))} FLOP/s, "
        f"{_num(dev.get('peak_hbm_bytes_per_sec'))} B/s, "
        f"ridge {dev.get('ridge_flops_per_byte')} FLOP/B",
        "",
    ]
    for name in report["ranked"]:
        p = report["programs"][name]
        ai = p["arithmetic_intensity"]
        lines.append(
            f"  {name:<28s} {p['class']:<14s} "
            f"AI={'-' if ai is None else format(ai, '.1f'):<8s} "
            f"share={p['time_share']:<7.2%} "
            f"headroom={'-' if p['headroom'] is None else p['headroom']}"
            f" score={p['score']}")
    anatomy = report.get("request_anatomy")
    if anatomy and anatomy.get("overall", {}).get("requests"):
        over = anatomy["overall"]
        comps = over["components"]
        pct = anatomy.get("percentile", 99)
        parts = " ".join(
            f"{k.replace('_ms', '')}={comps[k]:.1f}"
            for k in sorted(comps) if k != "e2e_ms"
            and isinstance(comps.get(k), (int, float)))
        lines += ["", f"  request p{pct:g} critical path "
                      f"({over['requests']} reqs, "
                      f"e2e {comps.get('e2e_ms') or 0.0:.1f} ms): "
                      f"{parts}"]
    lines += ["", report["summary"]]
    return "\n".join(lines)


__all__: List[str] = ["CACHE_THRASH_WASTE_FRAC", "PROGRAM_KNOBS",
                      "attribute", "attribute_registry", "classify",
                      "render_text"]
