"""The port's autopilot (``ray_tpu_torch/tools/autopilot``) against the
JAX package's ``tools/autopilot``, on the CPU: the cases of
``tests/test_autopilot.py``, each run through both packages on the
same inputs.

* attribution: the canned snapshot (one compute-bound, one HBM-bound,
  one unmeasured program) classifies, ranks and names the bottleneck
  as JAX does, report for report; the knob and candidate catalogs and
  ``mirror_variant`` of every candidate are JAX's;
* planner: on the same synthetic ledgers (unmeasured, stale, fresh,
  regressed, attributed) both plans are equal;
* verdict: a regressed history exits 1 naming the metric in both CLIs
  and files the same verdict; the port's reports land beside the
  ledger it read unless ``--out-dir`` says otherwise.

Every ledger and baseline is a file under ``tmp_path``: neither the
repo's BENCH_HISTORY.jsonl nor its BASELINE.json is read or written,
and no AUTOPILOT.* appears at the repo root.  Comparisons are exact.
"""

import json
import os
import pathlib
import subprocess
import sys

import pytest

from ray_tpu.tools import perfledger as jpl
from ray_tpu.tools.autopilot import attribution as jatt
from ray_tpu.tools.autopilot import planner as jplan
from ray_tpu.tools.autopilot import verdict as jver
from ray_tpu.tools.autopilot.__main__ import main as jmain
from ray_tpu_torch.tools import perfledger as tpl
from ray_tpu_torch.tools.autopilot import attribution as tatt
from ray_tpu_torch.tools.autopilot import planner as tplan
from ray_tpu_torch.tools.autopilot import verdict as tver
from ray_tpu_torch.tools.autopilot.__main__ import main as tmain

ROOT = pathlib.Path(__file__).resolve().parents[1]

#: an H100 SXM roofline block (engine_stats "device" shape): ridge 295
_H100 = {"backend": "cuda", "device_kind": "NVIDIA H100 80GB HBM3",
         "peak_flops_per_chip": 989e12,
         "peak_hbm_bytes_per_sec": 3.35e12,
         "ridge_flops_per_byte": 295.2}

#: train.step compute-bound (AI 400) at 1/3 of the walltime,
#: serve.decode HBM-bound (AI 50) at 2/3 with bytes for exactly half
#: the bandwidth, serve.prefill compiled but never invoked
_SNAPSHOT = {
    "train.step": {
        "compile_events": 1, "invokes": 100,
        "invoke_ms": {"count": 100, "mean": 10.0, "p50": 10.0,
                      "p95": 11.0, "p99": 12.0, "max": 13.0},
        "arithmetic_intensity": 400.0, "mfu": 0.45,
        "bytes_accessed": 4e9, "recompile_storm": False},
    "serve.decode": {
        "compile_events": 1, "invokes": 400,
        "invoke_ms": {"count": 400, "mean": 5.0, "p50": 5.0,
                      "p95": 6.0, "p99": 7.0, "max": 8.0},
        "arithmetic_intensity": 50.0, "mfu": 0.05,
        "bytes_accessed": 0.005 * 3.35e12 * 0.5,
        "recompile_storm": False},
    "serve.prefill": {
        "compile_events": 2, "invokes": 0,
        "invoke_ms": {"count": 0, "mean": None, "p50": None,
                      "p95": None, "p99": None, "max": None},
        "arithmetic_intensity": None, "mfu": None,
        "bytes_accessed": None, "recompile_storm": False},
}


@pytest.fixture(autouse=True)
def repo_files_untouched():
    """The repo's ledger, baseline and autopilot reports are neither
    written nor created by any case."""
    names = ("BENCH_HISTORY.jsonl", "BASELINE.json", "AUTOPILOT.md",
             "AUTOPILOT.json", "BENCH_HISTORY_TORCH.jsonl")

    def state():
        return {n: (ROOT / n).stat().st_mtime_ns
                if (ROOT / n).exists() else None for n in names}

    before = state()
    yield
    assert state() == before


def _paths(tmp_path):
    return str(tmp_path / "hist.jsonl"), str(tmp_path / "BASELINE.json")


def _bench_rec(value, metric="ap_tokens_per_sec"):
    return {"metric": metric, "value": value, "unit": "tok/s",
            "vs_baseline": None, "detail": {}}


def _write_entries(path, entries):
    with open(path, "w") as f:
        for e in entries:
            f.write(json.dumps(e) + "\n")


def _entry(rec, prov=None):
    return {"recorded_at": "2026-08-05 00:00:00", "source": "sweep",
            "provenance": prov or {}, "record": rec,
            "metrics": tpl.extract_metrics(rec)}


def test_catalogs_and_mirror_are_the_jax_packages():
    from ray_tpu._private.device_stats import KNOWN_PROGRAMS as jknown
    from ray_tpu_torch._private.device_stats import KNOWN_PROGRAMS

    assert tatt.PROGRAM_KNOBS == jatt.PROGRAM_KNOBS
    assert set(tatt.PROGRAM_KNOBS) == set(KNOWN_PROGRAMS) == set(jknown)
    assert tplan.CANDIDATES == jplan.CANDIDATES
    for c in tplan.CANDIDATES:
        got = tplan.mirror_variant(c["batch"], c["overrides"])
        assert got == jplan.mirror_variant(c["batch"], c["overrides"])
        assert tpl._variant_key(got) == jpl._variant_key(got)


@pytest.mark.parametrize("snapshot", [
    _SNAPSHOT, {"serve.prefill": _SNAPSHOT["serve.prefill"]}, {}],
    ids=["canned", "no-invokes", "empty"])
def test_attribution_equals_jax(snapshot):
    got = tatt.attribute(snapshot, device=_H100)
    assert got == jatt.attribute(snapshot, device=_H100)
    assert tatt.render_text(got) == jatt.render_text(got)
    if snapshot is _SNAPSHOT:
        progs = got["programs"]
        assert [progs[n]["class"] for n in
                ("train.step", "serve.decode", "serve.prefill")] == \
            ["compute-bound", "hbm-bound", "unmeasured"]
        assert progs["serve.decode"]["headroom"] == pytest.approx(0.5)
        assert got["bottleneck"] == "serve.decode"


def test_attribution_with_evidence_equals_jax():
    kv = {"forensics": {"reprefill_waste_frac": 0.05,
                        "reprefill_waste_tokens": 32,
                        "prefill_tokens": 640, "tokens_restored": 0}}
    tier = {"tokens_restored": 160, "hit_rate": 0.5, "enabled": True}
    train = {"anatomy": {"data_wait_ms": {"mean": 9.0},
                         "device_compute_ms": {"mean": 2.0}},
             "goodput": {"ratio": 0.2}}
    for kw in ({"kv_scope": kv, "kv_tier": tier},
               {"train_anatomy": train}):
        assert tatt.attribute(_SNAPSHOT, device=_H100, **kw) == \
            jatt.attribute(_SNAPSHOT, device=_H100, **kw)


def test_attribute_registry_reads_the_local_device():
    rep = tatt.attribute_registry()
    # no card here: the CPU's placeholder rates, as JAX's CPU backend
    assert rep["device"]["ridge_flops_per_byte"] == pytest.approx(10.0)
    assert rep["device"] == {**jatt.attribute_registry()["device"],
                             "device_kind": "cpu"}


def _plans(tmp_path, **kw):
    hist, base = _paths(tmp_path)
    return (tplan.plan(hist, base, **kw), jplan.plan(hist, base, **kw))


def test_plan_unmeasured_equals_jax(tmp_path):
    got, want = _plans(tmp_path, budget=3)
    assert got == want
    assert len(got["grid"]) == 3
    assert all(v["status"] == "unmeasured" for v in got["variants"])


def test_plan_stale_fresh_and_regressed_equal_jax(tmp_path):
    hist, _ = _paths(tmp_path)
    cand = next(c for c in tplan.CANDIDATES if c["id"] == "decode-b8")
    variant = tplan.mirror_variant(cand["batch"], cand["overrides"])
    current = tpl.provenance().get("git_sha")
    assert current, "tests run inside the repo checkout"
    rec = {"sweep": variant, "decode_tok_s": 1000.0}
    for prov in ({"git_sha": "deadbee"}, {"git_sha": current}):
        _write_entries(hist, [_entry(rec, prov)])
        for kw in ({"budget": 99}, {"budget": 99, "include_fresh": True}):
            got, want = _plans(tmp_path, **kw)
            assert got == want, (prov, kw)
    assert "decode-b8" in tplan.plan(hist, _paths(tmp_path)[1],
                                     budget=99)["skipped_fresh"]
    paged = next(c for c in tplan.CANDIDATES if c["id"] == "traffic-paged")
    variant = tplan.mirror_variant(paged["batch"], paged["overrides"])
    _write_entries(hist, [_entry({"sweep": variant, "slo_attainment": s})
                          for s in (0.99, 0.50)])
    got, want = _plans(tmp_path, budget=4)
    assert got == want
    assert got["variants"][0]["id"] == "traffic-paged"
    assert got["variants"][0]["status"] == "regressed"


def test_plan_biased_by_attribution_equals_jax(tmp_path):
    att = tatt.attribute(_SNAPSHOT, device=_H100)
    got, want = _plans(tmp_path, budget=4, attribution=att)
    assert got == want
    assert [v["id"] for v in got["variants"]][:3] == [
        "decode-b8", "decode-b16", "decode-b16-flash"]


def test_verdict_equals_jax(tmp_path):
    hist, base = _paths(tmp_path)
    tpl.append_records([_bench_rec(50.0)], "bench", path=hist)
    (tmp_path / "BASELINE.json").write_text(json.dumps({"published": {
        "ap_tokens_per_sec": 100.0, "never_measured_metric": 1.0}}))
    got = tver.build_verdict(hist, base)
    assert got == jver.build_verdict(hist, base)
    assert got["baseline_regressed"] == ["ap_tokens_per_sec"]
    assert got["unmeasured_baseline"] == ["never_measured_metric"]
    assert got["ok"] is False


def test_cli_verdict_exit_codes_and_reports(tmp_path, capsys):
    """A regressed history: both CLIs exit 1 naming the metric; the
    port files its reports beside the ledger when no --out-dir is
    given, and both JSON reports are equal."""
    hist, base = _paths(tmp_path)
    tpl.append_records([_bench_rec(100.0)], "bench", path=hist)
    tpl.append_records([_bench_rec(50.0)], "bench", path=hist)
    jdir = tmp_path / "jax"
    jdir.mkdir()
    rc_t = tmain(["--history", hist, "--baseline", base, "verdict"])
    err_t = capsys.readouterr().err
    rc_j = jmain(["--history", hist, "--baseline", base, "verdict",
                  "--out-dir", str(jdir)])
    err_j = capsys.readouterr().err
    assert rc_t == rc_j == 1
    assert "REGRESSED: ap_tokens_per_sec" in err_t
    assert "REGRESSED: ap_tokens_per_sec" in err_j
    got = json.loads((tmp_path / "AUTOPILOT.json").read_text())
    assert got == json.loads((jdir / "AUTOPILOT.json").read_text())
    assert got["regressed"] == ["ap_tokens_per_sec"]
    md = (tmp_path / "AUTOPILOT.md").read_text()
    assert "REGRESSED" in md and "Next plan" in md
    # clean: exit 0, nothing filed with --no-write
    clean = str(tmp_path / "clean.jsonl")
    tpl.append_records([_bench_rec(100.0)], "bench", path=clean)
    tpl.append_records([_bench_rec(101.0)], "bench", path=clean)
    assert tmain(["--history", clean, "--baseline", base, "verdict",
                  "--no-write"]) == 0
    assert "**OK**" in capsys.readouterr().out


def test_cli_attribute_and_plan(tmp_path, capsys):
    snap = tmp_path / "snap.json"
    snap.write_text(json.dumps({"programs": _SNAPSHOT, "device": _H100}))
    assert tmain(["attribute", "--snapshot", str(snap), "--format",
                  "json"]) == 0
    rep = json.loads(capsys.readouterr().out)
    assert rep["bottleneck"] == "serve.decode"
    assert rep["device"]["device_kind"] == "NVIDIA H100 80GB HBM3"
    hist, base = _paths(tmp_path)
    assert tmain(["--history", hist, "--baseline", base, "plan",
                  "--budget", "5"]) == 0
    out = capsys.readouterr()
    assert jmain(["--history", hist, "--baseline", base, "plan",
                  "--budget", "5"]) == 0
    assert json.loads(out.out) == json.loads(capsys.readouterr().out)
    assert len(json.loads(out.out)) == 5
    assert "autopilot:" in out.err and "rationale" not in out.out


def test_cli_subprocess_smoke(tmp_path):
    hist, base = _paths(tmp_path)
    proc = subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch.tools.autopilot",
         "--history", hist, "--baseline", base, "plan", "--budget", "2"],
        capture_output=True, text=True, cwd=str(ROOT),
        env={**os.environ, "RAYTPU_BENCH_HISTORY": hist}, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert len(json.loads(proc.stdout)) == 2
