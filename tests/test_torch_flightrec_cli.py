"""The port's postmortem CLI (``ray_tpu_torch.tools.flightrec``)
against the JAX package's ``ray_tpu.tools.flightrec``: the same
report, events, chrome-trace lane and SWEEPJSON records for a train
dump (the document of tests/test_trainwatch.py), a dump the port's
serving engine writes on an SLO breach, and a dump the port's train
health watchdog writes."""

import asyncio
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from ray_tpu.tools import flightrec as jcli  # noqa: E402
from ray_tpu_torch.serve import llm as tllm  # noqa: E402
from ray_tpu_torch.serve import slo as tslo  # noqa: E402
from ray_tpu_torch.tools import flightrec as tcli  # noqa: E402
from ray_tpu_torch.train import adamw, build_train_step  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

#: the train dump of tests/test_trainwatch.py:438-464
TRAIN_DOC = {
    "version": 1, "source": "train:t0",
    "reason": "train_anomaly_nonfinite_loss",
    "created": "2026-08-06T00:00:00", "uptime_s": 2.0,
    "events_recorded": 5, "events_retained": 5,
    "events_dropped": 0,
    "counts_by_kind": {"train_step": 3, "train_anomaly": 1,
                       "ckpt_save": 1},
    "context": {"trainer": "t0", "step": 2,
                "reason": "nonfinite_loss", "metric": "loss",
                "value": "nan",
                "trail": [{"step": 1, "loss": 0.5},
                          {"step": 2, "loss": "nan"}]},
    "events": [
        {"seq": 1, "t_s": 0.1, "kind": "train_step", "step": 0,
         "loss": 0.7, "wall_ms": 12.0},
        {"seq": 2, "t_s": 0.2, "kind": "train_step", "step": 1,
         "loss": 0.5, "wall_ms": 11.0},
        {"seq": 3, "t_s": 0.25, "kind": "ckpt_save", "step": 1,
         "dur_ms": 4.0, "bytes": 48},
        {"seq": 4, "t_s": 0.3, "kind": "train_step", "step": 2,
         "loss": "nan", "wall_ms": 13.0},
        {"seq": 5, "t_s": 0.3, "kind": "train_anomaly", "step": 2,
         "reason": "nonfinite_loss", "metric": "loss",
         "value": "nan"},
    ],
}


@pytest.fixture(scope="module")
def serve_dump(tmp_path_factory):
    """A flight record dumped by the port's continuous engine when a
    0.001 ms TTFT target breaches (llama nano, f32, paged)."""
    d = tmp_path_factory.mktemp("fr_serve")
    mp = pytest.MonkeyPatch()
    mp.setenv("RAYTPU_FLIGHTREC_DIR", str(d))
    try:
        engine = tllm.build_llm_deployment(
            "llama", "nano", device="cpu", scheduler="continuous",
            kv_layout="paged", max_new_tokens=4, kv_block_size=16,
            prefill_bucket=16, max_slots=2,
            slo=tslo.SLOConfig(ttft_ms=0.001),
            config_overrides={"dtype": torch.float32}).func_or_class()
        rs = np.random.RandomState(5)
        prompts = [rs.randint(2, 500, n).astype(np.int32)
                   for n in (9, 40, 13)]

        async def main():
            try:
                return await asyncio.gather(*(engine(p) for p in prompts))
            finally:
                engine.shutdown_engine()

        asyncio.run(main())
        dumps = engine.engine_stats()["slo"]["dumps"]
    finally:
        mp.undo()
    assert len(dumps) == 1
    return dumps[0]


@pytest.fixture(scope="module")
def train_dump(tmp_path_factory):
    """The port's health watchdog's dump of a NaN step."""
    d = tmp_path_factory.mktemp("fr_train")
    mp = pytest.MonkeyPatch()
    mp.setenv("RAYTPU_FLIGHTREC_DIR", str(d))
    try:
        tx = adamw(1e-2)
        step = build_train_step(
            lambda p, b: ((b["x"] @ p["w"] - b["y"]) ** 2).mean(), tx,
            health=True, telemetry_name="tfc_nan")
        params = {"w": torch.ones(4, 2)}
        state = tx.init(params)
        rng = np.random.RandomState(0)
        for i in range(4):
            x = torch.from_numpy(rng.randn(8, 4).astype(np.float32))
            if i == 3:
                x[0, 0] = float("nan")
            params, state, _, _ = step(params, state, {
                "x": x, "y": torch.from_numpy(
                    rng.randn(8, 2).astype(np.float32))})
    finally:
        mp.undo()
    assert len(step.watchdog.dumps) == 1
    return step.watchdog.dumps[0]


def _docs(serve_dump, train_dump):
    return {"train_doc": TRAIN_DOC,
            "serve_dump": tcli.load_dump(serve_dump),
            "train_dump": tcli.load_dump(train_dump)}


@pytest.mark.parametrize("which", ["train_doc", "serve_dump",
                                   "train_dump"])
def test_report_and_records_match_jax(which, serve_dump, train_dump):
    doc = _docs(serve_dump, train_dump)[which]
    lines = tcli.report_lines(doc)
    assert lines == jcli.report_lines(doc)
    assert tcli.sweepjson_records(doc) == jcli.sweepjson_records(doc)
    assert tcli.trace_events(doc) == jcli.trace_events(doc)
    for kw in ({}, {"kinds": ["train_step", "kv_reserve"]},
               {"since": 0.0, "until": 1e9, "last": 3},
               {"request": "0"}):
        assert tcli.filter_events(doc["events"], **kw) == \
            jcli.filter_events(doc["events"], **kw)
    text = "\n".join(lines)
    if which != "serve_dump":
        assert "train anomalies" in text and "metric trail" in text
    else:
        assert "SLO breach: objective=ttft" in text


def test_train_doc_renders_the_train_lanes():
    text = "\n".join(tcli.report_lines(TRAIN_DOC))
    assert "train steps: n=3" in text
    assert "2  loss  nan  nonfinite_loss" in text
    assert "trainer=t0" in text and "ckpt_save" in text
    assert any(r["metric"] == "flightrec_train_anomaly_events"
               and r["value"] == 1
               for r in tcli.sweepjson_records(TRAIN_DOC))


@pytest.mark.parametrize("argv", [["report"], ["events", "--last", "2"],
                                  ["events", "--kind", "train_step"],
                                  ["trace"], ["sweepjson"]],
                         ids=lambda a: "-".join(a))
def test_main_prints_what_the_jax_cli_prints(argv, train_dump, capsys):
    assert jcli.main(argv[:1] + [train_dump] + argv[1:]) == 0
    want = capsys.readouterr().out
    assert tcli.main(argv[:1] + [train_dump] + argv[1:]) == 0
    assert capsys.readouterr().out == want


def test_main_refuses_what_is_not_a_dump(tmp_path, capsys):
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"no": "events"}))
    assert tcli.main(["report", str(bad)]) == 2
    assert "not a flight-recorder dump" in capsys.readouterr().err


def test_runs_as_a_module(train_dump, tmp_path):
    out = tmp_path / "lane.json"
    r = subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch.tools.flightrec", "trace",
         train_dump, "-o", str(out)], cwd=ROOT, capture_output=True,
        text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert json.loads(out.read_text()) == jcli.trace_events(
        jcli.load_dump(train_dump))
