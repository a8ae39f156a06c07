"""The port's tune loggers, callbacks and syncer (``ray_tpu_torch/tune/
logger.py``, ``callback.py``, ``syncer.py``) against the JAX package's,
with no actors.

tests/test_tune_loggers.py's cases, driven directly: both packages'
default loggers (JSON, CSV, TensorBoard) get the same trials and the
same results under one fake clock, and must write the same files byte
for byte (params.json, result.json, progress.csv, the tfevents file
and its name), which each package's ``read_tfevents`` parses to the
same scalars.  Beside them: a callback that raises does not stop the
others, in both; and the experiment directory syncs to ``mem://`` and
back as the JAX package's does.
"""

import glob
import os
import types

import numpy as np
import pytest

from ray_tpu.tune import callback as jcallback
from ray_tpu.tune import logger as jlogger
from ray_tpu.tune import syncer as jsyncer
from ray_tpu_torch.tune import callback as tcallback
from ray_tpu_torch.tune import logger as tlogger
from ray_tpu_torch.tune import syncer as tsyncer

PACKAGES = {"jax": (jlogger, jcallback, jsyncer),
            "torch": (tlogger, tcallback, tsyncer)}

#: what the trials report: nested keys (flattened by CSV and TBX), a
#: key that appears late (dropped by the CSV header, kept by JSON), a
#: bool and strings (skipped by TBX), a numpy scalar (JSON's repr;
#: skipped by TBX)
RESULTS = [
    [{"loss": 1.0, "nested": {"a": 0, "b": 0.5}, "done": False,
      "training_iteration": 1},
     {"loss": 0.5, "nested": {"a": 1, "b": 0.25}, "note": "late",
      "done": False, "training_iteration": 2},
     {"loss": np.float32(0.25), "nested": {"a": 2}, "done": True,
      "training_iteration": 3}],
    [{"score": 3, "lr": 0.1, "training_iteration": 1},
     {"score": 4, "lr": 0.1, "timestamp": 17, "training_iteration": 2}],
]
CONFIGS = [{"x": 1.0, "act": "relu"}, {"x": 2.0, "nested": {"lr": 1e-3}}]


class _Clock:
    """A fake ``time`` module: ``time()`` steps 0.25 s a call."""

    def __init__(self):
        self.t = 1_700_000_000.0

    def time(self):
        self.t += 0.25
        return self.t


def _trial(i, root):
    return types.SimpleNamespace(trial_id=f"trial{i}", config=CONFIGS[i],
                                 logdir=os.path.join(root, f"trial_{i}"),
                                 iteration=0, status="RUNNING")


def _write(logger, callback, root, monkeypatch):
    monkeypatch.setattr(logger, "time", _Clock())
    cbs = callback.CallbackList([cls() for cls in logger.DEFAULT_LOGGERS])
    trials = [_trial(i, root) for i in range(len(RESULTS))]
    cbs.setup(root)
    for t in trials:
        cbs.on_trial_start(t)
    for step in range(max(map(len, RESULTS))):
        for t, results in zip(trials, RESULTS):
            if step < len(results):
                t.iteration += 1
                cbs.on_trial_result(t, dict(results[step]))
    trials[0].status = "TERMINATED"
    cbs.on_trial_complete(trials[0])
    cbs.on_experiment_end(trials)
    return trials


def _tree(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            path = os.path.join(d, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = fh.read()
    return out


def test_default_loggers_write_the_jax_files_byte_for_byte(tmp_path,
                                                           monkeypatch):
    trees = {}
    for name, (logger, callback, _) in PACKAGES.items():
        root = str(tmp_path / name)
        _write(logger, callback, root, monkeypatch)
        trees[name] = _tree(root)
    assert trees["torch"] == trees["jax"]
    names = sorted(n.split(".tfevents.")[0] for n in trees["torch"])
    assert names == sorted(
        f"trial_{i}/{f}" for i in range(2) for f in (
            "params.json", "result.json", "progress.csv", "events.out"))
    # tests/test_tune_loggers.py's reading of them
    progress = trees["torch"]["trial_0/progress.csv"].decode().splitlines()
    assert progress[0] == "done,loss,nested/a,nested/b,training_iteration"
    assert len(progress) == 4
    rows = trees["torch"]["trial_0/result.json"].decode().splitlines()
    assert len(rows) == 3 and '"note": "late"' in rows[1]


def test_tfevents_parse_to_the_same_scalars(tmp_path, monkeypatch):
    scalars = {}
    for name, (logger, callback, _) in PACKAGES.items():
        root = str(tmp_path / name)
        _write(logger, callback, root, monkeypatch)
        scalars[name] = [
            list(logger.read_tfevents(glob.glob(os.path.join(
                root, f"trial_{i}", "events.out.tfevents.*"))[0]))
            for i in range(2)]
    assert scalars["torch"] == scalars["jax"]
    loss = [(v, s) for tag, v, s in scalars["torch"][0]
            if tag == "ray/tune/loss"]
    # the third loss is a numpy float32, not a Python float: TBX skips it
    assert loss == [(1.0, 1), (0.5, 2)]
    assert not [t for t, _, _ in scalars["torch"][1] if "timestamp" in t]


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_a_failing_callback_does_not_stop_the_others(pkg, caplog):
    _, callback, _ = PACKAGES[pkg]
    seen = []

    class Bad(callback.Callback):
        def on_trial_result(self, trial, result):
            raise ValueError("callback bug")

    class Good(callback.Callback):
        def on_trial_result(self, trial, result):
            seen.append(result["i"])

    cbs = callback.CallbackList([Bad(), Good()])
    trial = types.SimpleNamespace(trial_id="t")
    for i in range(3):
        cbs.on_trial_result(trial, {"i": i})
    assert seen == [0, 1, 2]
    assert len([r for r in caplog.records
                if "Bad.on_trial_result failed" in r.getMessage()]) == 3


def test_syncer_round_trips_an_experiment_like_jax(tmp_path, monkeypatch):
    """RunConfig.sync_to's uploads (incremental: only changed files)
    and Tuner.restore's download, through mem://."""
    got = {}
    for name, (logger, callback, syncer) in PACKAGES.items():
        root = str(tmp_path / name / "exp")
        _write(logger, callback, root, monkeypatch)
        up = syncer.Syncer(root, f"mem://tune_sync_{name}/exp")
        first, again = up.sync_up(), up.sync_up()
        with open(os.path.join(root, "trial_0", "result.json"), "a") as f:
            f.write("{}\n")
        changed = up.sync_up()
        back = str(tmp_path / name / "restored")
        pulled = syncer.Syncer.sync_down(f"mem://tune_sync_{name}/exp",
                                         back)
        got[name] = (first, again, changed, pulled, _tree(back))
        assert _tree(back) == _tree(root)
    assert got["torch"] == got["jax"]
    assert got["torch"][:4] == (8, 0, 1, 8)
