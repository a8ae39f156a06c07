"""The port's train-step telemetry against the JAX package's.

``ray_tpu_torch.train.telemetry`` and ``train.goodput`` are copies of
their ``ray_tpu`` counterparts.  The recorders get the same injected
call scripts in both packages and must give equal ``stats()``,
``last_steps()``, anomaly dicts and dump contexts (timestamps and paths
aside).  ``build_train_step(health=True)`` trains llama nano in f32
beside ``jax_utils.build_train_step`` with ``optax.adamw`` (the JAX
package's parameters carried over through numpy) and must agree in
losses, parameters and every count; a NaN in the batch dumps a
postmortem within its step in both.  ``bench.train_watch`` returns the
records ``bench.py``'s ``--train`` emits.
"""

import json
import math
import types

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

import bench as jbench  # noqa: E402
from ray_tpu._private import device_stats as jds  # noqa: E402
from ray_tpu._private import flightrec as jflightrec  # noqa: E402
from ray_tpu.models import llama as jl  # noqa: E402
from ray_tpu.train import goodput as jgp  # noqa: E402
from ray_tpu.train import telemetry as jtel  # noqa: E402
from ray_tpu.train.jax_trainer import jax_utils  # noqa: E402
from ray_tpu_torch import bench as tbench  # noqa: E402
from ray_tpu_torch._private import device_stats as tds  # noqa: E402
from ray_tpu_torch._private import flightrec as tflightrec  # noqa: E402
from ray_tpu_torch.models import llama as tl  # noqa: E402
from ray_tpu_torch.models.convert import llama_params_from_numpy  # noqa: E402
from ray_tpu_torch.train import adamw, build_train_step  # noqa: E402
from ray_tpu_torch.train import goodput as tgp  # noqa: E402
from ray_tpu_torch.train import telemetry as ttel  # noqa: E402
from ray_tpu_torch.train import trainer as ttrainer  # noqa: E402
from ray_tpu_torch.train.optim import tree_leaves  # noqa: E402

JAX = types.SimpleNamespace(gp=jgp, tel=jtel, fr=jflightrec)
PORT = types.SimpleNamespace(gp=tgp, tel=ttel, fr=tflightrec)
SEEDS = pytest.mark.parametrize("seed", [0, 1, 2])

# after each AdamW step: the tolerances of the port's AdamW test
# (tests/test_torch_train_step.py).  An AdamW update is lr * m / (v +
# eps) with v = sqrt(nu / (1 - b2**t)): where v falls near eps = 1e-8
# (a gradient element that cancels to ~1e-9), the ~1e-9 difference of
# the two packages' summation orders moves the update by up to
# lr * 1e-9 / eps.  llama nano has such elements (one of 24,576 in
# blocks.mlp.w_up at the first step), so an element whose v was ever
# below EPS_BOUND (the reference's moments) is held to one update (lr)
# a step instead of PARAM_TOL.
PARAM_TOL = 1e-5
LOSS_TOL = 1e-5
EPS_BOUND = 10 * 1e-8


def eps_bound_mask(mask, nu_leaves, t, b2=0.999):
    """Elements whose AdamW denominator was near eps at any step so far
    (``mask`` from the steps before, None at the first).  An element
    that never had a gradient (v = 0: an embedding row no token used)
    is not among them: a 1e-12 gradient moves it by ~lr * 1e-4."""
    v = [np.sqrt(np.asarray(nu, np.float64) / (1 - b2 ** t))
         for nu in nu_leaves]
    new = [(x > 0) & (x < EPS_BOUND) for x in v]
    return new if mask is None else [a | b for a, b in zip(mask, new)]


def assert_params_close(got, want, mask, steps, lr, msg=""):
    """Leaves ``got`` (tensors) against ``want`` (numpy) after ``steps``
    AdamW steps of learning rate ``lr``: PARAM_TOL where the update
    never was eps-bound, one update a step where it was."""
    for j, (p, w, m) in enumerate(zip(got, want, mask)):
        diff = np.abs(p.detach().numpy() - w)
        off = diff > PARAM_TOL + PARAM_TOL * np.abs(w)
        assert not (off & ~m).any(), (
            f"{msg} leaf {j}: {(off & ~m).sum()} elements off, max "
            f"{diff[~m].max()}")
        assert diff.max() <= steps * lr, f"{msg} leaf {j}: {diff.max()}"


def _nu(opt_state):
    """optax.adamw's second moments, in tree_leaves order."""
    return [np.asarray(x)
            for x in jax.tree_util.tree_leaves(opt_state[0].nu)]


def _keytree(d):
    """The nested key structure of a stats dict."""
    if isinstance(d, dict):
        return {k: _keytree(v) for k, v in d.items()}
    return None


def _unique(tag, seed):
    return f"tpt_{tag}_{seed}"


# ---------------------------------------------------------------------------
# the recorders, fed the same scripts
# ---------------------------------------------------------------------------

@SEEDS
def test_train_telemetry_stats_match(seed):
    rng = np.random.default_rng(seed)
    durs = rng.uniform(1e-3, 2.0, 40)
    examples = rng.integers(0, 64, 40)
    out = []
    for m in (JAX, PORT):
        tel = m.tel.TrainTelemetry(_unique("tel", seed))
        for i, (d, n) in enumerate(zip(durs, examples)):
            if i % 7 == 0:
                tel.record_compile(f"sig{i}")
            tel.record_step(float(d), examples=int(n) or None)
        out.append(tel.stats())
    assert out[0] == out[1]


def _goodput_script(m, seed):
    rng = np.random.default_rng(seed)
    tr = m.gp.GoodputTracker(_unique("gp", seed), window=16)
    recs = []
    for i in range(30):
        if rng.random() < 0.6:
            tr.note_data_wait(float(rng.uniform(-1e-3, 5e-3)))
        if rng.random() < 0.4:
            tr.note_h2d(float(rng.uniform(0, 2e-3)))
        if rng.random() < 0.15:
            tr.record_checkpoint(["save", "restore"][i % 2],
                                 float(rng.uniform(0, 0.05)),
                                 nbytes=int(rng.integers(0, 10 ** 6)),
                                 step=i)
        device_s = (float(rng.uniform(0, 0.02)) if rng.random() < 0.3
                    else None)
        recs.append(tr.record_step(float(rng.uniform(0, 0.02)),
                                   compiled=(i % 11 == 0),
                                   device_s=device_s, now=float(i)))
    return recs, tr


@SEEDS
def test_goodput_tracker_matches(seed):
    (jrecs, jtr), (trecs, ttr) = (_goodput_script(m, seed)
                                  for m in (JAX, PORT))
    assert trecs == jrecs
    assert ttr.last_steps() == jtr.last_steps()
    assert ttr.anatomy() == jtr.anatomy()
    assert ttr.goodput_stats() == jtr.goodput_stats()
    assert ttr.checkpoint_stats() == jtr.checkpoint_stats()
    for rec in ttr.last_steps():
        legs = sum(rec[c] for c in tgp.ANATOMY_COMPONENTS)
        assert legs == pytest.approx(rec["step_wall_ms"], rel=1e-9,
                                     abs=1e-9)
    assert tgp.ANATOMY_COMPONENTS == jgp.ANATOMY_COMPONENTS


def test_disabled_tracker_records_nothing(monkeypatch):
    monkeypatch.setenv("RAYTPU_TRAINWATCH", "0")
    for m in (JAX, PORT):
        tr = m.gp.GoodputTracker("tpt_off")
        assert tr.enabled is False
        tr.note_data_wait(1.0)
        assert tr.record_step(0.1) is None
        assert tr.goodput_stats()["steps"] == 0


def _watchdog_script(m, seed, dump_dir):
    """Observations with a NaN loss, non-finite grads and a loss spike
    after the warm-up; the recorder and clock injected."""
    rng = np.random.default_rng(seed)
    rec = m.fr.FlightRecorder(f"train:{_unique('wd', seed)}")
    rec.dump_dir = dump_dir
    wd = m.gp.HealthWatchdog(_unique("wd", seed), warmup=5,
                             dump_cooldown=4, recorder=rec)
    anomalies = []
    for i in range(24):
        loss = float(1.0 + 0.01 * rng.standard_normal())
        grad = float(0.5 + 0.01 * rng.standard_normal())
        nonfinite = 0
        if i == 9:
            loss = float("nan")
        if i == 10:
            nonfinite, grad = 3, float("inf")
        if i == 17:
            loss = 40.0
        if i == 21:
            grad = 90.0
        anomalies.append(wd.observe(i, loss, grad_norm=grad,
                                    nonfinite=nonfinite,
                                    signature="(((2, 9), 'int32'),)",
                                    wall_ms=float(i), now=100.0 + i))
    return anomalies, wd, rec


def _strip_event(e):
    return {k: v for k, v in e.items() if k != "t_s"}


@SEEDS
def test_health_watchdog_matches(seed, tmp_path):
    (ja, jwd, jrec), (ta, twd, trec) = (
        _watchdog_script(m, seed, str(tmp_path / name))
        for m, name in ((JAX, "jax"), (PORT, "port")))
    assert ta == ja
    assert [a["reason"] for a in ta if a] == [
        "nonfinite_loss", "nonfinite_grads", "loss_spike", "grad_spike"]
    js, ts = jwd.stats(), twd.stats()
    assert len(ts.pop("dumps")) == len(js.pop("dumps")) == 3
    assert ts == js
    for jp, tp in zip(jwd.dumps, twd.dumps):
        jdoc, tdoc = (json.load(open(p)) for p in (jp, tp))
        assert tdoc["context"] == jdoc["context"]
        for k in ("source", "reason", "counts_by_kind", "events_recorded",
                  "events_retained", "events_dropped", "version"):
            assert tdoc[k] == jdoc[k], k
        assert [_strip_event(e) for e in tdoc["events"]] == \
            [_strip_event(e) for e in jdoc["events"]]
    assert [_strip_event(e) for e in trec.snapshot()] == \
        [_strip_event(e) for e in jrec.snapshot()]


@SEEDS
def test_worker_skew_and_dominant_component_match(seed):
    rng = np.random.default_rng(seed)
    for n in range(0, 7):
        times = {f"w{i}": float(rng.uniform(50, 250)) for i in range(n)}
        thr = float(rng.uniform(1.05, 1.6))
        assert tgp.worker_skew(times, threshold=thr) == \
            jgp.worker_skew(times, threshold=thr)
    for _ in range(10):
        anatomy = {c: ({"mean": float(rng.uniform(0, 10))}
                       if rng.random() < 0.8 else {})
                   for c in tgp.ANATOMY_COMPONENTS}
        assert tgp.dominant_component(anatomy) == \
            jgp.dominant_component(anatomy)
    assert tgp.dominant_component({}) is jgp.dominant_component({}) is None


def test_batch_signature_names_dtypes_as_jax_does():
    batch = {"x": np.zeros((8, 4), np.float32),
             "tokens": np.zeros((2, 9), np.int32)}
    want = jtel._batch_signature(batch)
    assert ttel._batch_signature(batch) == want
    tensors = {k: torch.from_numpy(v) for k, v in batch.items()}
    assert ttel._batch_signature(tensors) == want
    assert str(ttel._batch_signature(tensors)) == str(want)
    assert ttel._leading_dim(tensors) == jtel._leading_dim(batch) == 2


# ---------------------------------------------------------------------------
# build_train_step: the stack and its counts against the JAX package's
# ---------------------------------------------------------------------------

def _np_batches(n, seed=3):
    rng = np.random.default_rng(seed)
    return [{"tokens": rng.integers(0, 512, (2, 33)).astype(np.int32)}
            for _ in range(n)]


def _jax_llama():
    cfg = jl.llama_config("nano", dtype=jnp.float32, use_flash=False)
    return cfg, jl.llama_init(jax.random.PRNGKey(0), cfg)


def test_train_step_with_health_matches_jax_adamw(tmp_path, monkeypatch):
    monkeypatch.setenv("RAYTPU_FLIGHTREC_DIR", str(tmp_path))
    name = "tpt_llama"
    jcfg, jparams = _jax_llama()
    tx = optax.adamw(3e-4, weight_decay=0.1)
    jstate = tx.init(jparams)
    jstep = jax_utils.build_train_step(
        lambda p, b: jl.llama_loss(p, b, jcfg), tx, health=True,
        telemetry_name=name)

    cfg = tl.llama_config("nano", dtype=torch.float32)
    params = llama_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), cfg, device="cpu")
    ttx = adamw(3e-4, weight_decay=0.1)
    state = ttx.init(params)
    step = build_train_step(lambda p, b: tl.llama_loss(p, b, cfg), ttx,
                            health=True, telemetry_name=name)
    assert step._raw_step is not None and step.watchdog is not None

    jreg0 = jds.get_registry().snapshot().get("train.step", {})
    treg0 = tds.get_registry().snapshot().get("train.step", {})
    mask = None
    for i, b in enumerate(_np_batches(3)):
        jparams, jstate, jloss, jh = jstep(jparams, jstate, b)
        params, state, loss, h = step(params, state,
                                      {"tokens": torch.from_numpy(
                                          b["tokens"])})
        np.testing.assert_allclose(float(loss), float(jloss),
                                   atol=LOSS_TOL, rtol=LOSS_TOL)
        mask = eps_bound_mask(mask, _nu(jstate), i + 1)
        assert_params_close(
            tree_leaves(params),
            [np.asarray(x) for x in jax.tree_util.tree_leaves(jparams)],
            mask, i + 1, 3e-4, f"step {i + 1}")
    js, ts = jtel.train_stats(name), ttrainer.train_stats(name)
    assert _keytree(ts) == _keytree(js)
    for key in ("steps", "compiles", "examples"):
        assert ts[key] == js[key], key
    assert (ts["steps"], ts["compiles"]) == (3, 1)
    assert ts["health"]["observed"] == js["health"]["observed"] == 3
    assert ts["health"]["anomalies"] == js["health"]["anomalies"] == 0
    assert ts["goodput"]["steps"] == js["goodput"]["steps"] == 3
    assert ts["anatomy"]["step_wall_ms"]["count"] == 3
    assert ts["anatomy"]["compile_ms"]["count"] == 3
    for rec in step.goodput.last_steps():
        legs = sum(rec[c] for c in tgp.ANATOMY_COMPONENTS)
        assert legs == pytest.approx(rec["step_wall_ms"], rel=1e-9,
                                     abs=1e-9)
    assert tgp.get_train_recorder(name).counts_by_kind() == \
        jgp.get_train_recorder(name).counts_by_kind() == {"train_step": 3}
    # the registry's train.step: one compile event and two invokes in
    # both (the step's loss, grad norm and count as the JAX journal's)
    jreg = jds.get_registry().snapshot()["train.step"]
    treg = tds.get_registry().snapshot()["train.step"]
    for key in ("compile_events", "invokes"):
        assert treg[key] - treg0.get(key, 0) == \
            jreg[key] - jreg0.get(key, 0), key
    assert treg["compile_events"] - treg0.get("compile_events", 0) == 1
    jtrail = [{k: e[k] for k in ("step", "nonfinite")}
              for e in jgp.get_train_recorder(name).snapshot()]
    ttrail = tgp.get_train_recorder(name).snapshot()
    assert [{k: e[k] for k in ("step", "nonfinite")} for e in ttrail] \
        == jtrail
    for je, te in zip(jgp.get_train_recorder(name).snapshot(), ttrail):
        assert te["loss"] == pytest.approx(je["loss"], rel=LOSS_TOL)


def _mse_jax(params, batch):
    pred = batch["x"] @ params["w"]
    return jnp.mean((pred - batch["y"]) ** 2)


def _mse_torch(params, batch):
    return ((batch["x"] @ params["w"] - batch["y"]) ** 2).mean()


def _mse_batches(n, poison_at):
    rng = np.random.RandomState(0)
    for i in range(n):
        batch = {"x": rng.randn(8, 4).astype(np.float32),
                 "y": rng.randn(8, 2).astype(np.float32)}
        if i == poison_at:
            batch["x"][0, 0] = np.nan
        yield batch


def test_nan_dumps_within_the_step_in_both(tmp_path, monkeypatch):
    """The JAX package's NaN test (tests/test_trainwatch.py) run through
    both packages: the poisoned step's call returns with its dump
    written, naming the same trainer, step, reason and signature."""
    monkeypatch.setenv("RAYTPU_FLIGHTREC_DIR", str(tmp_path))
    name, poison_at = "tpt_nan", 4
    jtx = optax.adamw(1e-2)
    jstep = jax_utils.build_train_step(_mse_jax, jtx, health=True,
                                       telemetry_name=name)
    ttx = adamw(1e-2)
    tstep = build_train_step(_mse_torch, ttx, health=True,
                             telemetry_name=name)
    jp = {"w": jnp.ones((4, 2))}
    tp = {"w": torch.ones((4, 2))}
    js, ts = jtx.init(jp), ttx.init(tp)
    for i, b in enumerate(_mse_batches(6, poison_at)):
        jp, js, _, _ = jstep(jp, js, b)
        tp, ts, _, _ = tstep(tp, ts, {k: torch.from_numpy(v)
                                      for k, v in b.items()})
        if i == poison_at:
            assert len(jstep.watchdog.dumps) == len(tstep.watchdog.dumps) \
                == 1
    # the cooldown holds back the second NaN step's dump in both
    assert len(jstep.watchdog.dumps) == len(tstep.watchdog.dumps) == 1
    jdoc, tdoc = (json.load(open(s.watchdog.dumps[0]))
                  for s in (jstep, tstep))
    for key in ("trainer", "step", "reason", "metric", "value",
                "signature"):
        assert tdoc["context"][key] == jdoc["context"][key], key
    assert tdoc["context"]["step"] == poison_at
    assert tdoc["reason"] == jdoc["reason"] == \
        "train_anomaly_nonfinite_loss"
    assert tdoc["source"] == jdoc["source"] == f"train:{name}"
    assert tdoc["counts_by_kind"] == jdoc["counts_by_kind"]
    assert [e["step"] for e in tdoc["context"]["trail"]] == \
        [e["step"] for e in jdoc["context"]["trail"]]
    jst, tst = jtel.train_stats(name), ttel.train_stats(name)
    assert tst["health"]["anomalies"] == jst["health"]["anomalies"] == 2
    assert tst["health"]["dumps"] == tstep.watchdog.dumps


@pytest.mark.parametrize("stepped", [False, True], ids=["fresh", "stepped"])
def test_train_stats_key_tree_matches(stepped, tmp_path, monkeypatch):
    """The key tree of train_stats() equals the JAX package's (the
    golden schema of tests/test_trainwatch.py), fresh and after 3
    steps."""
    monkeypatch.setenv("RAYTPU_FLIGHTREC_DIR", str(tmp_path))
    name = f"tpt_schema_{stepped}"
    if stepped:
        jtx, ttx = optax.sgd(0.01), adamw(0.01)
        jstep = jax_utils.build_train_step(_mse_jax, jtx, health=True,
                                           telemetry_name=name)
        tstep = build_train_step(_mse_torch, ttx, health=True,
                                 telemetry_name=name)
        jp, tp = {"w": jnp.ones((4, 2))}, {"w": torch.ones((4, 2))}
        js, ts = jtx.init(jp), ttx.init(tp)
        for b in _mse_batches(3, None):
            jp, js, _, _ = jstep(jp, js, b)
            tp, ts, _, _ = tstep(tp, ts, {k: torch.from_numpy(v)
                                          for k, v in b.items()})
    js, ts = jtel.train_stats(name), ttel.train_stats(name)
    assert _keytree(ts) == _keytree(js)
    assert ts["anatomy"]["step_wall_ms"]["count"] == \
        js["anatomy"]["step_wall_ms"]["count"] == (3 if stepped else 0)
    assert ts["health"]["observed"] == js["health"]["observed"]
    assert (ts["goodput"]["ratio"] is None) == (not stepped)
    assert name in tgp.registered_trainers()


def test_instrumented_step_donates_and_keeps_outputs():
    """Telemetry on or off, the step returns what the raw step returns
    (same objects with donation) and keeps its signature counts."""
    cfg = tl.llama_config("nano", dtype=torch.float32)
    params = tl.llama_init(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    tx = adamw(3e-4)
    state = tx.init(params)
    step = build_train_step(lambda p, b: tl.llama_loss(p, b, cfg), tx,
                            telemetry_name="tpt_donate")
    b = {"tokens": torch.randint(0, 512, (2, 17))}
    out = step(params, state, b)
    assert len(out) == 3 and out[0] is params and out[1] is state
    assert state["count"].dtype == torch.int32 and int(state["count"]) == 1
    step(params, state, {"tokens": torch.randint(0, 512, (2, 9))})
    st = ttel.train_stats("tpt_donate")
    assert (st["steps"], st["compiles"]) == (2, 2)
    assert st["health"]["observed"] == 0
    assert not hasattr(build_train_step(lambda p, b: 0.0, tx,
                                        telemetry=False), "goodput")


def test_fetch_health_is_one_copy_of_exact_values():
    scalars = {"loss": torch.tensor(2.5), "grad_norm": torch.tensor(
        float("inf")), "nonfinite": torch.tensor(2 ** 24 + 1,
                                                 dtype=torch.int32)}
    got = tgp._fetch_health(scalars)
    assert got["loss"] == 2.5 and math.isinf(got["grad_norm"])
    assert got["nonfinite"] == 2 ** 24 + 1      # float64 keeps it exact
    assert tgp._fetch_health({"loss": torch.tensor(1.0)}) == {"loss": 1.0}


def test_registry_instrument_takes_n_devices():
    """Any device count is taken and recorded per program; the
    snapshot keeps the JAX key set.  The programs dispatch no tensor
    work, so the harvest books no cost and mfu stays None, as the JAX
    registry gives for the same calls (it harvests nothing from a
    function it cannot lower)."""
    from ray_tpu._private import device_stats as jds

    snaps = {}
    for k, mod in (("t", tds), ("j", jds)):
        reg = mod.ProgramRegistry()
        wrapped = reg.instrument("t.prog", lambda x: x + 1, n_devices=1)
        assert wrapped(1) == 2
        four = reg.instrument("t.sharded", lambda x: x * 2, n_devices=4)
        assert four(3) == 6 and four(3) == 6   # a compile, an invoke
        snaps[k] = reg.snapshot(prefix="t.", n_devices=4)
        if k == "t":
            assert (reg.devices_of("t.prog"),
                    reg.devices_of("t.sharded")) == (1, 4)
            assert reg.devices_of("t.never") == 1
    snap = snaps["t"]
    assert snap["t.sharded"]["invokes"] == 1
    assert snap["t.sharded"]["compile_events"] == 1
    for key in ("mfu", "xla_flops", "bytes_accessed", "peak_hbm_bytes"):
        assert snap["t.sharded"][key] is None
        assert snaps["j"]["t.sharded"][key] is None
    assert set(snap["t.sharded"]) == set(snap["t.prog"]) \
        == set(snaps["j"]["t.sharded"])


# ---------------------------------------------------------------------------
# the instrumented training bench (bench.py --train)
# ---------------------------------------------------------------------------

def test_train_watch_returns_the_reference_records():
    args = types.SimpleNamespace(preset="nano", chips=None, batch=2,
                                 steps=3)
    jbench._EMITTED.clear()
    jbench.main_train_watch(args, on_tpu=False)
    want = list(jbench._EMITTED)
    jbench._EMITTED.clear()
    got = tbench.train_watch(preset="nano", seq=128, batch=2, n_steps=3,
                             device="cpu")
    assert [r["metric"] for r in got] == [r["metric"] for r in want] == [
        "train_goodput", "train_data_wait_ms_p50", "train_data_wait_ms_p99"]
    for g, w in zip(got, want):
        assert set(g) == set(w)
        assert set(g["detail"]) == set(w["detail"])
        assert g["unit"] == w["unit"]
    detail = got[0]["detail"]
    assert detail["steps"] == 4 and detail["anomalies"] == 0
    assert detail["backend"] == "cpu" and detail["chips"] == 1
    assert 0 < got[0]["value"] <= 1
    assert set(detail["anatomy_mean_ms"]) == \
        set(want[0]["detail"]["anatomy_mean_ms"])
    # every batch copy was booked into the h2d leg
    assert ttel.train_stats("bench_train")["anatomy"]["h2d_ms"]["count"] \
        >= 4
