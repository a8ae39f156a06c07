"""``python -m ray_tpu_torch.bench`` against the repo's ``bench.py``, on
the CPU.

``parse_args`` of both gives the same flags and defaults; the port adds
one flag, ``--device`` (its counterpart of ``JAX_PLATFORMS=cpu``), and
drops none: every TPU-only part of the JAX harness is code, not a flag
(``_probe_tpu``, ``_pin_cpu``, ``ensure_backend`` and the
``BENCH_TPU_LAST.json`` record, whose ``last_known_tpu_result`` detail
key the port does not emit).

Each mode runs on both at the reference's CPU-smoke configuration
(``bench.py`` under ``JAX_PLATFORMS=cpu``, the port's with
``device="cpu"``), cut by the same flags to a few steps or requests, and
must print the same metric-line names, units and detail keys with equal
deterministic fields (shapes, counts, layouts; not times).  GPT-2 tiny's
greedy ``--decode`` tokens are held to the JAX package's on the same
weights (``models/convert.py``).  The options that wait for a ROADMAP.md
item raise naming it, the module's run appends its lines to the perf
ledger its environment names, and without a card the bench raises
instead of falling back to the CPU.
"""

import contextlib
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import re

import pytest
import torch

import bench as jbench
from ray_tpu_torch import bench as tbench

ROOT = Path(__file__).resolve().parents[1]
#: flags the port adds (none of the JAX harness's is dropped)
PORT_ONLY_FLAGS = {"device"}
#: detail keys the port does not emit: the JAX harness's TPU record
JAX_ONLY_DETAIL = {"last_known_tpu_result"}


@pytest.mark.parametrize("argv", [
    [],
    ["--decode", "--spec-k", "4", "--spec-draft", "ngram",
     "--prompt-len", "64", "--new-tokens", "8"],
    ["--traffic", "--replicas", "3", "--prefill-chunk", "0",
     "--kv-layout", "dense", "--kv-host-tier-bytes", "1024"],
    ["--traffic", "--prefill-replicas", "1", "--decode-replicas", "2",
     "--handoff-staged", "--chaos-freeze-replica", "0", "--requests", "8"],
    ["--chips", "2", "--mesh", "fsdp", "--remat", "dots_nb",
     "--ce-impl", "pallas", "--flash-resident", "on", "--batch", "8",
     "--steps", "3", "--preset", "gpt2-medium"],
    ["--train", "--profile", "/tmp/p", "--no-ledger", "--autopilot"],
], ids=["defaults", "decode", "traffic", "disagg", "train-shape", "train"])
def test_parse_args_matches_jax(argv):
    want = vars(jbench.parse_args(argv))
    got = vars(tbench.parse_args(argv))
    assert set(got) - set(want) == PORT_ONLY_FLAGS
    assert {k: got[k] for k in want} == want
    assert got["device"] is None


@pytest.mark.parametrize("argv", [["--mesh", "ring"], ["--remat", "x"],
                                  ["--ce-impl", "fused"],
                                  ["--kv-layout", "ring"], ["--steps", "a"]])
def test_parse_args_rejects_alike(argv, capsys):
    for mod in (jbench, tbench):
        with pytest.raises(SystemExit) as e:
            mod.parse_args(argv)
        assert e.value.code == 2
    errs = [ln for ln in capsys.readouterr().err.splitlines()
            if "error:" in ln]
    assert len(errs) == 2
    assert errs[0].split("error:", 1)[1] == errs[1].split("error:", 1)[1]


def _run(mod, argv, **kw):
    """The metric lines ``mod.main`` prints."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        mod.main(mod.parse_args(argv), **kw)
    return [json.loads(ln) for ln in out.getvalue().splitlines()
            if ln.startswith("{")]


def _key_tree(d):
    if isinstance(d, dict):
        return {k: _key_tree(v) for k, v in d.items()}
    return None


#: per mode: its flags, and the detail fields equal on both.  The JAX
#: harness's training modes count every local JAX device as a chip (the
#: tests' eight emulated host devices); the port runs one device, so
#: their "chips" is not compared
MODES = {
    "train-default": (["--steps", "1"],
                      ["batch", "seq", "mesh", "model_flops",
                       "remat_policy", "ce_impl", "flash_resident",
                       "backend"]),
    "decode": (["--decode", "--new-tokens", "4"],
               ["chips", "batch", "prompt_len", "new_tokens", "preset",
                "mesh", "flash_resident", "backend"]),
    "decode-spec": (["--decode", "--spec-k", "2"],
                    ["chips", "batch", "prompt_len", "new_tokens",
                     "preset", "spec_k", "spec_draft", "kv_layout",
                     "mesh", "backend"]),
    "traffic": (["--traffic", "--requests", "6"],
                ["chips", "requests", "completed", "shed", "kv_layout",
                 "preset", "backend"]),
    # --mesh tensor at one rank: the single-device path, as the
    # reference's decode_mesh(1) gives (2 gloo ranks shard it:
    # tests/test_torch_sharded_decode.py)
    "decode-tensor": (["--decode", "--mesh", "tensor", "--new-tokens", "4"],
                      ["chips", "batch", "prompt_len", "new_tokens",
                       "preset", "mesh", "flash_resident", "backend"]),
    "traffic-tensor": (["--traffic", "--mesh", "tensor", "--requests", "6"],
                       ["chips", "requests", "completed", "shed",
                        "kv_layout", "preset", "mesh_axes", "backend"]),
    "traffic-fleet": (["--traffic", "--replicas", "2", "--requests", "6"],
                      ["replicas", "requests", "completed", "shed",
                       "preset", "routing", "wfq", "backend"]),
    "train-watch": (["--train", "--steps", "1"],
                    ["batch", "seq", "preset", "steps"]),
}


@pytest.mark.parametrize("mode", list(MODES))
def test_cpu_mode_matches_jax(mode):
    flags, fields = MODES[mode]
    argv = [*flags, "--no-ledger"]
    want = _run(jbench, argv)
    got = _run(tbench, argv, device="cpu")
    assert [(r["metric"], r["unit"]) for r in got] == \
        [(r["metric"], r["unit"]) for r in want]
    for w, g in zip(want, got):
        wd = {k: v for k, v in w["detail"].items()
              if k not in JAX_ONLY_DETAIL}
        assert set(g["detail"]) == set(wd), w["metric"]
        if "engine" in wd:
            assert _key_tree(g["detail"]["engine"]) == \
                _key_tree(wd["engine"])
        assert {k: g["detail"].get(k) for k in fields} == \
            {k: wd.get(k) for k in fields}, w["metric"]
        if mode == "train-default":
            # MFU against the card's peak: none off the card (the JAX
            # harness states one against its CPU table entry)
            assert g["vs_baseline"] is None and g["detail"]["mfu"] is None
        else:
            assert g["vs_baseline"] is None and w["vs_baseline"] is None
    if mode == "decode-spec":
        # an aligned draft is the target itself: every draft accepted
        assert [r["value"] for r in got][1] == [r["value"]
                                                for r in want][1] == 1.0


def test_decode_greedy_tokens_match_jax():
    """``time_decode``'s prefill and greedy steps on GPT-2 tiny, in f32,
    give the JAX package's tokens on the same weights and prompt (the
    port's, drawn from a CPU generator seeded 1)."""
    from ray_tpu.models import decode_common as jdc
    from ray_tpu.models import gpt2 as jgpt2
    from ray_tpu.models import gpt2_decode as jdec
    from ray_tpu_torch.models.convert import gpt2_params_from_numpy
    from ray_tpu_torch.models.gpt2 import gpt2_config

    batch, prompt_len, new = 3, 16, 5
    jcfg = jgpt2.gpt2_config("tiny", dtype=jnp.float32, use_flash=False,
                             remat=False)
    jparams = jgpt2.gpt2_init(jax.random.PRNGKey(0), jcfg)
    tcfg = gpt2_config("tiny", dtype=torch.float32, use_flash=False)
    params = gpt2_params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg,
                                    "cpu")
    prompt = torch.randint(0, jcfg.vocab_size, (batch, prompt_len),
                           generator=torch.Generator().manual_seed(1)
                           ).numpy().astype(np.int32)

    tail = jdc.make_vocab_tail_mask(jcfg)
    logits, cache = jdec.prefill(jparams, jnp.asarray(prompt), jcfg)
    tok = jdc.sample_token(logits, None, 0.0, tail)
    want = [np.asarray(tok)]
    for _ in range(new):
        logits, cache = jdec.decode_step(jparams, cache, tok, jcfg)
        tok = jdc.sample_token(logits, None, 0.0, tail)
        want.append(np.asarray(tok))

    _, _, stats, n_chips, got = tbench.time_decode(
        batch, prompt_len=prompt_len, new_tokens=new, preset="tiny",
        device="cpu", params=params, dtype=torch.float32, use_flash=False)
    assert n_chips == 1
    assert got.numpy().tolist() == [w.tolist() for w in want]
    assert stats["requests"]["finished"] == 3


@pytest.mark.parametrize("argv,exc,match", [
    # a mesh spans the process group's ranks: more chips than it has
    # raise (this process has no group: one rank)
    pytest.param(["--chips", "2"], ValueError,
                 r"above the process group's world size 1",
                 id="argv0-item 7\\.7"),
    # --mesh tensor shards the decode over the group's ranks: more
    # than it has raise as any --chips does
    pytest.param(["--decode", "--mesh", "tensor", "--chips", "4"],
                 ValueError, r"above the process group's world size 1",
                 id="argv2-item 7\\.7"),
    # ported (tools/autopilot): runs and emits its attribution line
    pytest.param(["--autopilot", "--steps", "1", "--no-ledger"], None,
                 r'^\{"autopilot": \{', id="argv3-item 7\\.12"),
])
def test_unported_options_raise_naming_their_item(argv, exc, match,
                                                  capsys):
    if exc is None:
        tbench.main(tbench.parse_args(argv), device="cpu")
        last = capsys.readouterr().out.strip().splitlines()[-1]
        assert re.match(match, last), last
        return
    with pytest.raises(exc, match=match):
        tbench.main(tbench.parse_args(argv), device="cpu")


@pytest.mark.parametrize("mesh", ["fsdp", "data_fsdp"])
def test_train_meshes_run_on_one_rank(mesh):
    """``--mesh fsdp`` / ``data_fsdp`` (once argv1 above, raising) run:
    without a process group the mesh is one device, and the metric
    line is the ``data`` run's but for its mesh field (the JAX
    harness's layouts over more devices are held to on gloo ranks in
    tests/test_torch_parallel.py)."""
    argv = ["--steps", "1", "--no-ledger"]
    base = _run(tbench, argv, device="cpu")
    got = _run(tbench, [*argv, "--mesh", mesh], device="cpu")
    assert [r["metric"] for r in got] == [r["metric"] for r in base]
    d, bd = got[0]["detail"], base[0]["detail"]
    assert d["mesh"] == ("data" if mesh == "data_fsdp" else mesh)
    assert d["chips"] == bd["chips"] == 1
    assert d["loss"] == bd["loss"] and d["model_flops"] == bd["model_flops"]
    with pytest.raises(SystemExit, match="serve layout"):
        tbench.main(tbench.parse_args(["--mesh", "tensor"]), device="cpu")


def test_no_card_raises_instead_of_falling_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tbench.main(tbench.parse_args(["--decode"]))


def test_module_entry_point_prints_its_lines(tmp_path):
    """``python -m ray_tpu_torch.bench --decode --device cpu``: the
    metric lines on stdout, exit 0, and the lines appended to the perf
    ledger that RAYTPU_BENCH_HISTORY names (tools/perfledger.py),
    reported on stderr as the JAX harness reports its append."""
    hist = tmp_path / "hist.jsonl"
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    env["RAYTPU_BENCH_HISTORY"] = str(hist)
    r = subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch.bench", "--decode",
         "--device", "cpu", "--new-tokens", "2"], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    names = [json.loads(ln)["metric"] for ln in r.stdout.splitlines()]
    assert names == ["gpt2_decode_cpu_smoke_prefill_ttft_ms",
                     "gpt2_decode_cpu_smoke_tokens_per_sec",
                     "gpt2_decode_cpu_smoke_tokens_per_sec_per_chip"]
    assert f"bench: 3 record(s) appended to {hist}" in r.stderr
    assert [json.loads(ln)["record"]["metric"]
            for ln in hist.read_text().splitlines()] == names
