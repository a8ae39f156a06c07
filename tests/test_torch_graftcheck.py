"""graftcheck on the port (``ray_tpu_torch/tools/graftcheck``), on the
CPU: the cases of ``tests/test_graftcheck.py``.

1. **repo guard** — the full check over this checkout (the linter over
   ``ray_tpu_torch/`` and the program audit of the catalog's 13
   programs) comes back clean, with the port's three restored serve
   waivers visible; the catalogs are the JAX package's.
2. **planted program violations** — each audit rule fires on a minimal
   program that breaks exactly it (``.item()``, f64, an f32 product, a
   logits buffer, a per-token prefill loop, a dropped in-place update,
   a blown budget, a missing collective, a whole-buffer shape, a
   per-chip blowup); where the JAX auditor works on the same plant
   (f32-matmul, logits-buffer, t0-scan) both packages flag the same
   rule.
3. **lint fixtures** — each ast rule, the waiver hygiene and the
   registry checks, with the port's scopes and files.

The JAX catalog is not re-run here (tests/test_graftcheck.py runs it).
"""

import json
import pathlib
import subprocess
import sys
import textwrap

import pytest
import torch

from ray_tpu_torch.tools import graftcheck as gc
from ray_tpu_torch.tools.graftcheck.lint import (KERNEL_EXPORTS,
                                                 _autopilot_attribution,
                                                 _cuda_kernel_tests,
                                                 _observatory_mapping,
                                                 kernel_modules, lint_source)
from ray_tpu_torch.tools.graftcheck.trace_audit import (ProgramSpec,
                                                        audit_program)

ROOT = pathlib.Path(__file__).resolve().parents[1]
_SERVE = "ray_tpu_torch/serve/fixture.py"


# ---------------------------------------------------------------------------
# 1. the repo guard
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def repo_report():
    return gc.run_repo_check(ROOT)


def test_repo_is_clean(repo_report):
    assert repo_report["ok"], gc.render_text(repo_report)


def test_repo_audit_covers_the_catalog(repo_report):
    from ray_tpu.tools.graftcheck.programs import \
        default_programs as jax_programs

    names = [s.name for s in jax_programs()]
    assert sorted(repo_report["programs"]) == sorted(names)
    assert len(names) == 13
    for name, info in repo_report["programs"].items():
        assert "error" not in info, f"{name} failed: {info}"
        if name == "gpt2_sharded_decode_step":
            # below its two ranks here; tests/test_torch_sharded_decode
            # runs it on the tensor-parallel ranks
            assert info == {"skipped": "requires >= 2 ranks, have 1"}
            continue
        assert info["ops"] > 0
        assert 0 < info["peak_hbm_bytes"] <= info["hbm_budget_bytes"]
    assert repo_report["programs"]["gpt2_prefill_ragged"][
        "t0_scan_ops"]["64"][0] == repo_report["programs"][
        "gpt2_prefill_ragged"]["t0_scan_ops"]["64"][1]


def test_repo_suppressions_are_visible(repo_report):
    # serve/llm.py's three host-side normalizations carry their waivers
    assert repo_report["summary"]["n_suppressed"] >= 3
    assert repo_report["summary"]["files_scanned"] > 100
    assert "gpt2_train_step" in gc.render_text(repo_report)


def test_catalogs_equal_the_jax_package():
    from ray_tpu._private import device_stats as jds
    from ray_tpu.serve import kvscope as jkvscope
    from ray_tpu.tools.autopilot.attribution import PROGRAM_KNOBS as jknobs
    from ray_tpu.tools.graftcheck import lint as jlint
    from ray_tpu.tools.graftcheck.programs import \
        default_programs as jprograms
    from ray_tpu_torch._private import device_stats as tds
    from ray_tpu_torch.serve import kvscope as tkvscope
    from ray_tpu_torch.tools.autopilot.attribution import PROGRAM_KNOBS
    from ray_tpu_torch.tools.graftcheck.programs import default_programs

    assert tds.KNOWN_PROGRAMS == jds.KNOWN_PROGRAMS
    assert tds.STATIC_PROGRAM_MAP == jds.STATIC_PROGRAM_MAP
    assert PROGRAM_KNOBS == jknobs
    tspecs = {s.name: s for s in default_programs()}
    jspecs = {s.name: s for s in jprograms()}
    assert list(tspecs) == list(jspecs)
    for name, j in jspecs.items():
        t = tspecs[name]
        assert (t.hbm_budget_bytes, t.per_chip_hbm_budget_bytes,
                t.forbid_logits, t.donate_argnums, t.allow_f32_matmul) \
            == (j.hbm_budget_bytes, j.per_chip_hbm_budget_bytes,
                j.forbid_logits, j.donate_argnums, j.allow_f32_matmul)
    assert tkvscope.serve_program_budget_bytes() == \
        jkvscope.serve_program_budget_bytes() == 6 * 2 ** 20
    assert gc.KNOWN_RULES == jlint.KNOWN_RULES | {"cuda-kernel-test"}


def test_kernel_detectors_not_vacuous():
    import ray_tpu_torch.ops as ops

    assert kernel_modules(ROOT) == ["flash_attention", "fused_ce"]
    assert _cuda_kernel_tests(ROOT) == []
    for name in KERNEL_EXPORTS:
        assert name in ops.__all__ and callable(getattr(ops, name))


def test_cuda_kernel_test_planted(tmp_path):
    ops_dir = tmp_path / "ray_tpu_torch" / "ops"
    ops_dir.mkdir(parents=True)
    (ops_dir / "newk.py").write_text(
        "def f(x):\n    return _kernels.launch('newk', 'f', (x,), (), 0)\n")
    tests = tmp_path / "tests"
    tests.mkdir()
    vs = _cuda_kernel_tests(tmp_path)
    assert [v.rule for v in vs] == ["cuda-kernel-test"] * 2
    (tests / "test_torch_newk.py").write_text("def test_cpu(): pass\n")
    (tests / "test_torch_newk_kernel.py").write_text(
        "import pytest\n# newk\npytestmark = pytest.mark.cuda\n")
    assert _cuda_kernel_tests(tmp_path) == []


def test_observatory_and_autopilot_mappings(monkeypatch):
    from ray_tpu_torch._private import device_stats as ds
    from ray_tpu_torch.tools.autopilot import attribution as ap

    assert _observatory_mapping() == []
    assert _autopilot_attribution() == []
    missing = dict(ds.STATIC_PROGRAM_MAP)
    del missing["gpt2_train_step"]
    monkeypatch.setattr(ds, "STATIC_PROGRAM_MAP", missing)
    assert {v.rule for v in _observatory_mapping()} == \
        {"observatory-mapping"}
    monkeypatch.setattr(ds, "STATIC_PROGRAM_MAP",
                        {**missing, "gpt2_train_step": "serve.bogus",
                         "ghost_spec": "train.step"})
    msgs = [v.message for v in _observatory_mapping()]
    assert any("not a KNOWN_PROGRAMS" in m for m in msgs)
    assert any("matches no" in m for m in msgs)
    monkeypatch.undo()
    knobs = dict(ap.PROGRAM_KNOBS)
    del knobs["train.step"]
    knobs["serve.bogus"] = ("spec_k",)
    monkeypatch.setattr(ap, "PROGRAM_KNOBS", knobs)
    msgs = [v.message for v in _autopilot_attribution()]
    assert any("'train.step'" in m for m in msgs)
    assert any("not a KNOWN_PROGRAMS" in m for m in msgs)


# ---------------------------------------------------------------------------
# 2. planted program violations
# ---------------------------------------------------------------------------

def _spec(fn, args, **kw):
    return ProgramSpec(name="planted", build=lambda: (fn, args), **kw)


def _rules(violations):
    return {v.rule for v in violations}


def _jax_rules(fn, args, **kw):
    from ray_tpu.tools.graftcheck.jaxpr_audit import ProgramSpec as JSpec
    from ray_tpu.tools.graftcheck.jaxpr_audit import \
        audit_program as jaudit

    return _rules(jaudit(JSpec(name="planted", build=lambda: (fn, args),
                               **kw))[0])


@pytest.mark.parametrize("plant", ["item", "int", "nonzero", "bool_index"])
def test_planted_host_transfer_detected(plant):
    def fn(x):
        if plant == "item":
            return x * x[0].item()
        if plant == "int":
            return x[: int(x.sum())]
        if plant == "nonzero":
            return torch.nonzero(x)
        return x[x > 0]

    vs, _ = audit_program(_spec(fn, (torch.ones(8),)))
    assert "host-transfer" in _rules(vs)
    vs, _ = audit_program(_spec(lambda x: x * 2, (torch.ones(8),)))
    assert "host-transfer" not in _rules(vs)


def test_planted_f64_detected():
    vs, _ = audit_program(_spec(
        lambda x: (x.double() * 2.0).float(), (torch.zeros(8, 8),)))
    assert "f64" in _rules(vs)


def test_planted_f32_matmul_detected_as_in_jax():
    import jax.numpy as jnp

    x = torch.zeros(256, 256)         # 65536 elements = the threshold
    vs, _ = audit_program(_spec(lambda a: a @ a.T, (x,)))
    assert "f32-matmul" in _rules(vs)
    assert "f32-matmul" in _jax_rules(lambda a: a @ a.T,
                                      (jnp.zeros((256, 256)),))
    vs, _ = audit_program(_spec(lambda a: a @ a.T, (x,),
                                allow_f32_matmul=True))
    assert "f32-matmul" not in _rules(vs)
    vs, _ = audit_program(_spec(lambda a: a @ a.T,
                                (x.to(torch.bfloat16),)))
    assert "f32-matmul" not in _rules(vs)

    def serve_style(a):
        with torch.inference_mode():     # matmul reaches the mode whole
            return torch.einsum("ij,kj->ik", a, a) + a @ a.T

    vs, _ = audit_program(_spec(serve_style, (x,)))
    assert [v.rule for v in vs] == ["f32-matmul"] * 2


def test_planted_logits_buffer_detected_as_in_jax():
    import jax.numpy as jnp

    kw = dict(forbid_logits=(128, 512), allow_f32_matmul=True)
    for rows, flagged in ((128, True), (64, False)):
        h, w = torch.zeros(rows, 64), torch.zeros(512, 64)
        vs, _ = audit_program(_spec(lambda a, b: a @ b.T, (h, w), **kw))
        assert ("logits-buffer" in _rules(vs)) is flagged
        jrules = _jax_rules(lambda a, b: a @ b.T,
                            (jnp.zeros((rows, 64)), jnp.zeros((512, 64))),
                            **kw)
        assert ("logits-buffer" in jrules) is flagged


def test_planted_t0_scan_detected_as_in_jax():
    """A per-token prefill loop: its op count grows with the prompt (the
    JAX plant: a scan of length T0)."""
    import jax
    import jax.numpy as jnp

    def per_token_at(t):
        def fn(x):
            c = torch.zeros(())
            for i in range(x.shape[0]):
                c = c + x[i]
            return c
        return fn, (torch.zeros(t),)

    def batched_at(t):
        return (lambda x: x.sum()), (torch.zeros(t),)

    for build_at, flagged in ((per_token_at, True), (batched_at, False)):
        spec = ProgramSpec(name="planted", build=lambda b=build_at: b(64),
                           build_at=build_at, forbid_scan_lengths=(64,))
        vs, info = audit_program(spec)
        assert ("t0-scan" in _rules(vs)) is flagged, info

    def scanned(xs):
        c, _ = jax.lax.scan(lambda c, x: (c + x, x), jnp.zeros(()), xs)
        return c

    assert "t0-scan" in _jax_rules(scanned, (jnp.zeros((64,)),),
                                   forbid_scan_lengths=(64,))


def test_planted_dropped_donation_detected():
    """A train step that returns new parameters instead of updating
    them in place keeps two copies live."""
    params = {"w": torch.ones(32, 32), "b": torch.ones(32)}

    def dropped(p):
        return {k: v - 0.1 for k, v in p.items()}

    def in_place(p):
        for v in p.values():
            v.sub_(0.1)
        return p

    vs, _ = audit_program(_spec(dropped, (params,), donate_argnums=(0,)))
    assert "donation" in _rules(vs)
    vs, _ = audit_program(_spec(in_place, (params,), donate_argnums=(0,)))
    assert "donation" not in _rules(vs)

    def rebinds_b(p):
        p["w"].sub_(0.1)
        return {"w": p["w"], "b": p["b"] + 1}

    vs, _ = audit_program(_spec(rebinds_b, (params,), donate_argnums=(0,)))
    assert "donation" in _rules(vs)
    vs, _ = audit_program(_spec(rebinds_b, (params,), donate_argnums=(0,),
                                rebinds={"b": "a bias row, by design"}))
    assert "donation" not in _rules(vs)


def test_planted_hbm_budget_blowup_detected():
    x = torch.zeros(256, 256)                  # 256 KiB argument
    vs, info = audit_program(_spec(lambda a: a @ a.T, (x,),
                                   allow_f32_matmul=True,
                                   hbm_budget_bytes=300 * 1024))
    assert "hbm-budget" in _rules(vs)
    assert info["peak_hbm_bytes"] == 2 * 256 * 256 * 4


def test_planted_collectives_and_per_chip_detected():
    x = torch.zeros(64, 64)
    vs, info = audit_program(_spec(
        lambda a: a * 2, (x,), require_collectives=("all_reduce",),
        forbid_shapes=((64, 64),), per_chip_hbm_budget_bytes=1024))
    msgs = [v.message for v in vs]
    assert _rules(vs) == {"collectives", "per-chip-hbm"}
    assert any("no 'all_reduce'" in m for m in msgs)
    assert any("(64, 64)" in m for m in msgs)
    assert info["per_chip_hbm_bytes"] == 2 * 64 * 64 * 4


def test_min_ranks_skips_not_fails():
    vs, info = audit_program(_spec(lambda a: a.item(), (torch.ones(()),),
                                   min_ranks=2))
    assert vs == [] and "skipped" in info


def test_planted_spec_verify_full_logits_detected():
    """The catalog's spec-verify program, with a full (B*max_seq, V)
    buffer planted into it, trips the rule under its own spec."""
    from ray_tpu_torch.tools.graftcheck.programs import default_programs

    spec = next(s for s in default_programs()
                if s.name == "gpt2_spec_verify_step")
    assert spec.donate_argnums == (1,) and "pos" in spec.rebinds
    fn, args = spec.build()

    def bad(p, c, b, g):
        out, n_acc, cache = fn(p, c, b, g)
        full = torch.zeros(spec.forbid_logits)
        return out, n_acc + full.sum().to(n_acc.dtype), cache

    vs, _ = audit_program(ProgramSpec(
        name="planted", build=lambda: (bad, args),
        forbid_logits=spec.forbid_logits,
        donate_argnums=spec.donate_argnums, rebinds=spec.rebinds,
        allow_f32_matmul=True))
    assert _rules(vs) == {"logits-buffer"}


def test_audit_error_is_reported_not_raised():
    def boom():
        raise RuntimeError("no build")

    vs, infos = gc.audit_programs([ProgramSpec(name="x", build=boom)])
    assert [v.rule for v in vs] == ["audit-error"]
    assert infos["x"] == {"error": "RuntimeError"}


# ---------------------------------------------------------------------------
# 3. lint fixtures
# ---------------------------------------------------------------------------

def test_lint_blocking_calls_and_scope():
    src = textwrap.dedent("""\
        import time
        import numpy as np
        import torch
        import ray_tpu_torch

        async def handler(ref, prompt, ev):
            x = ray_tpu_torch.get(ref)
            torch.cuda.synchronize()
            ev.synchronize()
            time.sleep(1)
            return np.asarray(prompt)

        def sync_helper(p):
            return np.asarray(p)
    """)
    kept, n_sup = lint_source(src, _SERVE)
    assert [v.rule for v in kept] == ["blocking-call-in-async"] * 5
    assert n_sup == 0
    assert lint_source(src, "ray_tpu_torch/train/fixture.py")[0] == []
    assert lint_source(src, "ray_tpu_torch/tools/autopilot/x.py")[0]


def test_lint_wallclock_metric_and_mutable_global():
    src = "import time\n\ndef record():\n    return time.time()\n"
    for rel in ("ray_tpu_torch/serve/telemetry.py",
                "ray_tpu_torch/tools/autopilot/verdict.py",
                "ray_tpu_torch/serve/kv_tier.py"):
        assert [v.rule for v in lint_source(src, rel)[0]] == \
            ["wallclock-in-telemetry"]
    assert lint_source(src, "ray_tpu_torch/train/trainer.py")[0] == []
    src = textwrap.dedent("""\
        from ray_tpu_torch.util.metrics import Counter

        c = Counter("Bad-Name", "desc")
    """)
    assert [v.rule for v in lint_source(src, "ray_tpu_torch/util/x.py")[0]] \
        == ["metric-name"]
    kept, n_sup = lint_source(src.replace(
        'c = Counter("Bad-Name", "desc")',
        'c = Counter("Bad-Name", "desc")  '
        '# graftcheck: disable=metric-name(legacy dashboard name)'),
        "ray_tpu_torch/util/x.py")
    assert kept == [] and n_sup == 1
    src = textwrap.dedent("""\
        import ray_tpu_torch
        SEEN = []

        @ray_tpu_torch.remote
        def task(x):
            SEEN.append(x)
    """)
    assert [v.rule for v in lint_source(src, "ray_tpu_torch/x.py")[0]] \
        == ["mutable-global-in-remote"]


_HYGIENE = textwrap.dedent("""\
    import numpy as np

    async def handler(prompt):
        # graftcheck: disable=blocking-call-in-async{reason}
        return np.asarray(prompt)
""")


@pytest.mark.parametrize("src,want", [
    (_HYGIENE.format(reason=""), ["suppression-reason"]),
    (_HYGIENE.format(reason="(host-side fixture)"), []),
    ("# graftcheck: disable=no-such-rule(typo)\nx = 1\n",
     ["stale-suppression"]),
    ("# graftcheck: disable=blocking-call-in-async(left behind)\nx = 1\n",
     ["stale-suppression"]),
    ("# graftcheck: disable=all(generated file)\nx = 1\n",
     ["stale-suppression"]),
], ids=["bare", "reasoned", "unknown", "noop", "noop-all"])
def test_waiver_hygiene(src, want):
    from ray_tpu.tools.graftcheck.lint import lint_source as jlint_source

    kept, _ = lint_source(src, _SERVE)
    assert [v.rule for v in kept] == want
    jkept, _ = jlint_source(src, "ray_tpu/serve/fixture.py")
    assert [v.rule for v in jkept] == want


def test_contract_registry_and_perfledger_direction(monkeypatch):
    import ray_tpu_torch.serve.telemetry as telemetry
    import ray_tpu_torch.tools.perfledger as perfledger
    import ray_tpu_torch.tools.tracebus as tracebus
    from ray_tpu_torch.tools.graftcheck.contracts import (
        contract_registry, perfledger_direction)

    assert contract_registry(ROOT) == []
    assert perfledger_direction(ROOT) == []
    monkeypatch.setattr(
        telemetry, "CRITICAL_PATH_COMPONENTS",
        tuple(telemetry.CRITICAL_PATH_COMPONENTS) + ("phantom_ms",))
    msgs = [v.message for v in contract_registry(ROOT)]
    assert any("no COMPONENT_SPANS entry" in m for m in msgs)
    assert any("missing from the golden" in m for m in msgs)
    assert any("not documented" in m for m in msgs)
    monkeypatch.undo()
    monkeypatch.setattr(tracebus, "COMPONENT_SPANS",
                        {**tracebus.COMPONENT_SPANS,
                         "ghost_ms": "ghost.span"})
    msgs = [v.message for v in contract_registry(ROOT)]
    assert any("stale mapping" in m for m in msgs)
    assert any("never emits a 'ghost.span'" in m for m in msgs)
    monkeypatch.setattr(perfledger, "_SWEEP_FIELDS",
                        tuple(perfledger._SWEEP_FIELDS) + ("mystery",))
    assert [v.rule for v in perfledger_direction(ROOT)] == \
        ["perfledger-direction"]


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def _bad_tree(tmp_path):
    pkg = tmp_path / "ray_tpu_torch" / "serve"
    pkg.mkdir(parents=True)
    (pkg / "bad.py").write_text(
        "import numpy as np\n\nasync def handler(prompt):\n"
        "    return np.asarray(prompt)\n")
    (tmp_path / "ray_tpu_torch" / "ops").mkdir()
    (tmp_path / "tests").mkdir()


def test_cli_formats_and_exit_codes(tmp_path, capsys):
    from ray_tpu_torch.tools.graftcheck.__main__ import main

    rc = main(["--root", str(ROOT), "--skip-trace", "--format", "json"])
    report = json.loads(capsys.readouterr().out)
    assert rc == 0 and report["ok"] is True
    assert report["summary"]["n_suppressed"] >= 3
    _bad_tree(tmp_path)
    rc = main(["--root", str(tmp_path), "--skip-trace", "--format",
               "json"])
    report = json.loads(capsys.readouterr().out)
    assert rc == 1
    assert "blocking-call-in-async" in report["summary"]["rules_failed"]
    rc = main(["--root", str(tmp_path), "--skip-trace", "--format",
               "github"])
    out = capsys.readouterr().out
    assert rc == 1
    assert "::error file=ray_tpu_torch/serve/bad.py,line=4::" in out
    assert "::notice::graftcheck:" in out


def test_cli_changed_lints_only_the_range(tmp_path, capsys):
    from ray_tpu_torch.tools.graftcheck.__main__ import main

    def git(*argv):
        subprocess.run(["git", "-c", "user.email=t@t", "-c", "user.name=t",
                        *argv], cwd=tmp_path, check=True,
                       capture_output=True)

    pkg = tmp_path / "ray_tpu_torch" / "serve"
    pkg.mkdir(parents=True)
    git("init", "-q")
    git("commit", "-qm", "root", "--allow-empty")
    (pkg / "old_bad.py").write_text(
        "import numpy as np\n\nasync def old(p):\n    return np.asarray(p)\n")
    (pkg / "clean.py").write_text("x = 1\n")
    git("add", "-A")
    git("commit", "-qm", "seed")
    (pkg / "clean.py").write_text("x = 2\n")
    git("add", "-A")
    git("commit", "-qm", "touch clean")
    rc = main(["--root", str(tmp_path), "--changed", "HEAD~1..HEAD",
               "--format", "json"])
    report = json.loads(capsys.readouterr().out)
    assert rc == 0 and report["summary"]["files_scanned"] == 1
    rc = main(["--root", str(tmp_path), "--changed", "HEAD~2..HEAD",
               "--format", "json"])
    assert rc == 1
    capsys.readouterr()
    assert main(["--root", str(tmp_path), "--changed",
                 "not-a-rev..HEAD"]) == 2


def test_cli_subprocess_entry_point():
    """``python -m`` reaches main (an empty range: the lint itself is
    held above, in process)."""
    proc = subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch.tools.graftcheck",
         "--changed", "HEAD..HEAD", "--root", str(ROOT)],
        capture_output=True, text=True, cwd=str(ROOT), timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "graftcheck: 0 violation(s), 0 suppressed, 0 files" in \
        proc.stdout
    assert "Traceback" not in proc.stderr
