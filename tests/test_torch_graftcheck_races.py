"""shared-state-race + rng-discipline on the port (the cases of
``tests/test_graftcheck_races.py``).

1. **planted fixtures** — every ``# PLANTED: <kind>`` line of
   tests/_race_fixtures.py, linted under a ``ray_tpu_torch/serve/``
   path, is reported with exactly that kind, no negative site flags,
   and the port's pass reports what the JAX pass reports on the same
   source (lines and messages);
2. **dynamic proof** — real threads drive the planted unlocked ``+=``
   and lose updates, so the rule polices a real bug class;
3. **rng fixtures** — torch draws without ``generator=``, seeds from
   wallclock or entropy (``torch.manual_seed``, a generator's
   ``manual_seed``, ``random.Random``), unseeded module-level
   ``random``/``np.random`` draws; seeded instances stay clean.
"""

import ast
import pathlib
import re
import sys
import textwrap
import threading

import pytest

from ray_tpu.tools.graftcheck import races as jraces
from ray_tpu_torch.tools.graftcheck.lint import lint_source
from ray_tpu_torch.tools.graftcheck.races import (THREAD_ROOTS,
                                                  rng_discipline,
                                                  shared_state_races)

HERE = pathlib.Path(__file__).resolve().parent
FIXTURE = HERE / "_race_fixtures.py"
FIXTURE_REL = "ray_tpu_torch/serve/_race_fixtures.py"

KIND_TEXT = {
    "aug": "read-modify-write",
    "rmw": "read-modify-write store",
    "check-then-act": "check-then-act",
    "multi-init": "multi-step re-initialization",
    "iterate": "iteration over mutable shared",
}


def _planted(source):
    out = {}
    for lineno, line in enumerate(source.splitlines(), start=1):
        m = re.search(r"#\s*PLANTED:\s*([a-z\-]+)", line)
        if m:
            out[lineno] = m.group(1)
    return out


@pytest.fixture(scope="module")
def fixture_source():
    return FIXTURE.read_text()


@pytest.fixture(scope="module")
def fixture_violations(fixture_source):
    return shared_state_races(ast.parse(fixture_source), FIXTURE_REL)


def test_every_planted_race_detected_with_its_kind(fixture_source,
                                                   fixture_violations):
    planted = _planted(fixture_source)
    assert len(planted) >= 8, "fixture module lost its plants"
    by_line = {}
    for v in fixture_violations:
        by_line.setdefault(v.line, []).append(v.message)
    for ln, kind in planted.items():
        assert any(KIND_TEXT[kind] in m for m in by_line.get(ln, [])), \
            f"line {ln}: expected {kind!r} in {by_line.get(ln)}"
    extra = [str(v) for v in fixture_violations if v.line not in planted]
    assert not extra


def test_same_findings_as_the_jax_pass(fixture_source, fixture_violations):
    want = jraces.shared_state_races(ast.parse(fixture_source),
                                     "ray_tpu/serve/_race_fixtures.py")
    assert [(v.line, v.message) for v in fixture_violations] == \
        [(v.line, v.message) for v in want]
    assert THREAD_ROOTS == jraces.THREAD_ROOTS


def test_thread_roots_and_autodetect_and_scope(fixture_source,
                                               fixture_violations):
    msgs = [v.message for v in fixture_violations]
    assert any("HealthMonitor.heartbeat" in m for m in msgs)
    assert any("engine-wave-loop" in m for m in msgs)
    assert any("RacyCounter._writer" in m for m in msgs)
    assert any("writer-thread" in m for m in msgs)
    tree = ast.parse(fixture_source)
    assert shared_state_races(tree, "ray_tpu_torch/models/gpt2.py") == []
    # the vendored tree is outside the linter's walk
    assert shared_state_races(tree, "ray_tpu/serve/x.py") == []


def test_thread_root_classes_exist_in_the_port():
    root = HERE.parent / "ray_tpu_torch"
    classes = {}
    for path in root.rglob("*.py"):
        if "_vendor" in path.parts:
            continue
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.ClassDef):
                classes.setdefault(node.name, set()).update(
                    n.name for n in node.body
                    if isinstance(n, (ast.FunctionDef,
                                      ast.AsyncFunctionDef)))
    for root_name in THREAD_ROOTS:
        cls, meth = root_name.split(".")
        assert meth in classes.get(cls, ()), root_name


def test_lint_source_integration_and_suppression(fixture_source):
    kept, _ = lint_source(fixture_source, FIXTURE_REL)
    races = [v for v in kept if v.rule == "shared-state-race"]
    assert races
    line = races[0].line
    lines = fixture_source.splitlines()
    indent = len(lines[line - 1]) - len(lines[line - 1].lstrip())
    waived = "\n".join(
        lines[:line - 1]
        + [" " * indent + "# graftcheck: "
           "disable=shared-state-race(fixture waiver test)"]
        + lines[line - 1:])
    kept2, n_sup = lint_source(waived, FIXTURE_REL)
    assert len([v for v in kept2 if v.rule == "shared-state-race"]) == \
        len(races) - 1
    assert n_sup >= 1


def test_planted_race_is_real_under_threads():
    sys.path.insert(0, str(HERE))
    try:
        import _race_fixtures
    finally:
        sys.path.pop(0)
    n_threads, iters, rounds = 8, 50_000, 6
    old = sys.getswitchinterval()
    sys.setswitchinterval(5e-6)
    try:
        for _ in range(rounds):
            counter = _race_fixtures.RacyCounter()
            barrier = threading.Barrier(n_threads)

            def loop(c=counter, b=barrier):
                b.wait()
                c.bump(iters)

            threads = [threading.Thread(target=loop)
                       for _ in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            if counter.n < n_threads * iters:
                return
        pytest.fail("no lost update: the planted race is no longer racy")
    finally:
        sys.setswitchinterval(old)


_SERVE = "ray_tpu_torch/serve/fixture.py"


def _rng(src, rel=_SERVE):
    return rng_discipline(ast.parse(textwrap.dedent(src)), rel)


@pytest.mark.parametrize("src,n,text", [
    ("""\
        import torch

        def sample(probs):
            a = torch.multinomial(probs, 1)
            b = torch.rand(4)
            c = probs.bernoulli()
            return a, b, c
    """, 3, "without generator="),
    ("""\
        import time
        import torch

        def seed():
            torch.manual_seed(int(time.time()))
    """, 1, "unreproducible"),
    ("""\
        import os
        import torch

        def make(dev):
            return torch.Generator(dev).manual_seed(os.getpid())
    """, 1, "os.getpid"),
    ("""\
        import random
        import time

        def make_rng():
            return random.Random(time.time())
    """, 1, "unreproducible"),
    ("""\
        import random
        import numpy as np

        def jitter(ms):
            return ms * random.uniform(0.9, 1.1) * np.random.rand()
    """, 2, "process-global"),
], ids=["torch-draws", "manual-seed-time", "generator-pid",
        "random-time", "global-draws"])
def test_rng_plants_detected(src, n, text):
    vs = _rng(src)
    assert len(vs) == n, [str(v) for v in vs]
    assert all(v.rule == "rng-discipline" and text in v.message
               for v in vs)


def test_rng_seeded_draws_are_clean_and_scoped():
    src = """\
        import random
        import numpy as np
        import torch

        def sample(probs, seed, gen):
            rng = random.Random(seed)
            nprng = np.random.default_rng(seed)
            g = torch.Generator().manual_seed(seed)
            a = torch.multinomial(probs, 1, generator=gen)
            b = torch.rand(4, generator=g)
            return a, b, rng.uniform(0.9, 1.1) * nprng.random()
    """
    assert _rng(src) == []
    bad = "import random\n\ndef j(ms):\n    return random.uniform(0, ms)\n"
    assert _rng(bad, "ray_tpu_torch/train/loop.py") == []
    assert len(_rng(bad, "ray_tpu_torch/serve/traffic.py")) == 1
