"""The port stands alone: no file of ray_tpu_torch/, and none of
chip_smoke.py, fused_ce_limits.py and flash_bwd_limits.py, imports jax,
jaxlib or the JAX package ray_tpu."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "ray_tpu")


def _port_files():
    files = sorted((ROOT / "ray_tpu_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py", ROOT / "fused_ce_limits.py",
                    ROOT / "flash_bwd_limits.py"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, (node.module or "").split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                    "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield node.lineno, str(node.args[0].value).split(".")[0]


def test_port_files_exist():
    files = _port_files()
    assert all(f.exists() for f in files)
    assert len(files) > 10
    # the llama family, the paged layout's and the continuous
    # scheduler's modules (spec decoding and the prefill/decode
    # handoff among them) and the serving telemetry are scanned too
    names = {str(f.relative_to(ROOT)) for f in files}
    assert {"ray_tpu_torch/models/llama.py",
            "ray_tpu_torch/models/llama_decode.py",
            "ray_tpu_torch/models/gpt2_decode.py",
            "ray_tpu_torch/models/decode_common.py",
            "ray_tpu_torch/serve/batching.py",
            "ray_tpu_torch/serve/llm.py",
            "ray_tpu_torch/serve/kv_pager.py",
            "ray_tpu_torch/serve/kv_tier.py",
            "ray_tpu_torch/serve/kvscope.py",
            # the serving telemetry
            "ray_tpu_torch/_private/telemetry.py",
            "ray_tpu_torch/_private/flightrec.py",
            "ray_tpu_torch/_private/device_stats.py",
            "ray_tpu_torch/util/tracing.py",
            "ray_tpu_torch/util/metrics.py",
            "ray_tpu_torch/serve/health.py",
            "ray_tpu_torch/serve/chaos.py",
            "ray_tpu_torch/serve/slo.py",
            "ray_tpu_torch/serve/telemetry.py"} <= names


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = [(line, mod) for line, mod in _imported_roots(path)
           if mod in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_scanner_catches_each_import_form(tmp_path):
    src = tmp_path / "planted.py"
    src.write_text("import jax.numpy as jnp\n"
                   "from ray_tpu.ops import attention\n"
                   "import importlib\n"
                   "m = importlib.import_module('jaxlib.xla_client')\n")
    assert [m for _, m in _imported_roots(src)] == \
        ["jax", "ray_tpu", "importlib", "jaxlib"]
