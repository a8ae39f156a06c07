"""The port's checkpoints in torch state against the JAX package's
orbax ones: the same ``step_N`` layout, the same trainwatch booking
(checkpoint counters, the next step's ``checkpoint`` leg, the journal's
``ckpt_save``/``ckpt_restore`` events), and a bitwise round trip."""

import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from ray_tpu.train import checkpointing as jck  # noqa: E402
from ray_tpu.train import goodput as jgp  # noqa: E402
from ray_tpu.train import telemetry as jtel  # noqa: E402
from ray_tpu_torch.models import llama as tl  # noqa: E402
from ray_tpu_torch.train import adamw  # noqa: E402
from ray_tpu_torch.train import checkpointing as tck  # noqa: E402
from ray_tpu_torch.train import goodput as tgp  # noqa: E402
from ray_tpu_torch.train import telemetry as ttel  # noqa: E402
from ray_tpu_torch.train.optim import tree_leaves  # noqa: E402

#: the checkpoint block's keys that are counts (the rest are times)
COUNTS = ("saves", "restores", "bytes_written", "bytes_read", "last_step")


def test_checkpoint_block_matches_jax(tmp_path):
    """The JAX package's checkpoint test (tests/test_trainwatch.py) run
    through both: the 3x4 f32 tree at step 7."""
    name = "tck_block"
    jtree = {"w": jnp.arange(12.0).reshape(3, 4)}
    ttree = {"w": torch.arange(12.0).reshape(3, 4)}
    jtarget = jck.save_sharded(jtree, str(tmp_path / "jax"), step=7,
                               trainer=name)
    ttarget = tck.save_sharded(ttree, str(tmp_path / "port"), step=7,
                               trainer=name)
    assert os.path.basename(jtarget) == os.path.basename(ttarget) == \
        "step_7"
    jck.restore_sharded(str(tmp_path / "jax"), step=7, trainer=name)
    restored = tck.restore_sharded(str(tmp_path / "port"), step=7,
                                   trainer=name, device="cpu")
    assert torch.equal(restored["w"], ttree["w"])
    for m in (jgp, tgp):
        rec = m.get_goodput_tracker(name).record_step(0.001)
        assert rec["checkpoint_ms"] > 0
        assert sum(rec[c] for c in m.ANATOMY_COMPONENTS) == \
            pytest.approx(rec["step_wall_ms"], rel=1e-9, abs=1e-9)
    jblk = jtel.train_stats(name)["checkpoint"]
    tblk = ttel.train_stats(name)["checkpoint"]
    assert {k: tblk[k] for k in COUNTS} == {k: jblk[k] for k in COUNTS}
    assert tblk["bytes_written"] == tblk["bytes_read"] == 48
    assert tblk["last_step"] == 7
    assert set(tblk) == set(jblk)
    for k in ("save_ms", "restore_ms"):
        assert tblk[k]["count"] == jblk[k]["count"] == 1
    assert tgp.get_train_recorder(name).counts_by_kind() == \
        jgp.get_train_recorder(name).counts_by_kind() == \
        {"ckpt_restore": 1, "ckpt_save": 1}
    events = tgp.get_train_recorder(name).snapshot()
    assert events[0]["bytes"] == 48 and events[0]["path"] == ttarget
    assert tck.latest_step(str(tmp_path / "port")) == \
        jck.latest_step(str(tmp_path / "jax")) == 7


def test_round_trip_is_bitwise_with_a_template(tmp_path):
    cfg = tl.llama_config("nano", dtype=torch.float32)
    params = tl.llama_init(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    state = adamw(3e-4).init(params)
    tree = {"params": params, "opt": state,
            "extra": {"bf16": torch.randn(5, 3).to(torch.bfloat16),
                      "ids": torch.arange(7, dtype=torch.int32)}}
    for step in (2, 11, 5):
        tck.save_sharded(tree, str(tmp_path), step=step, trainer="tck_rt")
    assert tck.latest_step(str(tmp_path)) == 11
    template = {"params": params, "opt": state,
                "extra": {"bf16": torch.zeros(5, 3, dtype=torch.bfloat16),
                          "ids": torch.zeros(7, dtype=torch.int32)}}
    back = tck.restore_sharded(str(tmp_path), step=5, template=template,
                               trainer="tck_rt")
    for a, b in zip(tree_leaves(back), tree_leaves(tree)):
        assert a.dtype == b.dtype and a.device == b.device
        assert torch.equal(a, b)
    blk = ttel.train_stats("tck_rt")["checkpoint"]
    nbytes = sum(t.numel() * t.element_size() for t in tree_leaves(tree))
    assert blk["bytes_written"] == 3 * nbytes
    assert blk["bytes_read"] == nbytes and blk["last_step"] == 5


def test_template_mismatch_raises(tmp_path):
    tck.save_sharded({"w": torch.ones(3, 4)}, str(tmp_path), step=1)
    with pytest.raises(ValueError, match="shape"):
        tck.restore_sharded(str(tmp_path), step=1,
                            template={"w": torch.ones(4, 3)})
    with pytest.raises(ValueError, match="keys"):
        tck.restore_sharded(str(tmp_path), step=1,
                            template={"v": torch.ones(3, 4)})


def test_restore_defaults_to_the_card(tmp_path):
    """Without a template the leaves land on resolve_device(device): the
    card unless the caller asks for the CPU."""
    tck.save_sharded({"w": torch.ones(2)}, str(tmp_path), step=0)
    if torch.cuda.is_available():
        got = tck.restore_sharded(str(tmp_path), step=0)
        assert got["w"].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tck.restore_sharded(str(tmp_path), step=0)
    assert tck.restore_sharded(str(tmp_path), step=0,
                               device="cpu")["w"].device.type == "cpu"


def test_unported_options_raise(tmp_path):
    """Restoring onto a mesh is ported (held on gloo ranks in
    tests/test_torch_parallel.py): a mesh without ``axes`` is ignored
    as the JAX package ignores it, and the leaves restore whole."""
    tck.save_sharded({"w": torch.arange(4.0)}, str(tmp_path), step=0)
    got = tck.restore_sharded(str(tmp_path), step=0, mesh=object(),
                              device="cpu")
    assert torch.equal(got["w"], torch.arange(4.0))
    # the AIR checkpoint is ported (tests/test_torch_air.py holds it to
    # the JAX package's): it no longer raises
    ckpt = tck.sharded_checkpoint_to_air(str(tmp_path), step=0)
    assert ckpt.to_dict() == {
        "sharded_checkpoint_path": str(tmp_path / "step_0")}


def test_latest_step_matches_jax(tmp_path):
    assert tck.latest_step(str(tmp_path / "missing")) is \
        jck.latest_step(str(tmp_path / "missing")) is None
    for d in ("step_3", "step_12", "step_x", "other", "step_"):
        os.makedirs(tmp_path / d)
    assert tck.latest_step(str(tmp_path)) == \
        jck.latest_step(str(tmp_path)) == 12
    assert np.isscalar(tck.latest_step(str(tmp_path)))
