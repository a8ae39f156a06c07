"""The port's AIR layer (``ray_tpu_torch/air/``) against the JAX
package's (``ray_tpu/air/``), and ``train.checkpointing.
sharded_checkpoint_to_air``.

Mirrors tests/test_checkpoint_dir.py (a directory checkpoint carries its
files across pickling; a BatchPredictor over a Dataset on a CPU actor
pool, in both runtimes, which are up at once) and the AIR half of
tests/test_sharded_checkpoint.py.  Beyond them: every Checkpoint form
round-trips bf16 and f32 tensors bit for bit; a directory the JAX
package's Checkpoint wrote from a GPT-2 nano parameter tree reads in
the port and, through models/convert.py, gives the JAX model's loss
within test_torch_gpt2_train.py's tolerance; ScalingConfig asks for
cards where the reference asks for TPUs; the session raises as the
reference's does with no session set.
"""

import os
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu_torch
from ray_tpu import air as jair
from ray_tpu import data as jdata
from ray_tpu.models import gpt2 as jg
from ray_tpu.train import checkpointing as jck
from ray_tpu_torch import air as tair
from ray_tpu_torch import data as tdata
from ray_tpu_torch._private._vendor import cloudpickle as port_cloudpickle
from ray_tpu_torch.models import gpt2 as tg
from ray_tpu_torch.models.convert import gpt2_params_from_numpy
from ray_tpu_torch.train import checkpointing as tck
# autouse: the JAX runtime's loops settle before they stop
from tests.test_torch_jax_teardown import settle_jax_loops  # noqa: F401

port_cloudpickle.register_pickle_by_value(sys.modules[__name__])

STORE = 128 * 1024 * 1024
#: the longest a test waits for one result
WAIT_S = 120
#: test_torch_gpt2_train.py's loss tolerance (f32 nano, summed in
#: another order)
LOSS_TOL = 1e-5


@pytest.fixture(scope="module")
def runtimes():
    ray_tpu.init(num_cpus=4, object_store_memory=STORE, log_to_driver=False)
    ray_tpu_torch.init(num_cpus=4, num_gpus=0, object_store_memory=STORE,
                       log_to_driver=False)
    yield {"jax": (ray_tpu, jdata, jair), "torch": (ray_tpu_torch, tdata,
                                                    tair)}
    ray_tpu_torch.shutdown()
    ray_tpu.shutdown()


def _tree_equal(a, b):
    """Bitwise equality of two trees of tensors/arrays/values, types
    and dtypes included."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b)
        for k in a:
            _tree_equal(a[k], b[k])
    elif isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.device.type == b.device.type == "cpu"
        assert torch.equal(a.view(torch.uint8) if a.dtype == torch.bfloat16
                           else a, b.view(torch.uint8)
                           if b.dtype == torch.bfloat16 else b)
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


def _tensor_tree():
    g = torch.Generator().manual_seed(0)
    return {"params": {"w": torch.randn(3, 5, generator=g),
                       "h": torch.randn(4, 4, generator=g).bfloat16()},
            "count": torch.tensor(7, dtype=torch.int32),
            "np": np.arange(6, dtype=np.float32).reshape(2, 3),
            "meta": {"step": 3, "name": "gpt2"}}


@pytest.mark.parametrize("air", [jair, tair], ids=["jax", "torch"])
def test_directory_checkpoint_packs_files(air, tmp_path):
    src = tmp_path / "src"
    os.makedirs(src / "nested")
    (src / "weights.bin").write_bytes(b"\x01\x02\x03" * 100)
    (src / "nested" / "meta.txt").write_text("hello")

    c = air.Checkpoint.from_directory(str(src))
    c2 = pickle.loads(pickle.dumps(c))  # crosses a process boundary

    out = c2.to_directory(str(tmp_path / "out"))
    assert (tmp_path / "out" / "weights.bin").read_bytes() == \
        b"\x01\x02\x03" * 100
    assert (tmp_path / "out" / "nested" / "meta.txt").read_text() == "hello"
    assert c2.id == c.id and "form=dict" in repr(c2)


def test_checkpoint_forms_round_trip_bf16_and_f32_bit_for_bit(runtimes,
                                                              tmp_path):
    tree = _tensor_tree()
    c = tair.Checkpoint.from_dict(tree)
    path = c.to_directory(str(tmp_path / "ckpt"))
    assert sorted(os.listdir(path)) == ["_ckpt_payload.pkl"]
    back = tair.Checkpoint.from_directory(path)
    assert "form=directory" in repr(back)
    _tree_equal(tree, back.to_dict())
    # the object-store form, and a dict-form checkpoint's pickling
    ref = tair.Checkpoint.from_dict(tree).to_object_ref()
    _tree_equal(tree, tair.Checkpoint.from_object_ref(ref).to_dict())
    _tree_equal(tree, pickle.loads(pickle.dumps(c)).to_dict())
    # a task that receives the Checkpoint reads it whole
    got = ray_tpu_torch.get(ray_tpu_torch.remote(
        lambda ck: ck.to_dict()).remote(c), timeout=WAIT_S)
    _tree_equal(tree, got)
    with pytest.raises(ValueError, match="construct via"):
        tair.Checkpoint()
    with pytest.raises(TypeError, match="must be a dict"):
        tair.Checkpoint.from_dict([1])
    with pytest.raises(FileNotFoundError):
        tair.Checkpoint.from_directory(str(tmp_path / "missing"))


def test_to_host_detaches_and_moves_tensors():
    w = torch.ones(3, requires_grad=True)
    c = tair.Checkpoint.from_dict({"w": w * 2, "l": [w, (w,)]})
    d = c.to_dict()
    assert not d["w"].requires_grad and d["w"].device.type == "cpu"
    assert isinstance(d["l"][1], tuple) and not d["l"][1][0].requires_grad
    if torch.cuda.is_available():
        d = tair.Checkpoint.from_dict({"w": w.cuda()}).to_dict()
        assert d["w"].device.type == "cpu"


def test_jax_written_checkpoint_reads_in_the_port_and_gives_its_loss(
        tmp_path):
    """Weights cross over through AIR: the JAX package's Checkpoint of a
    GPT-2 nano parameter tree (jax.Array leaves, written as numpy) is a
    directory the port's Checkpoint reads; the tree through
    models/convert.py gives the JAX model's loss on the same batch."""
    jcfg = jg.gpt2_config("nano", dtype=jnp.float32, use_flash=False)
    params = jg.gpt2_init(jax.random.PRNGKey(0), jcfg)
    tokens = np.random.default_rng(0).integers(0, 512, (2, 33)).astype(
        np.int32)
    want = float(jg.gpt2_loss(params, {"tokens": jnp.asarray(tokens)},
                              jcfg))
    path = jair.Checkpoint.from_dict({"params": params, "step": 5}) \
        .to_directory(str(tmp_path / "jax_ckpt"))
    data = tair.Checkpoint.from_directory(path).to_dict()
    assert data["step"] == 5
    leaves = jax.tree_util.tree_leaves(data["params"])
    assert leaves and all(type(x) is np.ndarray for x in leaves)
    tcfg = tg.gpt2_config("nano", dtype=torch.float32)
    tparams = gpt2_params_from_numpy(data["params"], tcfg, device="cpu")
    got = float(tg.gpt2_loss(tparams, {"tokens": torch.from_numpy(tokens)},
                             tcfg))
    assert abs(got - want) <= LOSS_TOL, (got, want)
    # and back: the port's checkpoint of numpy leaves reads in the JAX
    # package
    again = tair.Checkpoint.from_dict(data).to_directory(
        str(tmp_path / "port_ckpt"))
    jback = jair.Checkpoint.from_directory(again).to_dict()
    for a, b in zip(jax.tree_util.tree_leaves(jback["params"]), leaves):
        np.testing.assert_array_equal(a, b)


def test_sharded_checkpoint_to_air_matches_jax(tmp_path):
    tck.save_sharded({"w": torch.arange(8.0)}, str(tmp_path / "t"), step=2)
    jck.save_sharded({"w": jnp.arange(8.0)}, str(tmp_path / "j"), step=2)
    got = tck.sharded_checkpoint_to_air(str(tmp_path / "t"), step=2)
    want = jck.sharded_checkpoint_to_air(str(tmp_path / "j"), step=2)
    assert isinstance(got, tair.Checkpoint)
    gd, wd = got.to_dict(), want.to_dict()
    assert list(gd) == list(wd) == ["sharded_checkpoint_path"]
    assert gd["sharded_checkpoint_path"] == str(tmp_path / "t" / "step_2")
    assert wd["sharded_checkpoint_path"] == str(tmp_path / "j" / "step_2")
    flat = tck.sharded_checkpoint_to_air(str(tmp_path / "t"))
    assert flat.to_dict()["sharded_checkpoint_path"].endswith("/t")
    back = tck.restore_sharded(gd["sharded_checkpoint_path"], device="cpu")
    assert torch.equal(back["w"], torch.arange(8.0))


def as_gpu(resources):
    """The reference's resources with its "TPU" read as "GPU"."""
    out = dict(resources)
    out["GPU"] = out.pop("TPU")
    return out


def test_scaling_config_asks_for_cards_where_the_reference_asks_for_tpus():
    for kw in ({}, {"num_workers": 3, "num_cpus_per_worker": 2.0},
               {"resources_per_worker": {"mem": 2}}):
        want = jair.ScalingConfig(use_tpu=True, **kw)
        got = tair.ScalingConfig(use_gpu=True, **kw)
        assert got._trainer_resources == as_gpu(want._trainer_resources)
        assert got.as_placement_group_bundles() == [
            as_gpu(b) for b in want.as_placement_group_bundles()]
        assert got.num_gpus_per_worker == want.num_tpus_per_worker == 1.0
    assert tair.ScalingConfig()._trainer_resources == \
        jair.ScalingConfig()._trainer_resources == {"CPU": 1.0}
    assert tair.ScalingConfig(num_gpus_per_worker=2).as_placement_group_bundles() \
        == [{"CPU": 1.0, "GPU": 2.0}]
    for kw in ({"use_tpu": True}, {"num_tpus_per_worker": 1}):
        with pytest.raises(ValueError, match="the port's accelerator "
                                             "resource is num_gpus"):
            tair.ScalingConfig(**kw)
    # topology and mesh are stored as the reference stores them (the
    # trainer's use of the mesh: tests/test_torch_train.py)
    from ray_tpu import parallel as jpar
    from ray_tpu_torch import parallel as tpar

    got = tair.ScalingConfig(topology="v5e-8", mesh=tpar.MeshSpec(seq=2))
    want = jair.ScalingConfig(topology="v5e-8", mesh=jpar.MeshSpec(seq=2))
    assert (got.topology, got.mesh.axis_sizes()) == \
        (want.topology, want.mesh.axis_sizes())
    assert got._trainer_resources == want._trainer_resources
    assert (tair.ScalingConfig().topology, tair.ScalingConfig().mesh) == \
        (None, None)
    with pytest.raises(TypeError, match="unexpected"):
        tair.ScalingConfig(num_chips=1)


def test_run_failure_checkpoint_configs_and_result_match_jax():
    for air in (jair, tair):
        with pytest.raises(ValueError, match="'max' or 'min'"):
            air.CheckpointConfig(checkpoint_score_order="median")
    got = tair.RunConfig(name="x", failure_config=tair.FailureConfig(2),
                         checkpoint_config=tair.CheckpointConfig(3))
    want = jair.RunConfig(name="x", failure_config=jair.FailureConfig(2),
                          checkpoint_config=jair.CheckpointConfig(3))
    assert repr(got).replace("ray_tpu_torch", "ray_tpu") == repr(want)
    assert tair.Result(metrics={"a": 1}).ok
    assert not tair.Result(error=RuntimeError("x")).ok


@pytest.mark.parametrize("name", ["report", "get_checkpoint",
                                  "get_dataset_shard", "get_world_size",
                                  "get_world_rank", "get_local_rank",
                                  "get_trial_name", "get_trial_id",
                                  "get_config"])
def test_session_without_a_session_raises_as_the_reference(name):
    args = ({},) if name == "report" else ()
    msgs = []
    for air in (jair, tair):
        with pytest.raises(RuntimeError) as e:
            getattr(air.session, name)(*args)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def prog_batch_predictor(rt, data, air):
    """BatchPredictor: checkpoint -> actor-pool inference over a Dataset
    (reference: train/batch_predictor.py + the GPU batch-prediction
    benchmark shape)."""
    class ScalePredictor(air.Predictor):
        def __init__(self, w):
            self.w = w

        @classmethod
        def from_checkpoint(cls, ckpt):
            return cls(ckpt.to_dict()["w"])

        def predict(self, batch):
            return {"y": batch["x"] * self.w}

    ckpt = air.Checkpoint.from_dict({"w": 3.0})
    bp = air.BatchPredictor.from_checkpoint(ckpt, ScalePredictor)
    ds = data.from_numpy({"x": np.arange(32, dtype=np.float32)})
    return bp.predict(ds, min_scoring_workers=2).take_all()


def test_batch_predictor_over_dataset_matches_jax(runtimes):
    want = prog_batch_predictor(*runtimes["jax"])
    got = prog_batch_predictor(*runtimes["torch"])
    assert got == want
    assert sorted(r["y"] for r in got) == [i * 3.0 for i in range(32)]


def test_batch_predictor_loads_tensors_once_per_actor(runtimes):
    """A tensor checkpoint reaches each pool actor from the object
    store: the predictor is built once per actor (2 actors, 8 blocks)
    and its weights are the checkpoint's, bit for bit."""
    w = torch.randn(4, 3, generator=torch.Generator().manual_seed(1))

    class MatPredictor(tair.Predictor):
        def __init__(self, w):
            import os

            self.w, self.pid = w, os.getpid()

        @classmethod
        def from_checkpoint(cls, ckpt):
            return cls(ckpt.to_dict()["w"])

        def predict(self, batch):
            y = torch.from_numpy(batch["x"].copy()) @ self.w
            return {"y": y.numpy(), "pid": np.full(len(y), self.pid)}

    bp = tair.BatchPredictor.from_checkpoint(
        tair.Checkpoint.from_dict({"w": w}), MatPredictor)
    x = np.random.default_rng(2).standard_normal((64, 4)).astype(np.float32)
    out = bp.predict(tdata.from_numpy({"x": x}, parallelism=8),
                     compute=tdata.ActorPoolStrategy(size=2, num_cpus=0.5))
    rows = out.take_all()
    assert len({r["pid"] for r in rows}) == 2
    np.testing.assert_array_equal(
        np.array([r["y"] for r in rows], dtype=np.float32),
        (torch.from_numpy(x) @ w).numpy())
