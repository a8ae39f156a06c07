"""The port's object serialization against the JAX package's.

Numpy and python values give the same envelope (header fields, buffer
count and lengths, bytes); tensors travel as one out-of-band buffer
and come back bitwise; closures and local classes round trip through
the vendored cloudpickle, and the vendored msgpack keeps msgpack's
data model (tuples unpack as lists, bytes stay bytes).
"""

import pickle

import msgpack
import numpy as np
import pytest
import torch

from ray_tpu._private import serialization as jser
from ray_tpu_torch._private import serialization as tser
from ray_tpu_torch._private._vendor import cloudpickle as vcloudpickle
from ray_tpu_torch._private._vendor import msgpack as vmsgpack

VALUES = {
    "array": np.arange(24, dtype=np.float32).reshape(4, 6),
    "arrays_in_dict": {"a": np.ones(3, np.int64), "b": [np.zeros(2), 5]},
    "nested_python": {"k": (1, 2.5, "s"), "l": [None, True, b"x"]},
    "string": "text",
    "raw_bytes": b"\x00\x01raw",
    "int": 12345,
}


def _header(ser):
    return vmsgpack.unpackb(ser.header, raw=False)


@pytest.mark.parametrize("name", sorted(VALUES))
def test_envelope_matches_jax_package(name):
    value = VALUES[name]
    port, ref = tser.serialize(value), jser.serialize(value)
    assert _header(port) == msgpack.unpackb(ref.header, raw=False)
    assert [len(b) for b in port.buffers] == [len(b) for b in ref.buffers]
    assert port.to_bytes() == ref.to_bytes()
    # each side reads the other's envelope
    back, err = tser.deserialize(ref.to_bytes())
    assert not err
    np.testing.assert_equal(back, value)


def _tensors():
    g = torch.Generator().manual_seed(0)
    f32 = torch.randn(5, 7, generator=g)
    return {
        "f32": f32,
        "bf16": torch.randn(3, 4, 8, generator=g).to(torch.bfloat16),
        "int64": torch.randint(-2**40, 2**40, (6,), generator=g),
        "non_contiguous": torch.randn(6, 8, generator=g)[:, ::3].t(),
        "zero_d": torch.tensor(3.25),
        "empty": torch.zeros(0, 4),
        "bool": torch.rand(9, generator=g) > 0.5,
    }


@pytest.mark.parametrize("name", sorted(_tensors()))
def test_tensor_round_trips_bitwise_out_of_band(name):
    t = _tensors()[name]
    ser = tser.serialize({"t": t, "tag": name})
    assert len(ser.buffers) == 1
    assert len(ser.buffers[0]) == t.numel() * t.element_size()
    # the tensor's bytes are not in the pickle stream
    assert len(ser.pickled) < 400
    back, err = tser.deserialize(ser.to_bytes())
    assert not err and back["tag"] == name
    out = back["t"]
    assert out.dtype == t.dtype and out.shape == t.shape
    assert out.device.type == "cpu" and out.is_contiguous()
    assert torch.equal(out.reshape(-1).view(torch.uint8),
                       t.contiguous().reshape(-1).view(torch.uint8))


def test_tensor_rebuild_copies_out_of_the_buffer():
    t = torch.arange(8, dtype=torch.float32)
    ser = tser.serialize(t)
    buf = bytearray(ser.to_bytes())
    out, _ = tser.deserialize(buf)
    buf[:] = bytes(len(buf))
    assert torch.equal(out, t)


def test_cuda_tensor_without_a_card_raises():
    """A CUDA tensor reaching a process that sees no card names the
    tensor's device and num_gpus instead of landing on the CPU."""
    t = torch.arange(4, dtype=torch.float32)
    fn, args = tser._reduce_tensor(t)
    buf, dtype, shape, _ = args
    if torch.cuda.is_available():
        pytest.skip("this process sees a card")
    with pytest.raises(RuntimeError, match=r"cuda:0 tensor.*num_gpus=1"):
        fn(buf, dtype, shape, "cuda:0")
    assert torch.equal(fn(buf, dtype, shape, "cpu"), t)


def test_tensors_that_keep_torch_pickling():
    """Tensors the reducer leaves alone (autograd leaves, subclasses)
    still round trip, through torch's own pickling."""
    leaf = torch.randn(3, requires_grad=True)
    param = torch.nn.Parameter(torch.randn(2, 2))
    back, _ = tser.deserialize(tser.serialize([leaf, param]).to_bytes())
    assert back[0].requires_grad and torch.equal(back[0], leaf)
    assert isinstance(back[1], torch.nn.Parameter)
    assert torch.equal(back[1], param)


def test_local_closure_and_class_round_trip():
    k = 7

    def closure(x):
        return x * k

    class Local:
        def __init__(self, v):
            self.v = v

        def twice(self):
            return closure(self.v) * 2

    f = vcloudpickle.loads(vcloudpickle.dumps(closure))
    assert f(3) == 21
    cls = vcloudpickle.loads(vcloudpickle.dumps(Local))
    assert cls(2).twice() == 28
    obj, _ = tser.deserialize(tser.serialize(Local(1)).to_bytes())
    assert obj.twice() == 14 and type(obj).__name__ == "Local"
    # stdlib pickle reads what the vendored cloudpickle writes
    assert pickle.loads(vcloudpickle.dumps(closure))(1) == 7


@pytest.mark.parametrize("value", [
    (1, 2, 3), {"t": (1, (2, 3)), "b": b"\xff"}, [b"a", "a", 1.5, None],
    {"n": -(2**40), "f": float("inf"), "nested": [(), []]}],
    ids=["tuple", "nested_tuple_bytes", "mixed_list", "numbers"])
def test_vendored_msgpack_keeps_the_data_model(value):
    packed = vmsgpack.packb(value)
    assert packed == msgpack.packb(value)
    assert vmsgpack.unpackb(packed, raw=False) == \
        msgpack.unpackb(packed, raw=False)
    assert vmsgpack.unpackb(msgpack.packb(value), raw=False) == \
        msgpack.unpackb(packed, raw=False)
    assert vmsgpack.Unpacker is vmsgpack.fallback.Unpacker
