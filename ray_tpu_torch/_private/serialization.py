"""Object serialization: msgpack envelope + pickle5 out-of-band buffers.

Role-equivalent of the reference's SerializationContext (reference
``python/ray/_private/serialization.py:92``, ``:380 _serialize_to_pickle5``):
a small fixed header describes the payload kind, then the cloudpickle stream,
then the out-of-band buffers laid end to end so large numpy arrays and
tensors are written into (and read from) shared memory without an extra
copy through the pickle stream.

Wire layout (both for shm objects and inline bytes):

    [4B header_len][msgpack header][pickle bytes][buf0][buf1]...

header = {k: kind, bl: [buffer lengths], pl: pickle length}
kinds:  PY   ordinary python value
        RAW  raw bytes payload (zero pickle overhead fast path)
        ERR  pickled exception (RayTaskError) -- get() re-raises

A copy of ``ray_tpu/_private/serialization.py`` on the vendored
cloudpickle and msgpack, plus a reducer for ``torch.Tensor``: its bytes
travel as ONE out-of-band buffer (a contiguous uint8 view; bf16 has no
numpy dtype, so every dtype goes as bytes) with its dtype's name, shape
and device type beside them.  The receiver rebuilds it with one copy: a
CPU tensor as a CPU tensor, a CUDA tensor on the receiver's current
CUDA device (the counterpart of a ``jax.Array``, which pickles through
host numpy and is put on the receiver's default device).  A process
that sees no card raises instead of landing the tensor on the CPU.
The reducer is registered without importing torch: it only acts once
some other code of the process has imported it.
"""

from __future__ import annotations

import io
import pickle
import struct
import sys
from typing import Any, List, Tuple

from ray_tpu_torch._private._vendor import cloudpickle
from ray_tpu_torch._private._vendor import msgpack

_LEN = struct.Struct("<I")

KIND_PY = 0
KIND_RAW = 1
KIND_ERR = 2


def _rebuild_tensor(buf, dtype: str, shape: tuple, device: str):
    """Inverse of ``_reduce_tensor``: one copy out of ``buf`` (a pickle
    buffer, often a view of shared memory), onto the card for a tensor
    that was on one."""
    import torch

    if device.startswith("cuda") and not torch.cuda.is_available():
        raise RuntimeError(
            f"a {device} tensor ({dtype}, shape {tuple(shape)}) reached a "
            f"process that sees no CUDA device: give the receiving task "
            f"or actor num_gpus=1, or move the tensor to the CPU before "
            f"sending it")
    flat = torch.empty(0, dtype=torch.uint8).set_(
        torch.UntypedStorage.from_buffer(buf, dtype=torch.uint8))
    out = flat.view(getattr(torch, dtype)).reshape(shape)
    if device.startswith("cuda"):
        out = out.to(torch.device("cuda", torch.cuda.current_device()))
    return out


def _reduce_tensor(t):
    src = t.detach()
    device = str(src.device)
    if src.device.type != "cpu":
        src = src.cpu()
    flat = src.contiguous().reshape(-1).view(sys.modules["torch"].uint8)
    return (_rebuild_tensor,
            (pickle.PickleBuffer(flat.numpy()),
             str(t.dtype).rsplit(".", 1)[-1], tuple(t.shape), device))


class _Pickler(cloudpickle.Pickler):
    """cloudpickle's pickler with the tensor reducer in front."""

    def reducer_override(self, obj):
        if type(obj).__module__ == "torch":
            torch = sys.modules.get("torch")
            if torch is not None and type(obj) is torch.Tensor and \
                    obj.layout == torch.strided and not obj.requires_grad \
                    and not obj.is_quantized:
                return _reduce_tensor(obj)
        return super().reducer_override(obj)


def dumps(value: Any, buffer_callback=None) -> bytes:
    with io.BytesIO() as f:
        _Pickler(f, protocol=5, buffer_callback=buffer_callback).dump(value)
        return f.getvalue()


class SerializedObject:
    """A serialization result that knows its total size before writing, so
    the object-store allocation can be exact and buffers copied in place."""

    __slots__ = ("kind", "pickled", "buffers", "header", "total_size")

    def __init__(self, kind: int, pickled: bytes, buffers: List[pickle.PickleBuffer]):
        self.kind = kind
        self.pickled = pickled
        self.buffers = [b.raw() for b in buffers]
        self.header = msgpack.packb(
            {"k": kind, "bl": [len(b) for b in self.buffers], "pl": len(pickled)}
        )
        self.total_size = (
            _LEN.size + len(self.header) + len(pickled) + sum(len(b) for b in self.buffers)
        )

    def write_into(self, view: memoryview) -> None:
        off = 0
        view[off:off + _LEN.size] = _LEN.pack(len(self.header))
        off += _LEN.size
        view[off:off + len(self.header)] = self.header
        off += len(self.header)
        view[off:off + len(self.pickled)] = self.pickled
        off += len(self.pickled)
        for b in self.buffers:
            view[off:off + len(b)] = b
            off += len(b)

    def to_bytes(self) -> bytes:
        out = bytearray(self.total_size)
        self.write_into(memoryview(out))
        return bytes(out)


def serialize(value: Any) -> SerializedObject:
    if isinstance(value, bytes):
        return SerializedObject(KIND_RAW, value, [])
    buffers: List[pickle.PickleBuffer] = []
    pickled = dumps(value, buffer_callback=buffers.append)
    return SerializedObject(KIND_PY, pickled, buffers)


def serialize_error(exc: BaseException) -> SerializedObject:
    from ray_tpu_torch.exceptions import RayTaskError

    try:
        pickled = cloudpickle.dumps(exc, protocol=5)
    except Exception:
        # Unpicklable cause: keep the wrapper (message + remote traceback),
        # drop only the cause object.
        if isinstance(exc, RayTaskError):
            fallback = RayTaskError(exc.cause_repr, exc.remote_traceback)
        else:
            fallback = RayTaskError(repr(exc), "")
        pickled = cloudpickle.dumps(fallback, protocol=5)
    return SerializedObject(KIND_ERR, pickled, [])


def deserialize(data) -> Tuple[Any, bool]:
    """Returns (value, is_error). ``data`` is bytes or a memoryview aliasing
    shared memory; out-of-band buffers are reconstructed as zero-copy views
    (numpy arrays built on them copy only if the consumer writes)."""
    value, is_err, _ = deserialize_info(data)
    return value, is_err


def deserialize_info(data) -> Tuple[Any, bool, int]:
    """deserialize() + the number of out-of-band buffers in the envelope
    (callers managing a pinned shared-memory region use it to decide
    whether the value may alias the input)."""
    value, is_err, spans = deserialize_info_spans(data)
    return value, is_err, len(spans)


def deserialize_info_spans(data) -> Tuple[Any, bool, list]:
    """deserialize() + the (offset, length) span of every out-of-band
    buffer relative to the start of ``data``.  The zero-copy get path
    matches deserialized arrays to these spans one-to-one before tying
    the shared-memory pin to array lifetime."""
    view = memoryview(data)
    (hlen,) = _LEN.unpack(view[:_LEN.size])
    off = _LEN.size
    header = msgpack.unpackb(bytes(view[off:off + hlen]), raw=False)
    off += hlen
    kind = header["k"]
    plen = header["pl"]
    pickled = view[off:off + plen]
    off += plen
    if kind == KIND_RAW:
        return bytes(pickled), False, []
    buffers = []
    spans = []
    for blen in header["bl"]:
        buffers.append(pickle.PickleBuffer(view[off:off + blen]))
        spans.append((off, blen))
        off += blen
    value = pickle.loads(bytes(pickled), buffers=buffers)
    return value, kind == KIND_ERR, spans
