"""Mesh construction: named parallelism axes over the ranks of a
process group.  Counterpart of ``ray_tpu/parallel/mesh.py``.

The JAX package lays a ``jax.sharding.Mesh`` over a TPU slice's
devices; the port lays a ``torch.distributed.device_mesh.DeviceMesh``
over the ranks of ``torch.distributed``'s default process group (one
rank a card: NCCL on the card, gloo on the CPU).  The same six named
axes, in the same order:

  pipeline — stage axis for pipeline parallelism
  data     — pure data parallelism (gradients summed over it)
  fsdp     — data parallelism with ZeRO-3 weight sharding
  expert   — expert parallelism for MoE layers
  seq      — sequence/context parallelism
  tensor   — tensor (op-level) parallelism

Trivial axes keep size 1, so a spec naming any standard axis always
resolves.  ``fake_mesh`` is for tests: the mesh's shape and each rank's
coordinates without live ranks.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

AXIS_DATA = "data"
AXIS_FSDP = "fsdp"
AXIS_TENSOR = "tensor"
AXIS_SEQ = "seq"
AXIS_EXPERT = "expert"
AXIS_PIPELINE = "pipeline"

# Canonical axis order: replication-heavy (cross-host tolerant)
# outermost, bandwidth-hungry innermost.
_AXIS_ORDER = (AXIS_PIPELINE, AXIS_DATA, AXIS_FSDP, AXIS_EXPERT, AXIS_SEQ,
               AXIS_TENSOR)


@dataclasses.dataclass
class MeshSpec:
    """Declarative mesh request.  -1 on at most one axis means "absorb
    all remaining devices" (like a reshape wildcard)."""

    data: int = 1
    fsdp: int = 1
    tensor: int = 1
    seq: int = 1
    expert: int = 1
    pipeline: int = 1

    def axis_sizes(self) -> Dict[str, int]:
        return {AXIS_PIPELINE: self.pipeline, AXIS_DATA: self.data,
                AXIS_FSDP: self.fsdp, AXIS_EXPERT: self.expert,
                AXIS_SEQ: self.seq, AXIS_TENSOR: self.tensor}

    def resolve(self, n_devices: int) -> "MeshSpec":
        sizes = self.axis_sizes()
        wild = [k for k, v in sizes.items() if v == -1]
        if len(wild) > 1:
            raise ValueError("at most one mesh axis may be -1")
        known = math.prod(v for v in sizes.values() if v != -1)
        if wild:
            if n_devices % known:
                raise ValueError(
                    f"{n_devices} devices not divisible by fixed axes "
                    f"product {known}")
            sizes[wild[0]] = n_devices // known
        elif known != n_devices:
            raise ValueError(
                f"mesh spec {sizes} needs {known} devices, have {n_devices}")
        return MeshSpec(data=sizes[AXIS_DATA], fsdp=sizes[AXIS_FSDP],
                        tensor=sizes[AXIS_TENSOR], seq=sizes[AXIS_SEQ],
                        expert=sizes[AXIS_EXPERT],
                        pipeline=sizes[AXIS_PIPELINE])

    def nontrivial_axes(self) -> List[Tuple[str, int]]:
        sizes = self.axis_sizes()
        return [(a, sizes[a]) for a in _AXIS_ORDER if sizes[a] != 1]

    @property
    def n_devices(self) -> int:
        return math.prod(self.axis_sizes().values())


def mesh_shape(mesh) -> Dict[str, int]:
    """{axis name: size} of a DeviceMesh or a FakeMesh, in axis order
    (JAX's ``Mesh.shape``)."""
    if isinstance(mesh, FakeMesh):
        return dict(mesh.shape)
    return {name: mesh.size(i) for i, name in
            enumerate(mesh.mesh_dim_names)}


def _world():
    """(torch.distributed, world size, the default group's backend):
    the default process group must exist."""
    import torch.distributed as dist

    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            "a mesh spans the ranks of torch.distributed's default "
            "process group: call torch.distributed.init_process_group("
            "backend, init_method=..., world_size=..., rank=...) first")
    return dist, dist.get_world_size(), dist.get_backend()


def _device_type(backend: str) -> str:
    """NCCL groups hold cards, gloo groups the CPU: the mesh's device
    type follows the backend, never the other way round."""
    if "nccl" in str(backend):
        return "cuda"
    if str(backend) == "gloo":
        return "cpu"
    raise ValueError(f"no mesh device type for backend {backend!r} "
                     f"(nccl: cuda, gloo: cpu)")


def _build(shape: Tuple[int, ...], ranks: Sequence[int]):
    from torch.distributed.device_mesh import DeviceMesh
    import torch

    _, _, backend = _world()
    grid = torch.as_tensor(np.asarray(ranks, dtype=np.int64).reshape(shape))
    return DeviceMesh(_device_type(backend), grid,
                      mesh_dim_names=_AXIS_ORDER)


def make_mesh(spec: Optional[MeshSpec] = None,
              devices: Optional[Sequence[int]] = None,
              *, contiguous_submeshes: bool = False):
    """A DeviceMesh with all six named axes over the ranks of the
    default process group (``devices``: the ranks in mesh order, all of
    them; None = 0..world-1).  Every rank calls it, with the same
    arguments.  ``contiguous_submeshes`` is the JAX keyword; ranks have
    no torus here, so the order is the plain reshape the JAX package
    falls back to on the CPU."""
    del contiguous_submeshes
    _, world, _ = _world()
    ranks = list(range(world)) if devices is None else [int(r) for r in
                                                       devices]
    if sorted(ranks) != list(range(world)):
        raise ValueError(f"a mesh spans every rank of the process group "
                         f"(0..{world - 1}); got {ranks}")
    spec = (spec or MeshSpec(data=-1)).resolve(len(ranks))
    return _build(tuple(spec.axis_sizes()[a] for a in _AXIS_ORDER), ranks)


def make_hybrid_mesh(spec: MeshSpec, *, num_slices: int,
                     devices: Optional[Sequence[int]] = None):
    """Multi-host mesh: the outer axes (pipeline, data, fsdp) split
    across ``num_slices`` groups of ranks, the inner ones within each.
    The JAX version's validation, and its CPU layout: a plain reshape
    of the ranks."""
    _, world, _ = _world()
    ranks = list(range(world)) if devices is None else [int(r) for r in
                                                       devices]
    spec = spec.resolve(len(ranks))
    sizes = spec.axis_sizes()
    remaining = num_slices
    for a in _AXIS_ORDER:
        if remaining > 1 and sizes[a] % remaining == 0 and a in (
                AXIS_PIPELINE, AXIS_DATA, AXIS_FSDP):
            remaining = 1
    if remaining != 1:
        raise ValueError(
            f"cannot place {num_slices} slices on axes {sizes}; make "
            f"pipeline/data/fsdp divisible by num_slices")
    return make_mesh(spec, devices=ranks)


def local_mesh(spec: Optional[MeshSpec] = None):
    """Mesh over this host's ranks: the port's process groups live on
    one host, so it is ``make_mesh`` over the whole group."""
    return make_mesh(spec)


_ACTIVE: contextvars.ContextVar = contextvars.ContextVar(
    "ray_tpu_torch_mesh", default=None)


def active_mesh():
    """The mesh made current by ``mesh_context``, or None."""
    return _ACTIVE.get()


@contextlib.contextmanager
def mesh_context(mesh):
    """``with mesh_context(mesh):`` makes ``mesh`` the one the port's
    mesh-aware code reads (``active_mesh``): the MoE block's expert and
    batch groups, the train step's shardings."""
    token = _ACTIVE.set(mesh)
    try:
        yield mesh
    finally:
        _ACTIVE.reset(token)


@dataclasses.dataclass(frozen=True)
class FakeMesh:
    """A mesh's shape without live ranks (tests only): ``shape`` maps
    each of the six axes to its size in axis order, ``devices`` the
    rank grid, ``coordinate(rank)`` a rank's index on each axis."""

    shape: Dict[str, int]

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(self.shape)

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    @property
    def devices(self) -> np.ndarray:
        return np.arange(self.size).reshape(tuple(self.shape.values()))

    def coordinate(self, rank: int) -> Dict[str, int]:
        idx = np.unravel_index(rank, tuple(self.shape.values()))
        return {a: int(i) for a, i in zip(self.shape, idx)}


def fake_mesh(n_devices: int = 8, spec: Optional[MeshSpec] = None
              ) -> FakeMesh:
    """The shape and coordinates of a mesh over ``n_devices`` ranks
    (default all ``data``), as ``mesh.py:204`` gives them over virtual
    CPU devices; no process group is needed, and no rank runs."""
    spec = (spec or MeshSpec(data=n_devices)).resolve(n_devices)
    sizes = spec.axis_sizes()
    return FakeMesh({a: sizes[a] for a in _AXIS_ORDER})
