"""Logical-axis sharding rules.  Counterpart of
``ray_tpu/parallel/sharding.py``.

Models annotate parameters and activations with *logical* axis names
("embed", "mlp", "heads", "batch", ...); a rule table maps logical axes
to mesh axes, so changing the parallelism is changing the table, not
the model.  The rule tables and the pure mappings (``logical_to_mesh_
axes``, ``mesh_axes_for_shape``) are the JAX package's; where JAX
places an array with a ``NamedSharding``, the port places a ``DTensor``
whose placements say, for each mesh axis, ``Shard(dim)`` or
``Replicate()``.  A mesh axis of size 1 places as ``Replicate()``: the
same layout, and no collective to run over it.

Compute sees plain tensors: ``gather_params`` turns a tree of
``DTensor`` parameters into this rank's local tensors (all-gathered
over every mesh axis but the ones kept sharded), whose gradients come
back onto the parameters' own placements: reduce-scattered onto a
shard, summed over the ranks that replicate it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional, Sequence, Tuple, Union

from ray_tpu_torch.parallel.mesh import (AXIS_DATA, AXIS_EXPERT, AXIS_FSDP,
                                         AXIS_SEQ, AXIS_TENSOR, active_mesh,
                                         mesh_shape)

# A rule maps a logical axis name to a mesh axis (or tuple of mesh axes,
# or None = replicate).
LogicalAxisRules = Sequence[Tuple[str, Union[str, Tuple[str, ...], None]]]

# Default table: batch over (data, fsdp); weights ZeRO-sharded over fsdp
# on their largest dim; Megatron TP over heads/mlp; sequence axis over
# seq for ring attention.
DEFAULT_RULES: LogicalAxisRules = (
    ("batch", (AXIS_DATA, AXIS_FSDP)),
    ("seq", AXIS_SEQ),
    ("embed", AXIS_FSDP),
    ("mlp", AXIS_TENSOR),
    ("heads", AXIS_TENSOR),
    ("kv", None),
    ("head_dim", None),
    ("vocab", AXIS_TENSOR),
    ("expert", AXIS_EXPERT),
    ("stage", None),
    ("norm", None),
)

# Serving table: pure tensor parallelism (no ZeRO, the batch and seq
# dims local); only the model-parallel dims split: attention heads + KV
# pool heads, MLP hidden, and the lm-head vocab over `tensor`.
DECODE_RULES: LogicalAxisRules = (
    ("batch", None),
    ("seq", None),
    ("embed", None),
    ("mlp", AXIS_TENSOR),
    ("heads", AXIS_TENSOR),
    ("kv_heads", AXIS_TENSOR),
    ("kv", None),
    ("head_dim", None),
    ("vocab", AXIS_TENSOR),
    ("expert", None),
    ("stage", None),
    ("norm", None),
)


class PartitionSpec(tuple):
    """One entry per array dim: a mesh axis name, a tuple of them, or
    None (replicated); trailing Nones dropped.  A tuple, printed as
    ``jax.sharding.PartitionSpec`` prints."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


def logical_to_mesh_axes(logical_axes: Sequence[Optional[str]],
                         rules: LogicalAxisRules = DEFAULT_RULES
                         ) -> PartitionSpec:
    """Map a tuple of logical axis names to a PartitionSpec, dropping
    mesh axes that are already taken by an earlier dimension (a mesh
    axis may shard at most one dim of one array)."""
    table = dict(rules)
    used: set = set()
    out: List[Union[str, Tuple[str, ...], None]] = []
    for name in logical_axes:
        mesh_axes = table.get(name) if name else None
        if mesh_axes is None:
            out.append(None)
            continue
        if isinstance(mesh_axes, str):
            mesh_axes = (mesh_axes,)
        avail = tuple(a for a in mesh_axes if a not in used)
        used.update(avail)
        out.append(avail if len(avail) > 1 else (avail[0] if avail else None))
    while out and out[-1] is None:
        out.pop()
    return PartitionSpec(*out)


def _names(ax) -> Tuple[str, ...]:
    return (ax,) if isinstance(ax, str) else tuple(ax or ())


def mesh_axes_for_shape(shape, logical_axes, mesh,
                        rules: LogicalAxisRules = DEFAULT_RULES
                        ) -> PartitionSpec:
    """logical_to_mesh_axes with a divisibility guard: any mesh axis
    group whose size product does not divide the corresponding array
    dim is dropped (the dim replicates instead of erroring), as are
    groups of size 1."""
    sizes = mesh_shape(mesh)
    spec = logical_to_mesh_axes(logical_axes, rules)
    parts = list(spec) + [None] * (len(shape) - len(spec))
    out: List[Union[str, Tuple[str, ...], None]] = []
    for dim, ax in zip(shape, parts):
        size = 1
        for a in _names(ax):
            size *= sizes[a]
        out.append(ax if (size > 1 and dim % size == 0) else None)
    while out and out[-1] is None:
        out.pop()
    return PartitionSpec(*out)


def split_axes(logical: str, mesh, rules: LogicalAxisRules = DEFAULT_RULES
               ) -> Tuple[str, ...]:
    """The mesh axes of size > 1 that ``rules`` give ``logical``, in
    mesh order: the ranks a dim of that name is split over."""
    sizes = mesh_shape(mesh)
    names = _names(dict(rules).get(logical))
    return tuple(a for a in sizes if a in names and sizes[a] > 1)


def placements_for(spec: Sequence, mesh) -> tuple:
    """The DTensor placements of ``spec`` on ``mesh``: for each mesh
    axis, ``Shard(dim)`` for the array dim it splits, else
    ``Replicate()`` (size-1 axes too).  An array dim split over several
    mesh axes splits in mesh-axis order, as JAX's tuple entries do, so
    the tuple must name them in that order."""
    from torch.distributed.tensor import Replicate, Shard

    order = list(mesh.mesh_dim_names)
    sizes = mesh_shape(mesh)
    out = [Replicate()] * len(order)
    for dim, ax in enumerate(spec):
        names = _names(ax)
        idx = [order.index(a) for a in names]
        if idx != sorted(idx):
            raise ValueError(f"mesh axes {names} of dim {dim} must follow "
                             f"the mesh's axis order {tuple(order)}")
        for a, i in zip(names, idx):
            if sizes[a] > 1:
                out[i] = Shard(dim)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """JAX's ``NamedSharding``: a mesh and a PartitionSpec; its
    ``placements`` place a DTensor."""

    mesh: Any
    spec: PartitionSpec

    @property
    def placements(self) -> tuple:
        return placements_for(self.spec, self.mesh)

    def shard_shape(self, shape) -> tuple:
        """The shape of one rank's block of an array of ``shape`` (even
        splits, as JAX requires of a device_put)."""
        sizes = mesh_shape(self.mesh)
        out = list(shape)
        for dim, ax in enumerate(self.spec):
            for a in _names(ax):
                out[dim] //= sizes[a]
        return tuple(out)


def _is_axes(x) -> bool:
    return x is None or isinstance(x, tuple)


def _map(fn: Callable, tree, axes):
    """``fn(leaf, axes leaf)`` over nested dicts and lists and the
    matching logical-axes tree (leaves: tuples of logical names)."""
    if isinstance(tree, dict):
        return {k: _map(fn, tree[k], axes[k]) for k in tree}
    if isinstance(tree, list):
        return [_map(fn, t, a) for t, a in zip(tree, axes)]
    return fn(tree, axes)


def _map_axes(fn: Callable, axes):
    if _is_axes(axes):
        return fn(axes)
    if isinstance(axes, list):
        return [_map_axes(fn, v) for v in axes]
    return {k: _map_axes(fn, v) for k, v in axes.items()}


def distribute(t, sharding: NamedSharding):
    """``t`` (the same full tensor on every rank) as a DTensor with
    ``sharding``'s placements; each rank keeps its own block, nothing
    is sent.  Placed on the mesh's device type."""
    import torch
    from torch.distributed.tensor import DTensor, distribute_tensor

    if isinstance(t, DTensor):
        return t.redistribute(sharding.mesh, sharding.placements)
    if sharding.mesh.device_type == "cuda":
        t = t.to(torch.device("cuda", torch.cuda.current_device()))
    elif t.device.type != sharding.mesh.device_type:
        t = t.to(sharding.mesh.device_type)
    return distribute_tensor(t.detach(), sharding.mesh,
                             sharding.placements, src_data_rank=None)


def param_shardings(logical_axes, mesh, rules: LogicalAxisRules =
                    DEFAULT_RULES):
    """NamedSharding tree for a parameter tree's logical axes."""
    return _map_axes(
        lambda axes: NamedSharding(mesh, logical_to_mesh_axes(axes or (),
                                                              rules)),
        logical_axes)


def shard_params(params, logical_axes, mesh, rules: LogicalAxisRules =
                 DEFAULT_RULES):
    """Place a parameter tree according to its logical-axes tree
    (matching structure, leaves = tuples of logical names): a tree of
    DTensors.  Every rank passes the same full values (a seeded init,
    or weights read from one file)."""
    return _map(lambda p, axes: distribute(
        p, NamedSharding(mesh, logical_to_mesh_axes(axes or (), rules))),
        params, logical_axes)


def shardings_by_shape(tree, logical_axes, mesh,
                       rules: LogicalAxisRules = DEFAULT_RULES):
    """NamedSharding tree for ``tree`` (tensors) under the
    shape-guarded mapping."""
    return _map(lambda leaf, axes: NamedSharding(
        mesh, mesh_axes_for_shape(tuple(leaf.shape), axes or (), mesh,
                                  rules)), tree, logical_axes)


def shard_by_shape(tree, logical_axes, mesh,
                   rules: LogicalAxisRules = DEFAULT_RULES):
    """Place a tree with the shape-guarded mapping (non-dividing dims
    replicate)."""
    return _map(distribute, tree,
                shardings_by_shape(tree, logical_axes, mesh, rules))


def with_logical_constraint(x, logical_axes, rules: LogicalAxisRules =
                            DEFAULT_RULES, mesh=None):
    """The identity without a mesh (none given, none active).  With
    one, a DTensor is redistributed to the rules' layout; a plain
    tensor is this rank's own block already and passes unchanged."""
    from torch.distributed.tensor import DTensor

    mesh = mesh if mesh is not None else active_mesh()
    if mesh is None or not isinstance(x, DTensor):
        return x
    return x.redistribute(mesh, placements_for(
        logical_to_mesh_axes(logical_axes, rules), mesh))


def gather_block(local, placements, mesh, keep: Sequence[str] = ()):
    """This rank's block ``local`` of a tensor placed by ``placements``
    on ``mesh``, all-gathered over every Shard axis not named in
    ``keep`` (an array dim split over several axes gathers the inner
    axis first).  Differentiable: the gradient of the result comes back
    as the SUM over the ranks that computed with it, reduce-scattered
    over the gathered axes and all-reduced over the axes that replicate
    the block (those of size > 1)."""
    from ray_tpu_torch.parallel.collective import (_sum_grad,
                                                   xla_allgather)

    names = list(mesh.mesh_dim_names)
    sizes = mesh_shape(mesh)
    replicated = tuple(n for n, pl in zip(names, placements)
                       if not pl.is_shard() and sizes[n] > 1)
    if replicated:
        local = _sum_grad(local, replicated, mesh)
    for n, pl in reversed(list(zip(names, placements))):
        if pl.is_shard() and n not in keep:
            local = xla_allgather(local, n, gather_axis=pl.dim, mesh=mesh)
    return local


def gather_params(tree, keep: Sequence[str] = ()):
    """Each DTensor leaf of ``tree`` as this rank's local tensor,
    all-gathered over every mesh axis except those named in ``keep``
    (where the rank keeps its shard); plain leaves pass unchanged.

    The gradient of a returned tensor comes back onto its DTensor's own
    placements as the SUM over the ranks that computed with it
    (``gather_block``): reduce-scattered onto an fsdp shard, all-reduced
    over the ranks that replicate it.  Scale the loss by 1 / world size
    before the backward for the mean (the train step does).  No DTensor
    op runs: the collectives act on the local blocks."""
    from torch.distributed.tensor import DTensor

    if isinstance(tree, dict):
        return {k: gather_params(v, keep) for k, v in tree.items()}
    if isinstance(tree, list):
        return [gather_params(v, keep) for v in tree]
    if not isinstance(tree, DTensor):
        return tree
    return gather_block(tree.to_local(), tree.placements, tree.device_mesh,
                        keep)
