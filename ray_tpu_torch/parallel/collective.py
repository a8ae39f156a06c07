"""Collective communication API.  Counterpart of
``ray_tpu/parallel/collective.py``.

Two planes, as in the JAX package:

* **in-program** (``xla_*``): collectives over one axis of a mesh
  (``parallel/mesh.py``; the active one unless ``mesh=`` is given),
  called by every rank of the program, on the tensors it holds.  The
  JAX package runs them under ``shard_map``; here they are
  ``torch.distributed``'s functional collectives over the mesh axis's
  process group (NCCL on the card, gloo on the CPU).  The sum and mean
  all-reduce, the all-gather, the reduce-scatter, the broadcast, the
  permutation and the all-to-all are differentiable: the backward of
  each is its adjoint, with a loss taken as the SUM of every rank's
  own (an all-reduce's backward is an all-reduce, an all-gather's a
  reduce-scatter, a permutation's the inverse permutation).
* **declared groups** (``init_collective_group`` ... ``barrier``): the
  JAX package's cross-actor collectives, rendezvous through the
  runtime's GCS KV and data through its object store, for actors that
  are not one program.  They take numpy arrays or tensors and return
  the same kind, a tensor on the device it came from.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

# ---------------------------------------------------------------------------
# In-program collectives over a mesh axis.
# ---------------------------------------------------------------------------

Axis = Union[str, Tuple[str, ...]]


def _mesh(mesh):
    from ray_tpu_torch.parallel.mesh import active_mesh

    mesh = mesh if mesh is not None else active_mesh()
    if mesh is None:
        raise RuntimeError("an in-program collective runs over an axis of "
                           "a mesh: pass mesh= or call it inside "
                           "mesh_context(mesh)")
    return mesh


def axis_size(axis: Axis, mesh=None) -> int:
    """Ranks along ``axis`` (a mesh axis name, or a tuple of them)."""
    m = _mesh(mesh)
    names = (axis,) if isinstance(axis, str) else tuple(axis)
    n = 1
    for a in names:
        n *= m.size(m.mesh_dim_names.index(a))
    return n


def axis_index(axis: str, mesh=None) -> int:
    """This rank's index along ``axis`` (``lax.axis_index``)."""
    m = _mesh(mesh)
    return int(m.get_local_rank(axis))


def flat_index(axes: Tuple[str, ...], mesh=None) -> int:
    """This rank's row-major index over ``axes`` (in mesh order): its
    block of a dim split over them."""
    i = 0
    for a in axes:
        i = i * axis_size(a, mesh) + axis_index(a, mesh)
    return i


def _fc():
    import torch.distributed._functional_collectives as fc

    return fc


def _wait(t):
    return _fc().wait_tensor(t)


def _g(mesh, axis: str) -> tuple:
    """The functional collectives' group of a mesh axis: (mesh, dim)."""
    return (mesh, list(mesh.mesh_dim_names).index(axis))


def _raw_all_reduce(x, op: str, mesh, axis: str):
    return _wait(_fc().all_reduce(x.contiguous(), op, _g(mesh, axis)))


def _raw_all_gather(x, dim: int, mesh, axis: str):
    fc = _fc()
    gather = getattr(fc, "all_gather_single", None) or fc.all_gather_tensor
    return _wait(gather(x.contiguous(), dim, _g(mesh, axis)))


def _raw_reduce_scatter(x, dim: int, mesh, axis: str):
    fc = _fc()
    scatter = (getattr(fc, "reduce_scatter_single", None)
               or fc.reduce_scatter_tensor)
    return _wait(scatter(x.contiguous(), "sum", dim, _g(mesh, axis)))


def _raw_all_to_all(x, split: int, concat: int, mesh, axis: str):
    import torch

    n = axis_size(axis, mesh)
    blocks = torch.stack(x.chunk(n, dim=split))
    # exchanged as n rows of one flat block each
    got = _wait(_fc().all_to_all_single(blocks.reshape(n, -1), None, None,
                                        _g(mesh, axis)))
    return torch.cat(got.reshape(blocks.shape).unbind(0), dim=concat)


def _raw_permute(x, pairs, mesh, axis: str):
    """Rank ``d`` of the axis gets rank ``s``'s ``x`` for each (s, d)
    of ``pairs``, zeros where it is no destination (``lax.ppermute``):
    point-to-point sends and receives within the axis's group."""
    import torch
    import torch.distributed as dist

    dst = dict(pairs)
    if len(dst) != len(pairs) or len(set(dst.values())) != len(pairs):
        raise ValueError(f"perm {pairs} sends from or to an index twice")
    src = {d: s for s, d in pairs}
    group = mesh.get_group(axis)
    members = dist.get_process_group_ranks(group)
    me = axis_index(axis, mesh)
    x = x.contiguous()
    out = torch.zeros_like(x)
    ops = []
    if me in dst:
        ops.append(dist.P2POp(dist.isend, x, members[dst[me]], group))
    if me in src:
        ops.append(dist.P2POp(dist.irecv, out, members[src[me]], group))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return out


def _autograd():
    """The differentiable collectives (autograd.Function classes made
    once, at first use: no torch import when this module loads)."""
    global _FNS
    if _FNS is not None:
        return _FNS
    import torch

    class AllReduce(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, op, mesh, axes):
            ctx.op, ctx.mesh, ctx.axes = op, mesh, axes
            for a in axes:
                x = _raw_all_reduce(x, op, mesh, a)
            return x

        @staticmethod
        def backward(ctx, g):
            for a in ctx.axes:
                g = _raw_all_reduce(g, ctx.op, ctx.mesh, a)
            return g, None, None, None

    class AllGather(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, dim, mesh, axis):
            ctx.dim, ctx.mesh, ctx.axis = dim, mesh, axis
            return _raw_all_gather(x, dim, mesh, axis)

        @staticmethod
        def backward(ctx, g):
            return (_raw_reduce_scatter(g, ctx.dim, ctx.mesh, ctx.axis),
                    None, None, None)

    class ReduceScatter(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, dim, mesh, axis):
            ctx.dim, ctx.mesh, ctx.axis = dim, mesh, axis
            return _raw_reduce_scatter(x, dim, mesh, axis)

        @staticmethod
        def backward(ctx, g):
            return (_raw_all_gather(g, ctx.dim, ctx.mesh, ctx.axis),
                    None, None, None)

    class AllToAll(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, split, concat, mesh, axis):
            ctx.args = (split, concat, mesh, axis)
            return _raw_all_to_all(x, split, concat, mesh, axis)

        @staticmethod
        def backward(ctx, g):
            split, concat, mesh, axis = ctx.args
            return (_raw_all_to_all(g, concat, split, mesh, axis),
                    None, None, None, None)

    class Permute(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, pairs, mesh, axis):
            ctx.args = (pairs, mesh, axis)
            return _raw_permute(x, pairs, mesh, axis)

        @staticmethod
        def backward(ctx, g):
            pairs, mesh, axis = ctx.args
            return (_raw_permute(g, [(d, s) for s, d in pairs], mesh, axis),
                    None, None, None)

    class SumGrad(torch.autograd.Function):
        """The identity, whose backward sums the gradient over the
        axes: a value every rank holds alike, used by each."""

        @staticmethod
        def forward(ctx, x, mesh, axes):
            ctx.mesh, ctx.axes = mesh, axes
            return x.view_as(x)

        @staticmethod
        def backward(ctx, g):
            for a in ctx.axes:
                g = _raw_all_reduce(g, "sum", ctx.mesh, a)
            return g, None, None

    _FNS = {"all_reduce": AllReduce, "all_gather": AllGather,
            "reduce_scatter": ReduceScatter, "all_to_all": AllToAll,
            "permute": Permute, "sum_grad": SumGrad}
    return _FNS


_FNS: Optional[Dict[str, Any]] = None


def _sum_grad(x, axes: Tuple[str, ...], mesh):
    """``x`` unchanged; its gradient summed over ``axes`` of ``mesh``
    in the backward (the adjoint of using a replicated value)."""
    return _autograd()["sum_grad"].apply(x, mesh, tuple(axes))
_OPS = {"sum": "sum", "mean": "avg", "max": "max", "min": "min"}


def xla_allreduce(x, axis: Axis, op: str = "sum", *, mesh=None):
    """``lax.psum``/``pmean``/``pmax``/``pmin`` over ``axis`` (a mesh
    axis or a tuple of them).  Sum and mean are differentiable."""
    if op not in _OPS:
        raise ValueError(f"unsupported reduce op {op!r}")
    m = _mesh(mesh)
    axes = tuple(a for a in ((axis,) if isinstance(axis, str) else axis)
                 if axis_size(a, m) > 1)
    if not axes:
        return x
    if op in ("sum", "mean"):
        # a mean is the sum over the ranks divided by their count (gloo
        # has no averaging reduction)
        out = _autograd()["all_reduce"].apply(x, "sum", m, axes)
        return out / axis_size(axes, m) if op == "mean" else out
    out = x.detach()
    for a in axes:
        out = _raw_all_reduce(out, _OPS[op], m, a)
    return out


def xla_allgather(x, axis: str, *, tiled: bool = True, gather_axis: int = 0,
                  mesh=None):
    """``lax.all_gather``: the axis's blocks concatenated along
    ``gather_axis`` (tiled) or stacked on a new one there."""
    import torch

    m = _mesh(mesh)
    if not tiled:
        x = x.unsqueeze(gather_axis)
    if axis_size(axis, m) == 1:
        return x
    return _autograd()["all_gather"].apply(x, gather_axis, m, axis)


def xla_reducescatter(x, axis: str, *, scatter_axis: int = 0, mesh=None):
    """``lax.psum_scatter(tiled=True)``: the sum over the axis, each
    rank keeping its block of ``scatter_axis``."""
    m = _mesh(mesh)
    if axis_size(axis, m) == 1:
        return x
    return _autograd()["reduce_scatter"].apply(x, scatter_axis, m, axis)


def xla_broadcast(x, axis: str, src: int = 0, *, mesh=None):
    """Broadcast ``src``'s block to all members of the axis, as the JAX
    version computes it: a sum of ``x`` masked to the source."""
    m = _mesh(mesh)
    sel = 1.0 if axis_index(axis, m) == src else 0.0
    return xla_allreduce(x * sel, axis, "sum", mesh=m)


def xla_ppermute(x, axis: str, perm: Sequence[Tuple[int, int]], *,
                 mesh=None):
    """``lax.ppermute``: rank d of the axis receives rank s's ``x`` for
    each (s, d) in ``perm``, zeros where it is no destination."""
    m = _mesh(mesh)
    pairs = [(int(s), int(d)) for s, d in perm]
    if axis_size(axis, m) == 1:
        return x if pairs == [(0, 0)] else x * 0
    return _autograd()["permute"].apply(x, pairs, m, axis)


def xla_all_to_all(x, axis: str, *, split_axis: int, concat_axis: int,
                   mesh=None):
    """``lax.all_to_all(tiled=True)``: ``x`` split into the axis's size
    blocks along ``split_axis``, block j sent to rank j, the received
    blocks concatenated along ``concat_axis`` in rank order."""
    m = _mesh(mesh)
    if axis_size(axis, m) == 1:
        return x
    return _autograd()["all_to_all"].apply(x, split_axis, concat_axis, m,
                                           axis)


# ---------------------------------------------------------------------------
# Cross-actor collectives over the object store (declared groups).
# ---------------------------------------------------------------------------

_groups: Dict[str, "_Group"] = {}
_groups_lock = threading.Lock()
_POLL_S = 0.002


def _host(x):
    """What a rank offers: a tensor moved to the host (bf16 stays a
    tensor: numpy has none), or a numpy array."""
    if hasattr(x, "detach") and hasattr(x, "device"):
        return x.detach().cpu()
    return np.asarray(x)


def _like(value, ref):
    """``value`` in ``ref``'s kind: a tensor on ``ref``'s device, or a
    numpy array."""
    if hasattr(ref, "detach") and hasattr(ref, "device"):
        import torch

        return torch.as_tensor(value).to(ref.device)
    return np.asarray(value)


def _reduce(parts: List[Any], op: str):
    if op not in _OPS:
        raise ValueError(f"unsupported reduce op {op!r}")
    if hasattr(parts[0], "detach"):
        import torch

        acc = torch.stack([torch.as_tensor(p) for p in parts])
        return {"sum": lambda: acc.sum(0), "mean": lambda: acc.mean(0),
                "max": lambda: acc.max(0).values,
                "min": lambda: acc.min(0).values}[op]()
    acc = np.stack(parts)
    return {"sum": acc.sum, "mean": acc.mean, "max": acc.max,
            "min": acc.min}[op](axis=0)


class _Group:
    def __init__(self, world_size: int, rank: int, name: str):
        self.world_size = world_size
        self.rank = rank
        self.name = name
        self.seq = 0          # collective-op counter; all ranks advance in step
        self._p2p: Dict[tuple, int] = {}   # (src, dst) -> p2p op counter
        # Rendezvous generation: the Nth cohort of world_size arrivals at
        # this group name forms generation N; keys are namespaced by it
        # so a re-created group never reads a previous generation's data.
        self.epoch = (self._kv_incr(f"colgen:{name}") - 1) // world_size

    # -- KV helpers -------------------------------------------------------
    def _cw(self):
        from ray_tpu_torch._private import worker_context
        return worker_context.core_worker()

    def _kv_incr(self, key: str) -> int:
        cw = self._cw()
        return cw.io.run(cw.gcs.call("kv_incr", {"key": key}))

    def _prefix(self) -> str:
        return f"col:{self.name}:{self.epoch}"

    def _kv_put(self, key: str, value: bytes):
        cw = self._cw()
        cw.io.run(cw.gcs.call(
            "kv_put", {"key": f"{self._prefix()}:{key}", "value": value}))

    def _kv_get(self, key: str, timeout: float) -> bytes:
        cw = self._cw()
        deadline = time.monotonic() + timeout
        full = f"{self._prefix()}:{key}"
        while True:
            v = cw.io.run(cw.gcs.call("kv_get", {"key": full}))
            if v is not None:
                return v
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"collective {full} timed out after {timeout}s "
                    f"(rank {self.rank}/{self.world_size})")
            time.sleep(_POLL_S)

    def _offer(self, tag: str, array) -> None:
        """Publish this rank's contribution: object-store put + KV pointer."""
        import pickle
        cw = self._cw()
        ref = cw.put(_host(array))
        self._kv_put(f"{tag}:{self.rank}", pickle.dumps(ref))

    def _collect(self, tag: str, rank: int, timeout: float):
        import pickle
        cw = self._cw()
        ref = pickle.loads(self._kv_get(f"{tag}:{rank}", timeout))
        return cw.get([ref], timeout=timeout)[0]

    # -- ops --------------------------------------------------------------
    def _gather(self, array, timeout: float) -> List[Any]:
        tag = f"ag:{self.seq}"
        self.seq += 1
        self._offer(tag, array)
        return [self._collect(tag, r, timeout)
                for r in range(self.world_size)]

    def allgather(self, array, timeout: float) -> List[Any]:
        return [_like(p, array) for p in self._gather(array, timeout)]

    def allreduce(self, array, op: str, timeout: float):
        return _like(_reduce(self._gather(array, timeout), op), array)

    def reducescatter(self, array, op: str, timeout: float):
        full = self.allreduce(array, op, timeout)
        if hasattr(full, "detach"):
            import torch

            return torch.tensor_split(full, self.world_size)[self.rank]
        return np.array_split(full, self.world_size)[self.rank]

    def broadcast(self, array, src: int, timeout: float):
        tag = f"bc:{self.seq}"
        self.seq += 1
        if self.rank == src:
            self._offer(tag, array)
            return array
        return _like(self._collect(tag, src, timeout), array)

    def send(self, array, dst: int, timeout: float) -> None:
        # Per-channel counters so p2p ops never desync the group-wide
        # collective counter on non-participating ranks.
        chan = (self.rank, dst)
        n = self._p2p.get(chan, 0)
        self._p2p[chan] = n + 1
        self._offer(f"p2p:{n}:{self.rank}->{dst}", array)

    def recv(self, src: int, timeout: float, like=None):
        chan = (src, self.rank)
        n = self._p2p.get(chan, 0)
        self._p2p[chan] = n + 1
        got = self._collect(f"p2p:{n}:{src}->{self.rank}", src, timeout)
        return got if like is None else _like(got, like)

    def cleanup(self):
        """Delete this generation's rendezvous keys from GCS KV."""
        try:
            cw = self._cw()
            cw.io.run(cw.gcs.call("kv_del_prefix",
                                  {"prefix": self._prefix()}))
        except Exception:  # noqa: BLE001 - best-effort on teardown
            pass

    def barrier(self, timeout: float) -> None:
        self._gather(np.zeros(1, dtype=np.int8), timeout)


def init_collective_group(world_size: int, rank: int, *,
                          backend: str = "objstore",
                          group_name: str = "default") -> None:
    """Declare this process/actor a member of a named collective group.
    Call from every participant (the JAX package's backends: "objstore"
    and "xla")."""
    if backend not in ("objstore", "xla"):
        raise ValueError(f"unknown collective backend {backend!r}")
    if not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} out of range [0, {world_size})")
    with _groups_lock:
        _groups[group_name] = _Group(world_size, rank, group_name)


def destroy_collective_group(group_name: str = "default") -> None:
    with _groups_lock:
        g = _groups.pop(group_name, None)
    if g is not None:
        g.cleanup()


def is_group_initialized(group_name: str = "default") -> bool:
    return group_name in _groups


def get_rank(group_name: str = "default") -> int:
    return _group(group_name).rank


def get_collective_group_size(group_name: str = "default") -> int:
    return _group(group_name).world_size


def _group(name: str) -> _Group:
    g = _groups.get(name)
    if g is None:
        raise RuntimeError(
            f"collective group {name!r} not initialized; call "
            f"init_collective_group() first")
    return g


def allreduce(array, op: str = "sum", group_name: str = "default",
              timeout: float = 60.0):
    return _group(group_name).allreduce(array, op, timeout)


def allgather(array, group_name: str = "default", timeout: float = 60.0):
    return _group(group_name).allgather(array, timeout)


def reducescatter(array, op: str = "sum", group_name: str = "default",
                  timeout: float = 60.0):
    return _group(group_name).reducescatter(array, op, timeout)


def broadcast(array, src_rank: int = 0, group_name: str = "default",
              timeout: float = 60.0):
    return _group(group_name).broadcast(array, src_rank, timeout)


def send(array, dst_rank: int, group_name: str = "default",
         timeout: float = 60.0):
    _group(group_name).send(array, dst_rank, timeout)


def recv(src_rank: int, group_name: str = "default", timeout: float = 60.0,
         like=None):
    """The array ``src_rank`` sent; with ``like`` (a tensor) a tensor
    on ``like``'s device."""
    return _group(group_name).recv(src_rank, timeout, like)


def barrier(group_name: str = "default", timeout: float = 60.0):
    _group(group_name).barrier(timeout)
