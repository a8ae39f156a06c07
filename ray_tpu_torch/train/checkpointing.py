"""Checkpoints of a parameter tree in torch state.  Counterpart of
``ray_tpu/train/checkpointing.py``.

The JAX package writes orbax checkpoints in which every host writes
its own shards and a restore can re-shard onto another mesh.  The port
keeps the same ``step_N/`` directories in two forms:

* a tree of plain tensors (one device): one ``torch.save`` file of the
  tree, tensors copied to the host, written beside its final name and
  renamed;
* a tree of DTensors (a mesh, ``parallel.shard_params``):
  ``torch.distributed.checkpoint``, every rank writing its own shards
  (a replicated block once) and a ``.metadata`` file of the global
  shapes.

``restore_sharded`` reads either: with ``mesh`` and ``axes`` the leaves
land as DTensors placed by the rules on that mesh, whatever mesh wrote
them (each rank reads the blocks it holds); without, as whole tensors
on one device.  Every save and restore is timed and booked into the
trainer's trainwatch state as the JAX package books it.
``sharded_checkpoint_to_air`` wraps a checkpoint directory as an AIR
Checkpoint (``air/``).
"""

from __future__ import annotations

import os
import time
from typing import Any, Optional

import torch

from ray_tpu_torch.device import DeviceLike, resolve_device
from ray_tpu_torch.train.optim import tree_leaves, tree_map
from ray_tpu_torch.train.trainer import _is_dtensor

__all__ = ["save_sharded", "restore_sharded", "latest_step",
           "sharded_checkpoint_to_air"]

#: the one file of a checkpoint directory of plain tensors
TREE_FILE = "tree.pt"
#: the metadata file of a torch.distributed.checkpoint directory
DCP_METADATA = ".metadata"


def _flat(tree, prefix: str = ""):
    """[(dotted key, leaf)] of a nested dict, as
    torch.distributed.checkpoint flattens it."""
    if isinstance(tree, dict):
        return [kv for k in tree for kv in _flat(tree[k], f"{prefix}{k}.")]
    return [(prefix[:-1], tree)]


def _nest(flat: dict) -> dict:
    out: dict = {}
    for key, v in flat.items():
        node = out
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


def _step_dir(path: str, step: Optional[int]) -> str:
    return os.path.join(path, f"step_{step}") if step is not None else path


def _tree_bytes(tree: Any) -> int:
    """Total tensor bytes in a tree (numel * element_size)."""
    return int(sum(x.numel() * x.element_size() for x in tree_leaves(tree)
                   if isinstance(x, torch.Tensor)))


def _record_ckpt(kind: str, dur_s: float, nbytes: int, target: str,
                 step: Optional[int], trainer: str) -> None:
    """Book one save/restore pause into trainwatch: the goodput
    tracker (so checkpoint pauses show up in the goodput denominator
    and the next step's ``checkpoint`` anatomy leg) plus a
    ``ckpt_save``/``ckpt_restore`` flight-recorder journal event."""
    try:
        from ray_tpu_torch.train.goodput import (get_goodput_tracker,
                                                 get_train_recorder)

        get_goodput_tracker(trainer).record_checkpoint(
            kind, dur_s, nbytes=nbytes, step=step)
        get_train_recorder(trainer).record(
            f"ckpt_{kind}", step=step,
            dur_ms=round(dur_s * 1e3, 3), bytes=nbytes, path=target)
    except Exception:  # noqa: BLE001 - observability must not raise
        pass


def _to_host(x: Any) -> Any:
    return x.detach().cpu() if isinstance(x, torch.Tensor) else x


def save_sharded(params: Any, path: str, *,
                 step: Optional[int] = None,
                 trainer: str = "default") -> str:
    """Write a tree (nested dicts of tensors) under ``path``
    (``path/step_{step}`` when ``step`` is given); returns the
    checkpoint directory.  The pause, from the device-to-host copy to
    the file's close, is timed and journaled under the named trainer's
    trainwatch state (``train_stats(trainer)["checkpoint"]``).  The
    file is written beside its final name and renamed, so a crash
    leaves the previous checkpoint whole."""
    target = os.path.abspath(_step_dir(path, step))
    os.makedirs(target, exist_ok=True)
    t0 = time.perf_counter()
    if any(_is_dtensor(t) for t in tree_leaves(params)):
        # every rank of the mesh calls this, each writing its blocks
        import torch.distributed.checkpoint as dcp

        dcp.save(params, checkpoint_id=target)
    else:
        final = os.path.join(target, TREE_FILE)
        host = tree_map(_to_host, params)
        with open(final + ".tmp", "wb") as f:
            torch.save(host, f)
        os.replace(final + ".tmp", final)
    _record_ckpt("save", time.perf_counter() - t0,
                 _tree_bytes(params), target, step, trainer)
    return target


def _place(template: Any, restored: Any) -> Any:
    """``restored`` in ``template``'s layout, each leaf cast to its
    template leaf's dtype and placed on its device."""
    if isinstance(template, dict):
        got = sorted(restored) if isinstance(restored, dict) else restored
        if got != sorted(template):
            raise ValueError(f"checkpoint keys {got} do not match the "
                             f"template's {sorted(template)}")
        return {k: _place(template[k], restored[k]) for k in template}
    if isinstance(template, torch.Tensor):
        if tuple(restored.shape) != tuple(template.shape):
            raise ValueError(f"checkpoint leaf of shape "
                             f"{tuple(restored.shape)} where the template "
                             f"has {tuple(template.shape)}")
        return restored.to(device=template.device, dtype=template.dtype)
    return restored


def restore_sharded(path: str, *, step: Optional[int] = None,
                    template: Any = None, mesh=None, axes: Any = None,
                    rules=None, trainer: str = "default",
                    device: DeviceLike = None) -> Any:
    """Restore a tree saved with save_sharded.

    With a ``template`` (a tree of tensors) the leaves take its
    layout, dtypes and devices; without one they land on
    ``resolve_device(device)``: the card unless the caller asks for
    the CPU.  The pause, from the read to the last leaf on its device,
    is timed and journaled as ``save_sharded``'s.

    Re-sharding: with ``mesh`` (a DeviceMesh, every rank calling) and
    ``axes`` (the model's logical-axis tree, e.g. ``gpt2_logical_axes``)
    the leaves land as DTensors placed by ``rules`` (default
    ``DEFAULT_RULES``) on that mesh, whichever mesh, or one device,
    saved them."""
    target = os.path.abspath(_step_dir(path, step))
    sharded = os.path.exists(os.path.join(target, DCP_METADATA))
    onto_mesh = mesh is not None and axes is not None
    dev = None if (template is not None or onto_mesh) else \
        resolve_device(device)
    t0 = time.perf_counter()
    if sharded:
        restored = _load_dcp(target, template, dev,
                             (mesh, axes, rules) if onto_mesh else None)
    else:
        with open(os.path.join(target, TREE_FILE), "rb") as f:
            host = torch.load(f, map_location="cpu", weights_only=True)
        if onto_mesh:
            from ray_tpu_torch.parallel.sharding import (DEFAULT_RULES,
                                                         shard_params)

            restored = shard_params(host, axes, mesh, rules or DEFAULT_RULES)
        elif template is not None:
            restored = _place(template, host)
        else:
            restored = tree_map(lambda x: x.to(dev)
                                if isinstance(x, torch.Tensor) else x, host)
    _record_ckpt("restore", time.perf_counter() - t0,
                 _tree_bytes(restored), target, step, trainer)
    return restored


def _load_dcp(target: str, template: Any, dev, onto) -> Any:
    """A torch.distributed.checkpoint directory read into DTensors on
    ``onto`` = (mesh, axes, rules), into ``template``'s tensors, or
    into whole tensors on ``dev``."""
    import torch.distributed.checkpoint as dcp

    meta = dcp.FileSystemReader(target).read_metadata().state_dict_metadata
    if onto is not None:
        from torch.distributed.tensor import DTensor

        from ray_tpu_torch.parallel.sharding import (DEFAULT_RULES,
                                                     NamedSharding,
                                                     logical_to_mesh_axes,
                                                     placements_for)

        mesh, axes, rules = onto
        axes_of = dict(_flat(axes))
        dest = {}
        for key, m in meta.items():
            spec = logical_to_mesh_axes(axes_of[key] or (),
                                        rules or DEFAULT_RULES)
            sh = NamedSharding(mesh, spec)
            local = torch.empty(sh.shard_shape(tuple(m.size)),
                                dtype=m.properties.dtype,
                                device=_mesh_device(mesh))
            dest[key] = DTensor.from_local(
                local, mesh, placements_for(spec, mesh), run_check=False,
                shape=torch.Size(m.size), stride=_contiguous(m.size))
        dest = _nest(dest)
    elif template is not None:
        dest = tree_map(lambda t: t.detach().clone() if isinstance(
            t, torch.Tensor) else t, template)
    else:
        dest = _nest({k: torch.empty(tuple(m.size),
                                     dtype=m.properties.dtype, device=dev)
                      for k, m in meta.items()})
    dcp.load(dest, checkpoint_id=target)
    return dest


def _mesh_device(mesh):
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _contiguous(size) -> tuple:
    stride, acc = [], 1
    for n in reversed(tuple(size)):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))


def latest_step(path: str) -> Optional[int]:
    """Largest step_N subdirectory under `path`, or None."""
    try:
        steps = [int(d[len("step_"):]) for d in os.listdir(path)
                 if d.startswith("step_") and
                 d[len("step_"):].isdigit()]
    except OSError:
        return None
    return max(steps) if steps else None


def sharded_checkpoint_to_air(path: str, step: Optional[int] = None):
    """Wrap a checkpoint directory as an AIR Checkpoint so it flows
    through session.report / Tune bookkeeping like any other artifact
    (the directory itself stays in place: a checkpoint is too big to
    ship through the object store).  As ``ray_tpu/train/
    checkpointing.py:134-143``: a dict holding the directory's absolute
    path under ``"sharded_checkpoint_path"``."""
    from ray_tpu_torch.air import Checkpoint

    return Checkpoint.from_dict({
        "sharded_checkpoint_path": os.path.abspath(
            _step_dir(path, step))})
