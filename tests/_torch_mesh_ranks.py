"""Rank programs for the port's multi-rank tests (tests/test_torch_
parallel.py), and their launcher.

Each program runs in its own process, started with the ``spawn``
context (the test process holds JAX and event-loop threads, which a
fork would copy), as one rank of a gloo process group on the CPU.
This module imports no JAX, and neither do the ranks: the test
computes the JAX side in its own process and hands the ranks numpy
arrays.  Every queue read and join has a 120 s limit.
"""

from __future__ import annotations

import os
import socket
import traceback

import numpy as np

WAIT_S = 120.0


def free_port() -> int:
    """A free TCP port on the loopback interface (a bounded search)."""
    for _ in range(100):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        if port > 1024:
            return port
    raise RuntimeError("no free port in 100 tries")


def _program(name: str):
    """A program of this module by name, or "module:function" of
    another module of rank programs (which must import no JAX)."""
    if ":" in name:
        import importlib

        mod, fn = name.split(":")
        return getattr(importlib.import_module(mod), fn)
    return globals()[name]


def _entry(rank, world, port, name, args, queue):
    import faulthandler

    # a rank stuck in a collective prints its stack and exits before
    # the parent's wait runs out
    faulthandler.dump_traceback_later(WAIT_S - 20, exit=True)
    try:
        import torch
        import torch.distributed as dist

        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                                rank=rank, world_size=world)
        try:
            out = _program(name)(rank, world, *args)
        finally:
            dist.destroy_process_group()
        queue.put((rank, "ok", out))
    except BaseException:  # noqa: BLE001 - reported to the test
        queue.put((rank, "error", traceback.format_exc()))
    # flush the result, then leave without the interpreter's teardown
    # (the process group's threads can hold it up)
    queue.close()
    queue.join_thread()
    os._exit(0)


def launch(name: str, world: int, *args) -> list:
    """Run program ``name`` (``_program``) on ``world`` gloo ranks; its
    return values in rank order.  Raises with a rank's traceback if one
    failed."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_entry,
                         args=(r, world, port, name, args, queue),
                         daemon=True) for r in range(world)]
    env = {"OMP_NUM_THREADS": "1"}
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        for p in procs:
            p.start()
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    results, errors = {}, []
    try:
        for _ in range(world):
            rank, status, out = queue.get(timeout=WAIT_S)
            if status == "ok":
                results[rank] = out
            else:
                errors.append(f"rank {rank}:\n{out}")
                break
    finally:
        for p in procs:
            p.join(timeout=WAIT_S if not errors else 5)
            if p.is_alive():
                p.terminate()
                p.join(timeout=WAIT_S)
    if errors:
        raise RuntimeError("\n".join(errors))
    return [results[r] for r in range(world)]


# -- helpers ----------------------------------------------------------------

def _tree(np_tree, dtype=None):
    import torch

    if isinstance(np_tree, dict):
        return {k: _tree(v, dtype) for k, v in np_tree.items()}
    t = torch.from_numpy(np.array(np_tree))
    return t if dtype is None else t.to(dtype)


def _locals(tree):
    """A tree of DTensors (or tensors) as numpy: each rank's block."""
    if isinstance(tree, dict):
        return {k: _locals(v) for k, v in tree.items()}
    t = tree.to_local() if hasattr(tree, "to_local") else tree
    return t.detach().cpu().numpy().copy()   # not a view of the state


def _gpt2(preset_kw):
    import torch

    from ray_tpu_torch.models import gpt2 as tg

    return tg.gpt2_config("nano", dtype=torch.float32, **preset_kw)


# -- programs ---------------------------------------------------------------

def prog_device_plane(rank, world, shard_cases, moe_inputs, vit_inputs):
    """4 ranks: (a) shard_params of each case on its mesh, this rank's
    block; (b) the xla_* collectives; (c) moe_apply with the experts
    split over expert=4; (e) one AdamW step of ViT tiny on fsdp=2 x
    tensor=2."""
    import torch

    from ray_tpu_torch.models import moe as tm
    from ray_tpu_torch.parallel import (MeshSpec, collective, make_mesh,
                                        mesh_context, shard_params)

    import sys

    # the ranks import no JAX (the parent process holds it)
    out = {"shards": [], "coords": None,
           "jax_loaded": "jax" in sys.modules or "ray_tpu" in sys.modules}
    meshes = {}
    for spec_kw, arr, axes in shard_cases:
        key = tuple(sorted(spec_kw.items()))
        if key not in meshes:
            meshes[key] = make_mesh(MeshSpec(**spec_kw))
        placed = shard_params({"w": torch.from_numpy(arr)}, {"w": axes},
                              meshes[key])
        out["shards"].append(placed["w"].to_local().numpy())
    mesh = make_mesh(MeshSpec(data=2, tensor=2))
    out["coords"] = {a: int(mesh.get_local_rank(a))
                     for a in mesh.mesh_dim_names}
    x = torch.arange(8, dtype=torch.float32).reshape(2, 4) + 10 * rank
    with mesh_context(mesh):
        out["psum_data"] = collective.xla_allreduce(x, "data").numpy()
        out["pmean_tensor"] = collective.xla_allreduce(
            x, "tensor", "mean").numpy()
        out["pmax_both"] = collective.xla_allreduce(
            x, ("data", "tensor"), "max").numpy()
        out["gather_tiled"] = collective.xla_allgather(
            x, "data", gather_axis=1).numpy()
        out["gather_stacked"] = collective.xla_allgather(
            x, "tensor", tiled=False).numpy()
        out["scatter"] = collective.xla_reducescatter(
            x, "data", scatter_axis=1).numpy()
        out["broadcast"] = collective.xla_broadcast(x, "tensor",
                                                    src=1).numpy()
        out["ppermute"] = collective.xla_ppermute(
            x, "data", [(0, 1)]).numpy()
        out["all_to_all"] = collective.xla_all_to_all(
            x, "tensor", split_axis=1, concat_axis=0).numpy()
        # the gradient of a sum of every rank's psum: the psum of ones
        xg = x.clone().requires_grad_(True)
        collective.xla_allreduce(xg * xg, "data").sum().backward()
        out["psum_grad"] = xg.grad.numpy()
    # (c) the expert-parallel MoE block against one rank's
    kw, params, xin = moe_inputs
    cfg = tm.MoEConfig(dtype=torch.float32, **kw)
    emesh = make_mesh(MeshSpec(expert=4))
    from ray_tpu_torch.models.moe import moe_logical_axes

    sp = shard_params(_tree(params), moe_logical_axes(cfg), emesh)
    out["w1_local"] = sp["w1"].to_local().shape[0]
    with mesh_context(emesh):
        y, aux = tm.moe_apply(sp, torch.from_numpy(xin), cfg)
    out["moe_y"], out["moe_aux"] = y.numpy(), float(aux)
    # (d) the batch split over data=2, the experts over expert=2: this
    # rank's rows, their routing (queue positions) and outputs
    dmesh = make_mesh(MeshSpec(data=2, expert=2))
    got = {}
    real = tm.moe_route

    def spy(*a, **kw):
        got.update(real(*a, **kw))
        return got

    tm.moe_route = spy
    try:
        d = int(dmesh.get_local_rank("data"))
        rows = xin.shape[0] // 2
        dp = shard_params(_tree(params), moe_logical_axes(cfg), dmesh)
        y, aux = tm.moe_apply(dp, torch.from_numpy(
            xin[d * rows:(d + 1) * rows]), cfg, mesh=dmesh)
    finally:
        tm.moe_route = real
    out.update(split_data=d, split_position=got["position"].numpy(),
               split_y=y.numpy(), split_aux=float(aux))
    out["vit"] = _vit_mesh_step(*vit_inputs)
    return out


def _vit_mesh_step(np_params, images, labels, lr):
    """(e) One AdamW step of ViT tiny (f32) through build_train_step on
    a fsdp=2 x tensor=2 mesh, the parameters placed by shard_params
    over vit_logical_axes: the loss, and the updated parameters
    gathered whole."""
    import torch

    from ray_tpu_torch.models import vit as tv
    from ray_tpu_torch.parallel import MeshSpec, make_mesh, shard_params
    from ray_tpu_torch.parallel.sharding import gather_params
    from ray_tpu_torch.train import adamw, build_train_step

    cfg = tv.vit_config("tiny", dtype=torch.float32)
    mesh = make_mesh(MeshSpec(fsdp=2, tensor=2))
    axes = tv.vit_logical_axes(cfg)
    tx = adamw(lr, weight_decay=0.1)
    params = shard_params(_tree(np_params), axes, mesh)
    step = build_train_step(lambda p, b: tv.vit_loss(p, b, cfg), tx,
                            mesh=mesh, logical_axes=axes, telemetry=False)
    batch = {"images": torch.from_numpy(images),
             "labels": torch.from_numpy(labels)}
    params, _, loss = step(params, tx.init(params), batch)
    return {"loss": float(loss),
            "qkv_placements": str(params["blocks"]["attn"]["qkv_w"]
                                  .placements),
            "params": _locals(gather_params(params))}


def prog_fsdp_step(rank, world, np_params, tokens, lr):
    """2 ranks, fsdp=2: one AdamW step of GPT-2 nano through
    build_train_step(mesh=...), an accumulated step (2 microbatches)
    through its in_shardings, and time_config(mesh="fsdp")'s losses."""
    import torch

    from ray_tpu_torch.bench import time_config
    from ray_tpu_torch.models import gpt2 as tg
    from ray_tpu_torch.parallel import MeshSpec, make_mesh, shard_params
    from ray_tpu_torch.parallel.sharding import param_shardings
    from ray_tpu_torch.train import (accumulated_train_step, adamw,
                                     build_train_step)

    cfg = _gpt2({})
    mesh = make_mesh(MeshSpec(fsdp=2))
    axes = tg.gpt2_logical_axes(cfg)
    tx = adamw(lr, weight_decay=0.1)
    batch = {"tokens": torch.from_numpy(tokens)}
    params = shard_params(_tree(np_params), axes, mesh)
    step = build_train_step(lambda p, b: tg.gpt2_loss(p, b, cfg), tx,
                            mesh=mesh, logical_axes=axes, telemetry=False,
                            health=True)
    params, state, loss, health = step(params, tx.init(params), batch)
    out = {"loss": float(loss), "params": _locals(params),
           "mu": _locals(state["mu"]),
           "grad_norm": float(health["grad_norm"]),
           "placements": str(params["wte"].placements)}
    # plain parameters are placed by the step itself
    p_shard = param_shardings(axes, mesh)
    acc = accumulated_train_step(
        lambda p, b: tg.gpt2_loss(p, b, cfg), tx, num_microbatches=2,
        jit_kwargs={"in_shardings": (p_shard, None, None)})
    plain = _tree(np_params)
    aparams, _, aloss = acc(plain, tx.init(plain), batch)
    out.update(accum_loss=float(aloss), accum_params=_locals(aparams))
    _, _, last, n_chips, cost = time_config(
        2, seq=32, n_steps=2, preset="nano", mesh="fsdp", device="cpu",
        dtype=torch.float32, use_flash=False)
    out.update(bench_losses=cost["losses"], bench_chips=n_chips)
    return out


def prog_moe_step(rank, world, np_params, tokens, lr, n_steps):
    """4 ranks, data=2 x expert=2: AdamW steps (no decay: optax.adam)
    of GPT-2 nano with 4 experts through build_train_step(mesh=...);
    every step's loss, the parameters after the first."""
    import torch

    from ray_tpu_torch.models import gpt2 as tg
    from ray_tpu_torch.parallel import MeshSpec, make_mesh, shard_params
    from ray_tpu_torch.train import adamw, build_train_step

    cfg = _gpt2(dict(n_experts=4, moe_top_k=2, use_flash=False))
    mesh = make_mesh(MeshSpec(data=2, expert=2))
    axes = tg.gpt2_logical_axes(cfg)
    tx = adamw(lr, weight_decay=0.0)
    params = shard_params(_tree(np_params), axes, mesh)
    state = tx.init(params)
    step = build_train_step(lambda p, b: tg.gpt2_loss(p, b, cfg), tx,
                            mesh=mesh, logical_axes=axes, telemetry=False)
    batch = {"tokens": torch.from_numpy(tokens)}
    losses, first = [], None
    for _ in range(n_steps):
        params, state, loss = step(params, state, batch)
        losses.append(float(loss))
        first = first or _locals(params)
    return {"losses": losses, "params": first,
            "w1_shape": tuple(params["blocks"]["moe"]["w1"].to_local().shape),
            "coords": {a: int(mesh.get_local_rank(a))
                       for a in mesh.mesh_dim_names}}


def prog_save(rank, world, path, np_params):
    """2 ranks, fsdp=2: save GPT-2 nano's parameters as DTensors."""
    from ray_tpu_torch.models import gpt2 as tg
    from ray_tpu_torch.parallel import MeshSpec, make_mesh, shard_params
    from ray_tpu_torch.train import save_sharded

    cfg = _gpt2({})
    mesh = make_mesh(MeshSpec(fsdp=2))
    params = shard_params(_tree(np_params), tg.gpt2_logical_axes(cfg), mesh)
    return save_sharded(params, path, step=3)


def prog_restore(rank, world, path):
    """4 ranks, data=2 x fsdp=2 (another mesh than the save's): this
    rank's blocks of the restored tree, and its placements."""
    from ray_tpu_torch.models import gpt2 as tg
    from ray_tpu_torch.parallel import MeshSpec, make_mesh
    from ray_tpu_torch.train import restore_sharded

    cfg = _gpt2({})
    mesh = make_mesh(MeshSpec(data=2, fsdp=2))
    got = restore_sharded(path, step=3, mesh=mesh,
                          axes=tg.gpt2_logical_axes(cfg))
    return {"params": _locals(got),
            "wte_placements": str(got["wte"].placements),
            "coords": {a: int(mesh.get_local_rank(a))
                       for a in mesh.mesh_dim_names}}
