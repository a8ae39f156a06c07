"""Rank programs for the port's sequence, pipeline and tensor-parallel
tests (tests/test_torch_ring_attention.py, test_torch_pipeline.py,
test_torch_gpt2_seq_parallel.py, test_torch_sharded_decode.py).

Each runs on gloo ranks started by ``tests/_torch_mesh_ranks.launch``
as ``"tests._torch_seq_ranks:<name>"``.  Like that module, this one
imports no JAX: the tests compute the JAX side in their own process and
hand the ranks numpy arrays, and the ranks hand numpy back.
"""

from __future__ import annotations

import numpy as np

from tests._torch_mesh_ranks import _tree


def _np(t):
    return t.detach().cpu().numpy().copy()


def _local_seq(x, rank_idx, n):
    tl = x.shape[1] // n
    return x[:, rank_idx * tl:(rank_idx + 1) * tl]


# -- ring and Ulysses attention -----------------------------------------------

def prog_ring(rank, world, cases):
    """4 ranks.  Each case: ring or Ulysses attention on this rank's
    sequence shard of seeded (B, T, H, D) q/k/v over seq=4 ("seq"), or
    over the seq axis of size 1 of a data=4 mesh ("data", the whole
    sequence on each rank: the identity case); with ``grad``, the
    gradients of sum(sin(out)) with respect to the local q/k/v.
    A case whose call raises a ValueError returns its message."""
    import torch

    from ray_tpu_torch.ops import ring_attention, ulysses_attention
    from ray_tpu_torch.parallel import MeshSpec, make_mesh

    meshes = {"seq": make_mesh(MeshSpec(seq=4)),
              "data": make_mesh(MeshSpec(data=4))}
    out = []
    for case in cases:
        mesh = meshes[case["mesh"]]
        n = 4 if case["mesh"] == "seq" else 1
        i = int(mesh.get_local_rank("seq"))
        q, k, v = (torch.from_numpy(_local_seq(case[x], i, n)).clone()
                   .requires_grad_(case["grad"]) for x in "qkv")
        fn = ulysses_attention if case["mode"] == "ulysses" else \
            ring_attention
        try:
            o = fn(q, k, v, causal=case["causal"], mesh=mesh)
        except ValueError as e:
            out.append({"error": str(e)})
            continue
        got = {"out": _np(o)}
        if case["grad"]:
            torch.sin(o).sum().backward()
            got.update(dq=_np(q.grad), dk=_np(k.grad), dv=_np(v.grad))
        out.append(got)
    return out


# -- the pipeline -------------------------------------------------------------

def _stage_fn(p, x):
    import torch

    return torch.tanh(x @ p["w"] + p["b"])


def prog_pipeline(rank, world, cases, grad_case, train_case):
    """4 ranks.  Each case (pp, mb, stacked params, x, dtensor) runs
    pipeline_apply on a pipeline=pp x data=4/pp mesh (with ``dtensor``
    the stacked params are DTensors split over the pipeline axis);
    ``grad_case`` differentiates mean((out - tgt)^2) / S with respect
    to the stacked params (this rank's stacked gradient: its own stage's
    row); ``train_case`` runs Adam steps (AdamW without decay) and
    returns the losses."""
    import torch

    from ray_tpu_torch.ops import pipeline_apply
    from ray_tpu_torch.parallel import MeshSpec, make_mesh
    from ray_tpu_torch.parallel.sharding import (NamedSharding,
                                                 PartitionSpec, distribute)
    from ray_tpu_torch.train import adamw

    meshes = {}

    def mesh_of(pp):
        if pp not in meshes:
            meshes[pp] = make_mesh(MeshSpec(pipeline=pp, data=-1))
        return meshes[pp]

    res = {"outs": []}
    for pp, mb, params, x, dtensor in cases:
        mesh = mesh_of(pp)
        p = _tree(params)
        if dtensor:
            sh = NamedSharding(mesh, PartitionSpec("pipeline"))
            p = {k: distribute(v, sh) for k, v in p.items()}
        with torch.no_grad():
            y = pipeline_apply(_stage_fn, p, torch.from_numpy(x),
                               microbatches=mb, mesh=mesh)
        res["outs"].append(_np(y))

    pp, mb, params, x, tgt = grad_case
    mesh = mesh_of(pp)
    p = {k: v.requires_grad_(True) for k, v in _tree(params).items()}
    y = pipeline_apply(_stage_fn, p, torch.from_numpy(x), microbatches=mb,
                       mesh=mesh)
    loss = ((y - torch.from_numpy(tgt)) ** 2).mean() / pp
    loss.backward()
    res["grads"] = {k: _np(v.grad) for k, v in p.items()}

    pp, mb, params, x, steps, lr = train_case
    mesh = mesh_of(pp)
    p = _tree(params)
    tx = adamw(lr, weight_decay=0.0)
    state = tx.init(p)
    xt = torch.from_numpy(x)
    losses = []
    for _ in range(steps):
        live = {k: v.detach().requires_grad_(True) for k, v in p.items()}
        y = pipeline_apply(_stage_fn, live, xt, microbatches=mb, mesh=mesh)
        loss = ((y - torch.sin(xt)) ** 2).mean()
        (loss / pp).backward()
        grads = [live[k].grad for k in sorted(live)]
        with torch.no_grad():
            tx.update_(p, grads, state)
        losses.append(float(loss))
    res["losses"] = losses
    return res


# -- GPT-2 under sequence parallelism -----------------------------------------

def prog_seq_gpt2(rank, world, np_params, tokens, cases):
    """4 ranks.  Each case (spec_kw, sp_mode): GPT-2 nano (f32, no
    flash, remat) with seq_parallel on that mesh, its loss and every
    gradient leaf through the mesh train step's value_and_grad (the
    parameters placed by the logical-axis rules, this rank's rows of
    the batch), each gradient gathered whole on rank 0."""
    import torch

    from ray_tpu_torch.models import gpt2 as tg
    from ray_tpu_torch.parallel import MeshSpec, make_mesh
    from ray_tpu_torch.parallel.sharding import gather_block
    from ray_tpu_torch.train.optim import tree_leaves
    from ray_tpu_torch.train.trainer import mesh_plan

    out = []
    batch = {"tokens": torch.from_numpy(tokens)}
    for spec_kw, sp_mode in cases:
        cfg = tg.gpt2_config("nano", dtype=torch.float32, use_flash=False,
                             remat=True, seq_parallel=True,
                             sp_mode=sp_mode)
        mesh = make_mesh(MeshSpec(**spec_kw))
        axes = tg.gpt2_logical_axes(cfg)
        plan = mesh_plan(mesh, axes)
        placed = plan.place(_tree(np_params))
        loss, grads = plan.value_and_grad(
            lambda p, b: tg.gpt2_loss(p, b, cfg), placed,
            plan.local_batch(batch))
        full = [gather_block(g, p.placements, mesh)
                for g, p in zip(grads, tree_leaves(placed))]
        out.append({"loss": float(loss),
                    "grads": [_np(g) for g in full] if rank == 0 else None})
    return out


# -- tensor-parallel decode and serving ---------------------------------------

BS = 16


def _right_aligned(tokens, t_pad):
    import torch

    out = np.zeros((1, t_pad), np.int32)
    out[0, t_pad - len(tokens):] = tokens
    return torch.from_numpy(out)


def _decode_family(name):
    import torch

    from ray_tpu_torch.models import gpt2 as tg
    from ray_tpu_torch.models import gpt2_decode, llama_decode
    from ray_tpu_torch.models import llama as tl
    from ray_tpu_torch.models.convert import (gpt2_params_from_numpy,
                                              llama_params_from_numpy)

    ovr = dict(dtype=torch.float32, use_flash=False, remat=False)
    if name == "gpt2":
        cfg = tg.gpt2_config("nano", **ovr)
        return (cfg, gpt2_params_from_numpy, tg.gpt2_logical_axes(cfg),
                gpt2_decode.paged_prefill, gpt2_decode.decode_step,
                gpt2_decode.init_paged_cache)
    cfg = tl.llama_config("nano", **ovr)
    return (cfg, llama_params_from_numpy, tl.llama_logical_axes(cfg),
            llama_decode.llama_paged_prefill,
            llama_decode.llama_decode_step,
            llama_decode.llama_init_paged_cache)


def _greedy(logits, cfg):
    from ray_tpu_torch.models.decode_common import (make_vocab_tail_mask,
                                                    sample_token)

    return sample_token(logits, None, 0.0,
                        make_vocab_tail_mask(cfg, logits.device))


def _tp_paged_decode(family, np_params, prompt, new, mesh):
    """tests/test_sharded_decode.py's paged decode on this rank's
    blocks: a paged prefill into row 0, then greedy decode steps with
    row 1 idle; the stream and each step's logits."""
    import torch

    from ray_tpu_torch.models.decode_common import tensor_parallel_params
    from ray_tpu_torch.parallel import mesh_context

    cfg, from_np, axes, paged_prefill, decode_step, init_paged = \
        _decode_family(family)
    params = tensor_parallel_params(from_np(np_params, cfg, device="cpu"),
                                    axes, mesh)
    nb_row = cfg.max_seq // BS
    with torch.no_grad(), mesh_context(mesh):
        cache = init_paged(cfg, 2, num_blocks=1 + 2 * nb_row,
                           block_size=BS, device="cpu", mesh=mesh)
        row_bt = torch.zeros(nb_row, dtype=torch.int32)
        row_bt[0] = 1
        logits, cache = paged_prefill(
            params, cache, _right_aligned(prompt, 16), cfg, row_bt=row_bt,
            prefix_len=np.int32(0), n_tail=np.int32(len(prompt)),
            slot=np.int32(0))
        steps = [logits.numpy().copy()]
        tok = _greedy(logits[None], cfg)
        stream = [int(tok[0])]
        cur = torch.tensor([int(tok[0]), 0], dtype=torch.int32)
        for _ in range(new - 1):
            logits, cache = decode_step(params, cache, cur, cfg)
            steps.append(logits[0].numpy().copy())
            nxt = _greedy(logits, cfg)
            stream.append(int(nxt[0]))
            cur = torch.tensor([int(nxt[0]), int(nxt[1])],
                               dtype=torch.int32)
    return {"stream": stream, "logits": steps,
            "k_heads": int(cache["k"].shape[3]),
            "wte_rows": int(params["wte"].shape[0])}


def _tp_prefix_reuse(family, np_params, a, b, new, mesh):
    """tests/test_sharded_decode.py's prefix reuse: b's tail prefilled
    over blocks a's prefill wrote; b's logits, then greedy streams of
    both rows from the shared pool."""
    import torch

    from ray_tpu_torch.models.decode_common import tensor_parallel_params
    from ray_tpu_torch.parallel import mesh_context

    cfg, from_np, axes, paged_prefill, decode_step, init_paged = \
        _decode_family(family)
    params = tensor_parallel_params(from_np(np_params, cfg, device="cpu"),
                                    axes, mesh)
    nb_row = cfg.max_seq // BS
    with torch.no_grad(), mesh_context(mesh):
        cache = init_paged(cfg, 2, num_blocks=1 + 2 * nb_row,
                           block_size=BS, device="cpu", mesh=mesh)
        bt_a = torch.arange(1, 1 + nb_row, dtype=torch.int32)
        logits_a, cache = paged_prefill(
            params, cache, _right_aligned(a, 48), cfg, row_bt=bt_a,
            prefix_len=np.int32(0), n_tail=np.int32(len(a)),
            slot=np.int32(0))
        bt_b = torch.zeros(nb_row, dtype=torch.int32)
        bt_b[0], bt_b[1], bt_b[2] = 1, 2, 1 + nb_row
        got, cache = paged_prefill(
            params, cache, _right_aligned(b[32:], 16), cfg, row_bt=bt_b,
            prefix_len=np.int32(32), n_tail=np.int32(len(b) - 32),
            slot=np.int32(1))
        tok = torch.stack([_greedy(logits_a[None], cfg)[0],
                           _greedy(got[None], cfg)[0]])
        streams, steps = [[], []], []
        for _ in range(new):
            streams[0].append(int(tok[0]))
            streams[1].append(int(tok[1]))
            logits, cache = decode_step(params, cache, tok, cfg)
            steps.append(logits.numpy().copy())
            tok = _greedy(logits, cfg)
    return {"got": got.numpy().copy(), "streams": streams, "logits": steps}


def _tp_engine(family, ckpt, prompts, max_new, mesh, rank):
    """tests/test_sharded_decode.py's continuous engine under the mesh:
    every rank builds it; rank 0 serves the prompts through 3 slots
    (two admission waves) and reads engine_stats(); rank 1 follows."""
    import asyncio

    import torch

    from ray_tpu_torch.serve.llm import build_llm_deployment

    dep = build_llm_deployment(
        family, "nano", max_new_tokens=max_new, temperature=0.0,
        scheduler="continuous", kv_layout="paged", kv_block_size=BS,
        prefill_bucket=16, max_slots=3, mesh=mesh, checkpoint_path=ckpt,
        config_overrides=dict(dtype=torch.float32, use_flash=False,
                              remat=False), device="cpu")
    inst = dep.func_or_class()
    if rank != 0:
        try:
            asyncio.run(inst(prompts[0]))
            refused = None
        except ValueError as e:
            refused = str(e)
        return {"followed": inst.follow(), "refused": refused}

    async def main():
        try:
            outs = await asyncio.wait_for(
                asyncio.gather(*[inst(p) for p in prompts]), 100)
            stats = inst.engine_stats()
        finally:
            inst.shutdown_engine()
        return outs, stats

    outs, stats = asyncio.run(main())
    kv = stats["kv_cache"]
    return {"outs": [np.asarray(o) for o in outs],
            "finished": stats["requests"]["finished"],
            "mesh": stats["mesh"],
            "kv": {k: kv[k] for k in ("pool_bytes", "pool_bytes_per_chip",
                                      "tensor_shards")},
            "programs": sorted(stats["programs"])}


def _tp_engine_extras(ckpt, prompts, mesh, rank):
    """Under the mesh, then (rank 0) without it, the same greedy
    requests: a speculative engine (n-gram drafts, k=2) over a 12-block
    pool with the host tier (evicted prefixes spill and restore whole
    rows), served one at a time, and a prefill/decode pair handing the
    prompts' rows over (whole rows out of the prefill pool, this rank's
    heads into the decode pool).  Rank 1 follows all three mesh engines
    in one loop."""
    import asyncio

    import torch

    from ray_tpu_torch.serve.llm import SpecConfig, build_llm_deployment

    common = dict(max_new_tokens=3, temperature=0.0, scheduler="continuous",
                  kv_layout="paged", kv_block_size=BS, prefill_bucket=16,
                  max_slots=2, checkpoint_path=ckpt, device="cpu",
                  config_overrides=dict(dtype=torch.float32,
                                        use_flash=False, remat=False))

    def build(m):
        return [build_llm_deployment("gpt2", "nano", mesh=m, **kw)
                .func_or_class() for kw in (
                    dict(common, kv_num_blocks=12,
                         kv_host_tier_bytes=1 << 24,
                         spec_decode=SpecConfig(draft="ngram", k=2)),
                    dict(common, role="prefill"),
                    dict(common, role="decode"))]

    async def drive(spec, pre, dec):
        try:
            outs = [await spec(p) for p in prompts]
            pair = [await dec.admit_prefilled(await pre(p))
                    for p in prompts[:4]]
        finally:
            for e in (spec, pre, dec):
                e.shutdown_engine()
        return outs, pair, spec.kv_stats()

    engines = build(mesh)
    if rank != 0:
        return {"followed": engines[0].follow()}
    got = asyncio.run(drive(*engines))
    want = asyncio.run(drive(*build(None)))
    return {"mesh": got, "alone": want}


def prog_tp_decode(rank, world, np_params, cases):
    """2 ranks, tensor=2: the paged decode and the prefix reuse of each
    family on this rank's blocks, then each family's continuous engine
    under the mesh, graftcheck's audit of the tensor-parallel decode
    step; and, on a data=2 mesh, this rank's rows of a sharded Data
    batch."""
    import torch

    from ray_tpu_torch import data
    from ray_tpu_torch.parallel import MeshSpec, make_mesh
    from ray_tpu_torch.parallel.sharding import NamedSharding, PartitionSpec

    mesh = make_mesh(MeshSpec(tensor=2))
    out = {}
    for family in ("gpt2", "llama"):
        c = cases[family]
        out[family] = {
            "decode": _tp_paged_decode(family, np_params[family],
                                       c["prompt"], c["new"], mesh),
            "reuse": _tp_prefix_reuse(family, np_params[family], c["a"],
                                      c["b"], c["reuse_new"], mesh),
            "engine": _tp_engine(family, c["ckpt"], c["prompts"],
                                 c["engine_new"], mesh, rank)}
    out["extras"] = _tp_engine_extras(cases["gpt2"]["ckpt"],
                                      cases["churn"], mesh, rank)
    # graftcheck's tensor-parallel spec, which needs the ranks
    from ray_tpu_torch.tools.graftcheck.programs import default_programs
    from ray_tpu_torch.tools.graftcheck.trace_audit import audit_program

    spec, = [s for s in default_programs()
             if s.name == "gpt2_sharded_decode_step"]
    violations, info = audit_program(spec)
    out["graftcheck"] = {"violations": [str(v) for v in violations],
                         "info": info}
    # the bench's decode path over the mesh, and alone
    from ray_tpu_torch.bench import time_decode

    kw = dict(prompt_len=16, new_tokens=4, preset="nano", device="cpu",
              dtype=torch.float32, use_flash=False)
    _, _, _, n_chips, tokens = time_decode(2, mesh=mesh, **kw)
    out["bench"] = {"n_chips": n_chips, "tokens": tokens.numpy(),
                    "alone": time_decode(2, **kw)[4].numpy()}
    # run_traffic over the mesh: rank 0's report, rank 1 follows
    from ray_tpu_torch.serve.traffic import TrafficSpec, run_traffic

    rep = run_traffic(
        TrafficSpec(num_requests=4, seed=0, num_prefix_groups=2,
                    prefix_len=32, p_shared=0.5, tail_len_mean=6.0,
                    tail_len_max=12, vocab=500),
        family="gpt2", preset="nano", max_slots=2, max_new_tokens=4,
        mesh=mesh, config_overrides=dict(dtype=torch.float32,
                                         use_flash=False), device="cpu")
    out["traffic"] = None if rep is None else {
        "completed": rep["completed"], "mesh": rep["engine"]["mesh"]}
    rows = NamedSharding(make_mesh(MeshSpec(data=2)), PartitionSpec("data"))
    ds = data.from_numpy({"x": np.arange(12, dtype=np.float32),
                          "y": np.arange(24).reshape(12, 2)})
    out["batches"] = [
        {k: (v.to_local().numpy().copy(), tuple(v.shape),
             str(v.placements)) for k, v in b.items()}
        for b in ds.iter_torch_batches(batch_size=4, sharding=rows,
                                       dtypes={"y": torch.float32})]
    return out
