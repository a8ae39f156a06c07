"""The canonical hot-path programs graftcheck audits (the counterpart of
``ray_tpu/tools/graftcheck/programs.py``: its 13 names, its nano shapes).

The train step for both model families, batched (ragged) prefill, the
pooled decode steps, the spec-decode verify step, a chunk of streaming
prefill, the prefill/decode handoff programs, and the fused CE forward
and backward.  Every spec runs a nano preset on the CPU, through the
kernels' plain routes (which report the kernels' own work and keep
their internals out of the shape rules, ``trace_audit.py``): the ops a
program dispatches, its tensors' shapes and dtypes and its in-place
updates are the same on the card.

Budgets are the JAX catalog's (2-3x its measured peaks), kept because
the port's harvested peaks, on the CPU at these shapes, all fit under
them (``python -m ray_tpu_torch.tools.graftcheck``): train steps
1.70-2.08 MiB against 8 MiB, serve programs 0.64-2.04 MiB against 6
MiB, the fused CE 0.24-0.39 MiB against 1 MiB.  Unlike the JAX
estimate, the port's peak counts the arguments' storages whole (the
parameters, the whole KV pool).
"""

from __future__ import annotations

from typing import List

import numpy as np

from ray_tpu_torch.tools.graftcheck.trace_audit import ProgramSpec

#: nano-family shape constants shared by the build functions below
_B, _T = 2, 64           # train batch: 128 tokens (> d_model=64)
_PB, _PT0 = 4, 64        # prefill batch: T0 != n_layer so no aliasing
_CE_N, _CE_D, _CE_V, _CE_VALID = 128, 64, 512, 500
_NANO_VOCAB = 512        # padded_vocab of the nano presets
_CHUNK_T = 32            # chunked-prefill tail bucket (< max_seq=128)
_BS = 16                 # the serve engine's default block size

_MiB = 2 ** 20

#: the paged decode's whole pool (L, 1 + B * max_seq / bs, bs, H, hd)
#: of nano: the tensor-parallel step must never hold it on one rank
_WHOLE_POOL = (2, 1 + _PB * 128 // _BS, _BS, 2, 32)

#: why a decode program's result holds a new ``pos``: the per-row
#: position vector is rebound as pos + 1 (or + kept + 1), 4 * B bytes
_POS_REBIND = ("the (B,) int32 position row is rebound (pos + n), "
               "4 * B bytes; the K/V pool is updated in place")


def _gen():
    import torch

    return torch.Generator().manual_seed(0)


def _nano_gpt2_cfg():
    from ray_tpu_torch.models.gpt2 import gpt2_config

    return gpt2_config("nano", ce_impl="pallas", ce_block_n=16,
                       ce_block_v=128, remat=False)


def _nano_llama_cfg():
    from ray_tpu_torch.models.llama import llama_config

    return llama_config("nano", ce_impl="pallas", ce_block_n=16,
                        ce_block_v=128)


def _f32_gpt2_cfg():
    import torch

    from ray_tpu_torch.models.gpt2 import gpt2_config

    return gpt2_config("nano", dtype=torch.float32, use_flash=False,
                       remat=False)


def _sgd_step(loss_fn):
    """The minimal train step (loss, backward, in-place update) — the
    optimizer does not change the audited invariants; parameters are
    updated in place, as build_train_step updates them."""
    import torch

    def step(params, batch):
        leaves = torch.utils._pytree.tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
            p.grad = None
        loss = loss_fn(params, batch)
        loss.backward()
        with torch.no_grad():
            for p in leaves:
                p.sub_(0.01 * p.grad.to(p.dtype))
                p.grad = None
        return params, loss.detach()

    return step


def _build_gpt2_train_step():
    import torch

    from ray_tpu_torch.models.gpt2 import gpt2_init, gpt2_loss

    cfg = _nano_gpt2_cfg()
    params = gpt2_init(cfg, _gen(), device="cpu")
    batch = {"tokens": torch.zeros((_B, _T + 1), dtype=torch.int64)}
    return _sgd_step(lambda p, b: gpt2_loss(p, b, cfg)), (params, batch)


def _build_llama_train_step():
    import torch

    from ray_tpu_torch.models.llama import llama_init, llama_loss

    cfg = _nano_llama_cfg()
    params = llama_init(cfg, _gen(), device="cpu")
    batch = {"tokens": torch.zeros((_B, _T + 1), dtype=torch.int64)}
    return _sgd_step(lambda p, b: llama_loss(p, b, cfg)), (params, batch)


def _serve(fn):
    """A serve program runs without autograd, as the engine runs it."""
    import torch

    def run(*args):
        with torch.inference_mode():
            return fn(*args)

    return run


def _build_gpt2_prefill_at(t0: int):
    import torch

    from ray_tpu_torch.models.gpt2 import gpt2_init
    from ray_tpu_torch.models.gpt2_decode import prefill

    cfg = _f32_gpt2_cfg()
    params = gpt2_init(cfg, _gen(), device="cpu")
    toks = torch.zeros((_PB, t0), dtype=torch.int32)
    lens = torch.full((_PB,), t0 // 2, dtype=torch.int32)
    return (_serve(lambda p, t, n: prefill(p, t, cfg, lengths=n)),
            (params, toks, lens))


def _build_llama_prefill_at(t0: int):
    import torch

    from ray_tpu_torch.models.llama import llama_init
    from ray_tpu_torch.models.llama_decode import llama_prefill

    cfg = _nano_llama_cfg()
    params = llama_init(cfg, _gen(), device="cpu")
    toks = torch.zeros((_PB, t0), dtype=torch.int32)
    lens = torch.full((_PB,), t0 // 2, dtype=torch.int32)
    return (_serve(lambda p, t, n: llama_prefill(p, t, cfg, lengths=n)),
            (params, toks, lens))


def _build_gpt2_decode_step():
    import torch

    from ray_tpu_torch.models.gpt2 import gpt2_init
    from ray_tpu_torch.models.gpt2_decode import decode_step, init_cache

    cfg = _f32_gpt2_cfg()
    params = gpt2_init(cfg, _gen(), device="cpu")
    cache = init_cache(cfg, _PB, device="cpu")
    toks = torch.zeros((_PB,), dtype=torch.int32)
    return (_serve(lambda p, c, t: decode_step(p, c, t, cfg)),
            (params, cache, toks))


def _paged_nano_pool(cfg, mesh=None):
    """The serve engine's default nano paged pool (null block + one
    full chain per pooled row) with identity tables."""
    import torch

    from ray_tpu_torch.models.gpt2_decode import init_paged_cache

    per_row = cfg.max_seq // _BS
    cache = init_paged_cache(cfg, _PB, num_blocks=1 + _PB * per_row,
                             block_size=_BS, device="cpu", mesh=mesh)
    cache["block_tables"].copy_(1 + torch.arange(
        _PB * per_row, dtype=torch.int32).reshape(_PB, per_row))
    return cache, per_row


def _build_gpt2_paged_decode_step():
    import torch

    from ray_tpu_torch.models.gpt2 import gpt2_init
    from ray_tpu_torch.models.gpt2_decode import decode_step

    cfg = _f32_gpt2_cfg()
    params = gpt2_init(cfg, _gen(), device="cpu")
    cache, _ = _paged_nano_pool(cfg)
    toks = torch.zeros((_PB,), dtype=torch.int32)
    return (_serve(lambda p, c, t: decode_step(p, c, t, cfg)),
            (params, cache, toks))


def _build_gpt2_sharded_decode_step():
    """The paged decode step with params and pool partitioned over a
    tensor=2 mesh of the process group's ranks — the serve engine's
    tensor-parallel configuration.  Its collectives (the all-reduce of
    the row-parallel partial sums, the logits' all-gather) must be
    dispatched, and the whole pool must never be on a rank."""
    import torch

    from ray_tpu_torch.models.decode_common import tensor_parallel_params
    from ray_tpu_torch.models.gpt2 import gpt2_init, gpt2_logical_axes
    from ray_tpu_torch.models.gpt2_decode import decode_step
    from ray_tpu_torch.parallel import MeshSpec, make_mesh, mesh_context

    cfg = _f32_gpt2_cfg()
    mesh = make_mesh(MeshSpec(tensor=2))
    params = tensor_parallel_params(gpt2_init(cfg, _gen(), device="cpu"),
                                    gpt2_logical_axes(cfg), mesh)
    cache, _ = _paged_nano_pool(cfg, mesh)
    toks = torch.zeros((_PB,), dtype=torch.int32)

    def step(p, c, t):
        with mesh_context(mesh):
            return decode_step(p, c, t, cfg)

    return _serve(step), (params, cache, toks)


def _build_gpt2_spec_verify_step():
    """The spec-decode verify program: ONE call ingests a (B, k+1)
    draft block, scores every position, runs the accept fold and moves
    pos by the kept count.  Its logits are (B, k+1, V), never the
    full-sequence shape; the KV pool (arg 1) is updated in place."""
    import torch

    from ray_tpu_torch.models.decode_common import make_spec_verify
    from ray_tpu_torch.models.gpt2 import gpt2_init
    from ray_tpu_torch.models.gpt2_decode import verify_step

    cfg = _f32_gpt2_cfg()
    params = gpt2_init(cfg, _gen(), device="cpu")
    cache, _ = _paged_nano_pool(cfg)
    spec_verify = make_spec_verify(verify_step, cfg)
    block = torch.zeros((_PB, 5), dtype=torch.int32)   # [cur, d_1..d_4]
    return (_serve(lambda p, c, b, g: spec_verify(p, c, b, g)),
            (params, cache, block, _gen()))


def _build_gpt2_chunked_prefill_at(tt: int):
    """One chunk of streaming prefill: the engine's chunked admission
    runs the paged_prefill program once a chunk with ``prefix_len`` =
    the tokens already filled, so the audited shape is a chunk-sized
    tail (Tt=32) against a pool with one resident prefix block; the
    scalars are numpy int32, as the engine hands them over.  The
    chunk's cost must be O(chunk): its op count must not grow with
    Tt."""
    import torch

    from ray_tpu_torch.models.gpt2 import gpt2_init
    from ray_tpu_torch.models.gpt2_decode import paged_prefill

    cfg = _f32_gpt2_cfg()
    params = gpt2_init(cfg, _gen(), device="cpu")
    cache, per_row = _paged_nano_pool(cfg)
    row_bt = 1 + torch.arange(per_row, dtype=torch.int32)
    toks = torch.zeros((1, tt), dtype=torch.int32)
    return (_serve(lambda p, c, t, bt, pl, nt, s: paged_prefill(
        p, c, t, cfg, row_bt=bt, prefix_len=pl, n_tail=nt, slot=s)),
        (params, cache, toks, row_bt, np.int32(16), np.int32(tt),
         np.int32(0)))


def _build_gpt2_kv_handoff_export():
    """The prefill side of a handoff: the filled block rows copied out
    of the pool by advanced indexing (serve/llm.py kv_handoff_export),
    no forward, no whole-pool intermediate."""
    import torch

    cache, per_row = _paged_nano_pool(_f32_gpt2_cfg())
    ids = torch.zeros((per_row,), dtype=torch.int64)

    def export(c, blk_ids):
        return (c["k"][:, blk_ids].transpose(0, 1),
                c["v"][:, blk_ids].transpose(0, 1))

    return _serve(export), (cache, ids)


def _build_gpt2_kv_handoff_install():
    """The decode side: the rows land in this pool's blocks and the row
    is pointed at them (serve/llm.py kv_handoff_install), the pool (arg
    0) updated in place: two live pools per install is the regression
    this spec exists to catch."""
    import torch

    from ray_tpu_torch.models.decode_common import set_pool_row

    cache, per_row = _paged_nano_pool(_f32_gpt2_cfg())
    ids = torch.zeros((per_row,), dtype=torch.int64)
    row_shape = (per_row,) + tuple(cache["k"][:, 0].shape)
    k_stack = torch.zeros(row_shape, dtype=cache["k"].dtype)
    v_stack = torch.zeros(row_shape, dtype=cache["v"].dtype)
    row_bt = torch.zeros((per_row,), dtype=torch.int32)

    def install(c, blk_ids, ks, vs, slot, bt, pos):
        c["k"][:, blk_ids] = ks.transpose(0, 1)
        c["v"][:, blk_ids] = vs.transpose(0, 1)
        set_pool_row(c, int(slot), bt, int(pos))
        return c

    return _serve(install), (cache, ids, k_stack, v_stack, np.int32(0),
                             row_bt, np.int32(48))


def _ce_inputs():
    import torch

    g = _gen()
    h = torch.randn((_CE_N, _CE_D), generator=g)
    w = torch.randn((_CE_V, _CE_D), generator=g)
    t = torch.zeros((_CE_N,), dtype=torch.int32)
    return h, w, t


def _build_fused_ce_fwd():
    import torch

    from ray_tpu_torch.ops.fused_ce import fused_lm_ce

    h, w, t = _ce_inputs()
    return (_serve(lambda a, b, c: fused_lm_ce(
        a, b, c, _CE_VALID, block_n=16, block_v=128,
        compute_dtype=torch.bfloat16)), (h, w, t))


def _build_fused_ce_bwd():
    import torch

    from ray_tpu_torch.ops.fused_ce import fused_lm_ce

    h, w, t = _ce_inputs()

    def grads(a, b):
        a = a.detach().requires_grad_(True)
        b = b.detach().requires_grad_(True)
        loss = fused_lm_ce(a, b, t, _CE_VALID, block_n=16, block_v=128,
                           compute_dtype=torch.bfloat16).sum()
        return torch.autograd.grad(loss, (a, b))

    return grads, (h, w)


def default_programs() -> List[ProgramSpec]:
    """The registry ``python -m ray_tpu_torch.tools.graftcheck`` audits."""
    return [
        ProgramSpec(
            name="gpt2_train_step",
            build=_build_gpt2_train_step,
            forbid_logits=(_B * _T, _NANO_VOCAB),
            donate_argnums=(0,),
            hbm_budget_bytes=8 * _MiB),
        ProgramSpec(
            name="llama_train_step",
            build=_build_llama_train_step,
            forbid_logits=(_B * _T, _NANO_VOCAB),
            donate_argnums=(0,),
            hbm_budget_bytes=8 * _MiB),
        ProgramSpec(
            name="gpt2_prefill_ragged",
            build=lambda: _build_gpt2_prefill_at(_PT0),
            build_at=_build_gpt2_prefill_at,
            forbid_logits=(_PB * _PT0, _NANO_VOCAB),
            forbid_scan_lengths=(_PT0,),
            # prefill runs the full-precision f32 nano config on the
            # CPU; the dtype policy is audited on the train steps
            allow_f32_matmul=True,
            hbm_budget_bytes=6 * _MiB),
        ProgramSpec(
            name="llama_prefill_ragged",
            build=lambda: _build_llama_prefill_at(_PT0),
            build_at=_build_llama_prefill_at,
            forbid_logits=(_PB * _PT0, _NANO_VOCAB),
            forbid_scan_lengths=(_PT0,),
            hbm_budget_bytes=6 * _MiB),
        ProgramSpec(
            name="gpt2_decode_step",
            build=_build_gpt2_decode_step,
            forbid_logits=(_PB * 128, _NANO_VOCAB),  # B * max_seq rows
            allow_f32_matmul=True,
            hbm_budget_bytes=6 * _MiB),
        ProgramSpec(
            name="gpt2_paged_decode_step",
            build=_build_gpt2_paged_decode_step,
            forbid_logits=(_PB * 128, _NANO_VOCAB),
            allow_f32_matmul=True,
            # the block pool plus the per-layer gathered (B, max_seq)
            # views; a dense re-materialization of the whole pool per
            # layer would blow through it
            hbm_budget_bytes=6 * _MiB),
        ProgramSpec(
            name="gpt2_sharded_decode_step",
            build=_build_gpt2_sharded_decode_step,
            forbid_logits=(_PB * 128, _NANO_VOCAB),
            allow_f32_matmul=True,
            min_ranks=2,
            require_collectives=("all_gather", "all_reduce"),
            forbid_shapes=(_WHOLE_POOL,),
            hbm_budget_bytes=6 * _MiB,
            per_chip_hbm_budget_bytes=int(1.6 * _MiB)),
        ProgramSpec(
            name="gpt2_spec_verify_step",
            build=_build_gpt2_spec_verify_step,
            forbid_logits=(_PB * 128, _NANO_VOCAB),
            allow_f32_matmul=True,
            donate_argnums=(1,),
            rebinds={"pos": _POS_REBIND},
            hbm_budget_bytes=6 * _MiB),
        ProgramSpec(
            name="gpt2_chunked_prefill",
            build=lambda: _build_gpt2_chunked_prefill_at(_CHUNK_T),
            build_at=_build_gpt2_chunked_prefill_at,
            # full-sequence logits must never appear: the chunk emits
            # one row of logits
            forbid_logits=(128, _NANO_VOCAB),        # max_seq rows
            forbid_scan_lengths=(_CHUNK_T,),
            allow_f32_matmul=True,
            hbm_budget_bytes=6 * _MiB),
        ProgramSpec(
            name="gpt2_kv_handoff_export",
            build=_build_gpt2_kv_handoff_export,
            forbid_logits=(_PB * 128, _NANO_VOCAB),
            allow_f32_matmul=True,
            hbm_budget_bytes=6 * _MiB),
        ProgramSpec(
            name="gpt2_kv_handoff_install",
            build=_build_gpt2_kv_handoff_install,
            forbid_logits=(_PB * 128, _NANO_VOCAB),
            allow_f32_matmul=True,
            donate_argnums=(0,),
            hbm_budget_bytes=6 * _MiB),
        ProgramSpec(
            name="fused_ce_fwd",
            build=_build_fused_ce_fwd,
            forbid_logits=(_CE_N, _CE_V),
            hbm_budget_bytes=1 * _MiB),
        ProgramSpec(
            name="fused_ce_bwd",
            build=_build_fused_ce_bwd,
            forbid_logits=(_CE_N, _CE_V),
            hbm_budget_bytes=1 * _MiB),
    ]
