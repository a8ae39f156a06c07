"""The GPT-2 benchmark on one card: ``python -m ray_tpu_torch.bench``.

The counterpart of the repo's ``bench.py`` (``:1187 main``), with its
flags, defaults and metric lines (one JSON object a line, ``emit``):

* the default mode times GPT-2-124M training steps (``time_config``,
  ``bench.py:312``): B=24, T=1024, remat ``mlp_only``, through the
  flash kernels and, with ``--ce-impl pallas``, the fused-CE kernels;
* ``--train`` drives the instrumented step (``train_watch``,
  ``bench.py:1094 main_train_watch``);
* ``--decode`` times one batched prefill (TTFT) and greedy decode steps
  (``time_decode``, ``bench.py:466``), B=8, prompt 128, +64; with
  ``--spec-k`` the continuous engine with speculative decoding
  (``time_decode_spec``, ``bench.py:620``);
* ``--traffic`` drives the continuous engine, and ``--replicas N`` (or
  the prefill/decode pair) a fleet, under seeded traffic
  (``serve/traffic.py``);
* ``--profile DIR`` traces the timed region (``torch.profiler``).

The card runs by default; ``--device cpu`` (the counterpart of
``JAX_PLATFORMS=cpu``, or ``device="cpu"`` from Python) runs the
reference's CPU smoke configurations.  Without a card and without that
request it raises as ``resolve_device`` does: nothing falls back to the
CPU.  MFU is stated against one NVIDIA H100 SXM's dense bf16 peak, 989
TFLOP/s (NVIDIA's data sheet, at 700 W); a run off the card reports no
MFU.  The training modes run over the ranks of torch.distributed's
default process group when one is initialized (``--mesh`` data, fsdp
or data_fsdp: ``parallel.make_mesh``), else on one device; ``--chips``
above the group's world size raises ValueError.  ``--mesh tensor``
with ``--decode`` or ``--traffic`` shards the serve path over a
``tensor`` mesh of ``--chips`` ranks (the whole group;
``decode_mesh``), the decode tensor-parallel on each rank's blocks
(models/decode_common.py).  Each run's metric lines are appended to
the port's perf ledger (tools/perfledger.py; ``--no-ledger`` opts
out); ``--autopilot`` first emits one line attributing the programs the
run registered (``tools/autopilot``).
The JAX harness's TPU probes (``_probe_tpu``, ``_pin_cpu``, ``ensure_backend``)
and its TPU result record have no counterpart.

    from ray_tpu_torch.bench import time_config, train_watch
    tok_s, mfu, loss, n_chips, cost = time_config(24, seq=1024, n_steps=20)
    records = train_watch()   # train_goodput, train_data_wait_ms_p50/p99
"""

from __future__ import annotations

import argparse
import asyncio
import contextlib
import dataclasses
import json
import sys
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ray_tpu_torch._private.device_stats import (H100_SXM,
                                                cost_capture_enabled,
                                                get_registry, harvest_cost)
from ray_tpu_torch.device import DeviceLike, resolve_device
from ray_tpu_torch.models.gpt2 import (gpt2_config, gpt2_init, gpt2_loss,
                                       gpt2_param_count)
from ray_tpu_torch.train import goodput as gp
from ray_tpu_torch.train.optim import adamw
from ray_tpu_torch.train.telemetry import train_stats
from ray_tpu_torch.train.trainer import build_train_step

#: dense bf16 peak of one NVIDIA H100 SXM (data sheet, at 700 W), from
#: the one table of the card's peak rates
H100_BF16_PEAK_FLOPS = H100_SXM["bf16_flops"]

#: vs_baseline = MFU / this, as ``bench.py``'s BASELINE_MFU
BASELINE_MFU = 0.40

#: time_config's layouts (bench.py:335-349)
TRAIN_MESHES = ("data", "fsdp", "data_fsdp")


def _world_size() -> int:
    """Ranks of torch.distributed's default process group, 1 without
    one."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def time_config(batch: int, seq: int = 1024, n_steps: int = 20,
                preset: str = "gpt2", mesh: str = "data",
                n_devices: int = 0, device: DeviceLike = None,
                **overrides):
    """Time ``n_steps`` AdamW steps (``adamw(3e-4, weight_decay=0.1)``
    as ``bench.py:351``) of GPT-2 ``preset`` on a repeated batch of
    seeded random tokens, after one warm-up step.

    Returns (tok_s_per_chip, mfu, final_loss, n_chips, cost) as the
    JAX version does.  ``mfu`` = 6 * params * tokens/s / 989e12, None
    off the card.  ``cost`` holds ``model_flops`` (6 * params *
    tokens per step), ``peak_flops``, ``device``, ``steps_run``
    (warm-up included), ``step_ms`` (the mean of the timed steps),
    ``compile_seconds`` (the warm-up step's wall) and ``losses``
    (every step's loss, read after the timed loop so the loop has no
    host sync).

    The step is the raw one (``telemetry=False``), as the JAX version
    times a raw jit; it books ``bench.train_step`` into the program
    registry as ``bench.py:392`` and ``:425-426`` do: one compile event
    for the warm-up step, which runs under the cost harvest
    (``device_stats.harvest_cost``, the counterpart of the JAX side
    compile's ``cost_analysis``), then one invoke of dt / n_steps per
    timed step.  ``cost`` then also holds ``xla_flops`` (the harvest's
    FLOPs of one step times the ranks), ``xla_flops_per_chip``,
    ``peak_hbm_bytes`` and, on the card, ``mfu_xla`` (xla_flops per
    second over the ranks' peak), as ``bench.py:436-445``.

    With torch.distributed's default process group initialized, every
    rank calls it and the step runs over a mesh of all its ranks
    (``mesh``: ``data`` all data-parallel, ``fsdp`` all ZeRO-3, or
    ``data_fsdp`` fsdp=2 inside data, as ``bench.py:335-349``): the
    parameters placed by ``shard_params``, the batch (the global one,
    the same seeded tokens on every rank) split over the ranks, and
    tok_s is per rank.  ``device`` is then the mesh's.  Without a
    group it runs on one device whatever ``mesh`` says (a mesh of one
    device is the plain step).  ``n_devices`` above the world size
    raises ValueError, as does one below it (the mesh spans the whole
    group)."""
    import torch.distributed as dist

    if mesh not in TRAIN_MESHES:
        raise ValueError(f"mesh must be one of {TRAIN_MESHES} (got "
                         f"{mesh!r}); a tensor-parallel mesh is a decode "
                         f"layout (time_decode, decode_mesh)")
    grouped = dist.is_available() and dist.is_initialized()
    n_chips = dist.get_world_size() if grouped else 1
    if n_devices and n_devices != n_chips:
        raise ValueError(
            f"n_devices={n_devices} against a process group of "
            f"{n_chips} rank(s): the mesh spans the whole group; start "
            f"that many ranks (torch.distributed.init_process_group)")
    cfg = gpt2_config(preset, max_seq=seq, **overrides)
    tx = adamw(3e-4, weight_decay=0.1)
    loss_fn = lambda p, b: gpt2_loss(p, b, cfg)  # noqa: E731
    if grouped:
        from ray_tpu_torch.models.gpt2 import gpt2_logical_axes
        from ray_tpu_torch.parallel import MeshSpec, make_mesh, shard_params

        spec = {"data": MeshSpec(data=-1), "fsdp": MeshSpec(fsdp=-1),
                "data_fsdp": MeshSpec(
                    data=-1, fsdp=2 if n_chips % 2 == 0 else 1)}[mesh]
        dmesh = make_mesh(spec)
        dev = (torch.device("cuda", torch.cuda.current_device())
               if dmesh.device_type == "cuda" else torch.device("cpu"))
        gen = torch.Generator(device=dev).manual_seed(0)
        axes = gpt2_logical_axes(cfg)
        params = shard_params(gpt2_init(cfg, gen, device=dev), axes, dmesh)
        step = build_train_step(loss_fn, tx, mesh=dmesh, logical_axes=axes,
                                telemetry=False)
    else:
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(0)
        params = gpt2_init(cfg, gen, device=dev)
        step = build_train_step(loss_fn, tx, telemetry=False)
    opt_state = tx.init(params)
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq + 1),
                           generator=gen, device=dev)
    data = {"tokens": tokens}

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    reg = get_registry()
    t_c0 = time.perf_counter()
    harvest = None
    if cost_capture_enabled():
        (params, opt_state, loss), harvest = harvest_cost(
            step, params, opt_state, data)
    else:
        params, opt_state, loss = step(params, opt_state, data)
    losses = [loss]
    sync()
    compile_s = time.perf_counter() - t_c0
    reg.record_compile("bench.train_step", compile_s, cost=harvest)
    t0 = time.perf_counter()
    for _ in range(n_steps):
        params, opt_state, loss = step(params, opt_state, data)
        losses.append(loss)
    sync()
    dt = time.perf_counter() - t0
    for _ in range(n_steps):
        reg.record_invoke("bench.train_step", dt / max(1, n_steps))

    n_params = gpt2_param_count(cfg)
    tok_s = batch * seq * n_steps / dt / n_chips
    on_card = dev.type == "cuda"
    mfu: Optional[float] = (6 * n_params * tok_s / H100_BF16_PEAK_FLOPS
                            if on_card else None)
    cost = {"model_flops": float(6 * n_params * batch * seq),
            "peak_flops": H100_BF16_PEAK_FLOPS if on_card else None,
            "device": (torch.cuda.get_device_name(dev) if on_card
                       else str(dev)),
            "steps_run": n_steps + 1,
            "step_ms": dt / n_steps * 1e3,
            "compile_seconds": round(compile_s, 3),
            "losses": [float(x) for x in losses]}
    if harvest and harvest.get("xla_flops"):
        # the harvest counts this rank's work: per chip, as XLA's
        # per-partition count is
        cost["xla_flops_per_chip"] = harvest["xla_flops"]
        cost["xla_flops"] = harvest["xla_flops"] * n_chips
        cost["peak_hbm_bytes"] = harvest.get("peak_hbm_bytes")
        if on_card:
            cost["mfu_xla"] = (cost["xla_flops"] * n_steps / dt
                               / (n_chips * H100_BF16_PEAK_FLOPS))
    return tok_s, mfu, cost["losses"][-1], n_chips, cost


def train_watch(preset: str = "gpt2", batch: int = 8, seq: int = 1024,
                n_steps: int = 20, device: DeviceLike = None,
                **overrides) -> List[Dict[str, Any]]:
    """The trainwatch goodput bench (``bench.py:1094
    main_train_watch``, at its TPU configuration by default): the
    instrumented step ``build_train_step(health=True,
    telemetry_name="bench_train")`` fed by a data-wait-probed iterator
    of seeded numpy int32 batches, ``n_steps + 1`` calls (the first
    pays the signature's one-time costs).  Returns the three records
    the JAX bench emits: ``train_goodput`` (productive device time over
    loop wall) and ``train_data_wait_ms_p50``/``_p99``, with their
    ``detail`` keys.  Health mode fences every step, so the device leg
    is device time.  ``overrides`` go to ``gpt2_config``."""
    dev = resolve_device(device)
    cfg = gpt2_config(preset, max_seq=seq, **overrides)
    trainer = "bench_train"
    params = gpt2_init(cfg, torch.Generator(device=dev).manual_seed(0),
                       device=dev)
    tx = adamw(3e-4, weight_decay=0.1)
    opt_state = tx.init(params)
    step = build_train_step(lambda p, b: gpt2_loss(p, b, cfg), tx,
                            health=True, telemetry_name=trainer)
    rng = np.random.RandomState(0)

    def batches():
        while True:
            yield {"tokens": rng.randint(
                0, cfg.vocab_size, size=(batch, seq + 1)).astype(np.int32)}

    it = gp.watch_data(batches(), trainer=trainer)
    tracker = gp.get_goodput_tracker(trainer)
    loss = None
    for _ in range(n_steps + 1):
        data = next(it)
        # the batch's copy to the device, timed into the next step's
        # h2d leg: in JAX it hides inside the jitted call
        t0 = time.perf_counter()
        data = {"tokens": torch.from_numpy(data["tokens"]).to(dev)}
        tracker.note_h2d(time.perf_counter() - t0)
        params, opt_state, loss, _health = step(params, opt_state, data)
    stats = train_stats(trainer)
    anatomy = stats["anatomy"]
    detail = {
        "chips": 1, "batch": batch, "seq": seq,
        "preset": preset, "steps": stats["goodput"]["steps"],
        "goodput": stats["goodput"],
        "anatomy_mean_ms": {k: (anatomy[k] or {}).get("mean")
                            for k in anatomy},
        "anomalies": stats["health"]["anomalies"],
        "loss": round(float(loss), 3) if loss is not None else None,
        "backend": dev.type,
        "tpu_error": None,   # the JAX key; the port probes no TPU
    }
    records = [{"metric": "train_goodput",
                "value": stats["goodput"]["ratio"], "unit": "ratio",
                "vs_baseline": None, "detail": detail}]
    dw = anatomy["data_wait_ms"]
    for q in ("p50", "p99"):
        records.append({"metric": f"train_data_wait_ms_{q}",
                        "value": dw[q], "unit": "ms", "vs_baseline": None,
                        "detail": {"count": dw["count"], "preset": preset,
                                   "backend": dev.type}})
    return records


# ---- the command line (bench.py:28 parse_args, :1187 main) ---------------

def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m ray_tpu_torch.bench",
        description="GPT-2-124M training and serving throughput on one "
                    "NVIDIA H100: one JSON line a metric.")
    ap.add_argument("--chips", type=int, default=0,
                    help="ranks to run on: the process group's world "
                         "size (more raises)")
    ap.add_argument("--mesh", default="data",
                    choices=["data", "fsdp", "data_fsdp", "tensor"],
                    help="parallelism layout over the process group's "
                         "ranks: data, fsdp, data_fsdp (train), or "
                         "tensor (serve: --decode/--traffic shard the "
                         "engine over tensor = --chips ranks)")
    ap.add_argument("--preset", default="",
                    help="model preset override; default gpt2 on the "
                         "card, tiny on the CPU")
    ap.add_argument("--batch", type=int, default=0,
                    help="global batch override (default 24 on the card)")
    ap.add_argument("--steps", type=int, default=0,
                    help="timed steps override")
    ap.add_argument("--remat", default="",
                    choices=["", "full", "mlp_only", "dots_nb"],
                    help="remat policy override; default mlp_only at "
                         "the default batch, full remat otherwise")
    ap.add_argument("--ce-impl", default="",
                    choices=["", "dense", "streaming_xla", "pallas"],
                    help="cross-entropy implementation: dense logits, "
                         "vocab tiles, or the fused lm-head+CE kernels "
                         "(default: config default)")
    ap.add_argument("--flash-resident", default="",
                    choices=["", "auto", "on", "off"],
                    help="resident-kv flash attention selection for this "
                         "run (RAYTPU_FLASH_RESIDENT still overrides; "
                         "default: config default)")
    ap.add_argument("--decode", action="store_true",
                    help="benchmark the serve path instead of training: "
                         "one batched prefill (TTFT) + greedy decode "
                         "steps (tokens/s); emits "
                         "gpt2_decode_prefill_ttft_ms and "
                         "gpt2_decode_tokens_per_sec JSON lines")
    ap.add_argument("--prompt-len", type=int, default=0,
                    help="--decode prompt length (default 128 on the card)")
    ap.add_argument("--new-tokens", type=int, default=0,
                    help="--decode generated tokens (default 64 on the "
                         "card)")
    ap.add_argument("--spec-k", type=int, default=0,
                    help="--decode with speculative decoding: draft k "
                         "tokens per round, one batched verify forward "
                         "(0 = off); emits gpt2_decode_spec_tokens_per_sec "
                         "and spec accept-rate JSON lines")
    ap.add_argument("--spec-draft", default="aligned",
                    help="--spec-k draft: 'aligned' (a draft with the "
                         "target's family/preset/seed), 'ngram', or "
                         "'<family>:<preset>'")
    ap.add_argument("--train", action="store_true",
                    help="benchmark through the trainwatch loop "
                         "(train/goodput.py): build_train_step(health=True) "
                         "fed by a data-wait-probed batch iterator; emits "
                         "train_goodput and train_data_wait_ms_p50/p99")
    ap.add_argument("--traffic", action="store_true",
                    help="benchmark the continuous serve engine under "
                         "synthetic shared-prefix Poisson traffic "
                         "(serve/traffic.py); emits prefix-hit-rate and "
                         "SLO-attainment JSON lines")
    ap.add_argument("--requests", type=int, default=0,
                    help="--traffic request count (default 64 on the card)")
    ap.add_argument("--replicas", type=int, default=1,
                    help="--traffic fleet size: N>1 drives a two-tenant "
                         "mixture through N continuous-engine replicas "
                         "behind the prefix-affinity router "
                         "(serve/router.py build_llm_fleet)")
    ap.add_argument("--kv-layout", default="paged",
                    choices=["dense", "paged"],
                    help="--traffic KV-cache layout (paged enables "
                         "prefix reuse; dense is the parity oracle)")
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="--traffic chunked prefill A/B: the two-tenant "
                         "long-prompt mixture with long prompts admitted "
                         "as N-token chunks (0 = the same mixture, "
                         "one-shot prefill)")
    ap.add_argument("--prefill-replicas", type=int, default=None,
                    help="--traffic disaggregated serving: this many "
                         "role='prefill' replicas beside "
                         "--decode-replicas role='decode' ones, with "
                         "block-granular KV handoff")
    ap.add_argument("--decode-replicas", type=int, default=None,
                    help="--traffic disaggregated serving: decode-role "
                         "replica count (see --prefill-replicas)")
    ap.add_argument("--handoff-staged", action="store_true",
                    help="--traffic disaggregated serving: hand KV over "
                         "through host memory instead of the same-device "
                         "fast path")
    ap.add_argument("--chaos-freeze-replica", type=int, default=None,
                    help="--traffic --replicas N chaos A/B: freeze this "
                         "replica's engine loop mid-traffic "
                         "(serve/chaos.py); emits time_to_detect_ms and "
                         "requests_requeued_on_death lines")
    ap.add_argument("--kv-host-tier-bytes", type=int, default=None,
                    help="--traffic host-RAM KV tier of this byte budget "
                         "(serve/kv_tier.py; paged layout only); emits "
                         "kv_tier_hit_rate lines")
    ap.add_argument("--profile", default="",
                    help="trace the timed region into this directory "
                         "(util/state.py profile_device, torch.profiler)")
    ap.add_argument("--no-ledger", action="store_true",
                    help="do not append this run's metric lines to the "
                         "perf ledger (tools/perfledger.py)")
    ap.add_argument("--autopilot", action="store_true",
                    help="emit one extra JSON line attributing the "
                         "programs this run registered (compute- vs "
                         "HBM-bound against the card's ridge, ranked by "
                         "headroom-weighted time share; tools/autopilot)")
    ap.add_argument("--device", default=None,
                    help="where to run: the card by default; 'cpu' runs "
                         "the CPU smoke configurations (the counterpart "
                         "of JAX_PLATFORMS=cpu)")
    return ap.parse_args(argv)


#: metric records emitted by this run
_EMITTED: List[Dict[str, Any]] = []


def emit(record) -> None:
    print(json.dumps(record), flush=True)
    _EMITTED.append(record)


def _maybe_autopilot(args) -> None:
    """``--autopilot``: one extra JSON line, ``{"autopilot":
    attribute_registry()}``, attributing the programs this run
    registered; emitted through emit() so it rides into the ledger with
    the metric lines (``bench.py:179-192``).  Best-effort."""
    if not getattr(args, "autopilot", False):
        return
    try:
        from ray_tpu_torch.tools.autopilot import attribute_registry

        emit({"autopilot": attribute_registry()})
    except Exception as e:  # noqa: BLE001 - attribution is best-effort
        sys.stderr.write(f"bench: autopilot attribution failed: "
                         f"{e!r}\n")


def _ledger_append(args) -> None:
    """Persist this run's JSON lines into the port's perf ledger
    (tools/perfledger.py ``history_path``: BENCH_HISTORY_TORCH.jsonl,
    or RAYTPU_BENCH_HISTORY) so the bench trajectory survives the
    terminal, as ``bench.py:195 _ledger_append`` does for the JAX
    package.  Best-effort: a ledger failure never breaks the bench
    contract of always printing its lines."""
    _maybe_autopilot(args)
    if args.no_ledger or not _EMITTED:
        return
    try:
        from ray_tpu_torch.tools import perfledger

        n = perfledger.append_records(_EMITTED, source="bench")
        sys.stderr.write(f"bench: {n} record(s) appended to "
                         f"{perfledger.history_path()}\n")
    except Exception as e:  # noqa: BLE001 - ledger is best-effort
        sys.stderr.write(f"bench: perf ledger append failed: {e!r}\n")


def _maybe_profile(logdir: str):
    """`--profile <dir>` context: a device trace of the timed region
    (no-op without the flag)."""
    if not logdir:
        return contextlib.nullcontext()
    from ray_tpu_torch.util.state import profile_device

    return profile_device(logdir)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def decode_mesh(tensor_degree: int):
    """(mesh, n_chips) of a tensor-parallel serve bench
    (``bench.py:447``): (None, 1) at degree 1, the single-device path
    unchanged; else a tensor=degree mesh over torch.distributed's
    default process group, whose ranks it must span (ValueError
    otherwise)."""
    if tensor_degree <= 1:
        return None, 1
    from ray_tpu_torch.parallel import MeshSpec, make_mesh

    if _world_size() != tensor_degree:
        raise ValueError(f"tensor degree {tensor_degree} needs a process "
                         f"group of {tensor_degree} ranks, have "
                         f"{_world_size()}")
    return make_mesh(MeshSpec(tensor=tensor_degree)), tensor_degree


def time_decode(batch, prompt_len=128, new_tokens=64, preset="gpt2",
                mesh=None, device: DeviceLike = None, params=None,
                **overrides):
    """Time the GPT-2 serve path (``bench.py:466``): ONE batched prefill
    of a (batch, prompt_len) prompt (TTFT, 3 repetitions after a warm-up)
    followed by ``new_tokens`` greedy decode steps against the KV cache
    (decode tokens/s), measured through the serve engine telemetry
    (serve/telemetry.py), whose p50/p95/p99 TTFT and inter-token
    percentiles come from the code path ``engine_stats()`` serves.

    Returns (ttft_best_ms, tok_s, engine_stats, n_chips, tokens), the
    reference's four and the greedy tokens: the prefill's and each
    decode step's, a (1 + new_tokens, batch) CPU tensor read after the
    timing.  ``params`` replaces the seeded weights.  The prompt is
    drawn from a CPU generator seeded 1.  ``mesh`` (every rank calls
    it) tensor-parallelises the whole path, as the reference's: the
    parameters are this rank's blocks under DECODE_RULES
    (``decode_common.tensor_parallel_params``) and the prefill's cache
    is born partitioned; n_chips is the mesh's size.  ``device`` is
    then this rank's (its card, or the CPU for a gloo mesh)."""
    from ray_tpu_torch.models.decode_common import (make_vocab_tail_mask,
                                                    sample_token,
                                                    tensor_parallel_params)
    from ray_tpu_torch.models.gpt2 import gpt2_logical_axes
    from ray_tpu_torch.models.gpt2_decode import decode_step, prefill
    from ray_tpu_torch.parallel.mesh import mesh_context
    from ray_tpu_torch.serve.telemetry import EngineTelemetry

    dev = resolve_device(device)
    cfg = gpt2_config(preset, **overrides)
    if prompt_len + new_tokens > cfg.max_seq:
        raise ValueError(f"prompt_len {prompt_len} + new_tokens "
                         f"{new_tokens} exceeds max_seq={cfg.max_seq}")
    if params is None:
        params = gpt2_init(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    n_chips = 1
    if mesh is not None:
        params = tensor_parallel_params(params, gpt2_logical_axes(cfg),
                                        mesh)
        n_chips = mesh.size()
    toks = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                         generator=torch.Generator().manual_seed(1)).to(dev)
    tail = make_vocab_tail_mask(cfg, dev)
    telemetry = EngineTelemetry("bench_decode", max_slots=batch)

    def run_prefill(t):
        logits, cache = prefill(params, t, cfg)
        return sample_token(logits, None, 0.0, tail), cache

    def run_step(cache, t):
        logits, cache = decode_step(params, cache, t, cfg)
        return sample_token(logits, None, 0.0, tail), cache

    with torch.inference_mode(), (mesh_context(mesh) if mesh is not None
                                  else contextlib.nullcontext()):
        # warm-up: both programs' first calls
        tok, cache = run_prefill(toks)
        run_step(cache, tok)
        _sync(dev)

        ttfts = []
        for rep in range(3):
            rec = telemetry.record_enqueue(prompt_len)
            t0 = time.perf_counter()
            telemetry.record_admit(rec, slot=0, bucket=prompt_len, now=t0)
            tok, cache = run_prefill(toks)
            _sync(dev)
            telemetry.record_first_token(rec)
            ttfts.append(time.perf_counter() - t0)
            if rep < 2:  # only the last rep's request runs the decode loop
                telemetry.record_finish(rec, n_tokens=1)
        ttft_ms = min(ttfts) * 1000.0
        steps = [tok]

        t0 = time.perf_counter()
        prev = t0
        for _ in range(new_tokens):
            tok, cache = run_step(cache, tok)
            steps.append(tok)
            now = time.perf_counter()
            telemetry.record_step(batch, now - prev, now=now)
            prev = now
        _sync(dev)
        dt = time.perf_counter() - t0
    tok_s = batch * new_tokens / dt
    telemetry.record_finish(rec, n_tokens=new_tokens)
    return ttft_ms, tok_s, telemetry.engine_stats(), n_chips, \
        torch.stack(steps).cpu()


def main_decode(args, dev: torch.device) -> None:
    """--decode (``bench.py:555``): inference metrics in the train
    metric's shape, one JSON line a metric, each carrying the others in
    detail.  vs_baseline is null: no published decode baseline."""
    if dev.type == "cuda":
        batch = args.batch or 8
        preset = args.preset or "gpt2"
        prompt_len = args.prompt_len or 128
        new_tokens = args.new_tokens or 64
        base = "gpt2_decode"
    else:  # CPU smoke so the decode bench always emits its lines
        batch = args.batch or 4
        preset = args.preset or "tiny"
        prompt_len = args.prompt_len or 16
        new_tokens = args.new_tokens or 8
        base = "gpt2_decode_cpu_smoke"
    cfg_kw = {}
    if args.flash_resident:
        cfg_kw["flash_resident"] = args.flash_resident
    mesh, n_chips = (decode_mesh(args.chips or 1)
                     if args.mesh == "tensor" else (None, 1))
    if mesh is not None:
        base += "_sharded"
    with _maybe_profile(args.profile):
        ttft_best_ms, tok_s, stats, n_chips, _ = time_decode(
            batch, prompt_len=prompt_len, new_tokens=new_tokens,
            preset=preset, mesh=mesh, device=dev, **cfg_kw)
    # the headline TTFT is engine_stats()' p50; the best of 3 stays in
    # detail as ttft_best_ms
    ttft_ms = stats["ttft_ms"]["p50"]
    if ttft_ms is None:
        ttft_ms = ttft_best_ms
    engine = {"ttft_ms": stats["ttft_ms"],
              "inter_token_ms": stats["inter_token_ms"],
              "tokens_per_sec": stats["tokens_per_sec"]}
    detail = {"chips": n_chips, "batch": batch,
              "prompt_len": prompt_len,
              "new_tokens": new_tokens, "preset": preset,
              "mesh": ({"tensor": n_chips} if mesh is not None else {}),
              "flash_resident": args.flash_resident or "auto",
              "backend": dev.type, "tpu_error": None,
              "ttft_best_ms": round(ttft_best_ms, 2), "engine": engine}
    emit({
        "metric": f"{base}_prefill_ttft_ms",
        "value": round(ttft_ms, 2), "unit": "ms", "vs_baseline": None,
        "detail": dict(detail, tokens_per_sec=round(tok_s, 1))})
    emit({
        "metric": f"{base}_tokens_per_sec",
        "value": round(tok_s, 1), "unit": "tokens/s",
        "vs_baseline": None,
        "detail": dict(detail, prefill_ttft_ms=round(ttft_ms, 2))})
    emit({
        "metric": f"{base}_tokens_per_sec_per_chip",
        "value": round(tok_s / max(1, n_chips), 1),
        "unit": "tokens/s/chip", "vs_baseline": None,
        "detail": dict(detail, tokens_per_sec=round(tok_s, 1),
                       prefill_ttft_ms=round(ttft_ms, 2))})


def time_decode_spec(batch, prompt_len=128, new_tokens=64,
                     preset="gpt2", spec_k=4, spec_draft="aligned",
                     kv_layout="dense", mesh=None, seed=0,
                     config_overrides=None, device: DeviceLike = None):
    """Time the continuous engine with speculative decoding
    (``bench.py:620``): ``batch`` concurrent greedy requests through
    ``build_llm_deployment(spec_decode=...)``.  'aligned' is a draft
    with the target's own family/preset/seed (acceptance ~1.0).

    Returns (tok_s, stats, dispatches_per_token, n_chips): one target
    prefill per request plus one verify per slot-round, over all
    emitted tokens.  Under a ``mesh`` of several ranks every rank calls
    it: the first drives the requests, the others follow its engine
    and return None."""
    import numpy as np

    from ray_tpu_torch.serve.llm import SpecConfig, build_llm_deployment

    draft = (f"gpt2:{preset}" if spec_draft == "aligned"
             else spec_draft)
    dep = build_llm_deployment(
        "gpt2", preset, scheduler="continuous",
        max_new_tokens=new_tokens, max_slots=batch,
        prefill_bucket=max(16, prompt_len), kv_layout=kv_layout,
        mesh=mesh, seed=seed,
        spec_decode=SpecConfig(draft=draft, k=spec_k),
        config_overrides=config_overrides, device=device)
    inst = dep.func_or_class()
    if not inst.is_leader:
        inst.follow()
        return None
    rng = np.random.default_rng(1)
    vocab = int(inst.cfg.vocab_size)
    prompts = [rng.integers(0, vocab, size=prompt_len).astype(np.int32)
               for _ in range(batch)]

    async def go():
        try:
            return await asyncio.gather(*[inst(p) for p in prompts])
        finally:
            inst.shutdown_engine()

    t0 = time.perf_counter()
    outs = asyncio.run(go())
    dt = time.perf_counter() - t0
    stats = inst.engine_stats()
    n_tokens = sum(len(o) - prompt_len for o in outs)
    dispatches = batch + stats["spec"]["rounds"]
    n_chips = mesh.size() if mesh is not None else 1
    return n_tokens / dt, stats, dispatches / max(1, n_tokens), n_chips


def main_decode_spec(args, dev: torch.device) -> None:
    """--decode --spec-k K (``bench.py:682``): speculative decoding on
    the continuous engine; headlines tokens/s and the acceptance rate,
    target dispatches per token in detail."""
    if dev.type == "cuda":
        batch = args.batch or 8
        preset = args.preset or "gpt2"
        prompt_len = args.prompt_len or 128
        new_tokens = args.new_tokens or 64
        base = "gpt2_decode"
        overrides = None
    else:  # CPU smoke so the spec bench always emits its lines
        batch = args.batch or 4
        preset = args.preset or "nano"
        prompt_len = args.prompt_len or 16
        new_tokens = args.new_tokens or 12
        base = "gpt2_decode_cpu_smoke"
        overrides = {"dtype": torch.float32, "use_flash": False,
                     "remat": False}
    mesh, n_chips = (decode_mesh(args.chips or 1)
                     if args.mesh == "tensor" else (None, 1))
    spec_base = base.replace("_decode", "_decode_spec")
    if mesh is not None:
        spec_base += "_sharded"
    with _maybe_profile(args.profile):
        res = time_decode_spec(
            batch, prompt_len=prompt_len, new_tokens=new_tokens,
            preset=preset, spec_k=args.spec_k,
            spec_draft=args.spec_draft, kv_layout=args.kv_layout,
            mesh=mesh, config_overrides=overrides, device=dev)
    if res is None:     # a follower rank: its leader reports
        return
    tok_s, stats, dpt, n_chips = res
    spec = stats["spec"]
    detail = {"chips": n_chips, "batch": batch,
              "prompt_len": prompt_len, "new_tokens": new_tokens,
              "preset": preset, "spec_k": args.spec_k,
              "spec_draft": args.spec_draft,
              "kv_layout": args.kv_layout,
              "mesh": ({"tensor": n_chips} if mesh is not None else {}),
              "backend": dev.type, "tpu_error": None,
              "target_dispatches_per_token": round(dpt, 4),
              "spec": spec}
    emit({
        "metric": f"{spec_base}_tokens_per_sec",
        "value": round(tok_s, 1), "unit": "tokens/s",
        "vs_baseline": None,
        "detail": dict(detail, accept_rate=spec["accept_rate"])})
    emit({
        "metric": f"{spec_base}_accept_rate",
        "value": spec["accept_rate"], "unit": "ratio",
        "vs_baseline": None,
        "detail": dict(detail, tokens_per_sec=round(tok_s, 1))})


def main_traffic(args, dev: torch.device) -> None:
    """--traffic (``bench.py:744``): the continuous engine under seeded
    shared-prefix Poisson load (``serve/traffic.py run_traffic``).
    Headlines: the paged KV cache's prefix-hit rate and the fraction of
    requests inside the latency SLO; per-objective engine-side SLO
    attainment, spec accept rates, per-tenant TTFT p99, the tracebus
    anatomy and kvscope lines follow.  ``--replicas N`` (N>1) and the
    prefill/decode pair switch to :func:`main_traffic_fleet`."""
    if args.replicas > 1 or args.prefill_replicas \
            or args.decode_replicas:
        return main_traffic_fleet(args, dev)
    from ray_tpu_torch.serve.batching import AdmissionPolicy
    from ray_tpu_torch.serve.llm import SpecConfig
    from ray_tpu_torch.serve.slo import SLOConfig
    from ray_tpu_torch.serve.traffic import (TenantSpec, TrafficSpec,
                                             run_traffic)

    on_card = dev.type == "cuda"
    if on_card:
        base, preset = "gpt2_traffic", "gpt2"
        n = args.requests or 64
        spec = TrafficSpec(num_requests=n, seed=0, rate_rps=32.0,
                           num_prefix_groups=4, prefix_len=256,
                           p_shared=0.75, tail_len_mean=32.0,
                           tail_len_max=128, vocab=50000)
        kw = dict(max_slots=8, max_new_tokens=64, prefill_bucket=128,
                  latency_slo_ms=20000.0, time_scale=1.0)
    else:  # CPU smoke so the traffic bench always emits its lines
        base, preset = "gpt2_traffic_cpu_smoke", "nano"
        n = args.requests or 16
        spec = TrafficSpec(num_requests=n, seed=0, rate_rps=100.0,
                           num_prefix_groups=2, prefix_len=32,
                           p_shared=0.75, tail_len_mean=6.0,
                           tail_len_max=16, vocab=500)
        kw = dict(max_slots=4, max_new_tokens=8, prefill_bucket=16,
                  latency_slo_ms=60000.0, time_scale=0.0,
                  config_overrides={"dtype": torch.float32,
                                    "use_flash": False})
    if args.prefill_chunk is not None:
        # an interactive tenant with the spec's short tails plus a batch
        # tenant flooding with long prompts; --prefill-chunk 0 runs the
        # same mixture one-shot, so the two runs A/B on one traffic
        base += "_long"
        spec = dataclasses.replace(spec, tenants=(
            TenantSpec("interactive", rate_share=3.0,
                       slo_class="interactive"),
            TenantSpec("batch", rate_share=1.0, slo_class="batch",
                       prompt_len=640 if on_card else 80),
        ))
        kw["prefill_chunk_tokens"] = args.prefill_chunk or None
    if args.kv_host_tier_bytes:
        base += "_tier"
        kw["kv_host_tier_bytes"] = args.kv_host_tier_bytes
    mesh, n_chips = (decode_mesh(args.chips or 1)
                     if args.mesh == "tensor" else (None, 1))
    if mesh is not None:
        base += "_sharded"
    # engine-side SLO targets from the client latency bound: TTFT gets
    # half the e2e budget
    slo_cfg = SLOConfig(ttft_ms=kw["latency_slo_ms"] / 2,
                        e2e_ms=kw["latency_slo_ms"])
    spec_cfg = None
    if args.spec_k > 0:
        base += "_spec"
        draft = (f"gpt2:{preset}" if args.spec_draft == "aligned"
                 else args.spec_draft)
        spec_cfg = SpecConfig(draft=draft, k=args.spec_k)
    with _maybe_profile(args.profile):
        rep = run_traffic(
            spec, family="gpt2", preset=preset,
            kv_layout=args.kv_layout,
            admission_policy=AdmissionPolicy(max_queue_depth=4 * n),
            slo=slo_cfg, spec_decode=spec_cfg, mesh=mesh, device=dev,
            **kw)
    if rep is None:     # a follower rank: its leader reports
        return
    eng = rep["engine"]
    mesh_axes = eng.get("mesh", {}).get("axes", {})
    tok_s = eng["tokens_per_sec"]
    detail = {"chips": n_chips, "requests": rep["offered"],
              "completed": rep["completed"], "shed": rep["shed"],
              "kv_layout": args.kv_layout, "preset": preset,
              "mesh_axes": mesh_axes,
              "backend": dev.type, "tpu_error": None,
              "latency_ms": rep["latency_ms"],
              "tokens_per_sec": tok_s,
              "tokens_per_sec_per_chip":
                  (round(tok_s / max(1, n_chips), 1)
                   if isinstance(tok_s, (int, float)) else tok_s),
              "ttft_ms": eng["ttft_ms"],
              "kv_cache": eng.get("kv_cache"),
              "rejections_by_reason": eng["rejections_by_reason"]}
    if args.prefill_chunk is not None:
        detail["prefill_chunk_tokens"] = args.prefill_chunk or None
        detail["prefill_chunks"] = rep.get("prefill_chunks")
    if args.kv_host_tier_bytes:
        detail["kv_host_tier_bytes"] = args.kv_host_tier_bytes
        detail["kv_tier"] = eng.get("kv_tier")
    if spec_cfg is not None:
        eng_spec = eng.get("spec") or {}
        detail["spec"] = {"k": args.spec_k,
                          "draft": spec_cfg.draft,
                          "accept_rate": eng_spec.get("accept_rate"),
                          "rounds": eng_spec.get("rounds"),
                          "proposed": eng_spec.get("proposed"),
                          "accepted": eng_spec.get("accepted")}
    emit({
        "metric": f"{base}_prefix_hit_rate",
        "value": rep["prefix_hit_rate"], "unit": "fraction",
        "vs_baseline": None,
        "detail": dict(detail, slo_attainment=rep["slo_attainment"])})
    emit({
        "metric": f"{base}_slo_attainment",
        "value": rep["slo_attainment"], "unit": "fraction",
        "vs_baseline": None,
        "detail": dict(detail, latency_slo_ms=rep["latency_slo_ms"],
                       prefix_hit_rate=rep["prefix_hit_rate"])})
    for name, obj in (rep.get("slo") or {}).items():
        if not isinstance(obj.get("attainment"), (int, float)):
            continue
        emit({
            "metric": f"{base}_{name}_slo_attainment",
            "value": obj["attainment"], "unit": "fraction",
            "vs_baseline": None,
            "detail": dict(detail, target_ms=obj["target_ms"],
                           burn_rate=obj["burn_rate"])})
    if spec_cfg is not None and isinstance(
            rep.get("spec_accept_rate"), (int, float)):
        emit({
            "metric": f"{base}_accept_rate",
            "value": rep["spec_accept_rate"], "unit": "ratio",
            "vs_baseline": None,
            "detail": dict(detail, rounds=rep.get("spec_rounds"))})
    for tname in ("interactive", "batch"):
        v = rep.get(f"{tname}_ttft_ms_p99")
        if isinstance(v, (int, float)):
            emit({
                "metric": f"{base}_{tname}_ttft_ms_p99",
                "value": v, "unit": "ms", "vs_baseline": None,
                "detail": detail})
    _emit_anatomy(base, rep, detail)
    _emit_kvscope(base, rep, detail)


def _emit_kvscope(base: str, rep: dict, detail: dict) -> None:
    """kvscope headlines shared by --traffic and --replicas N: p95 KV
    pool occupancy, re-prefill waste, and the host tier's hit rate
    (0.0 without a tier)."""
    for field, unit in (("kv_occupancy_p95", "fraction"),
                        ("reprefill_waste_frac", "fraction"),
                        ("kv_tier_hit_rate", "fraction")):
        v = rep.get(field)
        if isinstance(v, (int, float)):
            emit({
                "metric": f"{base}_{field}",
                "value": v, "unit": unit, "vs_baseline": None,
                "detail": detail})


def _emit_anatomy(base: str, rep: dict, detail: dict) -> None:
    """Tracebus anatomy lines shared by --traffic and --replicas N:
    inter-token latency p50/p99 and the p99 TTFT critical path."""
    for q in ("p50", "p99"):
        v = rep.get(f"itl_ms_{q}")
        if isinstance(v, (int, float)):
            emit({
                "metric": f"{base}_itl_ms_{q}",
                "value": v, "unit": "ms", "vs_baseline": None,
                "detail": dict(detail,
                               tpot_ms=(rep.get("latency_anatomy")
                                        or {}).get("tpot_ms"))})
    cp = rep.get("ttft_critical_path") or {}
    if isinstance(cp.get("total_p99_ms"), (int, float)):
        emit({
            "metric": f"{base}_ttft_critical_path",
            "value": cp["total_p99_ms"], "unit": "ms",
            "vs_baseline": None,
            "detail": dict(detail, critical_path=cp)})


def main_traffic_fleet(args, dev: torch.device) -> None:
    """--traffic --replicas N (``bench.py:954``): a two-tenant mixture
    through N continuous-engine replicas behind the prefix-affinity
    router with WFQ tenant classes (``run_traffic_fleet``).  Headlines:
    the fleet's pooled prefix-hit rate and per-tenant SLO attainment."""
    from ray_tpu_torch.serve.slo import SLOConfig
    from ray_tpu_torch.serve.traffic import (TenantSpec, TrafficSpec,
                                             run_traffic_fleet)

    if dev.type == "cuda":
        base, preset = "gpt2_traffic_fleet", "gpt2"
        n = args.requests or 64
        slo_ms = 20000.0
        tenants = (
            TenantSpec("interactive", rate_share=1.0,
                       slo_class="interactive", prefix_groups=(0, 1),
                       ttft_slo_ms=slo_ms / 2, e2e_slo_ms=slo_ms),
            TenantSpec("batch", rate_share=1.0, slo_class="batch",
                       prefix_groups=(2, 3), e2e_slo_ms=2 * slo_ms))
        spec = TrafficSpec(num_requests=n, seed=0, rate_rps=32.0,
                           num_prefix_groups=4, prefix_len=256,
                           p_shared=0.75, tail_len_mean=32.0,
                           tail_len_max=128, vocab=50000,
                           tenants=tenants)
        kw = dict(max_slots=8, max_new_tokens=64, prefill_bucket=128,
                  time_scale=1.0)
    else:  # CPU smoke so the fleet bench always emits its lines
        base, preset = "gpt2_traffic_fleet_cpu_smoke", "nano"
        n = args.requests or 16
        slo_ms = 60000.0
        tenants = (
            TenantSpec("interactive", rate_share=1.0,
                       slo_class="interactive", prefix_groups=(0,),
                       ttft_slo_ms=slo_ms / 2, e2e_slo_ms=slo_ms),
            TenantSpec("batch", rate_share=1.0, slo_class="batch",
                       prefix_groups=(1,), e2e_slo_ms=2 * slo_ms))
        spec = TrafficSpec(num_requests=n, seed=0, rate_rps=100.0,
                           num_prefix_groups=2, prefix_len=32,
                           p_shared=0.75, tail_len_mean=6.0,
                           tail_len_max=16, vocab=500,
                           tenants=tenants)
        kw = dict(max_slots=4, max_new_tokens=8, prefill_bucket=16,
                  time_scale=0.0,
                  config_overrides={"dtype": torch.float32,
                                    "use_flash": False})
    if args.kv_host_tier_bytes:
        base += "_tier"
        kw["kv_host_tier_bytes"] = args.kv_host_tier_bytes
    disagg = bool(args.prefill_replicas or args.decode_replicas)
    if disagg:
        base += "_disagg"
        kw["num_prefill_replicas"] = args.prefill_replicas
        kw["num_decode_replicas"] = args.decode_replicas
        kw["handoff_staged"] = args.handoff_staged
    chaos_freeze = args.chaos_freeze_replica
    if chaos_freeze is not None:
        from ray_tpu_torch.serve.chaos import ChaosConfig
        from ray_tpu_torch.serve.health import HealthConfig

        base += "_chaos"
        # tight thresholds so the CPU smoke detects within the freeze
        # window; the freeze outlasts dead_ms by construction
        kw["health"] = HealthConfig(suspect_ms=40.0, dead_ms=120.0,
                                    stall_ms=80.0, probe_ms=5.0)
        kw["chaos"] = ChaosConfig(
            seed=spec.seed, freeze_replica=int(chaos_freeze),
            freeze_after_waves=2, freeze_waves=200,
            freeze_poll_ms=5.0)
    with _maybe_profile(args.profile):
        rep = run_traffic_fleet(
            spec, num_replicas=args.replicas, family="gpt2",
            preset=preset, kv_block_size=16,
            slo=SLOConfig(ttft_ms=slo_ms / 2, e2e_ms=slo_ms), device=dev,
            **kw)
    fleet = rep["fleet"]
    detail = {"replicas": args.replicas, "requests": rep["offered"],
              "completed": rep["completed"], "shed": rep["shed"],
              "preset": preset, "routing": rep["routing"],
              "wfq": rep["wfq"],
              "backend": dev.type, "tpu_error": None,
              "latency_ms": rep["latency_ms"],
              "latency_ms_by_tenant": rep["latency_ms_by_tenant"],
              "routed_by_policy":
                  fleet["router"]["routed_by_policy"]}
    if args.kv_host_tier_bytes:
        detail["kv_host_tier_bytes"] = args.kv_host_tier_bytes
        detail["kv_tier"] = fleet.get("kv_tier")
    if disagg:
        detail["num_prefill_replicas"] = args.prefill_replicas
        detail["num_decode_replicas"] = args.decode_replicas
        detail["handoff_staged"] = args.handoff_staged
        detail["handoff"] = rep.get("handoff")
        emit({
            "metric": f"{base}_handoff_ms_p99",
            "value": rep.get("handoff_ms_p99"), "unit": "ms",
            "vs_baseline": None, "detail": detail})
        for key in sorted(rep):
            # {role}_kv_occupancy_{mean,p95} utilization lines
            if key.endswith("_kv_occupancy_p95") \
                    or key.endswith("_kv_occupancy_mean"):
                emit({
                    "metric": f"{base}_{key}",
                    "value": rep[key], "unit": "fraction",
                    "vs_baseline": None, "detail": detail})
    if chaos_freeze is not None:
        detail["chaos_freeze_replica"] = chaos_freeze
        detail["health"] = fleet.get("health")
        emit({
            "metric": f"{base}_time_to_detect_ms",
            "value": rep.get("time_to_detect_ms"), "unit": "ms",
            "vs_baseline": None, "detail": detail})
        emit({
            "metric": f"{base}_requests_requeued_on_death",
            "value": rep.get("requests_requeued_on_death"),
            "unit": "requests", "vs_baseline": None,
            "detail": detail})
    emit({
        "metric": f"{base}_router_prefix_hit_rate",
        "value": rep["router_prefix_hit_rate"], "unit": "fraction",
        "vs_baseline": None, "detail": detail})
    for name, value in sorted(rep["tenant_slo_attainment"].items()):
        if not isinstance(value, (int, float)):
            continue
        emit({
            "metric": f"{base}_{name}",
            "value": value, "unit": "fraction", "vs_baseline": None,
            "detail": dict(detail,
                           tenant_report=rep["tenants"].get(
                               name.split("_", 1)[0]))})
    _emit_anatomy(base, rep, detail)
    _emit_kvscope(base, rep, detail)


def main_train_watch(args, dev: torch.device) -> None:
    """--train (``bench.py:1094``): :func:`train_watch` at the
    reference's card or CPU-smoke configuration."""
    on_card = dev.type == "cuda"
    overrides = {} if on_card else {"use_flash": False}
    with _maybe_profile(args.profile):
        records = train_watch(
            preset=args.preset or ("gpt2" if on_card else "tiny"),
            batch=args.batch or (8 if on_card else 2),
            seq=1024 if on_card else 128,
            n_steps=args.steps or (20 if on_card else 3), device=dev,
            **overrides)
    for rec in records:
        emit(rec)


def main_train(args, dev: torch.device) -> None:
    """The default mode (``bench.py:1219-1333``): GPT-2 AdamW steps
    timed by :func:`time_config`; on the card GPT-2-124M, B=24, T=1024,
    remat ``mlp_only`` at the default batch; on the CPU the tiny smoke
    (B=2, T=128, full remat, no flash)."""
    if args.mesh == "tensor":
        raise SystemExit("--mesh tensor is a serve layout; combine it "
                         "with --decode or --traffic (train layouts: "
                         "data, fsdp, data_fsdp)")
    on_card = dev.type == "cuda"
    n_ranks = _world_size()
    seq = 1024
    batch = args.batch or (24 * n_ranks if on_card else 2)
    remat_policy = args.remat or ("mlp_only" if not args.batch
                                  else "full")
    cfg_kw = {}
    if args.ce_impl:
        cfg_kw["ce_impl"] = args.ce_impl
    if args.flash_resident:
        cfg_kw["flash_resident"] = args.flash_resident
    with _maybe_profile(args.profile):
        if on_card:
            tok_s, mfu, final_loss, n_chips, cost = time_config(
                batch, seq=seq, n_steps=args.steps or 20,
                preset=args.preset or "gpt2", mesh=args.mesh,
                n_devices=args.chips, remat_policy=remat_policy,
                device=dev, **cfg_kw)
        else:  # the CPU smoke
            remat_policy = "full"
            seq = 128
            tok_s, mfu, final_loss, n_chips, cost = time_config(
                batch, seq=seq, n_steps=args.steps or 2,
                preset=args.preset or "tiny", mesh=args.mesh,
                n_devices=args.chips, use_flash=False, device=dev,
                **cfg_kw)
    # the cost model's cross-check (bench.py:1268-1278): a harvested
    # FLOP count far from the hand-counted 6*N*D says the formula (and
    # the headline MFU) no longer describes the step
    model_flops = cost.get("model_flops")
    xla_flops = cost.get("xla_flops")
    if model_flops and xla_flops:
        rel = abs(xla_flops - model_flops) / model_flops
        if rel > 0.05:
            sys.stderr.write(
                f"bench: WARNING hand-counted FLOPs diverge from the "
                f"cost model by {rel:.1%} (model_flops={model_flops:.3e}"
                f" vs xla_flops={xla_flops:.3e}/step) — trust mfu_xla, "
                f"re-derive the 6*N*D formula\n")
    emit({
        "metric": ("gpt2_124m_train_tokens_per_sec_per_chip" if on_card
                   else "gpt2_tiny_cpu_smoke_tokens_per_sec"),
        "value": round(tok_s, 1),
        "unit": "tokens/s/chip",
        "vs_baseline": (round(mfu / BASELINE_MFU, 3) if mfu is not None
                        else None),
        "detail": {"chips": n_chips, "batch": batch, "seq": seq,
                   "mesh": ("data" if args.mesh == "data_fsdp"
                            and n_chips % 2 else args.mesh),
                   "mfu": round(mfu, 4) if mfu is not None else None,
                   # the cost model's numbers next to the hand count
                   # (device_stats.harvest_cost)
                   "model_flops": model_flops,
                   "xla_flops": xla_flops,
                   "mfu_xla": (round(cost["mfu_xla"], 4)
                               if cost.get("mfu_xla") else None),
                   "peak_hbm_bytes": cost.get("peak_hbm_bytes"),
                   "compile_seconds": cost["compile_seconds"],
                   "loss": round(final_loss, 3),
                   "remat_policy": remat_policy,
                   "ce_impl": args.ce_impl or "dense",
                   "flash_resident": args.flash_resident or "auto",
                   "backend": dev.type, "tpu_error": None}})


def main(args=None, device: DeviceLike = None) -> None:
    """``python -m ray_tpu_torch.bench``: one mode, its metric lines on
    stdout.  ``device`` (or ``--device``) picks the device; None is the
    card."""
    args = args or parse_args()
    if args.chips > _world_size():
        raise ValueError(
            f"--chips {args.chips} is above the process group's world "
            f"size {_world_size()}: start that many ranks "
            f"(torch.distributed.init_process_group) first")
    dev = resolve_device(args.device or device)
    del _EMITTED[:]
    if args.decode:
        if args.spec_k > 0:
            main_decode_spec(args, dev)
        else:
            main_decode(args, dev)
    elif args.traffic:
        main_traffic(args, dev)
    elif args.train:
        main_train_watch(args, dev)
    else:
        main_train(args, dev)
    _ledger_append(args)


if __name__ == "__main__":
    main()
