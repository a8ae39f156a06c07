#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (ray_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (any failure exits non-zero):

1. card   — require CUDA; print the card's name and power limit.
2. build  — build every CUDA kernel from ray_tpu_torch/ops/csrc with nvcc;
            print ptxas's registers, spills and wgmma-serialisation
            notes (C75xx) for each kernel.
3. kernel — hold the flash forward kernel against its plain PyTorch
            version at the serve shapes (B=8, H=12, D=64; T=512, 1024
            and an uneven 1000; causal and not; resident_kv on and off;
            bf16 and f32) and at D=32 and 128 (T=512 and 1000), and time
            it beside the plain version, a PyTorch library call
            computing the same function, and the card's bound.
4. kernel-bwd — hold the flash backward kernels (dQ with the delta
            it computes, dK/dV) against their plain PyTorch versions at
            B*H=24, T=1024, 1000 and 77, D=32, 64 and 128, causal and
            not, bf16 and f32, and the whole backward against the two
            kernels called alone (bit-equal), then hold them and the
            forward against their plain versions at the training shape
            (B=24, H=12, T=1024, D=64, causal, bf16), where they are
            timed beside their plain versions and their bounds (the
            share of it each reaches, grids and waves), the whole
            backward against scaled_dot_product_attention's backward
            in turns, and the forward against its forward; forward and
            backward each bit-equal across two calls.
5. kernel-ce — hold the fused lm-head + cross-entropy kernels
            (forward, dH, dW) against their plain PyTorch versions at
            the card tests' shapes (bf16 and f32; D from 64 to 8192,
            the bf16 backward's widest) and at the training
            shape (N=B*T=24576, V=50304, valid 50257, D=768, bf16, g =
            1/N as the mean loss gives), where they are timed beside
            their plain versions, their bounds (and the share of it
            each reaches), their grids and the dense composition (the
            dense CE's logits product, logsumexp and gather; its
            backward for dH and dW together, and the ratio of dH + dW
            to it), a yardstick the fused path never calls; the
            forward bit-equal across two calls; then at gpt2-large's
            head (N=8192, V=50304, D=1280) timed beside their bounds and
            the dense composition.
6. serve  — build the GPT-2-124M engine (full width, seeded random
            weights, bf16 compute) on the card, answer 8 concurrent
            512-token requests and one ragged batch, check the replies,
            check that the prefill went through the kernel (its launch
            counter, zeroed just before), hold the prefill logits
            against plain attention's, the flash kernels against their
            plain versions at the shape the prefill gives them, and
            paged greedy generation against dense (token for token),
            and time prefill and decode.
7. train  — time GPT-2-124M AdamW steps at full width and depth (B=24,
            T=1024, remat mlp_only, dense CE) through
            ray_tpu_torch.bench.time_config; check that every step
            launched the forward and both backward kernels once per
            layer (counters zeroed just before) and that the loss is
            finite and falls on the repeated batch; compare the loss,
            the gradient norm and the qkv_w gradient with those of
            plain attention (use_flash=False) on the same weights and
            batch, time the two steps in turns, and profile one flash
            step (torch.profiler: device time by kernel).
8. train-ce — the same steps with ce_impl="pallas" (the fused CE
            kernels) through time_config: 12 launches of each flash
            kernel and 1 of each fused-CE kernel per step, a finite
            falling loss; one step each of ce_impl "dense", "pallas",
            "streaming_xla" and of remat "dots", "dots_nb", "attn_out"
            on the same weights and batch, checked against each other
            (loss, gradient norm, wte gradient) and for their flash
            launches; the dense and pallas steps timed in turns, the
            peak memory of each step, and a profile of one pallas step;
            then one dense and one pallas step at gpt2-large's width
            (d_model 1280, 2 layers, B=8), checked against each other.
9. serve-llama — phase 6 for llama-1b (16 layers, 32 query heads on 8
            KV heads of 64, d_model 2048, vocab 32,000): 16 flash
            launches per equal-length prefill, flash vs plain prefill
            logits, paged vs dense greedy tokens (B=8, T=512, 16 new);
            as in phase 6, the flash kernels held against their plain
            versions at the shape the prefill gives them (B=8, H=32,
            T=512, D=64).
10. serve-continuous — llama-1b through the continuous scheduler
            (build_llm_deployment(scheduler="continuous")): 16 requests,
            8 sharing a 256-token prefix and 8 cold, 24 new tokens each,
            greedy, in two waves (12, then 4 once the first reply is
            back), through four f32 engines of 4 slots (dense; paged in
            a 65-block pool, which requeues and evicts; the same with
            chunked prefill of 128 tokens; the same with a host KV
            tier), each request held against the solo dense f32
            llama_generate of its prompt (token for token, or parted at
            a near-tie of the oracle's own logits, printed), the pager
            empty after each paged run, prefix hits and requeues in the
            second, tier restores in the fourth; then bf16 timing, 32
            such requests at once through a paged engine of 8 slots and
            through the batch scheduler, in turns: served tokens/s,
            request latency p50/p95, prefix hit rate, evictions; beside
            the phase's clock each continuous engine's own telemetry
            (engine_stats(): TTFT and inter-token p50/p95, decode
            tokens/s).  The engines launch no kernel (their prefills and
            decode are plain PyTorch), which the kernels line records.
11. serve-spec-disagg — speculative decoding and the prefill/decode
            roles on phase 10's request set, oracle and near-tie rule:
            f32 engines (e) paged with n-gram spec (k=4), (f) dense with
            the aligned draft (llama-1b drafting for itself), (g) a
            role="prefill" paged engine handing each request's blocks
            to a role="decode" one on the device, (h) the same pair
            staged through host memory with chunked prefill, (i) the
            pair of (g) with n-gram spec on the decode side; every reply
            held to the oracle; the acceptance rate of each spec engine
            (counted by wrapping its spec_verify and held equal to the
            engine's own engine_stats()["spec"]; the aligned draft's
            must reach 0.9), the blocks handed off (= sum of ceil(n/16),
            and equal to the engines' engine_stats()["handoff"]),
            the decode engine's prefix hits for prompts sent straight
            to it after the handoffs (>= its imported prefix blocks),
            empty pagers; then bf16, 32 requests at once through 8
            slots: plain, n-gram spec and a llama-s draft in turns
            (served tokens/s, latency p50/p95, acceptance rate), and a
            fast and a staged prefill/decode pair (export and install ms
            a request, bytes, GB/s), each engine's own telemetry beside
            the phase's clock.  No kernel launches.
12. serve-telemetry — the engine telemetry on llama-1b, phase 10's
            request set, oracle and near-tie rule: (a) an f32 paged
            engine of 4 slots with a generous SLOConfig: every reply
            held to the oracle, engine_stats() with every top-level key
            of the reference's, requests admitted = finished = 16,
            tokens_generated = the replies' decode tokens, kv_cache =
            kv_stats()'s, no breach, serve.paged_prefill and
            serve.decode compiled, one HBM-ledger row whose limit is the
            card's memory and whose headroom is limit - max(allocated,
            pool), the roofline naming the card, a timeline with a lane
            per slot, the queue's and the steps'; (b) bf16, 32 requests
            at once through 8 slots: served tokens/s by the phase's
            clock and the engine's, TTFT and inter-token p50/p95, slot
            utilization, the share of the wall time spent inside the
            EngineTelemetry methods (wrapped here), every record call
            under torch.cuda.set_sync_debug_mode("error"), the decode
            steps' and the prefills' share, and one run of 8 under
            torch.profiler: the card's busy share; (c) admission_policy:
            a queue bound of 4 (the shed = rejections_by_reason
            ["shed_queue_full"] > 0, the rest reply), a headroom above
            the card's memory (all shed as shed_hbm_headroom), a
            headroom of 1 GiB (none shed); (d) a 0.001 ms TTFT target:
            a breach and a flight-record dump holding the pager's
            kv_reserve events; (e) a HealthMonitor and a ChaosInjector
            freezing the engine for >= 600 ms, attached as the fleet
            router attaches them: suspect, dead, recovered, with
            time_to_detect_ms, f32 replies held to the oracle; (f) the
            batch scheduler, 8 equal-length bf16 requests: 8 finished
            with a latency sample each, 16 flash forward launches (one
            prefill, zeroed just before).
12a. serve-fleet — the fleet layer (build_llm_fleet, run_traffic,
            run_traffic_fleet, the tracebus) over llama-1b replicas:
            (a) f32, 3 groups x 4 requests of a 256-token shared prefix
            one at a time through 2 replicas by prefix routing and by
            round robin: replies held to the solo oracle, prefix
            routing's pooled hit rate above round robin's, routes by
            prefix affinity, both replicas used, one route event per
            request; (b) f32 disaggregated fleets (1 prefill + 1 decode
            replica; fast, staged): phase 10's 8 cold prompts handed
            off (handoffs = disagg_prefill routes), then 4 prompts of a
            prefix resident on the decode replica routed there by
            prefix affinity; a chaos-dropped handoff journaled and its
            request still the oracle's; (c) bf16 autoscaling with an
            injected clock: up on a burned SLO after the sustain
            window, the new replica serving, down on idle through a
            drain with no block in use, the flight record's scale and
            drain events and its rendered routing table; (d) f32 health
            + a chaos freeze of replica 0 with engine queues filled:
            replica 0 dead in the monitor's log, its queue requeued to
            replica 1, phase 10's replies held to the oracle; (e) bf16
            two-tenant seeded traffic (64 requests, +64 each) through 2
            replicas and through one engine, each once all at once and
            once as the spec's arrivals at 32/s, the side that goes
            first alternating: served tokens/s, latency p50/p95
            overall and per tenant, TTFT attainment, prefix hit rate,
            the router's host share; the tracebus CLI's report on a
            fleet dump exits 0 and each request's critical path sums to
            its e2e within 5%.  Each sub-phase's replicas freed before
            the next; no kernel launches.
12b. serve-run — llama-1b through ray_tpu_torch.init() and serve.run on
            the core runtime: (a) the object store sized to /dev/shm
            (min(2 GiB, half its free bytes); df printed),
            cluster_resources()["GPU"] = the card count, ray_perf at a
            quarter of its trials (tasks/s, actor calls/s, put/get GB/s of
            10 MB) and the vendored msgpack's cost a message; (b) a task
            granted one card sees CUDA_VISIBLE_DEVICES=0, the driver's
            card and no jax/ray_tpu, and runs the flash forward at the
            prefill's shape (B*H=256, T=512, D=64, causal, bf16) against
            its plain version (1 launch); a task without a grant sees no
            card and resolve_device(None) raises "no CUDA device" through
            the runtime; (c) a numpy array and a CPU f32 tensor of 256 MiB
            (at most a quarter of the store) and a 64 MiB bf16 CUDA tensor
            made in a granted task, driver -> task -> driver, bitwise,
            the CUDA one arriving on cuda:0, put/get GB/s; (d) f32: a
            deployment class of this script (ServeRunLLM, by value)
            wrapping the batch engine, num_gpus=1, 8 x 512-token prompts
            at once through handle.remote, each reply the in-process
            engine's or a near-tie of its logits, the replica's flash
            launches (zeroed just before) = 16 x its prefills, status 1
            replica, engine_stats' key tree the in-process engine's; (e)
            bf16, the replica and the in-process engine in turns: served
            tokens/s, a 1-token request's p50 through the handle and
            direct, serve.run to the first reply; (f) serve.delete: the
            replica exits and the card's free memory comes back within
            256 MiB of its value before (d); shutdown leaves no worker.
12c. serve-http — llama-1b over HTTP on a cluster the port's CLI starts:
            (a) `python -m ray_tpu_torch start --head --num-gpus 0` and a
            worker node `start --address <head> --num-gpus 1` as
            subprocesses (each one's start time), the driver attached by
            init(address=...): the two nodes alive beside the driver's
            own, GPU = 1, `status` and `list nodes` exit 0 and agree;
            (d1) a .bind() graph: a CPU task on the head feeds a task
            granted the card on the worker node, which runs the flash
            forward at the prefill's shape against its plain version (1
            launch); a placement group of {"GPU": 1} and {"CPU": 1}
            STRICT_SPREAD across the two nodes; `python -m ray_tpu_torch submit`
            of a `python -c` job that attaches by init(address="auto"):
            SUCCEEDED, its output in its logs, its env_vars reached; (b)
            f32 llama-1b by serve.schema.apply (import path
            ray_tpu_torch.serve.llm:build_llm_deployment, the batch
            scheduler, num_gpus=1), the HTTP proxy on the head, 8 x
            512-token prompts at once as HTTP POSTs: each reply (the
            repr of the engine's int32 array) the in-process engine's or
            a near-tie of its logits, the replica on the worker node, its
            flash launches (kernel_counts, zeroed just before) 16 x its
            prefills, serve.schema.status() 1 replica; (c) bf16 over
            HTTP, through get_deployment_handle and in process, in turns:
            a 1-token request's p50/p95, served tokens/s, and a no-op
            deployment's p50 over HTTP and through the handle (the
            proxy's hop); (d2) the replica's serve_* metrics in
            collect_cluster_metrics within 3 publish intervals, published
            from its process on the worker node; timeline(path) holding
            the replica's actor tasks; (e) serve.delete, shutdown(),
            `stop`: no process and no store segment of the port left,
            the card's free memory back within 256 MiB.
12d. dashboard — on serve-http's cluster before its teardown (e):
            start_dashboard (a detached actor, port 0) and GET
            /api/nodes, /api/actors, /api/serve/applications,
            /api/serve/stats, /api/perf/autopilot, /metrics and /:
            /api/nodes lists
            util.state.list_nodes()' nodes, /metrics carries raytpu_nodes,
            the worker node's raytpu_resource_total{...resource="gpu"} 1.0
            and the replica's published serve_* lines, /api/serve/stats
            the replica's finished requests of (c) and (d2); each route's
            p50 over 20 GETs.
12e. bench-cli — `python -m ray_tpu_torch.bench --ce-impl pallas --steps
            5 --autopilot` and `python -m ray_tpu_torch.bench --decode` as
            subprocesses (GPT-2-124M on the card): their metric lines
            bear the JAX harness's names (bench.py's on a TPU); per step
            12 launches of each flash kernel and 1 of each fused-CE
            kernel, per prefill 12 flash forwards, read in the
            subprocess; tokens/s, MFU and TTFT printed; their lines
            appended to a temporary perf ledger (RAYTPU_BENCH_HISTORY).
12f. data-air — Data and AIR on the port's runtime (init(num_gpus=1));
            first, whether pyarrow and pandas import here: (a) 1,536 seeded
            rows of 1,025 int32 tokens in 16 blocks, data.from_numpy ->
            random_shuffle(seed=0) -> iter_torch_batches(batch_size=24,
            drop_last=True) onto the card feed GPT-2-124M's train step
            (B=24, T=1024, remat mlp_only, ce_impl="pallas", AdamW) for 8
            steps: every batch bit for bit the dataset's numpy batch moved
            by hand, every loss the hand-fed step's from the same start
            (CE_LOSS_TOL), 12/12/12/1/1/1 launches a step; tokens/s
            dataset-fed and direct in turns, the wait for a batch p50/p99,
            the shuffle's wall; (b) the parameters and AdamW state after
            (a) through air.Checkpoint dict -> directory -> dict and
            through save_sharded -> sharded_checkpoint_to_air -> restore,
            bit for bit, GB/s; (c) air.BatchPredictor of those parameters
            over 64 prompts of 512 tokens (blocks of 8) on
            ActorPoolStrategy(size=1, num_gpus=1): a Predictor defined in
            the phase runs one forward a batch (12 flash forwards) and
            returns the next token's argmax and the prompt's mean nll;
            each row the driver's own predictor's (argmax, or a near-tie
            of the driver's logits; nll within LOGIT_TOL), exactly 96
            flash forwards and no other launch in the actor's process (its
            counts booked in the cluster KV), rows/s in the actor and in
            the driver.
12g. moe-mesh — the device plane and mixture-of-experts: (a) a world-1
            NCCL process group on the card and parallel.make_mesh over it
            (six named axes), GPT-2-124M's widths with 8 experts, top-2
            (capacity 1.25, aux 0.01, whole-block remat, pallas CE)
            placed by shard_params; (b) one f32 step at B=2, T=1024
            through the kernels held against the plain versions (plain
            attention, dense CE: loss, gradient norm, wte gradient),
            then 5 timed bf16 AdamW steps at B=8, T=1024 after a warm-up:
            step ms, tokens/s, peak memory against the reckoned peak, a
            profile of one more step (device time by kind),
            24/12/12/1/1/1 launches a step (worked out from the code:
            the remat recompute runs each block's flash forward again)
            against the measured; (c) the same step through
            build_train_step(mesh=...) on the world-1 mesh against the
            unsharded step from the same start (bit for bit, or the
            largest difference); (d) a declared collective group of two
            runtime actors, one granted the card: allreduce, allgather,
            broadcast and send/recv on a CUDA tensor against numpy, µs
            an op.
12h. train-tune — Train and Tune on the port's runtime (init(num_gpus=1)),
            GPT-2-124M (B=24, T=1024, remat mlp_only, ce_impl="pallas",
            AdamW) from a seeded start over 12f's 1,536 seeded rows: (a)
            JaxTrainer(...).fit() with ScalingConfig(num_workers=1,
            use_gpu=True) and JaxConfig(distributed="jax"): the worker,
            granted the card, joins an NCCL group (world 1), builds its
            step with jax_utils.get_mesh() and jax_utils.build_train_step
            (loss_fn, tx, mesh, gpt2_logical_axes(cfg)), runs 8 steps over
            its dataset shard's iter_torch_batches and reports each (loss,
            ms, 12/12/12/1/1/1 launches read in its process and booked in
            the cluster KV), the last with an AIR checkpoint; the trial
            actor holds neither the grant nor a CUDA context;
            metrics_history's 8 rounds carry _round 0-7 and
            training_iteration 1-8; every loss equals the driver's own
            step's on the same batches from the same start (CE_LOSS_TOL),
            the checkpoint's params the worker's bit for bit (sha256);
            the worker's and the driver's step ms, fit() to the first
            report (each process's start-up by part) and fit()'s wall;
            (b) the same with FailureConfig(max_failures=1), its loop
            raising once after reporting step 4 with a checkpoint (the
            marker in the KV): a new worker process granted the card
            resumes from it and steps 5-8 equal (a)'s; the restart's
            wall; (c) a Tuner of a function trainable (the same steps at
            B=8) over 4 learning rates, ASHAScheduler(max_t=8,
            grace_period=2, reduction_factor=2), one trial at a time,
            each granted the card: 12/12/12/1/1/1 launches in every step
            of every trial, the trials ASHA stopped equal to a fresh
            ASHAScheduler's on the replayed reports; the best lr, each
            trial's wall and the gaps between trials.
12j. vision — ViT-B/16 (224 px: T = 197, 12 heads of 64, 86.6M
            parameters) and ResNet-50 at full width and depth: (a) one f32
            ViT loss and gradient at B=4 through the non-causal flash
            kernels, remat on and off, against use_flash=False (a seeded
            non-zero head; every leaf), 24/12/12 and 12/12/12 launches; (b)
            bf16 ViT AdamW steps (f32 master weights) at B=128 through
            build_train_step, 2 warm-up and 5 timed: 24/12/12 launches a
            step (the kernels line's "vision" path), a finite falling
            loss, step ms, images/s, MFU, peak memory, a profile; (c) the
            flash kernels alone at (b)'s attention (B*H = 1536, T = 197,
            D = 64, non-causal, bf16) against their plain versions, timed
            beside their bounds and SDPA in turns; (d) one ResNet-50 loss at
            B=2 on the card against the port on the CPU (f32: logits,
            loss, batch-norm state; f64: those and every gradient leaf),
            then bf16 AdamW steps at B=128 carrying the batch-norm state:
            step ms, images/s, peak memory, a profile; (e) the perf
            ledger's check and report on phase 12e's ledger (entries
            stamped with this card), kvscope report/timeline/export on
            phase 12's engine_stats() snapshot, incidents report on
            phase 12a (d)'s chaos dump, naming the frozen replica with
            fleet_stats' time_to_detect_ms and transition count.
12k. observatory — the cost model, the autopilot and graftcheck: (a)
            bench.py's GPT-2-124M pallas step (B=24, T=1024,
            remat mlp_only) through time_config, 3 timed steps: the
            registry's bench.train_step xla_flops equal to the
            written-out step formula (gpt2_step_flops: forward,
            backward, the mlp_only recompute, the flash kernels'
            visible pairs, the fused-CE kernels), its ratio to
            6*N*tokens; the step built again, timed by CUDA events: its
            FLOPs at most 1.05 of 989 TFLOP/s, beside the registry's
            mfu; bytes_accessed's share of 3.35 TB/s, peak_hbm_bytes
            beside max_memory_allocated, a harvested warm step's wall
            against a plain one's in turns; (b) GPT-2's widths at 2
            layers, B=1, T=512: the harvest on the card (the kernels)
            equal to the harvest on the CPU (their plain versions); (c)
            the programs blocks of phases 10 and 11's engine_stats():
            every serve program that ran carries a cost; (d) phase
            12e's --autopilot line names bench.train_step with a class
            and a headroom; (e) the autopilot CLI's attribute on phase
            12's engine_stats() dump, plan and verdict on phase 12e's
            ledger (reports into a temporary directory); (f) python -m
            ray_tpu_torch.tools.graftcheck --format json reports ok, 12
            programs audited (the tensor-parallel one skipped below its
            two ranks); (g) /api/perf/autopilot answered 200 in 12d.
12l. rllib — RLlib's core on the port's runtime (init(num_gpus=1)): the
            learner policy on the card, rollout workers CPU actors with
            no grant: (a) PPO(cfg).train() x 3 at the repo's pixel pass
            bar (release/workloads/ppo_pixels_learning.py: MinAtar
            breakout 8x8, 2 workers x 8 envs, fragments of 128, batches
            of 2048, minibatch 256, 4 epochs, hidden (128,)): each
            iteration's time_this_iter_s, the learner's update ms (CUDA
            events), env steps/s, finite losses; the learner's
            parameters on the card, the workers' on the CPU
            (CUDA_VISIBLE_DEVICES empty, no CUDA context); whether
            gymnasium imports here (the phase needs none); (b) a learner
            update at Atari scale (84x84x4 frames through the catalog's
            Atari conv stack, hidden (256,), 5000 seeded rows, minibatch
            500, 10 epochs, the reference's atari-ppo.yaml sizes): one
            minibatch's loss and every gradient leaf on the card against
            the CPU (f32, TF32 off), then learn_on_batch timed (ms,
            minibatch steps/s, peak memory); (c) LSTM (cell 64) and
            attention (dim 64, 4 heads, max_seq_len 16) policies on
            RepeatPrev: one fragment from a CPU worker, the rollout's
            stored logp against the learner's recompute on the card
            (ratio 1), one update on the card; (d) Tuner("PPO"), one
            trial of 1 iteration on CartPole-v1 granted the card: no
            error, the JAX package's result keys.  No flash or fused-CE
            kernel launches on this path (counts of 0, the kernels
            line's "rllib" path).
13. train-llama — llama-1b AdamW steps at B=8, T=2048, remat of the
            whole block, ce_impl="pallas": a warm-up and 5 timed steps
            (step ms, tokens/s, MFU, peak memory; 32 flash forwards, 16
            dQ and 16 dK/dV launches and 1 of each fused-CE kernel per
            step; a finite falling loss); one dense-CE and one
            plain-attention step held against the pallas step; dense and
            pallas steps timed in turns; a profile of one pallas step;
            the fused-CE kernels at llama-1b's head (N=16384, V=32000,
            D=2048: dH and dW through the cluster kernel, bit-equal
            across two launches, its clusters and waves) and the flash
            kernels at its attention (B=8, H=32, T=2048, D=64) held
            against their plain versions and timed beside their bounds,
            the dense composition and SDPA.
14. train-telemetry — the train step's telemetry at llama-1b's full
            width (B=8, T=2048, pallas CE, AdamW): (a) build_train_step(
            health=True) fed by watch_data over seeded numpy batches (the
            copy to the card booked by note_h2d), a warm-up and 6 steps:
            32/16/16/1/1/1 launches a step, train_stats() steps 7,
            compiles 1, observed 7, anomalies 0, the registry's
            train.step 1 compile and 6 invokes, every step's anatomy
            legs summing to its wall; (b) save_sharded of the params
            after step 3 (GB/s; the next step's checkpoint leg, the
            checkpoint block); (d) raw and telemetry=True (health off)
            steps in turns under torch.cuda.set_sync_debug_mode("warn"):
            equal counts of synchronising calls, step ms, the wrappers'
            own share of the wall; (e) accumulated_train_step(2
            microbatches, telemetry=True): 64/32/32/2/2/2 launches, loss
            against the plain step's, and in f32 at 2 layers loss and
            updated params against it; (c) a NaN planted in a weight:
            the next step dumps a postmortem within the step, which
            ray_tpu_torch.tools.flightrec renders; restore_sharded of
            step 3 gives the probe loss of the save bit for bit; (f)
            ray_tpu_torch.bench.train_watch() at bench.py --train's
            configuration (GPT-2-124M, B=8, T=1024, 20 + 1 steps).
15. llama-7b — llama-7b's width (d_model 4096, 32 heads of 128) cut to
            2 layers: a dense and a pallas step at B=2, T=2048 checked
            against each other, the flash kernels held against their
            plain versions at the shape these steps give them (B=2,
            H=32, T=2048, D=128), and one prefill, flash vs plain
            attention.

After each phase a "[clock]" line gives its wall.  The line before
the last is a JSON object describing each kernel; the line before it
is the card's name and power limit; the last line is {"ok": true,
"device": {...}}.  There is no CPU path.
"""

from __future__ import annotations

import asyncio
import dataclasses
import importlib
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path


B, H, D = 8, 12, 64          # serve shape
TRAIN_B, TRAIN_T = 24, 1024  # training shape (bench.py's GPT-2 step)
# kernel vs plain version, max |difference| allowed:
# f32 O: the tolerance of the JAX package's flash tests; the kernel and
#   the plain version sum in different orders
# bf16 O: both compute in f32 and differ by the final rounding to bf16
#   (8 mantissa bits: one step is 2**-7 relative), plus order
# LSE (f32 in both cases): a log of a sum of up to T terms, magnitude
#   ~10, summed in another order
TOL = {("f32", "o"): 2e-5, ("bf16", "o"): 5e-2, ("f32", "lse"): 1e-4,
       ("bf16", "lse"): 1e-4}
# backward kernels vs plain versions, |kernel - plain| <= atol + rtol *
# |plain| elementwise and ||kernel - plain|| / ||plain|| <= BWD_REL_NORM
# per tensor: f32 at the JAX package's gradient tolerance (sums in
# another order); bf16: both round P and dS to bf16 before the products
# and the f32 sums to bf16 once, so an element can land one bf16 step
# (2**-7 relative, under rtol) from the plain version's; atol covers
# elements near 0 (a P/dS term rounded the other way is ~2**-9 of a term
# <~ 1) and is a tenth of a typical dK/dV element at T=1024 (~0.05), so
# a dropped part of a sum shows; few elements round apart, so the
# relative norm stays far below one bf16 step (<= 1.4e-4 on an H100 at
# every shape of phase 4; f32 <= 2.5e-7)
BWD_TOL = {"f32": (1e-4, 1e-4), "bf16": (5e-3, 2e-2)}
BWD_REL_NORM = {"f32": 1e-5, "bf16": 2e-3}
# delta = rowsum(dO * O) from the dQ kernel vs flash_bwd_delta: both sum
# the same D products in f32 in different orders (a bf16 product is exact
# in f32, an f32 one rounds once), so each lies within (D + 1) * 2**-24
# * sum|dO * O| of the exact sum and the two within twice that
DELTA_ULP = 2.0 ** -24
# rounds of the whole backward and SDPA's backward timed in turns
BWD_TURNS = 7
# one GPT-2-124M step, flash kernels vs plain attention on the same
# weights and batch, bf16 through 12 layers (on an H100: loss |diff|
# 4.1e-5, grad-norm relative diff 7.6e-6, q/k/v parts <= 1.53e-2; each
# bound is set well above that): the loss (~10.98 at this init), the global gradient
# norm, relative, and the relative norm of the difference of each of
# the q, k and v parts of the qkv_w gradient, which dq, dk and dv feed
# directly; the plain path rounds the scores and P to bf16 where the
# kernels keep f32, so its gradient differs elementwise by up to a bf16
# step
TRAIN_LOSS_TOL = 1e-3
TRAIN_GRAD_NORM_RTOL = 1e-3
TRAIN_QKV_GRAD_RTOL = 0.1
# prefill last-token logits, flash kernel vs plain attention, bf16
# through 12 layers: the paths round P and O to bf16 at different
# places; logits are O(1) at this init
LOGIT_TOL = 0.1


# fused CE kernels vs plain versions: nll and lse, |kernel - plain| <=
# 1e-4 + 1e-4 * |plain| (both sum exact bf16 products and exps in f32,
# in different orders); dH and dW, |kernel - plain| <= ATOL_FRAC *
# rms(plain) + RTOL * |plain| elementwise and ||kernel - plain|| /
# ||plain|| <= REL_NORM: f32 at the JAX package's gradient tolerance,
# bf16 where both round dlogits to bf16 before the products and an
# element rounded a step apart moves a sum of V or N terms by far less
# than a term (the reasons of tests/test_torch_fused_ce_kernel.py,
# which uses the same numbers); a dropped tile moves the relative norm
# by more than 1e-2
CE_OUT_TOL = (1e-4, 1e-4)
CE_GRAD_TOL = {"f32": (1e-4, 1e-4, 1e-5), "bf16": (1e-2, 2e-2, 2e-3)}
CE_SHAPES = ((33, 130, 123, 64), (70, 300, 257, 192),
             (1000, 50304, 50257, 768), (200, 1000, 990, 1024),
             (65, 1088, 1000, 64), (130, 513, 500, 128),
             # gpt2-large, llama-1b and llama-7b widths: the backward's
             # cluster kernel (2, 4 and 8 CTAs split D); D = 5120 and
             # 8192, past 8 x 8 boxes: two grid-y slices of 8 CTAs (at
             # 5120 three hold no column of D); D = 16384: 16 CTAs
             (300, 4096, 4000, 1280), (200, 2000, 1990, 2048),
             (130, 1000, 990, 4096), (33, 130, 123, 5120),
             (70, 200, 190, 8192), (70, 200, 190, 16384))
# GPT-2-124M's head at the training shape
CE_N, CE_V, CE_VALID, CE_D = TRAIN_B * TRAIN_T, 50304, 50257, 768
# gpt2-large's width (d_model 1280, 20 heads of 64: above the 1024 the
# fused-CE kernels once refused), depth cut to WIDE_LAYERS and the batch
# to WIDE_B x TRAIN_T; its pallas step is held against its dense step
WIDE_PRESET, WIDE_D, WIDE_LAYERS, WIDE_B = "gpt2-large", 1280, 2, 8
# one GPT-2-124M step, other CE or remat vs its reference step on the
# same weights and batch: the loss and the relative gradient norm (the
# tolerances of the flash-vs-plain step) and ||wte grad - reference|| /
# ||reference|| over all rows and over the head-only rows (the rows of
# tokens that are no input of the batch, whose gradient comes from the
# lm head alone).  All rows carry the embedding gradient, where the
# backbone's bf16 backward leaves differences near a bf16 step (6.4e-3
# on an H100 for every pair of CE paths); the head-only rows carry the
# CE's dW alone: against dense, which rounds it to bf16, 1e-2 (1.7e-3
# measured); between paths that keep it f32 (pallas, streaming_xla,
# the remat policies), 1e-4 (7.9e-7 measured; a dW kernel that drops
# its last row tile moves it by 2.9e-3)
CE_LOSS_TOL = 1e-3
CE_GRAD_NORM_RTOL = 1e-3
CE_WTE_GRAD_RTOL = 1e-2
CE_HEAD_GRAD_RTOL = {"dense": 1e-2, "f32": 1e-4}

# kinds of device work in the training-step profile, by kernel name
PROFILE_KINDS = (("flash kernels", ("flash_",)),
                 ("convolutions (cuDNN)", ("fprop", "dgrad", "wgrad",
                                           "convolve", "cudnn")),
                 ("fused CE kernels", ("fused_ce_",)),
                 ("matmuls (cuBLAS)", ("nvjet", "gemm", "cutlass", "xmma")),
                 ("copies and casts", ("Memcpy", "Memset", "copy_kernel")),
                 ("reductions", ("reduce_kernel",)))


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def time_ms(torch, fn, iters: int = 20) -> float:
    """Mean device time of fn() over iters calls (CUDA events), after
    warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def in_turns(torch, fns: dict, rounds: int = BWD_TURNS) -> tuple:
    """Each function's time_ms over `rounds` rounds in turns (a, b, b, a,
    ...): ({name: median}, {name: [ms of each round]})."""
    runs = {name: [] for name in fns}
    for i in range(rounds):
        for name in (list(fns) if i % 2 == 0 else list(fns)[::-1]):
            runs[name].append(time_ms(torch, fns[name]))
    return {k: sorted(v)[len(v) // 2] for k, v in runs.items()}, runs


def bound_ms(nbytes: float, flops: float, dtype: str) -> tuple:
    """(least time on this card in ms, "bytes" or "operations"): the
    larger of the bytes over the memory rate and the operations over
    the peak rate of their type: one H100 SXM's data-sheet rates, from
    the port's table (ray_tpu_torch/_private/device_stats.py)."""
    peak = importlib.import_module(
        "ray_tpu_torch._private.device_stats").H100_SXM
    t_bytes = nbytes / peak["hbm_bytes_per_s"] * 1e3
    t_ops = flops / peak[f"{dtype}_flops"] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def gpt2_step_flops(n_layer: int, batch: int, seq: int, d: int, d_ff: int,
                    n_head: int, valid: int, mlp_only: bool = True) -> int:
    """The cost model's FLOPs of one GPT-2 AdamW step through the flash
    kernels (causal) and the fused CE kernels, written out: each
    layer's four projections (qkv, attention out, fc, proj) forward
    2*N*d*out each and backward twice that (dX and dW); the flash
    kernels' visible pairs (forward 4*D, dQ 6*D plus 2*D a row for
    delta, dK/dV 8*D, each per (batch*head)); under ``mlp_only`` remat
    the MLP half is recomputed in the backward up to the last tensor it
    saves, the fc product (its proj output is not needed again); the
    fused CE forward 2*N*valid*D and dH and dW 4*N*valid*D each.  The
    layer norms, GELU, softmax pieces and AdamW are elementwise: 0."""
    n = batch * seq
    hd, bh = d // n_head, batch * n_head
    pairs = visible_pairs(seq, True)
    proj = 2 * n * d * (3 * d) + 2 * n * d * d + 2 * n * d * d_ff * 2
    fwd = proj + 4 * bh * hd * pairs
    bwd = 2 * proj + 14 * bh * hd * pairs + 2 * bh * seq * hd
    recompute = 2 * n * d * d_ff if mlp_only else 0
    return n_layer * (fwd + bwd + recompute) + 10 * n * valid * d


def _work_fns(name: str):
    """The port's per-kernel (operations, bytes) reckonings: the one
    count both these bounds and the cost model use."""
    mod = importlib.import_module(
        "ray_tpu_torch.ops.flash_attention" if name.startswith("flash")
        else "ray_tpu_torch.ops.fused_ce")
    return getattr(mod, f"{name}_work")


def visible_pairs(T: int, causal: bool) -> int:
    return importlib.import_module(
        "ray_tpu_torch.ops.flash_attention").visible_pairs(T, causal)


def attention_bound_ms(T: int, causal: bool, dtype: str,
                       bh: int = B * H, d: int = D) -> tuple:
    """Least time for one (BH, T, D) attention forward on this card:
    q, k, v read once, o and lse written once; 4*D operations per
    visible (query, key) pair (``flash_fwd_work``)."""
    elem = 2 if dtype == "bf16" else 4
    flops, nbytes = _work_fns("flash_fwd")(bh, T, d, causal, elem)
    return bound_ms(nbytes, flops, dtype)


def bwd_bounds_ms(bh: int, T: int, d: int, causal: bool,
                  dtype: str) -> dict:
    """Least times of the backward's parts, each tensor read or written
    once, per visible (query, key) pair: dQ kernel 6*D operations
    (S, dP, dS.K) and 2*D per row for delta (reads q, k, v, o, dO, lse;
    writes dq, delta), dK/dV kernel 8*D (S, dP, P^T.dO, dS^T.Q; reads
    q, k, v, dO, lse, delta; writes dk, dv), the whole backward 10*D
    and delta (reads q, k, v, o, dO, lse; writes dq, dk, dv): the
    ``flash_bwd_*_work`` reckonings."""
    elem = 2 if dtype == "bf16" else 4
    out = {}
    for key, name in (("dq", "flash_bwd_dq"), ("dkv", "flash_bwd_dkv"),
                      ("whole", "flash_bwd")):
        flops, nbytes = _work_fns(name)(bh, T, d, causal, elem)
        out[key] = bound_ms(nbytes, flops, dtype)
    return out


def bwd_compare(got, want, dtype: str) -> dict:
    """max |got - want|, the relative norm of the difference, and
    whether both are within BWD_TOL and BWD_REL_NORM."""
    atol, rtol = BWD_TOL[dtype]
    err = (got.float() - want.float()).abs()
    excess = (err - atol - rtol * want.float().abs()).max().item()
    rel = (err.norm() / want.float().norm()).item()
    return {"max": err.max().item(), "rel": rel,
            "ok": excess <= 0 and rel <= BWD_REL_NORM[dtype]
            and bool(got.isfinite().all())}


def bwd_report(cmp: dict, names=("dq", "dk", "dv")) -> str:
    return ", ".join(f"{n} max|d| {c['max']:.3e} rel {c['rel']:.3e}"
                     for n, c in zip(names, cmp))


def delta_compare(fa, delta, o3, do3) -> dict:
    """max |delta - plain| (flash_bwd_delta), its largest share of the
    bound 2 (D + 1) 2**-24 sum|dO * O| per row, and whether every row
    is within it."""
    want = fa.flash_bwd_delta(o3, do3)
    bound = 2 * (o3.shape[-1] + 1) * DELTA_ULP * (
        do3.float() * o3.float()).abs().sum(dim=-1)[:, None, :]
    err = (delta - want).abs()
    share = (err / bound.clamp_min(1e-30)).max().item()
    return {"max": err.max().item(), "share": share,
            "ok": delta.shape == want.shape and bool((err <= bound).all())}


COUNTERS = ("FLASH_FWD_LAUNCHES", "FLASH_BWD_DQ_LAUNCHES",
            "FLASH_BWD_DKV_LAUNCHES")
CE_COUNTERS = ("FUSED_CE_FWD_LAUNCHES", "FUSED_CE_BWD_DH_LAUNCHES",
               "FUSED_CE_BWD_DW_LAUNCHES")


def _fc():
    return importlib.import_module("ray_tpu_torch.ops.fused_ce")


def zero_counts(fa) -> None:
    for c in COUNTERS:
        setattr(fa, c, 0)
    for c in CE_COUNTERS:
        setattr(_fc(), c, 0)


def read_counts(fa) -> dict:
    """Launches of the flash kernels; of the fused CE kernels too where
    any ran (the serve and dense paths launch none)."""
    counts = {"flash_fwd": fa.FLASH_FWD_LAUNCHES,
              "flash_bwd_dq": fa.FLASH_BWD_DQ_LAUNCHES,
              "flash_bwd_dkv": fa.FLASH_BWD_DKV_LAUNCHES}
    fc = _fc()
    ce = {"fused_ce_fwd": fc.FUSED_CE_FWD_LAUNCHES,
          "fused_ce_bwd_dh": fc.FUSED_CE_BWD_DH_LAUNCHES,
          "fused_ce_bwd_dw": fc.FUSED_CE_BWD_DW_LAUNCHES}
    if any(ce.values()):
        counts.update(ce)
    return counts


def phase_card(torch) -> tuple:
    if not torch.cuda.is_available():
        fail("no CUDA device (torch.cuda.is_available() is false)")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(f"[card] torch {torch.__version__} cuda {torch.version.cuda}; "
          f"device 0: {name}; nvidia-smi: {card}", flush=True)
    return name, card


def ptxas_report(log: str) -> dict:
    """{kernel: [ptxas lines]} from an nvcc -Xptxas -v log: each entry
    function's registers and spills, and any wgmma-serialisation
    warning (C75xx) that names it; kernels by name and template
    arguments, e.g. flash_bwd_dq_bf16_kernel<64>."""
    def short(mangled):
        # the length-prefixed component that names a kernel, then its
        # template arguments (I Li64E ... E)
        for i in range(len(mangled)):
            for j in (1, 2, 3):
                if not mangled[i:i + j].isdigit():
                    break
                n = int(mangled[i:i + j])
                name = mangled[i + j:i + j + n]
                if name.endswith("_kernel") and name.isidentifier() and \
                        not name[0].isdigit():
                    m = re.match(r"I((?:Li\d+E)+)E", mangled[i + j + n:])
                    args = re.findall(r"Li(\d+)E", m.group(1)) if m else []
                    return name + (f"<{', '.join(args)}>" if args else "")
        return mangled[:60]

    report, current = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(\w+)", line)
        if m:
            current = short(m.group(1))
            continue
        if current and ("registers" in line or "spill" in line):
            report.setdefault(current, []).append(
                line.split(":", 1)[-1].strip())
        elif re.search(r"C75\d\d", line):
            m = re.search(r"'(_Z\w+)'", line)
            report.setdefault(short(m.group(1)) if m else "?", []).append(
                line.strip())
    return report


def phase_build(kernels) -> dict:
    t0 = time.perf_counter()
    paths = kernels.build_all()
    secs = time.perf_counter() - t0
    print(f"[build] {len(paths)} kernel libraries in {secs:.2f} s",
          flush=True)
    reports = {}
    for name, path in paths.items():
        log = path.with_suffix(".so.log")
        reports[name] = ptxas_report(log.read_text() if log.exists()
                                     else "")
        for kernel, lines in reports[name].items():
            print(f"[build] {name}: {kernel}: " + "; ".join(lines))
        serial = sum(bool(re.search(r"C75\d\d", ln))
                     for lines in reports[name].values() for ln in lines)
        print(f"[build] {name}: {serial} wgmma-serialisation notes (C75xx)",
              flush=True)
    return reports


def phase_kernel(torch, fa, card: str) -> dict:
    F = torch.nn.functional
    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev).manual_seed(0)
    dtypes = {"bf16": torch.bfloat16, "f32": torch.float32}
    cases = [(T, causal, dt, D) for T in (512, 1024)
             for causal in (True, False) for dt in ("bf16", "f32")]
    cases += [(1000, True, "bf16", D), (1000, True, "f32", D)]
    # the other head dims the kernel is built for (llama-7b's is 128)
    cases += [(T, causal, dt, d) for d in (32, 128) for T in (512, 1000)
              for causal in (True, False) for dt in ("bf16", "f32")]
    headline = None
    for T, causal, dt, d in cases:
        q4, k4, v4 = (torch.randn((B, T, H, d), generator=gen, device=dev)
                      .to(dtypes[dt]) for _ in range(3))
        q3, k3, v3 = (x.transpose(1, 2).reshape(B * H, T, d)
                      for x in (q4, k4, v4))
        scale = 1.0 / math.sqrt(d)
        o_ref, lse_ref = fa.flash_attention_fwd_reference(
            q3, k3, v3, scale=scale, causal=causal)
        o, lse = fa.flash_attention_fwd(q3, k3, v3, scale=scale,
                                        causal=causal)
        torch.cuda.synchronize()
        err_o = (o.float() - o_ref.float()).abs().max().item()
        err_lse = (lse - lse_ref).abs().max().item()
        o_ref4 = o_ref.reshape(B, H, T, d).transpose(1, 2).float()
        err_res = {}
        for resident in (True, False):
            o4 = fa.flash_attention(q4, k4, v4, causal=causal,
                                    resident_kv=resident)
            err_res[resident] = (o4.float() - o_ref4).abs().max().item()
        torch.cuda.synchronize()
        ok = (max(err_o, *err_res.values()) <= TOL[(dt, "o")]
              and err_lse <= TOL[(dt, "lse")])
        ms = time_ms(torch, lambda: fa.flash_attention_fwd(
            q3, k3, v3, scale=scale, causal=causal))
        bound, bound_by = attention_bound_ms(T, causal, dt, d=d)
        print(f"[kernel] T={T} D={d} causal={causal} {dt}: max|o-plain| "
              f"{err_o:.3e} (resident on {err_res[True]:.3e}, off "
              f"{err_res[False]:.3e}; tol {TOL[(dt, 'o')]:.0e}), "
              f"max|lse-plain| {err_lse:.3e} (tol "
              f"{TOL[(dt, 'lse')]:.0e}); kernel {ms:.4f} ms, bound "
              f"{bound:.4f} ms ({bound_by}) [{card}]", flush=True)
        if not ok:
            fail(f"kernel disagrees with its plain version at T={T} D={d} "
                 f"causal={causal} {dt}")
        if (T, causal, dt, d) == (512, True, "bf16", D):
            # the shape the serve prefill gives the kernel
            plain_ms = time_ms(torch, lambda: fa.
                               flash_attention_fwd_reference(
                                   q3, k3, v3, scale=scale, causal=causal))
            qh, kh, vh = (x.transpose(1, 2).contiguous()
                          for x in (q4, k4, v4))
            library_ms = time_ms(torch, lambda: F.
                                 scaled_dot_product_attention(
                                     qh, kh, vh, is_causal=True))
            headline = {"max_abs_err": err_o, "ms": ms,
                        "plain_ms": plain_ms, "bound_ms": bound,
                        "bound_by": bound_by, "library_ms": library_ms}
            print(f"[kernel] serve shape B={B} T={T} H={H} D={D} causal "
                  f"bf16: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                  f"library (scaled_dot_product_attention) "
                  f"{library_ms:.4f} ms, bound {bound:.4f} ms "
                  f"({bound_by}) [{card}]", flush=True)
        del q4, k4, v4, q3, k3, v3, o, lse, o_ref, lse_ref, o_ref4
    return headline


async def _serve_all(engine, prompts):
    return await asyncio.gather(*(engine(p) for p in prompts))


#: llama's flash-vs-plain bf16 prefill logit tolerance: the paths round
#: P and O to bf16 at different places through 16 layers with a bf16
#: residual stream, logits up to ~4 from the untied head: each bf16 path
#: lies ~0.12 from the f32 logits and the two 0.117 apart on an H100
#: (llama-7b's width at 2 layers: 0.10), so the bound is 0.25.  A bf16
#: forward that drops key tile 0 of the last query block reads 2.87 here,
#: and 0.663 when it does so in one (batch, head) pair only
#: (flash_fault_check.py on an H100); the kernel check at the path's own
#: shape (check_train_shape) is the sharper one: that plant moves o by
#: 0.232 against its 5e-2
LLAMA_LOGIT_TOL = 0.25
#: the same prefill in f32, the f32 flash kernel vs plain f32 attention:
#: each attention output within 2e-5 (TOL) of the other, carried through
#: the layers (on an H100: 3.3e-6 for GPT-2-124M, 2.3e-5 for llama-1b,
#: 2.5e-5 at llama-7b's width); an f32 forward that drops key tile 0 of
#: the last query block reads 2.35 at llama-1b (flash_fault_check.py)
F32_LOGIT_TOL = 1e-3


def serve_family(family: str) -> tuple:
    """(preset, prefill, decode step, generate, flash-vs-plain bf16
    prefill logit tolerance) of a serving phase's family."""
    if family == "gpt2":
        from ray_tpu_torch.models import gpt2_decode as m
        return "gpt2", m.prefill, m.decode_step, m.generate, LOGIT_TOL
    from ray_tpu_torch.models import llama_decode as m
    return ("llama-1b", m.llama_prefill, m.llama_decode_step,
            m.llama_generate, LLAMA_LOGIT_TOL)


def check_prefill_flash(torch, prefill, params, toks, cfg, tol: float,
                        tag: str) -> dict:
    """Prefill last-token logits through the flash kernel against plain
    attention on the same weights, in bf16 (within ``tol``) and in f32
    (the f32 flash kernel against plain f32 attention, within
    F32_LOGIT_TOL); and the bf16 flash logits no further from the f32
    ones than twice the bf16 plain logits are (the flash kernel keeps P
    in f32 where plain attention rounds it to bf16).  Fails otherwise.
    Must run under inference_mode.  Returns the numbers."""
    logits = {}
    for dtype in ("bf16", "f32"):
        for flash in (True, False):
            c = dataclasses.replace(cfg, use_flash=flash, dtype={
                "bf16": torch.bfloat16, "f32": torch.float32}[dtype])
            logits[dtype, flash] = prefill(params, toks, c)[0]
    torch.cuda.synchronize()
    lf = logits["bf16", True]
    ref = logits["f32", False]
    out = {"bf16": (lf - logits["bf16", False]).abs().max().item(),
           "f32": (logits["f32", True] - ref).abs().max().item(),
           "flash_from_f32": (lf - ref).abs().max().item(),
           "plain_from_f32": (logits["bf16", False] - ref).abs().max()
           .item()}
    print(f"[{tag}] prefill last-token logits, flash vs plain attention: "
          f"bf16 max|diff| {out['bf16']:.4e} (tol {tol}; max|logit| "
          f"{ref.abs().max().item():.3f}), f32 max|diff| {out['f32']:.4e} "
          f"(tol {F32_LOGIT_TOL}); bf16 from the f32 logits: flash "
          f"{out['flash_from_f32']:.4e}, plain {out['plain_from_f32']:.4e}"
          f" (flash within twice plain's)", flush=True)
    if lf.shape != (toks.shape[0], cfg.padded_vocab) or \
            not bool(torch.isfinite(lf).all()):
        fail("prefill logits are not finite (B, padded_vocab)")
    if out["bf16"] > tol or out["f32"] > F32_LOGIT_TOL or \
            out["flash_from_f32"] > 2 * out["plain_from_f32"]:
        fail("flash and plain prefill logits disagree")
    return out


def phase_serve(torch, np, fa, card: str, family: str = "gpt2",
                tag: str = "serve") -> dict:
    """The serving main path of ``family``: the engine at full width
    and depth answering 8 concurrent 512-token requests (flash launches
    counted, zeroed just before) and a ragged batch; prefill logits,
    flash against plain attention; the flash kernels against their
    plain versions at the shape the prefill gives them; paged greedy
    generation against dense, token for token; prefill and decode
    timed.  Returns the launch counts and the times."""
    from ray_tpu_torch.serve import build_llm_deployment

    preset, prefill, decode_step, generate, logit_tol = serve_family(family)
    max_new, t_prompt = 16, 512
    t0 = time.perf_counter()
    engine = build_llm_deployment(family, preset, max_new_tokens=max_new,
                                  max_batch_size=8, seed=0).func_or_class()
    cfg = engine.cfg
    torch.cuda.synchronize()
    print(f"[{tag}] {family} {preset}: {cfg.n_layer} layers, "
          f"d={cfg.d_model}, {cfg.n_head} heads "
          f"({getattr(cfg, 'n_kv_head', cfg.n_head)} KV heads), head_dim "
          f"{cfg.head_dim}, vocab {cfg.padded_vocab}, compute {cfg.dtype}, "
          f"params {cfg.param_dtype}: engine up in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    rng = np.random.default_rng(0)

    def prompts_of(lengths):
        return [rng.integers(0, cfg.vocab_size, size=n, dtype=np.int32)
                for n in lengths]

    def check(prompts, outs):
        for p, o in zip(prompts, outs):
            if o.shape != (len(p) + max_new,) or \
                    not np.array_equal(o[:len(p)], p):
                fail(f"reply of shape {o.shape} does not extend its "
                     f"{len(p)}-token prompt by {max_new} tokens")
            if o.min() < 0 or o.max() >= cfg.vocab_size:
                fail("reply holds a token outside the vocabulary")

    # warm-up: cuBLAS handles and allocator pools, not counted
    warm = prompts_of([t_prompt] * 8)
    check(warm, asyncio.run(_serve_all(engine, warm)))

    # the main path: 8 concurrent equal-length requests, one batch
    prompts = prompts_of([t_prompt] * 8)
    zero_counts(fa)
    t0 = time.perf_counter()
    outs = asyncio.run(_serve_all(engine, prompts))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts(fa)
    launches = counts["flash_fwd"]
    check(prompts, outs)
    if counts != {"flash_fwd": cfg.n_layer, "flash_bwd_dq": 0,
                  "flash_bwd_dkv": 0}:
        fail(f"kernel launches {counts} for the equal-length prefill, "
             f"expected {cfg.n_layer} forward and no backward")
    print(f"[{tag}] 8 x {t_prompt}-token requests: {launches} flash "
          f"kernel launches; {8 * max_new} tokens in {wall * 1e3:.1f} ms "
          f"wall = {8 * max_new / wall:.1f} served tokens/s [{card}]",
          flush=True)

    # a ragged batch: left-padded, plain attention by design
    ragged = prompts_of([512, 300, 100, 17, 450, 64, 256, 8])
    fa.FLASH_FWD_LAUNCHES = 0
    outs = asyncio.run(_serve_all(engine, ragged))
    check(ragged, outs)
    if fa.FLASH_FWD_LAUNCHES != 0:
        fail("the ragged prefill launched the causal-only flash kernel")
    print(f"[{tag}] ragged batch of {len(ragged)} answered (0 kernel "
          f"launches: ragged prefill takes the plain masked attention)",
          flush=True)

    # the kernels at this prefill's shape: (B*H, T, D) of the query heads
    kernel_err = check_train_shape(torch, fa, seed=3, b=len(prompts),
                                   h=cfg.n_head, T=t_prompt,
                                   d=cfg.head_dim, tag=f"{tag} shape")["err"]
    toks = torch.from_numpy(np.stack(prompts)).cuda()
    with torch.inference_mode():
        cfg_flash = dataclasses.replace(cfg, use_flash=True)
        cfg_plain = dataclasses.replace(cfg, use_flash=False)
        flash_check = check_prefill_flash(torch, prefill, engine.params,
                                          toks, cfg, logit_tol, tag)

        # the block-paged layout: greedy tokens equal to dense, token
        # for token (the gathered pool view holds the dense cache's
        # bytes, so every logit is the same)
        kw = dict(max_new_tokens=max_new, temperature=0.0)
        dense = generate(engine.params, toks, cfg, **kw)
        paged = generate(engine.params, toks, cfg, kv_layout="paged",
                         kv_block_size=16, **kw)
        torch.cuda.synchronize()
        same = bool(torch.equal(dense, paged))
        print(f"[{tag}] greedy generation B=8 T={t_prompt} +{max_new}, "
              f"kv_layout paged (16-token blocks) vs dense: "
              f"token-for-token equal {same}", flush=True)
        if not same:
            fail("paged and dense greedy generation disagree")
        del dense, paged

        # prefill with the kernel and with plain attention, in turns
        # (flash, plain, plain, flash, ...) so both see the same host
        prefill_s = {"flash": [], "plain": []}
        for name in ["flash", "plain", "plain", "flash"] * 3:
            c = cfg_flash if name == "flash" else cfg_plain
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, cache = prefill(engine.params, toks, c)
            torch.cuda.synchronize()
            prefill_s[name].append(time.perf_counter() - t0)
        med = {k: sorted(v)[len(v) // 2] * 1e3 for k, v in
               prefill_s.items()}
        step_tok = torch.zeros((8,), dtype=torch.int32, device="cuda")
        decode_step(engine.params, cache, step_tok, cfg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(max_new):
            _, cache = decode_step(engine.params, cache, step_tok, cfg)
        torch.cuda.synchronize()
        decode_ms = (time.perf_counter() - t0) / max_new * 1e3
    print(f"[{tag}] prefill B=8 T={t_prompt}, median of 6: "
          f"{med['flash']:.2f} ms with the flash kernel, "
          f"{med['plain']:.2f} ms with plain attention; decode B=8: "
          f"{decode_ms:.2f} ms/token step [{card}]", flush=True)
    del engine, cache
    torch.cuda.empty_cache()
    return {"counts": counts, "prefill_ms": med["flash"],
            "prefill_plain_ms": med["plain"], "decode_ms": decode_ms,
            "served_tokens_per_s": 8 * max_new / wall,
            "flash_vs_plain_logits": flash_check,
            "kernels_vs_plain": kernel_err}


def check_train_shape(torch, fa, seed: int = 2, b: int = TRAIN_B,
                      h: int = H, T: int = TRAIN_T, d: int = D,
                      tag: str = "training shape",
                      causal: bool = True) -> dict:
    """Hold the forward kernel (o, lse) and the backward kernels (dq,
    dk, dv) against their plain versions at a training shape (default
    GPT-2-124M's: B=24, H=12, T=1024, D=64; causal, bf16); fail if any
    disagrees.  Returns the inputs and outputs, for timing."""
    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev).manual_seed(seed)
    bh = b * h
    kw = dict(scale=1.0 / math.sqrt(d), causal=causal)
    mask = "causal" if causal else "non-causal"
    t = dict(zip(("q4", "k4", "v4", "do4"), (
        torch.randn((b, T, h, d), generator=gen, device=dev)
        .to(torch.bfloat16) for _ in range(4))))
    for n in ("q", "k", "v", "do"):
        t[f"{n}3"] = t[f"{n}4"].transpose(1, 2).reshape(bh, T, d)
    with torch.no_grad():
        q3, k3, v3, do3 = (t[n] for n in ("q3", "k3", "v3", "do3"))
        o3, lse = fa.flash_attention_fwd(q3, k3, v3, **kw)
        o_ref, lse_ref = fa.flash_attention_fwd_reference(q3, k3, v3, **kw)
        torch.cuda.synchronize()
        err_o = (o3.float() - o_ref.float()).abs().max().item()
        err_lse = (lse - lse_ref).abs().max().item()
        del o_ref, lse_ref
        print(f"[kernel-bwd] {tag} B={b} T={T} H={h} D={d} "
              f"{mask} bf16: forward max|o-plain| {err_o:.3e} (tol "
              f"{TOL[('bf16', 'o')]:.0e}), max|lse-plain| {err_lse:.3e} "
              f"(tol {TOL[('bf16', 'lse')]:.0e})", flush=True)
        if err_o > TOL[("bf16", "o")] or err_lse > TOL[("bf16", "lse")]:
            fail(f"the forward kernel disagrees with its plain version at "
                 f"the {tag}")
        dq, delta = fa.flash_bwd_dq(q3, k3, v3, o3, do3, lse, **kw)
        got = (dq, *fa.flash_bwd_dkv(q3, k3, v3, do3, lse, delta, **kw))
        dq_ref, delta_ref = fa.flash_bwd_dq_reference(q3, k3, v3, o3, do3,
                                                      lse, **kw)
        want = (dq_ref, *fa.flash_bwd_dkv_reference(q3, k3, v3, do3, lse,
                                                    delta_ref, **kw))
        torch.cuda.synchronize()
        cmp = [bwd_compare(g, w, "bf16") for g, w in zip(got, want)]
        dcmp = delta_compare(fa, delta, o3, do3)
        del got, want, dq, dq_ref, delta_ref
    print(f"[kernel-bwd] {tag} backward: {bwd_report(cmp)} (tol "
          f"{BWD_TOL['bf16'][0]:.0e} + {BWD_TOL['bf16'][1]:.0e}*|plain|, "
          f"rel {BWD_REL_NORM['bf16']:.0e}); delta from the dQ kernel "
          f"max|d| {dcmp['max']:.3e} ({dcmp['share']:.3f} of its bound "
          f"2 (D + 1) 2**-24 sum|dO O|)", flush=True)
    if not all(c["ok"] for c in cmp) or not dcmp["ok"]:
        fail(f"backward kernels disagree with their plain version at the "
             f"{tag}")
    t.update(o3=o3, lse=lse, delta=delta,
             err={"fwd": err_o, "dq": cmp[0]["max"],
                  "dkv": max(cmp[1]["max"], cmp[2]["max"]),
                  "delta": dcmp["max"], "delta_share": dcmp["share"]})
    return t


def phase_kernel_bwd(torch, fa, card: str, ptxas: dict) -> dict:
    F = torch.nn.functional
    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev).manual_seed(1)
    dtypes = {"bf16": torch.bfloat16, "f32": torch.float32}

    cases = [(T, d, causal, dt) for dt in ("bf16", "f32")
             for causal in (True, False) for T in (1024, 1000, 77)
             for d in (32, 64, 128)]
    with torch.no_grad():
        for T, d, causal, dt in cases:
            q3, k3, v3, do3 = (torch.randn((24, T, d), generator=gen,
                                           device=dev).to(dtypes[dt])
                               for _ in range(4))
            kw = dict(scale=d ** -0.5, causal=causal)
            o3, lse = fa.flash_attention_fwd_reference(q3, k3, v3, **kw)
            want = fa.flash_attention_bwd_reference(q3, k3, v3, o3, lse,
                                                    do3, **kw)
            dq, delta = fa.flash_bwd_dq(q3, k3, v3, o3, do3, lse, **kw)
            dk, dv = fa.flash_bwd_dkv(q3, k3, v3, do3, lse, delta, **kw)
            whole = fa.flash_attention_bwd(q3, k3, v3, o3, lse, do3, **kw)
            torch.cuda.synchronize()
            got = (dq, dk, dv)
            cmp = [bwd_compare(g, w, dt) for g, w in zip(got, want)]
            dcmp = delta_compare(fa, delta, o3, do3)
            same = all(torch.equal(a, b) for a, b in zip(whole, got))
            print(f"[kernel-bwd] BH=24 T={T} D={d} causal={causal} {dt}: "
                  f"{bwd_report(cmp)} (tol {BWD_TOL[dt][0]:.0e} + "
                  f"{BWD_TOL[dt][1]:.0e}*|plain|, rel "
                  f"{BWD_REL_NORM[dt]:.0e}); delta max|d| "
                  f"{dcmp['max']:.3e} ({dcmp['share']:.3f} of its bound); "
                  f"whole backward bit-equal to the kernels alone: {same}",
                  flush=True)
            if not all(c["ok"] for c in cmp) or not dcmp["ok"] or not same:
                fail(f"backward kernels disagree with their plain version "
                     f"at T={T} D={d} causal={causal} {dt}")
            del q3, k3, v3, do3, o3, lse, want, got, whole, dq, dk, dv, delta

    t = check_train_shape(torch, fa)
    q4, k4, v4, do4, q3, k3, v3, do3, o3, lse, delta = (
        t[n] for n in ("q4", "k4", "v4", "do4", "q3", "k3", "v3", "do3",
                       "o3", "lse", "delta"))
    err = t["err"]
    bh, T = TRAIN_B * H, TRAIN_T
    kw = dict(scale=1.0 / math.sqrt(D), causal=True)
    whole_fn = lambda: fa.flash_attention_bwd(q3, k3, v3, o3, lse, do3, **kw)
    with torch.no_grad():
        ms = {"dq": time_ms(torch, lambda: fa.flash_bwd_dq(
                  q3, k3, v3, o3, do3, lse, **kw)),
              "dkv": time_ms(torch, lambda: fa.flash_bwd_dkv(
                  q3, k3, v3, do3, lse, delta, **kw))}
        plain = {"dq": time_ms(torch, lambda: fa.flash_bwd_dq_reference(
                     q3, k3, v3, o3, do3, lse, **kw), iters=5),
                 "dkv": time_ms(torch, lambda: fa.flash_bwd_dkv_reference(
                     q3, k3, v3, do3, lse, delta, **kw), iters=5),
                 "whole": time_ms(torch, lambda: fa.
                                  flash_attention_bwd_reference(
                                      q3, k3, v3, o3, lse, do3, **kw),
                                  iters=5),
                 "fwd": time_ms(torch, lambda: fa.
                                flash_attention_fwd_reference(
                                    q3, k3, v3, **kw), iters=5)}
        # determinism at the training shape: a second call, bit-equal
        first = whole_fn()
        second = whole_fn()
        torch.cuda.synchronize()
        deterministic = all(torch.equal(a, b) for a, b in zip(first,
                                                                second))
        first = fa.flash_attention_fwd(q3, k3, v3, **kw)
        second = fa.flash_attention_fwd(q3, k3, v3, **kw)
        torch.cuda.synchronize()
        fwd_deterministic = all(torch.equal(a, b) for a, b in zip(first,
                                                                    second))
        del first, second
        qh, kh, vh, doh = (x.transpose(1, 2).contiguous()
                           for x in (q4, k4, v4, do4))
        # the forward and SDPA's forward in turns, as the backward below
        fwd_med, fwd_turns = in_turns(torch, {
            "port": lambda: fa.flash_attention_fwd(q3, k3, v3, **kw),
            "sdpa": lambda: F.scaled_dot_product_attention(
                qh, kh, vh, is_causal=True)})
        ms["fwd"], sdpa_fwd = fwd_med["port"], fwd_med["sdpa"]
    print(f"[kernel-bwd]   two calls bit-equal: whole backward (dq, dk, dv) "
          f"{deterministic}, forward (o, lse) {fwd_deterministic}",
          flush=True)
    if not deterministic or not fwd_deterministic:
        fail("the flash kernels gave different results on the same inputs")
    qh, kh, vh = (x.requires_grad_(True) for x in (qh, kh, vh))
    out = F.scaled_dot_product_attention(qh, kh, vh, is_causal=True)
    sdpa_fn = lambda: torch.autograd.grad(out, (qh, kh, vh), doh,
                                          retain_graph=True)
    # the whole backward and SDPA's backward in turns
    med, turns = in_turns(torch, {"port": whole_fn, "sdpa": sdpa_fn})
    ms["whole"] = med["port"]
    bounds = bwd_bounds_ms(bh, T, D, True, "bf16")
    fwd_bound = attention_bound_ms(T, True, "bf16", bh=bh)
    # grids: one CTA per (batch*head, block of rows), as many at once on
    # an SM as their registers allow
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    ctas = bh * -(-T // fa.BWD_BF16_CTA_ROWS)
    waves = ctas / (sms * fa.BWD_BF16_CTAS_PER_SM)
    for name in ("dq", "dkv", "whole"):
        share = bounds[name][0] / ms[name]
        grid = (f", {ctas} CTAs = {waves:.2f} waves of "
                f"{fa.BWD_BF16_CTAS_PER_SM} on each of {sms} SMs"
                if name != "whole" else "")
        print(f"[kernel-bwd]   {name:5s}: kernel {ms[name]:.4f} ms, plain "
              f"{plain[name]:.4f} ms, bound {bounds[name][0]:.4f} ms "
              f"({bounds[name][1]}, {100 * share:.1f}% of it "
              f"reached){grid} [{card}]", flush=True)
    factor = med["port"] / med["sdpa"]
    print(f"[kernel-bwd]   whole backward (dQ with delta, then dK/dV) vs "
          f"scaled_dot_product_attention's backward (dq, dk, dv), "
          f"{BWD_TURNS} rounds in turns: medians {med['port']:.4f} vs "
          f"{med['sdpa']:.4f} ms = {factor:.3f}x; port "
          f"{[round(x, 4) for x in turns['port']]}, sdpa "
          f"{[round(x, 4) for x in turns['sdpa']]} [{card}]", flush=True)
    fwd_ctas = bh * -(-T // fa.FWD_BF16_CTA_ROWS)
    fwd_waves = fwd_ctas / (sms * fa.FWD_BF16_CTAS_PER_SM)
    print(f"[kernel-bwd]   forward: kernel {ms['fwd']:.4f} ms, plain "
          f"{plain['fwd']:.4f} ms, scaled_dot_product_attention "
          f"{sdpa_fwd:.4f} ms ({ms['fwd'] / sdpa_fwd:.3f}x; medians of "
          f"{BWD_TURNS} rounds in turns, port "
          f"{[round(x, 4) for x in fwd_turns['port']]}, sdpa "
          f"{[round(x, 4) for x in fwd_turns['sdpa']]}), bound "
          f"{fwd_bound[0]:.4f} ms ({fwd_bound[1]}, "
          f"{100 * fwd_bound[0] / ms['fwd']:.1f}% of it reached), "
          f"{fwd_ctas} CTAs = {fwd_waves:.2f} waves of "
          f"{fa.FWD_BF16_CTAS_PER_SM} on each of {sms} SMs [{card}]",
          flush=True)
    whole = {"ms": ms["whole"], "plain_ms": plain["whole"],
             "bound_ms": bounds["whole"][0],
             "bound_by": bounds["whole"][1], "library_ms": med["sdpa"],
             "over_library": factor, "turns_ms": turns,
             "library": "backward of F.scaled_dot_product_attention("
                        "is_causal=True): dq, dk, dv; medians of "
                        f"{BWD_TURNS} rounds in turns"}
    kernels = {"dq": "flash_bwd_dq_bf16_kernel<64>",
               "dkv": "flash_bwd_dkv_bf16_kernel<64>"}
    records = {name: {"max_abs_err": err[name], "ms": ms[name],
                      "plain_ms": plain[name], "bound_ms": bounds[name][0],
                      "bound_by": bounds[name][1],
                      # no one PyTorch call computes dQ (or dK/dV) alone;
                      # the library's whole backward is under "whole"
                      "library_ms": None,
                      "bound_share": bounds[name][0] / ms[name],
                      "ctas": ctas, "waves": waves,
                      "ptxas": ptxas.get(kernels[name], []),
                      "whole_backward": whole}
               for name in ("dq", "dkv")}
    records["dq"]["delta_max_abs_err"] = err["delta"]
    records["dq"]["delta_bound_share"] = err["delta_share"]
    records["fwd_train_shape"] = {"ms": ms["fwd"], "plain_ms": plain["fwd"],
                                  "bound_ms": fwd_bound[0],
                                  "bound_by": fwd_bound[1],
                                  "library_ms": sdpa_fwd,
                                  "bound_share": fwd_bound[0] / ms["fwd"],
                                  "over_library": ms["fwd"] / sdpa_fwd,
                                  "turns_ms": fwd_turns,
                                  "ctas": fwd_ctas, "waves": fwd_waves}
    return records


# ---------------------------------------------------------------------------
# fused lm-head + cross-entropy kernels
# ---------------------------------------------------------------------------

def ce_inputs(torch, n, v, valid, d, dtype, seed, g=None):
    """h ~ N(0, 1) and w ~ N(0, 1/D) (logits ~ N(0, 1)), targets uniform
    over the valid vocab, g uniform or the given constant."""
    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev).manual_seed(seed)
    h = torch.randn((n, d), generator=gen, device=dev).to(dtype)
    w = (torch.randn((v, d), generator=gen, device=dev) * d ** -0.5).to(dtype)
    tgt = torch.randint(0, valid, (n,), generator=gen, device=dev,
                        dtype=torch.int32)
    gv = (torch.rand((n,), generator=gen, device=dev) if g is None
          else torch.full((n,), g, device=dev))
    return h, w, tgt, gv


def ce_compare(torch, got, want, dtype: str, kind: str) -> dict:
    """max |got - want|, the relative norm of the difference and whether
    both are within CE_OUT_TOL (kind "out": nll, lse) or CE_GRAD_TOL
    (kind "grad": dh, dw)."""
    err = (got.float() - want.float()).abs()
    rel = (err.norm() / want.float().norm()).item()
    if kind == "out":
        atol, rtol = CE_OUT_TOL
        rel_ok = True
    else:
        frac, rtol, rel_norm = CE_GRAD_TOL[dtype]
        atol = frac * want.float().square().mean().sqrt().item()
        rel_ok = rel <= rel_norm
    excess = (err - atol - rtol * want.float().abs()).max().item()
    return {"max": err.max().item(), "rel": rel,
            "ok": excess <= 0 and rel_ok and bool(got.isfinite().all())}


def check_ce_kernels(torch, fc, n, v, valid, d, dtype: str, seed: int,
                     g=None) -> dict:
    """Run the forward, dH and dW kernels once on seeded inputs and hold
    each against its plain version (dH and dW on the kernel's lse);
    fail on any disagreement.  Returns the inputs, outputs and errors."""
    dt = {"bf16": torch.bfloat16, "f32": torch.float32}[dtype]
    h, w, tgt, gv = ce_inputs(torch, n, v, valid, d, dt, seed, g)
    with torch.no_grad():
        nll, lse = fc.fused_ce_fwd(h, w, tgt, valid)
        dh = fc.fused_ce_bwd_dh(h, w, tgt, lse, gv, valid)
        dw = fc.fused_ce_bwd_dw(h, w, tgt, lse, gv, valid)
        torch.cuda.synchronize()
        want_nll, want_lse = fc.fused_ce_fwd_reference(h, w, tgt, valid)
        cmp = {"nll": ce_compare(torch, nll, want_nll, dtype, "out"),
               "lse": ce_compare(torch, lse, want_lse, dtype, "out")}
        del want_nll, want_lse
        cmp["dh"] = ce_compare(torch, dh, fc.fused_ce_bwd_dh_reference(
            h, w, tgt, lse, gv, valid), dtype, "grad")
        cmp["dw"] = ce_compare(torch, dw, fc.fused_ce_bwd_dw_reference(
            h, w, tgt, lse, gv, valid), dtype, "grad")
        tail_zero = bool((dw[valid:] == 0).all())
    print(f"[kernel-ce] N={n} V={v} valid={valid} D={d} {dtype}: " +
          ", ".join(f"{k} max|d| {c['max']:.3e} rel {c['rel']:.3e}"
                    for k, c in cmp.items()) +
          f"; dW rows past valid_vocab all 0: {tail_zero}", flush=True)
    if not all(c["ok"] for c in cmp.values()) or not tail_zero:
        fail(f"fused CE kernels disagree with their plain versions at N={n}"
             f" V={v} valid={valid} D={d} {dtype}")
    return {"h": h, "w": w, "tgt": tgt, "g": gv, "lse": lse, "cmp": cmp}


def check_ce_train_shape(torch, fc, seed: int = 3) -> dict:
    """The three fused CE kernels against their plain versions at the
    training shape (N=24576, V=50304, valid 50257, D=768, bf16, g=1/N);
    fails on any disagreement."""
    return check_ce_kernels(torch, fc, CE_N, CE_V, CE_VALID, CE_D, "bf16",
                            seed, g=1.0 / CE_N)


def ce_bounds_ms(n: int, v: int, valid: int, d: int) -> dict:
    """Least times of the three kernels on this card, bf16 operands:
    each reads h (N, D), w (valid rows used, D), the targets and
    (backward) lse and g once and writes its outputs once (nll and lse;
    dh (N, D) f32; dw (V, D) f32); the forward does 2*N*valid*D
    operations, dH and dW each 4*N*valid*D (the logits again and their
    own product): the ``fused_ce_*_work`` reckonings."""
    out = {}
    for key, name in (("fwd", "fused_ce_fwd"), ("dh", "fused_ce_bwd_dh"),
                      ("dw", "fused_ce_bwd_dw")):
        flops, nbytes = _work_fns(name)(n, v, valid, d, 2)
        out[key] = bound_ms(nbytes, flops, "bf16")
    return out


def time_wide_ce(torch, fc, card: str) -> dict:
    """The three kernels at the head shape of the gpt2-large step that
    phase train-ce checks (N = WIDE_B * TRAIN_T, V = 50304, D = 1280,
    bf16; dH and dW through the cluster kernel), held against their
    plain versions and timed beside their bounds and the dense
    composition (its forward for the forward, its backward for dH and
    dW together); {kernel: {"ms", "bound_ms", "bound_by", "shape",
    "max_abs_err", "rel_err", "library_ms", "dense_composition"}}."""
    from ray_tpu_torch.models.gpt2 import _LogitsMatmul, nll_from_logits

    n, d = WIDE_B * TRAIN_T, WIDE_D
    t = check_ce_kernels(torch, fc, n, CE_V, CE_VALID, d, "bf16", seed=4,
                         g=1.0 / n)
    h, w, tgt, g, lse = (t[k] for k in ("h", "w", "tgt", "g", "lse"))
    with torch.no_grad():
        ms = {"fwd": time_ms(torch, lambda: fc.fused_ce_fwd(
                  h, w, tgt, CE_VALID), iters=5),
              "dh": time_ms(torch, lambda: fc.fused_ce_bwd_dh(
                  h, w, tgt, lse, g, CE_VALID), iters=3),
              "dw": time_ms(torch, lambda: fc.fused_ce_bwd_dw(
                  h, w, tgt, lse, g, CE_VALID), iters=3)}
        dense_fwd = time_ms(torch, lambda: nll_from_logits(
            _LogitsMatmul.apply(h, w), tgt, CE_VALID, CE_V), iters=3)
    hg, wg = h.detach().requires_grad_(True), w.detach().requires_grad_(True)
    nll = nll_from_logits(_LogitsMatmul.apply(hg, wg), tgt, CE_VALID, CE_V)
    dense_bwd = time_ms(torch, lambda: torch.autograd.grad(
        nll, (hg, wg), g, retain_graph=True), iters=3)
    del nll, hg, wg
    bounds = ce_bounds_ms(n, CE_V, CE_VALID, d)
    print(f"[kernel-ce]   gpt2-large's head (N={n} V={CE_V} D={d} bf16): " +
          ", ".join(f"{k} {ms[k]:.4f} ms (bound {bounds[k][0]:.4f}, "
                    f"{100 * bounds[k][0] / ms[k]:.1f}%)" for k in ms) +
          f"; dense composition forward {dense_fwd:.4f} ms, backward (dH "
          f"and dW) {dense_bwd:.4f} ms; fused dH + dW "
          f"{(ms['dh'] + ms['dw']) / dense_bwd:.3f}x it [{card}]", flush=True)
    cmp = {"fwd": ("nll", "lse"), "dh": ("dh",), "dw": ("dw",)}
    return {k: {"ms": ms[k], "bound_ms": bounds[k][0],
                "bound_by": bounds[k][1], "shape": [n, CE_V, CE_VALID, d],
                "max_abs_err": max(t["cmp"][c]["max"] for c in cmp[k]),
                "rel_err": max(t["cmp"][c]["rel"] for c in cmp[k]),
                "library_ms": dense_fwd if k == "fwd" else None,
                "dense_composition": {"forward_ms": dense_fwd,
                                      "backward_ms": dense_bwd}}
            for k in ms}


def phase_kernel_ce(torch, fc, card: str, ptxas: dict) -> dict:
    from ray_tpu_torch.models.gpt2 import _LogitsMatmul, nll_from_logits

    for i, (n, v, valid, d) in enumerate(CE_SHAPES):
        for dtype in ("bf16", "f32"):
            check_ce_kernels(torch, fc, n, v, valid, d, dtype, seed=10 + i)
    # the cluster plan of each card-test width above 1024, and how many
    # of its clusters fit on the card at once
    for d in sorted({s[3] for s in CE_SHAPES if s[3] > 1024}):
        plan = fc.fused_ce_bwd_plan(d, fc.BWD_BLOCK_ROWS)
        print(f"[kernel-ce]   D={d}: clusters of {plan.k} CTAs holding "
              f"{plan.sc} boxes, {plan.slices} slice(s); "
              f"{fc.fused_ce_bwd_max_clusters(d, 'dh')} (dH) / "
              f"{fc.fused_ce_bwd_max_clusters(d, 'dw')} (dW) at once "
              f"[{card}]", flush=True)
    t = check_ce_train_shape(torch, fc)
    h, w, tgt, g, lse = (t[k] for k in ("h", "w", "tgt", "g", "lse"))
    a = (h, w, tgt)
    ab = (h, w, tgt, lse, g)
    valid = CE_VALID
    with torch.no_grad():
        ms = {"fwd": time_ms(torch, lambda: fc.fused_ce_fwd(*a, valid),
                             iters=10),
              "dh": time_ms(torch, lambda: fc.fused_ce_bwd_dh(*ab, valid),
                            iters=10),
              "dw": time_ms(torch, lambda: fc.fused_ce_bwd_dw(*ab, valid),
                            iters=10)}
        plain = {"fwd": time_ms(torch, lambda: fc.fused_ce_fwd_reference(
                     *a, valid), iters=2),
                 "dh": time_ms(torch, lambda: fc.fused_ce_bwd_dh_reference(
                     *ab, valid), iters=2),
                 "dw": time_ms(torch, lambda: fc.fused_ce_bwd_dw_reference(
                     *ab, valid), iters=2)}
        # the dense composition, as the dense-CE step runs it: f32
        # logits by torch.mm(out_dtype=float32), the -1e9 tail mask,
        # logsumexp and a gather (a yardstick: the fused path never
        # calls it)
        dense_fwd = time_ms(torch, lambda: nll_from_logits(
            _LogitsMatmul.apply(h, w), tgt, valid, CE_V), iters=5)
        # determinism: a second forward, bit-equal
        first, second = fc.fused_ce_fwd(*a, valid), fc.fused_ce_fwd(*a, valid)
        torch.cuda.synchronize()
        fwd_deterministic = all(torch.equal(x, y) for x, y in zip(first,
                                                                    second))
        del first, second
    print(f"[kernel-ce]   two calls of the forward bit-equal (nll, lse): "
          f"{fwd_deterministic}", flush=True)
    if not fwd_deterministic:
        fail("the fused CE forward gave different results on the same "
             "inputs")
    hg, wg = h.detach().requires_grad_(True), w.detach().requires_grad_(True)
    nll = nll_from_logits(_LogitsMatmul.apply(hg, wg), tgt, valid, CE_V)
    dense_bwd = time_ms(torch, lambda: torch.autograd.grad(
        nll, (hg, wg), g, retain_graph=True), iters=5)
    del nll, hg, wg
    bounds = ce_bounds_ms(CE_N, CE_V, valid, CE_D)
    # how many CTAs each kernel runs (the module's tiles and the
    # backward's launch plan), in waves over the card's SMs
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    # the forward's vocab splits, cut to whole groups of vocab tiles
    tiles = -(-valid // fc.FWD_TILE_ROWS)
    per_split = -(-tiles // fc.fused_ce_fwd_splits(CE_N, valid, sms))
    ctas = {"fwd": -(-CE_N // fc.FWD_BLOCK_ROWS) * -(-tiles // per_split),
            "dh": math.prod(fc.fused_ce_bwd_plan(CE_D, CE_N).grid),
            "dw": math.prod(fc.fused_ce_bwd_plan(CE_D, CE_V).grid)}
    share = {k: bounds[k][0] / ms[k] for k in ms}
    for k in ("fwd", "dh", "dw"):
        print(f"[kernel-ce]   {k:3s}: kernel {ms[k]:.4f} ms, plain "
              f"{plain[k]:.4f} ms, bound {bounds[k][0]:.4f} ms "
              f"({bounds[k][1]}, {100 * share[k]:.1f}% of it reached), "
              f"{ctas[k]} CTAs = {ctas[k] / sms:.2f} waves on {sms} SMs "
              f"[{card}]", flush=True)
    bwd_ratio = (ms["dh"] + ms["dw"]) / dense_bwd
    print(f"[kernel-ce]   dense composition: forward {dense_fwd:.4f} ms, "
          f"backward (dH and dW) {dense_bwd:.4f} ms; fused forward + dH + "
          f"dW {ms['fwd'] + ms['dh'] + ms['dw']:.4f} ms; fused dH + dW "
          f"{ms['dh'] + ms['dw']:.4f} ms = {bwd_ratio:.3f}x the dense "
          f"backward [{card}]", flush=True)
    dense = {"library": "dense CE composition: torch.mm(out_dtype="
                        "float32) logits, logsumexp, gather (dH and dW: "
                        "its backward, together)",
             "forward_ms": dense_fwd, "backward_ms": dense_bwd}
    cmp = t["cmp"]
    del h, w, tgt, g, lse, a, ab, t
    wide = time_wide_ce(torch, fc, card)
    records = {}
    for k, cmp_keys in (("fwd", ("nll", "lse")), ("dh", ("dh",)),
                        ("dw", ("dw",))):
        records[k] = {
            "max_abs_err": max(cmp[c]["max"] for c in cmp_keys),
            "ms": ms[k], "plain_ms": plain[k], "bound_ms": bounds[k][0],
            "bound_by": bounds[k][1],
            "library_ms": dense_fwd if k == "fwd" else None,
            "bound_share": share[k], "dense_composition": dense,
            "ctas": ctas[k], "waves": ctas[k] / sms,
            "wide_shape": wide[k],
            "ptxas": ptxas.get({"fwd": "fused_ce_fwd_bf16_kernel",
                                "dh": "fused_ce_bwd_bf16_kernel<1, 12>",
                                "dw": "fused_ce_bwd_bf16_kernel<2, 12>"}[k],
                               [])}
        if k != "fwd":
            records[k]["dh_plus_dw_over_dense_backward"] = bwd_ratio
    return records


def check_flash_vs_plain_step(torch, cfg) -> tuple:
    """One GPT-2 loss and gradient with the flash kernels and with
    plain attention (use_flash=False) on the same seeded weights and
    batch; fail unless the losses, the gradient norms and the q, k, v
    parts of the qkv_w gradient agree.  Returns (params, batch,
    {"flash": health, "plain": health})."""
    from ray_tpu_torch.models.gpt2 import gpt2_init, gpt2_loss
    from ray_tpu_torch.train.optim import tree_leaves, tree_unflatten

    gen = torch.Generator(device="cuda").manual_seed(0)
    params = gpt2_init(cfg, gen, device="cuda")
    tokens = torch.randint(0, cfg.vocab_size, (TRAIN_B, TRAIN_T + 1),
                           generator=gen, device="cuda")
    batch = {"tokens": tokens}
    health, qkv_grad = {}, {}
    for name, flash in (("flash", True), ("plain", False)):
        c = dataclasses.replace(cfg, use_flash=flash)
        live = [x.detach().requires_grad_(True)
                for x in tree_leaves(params)]
        loss = gpt2_loss(tree_unflatten(params, live), batch, c)
        grads = torch.autograd.grad(loss, live)
        health[name] = {"loss": loss.item(), "grad_norm": torch.stack(
            [g.float().square().sum() for g in grads]).sum().sqrt().item(),
            "nonfinite": sum(int((~g.isfinite()).sum()) for g in grads)}
        qkv_grad[name] = tree_unflatten(params, list(grads))[
            "blocks"]["attn"]["qkv_w"].float()
        del loss, grads, live
    dl = abs(health["flash"]["loss"] - health["plain"]["loss"])
    dg = abs(health["flash"]["grad_norm"] - health["plain"]["grad_norm"]) \
        / health["plain"]["grad_norm"]
    # qkv_w is (L, d, 3, h, hd): its q, k and v columns get their
    # gradient only through dQ, dK and dV, so each part is compared
    # alone (a kernel that dropped dK moves the k part by 1)
    dqkv = {n: ((qkv_grad["flash"][:, :, i] - qkv_grad["plain"][:, :, i])
                .norm() / qkv_grad["plain"][:, :, i].norm()).item()
            for i, n in enumerate("qkv")}
    print(f"[train] one step, flash kernels vs plain attention: loss "
          f"{health['flash']['loss']:.5f} vs {health['plain']['loss']:.5f}"
          f" (|diff| {dl:.3e}, tol {TRAIN_LOSS_TOL}), grad norm "
          f"{health['flash']['grad_norm']:.5f} vs "
          f"{health['plain']['grad_norm']:.5f} (rel diff {dg:.3e}, tol "
          f"{TRAIN_GRAD_NORM_RTOL}), qkv_w gradient ||flash - plain|| / "
          f"||plain|| of its q, k, v parts " + ", ".join(
              f"{n} {x:.3e}" for n, x in dqkv.items()) +
          f" (tol {TRAIN_QKV_GRAD_RTOL}), nonfinite "
          f"{health['flash']['nonfinite']}/{health['plain']['nonfinite']}",
          flush=True)
    if dl > TRAIN_LOSS_TOL or dg > TRAIN_GRAD_NORM_RTOL or \
            max(dqkv.values()) > TRAIN_QKV_GRAD_RTOL or \
            health["flash"]["nonfinite"] or health["plain"]["nonfinite"]:
        fail("the flash and plain-attention steps disagree")
    return params, batch, health


def profile_step(torch, state: dict, name: str, step_ms: float,
                 card: str, tag: str = "train") -> dict:
    """Profile one step of ``state[name]`` ([step, params, opt_state])
    with torch.profiler (CUPTI) and print its device time by kind and
    its largest kernels; returns {kind: ms}."""
    step, p, s = state[name]

    def run():
        state[name][1:] = step(p, s, state["batch"])[:2]

    return profile_call(torch, run, name, step_ms, card, tag)


def profile_call(torch, run, name: str, step_ms: float, card: str,
                 tag: str) -> dict:
    """profile_step's body for any step ``run()`` (named ``name``)."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    # kernels and copies themselves, not the host ops that launch them
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in events) / 1e3
    print(f"[{tag}] profile of one {name} step: {device_ms:.2f} ms of "
          f"device time in {len(events)} distinct kernels, "
          f"{device_ms / step_ms:.3f} of the unprofiled median step "
          f"({step_ms:.2f} ms) [{card}]", flush=True)
    kinds = {}
    for e in events:
        kind = next((k for k, marks in PROFILE_KINDS if any(
            m in e.key for m in marks)), "other elementwise")
        kinds[kind] = kinds.get(kind, 0.0) + e.self_device_time_total / 1e3
    print(f"[{tag}]   {name} step by kind: " + ", ".join(
        f"{k} {v:.2f} ms" for k, v in sorted(kinds.items(),
                                              key=lambda kv: -kv[1])),
          flush=True)
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"[{tag}]   {e.self_device_time_total / 1e3:8.3f} ms "
              f"x{e.count:<5d} {e.key[:90]}", flush=True)
    return kinds


def loss_of(cfg):
    """The loss function of cfg's family (gpt2_loss or llama_loss)."""
    from ray_tpu_torch.models.gpt2 import gpt2_loss
    from ray_tpu_torch.models.llama import LlamaConfig, llama_loss

    return llama_loss if isinstance(cfg, LlamaConfig) else gpt2_loss


def head_grad(grads: dict, cfg):
    """The lm head's gradient, vocab-major (V, D) float32: GPT-2's tied
    wte (its input rows carry the embedding's gradient too), llama's
    untied lm_head transposed (all of it comes from the CE)."""
    from ray_tpu_torch.models.llama import LlamaConfig

    if isinstance(cfg, LlamaConfig):
        return grads["lm_head"].t().float()
    return grads["wte"].float()


def interleaved_steps(torch, params, batch, cfgs: dict, order) -> tuple:
    """AdamW steps of each config in ``cfgs``, each from its own copy of
    ``params``, run in ``order`` (names of cfgs); returns (the steps'
    state for profile_step, {name: [wall seconds]})."""
    from ray_tpu_torch.train import adamw, build_train_step
    from ray_tpu_torch.train.optim import tree_map

    tx = adamw(3e-4, weight_decay=0.1)
    state = {"batch": batch}
    for name, c in cfgs.items():
        p = tree_map(torch.clone, params)
        state[name] = [build_train_step(
            lambda p, b, c=c: loss_of(c)(p, b, c), tx, telemetry=False), p,
            tx.init(p)]
    wall = {name: [] for name in cfgs}
    for name in order:
        step, p, s = state[name]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state[name][1:] = step(p, s, batch)[:2]
        torch.cuda.synchronize()
        wall[name].append(time.perf_counter() - t0)
    return state, wall


def run_main_path(torch, fa, card: str, tag: str, per_step: dict,
                  **overrides) -> dict:
    """The main path of a training phase: bench.py's GPT-2 step (B=24,
    T=1024, remat mlp_only, ``overrides``) through time_config, 5 timed
    steps after one warm-up, launch counters zeroed just before and
    read just after (``per_step`` launches of each kernel per step
    expected), the loss finite and falling, the peak memory."""
    from ray_tpu_torch.bench import time_config

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(fa)
    tok_s, mfu, _, _, cost = time_config(
        TRAIN_B, seq=TRAIN_T, n_steps=5, remat_policy="mlp_only",
        **overrides)
    torch.cuda.synchronize()
    counts = read_counts(fa)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    runs = cost["steps_run"]
    losses = cost["losses"]
    want = {k: n * runs for k, n in per_step.items()}
    print(f"[{tag}] GPT-2-124M, B={TRAIN_B} T={TRAIN_T}, remat mlp_only, "
          f"{overrides or 'dense CE'}: {runs} steps launched {counts} "
          f"(expected {per_step} per step); losses "
          f"{[round(x, 4) for x in losses]}", flush=True)
    if counts != want:
        fail(f"kernel launches {counts} over {runs} steps, expected {want}")
    if not all(math.isfinite(x) for x in losses) or \
            not losses[-1] < losses[0]:
        fail(f"the loss is not finite and falling: {losses}")
    print(f"[{tag}] 5 timed steps: {cost['step_ms']:.2f} ms/step, "
          f"{tok_s:.1f} tokens/s, MFU {mfu:.4f} (6*N*tokens/s against "
          f"989 TFLOP/s); peak memory {peak_gib:.2f} GiB "
          f"(max_memory_allocated) [{card}]", flush=True)
    return {"counts": counts, "steps_run": runs,
            "step_ms": cost["step_ms"], "tokens_per_s": tok_s, "mfu": mfu,
            "losses": losses, "peak_gib": peak_gib}


def report_medians(result: dict, wall: dict, tag: str, card: str,
                   n_params: int = 0,
                   tokens: int = TRAIN_B * TRAIN_T) -> None:
    """Median wall time, tokens/s and MFU of each interleaved step
    (default: GPT-2-124M's parameters and batch)."""
    from ray_tpu_torch.bench import H100_BF16_PEAK_FLOPS
    from ray_tpu_torch.models.gpt2 import gpt2_config, gpt2_param_count

    n_params = n_params or gpt2_param_count(gpt2_config("gpt2"))
    for name, secs in wall.items():
        med = sorted(secs)[len(secs) // 2]
        tps = tokens / med
        result[f"{name}_step_ms"] = med * 1e3
        print(f"[{tag}] {name:6s} step, median of {len(secs)} in turns: "
              f"{med * 1e3:.2f} ms, {tps:.1f} tokens/s, MFU "
              f"{6 * n_params * tps / H100_BF16_PEAK_FLOPS:.4f} [{card}]",
              flush=True)


def phase_train(torch, fa, card: str) -> dict:
    from ray_tpu_torch.models.gpt2 import gpt2_config

    cfg = gpt2_config("gpt2", max_seq=TRAIN_T, remat_policy="mlp_only")
    L = cfg.n_layer
    # the main path: bench.py's GPT-2 step (remat mlp_only, dense CE)
    result = run_main_path(torch, fa, card, "train", {
        "flash_fwd": L, "flash_bwd_dq": L, "flash_bwd_dkv": L})
    params, batch, health = check_flash_vs_plain_step(torch, cfg)
    cfgs = {"flash": cfg, "plain": dataclasses.replace(cfg,
                                                       use_flash=False)}
    # the two steps in turns (flash, plain, plain, flash, ...)
    state, wall = interleaved_steps(torch, params, batch, cfgs,
                                    ["flash", "plain", "plain", "flash"] * 2)
    # where one flash step's device time goes (torch.profiler, CUPTI)
    flash_ms = sorted(wall["flash"])[len(wall["flash"]) // 2] * 1e3
    profile_step(torch, state, "flash", flash_ms, card)

    result["health"] = health
    report_medians(result, wall, "train", card)
    return result


def one_step(torch, fa, params, batch, cfg) -> dict:
    """One loss and gradient of ``cfg`` on ``params`` and ``batch``: the
    loss, the global gradient norm, the nonfinite count, the head's
    gradient (head_grad), the kernel launches (counters zeroed just
    before) and the step's peak memory."""
    from ray_tpu_torch.train.optim import tree_leaves, tree_unflatten

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(fa)
    live = [x.detach().requires_grad_(True) for x in tree_leaves(params)]
    loss = loss_of(cfg)(tree_unflatten(params, live), batch, cfg)
    grads = torch.autograd.grad(loss, live)
    torch.cuda.synchronize()
    out = {"loss": loss.item(), "grad_norm": torch.stack(
        [g.float().square().sum() for g in grads]).sum().sqrt().item(),
        "nonfinite": sum(int((~g.isfinite()).sum()) for g in grads),
        "head_grad": head_grad(tree_unflatten(params, list(grads)), cfg),
        "counts": read_counts(fa),
        "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    del loss, grads, live
    return out


#: the steps of phase train-ce: name -> (GPT2Config overrides, the
#: steps it is checked against); every one at B=24, T=1024 on the same
#: weights and batch.  streaming_xla is held against pallas too: both
#: keep the wte gradient in f32.
CE_STEPS = {
    "dense": (dict(ce_impl="dense"), ()),
    "pallas": (dict(ce_impl="pallas"), ("dense",)),
    "streaming_xla": (dict(ce_impl="streaming_xla"), ("dense", "pallas")),
    "dots": (dict(ce_impl="pallas", remat_policy="dots"), ("pallas",)),
    "dots_nb": (dict(ce_impl="pallas", remat_policy="dots_nb"),
                ("pallas",)),
    "attn_out": (dict(ce_impl="pallas", remat_policy="attn_out"),
                 ("pallas",)),
}


def compare_steps(st: dict, r: dict, ref: str, head_only,
                  head_tol=None) -> tuple:
    """One step against its reference step ``r`` (named ``ref``): loss,
    relative gradient norm, ||head grad - reference|| / ||reference||
    over all rows and over the head-only rows.  GPT-2 (``head_only`` a
    row mask of the tied wte): tolerances CE_LOSS_TOL,
    CE_GRAD_NORM_RTOL, CE_WTE_GRAD_RTOL over all rows and
    CE_HEAD_GRAD_RTOL over the head-only rows.  llama (``head_only``
    None: every row of the untied lm_head is the head's): the loss and
    gradient norm tolerances, and ``head_tol`` over the lm_head.
    Returns (the numbers, a line of text, whether all are within)."""
    dl = abs(st["loss"] - r["loss"])
    dg = abs(st["grad_norm"] - r["grad_norm"]) / r["grad_norm"]
    diff = st["head_grad"] - r["head_grad"]
    dw = (diff.norm() / r["head_grad"].norm()).item()
    text = (f"; vs {ref}: loss |diff| {dl:.3e} (tol {CE_LOSS_TOL}), grad "
            f"norm rel diff {dg:.3e} (tol {CE_GRAD_NORM_RTOL}), ")
    ok = dl <= CE_LOSS_TOL and dg <= CE_GRAD_NORM_RTOL
    if head_only is None:
        text += (f"||lm_head grad - {ref}|| / ||{ref}|| {dw:.3e} (tol "
                 f"{head_tol})")
        return ({"loss_diff": dl, "grad_norm_rel": dg,
                 "lm_head_grad_rel": dw}, text, ok and dw <= head_tol)
    dh = (diff[head_only].norm() / r["head_grad"][head_only].norm()).item()
    head_tol = CE_HEAD_GRAD_RTOL["dense" if ref == "dense" else "f32"]
    text += (f"||wte grad - {ref}|| / ||{ref}|| {dw:.3e} (tol "
             f"{CE_WTE_GRAD_RTOL}), on the {int(head_only.sum())} head-only "
             f"rows {dh:.3e} (tol {head_tol})")
    ok = ok and dw <= CE_WTE_GRAD_RTOL and dh <= head_tol
    return ({"loss_diff": dl, "grad_norm_rel": dg, "wte_grad_rel": dw,
             "head_rows_rel": dh}, text, ok)


def check_ce_and_remat_steps(torch, fa, cfg, spec=None,
                             batch_rows: int = TRAIN_B) -> tuple:
    """One step of each ``spec`` entry (default CE_STEPS) on the same
    seeded weights and a batch of ``batch_rows`` x TRAIN_T tokens, each
    against its reference step (loss, gradient norm, wte gradient over
    all rows and over the head-only rows) and for its launches: one of
    each flash kernel per layer under mlp_only, two forwards and one of
    each backward under the selective policies (the per-layer counts of
    the CPU test test_flash_calls_per_step_follow_remat), 1 of each
    fused CE kernel with ce_impl="pallas" and none otherwise.  Returns
    (params, batch, {name: step})."""
    from ray_tpu_torch.models.gpt2 import gpt2_init

    gen = torch.Generator(device="cuda").manual_seed(1)
    params = gpt2_init(cfg, gen, device="cuda")
    batch = {"tokens": torch.randint(0, cfg.vocab_size,
                                     (batch_rows, TRAIN_T + 1),
                                     generator=gen, device="cuda")}
    head_only = torch.ones(cfg.padded_vocab, dtype=torch.bool,
                           device="cuda")
    head_only[batch["tokens"][:, :-1].flatten()] = False
    L = cfg.n_layer
    steps, bad = {}, []
    for name, (kw, refs) in (spec or CE_STEPS).items():
        c = dataclasses.replace(cfg, **kw)
        st = one_step(torch, fa, params, batch, c)
        steps[name] = st
        fwd = 2 * L if c.remat_policy in ("dots", "dots_nb", "attn_out") \
            else L
        want = {"flash_fwd": fwd, "flash_bwd_dq": L, "flash_bwd_dkv": L}
        if c.ce_impl == "pallas":
            want.update(fused_ce_fwd=1, fused_ce_bwd_dh=1,
                        fused_ce_bwd_dw=1)
        line = (f"[train-ce] one step, d_model {c.d_model}, {L} layers, "
                f"B={batch_rows}, ce {c.ce_impl}, remat "
                f"{c.remat_policy}: loss {st['loss']:.5f}, grad norm "
                f"{st['grad_norm']:.5f}, nonfinite {st['nonfinite']}, "
                f"peak memory {st['peak_gib']:.2f} GiB; launches "
                f"{st['counts']}")
        if st["counts"] != want:
            bad.append(f"{name}: launches {st['counts']}, expected {want}")
        if st["nonfinite"]:
            bad.append(f"{name}: {st['nonfinite']} nonfinite gradients")
        st["vs"] = {}
        for ref in refs:
            vs, text, ok = compare_steps(st, steps[ref], ref, head_only)
            st["vs"][ref] = vs
            line += text
            if not ok:
                bad.append(f"{name} disagrees with {ref}")
        print(line, flush=True)
    for st in steps.values():
        del st["head_grad"]
    if bad:
        fail("; ".join(bad))
    return params, batch, steps


#: the steps of the gpt2-large-width check
WIDE_STEPS = {name: CE_STEPS[name] for name in ("dense", "pallas")}


def check_wide_ce_step(torch, fa) -> dict:
    """One dense and one ce_impl="pallas" step of gpt2-large's width at
    reduced depth on the same weights and batch, checked against each
    other as check_ce_and_remat_steps does; fails on a disagreement."""
    from ray_tpu_torch.models.gpt2 import gpt2_config

    cfg = gpt2_config(WIDE_PRESET, n_layer=WIDE_LAYERS, max_seq=TRAIN_T,
                      remat_policy="mlp_only", ce_impl="dense")
    _, _, steps = check_ce_and_remat_steps(torch, fa, cfg, WIDE_STEPS,
                                           WIDE_B)
    return steps


def phase_train_ce(torch, fa, card: str) -> dict:
    from ray_tpu_torch.models.gpt2 import gpt2_config

    cfg = gpt2_config("gpt2", max_seq=TRAIN_T, remat_policy="mlp_only",
                      ce_impl="pallas")
    L = cfg.n_layer
    # the main path: bench.py's GPT-2 step through the fused CE kernels
    result = run_main_path(torch, fa, card, "train-ce", {
        "flash_fwd": L, "flash_bwd_dq": L, "flash_bwd_dkv": L,
        "fused_ce_fwd": 1, "fused_ce_bwd_dh": 1, "fused_ce_bwd_dw": 1},
        ce_impl="pallas")

    params, batch, steps = check_ce_and_remat_steps(
        torch, fa, dataclasses.replace(cfg, ce_impl="dense"))
    cfgs = {"dense": dataclasses.replace(cfg, ce_impl="dense"),
            "pallas": cfg}
    # the two steps in turns (dense, pallas, pallas, dense, ...)
    state, wall = interleaved_steps(torch, params, batch, cfgs,
                                    ["dense", "pallas", "pallas",
                                     "dense"] * 2)
    result["steps"] = steps
    report_medians(result, wall, "train-ce", card)
    result["wide_steps"] = check_wide_ce_step(torch, fa)
    result["profile"] = profile_step(torch, state, "pallas",
                                     result["pallas_step_ms"], card)
    return result


# ---------------------------------------------------------------------------
# the llama family
# ---------------------------------------------------------------------------

#: llama-1b (16 layers, 32 query / 8 KV heads of 64, d_model 2048, d_ff
#: 5504, vocab 32,000) trained at its max_seq: B=8, T=2048, remat of the
#: whole block, ce_impl="pallas"
LLAMA_PRESET, LLAMA_B, LLAMA_T, LLAMA_TIMED_STEPS = "llama-1b", 8, 2048, 5
#: llama-7b's width (d_model 4096, 32/32 heads of 128, d_ff 11008), depth
#: cut to 2 layers, B=2
LLAMA_WIDE_PRESET, LLAMA_WIDE_LAYERS, LLAMA_WIDE_B = "llama-7b", 2, 2
#: the lm_head gradient of one llama step against another on the same
#: weights and batch (compare_steps' head_tol), ||diff|| / ||ref||:
#: "dense" between the fused CE and the dense CE, whose backward rounds
#: dW to bf16 where the fused kernels keep it f32 (the hidden states are
#: the same): each element within a bf16 rounding (2**-9 relative), so
#: the norm well under 1e-2 (1.66e-3 on an H100 at llama-1b and at
#: llama-7b's width); "plain" between flash and plain attention,
#: whose hidden states differ by the bf16 rounding of P in every layer:
#: the bound of the GPT-2 flash-vs-plain step's q, k, v gradient parts
#: (TRAIN_QKV_GRAD_RTOL; 2.7e-2 on an H100 at llama-1b)
LLAMA_HEAD_GRAD_RTOL = {"dense": 1e-2, "plain": TRAIN_QKV_GRAD_RTOL}
#: the steps held against each other: name -> (LlamaConfig overrides,
#: the steps it is checked against)
LLAMA_STEPS = {"pallas": (dict(ce_impl="pallas"), ()),
               "dense": (dict(ce_impl="dense"), ("pallas",)),
               "plain": (dict(ce_impl="pallas", use_flash=False),
                         ("pallas",))}
LLAMA_WIDE_STEPS = {"dense": (dict(ce_impl="dense"), ()),
                    "pallas": (dict(ce_impl="pallas"), ("dense",))}


def llama_step_counts(cfg) -> dict:
    """Kernel launches of one llama loss and gradient: the flash forward
    twice a layer (remat recomputes the whole block), dQ and dK/dV once;
    none with plain attention; each fused-CE kernel once with
    ce_impl="pallas"."""
    L = cfg.n_layer if cfg.use_flash is not False else 0
    want = {"flash_fwd": 2 * L, "flash_bwd_dq": L, "flash_bwd_dkv": L}
    if cfg.ce_impl == "pallas":
        want.update(fused_ce_fwd=1, fused_ce_bwd_dh=1, fused_ce_bwd_dw=1)
    return want


def check_llama_steps(torch, fa, cfg, spec: dict, batch_rows: int,
                      seed: int, tag: str) -> tuple:
    """One loss and gradient of each ``spec`` entry on the same seeded
    llama weights and a batch of ``batch_rows`` x LLAMA_T tokens, each
    checked for its launches (llama_step_counts) and against its
    reference steps (compare_steps over the untied lm_head, tolerance
    LLAMA_HEAD_GRAD_RTOL); fails on any disagreement.  Returns (params,
    batch, {name: step})."""
    from ray_tpu_torch.models.llama import llama_init

    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = llama_init(cfg, gen, device="cuda")
    batch = {"tokens": torch.randint(0, cfg.vocab_size,
                                     (batch_rows, LLAMA_T + 1),
                                     generator=gen, device="cuda")}
    steps, bad = {}, []
    for name, (kw, refs) in spec.items():
        c = dataclasses.replace(cfg, **kw)
        st = one_step(torch, fa, params, batch, c)
        steps[name] = st
        want = llama_step_counts(c)
        line = (f"[{tag}] one step, d_model {c.d_model}, {c.n_layer} "
                f"layers, B={batch_rows} T={LLAMA_T}, ce {c.ce_impl}, "
                f"flash {c.use_flash is not False}: loss {st['loss']:.5f}, "
                f"grad norm {st['grad_norm']:.5f}, nonfinite "
                f"{st['nonfinite']}, peak memory {st['peak_gib']:.2f} GiB; "
                f"launches {st['counts']}")
        if st["counts"] != want:
            bad.append(f"{name}: launches {st['counts']}, expected {want}")
        if st["nonfinite"]:
            bad.append(f"{name}: {st['nonfinite']} nonfinite gradients")
        st["vs"] = {}
        for ref in refs:
            kind = "plain" if "plain" in (name, ref) else "dense"
            vs, text, ok = compare_steps(st, steps[ref], ref, None,
                                         LLAMA_HEAD_GRAD_RTOL[kind])
            st["vs"][ref] = vs
            line += text
            if not ok:
                bad.append(f"{name} disagrees with {ref}")
        print(line, flush=True)
    for st in steps.values():
        del st["head_grad"]
    if bad:
        fail("; ".join(bad))
    return params, batch, steps


def llama_main_path(torch, fa, cfg, card: str) -> dict:
    """The main path of phase train-llama: AdamW steps
    (``adamw(3e-4, weight_decay=0.1)``) of ``cfg`` at B=LLAMA_B,
    T=LLAMA_T on one repeated batch of seeded tokens through
    build_train_step, a warm-up step and LLAMA_TIMED_STEPS timed ones
    (host clock around synchronised steps, as time_config), the launch
    counters zeroed just before and read just after, the loss finite and
    falling, the peak memory."""
    from ray_tpu_torch.bench import H100_BF16_PEAK_FLOPS
    from ray_tpu_torch.models.llama import (llama_init, llama_loss,
                                            llama_param_count)
    from ray_tpu_torch.train import adamw, build_train_step

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = llama_init(cfg, gen, device="cuda")
    tx = adamw(3e-4, weight_decay=0.1)
    opt_state = tx.init(params)
    step = build_train_step(lambda p, b: llama_loss(p, b, cfg), tx,
                            telemetry=False)
    batch = {"tokens": torch.randint(0, cfg.vocab_size,
                                     (LLAMA_B, LLAMA_T + 1), generator=gen,
                                     device="cuda")}
    zero_counts(fa)
    params, opt_state, loss = step(params, opt_state, batch)
    losses = [loss]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(LLAMA_TIMED_STEPS):
        params, opt_state, loss = step(params, opt_state, batch)
        losses.append(loss)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = read_counts(fa)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = [float(x) for x in losses]
    runs = LLAMA_TIMED_STEPS + 1
    per_step = llama_step_counts(cfg)
    want = {k: n * runs for k, n in per_step.items()}
    n_params = llama_param_count(cfg)
    tok_s = LLAMA_B * LLAMA_T * LLAMA_TIMED_STEPS / dt
    mfu = 6 * n_params * tok_s / H100_BF16_PEAK_FLOPS
    print(f"[train-llama] {LLAMA_PRESET}, B={LLAMA_B} T={LLAMA_T}, remat "
          f"(whole block), ce {cfg.ce_impl}: {runs} steps launched {counts}"
          f" (expected {per_step} per step); losses "
          f"{[round(x, 4) for x in losses]}", flush=True)
    if counts != want:
        fail(f"kernel launches {counts} over {runs} steps, expected {want}")
    if not all(math.isfinite(x) for x in losses) or \
            not losses[-1] < losses[0]:
        fail(f"the loss is not finite and falling: {losses}")
    print(f"[train-llama] {LLAMA_TIMED_STEPS} timed steps: "
          f"{dt / LLAMA_TIMED_STEPS * 1e3:.2f} ms/step, {tok_s:.1f} "
          f"tokens/s, MFU {mfu:.4f} (6*N*tokens/s against 989 TFLOP/s, N = "
          f"{n_params} counting both embedding tables); peak memory "
          f"{peak_gib:.2f} GiB (max_memory_allocated) [{card}]", flush=True)
    del params, opt_state, step, batch
    torch.cuda.empty_cache()
    return {"counts": counts, "steps_run": runs,
            "step_ms": dt / LLAMA_TIMED_STEPS * 1e3, "tokens_per_s": tok_s,
            "mfu": mfu, "n_params": n_params, "losses": losses,
            "peak_gib": peak_gib}


def time_llama_ce(torch, fc, card: str, cfg) -> dict:
    """The fused-CE kernels at llama-1b's head (N = B*T = 16,384, V =
    valid = 32,000, D = 2048, bf16, g = 1/N; dH and dW through the
    cluster kernel): held against their plain versions, timed beside
    them, their bounds and the dense composition; dH and dW bit-equal
    across two launches; the backward's launch plan, CTAs, clusters that
    fit at once (cudaOccupancyMaxActiveClusters) and waves."""
    from ray_tpu_torch.models.gpt2 import _LogitsMatmul, nll_from_logits

    n, v, d = LLAMA_B * LLAMA_T, cfg.padded_vocab, cfg.d_model
    t = check_ce_kernels(torch, fc, n, v, cfg.vocab_size, d, "bf16",
                         seed=7, g=1.0 / n)
    h, w, tgt, g, lse = (t[k] for k in ("h", "w", "tgt", "g", "lse"))
    a, ab, valid = (h, w, tgt), (h, w, tgt, lse, g), cfg.vocab_size
    with torch.no_grad():
        ms = {"fwd": time_ms(torch, lambda: fc.fused_ce_fwd(*a, valid),
                             iters=5),
              "dh": time_ms(torch, lambda: fc.fused_ce_bwd_dh(*ab, valid),
                            iters=3),
              "dw": time_ms(torch, lambda: fc.fused_ce_bwd_dw(*ab, valid),
                            iters=3)}
        plain = {"fwd": time_ms(torch, lambda: fc.fused_ce_fwd_reference(
                     *a, valid), iters=1),
                 "dh": time_ms(torch, lambda: fc.fused_ce_bwd_dh_reference(
                     *ab, valid), iters=1),
                 "dw": time_ms(torch, lambda: fc.fused_ce_bwd_dw_reference(
                     *ab, valid), iters=1)}
        dense_fwd = time_ms(torch, lambda: nll_from_logits(
            _LogitsMatmul.apply(h, w), tgt, valid, v), iters=3)
    hg, wg = h.detach().requires_grad_(True), w.detach().requires_grad_(True)
    nll = nll_from_logits(_LogitsMatmul.apply(hg, wg), tgt, valid, v)
    dense_bwd = time_ms(torch, lambda: torch.autograd.grad(
        nll, (hg, wg), g, retain_graph=True), iters=3)
    del nll, hg, wg
    # the cluster kernel: each output element is summed in one fixed
    # order (the partials in rank order), so two launches give the same
    # bits
    with torch.no_grad():
        first, again = ((fc.fused_ce_bwd_dh(*ab, valid),
                         fc.fused_ce_bwd_dw(*ab, valid)) for _ in range(2))
        torch.cuda.synchronize()
        bit_equal = all(torch.equal(x, y) for x, y in zip(first, again))
        del first, again
    print(f"[train-llama]   dH and dW at llama-1b's head, two launches "
          f"bit-equal: {bit_equal}", flush=True)
    if not bit_equal:
        fail("the cluster dH/dW kernels gave different bits on the same "
             "inputs")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    launch = {}
    for k, rows in (("dh", n), ("dw", v)):
        plan = fc.fused_ce_bwd_plan(d, rows)
        ctas = math.prod(plan.grid)
        at_once = fc.fused_ce_bwd_max_clusters(d, k) * plan.k
        launch[k] = {"plan": plan._asdict(), "ctas": ctas,
                     "ctas_at_once": at_once, "waves": ctas / at_once}
        print(f"[train-llama]   {k} launch plan: {plan.kernel} kernel, "
              f"{plan.k} CTAs a cluster of {plan.c} boxes each, "
              f"{plan.slices} slice(s), grid {plan.grid}: {ctas} CTAs, "
              f"{at_once} at once on {sms} SMs (max active clusters "
              f"{at_once // plan.k}) = {ctas / at_once:.2f} waves [{card}]",
              flush=True)
    bounds = ce_bounds_ms(n, v, valid, d)
    out = {}
    for k, cmp_keys in (("fwd", ("nll", "lse")), ("dh", ("dh",)),
                        ("dw", ("dw",))):
        out[k] = {"shape": [n, v, valid, d],
                  "max_abs_err": max(t["cmp"][c]["max"] for c in cmp_keys),
                  "ms": ms[k], "plain_ms": plain[k],
                  "bound_ms": bounds[k][0], "bound_by": bounds[k][1],
                  "bound_share": bounds[k][0] / ms[k],
                  "library_ms": dense_fwd if k == "fwd" else None,
                  "dense_composition": {"forward_ms": dense_fwd,
                                        "backward_ms": dense_bwd},
                  **({"launch": launch[k], "bit_equal_relaunch": bit_equal}
                     if k in launch else {})}
        print(f"[train-llama]   {k:3s} at llama-1b's head (N={n} V={v} "
              f"D={d} bf16): kernel {ms[k]:.4f} ms, plain {plain[k]:.4f} "
              f"ms, bound {bounds[k][0]:.4f} ms ({bounds[k][1]}, "
              f"{100 * bounds[k][0] / ms[k]:.1f}% of it reached) [{card}]",
              flush=True)
    print(f"[train-llama]   dense composition at llama-1b's head: forward "
          f"{dense_fwd:.4f} ms, backward (dH and dW) {dense_bwd:.4f} ms; "
          f"fused dH + dW {ms['dh'] + ms['dw']:.4f} ms = "
          f"{(ms['dh'] + ms['dw']) / dense_bwd:.3f}x the dense backward "
          f"[{card}]", flush=True)
    return out


def time_llama_flash(torch, fa, card: str, cfg) -> dict:
    """The flash kernels at llama-1b's attention (B=8, H=32 query heads
    over the repeated KV heads, T=2048, D=64, causal, bf16): held
    against their plain versions (check_train_shape), timed beside them
    and their bounds, the forward and the whole backward against
    scaled_dot_product_attention's in turns."""
    return time_flash_shape(torch, fa, card, LLAMA_B, cfg.n_head, LLAMA_T,
                            cfg.head_dim, causal=True, seed=8,
                            shape_tag="llama-1b shape", tag="train-llama")


def time_flash_shape(torch, fa, card: str, b: int, h: int, T: int, d: int,
                     *, causal: bool, seed: int, shape_tag: str,
                     tag: str) -> dict:
    """time_llama_flash's work at any (B, H, T, D), causal or not:
    records of fwd, dq, dkv and the whole backward (ms, plain_ms,
    bound_ms, bound_by, bound_share, library_ms, max_abs_err)."""
    F = torch.nn.functional
    t = check_train_shape(torch, fa, seed=seed, b=b, h=h, T=T, d=d,
                          tag=shape_tag, causal=causal)
    q4, k4, v4, do4, q3, k3, v3, do3, o3, lse, delta = (
        t[n] for n in ("q4", "k4", "v4", "do4", "q3", "k3", "v3", "do3",
                       "o3", "lse", "delta"))
    kw = dict(scale=1.0 / math.sqrt(d), causal=causal)
    with torch.no_grad():
        ms = {"dq": time_ms(torch, lambda: fa.flash_bwd_dq(
                  q3, k3, v3, o3, do3, lse, **kw)),
              "dkv": time_ms(torch, lambda: fa.flash_bwd_dkv(
                  q3, k3, v3, do3, lse, delta, **kw))}
        plain = {"fwd": time_ms(torch, lambda: fa.
                                flash_attention_fwd_reference(q3, k3, v3,
                                                              **kw),
                                iters=1),
                 "whole": time_ms(torch, lambda: fa.
                                  flash_attention_bwd_reference(
                                      q3, k3, v3, o3, lse, do3, **kw),
                                  iters=1)}
        qh, kh, vh, doh = (x.transpose(1, 2).contiguous()
                           for x in (q4, k4, v4, do4))
        fwd_med, fwd_turns = in_turns(torch, {
            "port": lambda: fa.flash_attention_fwd(q3, k3, v3, **kw),
            "sdpa": lambda: F.scaled_dot_product_attention(
                qh, kh, vh, is_causal=causal)})
    qh, kh, vh = (x.requires_grad_(True) for x in (qh, kh, vh))
    out = F.scaled_dot_product_attention(qh, kh, vh, is_causal=causal)
    med, turns = in_turns(torch, {
        "port": lambda: fa.flash_attention_bwd(q3, k3, v3, o3, lse, do3,
                                               **kw),
        "sdpa": lambda: torch.autograd.grad(out, (qh, kh, vh), doh,
                                            retain_graph=True)})
    ms.update(fwd=fwd_med["port"], whole=med["port"])
    bh = b * h
    bounds = dict(bwd_bounds_ms(bh, T, d, causal, "bf16"),
                  fwd=attention_bound_ms(T, causal, "bf16", bh=bh, d=d))
    library = {"fwd": fwd_med["sdpa"], "whole": med["sdpa"]}
    recs = {}
    for k in ("fwd", "dq", "dkv", "whole"):
        recs[k] = {"shape": [b, h, T, d], "ms": ms[k],
                   "plain_ms": plain.get(k), "bound_ms": bounds[k][0],
                   "bound_by": bounds[k][1],
                   "bound_share": bounds[k][0] / ms[k],
                   "library_ms": library.get(k),
                   "max_abs_err": t["err"].get(k)}
        lib = (f", scaled_dot_product_attention {library[k]:.4f} ms "
               f"({ms[k] / library[k]:.3f}x, medians of {BWD_TURNS} "
               f"rounds in turns)" if k in library else "")
        pl = f", plain {plain[k]:.4f} ms" if k in plain else ""
        print(f"[{tag}]   flash {k:5s} at B={b} H={h} T={T} D={d}: "
              f"kernel {ms[k]:.4f} ms{pl}, bound {bounds[k][0]:.4f} ms "
              f"({bounds[k][1]}, {100 * bounds[k][0] / ms[k]:.1f}% of it "
              f"reached){lib} [{card}]", flush=True)
    recs["turns_ms"] = {"fwd": fwd_turns, "whole": turns}
    return recs


def phase_train_llama(torch, fa, fc, card: str) -> dict:
    from ray_tpu_torch.models.llama import llama_config

    cfg = llama_config(LLAMA_PRESET, ce_impl="pallas")
    # the main path: llama-1b AdamW steps through the flash and fused-CE
    # kernels
    result = llama_main_path(torch, fa, cfg, card)
    params, batch, steps = check_llama_steps(
        torch, fa, cfg, LLAMA_STEPS, LLAMA_B, seed=1, tag="train-llama")
    cfgs = {"dense": dataclasses.replace(cfg, ce_impl="dense"),
            "pallas": cfg}
    # the dense and pallas steps in turns (dense, pallas, pallas, dense)
    state, wall = interleaved_steps(torch, params, batch, cfgs,
                                    ["dense", "pallas", "pallas",
                                     "dense"] * 2)
    del params
    result["steps"] = steps
    report_medians(result, wall, "train-llama", card,
                   n_params=result["n_params"], tokens=LLAMA_B * LLAMA_T)
    # where one pallas step's device time goes (torch.profiler, CUPTI)
    result["profile"] = profile_step(torch, state, "pallas",
                                     result["pallas_step_ms"], card,
                                     "train-llama")
    del state
    torch.cuda.empty_cache()
    result["kernels"] = {"ce": time_llama_ce(torch, fc, card, cfg),
                         "flash": time_llama_flash(torch, fa, card, cfg)}
    torch.cuda.empty_cache()
    return result


def phase_llama_7b(torch, fa, fc, card: str) -> dict:
    """llama-7b's width at LLAMA_WIDE_LAYERS layers: one dense and one
    ce_impl="pallas" step at B=LLAMA_WIDE_B, T=LLAMA_T checked against
    each other (the flash kernels at D = 128, the cluster dH/dW kernel at
    D = 4096), the flash kernels and the fused-CE kernels against their
    plain versions at the shapes these steps give them, then one
    prefill, flash against plain attention."""
    from ray_tpu_torch.models.llama import llama_config
    from ray_tpu_torch.models.llama_decode import llama_prefill

    cfg = llama_config(LLAMA_WIDE_PRESET, n_layer=LLAMA_WIDE_LAYERS)
    params, batch, steps = check_llama_steps(
        torch, fa, cfg, LLAMA_WIDE_STEPS, LLAMA_WIDE_B, seed=9,
        tag="llama-7b")
    kernel_err = check_train_shape(torch, fa, seed=10, b=LLAMA_WIDE_B,
                                   h=cfg.n_head, T=LLAMA_T, d=cfg.head_dim,
                                   tag="llama-7b shape")["err"]
    # the fused-CE kernels at the pallas step's head (N = B*T, D = 4096:
    # dH and dW through clusters of 8 CTAs)
    n = LLAMA_WIDE_B * LLAMA_T
    t = check_ce_kernels(torch, fc, n, cfg.padded_vocab, cfg.vocab_size,
                         cfg.d_model, "bf16", seed=11, g=1.0 / n)
    ce_err = {k: {"shape": [n, cfg.padded_vocab, cfg.vocab_size,
                            cfg.d_model], **t["cmp"][k]}
              for k in ("nll", "lse", "dh", "dw")}
    del t
    toks = batch["tokens"][:, :LLAMA_T].to(torch.int32)
    with torch.inference_mode():
        fa.FLASH_FWD_LAUNCHES = 0
        llama_prefill(params, toks, cfg)
        launches = fa.FLASH_FWD_LAUNCHES
        print(f"[llama-7b] prefill B={LLAMA_WIDE_B} T={LLAMA_T} (head_dim "
              f"{cfg.head_dim}): {launches} flash kernel launches",
              flush=True)
        if launches != cfg.n_layer:
            fail(f"the llama-7b-width prefill launched the flash forward "
                 f"{launches} times, expected {cfg.n_layer}")
        prefill_check = check_prefill_flash(torch, llama_prefill, params,
                                            toks, cfg, LLAMA_LOGIT_TOL,
                                            "llama-7b")
    del params, batch
    torch.cuda.empty_cache()
    return {"steps": steps, "kernels_vs_plain": kernel_err,
            "ce_kernels_vs_plain": ce_err,
            "prefill_flash_vs_plain": prefill_check}


# phase train-telemetry: the train step's telemetry on llama-1b.  The
# instrumented step (a) takes a warm-up and TT_STEPS more steps, with a
# checkpoint (b) after step TT_SAVE_AT; (d) runs TT_TURNS raw and
# TT_TURNS instrumented steps in turns; (e) one accumulated step of
# TT_MICRO microbatches against the plain step, in bf16 at full depth
# and in f32 at TT_F32_LAYERS layers; (c) plants a NaN and restores.
TT_NAME, TT_STEPS, TT_SAVE_AT, TT_TURNS, TT_MICRO = "smoke_llama", 6, 3, 4, 2
#: (e): the accumulated step's loss against the plain step's, relative:
#: bf16 activations, the microbatches' rows in other matmul shapes
TT_ACCUM_RTOL = 2e-3
#: (e) in f32: the loss (relative) and the first moments, 0.1 x the
#: gradient, relative to each leaf's largest: the sum of B*T = 16,384
#: f32 terms in another order, ~sqrt(16384) * 2**-24 = 7.6e-6 of the
#: terms' size, more where they cancel
TT_F32_LAYERS, TT_F32_LOSS_RTOL, TT_F32_GRAD_RTOL = 2, 1e-5, 1e-4
#: (e) the updated parameters: AdamW's first update is lr * (g / (|g| +
#: eps) + wd * p), whose change under a gradient change dg is at most
#: lr * eps * |dg| / (m + eps)**2 (m: the least |g| between the two
#: gradients, 0 across a sign change): each element is held to that
#: bound from its two gradients, plus TT_F32_PARAM_ATOL for rounding
TT_F32_PARAM_ATOL = 1e-6


def _all_counts(fa) -> dict:
    fc = _fc()
    return {**{c: getattr(fa, c) for c in COUNTERS},
            **{c: getattr(fc, c) for c in CE_COUNTERS}}


def uncounted(fa, fn):
    """fn() with the launch counters put back as they were after it:
    a probe or a reference beside the main path is not the path."""
    saved = _all_counts(fa)
    try:
        return fn()
    finally:
        fc = _fc()
        for c, v in saved.items():
            setattr(fa if c in COUNTERS else fc, c, v)


#: the warning torch.cuda.set_sync_debug_mode("warn") gives for each
#: synchronising call (its first use also warns that the mode is a
#: prototype, which is not a sync)
SYNC_WARNING = "called a synchronizing CUDA operation"


class _SyncCount:
    """Counts the synchronising CUDA calls made inside it (warned under
    torch.cuda.set_sync_debug_mode); counts nothing off the card."""

    def __init__(self, torch, on_card: bool):
        self.torch, self.on_card, self.n = torch, on_card, 0

    def __enter__(self):
        import warnings

        self._catch = warnings.catch_warnings(record=True)
        self._caught = self._catch.__enter__()
        warnings.simplefilter("always")
        if self.on_card:
            self.torch.cuda.set_sync_debug_mode("warn")
        return self

    def __exit__(self, *exc):
        if self.on_card:
            self.torch.cuda.set_sync_debug_mode(0)
        self.n += sum(SYNC_WARNING in str(w.message) for w in self._caught)
        self._catch.__exit__(*exc)
        return False


def legs_sum(rec: dict) -> bool:
    from ray_tpu_torch.train.goodput import ANATOMY_COMPONENTS

    total = sum(rec[c] for c in ANATOMY_COMPONENTS)
    return abs(total - rec["step_wall_ms"]) <= 1e-9 * max(
        1.0, rec["step_wall_ms"])


def phase_train_telemetry(torch, np, fa, card: str, preset=LLAMA_PRESET,
                          device="cuda", rows=LLAMA_B, seq=LLAMA_T,
                          watch=None) -> dict:
    """Phase train-telemetry (module docstring, phase 14).  ``preset``,
    ``device``, ``rows``, ``seq`` and ``watch`` (train_watch's keywords)
    cut it down for a dry run on the CPU, where nothing launches and no
    sync is counted."""
    import os
    import tempfile

    from ray_tpu_torch._private.device_stats import get_registry
    from ray_tpu_torch.bench import train_watch
    from ray_tpu_torch.models.llama import (llama_config, llama_init,
                                            llama_loss)
    from ray_tpu_torch.tools.flightrec import load_dump, report_lines
    from ray_tpu_torch.train import (accumulated_train_step, adamw,
                                     build_train_step, get_goodput_tracker,
                                     restore_sharded, save_sharded,
                                     train_stats, watch_data)
    from ray_tpu_torch.train.checkpointing import _tree_bytes
    from ray_tpu_torch.train.goodput import dominant_component
    from ray_tpu_torch.train.trainer import instrument_step

    t_phase = time.perf_counter()
    dev = torch.device(device)
    on_card = dev.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def empty():
        if on_card:
            torch.cuda.empty_cache()

    tag = "[train-telemetry]"
    cfg = llama_config(preset, ce_impl="pallas")
    tx = adamw(3e-4, weight_decay=0.1)
    loss_fn = lambda p, b, c=cfg: llama_loss(p, b, c)  # noqa: E731
    empty()
    gen = torch.Generator(device=dev).manual_seed(0)
    params = llama_init(cfg, gen, device=dev)
    opt_state = tx.init(params)
    step = build_train_step(loss_fn, tx, health=True, telemetry_name=TT_NAME)
    tracker = get_goodput_tracker(TT_NAME)
    rng = np.random.RandomState(0)

    def fresh_batches():
        while True:
            yield {"tokens": rng.randint(0, cfg.vocab_size,
                                         size=(rows, seq + 1)).astype(
                                             np.int32)}

    it = watch_data(fresh_batches(), trainer=TT_NAME)

    def next_batch():
        data = next(it)
        t0 = time.perf_counter()
        data = {"tokens": torch.from_numpy(data["tokens"]).to(dev)}
        tracker.note_h2d(time.perf_counter() - t0)
        return data

    fixed = {"tokens": torch.from_numpy(np.random.RandomState(1).randint(
        0, cfg.vocab_size, size=(rows, seq + 1)).astype(np.int32)).to(dev)}

    def probe(p):
        """The loss of ``p`` on the fixed batch, no gradient."""
        def run():
            with torch.no_grad():
                out = llama_loss(p, fixed, cfg).clone()
            sync()
            return out
        return uncounted(fa, run)

    ckpt_dir = tempfile.mkdtemp(prefix="smoke_ckpt_")
    reg0 = get_registry().snapshot().get("train.step", {})

    # (a) the instrumented step with the health watchdog, fed by
    # watch_data, (b) with a save after step TT_SAVE_AT
    zero_counts(fa)
    losses, walls = [], []
    for i in range(1 + TT_STEPS):
        data = next_batch()
        t0 = time.perf_counter()
        params, opt_state, loss, _health = step(params, opt_state, data)
        walls.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss)
        if i == TT_SAVE_AT:
            t0 = time.perf_counter()
            save_sharded(params, ckpt_dir, step=i, trainer=TT_NAME)
            save_s = time.perf_counter() - t0
            probe_saved = probe(params)
    sync()
    counts = read_counts(fa)
    losses = [float(x) for x in losses]
    st = train_stats(TT_NAME)
    reg = get_registry().snapshot()["train.step"]
    reg_delta = {k: reg[k] - reg0.get(k, 0)
                 for k in ("compile_events", "invokes")}
    steps_raw = tracker.last_steps()
    runs = 1 + TT_STEPS
    per_step = llama_step_counts(cfg)
    want = ({k: n * runs for k, n in per_step.items()} if on_card else
            {k: 0 for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")})
    nbytes = _tree_bytes(params)
    ck = st["checkpoint"]
    ratio = st["goodput"]["ratio"]
    dom = dominant_component(st["anatomy"])
    means = {k: st["anatomy"][k]["mean"] for k in st["anatomy"]}
    print(f"{tag} (a) {preset}, B={rows} T={seq}, health on, fed by "
          f"watch_data: {runs} steps launched {counts} (expected "
          f"{per_step if on_card else 'none'} per step); losses "
          f"{[round(x, 4) for x in losses]}; step walls (fenced) "
          f"{[round(w, 2) for w in walls]} ms [{card}]", flush=True)
    print(f"{tag} (a) train_stats: steps {st['steps']}, compiles "
          f"{st['compiles']}, health observed {st['health']['observed']}, "
          f"anomalies {st['health']['anomalies']}; registry train.step "
          f"{reg_delta}; goodput ratio {ratio} ({st['goodput']}); dominant "
          f"component {dom}; anatomy means (ms) {means} [{card}]",
          flush=True)
    bad = []
    if counts != want:
        bad.append(f"launches {counts}, expected {want}")
    if (st["steps"], st["compiles"], st["health"]["observed"],
            st["health"]["anomalies"]) != (runs, 1, runs, 0):
        bad.append(f"train_stats steps {st['steps']}, compiles "
                   f"{st['compiles']}, observed "
                   f"{st['health']['observed']}, anomalies "
                   f"{st['health']['anomalies']}")
    if reg_delta != {"compile_events": 1, "invokes": TT_STEPS}:
        bad.append(f"registry train.step {reg_delta}")
    if len(steps_raw) != runs or not all(legs_sum(r) for r in steps_raw):
        bad.append(f"anatomy legs do not sum to the wall: {steps_raw}")
    if not all(math.isfinite(x) for x in losses):
        bad.append(f"losses {losses}")
    # (b) the checkpoint
    after_save = steps_raw[TT_SAVE_AT + 1]["checkpoint_ms"]
    print(f"{tag} (b) save_sharded of the params after step {TT_SAVE_AT}: "
          f"{nbytes / 1e9:.3f} GB in {save_s * 1e3:.1f} ms "
          f"({nbytes / save_s / 1e9:.3f} GB/s, device to host and "
          f"torch.save to the file's close); step {TT_SAVE_AT + 1}'s "
          f"checkpoint leg {after_save:.1f} ms; block {ck} [{card}]",
          flush=True)
    if not after_save > 0 or ck["saves"] != 1 or \
            ck["bytes_written"] != nbytes or ck["last_step"] != TT_SAVE_AT:
        bad.append(f"checkpoint: leg {after_save}, block {ck}, tree bytes "
                   f"{nbytes}")
    if bad:
        fail("train-telemetry (a)/(b): " + "; ".join(bad))

    # (d) no added sync: raw and instrumented (health off) steps in
    # turns.  The instrumented one is build_train_step's own stack
    # (instrument_step) over a timed raw step, so the wrappers' own
    # host time is the outer call less the inner one
    raw = build_train_step(loss_fn, tx, telemetry=False)
    inner = []

    def timed(*args):
        t0 = time.perf_counter()
        out = raw(*args)
        inner.append(time.perf_counter() - t0)
        return out

    tel = instrument_step(timed, TT_NAME + "_nosync")
    for s in (raw, tel):      # each one's first call
        params, opt_state = s(params, opt_state, fixed)[:2]
    sync()
    ms = {"raw": [], "telemetry": []}
    syncs = {"raw": _SyncCount(torch, on_card),
             "telemetry": _SyncCount(torch, on_card)}
    own_s = wall_s = 0.0
    for k in range(TT_TURNS):
        for kind in (("raw", "telemetry") if k % 2 == 0
                     else ("telemetry", "raw")):
            t0 = time.perf_counter()
            with syncs[kind]:
                params, opt_state = (raw if kind == "raw" else tel)(
                    params, opt_state, fixed)[:2]
            call = time.perf_counter() - t0
            sync()
            wall = time.perf_counter() - t0
            ms[kind].append(wall * 1e3)
            if kind == "telemetry":
                own_s += call - inner[-1]
                wall_s += wall
    share = own_s / wall_s
    n_sync = {k: v.n for k, v in syncs.items()}
    print(f"{tag} (d) {TT_TURNS} raw and {TT_TURNS} instrumented "
          f"(telemetry=True, health=False) steps in turns, ms: raw "
          f"{[round(x, 2) for x in ms['raw']]}, instrumented "
          f"{[round(x, 2) for x in ms['telemetry']]}; medians "
          f"{_median(ms['raw']):.2f} / {_median(ms['telemetry']):.2f}; "
          f"the wrappers' own host time {own_s * 1e3:.3f} ms = "
          f"{100 * share:.4f}% of the instrumented steps' wall; "
          f"synchronising calls raw {n_sync['raw']}, instrumented "
          f"{n_sync['telemetry']} [{card}]", flush=True)
    if n_sync["raw"] != n_sync["telemetry"]:
        fail(f"train-telemetry (d): the telemetry wrappers added "
             f"synchronising calls: {n_sync}")

    # (e) the accumulated step against the plain step
    acc = accumulated_train_step(loss_fn, tx, num_microbatches=TT_MICRO,
                                 telemetry=True,
                                 telemetry_name=TT_NAME + "_accum")
    plain = build_train_step(loss_fn, tx, donate=False, telemetry=False)
    sync()
    zero_counts(fa)
    acc_loss = float(acc(params, opt_state, fixed)[2])
    acc_counts = read_counts(fa)
    plain_loss = uncounted(fa, lambda: float(
        plain(params, opt_state, fixed)[2]))
    empty()
    acc_want = ({k: n * TT_MICRO for k, n in per_step.items()} if on_card
                else {k: 0 for k in want})
    rel = abs(acc_loss - plain_loss) / abs(plain_loss)
    acc_st = train_stats(TT_NAME + "_accum")
    print(f"{tag} (e) accumulated step, {TT_MICRO} microbatches of "
          f"{rows // TT_MICRO}: launches {acc_counts} (expected "
          f"{acc_want}); loss {acc_loss:.6f} vs the plain step's "
          f"{plain_loss:.6f} (rel {rel:.3e}, tol {TT_ACCUM_RTOL}); "
          f"train_stats steps {acc_st['steps']}, compiles "
          f"{acc_st['compiles']}", flush=True)
    if acc_counts != acc_want or rel > TT_ACCUM_RTOL or \
            (acc_st["steps"], acc_st["compiles"]) != (1, 1):
        fail("train-telemetry (e): the accumulated step disagrees")
    f32 = check_accum_f32(torch, fa, preset, dev, rows, seq, tx)

    # (c) a NaN in the final norm's scale: the next step dumps within
    # the step; then the checkpoint of (b) comes back
    fr_dir = tempfile.mkdtemp(prefix="smoke_flightrec_")
    old_dir = os.environ.get("RAYTPU_FLIGHTREC_DIR")
    os.environ["RAYTPU_FLIGHTREC_DIR"] = fr_dir
    try:
        with torch.no_grad():
            params["ln_f"]["scale"][0] = float("nan")
        data = next_batch()
        n0 = len(step.watchdog.dumps)
        params, opt_state, loss, _ = step(params, opt_state, data)
        dumps = step.watchdog.dumps[n0:]
    finally:
        if old_dir is None:
            del os.environ["RAYTPU_FLIGHTREC_DIR"]
        else:
            os.environ["RAYTPU_FLIGHTREC_DIR"] = old_dir
    if len(dumps) != 1 or not dumps[0].startswith(fr_dir):
        fail(f"train-telemetry (c): the NaN step left dumps {dumps}")
    doc = load_dump(dumps[0])
    ctx = doc["context"]
    sig = str(((tuple(data["tokens"].shape), "int32"),))
    lines = report_lines(doc)
    print(f"{tag} (c) NaN planted in ln_f.scale[0]: dump within the step "
          f"{os.path.basename(dumps[0])}, reason {doc['reason']}, context "
          f"trainer {ctx['trainer']} step {ctx['step']} signature "
          f"{ctx['signature']}; the CLI's report:", flush=True)
    for line in lines:
        print(f"{tag}     {line}", flush=True)
    if (ctx["trainer"], ctx["step"], ctx["reason"], ctx["signature"]) != \
            (TT_NAME, runs, "nonfinite_loss", sig) or \
            not any("train anomalies" in x for x in lines):
        fail(f"train-telemetry (c): the dump names {ctx}")
    del params, opt_state, loss
    empty()
    t0 = time.perf_counter()
    params = restore_sharded(ckpt_dir, step=TT_SAVE_AT, trainer=TT_NAME,
                             device=dev)
    restore_s = time.perf_counter() - t0
    probe_back = probe(params)
    ck = train_stats(TT_NAME)["checkpoint"]
    same = torch.equal(probe_back, probe_saved)
    print(f"{tag} (c) restore_sharded(step={TT_SAVE_AT}): "
          f"{restore_s * 1e3:.1f} ms ({nbytes / restore_s / 1e9:.3f} GB/s,"
          f" file to the device); probe loss {float(probe_back):.6f}, "
          f"bitwise equal to the one after the save: {same}; block {ck} "
          f"[{card}]", flush=True)
    if not same or ck["restores"] != 1 or ck["bytes_read"] != nbytes:
        fail("train-telemetry (c): the restore is not the save")
    del params
    empty()

    # (f) bench.py --train's configuration (GPT-2-124M, B=8, T=1024, 20
    # + 1 steps, health on)
    records = train_watch(**(watch or {}))
    for rec in records:
        print(f"{tag} (f) {json.dumps(rec)} [{card}]", flush=True)
    good = records[0]
    if not (good["value"] and 0 < good["value"] <= 1) or \
            good["detail"]["anomalies"] or \
            good["detail"]["steps"] != (watch or {}).get("n_steps", 20) + 1:
        fail(f"train-telemetry (f): {good}")
    empty()
    took = time.perf_counter() - t_phase
    print(f"{tag} phase took {took:.1f} s", flush=True)
    return {"counts": counts, "steps_run": runs, "goodput": st["goodput"],
            "dominant": dom, "walls_ms": walls, "save_s": save_s,
            "restore_s": restore_s, "ckpt_bytes": nbytes,
            "turns_ms": ms, "syncs": n_sync, "host_share": share,
            "accum": {"loss": acc_loss, "plain": plain_loss, "rel": rel,
                      "counts": acc_counts, "f32": f32},
            "train_watch": records, "seconds": took}


def _median(xs):
    return sorted(xs)[len(xs) // 2]


def check_accum_f32(torch, fa, preset, dev, rows, seq, tx) -> dict:
    """(e) in f32 at TT_F32_LAYERS layers of ``preset``'s width: one
    accumulated step (TT_MICRO microbatches) and one plain step from
    the same weights and batch; the losses and the updated parameters
    must agree (TT_F32_LOSS_RTOL, TT_F32_PARAM_ATOL)."""
    from ray_tpu_torch.models.llama import (llama_config, llama_init,
                                            llama_loss)
    from ray_tpu_torch.train import accumulated_train_step, build_train_step
    from ray_tpu_torch.train.optim import tree_leaves

    cfg = llama_config(preset, ce_impl="pallas", n_layer=TT_F32_LAYERS,
                       dtype=torch.float32)
    gen = torch.Generator(device=dev).manual_seed(3)
    params = llama_init(cfg, gen, device=dev)
    state = tx.init(params)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (rows, seq + 1),
                                     generator=gen, device=dev)}
    loss_fn = lambda p, b: llama_loss(p, b, cfg)  # noqa: E731

    def run():
        a = accumulated_train_step(loss_fn, tx, num_microbatches=TT_MICRO)(
            params, state, batch)
        p = build_train_step(loss_fn, tx, donate=False, telemetry=False)(
            params, state, batch)
        return a, p

    (pa, sa, la), (pp, sp, lp) = uncounted(fa, run)
    rel = abs(float(la) - float(lp)) / abs(float(lp))
    grad_rel = max(float((x - y).abs().max() / y.abs().max()) for x, y in
                   zip(tree_leaves(sa["mu"]), tree_leaves(sp["mu"])))
    diff, over, tight = 0.0, -math.inf, 0.0
    for xa, xp, ma, mp in zip(tree_leaves(pa), tree_leaves(pp),
                              tree_leaves(sa["mu"]), tree_leaves(sp["mu"])):
        ga, gp = ma / (1 - tx.b1), mp / (1 - tx.b1)
        m = torch.where(ga.sign() == gp.sign(),
                        torch.minimum(ga.abs(), gp.abs()), 0.0)
        sens = tx.learning_rate * tx.eps * (ga - gp).abs() / (m + tx.eps) ** 2
        d = (xa - xp).abs()
        diff = max(diff, float(d.max()))
        over = max(over, float((d - sens - TT_F32_PARAM_ATOL).max()))
        tight = max(tight, float(d[sens < TT_F32_PARAM_ATOL / 10].max()))
    update = max(float((x - y).abs().max()) for x, y in
                 zip(tree_leaves(pp), tree_leaves(params)))
    print(f"[train-telemetry] (e) f32, {cfg.n_layer} layers at d_model "
          f"{cfg.d_model}, B={rows} T={seq}: accumulated loss "
          f"{float(la):.7f} vs plain {float(lp):.7f} (rel {rel:.3e}, tol "
          f"{TT_F32_LOSS_RTOL}); first moments max |diff| / max |m| "
          f"{grad_rel:.3e} (tol {TT_F32_GRAD_RTOL}); updated params max "
          f"|diff| {diff:.3e} over all, {tight:.3e} where AdamW's "
          f"sensitivity bound is under {TT_F32_PARAM_ATOL / 10:g}, the "
          f"largest excess over the bound + {TT_F32_PARAM_ATOL:g} "
          f"{over:.3e} (must be <= 0), against a largest update of "
          f"{update:.3e}", flush=True)
    if rel > TT_F32_LOSS_RTOL or grad_rel > TT_F32_GRAD_RTOL or over > 0:
        fail("train-telemetry (e): the f32 accumulated step disagrees with "
             "the plain step")
    del pa, pp, sa, sp, params, state
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return {"loss_rel": rel, "grad_rel": grad_rel, "param_max_abs": diff,
            "param_max_abs_insensitive": tight, "over_bound": over,
            "max_update": update}


# phase serve-continuous: llama-1b through the continuous scheduler.
# The request set P: CONT_N requests, half of them a CONT_PREFIX-token
# shared prefix (16 blocks of 16) plus a tail of 16-128 tokens, half cold
# with 64-384 tokens, lengths from a seeded RandomState
# (continuous_prompts); CONT_WAVE1 of them first, the rest once the
# first reply is back.
CONT_N, CONT_WAVE1, CONT_PREFIX = 16, 12, 256
CONT_MAX_NEW, CONT_BUCKET, CONT_BLOCK = 24, 64, 16
#: the f32 gate's engines: 4 slots; paged pools of CONT_F32_BLOCKS blocks
#: hold at most two of the longest requests (26 blocks each), so
#: admission requeues and the LRU evicts.  A pool must hold one full
#: sequence (BlockPager), so the gate cuts the cache to CONT_MAX_SEQ
#: positions (llama-1b's 2048 would need 129 blocks); every prompt and
#: its continuation fits far below it
CONT_SLOTS, CONT_F32_BLOCKS, CONT_MAX_SEQ, CONT_CHUNK = 4, 65, 1024, 128
#: a greedy token may part from the oracle's only at a near-tie: where
#: the oracle's own f32 logits of the two tokens lie within this
#: fraction of the row's max |logit| (the engines' bucket-padded and
#: paged prefills sum in other orders than the solo prefill)
CONT_NEAR_TIE = 1e-4
#: the bf16 timing: requests drawn as P, all submitted at once, through
#: CONT_TIMED_SLOTS slots (default pool, max_seq 2048) and through the
#: batch scheduler (max_batch_size the same), in turns
CONT_TIMED_N, CONT_TIMED_SLOTS, CONT_TURNS = 32, 8, 2


def continuous_prompts(np, vocab: int, n: int, seed: int) -> list:
    """P, in order: a quarter of the shared-prefix prompts, the cold
    half, then the other shared quarter — the prefix comes back after
    a burst of cold traffic has pushed it down the LRU.  The lengths
    are drawn first, so they (and with them the pager's counts) do not
    depend on the vocabulary."""
    rs = np.random.RandomState(seed)
    tails = rs.randint(16, 129, n // 2)
    colds = rs.randint(64, 385, n // 2)
    prefix = rs.randint(0, vocab, CONT_PREFIX)
    shared = [np.concatenate([prefix, rs.randint(0, vocab, t)]).astype(
        np.int32) for t in tails]
    cold = [rs.randint(0, vocab, c).astype(np.int32) for c in colds]
    return shared[:n // 4] + cold + shared[n // 4:]


async def _serve_waves(engine, prompts, wave1: int) -> tuple:
    """prompts[:wave1] at once, the rest once the first reply is back:
    (replies, seconds from each request's submission to its reply).
    A request that raises fails the run."""
    sent, done = {}, {}

    async def one(i):
        sent[i] = time.perf_counter()
        out = await engine(prompts[i])
        done[i] = time.perf_counter()
        return out

    try:
        first = [asyncio.ensure_future(one(i)) for i in range(wave1)]
        rest = []
        if wave1 < len(prompts):
            await asyncio.wait(first, return_when=asyncio.FIRST_COMPLETED)
            rest = [asyncio.ensure_future(one(i))
                    for i in range(wave1, len(prompts))]
        outs = await asyncio.gather(*first, *rest)
    finally:
        if hasattr(engine, "shutdown_engine"):
            engine.shutdown_engine()
    return outs, [done[i] - sent[i] for i in range(len(prompts))]


def check_replies(np, prompts, outs, max_new: int, vocab: int,
                  tag: str) -> None:
    for p, o in zip(prompts, outs):
        if o.shape != (len(p) + max_new,) or \
                not np.array_equal(o[:len(p)], p):
            fail(f"[{tag}] reply of shape {o.shape} does not extend its "
                 f"{len(p)}-token prompt by {max_new} tokens")
        if o.min() < 0 or o.max() >= vocab:
            fail(f"[{tag}] reply holds a token outside the vocabulary")


def oracle_logits(torch, params, cfg, prompt, tokens):
    """The solo dense f32 generation's own logits row at each of its
    steps (its prefill, then decode steps fed its own tokens): the loop
    of decode_common.generate_with, replayed."""
    from ray_tpu_torch.models import llama_decode as m

    toks = torch.from_numpy(prompt)[None].to(params["wte"].device)
    logits, cache = m.llama_prefill(params, toks, cfg)
    rows = [logits[0]]
    for t in tokens[:-1]:
        tok = torch.tensor([int(t)], dtype=torch.int32, device=toks.device)
        logits, cache = m.llama_decode_step(params, cache, tok, cfg)
        rows.append(logits[0])
    return torch.stack(rows)


def gate_against_oracle(torch, np, params, cfg, prompts, outs, oracle,
                        tag: str, phase: str = "serve-continuous") -> list:
    """Each reply token for token equal to the oracle's, or parted at
    a near-tie of the oracle's own logits (printed).  Returns the
    near-ties."""
    ties = []
    for i, (p, o) in enumerate(zip(prompts, outs)):
        want = oracle[i][len(p):]
        got = o[len(p):]
        diff = np.nonzero(got != want)[0]
        if not diff.size:
            continue
        j = int(diff[0])
        row = oracle_logits(torch, params, cfg, p, want)[j]
        a, b = int(want[j]), int(got[j])
        gap = abs(row[a] - row[b]).item()
        scale = row.abs().max().item()
        print(f"[{phase}] {tag} request {i}: token {j} is {b}, "
              f"the oracle's {a}; oracle logits {row[a].item():.6f} vs "
              f"{row[b].item():.6f}, gap {gap:.3e} (near-tie bound "
              f"{CONT_NEAR_TIE * scale:.3e} = {CONT_NEAR_TIE} x max|logit| "
              f"{scale:.3f})", flush=True)
        if gap > CONT_NEAR_TIE * scale:
            fail(f"[{phase}] {tag} request {i} parts from the "
                 f"solo dense oracle at token {j} beyond a near-tie")
        ties.append({"engine": tag, "request": i, "token": j,
                     "gap": gap, "bound": CONT_NEAR_TIE * scale})
    return ties


def _pcts(xs) -> dict:
    s = sorted(xs)
    return {"p50_ms": s[len(s) // 2] * 1e3,
            "p95_ms": s[min(len(s) - 1, round(0.95 * (len(s) - 1)))] * 1e3}


def engine_clock(stats: dict) -> dict:
    """What an engine's own telemetry (engine_stats()) reads: TTFT and
    inter-token (one decode step or spec round) p50/p95 in ms, decode
    tokens/s over its step window, slot utilization."""
    return {"ttft_p50_ms": stats["ttft_ms"]["p50"],
            "ttft_p95_ms": stats["ttft_ms"]["p95"],
            "itl_p50_ms": stats["inter_token_ms"]["p50"],
            "itl_p95_ms": stats["inter_token_ms"]["p95"],
            "tokens_per_sec": stats["tokens_per_sec"],
            "slot_utilization": stats["slot_utilization"]}


def engine_clock_line(stats: dict) -> str:
    c = engine_clock(stats)
    return (f"engine telemetry: TTFT p50 {c['ttft_p50_ms']} ms, p95 "
            f"{c['ttft_p95_ms']} ms; inter-token p50 {c['itl_p50_ms']} ms, "
            f"p95 {c['itl_p95_ms']} ms; {c['tokens_per_sec']} decode "
            f"tokens/s; slot utilization {c['slot_utilization']}")


def phase_serve_continuous(torch, np, fa, card: str, preset="llama-1b",
                           device="cuda", widths=None) -> dict:
    """The continuous scheduler on llama-1b: the f32 correctness gate
    (P through a dense engine and three paged ones: a pool that
    requeues and evicts, the same with chunked prefill, the same with a
    host KV tier), each request held against the solo dense f32
    llama_generate of its prompt; then bf16 timing against the batch
    scheduler.  ``widths`` (config overrides) and ``device`` let the
    phase run cut down elsewhere; the smoke run leaves them.  Returns
    the kernel launches of the engine runs (none expected: the path
    runs plain PyTorch) and the numbers."""
    from ray_tpu_torch.models.llama_decode import llama_generate
    from ray_tpu_torch.serve import build_llm_deployment

    dev = torch.device(device)
    widths = dict(widths or {})

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    launches = {}

    def drive(engine, prompts, wave1):
        zero_counts(fa)
        out = asyncio.run(_serve_waves(engine, prompts, wave1))
        sync()
        for k, v in read_counts(fa).items():
            launches[k] = launches.get(k, 0) + v
        return out

    common = dict(scheduler="continuous", max_new_tokens=CONT_MAX_NEW,
                  prefill_bucket=CONT_BUCKET, seed=0, device=dev)
    f32 = dict(widths, dtype=torch.float32, max_seq=CONT_MAX_SEQ)
    paged = dict(kv_layout="paged", kv_block_size=CONT_BLOCK,
                 kv_num_blocks=CONT_F32_BLOCKS)
    engines = {"a dense": dict(kv_layout="dense"),
               "b paged": paged,
               "c paged+chunk": dict(paged,
                                     prefill_chunk_tokens=CONT_CHUNK),
               "d paged+tier": dict(paged, kv_host_tier_bytes=None)}
    ties, kv = [], {}
    oracle = params = cfg = prompts = None
    for tag, kw in engines.items():
        if tag.startswith("d"):
            # room for every block the pool could ever evict here: all
            # of P's prompt blocks, at the pool's bytes per block
            per_block = kv["b paged"]["kv_cache"]["pool_bytes"] \
                // CONT_F32_BLOCKS
            kw["kv_host_tier_bytes"] = per_block * sum(
                len(p) // CONT_BLOCK for p in prompts)
        engine = build_llm_deployment(
            "llama", preset, max_slots=CONT_SLOTS, config_overrides=f32,
            **common, **kw).func_or_class()
        if oracle is None:
            cfg, params = engine.cfg, engine.params
            prompts = continuous_prompts(np, cfg.vocab_size, CONT_N, seed=5)
            t0 = time.perf_counter()
            with torch.inference_mode():
                oracle = [llama_generate(
                    params, torch.from_numpy(p)[None].to(dev), cfg,
                    max_new_tokens=CONT_MAX_NEW, temperature=0.0)[0]
                    .cpu().numpy() for p in prompts]
            print(f"[serve-continuous] llama {preset} f32 (max_seq "
                  f"{cfg.max_seq}): {CONT_N} prompts of "
                  f"{min(map(len, prompts))}-{max(map(len, prompts))} "
                  f"tokens ({CONT_N // 2} sharing a {CONT_PREFIX}-token "
                  f"prefix), +{CONT_MAX_NEW}; solo dense oracle in "
                  f"{time.perf_counter() - t0:.2f} s", flush=True)
        t0 = time.perf_counter()
        outs, _ = drive(engine, prompts, CONT_WAVE1)
        wall = time.perf_counter() - t0
        check_replies(np, prompts, outs, CONT_MAX_NEW, cfg.vocab_size, tag)
        ties += gate_against_oracle(torch, np, params, cfg, prompts, outs,
                                    oracle, tag)
        kv[tag] = stats = engine.kv_stats()
        est = engine.engine_stats()
        programs = est["programs"]           # phase observatory (c)
        line = (f"[serve-continuous] f32 engine ({tag}): {CONT_N} "
                f"requests in {wall:.2f} s, all equal to the oracle or "
                f"parted at a near-tie; {engine_clock_line(est)}")
        if stats["kv_cache"] is not None:
            c, t = stats["kv_cache"], stats["kv_tier"]
            line += (f"; blocks in use after {c['blocks_in_use']}, prefix "
                     f"block hits {c['prefix_block_hits']} (rate "
                     f"{c['prefix_hit_rate']}), evictions {c['evictions']}"
                     f", requeues {stats['requeues']}, cow copies "
                     f"{c['cow_copies']}, partial fills "
                     f"{c['partial_fills']}; tier saves {t['saves']}, "
                     f"hits {t['hits']}, tokens restored "
                     f"{t['tokens_restored']}")
            if c["blocks_in_use"]:
                fail(f"[serve-continuous] {tag}: {c['blocks_in_use']} "
                     "blocks still in use after every request finished")
        print(line + f" [{card}]", flush=True)
        del engine
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    b, d = kv["b paged"], kv["d paged+tier"]
    if b["kv_cache"]["prefix_block_hits"] < CONT_PREFIX // CONT_BLOCK or \
            b["requeues"] < 1:
        fail("[serve-continuous] run (b) shows "
             f"{b['kv_cache']['prefix_block_hits']} prefix block hits "
             f"and {b['requeues']} requeues; expected >= "
             f"{CONT_PREFIX // CONT_BLOCK} and >= 1")
    if d["kv_tier"]["hits"] < 1:
        fail("[serve-continuous] run (d) restored nothing from the host "
             "tier")
    del params
    timing = time_continuous(torch, np, preset, dev, widths, card, drive,
                             sync)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    print(f"[serve-continuous] kernel launches of the engine runs: "
          f"{launches} (the path runs plain PyTorch) [{card}]", flush=True)
    if any(launches.values()):
        fail("[serve-continuous] the continuous engine launched a kernel; "
             "its prefills (ragged, paged) and decode are plain PyTorch")
    return {"counts": launches, "near_ties": ties,
            "kv": {k: {"kv_cache": v["kv_cache"], "requeues": v["requeues"],
                       "kv_tier": v["kv_tier"]} for k, v in kv.items()},
            "programs": programs,
            "gate": {"prompts": prompts, "oracle": oracle}, **timing}


def time_continuous(torch, np, preset, dev, widths, card, drive,
                    sync) -> dict:
    """bf16: CONT_TIMED_N requests drawn as P, all at once, through a
    fresh paged continuous engine (default pool) and through the batch
    scheduler, in turns (continuous, batch, batch, continuous, ...):
    served tokens/s, request latency p50/p95; prefix hit rate and
    evictions of each continuous run."""
    from ray_tpu_torch.serve import build_llm_deployment

    batch = build_llm_deployment(
        "llama", preset, max_new_tokens=CONT_MAX_NEW,
        max_batch_size=CONT_TIMED_SLOTS, seed=0, device=dev,
        config_overrides=widths).func_or_class()
    cfg = batch.cfg
    prompts = continuous_prompts(np, cfg.vocab_size, CONT_TIMED_N, seed=6)
    n_tok = CONT_TIMED_N * CONT_MAX_NEW

    def continuous():
        return build_llm_deployment(
            "llama", preset, scheduler="continuous", kv_layout="paged",
            kv_block_size=CONT_BLOCK, max_slots=CONT_TIMED_SLOTS,
            max_new_tokens=CONT_MAX_NEW, prefill_bucket=CONT_BUCKET, seed=0,
            device=dev, config_overrides=widths).func_or_class()

    # warm-up of both (cuBLAS handles, allocator pools), not timed
    for engine in (continuous(), batch):
        outs, _ = asyncio.run(_serve_waves(engine, prompts[:8], 8))
        check_replies(np, prompts[:8], outs, CONT_MAX_NEW, cfg.vocab_size,
                      "warm-up")
        del engine
    runs = {"continuous": [], "batch": []}
    order = ["continuous", "batch", "batch", "continuous"]
    for name in order * (CONT_TURNS // 2):
        engine = continuous() if name == "continuous" else batch
        sync()
        t0 = time.perf_counter()
        if name == "continuous":
            outs, lat = drive(engine, prompts, CONT_TIMED_N)
        else:
            outs, lat = asyncio.run(_serve_waves(engine, prompts,
                                                 CONT_TIMED_N))
            sync()
        wall = time.perf_counter() - t0
        check_replies(np, prompts, outs, CONT_MAX_NEW, cfg.vocab_size, name)
        run = {"tokens_per_s": n_tok / wall, "wall_s": wall, **_pcts(lat)}
        if name == "continuous":
            stats = engine.engine_stats()
            c = stats["kv_cache"]
            run.update(prefix_hit_rate=c["prefix_hit_rate"],
                       evictions=c["evictions"],
                       prefix_block_hits=c["prefix_block_hits"],
                       engine=engine_clock(stats))
            del engine
        runs[name].append(run)
        print(f"[serve-continuous] bf16 {name}: {CONT_TIMED_N} requests "
              f"(+{CONT_MAX_NEW} each), {run['tokens_per_s']:.1f} served "
              f"tokens/s, request latency p50 {run['p50_ms']:.1f} ms, p95 "
              f"{run['p95_ms']:.1f} ms"
              + (f", prefix hit rate {run['prefix_hit_rate']}, evictions "
                 f"{run['evictions']}; {engine_clock_line(stats)}"
                 if name == "continuous" else "")
              + f" [{card}]", flush=True)
    del batch
    return {"timed": runs}


# phase serve-spec-disagg: speculative decoding and the prefill/decode
# roles of the continuous engine, llama-1b, on phase serve-continuous's
# request set P, oracle and near-tie rule.
SPEC_K = 4
#: the least acceptance rate of the aligned draft (the target itself):
#: below it the verify forward and the decode step disagree
SPEC_ALIGNED_MIN_RATE = 0.9
#: the bf16 timing's model draft: llama-s (12 layers, d 768, llama-1b's
#: vocabulary of 32,000 and max_seq 2048)
SPEC_TIMED_DRAFT = "llama:llama-s"
#: prompts sent straight to the decode engine after the handoffs of
#: engine (g): the shared prefix and a fresh tail each
SPEC_DIRECT = 2


class _Pair:
    """A role="prefill" engine feeding a role="decode" one: a call
    prefills, hands the HandoffCursor over and awaits the decode
    engine's reply (the router's two-stage dispatch, done by hand).
    The install is fenced and timed from outside by wrapping the decode
    engine's kv_handoff_install (a closure over a list, not over the
    pair: a cycle through the engine would keep its memory after the
    phase)."""

    def __init__(self, torch, pre, dec, sync):
        from ray_tpu_torch.serve.batching import HandoffCursor

        self.pre, self.dec, self.pkgs = pre, dec, []
        self.install_s = install_s = []
        self._cursor = HandoffCursor
        install = dec._fns.kv_handoff_install

        def timed(*args):
            sync()
            t0 = time.perf_counter()
            out = install(*args)
            sync()
            install_s.append(time.perf_counter() - t0)
            return out

        dec._fns.kv_handoff_install = timed

    async def __call__(self, prompt):
        pkg = await self.pre(prompt)
        if not isinstance(pkg, self._cursor):
            fail("[serve-spec-disagg] a prefill engine answered a request "
                 "of 24 new tokens without a handoff")
        self.pkgs.append(pkg)
        return await self.dec.admit_prefilled(pkg)

    def shutdown_engine(self):
        self.pre.shutdown_engine()
        self.dec.shutdown_engine()

    def check_engines(self, tag: str) -> None:
        """The engines' own handoff counts (engine_stats()["handoff"])
        equal the packages this pair handed over."""
        want = {"handoffs_out": len(self.pkgs),
                "handoffs_in": len(self.pkgs),
                "blocks_moved": sum(p.n_blocks for p in self.pkgs)}
        got = {"handoffs_out":
               self.pre.engine_stats()["handoff"]["handoffs_out"]}
        dec = self.dec.engine_stats()["handoff"]
        got.update(handoffs_in=dec["handoffs_in"],
                   blocks_moved=dec["blocks_moved"])
        if got != want:
            fail(f"[serve-spec-disagg] {tag}: engine_stats handoff {got} "
                 f"!= the pair's count {want}")

    def handoffs(self) -> dict:
        """Export and install ms per request (means), bytes per request
        and the rate of each leg."""
        n = len(self.pkgs)
        nbytes = sum(p.nbytes for p in self.pkgs)
        export_s = sum(p.t_export1 - p.t_export0 for p in self.pkgs)
        install_s = sum(self.install_s)
        return {"handoffs": n, "path": self.pkgs[0].path if n else None,
                "blocks": sum(p.n_blocks for p in self.pkgs),
                "bytes_per_request": nbytes / max(n, 1),
                "export_ms": 1e3 * export_s / max(n, 1),
                "install_ms": 1e3 * install_s / max(n, 1),
                "export_gb_s": nbytes / export_s / 1e9 if export_s else None,
                "install_gb_s": (nbytes / install_s / 1e9 if install_s
                                 else None)}


class _Acceptance:
    """Counts a spec engine's proposals and acceptances from outside, by
    wrapping its spec_verify: k drafts per row that was decoding, and
    the n_acc of those rows.  The wrapper holds the engine's slot list
    and a counter list, not the engine (no reference cycle)."""

    def __init__(self, engine):
        # rounds, proposed, accepted, rounds x decoding rows
        self.counts = counts = [0, 0, 0, 0]
        verify, slots = engine._fns.spec_verify, engine._slots

        def counted(params, cache, block, *args):
            rows = [i for i, st in enumerate(slots)
                    if st is not None and st.get("state") != "prefill"]
            out, n_acc, cache = verify(params, cache, block, *args)
            counts[0] += 1
            counts[1] += (block.shape[1] - 1) * len(rows)
            counts[2] += int(n_acc[rows].sum())
            counts[3] += len(rows)
            return out, n_acc, cache

        engine._fns.spec_verify = counted

    rounds = property(lambda self: self.counts[0])
    proposed = property(lambda self: self.counts[1])
    accepted = property(lambda self: self.counts[2])
    row_rounds = property(lambda self: self.counts[3])

    def check_engine(self, stats: dict, tag: str) -> None:
        """The engine's own spec counts (engine_stats()["spec"], a
        round counted once per decoding request) equal this count."""
        spec = stats["spec"]
        want = {"proposed": self.proposed, "accepted": self.accepted,
                "rounds": self.row_rounds}
        got = {k: spec[k] for k in want}
        if got != want:
            fail(f"[serve-spec-disagg] {tag}: engine_stats spec {got} != "
                 f"the spec_verify wrapper's {want}")

    @property
    def rate(self) -> float:
        return self.accepted / self.proposed if self.proposed else 0.0


def phase_serve_spec_disagg(torch, np, fa, card: str, gate: dict,
                            preset="llama-1b", device="cuda", widths=None,
                            timed_draft=SPEC_TIMED_DRAFT) -> dict:
    """Speculative decoding and the prefill/decode handoff on llama-1b.
    The f32 gate: P (``gate``: phase serve-continuous's prompts and solo
    oracle) through (e) a paged engine with n-gram spec, (f) a dense one
    with the aligned model draft (the target itself), (g) a prefill
    engine feeding a decode engine on the device, (h) the same pair
    staged through host memory with chunked prefill, (i) the fast pair
    with n-gram spec on the decode side; each reply held to the oracle
    as in serve-continuous, the aligned draft's acceptance >= 0.9, the
    blocks handed off, the decode engine's prefix hits on the imported
    prefix, empty pagers.  Then bf16 timing of 32 requests at once:
    plain, n-gram spec and llama-s-draft spec in turns, and the fast
    and staged handoff.  ``preset``, ``device``, ``widths`` and
    ``timed_draft`` let it run cut down elsewhere."""
    from ray_tpu_torch.serve import SpecConfig, build_llm_deployment

    dev = torch.device(device)
    widths = dict(widths or {})
    prompts, oracle = gate["prompts"], gate["oracle"]

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    launches = {}

    def drive(engine, ps, wave1):
        zero_counts(fa)
        out = asyncio.run(_serve_waves(engine, ps, wave1))
        sync()
        for k, v in read_counts(fa).items():
            launches[k] = launches.get(k, 0) + v
        return out

    common = dict(scheduler="continuous", max_new_tokens=CONT_MAX_NEW,
                  prefill_bucket=CONT_BUCKET, seed=0, device=dev,
                  max_slots=CONT_SLOTS,
                  config_overrides=dict(widths, dtype=torch.float32,
                                        max_seq=CONT_MAX_SEQ))
    paged = dict(kv_layout="paged", kv_block_size=CONT_BLOCK,
                 kv_num_blocks=CONT_F32_BLOCKS)
    ngram = SpecConfig(draft="ngram", k=SPEC_K)

    def build(**kw):
        return build_llm_deployment("llama", preset, **common,
                                    **kw).func_or_class()

    def pair(staged=False, pre_kw=None, dec_kw=None):
        return _Pair(torch,
                     build(role="prefill", handoff_staged=staged, **paged,
                           **(pre_kw or {})),
                     build(role="decode", handoff_staged=staged, **paged,
                           **(dec_kw or {})), sync)

    engines = {
        "e paged+ngram": lambda: build(spec_decode=ngram, **paged),
        "f dense+aligned draft": lambda: build(
            kv_layout="dense",
            spec_decode=SpecConfig(draft=f"llama:{preset}", k=SPEC_K)),
        "g prefill->decode fast": lambda: pair(),
        "h prefill(chunked)->decode staged": lambda: pair(
            staged=True, pre_kw=dict(prefill_chunk_tokens=CONT_CHUNK)),
        "i prefill->decode+ngram": lambda: pair(
            dec_kw=dict(spec_decode=ngram)),
    }
    want_blocks = sum(-(-len(p) // CONT_BLOCK) for p in prompts)
    ties, rates, handoffs, direct_hits = [], {}, {}, None
    params = cfg = None
    for tag, make in engines.items():
        engine = make()
        target = engine.dec if isinstance(engine, _Pair) else engine
        if params is None:
            # the engines' weights are the serve-continuous ones (seed 0)
            cfg, params = target.cfg, target.params
        acc = _Acceptance(target) if target._fns.spec_verify else None
        t0 = time.perf_counter()
        outs, _ = drive(engine, prompts, CONT_WAVE1)
        wall = time.perf_counter() - t0
        check_replies(np, prompts, outs, CONT_MAX_NEW, cfg.vocab_size, tag)
        ties += gate_against_oracle(torch, np, params, cfg, prompts, outs,
                                    oracle, tag, "serve-spec-disagg")
        line = (f"[serve-spec-disagg] f32 engine ({tag}): {CONT_N} requests "
                f"in {wall:.2f} s, all equal to the oracle or parted at a "
                f"near-tie")
        if acc is not None:
            acc.check_engine(target.engine_stats(), tag)
            rates[tag] = {"proposed": acc.proposed, "accepted": acc.accepted,
                          "rounds": acc.rounds, "rate": acc.rate}
            line += (f"; spec rounds {acc.rounds}, accepted {acc.accepted} "
                     f"of {acc.proposed} drafts (rate {acc.rate:.4f}; "
                     f"engine_stats spec equal)")
        est = target.engine_stats()
        programs = est["programs"]           # phase observatory (c)
        line += f"; {engine_clock_line(est)}"
        pagers = []
        if isinstance(engine, _Pair):
            engine.check_engines(tag)
            h = handoffs[tag] = engine.handoffs()
            line += (f"; {h['handoffs']} handoffs ({h['path']}), "
                     f"{h['blocks']} blocks (sum of ceil(n/16): "
                     f"{want_blocks}; engine_stats handoff equal), decode "
                     f"requeues "
                     f"{engine.dec.kv_stats()['requeues']}")
            if h["blocks"] != want_blocks or h["handoffs"] != CONT_N:
                fail(f"[serve-spec-disagg] {tag} handed off {h['handoffs']} "
                     f"requests and {h['blocks']} blocks; expected {CONT_N} "
                     f"and {want_blocks}")
            if tag.startswith("g"):
                direct_hits = _direct_prefix_hits(np, engine.dec, prompts,
                                                  oracle, drive, tag, cfg)
                line += (f"; {SPEC_DIRECT} prompts sent straight to the "
                         f"decode engine hit {direct_hits} imported prefix "
                         f"blocks")
            pagers = [engine.pre, engine.dec]
        elif target._pager is not None:
            pagers = [target]
        for e in pagers:
            used = e.kv_stats()["kv_cache"]["blocks_in_use"]
            if used:
                fail(f"[serve-spec-disagg] {tag}: {used} blocks still in "
                     "use after every request finished")
        print(line + f" [{card}]", flush=True)
        del engine, target, acc
    del params
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    aligned = rates["f dense+aligned draft"]["rate"]
    if aligned < SPEC_ALIGNED_MIN_RATE:
        fail(f"[serve-spec-disagg] the aligned draft's acceptance rate "
             f"{aligned:.4f} < {SPEC_ALIGNED_MIN_RATE}: the verify forward "
             "and the decode step disagree")
    timing = time_spec(torch, np, preset, dev, widths, card, drive, sync,
                       timed_draft)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    print(f"[serve-spec-disagg] kernel launches of the engine runs: "
          f"{launches} (the path runs plain PyTorch) [{card}]", flush=True)
    if any(launches.values()):
        fail("[serve-spec-disagg] a spec or handoff engine launched a "
             "kernel; their verify, draft and handoff are plain PyTorch")
    return {"counts": launches, "near_ties": ties, "acceptance": rates,
            "handoffs": handoffs, "direct_prefix_hits": direct_hits,
            "programs": programs, **timing}


def _direct_prefix_hits(np, dec, prompts, oracle, drive, tag, cfg) -> int:
    """After the handoffs, SPEC_DIRECT prompts of P's shared prefix and
    fresh tails go straight to the decode engine, one by one (as the
    reference's router sends a resident prefix, tests/test_serve_disagg.py
    :145): their admissions must hit every full block of the prefix,
    which that engine only holds by note_handoff_import.  Their replies
    are checked for shape (the oracle covers P only)."""
    prefix = prompts[0][:CONT_PREFIX]
    rs = np.random.RandomState(8)
    direct = [np.concatenate([prefix, rs.randint(0, cfg.vocab_size, 16)])
              .astype(np.int32) for _ in range(SPEC_DIRECT)]
    before = dec.kv_stats()["kv_cache"]["prefix_block_hits"]
    for p in direct:
        outs, _ = drive(dec, [p], 1)
        check_replies(np, [p], outs, CONT_MAX_NEW, cfg.vocab_size, tag)
    hits = dec.kv_stats()["kv_cache"]["prefix_block_hits"] - before
    want = SPEC_DIRECT * (CONT_PREFIX // CONT_BLOCK)
    if hits < want:
        fail(f"[serve-spec-disagg] {tag}: prompts sharing the imported "
             f"{CONT_PREFIX}-token prefix hit {hits} blocks on the decode "
             f"engine; expected >= {want}")
    return hits


def time_spec(torch, np, preset, dev, widths, card, drive, sync,
              timed_draft) -> dict:
    """bf16: CONT_TIMED_N requests drawn as P, all at once, through a
    paged engine of CONT_TIMED_SLOTS slots (default pool) without spec,
    with n-gram spec and with ``timed_draft`` as the draft model, in
    turns (and back): served tokens/s, request latency p50/p95 and the
    acceptance rate; then through a fast and a staged prefill/decode
    pair: export and install ms per request, bytes, GB/s."""
    from ray_tpu_torch.models.llama import llama_config
    from ray_tpu_torch.serve import SpecConfig, build_llm_deployment

    kw = dict(scheduler="continuous", kv_layout="paged",
              kv_block_size=CONT_BLOCK, max_slots=CONT_TIMED_SLOTS,
              max_new_tokens=CONT_MAX_NEW, prefill_bucket=CONT_BUCKET, seed=0,
              device=dev, config_overrides=widths)
    specs = {"plain": None, "ngram": SpecConfig(draft="ngram", k=SPEC_K),
             "draft " + timed_draft.split(":")[1]: SpecConfig(
                 draft=timed_draft, k=SPEC_K)}

    def engine(name):
        return build_llm_deployment("llama", preset, spec_decode=specs[name],
                                    **kw).func_or_class()

    vocab = llama_config(preset, **widths).vocab_size
    prompts = continuous_prompts(np, vocab, CONT_TIMED_N, seed=6)
    n_tok = CONT_TIMED_N * CONT_MAX_NEW
    for name in specs:            # warm-up, not timed
        outs, _ = asyncio.run(_serve_waves(engine(name), prompts[:8], 8))
        check_replies(np, prompts[:8], outs, CONT_MAX_NEW, vocab, "warm-up")
    runs = {name: [] for name in specs}
    for name in list(specs) + list(specs)[::-1]:
        e = engine(name)
        acc = _Acceptance(e) if e._fns.spec_verify else None
        sync()
        t0 = time.perf_counter()
        outs, lat = drive(e, prompts, CONT_TIMED_N)
        wall = time.perf_counter() - t0
        check_replies(np, prompts, outs, CONT_MAX_NEW, vocab, name)
        stats = e.engine_stats()
        if acc is not None:
            acc.check_engine(stats, name)
        run = {"tokens_per_s": n_tok / wall, "wall_s": wall, **_pcts(lat),
               "accept_rate": acc.rate if acc else None,
               "engine": engine_clock(stats)}
        runs[name].append(run)
        print(f"[serve-spec-disagg] bf16 {name}: {CONT_TIMED_N} requests "
              f"(+{CONT_MAX_NEW} each), {run['tokens_per_s']:.1f} served "
              f"tokens/s, request latency p50 {run['p50_ms']:.1f} ms, p95 "
              f"{run['p95_ms']:.1f} ms"
              + (f", acceptance rate {acc.rate:.4f} ({acc.accepted} of "
                 f"{acc.proposed} drafts, {acc.rounds} rounds)" if acc else "")
              + f"; {engine_clock_line(stats)} [{card}]", flush=True)
        del e, acc
    handoff = {}
    for staged in (False, True):
        p = _Pair(torch, *(build_llm_deployment(
            "llama", preset, role=r, handoff_staged=staged,
            **kw).func_or_class()
            for r in ("prefill", "decode")), sync)
        outs, _ = drive(p, prompts, CONT_TIMED_N)
        check_replies(np, prompts, outs, CONT_MAX_NEW, vocab, "handoff")
        p.check_engines("handoff")
        h = handoff["staged" if staged else "fast"] = p.handoffs()
        print(f"[serve-spec-disagg] bf16 handoff ({h['path']}): "
              f"{h['handoffs']} requests, {h['bytes_per_request'] / 2**20:.3f}"
              f" MiB a request ({h['blocks']} blocks of 16 tokens), export "
              f"{h['export_ms']:.4f} ms ({h['export_gb_s']:.2f} GB/s), "
              f"install {h['install_ms']:.4f} ms ({h['install_gb_s']:.2f} "
              f"GB/s) per request [{card}]", flush=True)
        del p
    return {"timed": runs, "timed_handoff": handoff}


# phase serve-telemetry: the engine telemetry on llama-1b, phase
# serve-continuous's request set P, oracle and near-tie rule.
#: (b): requests all at once through TELE_SLOTS slots, bf16
TELE_N, TELE_SLOTS = 32, 8
#: (c): the queue bound of the shedding run
TELE_MAX_QUEUE = 4
#: (e): the health monitor's thresholds and the chaos freeze (polls of
#: TELE_POLL_MS: >= 600 ms, past dead_ms however the waves around it
#: run); the prober stands in for the fleet router's pump
TELE_HEALTH = dict(suspect_ms=150.0, dead_ms=400.0, stall_ms=60_000.0,
                   probe_ms=5.0)
TELE_FREEZE_POLLS, TELE_POLL_MS = 120, 5.0
#: (f): equal-length prompts through the batch scheduler
TELE_BATCH_N, TELE_BATCH_T = 8, 128


class _HostCostSpy:
    """Times the host work that the telemetry adds to one engine's run,
    by part: every public method of its EngineTelemetry instance; the
    flight recorder's ``record`` (the pager's journal writes into it
    too); the program registry's bookkeeping around each engine program
    call (``_signature`` over the arguments' leaves, ``record_invoke``
    and ``record_compile``; the wrapper's set lookup under its lock is
    not timed); and the engine's ``pager.stats()`` and
    ``_compose_kv_scope()``, whose results only telemetry reads.  Only
    the outermost timed call counts, so a nested one is not counted
    twice.  Every timed call runs under
    torch.cuda.set_sync_debug_mode("error"), set and reset by the
    wrapper outside the timed window, so a call that synchronizes the
    card raises (``guard``: off where there is no card).  ``restore()``
    takes the process-wide patches (the registry's) off again.  Holds
    the objects it patches, so it is dropped with the engine."""

    PARTS = ("EngineTelemetry methods", "flight recorder", "registry",
             "pager.stats / kv_scope")

    def __init__(self, torch, engine, guard: bool = True):
        from ray_tpu_torch._private import device_stats

        self.by_part = {p: 0.0 for p in self.PARTS}
        self.calls = 0
        self._depth = 0
        self._undo = []
        self._torch, self._guard = torch, guard
        tel = engine._telemetry
        for name in dir(tel):
            if not name.startswith("_") and callable(getattr(tel, name)):
                self._patch(tel, name, self.PARTS[0])
        self._patch(tel.flightrec, "record", self.PARTS[1])
        self._patch(device_stats, "_signature", self.PARTS[2])
        reg = device_stats.get_registry()
        self._patch(reg, "record_invoke", self.PARTS[2])
        self._patch(reg, "record_compile", self.PARTS[2])
        if engine._pager is not None:
            self._patch(engine._pager, "stats", self.PARTS[3])
        self._patch(engine, "_compose_kv_scope", self.PARTS[3])

    def _patch(self, obj, name: str, part: str) -> None:
        fn = getattr(obj, name)
        had = name in getattr(obj, "__dict__", {})
        torch, spy = self._torch, self

        def wrapped(*a, **kw):
            if spy._depth:
                return fn(*a, **kw)
            if spy._guard:
                prev = torch.cuda.get_sync_debug_mode()
                torch.cuda.set_sync_debug_mode("error")
            spy._depth += 1
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                spy.by_part[part] += time.perf_counter() - t0
                spy.calls += 1
                spy._depth -= 1
                if spy._guard:
                    torch.cuda.set_sync_debug_mode(prev)

        setattr(obj, name, wrapped)
        self._undo.append((obj, name, fn if had else None))

    def restore(self) -> None:
        for obj, name, fn in reversed(self._undo):
            if fn is None:
                delattr(obj, name)
            else:
                setattr(obj, name, fn)
        self._undo = []

    @property
    def seconds(self) -> float:
        return sum(self.by_part.values())


#: engine_stats()'s top-level keys (the reference's schema test,
#: tests/test_engine_stats_schema.py:26-34)
ENGINE_STATS_KEYS = {
    "deployment", "uptime_s", "requests", "ttft_ms", "queue_wait_ms",
    "request_latency_ms", "inter_token_ms", "engine_steps",
    "tokens_generated", "tokens_per_sec", "slot_utilization",
    "max_active_slots", "max_slots", "prefill_buckets",
    "prefill_compiles", "program_compiles", "rejections_by_reason",
    "kv_cache", "kv_scope", "kv_tier", "spec", "slo", "flightrec",
    "programs", "latency_anatomy", "prefill_chunks", "role", "handoff",
    "health"}


def profile_serving(torch, np, engine, prompts, card: str) -> dict:
    """One run of ``prompts``, all at once, under torch.profiler (CUPTI):
    the card's busy time (kernels, copies and sets on its one stream)
    over the run's wall time, and the busy time by kind.  The profiler
    slows the host's launches, so the busy share it gives is a lower
    bound of the unprofiled run's."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        asyncio.run(_serve_waves(engine, prompts, len(prompts)))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in events) / 1e6
    kinds = {}
    for e in events:
        kind = next((k for k, marks in PROFILE_KINDS if any(
            m in e.key for m in marks)), "other elementwise")
        kinds[kind] = kinds.get(kind, 0.0) + e.self_device_time_total / 1e3
    launches = sum(e.count for e in events)
    print(f"[serve-telemetry] (b) profiled run, {len(prompts)} requests at "
          f"once: wall {wall:.3f} s, device busy {busy:.3f} s = "
          f"{100 * busy / wall:.1f}% ({launches} device ops, "
          f"{1e6 * busy / max(launches, 1):.1f} us each); busy by kind "
          + ", ".join(f"{k} {v:.1f} ms" for k, v in sorted(
              kinds.items(), key=lambda kv: -kv[1]))
          + f" [{card}]", flush=True)
    return {"wall_s": wall, "busy_s": busy, "busy_share": busy / wall,
            "device_ops": launches, "by_kind_ms": kinds}


def phase_serve_telemetry(torch, np, fa, card: str, gate: dict,
                          preset="llama-1b", device="cuda",
                          widths=None) -> dict:
    """The serving telemetry on llama-1b: (a) an f32 paged engine of 4
    slots with a generous SLOConfig, each reply held to the oracle, its
    engine_stats() key tree, counts, HBM ledger, roofline and timeline
    checked; (b) bf16, 32 requests at once through 8 slots: served
    tokens/s by the phase's clock and the engine's, TTFT and
    inter-token percentiles, slot utilization, telemetry's share of the
    wall time, every record call under sync-debug "error"; (c) three
    admission-policy runs (a queue bound, a headroom above the card's
    memory, a headroom of 1 GiB); (d) a breached SLO dumping the flight
    record; (e) a health monitor and a chaos freeze attached as the
    fleet router attaches them, f32 replies held to the oracle; (f) the
    batch scheduler: 8 equal-length bf16 requests, one prefill through
    the flash forward (16 launches, zeroed just before).  ``preset``,
    ``device`` and ``widths`` let it run cut down elsewhere."""
    import os
    import tempfile

    from ray_tpu_torch.serve import build_llm_deployment
    from ray_tpu_torch.serve.batching import (AdmissionPolicy,
                                              OverloadedError)
    from ray_tpu_torch.serve.chaos import ChaosConfig, ChaosInjector
    from ray_tpu_torch.serve.health import HealthConfig, HealthMonitor
    from ray_tpu_torch.serve.slo import SLOConfig

    dev = torch.device(device)
    on_card = dev.type == "cuda"
    widths = dict(widths or {})
    prompts, oracle = gate["prompts"], gate["oracle"]
    out = {}

    def sync():
        if on_card:
            torch.cuda.synchronize()

    launches = {}

    def drive(engine, ps, wave1, extra=None):
        zero_counts(fa)

        async def run():
            helper = (asyncio.ensure_future(extra())
                      if extra is not None else None)
            try:
                return await _serve_waves(engine, ps, wave1)
            finally:
                if helper is not None:
                    helper.cancel()

        res = asyncio.run(run())
        sync()
        for k, v in read_counts(fa).items():
            launches[k] = launches.get(k, 0) + v
        return res

    f32 = dict(scheduler="continuous", max_new_tokens=CONT_MAX_NEW,
               prefill_bucket=CONT_BUCKET, seed=0, device=dev,
               max_slots=CONT_SLOTS, kv_layout="paged",
               kv_block_size=CONT_BLOCK, kv_num_blocks=CONT_F32_BLOCKS,
               config_overrides=dict(widths, dtype=torch.float32,
                                     max_seq=CONT_MAX_SEQ))
    bf16 = dict(scheduler="continuous", kv_layout="paged",
                kv_block_size=CONT_BLOCK, max_slots=TELE_SLOTS,
                max_new_tokens=CONT_MAX_NEW, prefill_bucket=CONT_BUCKET,
                seed=0, device=dev, config_overrides=widths)

    def build(**kw):
        return build_llm_deployment("llama", preset, **kw).func_or_class()

    # (a) -------------------------------------------------------------
    engine = build(slo=SLOConfig(ttft_ms=600_000.0, e2e_ms=600_000.0,
                                 queue_wait_ms=600_000.0), **f32)
    params, cfg = engine.params, engine.cfg
    # the registry is process-wide and an earlier phase's engine of the
    # same identity shares these programs: count (a)'s own invokes
    from ray_tpu_torch._private.device_stats import get_registry

    def calls_of(names):
        snap = get_registry().snapshot(prefix="serve.")
        return {n: snap.get(n, {}).get("invokes", 0)
                + snap.get(n, {}).get("compile_events", 0) for n in names}

    served_by = ("serve.paged_prefill", "serve.decode")
    calls0 = calls_of(served_by)
    t0 = time.perf_counter()
    outs, _ = drive(engine, prompts, CONT_WAVE1)
    wall = time.perf_counter() - t0
    calls = {n: c - calls0[n] for n, c in calls_of(served_by).items()}
    check_replies(np, prompts, outs, CONT_MAX_NEW, cfg.vocab_size, "a")
    ties = gate_against_oracle(torch, np, params, cfg, prompts, outs,
                               oracle, "a f32 paged+slo", "serve-telemetry")
    st = engine.engine_stats()
    missing = ENGINE_STATS_KEYS - set(st)
    if missing:
        fail(f"[serve-telemetry] engine_stats() lacks {sorted(missing)}")
    req = st["requests"]
    decoded = sum(len(o) - len(p) - 1 for p, o in zip(prompts, outs))
    checks = {
        "admitted == finished == requests":
            req["admitted"] == req["finished"] == len(prompts),
        "tokens_generated == decode tokens of the replies":
            st["tokens_generated"] == decoded,
        "kv_cache == the pager's stats()": st["kv_cache"] ==
            engine._pager.stats(),
        "slo not breached": st["slo"]["breached"] is False,
        "programs serve.paged_prefill and serve.decode compiled":
            all(st["programs"].get(n, {}).get("compile_events", 0) >= 1
                for n in served_by),
        "serve.paged_prefill and serve.decode called in this run":
            all(c >= 1 for c in calls.values()),
    }
    ledger = st["kv_scope"]["hbm_ledger"]["per_chip"]
    pool = st["kv_cache"]["pool_bytes"]
    if on_card:
        total = torch.cuda.mem_get_info(dev)[1]
        row = ledger[0] if len(ledger) == 1 else {}
        checks.update({
            "one ledger row with the card's total memory":
                row.get("bytes_limit") == total,
            "kv_pool_bytes == the pager's bytes":
                row.get("kv_pool_bytes") == pool,
            "headroom == limit - max(in use, pool)":
                row.get("headroom_bytes") == total - max(
                    row.get("bytes_in_use") or 0, pool),
            "the roofline names the card": st["device"]["device_kind"] ==
                torch.cuda.get_device_name(dev),
        })
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "timeline.json")
        engine.export_timeline(path)
        with open(path) as f:
            events = json.load(f)
    lanes = {e["args"]["name"] for e in events if e["name"] == "thread_name"}
    checks["timeline lanes: a slot each, the queue, the steps"] = lanes == \
        {f"slot {i}" for i in range(CONT_SLOTS)} | {"queue", "engine steps"}
    bad = [k for k, ok in checks.items() if not ok]
    print(f"[serve-telemetry] (a) f32 paged engine, {CONT_SLOTS} slots, "
          f"generous SLO: {len(prompts)} requests in {wall:.2f} s, all equal "
          f"to the oracle or parted at a near-tie; requests {req}; "
          f"tokens_generated {st['tokens_generated']}; programs "
          f"{ {n: b['compile_events'] for n, b in st['programs'].items()} }; "
          f"calls in this run {calls}; "
          f"flightrec {st['flightrec']['recorded']} events; ledger "
          f"{ledger}; roofline {st['device']}; timeline {len(events)} "
          f"events; {engine_clock_line(st)} [{card}]", flush=True)
    if bad:
        fail(f"[serve-telemetry] (a) failed: {bad}")
    # the snapshot tools/kvscope.py reads in phase vision (e)
    snapshot = os.path.join(tempfile.mkdtemp(prefix="chip_smoke_kv_"),
                            "engine_stats.json")
    with open(snapshot, "w") as f:
        json.dump(st, f, default=str)
    out["a"] = {"wall_s": wall, "requests": req, "ledger": ledger,
                "snapshot": snapshot,
                "program_calls": calls,
                "engine": engine_clock(st), "programs": {
                    n: b["compile_events"] for n, b in st["programs"].items()}}
    del engine

    # (b) -------------------------------------------------------------
    tprompts = continuous_prompts(np, cfg.vocab_size, TELE_N, seed=6)
    engine = build(**bf16)
    drive(engine, tprompts[:8], 8)          # warm-up, not timed
    engine = build(**bf16)
    spy = _HostCostSpy(torch, engine, guard=on_card)
    sync()
    t0 = time.perf_counter()
    try:
        outs, lat = drive(engine, tprompts, TELE_N)
    finally:
        spy.restore()
    wall = time.perf_counter() - t0
    check_replies(np, tprompts, outs, CONT_MAX_NEW, cfg.vocab_size, "b")
    st = engine.engine_stats()
    recs = engine.trace_records()
    prefill_s = sum(r["first_token"] - r["admit"] for r in recs
                    if r["first_token"] is not None
                    and r["admit"] is not None)
    step_s = st["inter_token_ms"]["mean"] * st["engine_steps"] / 1e3
    served = TELE_N * CONT_MAX_NEW / wall
    b = {"wall_s": wall, "served_tokens_per_s": served, **_pcts(lat),
         "engine": engine_clock(st), "telemetry_s": spy.seconds,
         "telemetry_calls": spy.calls,
         "telemetry_share": spy.seconds / wall,
         "telemetry_ms_by_part": {k: 1e3 * v
                                  for k, v in spy.by_part.items()},
         "decode_step_s": step_s, "decode_step_share": step_s / wall,
         "prefill_s": prefill_s, "prefill_share": prefill_s / wall,
         "engine_steps": st["engine_steps"]}
    print(f"[serve-telemetry] (b) bf16 paged, {TELE_N} requests at once "
          f"through {TELE_SLOTS} slots (+{CONT_MAX_NEW} each): {served:.1f} "
          f"served tokens/s by the phase's clock ({wall:.3f} s; request "
          f"latency p50 {b['p50_ms']:.1f} ms, p95 {b['p95_ms']:.1f} ms); "
          f"{engine_clock_line(st)}; telemetry's host work {spy.calls} "
          f"calls, {spy.seconds * 1e3:.2f} ms = "
          f"{100 * b['telemetry_share']:.3f}% of the wall time ("
          + ", ".join(f"{k} {v:.2f} ms"
                      for k, v in b["telemetry_ms_by_part"].items())
          + "), every timed call under sync-debug 'error'; "
          f"decode steps {st['engine_steps']} taking {step_s:.3f} s "
          f"({100 * step_s / wall:.1f}%), prefill (admit -> first token, "
          f"summed over requests) {prefill_s:.3f} s [{card}]", flush=True)
    if on_card:
        b["profiled"] = profile_serving(torch, np, build(**bf16),
                                        tprompts[:TELE_SLOTS], card)
    out["b"] = b
    del engine, spy

    # (c) -------------------------------------------------------------
    def shed_run(policy, tag):
        engine = build(admission_policy=policy, **bf16)
        # the admission gate's ledger refresh, timed on its own
        scope = [0.0, 0]
        compose = engine._compose_kv_scope

        def timed_scope(*a, **kw):
            t = time.perf_counter()
            try:
                return compose(*a, **kw)
            finally:
                scope[0] += time.perf_counter() - t
                scope[1] += 1

        engine._compose_kv_scope = timed_scope

        async def one(p):
            try:
                return await engine(p)
            except OverloadedError as e:
                return e

        async def run():
            try:
                return await asyncio.gather(*(one(p) for p in tprompts))
            finally:
                engine.shutdown_engine()

        sync()
        t = time.perf_counter()
        res = asyncio.run(run())
        sync()
        wall = time.perf_counter() - t
        del engine._compose_kv_scope
        shed = sum(isinstance(r, OverloadedError) for r in res)
        served = [r for r in res if not isinstance(r, Exception)]
        reasons = engine.engine_stats()["rejections_by_reason"]
        print(f"[serve-telemetry] (c) {tag}: {shed} of {len(tprompts)} "
              f"shed, {len(served)} replied in {wall:.3f} s; the gate's "
              f"ledger refreshes {scope[1]} taking {1e3 * scope[0]:.3f} ms; "
              f"rejections_by_reason {reasons} [{card}]", flush=True)
        runs[tag] = {"wall_s": wall, "ledger_refreshes": scope[1],
                     "ledger_ms": 1e3 * scope[0]}
        for p, r in zip(tprompts, res):
            if not isinstance(r, Exception):
                check_replies(np, [p], [r], CONT_MAX_NEW, cfg.vocab_size,
                              tag)
            elif not isinstance(r, OverloadedError):
                fail(f"[serve-telemetry] (c) {tag}: a request raised {r!r}")
        return shed, len(served), reasons, engine

    def admission_costs(engine, reps=50):
        """The host work an admission_policy adds to each request, by
        part, in us a call: the telemetry read that decide() takes,
        and the headroom gate's ledger refresh (the pager's kvscope
        block, the allocator read) beside the segment walk it leaves
        out."""
        from ray_tpu_torch._private.device_stats import device_memory_stats

        parts = {
            "engine_stats for decide": engine._telemetry.engine_stats,
            "ledger refresh": lambda: engine._compose_kv_scope(
                largest_alloc=False),
            "pager kv_scope_stats": engine._pager.kv_scope_stats,
            "allocator read": lambda: device_memory_stats(
                [dev], largest_alloc=False),
            "allocator read + segment walk": lambda: device_memory_stats(
                [dev]),
        }
        us = {}
        for name, fn in parts.items():
            fn()
            t = time.perf_counter()
            for _ in range(reps):
                fn()
            us[name] = 1e6 * (time.perf_counter() - t) / reps
        print("[serve-telemetry] (c) an admission's host work, us a call ("
              f"{reps} calls each): " + ", ".join(
                  f"{k} {v:.1f}" for k, v in us.items()) + f" [{card}]",
              flush=True)
        return us

    runs = {}
    total = torch.cuda.mem_get_info(dev)[1] if on_card else None
    n, ok, reasons, _ = shed_run(
        AdmissionPolicy(max_queue_depth=TELE_MAX_QUEUE), "max_queue_depth=4")
    if not n or reasons != {"shed_queue_full": n} or n + ok != TELE_N:
        fail(f"[serve-telemetry] (c) the queue bound shed {n} and served "
             f"{ok}; rejections {reasons}")
    out["c"] = {"queue_full_shed": n}
    if on_card:
        n, ok, reasons, _ = shed_run(
            AdmissionPolicy(min_headroom_bytes=2 * total),
            "min_headroom_bytes=2 x the card's memory")
        if n != TELE_N or reasons != {"shed_hbm_headroom": TELE_N}:
            fail(f"[serve-telemetry] (c) a headroom above the card's memory "
                 f"shed {n} of {TELE_N}; rejections {reasons}")
        n, ok, reasons, engine = shed_run(
            AdmissionPolicy(min_headroom_bytes=1 << 30),
            "min_headroom_bytes=1 GiB")
        if n or ok != TELE_N:
            fail(f"[serve-telemetry] (c) a 1 GiB headroom shed {n}")
        out["c"]["admission_us"] = admission_costs(engine)
        del engine
        # the same traffic with no policy: the 1 GiB run's wall beside it
        if shed_run(None, "no admission_policy")[0]:
            fail("[serve-telemetry] (c) a run without a policy shed")
        out["c"]["headroom_runs"] = "all shed / none shed"
    out["c"]["runs"] = runs

    # (d) -------------------------------------------------------------
    old = os.environ.get("RAYTPU_FLIGHTREC_DIR")
    with tempfile.TemporaryDirectory() as d:
        os.environ["RAYTPU_FLIGHTREC_DIR"] = d
        try:
            engine = build(slo=SLOConfig(ttft_ms=0.001), **bf16)
            drive(engine, tprompts[:8], 8)
            blk = engine.engine_stats()["slo"]
            dumps = list(blk["dumps"])
            doc = None
            if dumps and os.path.dirname(dumps[0]) == d:
                with open(dumps[0]) as f:
                    doc = json.load(f)
        finally:
            if old is None:
                os.environ.pop("RAYTPU_FLIGHTREC_DIR", None)
            else:
                os.environ["RAYTPU_FLIGHTREC_DIR"] = old
    kinds = (doc or {}).get("counts_by_kind", {})
    print(f"[serve-telemetry] (d) SLO ttft 0.001 ms: breached "
          f"{blk['breached']}, breaches {blk['breaches']}, {len(dumps)} "
          f"dump(s); the dump's events by kind {kinds} [{card}]", flush=True)
    if not blk["breached"] or not dumps or doc is None \
            or not kinds.get("kv_reserve"):
        fail("[serve-telemetry] (d) the breach did not dump a flight record "
             "holding the pager's kv_reserve events")
    out["d"] = {"breaches": blk["breaches"], "dumps": len(dumps),
                "kinds": kinds}
    del engine

    # (e) -------------------------------------------------------------
    engine = build(**f32)
    label = "fleet/r0"
    mon = HealthMonitor(HealthConfig(**TELE_HEALTH))
    inj = ChaosInjector(ChaosConfig(
        seed=0, freeze_replica=0, freeze_after_waves=4,
        freeze_waves=TELE_FREEZE_POLLS, freeze_poll_ms=TELE_POLL_MS),
        monitor=mon)
    # as the fleet router attaches them (ray_tpu/serve/router.py:735-746)
    engine._replica_label = label
    engine._health = mon
    mon.register(label, role="both", recorder=engine._telemetry.flightrec,
                 telemetry=engine._telemetry)
    engine._chaos = inj
    inj.bind(label)

    async def prober():
        while True:
            mon.maybe_probe()
            await asyncio.sleep(TELE_HEALTH["probe_ms"] / 1e3)

    t0 = time.perf_counter()
    outs, _ = drive(engine, prompts, CONT_WAVE1, extra=prober)
    wall = time.perf_counter() - t0
    check_replies(np, prompts, outs, CONT_MAX_NEW, cfg.vocab_size, "e")
    ties += gate_against_oracle(torch, np, params, cfg, prompts, outs,
                                oracle, "e f32 paged+health+chaos",
                                "serve-telemetry")
    h = engine.engine_stats()["health"]
    log = [(x["from"], x["to"], x["reason"]) for x in h["transition_log"]]
    print(f"[serve-telemetry] (e) health + chaos freeze of "
          f"{TELE_FREEZE_POLLS} polls of {TELE_POLL_MS} ms: {len(prompts)} "
          f"f32 requests in {wall:.2f} s, equal to the oracle or parted at "
          f"a near-tie; transitions {log}; time_to_detect_ms "
          f"{h['time_to_detect_ms']}; chaos {inj.stats()} [{card}]",
          flush=True)
    if ("suspect", "dead", "heartbeat_lost") not in log \
            or log[-1][1] != "healthy" or h["time_to_detect_ms"] is None \
            or not any(t[1] == "suspect" for t in log):
        fail("[serve-telemetry] (e) the monitor did not log the frozen "
             "replica going suspect, dead and recovering")
    out["e"] = {"transitions": log, "time_to_detect_ms":
                h["time_to_detect_ms"], "wall_s": wall}
    del engine, mon, inj, params

    # (f) -------------------------------------------------------------
    batch = build_llm_deployment(
        "llama", preset, max_new_tokens=CONT_MAX_NEW,
        max_batch_size=TELE_BATCH_N, seed=0, device=dev,
        config_overrides=widths).func_or_class()
    rs = np.random.RandomState(9)
    bprompts = [rs.randint(0, cfg.vocab_size, TELE_BATCH_T).astype(np.int32)
                for _ in range(TELE_BATCH_N)]
    zero_counts(fa)
    outs, _ = asyncio.run(_serve_waves(batch, bprompts, TELE_BATCH_N))
    sync()
    counts = read_counts(fa)
    check_replies(np, bprompts, outs, CONT_MAX_NEW, cfg.vocab_size, "f")
    st = batch.engine_stats()
    print(f"[serve-telemetry] (f) batch scheduler, {TELE_BATCH_N} "
          f"requests of {TELE_BATCH_T} tokens: requests {st['requests']}, "
          f"request latency count {st['request_latency_ms']['count']} p50 "
          f"{st['request_latency_ms']['p50']} ms; kernel launches {counts} "
          f"[{card}]", flush=True)
    want_fwd = cfg.n_layer if on_card else 0
    if st["requests"]["finished"] != TELE_BATCH_N \
            or st["request_latency_ms"]["count"] != TELE_BATCH_N \
            or counts["flash_fwd"] != want_fwd:
        fail(f"[serve-telemetry] (f) expected {TELE_BATCH_N} finished "
             f"requests with a latency sample each and {want_fwd} flash "
             f"forward launches; got {st['requests']} and {counts}")
    for k, v in counts.items():
        launches[k] = launches.get(k, 0) + v
    out["f"] = {"requests": st["requests"], "launches": counts}
    del batch
    if on_card:
        torch.cuda.empty_cache()
    return {"counts": launches, "near_ties": ties, **out}


# phase serve-fleet: the fleet layer (serve/router.py, serve/traffic.py,
# tools/tracebus.py) over llama-1b replicas, on phase serve-continuous's
# request set P, oracle and near-tie rule where the engine config is
# serve-continuous's.
#: (a): 3 groups x 4 requests, a FLEET_PREFIX-token shared prefix each
#: plus a 2-5-token tail, shuffled; FLEET_MAX_NEW tokens each
FLEET_GROUPS, FLEET_PER_GROUP, FLEET_PREFIX, FLEET_MAX_NEW = 3, 4, 256, 16
#: (b): P's 8 cold prompts at once, then FLEET_RESIDENT prompts that
#: extend the first cold prompt's full blocks (resident on the decode
#: replica after its handoff), one at a time
FLEET_RESIDENT = 4
#: (d): the inflight cap above the slots, so engine queues fill; the
#: interval of the pings submitted until the frozen replica is found
#: dead (under a quarter of TELE_HEALTH's dead_ms), and their deadline
FLEET_HEALTH_CAP = 2 * CONT_SLOTS
FLEET_PING_MS, FLEET_PING_DEADLINE_S = 50.0, 60.0
#: (e): the reference's fleet traffic (bench.py main_traffic_fleet, its
#: on-chip branch) at llama's vocabulary: requests, max_new_tokens,
#: slots, prefill bucket, the SLO (e2e; the interactive tenant's TTFT
#: target is half of it, the batch tenant's e2e twice it) and the
#: modelled Poisson rate of the time_scale=1 runs
FLEET_TIMED_N, FLEET_TIMED_NEW, FLEET_TIMED_SLOTS = 64, 64, 8
FLEET_TIMED_BUCKET, FLEET_SLO_MS, FLEET_RATE = 128, 20000.0, 32.0
#: the critical path's components sum to each request's e2e within this
FLEET_CP_TOL = 0.05


class _RouterCostSpy(_HostCostSpy):
    """Times the fleet router's own host work, as _HostCostSpy times
    telemetry: ``LLMRouter._pump`` (the health sweep, WFQ pops, replica
    picks, route records, dispatch task creation; run on every submit
    and every completion), ``_normalize`` and ``FairQueue.push``
    (submit's bookkeeping), and what ``_dispatch`` does beside awaiting
    its replica: the handoff's ``_pick_handoff_target`` and route record
    (``EngineTelemetry.record_route``: only routers record routes; the
    ones inside ``_pump`` count once), each under sync-debug "error" on
    the card.  Not timed: submit's TraceContext and future, asyncio's
    task scheduling, and a dropped handoff's journal write.  Patches the
    classes, so every router of the process is timed until
    ``restore()``."""

    PARTS = ("router",)

    def __init__(self, torch, guard: bool = True):
        from ray_tpu_torch.serve import router, telemetry

        self.by_part = {p: 0.0 for p in self.PARTS}
        self.calls = 0
        self._depth = 0
        self._undo = []
        self._torch, self._guard = torch, guard
        for obj, name in ((router.LLMRouter, "_pump"),
                          (router.LLMRouter, "_normalize"),
                          (router.LLMRouter, "_pick_handoff_target"),
                          (router.FairQueue, "push"),
                          (telemetry.EngineTelemetry, "record_route")):
            self._patch(obj, name, self.PARTS[0])


def shared_prefix_mix(np, vocab: int, prefix_len: int,
                      n_groups: int = FLEET_GROUPS,
                      per_group: int = FLEET_PER_GROUP,
                      seed: int = 11) -> list:
    """The reference's fleet workload (tests/test_serve_fleet.py:64-83)
    at a given vocabulary and prefix length: ``n_groups`` prefixes,
    ``per_group`` prompts each with a 2-4-token tail, shuffled."""
    rng = np.random.RandomState(seed)
    prefixes = [rng.randint(2, vocab, prefix_len) for _ in range(n_groups)]
    order = rng.permutation(np.repeat(np.arange(n_groups), per_group))
    return [np.concatenate([prefixes[g], rng.randint(
        2, vocab, 2 + int(rng.randint(3)))]).astype(np.int32)
        for g in order]


def _tenant_stats(np, doc: dict, tenants) -> dict:
    """Per tenant, from a tracebus dump's request snapshots: request
    latency (enqueue -> finish) and TTFT (enqueue -> first token)
    p50/p95, and the share of requests within each target the tenant's
    TenantSpec declares (``ttft_slo_ms``, ``e2e_slo_ms``)."""
    specs = {t.name: t for t in tenants}
    out = {}
    for t in sorted({r.get("tenant") or "default"
                     for r in doc["requests"]}):
        rs = [r for r in doc["requests"]
              if (r.get("tenant") or "default") == t
              and r.get("finish") is not None]
        ttft = [r["first_token"] - r["enqueue"] for r in rs]
        e2e = [r["finish"] - r["enqueue"] for r in rs]
        ts = _pcts(ttft)
        row = {"n": len(rs), **_pcts(e2e), "ttft_p50_ms": ts["p50_ms"],
               "ttft_p95_ms": ts["p95_ms"]}
        spec = specs.get(t)
        for key, xs in (("ttft", ttft), ("e2e", e2e)):
            target = getattr(spec, f"{key}_slo_ms", None)
            if target is not None:
                row[f"{key}_attainment"] = \
                    sum(v * 1e3 <= target for v in xs) / len(xs)
        out[t] = row
    return out


def phase_serve_fleet(torch, np, fa, card: str, gate: dict,
                      preset="llama-1b", device="cuda", widths=None,
                      timed_n=FLEET_TIMED_N, rate=FLEET_RATE) -> dict:
    """The serve fleet on llama-1b replicas, through build_llm_fleet and
    run_traffic(_fleet): (a) f32, 12 shared-prefix requests one at a
    time through two replicas by prefix routing and by round robin,
    replies held to the solo oracle; (b) f32 disaggregated fleets (one
    prefill, one decode replica; fast, staged, and a dropped handoff),
    P's cold prompts handed off and prompts of a resident prefix routed
    straight to the decode replica; (c) bf16 autoscaling with an
    injected clock: up on a burned SLO, the new replica serves, down on
    idle through a drain, the flight record rendered; (d) f32 health and
    a chaos freeze of replica 0, its queued requests requeued to replica
    1, P's replies held to the oracle; (e) bf16 timing of two-tenant
    seeded traffic through two replicas and through one engine, each
    once fired at once and once as Poisson arrivals (the side that goes
    first alternating), with the router's host
    share and a tracebus dump whose CLI report must run.  Frees each
    sub-phase's replicas before the next.  ``preset``, ``device``,
    ``widths``, ``timed_n`` and ``rate`` let it run cut down
    elsewhere."""
    import gc
    import os
    import tempfile

    from ray_tpu_torch.models.llama_decode import llama_generate
    from ray_tpu_torch.serve import (AutoscalePolicy, SLOConfig, TenantSpec,
                                     TrafficSpec, build_llm_fleet,
                                     run_traffic, run_traffic_fleet)
    from ray_tpu_torch.serve.chaos import ChaosConfig
    from ray_tpu_torch.serve.health import HealthConfig
    from ray_tpu_torch.tools import flightrec, tracebus

    dev = torch.device(device)
    on_card = dev.type == "cuda"
    widths = dict(widths or {})
    prompts, oracle = gate["prompts"], gate["oracle"]
    out, launches, ties = {}, {}, []

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def freed(tag):
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
            mib = torch.cuda.memory_allocated(dev) / 2**20
            print(f"[serve-fleet] after {tag}: {mib:.1f} MiB allocated on "
                  f"the card [{card}]", flush=True)
            out.setdefault("allocated_mib", {})[tag] = mib

    def count(fn):
        zero_counts(fa)
        res = fn()
        sync()
        for k, v in read_counts(fa).items():
            launches[k] = launches.get(k, 0) + v
        return res

    def drive(fleet, waves, extra=None):
        """Each wave's prompts at once, the waves one after another;
        (replies, fleet_stats) read before the fleet shuts down.
        ``extra``: a coroutine function run beside the waves, awaited
        after them; its result is returned third."""
        async def main():
            helper = (asyncio.ensure_future(extra())
                      if extra is not None else None)
            try:
                outs = []
                for wave in waves:
                    outs += await asyncio.gather(*(fleet(p) for p in wave))
                res = ([np.asarray(o) for o in outs],)
                if helper is not None:
                    res += (await helper,)
                return res[:1] + (fleet.fleet_stats(),) + res[1:]
            finally:
                if helper is not None and not helper.done():
                    helper.cancel()
                fleet.shutdown()

        return count(lambda: asyncio.run(main()))

    def blocks_free(st, tag):
        used = {n: r["kv_cache"]["blocks_in_use"]
                for n, r in st["replicas"].items()}
        if any(used.values()):
            fail(f"[serve-fleet] {tag}: blocks still in use after every "
                 f"request finished: {used}")

    def oracle_of(params, cfg, ps, max_new):
        with torch.inference_mode():
            return [llama_generate(
                params, torch.from_numpy(p)[None].to(dev), cfg,
                max_new_tokens=max_new, temperature=0.0)[0].cpu().numpy()
                for p in ps]

    f32 = dict(max_slots=CONT_SLOTS, kv_block_size=CONT_BLOCK,
               prefill_bucket=CONT_BUCKET, seed=0, device=dev,
               config_overrides=dict(widths, dtype=torch.float32,
                                     max_seq=CONT_MAX_SEQ))

    # (a) -------------------------------------------------------------
    stats, params, cfg, mix, want = {}, None, None, None, None
    for routing in ("prefix", "round_robin"):
        fleet = build_llm_fleet("llama", preset, num_replicas=2,
                                routing=routing, fleet_name=f"a_{routing}",
                                max_new_tokens=FLEET_MAX_NEW, **f32)
        if params is None:
            rep0 = fleet.router._replicas[0].inst
            params, cfg = rep0.params, rep0.cfg
            del rep0
            mix = shared_prefix_mix(np, cfg.vocab_size, FLEET_PREFIX)
            want = oracle_of(params, cfg, mix, FLEET_MAX_NEW)
        t0 = time.perf_counter()
        outs, st = drive(fleet, [[p] for p in mix])
        wall = time.perf_counter() - t0
        check_replies(np, mix, outs, FLEET_MAX_NEW, cfg.vocab_size, routing)
        ties += gate_against_oracle(torch, np, params, cfg, mix, outs, want,
                                    f"a {routing}", "serve-fleet")
        blocks_free(st, f"(a) {routing}")
        routes = fleet.telemetry.flightrec.snapshot()
        n_route = sum(e["kind"] == "route" for e in routes)
        stats[routing] = {
            "prefix_hit_rate": st["prefix_hit_rate"],
            "routed_by_policy": st["router"]["routed_by_policy"],
            "routed": {n: r["routed"] for n, r in st["replicas"].items()},
            "route_events": n_route, "wall_s": wall}
        print(f"[serve-fleet] (a) f32 {routing}: {len(mix)} requests one at "
              f"a time in {wall:.2f} s, all equal to the oracle or parted "
              f"at a near-tie; prefix hit rate {st['prefix_hit_rate']}, "
              f"routed by policy {st['router']['routed_by_policy']}, per "
              f"replica {stats[routing]['routed']}, {n_route} route events "
              f"[{card}]", flush=True)
        if n_route != len(mix):
            fail(f"[serve-fleet] (a) {routing}: {n_route} route events for "
                 f"{len(mix)} requests")
        del fleet
    a_p, a_rr = stats["prefix"], stats["round_robin"]
    if not a_p["prefix_hit_rate"] > a_rr["prefix_hit_rate"] \
            or not a_p["routed_by_policy"]["prefix_affinity"] > 0 \
            or not all(a_p["routed"].values()) \
            or a_rr["routed_by_policy"]["round_robin"] != len(mix):
        fail(f"[serve-fleet] (a) prefix routing {a_p} against round robin "
             f"{a_rr}: expected a higher hit rate, prefix-affinity routes, "
             f"both replicas used, and all {len(mix)} round robin")
    out["a"] = stats
    del params
    freed("(a)")

    # (b) -------------------------------------------------------------
    cold = prompts[CONT_N // 4:CONT_N // 4 + CONT_N // 2]
    cold_want = oracle[CONT_N // 4:CONT_N // 4 + CONT_N // 2]
    base = cold[0][:len(cold[0]) // CONT_BLOCK * CONT_BLOCK]
    rs = np.random.RandomState(12)
    resident = None
    b = {}
    runs = (("fast", dict(), True), ("staged", dict(handoff_staged=True),
                                     True),
            ("dropped handoff", dict(chaos=ChaosConfig(drop_handoff_nth=2)),
             False))
    for tag, kw, with_resident in runs:
        fleet = build_llm_fleet(
            "llama", preset, num_prefill_replicas=1, num_decode_replicas=1,
            fleet_name=f"b_{tag.split()[0]}", max_new_tokens=CONT_MAX_NEW,
            **f32, **kw)
        dec = fleet.router._replicas[1].inst
        if resident is None:
            resident = [np.concatenate([base, rs.randint(
                2, dec.cfg.vocab_size, 3 + i)]).astype(np.int32)
                for i in range(FLEET_RESIDENT)]
            params, cfg = dec.params, dec.cfg
            res_want = oracle_of(params, cfg, resident, CONT_MAX_NEW)
        del dec
        ps = cold + (resident if with_resident else [])
        ws = cold_want + (res_want if with_resident else [])
        waves = ([cold] + [[p] for p in resident] if with_resident
                 else [[p] for p in cold])
        t0 = time.perf_counter()
        outs, st = drive(fleet, waves)
        wall = time.perf_counter() - t0
        check_replies(np, ps, outs, CONT_MAX_NEW, cfg.vocab_size, tag)
        ties += gate_against_oracle(torch, np, params, cfg, ps, outs, ws,
                                    f"b {tag}", "serve-fleet")
        blocks_free(st, f"(b) {tag}")
        by, h = st["router"]["routed_by_policy"], st["handoff"]
        kinds = [e["kind"] for e in fleet.telemetry.flightrec.snapshot()]
        dropped = kinds.count("handoff_dropped")
        b[tag] = {"routed_by_policy": by, "handoffs":
                  st["router"]["handoffs"], "handoff": h,
                  "handoff_dropped": dropped, "wall_s": wall}
        print(f"[serve-fleet] (b) f32 disaggregated, {tag}: {len(ps)} "
              f"requests in {wall:.2f} s, all equal to the oracle or parted "
              f"at a near-tie; routed by policy {by}, router handoffs "
              f"{st['router']['handoffs']}, handoff block {h}, "
              f"handoff_dropped events {dropped} [{card}]", flush=True)
        want_hand = by["disagg_prefill"] - dropped
        if st["router"]["handoffs"] != want_hand \
                or h["handoffs_in"] != want_hand \
                or by["disagg_prefill"] != len(cold):
            fail(f"[serve-fleet] (b) {tag}: {st['router']['handoffs']} "
                 f"handoffs for {by['disagg_prefill']} disagg_prefill "
                 f"routes and {dropped} drops; expected all "
                 f"{len(cold)} cold prompts routed disagg_prefill")
        if with_resident and by["prefix_affinity"] != FLEET_RESIDENT:
            fail(f"[serve-fleet] (b) {tag}: {by['prefix_affinity']} of the "
                 f"{FLEET_RESIDENT} resident-prefix prompts routed "
                 f"prefix_affinity to the decode replica")
        if dropped != (0 if with_resident else 1):
            fail(f"[serve-fleet] (b) {tag}: {dropped} handoff_dropped "
                 "events journaled")
        del fleet
    out["b"] = b
    del params
    freed("(b)")

    # (c) -------------------------------------------------------------
    rs = np.random.RandomState(5)
    bf16 = dict(max_slots=CONT_SLOTS, kv_block_size=CONT_BLOCK,
                max_new_tokens=8, seed=0, device=dev,
                config_overrides=widths)
    fleet = build_llm_fleet(
        "llama", preset, num_replicas=1, fleet_name="c_scale",
        slo=SLOConfig(ttft_ms=1e-4, e2e_ms=1e-4, objective=0.5,
                      windows_s=(30.0,), dump_on_breach=False),
        autoscale=AutoscalePolicy(
            min_replicas=1, max_replicas=2, burn_threshold=1.0,
            queue_high=1e9, sustain_s=2.0, idle_s=2.0, up_cooldown_s=0.0,
            down_cooldown_s=0.0), **bf16)
    vocab = fleet.router._replicas[0].inst.cfg.vocab_size
    sprompts = [rs.randint(2, vocab, 20).astype(np.int32) for _ in range(6)]
    acts = []

    async def episode():
        try:
            outs = [await fleet(p) for p in sprompts[:4]]
            for now in (100.0, 101.0, 102.5):
                acts.append(await fleet.autoscale_step(now=now))
            outs += [await fleet(p) for p in sprompts[4:]]
            fleet.autoscale_policy = AutoscalePolicy(
                min_replicas=1, max_replicas=2, burn_threshold=1e9,
                queue_high=1e9, sustain_s=2.0, idle_s=2.0,
                up_cooldown_s=0.0, down_cooldown_s=0.0)
            for now in (110.0, 112.5, 120.0):
                acts.append(await fleet.autoscale_step(now=now))
            outs.append(await fleet(sprompts[0]))
            return outs, fleet.fleet_stats()
        finally:
            fleet.shutdown()

    outs, st = count(lambda: asyncio.run(episode()))
    check_replies(np, sprompts + sprompts[:1], outs, 8, vocab, "c")
    with tempfile.TemporaryDirectory() as d:
        fleet.telemetry.flightrec.dump_dir = d
        doc = flightrec.load_dump(
            fleet.telemetry.flightrec.dump(reason="autoscale"))
    kinds = doc["counts_by_kind"]
    text = "\n".join(flightrec.report_lines(doc))
    routed = {n: r["routed"] for n, r in st["replicas"].items()}
    up, down = acts[2], acts[4]
    print(f"[serve-fleet] (c) bf16 autoscale: actions {acts}; routed "
          f"{routed}; flight record {kinds}; the flightrec report's "
          f"routing table:\n" + "\n".join(
              line for line in text.splitlines()
              if line.lstrip().startswith("c_scale/"))
          + f" [{card}]", flush=True)
    if acts[:2] != [None, None] or not up or up["action"] != "up" \
            or up["reason"] != "burn_rate" or up["n_replicas"] != 2 \
            or acts[3] is not None or not down or down["action"] != "down" \
            or not down["drain"]["ok"] or down["drain"]["blocks_in_use"] \
            or acts[5] is not None or st["num_replicas"] != 1 \
            or not all(routed.values()) or len(routed) != 2:
        fail(f"[serve-fleet] (c) autoscale actions {acts}, routed {routed}: "
             "expected up after the sustain window, the new replica "
             "serving, and down through a clean drain")
    if (kinds.get("route"), kinds.get("scale_up"), kinds.get("scale_down"),
            kinds.get("drain")) != (len(outs), 1, 1, 1) \
            or "routing table (route events by replica):" not in text:
        fail(f"[serve-fleet] (c) the flight record {kinds} lacks the "
             "routes, scale-up, scale-down and drain, or its report the "
             "routing table")
    out["c"] = {"actions": acts, "routed": routed, "kinds": kinds}
    del fleet
    freed("(c)")

    # (d) -------------------------------------------------------------
    fleet = build_llm_fleet(
        "llama", preset, num_replicas=2, fleet_name="d_health",
        routing="round_robin", wfq=False,
        max_inflight_per_replica=FLEET_HEALTH_CAP,
        health=HealthConfig(**TELE_HEALTH),
        chaos=ChaosConfig(seed=0, freeze_replica=0, freeze_after_waves=4,
                          freeze_waves=TELE_FREEZE_POLLS,
                          freeze_poll_ms=TELE_POLL_MS),
        max_new_tokens=CONT_MAX_NEW, **f32)
    rep0 = fleet.router._replicas[0]
    params, cfg = rep0.inst.params, rep0.inst.cfg

    pings = []

    async def ping():
        # as the reference's chaos test does: keep submitting pings
        # through the fleet until the monitor has seen replica 0 die;
        # every submit runs the router's health sweep, and the pings
        # route around the sick replica
        deadline = time.perf_counter() + FLEET_PING_DEADLINE_S
        while (fleet.health.time_to_detect_ms is None
               and time.perf_counter() < deadline):
            pings.append(asyncio.ensure_future(fleet(prompts[0])))
            await asyncio.sleep(FLEET_PING_MS / 1e3)
        return [np.asarray(o) for o in await asyncio.gather(*pings)]

    t0 = time.perf_counter()
    outs, st, ping_outs = drive(fleet, [prompts], extra=ping)
    wall = time.perf_counter() - t0
    check_replies(np, prompts, outs, CONT_MAX_NEW, cfg.vocab_size, "d")
    check_replies(np, [prompts[0]] * len(pings), ping_outs, CONT_MAX_NEW,
                  cfg.vocab_size, "d pings")
    ties += gate_against_oracle(torch, np, params, cfg,
                                [prompts[0]] * len(pings), ping_outs,
                                [oracle[0]] * len(pings), "d pings",
                                "serve-fleet")
    ties += gate_against_oracle(torch, np, params, cfg, prompts, outs,
                                oracle, "d health+chaos", "serve-fleet")
    hb = st["health"]
    log = [(x["from"], x["to"], x["reason"])
           for x in hb["replicas"][rep0.name]["transitions"]]
    print(f"[serve-fleet] (d) f32 health + chaos freeze of replica 0 "
          f"({TELE_FREEZE_POLLS} polls of {TELE_POLL_MS} ms): {len(prompts)} "
          f"requests and {len(pings)} pings (one each {FLEET_PING_MS:g} ms "
          f"until the monitor found replica 0 dead) in {wall:.2f} s, equal "
          f"to the oracle or parted at a near-tie; replica 0 transitions "
          f"{log}; requeued_on_death "
          f"{hb['requeued_on_death']}; time_to_detect_ms "
          f"{hb['time_to_detect_ms']}; routed "
          f"{ {n: r['routed'] for n, r in st['replicas'].items()} } "
          f"[{card}]", flush=True)
    if ("suspect", "dead", "heartbeat_lost") not in log \
            or hb["requeued_on_death"] < 1 \
            or st["router"]["requeued_on_death"] != hb["requeued_on_death"]:
        fail("[serve-fleet] (d) replica 0 did not go dead in the monitor's "
             "log, or nothing of its queue was requeued")
    blocks_free(st, "(d)")
    # the dump tools/incidents.py reads in phase vision (e)
    dump = os.path.join(tempfile.mkdtemp(prefix="chip_smoke_chaos_"),
                        "chaos_dump.json")
    tracebus.write_dump(tracebus.collect(fleet), dump)
    out["d"] = {"transitions": log, "requeued_on_death":
                hb["requeued_on_death"], "time_to_detect_ms":
                hb["time_to_detect_ms"], "pings": len(pings), "wall_s": wall,
                "dump": dump, "frozen": rep0.name}
    del fleet, rep0, params
    freed("(d)")

    # (e) -------------------------------------------------------------
    # the reference's fleet traffic (bench.py main_traffic_fleet) at
    # llama's vocabulary; its SLO without the breach dumps
    vocab = cfg.vocab_size
    tenants = (TenantSpec("interactive", rate_share=1.0,
                          slo_class="interactive", prefix_groups=(0, 1),
                          ttft_slo_ms=FLEET_SLO_MS / 2,
                          e2e_slo_ms=FLEET_SLO_MS),
               TenantSpec("batch", rate_share=1.0, slo_class="batch",
                          prefix_groups=(2, 3), e2e_slo_ms=2 * FLEET_SLO_MS))
    spec = TrafficSpec(num_requests=timed_n, seed=0, rate_rps=rate,
                       num_prefix_groups=4, prefix_len=FLEET_PREFIX,
                       p_shared=0.75, tail_len_mean=32.0, tail_len_max=128,
                       vocab=vocab, tenants=tenants)
    kw = dict(family="llama", preset=preset, kv_block_size=CONT_BLOCK,
              max_slots=FLEET_TIMED_SLOTS, max_new_tokens=FLEET_TIMED_NEW,
              prefill_bucket=FLEET_TIMED_BUCKET, config_overrides=widths,
              slo=SLOConfig(ttft_ms=FLEET_SLO_MS / 2, e2e_ms=FLEET_SLO_MS,
                            dump_on_breach=False), device=dev)
    timed = {}
    with tempfile.TemporaryDirectory() as d:
        # each side once a time scale, the first side alternating
        for scale, order in ((0.0, ("single", "fleet")),
                             (1.0, ("fleet", "single"))):
            for i, mode in enumerate(order):
                dump = os.path.join(d, f"{mode}_{scale:g}_{i}.json")
                spy = _RouterCostSpy(torch, guard=on_card)
                try:
                    sync()
                    if mode == "fleet":
                        rep = count(lambda: run_traffic_fleet(
                            spec, num_replicas=2, time_scale=scale,
                            trace_dump=dump, **kw))
                        hit = rep["router_prefix_hit_rate"]
                    else:
                        rep = count(lambda: run_traffic(
                            spec, time_scale=scale, trace_dump=dump, **kw))
                        hit = rep["prefix_hit_rate"]
                finally:
                    spy.restore()
                if rep["completed"] != timed_n or rep["shed"]:
                    fail(f"[serve-fleet] (e) {mode}: {rep['completed']} of "
                         f"{timed_n} requests completed")
                doc = tracebus.load_dump(dump)
                per = _tenant_stats(np, doc, tenants)
                run = {"tokens_per_s": timed_n * FLEET_TIMED_NEW
                       / rep["wall_s"], "wall_s": rep["wall_s"],
                       "p50_ms": rep["latency_ms"]["p50"],
                       "p95_ms": rep["latency_ms"]["p95"],
                       "by_tenant": per, "prefix_hit_rate": hit,
                       "router_s": spy.seconds,
                       "router_share": spy.seconds / rep["wall_s"],
                       "router_calls": spy.calls}
                if mode == "fleet":
                    run["tenant_slo_attainment"] = \
                        rep["tenant_slo_attainment"]
                timed.setdefault(f"{mode} time_scale={scale:g}",
                                 []).append(run)
                print(f"[serve-fleet] (e) bf16 {mode}"
                      f"{' (2 replicas)' if mode == 'fleet' else ''}, "
                      f"time_scale {scale:g}: {timed_n} requests (+"
                      f"{FLEET_TIMED_NEW} each) in {rep['wall_s']:.3f} s, "
                      f"{run['tokens_per_s']:.1f} served tokens/s; request "
                      f"latency p50 {run['p50_ms']:.1f} ms, p95 "
                      f"{run['p95_ms']:.1f} ms; by tenant " + "; ".join(
                          f"{t}: n {v['n']}, latency p50 {v['p50_ms']:.1f} "
                          f"p95 {v['p95_ms']:.1f} ms, TTFT p50 "
                          f"{v['ttft_p50_ms']:.1f} p95 {v['ttft_p95_ms']:.1f}"
                          f" ms, within its targets " + ", ".join(
                              f"{k[:-11]} {v[k]:.4f}" for k in v
                              if k.endswith("_attainment"))
                          for t, v in per.items())
                      + f"; prefix hit rate {hit}; router host work "
                      f"{spy.seconds * 1e3:.2f} ms in {spy.calls} calls "
                      f"({100 * run['router_share']:.3f}% of the wall)"
                      + (f"; fleet tenant report "
                         f"{run['tenant_slo_attainment']}"
                         if mode == "fleet" else "") + f" [{card}]",
                      flush=True)
                if mode == "fleet" and i == 1 and scale == 0.0:
                    gate_dump(doc, dump, card)
                del spy, rep, doc
    out["e"] = timed
    freed("(e)")
    print(f"[serve-fleet] kernel launches of the fleet runs: {launches} (the "
          f"path runs plain PyTorch) [{card}]", flush=True)
    if any(launches.values()):
        fail("[serve-fleet] the fleet launched a kernel; its replicas' "
             "prefills and decode are plain PyTorch")
    return {"counts": launches, "near_ties": ties, **out}


def gate_dump(doc: dict, dump: str, card: str) -> None:
    """The tracebus CLI's report on a fleet dump exits 0 (run as its own
    process, as a user runs it), and every completed request's
    critical-path components sum to its e2e within FLEET_CP_TOL."""
    from ray_tpu_torch.serve.telemetry import CRITICAL_PATH_COMPONENTS

    proc = subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch.tools.tracebus", "report",
         dump], capture_output=True, text=True,
        cwd=str(Path(__file__).resolve().parent), timeout=120)
    worst = 0.0
    for r in doc["requests"]:
        cp = r.get("critical_path")
        if cp and cp["e2e_ms"] > 0:
            worst = max(worst, abs(sum(
                cp[k] for k in CRITICAL_PATH_COMPONENTS) - cp["e2e_ms"])
                / cp["e2e_ms"])
    print(f"[serve-fleet] (e) tracebus report on the fleet's dump (exit "
          f"{proc.returncode}):\n{proc.stdout.rstrip()}\n[serve-fleet] (e) "
          f"critical path: components vs e2e, worst relative gap "
          f"{worst:.3e} over {len(doc['requests'])} requests [{card}]",
          flush=True)
    if proc.returncode != 0:
        fail(f"[serve-fleet] (e) python -m ray_tpu_torch.tools.tracebus "
             f"report exited {proc.returncode}: {proc.stderr[-2000:]}")
    if worst > FLEET_CP_TOL:
        fail(f"[serve-fleet] (e) a request's critical-path components "
             f"part from its e2e by {worst:.3e} > {FLEET_CP_TOL}")


#: phase serve-run: llama-1b through serve.run on the core runtime, 8
#: equal-length prompts of 512 tokens, +16 (phase serve-llama's shape),
#: the batch scheduler, in a replica actor holding the card
RUN_B, RUN_T, RUN_NEW = 8, 512, 16
#: (c): host values of 256 MiB and a bf16 CUDA tensor of 64 MiB, each at
#: most a quarter of the store
RUN_HOST_BYTES, RUN_CUDA_BYTES = 256 * 2**20, 64 * 2**20
#: the store: the runtime's default (2 GiB) at most, and at most half of
#: what /dev/shm has free (a write past a tmpfs's size is a SIGBUS)
RUN_STORE_MAX = 2 * 2**30
#: (f): the card's free memory back within this of its value before (d)
RUN_MEM_TOL = 256 * 2**20
#: how long (d) and (f) wait for it: a process that has exited may hand
#: its memory back to the card a moment later
RUN_MEM_WAIT_S = 30.0
#: (e): replica, engine, engine, replica, RUN_TURNS times; per turn and
#: side RUN_ONE_TOKEN sequential requests of a 1-token prompt (serve-http's
#: (c) takes its turns too)
RUN_TURNS, RUN_ONE_TOKEN = 1, 5
#: (a): ray_perf's trials, scaled
RUN_PERF_SCALE = 0.25


class ServeRunLLM:
    """Phase serve-run's deployment: build_llm_deployment's llama engine
    (batch scheduler) in a replica actor, counting its generate calls
    (one prefill each) so that the replica can report its flash launches
    against its prefills.  Defined in this script, it travels to the
    replica by value (cloudpickle of a class of ``__main__``)."""

    def __init__(self, preset, dtype, device, widths, batch, max_new):
        import importlib

        import torch

        from ray_tpu_torch.serve import build_llm_deployment

        over = dict(widths or {})
        if dtype is not None:
            over["dtype"] = getattr(torch, dtype)
        self.engine = build_llm_deployment(
            "llama", preset, scheduler="batch", max_batch_size=batch,
            max_new_tokens=max_new, seed=0, device=device,
            config_overrides=over).func_or_class()
        self._fa = importlib.import_module(
            "ray_tpu_torch.ops.flash_attention")
        self.prefills = []
        generate = self.engine._generate

        def counted(toks, lengths=None):
            self.prefills.append(int(toks.shape[0]))
            return generate(toks, lengths)

        self.engine._generate = counted

    async def __call__(self, prompt):
        return await self.engine(prompt)

    def engine_stats(self):
        return self.engine.engine_stats()

    def counts(self, reset: bool = False) -> dict:
        """The replica's flash forward launches and prefill batch sizes
        (zeroed after reading when ``reset``), its process and card."""
        import os

        out = {"flash_fwd": self._fa.FLASH_FWD_LAUNCHES,
               "prefills": list(self.prefills), "pid": os.getpid(),
               "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
               "device": str(self.engine.device),
               "foreign": sorted({m.split(".")[0] for m in sys.modules}
                                 & {"jax", "jaxlib", "ray_tpu"})}
        if reset:
            self._fa.FLASH_FWD_LAUNCHES = 0
            self.prefills = []
        return out


def _run_grant_probe(bh: int, t: int, d: int) -> dict:
    """(b), in a task granted one card: what it sees, and the flash
    forward kernel at the prefill's shape (causal, bf16) against its
    plain version; the launches counted around the kernel's call."""
    import os

    import torch

    fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")
    g = torch.Generator(device="cuda").manual_seed(5)
    q, k, v = (torch.randn((bh, t, d), generator=g, device="cuda")
               .to(torch.bfloat16) for _ in range(3))
    scale = 1.0 / math.sqrt(d)
    fa.FLASH_FWD_LAUNCHES = 0
    o, lse = fa.flash_attention_fwd(q, k, v, scale=scale, causal=True)
    launches = fa.FLASH_FWD_LAUNCHES
    o_ref, lse_ref = fa.flash_attention_fwd_reference(q, k, v, scale=scale,
                                                      causal=True)
    torch.cuda.synchronize()
    return {"visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
            "name": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
            "foreign": sorted({m.split(".")[0] for m in sys.modules}
                              & {"jax", "jaxlib", "ray_tpu"}),
            "launches": launches,
            "err_o": (o.float() - o_ref.float()).abs().max().item(),
            "err_lse": (lse - lse_ref).abs().max().item()}


def _run_no_grant() -> dict:
    """(b), in a task without a grant."""
    import os

    import torch

    return {"visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
            "cuda": torch.cuda.is_available()}


def _run_resolve_default():
    """(b), in a task without a grant: the port's default device."""
    from ray_tpu_torch import resolve_device

    return str(resolve_device(None))


def _run_echo(x):
    return x


def _run_cuda_tensor(nbytes: int, seed: int):
    """(c): a bf16 tensor made on the task's card from a seed."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(nbytes // 2, generator=g, device="cuda",
                       dtype=torch.bfloat16)


def _run_retire_gpu_workers(rt) -> None:
    """Free the card of the pooled (idle) task workers (b) and (c)
    leave holding a CUDA context: an actor granted every card makes the
    node retire them, then goes itself."""
    import os

    @rt.remote(num_gpus=int(rt.cluster_resources().get("GPU", 0)))
    class _Holder:
        def pid(self):
            return os.getpid()

    holder = _Holder.remote()
    pid = rt.get(holder.pid.remote(), timeout=120)
    rt.kill(holder)
    _run_wait_exit([pid], "the card-holding actor")


def _run_wait_exit(pids, what: str, timeout: float = 30.0) -> None:
    import os

    def alive(pid):
        try:
            os.kill(pid, 0)
        except ProcessLookupError:
            return False
        try:  # an exited child not yet reaped is a zombie
            with open(f"/proc/{pid}/stat") as f:
                return f.read().rsplit(")", 1)[-1].split()[0] != "Z"
        except OSError:
            return False

    deadline = time.monotonic() + timeout
    left = list(pids)
    while left and time.monotonic() < deadline:
        left = [p for p in left if alive(p)]
        time.sleep(0.05)
    if left:
        fail(f"[serve-run] {what}: processes {left} still alive "
             f"{timeout:.0f} s after")


def _key_tree(d):
    if isinstance(d, dict):
        return {k: _key_tree(v) for k, v in d.items()}
    return None


def phase_serve_run(torch, np, fa, card: str, preset="llama-1b",
                    device="cuda", widths=None,
                    turns: int = RUN_TURNS) -> dict:
    """llama-1b through ``serve.run`` on the port's core runtime: (a)
    the runtime on the card's host (its store sized from /dev/shm, the
    GPU resource, ray_perf's rates and the vendored msgpack's cost a
    message); (b) a task granted the card sees it alone, and no JAX,
    and runs the flash forward at the prefill's shape against its plain
    version; a task without a grant sees no card and the default device
    raises; (c) objects driver -> task -> driver bitwise, a CUDA tensor
    made in a task arriving on cuda:0, put/get GB/s; (d) f32: the
    deployment as a replica actor granted the card, 8 prompts at once,
    each reply the in-process engine's (or a near-tie of its logits),
    16 flash launches per prefill in the replica, status and
    engine_stats; (e) bf16: the replica and the in-process engine in
    turns (served tokens/s, a 1-token request's p50 through the handle
    and direct, serve.run to first reply); (f) delete frees the card,
    shutdown leaves no worker.  ``preset``, ``device`` and ``widths``
    let it run cut down elsewhere (then without (b), (c)'s CUDA tensor
    and the card's memory)."""
    import gc
    import shutil

    import ray_tpu_torch as rt
    from ray_tpu_torch import serve as rserve
    from ray_tpu_torch._private import ray_perf, worker_context
    from ray_tpu_torch._private._vendor import msgpack
    from ray_tpu_torch.serve import build_llm_deployment

    t_phase = time.perf_counter()
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    widths = dict(widths or {})
    out = {"counts": {"flash_fwd": 0, "flash_bwd_dq": 0,
                      "flash_bwd_dkv": 0}}

    def free_mem(tag):
        gc.collect()
        if not on_card:
            return 0
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        free, total = torch.cuda.mem_get_info()
        print(f"[serve-run] card memory {tag}: {free / 2**30:.3f} GiB "
              f"free of {total / 2**30:.3f} [{card}]", flush=True)
        return free

    free_mem("at the phase's start (the driver's engines freed)")

    def memory_back(free0, tag):
        """The card's free memory once it is back within RUN_MEM_TOL of
        ``free0``, read until RUN_MEM_WAIT_S have passed; past that, the
        card's processes and the driver's own memory are printed and
        the last reading returned."""
        deadline = time.monotonic() + RUN_MEM_WAIT_S
        while True:
            free = free_mem(tag)
            if not on_card or abs(free - free0) <= RUN_MEM_TOL or \
                    time.monotonic() > deadline:
                break
            time.sleep(1.0)
        if on_card and abs(free - free0) > RUN_MEM_TOL:
            apps = subprocess.run(
                ["nvidia-smi", "--query-compute-apps=pid,process_name,"
                 "used_memory", "--format=csv,noheader"],
                capture_output=True, text=True, timeout=60).stdout
            print(f"[serve-run] {tag}: the card's processes {apps!r}; the "
                  f"driver's allocated {torch.cuda.memory_allocated()} "
                  f"bytes, reserved {torch.cuda.memory_reserved()}",
                  flush=True)
        return free

    # (a) the runtime, its store sized to /dev/shm
    df = subprocess.run(["df", "-B1", "/dev/shm"], capture_output=True,
                        text=True, timeout=30)
    shm_free = shutil.disk_usage("/dev/shm").free
    store = min(RUN_STORE_MAX, shm_free // 2) // 2**20 * 2**20
    print(f"[serve-run] (a) df -B1 /dev/shm:\n{df.stdout.rstrip()}\n"
          f"[serve-run] (a) object store {store} bytes ({store / 2**20:.0f} "
          f"MiB: min(2 GiB, half of /dev/shm's {shm_free} free))",
          flush=True)
    t0 = time.perf_counter()
    rt.init(num_cpus=4, object_store_memory=store)
    res = rt.cluster_resources()
    print(f"[serve-run] (a) init in {time.perf_counter() - t0:.2f} s; "
          f"cluster_resources {res}", flush=True)
    want_gpus = torch.cuda.device_count() if on_card else 0
    if res.get("GPU", 0) != want_gpus:
        fail(f"[serve-run] (a) cluster_resources GPU {res.get('GPU')} != "
             f"torch.cuda.device_count() {want_gpus}")
    perf = {r["benchmark"]: r["value"]
            for r in ray_perf.main(RUN_PERF_SCALE)}
    msg = {"task_id": bytes(24), "fid": bytes(20), "job_id": bytes(4),
           "name": "ping", "args": [{"k": "v", "d": bytes(64)}],
           "kwargs": {}, "num_returns": 1, "caller": bytes(16),
           "caller_addr": "/tmp/raytpu_torch/s_00000000/sockets/worker",
           "seqno": 7, "resources": {"CPU": 1.0}}
    n_msg = 2000
    t0 = time.perf_counter()
    for _ in range(n_msg):
        msgpack.unpackb(msgpack.packb(msg), raw=False)
    codec_us = (time.perf_counter() - t0) / n_msg * 1e6
    out["ray_perf"] = perf
    out["msgpack_us"] = codec_us
    print(f"[serve-run] (a) ray_perf x{RUN_PERF_SCALE}: "
          f"{perf['task_roundtrip']} tasks/s round trip "
          f"({1e6 / perf['task_roundtrip']:.0f} us), "
          f"{perf['actor_call_roundtrip']} actor calls/s "
          f"({1e6 / perf['actor_call_roundtrip']:.0f} us), put/get 10 MB "
          f"{perf['put_10MB_gbps']} / {perf['get_10MB_gbps']} GB/s; the "
          f"vendored (pure-Python) msgpack: {codec_us:.1f} us to pack and "
          f"unpack a task's spec [{card}]", flush=True)

    # (b) the grant
    if on_card:
        bh = RUN_B * 32 if preset == "llama-1b" else RUN_B * 4
        probe = rt.get(rt.remote(num_gpus=1)(_run_grant_probe).remote(
            bh, RUN_T, 64), timeout=300)
        print(f"[serve-run] (b) granted task: CUDA_VISIBLE_DEVICES="
              f"{probe['visible']!r}, {probe['count']} card(s), "
              f"{probe['name']}, jax/ray_tpu imported: {probe['foreign']}; "
              f"flash forward (B*H={bh}, T={RUN_T}, D=64, causal, bf16) "
              f"vs plain: max|o| {probe['err_o']:.3e} (tol "
              f"{TOL[('bf16', 'o')]:.0e}), max|lse| {probe['err_lse']:.3e} "
              f"(tol {TOL[('bf16', 'lse')]:.0e}), {probe['launches']} "
              f"launch", flush=True)
        if probe["visible"] != "0" or probe["count"] != 1 or \
                probe["name"] != torch.cuda.get_device_name(0) or \
                probe["foreign"]:
            fail("[serve-run] (b) the granted task does not see the card "
                 "alone, or imported jax/ray_tpu")
        if probe["launches"] != 1 or \
                probe["err_o"] > TOL[("bf16", "o")] or \
                probe["err_lse"] > TOL[("bf16", "lse")]:
            fail("[serve-run] (b) the flash forward in the granted task "
                 "did not launch once or disagrees with its plain version")
    bare = rt.get(rt.remote(_run_no_grant).remote(), timeout=300)
    try:
        rt.get(rt.remote(_run_resolve_default).remote(), timeout=120)
        raised = None
    except rt.exceptions.RayTaskError as e:
        raised = str(e).split("\n")[0]
    print(f"[serve-run] (b) task without a grant: CUDA_VISIBLE_DEVICES="
          f"{bare['visible']!r}, torch.cuda.is_available() {bare['cuda']}; "
          f"resolve_device(None) raised: {raised}", flush=True)
    if bare["visible"] != "" or bare["cuda"] or raised is None or \
            "no CUDA device" not in raised:
        fail("[serve-run] (b) a task without a grant saw a card, or its "
             "default device did not raise 'no CUDA device'")

    # (c) objects, driver -> task -> driver, bitwise
    echo = rt.remote(_run_echo)
    host_bytes = min(RUN_HOST_BYTES, store // 4)
    rng = np.random.default_rng(9)
    values = {"numpy": rng.standard_normal(host_bytes // 8),
              "cpu_f32": torch.from_numpy(rng.standard_normal(
                  host_bytes // 4, dtype=np.float32))}
    out["objects"] = {}

    def timed_get(ref):
        rt.wait([ref], num_returns=1, timeout=300)
        t0 = time.perf_counter()
        value = rt.get(ref, timeout=300)
        return value, time.perf_counter() - t0

    def report(kind, nbytes, put_s, get_s, same, extra=""):
        out["objects"][kind] = {"bytes": nbytes, "put_gbps":
                                nbytes / put_s / 1e9,
                                "get_gbps": nbytes / get_s / 1e9}
        print(f"[serve-run] (c) {kind} of {nbytes / 2**20:.0f} MiB "
              f"driver -> task -> driver: bitwise equal {same}{extra}; put "
              f"{nbytes / put_s / 1e9:.3f} GB/s, get "
              f"{nbytes / get_s / 1e9:.3f} GB/s [{card}]", flush=True)
        if not same:
            fail(f"[serve-run] (c) the {kind} came back changed")

    for kind, value in values.items():
        t0 = time.perf_counter()
        ref = rt.put(value)
        put_s = time.perf_counter() - t0
        back, get_s = timed_get(echo.remote(ref))
        if kind == "numpy":
            same = back.dtype == value.dtype and np.array_equal(
                back.view(np.uint8), value.view(np.uint8))
        else:
            same = back.dtype == value.dtype and torch.equal(
                back.view(torch.uint8), value.view(torch.uint8))
        report(kind, value.nbytes if kind == "numpy"
               else value.numel() * 4, put_s, get_s, same)
        del ref, back
    del values
    if on_card:
        cuda_bytes = min(RUN_CUDA_BYTES, store // 4)
        made, get_s = timed_get(rt.remote(num_gpus=1)(
            _run_cuda_tensor).remote(cuda_bytes, 11))
        want = _run_cuda_tensor(cuda_bytes, 11)
        same = made.device == torch.device("cuda:0") and torch.equal(
            made.view(torch.int16), want.view(torch.int16))
        t0 = time.perf_counter()
        ref = rt.put(want)
        put_s = time.perf_counter() - t0
        back = rt.get(ref, timeout=300)
        same = same and back.device == torch.device("cuda:0") and \
            torch.equal(back.view(torch.int16), want.view(torch.int16))
        report("cuda_bf16", cuda_bytes, put_s, get_s, same,
               f" (made in a granted task, arrived on {made.device})")
        del made, want, ref, back
        _run_retire_gpu_workers(rt)

    # (d) serve.run, f32: the replica's replies against the in-process
    # engine's, the replica's flash launches against its prefills.  The
    # driver's two in-process engines (f32, and bf16 for (e)) are built
    # and run first and live until (f), so that what the card's free
    # memory shows between here and (f) is the replicas' alone (the
    # driver's first use of an op loads its kernels and cuBLAS's
    # workspace, which no empty_cache() gives back)
    rng = np.random.default_rng(12)
    engine = build_llm_deployment(
        "llama", preset, scheduler="batch", max_batch_size=RUN_B,
        max_new_tokens=RUN_NEW, seed=0, device=dev,
        config_overrides={"dtype": torch.float32, **widths}).func_or_class()
    cfg = engine.cfg
    prompts = [rng.integers(0, cfg.vocab_size, size=RUN_T, dtype=np.int32)
               for _ in range(RUN_B)]
    one = [rng.integers(0, cfg.vocab_size, size=1, dtype=np.int32)
           for _ in range(RUN_ONE_TOKEN)]
    want = asyncio.run(_serve_all(engine, prompts))
    engine_bf16 = build_llm_deployment(
        "llama", preset, scheduler="batch", max_batch_size=RUN_B,
        max_new_tokens=RUN_NEW, seed=0, device=dev,
        config_overrides=widths or None).func_or_class()
    asyncio.run(_serve_all(engine_bf16, prompts))
    asyncio.run(engine_bf16(one[0]))
    free0 = free_mem("before (d)'s replica (the driver's two engines up)")
    grant = {"num_gpus": 1} if on_card else None
    dep = rserve.deployment(ServeRunLLM).options(
        name="serve_run_f32", ray_actor_options=grant,
        max_concurrent_queries=RUN_B)
    t0 = time.perf_counter()
    h = rserve.run(dep.bind(preset, "float32", None if on_card else device,
                            widths, RUN_B, RUN_NEW))
    rt.get(h.remote(prompts[0]), timeout=600)
    first_f32 = time.perf_counter() - t0
    before = rt.get(h.method("counts").remote(reset=True), timeout=60)
    t0 = time.perf_counter()
    got = rt.get([h.remote(p) for p in prompts], timeout=600)
    wall = time.perf_counter() - t0
    after = rt.get(h.method("counts").remote(), timeout=60)
    check_replies(np, prompts, got, RUN_NEW, cfg.vocab_size, "serve-run")
    ties = gate_against_oracle(torch, np, engine.params, cfg, prompts, got,
                               want, "f32 replica", phase="serve-run")
    equal = sum(bool(np.array_equal(a, b)) for a, b in zip(got, want))
    launches, prefills = after["flash_fwd"], after["prefills"]
    out["counts"]["flash_fwd"] = launches
    print(f"[serve-run] (d) f32 replica (pid {after['pid']}, "
          f"CUDA_VISIBLE_DEVICES={after['visible']!r}, engine on "
          f"{after['device']}, jax/ray_tpu imported: {after['foreign']}): "
          f"serve.run to its first reply {first_f32:.2f} s; {RUN_B} x "
          f"{RUN_T}-token requests at once in {wall * 1e3:.1f} ms: "
          f"{equal}/{RUN_B} replies equal to the in-process engine's, "
          f"{len(ties)} parted at a near-tie; {launches} flash launches "
          f"for prefills of {prefills} ({cfg.n_layer} layers) [{card}]",
          flush=True)
    if before["flash_fwd"] != (cfg.n_layer if on_card else 0) or \
            before["foreign"] or after["foreign"]:
        fail(f"[serve-run] (d) the replica's warm-up launched "
             f"{before['flash_fwd']} flash forwards, or it imported "
             f"jax/ray_tpu")
    if on_card and (after["visible"] != "0" or after["device"] != "cuda:0"):
        fail("[serve-run] (d) the replica does not hold the card as cuda:0")
    if not prefills or launches != (cfg.n_layer * len(prefills)
                                    if on_card else 0):
        fail(f"[serve-run] (d) {launches} flash launches in the replica "
             f"for {len(prefills)} prefills, expected {cfg.n_layer} each")
    status = rserve.status()
    # engine_stats()["programs"] is keyed by the programs the process's
    # registry holds: the driver's holds every earlier phase's too, so
    # that level is compared on the replica's programs
    remote = _key_tree(rserve.engine_stats("serve_run_f32"))
    local = _key_tree(engine.engine_stats())
    names = set(remote.get("programs") or {})
    same_tree = names <= set(local.get("programs") or {}) and remote == {
        **local, "programs": {k: v for k, v in
                              (local.get("programs") or {}).items()
                              if k in names}}
    print(f"[serve-run] (d) serve.status(): {status}; engine_stats() key "
          f"tree equal to the in-process engine's: {same_tree} (the "
          f"replica's programs {sorted(names)})", flush=True)
    if status.get("serve_run_f32", {}).get("replicas") != 1:
        fail("[serve-run] (d) serve.status() does not show the deployment "
             "with 1 replica")
    if not same_tree:
        fail("[serve-run] (d) serve.engine_stats() key tree differs from "
             "the in-process engine's")
    f32_pid = after["pid"]
    rserve.delete("serve_run_f32")
    _run_wait_exit([f32_pid], "the f32 replica after serve.delete")
    out.update(first_reply_f32_s=first_f32, ties=ties, equal=equal)
    free_d = memory_back(free0, "after (d)'s serve.delete")
    if on_card and abs(free_d - free0) > RUN_MEM_TOL:
        fail(f"[serve-run] (d) the card's free memory {free_d} is not back "
             f"within {RUN_MEM_TOL} of {free0} after the f32 replica")

    # (e) bf16, the replica and the in-process engine in turns
    dep = rserve.deployment(ServeRunLLM).options(
        name="serve_run_bf16", ray_actor_options=grant,
        max_concurrent_queries=RUN_B)
    t0 = time.perf_counter()
    h = rserve.run(dep.bind(preset, None, None if on_card else device,
                            widths, RUN_B, RUN_NEW))
    rt.get(h.remote(prompts[0]), timeout=600)
    first = time.perf_counter() - t0
    noop = []
    for _ in range(4 * RUN_ONE_TOKEN):
        t0 = time.perf_counter()
        rt.get(h.method("counts").remote(), timeout=60)
        noop.append(time.perf_counter() - t0)
    noop_ms = sorted(noop)[len(noop) // 2] * 1e3

    def replica_turn():
        t0 = time.perf_counter()
        rt.get([h.remote(p) for p in prompts], timeout=600)
        wall = time.perf_counter() - t0
        lat = []
        for p in one:
            t0 = time.perf_counter()
            rt.get(h.remote(p), timeout=600)
            lat.append(time.perf_counter() - t0)
        return wall, lat

    def engine_turn():
        t0 = time.perf_counter()
        asyncio.run(_serve_all(engine_bf16, prompts))
        wall = time.perf_counter() - t0
        lat = []
        for p in one:
            t0 = time.perf_counter()
            asyncio.run(engine_bf16(p))
            lat.append(time.perf_counter() - t0)
        return wall, lat

    walls, lats = {"replica": [], "engine": []}, {"replica": [],
                                                  "engine": []}
    for side in ["replica", "engine", "engine", "replica"] * turns:
        wall, lat = (replica_turn if side == "replica" else engine_turn)()
        walls[side].append(wall)
        lats[side].extend(lat)
    tps = {k: [RUN_B * RUN_NEW / w for w in v] for k, v in walls.items()}
    p50 = {k: sorted(v)[len(v) // 2] * 1e3 for k, v in lats.items()}
    ratio = [r / e for r, e in zip(tps["replica"], tps["engine"])]
    out.update(first_reply_s=first, tokens_per_s=tps, one_token_p50_ms=p50,
               handle_overhead_ms=p50["replica"] - p50["engine"],
               handle_noop_ms=noop_ms)
    print(f"[serve-run] (e) bf16, in turns (replica, engine, engine, "
          f"replica) x{turns}: served tokens/s through serve.run "
          f"{[round(x, 1) for x in tps['replica']]}, in process "
          f"{[round(x, 1) for x in tps['engine']]} (replica / engine "
          f"{[round(x, 3) for x in ratio]}); a 1-token request, p50 of "
          f"{len(lats['replica'])}: {p50['replica']:.2f} ms through the "
          f"handle, {p50['engine']:.2f} ms direct (handle overhead "
          f"{p50['replica'] - p50['engine']:.2f} ms); a no-op method "
          f"through the handle, p50 of {len(noop)}: {noop_ms:.3f} ms; "
          f"serve.run to first reply {first:.2f} s [{card}]", flush=True)

    # (f) teardown frees the card and leaves no worker
    bf16_pid = rt.get(h.method("counts").remote(), timeout=60)["pid"]
    rserve.delete("serve_run_bf16")
    _run_wait_exit([bf16_pid], "the bf16 replica after serve.delete")
    free1 = memory_back(free0, "after (f)'s serve.delete")
    if on_card and abs(free1 - free0) > RUN_MEM_TOL:
        fail(f"[serve-run] (f) the card's free memory {free1} is not back "
             f"within {RUN_MEM_TOL} of {free0} (before (d))")
    del engine, engine_bf16, want, got
    node = worker_context.node()
    pids = [w.pid for w in list(node.node_manager.workers.values())]
    rserve.shutdown()
    rt.shutdown()
    _run_wait_exit(pids, "the session's workers after shutdown()")
    secs = time.perf_counter() - t_phase
    out["phase_s"] = secs
    print(f"[serve-run] (f) serve.delete: the replica exited, the card "
          f"back to {free1 / 2**30:.3f} GiB free ({(free1 - free0) / 2**20:+.1f}"
          f" MiB against before (d)); shutdown: none of the session's "
          f"{len(pids)} workers alive; the phase in {secs:.1f} s [{card}]",
          flush=True)
    return out


#: phase serve-http: the cluster started by the port's CLI (a head with
#: no card, a worker node with it), llama-1b deployed by serve.schema.apply
#: and reached over HTTP through the proxy on the head
HTTP_NOOP_N = 40
#: (d): the publisher's interval is 5 s; its lines must show within 3
HTTP_PUBLISH_WAIT_S = 3 * 5.0


def _cli(*args, timeout: float = 120.0, check: bool = True):
    """``python -m ray_tpu_torch <args>`` from the repo's root."""
    import os

    root = str(Path(__file__).resolve().parent)
    env = dict(os.environ)
    env["PYTHONPATH"] = root + ":" + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-m", "ray_tpu_torch", *args],
                          cwd=root, env=env, capture_output=True,
                          text=True, timeout=timeout)
    if check and proc.returncode != 0:
        fail(f"[serve-http] `python -m ray_tpu_torch {' '.join(args)}` "
             f"exited {proc.returncode}:\n{proc.stdout[-2000:]}\n"
             f"{proc.stderr[-3000:]}")
    return proc


def _cli_node(args, needle: str, timeout: float = 120.0):
    """Start a node with the CLI; its process and the line holding
    ``needle``, read from its output within ``timeout``."""
    import os
    import queue
    import threading

    root = str(Path(__file__).resolve().parent)
    env = dict(os.environ)
    env["PYTHONPATH"] = root + ":" + env.get("PYTHONPATH", "")
    proc = subprocess.Popen(
        [sys.executable, "-m", "ray_tpu_torch", "start", *args], cwd=root,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    lines: "queue.Queue" = queue.Queue()

    def pump():
        for line in proc.stdout:
            lines.put(line)

    threading.Thread(target=pump, daemon=True).start()
    seen = []
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            line = lines.get(timeout=0.2)
        except queue.Empty:
            if proc.poll() is not None:
                break
            continue
        seen.append(line)
        if needle in line:
            return proc, line.strip()
    proc.kill()
    fail(f"[serve-http] (a) `start {' '.join(args)}` did not print "
         f"{needle!r}: {''.join(seen)[-2000:]}")


def _http_post(url: str, payload, timeout: float = 600.0):
    import urllib.request

    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(), method="POST",
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, json.loads(r.read())


def _parse_array_repr(np, text: str):
    """The int32 array the batch engine returned, from the proxy's
    ``{"result": repr(array)}`` (the reference's reply for a result that
    is not JSON)."""
    if not text.startswith("array([") or "dtype=int32" not in text:
        fail(f"[serve-http] a reply is not an int32 array's repr: "
             f"{text[:200]!r}")
    inner = text.split("[", 1)[1].split("]", 1)[0]
    return np.array([int(x) for x in inner.replace(",", " ").split()],
                    dtype=np.int32)


def _http_all(url: str, payloads, timeout: float = 600.0) -> list:
    """POST every payload at once, one thread each; the replies in
    order."""
    import threading

    out = [None] * len(payloads)

    def send(i):
        try:
            out[i] = _http_post(url, payloads[i], timeout)
        except Exception as e:  # noqa: BLE001 - read below
            out[i] = (None, repr(e))

    threads = [threading.Thread(target=send, args=(i,))
               for i in range(len(payloads))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout + 30)
    for i, (status, body) in enumerate(out):
        if status != 200:
            fail(f"[serve-http] HTTP request {i} failed: {status} {body}")
    return [body for _, body in out]


def _http_noop(x):
    return x


def _http_bind_source(seed: int, bh: int, t: int, d: int) -> dict:
    """(d), a CPU task on the head: q, k, v from a seed, and its node."""
    import os

    import numpy as np

    rng = np.random.default_rng(seed)
    return {"node": os.environ.get("RAYTPU_NODE_ID"),
            "qkv": [rng.standard_normal((bh, t, d), dtype=np.float32)
                    for _ in range(3)]}


def _http_bind_flash(src: dict, on_card: bool) -> dict:
    """(d), a task granted the card: the flash forward on the source's
    q, k, v (bf16, causal) against its plain version."""
    import os

    import torch

    fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")
    dev = "cuda" if on_card else "cpu"
    q, k, v = (torch.tensor(a, device=dev).to(torch.bfloat16)
               for a in src["qkv"])
    scale = 1.0 / math.sqrt(q.shape[-1])
    fa.FLASH_FWD_LAUNCHES = 0
    o, lse = fa.flash_attention_fwd(q, k, v, scale=scale, causal=True)
    launches = fa.FLASH_FWD_LAUNCHES
    o_ref, lse_ref = fa.flash_attention_fwd_reference(q, k, v, scale=scale,
                                                      causal=True)
    return {"node": os.environ.get("RAYTPU_NODE_ID"),
            "source_node": src["node"],
            "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
            "launches": launches,
            "err_o": (o.float() - o_ref.float()).abs().max().item(),
            "err_lse": (lse - lse_ref).abs().max().item()}


#: the variable that marks every process this script starts
RUN_MARK_VAR = "CHIP_SMOKE_RUN"


def _run_mark() -> bytes:
    """This run's mark, set in this process's environment on the first
    call: every process started after it inherits it (the CLI's nodes,
    their workers, the attached driver's workers, a job's child), so
    that it tells this run's processes from any other run's on the
    host."""
    import os

    os.environ.setdefault(RUN_MARK_VAR, f"{os.getpid()}.{time.time_ns()}")
    return f"{RUN_MARK_VAR}={os.environ[RUN_MARK_VAR]}".encode()


def _ray_tpu_torch_pids() -> list:
    """This run's processes (``_run_mark``), other than this one, of the
    port's runtime: its worker processes and its CLI (nodes,
    commands)."""
    import os

    me, mark = os.getpid(), _run_mark()
    out = []
    for name in os.listdir("/proc"):
        if not name.isdigit() or int(name) == me:
            continue
        try:
            with open(f"/proc/{name}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode(errors="replace")
            with open(f"/proc/{name}/stat") as f:
                if f.read().rsplit(")", 1)[-1].split()[0] == "Z":
                    continue
            with open(f"/proc/{name}/environ", "rb") as f:
                if mark not in f.read().split(b"\0"):
                    continue
        except OSError:
            continue
        argv = cmd.split()
        if "ray_tpu_torch._private.worker_main" in argv or any(
                a == "-m" and b == "ray_tpu_torch"
                for a, b in zip(argv, argv[1:])):
            out.append((int(name), cmd.strip()[:160]))
    return out


def phase_serve_http(torch, np, fa, card: str, preset="llama-1b",
                     device="cuda", widths=None,
                     turns: int = RUN_TURNS) -> dict:
    """llama-1b over HTTP on a cluster started by the port's CLI: (a)
    ``python -m ray_tpu_torch start --head --num-gpus 0`` and a worker
    node offering the card, the driver attached by ``init(address=)``,
    ``status`` and ``list nodes``; (d1) a ``.bind()`` graph from a CPU
    task on the head into a task granted the card (the flash forward
    against its plain version), a placement group across the two nodes,
    a job through ``python -m ray_tpu_torch submit``; (b) f32 llama-1b
    by ``serve.schema.apply`` on the worker node, the proxy on the head,
    8 x 512-token prompts at once over HTTP, each reply the in-process
    engine's (or a near-tie), 16 flash launches per prefill in the
    replica; (c) bf16 over HTTP, through the handle and in process in
    turns (1-token p50/p95, served tokens/s) and a no-op's p50 over HTTP
    and through the handle; (d2) the replica's serve_* metrics through
    the publisher and ``collect_cluster_metrics``, ``timeline()``; (e)
    delete, shutdown, ``stop``: no process and no store segment left,
    the card's memory back.
    ``preset``, ``device`` and ``widths`` let it run cut down on the CPU
    (then no card: no grant, the kernel runs its plain version)."""
    import gc
    import os
    import shutil
    import tempfile

    import ray_tpu_torch as rt
    from ray_tpu_torch import serve as rserve
    from ray_tpu_torch._private import worker_context
    from ray_tpu_torch.dag import InputNode
    from ray_tpu_torch.serve import schema
    from ray_tpu_torch.util import metrics, state
    from ray_tpu_torch.util.placement_group import (placement_group,
                                                    remove_placement_group)

    t_phase = time.perf_counter()
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    widths = dict(widths or {})
    out = {"counts": {"flash_fwd": 0, "flash_bwd_dq": 0,
                      "flash_bwd_dkv": 0}}
    left = _ray_tpu_torch_pids()
    if left:
        fail(f"[serve-http] ray_tpu_torch processes alive before the "
             f"phase: {left}")

    def free_mem(tag):
        gc.collect()
        if not on_card:
            return 0
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        free, total = torch.cuda.mem_get_info()
        print(f"[serve-http] card memory {tag}: {free / 2**30:.3f} GiB "
              f"free of {total / 2**30:.3f} [{card}]", flush=True)
        return free

    # the driver's in-process engines (the f32 oracle, the bf16 route of
    # (c)) first, so that the card's free memory from here to (e) moves
    # with the cluster's processes alone
    from ray_tpu_torch.serve import build_llm_deployment

    rng = np.random.default_rng(15)

    engine = build_llm_deployment(
        "llama", preset, scheduler="batch", max_batch_size=RUN_B,
        max_new_tokens=RUN_NEW, seed=0, device=dev,
        config_overrides={"dtype": torch.float32, **widths}).func_or_class()
    cfg = engine.cfg
    prompts = [rng.integers(0, cfg.vocab_size, size=RUN_T, dtype=np.int32)
               for _ in range(RUN_B)]
    one = [rng.integers(0, cfg.vocab_size, size=1, dtype=np.int32)
           for _ in range(RUN_ONE_TOKEN)]
    want = asyncio.run(_serve_all(engine, prompts))
    engine_bf16 = build_llm_deployment(
        "llama", preset, scheduler="batch", max_batch_size=RUN_B,
        max_new_tokens=RUN_NEW, seed=0, device=dev,
        config_overrides=widths or None).func_or_class()
    asyncio.run(_serve_all(engine_bf16, prompts))
    asyncio.run(engine_bf16(one[0]))
    free0 = free_mem("before the cluster (the driver's two engines up)")

    def segments(pids):
        """The object-store segments in /dev/shm of the port's nodes
        in processes ``pids`` (named ``raytpu_torch_<session>_<pid>``)."""
        return {n for n in os.listdir("/dev/shm")
                if n.startswith("raytpu_torch_")
                and n.rsplit("_", 1)[-1] in {str(p) for p in pids}}

    shm0 = segments([os.getpid()])

    # (a) the cluster by the CLI, the driver attached
    store = min(RUN_STORE_MAX, shutil.disk_usage("/dev/shm").free // 6) \
        // 2**20 * 2**20
    head = worker = stop = None
    proxies = []
    try:
        t0 = time.perf_counter()
        head, line = _cli_node(
            ["--head", "--host", "127.0.0.1", "--port", "0", "--num-cpus",
             "2", "--num-gpus", "0", "--object-store-memory", str(store)],
            "GCS at ")
        head_s = time.perf_counter() - t0
        address = line.split("GCS at ")[-1]
        t0 = time.perf_counter()
        worker, line = _cli_node(
            ["--address", address, "--num-cpus", "4", "--num-gpus",
             "1" if on_card else "0", "--object-store-memory", str(store)],
            "joined")
        worker_s = time.perf_counter() - t0
        worker_hex12 = line.split("node ", 1)[1].split(" ", 1)[0]
        out["node_start_s"] = {"head": head_s, "worker": worker_s}
        t0 = time.perf_counter()
        # the driver's node offers half a CPU: room for its proxy (one a
        # node, 0.1 CPU each), none for the placement group's CPU bundle
        rt.init(address=address, num_cpus=0.5, object_store_memory=store)
        attach_s = time.perf_counter() - t0
        mine = worker_context.node().node_id.hex()
        nodes = [n for n in rt.nodes() if n["Alive"]]
        cluster = [n for n in nodes if n["NodeID"] != mine]
        res = rt.cluster_resources()
        worker_hex = next((n["NodeID"] for n in cluster
                           if n["NodeID"].startswith(worker_hex12)), None)
        head_hex = next((n["NodeID"] for n in cluster
                         if n["NodeID"] != worker_hex), None)
        st = _cli("status", "--address", address)
        ls = _cli("list", "nodes", "--address", address)
        listed = {n["node_id"]: n for n in json.loads(
            ls.stdout[ls.stdout.index("["):ls.stdout.rindex("]") + 1])}
        st_alive = {ln.split()[0] for ln in st.stdout.splitlines()
                    if "alive=True" in ln}
        agree = all(h is not None and listed.get(h, {}).get("alive")
                    and h[:12] in st_alive for h in (head_hex, worker_hex))
        totals = json.loads(st.stdout.split("cluster totals:", 1)[1]
                            .splitlines()[0])
        print(f"[serve-http] (a) head started in {head_s:.2f} s "
              f"(GCS at {address}), the worker node in {worker_s:.2f} s, "
              f"the driver attached in {attach_s:.2f} s; nodes(): "
              f"{len(nodes)} alive (the head, the worker node and the "
              f"driver's own, which offers half a CPU); cluster_resources "
              f"GPU {res.get('GPU')}; `status` (exit 0) and `list nodes` "
              f"(exit 0) agree on both nodes alive: {agree}, status's GPU "
              f"total {totals.get('GPU')} [{card}]", flush=True)
        if len(cluster) != 2 or worker_hex is None or head_hex is None:
            fail(f"[serve-http] (a) nodes() shows {len(cluster)} alive "
                 f"nodes beside the driver's, not the head and the worker")
        want_gpu = 1.0 if on_card else None
        if res.get("GPU") != want_gpu or totals.get("GPU") != want_gpu:
            fail(f"[serve-http] (a) cluster_resources GPU {res.get('GPU')}"
                 f", status's {totals.get('GPU')}, expected {want_gpu}")
        if not agree:
            fail("[serve-http] (a) `status` and `list nodes` disagree on "
                 "the head and the worker node")

        # (d1) a .bind() graph across both nodes, a placement group, a job
        bh = RUN_B * 32 if preset == "llama-1b" else RUN_B * 4
        src = rt.remote(num_cpus=1, resources={f"node:{head_hex}": 0.01})(
            _http_bind_source)
        sink = rt.remote(num_gpus=1 if on_card else 0, num_cpus=1,
                         resources={f"node:{worker_hex}": 0.01})(
            _http_bind_flash)
        with InputNode() as seed:
            dag = sink.bind(src.bind(seed, bh, RUN_T, 64), on_card)
        t0 = time.perf_counter()
        r = rt.get(dag.execute(7), timeout=600)
        dag_s = time.perf_counter() - t0
        print(f"[serve-http] (d) .bind() graph: a CPU task on the head "
              f"({r['source_node'] == head_hex}) fed a task on the worker "
              f"node ({r['node'] == worker_hex}, CUDA_VISIBLE_DEVICES="
              f"{r['visible']!r}): flash forward (B*H={bh}, T={RUN_T}, "
              f"D=64, causal, bf16) vs plain: max|o| {r['err_o']:.3e} (tol "
              f"{TOL[('bf16', 'o')]:.0e}), max|lse| {r['err_lse']:.3e} (tol "
              f"{TOL[('bf16', 'lse')]:.0e}), {r['launches']} launch; "
              f"execute() to result {dag_s:.2f} s [{card}]", flush=True)
        if r["source_node"] != head_hex or r["node"] != worker_hex:
            fail("[serve-http] (d) the .bind() graph's tasks ran on the "
                 "wrong nodes")
        if r["launches"] != (1 if on_card else 0) or \
                r["err_o"] > TOL[("bf16", "o")] or \
                r["err_lse"] > TOL[("bf16", "lse")] or \
                (on_card and r["visible"] != "0"):
            fail("[serve-http] (d) the flash forward in the .bind() graph "
                 "did not launch once on the card or disagrees with its "
                 "plain version")
        # the GCS places bundles in order, greedily: the card's first
        bundles = [{"GPU": 1} if on_card else {"CPU": 1}, {"CPU": 1}]
        pg = placement_group(bundles, strategy="STRICT_SPREAD",
                             name="smoke_pg")
        pg.ready(timeout=120)
        info = next(p for p in worker_context.core_worker().io.run(
            worker_context.core_worker().gcs.call("pg_list", {}))
            if p["name"] == "smoke_pg")
        placed = [n.hex() for n in info["bundle_nodes"]]
        listed_pg = [p for p in state.list_placement_groups()
                     if p["name"] == "smoke_pg"]
        remove_placement_group(pg)
        where = ["head" if n == head_hex else "worker" if n == worker_hex
                 else n for n in placed]
        print(f"[serve-http] (d) placement group {bundles} STRICT_SPREAD: "
              f"{info['state']}, bundles on {where}; "
              f"list_placement_groups(): {len(listed_pg)}", flush=True)
        if info["state"] != "CREATED" or set(placed) != {head_hex,
                                                         worker_hex} or \
                (on_card and placed[0] != worker_hex) or len(listed_pg) != 1:
            fail("[serve-http] (d) the placement group was not placed "
                 "across the head and the worker node")
        code = ("import os, ray_tpu_torch as r; r.init(address='auto'); "
                "print('SMOKE_JOB', os.environ['SMOKE_ENV'], "
                "r.cluster_resources().get('GPU'), len(r.nodes()))")
        t0 = time.perf_counter()
        job = _cli("submit", "--address", address, "--env",
                   "SMOKE_ENV=reached", "--", sys.executable, "-c", code,
                   timeout=300, check=False)
        job_s = time.perf_counter() - t0
        # submit waits for the job and prints its logs and its end
        jid = next((ln.split()[-1] for ln in job.stdout.splitlines()
                    if ln.startswith("submitted job ")), None)
        listed_jobs = json.loads(_cli("job", "list", "--address",
                                      address).stdout)
        rec = next((j for j in listed_jobs if j["job_id"] == jid), {})
        out["job_s"] = job_s
        print(f"[serve-http] (d) `python -m ray_tpu_torch submit` exited "
              f"{job.returncode} in {job_s:.2f} s: job {jid}, `job list` "
              f"says {rec.get('status')} (started to ended "
              f"{rec.get('end_time', 0) - rec.get('start_time', 0):.2f} s); "
              f"submit's output: {job.stdout.strip()!r} [{card}]",
              flush=True)
        if job.returncode != 0 or rec.get("status") != "SUCCEEDED" or \
                f"SMOKE_JOB reached {1.0 if on_card else None}" \
                not in job.stdout:
            fail(f"[serve-http] (d) the job did not succeed with its "
                 f"env_vars: {job.stdout[-2000:]} {job.stderr[-2000:]}")

        # (b) f32: apply, the proxy on the head, 8 prompts over HTTP
        grant = {"num_gpus": 1} if on_card else None
        dep_name = f"llm_llama_{preset}"

        def app(dtype):
            over = dict(widths)
            if dtype is not None:
                over["dtype"] = dtype
            return {"import_path":
                    "ray_tpu_torch.serve.llm:build_llm_deployment",
                    "route_prefix": "/llm",
                    "args": {"family": "llama", "preset": preset,
                             "scheduler": "batch", "max_batch_size": RUN_B,
                             "max_new_tokens": RUN_NEW, "seed": 0,
                             "config_overrides": over or None,
                             "device": None if on_card else device},
                    "deployments": [{"name": dep_name,
                                     "max_concurrent_queries": RUN_B,
                                     "ray_actor_options": grant}]}

        t0 = time.perf_counter()
        h = schema.apply(app(torch.float32))
        # one proxy a node, each pinned by its node:<hex>; requests go
        # to the head's
        rserve.start_http_proxy(port=_free_tcp_ports(len(nodes)),
                                per_node=True)
        proxies = sorted((a["name"], a["node_id"]) for a in
                         state.list_actors() if a["state"] == "ALIVE" and
                         a["name"].startswith("SERVE_HTTP_PROXY:"))
        head_proxy = rt.get_actor(f"SERVE_HTTP_PROXY:{head_hex[:12]}")
        url = rt.get(head_proxy.address.remote(), timeout=30)
        proxy_node = dict(proxies).get(f"SERVE_HTTP_PROXY:{head_hex[:12]}")
        _http_post(url + "/llm", prompts[0].tolist())
        first_f32 = time.perf_counter() - t0
        before = rt.get(h.method("kernel_counts").remote(reset=True),
                        timeout=60)
        t0 = time.perf_counter()
        bodies = _http_all(url + "/llm", [p.tolist() for p in prompts])
        wall = time.perf_counter() - t0
        after = rt.get(h.method("kernel_counts").remote(), timeout=60)
        got = [_parse_array_repr(np, b["result"]) for b in bodies]
        check_replies(np, prompts, got, RUN_NEW, cfg.vocab_size,
                      "serve-http")
        ties = gate_against_oracle(torch, np, engine.params, cfg, prompts,
                                   got, want, "f32 replica over HTTP",
                                   phase="serve-http")
        equal = sum(bool(np.array_equal(a, b)) for a, b in zip(got, want))
        launches, prefills = after["flash_fwd"], after["prefills"]
        out["counts"]["flash_fwd"] = launches
        sstatus = schema.status()
        replicas = sstatus["applications"].get(dep_name, {}).get("replicas")
        print(f"[serve-http] (b) f32 by serve.schema.apply: the replica "
              f"(pid {after['pid']}) on the worker node "
              f"({after['node_id'] == worker_hex}, CUDA_VISIBLE_DEVICES="
              f"{after['visible']!r}, engine on {after['device']}), "
              f"start_http_proxy(per_node=True): {len(proxies)} proxies, the "
              f"head's on the head ({proxy_node == head_hex}) at {url}; apply "
              f"to the first HTTP reply {first_f32:.2f} s; {RUN_B} x "
              f"{RUN_T}-token requests at once over HTTP in "
              f"{wall * 1e3:.1f} ms: {equal}/{RUN_B} replies equal to the "
              f"in-process engine's, {len(ties)} parted at a near-tie; "
              f"{launches} flash launches in the replica for prefills "
              f"{prefills} ({cfg.n_layer} layers); serve.schema.status(): "
              f"{replicas} replica [{card}]", flush=True)
        if after["node_id"] != worker_hex or proxy_node != head_hex or \
                {n for _, n in proxies} != {n["NodeID"] for n in nodes}:
            fail("[serve-http] (b) the replica is not on the worker node, "
                 "or not one proxy on each node")
        if on_card and (after["visible"] != "0" or
                        after["device"] != "cuda:0"):
            fail("[serve-http] (b) the replica does not hold the card as "
                 "cuda:0")
        if before["flash_fwd"] != (cfg.n_layer if on_card else 0) or \
                not prefills or launches != (cfg.n_layer * prefills
                                             if on_card else 0):
            fail(f"[serve-http] (b) {launches} flash launches in the "
                 f"replica for {prefills} prefills (warm-up "
                 f"{before['flash_fwd']}), expected {cfg.n_layer} each")
        if replicas != 1:
            fail(f"[serve-http] (b) serve.schema.status() shows {replicas} "
                 f"replicas, not 1")
        f32_pid = after["pid"]
        rserve.delete(dep_name)
        _run_wait_exit([f32_pid], "the f32 replica after serve.delete")

        # (c) bf16: over HTTP, through the handle and in process, in turns
        t0 = time.perf_counter()
        h = schema.apply(app(None))
        _http_post(url + "/llm", prompts[0].tolist())
        first = time.perf_counter() - t0
        rserve.run(rserve.deployment(_http_noop, name="http_noop",
                                     route_prefix="/noop").bind())
        noop_h = rserve.get_deployment_handle("http_noop")
        _http_post(url + "/noop", 0)
        time.sleep(2.1)  # the proxy's route table holds /noop
        noop = {"http": [], "handle": []}
        for i in range(HTTP_NOOP_N):
            for side in (("http", "handle") if i % 2 else
                         ("handle", "http")):
                t0 = time.perf_counter()
                if side == "http":
                    _http_post(url + "/noop", i)
                else:
                    rt.get(noop_h.remote(i), timeout=60)
                noop[side].append(time.perf_counter() - t0)
        noop_p50 = {k: sorted(v)[len(v) // 2] * 1e3 for k, v in noop.items()}

        def http_turn():
            t0 = time.perf_counter()
            _http_all(url + "/llm", [p.tolist() for p in prompts])
            wall = time.perf_counter() - t0
            lat = []
            for p in one:
                t0 = time.perf_counter()
                _http_post(url + "/llm", p.tolist())
                lat.append(time.perf_counter() - t0)
            return wall, lat

        def handle_turn():
            t0 = time.perf_counter()
            rt.get([h.remote(p) for p in prompts], timeout=600)
            wall = time.perf_counter() - t0
            lat = []
            for p in one:
                t0 = time.perf_counter()
                rt.get(h.remote(p), timeout=600)
                lat.append(time.perf_counter() - t0)
            return wall, lat

        def engine_turn():
            t0 = time.perf_counter()
            asyncio.run(_serve_all(engine_bf16, prompts))
            wall = time.perf_counter() - t0
            lat = []
            for p in one:
                t0 = time.perf_counter()
                asyncio.run(engine_bf16(p))
                lat.append(time.perf_counter() - t0)
            return wall, lat

        sides = {"http": http_turn, "handle": handle_turn,
                 "engine": engine_turn}
        walls = {k: [] for k in sides}
        lats = {k: [] for k in sides}
        for side in ["http", "handle", "engine", "engine", "handle",
                     "http"] * turns:
            wall, lat = sides[side]()
            walls[side].append(wall)
            lats[side].extend(lat)
        tps = {k: [RUN_B * RUN_NEW / w for w in v] for k, v in walls.items()}
        pct = {k: {"p50": sorted(v)[len(v) // 2] * 1e3,
                   "p95": sorted(v)[min(len(v) - 1,
                                        int(0.95 * len(v)))] * 1e3}
               for k, v in lats.items()}
        out.update(first_reply_s=first, first_reply_f32_s=first_f32,
                   tokens_per_s=tps, one_token_ms=pct, noop_p50_ms=noop_p50,
                   proxy_hop_ms=noop_p50["http"] - noop_p50["handle"],
                   ties=ties, equal=equal)
        print(f"[serve-http] (c) bf16, in turns (http, handle, engine, "
              f"engine, handle, http) x{turns}: served tokens/s over HTTP "
              f"{[round(x, 1) for x in tps['http']]}, through the handle "
              f"{[round(x, 1) for x in tps['handle']]}, in process "
              f"{[round(x, 1) for x in tps['engine']]} (HTTP / handle "
              f"{[round(a / b, 3) for a, b in zip(tps['http'], tps['handle'])]}"
              f"); a 1-token request p50/p95 of {len(lats['http'])}: HTTP "
              f"{pct['http']['p50']:.2f}/{pct['http']['p95']:.2f} ms, handle "
              f"{pct['handle']['p50']:.2f}/{pct['handle']['p95']:.2f} ms, "
              f"in process {pct['engine']['p50']:.2f}/"
              f"{pct['engine']['p95']:.2f} ms; a no-op deployment, p50 of "
              f"{HTTP_NOOP_N}: {noop_p50['http']:.3f} ms over HTTP, "
              f"{noop_p50['handle']:.3f} ms through the handle (the proxy's "
              f"hop {noop_p50['http'] - noop_p50['handle']:.3f} ms); apply "
              f"to the first bf16 HTTP reply {first:.2f} s [{card}]",
              flush=True)

        # (d2) the replica's metrics through the publisher: the publish
        # lag is the time from a request's end to collect_cluster_metrics
        # showing the replica's finished count with it; the timeline
        counts = rt.get(h.method("kernel_counts").remote(), timeout=60)
        cw = worker_context.core_worker()
        label = f'worker="{counts["worker_id"][:12]}"'

        def replica_lines():
            return [ln for ln in metrics.collect_cluster_metrics(
                cw.kv_get, cw.kv_keys)
                if ln.startswith("raytpu_app_serve_") and label in ln]

        def finished(lines):
            return sum(float(ln.rsplit(" ", 1)[1]) for ln in lines
                       if ln.startswith(
                           "raytpu_app_serve_requests_finished_total{"))

        published0 = finished(replica_lines())
        rt.get(h.remote(one[0]), timeout=600)
        target = rt.get(h.method("engine_stats").remote(),
                        timeout=60)["requests"]["finished"]
        t0 = time.perf_counter()
        lines, shown = [], published0
        while time.perf_counter() - t0 < HTTP_PUBLISH_WAIT_S:
            lines = replica_lines()
            shown = finished(lines)
            if shown >= target:
                break
            time.sleep(0.05)
        lag = time.perf_counter() - t0
        names = sorted({ln.split("{", 1)[0] for ln in lines})
        out["publish_lag_s"] = lag
        print(f"[serve-http] (d) collect_cluster_metrics: {len(lines)} "
              f"serve_* lines from the replica's process ({label}, on the "
              f"worker node {counts['node_id'] == worker_hex}); its "
              f"finished count published {published0:g} before one more "
              f"request, {target} in the replica after it, {shown:g} "
              f"shown {lag:.3f} s after its end (the publish lag; interval "
              f"{metrics._PUBLISH_INTERVAL_S} s): {names[:6]}"
              f"{' ...' if len(names) > 6 else ''}", flush=True)
        if shown < target or counts["node_id"] != worker_hex:
            fail(f"[serve-http] (d) the replica's finished count {target} "
                 f"not published within {HTTP_PUBLISH_WAIT_S} s")
        with tempfile.TemporaryDirectory() as d:
            trace_path = os.path.join(d, "serve_http_timeline.json")
            deadline = time.monotonic() + 10  # events flush every ~1 s
            while True:
                events = rt.timeline(trace_path)
                mine_ev = [e for e in events if e["pid"] == counts["pid"]]
                if mine_ev or time.monotonic() > deadline:
                    break
                time.sleep(0.25)
            with open(trace_path) as f:
                on_disk = len(json.load(f))
        print(f"[serve-http] (d) timeline(path): {len(events)} "
              f"events ({on_disk} on disk), {len(mine_ev)} of the "
              f"replica's actor tasks (pid {counts['pid']}): "
              f"{sorted({e['name'] for e in mine_ev})[:4]}", flush=True)
        if not mine_ev or on_disk != len(events) or \
                any(e["ph"] != "X" or e["cat"] != "task" for e in events):
            fail("[serve-http] (d) the timeline holds none of the "
                 "replica's actor tasks")

        out["dashboard"] = phase_dashboard(
            rt, state, card, dep_name, target, worker_hex, counts, on_card)

        # (e) teardown
        bf16_pid = counts["pid"]
        rserve.delete(dep_name)
        rserve.delete("http_noop")
        _run_wait_exit([bf16_pid], "the bf16 replica after serve.delete")
        rserve.shutdown()  # the controller (and the one-proxy name only)
        for name, _ in proxies:
            rt.kill(rt.get_actor(name))
    finally:
        try:
            rt.shutdown()
        finally:
            if head is not None:
                stop = _cli("stop", check=False)
            for p in (worker, head):
                if p is None:
                    continue
                try:
                    p.wait(timeout=60)
                except subprocess.TimeoutExpired:
                    p.kill()
    left = []
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        left = _ray_tpu_torch_pids()
        if not left:
            break
        time.sleep(0.2)
    free1 = free_mem("after stop")
    shm_left = sorted(segments([head.pid, worker.pid, os.getpid()]) - shm0)
    secs = time.perf_counter() - t_phase
    out["phase_s"] = secs
    print(f"[serve-http] (e) serve.delete, shutdown() and `stop` "
          f"({stop.stdout.strip()}, exit {stop.returncode}): the nodes "
          f"exited {head.returncode}, {worker.returncode}; ray_tpu_torch "
          f"processes left: {left}, store segments left: {shm_left}; the "
          f"card back to {free1 / 2**30:.3f} "
          f"GiB free ({(free1 - free0) / 2**20:+.1f} MiB against before the "
          f"cluster); the phase in {secs:.1f} s [{card}]", flush=True)
    if stop.returncode != 0 or left or shm_left:
        fail(f"[serve-http] (e) processes of the phase still alive ({left}) "
             f"or its store segments left in /dev/shm ({shm_left})")
    if on_card and abs(free1 - free0) > RUN_MEM_TOL:
        fail(f"[serve-http] (e) the card's free memory {free1} is not back "
             f"within {RUN_MEM_TOL} of {free0}")
    del engine, engine_bf16, want
    return out


#: each kernel's launch counter
CE_OR_FLASH = {"flash_fwd": "FLASH_FWD_LAUNCHES",
               "flash_bwd_dq": "FLASH_BWD_DQ_LAUNCHES",
               "flash_bwd_dkv": "FLASH_BWD_DKV_LAUNCHES",
               "fused_ce_fwd": "FUSED_CE_FWD_LAUNCHES",
               "fused_ce_bwd_dh": "FUSED_CE_BWD_DH_LAUNCHES",
               "fused_ce_bwd_dw": "FUSED_CE_BWD_DW_LAUNCHES"}
#: GETs per dashboard route for its latency p50
DASH_GETS = 20
#: the dashboard routes phase dashboard reads
DASH_ROUTES = ("/api/nodes", "/api/actors", "/api/serve/applications",
               "/api/serve/stats", "/api/perf/autopilot", "/metrics", "/")


def _http_get(url: str, timeout: float = 60.0):
    """(status, content type, body text) of a GET."""
    import urllib.request

    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.status, r.headers.get("Content-Type"), r.read().decode()


def phase_dashboard(rt, state, card: str, dep_name: str, finished: int,
                    worker_hex: str, counts: dict, on_card: bool) -> dict:
    """12d: the port's dashboard on serve-http's cluster, while the bf16
    replica ``dep_name`` is up (``finished`` requests done, its process
    ``counts`` on node ``worker_hex``, which offers the card when
    ``on_card``)."""
    from ray_tpu_torch.dashboard import start_dashboard
    from ray_tpu_torch.dashboard.app import DASHBOARD_NAME

    t0 = time.perf_counter()
    url = start_dashboard(port=0)
    start_s = time.perf_counter() - t0
    try:
        got = {r: _http_get(url + r) for r in DASH_ROUTES}
        bad = {r: g[0] for r, g in got.items() if g[0] != 200}
        if bad:
            fail(f"[dashboard] routes answered {bad}")
        nodes = json.loads(got["/api/nodes"][2])
        want = state.list_nodes()

        def ids(ns):
            return sorted((n["node_id"], n["alive"]) for n in ns)

        metrics = got["/metrics"][2].splitlines()
        gpu = [ln for ln in metrics if ln.startswith(
            f'raytpu_resource_total{{node="{worker_hex[:12]}",'
            f'resource="gpu"}}')]
        label = f'worker="{counts["worker_id"][:12]}"'
        served = [ln for ln in metrics if ln.startswith("raytpu_app_serve_")
                  and label in ln]
        stats = json.loads(got["/api/serve/stats"][2]).get(dep_name, {})
        done = (stats.get("requests") or {}).get("finished")
        apps = json.loads(got["/api/serve/applications"][2])
        actors = json.loads(got["/api/actors"][2])
        print(f"[dashboard] start_dashboard() in {start_s:.2f} s at {url}; "
              f"/api/nodes {len(nodes)} nodes, equal to "
              f"util.state.list_nodes(): {ids(nodes) == ids(want)}; "
              f"/api/actors {len(actors)}; /api/serve/applications "
              f"{sorted(apps.get('applications', {}))}; /api/serve/stats "
              f"{dep_name}: {done} finished (the replica's own count "
              f"{finished}); /metrics {len(metrics)} lines, raytpu_nodes "
              f"{any(ln.startswith('raytpu_nodes ') for ln in metrics)}, the "
              f"worker node's gpu total {gpu}, {len(served)} of the "
              f"replica's serve_* lines; / {len(got['/'][2])} bytes of "
              f"{got['/'][1]} [{card}]", flush=True)
        if ids(nodes) != ids(want):
            fail("[dashboard] /api/nodes disagrees with "
                 "util.state.list_nodes()")
        gpu_ok = (len(gpu) == 1 and float(gpu[0].rsplit(" ", 1)[1]) == 1.0
                  if on_card else not gpu)
        if not any(ln.startswith("raytpu_nodes ") for ln in metrics) or \
                not gpu_ok or not served:
            fail("[dashboard] /metrics lacks raytpu_nodes, the worker "
                 "node's gpu total or the replica's serve_* lines")
        if done is None or done < finished or \
                dep_name not in apps.get("applications", {}):
            fail(f"[dashboard] /api/serve/stats shows {done} finished "
                 f"requests of {dep_name}, not the {finished} sent")
        p50 = {}
        for r in DASH_ROUTES:
            lat = []
            for _ in range(DASH_GETS):
                t1 = time.perf_counter()
                _http_get(url + r)
                lat.append(time.perf_counter() - t1)
            p50[r] = sorted(lat)[len(lat) // 2] * 1e3
        print(f"[dashboard] GET p50 of {DASH_GETS} (a connection each): "
              + ", ".join(f"{r} {v:.2f} ms" for r, v in p50.items())
              + f" [{card}]", flush=True)
    finally:
        rt.kill(rt.get_actor(DASHBOARD_NAME))
    doc = json.loads(got["/api/perf/autopilot"][2])
    return {"start_s": start_s, "get_p50_ms": p50, "autopilot": {
        "status": got["/api/perf/autopilot"][0],
        "deployments": doc.get("deployments"),
        "summary": (doc.get("attribution") or {}).get("summary")}}


#: what `python -m ray_tpu_torch.bench` runs in phase bench-cli, and the
#: metric names the JAX harness gives the same modes on a TPU (bench.py
#: :1297 the train line, :571 and :608-624 the decode lines)
BENCH_RUNS = {
    "train": (["--ce-impl", "pallas", "--steps", "5", "--autopilot"],
              ["gpt2_124m_train_tokens_per_sec_per_chip"]),
    "decode": (["--decode"],
               ["gpt2_decode_prefill_ttft_ms", "gpt2_decode_tokens_per_sec",
                "gpt2_decode_tokens_per_sec_per_chip"]),
}
#: the bench's module run as `python -m` runs it (runpy, run_name
#: "__main__"), then the process's kernel launch counters printed
BENCH_WRAPPER = """
import importlib, json, runpy, sys
sys.argv = ["ray_tpu_torch.bench", *sys.argv[1:]]
runpy.run_module("ray_tpu_torch.bench", run_name="__main__", alter_sys=True)
fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")
fc = importlib.import_module("ray_tpu_torch.ops.fused_ce")
print("BENCH_COUNTS " + json.dumps({
    **{c: getattr(fa, c) for c in %r}, **{c: getattr(fc, c) for c in %r}}))
""" % (COUNTERS, CE_COUNTERS)


def phase_bench_cli(torch, card: str) -> dict:
    """12e: ``python -m ray_tpu_torch.bench`` on the card, train (pallas
    CE, 5 timed steps + 1 warm-up) and --decode (1 warm-up + 3 TTFT
    prefills), each in a subprocess whose launch counters start at 0,
    each appending its metric lines to a temporary perf ledger
    (RAYTPU_BENCH_HISTORY; phase vision (e) reads it)."""
    import gc
    import os
    import tempfile

    gc.collect()
    torch.cuda.empty_cache()
    root = Path(__file__).resolve().parent
    ledger = os.path.join(tempfile.mkdtemp(prefix="chip_smoke_ledger_"),
                          "history.jsonl")
    env = dict(os.environ, RAYTPU_BENCH_HISTORY=ledger)
    out = {"ledger": ledger}
    for mode, (args, names) in BENCH_RUNS.items():
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-c", BENCH_WRAPPER, *args],
                           cwd=root, capture_output=True, text=True,
                           timeout=600, env=env)
        secs = time.perf_counter() - t0
        if r.returncode != 0:
            fail(f"[bench-cli] python -m ray_tpu_torch.bench {' '.join(args)}"
                 f" exited {r.returncode}: {r.stderr[-3000:]}")
        lines = [json.loads(ln) for ln in r.stdout.splitlines()
                 if ln.startswith("{")]
        # --autopilot's attribution line (phase observatory (d) reads it)
        autopilot = [rec for rec in lines if "autopilot" in rec]
        lines = [rec for rec in lines if "metric" in rec]
        counts = json.loads(next(ln for ln in r.stdout.splitlines()
                                 if ln.startswith("BENCH_COUNTS "))
                            .split(" ", 1)[1])
        got = [rec["metric"] for rec in lines]
        if got != names:
            fail(f"[bench-cli] {mode}: metric lines {got}, the JAX "
                 f"harness's are {names}")
        rec = lines[0]
        if mode == "train":
            steps = int(args[args.index("--steps") + 1]) + 1  # + warm-up
            want = {"FLASH_FWD_LAUNCHES": 12, "FLASH_BWD_DQ_LAUNCHES": 12,
                    "FLASH_BWD_DKV_LAUNCHES": 12,
                    "FUSED_CE_FWD_LAUNCHES": 1, "FUSED_CE_BWD_DH_LAUNCHES": 1,
                    "FUSED_CE_BWD_DW_LAUNCHES": 1}
            per = {k: counts[k] / steps for k in want}
            print(f"[bench-cli] python -m ray_tpu_torch.bench "
                  f"{' '.join(args)} in {secs:.1f} s: {rec['metric']} "
                  f"{rec['value']} tokens/s, MFU {rec['detail']['mfu']} "
                  f"(vs_baseline {rec['vs_baseline']}), loss "
                  f"{rec['detail']['loss']}, B={rec['detail']['batch']} "
                  f"T={rec['detail']['seq']} remat "
                  f"{rec['detail']['remat_policy']} ce "
                  f"{rec['detail']['ce_impl']}; launches per step over "
                  f"{steps} steps {per} [{card}]", flush=True)
            if per != want or rec["detail"]["mfu"] is None or \
                    not math.isfinite(rec["detail"]["loss"]):
                fail(f"[bench-cli] train: launches per step {per}, "
                     f"expected {want}; MFU {rec['detail']['mfu']}")
        else:
            prefills = 1 + 3
            per = counts["FLASH_FWD_LAUNCHES"] / prefills
            d = rec["detail"]
            print(f"[bench-cli] python -m ray_tpu_torch.bench "
                  f"{' '.join(args)} in {secs:.1f} s: TTFT p50 "
                  f"{rec['value']} ms (best {d['ttft_best_ms']} ms), "
                  f"decode {lines[1]['value']} tokens/s, B={d['batch']} "
                  f"prompt {d['prompt_len']} +{d['new_tokens']}; flash "
                  f"forwards per prefill {per} over {prefills}, other "
                  f"kernels {sum(v for k, v in counts.items() if k != 'FLASH_FWD_LAUNCHES')} "
                  f"[{card}]", flush=True)
            if per != 12 or sum(counts.values()) != counts[
                    "FLASH_FWD_LAUNCHES"]:
                fail(f"[bench-cli] decode: {counts} launches for "
                     f"{prefills} prefills, expected 12 flash forwards "
                     f"each and nothing else")
        out[mode] = {"records": lines, "counts": counts, "s": secs,
                     "autopilot": autopilot[-1] if autopilot else None}
        if ("--autopilot" in args) != bool(autopilot):
            fail(f"[bench-cli] {mode}: {len(autopilot)} --autopilot lines")
    return out



#: phase data-air (12f): the token dataset (rows x (seq + 1) int32 over
#: GPT-2's vocabulary, seeded), its blocks, the dataset-fed steps (the
#: first a warm-up), the timed turns, and the predictor's prompts
DATA_ROWS, DATA_BLOCKS, DATA_STEPS = 1536, 16, 8
DATA_SEED = 17
DATA_TURNS = ("dataset", "direct", "direct", "dataset")
PREDICT_PROMPTS, PREDICT_T, PREDICT_B = 64, 512, 8
#: the predictor's nll against the driver's: phase serve's logit
#: tolerance (bf16 compute, f32 logits)
PREDICT_NLL_TOL = LOGIT_TOL
#: where a pool actor's predictor books its launch counts (the KV)
PREDICT_KV = "chip_smoke:data_predict:"


def _importable(name: str):
    """Whether ``import name`` works here, and its version."""
    try:
        mod = importlib.import_module(name)
    except ImportError as e:
        return False, str(e)
    return True, getattr(mod, "__version__", "?")


def _gpt2_predictor(cfg, device, kv_prefix: str):
    """Phase data-air's Predictor class: GPT-2 (``cfg``) from an AIR
    checkpoint's ``"params"``, one forward of each batch of prompts
    through the flash forward (``gpt2_forward``: 12 launches a batch at
    full depth), returning the next token's argmax and the prompt's mean
    nll.  Built in a pool actor (``from_checkpoint``) it requires a card
    granted through CUDA_VISIBLE_DEVICES, zeroes its process's launch
    counters and books them after each batch under ``kv_prefix`` + its
    pid in the cluster KV.  Defined here, it travels to the actor by
    value."""
    from ray_tpu_torch.air import Predictor

    class GPT2Predictor(Predictor):
        def __init__(self, params, dev, book: bool):
            self.params, self.dev, self.book = params, dev, book
            self.batch_s = []

        @classmethod
        def load(cls, ckpt, granted: bool):
            import os

            import ray_tpu_torch.ops.fused_ce as fc
            from ray_tpu_torch.device import resolve_device
            from ray_tpu_torch.train.optim import tree_map

            fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")
            dev = resolve_device(device)
            if granted and dev.type == "cuda" and not os.environ.get(
                    "CUDA_VISIBLE_DEVICES"):
                raise RuntimeError("the predictor's actor was not granted "
                                   "a card (CUDA_VISIBLE_DEVICES is empty)")
            params = tree_map(lambda x: x.to(dev), ckpt.to_dict()["params"])
            if granted:
                for c in COUNTERS:
                    setattr(fa, c, 0)
                for c in CE_COUNTERS:
                    setattr(fc, c, 0)
            return cls(params, dev, granted)

        @classmethod
        def from_checkpoint(cls, ckpt):
            return cls.load(ckpt, granted=True)

        def forward(self, tokens):
            """(next-token argmax, mean nll of the prompt, last-column
            logits over the real vocabulary) of tokens (B, T)."""
            import torch

            from ray_tpu_torch.models.gpt2 import gpt2_forward

            with torch.inference_mode():
                toks = torch.as_tensor(tokens).to(self.dev).long()
                lv = gpt2_forward(self.params, toks, cfg)[..., :cfg.vocab_size]
                last = lv[:, -1]
                head = lv[:, :-1]
                nll = (torch.logsumexp(head, -1) - head.gather(
                    -1, toks[:, 1:, None])[..., 0]).mean(-1)
                return last.argmax(-1), nll, last

        def predict(self, batch):
            import json
            import os

            import numpy
            import ray_tpu_torch.ops.fused_ce as fc
            from ray_tpu_torch._private import worker_context

            fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")
            t0 = time.perf_counter()
            nxt, nll, _ = self.forward(batch["tokens"])
            out = {"next": nxt.cpu().numpy().astype(numpy.int64),
                   "nll": nll.float().cpu().numpy()}
            self.batch_s.append(time.perf_counter() - t0)
            if self.book:
                worker_context.core_worker().kv_put(
                    f"{kv_prefix}{os.getpid()}", json.dumps({
                        "pid": os.getpid(), "batch_s": self.batch_s,
                        "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
                        "counts": {**{c: getattr(fa, c) for c in COUNTERS},
                                   **{c: getattr(fc, c)
                                      for c in CE_COUNTERS}}}).encode())
            return out

    return GPT2Predictor


def _tree_bitwise_equal(torch, a, b) -> bool:
    """Every leaf of two trees of tensors equal bit for bit (bf16 and
    f32 alike), in the same layout."""
    from ray_tpu_torch.train.optim import tree_leaves

    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and x.shape == y.shape and torch.equal(
            x.detach().cpu().reshape(-1).view(torch.uint8),
            y.detach().cpu().reshape(-1).view(torch.uint8))
        for x, y in zip(la, lb))


def _tree_nbytes(tree) -> int:
    from ray_tpu_torch.train.optim import tree_leaves

    return sum(x.numel() * x.element_size() for x in tree_leaves(tree))


def phase_data_air(torch, np, fa, card: str, preset: str = "gpt2",
                   device: str = "cuda", rows: int = DATA_ROWS,
                   seq: int = TRAIN_T, batch: int = TRAIN_B,
                   blocks: int = DATA_BLOCKS, steps: int = DATA_STEPS,
                   prompts: int = PREDICT_PROMPTS,
                   prompt_len: int = PREDICT_T,
                   predict_b: int = PREDICT_B) -> dict:
    """12f: Data and AIR on the card, on the port's runtime
    (``ray_tpu_torch.init(num_gpus=1)``).  (a) ``rows`` seeded token rows
    in ``blocks`` blocks, ``from_numpy`` -> ``random_shuffle(seed=0)`` ->
    ``iter_torch_batches(batch_size=batch, drop_last=True)`` onto the
    card feed GPT-2's train step (``preset``, remat mlp_only,
    ``ce_impl="pallas"``, AdamW) for ``steps`` steps: every batch
    bit for bit the dataset's numpy batch moved by hand, every loss the
    hand-fed step's from the same start within CE_LOSS_TOL, 12/12/12/
    1/1/1 launches a step; tokens/s fed from the dataset and directly,
    in turns, the wait for a batch (p50/p99), the shuffle's wall.  (b)
    the parameters and AdamW state after (a) through
    ``air.Checkpoint`` dict -> directory -> dict, and through
    ``save_sharded`` -> ``sharded_checkpoint_to_air`` -> restore, bit
    for bit, GB/s.  (c) ``air.BatchPredictor`` of (b)'s parameters over
    ``prompts`` prompts of ``prompt_len`` tokens in blocks of
    ``predict_b``, on an ``ActorPoolStrategy(size=1, num_gpus=1)``
    actor: each row the driver's own predictor's (argmax, or a near-tie
    of the driver's logits; nll within PREDICT_NLL_TOL), the actor's
    flash forwards exactly n_layer a batch and no other launch.
    ``preset``/``device`` and the sizes let it run cut down on the CPU
    (then the pool actor holds no card)."""
    import gc
    import itertools
    import shutil
    import tempfile

    import ray_tpu_torch as rt
    from ray_tpu_torch import air, data
    from ray_tpu_torch._private import worker_context
    from ray_tpu_torch.bench import H100_BF16_PEAK_FLOPS
    from ray_tpu_torch.models.gpt2 import (gpt2_config, gpt2_init, gpt2_loss,
                                           gpt2_param_count)
    from ray_tpu_torch.train import (adamw, build_train_step, restore_sharded,
                                     save_sharded, sharded_checkpoint_to_air)
    from ray_tpu_torch.train.optim import tree_map

    dev = torch.device(device)
    on_card = dev.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    arrow = _importable("pyarrow")
    pandas = _importable("pandas")
    print(f"[data-air] pyarrow importable: {arrow[0]} ({arrow[1]}); pandas "
          f"importable: {pandas[0]} ({pandas[1]}) [{card}]", flush=True)
    out = {"pyarrow": arrow[0], "pandas": pandas[0]}
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    shm_free = shutil.disk_usage("/dev/shm").free
    store = min(RUN_STORE_MAX, shm_free // 2) // 2**20 * 2**20
    t0 = time.perf_counter()
    rt.init(num_cpus=4, num_gpus=1 if on_card else 0,
            object_store_memory=store)
    print(f"[data-air] init(num_gpus={1 if on_card else 0}) in "
          f"{time.perf_counter() - t0:.2f} s, store {store / 2**20:.0f} MiB; "
          f"cluster_resources {rt.cluster_resources()}", flush=True)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_data_air_")
    try:
        # -- (a) ingest into training ------------------------------------
        cfg = gpt2_config(preset, max_seq=seq, remat_policy="mlp_only",
                          ce_impl="pallas")
        L = cfg.n_layer
        tokens = np.random.default_rng(DATA_SEED).integers(
            0, cfg.vocab_size, (rows, seq + 1)).astype(np.int32)
        t0 = time.perf_counter()
        ds = data.from_numpy({"tokens": tokens}, parallelism=blocks)
        t_put = time.perf_counter() - t0
        t0 = time.perf_counter()
        sh = ds.random_shuffle(seed=0)
        rt.wait(sh._block_refs, num_returns=len(sh._block_refs),
                timeout=600)
        t_shuffle = time.perf_counter() - t0
        print(f"[data-air] (a) {rows} x {seq + 1} int32 tokens "
              f"({tokens.nbytes / 1e6:.2f} MB) in {ds.num_blocks} blocks: "
              f"from_numpy {t_put * 1e3:.1f} ms, random_shuffle(seed=0) "
              f"{t_shuffle * 1e3:.1f} ms ({sh.num_blocks} blocks; "
              f"{sh.stats()})", flush=True)
        want = [b["tokens"] for b in itertools.islice(
            sh.iter_batches(batch_size=batch, batch_format="numpy",
                            drop_last=True), steps)]
        if len(want) != steps or np.array_equal(
                np.concatenate(want), tokens[:steps * batch]):
            fail(f"[data-air] (a) the shuffled dataset gave {len(want)} "
                 f"batches, or its rows were not shuffled")
        by_hand = [torch.from_numpy(b.copy()).to(dev) for b in want]

        gen = torch.Generator(device=dev).manual_seed(0)
        params0 = gpt2_init(cfg, gen, device=dev)
        tx = adamw(3e-4, weight_decay=0.1)
        step = build_train_step(lambda p, b: gpt2_loss(p, b, cfg), tx,
                                telemetry=False)
        # off the card every kernel takes its plain version: no launch
        n = 1 if on_card else 0
        per_step = {"flash_fwd": n * L, "flash_bwd_dq": n * L,
                    "flash_bwd_dkv": n * L, "fused_ce_fwd": n,
                    "fused_ce_bwd_dh": n, "fused_ce_bwd_dw": n}

        def fresh():
            p = tree_map(torch.clone, params0)
            return p, tx.init(p)

        # the main path: the dataset feeds the step; counters zeroed
        # just before, read just after
        params, opt = fresh()
        losses, waits, bad, counts_by_step = [], [], [], []
        sync()
        zero_counts(fa)
        it = sh.iter_torch_batches(batch_size=batch, drop_last=True,
                                   device=None if on_card else dev)
        for i in range(steps):
            t0 = time.perf_counter()
            b = next(it)
            waits.append(time.perf_counter() - t0)
            before = read_counts(fa)
            params, opt, loss = step(params, opt, b)
            after = read_counts(fa)
            counts_by_step.append({k: after.get(k, 0) - before.get(k, 0)
                                   for k in per_step})
            losses.append(loss)
            if not torch.equal(b["tokens"], by_hand[i]):
                bad.append(i)
        it.close()
        sync()
        counts_train = read_counts(fa)
        fed = [float(x) for x in losses]
        if bad:
            fail(f"[data-air] (a) batches {bad} differ from the dataset's "
                 f"numpy batches moved by hand")
        if any(c != per_step for c in counts_by_step):
            fail(f"[data-air] (a) launches by step {counts_by_step}, "
                 f"expected {per_step} each")
        # the same steps fed the hand-moved batches, from the same start
        params_d, opt_d = fresh()
        direct = []
        for b in by_hand:
            params_d, opt_d, loss = uncounted(
                fa, lambda: step(params_d, opt_d, {"tokens": b}))
            direct.append(loss)
        direct = [float(x) for x in direct]
        diffs = [abs(a - b) for a, b in zip(fed, direct)]
        print(f"[data-air] (a) {steps} steps fed by iter_torch_batches "
              f"(B={batch}, T={seq}, {L} layers, remat mlp_only, pallas CE, "
              f"AdamW): every batch bit for bit the dataset's numpy batch "
              f"moved by hand; launches per step {counts_by_step[0]} (all "
              f"{steps} equal); losses {[round(x, 5) for x in fed]}; the "
              f"hand-fed steps' {[round(x, 5) for x in direct]}, max |diff| "
              f"{max(diffs):.3e} (tol {CE_LOSS_TOL}) [{card}]", flush=True)
        if max(diffs) > CE_LOSS_TOL or not all(map(math.isfinite, fed)):
            fail(f"[data-air] (a) dataset-fed losses {fed} against the "
                 f"hand-fed {direct}")
        del params_d, opt_d

        # dataset-fed and direct, in turns (warm-up already paid)
        walls = {"dataset": [], "direct": []}
        for kind in DATA_TURNS:
            p, o = fresh()
            sync()
            t0 = time.perf_counter()
            if kind == "dataset":
                it = sh.iter_torch_batches(batch_size=batch, drop_last=True,
                                           device=None if on_card else dev)
                for _ in range(steps):
                    t1 = time.perf_counter()
                    b = next(it)
                    waits.append(time.perf_counter() - t1)
                    p, o, _ = uncounted(fa, lambda: step(p, o, b))
                it.close()
            else:
                for b in by_hand:
                    p, o, _ = uncounted(fa, lambda: step(p, o, {"tokens": b}))
            sync()
            walls[kind].append(time.perf_counter() - t0)
            del p, o
        n_params = gpt2_param_count(cfg)
        tps = {k: [steps * batch * seq / w for w in v]
               for k, v in walls.items()}
        wait_ms = sorted(w * 1e3 for w in waits)
        p50 = wait_ms[len(wait_ms) // 2]
        p99 = wait_ms[min(len(wait_ms) - 1, int(0.99 * len(wait_ms)))]
        mfu = {k: [6 * n_params * t / H100_BF16_PEAK_FLOPS for t in v]
               for k, v in tps.items()} if on_card else None
        print(f"[data-air] (a) in turns {list(DATA_TURNS)}, {steps} steps "
              f"each: tokens/s fed from the dataset "
              f"{[round(x, 1) for x in tps['dataset']]}, fed directly "
              f"{[round(x, 1) for x in tps['direct']]} (MFU "
              f"{mfu and {k: [round(x, 4) for x in v] for k, v in mfu.items()}}"
              f"); the wait for a batch (next() of iter_torch_batches) over "
              f"{len(waits)} batches p50 {p50:.3f} ms, p99 {p99:.3f} ms "
              f"[{card}]", flush=True)
        out.update(counts_train=counts_train, losses=fed, direct=direct,
                   tokens_per_s=tps, wait_ms_p50=p50, wait_ms_p99=p99,
                   shuffle_ms=t_shuffle * 1e3, steps_run=steps)

        # -- (b) the checkpoint ------------------------------------------
        tree = {"params": params, "opt_state": opt}
        nbytes = _tree_nbytes(tree)
        sync()
        t0 = time.perf_counter()
        ckpt = air.Checkpoint.from_dict(tree)
        t_host = time.perf_counter() - t0
        t0 = time.perf_counter()
        path = ckpt.to_directory(f"{tmp}/air")
        t_write = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = air.Checkpoint.from_directory(path).to_dict()
        t_read = time.perf_counter() - t0
        ok_air = _tree_bitwise_equal(torch, tree, back)
        sync()
        t0 = time.perf_counter()
        target = save_sharded(tree, f"{tmp}/sharded", step=steps)
        t_save = time.perf_counter() - t0
        ck2 = sharded_checkpoint_to_air(f"{tmp}/sharded", step=steps)
        got_path = ck2.to_dict()["sharded_checkpoint_path"]
        t0 = time.perf_counter()
        restored = restore_sharded(got_path, device=dev)
        sync()
        t_restore = time.perf_counter() - t0
        ok_sharded = got_path == target and _tree_bitwise_equal(
            torch, tree, restored)
        gbs = {"to_host": nbytes / t_host / 1e9,
               "to_directory": nbytes / t_write / 1e9,
               "from_directory": nbytes / t_read / 1e9,
               "save_sharded": nbytes / t_save / 1e9,
               "restore_sharded": nbytes / t_restore / 1e9}
        print(f"[data-air] (b) {nbytes / 1e9:.3f} GB (params and AdamW "
              f"state after (a)): Checkpoint.from_dict -> to_directory -> "
              f"from_directory -> to_dict bit for bit {ok_air}; "
              f"save_sharded -> sharded_checkpoint_to_air -> "
              f"restore_sharded bit for bit {ok_sharded}; GB/s "
              f"{ {k: round(v, 3) for k, v in gbs.items()} } [{card}]",
              flush=True)
        if not (ok_air and ok_sharded):
            fail(f"[data-air] (b) a checkpoint round trip changed the tree "
                 f"(AIR {ok_air}, sharded {ok_sharded})")
        out["checkpoint_gbs"] = gbs
        out["checkpoint_bytes"] = nbytes
        host_params = back["params"]
        del tree, back, restored, ckpt, params, opt, params0
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()

        # -- (c) batch inference on a GPU actor --------------------------
        pcfg = gpt2_config(preset, max_seq=seq)
        Pred = _gpt2_predictor(pcfg, None if on_card else device,
                               PREDICT_KV)
        pds = data.from_numpy({"tokens": tokens[:prompts, :prompt_len]},
                              parallelism=prompts // predict_b)
        pckpt = air.Checkpoint.from_dict({"params": host_params})
        cw = worker_context.core_worker()
        for k in cw.kv_keys(PREDICT_KV):
            cw.kv_del(k)
        t0 = time.perf_counter()
        rows_out = air.BatchPredictor.from_checkpoint(pckpt, Pred).predict(
            pds, compute=data.ActorPoolStrategy(
                size=1, num_gpus=1 if on_card else 0)).take_all()
        t_pool = time.perf_counter() - t0
        books = [json.loads(cw.kv_get(k)) for k in cw.kv_keys(PREDICT_KV)]
        if len(books) != 1:
            fail(f"[data-air] (c) {len(books)} pool actors booked launches, "
                 f"expected 1")
        book = books[0]
        counts_predict = book["counts"]
        # the actor's first batch pays its process's first forward
        # (the kernel library's load, cuBLAS's handles)
        warm = book["batch_s"][1:]
        actor_rps = predict_b * len(warm) / sum(warm)
        want_pred = {c: 0 for c in COUNTERS + CE_COUNTERS}
        want_pred["FLASH_FWD_LAUNCHES"] = n * L * (prompts // predict_b)
        # the driver's own predictor, batch by batch
        mine = Pred.load(pckpt, granted=False)
        t0 = time.perf_counter()
        drv = [mine.forward(tokens[i:i + predict_b, :prompt_len])
               for i in range(0, prompts, predict_b)]
        sync()
        t_drv = time.perf_counter() - t0
        nxt = torch.cat([d[0] for d in drv]).cpu()
        nll = torch.cat([d[1] for d in drv]).float().cpu()
        last = torch.cat([d[2] for d in drv]).float().cpu()
        ties, nll_diff = [], 0.0
        for i, r in enumerate(rows_out):
            nll_diff = max(nll_diff, abs(r["nll"] - float(nll[i])))
            if r["next"] != int(nxt[i]):
                gap = float(last[i, int(nxt[i])] - last[i, r["next"]])
                scale = float(last[i].abs().max())
                ties.append((i, gap, CONT_NEAR_TIE * scale))
        print(f"[data-air] (c) BatchPredictor over {prompts} prompts of "
              f"{prompt_len} tokens in blocks of {predict_b} on "
              f"ActorPoolStrategy(size=1, num_gpus={1 if on_card else 0}): "
              f"{len(rows_out)} rows in {t_pool:.2f} s with the actor's start "
              f"({prompts / t_pool:.1f} rows/s); the actor's predict by "
              f"batch {[round(x * 1e3, 2) for x in book['batch_s']]} ms "
              f"({actor_rps:.1f} rows/s after the first), the driver's "
              f"{t_drv:.3f} s ({prompts / t_drv:.1f} rows/s); the actor "
              f"(pid {book['pid']}, CUDA_VISIBLE_DEVICES="
              f"{book['visible']!r}) launched {counts_predict}; argmax "
              f"parted at {len(ties)} rows {ties}; nll max |diff| "
              f"{nll_diff:.3e} (tol {PREDICT_NLL_TOL}) [{card}]", flush=True)
        if len(rows_out) != prompts:
            fail(f"[data-air] (c) {len(rows_out)} rows, expected {prompts}")
        if counts_predict != want_pred:
            fail(f"[data-air] (c) the actor launched {counts_predict}, "
                 f"expected {want_pred}")
        if any(gap > bound for _, gap, bound in ties) or \
                nll_diff > PREDICT_NLL_TOL:
            fail(f"[data-air] (c) the actor's rows part from the driver's: "
                 f"ties {ties}, nll max |diff| {nll_diff}")
        if on_card and not book["visible"]:
            fail("[data-air] (c) the pool actor held no card")
        out["counts_predict"] = {"flash_fwd": counts_predict[
            "FLASH_FWD_LAUNCHES"], "flash_bwd_dq": counts_predict[
            "FLASH_BWD_DQ_LAUNCHES"], "flash_bwd_dkv": counts_predict[
            "FLASH_BWD_DKV_LAUNCHES"]}
        out.update(predict_rows_per_s=actor_rps,
                   predict_rows_per_s_wall=prompts / t_pool,
                   driver_rows_per_s=prompts / t_drv, ties=ties,
                   nll_diff=nll_diff)
        # the datasets' blocks (and numpy views of them) go before the
        # store does
        del mine, drv, host_params, pckpt, want, sh, ds, pds
    finally:
        rt.shutdown()
        shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    return out

#: phase moe-mesh (12g): GPT-2-124M's widths with experts in every block
#: (Mixtral-8x7B's routing: 8 experts, top-2), its timed batch, the
#: small f32 batch held against the plain versions, the timed steps
#: after a warm-up, and the declared group's tensor and rounds
MOE_KW = dict(n_experts=8, moe_top_k=2, moe_capacity_factor=1.25,
              moe_aux_weight=0.01, remat_policy="full", ce_impl="pallas")
MOE_B, MOE_CHECK_B, MOE_STEPS = 8, 2, 5
MOE_SEED = 23
GROUP_ELEMS, GROUP_ROUNDS = 1 << 18, 20


class _GroupMember:
    """A member of a declared collective group on the port's runtime
    (phase moe-mesh (d)): rank 0 holds the card when the node has one,
    rank 1 none.  ``run`` does allreduce, allgather, broadcast and
    send/recv on its tensor (on the card where it has one), returns the
    results on the host and the µs each op took over ``rounds``."""

    def __init__(self, rank: int, world: int, name: str):
        from ray_tpu_torch.parallel import collective

        collective.init_collective_group(world, rank, group_name=name)
        self.rank, self.name = rank, name

    def run(self, n: int, rounds: int) -> dict:
        import os

        import torch

        from ray_tpu_torch.parallel import collective as col

        dev = "cuda" if torch.cuda.is_available() else "cpu"
        x = torch.arange(n, dtype=torch.float32, device=dev) + 1000 * self.rank
        g = self.name

        def sync():
            if dev == "cuda":
                torch.cuda.synchronize()

        def p2p():
            if self.rank == 0:
                col.send(x, 1, group_name=g)
                return x
            return col.recv(0, group_name=g, like=x)

        ops = {"allreduce": lambda: col.allreduce(x, group_name=g),
               "allgather": lambda: torch.stack(col.allgather(
                   x, group_name=g)),
               "broadcast": lambda: col.broadcast(x, src_rank=0,
                                                  group_name=g),
               "send_recv": p2p}
        out = {"device": str(x.device),
               "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
               "result_devices": {}, "results": {}, "us": {}}
        for name, op in ops.items():
            got = op()
            sync()
            out["result_devices"][name] = str(got.device)
            out["results"][name] = got.cpu().numpy()
            t0 = time.perf_counter()
            for _ in range(rounds):
                op()
            sync()
            out["us"][name] = (time.perf_counter() - t0) / rounds * 1e6
        # the group's keys go with the runtime: a member that deleted
        # them here could do so before the other has read its part
        col.barrier(group_name=g)
        return out


def moe_step_counts(cfg) -> dict:
    """Launches of each kernel in one AdamW step of GPT-2 with experts
    under whole-block remat, flash attention and the fused CE, worked
    out from the code: gpt2_hidden runs each block once forward and
    once more in the backward (torch.utils.checkpoint recomputes it),
    each run one flash forward; the block's backward one dQ and one
    dK/dV; the head one of each fused CE kernel."""
    L = cfg.n_layer
    return {"flash_fwd": 2 * L, "flash_bwd_dq": L, "flash_bwd_dkv": L,
            "fused_ce_fwd": 1, "fused_ce_bwd_dh": 1, "fused_ce_bwd_dw": 1}


def moe_peak_bytes(cfg, batch: int, seq: int) -> dict:
    """The step's memory, reckoned before the run: f32 parameters,
    gradients and two AdamW moments (16 bytes a parameter); the block
    inputs that whole-block remat keeps (L x B x T x d in the compute
    dtype); and one block's MoE tensors at a time in its recompute and
    backward, N x E x C elements each in the compute dtype: the slot
    one-hot, the combine tensor, the combine's gradient, and the 1-byte
    mask they are made from."""
    from ray_tpu_torch.models.gpt2 import gpt2_param_count

    n_params = gpt2_param_count(cfg) + (cfg.padded_vocab - cfg.vocab_size) \
        * cfg.d_model
    el = 2 if cfg.dtype is not None and str(cfg.dtype).endswith(
        "bfloat16") else 4
    N = batch * seq
    C = math.ceil(N * cfg.moe_top_k / cfg.n_experts * cfg.moe_capacity_factor)
    nec = N * cfg.n_experts * C
    parts = {"state": 16 * n_params,
             "block_inputs": cfg.n_layer * N * cfg.d_model * el,
             "moe_block": nec * (3 * el + 1)}
    parts["total"] = sum(parts.values())
    parts.update(params=n_params, tokens=N, capacity=C)
    return parts


def _tree_max_diff(torch, a, b) -> float:
    from ray_tpu_torch.train.optim import tree_leaves

    diff = 0.0
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        x = x.to_local() if hasattr(x, "to_local") else x
        y = y.to_local() if hasattr(y, "to_local") else y
        diff = max(diff, float((x.float() - y.float()).abs().max()))
    return diff


def phase_moe_mesh(torch, np, fa, card: str, preset: str = "gpt2",
                   device: str = "cuda", seq: int = TRAIN_T,
                   batch: int = MOE_B, check_batch: int = MOE_CHECK_B,
                   steps: int = MOE_STEPS, group_elems: int = GROUP_ELEMS,
                   group_rounds: int = GROUP_ROUNDS) -> dict:
    """12g: the device plane and mixture-of-experts on the card.  (a) a
    world-1 NCCL process group on the card (localhost rendezvous), a
    make_mesh over it with the six named axes, GPT-2 (``preset``'s
    widths, MOE_KW: 8 experts, top-2, capacity 1.25, aux 0.01, whole
    -block remat, pallas CE, flash) placed by shard_params; (b) one f32
    step at ``check_batch`` rows through the kernels held against the
    step through the plain versions (plain attention, dense CE), then
    ``steps`` timed bf16 AdamW steps at ``batch`` rows after a warm-up:
    step ms (median), tokens/s, peak memory against the reckoned one,
    launches a step against moe_step_counts, the loss finite and
    falling; (c) the same step through build_train_step(mesh=...) on
    the world-1 mesh against the unsharded step from the same start:
    bit for bit, or the largest difference printed; (d) a declared
    collective group of two runtime actors, one granted the card,
    running allreduce, allgather, broadcast and send/recv on a CUDA
    tensor against numpy, µs an op.  ``preset``/``device`` and the
    sizes let it run cut down on the CPU (gloo, no launches)."""
    import gc
    import shutil

    import torch.distributed as dist

    import ray_tpu_torch as rt
    from ray_tpu_torch.models.gpt2 import (gpt2_config, gpt2_init,
                                           gpt2_logical_axes, gpt2_loss)
    from ray_tpu_torch.parallel import MeshSpec, make_mesh, shard_params
    from ray_tpu_torch.parallel.mesh import mesh_shape
    from ray_tpu_torch.train import adamw, build_train_step
    from ray_tpu_torch.train.optim import tree_leaves, tree_map

    dev = torch.device(device)
    on_card = dev.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    out = {}
    # -- (a) the process group and the mesh ------------------------------
    backend = "nccl" if on_card else "gloo"
    port = _free_tcp_ports(1)
    t0 = time.perf_counter()
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1)
    try:
        mesh = make_mesh(MeshSpec())
        t_group = time.perf_counter() - t0
        got = dist.get_backend()
        print(f"[moe-mesh] (a) process group: backend {got}, world size "
              f"{dist.get_world_size()}, rank {dist.get_rank()}; mesh "
              f"{mesh_shape(mesh)} on {mesh.device_type} (group and mesh in "
              f"{t_group:.2f} s) [{card}]", flush=True)
        if got != backend or mesh.device_type != dev.type:
            fail(f"[moe-mesh] (a) backend {got} on {mesh.device_type}, "
                 f"expected {backend} on {dev.type}")
        cfg = gpt2_config(preset, max_seq=seq, **MOE_KW)
        axes = gpt2_logical_axes(cfg)
        gen = torch.Generator(device=dev).manual_seed(MOE_SEED)
        params0 = gpt2_init(cfg, gen, device=dev)
        placed = shard_params(params0, axes, mesh)
        kinds = sorted({str(p.placements) for p in tree_leaves(placed)})
        print(f"[moe-mesh] (a) GPT-2 {preset} widths with {cfg.n_experts} "
              f"experts, top-{cfg.moe_top_k}: {len(tree_leaves(placed))} "
              f"leaves placed by shard_params(DEFAULT_RULES) as DTensors, "
              f"placements {kinds}", flush=True)
        del placed

        # -- (b) the step against the plain versions, then timed -----------
        L = cfg.n_layer
        want = moe_step_counts(cfg) if on_card else {
            k: 0 for k in moe_step_counts(cfg)}
        cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
        small = {"tokens": torch.randint(0, cfg.vocab_size,
                                         (check_batch, seq + 1),
                                         generator=gen, device=dev)}
        head_only = torch.ones(cfg.padded_vocab, dtype=torch.bool,
                               device=dev)
        head_only[small["tokens"][:, :-1].flatten()] = False
        if on_card:
            kern = one_step(torch, fa, params0, small, cfg32)
            plain = uncounted(fa, lambda: one_step(
                torch, fa, params0, small, dataclasses.replace(
                    cfg32, use_flash=False, ce_impl="dense")))
            vs, text, ok = compare_steps(kern, plain, "dense", head_only)
            print(f"[moe-mesh] (b) f32, B={check_batch}, T={seq}: the step "
                  f"through the kernels loss {kern['loss']:.6f}, grad norm "
                  f"{kern['grad_norm']:.6f}, launches {kern['counts']} "
                  f"(expected {want}){text} [{card}]", flush=True)
            if not ok or kern["counts"] != want or kern["nonfinite"]:
                fail(f"[moe-mesh] (b) the f32 step disagrees with the plain "
                     f"versions or launched {kern['counts']}: {vs}")
            out["f32_vs_plain"] = vs
            del kern, plain
        big = {"tokens": torch.randint(0, cfg.vocab_size, (batch, seq + 1),
                                       generator=gen, device=dev)}
        tx = adamw(3e-4, weight_decay=0.1)
        step = build_train_step(lambda p, b: gpt2_loss(p, b, cfg), tx,
                                telemetry=False)

        def fresh():
            p = tree_map(torch.clone, params0)
            return p, tx.init(p)

        reckoned = moe_peak_bytes(cfg, batch, seq)
        print(f"[moe-mesh] (b) reckoned before the run: {reckoned['params']} "
              f"parameters, N={reckoned['tokens']} tokens, capacity "
              f"C={reckoned['capacity']} slots an expert; f32 state "
              f"{reckoned['state'] / 2**30:.2f} GiB + block inputs "
              f"{reckoned['block_inputs'] / 2**30:.2f} GiB + one block's MoE "
              f"tensors {reckoned['moe_block'] / 2**30:.2f} GiB = "
              f"{reckoned['total'] / 2**30:.2f} GiB peak", flush=True)
        params, opt = fresh()
        sync()
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        walls, losses, by_step = [], [], []
        zero_counts(fa)
        for i in range(steps + 1):
            before = read_counts(fa)
            sync()
            t0 = time.perf_counter()
            params, opt, loss = step(params, opt, big)
            sync()
            walls.append(time.perf_counter() - t0)
            after = read_counts(fa)
            by_step.append({k: after.get(k, 0) - before.get(k, 0)
                            for k in want})
            losses.append(float(loss))
        counts = read_counts(fa)
        peak = torch.cuda.max_memory_allocated() if on_card else 0
        med = sorted(walls[1:])[len(walls[1:]) // 2]
        tps = batch * seq / med
        print(f"[moe-mesh] (b) bf16, B={batch}, T={seq}, {L} layers: "
              f"{steps} timed steps after a warm-up, step ms "
              f"{[round(w * 1e3, 2) for w in walls]}, median "
              f"{med * 1e3:.2f} ms, {tps:.1f} tokens/s; peak allocated "
              f"{peak / 2**30:.2f} GiB (reckoned "
              f"{reckoned['total'] / 2**30:.2f}); launches a step "
              f"{by_step[0]} (predicted {want}; all {steps + 1} equal: "
              f"{all(c == want for c in by_step)}); losses "
              f"{[round(x, 4) for x in losses]} [{card}]", flush=True)
        if any(c != want for c in by_step):
            fail(f"[moe-mesh] (b) launches by step {by_step}, expected "
                 f"{want} each")
        if not all(map(math.isfinite, losses)) or not losses[-1] < losses[0]:
            fail(f"[moe-mesh] (b) the loss is not finite and falling: "
                 f"{losses}")
        out.update(step_ms=med * 1e3, tokens_per_s=tps, peak_gib=peak / 2**30,
                   reckoned_gib=reckoned["total"] / 2**30, losses=losses,
                   per_step=by_step[0], predicted=want)
        if on_card:
            # where the step's device time goes (one more step, outside
            # the main path's count)
            out["profile"] = uncounted(fa, lambda: profile_step(
                torch, {"batch": big, "moe": [step, params, opt]}, "moe",
                med * 1e3, card, tag="moe-mesh"))
        del params, opt

        # -- (c) the sharded step against the unsharded one ----------------
        p_ref, o_ref = fresh()
        p_ref, o_ref, l_ref = uncounted(fa, lambda: step(p_ref, o_ref, big))
        p_sh = shard_params(tree_map(torch.clone, params0), axes, mesh)
        o_sh = tx.init(p_sh)
        sstep = build_train_step(lambda p, b: gpt2_loss(p, b, cfg), tx,
                                 mesh=mesh, logical_axes=axes,
                                 telemetry=False)
        before = read_counts(fa)
        p_sh, o_sh, l_sh = sstep(p_sh, o_sh, big)
        sync()
        after = read_counts(fa)
        counts = read_counts(fa)
        sharded_counts = {k: after.get(k, 0) - before.get(k, 0)
                          for k in want}
        d_params = _tree_max_diff(torch, p_sh, p_ref)
        d_mu = _tree_max_diff(torch, o_sh["mu"], o_ref["mu"])
        d_loss = abs(float(l_sh) - float(l_ref))
        bitwise = d_params == 0.0 and d_mu == 0.0 and d_loss == 0.0
        why = ("" if bitwise else
               "; not bit for bit: the sharded step's loss and updates run "
               "through other code (gathered local views, the mesh's "
               "all-reduce of the loss)")
        print(f"[moe-mesh] (c) build_train_step(mesh=...) on the world-1 "
              f"mesh vs the unsharded step from the same start: loss "
              f"{float(l_sh):.6f} vs {float(l_ref):.6f}; max |diff| of the "
              f"updated parameters {d_params:.3e}, of the first moments "
              f"{d_mu:.3e}; bit for bit: {bitwise}{why}; launches "
              f"{sharded_counts} (the unsharded step's {want}) [{card}]",
              flush=True)
        if sharded_counts != want or d_loss > CE_LOSS_TOL or \
                d_params > 2 * 3e-4:
            fail(f"[moe-mesh] (c) the sharded step differs: loss |diff| "
                 f"{d_loss}, params {d_params}, launches {sharded_counts}")
        out.update(sharded_bitwise=bitwise, sharded_param_diff=d_params,
                   counts=counts)
        del p_ref, o_ref, p_sh, o_sh
    finally:
        dist.destroy_process_group()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    # -- (d) the declared collective group on the runtime -----------------
    shm_free = shutil.disk_usage("/dev/shm").free
    store = min(RUN_STORE_MAX, shm_free // 2) // 2**20 * 2**20
    rt.init(num_cpus=4, num_gpus=1 if on_card else 0,
            object_store_memory=store)
    try:
        member = rt.remote(_GroupMember)
        a = rt.remote(num_gpus=1 if on_card else 0)(_GroupMember).remote(
            0, 2, "chip_smoke_moe_mesh")
        b = member.remote(1, 2, "chip_smoke_moe_mesh")
        r0, r1 = rt.get([a.run.remote(group_elems, group_rounds),
                         b.run.remote(group_elems, group_rounds)],
                        timeout=600)
    finally:
        rt.shutdown()
    x = [np.arange(group_elems, dtype=np.float32) + 1000 * r for r in (0, 1)]
    expect = {"allreduce": x[0] + x[1], "allgather": np.stack(x),
              "broadcast": x[0]}
    bad = []
    for r, res in ((0, r0), (1, r1)):
        for name, w in expect.items():
            if not np.array_equal(res["results"][name], w):
                bad.append(f"rank {r} {name}")
    if not np.array_equal(r1["results"]["send_recv"], x[0]):
        bad.append("rank 1 recv")
    print(f"[moe-mesh] (d) declared group of 2 runtime actors (rank 0 on "
          f"{r0['device']}, CUDA_VISIBLE_DEVICES={r0['visible']!r}; rank 1 "
          f"on {r1['device']}), {group_elems} f32 elements: results on "
          f"{r0['result_devices']} / {r1['result_devices']}, equal to "
          f"numpy's: {not bad}; µs an op over {group_rounds} rounds, rank 0 "
          f"{ {k: round(v, 1) for k, v in r0['us'].items()} }, rank 1 "
          f"{ {k: round(v, 1) for k, v in r1['us'].items()} } [{card}]",
          flush=True)
    if bad:
        fail(f"[moe-mesh] (d) {bad} differ from numpy's")
    if on_card and not (r0["device"].startswith("cuda") and all(
            d.startswith("cuda") for d in r0["result_devices"].values())):
        fail(f"[moe-mesh] (d) rank 0 ran on {r0['device']}, results on "
             f"{r0['result_devices']}: expected the card")
    out["group_us"] = {"rank0": r0["us"], "rank1": r1["us"]}
    return out


#: phase seq-pipe-tp (12i): attention over the seq axis at the serve
#: shape B, H, D with T = TRAIN_T; the seq-parallel step at SP_B rows;
#: the one-stage pipeline at PP_M microbatches of PP_MB rows; the
#: world-1 tensor-parallel engine (f32, paged) on TP_N requests
SP_B, SP_STEPS = 8, 3
PP_M, PP_MB = 4, 2
TP_N, TP_SLOTS, TP_MAX_NEW, TP_SEED = 8, 4, 16, 31
SPT_SEED = 37
#: the one-stage pipeline against gpt2_hidden in bf16 (other microbatch
#: shapes: the products may take other cuBLAS algorithms): the hidden
#: states at the logits' bf16 tolerance, the loss and the global
#: gradient norm relative, each block leaf's gradient by the relative
#: norm of its difference (the train phase's qkv bound)
PP_HIDDEN_TOL = LOGIT_TOL
PP_LOSS_RTOL = 1e-3
PP_GRAD_NORM_RTOL = 1e-3
PP_LEAF_RTOL = TRAIN_QKV_GRAD_RTOL


def seq_pipe_counts(cfg, m: int = PP_M) -> dict:
    """Launches predicted for phase 12i's counted paths: Ulysses once
    (1, 1, 1); a seq-parallel step with whole-block remat, each sp_mode
    (2 L forward: the forward and its recompute, L dQ, L dK/dV); the
    one-stage pipeline, M ticks each rematted whole (2 M L forward,
    M L dQ, M L dK/dV)."""
    L = cfg.n_layer
    return {"ulysses": {"flash_fwd": 1, "flash_bwd_dq": 1,
                        "flash_bwd_dkv": 1},
            "sp_step": {"flash_fwd": 2 * L, "flash_bwd_dq": L,
                        "flash_bwd_dkv": L},
            "pipeline": {"flash_fwd": 2 * m * L, "flash_bwd_dq": m * L,
                         "flash_bwd_dkv": m * L}}


def _delta(before: dict, after: dict) -> dict:
    return {k: after.get(k, 0) - before.get(k, 0)
            for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}


def phase_seq_pipe_tp(torch, np, fa, card: str, preset: str = "gpt2",
                      device: str = "cuda", seq: int = TRAIN_T,
                      heads: int = H, head_dim: int = D,
                      attn_batch: int = B, sp_batch: int = SP_B,
                      sp_steps: int = SP_STEPS, mb_rows: int = PP_MB,
                      n_req: int = TP_N) -> dict:
    """12i: sequence, pipeline and tensor parallelism on a world-1 NCCL
    mesh, at GPT-2-124M's widths.  (a) ring and Ulysses attention
    (ops/ring_attention.py) at B x T x H x D, forward and backward: in
    f32 both held against reference_attention (output and q/k/v
    gradients at the f32 kernel tolerance); in bf16 Ulysses' one flash
    forward, dQ and dK/dV read from the counters, and Ulysses bit for
    bit the direct flash call (its all-to-alls are the identity at
    world 1); each one's bf16 error against the f32 reference printed
    and each timed beside the direct flash call; (b) a seq_parallel GPT-2 step
    (dense CE, both sp_modes) through build_train_step on the mesh,
    ``sp_steps`` steps against the same config's meshless step; (c)
    pipeline_apply with one stage, GPT-2-124M's 12 blocks, PP_M
    microbatches, remat, forward and backward of a loss of the hidden
    states, held against gpt2_hidden on the same parameters; (d) a
    continuous GPT-2 engine (f32, paged) with mesh= the world-1 mesh
    and with none: the same replies, JAX's engine_stats()["mesh"] keys,
    the programs under serve.sharded_*; then one bench time_decode
    (mesh=) call beside the meshless one.  ``device`` and the sizes let
    it run cut down on the CPU (gloo, no launches)."""
    import gc

    import torch.distributed as dist

    from ray_tpu_torch.bench import time_decode
    from ray_tpu_torch.models import gpt2 as tg
    from ray_tpu_torch.ops import (causal_attention, pipeline_apply,
                                   reference_attention, ring_attention,
                                   ulysses_attention)
    from ray_tpu_torch.parallel import MeshSpec, make_mesh
    from ray_tpu_torch.parallel.mesh import mesh_context, mesh_shape
    from ray_tpu_torch.serve.llm import build_llm_deployment
    from ray_tpu_torch.train import adamw, build_train_step
    from ray_tpu_torch.train.optim import tree_leaves, tree_map

    dev = torch.device(device)
    on_card = dev.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def timed(fn):
        return time_ms(torch, fn, iters=5) if on_card else None

    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    cfg = tg.gpt2_config(preset, max_seq=seq)
    want = seq_pipe_counts(cfg) if on_card else {
        k: {n: 0 for n in v} for k, v in seq_pipe_counts(cfg).items()}
    gen = torch.Generator(device=dev).manual_seed(SPT_SEED)
    out = {"predicted": want}
    backend = "nccl" if on_card else "gloo"
    dist.init_process_group(
        backend, init_method=f"tcp://127.0.0.1:{_free_tcp_ports(1)}",
        rank=0, world_size=1)
    try:
        mesh = make_mesh(MeshSpec())
        print(f"[seq-pipe-tp] world-1 {dist.get_backend()} mesh "
              f"{mesh_shape(mesh)} on {mesh.device_type} [{card}]",
              flush=True)
        zero_counts(fa)

        # -- (a) ring and Ulysses attention -------------------------------
        shape = (attn_batch, seq, heads, head_dim)
        q, k, v, do = (torch.randn(shape, generator=gen, device=dev)
                       for _ in range(4))

        def fwd_bwd(fn, dtype):
            qs, ks, vs = (t.detach().to(dtype).requires_grad_(True)
                          for t in (q, k, v))
            o = fn(qs, ks, vs)
            o.backward(do.to(dtype))
            return o.detach(), qs.grad, ks.grad, vs.grad

        fns = {"ulysses": lambda a, b, c: ulysses_attention(a, b, c,
                                                            mesh=mesh),
               "ring": lambda a, b, c: ring_attention(a, b, c, mesh=mesh),
               "flash": lambda a, b, c: causal_attention(a, b, c)}
        # f32: each against reference_attention at the kernel phases' f32
        # tolerance (the f32 kernels; outside the counted path)
        ref = uncounted(fa, lambda: fwd_bwd(
            lambda a, b, c: reference_attention(a, b, c, causal=True),
            torch.float32))
        got, ms = {}, {}
        for name in ("ulysses", "ring"):
            res = uncounted(fa, lambda: fwd_bwd(fns[name], torch.float32))
            o_err = (res[0] - ref[0]).abs().max().item()
            grads = [bwd_compare(g, w, "f32")
                     for g, w in zip(res[1:], ref[1:])]
            got[name] = {"f32_o_max": o_err, "f32_grads": grads}
            print(f"[seq-pipe-tp] (a) {name}, f32 B={attn_batch} T={seq} "
                  f"H={heads} D={head_dim}, forward and backward vs "
                  f"reference_attention: O max|d| {o_err:.3e}, "
                  f"{bwd_report(grads)} [{card}]", flush=True)
            if o_err > TOL[("f32", "o")] or not all(c["ok"] for c in grads):
                fail(f"[seq-pipe-tp] (a) {name} in f32 disagrees with "
                     f"reference_attention: O {o_err}, {grads}")
        # bf16, the counted path: Ulysses' one flash forward, dQ and
        # dK/dV; at world 1 its all-to-alls are the identity, so it is
        # the direct flash call bit for bit.  Each one's error against
        # the f32 reference and its fwd+bwd ms (CUDA events) beside it
        before = read_counts(fa)
        uly = fwd_bwd(fns["ulysses"], torch.bfloat16)
        sync()
        launched = _delta(before, read_counts(fa))
        direct = uncounted(fa, lambda: fwd_bwd(fns["flash"], torch.bfloat16))
        same = all(torch.equal(a, b) for a, b in zip(uly, direct))
        for name in ("ulysses", "ring", "flash"):
            res = {"ulysses": uly, "flash": direct}.get(name) or uncounted(
                fa, lambda: fwd_bwd(fns[name], torch.bfloat16))
            errs = [(r.float() - w).abs().max().item()
                    for r, w in zip(res, ref)]
            ms[name] = uncounted(fa, lambda: timed(
                lambda: fwd_bwd(fns[name], torch.bfloat16)))
            got.setdefault(name, {}).update(bf16_max_vs_f32=errs)
            print(f"[seq-pipe-tp] (a) {name}, bf16: max|d| vs the f32 "
                  f"reference (o, dq, dk, dv) "
                  f"{[f'{e:.3e}' for e in errs]}; forward and backward "
                  f"{ms[name]} ms [{card}]", flush=True)
        print(f"[seq-pipe-tp] (a) Ulysses bf16 launches {launched} "
              f"(predicted {want['ulysses']}); equal to the direct flash "
              f"call bit for bit: {same} [{card}]", flush=True)
        if launched != want["ulysses"] or not same:
            fail(f"[seq-pipe-tp] (a) Ulysses launched {launched}, bit for "
                 f"bit the direct call: {same}")
        got["ulysses"]["launches"] = launched
        out["attention"] = got
        out["attention_ms"] = ms
        del q, k, v, do, ref, uly, direct

        # -- (b) the seq-parallel GPT-2 step on the mesh ------------------
        params0 = tg.gpt2_init(cfg, gen, device=dev)
        batch = {"tokens": torch.randint(0, cfg.vocab_size,
                                         (sp_batch, seq + 1),
                                         generator=gen, device=dev)}
        tx = adamw(3e-4, weight_decay=0.1)
        out["sp"] = {}
        for mode in ("ring", "ulysses"):
            scfg = dataclasses.replace(cfg, seq_parallel=True, sp_mode=mode,
                                       ce_impl="dense")
            loss_fn = (lambda c: lambda p, b: tg.gpt2_loss(p, b, c))(scfg)
            losses = {}
            for with_mesh in (True, False):
                step = build_train_step(loss_fn, tx,
                                        mesh=mesh if with_mesh else None,
                                        telemetry=False)
                p = tree_map(torch.clone, params0)
                o = tx.init(p)
                before = read_counts(fa)
                run = []
                for _ in range(sp_steps):
                    if with_mesh:
                        p, o, loss = step(p, o, batch)
                    else:
                        p, o, loss = uncounted(fa, lambda: step(p, o, batch))
                    run.append(float(loss))
                sync()
                losses[with_mesh] = run
                if with_mesh:
                    per_step = {k: v // sp_steps for k, v in
                                _delta(before, read_counts(fa)).items()}
                del p, o
            diff = max(abs(a - b) for a, b in zip(losses[True],
                                                  losses[False]))
            print(f"[seq-pipe-tp] (b) seq_parallel sp_mode={mode}, dense "
                  f"CE, B={sp_batch} T={seq}: {sp_steps} steps on the "
                  f"world-1 mesh, losses {[round(x, 6) for x in losses[True]]}"
                  f" vs meshless {[round(x, 6) for x in losses[False]]}, "
                  f"max |diff| {diff:.3e}; launches a step {per_step} "
                  f"(predicted {want['sp_step']}) [{card}]", flush=True)
            if diff > CE_LOSS_TOL or per_step != want["sp_step"] or not \
                    all(map(math.isfinite, losses[True])):
                fail(f"[seq-pipe-tp] (b) sp_mode={mode}: loss |diff| "
                     f"{diff}, launches {per_step}")
            out["sp"][mode] = {"losses": losses[True], "max_diff": diff,
                               "per_step": per_step}

        # -- (c) the one-stage pipeline of the 12 blocks -------------------
        rows = PP_M * mb_rows
        tokens = torch.randint(0, cfg.vocab_size, (rows, seq),
                               generator=gen, device=dev)
        r = torch.randn((rows, seq, cfg.d_model), generator=gen, device=dev)
        stage = {"blocks": tree_map(lambda t: t[None], params0["blocks"])}

        def stage_fn(sp, act):
            for lp in tg._layers(sp["blocks"], cfg.n_layer):
                act = tg._block(act, lp, cfg)
            return act

        def pipe_loss(blocks):
            x = (params0["wte"].to(cfg.dtype)[tokens]
                 + params0["wpe"].to(cfg.dtype)[:seq])
            y = pipeline_apply(stage_fn, {"blocks": blocks}, x,
                               microbatches=PP_M, mesh=mesh, remat=True)
            h = tg._layernorm(y, params0["ln_f"]["scale"],
                              params0["ln_f"]["bias"])
            return h, (h.float() * r).mean()

        def hidden_loss(blocks):
            p = dict(params0, blocks=blocks)
            h = tg.gpt2_hidden(p, tokens, cfg)
            return h, (h.float() * r).mean()

        def value_and_grads(fn, blocks):
            live = tree_map(lambda t: t.detach().requires_grad_(True),
                            blocks)
            h, loss = fn(live)
            grads = torch.autograd.grad(loss, tree_leaves(live))
            return h.detach(), float(loss.detach()), grads

        before = read_counts(fa)
        h_p, l_p, g_p = value_and_grads(pipe_loss, stage["blocks"])
        sync()
        pipe_counts = _delta(before, read_counts(fa))
        h_r, l_r, g_r = uncounted(fa, lambda: value_and_grads(
            hidden_loss, params0["blocks"]))
        h_err = (h_p.float() - h_r.float()).abs().max().item()
        norm_p = torch.stack([g.float().norm() for g in g_p]).norm().item()
        norm_r = torch.stack([g.float().norm() for g in g_r]).norm().item()
        leaf_rel = max(((a[0].float() - b.float()).norm()
                        / b.float().norm().clamp_min(1e-30)).item()
                       for a, b in zip(g_p, g_r))
        l_rel = abs(l_p - l_r) / max(abs(l_r), 1e-30)
        n_rel = abs(norm_p - norm_r) / max(norm_r, 1e-30)
        print(f"[seq-pipe-tp] (c) pipeline_apply, one stage of "
              f"{cfg.n_layer} blocks, {PP_M} microbatches of {mb_rows}x"
              f"{seq}, remat: hidden max|d| vs gpt2_hidden {h_err:.3e}, "
              f"loss {l_p:.6e} vs {l_r:.6e} (rel {l_rel:.2e}), grad norm "
              f"{norm_p:.6e} vs {norm_r:.6e} (rel {n_rel:.2e}), worst "
              f"leaf's relative difference {leaf_rel:.3e}; launches "
              f"{pipe_counts} (predicted {want['pipeline']}) [{card}]",
              flush=True)
        if (h_err > PP_HIDDEN_TOL or l_rel > PP_LOSS_RTOL
                or n_rel > PP_GRAD_NORM_RTOL or leaf_rel > PP_LEAF_RTOL
                or pipe_counts != want["pipeline"]):
            fail(f"[seq-pipe-tp] (c) the pipeline differs from gpt2_hidden:"
                 f" hidden {h_err}, loss {l_rel}, norm {n_rel}, leaf "
                 f"{leaf_rel}, launches {pipe_counts}")
        out["pipeline"] = {"hidden_max": h_err, "loss_rel": l_rel,
                           "grad_norm_rel": n_rel, "leaf_rel": leaf_rel,
                           "launches": pipe_counts}
        del params0, stage, g_p, g_r, h_p, h_r
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()

        # -- (d) the engine on the world-1 mesh, and the bench ------------
        prompts = continuous_prompts(np, cfg.vocab_size, n_req, TP_SEED)
        kw = dict(max_new_tokens=TP_MAX_NEW, temperature=0.0,
                  scheduler="continuous", kv_layout="paged",
                  kv_block_size=CONT_BLOCK, prefill_bucket=CONT_BUCKET,
                  max_slots=TP_SLOTS, seed=TP_SEED,
                  config_overrides={"dtype": torch.float32,
                                    "max_seq": CONT_MAX_SEQ}, device=dev)
        replies, stats = {}, {}
        for with_mesh in (True, False):
            eng = build_llm_deployment(
                "gpt2", preset, mesh=mesh if with_mesh else None,
                **kw).func_or_class()
            run = lambda: asyncio.run(_serve_waves(eng, prompts, n_req))
            with torch.inference_mode():
                replies[with_mesh] = (run() if with_mesh
                                      else uncounted(fa, run))[0]
            stats[with_mesh] = eng.engine_stats()
            del eng
        same = all(np.array_equal(a, b) for a, b in
                   zip(replies[True], replies[False]))
        block = stats[True]["mesh"]
        programs = sorted(stats[True]["programs"])
        sharded = [p for p in programs if p.startswith("serve.sharded_")]
        check_replies(np, prompts, replies[True], TP_MAX_NEW,
                      cfg.vocab_size, "seq-pipe-tp")
        print(f"[seq-pipe-tp] (d) continuous GPT-2 engine, f32 paged, "
              f"{TP_SLOTS} slots, {n_req} requests: mesh=world-1 replies "
              f"equal to mesh=None's: {same}; engine_stats()['mesh'] "
              f"{ {k: v for k, v in block.items() if k != 'devices'} } "
              f"with {len(block['devices'])} device row(s); sharded "
              f"programs {sharded}; meshless engine has a mesh block: "
              f"{'mesh' in stats[False]} [{card}]", flush=True)
        if (not same or set(block) != {"axes", "n_devices", "kv_shards",
                                       "devices"}
                or block["n_devices"] != 1 or block["kv_shards"] != 1
                or not sharded or "serve.sharded_decode" not in sharded):
            fail(f"[seq-pipe-tp] (d) the mesh engine: replies equal "
                 f"{same}, mesh block {block}, programs {programs}")
        dkw = dict(prompt_len=min(128, seq // 2), new_tokens=16,
                   preset=preset, device=dev, max_seq=seq)
        t_mesh = time_decode(B, mesh=mesh, **dkw)
        t_plain = uncounted(fa, lambda: time_decode(B, **dkw))
        equal = torch.equal(t_mesh[4], t_plain[4])
        print(f"[seq-pipe-tp] (d) bench time_decode(mesh=world-1), B={B}, "
              f"prompt {dkw['prompt_len']}, 16 new: n_chips {t_mesh[3]}, TTFT "
              f"{t_mesh[0]:.2f} ms, {t_mesh[1]:.1f} tokens/s (meshless "
              f"{t_plain[0]:.2f} ms, {t_plain[1]:.1f} tokens/s); greedy "
              f"tokens equal: {equal} [{card}]", flush=True)
        if t_mesh[3] != 1 or not equal:
            fail(f"[seq-pipe-tp] (d) time_decode(mesh=) n_chips "
                 f"{t_mesh[3]}, tokens equal {equal}")
        out["engine"] = {"same": same, "mesh": block, "sharded": sharded}
        out["bench"] = {"ttft_ms": t_mesh[0], "tok_s": t_mesh[1],
                        "plain_ttft_ms": t_plain[0],
                        "plain_tok_s": t_plain[1]}
        out["counts"] = read_counts(fa)
    finally:
        dist.destroy_process_group()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    return out


#: phase train-tune (12h): GPT-2 steps in a train worker (a) and (b) and
#: in tune trials (c), each the pallas step of phase data-air; (a) and
#: (b) read the dataset of 12f (DATA_ROWS seeded rows); (b) fails once
#: after reporting step TT_FAIL_AFTER; (c) runs TT_STEPS steps at B =
#: TT_TUNE_B for each learning rate under ASHA (max_t TT_STEPS)
TT_STEPS, TT_FAIL_AFTER, TT_TUNE_B = 8, 4, 8
TT_SEED = 29
TT_LRS = (1e-4, 3e-4, 1e-3, 3e-3)
TT_LR = 3e-4
TT_ASHA = dict(metric="loss", mode="min", max_t=TT_STEPS, grace_period=2,
               reduction_factor=2)
#: where a worker or trial process books its launch counts and the
#: trial actor its probes (the cluster KV)
TT_KV = "chip_smoke:train_tune:"


def _tt_kv():
    from ray_tpu_torch._private import worker_context

    return worker_context.core_worker()


def _tt_cuda_state() -> dict:
    """This process's grant and CUDA state, without touching CUDA:
    CUDA_VISIBLE_DEVICES and whether torch has initialised CUDA."""
    import os

    torch = sys.modules.get("torch")
    return {"pid": os.getpid(),
            "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
            "cuda_initialized": bool(torch is not None
                                     and torch.cuda.is_initialized())}


def _tt_probe(tag: str) -> None:
    """Book this process's CUDA state under TT_KV + tag + its pid."""
    state = _tt_cuda_state()
    _tt_kv().kv_put(f"{TT_KV}{tag}:{state['pid']}",
                    json.dumps(state).encode())


def _proc_start() -> float:
    """When this process started, on time.time()'s clock (from /proc)."""
    import os

    with open("/proc/self/stat") as f:
        ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/stat") as f:
        boot = next(int(line.split()[1]) for line in f
                    if line.startswith("btime"))
    return boot + ticks / os.sysconf("SC_CLK_TCK")


def _tt_marks(first: dict, t0: float) -> str:
    """A process's start-up by part, from its first report: the driver's
    ``t0`` to the process's start, to its loop, imports, device, mesh
    and step, parameters, first batch, then the first step."""
    m = first["marks"]
    order = ["proc", "loop", "imports", "device", "mesh", "params", "batch"]
    parts, prev = [], t0
    for k in order:
        parts.append(f"{k} +{m[k] - prev:.2f}")
        prev = m[k]
    return (", ".join(parts) + f", first step {first['step_ms'] / 1e3:.2f}"
            f" s")


def _tree_digest(torch, tree) -> str:
    """sha256 over every leaf's bytes in tree_leaves order (on the
    host; dtype and shape included)."""
    import hashlib

    from ray_tpu_torch.train.optim import tree_leaves

    h = hashlib.sha256()
    for t in tree_leaves(tree):
        t = t.detach().cpu().contiguous()
        h.update(f"{t.dtype}{tuple(t.shape)}".encode())
        h.update(t.reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def _tt_train(config: dict, batches, start: int, tag: str) -> None:
    """Phase train-tune's steps, in a train worker or a tune trial:
    GPT-2 (``config``: preset, seq, device, lr) from the seeded start
    (TT_SEED) or from the session's checkpoint, its step built with
    ``jax_utils.get_mesh()`` and ``jax_utils.build_train_step(loss_fn,
    tx, mesh, gpt2_logical_axes(cfg))``; runs steps ``start + 1`` ..
    ``config["steps"]`` over ``batches`` (the rest of an iterator of
    token batches), each reported with its loss, step ms and launches
    (read in this process, booked in the KV under TT_KV + tag + pid).
    A checkpoint (params and AdamW state, gathered) goes with the
    report of step ``config["fail_after"]``, which then raises once
    (its marker in the KV), and the last step's carries the params."""
    import os
    import time as _time

    marks = {"proc": _proc_start(), "loop": _time.time()}
    import torch
    import torch.distributed as dist

    from ray_tpu_torch.air import session
    from ray_tpu_torch.device import resolve_device
    from ray_tpu_torch.models.gpt2 import (gpt2_config, gpt2_init,
                                           gpt2_logical_axes, gpt2_loss)
    from ray_tpu_torch.parallel.sharding import gather_params
    from ray_tpu_torch.parallel.mesh import mesh_shape
    from ray_tpu_torch.train import adamw, jax_utils
    from ray_tpu_torch.train.optim import tree_leaves, tree_map

    fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")
    marks["imports"] = _time.time()
    dev = resolve_device(config["device"])
    on_card = dev.type == "cuda"
    torch.empty(1, device=dev)  # the CUDA context, if not made yet
    marks["device"] = _time.time()
    if on_card and not os.environ.get("CUDA_VISIBLE_DEVICES"):
        raise RuntimeError("phase train-tune: this process was not granted "
                           "a card (CUDA_VISIBLE_DEVICES is empty)")
    cfg = gpt2_config(config["preset"], max_seq=config["seq"],
                      remat_policy="mlp_only", ce_impl="pallas")
    tx = adamw(config["lr"], weight_decay=0.1)
    mesh = jax_utils.get_mesh()
    step = jax_utils.build_train_step(lambda p, b: gpt2_loss(p, b, cfg), tx,
                                      mesh, gpt2_logical_axes(cfg))
    marks["mesh"] = _time.time()
    ckpt = session.get_checkpoint()
    if ckpt is not None:
        state = ckpt.to_dict()
        params = tree_map(lambda t: t.to(dev), state["params"])
        opt = {"count": state["opt_state"]["count"].clone(),
               "mu": tree_map(lambda t: t.to(dev), state["opt_state"]["mu"]),
               "nu": tree_map(lambda t: t.to(dev), state["opt_state"]["nu"])}
        if state["step"] != start:
            raise RuntimeError(f"resumed from step {state['step']}, "
                               f"expected {start}")
    else:
        params = gpt2_init(cfg, torch.Generator(device=dev).manual_seed(
            TT_SEED), device=dev)
        opt = tx.init(params)
    fingerprint = sum(float(t.double().sum()) for t in tree_leaves(params))
    marks["params"] = _time.time()
    cw = _tt_kv()
    first = {"pid": os.getpid(), "t_loop": marks["loop"], "marks": marks,
             "fingerprint": fingerprint,
             "backend": str(dist.get_backend()),
             "world": dist.get_world_size(), "mesh": mesh_shape(mesh),
             "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
             "device": (torch.cuda.get_device_name(dev) if on_card
                        else "cpu")}
    zero_counts(fa)
    total = {}
    for i in range(start, config["steps"]):
        b = next(batches)
        marks.setdefault("batch", _time.time())
        before = read_counts(fa)
        if on_card:
            torch.cuda.synchronize()
        t0 = _time.perf_counter()
        params, opt, loss = step(params, opt, b)
        loss = float(loss)
        if on_card:
            torch.cuda.synchronize()
        ms = (_time.perf_counter() - t0) * 1e3
        after = read_counts(fa)
        launches = {k: after.get(k, 0) - before.get(k, 0)
                    for k in CE_OR_FLASH}
        total = after
        cw.kv_put(f"{TT_KV}{tag}:{os.getpid()}", json.dumps(
            {"counts": total, "steps": i + 1 - start}).encode())
        metrics = {"loss": loss, "step": i + 1, "step_ms": ms,
                   "launches": launches, "pid": os.getpid(),
                   "t": _time.time(),
                   "batch_sum": int(b["tokens"].sum())}
        if i == start:
            metrics.update(first)
        last = i + 1 == config["steps"]
        fail_here = i + 1 == config.get("fail_after")
        report_ckpt = None
        if last or fail_here:
            whole = gather_params(params)
            report_ckpt = {"params": whole, "step": i + 1}
            if fail_here:
                report_ckpt["opt_state"] = {
                    "count": opt["count"], "mu": gather_params(opt["mu"]),
                    "nu": gather_params(opt["nu"])}
            if last:
                metrics["params_digest"] = _tree_digest(torch, whole)
        session.report(metrics, checkpoint=report_ckpt)
        if fail_here and cw.kv_get(f"{TT_KV}failed") is None:
            cw.kv_put(f"{TT_KV}failed", json.dumps(
                {"pid": os.getpid(), "t": _time.time()}).encode())
            raise RuntimeError(f"phase train-tune (b): a planted failure "
                               f"after step {i + 1}")


def _tt_loop(config: dict) -> None:
    """(a)/(b): the train worker's loop over its dataset shard."""
    import itertools

    start = 0
    from ray_tpu_torch.air import session

    ckpt = session.get_checkpoint()
    if ckpt is not None:
        start = ckpt.to_dict()["step"]
    it = session.get_dataset_shard("train").iter_torch_batches(
        batch_size=config["batch"], drop_last=True, device=config["device"])
    _tt_train(config, itertools.islice(it, start, None), start, "worker")


def _tt_trial(config: dict) -> None:
    """(c): a tune trial's function trainable: the rows of 12f's dataset
    (regenerated from DATA_SEED), ``config["batch"]`` a step."""
    import numpy

    import torch

    from ray_tpu_torch.device import resolve_device
    from ray_tpu_torch.models.gpt2 import gpt2_config

    cfg = gpt2_config(config["preset"], max_seq=config["seq"])
    dev = resolve_device(config["device"])
    b, s = config["batch"], config["seq"]
    rows = numpy.random.default_rng(DATA_SEED).integers(
        0, cfg.vocab_size, (config["rows"], s + 1)).astype(numpy.int32)
    batches = ({"tokens": torch.from_numpy(rows[i * b:(i + 1) * b]).to(dev)}
               for i in range(config["steps"]))
    _tt_train(config, batches, 0, "trial")


def _tt_books(cw, tag: str) -> dict:
    """{pid: book} of the processes that booked under TT_KV + tag."""
    out = {}
    for k in cw.kv_keys(f"{TT_KV}{tag}:"):
        book = json.loads(cw.kv_get(k))
        out[int(k.rsplit(":", 1)[1])] = book
    return out


def phase_train_tune(torch, np, fa, card: str, preset: str = "gpt2",
                     device: str = "cuda", rows: int = DATA_ROWS,
                     seq: int = TRAIN_T, batch: int = TRAIN_B,
                     blocks: int = DATA_BLOCKS, steps: int = TT_STEPS,
                     tune_batch: int = TT_TUNE_B) -> dict:
    """12h: Train and Tune on the port's runtime (``init(num_gpus=1)``),
    GPT-2 (``preset``, B=``batch``, T=``seq``, remat mlp_only,
    ce_impl="pallas", AdamW) from TT_SEED over 12f's seeded rows in
    ``blocks`` blocks.  (a) ``JaxTrainer(...).fit()`` on one worker
    granted the card (``ScalingConfig(num_workers=1, use_gpu=True)``,
    ``JaxConfig(distributed="jax")``): an NCCL group in the worker,
    ``steps`` steps over its dataset shard, each reporting its loss, ms
    and launches (12/12/12/1/1/1), the last an AIR checkpoint; the
    worker holds the card, the trial actor neither the grant nor a CUDA
    context; ``metrics_history`` ``steps`` rounds with ``_round`` and
    ``training_iteration``; every loss the driver's own step's on the
    same batches from the same start (CE_LOSS_TOL); the checkpoint's
    params the worker's bit for bit (sha256).  (b) the same with
    ``FailureConfig(max_failures=1)`` and a loop that raises once after
    reporting step TT_FAIL_AFTER with a checkpoint: a new worker
    process granted the card resumes from it, steps after it equal
    (a)'s.  (c) ``Tuner`` of a function trainable (``steps`` steps at
    B=``tune_batch``) over TT_LRS under ``ASHAScheduler(**TT_ASHA)``,
    ``resources_per_trial={"CPU": 1, "GPU": 1}``,
    ``max_concurrent_trials=1``: every step's launches, and the stops
    equal to a fresh ASHAScheduler's on the replayed reports.
    ``preset``/``device`` and the sizes let it run cut down on the CPU
    (gloo, no grant, no launches)."""
    import gc
    import itertools
    import os
    import shutil
    import tempfile
    import types

    import ray_tpu_torch as rt
    from ray_tpu_torch import data, tune
    from ray_tpu_torch.air.config import FailureConfig, RunConfig
    from ray_tpu_torch.models.gpt2 import gpt2_config, gpt2_init, gpt2_loss
    from ray_tpu_torch.train import (JaxConfig, JaxTrainer, ScalingConfig,
                                     adamw, build_train_step)
    from ray_tpu_torch.train.optim import tree_leaves

    dev = torch.device(device)
    on_card = dev.type == "cuda"
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    cfg = gpt2_config(preset, max_seq=seq, remat_policy="mlp_only",
                      ce_impl="pallas")
    L = cfg.n_layer
    n = 1 if on_card else 0
    per_step = {"flash_fwd": n * L, "flash_bwd_dq": n * L,
                "flash_bwd_dkv": n * L, "fused_ce_fwd": n,
                "fused_ce_bwd_dh": n, "fused_ce_bwd_dw": n}
    loop_cfg = {"preset": preset, "seq": seq, "batch": batch,
                "steps": steps, "lr": TT_LR,
                "device": None if on_card else device}

    class ProbedTrainer(JaxTrainer):
        """JaxTrainer whose training_loop books the trial actor's CUDA
        state before and after it (the actor that hosts the loop)."""

        def training_loop(self):
            _tt_probe("trial_actor_before")
            try:
                return super().training_loop()
            finally:
                _tt_probe("trial_actor_after")

    def launches_ok(history, want):
        return all(m["launches"] == want for m in history)

    def trial_probes(cw) -> list:
        """The trial actor's probes (before and after its loop), taken
        out of the KV; fails if it held a card or a CUDA context."""
        keys = cw.kv_keys(f"{TT_KV}trial_actor_")
        got = [json.loads(cw.kv_get(k)) for k in keys]
        for k in keys:
            cw.kv_del(k)
        if len(got) != 2 or len({g["pid"] for g in got}) != 1 or any(
                g["visible"] or g["cuda_initialized"] for g in got):
            fail(f"[train-tune] the trial actor's process holds a card or "
                 f"a CUDA context: {got}")
        return got

    store = min(RUN_STORE_MAX, shutil.disk_usage("/dev/shm").free // 2) \
        // 2**20 * 2**20
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_tune_")
    results_env = os.environ.get("RAYTPU_RESULTS_DIR")
    os.environ["RAYTPU_RESULTS_DIR"] = f"{tmp}/results"
    t0 = time.perf_counter()
    rt.init(num_cpus=4, num_gpus=1 if on_card else 0,
            object_store_memory=store)
    print(f"[train-tune] init(num_gpus={n}) in {time.perf_counter() - t0:.2f}"
          f" s; cluster_resources {rt.cluster_resources()} [{card}]",
          flush=True)
    out = {}
    try:
        cw = _tt_kv()
        for k in cw.kv_keys(TT_KV):
            cw.kv_del(k)
        tokens = np.random.default_rng(DATA_SEED).integers(
            0, cfg.vocab_size, (rows, seq + 1)).astype(np.int32)
        ds = data.from_numpy({"tokens": tokens}, parallelism=blocks)
        want_batches = [b["tokens"] for b in itertools.islice(
            ds.iter_batches(batch_size=batch, batch_format="numpy",
                            drop_last=True), steps)]

        # -- (a) fit() on one worker granted the card -------------------------
        trainer = ProbedTrainer(
            _tt_loop, train_loop_config=loop_cfg,
            jax_config=JaxConfig(distributed="jax"),
            scaling_config=ScalingConfig(num_workers=1, use_gpu=on_card),
            datasets={"train": ds})
        t_fit = time.time()
        res = trainer.fit()
        wall_a = time.time() - t_fit
        if res.error is not None:
            fail(f"[train-tune] (a) fit() failed: {res.error!r}")
        hist = res.metrics_history
        h0 = hist[0]
        trial = trial_probes(cw)
        print(f"[train-tune] (a) JaxTrainer.fit(): the worker (pid "
              f"{h0['pid']}, CUDA_VISIBLE_DEVICES={h0['visible']!r}, "
              f"{h0['device']}) in a process group of backend "
              f"{h0['backend']}, world {h0['world']}, mesh {h0['mesh']}; the "
              f"trial actor {trial} [{card}]", flush=True)
        if on_card and h0["backend"] != "nccl":
            fail(f"[train-tune] (a) the worker's process group is "
                 f"{h0['backend']}, expected nccl")
        if on_card and (not h0["visible"] or h0["device"] != card.split(
                ",")[0].strip()):
            fail(f"[train-tune] (a) the worker holds {h0['visible']!r} / "
                 f"{h0['device']}, expected the card {card}")
        if trial[0]["pid"] == h0["pid"]:
            fail("[train-tune] (a) the loop ran in the trial actor")
        rounds = [(m["_round"], m["training_iteration"], m["step"])
                  for m in hist]
        if rounds != [(i, i + 1, i + 1) for i in range(steps)]:
            fail(f"[train-tune] (a) metrics_history rounds {rounds}")
        if not launches_ok(hist, per_step):
            fail(f"[train-tune] (a) launches by step "
                 f"{[m['launches'] for m in hist]}, expected {per_step}")
        bad = [i for i, m in enumerate(hist)
               if m["batch_sum"] != int(want_batches[i].sum())]
        if bad:
            fail(f"[train-tune] (a) the worker's batches {bad} are not the "
                 f"dataset's")

        # the same steps in the driver, from the same start
        params = gpt2_init(cfg, torch.Generator(device=dev).manual_seed(
            TT_SEED), device=dev)
        fp = sum(float(t.double().sum()) for t in tree_leaves(params))
        tx = adamw(TT_LR, weight_decay=0.1)
        opt = tx.init(params)
        step = build_train_step(lambda p, b: gpt2_loss(p, b, cfg), tx,
                                telemetry=False)
        driver_losses, driver_ms = [], []
        for b in want_batches:
            tb = {"tokens": torch.from_numpy(b.copy()).to(dev)}
            if on_card:
                torch.cuda.synchronize()
            t1 = time.perf_counter()
            params, opt, loss = uncounted(fa, lambda: step(params, opt, tb))
            driver_losses.append(float(loss))
            driver_ms.append((time.perf_counter() - t1) * 1e3)
        worker_losses = [m["loss"] for m in hist]
        diffs = [abs(a - b) for a, b in zip(worker_losses, driver_losses)]
        ck = res.checkpoint.to_dict()
        digest = _tree_digest(torch, ck["params"])
        d_final = max(float((a.float() - b.float().to(a.device)).abs().max())
                      for a, b in zip(tree_leaves(params),
                                      tree_leaves(ck["params"])))
        med_w = sorted(m["step_ms"] for m in hist[1:])[len(hist[1:]) // 2]
        med_d = sorted(driver_ms[1:])[len(driver_ms[1:]) // 2]
        print(f"[train-tune] (a) {steps} rounds, _round 0-{steps - 1}, "
              f"training_iteration 1-{steps}; launches per step "
              f"{hist[0]['launches']} (all {steps} equal); start fingerprint "
              f"worker {h0['fingerprint']!r}, driver {fp!r}; losses "
              f"{[round(x, 5) for x in worker_losses]}, the driver's "
              f"{[round(x, 5) for x in driver_losses]}, max |diff| "
              f"{max(diffs):.3e} (tol {CE_LOSS_TOL}); the checkpoint's params "
              f"sha256 {digest[:16]} vs the worker's "
              f"{hist[-1]['params_digest'][:16]} (bit for bit "
              f"{digest == hist[-1]['params_digest']}), max |diff| from the "
              f"driver's final params {d_final:.3e}; median step ms in the "
              f"worker {med_w:.2f}, in the driver {med_d:.2f}; fit() to the "
              f"first report {h0['t'] - t_fit:.2f} s ({_tt_marks(h0, t_fit)}"
              f"), whole fit() {wall_a:.2f} s [{card}]", flush=True)
        if h0["fingerprint"] != fp:
            fail(f"[train-tune] (a) the worker started from other parameters "
                 f"({h0['fingerprint']!r} vs {fp!r})")
        if max(diffs) > CE_LOSS_TOL or not all(map(math.isfinite,
                                                   worker_losses)):
            fail(f"[train-tune] (a) the worker's losses {worker_losses} "
                 f"against the driver's {driver_losses}")
        if digest != hist[-1]["params_digest"] or ck["step"] != steps:
            fail("[train-tune] (a) the checkpoint's parameters are not the "
                 "worker's final ones")
        out.update(a={"losses": worker_losses, "driver_losses": driver_losses,
                      "step_ms": med_w, "driver_step_ms": med_d,
                      "first_report_s": h0["t"] - t_fit, "fit_s": wall_a},
                   per_step=hist[0]["launches"])
        del params, opt, ck, res, trainer
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()

        # -- (b) a failure after step TT_FAIL_AFTER, resumed on the card -
        trainer = ProbedTrainer(
            _tt_loop, train_loop_config={**loop_cfg,
                                         "fail_after": TT_FAIL_AFTER},
            jax_config=JaxConfig(distributed="jax"),
            scaling_config=ScalingConfig(num_workers=1, use_gpu=on_card),
            run_config=RunConfig(failure_config=FailureConfig(
                max_failures=1)),
            datasets={"train": ds})
        t_fit = time.time()
        res = trainer.fit()
        wall_b = time.time() - t_fit
        if res.error is not None:
            fail(f"[train-tune] (b) fit() failed: {res.error!r}")
        hist_b = res.metrics_history
        trial_b = trial_probes(cw)
        failed = json.loads(cw.kv_get(f"{TT_KV}failed"))
        k = TT_FAIL_AFTER
        pids = [m["pid"] for m in hist_b]
        new = hist_b[k] if len(hist_b) > k else {}
        diffs_b = [abs(a - b) for a, b in zip(
            [m["loss"] for m in hist_b], worker_losses)]
        print(f"[train-tune] (b) FailureConfig(max_failures=1), a failure "
              f"after step {k} (pid {failed['pid']}): {len(hist_b)} rounds, "
              f"steps {[m['step'] for m in hist_b]}, pids {pids}; the new "
              f"worker CUDA_VISIBLE_DEVICES={new.get('visible')!r}, "
              f"{new.get('device')}, backend {new.get('backend')}; losses vs "
              f"(a)'s max |diff| {max(diffs_b):.3e}; restart: failure to "
              f"the new loop's start {new.get('t_loop', 0) - failed['t']:.2f} "
              f"s, to its first report {new.get('t', 0) - failed['t']:.2f} "
              f"s ({_tt_marks(new, failed['t'])}); whole fit() {wall_b:.2f} "
              f"s; the trial actor {trial_b} [{card}]", flush=True)
        if [m["step"] for m in hist_b] != list(range(1, steps + 1)) or [
                m["_round"] for m in hist_b] != list(range(steps)):
            fail(f"[train-tune] (b) rounds {[m['step'] for m in hist_b]}")
        if len(set(pids[:k])) != 1 or len(set(pids[k:])) != 1 or \
                pids[0] == pids[k] or failed["pid"] != pids[0]:
            fail(f"[train-tune] (b) the gang did not restart in a new "
                 f"process: pids {pids}")
        if on_card and (not new["visible"] or new["backend"] != "nccl"):
            fail(f"[train-tune] (b) the new worker holds "
                 f"{new['visible']!r}, backend {new['backend']}")
        if max(diffs_b) > CE_LOSS_TOL or not launches_ok(hist_b, per_step):
            fail(f"[train-tune] (b) losses {[m['loss'] for m in hist_b]} "
                 f"against (a)'s {worker_losses}, or launches "
                 f"{[m['launches'] for m in hist_b]}")
        out["b"] = {"losses": [m["loss"] for m in hist_b], "fit_s": wall_b,
                    "restart_s": new["t"] - failed["t"]}
        del res, trainer
        gc.collect()

        # -- (c) a Tuner whose trials take the card in turn -----------------
        clock = {}

        class TrialClock(tune.Callback):
            def on_trial_start(self, trial):
                clock.setdefault(trial.trial_id, {})["start"] = time.time()

            def on_trial_complete(self, trial):
                clock.setdefault(trial.trial_id, {})["end"] = time.time()

        t_tuner = time.time()
        grid = tune.Tuner(
            _tt_trial,
            param_space={**loop_cfg, "batch": tune_batch, "rows": rows,
                         "lr": tune.grid_search(list(TT_LRS))},
            tune_config=tune.TuneConfig(
                scheduler=tune.ASHAScheduler(**TT_ASHA),
                max_concurrent_trials=1),
            run_config=RunConfig(storage_path=f"{tmp}/tune", name="asha",
                                 callbacks=[TrialClock()]),
            resources_per_trial={"CPU": 1, "GPU": n}).fit()
        if grid.errors:
            fail(f"[train-tune] (c) trials failed: {grid.errors}")
        order = sorted(grid.trials, key=lambda t: clock[t.trial_id]["start"])
        replay = tune.ASHAScheduler(**TT_ASHA)
        stops, replayed = {}, {}
        for t in order:
            stops[t.config["lr"]] = t.iteration if t.status == "STOPPED" \
                else None
            stub = types.SimpleNamespace(trial_id=t.trial_id, iteration=0)
            for m in t.metrics_history:
                stub.iteration += 1
                if replay.on_trial_result(stub, m) == "STOP":
                    replayed[t.config["lr"]] = stub.iteration
                    break
            else:
                replayed[t.config["lr"]] = None
        walls = [clock[t.trial_id]["end"] - clock[t.trial_id]["start"]
                 for t in order]
        gaps = [clock[b.trial_id]["start"] - clock[a.trial_id]["end"]
                for a, b in zip(order, order[1:])]
        best = min(order, key=lambda t: t.best_metric("loss", "min"))
        trial_launches = [m["launches"] for t in order
                          for m in t.metrics_history]
        launch_ok = all(c == per_step for c in trial_launches)
        trial_pids = [t.metrics_history[0]["pid"] for t in order]
        ends = [t_tuner] + [clock[t.trial_id]["end"] for t in order]
        for t, t0 in zip(order, ends):
            print(f"[train-tune] (c) lr {t.config['lr']}: from the previous "
                  f"trial's end, {_tt_marks(t.metrics_history[0], t0)} "
                  f"[{card}]", flush=True)
        print(f"[train-tune] (c) Tuner over lr {list(TT_LRS)}, ASHA "
              f"{TT_ASHA}, B={tune_batch}, one trial at a time: stopped at "
              f"iteration {stops} (a fresh ASHAScheduler on the replayed "
              f"reports: {replayed}); launches in every step of every trial "
              f"{per_step}: {launch_ok}; trial pids {trial_pids}, "
              f"CUDA_VISIBLE_DEVICES "
              f"{[t.metrics_history[0]['visible'] for t in order]}; best lr "
              f"{best.config['lr']} (loss "
              f"{best.best_metric('loss', 'min'):.5f}); trial walls "
              f"{[round(w, 2) for w in walls]} s, gaps between trials "
              f"{[round(g, 2) for g in gaps]} s [{card}]",
              flush=True)
        if stops != replayed:
            fail(f"[train-tune] (c) the stops {stops} differ from the "
                 f"replayed decisions {replayed}")
        if not launch_ok:
            fail(f"[train-tune] (c) launches by step {trial_launches}, "
                 f"expected {per_step} each")
        if on_card and not all(t.metrics_history[0]["visible"]
                               for t in order):
            fail("[train-tune] (c) a trial held no card")
        out["c"] = {"stops": stops, "best_lr": best.config["lr"],
                    "trial_s": walls, "gap_s": gaps}

        books = {**_tt_books(cw, "worker"), **_tt_books(cw, "trial")}
        total = {key: sum(b["counts"].get(key, 0) for b in books.values())
                 for key in per_step}
        print(f"[train-tune] launches booked by {len(books)} processes "
              f"(3 workers, {len(order)} trials): {total} [{card}]",
              flush=True)
        out["counts"] = total
    finally:
        rt.shutdown()
        if results_env is None:
            os.environ.pop("RAYTPU_RESULTS_DIR", None)
        else:
            os.environ["RAYTPU_RESULTS_DIR"] = results_env
        shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase vision (12j): ViT-B/16 and ResNet-50
# ---------------------------------------------------------------------------

#: ViT-B/16 at 224 px (T = 197 = 196 patches + CLS, 12 heads of 64,
#: 86.6M parameters): (a) one f32 loss and gradient at VIT_CHECK_B, the
#: flash kernels against use_flash=False; (b) bf16 AdamW steps (f32
#: master weights) at VIT_B, VIT_WARMUP then VIT_TIMED; (c) the flash
#: kernels alone at (b)'s attention, B*H = 1536, non-causal
VIT_PRESET, VIT_IMAGE, VIT_CHECK_B, VIT_B = "vit-b16", 224, 4, 128
VIT_WARMUP, VIT_TIMED = 2, 5
#: ResNet-50 at 224 px: (d) one loss and gradient at RESNET_CHECK_B on
#: the card held against the port on the CPU, then bf16 AdamW steps at
#: RESNET_B (19.6 GiB at its peak of the card's 80: no cut)
RESNET_PRESET, RESNET_CHECK_B, RESNET_B = "resnet50", 2, 128
#: (a) f32 flash kernels vs the plain attention through 12 layers: the
#: loss |diff| and, per gradient leaf, ||flash - plain|| / ||plain||.
#: Both sum the same f32 products in other orders (the kernel's O is
#: within 2e-5 of the plain version's at phase 3): 4.8e-7 on the loss
#: and 1.86e-6 on the worst leaf (cls) on an H100; a kernel that
#: dropped the ragged last key tile (5 of T = 197 keys) would move
#: every backbone gradient by percents
VIT_LOSS_TOL = 1e-5
VIT_GRAD_RTOL = 2e-5
#: (d) ResNet-50 on the card (cuDNN, TF32 off) vs the CPU, ||card -
#: cpu|| / ||cpu||.  In float32 the logits, the loss and each new
#: batch-norm statistic within RESNET_RTOL (the convolutions sum in
#: other orders, the batch norms renormalise every layer: 1.3e-5 on an
#: H100; a wrong padding or statistic moves them by percents).  The
#: gradient at init in training mode is too ill-conditioned for float32
#: (back through 53 batch norms over two images the CPU's own gradient
#: moves 1.4e-2 when the batch is merely reversed), so those and every
#: gradient leaf are held in float64, whose 2^29 times finer rounding
#: scales that to ~3e-11, within RESNET_F64_RTOL
RESNET_RTOL = 1e-3
RESNET_F64_RTOL = 1e-6


def vit_step_counts(cfg, on_card: bool = True) -> dict:
    """Flash launches of one ViT loss and gradient: the forward once a
    layer and again in the backward's recompute under remat, dQ and
    dK/dV once a layer; none with plain attention or off the card; no
    fused CE (ViT's head is a (d, classes) product)."""
    L = cfg.n_layer if (cfg.use_flash is not False and on_card) else 0
    return {"flash_fwd": (2 if cfg.remat else 1) * L, "flash_bwd_dq": L,
            "flash_bwd_dkv": L}


def _leaf_names(tree, prefix=""):
    """Paths of a tree's leaves in tree_leaves order."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree)
                for n in _leaf_names(tree[k], f"{prefix}{k}.")]
    if isinstance(tree, list):
        return [n for i, v in enumerate(tree)
                for n in _leaf_names(v, f"{prefix}{i}.")]
    return [prefix[:-1]]


def _rel_diffs(got, want, names) -> dict:
    """{name: (||got - want|| / ||want||, max |got - want|)} over
    matching tensor lists (``want`` on any device), in float64."""
    out = {}
    for n, g, w in zip(names, got, want):
        g, w = g.detach().double().cpu(), w.detach().double().cpu()
        d = g - w
        out[n] = ((d.norm() / w.norm().clamp_min(1e-30)).item(),
                  d.abs().max().item())
    return out


def _worst(rel: dict) -> tuple:
    name = max(rel, key=lambda n: rel[n][0])
    return name, rel[name][0], max(v[1] for v in rel.values())


def check_vit_flash(torch, fa, dev, on_card: bool, preset: str, image: int,
                    b: int, card: str) -> dict:
    """(a) One f32 ViT loss and gradient of every leaf through the flash
    kernels (remat on, then off) against use_flash=False, on seeded
    weights with a seeded non-zero head (vit_init's zero head leaves
    every backbone gradient at exactly 0); the launches of each."""
    from ray_tpu_torch.models.vit import vit_config, vit_init, vit_loss
    from ray_tpu_torch.train.optim import tree_leaves, tree_unflatten

    cfg = vit_config(preset, dtype=torch.float32, image_size=image)
    gen = torch.Generator(device=dev).manual_seed(21)
    params = vit_init(gen, cfg, device=dev)
    for k in ("head_w", "head_b"):
        params[k] = 0.02 * torch.randn(params[k].shape, generator=gen,
                                       device=dev)
    batch = {"images": torch.randn((b, image, image, 3), generator=gen,
                                   device=dev),
             "labels": torch.randint(0, cfg.n_classes, (b,), generator=gen,
                                     device=dev)}
    names = _leaf_names(params)
    runs = {}
    for name, kw in (("plain", dict(use_flash=False)),
                     ("flash", dict(use_flash=True)),
                     ("flash_no_remat", dict(use_flash=True, remat=False))):
        c = dataclasses.replace(cfg, **kw)
        zero_counts(fa)
        leaves = [x.detach().requires_grad_(True)
                  for x in tree_leaves(params)]
        loss = vit_loss(tree_unflatten(params, leaves), batch, c)
        grads = torch.autograd.grad(loss, leaves)
        if on_card:
            torch.cuda.synchronize()
        runs[name] = {"loss": loss.item(), "grads": grads,
                      "counts": read_counts(fa),
                      "want": vit_step_counts(c, on_card)}
    base = runs.pop("plain")
    out, bad = {"tol": {"loss": VIT_LOSS_TOL, "grad_rel": VIT_GRAD_RTOL}}, []
    for name, r in runs.items():
        rel = _rel_diffs(r["grads"], base["grads"], names)
        worst, worst_rel, max_abs = _worst(rel)
        dl = abs(r["loss"] - base["loss"])
        nonfinite = sum(int((~g.isfinite()).sum()) for g in r["grads"])
        zero = [n for n, g in zip(names, base["grads"])
                if not bool(g.abs().sum() > 0)]
        out[name] = {"loss": r["loss"], "loss_diff": dl,
                     "worst_leaf": worst, "worst_rel": worst_rel,
                     "max_abs_diff": max_abs, "counts": r["counts"]}
        print(f"[vision] (a) {preset} f32 B={b} at {image} px (T = "
              f"{cfg.n_patches + 1}), {name} vs plain attention: loss "
              f"{r['loss']:.6f} vs {base['loss']:.6f} (|diff| {dl:.3e}, tol "
              f"{VIT_LOSS_TOL:.0e}); {len(names)} gradient leaves, largest "
              f"||flash - plain|| / ||plain|| {worst_rel:.3e} ({worst}; tol "
              f"{VIT_GRAD_RTOL:.0e}), largest |diff| {max_abs:.3e}; "
              f"launches {r['counts']} (expected {r['want']}) [{card}]",
              flush=True)
        if dl > VIT_LOSS_TOL or worst_rel > VIT_GRAD_RTOL or nonfinite:
            bad.append(f"{name}: loss diff {dl}, worst leaf {worst} "
                       f"{worst_rel}, {nonfinite} nonfinite")
        if r["counts"] != r["want"]:
            bad.append(f"{name}: launches {r['counts']}, expected "
                       f"{r['want']}")
        if zero:
            bad.append(f"gradient leaves of exactly 0: {zero}")
    if bad:
        fail("[vision] (a) " + "; ".join(bad))
    return out


def time_vit_steps(torch, fa, dev, on_card: bool, preset: str, image: int,
                   b: int, card: str) -> dict:
    """(b) ViT AdamW steps (``adamw(3e-4, weight_decay=0.1)``) in bf16
    with f32 master weights through build_train_step: VIT_WARMUP then
    VIT_TIMED steps on one seeded batch (host clock around synchronised
    steps), the launch counters zeroed just before and read just after,
    the loss finite and falling, images/s, MFU, the peak memory and a
    profile of one more step."""
    from ray_tpu_torch.bench import H100_BF16_PEAK_FLOPS
    from ray_tpu_torch.models.vit import (vit_config, vit_init, vit_loss,
                                          vit_param_count)
    from ray_tpu_torch.train import adamw, build_train_step

    cfg = vit_config(preset, image_size=image)
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev).manual_seed(22)
    params = vit_init(gen, cfg, device=dev)
    tx = adamw(3e-4, weight_decay=0.1)
    opt_state = tx.init(params)
    step = build_train_step(lambda p, bt: vit_loss(p, bt, cfg), tx,
                            telemetry=False)
    batch = {"images": torch.randn((b, image, image, 3), generator=gen,
                                   device=dev),
             "labels": torch.randint(0, cfg.n_classes, (b,), generator=gen,
                                     device=dev)}

    def sync():
        if on_card:
            torch.cuda.synchronize()

    zero_counts(fa)
    losses = []
    for _ in range(VIT_WARMUP):
        params, opt_state, loss = step(params, opt_state, batch)
        losses.append(loss)
    sync()
    t0 = time.perf_counter()
    for _ in range(VIT_TIMED):
        params, opt_state, loss = step(params, opt_state, batch)
        losses.append(loss)
    sync()
    dt = time.perf_counter() - t0
    counts = read_counts(fa)
    runs = VIT_WARMUP + VIT_TIMED
    per_step = vit_step_counts(cfg, on_card)
    want = {k: n * runs for k, n in per_step.items()}
    losses = [float(x) for x in losses]
    peak_gib = (torch.cuda.max_memory_allocated() / 2 ** 30 if on_card
                else None)
    n_params = vit_param_count(cfg)
    T = cfg.n_patches + 1
    img_s = b * VIT_TIMED / dt
    step_ms = dt / VIT_TIMED * 1e3
    mfu = 6 * n_params * img_s * T / H100_BF16_PEAK_FLOPS if on_card \
        else None
    print(f"[vision] (b) {preset} bf16 (f32 master weights) B={b} at "
          f"{image} px (T = {T}), remat: {runs} steps launched {counts} "
          f"(expected {per_step} a step); losses "
          f"{[round(x, 4) for x in losses]}", flush=True)
    if counts != want:
        fail(f"[vision] (b) kernel launches {counts} over {runs} steps, "
             f"expected {want}")
    if not all(math.isfinite(x) for x in losses) or \
            not losses[-1] < losses[0]:
        fail(f"[vision] (b) the loss is not finite and falling: {losses}")
    mfu_text = (f"MFU {mfu:.4f} (6 N images/s T against 989 TFLOP/s, N = "
                f"{n_params}, ignoring attention's own products)"
                if mfu is not None else "MFU not measured off the card")
    print(f"[vision] (b) {VIT_TIMED} timed steps: {step_ms:.2f} ms/step, "
          f"{img_s:.1f} images/s, {mfu_text}; peak memory "
          f"{peak_gib if peak_gib is None else round(peak_gib, 2)} GiB "
          f"(max_memory_allocated) [{card}]", flush=True)
    out = {"steps_run": runs, "counts": counts, "per_step": per_step,
           "step_ms": step_ms, "images_per_s": img_s, "mfu": mfu,
           "peak_gib": peak_gib, "losses": losses, "n_params": n_params,
           "batch": b, "T": T}
    if on_card:
        out["profile"] = profile_call(
            torch, lambda: step(params, opt_state, batch), "ViT-B/16",
            step_ms, card, "vision")
    return out


def _resnet_run(torch, params, state, batch, cfg, grads: bool) -> dict:
    """One ResNet training-mode loss: {"logits", "loss", "state"} and,
    with ``grads``, "grads", the gradient of every parameter leaf."""
    from ray_tpu_torch.models.resnet import resnet_forward, resnet_loss
    from ray_tpu_torch.train.optim import tree_leaves, tree_unflatten

    with torch.no_grad():
        logits, _ = resnet_forward(params, state, batch["x"], cfg,
                                   training=True)
    leaves = [x.detach().requires_grad_(grads) for x in tree_leaves(params)]
    with torch.set_grad_enabled(grads):
        loss, new_state = resnet_loss(tree_unflatten(params, leaves), state,
                                      batch, cfg)
    out = {"logits": logits, "loss": loss.detach(), "state": new_state}
    if grads:
        out["grads"] = torch.autograd.grad(loss, leaves)
    return out


def check_resnet_card(torch, dev, preset: str, image: int, b: int,
                      card: str) -> dict:
    """(d1) One ResNet training-mode loss on ``dev`` against the port on
    the CPU from the same seeded weights, state and batch: in float32
    the logits, the loss and every new batch-norm statistic within
    RESNET_RTOL; in float64 those and every gradient leaf within
    RESNET_F64_RTOL (relative norms)."""
    from ray_tpu_torch.models.resnet import resnet_config, resnet_init
    from ray_tpu_torch.train.optim import tree_leaves, tree_map

    cfg = resnet_config(preset, dtype=torch.float32)
    gen = torch.Generator().manual_seed(31)
    params, state = resnet_init(gen, cfg, device="cpu")
    batch = {"x": torch.randn((b, image, image, 3), generator=gen),
             "y": torch.randint(0, cfg.n_classes, (b,), generator=gen)}
    out, bad = {}, []
    for dt, tol in ((torch.float32, RESNET_RTOL),
                    (torch.float64, RESNET_F64_RTOL)):
        c = dataclasses.replace(cfg, dtype=dt, param_dtype=dt)
        grads = dt == torch.float64
        def cast(t, dt=dt):
            return t.to(dt) if t.is_floating_point() else t

        p, st, bt = (tree_map(cast, x) for x in (params, state, batch))
        t0 = time.perf_counter()
        cpu = _resnet_run(torch, p, st, bt, c, grads)
        cpu_s = time.perf_counter() - t0
        to = lambda t: t.to(dev)  # noqa: E731
        t0 = time.perf_counter()
        got = _resnet_run(torch, tree_map(to, p), tree_map(to, st),
                          tree_map(to, bt), c, grads)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        dev_s = time.perf_counter() - t0
        parts = {"logits": ([got["logits"]], [cpu["logits"]], ["logits"]),
                 "loss": ([got["loss"]], [cpu["loss"]], ["loss"]),
                 "state": (tree_leaves(got["state"]),
                           tree_leaves(cpu["state"]),
                           _leaf_names(cpu["state"]))}
        if grads:
            parts["grads"] = (list(got["grads"]), list(cpu["grads"]),
                              _leaf_names(params))
        rec = {}
        for part, (g, w, names) in parts.items():
            rel = _rel_diffs(g, w, names)
            worst, worst_rel, max_abs = _worst(rel)
            rec[part] = {"n": len(names), "worst": worst,
                         "worst_rel": worst_rel, "max_abs_diff": max_abs}
            if worst_rel > tol or not all(bool(t.isfinite().all())
                                          for t in g):
                bad.append(f"{dt} {part}: {worst} {worst_rel:.3e} (tol "
                           f"{tol:.0e})")
        name = str(dt).split(".")[-1]
        out[name] = dict(rec, tol=tol, cpu_s=cpu_s, dev_s=dev_s)
        print(f"[vision] (d) {preset} {name} B={b} at {image} px, training "
              f"mode{', with every gradient' if grads else ''}, {dev.type} "
              f"({dev_s:.1f} s) against the CPU ({cpu_s:.1f} s): loss "
              f"{float(cpu['loss']):.6f}; largest ||{dev.type} - cpu|| / "
              f"||cpu|| (tol {tol:.0e}): " +
              "; ".join(f"{q} {o['worst_rel']:.3e} over {o['n']} "
                        f"({o['worst']}, max |diff| "
                        f"{o['max_abs_diff']:.3e})" for q, o in rec.items())
              + f" [{card}]", flush=True)
    if bad:
        fail("[vision] (d) the card's ResNet disagrees with the CPU's: " +
             "; ".join(bad))
    return out


def time_resnet_steps(torch, dev, on_card: bool, preset: str, image: int,
                      b: int, card: str) -> dict:
    """(d2) ResNet AdamW steps (``adamw(3e-4, weight_decay=0.1)``) in
    bf16 with f32 master weights and the batch-norm state carried, a
    step written here (the JAX package trains it through its trainer's
    jit): autograd over the parameter leaves, the port's AdamW in
    place.  VIT_WARMUP then VIT_TIMED steps on one seeded batch, the
    loss finite and falling, images/s, the peak memory and a profile of
    one more step."""
    from ray_tpu_torch.models.resnet import (resnet_config, resnet_init,
                                             resnet_loss)
    from ray_tpu_torch.train import adamw
    from ray_tpu_torch.train.optim import tree_leaves, tree_unflatten

    cfg = resnet_config(preset)
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev).manual_seed(32)
    params, bn_state = resnet_init(gen, cfg, device=dev)
    tx = adamw(3e-4, weight_decay=0.1)
    opt_state = tx.init(params)
    batch = {"x": torch.randn((b, image, image, 3), generator=gen,
                              device=dev),
             "y": torch.randint(0, cfg.n_classes, (b,), generator=gen,
                                device=dev)}
    carried = [bn_state]

    def step():
        leaves = [x.detach().requires_grad_(True)
                  for x in tree_leaves(params)]
        loss, carried[0] = resnet_loss(tree_unflatten(params, leaves),
                                       carried[0], batch, cfg)
        grads = torch.autograd.grad(loss, leaves)
        tx.update_(params, list(grads), opt_state)
        return loss.detach()

    def sync():
        if on_card:
            torch.cuda.synchronize()

    losses = [step() for _ in range(VIT_WARMUP)]
    sync()
    t0 = time.perf_counter()
    losses += [step() for _ in range(VIT_TIMED)]
    sync()
    dt = time.perf_counter() - t0
    losses = [float(x) for x in losses]
    step_ms = dt / VIT_TIMED * 1e3
    img_s = b * VIT_TIMED / dt
    peak_gib = (torch.cuda.max_memory_allocated() / 2 ** 30 if on_card
                else None)
    moved = float((carried[0]["stem"]["mean"] - bn_state["stem"]["mean"])
                  .abs().max())
    print(f"[vision] (d) {preset} bf16 (f32 master weights, batch norm in "
          f"f32) B={b} at {image} px: {VIT_WARMUP} + {VIT_TIMED} steps, "
          f"losses {[round(x, 4) for x in losses]}; {step_ms:.2f} ms/step, "
          f"{img_s:.1f} images/s; peak memory "
          f"{peak_gib if peak_gib is None else round(peak_gib, 2)} GiB; the "
          f"stem's running mean moved {moved:.3e} [{card}]", flush=True)
    if not all(math.isfinite(x) for x in losses) or \
            not losses[-1] < losses[0] or not moved > 0:
        fail(f"[vision] (d) the loss is not finite and falling ({losses}) "
             f"or the batch-norm state stood still")
    out = {"batch": b, "step_ms": step_ms, "images_per_s": img_s,
           "peak_gib": peak_gib, "losses": losses}
    if on_card:
        out["profile"] = profile_call(torch, step, "ResNet-50", step_ms,
                                      card, "vision")
    return out


def _run_tool(*args) -> subprocess.CompletedProcess:
    """``python -m <args>`` from the repo's root, its output captured."""
    root = Path(__file__).resolve().parent
    return subprocess.run([sys.executable, "-m", *args], cwd=root,
                          capture_output=True, text=True, timeout=120)


def check_tools(tools: dict, card: str, device_kind) -> dict:
    """(e) The operator CLIs on this run's own files: perfledger check
    and report on phase bench-cli's ledger (its entries stamped with
    this card), kvscope report, timeline and export on phase
    serve-telemetry's engine_stats() snapshot, and incidents report on
    phase serve-fleet's chaos dump, which must name the frozen replica
    with fleet_stats' detection latency and count its transitions as
    fleet_stats' log does (each journaled twice, to the fleet's lane
    and the replica's)."""
    import os

    t0 = time.perf_counter()
    bad, out = [], {}
    ledger = tools["ledger"]
    with open(ledger) as f:
        entries = [json.loads(ln) for ln in f if ln.strip()]
    # (the train run's --autopilot line is a record without a metric)
    metrics = [e["record"]["metric"] for e in entries
               if "metric" in e["record"]]
    kinds = {e["provenance"].get("device_kind") for e in entries}
    chk = _run_tool("ray_tpu_torch.tools.perfledger", "--history", ledger,
                    "check")
    rep = _run_tool("ray_tpu_torch.tools.perfledger", "--history", ledger,
                    "report")
    verdicts = (json.loads(chk.stdout)["verdicts"] if chk.returncode in (0, 1)
                else {})
    out["perfledger"] = {"entries": len(entries), "check_rc": chk.returncode,
                         "report_rc": rep.returncode,
                         "verdicts": {k: v["verdict"]
                                      for k, v in verdicts.items()}}
    print(f"[vision] (e) perfledger on phase bench-cli's ledger: "
          f"{len(entries)} entries {metrics}, device kinds {kinds}; check "
          f"exit {chk.returncode}, verdicts "
          f"{out['perfledger']['verdicts']}; report exit {rep.returncode}, "
          f"{len(rep.stdout.splitlines())} lines", flush=True)
    if chk.returncode != 0 or rep.returncode != 0 or \
            sorted(verdicts) != sorted(metrics) or \
            not all(m in rep.stdout for m in metrics) or \
            kinds != {device_kind}:
        bad.append(f"perfledger: check {chk.returncode} {chk.stderr[-500:]}"
                   f", report {rep.returncode}, kinds {kinds}")

    snap = tools["snapshot"]
    with open(snap) as f:
        scope = json.load(f)["kv_scope"]
    ring = scope["occupancy"]["ring"]
    r_rep = _run_tool("ray_tpu_torch.tools.kvscope", "report", snap)
    r_tl = _run_tool("ray_tpu_torch.tools.kvscope", "timeline", snap)
    trace = os.path.join(os.path.dirname(snap), "kv_trace.json")
    r_ex = _run_tool("ray_tpu_torch.tools.kvscope", "export", snap, "-o",
                     trace)
    counters, pool = [], set()
    if r_ex.returncode == 0:
        with open(trace) as f:
            counters = [e for e in json.load(f) if e.get("ph") == "C"]
        pool = {sum(e["args"].values()) for e in counters
                if e["name"] == "kv blocks"}
    rows = [ln for ln in r_tl.stdout.splitlines() if "use=" in ln]
    out["kvscope"] = {"rcs": [r_rep.returncode, r_tl.returncode,
                              r_ex.returncode], "ring": len(ring),
                      "timeline_rows": len(rows),
                      "counter_events": len(counters)}
    print(f"[vision] (e) kvscope on phase serve-telemetry's engine_stats(): "
          f"report/timeline/export exit {out['kvscope']['rcs']}; "
          f"{r_rep.stdout.splitlines()[:2]}; {len(rows)} timeline rows for "
          f"{len(ring)} ring samples; {len(counters)} counter events, pool "
          f"sizes {pool}", flush=True)
    if out["kvscope"]["rcs"] != [0, 0, 0] or len(rows) != len(ring) or \
            not ring or len(pool) != 1 or \
            "kvscope enabled" not in r_rep.stdout:
        bad.append(f"kvscope: {out['kvscope']} {r_rep.stderr[-500:]}")

    inc = _run_tool("ray_tpu_torch.tools.incidents", "report", tools["dump"])
    frozen, ttd = tools["frozen"], tools["time_to_detect_ms"]
    lines = inc.stdout.splitlines()
    named = f"replica {frozen}:" in lines
    said = [float(m) for m in re.findall(r"time_to_detect_ms=([0-9.]+)",
                                         inc.stdout)]
    # the first count after the frozen replica's heading is its own
    own = re.search(r"transitions=(\d+)",
                    inc.stdout.split(f"replica {frozen}:", 1)[-1])
    counted = int(own.group(1)) if named and own else None
    out["incidents"] = {"rc": inc.returncode, "names_frozen": named,
                        "time_to_detect_ms": said,
                        "fleet_time_to_detect_ms": ttd,
                        "transitions": counted,
                        "fleet_transitions": tools["transitions"]}
    print(f"[vision] (e) incidents report on phase serve-fleet's chaos dump: "
          f"exit {inc.returncode}; names {frozen}: {named}; "
          f"time_to_detect_ms {said} against fleet_stats' {ttd}; "
          f"transitions {counted} against fleet_stats' "
          f"{tools['transitions']}; {len(lines)} lines", flush=True)
    if inc.returncode != 0 or not named or said != [ttd] or \
            counted != tools["transitions"]:
        bad.append(f"incidents: {out['incidents']} {inc.stderr[-500:]}")
    out["wall_s"] = time.perf_counter() - t0
    print(f"[vision] (e) the three tools in {out['wall_s']:.2f} s [{card}]",
          flush=True)
    if bad:
        fail("[vision] (e) " + "; ".join(bad))
    return out


def phase_vision(torch, fa, card: str, tools, device: str = "cuda",
                 vit_preset: str = VIT_PRESET, image: int = VIT_IMAGE,
                 vit_check_b: int = VIT_CHECK_B, vit_b: int = VIT_B,
                 resnet_preset: str = RESNET_PRESET,
                 resnet_check_b: int = RESNET_CHECK_B,
                 resnet_b: int = RESNET_B) -> dict:
    """12j: ViT-B/16 and ResNet-50 at full width: (a) ViT f32 flash vs
    plain, (b) ViT bf16 training (the main path: its launches are the
    kernels line's), (c) the non-causal flash kernels at ViT's
    attention, (d) ResNet-50 card vs CPU and bf16 training, (e) the
    perf ledger, kvscope and incidents CLIs on this run's files.
    ``device``, the presets and the sizes let it run cut down
    elsewhere (no timing of kernels, no profile, no tools off the
    card when ``tools`` is None)."""
    from ray_tpu_torch.models.vit import vit_config

    dev = torch.device(device)
    on_card = dev.type == "cuda"
    t0 = time.perf_counter()
    out = {"a": check_vit_flash(torch, fa, dev, on_card, vit_preset, image,
                                vit_check_b, card)}
    out["b"] = time_vit_steps(torch, fa, dev, on_card, vit_preset, image,
                              vit_b, card)
    out["counts"], out["per_step"] = out["b"]["counts"], out["b"]["per_step"]
    if on_card:
        cfg = vit_config(vit_preset, image_size=image)
        out["kernels"] = time_flash_shape(
            torch, fa, card, vit_b, cfg.n_head, cfg.n_patches + 1,
            cfg.head_dim, causal=False, seed=23, shape_tag="ViT-B/16 shape",
            tag="vision")
        torch.cuda.empty_cache()
    out["d_check"] = check_resnet_card(torch, dev, resnet_preset, image,
                                       resnet_check_b, card)
    out["d_train"] = time_resnet_steps(torch, dev, on_card, resnet_preset,
                                       image, resnet_b, card)
    if tools is not None:
        out["e"] = check_tools(tools, card, torch.cuda.get_device_name(dev)
                               if on_card else None)
    out["phase_s"] = time.perf_counter() - t0
    return out


def _free_tcp_ports(n: int) -> int:
    """The first of ``n`` consecutive free ports."""
    import socket

    while True:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            base = s.getsockname()[1]
        try:
            for i in range(1, n):
                with socket.socket() as s:
                    s.bind(("127.0.0.1", base + i))
            return base
        except OSError:
            continue



#: phase observatory (12k): the GPT-2-124M pallas step the cost model
#: counts (bench.py's train step: B=24, T=1024, remat mlp_only) and its
#: timed steps; the program held on the card and on the CPU (b): GPT-2's
#: widths at 2 layers, B=1, T=512
OBS_STEPS, OBS_EVENT_STEPS = 3, 3
OBS_CPU_LAYERS, OBS_CPU_B, OBS_CPU_T = 2, 1, 512
#: a share of the peak above this means the FLOP count is wrong: no step
#: beats the card's dense bf16 rate
OBS_MAX_SHARE = 1.05
#: the serving programs (c) that must carry a cost once they ran
OBS_SERVE = ("serve.prefill", "serve.paged_prefill", "serve.decode",
             "serve.spec_verify", "serve.kv_handoff_export",
             "serve.kv_handoff_install")


def _obs_step(torch, cfg, batch, seq, dev, seed=0):
    """(step, params, opt_state, data) of bench.py's train step (AdamW
    3e-4, weight decay 0.1, telemetry off) on seeded tokens."""
    from ray_tpu_torch.models.gpt2 import gpt2_init, gpt2_loss
    from ray_tpu_torch.train import adamw, build_train_step

    gen = torch.Generator(device=dev).manual_seed(seed)
    params = gpt2_init(cfg, gen, device=dev)
    tx = adamw(3e-4, weight_decay=0.1)
    step = build_train_step(lambda p, b: gpt2_loss(p, b, cfg), tx,
                            telemetry=False)
    data = {"tokens": torch.randint(0, cfg.vocab_size, (batch, seq + 1),
                                    generator=gen, device=dev)}
    return step, params, tx.init(params), data


def phase_observatory(torch, fa, fc, card: str, inputs, device="cuda",
                      preset="gpt2", batch=TRAIN_B, seq=TRAIN_T,
                      cpu_layers=OBS_CPU_LAYERS, cpu_batch=OBS_CPU_B,
                      cpu_seq=OBS_CPU_T) -> dict:
    """12k: the cost model, the autopilot and graftcheck.  (a) bench.py's
    GPT-2-124M pallas step through ``time_config``: the registry's
    ``bench.train_step`` block's FLOPs equal the written-out formula
    (``gpt2_step_flops``) exactly; the same step built again and timed
    by CUDA events, its FLOPs at most OBS_MAX_SHARE of the peak's rate
    (a harvest that lost the backward or a kernel would read far lower,
    one that double counts higher), a harvest of a warm step beside a
    plain one; (b) the same 2-layer program harvested on the card and
    on the CPU books equal FLOPs; (c) the serving programs of phases 10
    and 11 carry costs; (d) the bench's ``--autopilot`` line of phase
    12e names bench.train_step; (e) the autopilot CLI on phase 12's
    engine_stats() dump and phase 12e's ledger; (f) ``python -m
    ray_tpu_torch.tools.graftcheck --format json`` (started first, in
    the background, on the CPU); (g) ``/api/perf/autopilot`` of phase
    12d.  ``inputs``: {"programs": {phase: engine_stats()["programs"]},
    "autopilot_line", "snapshot", "ledger", "dashboard_autopilot"};
    None for one skips its part (a CPU dry run)."""
    import os
    import tempfile

    from ray_tpu_torch._private import device_stats as ds
    from ray_tpu_torch.bench import time_config
    from ray_tpu_torch.models.gpt2 import gpt2_config, gpt2_param_count

    t_phase = time.perf_counter()
    root = Path(__file__).resolve().parent
    on_card = device == "cuda"
    peak = ds.H100_SXM["bf16_flops"]
    # (f) first: it runs on the CPU while the card works
    gc_proc = subprocess.Popen(
        [sys.executable, "-m", "ray_tpu_torch.tools.graftcheck", "--format",
         "json"], cwd=root, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    out, bad = {}, []

    def sync():
        if on_card:
            torch.cuda.synchronize()

    # (a) -------------------------------------------------------------
    kw = dict(ce_impl="pallas", remat_policy="mlp_only")
    if not on_card:
        kw["use_flash"] = True
    cfg = gpt2_config(preset, max_seq=seq, **kw)
    formula = gpt2_step_flops(cfg.n_layer, batch, seq, cfg.d_model,
                              cfg.d_ff, cfg.n_head, cfg.vocab_size)
    tokens = batch * seq
    six_n = 6 * gpt2_param_count(cfg) * tokens
    # the process registry, reset so that its bench.train_step block
    # holds this step's cost and invokes alone (the training phases'
    # time_config runs booked other configurations; (c) reads the serve
    # phases' blocks as they printed them)
    ds.reset_registry()
    reg = ds.get_registry()
    _, mfu_6n, _, _, tc_cost = time_config(batch, seq=seq, n_steps=OBS_STEPS,
                                           preset=preset, device=device, **kw)
    blk = reg.snapshot(n_devices=1)["bench.train_step"]
    if on_card:
        torch.cuda.empty_cache()
    step, params, opt, data = _obs_step(torch, cfg, batch, seq, device)
    params, opt, _ = step(params, opt, data)                  # warm-up
    sync()
    walls = {}
    for kind in ("plain", "harvest", "harvest", "plain"):
        t0 = time.perf_counter()
        if kind == "plain":
            params, opt, _ = step(params, opt, data)
        else:
            (params, opt, _), warm = ds.harvest_cost(step, params, opt, data)
        sync()
        walls.setdefault(kind, []).append(time.perf_counter() - t0)
    ms = []
    for _ in range(OBS_EVENT_STEPS if on_card else 0):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        params, opt, _ = step(params, opt, data)
        ev[1].record()
        torch.cuda.synchronize()
        ms.append(ev[0].elapsed_time(ev[1]))
    step_ms = sorted(ms)[len(ms) // 2] if ms else tc_cost["step_ms"]
    share = formula / (step_ms / 1e3 * peak)
    bw_share = (blk["bytes_accessed"] or 0) / (
        step_ms / 1e3 * ds.H100_SXM["hbm_bytes_per_s"])
    max_alloc = torch.cuda.max_memory_allocated() if on_card else None
    del step, params, opt, data
    if on_card:
        torch.cuda.empty_cache()
    harvest_ms = [w * 1e3 for w in walls["harvest"]]
    plain_ms = [w * 1e3 for w in walls["plain"]]
    out["a"] = {"xla_flops": blk["xla_flops"], "formula": formula,
                "ratio_to_6n": formula / six_n, "step_ms": step_ms,
                "event_ms": ms, "share_of_peak": share,
                "registry_mfu": blk["mfu"], "mfu_6n": mfu_6n,
                "mfu_xla": tc_cost.get("mfu_xla"),
                "bytes_accessed": blk["bytes_accessed"],
                "bytes_share": bw_share,
                "peak_hbm_bytes": blk["peak_hbm_bytes"],
                "max_memory_allocated": max_alloc,
                "warm_harvest_flops": (warm or {}).get("xla_flops"),
                "harvest_ms": harvest_ms, "plain_ms": plain_ms,
                "first_call_s": blk["compile_seconds"]}
    print(f"[observatory] (a) {preset} pallas step B={batch} T={seq} remat "
          f"mlp_only through time_config: bench.train_step xla_flops "
          f"{blk['xla_flops']}, the formula {formula} (equal: "
          f"{blk['xla_flops'] == formula}; a warm step's harvest "
          f"{(warm or {}).get('xla_flops')}), {formula / six_n:.4f} x "
          f"6*N*tokens; step {step_ms:.3f} ms by CUDA events {ms}: "
          f"{share:.4f} of {peak / 1e12:g} TFLOP/s (registry mfu "
          f"{blk['mfu']}, mfu_xla {tc_cost.get('mfu_xla')}, 6N mfu "
          f"{mfu_6n}); bytes_accessed {blk['bytes_accessed']} = "
          f"{bw_share:.4f} of 3.35 TB/s; peak_hbm_bytes "
          f"{blk['peak_hbm_bytes']} beside the process's "
          f"max_memory_allocated {max_alloc}; walls in turns (plain, "
          f"harvest, harvest, plain) plain {plain_ms} ms, harvest "
          f"{harvest_ms} ms; the first (harvested) call "
          f"{blk['compile_seconds']} s [{card}]", flush=True)
    if blk["xla_flops"] != formula or \
            (warm or {}).get("xla_flops") != formula:
        bad.append(f"(a) xla_flops {blk['xla_flops']} (warm "
                   f"{(warm or {}).get('xla_flops')}) != formula {formula}")
    if on_card and not 0 < share <= OBS_MAX_SHARE:
        bad.append(f"(a) {share:.4f} of the peak by CUDA events: the "
                   f"count is wrong")
    if blk["peak_hbm_bytes"] is None or blk["bytes_accessed"] is None:
        bad.append("(a) the bench.train_step block lacks a cost")

    # (b) -------------------------------------------------------------
    small = gpt2_config(preset, n_layer=cpu_layers, max_seq=cpu_seq,
                        **dict(kw, use_flash=True))
    got = {}
    for dev in dict.fromkeys((device, "cpu")):
        step, params, opt, data = _obs_step(torch, small, cpu_batch,
                                            cpu_seq, dev)
        t0 = time.perf_counter()
        _, cost = ds.harvest_cost(step, params, opt, data)
        got[dev] = dict(cost or {}, wall_s=time.perf_counter() - t0)
        del step, params, opt, data
    want = gpt2_step_flops(cpu_layers, cpu_batch, cpu_seq, small.d_model,
                           small.d_ff, small.n_head, small.vocab_size)
    out["b"] = got
    print(f"[observatory] (b) {preset} widths, {cpu_layers} layers, "
          f"B={cpu_batch} T={cpu_seq}: xla_flops on {device} "
          f"{got[device].get('xla_flops')}, on the cpu "
          f"{got['cpu'].get('xla_flops')} (the formula {want}); "
          f"bytes_accessed {got[device].get('bytes_accessed')} / "
          f"{got['cpu'].get('bytes_accessed')}; harvest walls "
          f"{got[device]['wall_s']:.2f} s / {got['cpu']['wall_s']:.2f} s "
          f"[{card}]", flush=True)
    if not got[device].get("xla_flops") or \
            got[device].get("xla_flops") != got["cpu"].get("xla_flops") \
            or got["cpu"]["xla_flops"] != want:
        bad.append(f"(b) card {got[device].get('xla_flops')} != cpu "
                   f"{got['cpu'].get('xla_flops')} (formula {want})")

    # (c) -------------------------------------------------------------
    for phase, progs in (inputs.get("programs") or {}).items():
        ran = {n: b for n, b in progs.items() if b["compile_events"]}
        for name, b in sorted(ran.items()):
            print(f"[observatory] (c) {phase}: {name}: compile events "
                  f"{b['compile_events']}, invokes {b['invokes']}; the "
                  f"harvested first fresh call of its wrapper: xla_flops "
                  f"{b['xla_flops']}, bytes {b['bytes_accessed']}, AI "
                  f"{b['arithmetic_intensity']}, peak_hbm_bytes "
                  f"{b['peak_hbm_bytes']}, mfu {b['mfu']} [{card}]",
                  flush=True)
            if any(b[k] is None for k in ("xla_flops", "bytes_accessed",
                                          "peak_hbm_bytes")):
                bad.append(f"(c) {phase} {name} carries no cost")
            # every program but the handoff's gather and splice runs
            # products
            elif not b["xla_flops"] and "handoff" not in name:
                bad.append(f"(c) {phase} {name}: xla_flops 0")
        missing = [n for n in OBS_SERVE if n not in ran]
        out.setdefault("c", {})[phase] = sorted(ran)
        if phase == "serve-spec-disagg" and missing:
            bad.append(f"(c) no block for {missing}")

    # (d) -------------------------------------------------------------
    line = inputs.get("autopilot_line")
    if line is not None:
        att = line["autopilot"]
        b = att["programs"].get("bench.train_step") or {}
        print(f"[observatory] (d) python -m ray_tpu_torch.bench --autopilot"
              f" (phase 12e): bench.train_step {b.get('class')}, AI "
              f"{b.get('arithmetic_intensity')}, mfu {b.get('mfu')}, "
              f"headroom {b.get('headroom')}; {att['summary']} [{card}]",
              flush=True)
        out["d"] = b
        if b.get("class") not in ("compute-bound", "hbm-bound") or \
                b.get("headroom") is None:
            bad.append(f"(d) the attribution line names {b}")

    # (e) -------------------------------------------------------------
    if inputs.get("snapshot") and inputs.get("ledger"):
        import contextlib
        import io

        from ray_tpu_torch.tools.autopilot.__main__ import main as ap

        tmp = tempfile.mkdtemp(prefix="chip_smoke_autopilot_")
        base = os.path.join(tmp, "no_baseline.json")
        rcs, texts = {}, {}
        for name, argv in (
                ("attribute", ["attribute", "--snapshot",
                               inputs["snapshot"], "--format", "json"]),
                ("plan", ["--history", inputs["ledger"], "--baseline",
                          base, "plan", "--format", "full"]),
                ("verdict", ["--history", inputs["ledger"], "--baseline",
                             base, "verdict", "--out-dir", tmp,
                             "--format", "json"])):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf), \
                    contextlib.redirect_stderr(io.StringIO()):
                rcs[name] = ap(argv)
            texts[name] = json.loads(buf.getvalue())
        v = texts["verdict"]
        filed = sorted(f for f in os.listdir(tmp) if f.startswith("AUTO"))
        print(f"[observatory] (e) autopilot CLI: attribute exit "
              f"{rcs['attribute']} ({texts['attribute']['summary']}); plan "
              f"exit {rcs['plan']}, {len(texts['plan']['grid'])} variants "
              f"(bottleneck {texts['plan']['bottleneck']}); verdict exit "
              f"{rcs['verdict']}, ok {v['ok']}, {v['entries']} entries, "
              f"new {v['new']}, regressed {v['regressed']}, filed {filed} "
              f"[{card}]", flush=True)
        out["e"] = {"rcs": rcs, "filed": filed}
        if rcs != {"attribute": 0, "plan": 0, "verdict": 0} or \
                filed != ["AUTOPILOT.json", "AUTOPILOT.md"] or \
                not texts["plan"]["grid"] or v["regressed"]:
            bad.append(f"(e) exits {rcs}, filed {filed}")

    # (g) -------------------------------------------------------------
    dash = inputs.get("dashboard_autopilot")
    if dash is not None:
        print(f"[observatory] (g) /api/perf/autopilot (phase 12d): status "
              f"{dash['status']}, deployments {dash.get('deployments')}, "
              f"{dash.get('summary')} [{card}]", flush=True)
        out["g"] = dash
        if dash["status"] != 200:
            bad.append(f"(g) /api/perf/autopilot answered {dash['status']}")

    # (f) -------------------------------------------------------------
    stdout, stderr = gc_proc.communicate(timeout=600)
    rep = json.loads(stdout) if stdout.strip().startswith("{") else {}
    audited = sorted(n for n, i in rep.get("programs", {}).items()
                     if "skipped" not in i)
    print(f"[observatory] (f) python -m ray_tpu_torch.tools.graftcheck "
          f"--format json: exit {gc_proc.returncode}, ok {rep.get('ok')}, "
          f"{rep.get('summary')}, {len(audited)} programs audited "
          f"{audited}, skipped "
          f"{[n for n, i in rep.get('programs', {}).items() if 'skipped' in i]}"
          f" [{card}]", flush=True)
    out["f"] = {"rc": gc_proc.returncode, "ok": rep.get("ok"),
                "audited": audited}
    if gc_proc.returncode != 0 or rep.get("ok") is not True or \
            len(audited) != 12:
        bad.append(f"(f) graftcheck exit {gc_proc.returncode}: "
                   f"{(rep.get('violations') or stderr[-1500:])}")
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"[observatory] phase wall {out['wall_s']:.1f} s [{card}]",
          flush=True)
    if bad:
        fail("[observatory] " + "; ".join(bad))
    return out


# ---------------------------------------------------------------------------
# phase rllib (12l): RLlib's core — PPO and Tune on the card
# ---------------------------------------------------------------------------

#: (a) the repo's pixel pass bar at its own configuration
#: (release/workloads/ppo_pixels_learning.py:16-20): MinAtar breakout
#: on an 8x8 board, 2 CPU workers x 8 envs, fragments of 128, batches
#: of 2048 in minibatches of 256 over 4 epochs; RL_ITERS train() calls
RL_PIXELS = dict(env="MinAtarBreakout", env_config={"size": 8},
                 num_workers=2, num_envs_per_worker=8,
                 rollout_fragment_length=128, train_batch_size=2048,
                 num_sgd_iter=4, minibatch_size=256, hidden=(128,),
                 lr=7e-4, entropy_coeff=0.02, seed=1)
RL_ITERS = 3
#: (b) an Atari-scale learner update at the sizes of the reference's
#: rllib/tuned_examples/ppo/atari-ppo.yaml (train_batch_size 5000,
#: sgd_minibatch_size 500, num_sgd_iter 10, clip_param 0.1,
#: entropy_coeff 0.01): 84x84x4 frames, so the catalog's Atari conv
#: stack ((16, 8, 4), (32, 4, 2), (64, 3, 2)), hidden (256,), Breakout's
#: 4 actions; a seeded batch of RL_ATARI_ROWS rows, RL_ATARI_TIMED timed
#: updates after one warm-up
RL_ATARI = dict(obs_dim=84 * 84 * 4, n_actions=4, obs_shape=(84, 84, 4),
                hidden=(256,), num_sgd_iter=10, minibatch_size=500,
                clip_param=0.1, entropy_coeff=0.01)
RL_ATARI_ROWS, RL_ATARI_TIMED = 5000, 2
#: (b) one minibatch's loss and gradient, f32 with TF32 off, on the
#: card against the port on the CPU: cuDNN's and the CPU's convolutions
#: sum the same products in other orders; the loss within RL_LOSS_RTOL
#: relative, each leaf within RL_GRAD_REL as ||card - cpu|| / ||cpu||
RL_LOSS_RTOL = 1e-5
RL_GRAD_REL = 1e-4
#: (c) recurrent and attention policies on RepeatPrev (the JAX
#: package's memory-task settings, tests/test_rllib_models.py): one
#: fragment of 8 envs x 64 steps from a CPU worker, one update on the
#: card; the rollout's stored logp against the learner's recompute on
#: the card from the same weights (ratio 1) within RL_LOGP_TOL
RL_SEQ_COMMON = dict(obs_dim=3, n_actions=3, hidden=(64,), max_seq_len=16,
                     num_sgd_iter=6, minibatch_size=32, lr=1e-3,
                     entropy_coeff=0.003)
RL_SEQ = {"lstm": dict(use_lstm=True, lstm_cell_size=64),
          "attention": dict(use_attention=True, attention_dim=64,
                            attention_heads=4)}
RL_LOGP_TOL = 1e-4
#: (d) Tuner("PPO"): one trial of 1 iteration on CartPole-v1, granted
#: the card
RL_TUNE = dict(env="CartPole-v1", num_workers=1, num_envs_per_worker=4,
               rollout_fragment_length=250, train_batch_size=1000,
               training_iterations=1, seed=0)
#: the JAX package's PPO result keys (ray_tpu/rllib/algorithm.py
#: train(), ppo.py training_step, policy.py's update stats)
RL_RESULT_KEYS = frozenset((
    "policy_loss", "vf_loss", "entropy", "total_loss",
    "timesteps_this_iter", "training_iteration", "timesteps_total",
    "episode_reward_mean", "episodes_total", "time_this_iter_s"))


def _probed_worker_cls():
    """RolloutWorker with a ``probe()`` saying where it runs (defined
    here, so it travels by value to the workers)."""
    from ray_tpu_torch.rllib.rollout_worker import RolloutWorker

    class ProbedRolloutWorker(RolloutWorker):
        def probe(self):
            import os

            import torch

            leaf = next(iter(self.policy.net.parameters()))
            return {"pid": os.getpid(), "device": str(leaf.device),
                    "CUDA_VISIBLE_DEVICES":
                        os.environ.get("CUDA_VISIBLE_DEVICES"),
                    "cuda_initialized": torch.cuda.is_initialized()}

    return ProbedRolloutWorker


def _rl_timed(torch, policy, on_card: bool, out: list):
    """Wrap ``policy.learn_on_batch``: each call's wall (it ends in one
    read of the stats) and, on the card, its CUDA-event ms into out."""
    inner = policy.learn_on_batch

    def learn(batch):
        t0 = time.perf_counter()
        if on_card:
            e0, e1 = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
            e0.record()
        stats = inner(batch)
        rec = {"wall_ms": (time.perf_counter() - t0) * 1e3}
        if on_card:
            e1.record()
            e1.synchronize()
            rec["ms"] = e0.elapsed_time(e1)
        out.append(rec)
        return stats

    policy.learn_on_batch = learn


def phase_rllib(torch, np, fa, card: str, device: str = "cuda",
                pixels=None, iters: int = RL_ITERS, atari=None,
                atari_rows: int = RL_ATARI_ROWS,
                atari_timed: int = RL_ATARI_TIMED, seq_common=None,
                fragment: int = 64, tune_cfg=None) -> dict:
    """12l: RLlib's core on the port's runtime (``init(num_gpus=1)``),
    the learner on the card, rollout workers CPU actors with no grant.
    (a) ``PPO(cfg).train()`` x ``iters`` at RL_PIXELS: each iteration's
    time_this_iter_s, the learner's update ms (CUDA events), env steps/s,
    finite losses; the learner's parameters on the card, the workers' on
    the CPU in processes with ``CUDA_VISIBLE_DEVICES=""``; whether
    gymnasium imports here (the phase needs none).  (b) the learner
    update at RL_ATARI on ``atari_rows`` seeded rows: one minibatch's
    loss and every gradient leaf on the card against the CPU (f32, TF32
    off), then ``learn_on_batch`` timed (ms, minibatch steps/s, peak
    memory).  (c) LSTM and attention policies on RepeatPrev: one
    fragment from a CPU worker, the stored logp against the card's
    recompute, one update on the card.  (d) ``Tuner("PPO")`` at RL_TUNE,
    one trial granted the card: no error, the JAX package's result
    keys.  No flash or fused-CE kernel runs on this path: their counts,
    zeroed before (a) and read after (c), are 0.  The sizes and
    ``device="cpu"`` (the learner on the CPU, no grant) make a CPU dry
    run."""
    import gc
    import os
    import shutil
    import tempfile

    import ray_tpu_torch as rt
    from ray_tpu_torch import tune
    from ray_tpu_torch.rllib import PPO, PPOConfig, worker_set
    from ray_tpu_torch.rllib import sample_batch as sb
    from ray_tpu_torch.rllib.policy import JaxPolicy, PolicySpec
    from ray_tpu_torch.rllib.sample_batch import SampleBatch

    dev = torch.device(device)
    on_card = dev.type == "cuda"
    learner_device = None if on_card else device
    pixels = dict(RL_PIXELS, **(pixels or {}))
    atari = dict(RL_ATARI, **(atari or {}))
    seq_common = dict(RL_SEQ_COMMON, **(seq_common or {}))
    tune_cfg = dict(RL_TUNE, **(tune_cfg or {}))
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    gym = _importable("gymnasium")
    print(f"[rllib] gymnasium importable here: {gym[0]} ({gym[1]}); the "
          f"phase's envs are the repo's own [{card}]", flush=True)
    store = min(RUN_STORE_MAX, shutil.disk_usage("/dev/shm").free // 4) \
        // 2**20 * 2**20
    tmp = tempfile.mkdtemp(prefix="chip_smoke_rllib_")
    results_env = os.environ.get("RAYTPU_RESULTS_DIR")
    os.environ["RAYTPU_RESULTS_DIR"] = f"{tmp}/results"
    probed = _probed_worker_cls()
    plain_worker = worker_set.RolloutWorker
    worker_set.RolloutWorker = probed
    t0 = time.perf_counter()
    rt.init(num_cpus=6, num_gpus=1 if on_card else 0,
            object_store_memory=store)
    print(f"[rllib] init in {time.perf_counter() - t0:.2f} s; "
          f"cluster_resources {rt.cluster_resources()} [{card}]", flush=True)
    out, bad = {}, []
    try:
        # (c)'s CPU workers start now and boot while (a) and (b) run
        seq_specs = {k: PolicySpec(**seq_common, **v)
                     for k, v in RL_SEQ.items()}
        seq_remote = rt.remote(num_cpus=1, num_gpus=0)(probed)
        seq_workers = {k: seq_remote.remote(
            env="RepeatPrev", policy_spec=spec, num_envs=8,
            rollout_fragment_length=fragment, seed=7 + i, num_threads=1)
            for i, (k, spec) in enumerate(seq_specs.items())}

        # (a) -------------------------------------------------------------
        zero_counts(fa)
        cfg = PPOConfig(**pixels, learner_device=learner_device)
        t0 = time.perf_counter()
        algo = PPO(cfg)
        setup_s = time.perf_counter() - t0
        try:
            learns = []
            _rl_timed(torch, algo.learner_policy, on_card, learns)
            results = []
            for _ in range(iters):
                results.append(algo.train())
            probes = rt.get([w.probe.remote()
                             for w in algo.workers.workers], timeout=300)
        finally:
            algo.stop()
        lp_dev = str(next(iter(algo.learner_policy.net.parameters())).device)
        for r, lr in zip(results, learns):
            print(f"[rllib] (a) iteration {r['training_iteration']}: "
                  f"time_this_iter_s {r['time_this_iter_s']:.3f}, learner "
                  f"update {lr.get('ms', float('nan')):.2f} ms (CUDA "
                  f"events; {lr['wall_ms']:.2f} ms wall), env steps/s "
                  f"{r['timesteps_this_iter'] / r['time_this_iter_s']:.0f}"
                  f", losses policy {r['policy_loss']:.5f} vf "
                  f"{r['vf_loss']:.5f} entropy {r['entropy']:.5f} total "
                  f"{r['total_loss']:.5f}, episode_reward_mean "
                  f"{r['episode_reward_mean']:.3f} [{card}]", flush=True)
        print(f"[rllib] (a) PPO(cfg) set-up {setup_s:.2f} s (2 worker "
              f"processes); the learner's parameters on {lp_dev}; the "
              f"workers {probes} [{card}]", flush=True)
        out["a"] = {"results": results, "learns": learns,
                    "setup_s": setup_s, "learner_device": lp_dev,
                    "workers": probes}
        if on_card != lp_dev.startswith("cuda"):
            bad.append(f"(a) the learner's parameters are on {lp_dev}")
        if any(p["device"] != "cpu" or p["CUDA_VISIBLE_DEVICES"] != ""
               or p["cuda_initialized"] for p in probes):
            bad.append(f"(a) a worker is not a CPU actor: {probes}")
        if len(results) != iters or any(
                not np.isfinite(r[k]) for r in results for k in
                ("policy_loss", "vf_loss", "entropy", "total_loss")):
            bad.append(f"(a) results {results}")
        if any(r["timesteps_this_iter"] < pixels["train_batch_size"]
               for r in results):
            bad.append("(a) an iteration took fewer steps than a batch")

        # (b) -------------------------------------------------------------
        spec = PolicySpec(**atari)
        rng = np.random.default_rng(RL_PIXELS["seed"])
        n = atari_rows
        batch = SampleBatch({
            sb.OBS: rng.random((n, *spec.obs_shape), dtype=np.float32),
            sb.ACTIONS: rng.integers(0, spec.n_actions, n),
            sb.ACTION_LOGP: np.log(rng.dirichlet(
                np.ones(spec.n_actions), n).max(-1)).astype(np.float32),
            sb.ADVANTAGES: rng.standard_normal(n, dtype=np.float32),
            sb.VALUE_TARGETS: rng.standard_normal(n, dtype=np.float32)})
        pol = JaxPolicy(spec, seed=0, device=learner_device)
        ref = JaxPolicy(spec, seed=1, device="cpu")
        ref.set_weights(pol.get_weights())
        mini = batch.slice(0, spec.minibatch_size)
        loss, _, grads = pol.loss_and_grads(mini.to_device(pol.device))
        rloss, _, rgrads = ref.loss_and_grads(mini.to_device("cpu"))
        loss, rloss = float(loss.detach()), float(rloss.detach())
        loss_rel = abs(loss - rloss) / abs(rloss)
        rels = [float((g.cpu() - r).norm() / r.norm().clamp_min(1e-30))
                for g, r in zip(grads, rgrads)]
        worst = max(range(len(rels)), key=rels.__getitem__)
        print(f"[rllib] (b) one minibatch of {spec.minibatch_size} at "
              f"{spec.obs_shape}, f32, TF32 off: loss card {loss:.6f}"
              f" cpu {rloss:.6f} (rel {loss_rel:.2e}, tol "
              f"{RL_LOSS_RTOL}); gradient leaves {len(rels)}, worst "
              f"||card - cpu|| / ||cpu|| {rels[worst]:.2e} (leaf {worst}, "
              f"tol {RL_GRAD_REL}) [{card}]", flush=True)
        if not (loss_rel <= RL_LOSS_RTOL and max(rels) <= RL_GRAD_REL):
            bad.append(f"(b) card vs CPU: loss rel {loss_rel:.2e}, "
                       f"leaves {rels}")
        del grads, rgrads, ref
        times = []
        _rl_timed(torch, pol, on_card, times)
        pol.learn_on_batch(batch)                  # warm-up
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        for _ in range(atari_timed):
            stats = pol.learn_on_batch(batch)
        peak = torch.cuda.max_memory_allocated() if on_card else 0
        steps = spec.num_sgd_iter * (n // min(spec.minibatch_size, n))
        ms = [t.get("ms", t["wall_ms"]) for t in times[1:]]
        print(f"[rllib] (b) learn_on_batch of {n} rows ({steps} minibatch "
              f"steps): {', '.join(f'{m:.1f}' for m in ms)} ms "
              f"({'CUDA events' if on_card else 'wall, CPU'}; walls "
              f"{[round(t['wall_ms'], 1) for t in times[1:]]}), "
              f"{steps / (min(ms) / 1e3):.0f} minibatch steps/s, peak "
              f"memory {peak / 2**30:.2f} GiB, stats {stats} [{card}]",
              flush=True)
        out["b"] = {"ms": ms, "steps": steps, "peak_bytes": peak,
                    "loss_rel": loss_rel, "worst_leaf_rel": rels[worst],
                    "stats": stats}
        if on_card:
            # where an update's time goes: device time by kind against
            # its wall (the host's share is the rest)
            out["b"]["profile"] = profile_call(
                torch, lambda: pol.learn_on_batch(batch),
                "Atari-scale learn_on_batch", min(ms), card, "rllib")
        if not all(np.isfinite(v) for v in stats.values()):
            bad.append(f"(b) stats {stats}")
        del pol, batch

        # (c) -------------------------------------------------------------
        out["c"] = {}
        for kind, spec in seq_specs.items():
            learner = JaxPolicy(spec, seed=3, device=learner_device)
            w = seq_workers[kind]
            rt.get(w.set_weights.remote(learner.get_weights()), timeout=300)
            t0 = time.perf_counter()
            frag = rt.get(w.sample.remote(), timeout=300)
            sample_s = time.perf_counter() - t0
            probe = rt.get(w.probe.remote(), timeout=60)
            dev_batch = frag.to_device(learner.device)
            seen = []
            objective = learner._ppo_objective
            learner._ppo_objective = \
                lambda logp, *a: (seen.append(logp.detach()),
                                  objective(logp, *a))[1]
            with torch.no_grad():
                learner._loss(learner.params, dev_batch)
            del learner._ppo_objective
            logp_err = float((seen[0] - dev_batch[sb.ACTION_LOGP]).abs()
                             .max())
            stats = learner.learn_on_batch(frag)
            print(f"[rllib] (c) {kind}: a fragment {frag[sb.OBS].shape} "
                  f"from a CPU worker ({probe['device']}, "
                  f"CUDA_VISIBLE_DEVICES={probe['CUDA_VISIBLE_DEVICES']!r})"
                  f" in {sample_s:.2f} s; stored vs recomputed logp on "
                  f"{learner.device}: max |d| {logp_err:.2e} (tol "
                  f"{RL_LOGP_TOL}); one update: {stats} [{card}]",
                  flush=True)
            out["c"][kind] = {"logp_err": logp_err, "stats": stats,
                              "sample_s": sample_s}
            if not logp_err <= RL_LOGP_TOL:
                bad.append(f"(c) {kind}: logp off by {logp_err:.2e}")
            if not all(np.isfinite(v) for v in stats.values()):
                bad.append(f"(c) {kind}: stats {stats}")
            if probe["device"] != "cpu" or probe["CUDA_VISIBLE_DEVICES"]:
                bad.append(f"(c) {kind}: worker {probe}")
        out["counts"] = read_counts(fa)
        print(f"[rllib] kernel launches over (a)-(c): {out['counts']} "
              f"[{card}]", flush=True)
        if any(out["counts"].values()):
            bad.append(f"kernel launches {out['counts']}")
        for w in seq_workers.values():
            rt.kill(w)

        # (d) -------------------------------------------------------------
        t0 = time.perf_counter()
        grid = tune.Tuner(
            "PPO", param_space=dict(tune_cfg, learner_device=learner_device),
            tune_config=tune.TuneConfig(max_concurrent_trials=1),
            resources_per_trial={"CPU": 1, "GPU": 1} if on_card
            else {"CPU": 1}).fit()
        wall = time.perf_counter() - t0
        trial = grid.trials[0]
        res = trial.last_result or {}
        missing = sorted(RL_RESULT_KEYS - set(res))
        print(f"[rllib] (d) Tuner('PPO') (the trial granted "
              f"{'the card' if on_card else 'no card'}; its learner's "
              f"default device raises without one): status {trial.status}, "
              f"error {trial.error!r}, training_iteration "
              f"{res.get('training_iteration')}, timesteps_total "
              f"{res.get('timesteps_total')}, JAX keys missing {missing}, "
              f"wall {wall:.1f} s [{card}]", flush=True)
        out["d"] = {"wall_s": wall, "error": repr(trial.error),
                    "missing": missing}
        if trial.error is not None or missing or \
                res.get("training_iteration") != 1:
            bad.append(f"(d) trial error {trial.error!r}, missing keys "
                       f"{missing}, result {res}")
    finally:
        worker_set.RolloutWorker = plain_worker
        rt.shutdown()
        if results_env is None:
            os.environ.pop("RAYTPU_RESULTS_DIR", None)
        else:
            os.environ["RAYTPU_RESULTS_DIR"] = results_env
        shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"[rllib] phase wall {out['wall_s']:.1f} s [{card}]", flush=True)
    if bad:
        fail("[rllib] " + "; ".join(bad))
    return out


class _PhaseClock:
    """``tick(name)`` prints the wall since the last tick (the phase
    just run) and since the script's first phase."""

    def __init__(self):
        self.start = self.last = time.perf_counter()

    def __call__(self, name: str) -> None:
        now = time.perf_counter()
        print(f"[clock] {name}: {now - self.last:.1f} s (script at "
              f"{now - self.start:.1f} s)", flush=True)
        self.last = now


def keep_bytecode() -> None:
    """Where the interpreter runs with bytecode writing off
    (PYTHONDONTWRITEBYTECODE), every process this script starts (the
    runtime's workers, the CLI's nodes, the bench's subprocesses)
    compiles torch's Python sources anew, seconds a process: turn it on
    for this process and the ones it starts, with the bytecode under
    __pycache__/bytecode beside this script.  Call before torch is
    imported."""
    import os

    if not (sys.dont_write_bytecode or os.environ.get(
            "PYTHONDONTWRITEBYTECODE")):
        return
    prefix = str(Path(__file__).resolve().parent / "__pycache__" /
                 "bytecode")
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
    os.environ["PYTHONPYCACHEPREFIX"] = prefix
    sys.dont_write_bytecode = False
    sys.pycache_prefix = prefix


def main() -> int:
    keep_bytecode()
    import numpy as np
    import torch

    _run_mark()  # before any process starts: _ray_tpu_torch_pids
    name, card = phase_card(torch)
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    kernels = importlib.import_module("ray_tpu_torch.ops._kernels")
    fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")
    fc = _fc()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    tick = _PhaseClock()
    ptxas = phase_build(kernels)
    tick("build")
    with torch.inference_mode():
        headline = phase_kernel(torch, fa, card)
    headline["ptxas"] = ptxas["flash_fwd"].get("flash_fwd_bf16_kernel<64>",
                                               [])
    tick("kernel")
    bwd = phase_kernel_bwd(torch, fa, card, ptxas["flash_bwd"])
    tick("kernel-bwd")
    ce = phase_kernel_ce(torch, fc, card, ptxas["fused_ce"])
    tick("kernel-ce")
    serve_counts = phase_serve(torch, np, fa, card)["counts"]
    tick("serve")
    train = phase_train(torch, fa, card)
    tick("train")
    train_ce = phase_train_ce(torch, fa, card)
    tick("train-ce")
    serve_llama = phase_serve(torch, np, fa, card, "llama", "serve-llama")
    tick("serve-llama")
    with torch.inference_mode():
        serve_cont = phase_serve_continuous(torch, np, fa, card)
        gate = serve_cont.pop("gate")
        tick("serve-continuous")
        serve_spec = phase_serve_spec_disagg(torch, np, fa, card, gate)
        tick("serve-spec-disagg")
        serve_tele = phase_serve_telemetry(torch, np, fa, card, gate)
        tick("serve-telemetry")
        serve_fleet = phase_serve_fleet(torch, np, fa, card, gate)
        tick("serve-fleet")
        serve_run = phase_serve_run(torch, np, fa, card)
        tick("serve-run")
        serve_http = phase_serve_http(torch, np, fa, card)
        tick("serve-http")
    bench_cli = phase_bench_cli(torch, card)
    tick("bench-cli")
    data_air = phase_data_air(torch, np, fa, card)
    tick("data-air")
    moe_mesh = phase_moe_mesh(torch, np, fa, card)
    tick("moe-mesh")
    seq_pipe = phase_seq_pipe_tp(torch, np, fa, card)
    tick("seq-pipe-tp")
    train_tune = phase_train_tune(torch, np, fa, card)
    tick("train-tune")
    vision = phase_vision(torch, fa, card, {
        "ledger": bench_cli["ledger"],
        "snapshot": serve_tele["a"]["snapshot"],
        "dump": serve_fleet["d"]["dump"],
        "frozen": serve_fleet["d"]["frozen"],
        "time_to_detect_ms": serve_fleet["d"]["time_to_detect_ms"],
        "transitions": len(serve_fleet["d"]["transitions"])})
    tick("vision")
    phase_observatory(torch, fa, fc, card, {
        "programs": {"serve-continuous": serve_cont["programs"],
                     "serve-spec-disagg": serve_spec["programs"]},
        "autopilot_line": bench_cli["train"]["autopilot"],
        "snapshot": serve_tele["a"]["snapshot"],
        "ledger": bench_cli["ledger"],
        "dashboard_autopilot": serve_http["dashboard"]["autopilot"]})
    tick("observatory")
    rllib = phase_rllib(torch, np, fa, card)
    tick("rllib")
    train_llama = phase_train_llama(torch, fa, fc, card)
    tick("train-llama")
    train_tele = phase_train_telemetry(torch, np, fa, card)
    tick("train-telemetry")
    llama_7b = phase_llama_7b(torch, fa, fc, card)
    tick("llama-7b")

    def launches(name):
        by_path = {"serve": serve_counts.get(name, 0),
                   "train": train["counts"].get(name, 0),
                   "train_pallas": train_ce["counts"][name],
                   "serve_llama": serve_llama["counts"].get(name, 0),
                   "serve_continuous": serve_cont["counts"].get(name, 0),
                   "serve_spec_disagg": serve_spec["counts"].get(name, 0),
                   "serve_telemetry": serve_tele["counts"].get(name, 0),
                   "serve_fleet": serve_fleet["counts"].get(name, 0),
                   "serve_run": serve_run["counts"].get(name, 0),
                   "serve_http": serve_http["counts"].get(name, 0),
                   "bench_cli_train": bench_cli["train"]["counts"][
                       CE_OR_FLASH[name]],
                   "bench_cli_decode": bench_cli["decode"]["counts"][
                       CE_OR_FLASH[name]],
                   "data_train": data_air["counts_train"].get(name, 0),
                   "data_predict": data_air["counts_predict"].get(name, 0),
                   "moe_mesh": moe_mesh["counts"].get(name, 0),
                   "seq_pipe_tp": seq_pipe["counts"].get(name, 0),
                   "train_tune": train_tune["counts"][name],
                   "vision": vision["counts"].get(name, 0),
                   "rllib": rllib["counts"].get(name, 0),
                   "train_llama": train_llama["counts"][name],
                   "train_telemetry": train_tele["counts"][name]}
        return {"launches": sum(by_path.values()),
                "launches_by_path": by_path,
                "launches_per_train_step":
                    train_ce["counts"][name] / train_ce["steps_run"],
                "launches_per_llama_train_step":
                    train_llama["counts"][name] / train_llama["steps_run"],
                "launches_per_moe_train_step": moe_mesh["per_step"][name],
                "launches_per_trainer_step": train_tune["per_step"][name],
                "launches_per_vit_train_step":
                    vision["counts"].get(name, 0) / vision["b"]["steps_run"]}

    # each kernel at llama-1b's shapes (phase train-llama)
    at_llama = {"flash_fwd": train_llama["kernels"]["flash"]["fwd"],
                "flash_bwd_dq": train_llama["kernels"]["flash"]["dq"],
                "flash_bwd_dkv": train_llama["kernels"]["flash"]["dkv"],
                "fused_ce_fwd": train_llama["kernels"]["ce"]["fwd"],
                "fused_ce_bwd_dh": train_llama["kernels"]["ce"]["dh"],
                "fused_ce_bwd_dw": train_llama["kernels"]["ce"]["dw"]}

    src = "ray_tpu/ops/flash_attention.py"
    records = [
        {"name": "flash_fwd", "route": "cuda",
         "source": "ray_tpu_torch/ops/csrc/flash_fwd.cu",
         "replaces": f"{src}:68", "also_replaces": f"{src}:294",
         **launches("flash_fwd"), **headline,
         "train_shape": bwd["fwd_train_shape"]},
        {"name": "flash_bwd_dq", "route": "cuda",
         "source": "ray_tpu_torch/ops/csrc/flash_bwd.cu",
         "replaces": f"{src}:148", "also_replaces": f"{src}:358",
         **launches("flash_bwd_dq"), **bwd["dq"]},
        {"name": "flash_bwd_dkv", "route": "cuda",
         "source": "ray_tpu_torch/ops/csrc/flash_bwd.cu",
         "replaces": f"{src}:186", "also_replaces": f"{src}:395",
         **launches("flash_bwd_dkv"), **bwd["dkv"]},
    ]
    src = "ray_tpu/ops/fused_ce.py"
    for kernel, key, line in (("fused_ce_fwd", "fwd", 83),
                              ("fused_ce_bwd_dh", "dh", 164),
                              ("fused_ce_bwd_dw", "dw", 185)):
        records.append({"name": kernel, "route": "cuda",
                        "source": "ray_tpu_torch/ops/csrc/fused_ce.cu",
                        "replaces": f"{src}:{line}", **launches(kernel),
                        **ce[key]})
    for rec in records:
        rec["llama_1b_shape"] = at_llama[rec["name"]]
    for rec, keys in ((records[3], ("nll", "lse")), (records[4], ("dh",)),
                      (records[5], ("dw",))):
        rec["llama_7b_shape"] = {k: llama_7b["ce_kernels_vs_plain"][k]
                                 for k in keys}
    # ptxas's record of the cluster kernel that llama-1b's head runs
    plan = fc.fused_ce_bwd_plan(2048, LLAMA_B * LLAMA_T)
    for rec, mode in ((records[4], 1), (records[5], 2)):
        rec["llama_1b_shape"]["ptxas"] = ptxas["fused_ce"].get(
            f"fused_ce_bwd_bf16_cluster_kernel<{mode}, {plan.k}, {plan.c}, "
            f"{plan.sc}>", [])
    records[1]["llama_1b_shape"]["whole_backward"] = \
        train_llama["kernels"]["flash"]["whole"]
    # each flash kernel at ViT-B/16's attention (phase vision (c):
    # B*H = 1536, T = 197, D = 64, non-causal)
    for rec, k in zip(records[:3], ("fwd", "dq", "dkv")):
        rec["vit_shape"] = vision["kernels"][k]
    records[1]["vit_shape"]["whole_backward"] = vision["kernels"]["whole"]
    print(card)
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
