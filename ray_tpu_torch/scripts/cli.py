"""Cluster CLI (reference analog: python/ray/scripts/scripts.py —
`ray start/stop/status/...`).  Run as `python -m ray_tpu_torch <cmd>`.

A copy of ``ray_tpu/scripts/cli.py``.  `start --head` runs GCS + a node
manager in the foreground (daemonize with nohup/systemd as you
prefer); `start --address` joins an existing head; `--num-gpus` is the
count of cards the node offers (counted when not given: on one host,
give the head 0 and one node the cards, or two nodes grant the same
card twice); `status` prints the cluster resource summary; `stop` kills
nodes started on this host.  The address and pid files live under
``tempfile.gettempdir()/raytpu_torch/``, apart from the JAX package's
``/tmp/raytpu/``, so that neither package's `stop` signals the other's
nodes.  `rllib train|evaluate|algorithms` runs the port's RLlib
(``ray_tpu_torch/rllib/``): the learner on the card unless the config
sets ``learner_device``, the rollout workers CPU actors; an algorithm
not ported yet raises NotImplementedError naming its ROADMAP item.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import tempfile
import time

_CLI_DIR = os.path.join(tempfile.gettempdir(), "raytpu_torch")
_ADDR_FILE = os.path.join(_CLI_DIR, "ray_current_cluster")
_PID_DIR = os.path.join(_CLI_DIR, "pids")


def _write_pidfile(role: str) -> str:
    os.makedirs(_PID_DIR, exist_ok=True)
    path = os.path.join(_PID_DIR, f"{role}-{os.getpid()}.pid")
    with open(path, "w") as f:
        f.write(str(os.getpid()))
    return path


def cmd_start(args) -> int:
    from ray_tpu_torch._private.config import Config
    from ray_tpu_torch._private.node import Node

    config = Config().apply_env()
    if args.head:
        gcs_address = f"{args.host}:{args.port}"
        node = Node(head=True, num_cpus=args.num_cpus,
                    num_gpus=args.num_gpus,
                    object_store_memory=args.object_store_memory,
                    config=config, gcs_address=gcs_address)
        node.start()
        os.makedirs(os.path.dirname(_ADDR_FILE), exist_ok=True)
        with open(_ADDR_FILE, "w") as f:
            f.write(node.gcs_address)
        print(f"head started; GCS at {node.gcs_address}")
        print(f"attach drivers with ray_tpu_torch.init("
              f"address={node.gcs_address!r})")
        print(f"join workers with: python -m ray_tpu_torch start "
              f"--address {node.gcs_address}")
    else:
        address = args.address or _read_addr()
        if not address:
            print("--address required (no local cluster found)",
                  file=sys.stderr)
            return 1
        node = Node(head=False, num_cpus=args.num_cpus,
                    num_gpus=args.num_gpus,
                    object_store_memory=args.object_store_memory,
                    config=config, gcs_address=address)
        node.start()
        print(f"node {node.node_id.hex()[:12]} joined {address}")

    # Mark this node as process-backed: shutdown_node (chaos tooling)
    # hard-exits instead of just closing the in-process server.
    os.environ["RAYTPU_NODE_PROCESS"] = "1"
    pidfile = _write_pidfile("head" if args.head else "node")
    stop = {"flag": False}

    def _sig(_s, _f):
        stop["flag"] = True

    signal.signal(signal.SIGTERM, _sig)
    signal.signal(signal.SIGINT, _sig)
    try:
        while not stop["flag"]:
            time.sleep(0.5)
    finally:
        node.stop()
        for p in (pidfile, _ADDR_FILE if args.head else None):
            if p:
                try:
                    os.unlink(p)
                except OSError:
                    pass
    return 0


def _read_addr() -> str:
    try:
        with open(_ADDR_FILE) as f:
            return f.read().strip()
    except OSError:
        return ""


def cmd_stop(_args) -> int:
    n = 0
    if os.path.isdir(_PID_DIR):
        for name in os.listdir(_PID_DIR):
            try:
                pid = int(open(os.path.join(_PID_DIR, name)).read())
                os.kill(pid, signal.SIGTERM)
                n += 1
            except (OSError, ValueError):
                pass
            try:
                os.unlink(os.path.join(_PID_DIR, name))
            except OSError:
                pass
    print(f"signalled {n} node process(es)")
    return 0


def cmd_status(args) -> int:
    import ray_tpu_torch

    address = args.address or _read_addr()
    if not address:
        print("no cluster address (start one or pass --address)",
              file=sys.stderr)
        return 1
    ray_tpu_torch.init(address=address, num_cpus=0, num_gpus=0)
    try:
        nodes = ray_tpu_torch.nodes()
        total = ray_tpu_torch.cluster_resources()
        avail = ray_tpu_torch.available_resources()
        print(f"{len(nodes)} node(s) @ {address}")
        for n in nodes:
            print(f"  {n['NodeID'][:12]} alive={n['Alive']} "
                  f"total={n['Resources']}")
        print("cluster totals:", json.dumps(total))
        print("available:   ", json.dumps(avail))
    finally:
        ray_tpu_torch.shutdown()
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="ray_tpu_torch",
        description="distributed runtime CLI (the PyTorch/CUDA port)")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p_start = sub.add_parser("start", help="start a head or worker node")
    p_start.add_argument("--head", action="store_true")
    p_start.add_argument("--address", default="")
    p_start.add_argument("--host", default="0.0.0.0")
    p_start.add_argument("--port", type=int, default=6380)
    p_start.add_argument("--num-cpus", type=int, default=None,
                         dest="num_cpus")
    p_start.add_argument("--num-gpus", type=int, default=None,
                         dest="num_gpus")
    p_start.add_argument("--object-store-memory", type=int, default=None,
                         dest="object_store_memory")
    p_start.set_defaults(fn=cmd_start)

    p_stop = sub.add_parser("stop", help="stop nodes on this host")
    p_stop.set_defaults(fn=cmd_stop)

    p_status = sub.add_parser("status", help="cluster resource summary")
    p_status.add_argument("--address", default="")
    p_status.set_defaults(fn=cmd_status)

    p_list = sub.add_parser(
        "list", help="list cluster state: actors|nodes|tasks|pgs")
    p_list.add_argument("kind",
                        choices=["actors", "nodes", "tasks", "pgs"])
    p_list.add_argument("--address", default="")
    p_list.set_defaults(fn=cmd_list)

    p_sum = sub.add_parser("summary", help="task/actor summaries")
    p_sum.add_argument("--address", default="")
    p_sum.set_defaults(fn=cmd_summary)

    p_tl = sub.add_parser("timeline",
                          help="dump chrome-trace of task events")
    p_tl.add_argument("--address", default="")
    p_tl.add_argument("--out", default="timeline.json")
    p_tl.set_defaults(fn=cmd_timeline)

    # Job submission (reference: dashboard/modules/job/cli.py +
    # `ray job submit/status/logs/stop/list`).
    p_mem = sub.add_parser(
        "memory", help="per-node object store + spill usage")
    p_mem.add_argument("--address", default="")
    p_mem.set_defaults(fn=cmd_memory)

    p_krn = sub.add_parser(
        "kill-random-node",
        help="chaos: kill a random non-head worker node")
    p_krn.add_argument("--address", default="")
    p_krn.set_defaults(fn=cmd_kill_random_node)

    p_submit = sub.add_parser("submit", help="submit a job to the cluster")
    p_submit.add_argument("--address", default="")
    p_submit.add_argument("--working-dir", default="", dest="working_dir")
    p_submit.add_argument("--env", action="append", default=[],
                          help="KEY=VALUE env var for the job")
    p_submit.add_argument("--no-wait", action="store_true", dest="no_wait")
    p_submit.add_argument("entrypoint", nargs=argparse.REMAINDER,
                          help="command to run (prefix with --)")
    p_submit.set_defaults(fn=cmd_submit)

    p_job = sub.add_parser("job", help="job operations")
    job_sub = p_job.add_subparsers(dest="job_cmd", required=True)
    for name in ("list", "status", "logs", "stop"):
        pj = job_sub.add_parser(name)
        pj.add_argument("--address", default="")
        if name != "list":
            pj.add_argument("job_id")
        pj.set_defaults(fn=cmd_job, job_cmd=name)

    p_rllib = sub.add_parser(
        "rllib", help="train / evaluate RLlib algorithms by name "
                      "(reference: the `rllib` CLI)")
    rl_sub = p_rllib.add_subparsers(dest="rllib_cmd", required=True)
    p_rt = rl_sub.add_parser("train")
    p_rt.add_argument("--run", required=True,
                      help="registry name, e.g. PPO (see "
                           "`rllib algorithms`)")
    p_rt.add_argument("--env", required=True,
                      help="env id, e.g. CartPole-v1")
    p_rt.add_argument("--stop-iters", type=int, default=10,
                      dest="stop_iters")
    p_rt.add_argument("--stop-reward", type=float, default=None,
                      dest="stop_reward")
    p_rt.add_argument("--config", default="{}",
                      help="JSON of Config field overrides")
    p_rt.add_argument("--checkpoint-dir", default="",
                      dest="checkpoint_dir",
                      help="save the final state here")
    p_rt.set_defaults(fn=cmd_rllib_train)
    p_re = rl_sub.add_parser("evaluate")
    p_re.add_argument("checkpoint", help="path from `rllib train "
                                         "--checkpoint-dir`")
    p_re.add_argument("--run", required=True)
    p_re.add_argument("--env", required=True)
    p_re.add_argument("--episodes", type=int, default=10)
    p_re.add_argument("--config", default="{}")
    p_re.set_defaults(fn=cmd_rllib_evaluate)
    p_ra = rl_sub.add_parser("algorithms",
                             help="list registered algorithm names")
    p_ra.set_defaults(fn=cmd_rllib_algorithms)

    args = parser.parse_args(argv)
    return args.fn(args)


def _build_algorithm(args, overrides=None):
    import ray_tpu_torch
    from ray_tpu_torch.rllib.registry import get_algorithm_class

    cls, cfg_cls = get_algorithm_class(args.run, return_config=True)
    if overrides is None:
        overrides = json.loads(args.config)
    overrides.pop("env", None)       # --env wins over a config "env"
    # logical-CPU headroom: rollout workers + a lazy eval worker must
    # co-schedule even on a 1-core box (they are IO/step-bound)
    ray_tpu_torch.init(num_cpus=max(4, (os.cpu_count() or 1) * 2))
    return cls(cfg_cls(env=args.env, **overrides))


def cmd_rllib_train(args) -> int:
    import ray_tpu_torch

    algo = _build_algorithm(args)
    try:
        for _ in range(args.stop_iters):
            result = algo.train()
            print(json.dumps({
                k: result.get(k) for k in
                ("training_iteration", "timesteps_total",
                 "episode_reward_mean", "episodes_total")},
                default=float), flush=True)
            reward = result.get("episode_reward_mean")
            if (args.stop_reward is not None and reward is not None
                    and reward == reward        # not NaN
                    and reward >= args.stop_reward):
                break
        if args.checkpoint_dir:
            path = algo.save(args.checkpoint_dir)
            print(f"checkpoint saved: {path}")
    finally:
        algo.stop()
        ray_tpu_torch.shutdown()
    return 0


def cmd_rllib_evaluate(args) -> int:
    import ray_tpu_torch

    # evaluation uses only the dedicated eval worker — don't spin up
    # the full rollout gang unless the user asked for it
    overrides = json.loads(args.config)
    overrides.setdefault("num_workers", 0)
    algo = _build_algorithm(args, overrides)
    try:
        algo.restore(args.checkpoint)
        algo.config.evaluation_num_episodes = args.episodes
        try:
            result = algo.evaluate()
        except NotImplementedError:
            # no dedicated eval worker (A3C): greedy in-process rollout
            # through the policy's action surface
            result = _greedy_rollout_eval(algo, args.env,
                                          args.episodes)
        print(json.dumps(result, default=float))
    finally:
        algo.stop()
        ray_tpu_torch.shutdown()
    return 0


def _greedy_rollout_eval(algo, env_id: str, episodes: int):
    import numpy as np

    from ray_tpu_torch.rllib.rollout_worker import _make_env

    policy = getattr(algo, "policy", None) \
        or getattr(algo, "learner_policy", None)
    if policy is None or not hasattr(policy, "compute_actions"):
        raise SystemExit(
            f"{type(algo).__name__} exposes no evaluable policy")
    # greedy where the policy offers it (JaxPolicy)
    act_fn = getattr(policy, "compute_deterministic_actions",
                     policy.compute_actions)
    env = _make_env(env_id, None)
    space = getattr(env, "action_space", None)
    discrete = space is None or getattr(space, "n", None) is not None
    low = np.asarray(getattr(space, "low", -1.0))
    high = np.asarray(getattr(space, "high", 1.0))
    returns = []
    try:
        for ep in range(episodes):
            obs, _ = env.reset(seed=10_000 + ep)
            total = 0.0
            for _ in range(10_000):
                acts = act_fn(
                    np.asarray(obs, np.float32).ravel()[None])
                a = np.asarray(acts[0] if isinstance(acts, tuple)
                               else acts)
                if discrete:
                    env_a = int(a.ravel()[0])
                else:
                    # continuous policies act in [-1, 1]; rescale to
                    # the env bounds (worker-side convention)
                    env_a = (low + (a.reshape(space.shape) + 1.0)
                             * 0.5 * (high - low))
                obs, r, term, trunc, _ = env.step(env_a)
                total += float(r)
                if term or trunc:
                    break
            returns.append(total)
    finally:
        env.close() if hasattr(env, "close") else None
    return {"episode_reward_mean": float(np.mean(returns)),
            "episodes": episodes, "mode": "greedy_rollout"}


def cmd_rllib_algorithms(_args) -> int:
    from ray_tpu_torch.rllib.registry import registered_algorithms

    for name in registered_algorithms():
        print(name)
    return 0


def _attached(args):
    import contextlib

    import ray_tpu_torch

    @contextlib.contextmanager
    def ctx():
        address = args.address or _read_addr()
        if not address:
            raise SystemExit("no cluster address; pass --address")
        ray_tpu_torch.init(address=address)
        try:
            yield
        finally:
            ray_tpu_torch.shutdown()

    return ctx()


def cmd_list(args) -> int:
    from ray_tpu_torch.util import state

    fns = {"actors": state.list_actors, "nodes": state.list_nodes,
           "tasks": state.list_tasks, "pgs": state.list_placement_groups}
    with _attached(args):
        print(json.dumps(fns[args.kind](), indent=2, default=str))
    return 0


def cmd_summary(args) -> int:
    from ray_tpu_torch.util import state

    with _attached(args):
        print(json.dumps({"tasks": state.summarize_tasks(),
                          "actors": state.summarize_actors()}, indent=2))
    return 0


def cmd_timeline(args) -> int:
    import ray_tpu_torch

    with _attached(args):
        events = ray_tpu_torch.timeline(args.out)
    print(f"wrote {len(events)} events to {args.out}")
    return 0


def _each_node_stats(timeout: float = 10.0):
    """Dial every alive node manager and fetch node_stats."""
    import asyncio

    from ray_tpu_torch._private import protocol, worker_context

    cw = worker_context.core_worker()
    nodes = [n for n in cw.nodes() if n["alive"]]

    async def fetch(addr):
        if addr.startswith("/"):
            conn = await protocol.connect_unix(addr)
        else:
            host, port = addr.rsplit(":", 1)
            conn = await protocol.connect_tcp(host, int(port))
        try:
            return await conn.call("node_stats", {}, timeout=timeout)
        finally:
            await conn.close()

    for n in nodes:
        try:
            yield n, cw.io.run(fetch(n["address"]), timeout=timeout + 2)
        except Exception as e:  # noqa: BLE001 - node mid-death
            yield n, {"error": str(e)}


def cmd_memory(args) -> int:
    """Reference analog: `ray memory` (scripts.py memory command)."""
    with _attached(args):
        out = []
        for n, stats in _each_node_stats():
            store = stats.get("object_store", {})
            out.append({
                "node_id": n["node_id"].hex()[:16],
                "address": n["address"],
                "store_bytes_used": store.get("bytes_used"),
                "store_capacity": store.get("capacity"),
                "store_objects": store.get("num_objects"),
                "evictions": store.get("evictions"),
                "spilled_objects": stats.get("spilled_objects"),
                "spilled_bytes": stats.get("spilled_bytes"),
                "error": stats.get("error"),
            })
        print(json.dumps(out, indent=2))
    return 0


def cmd_kill_random_node(args) -> int:
    """Reference analog: `ray kill-random-node` (scripts.py:1269)."""
    import random

    from ray_tpu_torch._private import protocol, worker_context

    import socket

    with _attached(args):
        cw = worker_context.core_worker()
        raw_addr = args.address or _read_addr()
        if "://" in raw_addr:  # init() accepts ray://host:port URIs
            raw_addr = raw_addr.split("://", 1)[1]
        gcs_host = raw_addr.rsplit(":", 1)[0]
        try:  # hostnames must compare as IPs against node addresses
            gcs_ips = {ai[4][0] for ai in socket.getaddrinfo(
                gcs_host, None)}
        except OSError:
            gcs_ips = {gcs_host}
        gcs_ips |= {gcs_host, "127.0.0.1", "localhost"}

        def is_head(n) -> bool:
            addr = n["address"]
            if addr.startswith("/"):
                return True  # same-host unix node: could host the GCS
            return addr.rsplit(":", 1)[0] in gcs_ips

        candidates = [n for n in cw.nodes()
                      if n["alive"] and not is_head(n)]
        if not candidates:
            print("no safely-killable worker nodes (refusing to risk "
                  "the head)")
            return 1
        victim = random.choice(candidates)

        async def kill(addr):
            host, port = addr.rsplit(":", 1)
            conn = await protocol.connect_tcp(host, int(port)) \
                if not addr.startswith("/") else \
                await protocol.connect_unix(addr)
            try:
                await conn.call("shutdown_node", {}, timeout=5)
            finally:
                await conn.close()

        try:
            cw.io.run(kill(victim["address"]), timeout=10)
        except Exception:  # noqa: BLE001 - it died mid-reply: success
            pass
        print(f"killed node {victim['node_id'].hex()[:16]} "
              f"at {victim['address']}")
    return 0


def cmd_submit(args) -> int:
    import shlex

    from ray_tpu_torch import job as job_api

    entry = list(args.entrypoint)
    if entry and entry[0] == "--":  # drop only the leading separator
        entry = entry[1:]
    if not entry:
        raise SystemExit(
            "no entrypoint; usage: ray_tpu_torch submit -- cmd ...")
    runtime_env = {}
    if args.working_dir:
        runtime_env["working_dir"] = args.working_dir
    if args.env:
        runtime_env["env_vars"] = dict(e.split("=", 1) for e in args.env)
    with _attached(args):
        jid = job_api.submit_job(shlex.join(entry),
                                 runtime_env=runtime_env or None)
        print(f"submitted job {jid}")
        if not args.no_wait:
            info = job_api.wait_job(jid, timeout=24 * 3600)
            print(job_api.get_job_logs(jid))
            print(f"job {jid} finished: {info.status} {info.message}")
            return 0 if info.status == "SUCCEEDED" else 1
    return 0


def cmd_job(args) -> int:
    from dataclasses import asdict

    from ray_tpu_torch import job as job_api

    with _attached(args):
        if args.job_cmd == "list":
            print(json.dumps([asdict(j) for j in job_api.list_jobs()],
                             indent=2))
        elif args.job_cmd == "status":
            print(json.dumps(asdict(job_api.get_job_info(args.job_id)),
                             indent=2))
        elif args.job_cmd == "logs":
            print(job_api.get_job_logs(args.job_id))
        elif args.job_cmd == "stop":
            print(job_api.stop_job(args.job_id))
    return 0


if __name__ == "__main__":
    sys.exit(main())
