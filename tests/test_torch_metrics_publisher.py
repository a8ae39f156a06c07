"""The port's metrics publisher and ``collect_cluster_metrics`` against
the JAX package's.

Mirrors tests/test_metrics_prom.py: the same metrics observed the same
way in both packages give, through each package's snapshot, msgpack
blob (the JAX package's msgpack, the port's vendored copy) and
collector, the same Prometheus lines: names, types, labels and
histogram suffixes.  Name checks and the duplicate warning behave
alike.  End to end, a worker of each runtime registers and observes
metrics and its publisher thread pushes them into the GCS KV, where the
driver's collector finds the same lines as the JAX package's, worker
ids aside; the port's publishing worker has no torch in sys.modules.
"""

import re
import sys
import time
import warnings

import msgpack
import pytest

import ray_tpu
import ray_tpu_torch
from ray_tpu.util import metrics as jmetrics
from ray_tpu_torch._private._vendor import cloudpickle as port_cloudpickle
from ray_tpu_torch._private._vendor import msgpack as port_msgpack
from ray_tpu_torch.util import metrics as tmetrics
# autouse: the JAX runtime's loops settle before they stop
from tests.test_torch_jax_teardown import settle_jax_loops  # noqa: F401

port_cloudpickle.register_pickle_by_value(sys.modules[__name__])

SIDES = {"jax": (jmetrics, msgpack), "torch": (tmetrics, port_msgpack)}


def _exposition(side, names, max_age_s=60.0, ts=None):
    """Round-trip the named metrics of a package's registry through its
    msgpack blob and collector, as a dashboard's /metrics page would."""
    mod, codec = SIDES[side]
    snap = {n: d for n, d in mod._registry.snapshot().items() if n in names}
    kv = {"metrics:promgoldworker01": codec.packb(
        {"ts": time.time() if ts is None else ts, "metrics": snap})}
    return mod.collect_cluster_metrics(
        kv.get, lambda prefix: [k for k in kv if k.startswith(prefix)],
        max_age_s=max_age_s)


def _observe_golden(mod, suffix):
    h = mod.Histogram(f"pub_gold_latency_ms_{suffix}", "golden latency",
                      boundaries=[1.0, 5.0, 25.0, 100.0],
                      tag_keys=("route",))
    for v in (3.0, 3.0, 60.0, 500.0):
        h.observe(v, tags={"route": "/a"})
    h.observe(0.5, tags={"route": "/b"})
    c = mod.Counter(f"pub_gold_reqs_total_{suffix}", "golden requests")
    c.inc(7)
    g = mod.Gauge(f"pub_gold_depth_{suffix}", "golden depth",
                  tag_keys=("q",)).set_default_tags({"q": "main"})
    g.set(4)
    g.set(2, tags={"q": "side"})
    mod.Histogram(f"pub_gold_empty_ms_{suffix}", "never observed",
                  boundaries=[0.5, 2.0])
    return [m.name for m in (h, c, g)] + [f"pub_gold_empty_ms_{suffix}"]


def test_exposition_lines_match_jax():
    want = _exposition("jax", _observe_golden(jmetrics, "x"))
    got = _exposition("torch", _observe_golden(tmetrics, "x"))
    assert got == want
    text = "\n".join(got)
    full = "raytpu_app_pub_gold_latency_ms_x"
    assert text.count(f"# TYPE {full} histogram") == 1
    assert text.count("# TYPE raytpu_app_pub_gold_reqs_total_x counter") == 1
    assert text.count("# TYPE raytpu_app_pub_gold_depth_x gauge") == 1
    # every boundary zero-filled, cumulative, +Inf, _sum and _count
    series = [float(re.search(
        rf'{full}_bucket{{worker="promgoldwork",le="{re.escape(le)}",'
        rf'route="/a"}} ([0-9.]+)', text).group(1))
        for le in ("1.0", "5.0", "25.0", "100.0", "+Inf")]
    assert series == [0.0, 2.0, 2.0, 3.0, 4.0]
    assert f'{full}_sum{{worker="promgoldwork",route="/a"}} 566.0' in text
    assert f'{full}_count{{worker="promgoldwork",route="/b"}} 1.0' in text
    assert 'raytpu_app_pub_gold_empty_ms_x_count{worker="promgoldwork"} ' \
        '0.0' in text


def test_stale_snapshot_is_skipped_alike():
    names = {"jax": _observe_golden(jmetrics, "stale"),
             "torch": _observe_golden(tmetrics, "stale")}
    old = time.time() - 120.0
    for side in SIDES:
        assert _exposition(side, names[side], ts=old) == []
        assert _exposition(side, names[side], ts=old,
                           max_age_s=300.0) != []


def test_histogram_dump_matches_jax():
    dumps = {}
    for side, (mod, _) in SIDES.items():
        h = mod.Histogram("pub_gold_multi_ms", "two tag sets",
                          boundaries=[1.0, 10.0], tag_keys=("k",))
        h.observe(0.5, tags={"k": "x"})
        h.observe(100.0, tags={"k": "y"})
        dumps[side] = h._dump()
    assert dumps["torch"] == dumps["jax"]
    assert len(dumps["torch"]["values"]) == 2 * 5


@pytest.mark.parametrize("name", ["Bad", "1starts_with_digit", "has-dash",
                                  "has space", "", "raytpu_app_UPPER"])
def test_invalid_names_raise_alike(name):
    msgs = []
    for mod, _ in SIDES.values():
        with pytest.raises(ValueError, match="invalid metric name") as e:
            mod.Gauge(name, "nope")
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_duplicate_registration_warns_once_newest_wins():
    for mod, _ in SIDES.values():
        g1 = mod.Gauge("pub_guard_dup_gauge", "first")
        with pytest.warns(RuntimeWarning, match="registered more than once"):
            g2 = mod.Gauge("pub_guard_dup_gauge", "second")
        assert mod._registry.metrics["pub_guard_dup_gauge"] is g2
        g1.set(1.0)
        g2.set(2.0)
        snap = mod._registry.snapshot()
        assert snap["pub_guard_dup_gauge"]["values"][0][1] == 2.0
        with warnings.catch_warnings():
            warnings.simplefilter("error", RuntimeWarning)
            mod.Gauge("pub_guard_dup_gauge", "third")
            mod._registry.register(g2)


# ---- end to end: a worker's publisher, the driver's collector ---------

def _publish_in_worker(pkg: str) -> dict:
    """In a worker: register and observe metrics with a short publish
    interval, wait for one publish, and report the worker's id and the
    heavy modules its process holds."""
    import importlib
    import os

    mod = importlib.import_module(f"{pkg}.util.metrics")
    mod._PUBLISH_INTERVAL_S = 0.2
    h = mod.Histogram("pub_e2e_ms", "end to end", boundaries=[1.0, 10.0],
                      tag_keys=("route",))
    h.observe(4.0, tags={"route": "/e2e"})
    mod.Counter("pub_e2e_total", "end to end").inc(3)
    # a fresh worker's publisher starts with the first registration,
    # after the interval was set: it publishes within 0.2 s
    time.sleep(1.0)
    return {"worker": os.environ["RAYTPU_WORKER_ID"],
            "heavy": sorted({m.split(".")[0] for m in sys.modules}
                            & {"torch", "jax", "jaxlib"})}


def _e2e(rt, pkg):
    import importlib

    from_worker = rt.get(rt.remote(_publish_in_worker).remote(pkg),
                         timeout=120)
    wc = importlib.import_module(f"{pkg}._private.worker_context")
    mod = importlib.import_module(f"{pkg}.util.metrics")
    cw = wc.core_worker()
    label = f'worker="{from_worker["worker"][:12]}"'
    deadline = time.monotonic() + 15
    lines = []
    while time.monotonic() < deadline:
        lines = [ln for ln in mod.collect_cluster_metrics(cw.kv_get,
                                                          cw.kv_keys)
                 if "pub_e2e_" in ln and (label in ln or ln.startswith("#"))]
        if any(label in ln for ln in lines):
            break
        time.sleep(0.2)
    return from_worker, [ln.replace(label, 'worker="W"') for ln in lines]


def test_worker_publishes_to_the_collector_like_jax():
    ray_tpu.init(num_cpus=1, object_store_memory=64 * 1024 * 1024,
                 log_to_driver=False)
    ray_tpu_torch.init(num_cpus=1, num_gpus=0,
                       object_store_memory=64 * 1024 * 1024,
                       log_to_driver=False)
    try:
        jw, want = _e2e(ray_tpu, "ray_tpu")
        tw, got = _e2e(ray_tpu_torch, "ray_tpu_torch")
    finally:
        ray_tpu_torch.shutdown()
        ray_tpu.shutdown()
    assert got == want
    assert 'raytpu_app_pub_e2e_total{worker="W"} 3.0' in got
    assert 'raytpu_app_pub_e2e_ms_count{worker="W",route="/e2e"} 1.0' in got
    # the port's publishing worker holds neither torch nor jax
    assert tw["heavy"] == []
