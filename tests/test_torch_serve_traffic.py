"""The port's seeded traffic (``ray_tpu_torch/serve/traffic.py``)
against the JAX package's.

One seed must give the JAX package's requests bit for bit (arrival
offsets, prompts, prefix groups, tenants), for a plain spec, a
two-tenant mixture, a long-prompt tenant and a cache-churn tenant; the
spec validation raises the same messages; and ``run_traffic`` /
``run_traffic_fleet`` at nano with every request fired at once return
the JAX reports' keys.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from ray_tpu.serve import traffic as jtraffic  # noqa: E402
from ray_tpu_torch.serve import traffic as ttraffic  # noqa: E402


def _spec(mod, name):
    T = mod.TenantSpec
    base = dict(num_requests=24, seed=3, rate_rps=40.0,
                num_prefix_groups=3, prefix_len=32, p_shared=0.6,
                tail_len_mean=6.0, tail_len_max=16, vocab=500)
    tenants = {
        "plain": (),
        "two_tenants": (T("interactive", rate_share=1.0,
                          prefix_groups=(0,), ttft_slo_ms=50.0),
                        T("batch", rate_share=2.0, slo_class="batch",
                          prefix_groups=(1, 2))),
        "prompt_len": (T("interactive", rate_share=1.0),
                       T("batch", rate_share=1.0, slo_class="batch",
                         prompt_len=40)),
        "prefix_pool": (T("interactive", rate_share=1.0),
                        T("churn", rate_share=1.0, slo_class="batch",
                          prefix_pool=5)),
    }[name]
    return mod.TrafficSpec(**base, tenants=tenants)


@pytest.mark.parametrize("name", ["plain", "two_tenants", "prompt_len",
                                  "prefix_pool"])
def test_generator_equals_jax_bit_for_bit(name):
    got = ttraffic.TrafficGenerator(_spec(ttraffic, name)).requests()
    want = jtraffic.TrafficGenerator(_spec(jtraffic, name)).requests()
    assert len(got) == len(want) == 24
    for g, w in zip(got, want):
        assert g.arrival_s == w.arrival_s
        assert g.prompt.dtype == w.prompt.dtype == np.int32
        np.testing.assert_array_equal(g.prompt, w.prompt)
        assert (g.group, g.tenant) == (w.group, w.tenant)
    # a second call replays the same stream
    again = ttraffic.TrafficGenerator(_spec(ttraffic, name)).requests()
    assert all(np.array_equal(a.prompt, b.prompt)
               for a, b in zip(got, again))
    if name != "plain":
        assert {r.tenant for r in got} == {
            t.name for t in _spec(ttraffic, name).tenants}
    if name == "prefix_pool":
        assert any(r.group <= -2 for r in got)


def _error(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


@pytest.mark.parametrize("case", [
    ("spec", dict(num_requests=0)), ("spec", dict(rate_rps=0.0)),
    ("spec", dict(p_shared=1.5)), ("dup", {}), ("group", {}),
    ("tenant", dict(rate_share=0.0)), ("tenant", dict(prompt_len=0)),
    ("tenant", dict(prefix_pool=0)),
    ("tenant", dict(prefix_pool=2, prefix_groups=(0,))),
    ("tenant", dict(slo_class="gold"))],
    ids=["requests", "rate", "p_shared", "duplicate", "group_range",
         "share", "prompt_len", "pool", "pool_and_groups", "class"])
def test_spec_validation_messages_equal_jax(case):
    kind, kw = case

    def make(mod):
        if kind == "spec":
            return mod.TrafficSpec(**kw)
        if kind == "dup":
            return mod.TrafficSpec(tenants=(mod.TenantSpec("a"),
                                            mod.TenantSpec("a")))
        if kind == "group":
            return mod.TrafficSpec(num_prefix_groups=2, tenants=(
                mod.TenantSpec("a", prefix_groups=(2,)),))
        return mod.TenantSpec("t", **kw)

    assert _error(lambda: make(ttraffic)) == _error(lambda: make(jtraffic))


def test_tenant_spec_maps_to_the_router_class():
    got = ttraffic.TenantSpec("i", ttft_slo_ms=5.0).to_class()
    want = jtraffic.TenantSpec("i", ttft_slo_ms=5.0).to_class()
    assert (got.name, got.weight, got.ttft_ms, got.objective) == \
        (want.name, want.weight, want.ttft_ms, want.objective) == \
        ("i", 8.0, 5.0, 0.95)


def _traffic(mod):
    return mod.TrafficSpec(
        num_requests=6, seed=0, num_prefix_groups=2, prefix_len=32,
        p_shared=0.5, tail_len_mean=6.0, tail_len_max=12, vocab=500,
        tenants=(mod.TenantSpec("interactive", ttft_slo_ms=1e6),
                 mod.TenantSpec("batch", slo_class="batch")))


_KW = dict(family="gpt2", preset="nano", max_slots=2, max_new_tokens=4,
           time_scale=0.0)
_TORCH = dict(config_overrides={"dtype": torch.float32}, device="cpu")
_JAX = dict(config_overrides={"dtype": jnp.float32, "use_flash": False})


def test_run_traffic_report_keys_equal_jax():
    got = ttraffic.run_traffic(_traffic(ttraffic), **_KW, **_TORCH)
    want = jtraffic.run_traffic(_traffic(jtraffic), **_KW, **_JAX)
    assert set(got) == set(want)
    assert set(got["engine"]) == set(want["engine"])
    assert got["completed"] == want["completed"] == 6
    assert got["spec"] == want["spec"]
    assert got["prefix_hit_rate"] == want["prefix_hit_rate"]


def test_run_traffic_fleet_report_keys_equal_jax(tmp_path):
    dump = str(tmp_path / "fleet.json")
    got = ttraffic.run_traffic_fleet(_traffic(ttraffic), **_KW, **_TORCH,
                                     trace_dump=dump)
    want = jtraffic.run_traffic_fleet(_traffic(jtraffic), **_KW, **_JAX)
    assert set(got) == set(want)
    assert set(got["fleet"]) == set(want["fleet"])
    assert set(got["tenant_slo_attainment"]) == \
        set(want["tenant_slo_attainment"]) == {
            "interactive_ttft_slo_attainment"}
    assert got["completed"] == want["completed"] == 6
    from ray_tpu_torch.tools import tracebus

    doc = tracebus.load_dump(dump)
    assert len(doc["requests"]) == 6 and "router" in doc["flightrec"]


def test_a_mesh_raises_the_ports_item_7_error():
    """run_traffic hands its mesh to the engine (served on 2 gloo ranks
    in tests/test_torch_sharded_decode.py): what is no mesh fails at
    the engine's construction, as in the reference."""
    with pytest.raises(AttributeError):
        jtraffic.run_traffic(_traffic(jtraffic), mesh=object(), **_KW,
                             **_JAX)
    with pytest.raises(AttributeError):
        ttraffic.run_traffic(_traffic(ttraffic), mesh=object(), **_KW,
                             **_TORCH)
