"""The port's LM engine end to end against the JAX package's generate.

JAX-initialized GPT-2 nano and llama nano parameters are pickled as
numpy, the port's engine loads them through ``checkpoint_path`` on the
CPU, and every reply must equal JAX ``generate`` (``llama_generate``)
on the same prompts, token for token (greedy, f32).
"""

import asyncio
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import gpt2 as jgpt2
from ray_tpu.models import gpt2_decode as jdec
from ray_tpu.models import llama as jllama
from ray_tpu.models import llama_decode as jldec
from ray_tpu.serve import llm as jllm
from ray_tpu_torch.serve import build_llm_deployment

MAX_NEW = 5


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    cfg = jgpt2.gpt2_config("nano", dtype=jnp.float32, use_flash=False,
                            remat=False)
    params = jgpt2.gpt2_init(jax.random.PRNGKey(3), cfg)
    path = tmp_path_factory.mktemp("ckpt") / "gpt2_nano.pkl"
    with open(path, "wb") as f:
        pickle.dump(jax.tree.map(np.asarray, params), f)
    return str(path), cfg, params


@pytest.fixture(scope="module")
def llama_checkpoint(tmp_path_factory):
    cfg = jllama.llama_config("nano", dtype=jnp.float32, use_flash=False)
    params = jllama.llama_init(jax.random.PRNGKey(4), cfg)
    path = tmp_path_factory.mktemp("ckpt") / "llama_nano.pkl"
    with open(path, "wb") as f:
        pickle.dump(jax.tree.map(np.asarray, params), f)
    return str(path), cfg, params


def _engine(path, family="gpt2", **kw):
    cls = build_llm_deployment(
        family, "nano", max_new_tokens=MAX_NEW, temperature=0.0,
        max_batch_size=4, batch_wait_timeout_s=0.05, checkpoint_path=path,
        device="cpu", config_overrides={"dtype": torch.float32}, **kw)
    return cls.func_or_class()


async def _serve(engine, prompts):
    return await asyncio.gather(*(engine(p) for p in prompts))


def test_equal_length_requests_match_jax_generate(checkpoint):
    path, cfg, params = checkpoint
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, 512, size=9, dtype=np.int32)
               for _ in range(4)]
    outs = asyncio.run(_serve(_engine(path), prompts))
    want = np.asarray(jdec.generate(params, jnp.asarray(np.stack(prompts)),
                                    cfg, max_new_tokens=MAX_NEW,
                                    temperature=0.0))
    for got, row in zip(outs, want):
        assert got.dtype == np.int32 and got.shape == (9 + MAX_NEW,)
        np.testing.assert_array_equal(got, row)


def test_ragged_batch_matches_jax_generate(checkpoint):
    path, cfg, params = checkpoint
    rng = np.random.default_rng(12)
    lens = [10, 4, 7]
    prompts = [rng.integers(0, 512, size=n, dtype=np.int32) for n in lens]
    outs = asyncio.run(_serve(_engine(path), prompts))
    t0 = max(lens)
    padded = np.zeros((3, t0), np.int32)
    for i, p in enumerate(prompts):
        padded[i, t0 - len(p):] = p
    want = np.asarray(jdec.generate(
        params, jnp.asarray(padded), cfg, max_new_tokens=MAX_NEW,
        temperature=0.0, lengths=jnp.asarray(lens, jnp.int32)))
    for got, row, p in zip(outs, want, prompts):
        np.testing.assert_array_equal(got[:len(p)], p)
        np.testing.assert_array_equal(got, row[t0 - len(p):])


def _left_padded(prompts):
    t0 = max(len(p) for p in prompts)
    padded = np.zeros((len(prompts), t0), np.int32)
    for i, p in enumerate(prompts):
        padded[i, t0 - len(p):] = p
    return padded


@pytest.mark.parametrize("lens", [[9, 9, 9, 9], [10, 4, 7]],
                         ids=["equal", "ragged"])
def test_llama_engine_matches_jax_llama_generate(llama_checkpoint, lens):
    """family="llama" serves the JAX weights through checkpoint_path:
    every reply is JAX llama_generate's greedy continuation of its
    prompt (ragged batches left-padded, as the engine pads them)."""
    path, cfg, params = llama_checkpoint
    rng = np.random.default_rng(13)
    prompts = [rng.integers(0, 512, size=n, dtype=np.int32) for n in lens]
    engine = _engine(path, family="llama")
    outs = asyncio.run(_serve(engine, prompts))
    padded = _left_padded(prompts)
    ragged = len(set(lens)) > 1
    want = np.asarray(jldec.llama_generate(
        params, jnp.asarray(padded), cfg, max_new_tokens=MAX_NEW,
        temperature=0.0,
        lengths=jnp.asarray(lens, jnp.int32) if ragged else None))
    t0 = padded.shape[1]
    for got, row, p in zip(outs, want, prompts):
        assert got.dtype == np.int32 and got.shape == (len(p) + MAX_NEW,)
        np.testing.assert_array_equal(got[:len(p)], p)
        np.testing.assert_array_equal(got, row[t0 - len(p):])


def test_llama_fresh_init_engine_serves_from_seed():
    cls = build_llm_deployment("llama", "nano", max_new_tokens=3, seed=5,
                               device="cpu",
                               config_overrides={"n_kv_head": 2})
    a, b = cls.func_or_class(), cls.func_or_class()
    assert a.cfg.n_kv_head == 2 and a.cfg.max_seq == 128
    prompt = np.arange(6, dtype=np.int32)
    out_a = asyncio.run(a(prompt))
    np.testing.assert_array_equal(out_a[:6], prompt)
    np.testing.assert_array_equal(asyncio.run(b(prompt)), out_a)


def test_llama_checkpoint_of_the_wrong_family_is_rejected(checkpoint):
    path = checkpoint[0]                 # a GPT-2 tree
    with pytest.raises(ValueError, match="llama params"):
        _engine(path, family="llama")


def test_oversized_prompt_raises(checkpoint):
    path, cfg, _ = checkpoint
    engine = _engine(path)
    too_long = np.zeros(cfg.max_seq - MAX_NEW + 1, np.int32)
    with pytest.raises(ValueError, match="prompt length"):
        asyncio.run(engine(too_long))
    with pytest.raises(ValueError, match="prompt length"):
        asyncio.run(engine(np.zeros(0, np.int32)))


def test_unknown_family_raises():
    with pytest.raises(ValueError, match="unknown LM family"):
        build_llm_deployment("bert", "nano", device="cpu")


@pytest.mark.parametrize("kw", [
    {"scheduler": "continuous", "mesh": object()},
    {"num_replicas": 2}])
def test_options_not_ported_yet_name_their_roadmap_item(kw):
    """What the reference accepts the port accepts: a mesh (its serving
    is held on gloo ranks in tests/test_torch_sharded_decode.py) and
    ``num_replicas=2``, recorded on the returned Deployment, as the
    reference does: its name and replica count equal the reference's.
    The engine reads the mesh when it is built, as the reference's
    does."""
    kw = {"family": "gpt2", **kw}
    dep = build_llm_deployment(preset="nano", device="cpu", **kw)
    ref = jllm.build_llm_deployment(preset="nano", **kw)
    assert (dep.name, dep.num_replicas) == (ref.name, ref.num_replicas) \
        == ("llm_gpt2_nano", kw.get("num_replicas", 1))
    assert isinstance(dep.func_or_class, type)


@pytest.mark.parametrize("kw", [
    {"scheduler": "continuous", "kv_layout": "paged", "role": "prefill"},
    {"scheduler": "continuous", "kv_layout": "paged", "role": "prefill",
     "handoff_staged": True},
    {"scheduler": "continuous", "kv_layout": "paged", "role": "decode"}])
def test_roles_serve(kw):
    """The roles that once raised NotImplementedError serve: the
    engine of ``kw`` and its counterpart role (the same staging) answer
    a request together, the prefill engine with a HandoffCursor that
    the decode engine's admit_prefilled turns into the prompt and
    max_new_tokens more tokens."""
    from ray_tpu_torch.serve.batching import HandoffCursor

    other = "decode" if kw["role"] == "prefill" else "prefill"
    engines = {kw["role"]: build_llm_deployment(
        "gpt2", "nano", device="cpu", max_new_tokens=3, **kw).func_or_class()}
    engines[other] = build_llm_deployment(
        "gpt2", "nano", device="cpu", max_new_tokens=3,
        **dict(kw, role=other)).func_or_class()
    prompt = np.arange(40, dtype=np.int32)

    async def main():
        try:
            pkg = await engines["prefill"](prompt)
            assert isinstance(pkg, HandoffCursor)
            return await engines["decode"].admit_prefilled(pkg)
        finally:
            for e in engines.values():
                e.shutdown_engine()

    out = asyncio.run(main())
    assert out.dtype == np.int32 and out.shape == (43,)
    np.testing.assert_array_equal(out[:40], prompt)


@pytest.mark.parametrize("kw", [
    {"scheduler": "continuous"},
    {"scheduler": "continuous", "kv_layout": "paged"},
    {"scheduler": "continuous", "kv_layout": "paged",
     "kv_host_tier_bytes": 1 << 20},
    {"scheduler": "continuous", "kv_layout": "paged",
     "prefill_chunk_tokens": 32},
    {"family": "llama", "scheduler": "continuous", "kv_layout": "paged"},
    {"scheduler": "continuous", "kv_layout": "paged",
     "admission_policy": "queue"},
    {"scheduler": "continuous", "slo": "generous"}])
def test_continuous_options_serve(kw):
    """The continuous scheduler's options that once raised
    NotImplementedError serve: a fresh-init engine answers a request
    with its prompt and max_new_tokens more tokens (the admission
    policy and the SLO among them)."""
    from ray_tpu_torch.serve.batching import AdmissionPolicy
    from ray_tpu_torch.serve.slo import SLOConfig

    kw = {"family": "gpt2", **kw}
    if "admission_policy" in kw:
        kw["admission_policy"] = AdmissionPolicy(max_queue_depth=8)
    if "slo" in kw:
        kw["slo"] = SLOConfig(ttft_ms=60_000.0)
    engine = build_llm_deployment(preset="nano", device="cpu",
                                  max_new_tokens=3, **kw).func_or_class()
    prompt = np.arange(40, dtype=np.int32)

    async def main():
        try:
            return await engine(prompt)
        finally:
            engine.shutdown_engine()

    out = asyncio.run(main())
    assert out.dtype == np.int32 and out.shape == (43,)
    np.testing.assert_array_equal(out[:40], prompt)


@pytest.mark.parametrize("kw,match", [
    ({"stop_sequences": [[5, 6], []]}, "empty stop sequence"),
    ({"kv_host_tier_bytes": 1 << 20}, "kv_host_tier_bytes requires"),
    ({"prefill_chunk_tokens": 32}, "prefill_chunk_tokens requires"),
    ({"handoff_staged": True}, "handoff_staged only applies"),
    ({"slo": object()}, "slo must be a serve.slo.SLOConfig"),
    ({"num_replicas": 0}, "num_replicas must be a positive int"),
    ({"kv_layout": "paged"}, "kv_layout='paged' requires"),
    ({"spec_decode": object()}, "spec_decode must be a SpecConfig"),
    ({"role": "prefill"}, "role='prefill' requires scheduler"),
    ({"mesh": object()}, "mesh-sharded serving requires"),
    ({"kv_layout": "paged", "kv_host_tier_bytes": 1 << 20},
     "kv_layout='paged' requires"),
    ({"kv_layout": "paged", "prefill_chunk_tokens": 32},
     "kv_layout='paged' requires"),
    ({"role": "prefill", "handoff_staged": True},
     "role='prefill' requires scheduler"),
    ({"scheduler": "continuous", "role": "decode"},
     "role='decode' requires kv_layout='paged'"),
    ({"scheduler": "continuous", "kv_layout": "paged",
      "prefill_chunk_tokens": 20}, "positive multiple of kv_block_size"),
    ({"role": "both!"}, "unknown role")])
def test_batch_scheduler_rejects_what_the_reference_rejects(kw, match):
    """The combinations ray_tpu/serve/llm.py rejects with ValueError under
    scheduler="batch" raise the same here."""
    with pytest.raises(ValueError, match=match):
        build_llm_deployment("gpt2", "nano", device="cpu", **kw)


@pytest.mark.parametrize("kw", [
    {"kv_layout": "paged"}, {"role": "prefill"}, {"mesh": object()},
    {"kv_layout": "paged", "role": "decode", "mesh": object()},
    {"role": "decode", "mesh": object(), "handoff_staged": True},
    {"kv_layout": "paged", "prefill_chunk_tokens": 32},
    {"prefill_chunk_tokens": 32, "kv_host_tier_bytes": 1 << 20},
    {"scheduler": "continuous", "kv_layout": "paged",
     "kv_host_tier_bytes": 0},
    {"family": "llama", "kv_layout": "paged", "spec_decode": object()},
    {"spec_decode": object()}, {"slo": 0.5},
    {"scheduler": "continuous", "spec_decode": object()},
    {"scheduler": "continuous", "kv_layout": "paged",
     "spec_decode": object()},
    {"scheduler": "continuous", "slo": object()}])
def test_batch_scheduler_rejections_match_the_reference_messages(kw):
    """Where the reference raises ValueError, the port raises the same
    message: the same check first when several apply."""
    kw = {"family": "gpt2", "preset": "nano", **kw}
    with pytest.raises(ValueError) as want:
        jllm.build_llm_deployment(**kw)
    with pytest.raises(ValueError) as got:
        build_llm_deployment(device="cpu", **kw)
    assert str(got.value) == str(want.value)


def test_batch_scheduler_slo_matches_the_reference_message():
    """An SLOConfig (each package's own) with the batch scheduler: the
    reference's ValueError, message for message."""
    from ray_tpu.serve.slo import SLOConfig as JSLOConfig
    from ray_tpu_torch.serve.slo import SLOConfig

    with pytest.raises(ValueError) as want:
        jllm.build_llm_deployment("gpt2", "nano",
                                  slo=JSLOConfig(ttft_ms=1.0))
    with pytest.raises(ValueError) as got:
        build_llm_deployment("gpt2", "nano", device="cpu",
                             slo=SLOConfig(ttft_ms=1.0))
    assert str(got.value) == str(want.value)
    assert "slo requires scheduler='continuous'" in str(got.value)


def test_roadmap_message_names_what_is_left_of_telemetry():
    """Both halves of the telemetry are ported, and so are the fleet
    (item 5) and the mesh (item 7.7b): no serving option is left to
    raise naming a ROADMAP item, and build_train_step(telemetry=True)
    builds the wrapped step."""
    import ray_tpu_torch.serve.llm as tllm
    from ray_tpu_torch.train import build_train_step

    assert not hasattr(tllm, "_ROADMAP_ITEM")
    assert not hasattr(tllm, "_not_ported")
    step = build_train_step(lambda p, b: p, None, telemetry=True)
    assert step.goodput.name == "jax_trainer"


def test_continuous_only_keywords_are_ignored_by_the_batch_scheduler():
    """stop_sequences, eos_id and the slot/KV/admission knobs are the
    continuous scheduler's: under "batch" they are accepted, as by the
    reference, and the greedy reply is the one without them."""
    kw = dict(max_new_tokens=3, seed=5, device="cpu")
    plain = build_llm_deployment("gpt2", "nano", **kw).func_or_class()
    knobs = build_llm_deployment(
        "gpt2", "nano", stop_sequences=[[1, 2]], eos_id=0, num_replicas=1,
        max_slots=2, prefill_bucket=8, kv_block_size=8, kv_num_blocks=64,
        admission_policy=object(), **kw).func_or_class()
    prompt = np.arange(6, dtype=np.int32)
    np.testing.assert_array_equal(asyncio.run(knobs(prompt)),
                                  asyncio.run(plain(prompt)))


def test_default_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_llm_deployment("gpt2", "nano")


def test_fresh_init_engine_serves_from_seed():
    cls = build_llm_deployment("gpt2", "nano", max_new_tokens=3, seed=5,
                               device="cpu")
    a, b = cls.func_or_class(), cls.func_or_class()
    prompt = np.arange(6, dtype=np.int32)
    out_a = asyncio.run(a(prompt))
    np.testing.assert_array_equal(out_a[:6], prompt)
    # the same seed gives the same weights, so the same greedy reply
    np.testing.assert_array_equal(asyncio.run(b(prompt)), out_a)
