"""The port's LM engine end to end against the JAX package's generate.

JAX-initialized GPT-2 nano parameters are pickled as numpy, the port's
engine loads them through ``checkpoint_path`` on the CPU, and every
reply must equal JAX ``generate`` on the same prompts, token for token
(greedy, f32).
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


def _engine(path, **kw):
    cls = build_llm_deployment(
        "gpt2", "nano", max_new_tokens=MAX_NEW, temperature=0.0,
        max_batch_size=4, batch_wait_timeout_s=0.05, checkpoint_path=path,
        device="cpu", config_overrides={"dtype": torch.float32}, **kw)
    return cls()


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
    {"family": "llama"}, {"scheduler": "continuous"},
    {"kv_layout": "paged"}, {"spec_decode": object()},
    {"role": "prefill"}, {"mesh": object()}])
def test_options_not_ported_yet_name_their_roadmap_item(kw):
    kw = {"family": "gpt2", **kw}
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1"):
        build_llm_deployment(preset="nano", device="cpu", **kw)


def test_default_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_llm_deployment("gpt2", "nano")


def test_fresh_init_engine_serves_from_seed():
    cls = build_llm_deployment("gpt2", "nano", max_new_tokens=3, seed=5,
                               device="cpu")
    a, b = cls(), cls()
    prompt = np.arange(6, dtype=np.int32)
    out_a = asyncio.run(a(prompt))
    np.testing.assert_array_equal(out_a[:6], prompt)
    # the same seed gives the same weights, so the same greedy reply
    np.testing.assert_array_equal(asyncio.run(b(prompt)), out_a)
