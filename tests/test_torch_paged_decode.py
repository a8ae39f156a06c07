"""The port's block-paged KV layout, both decoder families.

In the port, paged decoding must be a pure data-movement change: paged
generation equals dense generation bit for bit (the dense layout is its
oracle, as in the JAX package).  Against the JAX package, on the same
JAX-initialized nano weights in f32: ``paged_prefill`` and
``llama_paged_prefill``, cold and with prefix reuse (the model is
tests/test_paged_decode.py), paged decode steps, and paged greedy
generation.  Block 0 of a pool is the null block that absorbs pad
writes, whose value depends on which pad's write lands last; it is left
out of the pool comparisons.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import decode_common as jdc
from ray_tpu.models import gpt2 as jg
from ray_tpu.models import gpt2_decode as jgd
from ray_tpu.models import llama as jl
from ray_tpu.models import llama_decode as jld
from ray_tpu_torch.models import decode_common as tdc
from ray_tpu_torch.models import gpt2 as tg
from ray_tpu_torch.models import gpt2_decode as tgd
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.models import llama_decode as tld
from ray_tpu_torch.models.convert import (gpt2_params_from_numpy,
                                          llama_params_from_numpy)

# the decode tolerance of tests/test_torch_gpt2_decode.py
LOGIT_TOL = 1e-4
BS = 16  # block size under test (nano max_seq=128 -> 8 blocks a row)
FAMILIES = ("gpt2", "llama")


def _fns(mod, names):
    return {k: getattr(mod, v) for k, v in names.items()}


_GPT2 = dict(prefill="prefill", paged_prefill="paged_prefill",
             decode_step="decode_step", init_paged="init_paged_cache",
             generate="generate")
_LLAMA = dict(prefill="llama_prefill", paged_prefill="llama_paged_prefill",
              decode_step="llama_decode_step",
              init_paged="llama_init_paged_cache", generate="llama_generate")


def _family(name):
    """(jax cfg, jax params, jax fns, port cfg, port params, port fns)."""
    if name == "gpt2":
        jcfg = jg.gpt2_config("nano", dtype=jnp.float32, use_flash=False,
                              remat=False)
        jparams = jg.gpt2_init(jax.random.PRNGKey(0), jcfg)
        tcfg = tg.gpt2_config("nano", dtype=torch.float32, use_flash=False)
        tparams = gpt2_params_from_numpy(jax.tree.map(np.asarray, jparams),
                                         tcfg, "cpu")
        return (jcfg, jparams, _fns(jgd, _GPT2), tcfg, tparams,
                _fns(tgd, _GPT2))
    jcfg = jl.llama_config("nano", dtype=jnp.float32, use_flash=False)
    jparams = jl.llama_init(jax.random.PRNGKey(0), jcfg)
    tcfg = tl.llama_config("nano", dtype=torch.float32, use_flash=False)
    tparams = llama_params_from_numpy(jax.tree.map(np.asarray, jparams),
                                      tcfg, "cpu")
    return jcfg, jparams, _fns(jld, _LLAMA), tcfg, tparams, _fns(tld, _LLAMA)


@pytest.fixture(scope="module", params=FAMILIES)
def family(request):
    return _family(request.param)


def _close(got, want, tol=LOGIT_TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=tol, rtol=tol)


def _right_aligned(tokens, t_pad):
    out = np.zeros((1, t_pad), np.int32)
    out[0, t_pad - len(tokens):] = tokens
    return out


@pytest.mark.parametrize("ragged", [False, True])
def test_generate_paged_matches_dense_bitwise(family, ragged):
    *_, tcfg, tparams, t = family
    rng = np.random.RandomState(1)
    prompt = rng.randint(2, tcfg.vocab_size, (3, 9)).astype(np.int32)
    lengths = None
    if ragged:
        lengths = torch.tensor([9, 4, 1], dtype=torch.int32)
        prompt[1, :5] = 0
        prompt[2, :8] = 0
    kw = dict(max_new_tokens=8, temperature=0.0, lengths=lengths)
    dense = t["generate"](tparams, torch.from_numpy(prompt), tcfg, **kw)
    for bs in (BS, 8):
        paged = t["generate"](tparams, torch.from_numpy(prompt), tcfg,
                              kv_layout="paged", kv_block_size=bs, **kw)
        assert torch.equal(dense, paged)


def test_paged_decode_logits_equal_dense_bitwise(family):
    """Each step's logits, not only the argmax: the gathered pool view
    holds what the dense cache holds, masked lanes included."""
    *_, tcfg, tparams, t = family
    toks = torch.from_numpy(np.random.RandomState(2).randint(
        2, tcfg.vocab_size, (2, 10)).astype(np.int32))
    _, dense = t["prefill"](tparams, toks, tcfg)
    paged = tdc.dense_to_paged({k: v.clone() for k, v in dense.items()}, BS)
    step = torch.tensor([5, 7], dtype=torch.int32)
    for _ in range(5):
        ld, dense = t["decode_step"](tparams, dense, step, tcfg)
        lp, paged = t["decode_step"](tparams, paged, step, tcfg)
        assert torch.equal(ld, lp)
        step = ld.argmax(-1).to(torch.int32)


def test_paged_generate_matches_jax(family):
    jcfg, jparams, j, tcfg, tparams, t = family
    prompt = np.random.RandomState(1).randint(2, tcfg.vocab_size,
                                              (2, 9)).astype(np.int32)
    want = j["generate"](jparams, jnp.asarray(prompt), jcfg,
                         max_new_tokens=6, temperature=0.0,
                         kv_layout="paged", kv_block_size=BS)
    got = t["generate"](tparams, torch.from_numpy(prompt), tcfg,
                        max_new_tokens=6, temperature=0.0,
                        kv_layout="paged", kv_block_size=BS)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_paged_decode_steps_match_jax(family):
    jcfg, jparams, j, tcfg, tparams, t = family
    toks = np.random.RandomState(4).randint(2, tcfg.vocab_size,
                                            (2, 7)).astype(np.int32)
    lens = np.array([7, 3], np.int32)
    toks[1, :4] = 0
    _, jc = j["prefill"](jparams, jnp.asarray(toks), jcfg,
                         lengths=jnp.asarray(lens))
    _, tc = t["prefill"](tparams, torch.from_numpy(toks), tcfg,
                         lengths=torch.from_numpy(lens))
    jc, tc = jdc.dense_to_paged(jc, BS), tdc.dense_to_paged(tc, BS)
    for row in np.random.RandomState(5).randint(0, 512, (4, 2)):
        jlog, jc = j["decode_step"](jparams, jc, jnp.asarray(row, jnp.int32),
                                    jcfg)
        tlog, tc = t["decode_step"](tparams, tc,
                                    torch.from_numpy(row.astype(np.int32)),
                                    tcfg)
        _close(tlog, jlog)
    _close(tc["k"][:, 1:], jc["k"][:, 1:])
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))


def test_init_paged_cache_layout_matches_jax(family):
    jcfg, _, j, tcfg, _, t = family
    jc = j["init_paged"](jcfg, 3, num_blocks=5, block_size=BS)
    tc = t["init_paged"](tcfg, 3, num_blocks=5, block_size=BS, device="cpu")
    assert sorted(tc) == sorted(jc)
    for name in jc:
        assert tuple(tc[name].shape) == tuple(jc[name].shape), name
        assert not bool(tc[name].any())
    assert tc["block_tables"].dtype == tc["pos"].dtype == torch.int32
    with pytest.raises(ValueError, match="multiple of block_size"):
        t["init_paged"](tcfg, 1, num_blocks=2, block_size=48, device="cpu")


def test_paged_prefill_cold_matches_jax(family):
    """A whole prompt ingested cold (prefix_len 0) into a fresh pool,
    right-aligned in a bucket with pads: logits and pool against the
    JAX package's paged_prefill, and the logits against the dense
    prefill."""
    jcfg, jparams, j, tcfg, tparams, t = family
    n, t_pad = 33, 48
    prompt = np.random.RandomState(2).randint(
        2, tcfg.vocab_size, n).astype(np.int32)
    nb_row = tcfg.max_seq // BS
    toks = _right_aligned(prompt, t_pad)
    kw = dict(prefix_len=0, n_tail=n, slot=1)
    jc = j["init_paged"](jcfg, 2, num_blocks=1 + nb_row, block_size=BS)
    jlog, jc = j["paged_prefill"](
        jparams, jc, jnp.asarray(toks), jcfg,
        row_bt=jnp.arange(1, 1 + nb_row, dtype=jnp.int32), **kw)
    tc = t["init_paged"](tcfg, 2, num_blocks=1 + nb_row, block_size=BS,
                         device="cpu")
    tlog, tc = t["paged_prefill"](
        tparams, tc, torch.from_numpy(toks), tcfg,
        row_bt=torch.arange(1, 1 + nb_row, dtype=torch.int32), **kw)
    _close(tlog, jlog)
    for name in ("k", "v"):
        _close(tc[name][:, 1:], jc[name][:, 1:])
    for name in ("block_tables", "pos", "start"):
        np.testing.assert_array_equal(tc[name].numpy(),
                                      np.asarray(jc[name]))
    assert int(tc["pos"][1]) == n and int(tc["start"][1]) == 0
    want, _ = t["prefill"](tparams, torch.from_numpy(prompt[None]), tcfg,
                           lengths=torch.tensor([n], dtype=torch.int32))
    _close(tlog, want[0], tol=1e-5)


def test_paged_prefill_prefix_reuse_matches_jax(family):
    """A request whose prompt extends blocks already resident in the
    pool (written by another sequence's prefill) gives the logits of
    dense-prefilling its whole prompt, leaves the shared blocks as they
    were, and decodes from the shared pool to the greedy tokens of
    per-sequence dense generation."""
    jcfg, jparams, j, tcfg, tparams, t = family
    rng = np.random.RandomState(3)
    shared = rng.randint(2, tcfg.vocab_size, 32).astype(np.int32)
    a = np.concatenate([shared, rng.randint(2, tcfg.vocab_size, 3)
                        .astype(np.int32)])
    b = np.concatenate([shared, rng.randint(2, tcfg.vocab_size, 2)
                        .astype(np.int32)])
    nb_row = tcfg.max_seq // BS
    bt_a = np.arange(1, 1 + nb_row, dtype=np.int32)
    bt_b = np.zeros(nb_row, np.int32)
    bt_b[0], bt_b[1], bt_b[2] = 1, 2, 1 + nb_row
    steps = [
        (_right_aligned(a, 48), bt_a, dict(prefix_len=0, n_tail=len(a),
                                           slot=0)),
        (_right_aligned(b[32:], 16), bt_b, dict(prefix_len=32,
                                                n_tail=len(b) - 32,
                                                slot=1))]
    jc = j["init_paged"](jcfg, 2, num_blocks=1 + 2 * nb_row, block_size=BS)
    tc = t["init_paged"](tcfg, 2, num_blocks=1 + 2 * nb_row, block_size=BS,
                         device="cpu")
    for i, (toks, bt, kw) in enumerate(steps):
        if i == 1:
            pool_before = tc["k"].clone()
        jlog, jc = j["paged_prefill"](jparams, jc, jnp.asarray(toks), jcfg,
                                      row_bt=jnp.asarray(bt), **kw)
        tlog, tc = t["paged_prefill"](tparams, tc, torch.from_numpy(toks),
                                      tcfg, row_bt=torch.from_numpy(bt),
                                      **kw)
        _close(tlog, jlog)
    _close(tc["k"][:, 1:], jc["k"][:, 1:])
    # the shared prefix blocks were read, not rewritten
    assert torch.equal(pool_before[:, [1, 2]], tc["k"][:, [1, 2]])
    want, _ = t["prefill"](tparams, torch.from_numpy(b[None]), tcfg,
                           lengths=torch.tensor([len(b)], dtype=torch.int32))
    _close(tlog, want[0], tol=1e-5)

    # greedy decode from the shared pool, both rows stepping together,
    # against each sequence's dense generation
    new = 4
    oracle = [t["generate"](tparams, torch.from_numpy(s[None]), tcfg,
                            max_new_tokens=new, temperature=0.0
                            )[0, len(s):].tolist() for s in (a, b)]
    tok = torch.tensor([oracle[0][0], int(tlog.argmax())],
                       dtype=torch.int32)
    streams = [[], []]
    for _ in range(new):
        for r in (0, 1):
            streams[r].append(int(tok[r]))
        logits, tc = t["decode_step"](tparams, tc, tok, tcfg)
        tok = tdc.sample_token(logits, None, 0.0,
                               tdc.make_vocab_tail_mask(tcfg, "cpu"))
    assert streams == oracle


def test_dense_to_paged_structure(family):
    *_, tcfg, tparams, t = family
    toks = torch.tensor([[5, 6, 7, 8], [0, 0, 9, 10]], dtype=torch.int32)
    _, cache = t["prefill"](tparams, toks, tcfg,
                            lengths=torch.tensor([4, 2], dtype=torch.int32))
    paged = tdc.dense_to_paged(cache, BS)
    assert tdc.is_paged(paged) and not tdc.is_paged(cache)
    nb = tcfg.max_seq // BS
    heads = cache["k"].shape[3]
    assert tuple(paged["k"].shape) == (tcfg.n_layer, 1 + 2 * nb, BS, heads,
                                       tcfg.head_dim)
    np.testing.assert_array_equal(
        paged["block_tables"].numpy(),
        1 + np.arange(2 * nb, dtype=np.int32).reshape(2, nb))
    # block 0 is the null block; each row's blocks, gathered in table
    # order, are its dense cache exactly
    assert not bool(paged["k"][:, 0].any())
    for row in range(2):
        for name in ("k", "v"):
            view = paged[name][:, paged["block_tables"][row].long()]
            assert torch.equal(view.reshape(cache[name][:, row].shape),
                               cache[name][:, row])
    assert paged["pos"] is cache["pos"] and paged["start"] is cache["start"]
    with pytest.raises(ValueError, match="multiple of block_size"):
        tdc.dense_to_paged(cache, 48)


def test_copy_block_copies_all_layers(family):
    *_, tcfg, _, t = family
    cache = t["init_paged"](tcfg, 1, num_blocks=4, block_size=BS,
                            device="cpu")
    cache["k"][:, 1] = 1.5
    cache["v"][:, 1] = -2.5
    out = tdc.copy_block(cache, 1, torch.tensor(3, dtype=torch.int32))
    assert out is cache                          # in place
    assert bool((out["k"][:, 3] == 1.5).all())
    assert bool((out["v"][:, 3] == -2.5).all())
    # source and unrelated blocks untouched
    assert bool((out["k"][:, 1] == 1.5).all())
    assert not bool(out["k"][:, 2].any()) and not bool(out["v"][:, 0].any())


def test_paged_update_and_view_matches_jax():
    rng = np.random.RandomState(6)
    layer = rng.standard_normal((5, 4, 2, 3)).astype(np.float32)
    bt = np.array([[1, 2], [4, 3]], np.int32)
    pos = np.array([5, 2], np.int32)
    new = rng.standard_normal((2, 2, 3)).astype(np.float32)
    jlayer, jview = jdc.paged_update_and_view(
        jnp.asarray(layer), jnp.asarray(bt), jnp.asarray(pos),
        jnp.asarray(new))
    tlayer, tview = tdc.paged_update_and_view(
        torch.from_numpy(layer.copy()), torch.from_numpy(bt),
        torch.from_numpy(pos), torch.from_numpy(new))
    np.testing.assert_array_equal(tlayer.numpy(), np.asarray(jlayer))
    np.testing.assert_array_equal(tview.numpy(), np.asarray(jview))
