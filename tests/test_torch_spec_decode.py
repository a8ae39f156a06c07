"""Speculative decoding in the port against the JAX package's.

Function level: ``spec_accept`` (greedy token for token; sampled by
distribution, since a ``torch.Generator`` and ``jax.random`` draw
different numbers), ``verify_step``/``llama_verify_step`` (logits and
the cache after, both layouts, a block crossing max_seq included),
``make_spec_verify``, ``make_draft_propose`` and ``ngram_propose``, fed
the same seeded numpy inputs as their JAX counterparts, on JAX-
initialized nano weights in f32.  The engine's spec decoding is
``tests/test_torch_serve_spec.py``.
"""

import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from ray_tpu.models import decode_common as jdc  # noqa: E402
from ray_tpu.models import gpt2 as jg  # noqa: E402
from ray_tpu.models import gpt2_decode as jgd  # noqa: E402
from ray_tpu.models import llama as jl  # noqa: E402
from ray_tpu.models import llama_decode as jld  # noqa: E402
from ray_tpu_torch.models import decode_common as tdc  # noqa: E402
from ray_tpu_torch.models import gpt2 as tg  # noqa: E402
from ray_tpu_torch.models import gpt2_decode as tgd  # noqa: E402
from ray_tpu_torch.models import llama as tl  # noqa: E402
from ray_tpu_torch.models import llama_decode as tld  # noqa: E402
from ray_tpu_torch.models.convert import (  # noqa: E402
    gpt2_params_from_numpy, llama_params_from_numpy)

# the decode tolerance of tests/test_torch_gpt2_decode.py (f32)
LOGIT_TOL = 1e-4
FAMILIES = ("gpt2", "llama")
K = 4
_JOVR = {"dtype": jnp.float32, "use_flash": False, "remat": False}


@functools.lru_cache(maxsize=None)
def _family(name):
    """(jax cfg, jax params, port cfg, port params, jax module, port
    module, {fn role: name})."""
    if name == "gpt2":
        jcfg = jg.gpt2_config("nano", **_JOVR)
        jparams = jg.gpt2_init(jax.random.PRNGKey(0), jcfg)
        tree = jax.tree.map(np.asarray, jparams)
        tcfg = tg.gpt2_config("nano", dtype=torch.float32, use_flash=False)
        return (jcfg, jparams, tcfg, gpt2_params_from_numpy(tree, tcfg, "cpu"),
                jgd, tgd, dict(verify="verify_step", step="decode_step",
                               prefill="prefill", generate="generate"))
    jcfg = jl.llama_config("nano", **_JOVR)
    jparams = jl.llama_init(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree.map(np.asarray, jparams)
    tcfg = tl.llama_config("nano", dtype=torch.float32, use_flash=False)
    return (jcfg, jparams, tcfg, llama_params_from_numpy(tree, tcfg, "cpu"),
            jld, tld, dict(verify="llama_verify_step",
                           step="llama_decode_step", prefill="llama_prefill",
                           generate="llama_generate"))


def _fn(family, which, port):
    _, _, _, _, jm, tm, names = _family(family)
    return getattr(tm if port else jm, names[which])


def _kv_heads(cfg):
    return getattr(cfg, "n_kv_head", None) or cfg.n_head


def _caches(family, layout, pos, start, seed=0, bs=16):
    """The same seeded cache for JAX (jnp) and the port (torch): random
    K/V, the given pos/start, paged rows on shuffled blocks."""
    jcfg = _family(family)[0]
    rs = np.random.RandomState(seed)
    B = len(pos)
    L, S, H, hd = jcfg.n_layer, jcfg.max_seq, _kv_heads(jcfg), jcfg.head_dim
    arrs = {"pos": np.asarray(pos, np.int32),
            "start": np.asarray(start, np.int32)}
    if layout == "dense":
        shape = (L, B, S, H, hd)
    else:
        nb = S // bs
        n_blocks = 1 + B * nb + 3
        shape = (L, n_blocks, bs, H, hd)
        arrs["block_tables"] = (1 + rs.permutation(n_blocks - 1)[:B * nb]
                                ).reshape(B, nb).astype(np.int32)
    arrs["k"] = rs.randn(*shape).astype(np.float32)
    arrs["v"] = rs.randn(*shape).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in arrs.items()},
            {k: torch.from_numpy(v.copy()) for k, v in arrs.items()})


def _assert_cache(tc, jc, paged):
    """The port's cache after equals JAX's: pos/start exactly, K/V
    within f32 rounding; block 0 of a pool (the null block, whose value
    depends on which out-of-range write lands last) left out."""
    for name in ("pos", "start"):
        np.testing.assert_array_equal(tc[name].numpy(), np.asarray(jc[name]))
    for name in ("k", "v"):
        got, want = tc[name].numpy(), np.asarray(jc[name])
        if paged:
            got, want = got[:, 1:], want[:, 1:]
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# spec_accept
# ---------------------------------------------------------------------------


def _accept_inputs(seed, B=6, T=K + 1, V=72, vocab=64):
    """Logits whose argmax the drafts follow for a seeded number of
    columns, then leave; a padded vocab tail holding large logits."""
    rs = np.random.RandomState(seed)
    logits = rs.randn(B, T, V).astype(np.float32) * 3
    logits[..., vocab:] = 50.0                  # the tail must never win
    g = logits[..., :vocab].argmax(-1)
    drafts = rs.randint(0, vocab, (B, T - 1))
    for b in range(B):
        keep = rs.randint(0, T)
        drafts[b, :keep] = g[b, :keep]
    block = np.concatenate([rs.randint(0, vocab, (B, 1)), drafts],
                           1).astype(np.int32)
    tail = np.arange(V) < vocab
    return logits, block, tail


@pytest.mark.parametrize("seed", range(4))
def test_spec_accept_greedy_equals_jax(seed):
    logits, block, tail = _accept_inputs(seed)
    jout, jn = jdc.spec_accept(jnp.asarray(logits), jnp.asarray(block),
                               None, 0.0, jnp.asarray(tail))
    tout, tn = tdc.spec_accept(torch.from_numpy(logits),
                               torch.from_numpy(block), None, 0.0,
                               torch.from_numpy(tail))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
    assert tout.dtype == torch.int32 and tn.dtype == torch.int32


#: chi-square bound for V - 1 = 5 degrees of freedom: P(X > 30) ~ 1.5e-5
CHI2_BOUND_5DOF = 30.0
#: ... and for k = 3 degrees of freedom (n_acc in 0..3): P(X > 25) ~ 1.6e-5
CHI2_BOUND_3DOF = 25.0
TRIALS = 20000


def _chi2(counts, probs):
    expected = probs * counts.sum()
    keep = expected > 0
    assert counts[~keep].sum() == 0, "a draw where the law puts no mass"
    return float(((counts[keep] - expected[keep]) ** 2
                  / expected[keep]).sum())


def _sampled_case(seed, k=3, V=6):
    """One row's target logits (k+1, V), a draft distribution q (k, V)
    unlike the target, and drafts drawn from q, repeated TRIALS times."""
    rs = np.random.RandomState(seed)
    logits = rs.randn(k + 1, V).astype(np.float32) * 1.5
    q = rs.dirichlet(np.ones(V), size=k).astype(np.float32)
    drafts = np.stack([rs.choice(V, size=TRIALS, p=q[t] / q[t].sum())
                       for t in range(k)], 1)
    block = np.concatenate([np.zeros((TRIALS, 1), np.int64), drafts], 1)
    return (np.broadcast_to(logits, (TRIALS, k + 1, V)).copy(),
            block.astype(np.int32),
            np.broadcast_to(q, (TRIALS, k, V)).copy())


@pytest.mark.parametrize("knobs", [dict(temperature=1.0),
                                   dict(temperature=0.7, top_k=4)],
                         ids=["t1", "t07_topk4"])
def test_spec_accept_sampled_first_token_follows_the_target(knobs):
    """Rejection sampling keeps the target's law: the first emitted
    token, over TRIALS seeded draws from a draft q unlike p, is
    distributed as the target's filtered p (chi-square below
    CHI2_BOUND_5DOF), with q given and with the one-hot q of an n-gram
    draft."""
    logits, block, q = _sampled_case(1)
    t = knobs["temperature"]
    filt = tdc.filter_logits(torch.from_numpy(logits[:1, 0]), t, None,
                             knobs.get("top_k", 0))
    p0 = torch.softmax(filt, -1)[0].numpy().astype(np.float64)
    for draft_probs in (torch.from_numpy(q), None):
        gen = torch.Generator().manual_seed(5)
        out, _ = tdc.spec_accept(torch.from_numpy(logits),
                                 torch.from_numpy(block), gen, t, None,
                                 top_k=knobs.get("top_k", 0),
                                 draft_probs=draft_probs)
        counts = np.bincount(out[:, 0].numpy(), minlength=p0.size)
        assert _chi2(counts, p0) < CHI2_BOUND_5DOF


def test_spec_accept_sampled_n_acc_distribution_equals_jax():
    """n_acc over TRIALS draws on the same logits, drafts and draft
    probabilities: the port's and JAX's histograms each within
    CHI2_BOUND_3DOF of the law P(n_acc >= j) = prod_{t<j} min(1,
    p_t(d_t) / q_t(d_t)), computed per trial, and within 0.02 of each
    other in every bin."""
    k = 3
    logits, block, q = _sampled_case(2, k=k)
    gen = torch.Generator().manual_seed(3)
    _, tn = tdc.spec_accept(torch.from_numpy(logits), torch.from_numpy(block),
                            gen, 1.0, None, draft_probs=torch.from_numpy(q))
    _, jn = jax.jit(lambda lg, bl, key, qq: jdc.spec_accept(
        lg, bl, key, 1.0, None, draft_probs=qq))(
        jnp.asarray(logits), jnp.asarray(block), jax.random.PRNGKey(3),
        jnp.asarray(q))
    p = torch.softmax(torch.from_numpy(logits[0]), -1).numpy()
    d = block[:, 1:]
    ratio = np.minimum(1.0, p[np.arange(k), d] / q[0][np.arange(k), d])
    reach = np.concatenate([np.ones((TRIALS, 1)), np.cumprod(ratio, 1)], 1)
    law = (reach[:, :k + 1] - np.concatenate(
        [reach[:, 1:], np.zeros((TRIALS, 1))], 1)).mean(0)
    hist = {}
    for name, n in (("port", tn.numpy()), ("jax", np.asarray(jn))):
        hist[name] = np.bincount(n, minlength=k + 1)
        assert _chi2(hist[name], law) < CHI2_BOUND_3DOF, name
    np.testing.assert_allclose(hist["port"] / TRIALS, hist["jax"] / TRIALS,
                               atol=0.02)


# ---------------------------------------------------------------------------
# verify_step / llama_verify_step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layout", ["dense", "paged"])
@pytest.mark.parametrize("family", FAMILIES)
def test_verify_step_equals_jax(family, layout):
    """Logits (B, k+1, V) within LOGIT_TOL of JAX's and the cache after
    equal to JAX's, on a seeded cache whose row 0 sits at pos 125 of
    max_seq 128, so its block crosses the end (dense: the writes past it
    are dropped; paged: routed to the null block)."""
    jcfg, jparams, tcfg, tparams, *_ = _family(family)
    pos, start = [125, 60, 3], [0, 10, 0]
    jc, tc = _caches(family, layout, pos, start, seed=1)
    block = np.random.RandomState(2).randint(
        0, jcfg.vocab_size, (3, K + 1)).astype(np.int32)
    jlog, jc = _fn(family, "verify", False)(jparams, jc, jnp.asarray(block),
                                           jcfg)
    with torch.no_grad():
        tlog, tc = _fn(family, "verify", True)(tparams, tc,
                                              torch.from_numpy(block), tcfg)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                               atol=LOGIT_TOL, rtol=LOGIT_TOL)
    _assert_cache(tc, jc, layout == "paged")
    assert tc["pos"].tolist() == pos            # not advanced


@pytest.mark.parametrize("layout", ["dense", "paged"])
@pytest.mark.parametrize("family", FAMILIES)
def test_verify_step_equals_sequential_decode_steps(family, layout):
    """One verify forward gives the logits of k+1 sequential decode
    steps fed the same tokens (within LOGIT_TOL), and writes the same
    K/V."""
    _, _, tcfg, tparams, *_ = _family(family)
    pos, start = [40, 17, 90], [0, 5, 0]
    _, tc = _caches(family, layout, pos, start, seed=3)
    _, seq = _caches(family, layout, pos, start, seed=3)
    block = torch.from_numpy(np.random.RandomState(4).randint(
        0, tcfg.vocab_size, (3, K + 1)).astype(np.int32))
    step = _fn(family, "step", True)
    with torch.no_grad():
        logits, tc = _fn(family, "verify", True)(tparams, tc, block, tcfg)
        rows = []
        for t in range(K + 1):
            lg, seq = step(tparams, seq, block[:, t], tcfg)
            rows.append(lg)
    torch.testing.assert_close(logits, torch.stack(rows, 1), atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)
    for name in ("k", "v"):
        torch.testing.assert_close(tc[name], seq[name], atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("family", FAMILIES)
def test_make_spec_verify_moves_pos_as_jax(family):
    """The composed verify: out tokens and n_acc equal JAX's, pos lands
    at pos + n_acc + 1 (greedy; the drafts of row 0 are the target's own
    argmax continuation, so it accepts all k)."""
    jcfg, jparams, tcfg, tparams, *_ = _family(family)
    pos, start = [30, 50], [0, 0]
    jc, tc = _caches(family, "dense", pos, start, seed=5)
    rs = np.random.RandomState(6)
    block = rs.randint(0, jcfg.vocab_size, (2, K + 1)).astype(np.int32)
    # row 0 follows the target's argmax: accepts all k
    probe = dict((k, v.clone()) for k, v in tc.items())
    for t in range(K):
        with torch.no_grad():
            lg, probe = _fn(family, "verify", True)(
                tparams, probe, torch.from_numpy(block), tcfg)
        block[0, t + 1] = int(lg[0, t, :tcfg.vocab_size].argmax())
    jv = jdc.make_spec_verify(_fn(family, "verify", False), jcfg)
    tv = tdc.make_spec_verify(_fn(family, "verify", True), tcfg)
    jout, jn, jc = jv(jparams, jc, jnp.asarray(block), None)
    with torch.no_grad():
        tout, tn, tc = tv(tparams, tc, torch.from_numpy(block))
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    assert tn.tolist()[0] == K
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    assert tc["pos"].tolist() == [p + n + 1 for p, n in zip(pos, tn.tolist())]


@pytest.mark.parametrize("family", FAMILIES)
def test_make_draft_propose_greedy_equals_jax(family):
    """Two rounds of the greedy draft program on a prefilled ragged
    batch: the drafts and the draft cache's pos equal JAX's, the second
    round after rewinding (2, 0) rejected positions."""
    jcfg, jparams, tcfg, tparams, *_ = _family(family)
    prompts = np.random.RandomState(7).randint(1, 500, (2, 9)).astype(np.int32)
    lens = np.asarray([9, 5], np.int32)
    _, jc = _fn(family, "prefill", False)(jparams, jnp.asarray(prompts), jcfg,
                                          lengths=jnp.asarray(lens))
    with torch.no_grad():
        _, tc = _fn(family, "prefill", True)(
            tparams, torch.from_numpy(prompts), tcfg,
            lengths=torch.from_numpy(lens))
    jp = jdc.make_draft_propose(_fn(family, "step", False), jcfg, K)
    tp = tdc.make_draft_propose(_fn(family, "step", True), tcfg, K)
    cur = np.asarray([3, 7], np.int32)
    for rej in ([0, 0], [2, 0]):
        jd, jc = jp(jparams, jc, jnp.asarray(cur), jnp.asarray(rej, jnp.int32),
                    jax.random.PRNGKey(0))
        with torch.no_grad():
            td, tc = tp(tparams, tc, torch.from_numpy(cur),
                        torch.tensor(rej, dtype=torch.int32))
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
        cur = td.numpy()[:, -1].copy()
    with pytest.raises(ValueError, match="with_probs requires temperature"):
        tdc.make_draft_propose(_fn(family, "step", True), tcfg, K,
                               with_probs=True)


def test_sampled_draft_propose_returns_its_distributions():
    """with_probs: each draft token is drawn from the (k, V) rows it
    returns, which are distributions over the real vocab."""
    _, _, tcfg, tparams, *_ = _family("gpt2")
    _, tc = _caches("gpt2", "dense", [20, 30], [0, 0], seed=8)
    prop = tdc.make_draft_propose(tgd.decode_step, tcfg, K, temperature=0.8,
                                  top_k=5, with_probs=True)
    with torch.no_grad():
        drafts, probs, tc = prop(tparams, tc, torch.tensor([1, 2]),
                                 torch.zeros(2, dtype=torch.int32),
                                 torch.Generator().manual_seed(0))
    assert drafts.shape == (2, K) and probs.shape == (2, K, tcfg.padded_vocab)
    torch.testing.assert_close(probs.sum(-1), torch.ones(2, K))
    assert ((probs > 0).sum(-1) <= 5).all()
    assert (probs.gather(-1, drafts.long()[..., None]) > 0).all()
    assert tc["pos"].tolist() == [20 + K + 1, 30 + K + 1]


@pytest.mark.parametrize("seed", range(6))
def test_ngram_propose_equals_jax(seed):
    rs = np.random.RandomState(seed)
    for n in (0, 1, 2, 3, 8, 40):
        toks = rs.randint(0, 4, n).tolist()
        for k, order in ((K, 2), (2, 1), (5, 3)):
            assert tdc.ngram_propose(toks, k, order) == \
                jdc.ngram_propose(toks, k, order)
