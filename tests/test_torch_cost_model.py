"""The port's cost model (``_private/device_stats.py``) against the JAX
package's compiled cost analysis, on the CPU.

What is held, and to what:

* a (128, 64) x (64, 256) f32 product: the harvest's FLOPs equal XLA's
  ``cost_analysis()`` exactly (2*M*N*K = 4,194,304);
* the GPT-2 nano forward (B=2, T=64, dense CE, plain attention) at one
  layer equals the products' formula exactly (23,068,672) and is at
  most XLA's count (XLA also counts elementwise work); at 2 and 4
  layers the port grows by one layer's products each, where XLA counts
  the scanned layer stack once (a limit of the JAX package's figure,
  asserted as such);
* each kernel entry (the flash forward, dQ, dK/dV; the fused CE
  forward, dH, dW) books its own reckoning (``*_work``) on the plain
  route, FLOPs and bytes exactly;
* a GPT-2 nano AdamW step through the flash and fused-CE entries,
  remat ``mlp_only``, equals chip_smoke's written-out step formula
  exactly, the backward included;
* matmul, linear, einsum and conv2d count the same with autograd on
  (their products reach the mode) and under inference mode (the
  composites do), and so does the nano decode step;
* a program with an in-place side effect runs once under the harvest;
  a known temporary shows in ``peak_hbm_bytes``;
* the registry's snapshot equals the JAX registry's, key for key and
  ``mfu`` included, for identical recorded costs and invokes.

All counts are integers compared exactly; no tolerance.
"""

import importlib

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from ray_tpu._private import device_stats as jds  # noqa: E402
from ray_tpu.models import gpt2 as jgpt2  # noqa: E402
from ray_tpu_torch._private import device_stats as tds  # noqa: E402
from ray_tpu_torch.models import gpt2 as tgpt2  # noqa: E402
from ray_tpu_torch.ops import fused_ce as fc  # noqa: E402

fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")

#: the nano forward's products at one layer: the block's four
#: projections 12,582,912, attention's two products 2,097,152, the
#: tied head 8,388,608 (B=2, T=64, d=64, d_ff=256, V=512)
NANO_ONE_LAYER = 23_068_672
NANO_LAYER = 12_582_912 + 2_097_152


def _xla_flops(fn, *args) -> float:
    ca = jax.jit(fn).lower(*args).compile().cost_analysis()
    if isinstance(ca, (list, tuple)):
        ca = ca[0]
    return float(ca["flops"])


def test_f32_product_equals_xla():
    rs = np.random.RandomState(0)
    a = rs.randn(128, 64).astype(np.float32)
    b = rs.randn(64, 256).astype(np.float32)
    want = _xla_flops(lambda x, y: x @ y, jnp.asarray(a), jnp.asarray(b))
    out, cost = tds.harvest_cost(lambda x, y: x @ y, torch.from_numpy(a),
                                 torch.from_numpy(b))
    assert cost["xla_flops"] == want == 2 * 128 * 256 * 64
    np.testing.assert_allclose(out.numpy(), a @ b, rtol=1e-5, atol=1e-5)
    # (128*64 + 64*256 + 128*256) f32 elements read or written
    assert cost["bytes_accessed"] == 4 * (128 * 64 + 64 * 256 + 128 * 256)
    assert cost["arithmetic_intensity"] == round(
        cost["xla_flops"] / cost["bytes_accessed"], 3)


def _nano_losses(n_layer):
    cfg_j = jgpt2.gpt2_config("nano", ce_impl="dense", use_flash=False,
                              n_layer=n_layer)
    cfg_t = tgpt2.gpt2_config("nano", ce_impl="dense", use_flash=False,
                              n_layer=n_layer)
    params = tgpt2.gpt2_init(cfg_t, torch.Generator().manual_seed(0),
                             device="cpu")
    toks = np.random.RandomState(1).randint(0, 500, (2, 65))
    jp = jgpt2.gpt2_init(jax.random.PRNGKey(0), cfg_j)
    want = _xla_flops(lambda p, t: jgpt2.gpt2_loss(p, {"tokens": t},
                                                   cfg_j),
                      jp, jnp.asarray(toks, jnp.int32))
    _, cost = tds.harvest_cost(
        lambda: tgpt2.gpt2_loss(params, {"tokens": torch.from_numpy(toks)},
                                cfg_t))
    return cost["xla_flops"], want


def test_nano_forward_counts_every_layer():
    got = {}
    for n_layer in (1, 2, 4):
        got[n_layer] = _nano_losses(n_layer)
    port, xla = got[1]
    assert port == NANO_ONE_LAYER
    assert port <= xla            # XLA adds the elementwise work
    # the port counts each layer of the stack ...
    assert got[2][0] == NANO_ONE_LAYER + NANO_LAYER
    assert got[4][0] == NANO_ONE_LAYER + 3 * NANO_LAYER
    # ... where XLA's cost_analysis counts the scanned stack's body once
    # (a limit of the JAX package's xla_flops, not a model the port
    # follows)
    assert got[2][1] == got[4][1]


def _rand(shape, seed, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g).to(dtype)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_entries_book_their_reckoning(causal, dtype):
    bh, T, d = 4, 48, 32
    q, k, v, do = (_rand((bh, T, d), s, dtype) for s in range(4))
    elem = q.element_size()
    (o, lse), c = tds.harvest_cost(fa.flash_attention_fwd, q, k, v,
                                   causal=causal)
    assert (c["xla_flops"], c["bytes_accessed"]) == tuple(
        map(float, fa.flash_fwd_work(bh, T, d, causal, elem)))
    scale = d ** -0.5
    (dq, delta), c = tds.harvest_cost(fa.flash_bwd_dq, q, k, v, o, do, lse,
                                      scale=scale, causal=causal)
    assert (c["xla_flops"], c["bytes_accessed"]) == tuple(
        map(float, fa.flash_bwd_dq_work(bh, T, d, causal, elem)))
    _, c = tds.harvest_cost(fa.flash_bwd_dkv, q, k, v, do, lse, delta,
                            scale=scale, causal=causal)
    assert (c["xla_flops"], c["bytes_accessed"]) == tuple(
        map(float, fa.flash_bwd_dkv_work(bh, T, d, causal, elem)))
    # the whole backward books the two kernels' sum, which recomputes
    # S and dP in each: above the least work of the backward (the bound
    # of flash_bwd_work, 10*D a pair)
    _, c = tds.harvest_cost(fa.flash_attention_bwd, q, k, v, o, lse, do,
                            causal=causal)
    assert c["xla_flops"] == \
        fa.flash_bwd_dq_work(bh, T, d, causal, elem)[0] + \
        fa.flash_bwd_dkv_work(bh, T, d, causal, elem)[0] > \
        fa.flash_bwd_work(bh, T, d, causal, elem)[0]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_ce_entries_book_their_reckoning(dtype):
    n, v, valid, d = 40, 96, 90, 64
    h, w = _rand((n, d), 0, dtype), _rand((v, d), 1, dtype)
    tgt = torch.randint(0, valid, (n,), dtype=torch.int32,
                        generator=torch.Generator().manual_seed(2))
    g = _rand((n,), 3).abs()
    elem = h.element_size()
    (nll, lse), c = tds.harvest_cost(fc.fused_ce_fwd, h, w, tgt, valid)
    assert (c["xla_flops"], c["bytes_accessed"]) == tuple(
        map(float, fc.fused_ce_fwd_work(n, v, valid, d, elem)))
    for entry, work in ((fc.fused_ce_bwd_dh, fc.fused_ce_bwd_dh_work),
                        (fc.fused_ce_bwd_dw, fc.fused_ce_bwd_dw_work)):
        _, c = tds.harvest_cost(entry, h, w, tgt, lse, g, valid)
        assert (c["xla_flops"], c["bytes_accessed"]) == tuple(
            map(float, work(n, v, valid, d, elem)))
    # the (N, V) logits of the plain route never reach the peak: the
    # kernel allocates only what it returns
    assert c["peak_hbm_bytes"] == c["argument_bytes"] + v * d * 4


def test_train_step_equals_the_step_formula():
    """A GPT-2 nano AdamW step, flash + fused CE + mlp_only remat, as
    chip_smoke's phase observatory (a) counts GPT-2-124M's on the
    card."""
    from chip_smoke import gpt2_step_flops
    from ray_tpu_torch.train import adamw, build_train_step

    cfg = tgpt2.gpt2_config("nano", ce_impl="pallas", use_flash=True,
                            remat_policy="mlp_only", n_layer=2)
    params = tgpt2.gpt2_init(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    tx = adamw(3e-4, weight_decay=0.1)
    step = build_train_step(lambda p, b: tgpt2.gpt2_loss(p, b, cfg), tx,
                            telemetry=False)
    opt = tx.init(params)
    batch = {"tokens": torch.randint(0, 500, (2, 65), generator=torch.
                                     Generator().manual_seed(1))}
    before = params["wte"].clone()
    (params, opt, loss), cost = tds.harvest_cost(step, params, opt, batch)
    assert not torch.equal(before, params["wte"])       # it stepped
    want = gpt2_step_flops(cfg.n_layer, 2, 64, cfg.d_model, cfg.d_ff,
                           cfg.n_head, cfg.vocab_size)
    assert cost["xla_flops"] == want
    forward = tds.harvest_cost(
        lambda: tgpt2.gpt2_loss(params, batch, cfg))[1]["xla_flops"]
    assert cost["xla_flops"] > 2.5 * forward             # the backward


def test_inference_mode_counts_the_composites():
    """Under inference mode matmul, linear, einsum and conv2d reach the
    mode whole: counted there, the serve programs count what they count
    with autograd on."""
    from ray_tpu_torch.models.gpt2_decode import decode_step, init_cache

    a, b = _rand((3, 5, 7), 0), _rand((7, 2), 1)
    x, w = _rand((2, 3, 8, 8), 2), _rand((4, 3, 3, 3), 3)
    cases = {"matmul": (lambda: a @ b, 2 * 3 * 5 * 7 * 2),
             "linear": (lambda: torch.nn.functional.linear(a, b.T),
                        2 * 3 * 5 * 7 * 2),
             "einsum": (lambda: torch.einsum("bij,jk->bik", a, b),
                        2 * 3 * 5 * 7 * 2),
             "conv2d": (lambda: torch.nn.functional.conv2d(x, w),
                        2 * (2 * 4 * 6 * 6) * (3 * 3 * 3))}
    for name, (fn, want) in cases.items():
        for mode in (torch.no_grad, torch.inference_mode):
            with mode():
                assert tds.harvest_cost(fn)[1]["xla_flops"] == want, \
                    (name, mode)
    cfg = tgpt2.gpt2_config("nano", dtype=torch.float32, use_flash=False,
                            remat=False)
    params = tgpt2.gpt2_init(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    toks = torch.zeros((4,), dtype=torch.int32)
    got = []
    for mode in (torch.no_grad, torch.inference_mode):
        with mode():
            got.append(tds.harvest_cost(decode_step, params, init_cache(
                cfg, 4, device="cpu"), toks, cfg)[1]["xla_flops"])
    # 4 rows: 24*d^2 a layer, attention over max_seq=128 slots, the head
    d, L, S, V = cfg.d_model, cfg.n_layer, cfg.max_seq, cfg.padded_vocab
    assert got[0] == got[1] == 4 * (L * (24 * d * d + 4 * S * d)
                                    + 2 * d * V)


def test_in_place_program_runs_once_under_the_harvest(monkeypatch):
    monkeypatch.setenv("RAYTPU_DEVICE_STATS_COST", "1")
    calls = []
    x = torch.zeros(4)

    def prog(t):
        calls.append(1)
        return t.add_(1.0)

    out, cost = tds.harvest_cost(prog, x)
    assert len(calls) == 1 and out is x and x.tolist() == [1.0] * 4
    assert cost["argument_bytes"] == 16 and cost["output_bytes"] == 0
    reg = tds.ProgramRegistry()
    wrapped = reg.instrument("serve.decode", prog)
    wrapped(x)                    # the compile event: harvested
    wrapped(x)                    # an invoke
    assert len(calls) == 3 and x.tolist() == [3.0] * 4
    snap = reg.snapshot()["serve.decode"]
    assert snap["compile_events"] == 1 and snap["invokes"] == 1
    assert snap["bytes_accessed"] == 32.0     # read and written once
    # off, the first call runs bare and books no cost
    monkeypatch.setenv("RAYTPU_DEVICE_STATS_COST", "0")
    reg = tds.ProgramRegistry()
    reg.instrument("serve.decode", prog)(x)
    assert len(calls) == 4
    assert reg.snapshot()["serve.decode"]["xla_flops"] is None


def test_peak_counts_a_known_temporary():
    n = 1 << 18                               # 1 MiB of f32
    x = torch.ones(n)

    def prog(t):
        tmp = t * 2.0                         # 1 MiB, freed at return
        return tmp.sum()                      # 4 bytes

    out, cost = tds.harvest_cost(prog, x)
    assert out.item() == 2.0 * n
    assert cost["argument_bytes"] == 4 * n
    assert cost["output_bytes"] == 4
    assert cost["peak_hbm_bytes"] == 4 * n + 4 * n + 4
    assert cost["temp_bytes"] == 4 * n


def test_kernel_work_outside_a_harvest_does_nothing():
    assert tds.active_cost_counter() is None
    with tds.kernel_work(10, 20):
        assert tds.active_cost_counter() is None


def test_snapshot_equals_the_jax_registry_for_the_same_records():
    now = iter(np.arange(0.0, 100.0, 0.25)).__next__
    regs = {"j": jds.ProgramRegistry(now=now),
            "t": tds.ProgramRegistry(now=now)}
    cost = {"xla_flops": 3.0e9, "bytes_accessed": 1.5e8,
            "arithmetic_intensity": 20.0, "peak_hbm_bytes": 1 << 26,
            "argument_bytes": 1 << 25, "output_bytes": 1 << 20,
            "temp_bytes": 1 << 24}
    for reg in regs.values():
        reg.record_compile("serve.decode", 1.25, cost=cost, now=1.0)
        reg.record_compile("serve.prefill", 0.5, now=2.0)
        for i, s in enumerate((0.004, 0.005, 0.006, 0.0045)):
            reg.record_invoke("serve.decode", s, now=3.0 + i)
        reg.record_invoke("serve.prefill", 0.02, now=9.0)
    for kw in ({}, {"n_devices": 4}, {"prefix": "serve.d"},
               {"peak_flops": 989e12}):
        sj, st = regs["j"].snapshot(**kw), regs["t"].snapshot(**kw)
        assert st == sj, kw
    assert st["serve.decode"]["mfu"] is not None
