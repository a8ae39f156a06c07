"""ResNet (v1.5, post-activation): config, init, forward, loss.

Counterpart of ``ray_tpu/models/resnet.py``, the image-training
baseline (BASELINE.json: "JaxTrainer: ResNet-50 ImageNet
data-parallel").  The parameter tree is the JAX package's: HWIO
kernels, lists of blocks holding ``convs``, ``bns`` and, where a
block's channels change, ``proj`` and ``proj_bn``; batch norm is
functional, its running statistics in a separate ``state`` tree that
the forward returns anew, so a train step carries it.

Images come in as (B, H, W, 3), as in JAX; ``permute(0, 3, 1, 2)``
gives the NCHW view of that memory, a channels_last tensor, with no
copy.  Convolutions are ``F.conv2d`` (cuDNN on the card), as the JAX
package's are XLA's ``lax.conv_general_dilated``: no Pallas kernel
runs here.  What must match JAX's semantics:

* ``"SAME"`` padding is asymmetric at stride 2 (``_same_pads``): the
  7x7/2 stem pads (2, 3) at an even input, a 3x3/2 conv (0, 1);
  PyTorch's symmetric ``padding=`` is off by a pixel there;
* the stem's 3x3/2 max-pool pads with -inf the same way;
* batch norm takes its statistics over (N, H, W) in float32 with the
  biased variance (``jnp.var``), and updates the running statistics
  as ``m * old + (1 - m) * batch`` (``F.batch_norm`` keeps the
  unbiased variance and weights the momentum the other way).

A float64 config computes in float64 throughout (the statistics and
the head included, where JAX's float32 casts would round it): the
card's gradient check runs there, since at init in training mode the
gradient through 53 batch norms is too ill-conditioned for float32 to
pin down.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from ray_tpu_torch.device import DeviceLike, resolve_device

_STAGES = {
    # name: (block sizes, bottleneck?)
    "resnet18": ((2, 2, 2, 2), False),
    "resnet34": ((3, 4, 6, 3), False),
    "resnet50": ((3, 4, 6, 3), True),
    "resnet101": ((3, 4, 23, 3), True),
    "tiny": ((1, 1), False),  # test-sized: 2 stages
}

#: batch norm's epsilon (the JAX ``_batchnorm``'s)
BN_EPS = 1e-5


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    """Every field of the JAX ResNetConfig, with torch dtypes."""
    blocks: Sequence[int] = (3, 4, 6, 3)
    bottleneck: bool = True
    n_classes: int = 1000
    width: int = 64
    dtype: Any = torch.bfloat16       # activation/compute dtype
    param_dtype: Any = torch.float32  # master weights
    bn_momentum: float = 0.9


def resnet_config(name: str = "resnet50", **overrides) -> ResNetConfig:
    blocks, bottleneck = _STAGES[name]
    kw: Dict[str, Any] = dict(blocks=blocks, bottleneck=bottleneck)
    if name == "tiny":
        kw.update(width=32, n_classes=10)
    kw.update(overrides)
    return ResNetConfig(**kw)


def _block_channels(cfg: ResNetConfig) -> List[Tuple[int, int, int]]:
    """(cin, cmid, cout) per residual block, flattened over stages."""
    out: List[Tuple[int, int, int]] = []
    expansion = 4 if cfg.bottleneck else 1
    cin = cfg.width
    for stage, n in enumerate(cfg.blocks):
        cmid = cfg.width * (2 ** stage)
        cout = cmid * expansion
        for _ in range(n):
            out.append((cin, cmid, cout))
            cin = cout
    return out


def _block_kernels(cfg: ResNetConfig, cin: int, cmid: int,
                   cout: int) -> List[Tuple[int, int, int]]:
    """(kernel size, cin, cout) of a block's convs, in order."""
    if cfg.bottleneck:
        return [(1, cin, cmid), (3, cmid, cmid), (1, cmid, cout)]
    return [(3, cin, cmid), (3, cmid, cout)]


def resnet_init(generator: torch.Generator, cfg: ResNetConfig,
                device: DeviceLike = None):
    """(params, state), shaped and keyed as the JAX ``resnet_init``:
    He-normal HWIO conv kernels (std sqrt(2 / fan_in)), batch norm
    scale 1 and bias 0, a N(0, 0.01) head; ``state`` holds each batch
    norm's running mean 0 and variance 1 in float32.  Drawn from
    ``generator`` (which must live on ``device``, default the card); the
    draws differ from jax.random's, so cross-package tests carry
    JAX-initialised weights across (models/convert.py)."""
    dev = resolve_device(device)
    pd = cfg.param_dtype

    def conv(k, cin, cout):
        w = torch.randn((k, k, cin, cout), generator=generator, device=dev,
                        dtype=torch.float32)
        return (w * math.sqrt(2.0 / (k * k * cin))).to(pd)

    def bn(c):
        return {"scale": torch.ones((c,), dtype=pd, device=dev),
                "bias": torch.zeros((c,), dtype=pd, device=dev)}

    def bn_state(c):
        return {"mean": torch.zeros((c,), dtype=torch.float32, device=dev),
                "var": torch.ones((c,), dtype=torch.float32, device=dev)}

    params: Dict[str, Any] = {
        "stem": {"conv": conv(7, 3, cfg.width), "bn": bn(cfg.width)},
        "blocks": [], "head": {}}
    state: Dict[str, Any] = {"stem": bn_state(cfg.width), "blocks": []}
    for cin, cmid, cout in _block_channels(cfg):
        kernels = _block_kernels(cfg, cin, cmid, cout)
        blk = {"convs": [conv(*kc) for kc in kernels],
               "bns": [bn(c) for _, _, c in kernels]}
        st = {"bns": [bn_state(c) for _, _, c in kernels]}
        if cin != cout:
            blk["proj"] = conv(1, cin, cout)
            blk["proj_bn"] = bn(cout)
            st["proj_bn"] = bn_state(cout)
        params["blocks"].append(blk)
        state["blocks"].append(st)
    chead = _block_channels(cfg)[-1][2]
    params["head"] = {
        "w": (torch.randn((chead, cfg.n_classes), generator=generator,
                          device=dev, dtype=torch.float32) * 0.01).to(pd),
        "b": torch.zeros((cfg.n_classes,), dtype=pd, device=dev)}
    return params, state


def resnet_logical_axes(cfg: ResNetConfig):
    """Conv kernels shard cout over tensor, cin over fsdp (HWIO
    layout), as the JAX package's."""
    conv_ax = (None, None, "embed", "mlp")
    bn_ax = {"scale": ("norm",), "bias": ("norm",)}
    axes: Dict[str, Any] = {
        "stem": {"conv": conv_ax, "bn": bn_ax},
        "blocks": [],
        "head": {"w": ("embed", "vocab"), "b": ("vocab",)},
    }
    n = 3 if cfg.bottleneck else 2
    for cin, _, cout in _block_channels(cfg):
        b: Dict[str, Any] = {"convs": [conv_ax] * n, "bns": [bn_ax] * n}
        if cin != cout:
            b["proj"] = conv_ax
            b["proj_bn"] = bn_ax
        axes["blocks"].append(b)
    return axes


def _same_pads(size: int, k: int, stride: int) -> Tuple[int, int]:
    """(low, high) padding of XLA's "SAME" along one spatial dim: the
    output has ceil(size / stride) positions, the total padding is what
    they need beyond the input, the extra pixel of an odd total on the
    high side."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _conv(x, w, stride: int = 1):
    """``lax.conv_general_dilated(x, w, stride, "SAME")`` on an NCHW
    view ``x`` and an HWIO kernel ``w``: symmetric padding goes to the
    convolution, an asymmetric one to an explicit ``F.pad`` first."""
    k = w.shape[0]
    (hl, hh), (wl, wh) = (_same_pads(n, k, stride) for n in x.shape[2:])
    w = w.to(x.dtype).permute(3, 2, 0, 1)  # HWIO -> OIHW
    if hl == hh and wl == wh:
        return F.conv2d(x, w, stride=stride, padding=(hl, wl))
    return F.conv2d(F.pad(x, (wl, wh, hl, hh)), w, stride=stride)


def _max_pool_same(x, k: int = 3, stride: int = 2):
    """``lax.reduce_window(x, -inf, max, (1, k, k, 1), (1, s, s, 1),
    "SAME")``: padded with -inf by ``_same_pads``, then pooled."""
    (hl, hh), (wl, wh) = (_same_pads(n, k, stride) for n in x.shape[2:])
    x = F.pad(x, (wl, wh, hl, hh), value=-math.inf)
    return F.max_pool2d(x, k, stride)


def _wide(dtype):
    """The dtype statistics and the head compute in: float32, or
    float64 for a float64 input."""
    return torch.promote_types(dtype, torch.float32)


def _batchnorm(x, p, st, *, training: bool, momentum: float):
    """Batch norm over (N, H, W) of an NCHW view in float32 (``_wide``):
    (y in x's dtype, the new running statistics).  Training takes the
    batch's mean and biased variance and moves the running ones towards
    them (detached: JAX returns them as values); evaluation uses the
    running ones."""
    wide = _wide(x.dtype)
    xf = x.to(wide)
    if training:
        mean = xf.mean(dim=(0, 2, 3))
        var = (xf - mean[:, None, None]).square().mean(dim=(0, 2, 3))
        new_st = {"mean": (momentum * st["mean"]
                           + (1 - momentum) * mean).detach(),
                  "var": (momentum * st["var"]
                          + (1 - momentum) * var).detach()}
    else:
        mean, var = st["mean"], st["var"]
        new_st = st
    y = (xf - mean[:, None, None]) * torch.rsqrt(var + BN_EPS)[:, None, None]
    y = (y * p["scale"].to(wide)[:, None, None]
         + p["bias"].to(wide)[:, None, None])
    return y.to(x.dtype), new_st


def resnet_forward(params, state, images, cfg: ResNetConfig, *,
                   training: bool = True):
    """images (B, H, W, 3) → (logits (B, n_classes) float32 (float64
    for a float64 config), new_state)."""
    x = images.to(cfg.dtype).permute(0, 3, 1, 2)
    mom = cfg.bn_momentum
    new_state: Dict[str, Any] = {"blocks": []}

    x = _conv(x, params["stem"]["conv"], stride=2)
    x, new_state["stem"] = _batchnorm(x, params["stem"]["bn"],
                                      state["stem"], training=training,
                                      momentum=mom)
    x = _max_pool_same(torch.relu(x))

    stage_starts, acc = set(), 0
    for n in cfg.blocks:
        stage_starts.add(acc)
        acc += n

    for i, (blk, st) in enumerate(zip(params["blocks"], state["blocks"])):
        stride = 2 if (i in stage_starts and i != 0) else 1
        new_blk: Dict[str, Any] = {"bns": []}
        # a bottleneck takes its stride in the middle conv
        strides = [1, stride, 1] if cfg.bottleneck else [stride, 1]
        h = x
        last = len(blk["convs"]) - 1
        for j, (w, bn, bst, s) in enumerate(
                zip(blk["convs"], blk["bns"], st["bns"], strides)):
            h, nst = _batchnorm(_conv(h, w, stride=s), bn, bst,
                                training=training, momentum=mom)
            new_blk["bns"].append(nst)
            if j < last:
                h = torch.relu(h)
        shortcut = x
        if "proj" in blk:
            shortcut, new_blk["proj_bn"] = _batchnorm(
                _conv(x, blk["proj"], stride=stride), blk["proj_bn"],
                st["proj_bn"], training=training, momentum=mom)
        x = torch.relu(h + shortcut)
        new_state["blocks"].append(new_blk)

    wide = _wide(x.dtype)
    x = x.to(wide).mean(dim=(2, 3))
    logits = x @ params["head"]["w"].to(wide) + params["head"]["b"].to(wide)
    return logits, new_state


def resnet_loss(params, state, batch, cfg: ResNetConfig, *,
                training: bool = True):
    """batch: {"x": (B, H, W, 3), "y": (B,)} → (mean cross-entropy,
    new_state)."""
    logits, new_state = resnet_forward(params, state, batch["x"], cfg,
                                       training=training)
    logp = torch.log_softmax(logits, dim=-1)
    labels = torch.as_tensor(batch["y"], device=logp.device).long()
    return -logp.gather(-1, labels[:, None]).mean(), new_state
