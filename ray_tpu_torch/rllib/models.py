"""Model catalog: configurable policy networks (MLP / CNN / LSTM /
GTrXL attention).

Reference analog: rllib/models/catalog.py:195 ``ModelCatalog`` — the
config-driven mapping from observation shape + model options to a
network — plus the conv stacks of models/torch/visionnet.py and the
recurrent wrapper of models/torch/recurrent_net.py.

The counterpart of ``ray_tpu/rllib/models.py``.  Each block is an
``nn.Module`` whose parameters keep the JAX package's pytree layout
(``module_tree`` gives it: an MLP or a conv stack is an
``nn.ModuleList`` of ``Dense`` layers, ``{"w", "b"}`` each, ``w`` as
(d_in, d_out) or HWIO), and whose arithmetic is a function over such a
tree (``mlp_apply``, ``conv_apply``, ``attention_apply``,
``lstm_step``), so a policy can run the same network on the tree of
another weight set and weights cross to and from the JAX package as
numpy trees.  Initialisation draws from an explicit
``torch.Generator`` on the CPU with the JAX package's distributions
(the draws themselves differ from ``jax.random``'s).

Conv filters spec: a tuple of (out_channels, kernel, stride) triples,
NHWC observations.  ``None`` selects defaults by observation rank:
rank-1 → MLP only, rank-3 → a MinAtar-scale conv stack for small boards
or an Atari-scale stack for 84×84 frames (reference: catalog.py
_get_filter_config).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ray_tpu_torch.models.resnet import _conv


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Per-policy model options (reference: MODEL_DEFAULTS in
    models/catalog.py)."""

    fcnet_hiddens: Tuple[int, ...] = (64, 64)
    #: ((out_ch, kernel, stride), ...) or None → defaults by obs rank
    conv_filters: Optional[Tuple[Tuple[int, int, int], ...]] = None
    use_lstm: bool = False
    lstm_cell_size: int = 64
    #: training-time BPTT chunk length (reference: rnn_sequencing
    #: max_seq_len)
    max_seq_len: int = 16


def default_conv_filters(obs_shape: Sequence[int]
                         ) -> Tuple[Tuple[int, int, int], ...]:
    """Pick a conv stack for an (H, W, C) observation (reference:
    catalog.py _get_filter_config: 84x84 Atari stack, small boards get
    a 2-layer MinAtar-scale stack)."""
    h = obs_shape[0]
    if h >= 64:  # Atari-class frames
        return ((16, 8, 4), (32, 4, 2), (64, 3, 2))
    return ((16, 3, 1), (32, 3, 2))


# ---------------------------------------------------------------------------
# the tree a module's parameters form
# ---------------------------------------------------------------------------

def module_tree(module: nn.Module):
    """The JAX pytree layout of ``module``'s parameters: a ModuleList
    is a list, any other module a dict of its own parameters and its
    children's trees, by attribute name."""
    if isinstance(module, nn.ModuleList):
        return [module_tree(m) for m in module]
    out = dict(module.named_parameters(recurse=False))
    for name, child in module.named_children():
        out[name] = module_tree(child)
    return out


def _normal(gen: torch.Generator, shape, scale: float) -> nn.Parameter:
    return nn.Parameter(torch.randn(shape, generator=gen) * scale)


def _zeros(n: int) -> nn.Parameter:
    return nn.Parameter(torch.zeros(n))


class Dense(nn.Module):
    """``{"w": (d_in, d_out), "b": (d_out,)}``."""

    def __init__(self, w: nn.Parameter, b: nn.Parameter):
        super().__init__()
        self.w = w
        self.b = b


# ---------------------------------------------------------------------------
# building blocks: functions over trees, modules that hold the trees
# ---------------------------------------------------------------------------

def mlp_layers(gen: torch.Generator, dims: Sequence[int]) -> nn.ModuleList:
    """``mlp_init``: w ~ N(0, 2 / d_in), b = 0."""
    return nn.ModuleList(
        Dense(_normal(gen, (d_in, d_out), math.sqrt(2.0 / d_in)),
              _zeros(d_out))
        for d_in, d_out in zip(dims[:-1], dims[1:]))


def mlp_apply(layers, x, final_linear: bool = True):
    for i, l in enumerate(layers):
        x = x @ l["w"] + l["b"]
        if i < len(layers) - 1 or not final_linear:
            x = torch.tanh(x)
    return x


def conv_layers(gen: torch.Generator, in_channels: int,
                filters: Sequence[Tuple[int, int, int]]) -> nn.ModuleList:
    """``conv_init``: HWIO w ~ N(0, 2 / (k * k * c_in)), b = 0."""
    layers = []
    c_in = in_channels
    for (c_out, k, _s) in filters:
        layers.append(Dense(
            _normal(gen, (k, k, c_in, c_out), math.sqrt(2.0 / (k * k * c_in))),
            _zeros(c_out)))
        c_in = c_out
    return nn.ModuleList(layers)


def conv_apply(layers, x, filters: Sequence[Tuple[int, int, int]]):
    """x: (B, H, W, C) → (B, features) after flatten.  The stack runs in
    NCHW with XLA's "SAME" pads (asymmetric where the total is odd:
    ``models/resnet.py``'s ``_conv``); the output is permuted back to
    NHWC before it is flattened, as the JAX package flattens it."""
    x = x.permute(0, 3, 1, 2)
    for l, (_c, _k, s) in zip(layers, filters):
        x = F.relu(_conv(x, l["w"], s) + l["b"][:, None, None])
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


def conv_out_dim(obs_shape: Sequence[int],
                 filters: Sequence[Tuple[int, int, int]]) -> int:
    h, w = obs_shape[0], obs_shape[1]
    c = obs_shape[2]
    for (c_out, _k, s) in filters:
        h = -(-h // s)  # ceil: SAME padding
        w = -(-w // s)
        c = c_out
    return h * w * c


class _Gate(nn.Module):
    """GRU-style gate params (GTrXL: g = GRU(x, y))."""

    def __init__(self, gen: torch.Generator, dim: int, scale: float):
        super().__init__()
        self.wr = _normal(gen, (2 * dim, dim), scale)
        self.wz = _normal(gen, (2 * dim, dim), scale)
        self.wh = _normal(gen, (2 * dim, dim), scale)
        # bias >0 biases the gate toward identity at init — the GTrXL
        # trick that makes RL training stable
        self.bz = nn.Parameter(torch.full((dim,), 2.0))
        self.br = _zeros(dim)


class _LayerNorm(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.g = nn.Parameter(torch.ones(dim))
        self.b = _zeros(dim)


class GTrXLBlock(nn.Module):
    """GTrXL-style gated causal self-attention block (reference:
    models/torch/attention_net.py:37 GTrXLNet — transformer layers with
    GRU-type gating for RL stability).  One block: LN → causal MHA →
    GRU gate → LN → MLP → GRU gate (``attention_init``'s tree)."""

    def __init__(self, gen: torch.Generator, dim: int, n_heads: int,
                 context_len: int = 0):
        super().__init__()
        if dim % n_heads:
            raise ValueError(
                f"attention dim {dim} must divide by n_heads {n_heads}")
        self.n_heads = n_heads
        scale = math.sqrt(1.0 / dim)

        def lin(d_in, d_out):
            return Dense(_normal(gen, (d_in, d_out), scale), _zeros(d_out))

        self.qkv = lin(dim, 3 * dim)
        self.proj = lin(dim, dim)
        self.mlp1 = lin(dim, 2 * dim)
        self.mlp2 = lin(2 * dim, dim)
        self.gate1 = _Gate(gen, dim, scale)
        self.gate2 = _Gate(gen, dim, scale)
        self.ln1 = _LayerNorm(dim)
        self.ln2 = _LayerNorm(dim)
        if context_len:
            # learned absolute positions over the chunk-local context:
            # without them attention is permutation-invariant over the
            # window and cannot express "the previous step"
            self.pos = _normal(gen, (context_len, dim), scale)

    def forward(self, x, mask=None):
        return attention_apply(module_tree(self), x, self.n_heads, mask)


def _ln(p, x):
    m = x.mean(-1, keepdim=True)
    v = x.var(-1, unbiased=False, keepdim=True)
    return (x - m) / torch.sqrt(v + 1e-5) * p["g"] + p["b"]


def _gru_gate(p, x, y):
    """g = GRU-style gate combining residual x with sublayer output y."""
    xy = torch.cat([x, y], dim=-1)
    r = torch.sigmoid(xy @ p["wr"] + p["br"])
    z = torch.sigmoid(xy @ p["wz"] - p["bz"])
    h = torch.tanh(torch.cat([r * x, y], dim=-1) @ p["wh"])
    return (1 - z) * x + z * h


def attention_apply(params, x, n_heads: int, mask=None):
    """x: (B, T, dim) → (B, T, dim); causal (position t attends ≤ t).
    ``mask``: optional extra (B, T, T) bool, ANDed with the causal mask
    (segment cuts at episode boundaries, validity windows).  Plain
    arithmetic as the JAX package's (a -1e9 fill, not SDPA)."""
    B, T, D = x.shape
    hd = D // n_heads
    if "pos" in params:
        x = x + params["pos"][:T]
    h = _ln(params["ln1"], x)
    qkv = h @ params["qkv"]["w"] + params["qkv"]["b"]
    q, k, v = torch.split(qkv, D, dim=-1)

    def heads(t):
        return t.reshape(B, T, n_heads, hd).transpose(1, 2)

    q, k, v = heads(q), heads(k), heads(v)
    scores = q @ k.transpose(-1, -2) / math.sqrt(hd)
    allow = torch.tril(torch.ones((T, T), dtype=torch.bool,
                                  device=x.device))[None, None]
    if mask is not None:
        allow = allow & mask[:, None]
    # a fully-masked row (pre-episode padding) must not NaN: keep the
    # diagonal open
    allow = allow | torch.eye(T, dtype=torch.bool, device=x.device)[None, None]
    scores = torch.where(allow, scores, torch.full_like(scores, -1e9))
    att = torch.softmax(scores, dim=-1) @ v          # (B, H, T, hd)
    att = att.transpose(1, 2).reshape(B, T, D)
    att = att @ params["proj"]["w"] + params["proj"]["b"]
    x = _gru_gate(params["gate1"], x, att)
    h2 = _ln(params["ln2"], x)
    m = F.relu(h2 @ params["mlp1"]["w"] + params["mlp1"]["b"])
    m = m @ params["mlp2"]["w"] + params["mlp2"]["b"]
    return _gru_gate(params["gate2"], x, m)


class LSTMCell(nn.Module):
    """``lstm_init``: one fused (in_dim + cell, 4 * cell) weight over
    ``[x, h]``, gate order i, f, g, o, and one bias holding the
    forget-gate bias 1.0 (``nn.LSTM`` splits weights and biases
    otherwise)."""

    def __init__(self, gen: torch.Generator, in_dim: int, cell: int):
        super().__init__()
        self.w = _normal(gen, (in_dim + cell, 4 * cell),
                         math.sqrt(1.0 / (in_dim + cell)))
        b = torch.zeros(4 * cell)
        b[cell:2 * cell] = 1.0  # forget gate: gradient flow at init
        self.b = nn.Parameter(b)

    def forward(self, carry, x):
        return lstm_step(module_tree(self), carry, x)


def lstm_step(params, carry, x):
    """One LSTM cell step.  carry = (h, c), x: (B, in_dim)."""
    h, c = carry
    z = torch.cat([x, h], dim=-1) @ params["w"] + params["b"]
    i, f, g, o = torch.chunk(z, 4, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h = torch.sigmoid(o) * torch.tanh(c)
    return (h, c)


# ---------------------------------------------------------------------------
# encoder: obs -> feature vector (conv stack for rank-3 obs, then MLP)
# ---------------------------------------------------------------------------

class Encoder(nn.Module):
    """Configured obs→features network over the tree ``{"mlp": [...],
    "conv": [...]}`` (conv for rank-3 observations only).

    ``obs_shape`` is the single-observation shape.  Rank-3 shapes get
    the conv stack; the MLP tower follows in both cases.  The encoder
    output dim is ``feature_dim``."""

    def __init__(self, obs_shape: Sequence[int], config: ModelConfig,
                 gen: torch.Generator):
        super().__init__()
        self.obs_shape = tuple(obs_shape)
        self.config = config
        if len(self.obs_shape) == 3:
            self.filters = (config.conv_filters
                            or default_conv_filters(self.obs_shape))
            flat = conv_out_dim(self.obs_shape, self.filters)
        elif len(self.obs_shape) == 1:
            self.filters = None
            flat = self.obs_shape[0]
        else:
            raise ValueError(
                f"unsupported observation rank: {self.obs_shape} "
                "(flatten dict/tuple spaces in a connector)")
        self.mlp_dims = (flat, *config.fcnet_hiddens)
        self.feature_dim = (config.fcnet_hiddens[-1]
                            if config.fcnet_hiddens else flat)
        self.mlp = mlp_layers(gen, self.mlp_dims)
        if self.filters is not None:
            self.conv = conv_layers(gen, self.obs_shape[2], self.filters)

    def apply(self, params, obs):
        """obs: (B, *obs_shape) → (B, feature_dim) over the tree
        ``params`` (this encoder's or another of its config's)."""
        x = obs
        if self.filters is not None:
            x = conv_apply(params["conv"], x, self.filters)
        # final_linear=False: features end in a nonlinearity; heads are
        # the linear readouts
        return mlp_apply(params["mlp"], x, final_linear=False)

    def forward(self, obs):
        return self.apply(module_tree(self), obs)
