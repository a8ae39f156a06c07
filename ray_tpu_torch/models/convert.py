"""Parameter trees between numpy and the port's tensors.

The layout is the JAX package's (``gpt2_init``, ``llama_init``,
``mlp_init``, ``vit_init``, ``resnet_init`` and its batch-norm state);
only the leaves change type.  This is how weights cross
from JAX to the port in the tests, and how ``checkpoint_path`` pickles
load in ``serve/llm.py``.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ray_tpu_torch.device import DeviceLike, resolve_device
from ray_tpu_torch.models.gpt2 import GPT2Config
from ray_tpu_torch.models.llama import LlamaConfig
from ray_tpu_torch.models.mlp import MLPConfig, mlp_dims
from ray_tpu_torch.models.resnet import (ResNetConfig, _block_channels,
                                         _block_kernels)
from ray_tpu_torch.models.vit import ViTConfig


def _gpt2_shapes(cfg: GPT2Config) -> Dict[str, Any]:
    L, d, f, h, hd = (cfg.n_layer, cfg.d_model, cfg.d_ff, cfg.n_head,
                      cfg.head_dim)
    if cfg.n_experts:
        E = cfg.n_experts
        ff = {"moe": {"gate": (L, d, E), "w1": (L, E, d, f),
                      "b1": (L, E, f), "w2": (L, E, f, d),
                      "b2": (L, E, d)}}
    else:
        ff = {"mlp": {"fc_w": (L, d, f), "fc_b": (L, f),
                      "proj_w": (L, f, d), "proj_b": (L, d)}}
    return {
        "wte": (cfg.padded_vocab, d), "wpe": (cfg.max_seq, d),
        "ln_f": {"scale": (d,), "bias": (d,)},
        "blocks": {
            "ln1": {"scale": (L, d), "bias": (L, d)},
            "ln2": {"scale": (L, d), "bias": (L, d)},
            "attn": {"qkv_w": (L, d, 3, h, hd), "qkv_b": (L, 3, h, hd),
                     "o_w": (L, h, hd, d), "o_b": (L, d)},
            **ff,
        },
    }


def _llama_shapes(cfg: LlamaConfig) -> Dict[str, Any]:
    L, d, f = cfg.n_layer, cfg.d_model, cfg.d_ff
    h, kv, hd = cfg.n_head, cfg.n_kv_head, cfg.head_dim
    return {
        "wte": (cfg.padded_vocab, d), "lm_head": (d, cfg.padded_vocab),
        "ln_f": {"scale": (d,)},
        "blocks": {
            "ln1": {"scale": (L, d)}, "ln2": {"scale": (L, d)},
            "attn": {"wq": (L, d, h, hd), "wk": (L, d, kv, hd),
                     "wv": (L, d, kv, hd), "wo": (L, h, hd, d)},
            "mlp": {"w_gate": (L, d, f), "w_up": (L, d, f),
                    "w_down": (L, f, d)},
        },
    }


def _mlp_shapes(cfg: MLPConfig) -> Dict[str, Any]:
    return {"layers": [{"w": (d_in, d_out), "b": (d_out,)}
                       for d_in, d_out in mlp_dims(cfg)]}


def _vit_shapes(cfg: ViTConfig) -> Dict[str, Any]:
    L, d, f, h, hd = (cfg.n_layer, cfg.d_model, cfg.d_ff, cfg.n_head,
                      cfg.head_dim)
    return {
        "patch_w": (cfg.patch_size ** 2 * 3, d), "patch_b": (d,),
        "pos": (cfg.n_patches + 1, d), "cls": (1, d),
        "ln_f": {"scale": (d,), "bias": (d,)},
        "head_w": (d, cfg.n_classes), "head_b": (cfg.n_classes,),
        "blocks": {
            "ln1": {"scale": (L, d), "bias": (L, d)},
            "ln2": {"scale": (L, d), "bias": (L, d)},
            "attn": {"qkv_w": (L, d, 3, h, hd), "qkv_b": (L, 3, h, hd),
                     "o_w": (L, h, hd, d), "o_b": (L, d)},
            "mlp": {"fc_w": (L, d, f), "fc_b": (L, f),
                    "proj_w": (L, f, d), "proj_b": (L, d)},
        },
    }


def _resnet_shapes(cfg: ResNetConfig, state: bool = False):
    """The parameter tree's shapes, or with ``state`` the batch-norm
    state's."""
    def bn(c):
        return ({"mean": (c,), "var": (c,)} if state
                else {"scale": (c,), "bias": (c,)})

    blocks = []
    for cin, cmid, cout in _block_channels(cfg):
        kernels = _block_kernels(cfg, cin, cmid, cout)
        blk: Dict[str, Any] = {"bns": [bn(c) for _, _, c in kernels]}
        if not state:
            blk["convs"] = [(k, k, ci, co) for k, ci, co in kernels]
        if cin != cout:
            blk["proj_bn"] = bn(cout)
            if not state:
                blk["proj"] = (1, 1, cin, cout)
        blocks.append(blk)
    if state:
        return {"stem": bn(cfg.width), "blocks": blocks}
    chead = _block_channels(cfg)[-1][2]
    return {"stem": {"conv": (7, 7, 3, cfg.width), "bn": bn(cfg.width)},
            "blocks": blocks,
            "head": {"w": (chead, cfg.n_classes), "b": (cfg.n_classes,)}}


def _leaf_to_tensor(leaf, device: torch.device) -> torch.Tensor:
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":
        # numpy has no bfloat16 of its own (JAX's comes from
        # ml_dtypes); widening to f32 is exact, narrowing back is too
        return torch.from_numpy(arr.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    # np.array copies: the tensor owns writable memory even when the
    # source array is read-only (as JAX's host arrays are)
    return torch.from_numpy(np.array(arr)).to(device)


def _from_numpy(tree, want, family: str, device: DeviceLike):
    """Walk ``tree`` against the expected shapes ``want``: the same tree
    of tensors on ``device``, dtypes kept; ValueError naming the path
    on a key or shape that does not match."""
    dev = resolve_device(device)

    def walk(node, want, path):
        if isinstance(want, dict):
            if not isinstance(node, dict) or set(node) != set(want):
                got = sorted(node) if isinstance(node, dict) else node
                raise ValueError(f"{family} params at {path or 'root'}: "
                                 f"expected keys {sorted(want)}, got "
                                 f"{got}")
            return {k: walk(node[k], want[k], f"{path}/{k}")
                    for k in want}
        if isinstance(want, list):
            if not isinstance(node, (list, tuple)) or len(node) != len(
                    want):
                got = len(node) if isinstance(node, (list, tuple)) else node
                raise ValueError(f"{family} params at {path or 'root'}: "
                                 f"expected a list of {len(want)}, got "
                                 f"{got}")
            return [walk(n, w, f"{path}/{i}")
                    for i, (n, w) in enumerate(zip(node, want))]
        t = _leaf_to_tensor(node, dev)
        if tuple(t.shape) != want:
            raise ValueError(f"{family} param {path}: expected shape "
                             f"{want}, got {tuple(t.shape)}")
        return t

    return walk(tree, want, "")


def gpt2_params_from_numpy(tree, cfg: GPT2Config,
                           device: DeviceLike = None) -> Dict[str, Any]:
    """A GPT-2 parameter tree of numpy arrays (or anything np.asarray
    takes) → the same tree of tensors on ``device``, dtypes kept.
    Raises ValueError when the keys or shapes do not match ``cfg``."""
    return _from_numpy(tree, _gpt2_shapes(cfg), "GPT-2", device)


def llama_params_from_numpy(tree, cfg: LlamaConfig,
                            device: DeviceLike = None) -> Dict[str, Any]:
    """The same for a llama parameter tree (``llama_init``'s layout)."""
    return _from_numpy(tree, _llama_shapes(cfg), "llama", device)


def mlp_params_from_numpy(tree, cfg: MLPConfig,
                          device: DeviceLike = None) -> Dict[str, Any]:
    """The same for an MLP parameter tree (``mlp_init``'s layout: a
    list of layers)."""
    return _from_numpy(tree, _mlp_shapes(cfg), "MLP", device)


def vit_params_from_numpy(tree, cfg: ViTConfig,
                          device: DeviceLike = None) -> Dict[str, Any]:
    """The same for a ViT parameter tree (``vit_init``'s layout)."""
    return _from_numpy(tree, _vit_shapes(cfg), "ViT", device)


def resnet_params_from_numpy(tree, cfg: ResNetConfig,
                             device: DeviceLike = None) -> Dict[str, Any]:
    """The same for a ResNet parameter tree (``resnet_init``'s params:
    lists of blocks)."""
    return _from_numpy(tree, _resnet_shapes(cfg), "ResNet", device)


def resnet_state_from_numpy(tree, cfg: ResNetConfig,
                            device: DeviceLike = None) -> Dict[str, Any]:
    """The same for ResNet's batch-norm state (``resnet_init``'s
    second tree)."""
    return _from_numpy(tree, _resnet_shapes(cfg, state=True),
                       "ResNet state", device)


def gpt2_params_to_numpy(params) -> Dict[str, Any]:
    """The inverse, for every family: a tree of tensors → a tree of
    numpy arrays on the host.  bfloat16 leaves come back as float32
    (exact), since numpy has no bfloat16."""
    if isinstance(params, dict):
        return {k: gpt2_params_to_numpy(v) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [gpt2_params_to_numpy(v) for v in params]
    t = params.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


llama_params_to_numpy = gpt2_params_to_numpy
mlp_params_to_numpy = gpt2_params_to_numpy
vit_params_to_numpy = gpt2_params_to_numpy
resnet_params_to_numpy = gpt2_params_to_numpy
