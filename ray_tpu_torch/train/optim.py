"""AdamW with optax's semantics over a tree of tensors.

Counterpart of ``optax.adamw`` as the JAX package uses it
(``bench.py:351``: ``optax.adamw(3e-4, weight_decay=0.1)``): the chain
scale_by_adam -> add_decayed_weights -> scale_by_learning_rate, with
optax's defaults b1=0.9, b2=0.999, eps=1e-8, eps_root=0 and its default
weight_decay of 1e-4 (torch's AdamW defaults to 0.01, so the port does
not use it).  Every leaf decays, biases and LayerNorm included, as
optax does without a mask.

Parameters are nested dicts (and lists) of tensors (the JAX pytree's
layout); the state holds first and second moments in the same layout
and the step count, a 0-d int32 tensor on the host as optax's
``count`` is an int32 array (so a program registry keys it by shape
and dtype, not by value, and reading it needs no device sync).
``update_`` changes parameters and moments in place, which is what
JAX's buffer donation amounts to.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List

import torch

Tree = Any


def tree_leaves(tree: Tree) -> List[torch.Tensor]:
    """Leaves of nested dicts and lists, dicts in sorted-key order and
    lists in order (jax.tree_util's order)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, list):
        return [leaf for node in tree for leaf in tree_leaves(node)]
    return [tree]


def tree_map(fn: Callable, tree: Tree) -> Tree:
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def tree_unflatten(like: Tree, leaves: List[torch.Tensor]) -> Tree:
    """The tree of ``like``'s layout holding ``leaves`` (in
    tree_leaves order)."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, list):
            return [build(v) for v in node]
        return next(it)

    return build(like)


@dataclasses.dataclass(frozen=True)
class AdamW:
    """optax.adamw's arithmetic, step by step:

        mu  = b1 * mu + (1 - b1) * g
        nu  = b2 * nu + (1 - b2) * g**2
        u   = (mu / (1 - b1**t)) / (sqrt(nu / (1 - b2**t) + eps_root) + eps)
        p  += -lr * (u + weight_decay * p)
    """
    learning_rate: float
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    eps_root: float = 0.0
    weight_decay: float = 1e-4

    def init(self, params: Tree) -> Dict[str, Any]:
        """{"count": steps taken (0-d int32, CPU), "mu": zeros, "nu":
        zeros} (moments in the parameters' layout and dtype)."""
        return {"count": torch.zeros((), dtype=torch.int32),
                "mu": tree_map(torch.zeros_like, params),
                "nu": tree_map(torch.zeros_like, params)}

    @torch.no_grad()
    def update_(self, params: Tree, grads: List[torch.Tensor],
                state: Dict[str, Any]) -> None:
        """One step, in place on ``params`` and ``state``; ``grads`` in
        tree_leaves order of ``params``."""
        # a new count tensor, not += : a caller's copy of the state
        # (donate=False) shares the old one
        state["count"] = state["count"] + 1
        t = int(state["count"])
        bc1 = 1.0 - self.b1 ** t
        bc2 = 1.0 - self.b2 ** t
        for p, g, mu, nu in zip(tree_leaves(params), grads,
                                tree_leaves(state["mu"]),
                                tree_leaves(state["nu"])):
            mu.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            nu.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            denom = (nu / bc2).add_(self.eps_root).sqrt_().add_(self.eps)
            u = (mu / bc1).div_(denom)
            u.add_(p, alpha=self.weight_decay)
            p.add_(u, alpha=-self.learning_rate)


def adamw(learning_rate: float, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, eps_root: float = 0.0,
          weight_decay: float = 1e-4) -> AdamW:
    """``optax.adamw``'s signature and defaults (no mask, no moment
    dtype option)."""
    return AdamW(learning_rate, b1=b1, b2=b2, eps=eps, eps_root=eps_root,
                 weight_decay=weight_decay)
