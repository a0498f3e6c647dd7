"""Stacked-tree helpers (port of ``src/repro/utils/tree.py``).

Federated state is a *stacked* tree: nested dicts / lists / tuples /
NamedTuples of tensors whose every leaf carries a leading ``clients``
axis, so a mean over clients is ``mean(dim=0)`` on every leaf. The tree
plumbing is ``torch.utils._pytree``, the same one ``torch.func`` uses.
"""

from __future__ import annotations

import torch
from torch.utils import _pytree as pytree


def tree_leaves(tree) -> list:
    return pytree.tree_flatten(tree)[0]


def tree_map(fn, tree, *rest):
    """``fn`` applied leaf-wise over trees of one structure."""
    leaves, spec = pytree.tree_flatten(tree)
    others = [pytree.tree_flatten(r)[0] for r in rest]
    for o in others:
        if len(o) != len(leaves):
            raise ValueError("tree_map over trees of different structure")
    return pytree.tree_unflatten(
        [fn(*args) for args in zip(leaves, *others)], spec)


def tree_index(tree, i: int):
    """Entry ``i`` of the leading axis of every leaf: one layer of a
    stacked ``[L, ...]`` parameter tree."""
    return tree_map(lambda t: t[i], tree)


def tree_zeros_like(a):
    return tree_map(torch.zeros_like, a)


def tree_client_mean(a, *, keepdims: bool = True):
    """Mean over the leading clients axis of every leaf.

    With ``keepdims=True`` the result keeps the ``[1, ...]`` axis, so it
    broadcasts back against the stacked tree (the server broadcast)."""
    return tree_map(lambda x: torch.mean(x, dim=0, keepdim=keepdims), a)


def tree_num_params(a) -> int:
    return sum(x.numel() for x in tree_leaves(a))
