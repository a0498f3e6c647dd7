"""Checkpointing: tensor tree <-> ``.npz`` (port of
``src/repro/checkpoint/ckpt.py``), in the reference's file layout, so a
checkpoint crosses between the two packages in both directions.

The layout: one ``leaf_<i>`` array per leaf, numbered in JAX's flatten
order, plus a ``treedef`` byte string that describes the structure
(``torch.utils._pytree``'s tree spec here) and that no loader reads.
JAX's order is not ``torch.utils._pytree``'s, so this module walks trees
itself: dicts by sorted key, lists, tuples and NamedTuples in order,
``None`` as an empty node, an :class:`~repro_torch.core.arena.Arena` as
its one ``data`` leaf. The
port's step counters are Python ints where the reference holds 0-d
integer arrays: an int is written as a 0-d int32 array in the same slot
and restored as an int. Loading restores into the structure of a
``like`` tree, each tensor onto its ``like`` leaf's device; steps are
retained round-robin (``keep`` most recent).
"""

from __future__ import annotations

import json
import os
import re

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch.core.arena import Arena


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _flatten(tree) -> list:
    """The leaves of ``tree`` in JAX's flatten order."""
    out = []

    def walk(node):
        if node is None:
            return
        if isinstance(node, Arena):
            out.append(node.data)
        elif isinstance(node, dict):
            for k in sorted(node):
                walk(node[k])
        elif isinstance(node, (list, tuple)):
            for c in node:
                walk(c)
        else:
            out.append(node)

    walk(tree)
    return out


def _unflatten(like, leaves: list):
    """``like``'s structure (its dict key order included) around
    ``leaves`` given in JAX's flatten order."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        if isinstance(node, Arena):
            return Arena(_restore_leaf(next(it), node.data), node.layout)
        if isinstance(node, dict):
            vals = {k: build(node[k]) for k in sorted(node)}
            return type(node)((k, vals[k]) for k in node)
        if _is_namedtuple(node):
            return type(node)(*[build(c) for c in node])
        if isinstance(node, (list, tuple)):
            return type(node)(build(c) for c in node)
        return _restore_leaf(next(it), node)

    return build(like)


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    if isinstance(leaf, int):
        return np.asarray(leaf, dtype=np.int32)
    return np.asarray(leaf)


def _restore_leaf(arr: np.ndarray, like):
    if isinstance(like, torch.Tensor):
        return torch.from_numpy(arr).to(like.device)
    if isinstance(like, int):
        return int(arr)
    return arr


def _shape(leaf) -> tuple:
    return tuple(leaf.shape) if isinstance(leaf, torch.Tensor) \
        else tuple(np.shape(leaf))


def save_pytree(path: str, tree) -> None:
    payload = {f"leaf_{i}": _to_numpy(x) for i, x in enumerate(_flatten(tree))}
    payload["treedef"] = np.frombuffer(
        json.dumps(str(pytree.tree_structure(tree))).encode(), dtype=np.uint8)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp.npz"
    np.savez(tmp, **payload)
    os.replace(tmp, path)


def load_pytree(path: str, like):
    """Restore into the structure of ``like`` (whose leaves must match)."""
    with np.load(path) as z:
        n = sum(1 for k in z.files if k.startswith("leaf_"))
        leaves = [z[f"leaf_{i}"] for i in range(n)]
    ref_leaves = _flatten(like)
    if len(ref_leaves) != len(leaves):
        raise ValueError(
            f"checkpoint {path!r} holds {len(leaves)} leaves, the requested "
            f"state layout {len(ref_leaves)}")
    # Leaf count alone cannot detect a reordered state layout (e.g. a
    # checkpoint written by an older state structure): that would restore
    # leaves transposed. Fail loudly on any shape mismatch instead.
    for i, (got, ref) in enumerate(zip(leaves, ref_leaves)):
        if tuple(got.shape) != _shape(ref):
            raise ValueError(
                f"checkpoint {path!r} is incompatible with the requested "
                f"state layout: leaf {i} has shape {tuple(got.shape)}, "
                f"expected {_shape(ref)} (was it written by an "
                "older algorithm-state structure?)")
    return _unflatten(like, leaves)


def save(ckpt_dir: str, step: int, tree, *, keep: int = 3) -> str:
    path = os.path.join(ckpt_dir, f"step_{step:09d}.npz")
    save_pytree(path, tree)
    steps = sorted(all_steps(ckpt_dir))
    for old in steps[:-keep]:
        os.remove(os.path.join(ckpt_dir, f"step_{old:09d}.npz"))
    return path


def all_steps(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for f in os.listdir(ckpt_dir):
        m = re.fullmatch(r"step_(\d+)\.npz", f)
        if m:
            out.append(int(m.group(1)))
    return sorted(out)


def latest_step(ckpt_dir: str) -> int | None:
    steps = all_steps(ckpt_dir)
    return steps[-1] if steps else None


def restore(ckpt_dir: str, like, step: int | None = None):
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            return None, None
    path = os.path.join(ckpt_dir, f"step_{step:09d}.npz")
    return load_pytree(path, like), step
