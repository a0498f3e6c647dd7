"""Parameter / input / cache sharding specs (port of
``src/repro/launch/partition.py``), and their DTensor placements.

A spec is the reference's ``PartitionSpec`` as a plain tuple, one entry
per tensor dim: an axis name, a tuple of names, or ``None``; so a spec
compares with the reference's entry for entry. Rules are name-based over
the parameter-tree paths (``layers/attn/wq``), and divisibility-aware: a
dimension is only sharded over `model` when its size divides the axis;
otherwise the rule falls through to the next-best dim (granite's 40
experts don't divide a 16-way model axis, so its expert FFN shards the
tiny d_ff instead). Megatron conventions throughout: column-parallel
in-projections, row-parallel out-projections, vocab-sharded embeddings,
expert-parallel MoE when divisible.

Stacked leading dims (layers ``[L, ...]``, hybrid groups ``[G, every,
...]``, and the federated clients axis) are handled by right-aligning the
rule to the trailing logical dims and padding/prepending the rest.

``utils/sharding_ctx.py:spec_placements`` turns a spec into placements:
``Shard(i)`` on each mesh dim named in dim ``i``, ``Replicate()``
elsewhere. ``distribute`` turns a tree and its specs into DTensors: a
``meta`` leaf becomes a fake local shard wrapped by
``DTensor.from_local`` (nothing the size of the global array is ever
allocated), a real one goes through ``distribute_tensor``.
"""

from __future__ import annotations

import math

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.utils import _pytree as pytree

from repro_torch.launch.mesh import axis_size, client_axes as _client_axes
from repro_torch.utils.sharding_ctx import spec_placements


def _tp_if(n: int, tp: int):
    return "model" if n % tp == 0 and n >= tp else None


def _base_spec(path: tuple[str, ...], shape: tuple[int, ...], tp: int):
    """Spec for the TRAILING logical dims of one leaf. Returns a tuple whose
    length is the number of trailing dims it claims."""
    names = set(path)
    last = path[-1]
    in_moe = "moe" in names and "shared" not in names

    if last == "embed":
        return (_tp_if(shape[-2], tp), None)
    if last == "lm_head":
        return (None, _tp_if(shape[-1], tp))
    if last == "router":
        return (None, None)
    if in_moe and last in ("gate", "up"):
        e, _, f = shape[-3:]
        if e % tp == 0:
            return ("model", None, None)
        return (None, None, _tp_if(f, tp))
    if in_moe and last == "down":
        e, f, _ = shape[-3:]
        if e % tp == 0:
            return ("model", None, None)
        return (None, _tp_if(f, tp), None)
    if last in ("wq", "wk", "wv", "gate", "up", "wz", "wx"):
        return (None, _tp_if(shape[-1], tp))
    if last in ("wo", "out_proj", "down"):
        return (_tp_if(shape[-2], tp), None)
    if last == "conv_w":
        return (_tp_if(shape[-2], tp), None)
    # norms, biases, A_log, D, dt_bias, wB, wC, wdt, q_norm, ... -> replicated
    return ()


def _with_extra_axis(base: tuple, shape: tuple[int, ...], extra_axis: str,
                     extra_size: int) -> tuple:
    """ZeRO/2D-TP second weight axis: assign `extra_axis` to the first
    still-unsharded logical dim it divides."""
    if not base or extra_size <= 1:
        return base
    dims = shape[-len(base):]
    out = list(base)
    for i, (ax, dim) in enumerate(zip(base, dims)):
        if ax is None and dim % extra_size == 0 and dim >= extra_size:
            out[i] = extra_axis
            break
    return tuple(out)


def param_pspec(path: tuple[str, ...], leaf, tp: int,
                client_axes: tuple[str, ...] = (),
                extra_axis: str | None = None, extra_size: int = 1) -> tuple:
    base = _base_spec(path, leaf.shape, tp)
    if extra_axis:
        base = _with_extra_axis(base, leaf.shape, extra_axis, extra_size)
    n_pad = leaf.ndim - len(base) - (1 if client_axes else 0)
    if n_pad < 0:  # scalar-ish leaf under clients axis
        return (client_axes,) if client_axes else ()
    front = ((client_axes,) if client_axes else ())
    return (*front, *(None,) * n_pad, *base)


def _path_names(kp) -> tuple[str, ...]:
    names = []
    for k in kp:
        if hasattr(k, "key"):
            names.append(str(k.key))
        elif hasattr(k, "idx"):
            names.append(str(k.idx))
        elif hasattr(k, "name"):
            names.append(str(k.name))
    return tuple(names)


def _leaves(tree):
    """[(path names, leaf)] and the tree's structure."""
    flat, treedef = pytree.tree_flatten_with_path(tree)
    return [(_path_names(kp), leaf) for kp, leaf in flat], treedef


def tree_pspecs(tree, tp: int, client_axes: tuple[str, ...] = (),
                extra_axis: str | None = None,
                extra_size: int = 1) -> list[tuple[tuple[str, ...], tuple]]:
    """[(path, spec)] for every tensor leaf of ``tree``, in leaf order."""
    leaves, _ = _leaves(tree)
    return [(path, param_pspec(path, leaf, tp, client_axes, extra_axis,
                               extra_size))
            for path, leaf in leaves if isinstance(leaf, torch.Tensor)]


def tree_shardings(tree, mesh: DeviceMesh, tp: int,
                   client_axes: tuple[str, ...] = (),
                   extra_axis: str | None = None):
    """A tree of specs mirroring ``tree``'s tensor leaves (other leaves
    come back as they are)."""
    extra_size = axis_size(mesh, extra_axis) if extra_axis else 1
    specs = iter(s for _, s in tree_pspecs(tree, tp, client_axes,
                                           extra_axis, extra_size))
    return _map_tensors(lambda path, leaf: next(specs), tree)


def _map_tensors(fn, tree):
    leaves, treedef = _leaves(tree)
    return pytree.tree_unflatten(
        [_Spec(fn(path, leaf)) if isinstance(leaf, torch.Tensor) else leaf
         for path, leaf in leaves], treedef)


class _Spec(tuple):
    """A spec kept as one leaf of a spec tree: a bare tuple would be a
    pytree node, a subclass pytree does not know is a leaf."""


def spec_leaves(spec_tree) -> list:
    """The specs of a spec tree, in leaf order (``None`` where the tree
    holds a non-tensor leaf)."""
    flat = pytree.tree_leaves(spec_tree)
    return [tuple(s) if isinstance(s, _Spec) else None for s in flat]


# --------------------------------------------------------------- serve side
def cache_pspec(path: tuple[str, ...], leaf, tp: int, dp, seq_axes) -> tuple:
    """KV/SSM cache sharding. dp = axis (tuple) for the batch dim or None;
    seq_axes = axes for the cache slot/seq dim (the long dim)."""
    last = path[-1]
    if last in ("k", "v"):           # [.., B, cap, Hkv, Dh]
        base = (dp, seq_axes, None, None)
    elif last in ("cross_k", "cross_v"):  # [.., B, T_enc, H, Dh]
        base = (dp, None, None, None)
    elif last == "conv":             # [.., B, K-1, ch]
        base = (dp, None, _tp_if(leaf.shape[-1], tp))
    elif last == "state":            # [.., B, H, P, N]
        h, p_dim = leaf.shape[-3], leaf.shape[-2]
        if h % tp == 0 and h >= tp:
            base = (dp, "model", None, None)
        elif p_dim % tp == 0 and p_dim >= tp:
            base = (dp, None, "model", None)
        else:
            base = (dp, None, None, None)
    else:                            # pos, length, ...
        return (None,) * leaf.ndim
    n_pad = leaf.ndim - len(base)
    return (*(None,) * n_pad, *base)


def _axes_size(mesh: DeviceMesh, ax) -> int:
    axes = ax if isinstance(ax, tuple) else ((ax,) if ax else ())
    return math.prod(axis_size(mesh, a) for a in axes)


def cache_shardings(caches, mesh: DeviceMesh, *, batch: int):
    """Specs for a cache tree. Batch gets the client/data axes when it
    divides them; otherwise the sequence dim absorbs ALL mesh axes (the
    long_500k single-request layout). A dim the axes' size does not divide
    is left unsharded."""
    tp = axis_size(mesh, "model")
    ca = _client_axes(mesh)
    dp_size = math.prod(axis_size(mesh, a) for a in ca)
    if batch % dp_size == 0 and batch >= dp_size:
        dp, seq_axes = ca, "model"
    else:
        dp, seq_axes = None, ca + ("model",)

    def assign(path, leaf):
        spec = cache_pspec(path, leaf, tp, dp, seq_axes)
        fixed = []
        for ax, dim in zip(spec, leaf.shape):
            size = _axes_size(mesh, ax)
            fixed.append(ax if size and dim % size == 0 and dim >= size
                         else None)
        return tuple(fixed)

    return _map_tensors(assign, caches)


def batch_shardings(batch_tree, mesh: DeviceMesh, *, dim_axes: tuple):
    """Input batches: ``dim_axes`` gives the axis (or axis tuple) for each
    leading dim; remaining dims are replicated. Serve: ``dim_axes =
    (batch_axes,)`` for ``[B, ...]``."""
    return _map_tensors(
        lambda path, leaf: (*dim_axes, *(None,) * (leaf.ndim - len(dim_axes))),
        batch_tree)


# ------------------------------------------------------------- placements
def local_shape(shape, spec, mesh: DeviceMesh) -> tuple[int, ...]:
    """One rank's shard shape of a tensor of ``shape`` under ``spec``. The
    rules shard only dims their axes divide; anything else raises."""
    out = []
    for dim, ax in zip(shape, tuple(spec) + (None,) * (len(shape)
                                                       - len(spec))):
        n = _axes_size(mesh, ax)
        if dim % n:
            raise ValueError(f"dim {dim} of {tuple(shape)} does not divide "
                             f"over {ax} ({n}) in spec {spec}")
        out.append(dim // n)
    return tuple(out)


def _distribute_leaf(leaf, spec, mesh: DeviceMesh, fake_mode):
    from torch.distributed.tensor import DTensor, distribute_tensor

    placements = spec_placements(spec, mesh)
    if isinstance(leaf, DTensor):
        return leaf.redistribute(mesh, placements)
    if leaf.device.type != "meta":
        return distribute_tensor(leaf, mesh, placements)
    with fake_mode:
        local = torch.empty(local_shape(leaf.shape, spec, mesh),
                            dtype=leaf.dtype, device=mesh.device_type)
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=leaf.shape,
                              stride=torch.empty(leaf.shape,
                                                 device="meta").stride())


def distribute(tree, spec_tree, mesh: DeviceMesh, fake_mode=None):
    """DTensors of ``tree``'s tensor leaves under the specs of
    ``spec_tree`` (from ``tree_shardings`` / ``cache_shardings`` /
    ``batch_shardings``). ``meta`` leaves become fake local shards of
    ``fake_mode`` (a ``FakeTensorMode``); DTensors are redistributed (a
    step's output passed to the next); other leaves are distributed from
    their values."""
    leaves, treedef = pytree.tree_flatten(tree)
    specs = spec_leaves(spec_tree)
    if len(specs) != len(leaves):
        raise ValueError("distribute: the spec tree does not mirror the tree")
    out = []
    for leaf, spec in zip(leaves, specs):
        if isinstance(leaf, torch.Tensor):
            if leaf.device.type == "meta" and fake_mode is None:
                raise ValueError("distribute: meta leaves need a fake_mode")
            leaf = _distribute_leaf(leaf, spec, mesh, fake_mode)
        out.append(leaf)
    return pytree.tree_unflatten(out, treedef)


def local_bytes(tree) -> int:
    """The bytes of this rank's shards of a tree of DTensors (plain
    tensors count whole)."""
    from torch.distributed.tensor import DTensor

    total = 0
    for t in pytree.tree_leaves(tree):
        if isinstance(t, DTensor):
            t = t._local_tensor
        if isinstance(t, torch.Tensor):
            total += t.numel() * t.element_size()
    return total
