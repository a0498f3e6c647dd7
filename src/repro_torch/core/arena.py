"""Packed parameter arena: the model tree as ONE lane-aligned buffer (port
of ``src/repro/core/arena.py:1-237``).

The engine's message/aggregate seam is element-wise over the whole model
(compress -> reduce -> FedCET ``(d', x')`` pair). The arena flattens the
tree once into a contiguous ``[rows, LANES]`` buffer (LANES = 1024, the
reference's lane tiling, kept as the shared memory layout) so the seam is
a handful of whole-model passes, and with ``FedCET(use_fused_kernel=True)``
one fused kernel visit per element (``kernels/ops.py:fedcet_round_tail``).

Layout: leaves in ``torch.utils._pytree`` flatten order, each padded up to
a whole number of 1024-lane rows. (torch flattens a dict in insertion
order, JAX in sorted key order: a tree carried across from the reference,
whose dicts arrive sorted, packs in the reference's order.) Pads are ZERO
and every seam operation keeps them zero (add/sub of zero is zero, the
dither is zero-padded so ``floor(0 + 0) = 0``, reductions are per leaf
through the row->leaf segment map). :class:`ArenaLayout` records the
tree structure, per-leaf shapes and row extents; :class:`Arena` is a
pytree node whose one child is ``data`` and whose context is the layout,
so ``tree_map``, ``replicate`` and the client-axis helpers treat it as a
single leaf:

* ``data.dim() == 2``: ``[rows, LANES]``, one model;
* ``data.dim() == 3``: ``[lead, rows, LANES]``, a stacked ``[clients, ...]``
  tree (axis 0 keeps meaning clients).

Pack/unpack happen only at the model-apply boundary (the engine wraps the
vmapped gradient) and in :func:`adapt_state`. ``unpack`` returns VIEWS of
the buffer, not copies.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Any

import torch
from torch.utils import _pytree as pytree

from repro_torch.core.comm import reference_leaf_index
from repro_torch.kernels.threefry import LANES
from repro_torch.utils.spans import spanned

__all__ = ["LANES", "Arena", "ArenaLayout", "adapt_state", "pack",
           "pack_rows", "unpack"]


def _rows_of(shape: tuple) -> int:
    return max(1, -(-math.prod(shape) // LANES))


@dataclasses.dataclass(frozen=True)
class ArenaLayout:
    """Static description of how a tree maps onto the arena."""

    treedef: Any
    shapes: tuple  # per-leaf MODEL shapes (no client axis), flatten order
    dtype: torch.dtype  # the single float dtype every leaf shares
    rows_per_leaf: tuple
    #: per-device row->leaf maps and leaf tables (filled by
    #: :meth:`row_segments` and :meth:`leaf_table`).
    _segments: dict = dataclasses.field(default_factory=dict, compare=False,
                                        repr=False)
    _tables: dict = dataclasses.field(default_factory=dict, compare=False,
                                      repr=False)

    @classmethod
    def for_tree(cls, tree) -> "ArenaLayout":
        """Layout for a MODEL tree (leaves carry no client axis)."""
        leaves, treedef = pytree.tree_flatten(tree)
        if not leaves:
            raise ValueError("cannot build an arena layout for an empty tree")
        dtypes = {torch.as_tensor(leaf).dtype for leaf in leaves}
        if len(dtypes) != 1:
            raise ValueError(
                "arena requires a homogeneous leaf dtype (mixed dtypes would "
                f"change per-leaf rounding): {sorted(map(str, dtypes))}")
        (dtype,) = dtypes
        if not dtype.is_floating_point:
            raise ValueError(f"arena leaves must be floating, got {dtype}")
        shapes = tuple(tuple(leaf.shape) for leaf in leaves)
        return cls(treedef=treedef, shapes=shapes, dtype=dtype,
                   rows_per_leaf=tuple(_rows_of(s) for s in shapes))

    @property
    def rows(self) -> int:
        return sum(self.rows_per_leaf)

    @property
    def num_params(self) -> int:
        return sum(math.prod(s) for s in self.shapes)

    def leaf_sizes(self) -> tuple:
        """Per-leaf coordinate counts in flatten order (the segment index
        of ``row_segments``, the order of ``core/comm.py:leaf_info_of`` on
        the unpacked tree): the ``n`` a
        :class:`~repro_torch.core.compressors.CompressionPlan`'s exact
        ``wire_bits`` rounding bills. Its digit rules name leaves in the
        reference's order instead (``leaf_info_of(...).ref_index``)."""
        return tuple(math.prod(s) for s in self.shapes)

    def row_segments(self, device=None) -> torch.Tensor:
        """Row -> leaf-index map ``[rows]`` (int64) for per-leaf segment
        reductions (quantizer scales) over the packed buffer. Built once
        per device and kept: a fresh host-to-device copy every round would
        wait for the card."""
        device = torch.device("cpu" if device is None else device)
        seg = self._segments.get(device)
        if seg is None:
            seg = torch.repeat_interleave(
                torch.arange(len(self.shapes)),
                torch.tensor(self.rows_per_leaf)).to(device)
            self._segments[device] = seg
        return seg

    def leaf_table(self, device=None) -> torch.Tensor:
        """Per leaf in layout order, ``(first row, element count, index in
        the reference's flatten order)`` as int64 ``[leaves, 3]``: with
        :meth:`row_segments`, what the packed dither draw
        (``kernels/ops.py:arena_uniform``) reads besides the round key. The
        third column is the ``i`` of each leaf's ``fold_in(key, i)``
        (``core/comm.py:reference_leaf_index``). Built once per device and
        kept, as :meth:`row_segments` is."""
        device = torch.device("cpu" if device is None else device)
        table = self._tables.get(device)
        if table is None:
            starts = itertools.accumulate(self.rows_per_leaf[:-1], initial=0)
            index = reference_leaf_index(pytree.tree_unflatten(
                [0] * len(self.shapes), self.treedef))
            table = torch.tensor(list(zip(starts, self.leaf_sizes(), index)),
                                 dtype=torch.int64).to(device)
            self._tables[device] = table
        return table


class Arena:
    """A tree whose leaves live packed in one ``[..., rows, LANES]`` buffer;
    a pytree node with child ``data`` and context ``layout``."""

    __slots__ = ("data", "layout")

    def __init__(self, data, layout: ArenaLayout):
        self.data = data
        self.layout = layout

    def __repr__(self):
        return (f"Arena(shape={tuple(self.data.shape)}, "
                f"leaves={len(self.layout.shapes)}, "
                f"params={self.layout.num_params})")


pytree.register_pytree_node(
    Arena,
    lambda a: ([a.data], a.layout),
    lambda children, layout: Arena(children[0], layout),
    serialized_type_name="repro_torch.core.arena.Arena",
)


def _lead_of(leaf_shape: tuple, model_shape: tuple) -> int | None:
    """None for an unstacked (model-shaped) leaf, else the stack size."""
    if tuple(leaf_shape) == tuple(model_shape):
        return None
    if tuple(leaf_shape[1:]) == tuple(model_shape):
        return int(leaf_shape[0])
    raise ValueError(f"leaf shape {tuple(leaf_shape)} matches neither the "
                     f"model shape {model_shape} nor a stacked [lead, ...] "
                     "of it")


def pack(tree, layout: ArenaLayout | None = None) -> Arena:
    """Flatten ``tree`` (model-shaped, or stacked ``[lead, ...]``) into an
    :class:`Arena`. Padding is zero; pure reshape/concat, bitwise."""
    if layout is None:
        layout = ArenaLayout.for_tree(tree)
    leaves = pytree.tree_leaves(tree)
    if len(leaves) != len(layout.shapes):
        raise ValueError(f"tree has {len(leaves)} leaves, layout expects "
                         f"{len(layout.shapes)}")
    leads = {_lead_of(leaf.shape, s) for leaf, s in zip(leaves, layout.shapes)}
    if len(leads) != 1:
        raise ValueError(f"inconsistent leading axes across leaves: {leads}")
    (lead,) = leads
    return Arena(pack_rows(leaves, layout, lead=lead), layout)


@spanned("pack")
def pack_rows(leaves, layout: ArenaLayout, lead: int | None = None):
    """Pack a list of per-leaf tensors (layout order; model-shaped, or
    ``[lead, ...]``-stacked when ``lead`` is given) into a raw
    ``[(lead,) rows, LANES]`` buffer: leaves and their zero pads go into
    ONE concatenation, so the buffer is written once."""
    parts = []
    ref = leaves[0]
    for leaf, shape, nr in zip(leaves, layout.shapes, layout.rows_per_leaf):
        n = math.prod(shape)
        parts.append(leaf.reshape((n,) if lead is None else (lead, n)))
        if nr * LANES != n:
            pad = (nr * LANES - n,) if lead is None else (lead, nr * LANES - n)
            parts.append(torch.zeros(pad, dtype=layout.dtype,
                                     device=ref.device))
    flat = torch.cat(parts, dim=-1)
    shape = (layout.rows, LANES)
    return flat.reshape(shape if lead is None else (lead,) + shape)


def unpack(arena: Arena):
    """Invert :func:`pack`: views of each leaf's rows, reshaped. ``data``
    of dim 2 yields the model tree; dim 3 a stacked ``[lead, ...]`` tree.
    Bitwise (pads dropped, no arithmetic, no copy)."""
    lo, data = arena.layout, arena.data
    if data.dim() not in (2, 3):
        raise ValueError(f"arena data must be [lead?, rows, {LANES}], got "
                         f"shape {tuple(data.shape)}")
    lead = None if data.dim() == 2 else data.shape[0]
    out, off = [], 0
    for shape, nr in zip(lo.shapes, lo.rows_per_leaf):
        n = math.prod(shape)
        if lead is None:
            a = data[off:off + nr].reshape(nr * LANES)[:n]
            out.append(a.reshape(shape))
        else:
            a = data[:, off:off + nr].reshape(lead, nr * LANES)[:, :n]
            out.append(a.reshape((lead,) + shape))
        off += nr
    return pytree.tree_unflatten(out, lo.treedef)


def adapt_state(src, like):
    """Adapt an engine state between the per-leaf and arena
    representations: wherever ``like`` carries an :class:`Arena` and
    ``src`` the corresponding tree (or vice versa), pack / unpack;
    everything else is recursed field by field."""
    if isinstance(like, Arena):
        if isinstance(src, Arena):
            return src
        return pack(src, like.layout)
    if isinstance(src, Arena):
        return unpack(src)
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(adapt_state(s, l) for s, l in zip(src, like)))
    if isinstance(like, tuple):
        return tuple(adapt_state(s, l) for s, l in zip(src, like))
    if isinstance(like, list):
        return [adapt_state(s, l) for s, l in zip(src, like)]
    if isinstance(like, dict):
        return {k: adapt_state(src[k], like[k]) for k in like}
    return src
