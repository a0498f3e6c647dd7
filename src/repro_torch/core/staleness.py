"""Weighted client reduction (port of ``src/repro/core/staleness.py:108-122``,
``weighted_client_mean`` only).

The topologies (``core/topology.py``) reduce a stacked ``[clients, ...]``
tree under per-client weights: uniform, or the participation mask. The
delay models and stale-aggregation policies that also feed this
reduction in the reference come with the staleness slice.
"""

from __future__ import annotations

import torch

from repro_torch.utils.tree import tree_map

__all__ = ["weighted_client_mean"]


def weighted_client_mean(tree, w: torch.Tensor):
    """Weighted mean over the leading clients axis with weights ``w``
    (normalized here; an all-zero ``w`` yields zeros). Reduces to the plain
    client mean for any uniform positive ``w``. The zero-sum guard does not
    clamp small positive sums: a clamp would silently shrink the mean of
    weights that sum below 1."""
    s = torch.sum(w)
    denom = torch.where(s > 0, s, torch.ones_like(s))

    def mean_leaf(a):
        wb = w.reshape((-1,) + (1,) * (a.dim() - 1)).to(a.dtype)
        return torch.sum(a * wb, dim=0, keepdim=True) / denom.to(a.dtype)

    return tree_map(mean_leaf, tree)
