"""Collective traffic of an eager program (the counterpart of
``src/repro/roofline/hlo_parse.py``).

The reference parses the compiled HLO and multiplies each collective
inside a ``while`` body by its trip count, because XLA prints a loop body
once. The port has no HLO: PyTorch runs eagerly, so every loop body
dispatches its collectives as often as it runs, and a dispatch mode that
sees each one needs no multipliers. ``CollectiveCounter`` records every
collective that reaches the dispatcher (the functional collectives that
DTensor's redistributions issue, and the in-place ``c10d`` ones) with its
result bytes, under the reference's kind names.

Bytes convention, as in the reference: the result's bytes, a proxy for the
link traffic; ``roofline/analysis.py`` applies the ring factor.
``shape_bytes`` and the HLO parser (``_split_computations``,
``parse_collectives``) have no counterpart.
"""

from __future__ import annotations

from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")

#: op name (``aten``-style ``namespace::name`` without the overload) ->
#: the reference's kind.
_KINDS = {
    "_c10d_functional::all_reduce": "all-reduce",
    "_c10d_functional::all_reduce_": "all-reduce",
    "_c10d_functional::all_reduce_coalesced": "all-reduce",
    "_c10d_functional::all_gather_into_tensor": "all-gather",
    "_c10d_functional::all_gather_into_tensor_out": "all-gather",
    "_c10d_functional::all_gather_into_tensor_coalesced": "all-gather",
    "_c10d_functional::reduce_scatter_tensor": "reduce-scatter",
    "_c10d_functional::reduce_scatter_tensor_coalesced": "reduce-scatter",
    "_c10d_functional::all_to_all_single": "all-to-all",
    "c10d::allreduce_": "all-reduce",
    "c10d::allgather_": "all-gather",
    "c10d::_allgather_base_": "all-gather",
    "c10d::allgather_into_tensor_coalesced_": "all-gather",
    "c10d::reduce_scatter_": "reduce-scatter",
    "c10d::_reduce_scatter_base_": "reduce-scatter",
    "c10d::alltoall_": "all-to-all",
    "c10d::alltoall_base_": "all-to-all",
    "c10d::send": "collective-permute",
    "c10d::recv_": "collective-permute",
}


#: ops of the two namespaces that move no data.
_NOT_COLLECTIVES = ("wait_tensor", "wait", "_wrap_tensor_autograd")


def _defer_to_subclass(types) -> bool:
    """True for an op on DTensors: a mode runs before the subclass, so it
    returns ``NotImplemented`` and lets DTensor run the op, which then
    dispatches its local ops and its collectives, the redistributions an
    op needs included, to the mode (the way ``CommDebugMode`` sees
    them)."""
    from torch.distributed.tensor import DTensor

    return any(issubclass(t, DTensor) for t in types)


def _tensor_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_flatten(tree)[0]
               if isinstance(t, torch.Tensor))


class CollectiveCounter(TorchDispatchMode):
    """Records every collective dispatched while it is active::

        with CollectiveCounter() as cc:
            step(...)
        cc.collective_summary()

    A collective it has no kind for (a broadcast, say) is recorded under
    its op name, so nothing goes unseen."""

    def __init__(self):
        super().__init__()
        self.sites: list[tuple[str, int]] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if _defer_to_subclass(types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        ns = func.namespace
        if ns in ("_c10d_functional", "c10d"):
            name = f"{ns}::{func._opname}"
            kind = _KINDS.get(name)
            if kind is None and func._opname not in _NOT_COLLECTIVES:
                kind = name
            if kind is not None:
                self.sites.append((kind, _tensor_bytes(out)))
        return out

    def collective_summary(self) -> dict:
        """The reference's summary: bytes and count by kind, their total,
        and the number of sites (here one per dispatch)."""
        by_kind: dict[str, int] = defaultdict(int)
        count: dict[str, int] = defaultdict(int)
        for kind, b in self.sites:
            by_kind[kind] += b
            count[kind] += 1
        return {
            "bytes_by_kind": dict(by_kind),
            "count_by_kind": dict(count),
            "total_bytes": int(sum(by_kind.values())),
            "n_sites": len(self.sites),
        }
