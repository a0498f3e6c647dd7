"""CUDA kernel for the gossip neighbor reduce (port of
``src/repro/kernels/gossip_reduce.py``: ``segment_reduce_2d``).

The sparse gossip lowering (``core/topology.py``: ``Mixing`` with
``lowering="sparse"``) reduces each node's ``S`` weighted neighbor rows.
The reference gathers them into a ``[n*S, D]`` contribution tensor and
sums its slots in the TPU kernel; the CUDA kernel of
``csrc/gossip_reduce.cu`` gathers, weights, sums and divides in one pass
and never writes that tensor. Where all ``R`` source rows of a column tile
fit in shared memory (the main path: ``R = n = 8``) a block owns a column
tile and reads each source element once (the column-owning route, see
:func:`route`); larger tables take the node-owning route, which reads the
``S`` rows of each node. ``kernels/library.py`` builds and loads it
and counts its launches under ``"gossip_reduce"``. The index and weight
tables are inputs, so the kernel is a pure function of its operands,
comparable bit for bit with ``kernels/ref.py:gossip_reduce``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import library as L

__all__ = ["gossip_reduce", "route"]


def _vec(src: torch.Tensor) -> bool:
    """Whether the kernel moves 16-byte vectors (the output, a fresh
    allocation, is always aligned)."""
    return L.aligned(src) and src.shape[1] % (16 // src.element_size()) == 0


def route(src: torch.Tensor, idx: torch.Tensor) -> str:
    """``"column"`` or ``"node"``: the route the kernel takes for ``src``
    ``[R, D]`` on the card and the table ``idx`` ``[n, S]`` (the one
    ``launch_gossip_reduce`` chooses by shape)."""
    n, slots = idx.shape
    most = L.library().gossip_reduce_column_rows(
        n, slots, src.element_size(), int(_vec(src)))
    return "column" if src.shape[0] <= most else "node"


def gossip_reduce(src: torch.Tensor, idx: torch.Tensor, wgt: torch.Tensor,
                  denom: torch.Tensor | None = None) -> torch.Tensor:
    """``out[i] = (sum_s wgt[i, s] * src[idx[i, s]]) / denom[i]`` over the
    rows of ``src`` ``[R, D]``, with ``idx`` ``[n, S]`` (int64 row indices
    in ``[0, R)``), ``wgt`` ``[n, S]`` and ``denom`` ``[n]`` or None (no
    division). Slots are summed in order from the slot-0 product. Every
    operand stays on the card: nothing is read back to the host. Returns
    ``[n, D]``."""
    ops = (src, wgt) if denom is None else (src, wgt, denom)
    sfx = L.check("gossip_reduce", *ops)
    if idx.device != src.device or idx.dtype != torch.int64 \
            or not idx.is_contiguous():
        raise ValueError(f"gossip_reduce: idx must be a contiguous int64 "
                         f"tensor on {src.device}, got {idx.dtype} on "
                         f"{idx.device}")
    if src.dim() != 2 or idx.dim() != 2 \
            or tuple(wgt.shape) != tuple(idx.shape):
        raise ValueError(f"gossip_reduce: src must be [R, D] and idx, wgt "
                         f"one [n, S] shape, got {tuple(src.shape)} "
                         f"{tuple(idx.shape)} {tuple(wgt.shape)}")
    n, slots = idx.shape
    if slots < 1 or (denom is not None and denom.numel() != n):
        raise ValueError(f"gossip_reduce: need S >= 1 and denom of n = {n} "
                         f"values, got S = {slots}, denom "
                         f"{None if denom is None else tuple(denom.shape)}")
    d = src.shape[1]
    out = torch.empty((n, d), dtype=src.dtype, device=src.device)
    if out.numel() == 0:
        return out
    # the kernel reads src[idx] unchecked: an index outside [0, R) fails
    # on the card here, without a read-back to the host.
    torch._assert_async(((idx >= 0) & (idx < src.shape[0])).all(),
                        "gossip_reduce: idx outside the rows of src")
    L.launch("gossip_reduce", sfx, src, src.data_ptr(), idx.data_ptr(),
             wgt.data_ptr(), None if denom is None else denom.data_ptr(),
             out.data_ptr(), n, slots, src.shape[0], d, int(_vec(src)))
    return out
