"""CUDA kernel for the packed arena's dither: ``threefry_uniform_rows``
(``csrc/threefry.cu``), every leaf's ``prng.uniform`` draw under its
``fold_in(key, i)`` written straight into the ``[(planes,) rows, 1024]``
arena layout in one launch, bit for bit the per-leaf draws packed by
``core/arena.py:pack_rows``. It replaces no TPU kernel (the reference's
XLA fuses each draw's threefry by itself). Plain version:
``kernels/ref.py:arena_uniform``."""

from __future__ import annotations

import torch

from repro_torch.kernels import library as L

__all__ = ["threefry_uniform_rows"]

#: lane width of one arena row (``core/arena.py`` re-exports it): the
#: kernel's block writes one row, 4 lanes a thread.
LANES = 1024


def threefry_uniform_rows(key, table: torch.Tensor, row_leaf: torch.Tensor,
                          planes: int, dtype: torch.dtype) -> torch.Tensor:
    """The dither ``[planes, rows, 1024]`` of ``dtype`` (float32 or
    float64) drawn from the key's two 32-bit words: ``table`` is the int64
    ``[leaves, 3]`` of ``ArenaLayout.leaf_table`` (first row, element
    count, reference leaf index), ``row_leaf`` the int64 ``[rows]`` map of
    ``ArenaLayout.row_segments``, both on the card; ``planes`` the client
    planes of a per-client dither (1 for the client-shared one)."""
    name = "threefry_uniform_rows"
    rows = row_leaf.shape[0]
    for t, want in ((table, 2), (row_leaf, 1)):
        if (t.dtype != torch.int64 or t.dim() != want
                or t.device != table.device or not t.is_contiguous()):
            raise ValueError(f"{name}: table [leaves, 3] and row_leaf "
                             f"[rows] must be contiguous int64 on one "
                             f"device, got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")
    if table.shape[1] != 3 or planes < 1:
        raise ValueError(f"{name}: table must be [leaves, 3] and planes "
                         f">= 1, got {tuple(table.shape)} and {planes}")
    out = torch.empty((planes, rows, LANES), dtype=dtype,
                      device=table.device)
    sfx = L.check(name, out)
    k0, k1 = (int(w) & 0xFFFFFFFF for w in key)
    L.launch(name, sfx, out, out.data_ptr(), table.data_ptr(),
             row_leaf.data_ptr(), k0, k1, rows, planes)
    return out
