"""CUDA kernel for the telemetry client sketch (port of
``src/repro/kernels/telemetry_reduce.py``: ``client_sketch_2d``).

The population sketches of ``core/telemetry.py`` need, once per round and
per sketched state, each client's L2 norm over the packed ``[clients,
rows, 1024]`` arena and a log10 histogram of those norms. The kernel of
``csrc/telemetry_reduce.cu`` reads the store once: pass 1 splits each
client's row over many blocks into ``[n, nblk]`` partial sums of squares,
pass 2 reduces each client's partials, writes its squared norm and bins
its norm with an integer atomic add. Both sums run in a fixed order that
``kernels/ref.py:client_sketch`` repeats, so the two agree bit for bit.
``kernels/library.py`` builds and loads it and counts its launches under
``"telemetry_sketch"``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import library as L
from repro_torch.kernels import ref as R

__all__ = ["client_sketch"]


def client_sketch(x: torch.Tensor, *, bins: int, lo: float, hi: float):
    """``(sq [n], hist [bins] int32)`` of the ``[n, D]`` client store
    ``x``: every client's sum of squares and the log10 histogram of the
    norms over ``[10^lo, 10^hi)`` (zeros in bin 0, edges clipped; every
    client counts). The arithmetic is in x's dtype; nothing is read back
    to the host."""
    sfx = L.check("telemetry_sketch", x)
    if x.dim() != 2:
        raise ValueError(f"telemetry_sketch: x must be [n, D], got "
                         f"{tuple(x.shape)}")
    if bins < 1 or not hi > lo:
        raise ValueError(f"telemetry_sketch: need bins >= 1 and hi > lo, "
                         f"got bins={bins}, lo={lo}, hi={hi}")
    n, d = x.shape
    nblk, lanes = R.sketch_geometry(n, d, x.element_size())
    sq = torch.empty((n,), dtype=x.dtype, device=x.device)
    hist = torch.empty((bins,), dtype=torch.int32, device=x.device)
    part = torch.empty((n, nblk), dtype=x.dtype, device=x.device)
    vec = L.aligned(x) and d % lanes == 0
    L.launch("telemetry_sketch", sfx, x, x.data_ptr(), part.data_ptr(),
             sq.data_ptr(), hist.data_ptr(), n, d, nblk, bins, float(lo),
             bins / (hi - lo), int(vec))
    return sq, hist
