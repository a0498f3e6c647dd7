"""Public wrappers of the FedCET kernels (port of
``src/repro/kernels/ops.py``: ``fedcet_v`` and ``fedcet_comm``).

``impl`` selects the implementation:

* ``"auto"`` (default): the CUDA kernel for a CUDA tensor, the plain
  PyTorch version (``kernels/ref.py``) for a CPU tensor. For a CUDA tensor
  a kernel that fails to build or launch raises; nothing falls back.
* ``"kernel"``: the CUDA kernel (CUDA tensors only).
* ``"ref"``: the plain version, on any device.

Unlike the reference's TPU wrappers there is no ``[rows, 1024]`` tiling or
padding: the CUDA kernels work on the flat leaf.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import fedcet_update as K
from repro_torch.kernels import ref as R


def _use_kernel(impl: str, t: torch.Tensor) -> bool:
    if impl == "auto":
        return t.device.type == "cuda"
    if impl in ("kernel", "ref"):
        return impl == "kernel"
    raise ValueError(f"unknown impl {impl!r} (auto | kernel | ref)")


def fedcet_v(x, g, d, alpha: float, impl: str = "auto"):
    """Fused FedCET local-step triad (see kernels/ref.py:fedcet_v)."""
    if _use_kernel(impl, x):
        return K.fedcet_v(x, g, d, alpha)
    return R.fedcet_v(x, g, d, alpha)


def fedcet_comm(d, m, m_bar, c: float, alpha: float, v=None,
                impl: str = "auto"):
    """Fused FedCET aggregation pair (see kernels/ref.py:fedcet_comm).

    ``m`` is the client's own WIRE message; pass ``v`` (the exact local
    vector) when the message path is compressed. ``v=None`` keeps the
    uncompressed behavior (``v = m``). Returns ``(d', x')``."""
    if _use_kernel(impl, m):
        return K.fedcet_comm(d, m, m_bar, c, alpha, v=v)
    return R.fedcet_comm(d, m, m_bar, c, alpha, v=v)
