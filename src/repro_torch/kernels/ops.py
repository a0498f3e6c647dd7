"""Public wrappers of the port's kernels (port of
``src/repro/kernels/ops.py``: ``fedcet_v``, ``fedcet_comm``,
``stochastic_quantize``, ``stochastic_quantize_rows`` and
``fedcet_round_tail``).

``impl`` selects the implementation:

* ``"auto"`` (default): the CUDA kernel for a CUDA tensor, the plain
  PyTorch version (``kernels/ref.py``) for a CPU tensor. For a CUDA tensor
  a kernel that fails to build or launch raises; nothing falls back.
* ``"kernel"``: the CUDA kernel (CUDA tensors only).
* ``"ref"``: the plain version, on any device.

Unlike the reference's TPU wrappers there is no ``[rows, 1024]`` tiling or
padding, and no broadcast operand is materialized: the CUDA kernels work
on the flat leaf and broadcast the shared operand themselves.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import fedcet_update as K
from repro_torch.kernels import quantize as KQ
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


def stochastic_quantize(a, u, scale, bits: int, impl: str = "auto"):
    """Fused dithered-quantize round-trip over a stacked ``[C, ...]`` leaf
    (see kernels/ref.py:stochastic_quantize). ``u`` is the dither, of the
    leaf's coordinate shape (client-shared) or of ``a``'s shape;
    ``scale`` the per-leaf step as a one-element tensor."""
    if _use_kernel(impl, a):
        return KQ.stochastic_quantize(a, u, scale, bits)
    return R.stochastic_quantize(a, u, scale, bits)


def stochastic_quantize_rows(a, u, scale_rows, bits: int, impl: str = "auto"):
    """Row-scale dithered-quantize round-trip over the packed arena
    ``[C, rows, 1024]`` (see kernels/ref.py:stochastic_quantize_rows);
    ``u`` is ``[rows, 1024]`` or ``a``'s shape, ``scale_rows`` one step per
    row."""
    if _use_kernel(impl, a):
        return KQ.stochastic_quantize_rows(a, u, scale_rows, bits)
    return R.stochastic_quantize_rows(a, u, scale_rows, bits)


def fedcet_round_tail(v, h, d, u, scale, w, den, *, c: float, alpha: float,
                      beta: float, bits: int, impl: str = "auto"):
    """The fused shift-compressed FedCET round tail (see
    kernels/ref.py:fedcet_round_tail): dithered-quantize the shifted
    residual, reconstruct the wire message, weighted-reduce it across
    clients and apply the paired ``(d', x')`` update plus the DIANA shift
    step, one kernel visit per element on the card.

    Shapes: ``v``/``h``/``d`` [clients, rows, 1024]; ``u`` [rows, 1024];
    ``scale`` one step per row; ``w`` the clients' weights; ``den`` one
    element. Returns ``(d', x', h')``."""
    if _use_kernel(impl, v):
        return K.fedcet_round_tail(v, h, d, u, scale, w, den, c=c,
                                   alpha=alpha, beta=beta, bits=bits)
    return R.fedcet_round_tail(v, h, d, u, scale, w, den, c=c, alpha=alpha,
                               beta=beta, bits=bits)
