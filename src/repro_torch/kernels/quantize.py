"""CUDA kernels for the dithered quantize round-trip (port of
``src/repro/kernels/quantize.py``): one scale per leaf
(``stochastic_quantize``) or one per arena row
(``stochastic_quantize_rows``).

Both forms run the one kernel of ``csrc/quantize.cu``; each counts its
own launches in ``kernels/library.py``'s :data:`LAUNCHES`. The dither and
the scale are inputs (drawn by ``core/compressors.py`` from the shared
round key), so the kernel is a pure function of its operands, comparable
bit for bit with ``kernels/ref.py``. The client-shared dither is
broadcast inside the kernel, never materialized over the clients.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import library as L

__all__ = ["stochastic_quantize", "stochastic_quantize_rows"]


def _dither_mode(name: str, a: torch.Tensor, u: torch.Tensor) -> bool:
    """True for a per-client dither (``u`` shaped like ``a``), False for
    the client-shared one (``u`` shaped like ``a[0]``)."""
    if tuple(u.shape) == tuple(a.shape):
        return True
    if tuple(u.shape) == tuple(a.shape[1:]):
        return False
    raise ValueError(f"{name}: u must be shaped like a {tuple(a.shape)} or "
                     f"like one client {tuple(a.shape[1:])}, got "
                     f"{tuple(u.shape)}")


def _quantize(form, a, u, scale, bits, lanes):
    sfx = L.check(form, a, u, scale)
    if a.dim() < 1:
        raise ValueError(f"{form}: a must be a stacked [C, ...] tensor")
    if not 2 <= bits <= 16:
        raise ValueError(f"{form}: bits must be in [2, 16], got {bits}")
    per_client = _dither_mode(form, a, u)
    out = torch.empty_like(a)
    if a.numel() == 0:
        return out
    clients, p, width = a.shape[0], a[0].numel(), 16 // a.element_size()
    vec = (L.aligned(a, u, out) and p % width == 0
           and (lanes == 0 or lanes % width == 0))
    L.launch(form, sfx, a, a.data_ptr(), u.data_ptr(), scale.data_ptr(),
             out.data_ptr(), bits, clients, p, lanes, int(per_client),
             int(vec))
    return out


def stochastic_quantize(a: torch.Tensor, u: torch.Tensor,
                        scale: torch.Tensor, bits: int) -> torch.Tensor:
    """``s * clip(floor(a/s + u), -L, L)`` over a stacked ``[C, ...]``
    leaf with one scale ``s`` (a one-element tensor on the card). ``u`` is
    the client-shared dither (``a``'s coordinate shape) or a per-client
    one (``a``'s shape)."""
    if scale.numel() != 1:
        raise ValueError(f"stochastic_quantize: one scale, got "
                         f"{scale.numel()}")
    return _quantize("stochastic_quantize", a, u, scale, bits, 0)


def stochastic_quantize_rows(a: torch.Tensor, u: torch.Tensor,
                             scale_rows: torch.Tensor,
                             bits: int) -> torch.Tensor:
    """The row-scale form over the packed arena: ``a`` is
    ``[C, rows, lanes]``, ``u`` ``[rows, lanes]`` (shared) or ``a``'s shape
    (per client), ``scale_rows`` one step per row (``[rows]`` or
    ``[rows, 1]``)."""
    if a.dim() != 3 or scale_rows.numel() != a.shape[1]:
        raise ValueError(f"stochastic_quantize_rows: a must be [C, rows, "
                         f"lanes] with one scale per row, got a "
                         f"{tuple(a.shape)}, scale {tuple(scale_rows.shape)}")
    return _quantize("stochastic_quantize_rows", a, u, scale_rows, bits,
                     a.shape[2])
