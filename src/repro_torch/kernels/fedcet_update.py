"""CUDA kernels for the FedCET update hot path (port of
``src/repro/kernels/fedcet_update.py``): the local-step triad, the
aggregation pair in its 3- and 4-operand forms, and the fused ``shift:q8``
round tail.

The kernels live in ``csrc/fedcet_update.cu`` behind a plain C interface;
``kernels/library.py`` builds and loads them on first use and keeps the
launch counts (:data:`LAUNCHES`, one entry per form). Each wrapper checks
device, dtype, contiguity and shape, allocates its outputs with
``torch.empty``, launches on PyTorch's current stream and raises if the
launch reports an error.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import library as L
from repro_torch.kernels.library import LAUNCHES, build, reset_launches

__all__ = ["LAUNCHES", "build", "fedcet_comm", "fedcet_round_tail",
           "fedcet_v", "reset_launches"]


def fedcet_v(x: torch.Tensor, g: torch.Tensor, d: torch.Tensor,
             alpha: float) -> torch.Tensor:
    """``x - alpha*g - alpha*d`` in one kernel pass over any leaf shape
    (a whole stacked ``[clients, ...]`` leaf, or the arena, is one
    launch)."""
    sfx = L.check("fedcet_v", x, g, d)
    if g.shape != x.shape or d.shape != x.shape:
        raise ValueError(f"fedcet_v: shapes differ {x.shape} {g.shape} "
                         f"{d.shape}")
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    L.launch("fedcet_v", sfx, x, x.data_ptr(), g.data_ptr(), d.data_ptr(),
             out.data_ptr(), alpha, x.numel(), int(L.aligned(x, g, d, out)))
    return out


def fedcet_comm(d: torch.Tensor, m: torch.Tensor, m_bar: torch.Tensor,
                c: float, alpha: float, v: torch.Tensor | None = None):
    """The paired aggregation ``(d + c*delta, v - c*alpha*delta)`` with
    ``delta = m - m_bar``, both outputs in one kernel visit. ``d``, ``m``
    (and ``v``) are ``[clients, ...]``; ``m_bar`` is the ``[1, ...]`` client
    mean (or has ``m``'s shape, then read as one client) and is never
    expanded. ``v=None`` is the 3-operand form (``v = m``), counted as
    ``fedcet_comm``; with ``v`` it counts as ``fedcet_comm4``."""
    form = "fedcet_comm" if v is None else "fedcet_comm4"
    ops = (d, m, m_bar) if v is None else (d, m, m_bar, v)
    sfx = L.check(form, *ops)
    if d.shape != m.shape or (v is not None and v.shape != m.shape):
        raise ValueError(f"{form}: d, m, v shapes differ {d.shape} "
                         f"{m.shape} {None if v is None else v.shape}")
    if m_bar.shape == m.shape:
        clients, p = 1, m.numel()
    elif m.dim() >= 1 and m_bar.shape == (1,) + tuple(m.shape[1:]):
        clients, p = m.shape[0], m_bar.numel()
    else:
        raise ValueError(f"{form}: m_bar must be [1, ...] of m's trailing "
                         f"shape or m's shape, got {m_bar.shape} for m "
                         f"{m.shape}")
    d_out, x_out = torch.empty_like(d), torch.empty_like(m)
    if m.numel() == 0:
        return d_out, x_out
    width = 16 // m.element_size()
    vec = L.aligned(*ops, d_out, x_out) and p % width == 0
    L.launch(form, sfx, m, d.data_ptr(), m.data_ptr(), m_bar.data_ptr(),
             None if v is None else v.data_ptr(), d_out.data_ptr(),
             x_out.data_ptr(), c, c * alpha, clients, p, int(vec))
    return d_out, x_out


def fedcet_round_tail(v: torch.Tensor, h: torch.Tensor, d: torch.Tensor,
                      u: torch.Tensor, scale: torch.Tensor, w: torch.Tensor,
                      den: torch.Tensor, *, c: float, alpha: float,
                      beta: float, bits: int):
    """The fused ``shift`` + dithered quantize -> weighted client mean ->
    FedCET pair -> DIANA shift round tail in one kernel (see
    ``kernels/ref.py:fedcet_round_tail``). ``v``, ``h``, ``d`` are
    ``[C, rows, lanes]``; ``u`` is the client-shared ``[rows, lanes]``
    dither; ``scale`` holds one step per row (``[rows]`` or ``[rows, 1]``);
    ``w`` the C client weights and ``den`` their one-element denominator.
    All stay on the card: nothing is read back to the host. Returns
    ``(d', x', h')``."""
    ops = (v, h, d, u, scale, w, den)
    sfx = L.check("fedcet_round_tail", *ops)
    if v.dim() != 3 or h.shape != v.shape or d.shape != v.shape:
        raise ValueError(f"fedcet_round_tail: v, h, d must share one "
                         f"[C, rows, lanes] shape, got {v.shape} {h.shape} "
                         f"{d.shape}")
    clients, rows, lanes = v.shape
    if clients < 1 or tuple(u.shape) != (rows, lanes):
        raise ValueError(f"fedcet_round_tail: u must be [rows, lanes] = "
                         f"{(rows, lanes)} with C >= 1, got {u.shape}")
    if scale.numel() != rows or w.numel() != clients or den.numel() != 1:
        raise ValueError(f"fedcet_round_tail: scale needs {rows} values, w "
                         f"{clients} and den 1; got {scale.numel()}, "
                         f"{w.numel()}, {den.numel()}")
    if not 2 <= bits <= 16:
        raise ValueError(f"fedcet_round_tail: bits must be in [2, 16], got "
                         f"{bits}")
    outs = tuple(torch.empty_like(v) for _ in range(3))
    if v.numel() == 0:
        return outs
    p, width = rows * lanes, 16 // v.element_size()
    vec = (L.aligned(v, h, d, u, *outs) and p % width == 0
           and lanes % width == 0)
    L.launch("fedcet_round_tail", sfx, v, *(t.data_ptr() for t in ops),
             *(t.data_ptr() for t in outs), c, c * alpha, beta, bits,
             clients, p, lanes, int(vec))
    return outs
