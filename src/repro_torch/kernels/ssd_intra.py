"""CUDA kernel for the Mamba2 SSD intra-chunk term (port of
``src/repro/kernels/ssd_intra.py``: ``ssd_intra``).

The chunked SSD (``models/mamba2.py:ssd_chunked``) computes its quadratic
within-chunk term through the kernel of ``csrc/ssd_intra.cu``, bound by
the bytes it moves (every operand read once, y written once). One block
per (head group, chunk, batch) forms ``C B^T`` once for all heads of the
group, only its causal tiles, into shared memory; then two sets of eight
warps each work through every other head, one warp per 16-row tile,
forming the causally masked, decayed weights ``W`` fragment by fragment
and ``W @ x``, while the set's next head's x loads with ``cp.async``.
Both products run on the tensor cores (``mma.sync`` m16n8k8 in TF32,
float32 accumulators) as 3xTF32: each float32 operand splits into a TF32
high part and a remainder, and three products keep the sums within
float32 rounding of the plain version; bfloat16 operands are exact in TF32
and skip their remainder. ``kernels/library.py`` builds and loads it and
counts its launches under ``"ssd_intra"``. Its plain version is
``kernels/ref.py:ssd_intra``; the two agree within float32 rounding (the
sums run in another order), not bit for bit. The kernel has no backward:
under autograd it raises.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import library as L

__all__ = ["MAX_CHUNK", "MAX_HEAD_DIM", "ssd_intra"]

#: the largest chunk length (Lc) and head dim (P) the kernel takes.
MAX_CHUNK = 128
MAX_HEAD_DIM = 128


def ssd_intra(x: torch.Tensor, dt: torch.Tensor, a_cs: torch.Tensor,
              Bm: torch.Tensor, Cm: torch.Tensor) -> torch.Tensor:
    """``y_i = sum_{j<=i} (C_i . B_j) exp(a_cs_i - a_cs_j) dt_j x_j`` per
    (batch, chunk, head): x ``[B, Nc, Lc, H, P]``, dt and a_cs ``[B, Nc,
    Lc, H]``, Bm and Cm ``[B, Nc, Lc, N]``, all float32 or all bfloat16,
    with ``Lc <= 128`` and ``P <= 128``. Returns x's shape and dtype."""
    ops = (x, dt, a_cs, Bm, Cm)
    if torch.is_grad_enabled() and any(t.requires_grad for t in ops):
        raise NotImplementedError(
            "ssd_intra: the CUDA kernel has no backward (the reference's "
            "Pallas kernel has none either): train with "
            "use_pallas_ssd=False")
    sfx = L.check("ssd_intra", *ops)
    if x.dim() != 5 or dt.dim() != 4 or Bm.dim() != 4:
        raise ValueError(f"ssd_intra: x must be [B, Nc, Lc, H, P], dt and "
                         f"a_cs [B, Nc, Lc, H], Bm and Cm [B, Nc, Lc, N]; got "
                         f"{tuple(x.shape)} {tuple(dt.shape)} "
                         f"{tuple(Bm.shape)}")
    B, Nc, Lc, H, P = x.shape
    N = Bm.shape[-1]
    if (tuple(dt.shape) != (B, Nc, Lc, H) or tuple(a_cs.shape) != tuple(
            dt.shape) or tuple(Bm.shape) != (B, Nc, Lc, N)
            or tuple(Cm.shape) != tuple(Bm.shape)):
        raise ValueError(f"ssd_intra: shapes disagree: x {tuple(x.shape)}, "
                         f"dt {tuple(dt.shape)}, a_cs {tuple(a_cs.shape)}, "
                         f"Bm {tuple(Bm.shape)}, Cm {tuple(Cm.shape)}")
    if not (1 <= Lc <= MAX_CHUNK and 1 <= P <= MAX_HEAD_DIM and N >= 1):
        raise ValueError(f"ssd_intra: the kernel takes 1 <= Lc <= "
                         f"{MAX_CHUNK}, 1 <= P <= {MAX_HEAD_DIM} and N >= 1; "
                         f"got Lc={Lc}, P={P}, N={N}")
    if B > 65535 or Nc > 65535:
        raise ValueError(f"ssd_intra: at most 65535 batches and chunks, got "
                         f"B={B}, Nc={Nc}")
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    L.launch("ssd_intra", sfx, x, x.data_ptr(), dt.data_ptr(),
             a_cs.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), out.data_ptr(),
             B, Nc, Lc, H, P, N)
    return out
