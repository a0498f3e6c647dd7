"""CUDA kernel for grouped-GQA flash attention, forward (port of
``src/repro/kernels/flash_attention.py``: ``flash_attention``).

Every prefill of the serving path (``models/attention.py:
prefill_attention``) and the model's ``use_pallas_attention`` forward
compute their full-sequence attention through the kernel of
``csrc/flash_attention.cu``: an online softmax over kv tiles held in
shared memory, one block per (row tile, KV head, batch) serving all G
query heads of the group, float32 statistics, fully masked kv tiles
skipped. ``kernels/library.py`` builds and loads it and counts its
launches under ``"flash_attention"``. Its plain version is
``kernels/ref.py:flash_attention``; the two agree within float32
rounding (the sums run in another order), not bit for bit.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import library as L
from repro_torch.kernels.ref import MASK_KINDS

__all__ = ["HEAD_DIMS", "flash_attention"]

#: the head dims the kernel is built for: the repo's configs use 64, 128
#: and 256; 16 and 32 serve small tests.
HEAD_DIMS = (16, 32, 64, 128, 256)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    kind: str = "causal", window: int = 0,
                    chunk: int = 0) -> torch.Tensor:
    """Attention of q ``[B, S, Hq, D]`` over k, v ``[B, T, Hkv, D]``
    (``Hq`` a multiple of ``Hkv``; query head ``h * G + g`` reads KV head
    ``h``) under the ``kind`` mask (causal, sliding with ``window >= 1``,
    chunked with ``chunk >= 1``, bidirectional), in float32 or bfloat16.
    Returns ``[B, S, Hq, D]`` in q's dtype. A query row with no allowed key
    (possible only when ``T != S``) comes out as the reference's kernel
    gives it: ``sum_{t<T} v_t / (nk * kv_blk)`` with ``kv_blk = min(256,
    T)`` and ``nk = ceil(T / kv_blk)``, every key and pad key weighted
    ``exp(0) = 1``."""
    sfx = L.check("flash_attention", q, k, v)
    if q.dim() != 4 or k.dim() != 4 or tuple(k.shape) != tuple(v.shape):
        raise ValueError(f"flash_attention: q must be [B, S, Hq, D] and k, v "
                         f"one [B, T, Hkv, D] shape, got {tuple(q.shape)} "
                         f"{tuple(k.shape)} {tuple(v.shape)}")
    B, S, Hq, D = q.shape
    _, T, Hkv, Dk = k.shape
    if k.shape[0] != B or Dk != D or Hkv < 1 or Hq % Hkv or T < 1:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k/v "
                         f"{tuple(k.shape)} disagree in batch or head dim, "
                         f"or Hq is not a multiple of Hkv")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {D} is not built; the "
                         f"kernel supports {HEAD_DIMS}")
    if kind not in MASK_KINDS:
        raise ValueError(f"flash_attention: kind {kind!r} not in "
                         f"{MASK_KINDS}")
    if (kind == "sliding" and window < 1) or (kind == "chunked"
                                              and chunk < 1):
        raise ValueError(f"flash_attention: {kind} needs window / chunk >= 1"
                         f", got window={window}, chunk={chunk}")
    if not L.aligned(q, k, v):
        raise ValueError("flash_attention: q, k and v must be 16-byte "
                         "aligned")
    out = torch.empty_like(q)
    L.launch("flash_attention", sfx, q, q.data_ptr(), k.data_ptr(),
             v.data_ptr(), out.data_ptr(), B, S, T, Hkv, Hq // Hkv, D,
             MASK_KINDS.index(kind), int(window), int(chunk))
    return out
