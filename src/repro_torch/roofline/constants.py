"""NVIDIA H100 SXM constants (per card) for the roofline (counterpart of
``src/repro/roofline/constants.py``, whose TPU v5e figures are not used).

These are NVIDIA's published data-sheet figures for the H100 SXM5 80 GB
part, dense rates without sparsity, and they assume the card's full
700 W power limit; a card set below it runs slower under load. They are
not measurements of this repository's card.
"""

from __future__ import annotations

import torch

#: dense peaks by element type, FLOP/s; float32 is the CUDA cores' rate
#: (the tensor cores' float32 route is TF32, below).
PEAK_FLOPS_BY_DTYPE = {
    torch.bfloat16: 989e12,
    torch.float16: 989e12,
    torch.float32: 67e12,
}
TF32_FLOPS = 495e12
#: the bfloat16 tensor-core peak, the rate the dry run's bfloat16 programs
#: are held to (the reference's ``PEAK_FLOPS``).
PEAK_FLOPS = PEAK_FLOPS_BY_DTYPE[torch.bfloat16]

HBM_BW = 3.35e12            # bytes/s
HBM_BYTES = 80e9            # bytes of device memory
NVLINK_BW = 450e9           # bytes/s each way, to the other cards of a host
L2_BYTES = 50e6
N_SMS = 132
SMEM_PER_BLOCK = 232_448    # bytes of shared memory one block can use
POWER_LIMIT_W = 700         # the power limit the rates assume


def peak_flops(dtype, tf32: bool = False) -> float:
    """The dense peak for arithmetic in ``dtype`` (a torch dtype or its
    name); float32 counts at the TF32 tensor-core rate only with
    ``tf32=True`` (``chip_smoke.py`` keeps TF32 off)."""
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype)
    if dtype not in PEAK_FLOPS_BY_DTYPE:
        raise ValueError(f"no H100 peak for {dtype}")
    if dtype == torch.float32 and tf32:
        return TF32_FLOPS
    return PEAK_FLOPS_BY_DTYPE[dtype]
