"""Published peaks of the cards the benchmark knows (NVIDIA's data sheet,
SXM part, dense rates, at the full 700 W power limit)."""

PEAKS = {
    "H100": {"fp32_flops": 67e12, "tf32_flops": 495e12,
             "bf16_flops": 989e12, "hbm_bytes_per_s": 3.35e12},
}


def peaks_for(kind: str) -> dict:
    """The peaks of the card named ``kind``
    (``torch.cuda.get_device_name``)."""
    for name, p in PEAKS.items():
        if name in kind:
            return p
    raise KeyError(f"no published peaks for {kind!r}")
