"""Roofline of the port (port of ``src/repro/roofline/``): the analytic
cost model, the collective counter and the three-term assembly at H100
constants."""

from repro_torch.roofline.analysis import RooflineReport, analyze_lowered
from repro_torch.roofline.constants import (HBM_BW, NVLINK_BW, PEAK_FLOPS,
                                            peak_flops)

__all__ = ["HBM_BW", "NVLINK_BW", "PEAK_FLOPS", "RooflineReport",
           "analyze_lowered", "peak_flops"]
