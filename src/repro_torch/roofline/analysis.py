"""Three-term roofline assembly, compute / memory / collective (port of
``src/repro/roofline/analysis.py``), at H100 constants:

    compute term    = FLOPs per device / peak_flops(dtype)
    memory term     = HBM bytes per device / 3.35 TB/s
    collective term = collective bytes / 450 GB/s NVLink (each way)

FLOPs and HBM bytes come from the analytic cost model
(``roofline/flops.py``), collective bytes from the traced program
(``roofline/comm_count.py``), with the ring factor 2(n-1)/n for
all-reduce and (n-1)/n for all-gather and reduce-scatter. The largest
term is the bottleneck.
"""

from __future__ import annotations

import dataclasses

from repro_torch.roofline import constants as C
from repro_torch.roofline.flops import StepCost


@dataclasses.dataclass(frozen=True)
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    n_devices: int
    compute_s: float
    memory_s: float
    collective_s: float
    model_flops: float
    analytic_flops_total: float
    flops_ratio: float            # MODEL_FLOPS / analytic total FLOPs
    collective_bytes: int
    collective_detail: dict
    memory_per_device_bytes: int  # argument + temp + output, per device
    raw_cost_analysis: dict       # eager PyTorch has none: always {}
    bottleneck: str = ""

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def _ring_factor(kind: str, n: int) -> float:
    if kind == "all-reduce":
        return 2.0 * (n - 1) / n
    if kind in ("all-gather", "reduce-scatter"):
        return (n - 1) / n
    return 1.0


def analyze_lowered(*, arch: str, shape: str, mesh_name: str, n_devices: int,
                    cost: StepCost, collectives: dict, memory: dict | None,
                    dtype) -> RooflineReport:
    """The reference's ``analyze_compiled`` for a traced program:
    ``collectives`` is ``CollectiveCounter.collective_summary()``,
    ``memory`` the ``argument_bytes`` / ``temp_bytes`` / ``output_bytes``
    per device, ``dtype`` the element type the compute term's peak is
    read for."""
    coll_s = 0.0
    for kind, b in collectives["bytes_by_kind"].items():
        coll_s += b * _ring_factor(kind, n_devices) / C.NVLINK_BW
    compute_s = cost.flops_per_device / C.peak_flops(dtype)
    memory_s = cost.hbm_bytes_per_device / C.HBM_BW
    analytic_total = cost.flops_per_device * n_devices
    ratio = (cost.model_flops_total / analytic_total) if analytic_total else 0.0
    mem_bytes = 0
    if memory is not None:
        mem_bytes = int(memory["argument_bytes"] + memory["temp_bytes"]
                        + memory["output_bytes"])
    terms = {"compute": compute_s, "memory": memory_s, "collective": coll_s}
    return RooflineReport(
        arch=arch, shape=shape, mesh=mesh_name, n_devices=n_devices,
        compute_s=compute_s, memory_s=memory_s, collective_s=coll_s,
        model_flops=cost.model_flops_total,
        analytic_flops_total=analytic_total,
        flops_ratio=ratio,
        collective_bytes=collectives["total_bytes"],
        collective_detail=collectives,
        memory_per_device_bytes=mem_bytes,
        raw_cost_analysis={},
        bottleneck=max(terms, key=terms.get),
    )
