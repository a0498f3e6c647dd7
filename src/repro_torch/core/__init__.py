"""Federated-learning core of the port (port of ``src/repro/core/``):
the round engine, FedCET, its comparison baselines, Algorithm 1 and the
quadratic simulator."""

from repro_torch.core.baselines import (
    NIDS,
    FedAvg,
    FedDyn,
    FedLin,
    FedProx,
    FedTrack,
    Scaffold,
)
from repro_torch.core.comm import quantize_bf16, topk_sparsify
from repro_torch.core.fedcet import (
    FedCET,
    FedCETLiteral,
    FedCETLiteralState,
    FedCETState,
    max_weight_c,
)

__all__ = ["FedAvg", "FedCET", "FedCETLiteral", "FedCETLiteralState",
           "FedCETState", "FedDyn", "FedLin", "FedProx", "FedTrack", "NIDS",
           "Scaffold", "max_weight_c", "quantize_bf16", "topk_sparsify"]
