"""Federated-learning core of the port (port of ``src/repro/core/``):
the round engine, FedCET, Algorithm 1 and the quadratic simulator."""

from repro_torch.core.fedcet import (
    FedCET,
    FedCETLiteral,
    FedCETLiteralState,
    FedCETState,
    max_weight_c,
)

__all__ = ["FedCET", "FedCETLiteral", "FedCETLiteralState", "FedCETState",
           "max_weight_c"]
