"""Partial client participation (port of
``src/repro/core/participation.py``).

The paper assumes full participation; real federations sample clients.
``with_participation`` (``core/engine.py``) wraps ANY engine algorithm: a
Bernoulli mask per round (from the step counter), the server averages over
present clients only, and absent clients freeze, so FedCET's
``sum_i d_i = 0`` survives sampling. :func:`FedCETPartial` is construction
sugar for the FedCET case.
"""

from __future__ import annotations

from repro_torch.core.engine import (
    ClientSampling,
    RoundEngine,
    masked_client_mean,
    participation_mask,
    select_clients,
    with_participation,
)
from repro_torch.core.fedcet import FedCET

__all__ = ["ClientSampling", "FedCETPartial", "masked_client_mean",
           "participation_mask", "select_clients", "with_participation"]


def FedCETPartial(alpha: float, c: float, tau: int, n_clients: int,
                  participation: float = 1.0, seed: int = 0,
                  name: str = "fedcet_partial", **engine_kw) -> RoundEngine:
    """FedCET with per-round client sampling: ``with_participation`` over
    the FedCET spec. ``participation=1.0`` is an exact no-op."""
    base = FedCET(alpha=alpha, c=c, tau=tau, n_clients=n_clients, name=name,
                  **engine_kw)
    return with_participation(base, participation, seed=seed)
