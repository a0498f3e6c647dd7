"""Optimizers and learning-rate schedules (port of ``src/repro/optim/``)."""

from repro_torch.optim.optimizers import Adam, Sgd
from repro_torch.optim.schedules import constant, cosine, wsd

__all__ = ["Adam", "Sgd", "constant", "cosine", "wsd"]
