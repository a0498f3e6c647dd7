"""The training harness (port of ``src/repro/fed/``)."""

from repro_torch.fed.trainer import FedTrainer, TrainerConfig

__all__ = ["FedTrainer", "TrainerConfig"]
