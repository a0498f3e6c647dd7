"""Checkpoints (port of ``src/repro/checkpoint/``)."""

from repro_torch.checkpoint.ckpt import (
    all_steps,
    latest_step,
    load_pytree,
    restore,
    save,
    save_pytree,
)

__all__ = ["all_steps", "latest_step", "load_pytree", "restore", "save",
           "save_pytree"]
