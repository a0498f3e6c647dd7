"""Learning-rate schedules, WSD (warmup-stable-decay) among them (port of
``src/repro/optim/schedules.py``).

WSD is MiniCPM's schedule [arXiv:2404.06395]: linear warmup, a long
stable plateau, then a short exponential decay. Each schedule maps a step
to a 0-d float32 tensor.
"""

from __future__ import annotations

import math

import torch


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def constant(lr: float):
    return lambda step: _f32(lr)


def cosine(lr: float, total_steps: int, warmup: int = 0,
           min_frac: float = 0.1):
    def f(step):
        step = _f32(step)
        warm = torch.clamp(step / max(warmup, 1), max=1.0)
        prog = torch.clamp((step - warmup) / max(total_steps - warmup, 1),
                           0.0, 1.0)
        cos = min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
        return lr * warm * cos

    return f


def wsd(lr: float, total_steps: int, *, warmup_frac: float = 0.01,
        decay_frac: float = 0.1, min_frac: float = 0.01):
    """Warmup-Stable-Decay: the final ``decay_frac`` of training decays
    exponentially from lr to min_frac * lr."""
    warmup = max(1, int(warmup_frac * total_steps))
    decay_start = int((1.0 - decay_frac) * total_steps)

    def f(step):
        step = _f32(step)
        warm = torch.clamp(step / warmup, max=1.0)
        decay_prog = torch.clamp(
            (step - decay_start) / max(total_steps - decay_start, 1),
            0.0, 1.0)
        decay = torch.pow(_f32(min_frac), decay_prog)  # to min_frac * lr
        return lr * warm * decay

    return f
