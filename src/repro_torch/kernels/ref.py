"""Plain PyTorch versions of the FedCET kernels (port of
``src/repro/kernels/ref.py:8-26``), term for term: the CPU path of
``kernels/ops.py`` and the yardstick the CUDA kernels are held against."""

from __future__ import annotations


def fedcet_v(x, g, d, alpha: float):
    """The FedCET local-step triad: v = x - alpha*g - alpha*d.

    (== the paper's 2x(t) - x(t-1) - a grad(t) + a grad(t-1), via Lemma 1.)
    """
    return x - alpha * g - alpha * d


def fedcet_comm(d, m, m_bar, c: float, alpha: float, v=None):
    """The FedCET aggregation step:
    d' = d + c (m - m_bar);  x' = v - c*alpha*(m - m_bar).

    ``m`` is the client's own WIRE message and ``v`` the exact local vector
    the x-update starts from; without compression they coincide (the
    ``v=None`` default). ``m_bar`` broadcasts against ``m`` (``[1, ...]``)."""
    if v is None:
        v = m
    delta = m - m_bar
    return d + c * delta, v - (c * alpha) * delta
