"""NIDS [Li, Shi & Yan, 2019], the decentralized optimizer FedCET descends
from, as an engine spec (port of ``src/repro/core/baselines/nids.py``).

NIDS iterates, per node i over a gossip graph with doubly-stochastic
mixing matrix W::

    x(k+1) = W~ [ 2 x(k) - x(k-1) - alpha (grad(k) - grad(k-1)) ],
    W~ = (I + W) / 2,

FedCET's 2-point extrapolation message (``FedCETLiteral``) pushed through
a LAZY mixing step: ``message`` is ``m = 2x - x_prev - alpha (g - g_prev)``
and ``server_aggregate`` applies ``x <- (m + m_bar) / 2``, so with
``core/engine.py:with_topology`` supplying ``m_bar = (W m)_i`` the update
is ``((I + W)/2) m``. Under the star topology ``m_bar`` is the global mean
and NIDS is ``FedCETLiteral`` with ``c * alpha = 1/2``.

Communication: the spec declares the star cost (one vector each way); a
gossip topology reshapes it (one message per directed edge, no
broadcast). ``tau`` defaults to 1 (NIDS mixes every step).
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

from repro_torch.core.api import replicate
from repro_torch.core.engine import RoundEngine
from repro_torch.utils.tree import tree_map


class NIDSState(NamedTuple):
    x_curr: Any  # stacked [clients, ...] x(k)
    x_prev: Any  # x(k-1)
    g_prev: Any  # grad f(x(k-1))
    t: int


@dataclasses.dataclass(frozen=True)
class NIDS(RoundEngine):
    alpha: float
    n_clients: int
    tau: int = 1
    name: str = "nids"
    vectors_up: int = 1
    vectors_down: int = 1  # star broadcast; gossip topologies zero it

    def init_warmup(self, gf, x0, init_batch):
        """x(-1) = x(-2) - alpha grad(x(-2)), then one aggregating step:
        the initialization that zeroes the conserved mean-gradient term."""
        x_m2 = replicate(x0, self.n_clients)
        g_m2 = gf(x_m2, init_batch)
        x_m1 = tree_map(lambda x, g: x - self.alpha * g, x_m2, g_m2)
        return NIDSState(x_curr=x_m1, x_prev=x_m2, g_prev=g_m2, t=-1), True

    def _extrapolate(self, gf, state, batch):
        """m = 2 x(k) - x(k-1) - alpha (grad(k) - grad(k-1))."""
        a = self.alpha
        g = gf(state.x_curr, batch)
        m = tree_map(lambda xc, xp, gc, gp: 2.0 * xc - xp - a * gc + a * gp,
                     state.x_curr, state.x_prev, g, state.g_prev)
        return m, g

    def local_step(self, gf, state, batch, rctx):
        m, g = self._extrapolate(gf, state, batch)
        return NIDSState(x_curr=m, x_prev=state.x_curr, g_prev=g,
                         t=state.t + 1)

    def message(self, gf, state, batch, rctx):
        """The transmitted vector is the extrapolation m; mctx carries the
        exact (m, grad) pair (a node knows its own m exactly)."""
        m, g = self._extrapolate(gf, state, batch)
        return m, (m, g)

    def server_aggregate(self, state, msg, msg_bar, mctx, rctx):
        """The lazy mixing half-step x <- (m + m_bar)/2."""
        m_exact, g = mctx
        x_next = tree_map(lambda mm, mb: 0.5 * (mm + mb), m_exact, msg_bar)
        return NIDSState(x_curr=x_next, x_prev=state.x_curr, g_prev=g,
                         t=state.t + 1)

    def client_params_of(self, inner):
        return inner.x_curr
