"""FedTrack [30] / FedLin [18], gradient-tracking baselines, as engine
specs (port of ``src/repro/core/baselines/fedlin.py``).

Both start every round from the shared global model x_bar and run tau
corrected local steps

    y <- y - alpha * (grad_i(y) - g_i + g_bar),   g_i = grad_i(x_bar),

where g_bar = mean_i g_i is the incrementally aggregated global gradient.
The server then averages the endpoints: exact linear convergence under
heterogeneity, at the cost of TWO n-dimensional vectors each way per
round (g_i and the endpoint up; x_bar and g_bar down). The round-start
gradient exchange is ``begin_round`` (through the engine's aggregator, so
client sampling masks it consistently); the endpoint model is the message.

FedLin also sparsifies the round-start uplink gradient with top-k and
error feedback (client-side memory), its own scheme kept in the spec: the
generic ``with_compression`` transform applies to the endpoint message
instead. ``k_frac = 1.0`` is FedTrack exactly.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

from repro_torch.core.api import replicate
from repro_torch.core.baselines.fedavg import broadcast_mean
from repro_torch.core.comm import sparsified_up_frac, topk_sparsify
from repro_torch.core.engine import RoundEngine
from repro_torch.utils.tree import tree_map, tree_zeros_like


class FedLinState(NamedTuple):
    x: Any        # global model (replicated across the stacked axis)
    memory: Any   # per-client error-feedback memory (zeros when k_frac=1)
    t: int


@dataclasses.dataclass(frozen=True)
class FedLin(RoundEngine):
    alpha: float
    tau: int
    n_clients: int
    k_frac: float = 1.0  # fraction of gradient entries transmitted (top-k)
    name: str = "fedlin"
    vectors_up: int = 2
    vectors_down: int = 2

    @property
    def up_frac(self) -> float:
        """The TWO up vectors compress independently: the round-start
        gradient through FedLin's own top-k (k_frac), the endpoint message
        through any attached engine transforms."""
        g_frac = sparsified_up_frac(self.k_frac) if self.k_frac < 1.0 else 1.0
        return (g_frac + super().up_frac) / 2.0

    @property
    def bits_per_coord(self) -> float:
        """Bit-true counterpart of ``up_frac``: the sparsified round-start
        gradient costs ``k_frac * (32 + 32)`` bits a coordinate (f32 values
        and int32 indices); the endpoint message pays the attached
        transforms."""
        g_bits = 32.0 * (sparsified_up_frac(self.k_frac)
                         if self.k_frac < 1.0 else 1.0)
        return (g_bits + self._transforms_bits(32.0)) / 2.0

    @property
    def cohort_compatible(self) -> bool:
        """FedLin's own top-k selects ACROSS the stacked client axis
        (``topk_sparsify`` over the whole uplink-gradient leaf), a
        population-global selection, so cohort execution is only
        compatible when it is dense (``k_frac=1``, FedTrack)."""
        return self.k_frac >= 1.0

    def init_warmup(self, gf, x0, init_batch):
        del gf, init_batch
        x = replicate(x0, self.n_clients)
        return FedLinState(x=x, memory=tree_zeros_like(x), t=0), False

    def _compress_up(self, g, memory):
        """Top-k sparsification with error feedback on the uplink gradient."""
        if self.k_frac >= 1.0:
            return g, memory
        g_eff = tree_map(lambda a, b: a + b, g, memory)
        g_sparse = tree_map(lambda a: topk_sparsify(a, self.k_frac), g_eff)
        memory = tree_map(lambda a, b: a - b, g_eff, g_sparse)
        return g_sparse, memory

    def begin_round(self, gf, state, first_batch, agg):
        """Round-start exchange: each client evaluates its gradient at the
        shared point, uplinks it (sparsified when k_frac < 1), the server
        means it and downlinks the mean."""
        g_i = gf(state.x, first_batch)
        g_i_tx, memory = self._compress_up(g_i, state.memory)
        g_bar = agg(g_i_tx)
        return state._replace(memory=memory), (g_i_tx, g_bar)

    def _tracked_step(self, gf, state, batch, rctx):
        g_i_tx, g_bar = rctx
        g = gf(state.x, batch)
        return tree_map(
            lambda yy, gg, gi, gb: yy - self.alpha * (gg - gi + gb),
            state.x, g, g_i_tx, g_bar)

    def local_step(self, gf, state, batch, rctx):
        return state._replace(x=self._tracked_step(gf, state, batch, rctx))

    def message(self, gf, state, batch, rctx):
        """The tau-th corrected step folds into the endpoint message."""
        return self._tracked_step(gf, state, batch, rctx), None

    def server_aggregate(self, state, msg, msg_bar, mctx, rctx):
        return FedLinState(x=broadcast_mean(msg_bar, msg),
                           memory=state.memory, t=state.t + self.tau)


def FedTrack(alpha: float, tau: int, n_clients: int) -> FedLin:
    """FedTrack = FedLin without sparsification (k_frac = 1)."""
    return FedLin(alpha=alpha, tau=tau, n_clients=n_clients, k_frac=1.0,
                  name="fedtrack")
