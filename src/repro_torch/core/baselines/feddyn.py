"""FedDyn [Acar et al., ICLR 2021], dynamic regularization, as an engine
spec (port of ``src/repro/core/baselines/feddyn.py``).

Each client carries a dual variable ``lam_i`` (its running estimate of the
local gradient at the consensus optimum) and descends the dynamic
surrogate ``f_i(x) - <lam_i, x> + (a/2) ||x - x_t||^2`` with ``tau``
gradient steps from the round-start anchor ``x_t``:

    x <- x - alpha (grad_i(x) - lam_i + a (x - x_t)),

then updates the dual from the transmitted endpoint ``y_i``:

    lam_i <- lam_i - a (y_i - x_t).

The server tracks ``h = mean_i(lam_i)`` from the SAME aggregate the model
update uses and de-biases the broadcast:

    h <- h - a (y_bar - x_t),        x_{t+1} = y_bar - h / a.

At the fixed point ``lam_i = grad_i(x*)``, so FedDyn converges exactly
under heterogeneous data with a constant step, sending one n-vector each
way. ``h`` is replicated server state: under client sampling absent
clients keep their frozen replica.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

from repro_torch.core.api import replicate
from repro_torch.core.engine import RoundEngine
from repro_torch.utils.tree import tree_map, tree_zeros_like


class FedDynState(NamedTuple):
    x: Any       # stacked [clients, ...] model parameters
    lam: Any     # stacked per-client dual variables (-> grad_i(x*))
    h: Any       # server de-bias state (replicated; -> 0 at the optimum)
    t: int


@dataclasses.dataclass(frozen=True)
class FedDyn(RoundEngine):
    alpha: float
    a_dyn: float
    tau: int
    n_clients: int
    name: str = "feddyn"
    vectors_up: int = 1
    vectors_down: int = 1

    def init_warmup(self, gf, x0, init_batch):
        del gf, init_batch
        x = replicate(x0, self.n_clients)
        return FedDynState(x=x, lam=tree_zeros_like(x), h=tree_zeros_like(x),
                           t=0), False

    def begin_round(self, gf, state, first_batch, agg):
        """rctx = the round-start model (the anchor x_t)."""
        del gf, first_batch, agg
        return state, state.x

    def _dyn_step(self, gf, state, batch, x0):
        g = gf(state.x, batch)
        return tree_map(
            lambda xx, gg, ll, aa:
                xx - self.alpha * (gg - ll + self.a_dyn * (xx - aa)),
            state.x, g, state.lam, x0)

    def local_step(self, gf, state, batch, rctx):
        return state._replace(x=self._dyn_step(gf, state, batch, rctx))

    def message(self, gf, state, batch, rctx):
        """The tau-th dynamic step folds into the endpoint message."""
        return self._dyn_step(gf, state, batch, rctx), None

    def server_aggregate(self, state, msg, msg_bar, mctx, rctx):
        """``lam_i`` updates from the client's own TRANSMITTED endpoint
        (``msg``, after compression) and ``h`` from the aggregate of the
        same wire data, so ``h = mean_i(lam_i)`` survives any compressor
        exactly (the discipline of FedCET's Lemma 2)."""
        x0 = rctx
        lam_new = tree_map(lambda ll, yy, aa: ll - self.a_dyn * (yy - aa),
                           state.lam, msg, x0)
        h_new = tree_map(lambda hh, mb, aa: hh - self.a_dyn * (mb - aa),
                         state.h, msg_bar, x0)
        x_next = tree_map(
            lambda mb, hh: mb.expand(hh.shape) - hh / self.a_dyn,
            msg_bar, h_new)
        return FedDynState(x=x_next, lam=lam_new, h=h_new,
                           t=state.t + self.tau)
