"""FedProx [Li et al., MLSys 2020], proximal local SGD, as an engine spec
(port of ``src/repro/core/baselines/fedprox.py``).

Each round starts from the shared global model ``x0`` (the round-start
anchor, carried as ``rctx``); every local step descends the proximal
surrogate ``f_i(x) + (mu/2) ||x - x0||^2``:

    x <- x - alpha * (grad_i(x) + mu * (x - x0)).

The message is the post-local-steps model (as FedAvg's); the server
broadcasts the (participating-clients) mean. One n-vector each way.
``mu = 0`` runs FedAvg's iterates exactly.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

from repro_torch.core.api import replicate
from repro_torch.core.baselines.fedavg import broadcast_mean
from repro_torch.core.engine import RoundEngine
from repro_torch.utils.tree import tree_map


class FedProxState(NamedTuple):
    x: Any  # stacked [clients, ...]
    t: int


@dataclasses.dataclass(frozen=True)
class FedProx(RoundEngine):
    alpha: float
    mu_prox: float
    tau: int
    n_clients: int
    name: str = "fedprox"
    vectors_up: int = 1
    vectors_down: int = 1

    def init_warmup(self, gf, x0, init_batch):
        del gf, init_batch
        return FedProxState(x=replicate(x0, self.n_clients), t=0), False

    def begin_round(self, gf, state, first_batch, agg):
        """rctx = the round-start model (the proximal anchor x0; the
        broadcast global model, since server_aggregate replicates it)."""
        del gf, first_batch, agg
        return state, state.x

    def _prox_step(self, gf, x, batch, x0):
        g = gf(x, batch)
        return tree_map(
            lambda xx, gg, aa: xx - self.alpha * (gg + self.mu_prox * (xx - aa)),
            x, g, x0)

    def local_step(self, gf, state, batch, rctx):
        return FedProxState(x=self._prox_step(gf, state.x, batch, rctx),
                            t=state.t)

    def message(self, gf, state, batch, rctx):
        """The tau-th proximal step folds into the message computation."""
        return self._prox_step(gf, state.x, batch, rctx), None

    def server_aggregate(self, state, msg, msg_bar, mctx, rctx):
        return FedProxState(x=broadcast_mean(msg_bar, msg),
                            t=state.t + self.tau)
