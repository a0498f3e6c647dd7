"""FedAvg [4], the canonical federated learning baseline, as an engine spec
(port of ``src/repro/core/baselines/fedavg.py``).

tau local SGD steps per client, then the server averages the models. One
n-dimensional vector up and one down per round, the same communication as
FedCET, but under heterogeneous client Hessians it exhibits *client
drift*: with a constant learning rate the iterates stall at a nonzero
distance from x* (the failure FedCET fixes).

The transmitted message is the post-local-steps model itself; the server
aggregate broadcasts its (participating-clients) mean.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

from repro_torch.core.api import replicate
from repro_torch.core.engine import RoundEngine
from repro_torch.utils.tree import tree_map


class FedAvgState(NamedTuple):
    x: Any  # stacked [clients, ...]
    t: int  # step counter, advanced by tau a round


def broadcast_mean(msg_bar, msg):
    """The server's aggregate broadcast to every client: ``msg_bar``
    materialized at the stacked shape of ``msg`` (contiguous, as every
    per-client state leaf of the port)."""
    return tree_map(lambda mb, mm: mb.expand(mm.shape).contiguous(),
                    msg_bar, msg)


@dataclasses.dataclass(frozen=True)
class FedAvg(RoundEngine):
    alpha: float
    tau: int
    n_clients: int
    name: str = "fedavg"
    vectors_up: int = 1
    vectors_down: int = 1

    def init_warmup(self, gf, x0, init_batch):
        del gf, init_batch
        return FedAvgState(x=replicate(x0, self.n_clients), t=0), False

    def _sgd(self, gf, x, batch):
        g = gf(x, batch)
        return tree_map(lambda xx, gg: xx - self.alpha * gg, x, g)

    def local_step(self, gf, state, batch, rctx):
        return FedAvgState(x=self._sgd(gf, state.x, batch), t=state.t)

    def message(self, gf, state, batch, rctx):
        """The tau-th local step folds into the message computation."""
        return self._sgd(gf, state.x, batch), None

    def server_aggregate(self, state, msg, msg_bar, mctx, rctx):
        return FedAvgState(x=broadcast_mean(msg_bar, msg),
                           t=state.t + self.tau)
