"""SCAFFOLD [26], stochastic controlled averaging, as an engine spec (port
of ``src/repro/core/baselines/scaffold.py``).

Clients carry a control variate c_i, the server carries c; local steps use
the corrected gradient grad_i - c_i + c. Full participation with option II
control updates (the variant of the paper's comparison: alpha_g = 1,
alpha_l = 1/(81 tau L)).

Communication per round per client: the model delta AND the control delta
up, the global model AND the global control down: TWO n-dimensional
vectors each way, double FedCET's traffic (Remark 2). The message is the
two-tree dict ``{"dc": c_i+ - c_i, "dy": y - x}``; ``begin_round`` stashes
the round-start model so the deltas and the option-II update have their
anchor after the local steps have advanced ``x``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

from repro_torch.core.api import replicate
from repro_torch.core.engine import RoundEngine
from repro_torch.utils.tree import tree_map, tree_zeros_like


class ScaffoldState(NamedTuple):
    x: Any       # server model, replicated across the stacked axis
    c_i: Any     # stacked per-client control variates
    c: Any       # server control variate (replicated)
    t: int


@dataclasses.dataclass(frozen=True)
class Scaffold(RoundEngine):
    alpha_l: float
    tau: int
    n_clients: int
    alpha_g: float = 1.0
    name: str = "scaffold"
    vectors_up: int = 2
    vectors_down: int = 2

    def init_warmup(self, gf, x0, init_batch):
        del gf, init_batch
        x = replicate(x0, self.n_clients)
        return ScaffoldState(x=x, c_i=tree_zeros_like(x),
                             c=tree_zeros_like(x), t=0), False

    def message_like(self, inner):
        return {"dc": inner.x, "dy": inner.x}

    def begin_round(self, gf, state, first_batch, agg):
        del gf, first_batch, agg
        return state, state.x  # rctx = round-start model x

    def _corrected_step(self, gf, state, batch):
        g = gf(state.x, batch)
        return tree_map(
            lambda yy, gg, ci, cc: yy - self.alpha_l * (gg - ci + cc),
            state.x, g, state.c_i, state.c)

    def local_step(self, gf, state, batch, rctx):
        return state._replace(x=self._corrected_step(gf, state, batch))

    def message(self, gf, state, batch, rctx):
        x0 = rctx
        y = self._corrected_step(gf, state, batch)
        # Option II: c_i+ = c_i - c + (x - y_i) / (tau * alpha_l)
        c_i_new = tree_map(
            lambda ci, cc, xx, yy:
                ci - cc + (xx - yy) / (self.tau * self.alpha_l),
            state.c_i, state.c, x0, y)
        # keys in sorted order: the reference's (JAX's) flatten order, which
        # numbers the leaves a compressor keys its dither by.
        msg = {"dc": tree_map(lambda a, b: a - b, c_i_new, state.c_i),
               "dy": tree_map(lambda a, b: a - b, y, x0)}
        return msg, c_i_new

    def server_aggregate(self, state, msg, msg_bar, mctx, rctx):
        x0, c_i_new = rctx, mctx
        x_new = tree_map(lambda xx, d: xx + self.alpha_g * d,
                         x0, msg_bar["dy"])
        c_new = tree_map(lambda a, b: a + b, state.c, msg_bar["dc"])
        return ScaffoldState(x=x_new, c_i=c_i_new, c=c_new,
                             t=state.t + self.tau)
