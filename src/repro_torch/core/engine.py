"""The federated round engine, synchronous star core (port of
``src/repro/core/engine.py``).

Every algorithm shares the paper's round structure (Remark 2): ``tau - 1``
pure-local steps, then ONE aggregating step in which each client transmits
a message, the server reduces it, and clients apply the result. The engine
owns that structure once; an algorithm is a frozen-dataclass *spec* with
the reference's hooks, under identical names and signatures:

* ``init_warmup(gf, x0, init_batch) -> (state, run_init_comm_step)``;
* ``begin_round(gf, state, first_batch, agg) -> (state, rctx)``;
* ``local_step(gf, state, batch, rctx) -> state``;
* ``message(gf, state, batch, rctx) -> (msg, mctx)``;
* ``server_aggregate(state, msg, msg_bar, mctx, rctx) -> state``.

PyTorch runs eagerly, so the reference's ``lax.scan`` over local steps and
over rounds become Python loops. This slice ports the synchronous star
round only: message transforms, client sampling, delay, topology, cohort,
arena and telemetry stay as fields, and setting any of them raises
``NotImplementedError`` naming the slice that ports it.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.core.api import GradFn, vmap_grads
from repro_torch.utils.tree import tree_client_mean, tree_leaves, tree_map

#: engine fields whose mechanisms later slices port (see ROADMAP.md).
_LATER = {
    "transforms": "the compressed-uplink slice (slice 2)",
    "sampling": "the client-sampling slice (slice 2)",
    "delay": "the scenario-axes slice",
    "topology": "the scenario-axes slice",
    "cohort": "the scenario-axes slice",
    "arena": "the arena slice (slice 3)",
    "telemetry": "the telemetry slice",
    "spmd_client_axes": "the multi-GPU launch slice",
}


def masked_client_mean(tree, mask: torch.Tensor, *, keepdims: bool = True):
    """Mean over the leading clients axis restricted to ``mask``-selected
    clients (the server average under partial participation)."""
    denom = torch.clamp(mask.to(torch.int64).sum(), min=1)

    def mean_leaf(a):
        mb = mask.reshape((-1,) + (1,) * (a.dim() - 1)).to(a.dtype)
        return torch.sum(a * mb, dim=0, keepdim=keepdims) / denom.to(a.dtype)

    return tree_map(mean_leaf, tree)


@dataclasses.dataclass(frozen=True)
class RoundEngine:
    """Shared round driver; algorithms subclass it and implement the hooks.

    Subclasses declare ``name``, ``tau``, ``n_clients``, ``vectors_up`` and
    ``vectors_down``; their state is a NamedTuple whose per-client leaves
    carry a leading ``n_clients`` axis, plus a step counter ``t`` (a Python
    int) that a round advances by exactly ``tau``."""

    transforms: tuple = dataclasses.field(default=(), kw_only=True)
    sampling: Any | None = dataclasses.field(default=None, kw_only=True)
    delay: Any | None = dataclasses.field(default=None, kw_only=True)
    topology: Any | None = dataclasses.field(default=None, kw_only=True)
    cohort: Any | None = dataclasses.field(default=None, kw_only=True)
    arena: bool = dataclasses.field(default=False, kw_only=True)
    telemetry: Any | None = dataclasses.field(default=None, kw_only=True)
    spmd_client_axes: tuple = dataclasses.field(default=(), kw_only=True)

    def __post_init__(self):
        for name, where in _LATER.items():
            if getattr(self, name):
                raise NotImplementedError(
                    f"RoundEngine.{name} is not yet ported to PyTorch: it "
                    f"comes with {where}")

    # ------------------------------------------------------------ spec hooks
    def init_warmup(self, gf, x0, init_batch):
        raise NotImplementedError

    def begin_round(self, gf, state, first_batch, agg):
        """Optional round-start exchange; returns (state, round context)."""
        del gf, first_batch, agg
        return state, None

    def local_step(self, gf, state, batch, rctx):
        raise NotImplementedError

    def message(self, gf, state, batch, rctx):
        raise NotImplementedError

    def server_aggregate(self, state, msg, msg_bar, mctx, rctx):
        raise NotImplementedError

    def client_params(self, state):
        """Stacked [clients, ...] model parameters (default: ``state.x``)."""
        return state.x

    def global_params(self, state):
        return tree_client_mean(self.client_params(state), keepdims=False)

    # ------------------------------------------------------------- plumbing
    def _comm_step(self, gf, inner, batch, rctx, agg):
        """The single aggregating step: message -> reduce -> apply."""
        msg, mctx = self.message(gf, inner, batch, rctx)
        return self.server_aggregate(inner, msg, agg(msg), mctx, rctx)

    # -------------------------------------------------------------- protocol
    def init(self, grad_fn: GradFn, x0, init_batch):
        """Replicate-and-warm-up, plus one aggregating step if the spec's
        warm-up requests it."""
        gf = vmap_grads(grad_fn)
        inner, run_comm = self.init_warmup(gf, x0, init_batch)
        if run_comm:
            inner = self._comm_step(gf, inner, init_batch, None,
                                    tree_client_mean)
        return inner

    def round(self, grad_fn: GradFn, state, batches):
        """One communication round: optional round-start exchange, tau-1
        local steps, one aggregating step. ``batches`` leaves have leading
        ``[tau, clients, ...]`` axes."""
        gf = vmap_grads(grad_fn)
        agg = tree_client_mean
        inner, rctx = self.begin_round(
            gf, state, tree_map(lambda b: b[0], batches), agg)
        for k in range(self.tau - 1):
            inner = self.local_step(gf, inner,
                                    tree_map(lambda b: b[k], batches), rctx)
        last_b = tree_map(lambda b: b[self.tau - 1], batches)
        return self._comm_step(gf, inner, last_b, rctx, agg)


# --------------------------------------------------------- multi-round driver
def make_round_runner(algo, grad_fn: GradFn, *, metric_fn=None,
                      repeat: bool = False, metric_with_batch: bool = False):
    """The K-round loop over ``algo.round`` (the reference's jitted scan).

    * ``repeat=False``: ``run(state, batches)`` loops over stacked
      per-round batches (leaves ``[rounds, tau, clients, ...]``).
    * ``repeat=True``: ``run(state, batches, rounds)`` replays the SAME
      per-round batch tree (leaves ``[tau, clients, ...]``).

    ``metric_fn(state)`` (or ``metric_fn(state, round_batches)`` with
    ``metric_with_batch``) runs after every round; its tensor results are
    stacked into the second return value (``None`` without a hook)."""

    def _metric(s, b):
        if metric_fn is None:
            return None
        return metric_fn(s, b) if metric_with_batch else metric_fn(s)

    def _stack(ys):
        return None if metric_fn is None else torch.stack(ys)

    if repeat:
        def run(state, batches, rounds):
            ys = []
            for _ in range(rounds):
                state = algo.round(grad_fn, state, batches)
                ys.append(_metric(state, batches))
            return state, _stack(ys)

        return run

    def run(state, batches):
        ys = []
        for r in range(tree_leaves(batches)[0].shape[0]):
            b = tree_map(lambda a: a[r], batches)
            state = algo.round(grad_fn, state, b)
            ys.append(_metric(state, b))
        return state, _stack(ys)

    return run


def scan_segments(start: int, total: int, is_boundary, *, max_rounds: int = 32):
    """Yield ``(first, last)`` round indices of loop segments: each ends at
    the next boundary round (inclusive) or after ``max_rounds``."""
    r = start
    while r < total:
        cap = min(total - 1, r + max_rounds - 1)
        stop = next((s for s in range(r, cap) if is_boundary(s)), cap)
        yield r, stop
        r = stop + 1


def run_rounds(algo, grad_fn: GradFn, state, batches, *,
               rounds: int | None = None, metric_fn=None):
    """Run K communication rounds. With ``rounds=None`` the batches leaves
    are ``[rounds, tau, clients, ...]`` stacks; with ``rounds=K`` one
    per-round tree is replayed K times. Returns ``(state, metrics)``."""
    if rounds is not None:
        return make_round_runner(algo, grad_fn, metric_fn=metric_fn,
                                 repeat=True)(state, batches, rounds)
    return make_round_runner(algo, grad_fn, metric_fn=metric_fn)(state,
                                                                 batches)
