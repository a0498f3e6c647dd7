"""Sequential federated simulation driver (port of
``src/repro/core/simulate.py``: ``simulate_quadratic`` and the Fig. 1
line-up ``paper_fig1_algorithms``).

Runs a FederatedAlgorithm against the paper's quadratic problem for K
communication rounds through ``engine.run_rounds``, full-batch, with the
paper's error e(k) = || (1/N) sum_i x_i(k tau) - x* ||. With telemetry
attached (``with_telemetry``) the result carries the stacked per-round
series.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch import resolve_device
from repro_torch.core.engine import run_rounds
from repro_torch.core.telemetry import split_metrics
from repro_torch.data.quadratic import QuadraticProblem
from repro_torch.utils.tree import tree_map


@dataclasses.dataclass(frozen=True)
class SimResult:
    errors: torch.Tensor     # [rounds+1] e(k) = ||mean_i x_i(k tau) - x*||
    state: Any               # final algorithm state
    bytes_per_round: int     # per the algorithm's declared vectors
    #: stacked per-round telemetry series (dict of [rounds, ...] tensors)
    #: when the algorithm has ``with_telemetry`` attached, else None; feed
    #: it to ``core/telemetry.py:drain`` for sinks and monitors.
    telemetry: Any = None

    @property
    def final_error(self) -> float:
        return float(self.errors[-1])


def simulate_quadratic(algo, problem: QuadraticProblem, rounds: int, *,
                       x0: torch.Tensor | None = None,
                       device=None) -> SimResult:
    """The paper's §IV protocol on ``device`` (``cuda`` unless the caller
    passes another; with no card and no explicit device it raises)."""
    device = resolve_device(device)
    problem = problem.to(device)
    if x0 is None:
        x0 = torch.zeros((problem.dim,), dtype=problem.b.dtype, device=device)
    grad_fn = torch.func.grad(problem.client_loss)
    batches = problem.stacked_batches(algo.tau)
    init_batch = tree_map(lambda b: b[0], batches)
    x_star = problem.x_star

    state0 = algo.init(grad_fn, x0, init_batch)

    def err(state) -> torch.Tensor:
        return torch.linalg.norm(algo.global_params(state) - x_star)

    err0 = err(state0)  # a cohort round consumes its input state
    final_state, ys = run_rounds(algo, grad_fn, state0, batches,
                                 rounds=rounds, metric_fn=err)
    errs, telemetry = split_metrics(algo, ys)
    errors = torch.cat([err0[None], errs])
    n_bytes = ((algo.vectors_up + algo.vectors_down) * problem.dim * 4
               * problem.n_clients)
    return SimResult(errors=errors, state=final_state,
                     bytes_per_round=n_bytes, telemetry=telemetry)


def paper_fig1_algorithms(problem: QuadraticProblem, tau: int = 2):
    """The four algorithms of Fig. 1 (+ FedAvg as the drift illustration),
    with the exact learning-rate rules the paper prescribes."""
    from repro_torch.core.baselines import FedAvg, FedTrack, Scaffold
    from repro_torch.core.fedcet import FedCET, max_weight_c
    from repro_torch.core.lr_search import lr_search

    mu, L, n = problem.mu, problem.L, problem.n_clients
    alpha = lr_search(mu, L, tau)  # Algorithm 1, h = 0.001 * alpha_0
    return {
        "fedcet": FedCET(alpha=alpha, c=max_weight_c(mu, alpha), tau=tau,
                         n_clients=n),
        "fedtrack": FedTrack(alpha=1.0 / (18.0 * tau * L), tau=tau,
                             n_clients=n),
        "scaffold": Scaffold(alpha_l=1.0 / (81.0 * tau * L), alpha_g=1.0,
                             tau=tau, n_clients=n),
        "fedavg": FedAvg(alpha=1.0 / (2.0 * tau * L), tau=tau, n_clients=n),
    }
