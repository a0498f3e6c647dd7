"""The long convergence mirrors of ``tests/test_baselines.py`` for the
port, on the CPU in float64, on the reference's quadratic problems passed
in as numpy, at the reference's round counts: FedCET goes exact where
FedAvg floors at the same bytes; FedTrack, SCAFFOLD, sparsified FedLin
and FedProx converge exactly. FedDyn's are in
``tests/test_torch_baselines_feddyn.py``.
(``test_fedprox_inherits_all_three_transforms`` needs delay, which the
port does not run yet.)"""

import numpy as np
import pytest
import torch

from repro_torch.core import (FedAvg, FedCET, FedLin, FedProx, FedTrack,
                              Scaffold, max_weight_c)
from repro_torch.core.lr_search import lr_search
from repro_torch.core.simulate import simulate_quadratic
from repro_torch.data.quadratic import QuadraticProblem


def _port(name, seed):
    import jax

    jax.config.update("jax_enable_x64", True)
    import repro.data.quadratic as jq

    jp = getattr(jq, name)(seed)
    return QuadraticProblem(b=torch.tensor(np.asarray(jp.b)),
                            m=torch.tensor(np.asarray(jp.m)))


@pytest.fixture(scope="module")
def problem():
    return _port("make_quadratic_problem", 0)


@pytest.fixture(scope="module")
def hetero():
    return _port("make_hetero_hessian_problem", 11)


def _sim(algo, problem, rounds):
    return simulate_quadratic(algo, problem, rounds, device="cpu")


def test_fedcet_beats_fedavg_floor_same_bytes(hetero):
    tau = 2
    alpha = lr_search(hetero.mu, hetero.L, tau)
    fedcet = FedCET(alpha=alpha, c=max_weight_c(hetero.mu, alpha), tau=tau,
                    n_clients=hetero.n_clients)
    fedavg = FedAvg(alpha=1.0 / (2 * tau * hetero.L), tau=tau,
                    n_clients=hetero.n_clients)
    r_cet = _sim(fedcet, hetero, 3000)
    r_avg = _sim(fedavg, hetero, 3000)
    assert r_cet.bytes_per_round == r_avg.bytes_per_round
    assert r_cet.final_error < 1e-8 < r_avg.final_error


def test_fedtrack_converges_exactly(problem):
    algo = FedTrack(alpha=1.0 / (18 * 2 * problem.L), tau=2,
                    n_clients=problem.n_clients)
    res = _sim(algo, problem, 1500)
    assert res.final_error < 1e-8, res.final_error


def test_scaffold_converges_exactly(problem):
    algo = Scaffold(alpha_l=1.0 / (81 * 2 * problem.L), alpha_g=1.0, tau=2,
                    n_clients=problem.n_clients)
    res = _sim(algo, problem, 4000)
    assert res.final_error < 1e-6, res.final_error


def test_fedlin_sparsified_converges(problem):
    """Top-30% uplink sparsification with error feedback still converges
    exactly (more rounds, fewer bytes a round)."""
    algo = FedLin(alpha=1.0 / (18 * 2 * problem.L), tau=2,
                  n_clients=problem.n_clients, k_frac=0.3)
    res = _sim(algo, problem, 4000)
    assert res.final_error < 1e-6, res.final_error


@pytest.mark.parametrize("mu", [0.5, 2.0])
def test_fedprox_converges_on_quadratic(problem, mu):
    """On the paper's (homogeneous-Hessian) quadratic the proximal anchor
    does not bias the fixed point."""
    algo = FedProx(alpha=1.0 / (2 * 2 * problem.L), mu_prox=mu, tau=2,
                   n_clients=problem.n_clients)
    res = _sim(algo, problem, 2000)
    assert res.final_error < 1e-9, (mu, res.final_error)
