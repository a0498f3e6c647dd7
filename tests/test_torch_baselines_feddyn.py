"""FedDyn's convergence mirrors of ``tests/test_baselines.py`` for the
port, on the CPU in float64, on the reference's heterogeneous-Hessian
problem (``make_hetero_hessian_problem(11)``) passed in as numpy, at the
reference's round counts: FedDyn converges exactly where FedAvg floors
(three ``a_dyn``), its duals track the local gradients, and it stays
exact under ``shift:q8`` x 0.8 participation (split from
``tests/test_torch_baselines_exact.py`` so that each file stays short)."""

import numpy as np
import pytest
import torch

from repro_torch.core import FedDyn
from repro_torch.core.engine import with_compression, with_participation
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
def hetero():
    return _port("make_hetero_hessian_problem", 11)


def _sim(algo, problem, rounds):
    return simulate_quadratic(algo, problem, rounds, device="cpu")


def _feddyn(problem, a_dyn=1.0, tau=2):
    return FedDyn(alpha=1.0 / (2 * tau * (problem.L + a_dyn)), a_dyn=a_dyn,
                  tau=tau, n_clients=problem.n_clients)


@pytest.mark.parametrize("a_dyn", [0.5, 1.0, 2.0])
def test_feddyn_exact_where_fedavg_floors(hetero, a_dyn):
    res = _sim(_feddyn(hetero, a_dyn), hetero, 3000)
    assert res.final_error < 1e-9, (a_dyn, res.final_error)
    algo = _feddyn(hetero)
    assert algo.vectors_up == 1 and algo.vectors_down == 1


def test_feddyn_dual_tracks_local_gradients(hetero):
    """At the fixed point lam_i -> grad f_i(x*), and their mean tracks the
    server de-bias state h."""
    state = _sim(_feddyn(hetero), hetero, 3000).state
    x_star = hetero.x_star
    grads = torch.stack([
        hetero.client_grad(x_star, {"b": hetero.b[i], "m": hetero.m[i]})
        for i in range(hetero.n_clients)])
    np.testing.assert_allclose(state.lam.numpy(), grads.numpy(), atol=1e-8)
    np.testing.assert_allclose(state.lam.mean(0).numpy(),
                               state.h[0].numpy(), atol=1e-10)


def test_feddyn_exact_under_compression_and_participation(hetero):
    """Exact under shift:q8 x 80% sampling, because the dual update uses
    the client's own transmitted message."""
    algo = with_compression(with_participation(_feddyn(hetero), 0.8, seed=3),
                            compressor="shift:q8")
    res = _sim(algo, hetero, 3000)
    assert res.final_error < 1e-9, res.final_error
