"""Mirrors of ``tests/test_participation.py`` (partial client
participation) and ``tests/test_invariants.py`` (the system-level
invariants, as seeded cases) on the port, on the CPU in float64, held to
the reference's own bounds.

The participation tests run on the reference's ``make_quadratic_problem(0)``
(carried across as numpy); the invariants draw their problems with the
port's own generator at fixed seeds (``make_quadratic_problem(seed)``,
``make_hetero_hessian_problem(seed)``), as many cases as the reference's
``max_examples`` (10, 8 and 6).
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import FedCET, max_weight_c
from repro_torch.core import prng
from repro_torch.core.lr_search import lr_search
from repro_torch.core.participation import FedCETPartial, participation_mask
from repro_torch.core.simulate import simulate_quadratic
from repro_torch.data.quadratic import (QuadraticProblem,
                                        make_hetero_hessian_problem,
                                        make_quadratic_problem)


@pytest.fixture(scope="module")
def problem():
    import jax

    jax.config.update("jax_enable_x64", True)
    from repro.data.quadratic import make_quadratic_problem as jmake

    jp = jmake(0)
    return QuadraticProblem(b=torch.tensor(np.asarray(jp.b)),
                            m=torch.tensor(np.asarray(jp.m)))


def _sim(algo, problem, rounds, **kw):
    return simulate_quadratic(algo, problem, rounds, device="cpu", **kw)


def _algo(problem, rate, tau=2):
    alpha = lr_search(problem.mu, problem.L, tau)
    return FedCETPartial(alpha=alpha, c=max_weight_c(problem.mu, alpha),
                         tau=tau, n_clients=problem.n_clients,
                         participation=rate)


# ---------------------------------------------- tests/test_participation.py
def test_mask_never_empty():
    """Mirror of ``test_mask_never_empty`` (rate 0.05, 50 keys)."""
    for s in range(50):
        assert bool(participation_mask(prng.key(s), 10, 0.05).any())


def test_full_participation_matches_fedcet(problem):
    """Mirror of ``test_full_participation_matches_fedcet``."""
    a = _algo(problem, 1.0)
    base = FedCET(alpha=a.alpha, c=a.c, tau=2, n_clients=problem.n_clients)
    np.testing.assert_allclose(_sim(a, problem, 40).errors.numpy(),
                               _sim(base, problem, 40).errors.numpy(),
                               rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("rate", [0.8, 0.5])
def test_partial_participation_still_exact(problem, rate):
    """Mirror of ``test_partial_participation_still_exact``: < 1e-8 after
    1200 / rate rounds."""
    res = _sim(_algo(problem, rate), problem, int(1200 / rate))
    assert res.final_error < 1e-8, (rate, res.final_error)


def test_drift_sum_invariant_under_sampling(problem):
    """Mirror of ``test_drift_sum_invariant_under_sampling``."""
    res = _sim(_algo(problem, 0.6), problem, 37)
    np.testing.assert_allclose(torch.mean(res.state.d, dim=0).numpy(), 0.0,
                               atol=1e-10)


def test_lower_participation_is_slower_but_unbiased(problem):
    """Mirror of ``test_lower_participation_is_slower_but_unbiased``."""
    errs = {rate: _sim(_algo(problem, rate), problem, 250).final_error
            for rate in (1.0, 0.5)}
    assert errs[1.0] < errs[0.5]
    assert _sim(_algo(problem, 0.5), problem, 3000).final_error < 1e-10


# -------------------------------------------------- tests/test_invariants.py
@pytest.mark.parametrize("seed,tau,rounds,n_clients", [
    (0, 1, 1, 2), (17, 2, 30, 8), (123, 3, 7, 3), (999, 4, 12, 5),
    (2024, 1, 25, 6), (4096, 2, 3, 4), (5000, 3, 19, 7), (7777, 4, 30, 2),
    (8191, 2, 11, 8), (10_000, 1, 16, 3)])
def test_property_drift_variable_is_mean_zero(seed, tau, rounds, n_clients):
    """Mirror of ``test_property_drift_variable_is_mean_zero``: d sums to
    zero over clients (1e-10) at every round count."""
    p = make_quadratic_problem(seed, n_clients=n_clients, dim=12)
    algo = FedCET(alpha=0.01, c=0.3, tau=tau, n_clients=n_clients)
    res = _sim(algo, p, rounds)
    np.testing.assert_allclose(torch.mean(res.state.d, dim=0).numpy(), 0.0,
                               atol=1e-10)


@pytest.mark.parametrize("seed,rounds", [
    (0, 5), (11, 50), (257, 17), (1000, 33), (3141, 8), (6000, 41),
    (9001, 26), (10_000, 12)])
def test_property_consensus_error_bounded_by_state(seed, rounds):
    """Mirror of ``test_property_consensus_error_bounded_by_state``: the
    clients' spread about their mean stays below 10 (1 + |mean|)."""
    p = make_hetero_hessian_problem(seed)
    alpha = lr_search(p.mu, p.L, 2)
    algo = FedCET(alpha=alpha, c=max_weight_c(p.mu, alpha), tau=2,
                  n_clients=p.n_clients)
    x = _sim(algo, p, rounds).state.x
    spread = float(torch.linalg.norm(x - x.mean(0, keepdim=True)))
    assert np.isfinite(spread)
    assert spread < 10.0 * (1.0 + float(torch.linalg.norm(x.mean(0))))


@pytest.mark.parametrize("seed,scale", [
    (0, 0.1), (7, 10.0), (99, 1.0), (256, 3.7), (640, 0.55), (1000, 7.25)])
def test_property_translation_equivariance(seed, scale):
    """Mirror of ``test_property_translation_equivariance``: shifting
    every measurement by 2s and x0 by s shifts the whole trajectory, so
    the e(k) curves agree (rtol 1e-8, atol 1e-9)."""
    p1 = make_quadratic_problem(seed, n_clients=4, dim=8)
    shift = scale * torch.ones(8, dtype=p1.b.dtype)
    p2 = dataclasses.replace(p1, b=p1.b + 2.0 * shift[None, None, :])
    algo = FedCET(alpha=0.02, c=0.3, tau=2, n_clients=4)
    r1 = _sim(algo, p1, 30)
    r2 = _sim(algo, p2, 30, x0=torch.zeros(8, dtype=p1.b.dtype) + shift)
    np.testing.assert_allclose(r1.errors.numpy(), r2.errors.numpy(),
                               rtol=1e-8, atol=1e-9)
