"""The port's FedCET on the paper's §IV quadratic problem against the JAX
package's, on the reference's ``make_quadratic_problem(0)`` arrays passed
in as numpy, in float64 on the CPU.

* the per-round error curve of ``simulate_quadratic`` equals JAX's within
  1e-12 over 200 rounds;
* Lemma 1: the (d, x) form equals the literal Algorithm 2 (1e-9, the
  reference's own bound in tests/test_fedcet_quadratic.py);
* Algorithm 1 (``lr_search``), ``contraction_factors`` and ``max_weight_c``
  equal the reference exactly (the same float arithmetic);
* FedCET reaches the exact optimum: error < 1e-9 at 400 rounds.
* Mirrors of the theory tests of ``tests/test_fedcet_quadratic.py``, each
  named in its docstring and held to its bounds: the gradient's closed
  form, ``x*`` stationary, the measured rate under Corollary 1's rho, the
  fixed point of Lemma 2, one vector each way, convergence across tau,
  exactness with heterogeneous Hessians and with homogeneous data.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import FedCET, FedCETLiteral, max_weight_c
from repro_torch.core.lr_search import contraction_factors, lr_search
from repro_torch.core.simulate import simulate_quadratic
from repro_torch.data.quadratic import (QuadraticProblem,
                                        make_hetero_hessian_problem,
                                        make_quadratic_problem)


def _jax():
    import jax

    jax.config.update("jax_enable_x64", True)
    return jax


@pytest.fixture(scope="module")
def problems():
    _jax()
    from repro.data.quadratic import make_quadratic_problem as jmake

    jp = jmake(0)
    port = QuadraticProblem(b=torch.tensor(np.asarray(jp.b)),
                            m=torch.tensor(np.asarray(jp.m)))
    return jp, port


def _fedcet(problem, tau=2, cls=FedCET):
    alpha = lr_search(problem.mu, problem.L, tau)
    return cls(alpha=alpha, c=max_weight_c(problem.mu, alpha), tau=tau,
               n_clients=problem.n_clients)


@pytest.fixture(scope="module")
def port_run(problems):
    """400 rounds of the port's FedCET, run once for the tests below."""
    return simulate_quadratic(_fedcet(problems[1]), problems[1], 400,
                              device="cpu")


def test_error_curve_matches_jax(problems, port_run):
    from repro.core import FedCET as JFedCET
    from repro.core.simulate import simulate_quadratic as jsim

    jp, port = problems
    algo = _fedcet(port)
    jalgo = JFedCET(alpha=algo.alpha, c=algo.c, tau=algo.tau,
                    n_clients=algo.n_clients)
    want = np.asarray(jsim(jalgo, jp, rounds=200).errors)
    got = port_run.errors.numpy()[:201]
    assert got.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_exact_convergence_at_400_rounds(port_run):
    assert port_run.final_error < 1e-9, port_run.final_error


def test_problem_constants_match_jax(problems):
    jp, port = problems
    assert port.mu == jp.mu and port.L == jp.L
    # the means reduce in another order than XLA's: last-bit differences
    np.testing.assert_allclose(port.x_star.numpy(), np.asarray(jp.x_star),
                               rtol=0, atol=1e-15)
    batch = {"b": port.b[0], "m": port.m[0]}
    x = torch.linspace(-1.0, 1.0, port.dim, dtype=torch.float64)
    np.testing.assert_allclose(
        torch.func.grad(port.client_loss)(x, batch).numpy(),
        port.client_grad(x, batch).numpy(), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("tau", [1, 2, 3, 8])
def test_lr_search_and_weights_equal_reference(problems, tau):
    from repro.core import max_weight_c as jmax_weight_c
    from repro.core.lr_search import contraction_factors as jcf
    from repro.core.lr_search import lr_search as jlr

    jp, port = problems
    alpha = lr_search(port.mu, port.L, tau)
    assert alpha == jlr(jp.mu, jp.L, tau)
    assert max_weight_c(port.mu, alpha) == jmax_weight_c(jp.mu, alpha)
    assert (contraction_factors(alpha, port.mu, port.L, tau, 10)
            .__dict__ == jcf(alpha, jp.mu, jp.L, tau, 10).__dict__)


def test_dform_equals_literal_form(problems):
    """Lemma 1 in the port: identical iterates at every round."""
    port = problems[1]
    tau = 3
    a, b = _fedcet(port, tau), _fedcet(port, tau, FedCETLiteral)
    grad_fn = torch.func.grad(port.client_loss)
    batches = port.stacked_batches(tau)
    init_batch = {k: v[0] for k, v in batches.items()}
    x0 = torch.zeros(port.dim, dtype=torch.float64)
    sa, sb = a.init(grad_fn, x0, init_batch), b.init(grad_fn, x0, init_batch)
    np.testing.assert_allclose(sa.x.numpy(), sb.x_curr.numpy(), rtol=1e-12,
                               atol=1e-12)
    for _ in range(5):
        sa, sb = a.round(grad_fn, sa, batches), b.round(grad_fn, sb, batches)
        np.testing.assert_allclose(sa.x.numpy(), sb.x_curr.numpy(),
                                   rtol=1e-9, atol=1e-9)


def test_fused_and_unfused_paths_agree_exactly_on_cpu(problems):
    port = problems[1]
    fused = simulate_quadratic(_fedcet(port), port, 20, device="cpu")
    plain = simulate_quadratic(
        dataclasses.replace(_fedcet(port), use_fused_kernel=False),
        port, 20, device="cpu")
    assert torch.equal(fused.errors, plain.errors)


def test_own_problem_generator_converges():
    p = make_quadratic_problem(3)
    assert p.b.dtype == torch.float64 and p.mu == p.L == 4.0
    assert float(p.b.abs().max()) <= 10.0
    res = simulate_quadratic(_fedcet(p), p, 150, device="cpu")
    assert res.final_error < 1e-3 * float(res.errors[0])


# ------------------------------- mirrors of tests/test_fedcet_quadratic.py
def _batch(port, i):
    return {"b": port.b[i], "m": port.m[i]}


def test_gradient_matches_closed_form(problems):
    """Mirror of ``test_gradient_matches_closed_form``: autograd of every
    client's loss equals the closed form (1e-5, the reference's bound)."""
    port = problems[1]
    x = torch.randn(port.dim, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(1))
    for i in range(port.n_clients):
        np.testing.assert_allclose(
            torch.func.grad(port.client_loss)(x, _batch(port, i)).numpy(),
            port.client_grad(x, _batch(port, i)).numpy(),
            rtol=1e-5, atol=1e-5)


def test_x_star_is_stationary(problems):
    """Mirror of ``test_x_star_is_stationary``: the global loss (the mean
    of the client losses) has zero gradient at ``x*`` (1e-10)."""
    port = problems[1]

    def global_loss(x):
        return torch.mean(torch.stack([port.client_loss(x, _batch(port, i))
                                       for i in range(port.n_clients)]))

    np.testing.assert_allclose(
        torch.func.grad(global_loss)(port.x_star).numpy(), 0.0, atol=1e-10)


def test_linear_rate_matches_theory(problems, port_run):
    """Mirror of ``test_linear_rate_matches_theory``: Algorithm 1's alpha
    gives rho < 1, and the geometric-mean contraction over rounds 10-100
    is below sqrt(rho) + 1e-3 and below 1."""
    port = problems[1]
    algo = _fedcet(port)
    cf = contraction_factors(algo.alpha, port.mu, port.L, algo.tau,
                             port.n_clients)
    assert cf.converges, cf
    window = port_run.errors.numpy()[10:100]
    measured = (window[-1] / window[0]) ** (1.0 / (len(window) - 1))
    assert measured < np.sqrt(cf.rho) + 1e-3, (measured, cf.rho)
    assert measured < 1.0


def test_fixed_point_characterization(problems):
    """Mirror of ``test_fixed_point_characterization`` (Lemma 2): after
    600 rounds every client holds x* (1e-7) and d_i = -grad f_i(x*)
    (1e-6)."""
    port = problems[1]
    res = simulate_quadratic(_fedcet(port), port, 600, device="cpu")
    x_star = port.x_star
    for i in range(port.n_clients):
        np.testing.assert_allclose(res.state.x[i].numpy(), x_star.numpy(),
                                   atol=1e-7)
        gi = port.client_grad(x_star, _batch(port, i))
        np.testing.assert_allclose(res.state.d[i].numpy(), -gi.numpy(),
                                   atol=1e-6)


def test_d_never_transmitted_one_vector_comm(problems):
    """Mirror of ``test_d_never_transmitted_one_vector_comm`` (Remark 2)."""
    algo = _fedcet(problems[1])
    assert algo.vectors_up == 1 and algo.vectors_down == 1


@pytest.mark.parametrize("tau", [1, 2, 4, 8])
def test_convergence_across_tau(problems, tau):
    """Mirror of ``test_convergence_across_tau``: < 1e-6 at 200 tau
    rounds."""
    port = problems[1]
    res = simulate_quadratic(_fedcet(port, tau), port, 200 * tau,
                             device="cpu")
    assert res.final_error < 1e-6, (tau, res.final_error)


def test_exact_convergence_heterogeneous_hessians():
    """Mirror of ``test_exact_convergence_heterogeneous_hessians``: the
    reference's ``make_hetero_hessian_problem(7)``, < 1e-9 at 3000
    rounds."""
    _jax()
    from repro.data.quadratic import make_hetero_hessian_problem as jmake

    jp = jmake(7)
    p = QuadraticProblem(b=torch.tensor(np.asarray(jp.b)),
                         m=torch.tensor(np.asarray(jp.m)))
    res = simulate_quadratic(_fedcet(p), p, 3000, device="cpu")
    assert res.final_error < 1e-9, res.final_error
    own = make_hetero_hessian_problem(7)
    assert simulate_quadratic(_fedcet(own), own, 3000,
                              device="cpu").final_error < 1e-9


def test_homogeneous_data_still_converges():
    """Mirror of ``test_homogeneous_data_still_converges``: identical
    client data, < 1e-10 at 300 rounds."""
    p = make_quadratic_problem(3, n_clients=4)
    p = QuadraticProblem(b=p.b[:1].expand(p.b.shape).contiguous(), m=p.m)
    res = simulate_quadratic(_fedcet(p), p, 300, device="cpu")
    assert res.final_error < 1e-10
