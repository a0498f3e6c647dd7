"""Compressed-uplink FedCET (``core/fedcet_compressed.py``) against the
JAX package's, on the CPU in float64: mirrors of
``tests/test_fedcet_compressed.py``, each on the reference's own problem
(passed in through numpy), with the port's per-round error curve held
within 1e-12 of the reference's at every round, plus the reference's own
convergence assertions on the port's run.

Top-k with error feedback on the heterogeneous-Hessian problem is the one
exception to "every round": both packages start one ulp apart in places
from round 1 (XLA contracts ``a*b - c`` into an FMA) and the feedback
loop's limit cycle amplifies the gap about e-fold every ~110 rounds
(measured, k 0.5: 7e-16 at round 1000, 1.0e-12 at 1616, 3.8e-6 at 3000 on
an error of 4.6e-5). Those curves are held within 1e-12 over their first
1000 rounds, and the whole 3000-round run to the reference's own
assertions. Without feedback the curves stay within 6e-16 throughout.

The legacy ``k_frac=`` / ``quantize=`` form is
``ErrorFeedbackCompression``: cross-client top-k and bf16 under error
feedback, or without it (``error_feedback=False``), the acceptance case
``k_frac=0.3, quantize=True, error_feedback=False`` included.
"""

import numpy as np
import pytest
import torch

from repro_torch.core.fedcet import FedCET, max_weight_c
from repro_torch.core.fedcet_compressed import FedCETCompressed
from repro_torch.core.lr_search import lr_search
from repro_torch.core.simulate import simulate_quadratic
from repro_torch.data.quadratic import QuadraticProblem

TOL = 1e-12


def _jax():
    import jax

    jax.config.update("jax_enable_x64", True)
    return jax


def _pair(jp):
    return jp, QuadraticProblem(b=torch.tensor(np.asarray(jp.b)),
                                m=torch.tensor(np.asarray(jp.m)))


@pytest.fixture(scope="module")
def problem():
    _jax()
    from repro.data.quadratic import make_quadratic_problem

    return _pair(make_quadratic_problem(0))


@pytest.fixture(scope="module")
def hetero():
    _jax()
    from repro.data.quadratic import make_hetero_hessian_problem

    return _pair(make_hetero_hessian_problem(7))


def _run(pair, rounds, tau=2, exact_rounds=None, **kw):
    """The port's and the reference's FedCETCompressed on one problem;
    returns the port's result after holding its curve to the reference's
    (over the first ``exact_rounds`` rounds when given)."""
    from repro.core.fedcet_compressed import FedCETCompressed as JFC
    from repro.core.simulate import simulate_quadratic as jsim

    jp, port = pair
    alpha = lr_search(port.mu, port.L, tau)
    c = max_weight_c(port.mu, alpha)
    algo = FedCETCompressed(alpha=alpha, c=c, tau=tau,
                            n_clients=port.n_clients, **kw)
    got = simulate_quadratic(algo, port, rounds, device="cpu")
    want = jsim(JFC(alpha=alpha, c=c, tau=tau, n_clients=port.n_clients,
                    **kw), jp, rounds)
    keep = slice(None if exact_rounds is None else exact_rounds + 1)
    np.testing.assert_allclose(got.errors.numpy()[keep],
                               np.asarray(want.errors)[keep], rtol=0,
                               atol=TOL)
    return algo, got


def test_dense_variant_matches_fedcet(problem):
    """k_frac=1, no quantization == plain FedCET exactly."""
    a, r_c = _run(problem, 50)
    base = FedCET(alpha=a.alpha, c=a.c, tau=2, n_clients=10)
    r_b = simulate_quadratic(base, problem[1], 50, device="cpu")
    assert a.transforms == ()
    np.testing.assert_allclose(r_c.errors.numpy(), r_b.errors.numpy(),
                               rtol=1e-10, atol=1e-12)


def test_bf16_quantized_uplink_converges(problem):
    a, res = _run(problem, 600, quantize=True)
    assert res.final_error < 1e-5, res.final_error
    assert a.up_frac == 0.5


def test_topk_sparsified_uplink_converges(problem):
    a, res = _run(problem, 2000, k_frac=0.3)
    assert res.final_error < 1e-6, res.final_error
    assert a.up_frac == pytest.approx(0.6)


def test_topk_hetero_hessians_neighborhood(hetero):
    """Under Hessian heterogeneity top-k + EF FedCET reaches a small
    neighborhood of x* (~1e-4), not x* itself."""
    _, res = _run(hetero, 3000, exact_rounds=1000, k_frac=0.5)
    assert res.final_error < 1e-3, res.final_error


def test_error_feedback_required(hetero):
    """Without error feedback top-k FedCET stalls at a hard bias floor;
    with it, ~50x lower."""
    _, r_ef = _run(hetero, 3000, exact_rounds=1000, k_frac=0.5)
    _, r_no = _run(hetero, 3000, k_frac=0.5, error_feedback=False)
    assert r_ef.final_error < 1e-3
    assert r_no.final_error > 50 * r_ef.final_error


def test_topk_bf16_without_error_feedback_matches_jax(problem):
    """The legacy form's top-k + bf16 with error feedback off: the
    curve within 1e-12 of the reference's; bit-true accounting, 0.3 of
    the coordinates at bf16 values and int32 indices."""
    a, res = _run(problem, 400, k_frac=0.3, quantize=True,
                  error_feedback=False)
    assert np.all(np.isfinite(res.errors.numpy()))
    assert a.bits_per_coord == pytest.approx(0.3 * (16 + 32))
    assert a.up_frac == pytest.approx(0.3)


@pytest.mark.parametrize("spec", ["randk:0.25", "ef:topk:0.3+bf16",
                                  "shift:nat"])
def test_compressor_form_matches_jax(problem, spec):
    """The ``compressor=`` form over the rest of the grammar: curves
    within 1e-12 of the reference's."""
    _run(problem, 200, compressor=spec, seed=3)
