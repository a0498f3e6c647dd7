"""The port's Fig. 1 baselines against the JAX package's, on the CPU in
float64, on the reference's quadratic problems passed in as numpy
(``make_quadratic_problem(0)``, ``make_hetero_hessian_problem(11)``).

* The per-round error curves of ``paper_fig1_algorithms`` (FedCET,
  FedTrack, SCAFFOLD, FedAvg), FedProx, FedDyn, FedLin at ``k_frac=0.25``,
  SCAFFOLD under ``shift:q8`` (its two-leaf message keys the dither by
  JAX's leaf order), FedDyn under ``shift:q8`` and FedDyn at 0.8
  participation (the mask keyed by a counter that advances by tau) agree
  with the reference's at every round within 1e-12. (FedDyn under both
  at once agrees within 1e-12 up to round 268; at round 269 one
  quantizer code lands one step apart, where ``(v - h)/s + u`` sits
  within rounding of an integer and XLA's contracted ``a*b - c`` rounds
  it the other way: 3.8e-10 at an error of 8e-7. Its convergence is held
  in ``tests/test_torch_baselines_exact.py``.)
* ``topk_sparsify`` equals the reference's on inputs with ties.
* The short mirrors of ``tests/test_baselines.py``: FedAvg's drift floor,
  the Fig. 1 ordering and bytes, error-vs-bytes dominance, FedProx at
  ``mu = 0`` is FedAvg. The long ones are in
  ``tests/test_torch_baselines_exact.py``.
* Telemetry on equals telemetry off at exactly 0.0 for FedAvg and
  SCAFFOLD, bare and on ``hier:g4`` with ``shift:q8`` (the port's own
  property, as the reference's
  ``test_disabled_vs_enabled_is_bitwise_identical`` cases state it).
"""

import numpy as np
import pytest
import torch

from repro_torch.configs.base import FedScenario
from repro_torch.core import (FedAvg, FedDyn, FedLin, FedProx, Scaffold,
                              topk_sparsify)
from repro_torch.core.engine import with_compression, with_participation
from repro_torch.core.simulate import paper_fig1_algorithms, simulate_quadratic
from repro_torch.data.quadratic import QuadraticProblem
from repro_torch.utils.tree import tree_leaves

ROUNDS = 300


def _jax():
    import jax

    jax.config.update("jax_enable_x64", True)
    return jax


def _pair(jp):
    return jp, QuadraticProblem(b=torch.tensor(np.asarray(jp.b)),
                                m=torch.tensor(np.asarray(jp.m)))


@pytest.fixture(scope="module")
def problems():
    _jax()
    from repro.data.quadratic import (make_hetero_hessian_problem,
                                      make_quadratic_problem)

    return {"paper": _pair(make_quadratic_problem(0)),
            "hetero": _pair(make_hetero_hessian_problem(11))}


@pytest.fixture(scope="module")
def fig1(problems):
    """400 rounds of the port's four Fig. 1 algorithms, run once."""
    port = problems["paper"][1]
    return {k: simulate_quadratic(a, port, 400, device="cpu")
            for k, a in paper_fig1_algorithms(port, tau=2).items()}


def _jsim(algo, jp, rounds=ROUNDS):
    from repro.core.simulate import simulate_quadratic as jsim

    return np.asarray(jsim(algo, jp, rounds=rounds).errors)


@pytest.mark.parametrize("name", ["fedcet", "fedtrack", "scaffold", "fedavg"])
def test_fig1_curves_match_jax(problems, fig1, name):
    from repro.core.simulate import paper_fig1_algorithms as jfig1

    jp, port = problems["paper"]
    jalgo = jfig1(jp, tau=2)[name]
    algo = paper_fig1_algorithms(port, tau=2)[name]
    for f in ("alpha", "alpha_l", "alpha_g", "c", "tau", "n_clients"):
        assert getattr(algo, f, None) == getattr(jalgo, f, None), f
    got = fig1[name].errors.numpy()[:ROUNDS + 1]
    assert got.dtype == np.float64
    np.testing.assert_allclose(got, _jsim(jalgo, jp), rtol=0, atol=1e-12)


def _fedprox(pkg, p):
    return pkg.FedProx(alpha=1.0 / (2 * 2 * p.L), mu_prox=0.5, tau=2,
                       n_clients=p.n_clients)


def _feddyn(pkg, p, a_dyn=1.0, tau=2):
    return pkg.FedDyn(alpha=1.0 / (2 * tau * (p.L + a_dyn)), a_dyn=a_dyn,
                      tau=tau, n_clients=p.n_clients)


def _fedlin(pkg, p):
    return pkg.FedLin(alpha=1.0 / (18 * 2 * p.L), tau=2,
                      n_clients=p.n_clients, k_frac=0.25)


def _scaffold_q8(pkg, p):
    return pkg.with_compression(
        pkg.Scaffold(alpha_l=1.0 / (81 * 2 * p.L), tau=2,
                     n_clients=p.n_clients), compressor="shift:q8")


def _feddyn_q8(pkg, p):
    return pkg.with_compression(_feddyn(pkg, p), compressor="shift:q8")


def _feddyn_p08(pkg, p):
    return pkg.with_participation(_feddyn(pkg, p), 0.8, seed=3)


class _Port:
    """The port's names beside ``repro.core``'s, for the helpers above."""

    FedAvg, FedProx, FedDyn, FedLin = FedAvg, FedProx, FedDyn, FedLin
    Scaffold = Scaffold
    with_compression = staticmethod(with_compression)
    with_participation = staticmethod(with_participation)


@pytest.mark.parametrize("make,which", [
    (_fedprox, "paper"), (_feddyn, "hetero"), (_fedlin, "paper"),
    (_scaffold_q8, "paper"), (_feddyn_q8, "hetero"),
    (_feddyn_p08, "hetero")],
    ids=["fedprox", "feddyn", "fedlin_k0.25", "scaffold_shift_q8",
         "feddyn_shift_q8", "feddyn_p0.8"])
def test_more_baseline_curves_match_jax(problems, make, which):
    import repro.core as jcore

    jp, port = problems[which]
    got = simulate_quadratic(make(_Port, port), port, ROUNDS,
                             device="cpu").errors.numpy()
    np.testing.assert_allclose(got, _jsim(make(jcore, jp), jp), rtol=0,
                               atol=1e-12)


@pytest.mark.parametrize("k_frac", [0.1, 0.25, 0.3, 0.5, 0.01])
def test_topk_sparsify_matches_jax_with_ties(k_frac):
    import jax.numpy as jnp

    from repro.core.comm import topk_sparsify as jtopk

    _jax()
    rng = np.random.default_rng(7)
    # magnitudes drawn from few values, both signs: many ties, also at
    # the threshold itself.
    a = (rng.integers(0, 6, size=(4, 37)) * rng.choice([-1.0, 1.0],
                                                       size=(4, 37)))
    want = np.asarray(jtopk(jnp.asarray(a), k_frac))
    got = topk_sparsify(torch.tensor(a), k_frac).numpy()
    np.testing.assert_array_equal(got, want)
    k = max(1, round(k_frac * a.size))
    assert np.count_nonzero(np.abs(got) >= np.sort(np.abs(a).ravel())[-k]) \
        >= k
    assert topk_sparsify(torch.tensor(a), 1.0) is not None


# ------------------------------------------- mirrors of test_baselines.py
def test_fedavg_drifts_under_heterogeneity(problems):
    """Constant-lr FedAvg stalls at a nonzero error floor under client
    drift (heterogeneous Hessians; with M_i = I periodic averaging of
    quadratics is exact)."""
    problem = problems["hetero"][1]
    algo = FedAvg(alpha=1.0 / (2 * 2 * problem.L), tau=2,
                  n_clients=problem.n_clients)
    errs = simulate_quadratic(algo, problem, rounds=800,
                              device="cpu").errors.numpy()
    floor = errs[-1]
    assert floor > 1e-4, f"expected drift floor, got {floor}"
    # it plateaus: the last 100 rounds move by < 1% relative.
    assert abs(errs[-1] - errs[-100]) < 0.01 * floor + 1e-12


def test_fig1_ordering(fig1):
    """At equal round counts FedCET's error is below FedTrack's, which is
    below SCAFFOLD's, with FedCET moving half the bytes per round."""
    e = {k: float(r.errors[300]) for k, r in fig1.items()}
    assert e["fedcet"] < e["fedtrack"] < e["scaffold"], e
    assert fig1["fedcet"].bytes_per_round * 2 \
        == fig1["fedtrack"].bytes_per_round
    assert fig1["fedcet"].bytes_per_round * 2 \
        == fig1["scaffold"].bytes_per_round


def test_error_vs_bytes_dominance(fig1):
    """At any transmitted-byte budget in the sampled range, FedCET's error
    is no worse than SCAFFOLD's or FedTrack's."""
    for budget_rounds in (50, 100, 200):
        bytes_budget = fig1["fedcet"].bytes_per_round * budget_rounds
        e_fedcet = float(fig1["fedcet"].errors[budget_rounds])
        for other in ("fedtrack", "scaffold"):
            k = bytes_budget // fig1[other].bytes_per_round
            e_other = float(fig1[other].errors[k])
            assert e_fedcet <= e_other, (budget_rounds, other, e_fedcet,
                                         e_other)


def test_fedprox_mu0_is_fedavg(problems):
    problem = problems["paper"][1]
    alpha = 1.0 / (2 * 2 * problem.L)
    avg = FedAvg(alpha=alpha, tau=2, n_clients=problem.n_clients)
    prox = FedProx(alpha=alpha, mu_prox=0.0, tau=2,
                   n_clients=problem.n_clients)
    r_avg = simulate_quadratic(avg, problem, rounds=100, device="cpu")
    r_prox = simulate_quadratic(prox, problem, rounds=100, device="cpu")
    np.testing.assert_allclose(r_prox.errors.numpy(), r_avg.errors.numpy(),
                               rtol=1e-12, atol=1e-12)


# ------------------------------------------------ telemetry on == off
def _tel_algo(name, problem, tau=2):
    L, n = problem.L, problem.n_clients
    return {"fedavg": lambda: FedAvg(alpha=1.0 / (2 * tau * L), tau=tau,
                                     n_clients=n),
            "scaffold": lambda: Scaffold(alpha_l=1.0 / (81 * tau * L),
                                         tau=tau, n_clients=n)}[name]()


TEL_SCENARIOS = {"bare": {},
                 "hier": dict(compression="shift:q8", topology="hier:g4")}


@pytest.mark.parametrize("algo_name", ["fedavg", "scaffold"])
@pytest.mark.parametrize("scenario", sorted(TEL_SCENARIOS))
def test_telemetry_on_equals_off(algo_name, scenario):
    _jax()
    from repro.data.quadratic import make_quadratic_problem as jmake

    problem = _pair(jmake(0, n_clients=8, dim=24))[1]
    kw = TEL_SCENARIOS[scenario]
    off = FedScenario(telemetry=False, **kw).apply(
        _tel_algo(algo_name, problem))
    on = FedScenario(telemetry=True, **kw).apply(
        _tel_algo(algo_name, problem))
    assert on.telemetry is not None and off.telemetry is None
    res_off = simulate_quadratic(off, problem, rounds=8, device="cpu")
    res_on = simulate_quadratic(on, problem, rounds=8, device="cpu")
    assert res_off.telemetry is None
    assert len(res_on.telemetry["consensus_err"]) == 8
    for a, b in zip(tree_leaves(res_off.state), tree_leaves(res_on.state)):
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and float((a - b).abs().max()) == 0.0
        else:
            assert a == b
    assert float((res_off.errors - res_on.errors).abs().max()) == 0.0


@pytest.mark.parametrize("name", ["fedavg", "scaffold", "fedlin", "fedprox",
                                  "feddyn"])
def test_reference_states_cross_through_numpy(problems, name):
    """``models/convert.py:state_from_numpy`` carries a reference state of
    every baseline across mid-run: 20 more rounds in the port equal the
    reference's own continuation within 1e-12, the counter included."""
    jax = _jax()
    import jax.numpy as jnp

    import repro.core as J
    from repro.core.engine import run_rounds as jrun

    from repro_torch.core.engine import run_rounds
    from repro_torch.models.convert import state_from_numpy

    which = "hetero" if name == "feddyn" else "paper"
    jp, port = problems[which]
    make = {"fedavg": lambda m, p: m.FedAvg(alpha=1 / (4 * p.L), tau=2,
                                            n_clients=p.n_clients),
            "scaffold": lambda m, p: m.Scaffold(alpha_l=1 / (162 * p.L),
                                                tau=2, n_clients=p.n_clients),
            "fedlin": _fedlin, "fedprox": _fedprox, "feddyn": _feddyn}[name]
    jalgo, algo = make(J, jp), make(_Port, port)
    jgrad = jax.grad(jp.client_loss)
    jb = jp.stacked_batches(2)
    js = jalgo.init(jgrad, jnp.zeros(jp.dim), jax.tree.map(lambda b: b[0], jb))
    js, _ = jrun(jalgo, jgrad, js, jb, rounds=10)
    state = state_from_numpy(jax.tree.map(np.asarray, js))
    assert type(state).__name__ == type(js).__name__ and state.t == 20
    js, _ = jrun(jalgo, jgrad, js, jb, rounds=20)
    state, _ = run_rounds(algo, torch.func.grad(port.client_loss), state,
                          port.stacked_batches(2), rounds=20)
    assert state.t == int(js.t) == 60
    for f in state._fields[:-1]:
        np.testing.assert_allclose(getattr(state, f).numpy(),
                                   np.asarray(getattr(js, f)), rtol=0,
                                   atol=1e-12)
