"""The port's asynchronous rounds (``core/staleness.py`` and the engine's
``with_delay``) against the JAX package's, on the CPU, in float64, on the
reference's own problem (``make_quadratic_problem(0)``, carried across as
numpy).

* Mirrors of ``tests/test_staleness.py``, each named in its docstring and
  held to that test's own bounds: identity delays are exact no-ops; the
  machinery with an always-fresh schedule is the synchronous run within
  1e-12 for FedCET, FedAvg, SCAFFOLD and FedLin; composition in either
  order; drop + always-fresh + sampling is sampling alone; the schedule
  is deterministic and restart-stable; a checkpoint restores the server
  buffer; FedCET stays exact at delay 2 under ``drop`` and ``last``,
  ``poly:1`` breaks it, SCAFFOLD's delta messages are not stale-safe; the
  uplink duty cycle; ``FedTrainer`` on a delayed scenario.
* Mirror of ``tests/test_baselines.py::test_fedprox_inherits_all_three_transforms``.
* Against the reference: delayed error curves within 1e-12 (``poly:1``
  within 1e-9 relative: its floor is a limit cycle that amplifies the
  ulps where XLA contracts ``a*b - c`` into an FMA), and a delayed
  run's checkpoint crosses the packages both ways.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

from repro_torch.checkpoint.ckpt import (_flatten, load_pytree, restore,
                                         save_pytree)
from repro_torch.core import FedAvg, FedCET, FedLin, FedProx, Scaffold
from repro_torch.core import max_weight_c
from repro_torch.core.comm import CommMeter, comm_bits_per_round
from repro_torch.core.engine import (EngineState, run_rounds,
                                     with_compression, with_delay,
                                     with_participation)
from repro_torch.core.lr_search import lr_search
from repro_torch.core.simulate import simulate_quadratic
from repro_torch.core.staleness import (DelayState, FixedDelay,
                                        GeometricDelay, RoundRobinStraggler,
                                        StalenessConfig, parse_delay,
                                        parse_policy)
from repro_torch.data.quadratic import QuadraticProblem
from repro_torch.utils.tree import tree_leaves, tree_map

TAU = 2
_TOL = dict(rtol=1e-12, atol=1e-12)
POLICIES = ("drop", "last", "poly:1")

PORT = types.SimpleNamespace(
    FedCET=FedCET, FedAvg=FedAvg, Scaffold=Scaffold, FedLin=FedLin,
    with_delay=with_delay, with_compression=with_compression,
    with_participation=with_participation)


def _jax():
    import jax

    jax.config.update("jax_enable_x64", True)
    return jax


@pytest.fixture(scope="module")
def problems():
    _jax()
    from repro.data.quadratic import make_quadratic_problem

    jp = make_quadratic_problem(0)
    return jp, QuadraticProblem(b=torch.tensor(np.asarray(jp.b)),
                                m=torch.tensor(np.asarray(jp.m)))


@pytest.fixture(scope="module")
def problem(problems):
    return problems[1]


def _sim(algo, problem, rounds):
    return simulate_quadratic(algo, problem, rounds, device="cpu")


def _fedcet(problem, pkg=PORT, tau=TAU):
    alpha = lr_search(problem.mu, problem.L, tau)
    return pkg.FedCET(alpha=alpha, c=max_weight_c(problem.mu, alpha),
                      tau=tau, n_clients=problem.n_clients)


def _all_algos(problem, pkg=PORT):
    n, L = problem.n_clients, problem.L
    return {
        "fedcet": _fedcet(problem, pkg),
        "fedavg": pkg.FedAvg(alpha=1.0 / (2 * TAU * L), tau=TAU, n_clients=n),
        "scaffold": pkg.Scaffold(alpha_l=1.0 / (81 * TAU * L), tau=TAU,
                                 n_clients=n),
        "fedlin": pkg.FedLin(alpha=1.0 / (18 * TAU * L), tau=TAU, n_clients=n,
                             k_frac=0.3),
    }


def _always_fresh(algo, policy):
    """The whole delay machinery (buffer, ages, weighted aggregation) with
    a schedule that never delays, past the factory's identity shortcut."""
    cfg = StalenessConfig(GeometricDelay(1.0), policy=parse_policy(policy))
    return dataclasses.replace(algo, delay=cfg)


# ------------------------------------------------------------ exact no-ops
def test_identity_delay_specs_are_exact_noops(problem):
    """Mirror of ``test_identity_delay_specs_are_exact_noops``."""
    for algo in _all_algos(problem).values():
        for spec in ("none", "off", "fixed:0", "rr:0", "geom:1", None,
                     FixedDelay(0), RoundRobinStraggler(0)):
            for pol in POLICIES:
                assert with_delay(algo, spec, policy=pol) is algo


def test_always_fresh_machinery_is_noop_every_algorithm(problem):
    """Mirror of ``test_always_fresh_machinery_is_noop_every_algorithm``:
    every policy reproduces the synchronous trajectory within 1e-12."""
    for name, algo in _all_algos(problem).items():
        ref = _sim(algo, problem, 12)
        for pol in POLICIES:
            res = _sim(_always_fresh(algo, pol), problem, 12)
            np.testing.assert_allclose(res.errors.numpy(), ref.errors.numpy(),
                                       **_TOL, err_msg=f"{name}/{pol}")


def test_parse_delay_grammar():
    """Mirror of ``test_parse_delay_grammar``."""
    assert parse_delay("fixed:2") == FixedDelay(2)
    assert parse_delay("rr:1") == RoundRobinStraggler(1)
    assert parse_delay("geom:0.5") == GeometricDelay(0.5)
    assert parse_delay("geom:1.0") is None
    assert parse_delay("") is None
    with pytest.raises(ValueError, match="unknown delay"):
        parse_delay("exp:3")
    with pytest.raises(ValueError, match="unknown stale policy"):
        parse_policy("oldest")


# ------------------------------------------------------------- composition
def test_delay_composes_with_transforms_in_either_order(problem):
    """Mirror of ``test_delay_composes_with_transforms_in_either_order``:
    the two factory orders build EQUAL specs, and the composed run
    converges (< 1e-9 at 1500 rounds)."""
    base = _fedcet(problem)
    a = with_delay(with_compression(base, compressor="randk:0.5"),
                   "rr:2", policy="last")
    b = with_compression(with_delay(base, "rr:2", policy="last"),
                         compressor="randk:0.5")
    assert a == b
    res = _sim(a, problem, 1500)
    assert res.final_error < 1e-9, res.final_error


def test_drop_with_sampling_matches_participation_alone(problem):
    """Mirror of ``test_drop_with_sampling_matches_participation_alone``:
    drop + always-fresh + sampling is trajectory-identical to sampling
    alone (1e-12)."""
    base = _fedcet(problem)
    ref = _sim(with_participation(base, 0.6, seed=7), problem, 40)
    res = _sim(_always_fresh(with_participation(base, 0.6, seed=7), "drop"),
               problem, 40)
    np.testing.assert_allclose(res.errors.numpy(), ref.errors.numpy(), **_TOL)


def test_stacked_delay_raises(problem):
    """Mirror of ``test_stacked_delay_raises``."""
    algo = with_delay(_fedcet(problem), "fixed:2")
    with pytest.raises(ValueError, match="already has a delay"):
        with_delay(algo, "rr:1")


# ------------------------------------------------------------- determinism
def test_delay_schedule_deterministic_across_runs(problem):
    """Mirror of ``test_delay_schedule_deterministic_across_runs``."""
    algo = with_delay(_fedcet(problem), "geom:0.5", policy="last", seed=11)
    r1 = _sim(algo, problem, 60)
    r2 = _sim(algo, problem, 60)
    assert torch.equal(r1.errors, r2.errors)


def test_fresh_mask_restart_stable():
    """Mirror of ``test_fresh_mask_restart_stable``; the masks are also
    the reference's, bit for bit."""
    _jax()
    import jax.numpy as jnp

    from repro.core import StalenessConfig as JConfig
    from repro.core import parse_policy as jparse
    from repro.core.staleness import GeometricDelay as JGeom

    cfg = StalenessConfig(GeometricDelay(0.4), policy=parse_policy("last"),
                          seed=5)
    jcfg = JConfig(JGeom(0.4), policy=jparse("last"), seed=5)
    assert torch.equal(cfg.fresh_mask(6, TAU, 8), cfg.fresh_mask(6, TAU, 8))
    masks = [cfg.fresh_mask(s, TAU, 8) for s in range(0, 40, TAU)]
    assert any(not torch.equal(masks[0], m) for m in masks[1:])
    for s, m in zip(range(0, 40, TAU), masks):
        assert np.array_equal(
            m.numpy(), np.asarray(jcfg.fresh_mask(jnp.asarray(s), TAU, 8)))


@pytest.mark.parametrize("spec", ["rr:2", "geom:0.5"])
def test_checkpoint_resume_reproduces_buffer(problem, spec, tmp_path):
    """Mirror of ``test_checkpoint_resume_reproduces_buffer``: the buffer
    rides in ``EngineState``, round-trips the npz checkpoint exactly (age
    as int32), and the resumed run continues bit for bit."""
    algo = with_delay(_fedcet(problem), spec, policy="last", seed=3)
    gf = torch.func.grad(problem.client_loss)
    batches = problem.stacked_batches(TAU)
    init_b = tree_map(lambda b: b[0], batches)
    state0 = algo.init(gf, torch.zeros(problem.dim, dtype=torch.float64),
                       init_b)
    assert isinstance(state0, EngineState)
    dstate = state0.extras[-1]
    assert isinstance(dstate, DelayState)
    assert dstate.age.dtype == torch.int32
    assert torch.equal(dstate.age, torch.zeros(problem.n_clients,
                                               dtype=torch.int32))
    full, _ = run_rounds(algo, gf, state0, batches, rounds=8)
    half, _ = run_rounds(algo, gf, state0, batches, rounds=4)
    path = str(tmp_path / "mid.npz")
    save_pytree(path, half)
    with np.load(path) as z:
        assert z[f"leaf_{len(_flatten(half)) - 1}"].dtype == np.int32
    back = load_pytree(path, half)
    for a, b in zip(tree_leaves(half), tree_leaves(back)):
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
    resumed, _ = run_rounds(algo, gf, back, batches, rounds=4)
    for a, b in zip(tree_leaves(full), tree_leaves(resumed)):
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b


# ------------------------------------------- measured convergence boundaries
def test_fedcet_exact_under_delay_drop_and_last(problem):
    """Mirror of ``test_fedcet_exact_under_delay_drop_and_last``: FedCET
    stays exact (< 1e-9 at 800 rounds) at delay 2 under drop and last."""
    base = _fedcet(problem)
    for spec in ("fixed:2", "rr:2"):
        for pol in ("drop", "last"):
            res = _sim(with_delay(base, spec, policy=pol), problem, 800)
            assert res.final_error < 1e-9, (spec, pol, res.final_error)


def test_poly_discount_breaks_fedcet_exactness(problem):
    """Mirror of ``test_poly_discount_breaks_fedcet_exactness``: poly:1
    under rr:2 floors between 1e-4 and 1, and the drift invariant
    measurably drifts."""
    algo = with_delay(_fedcet(problem), "rr:2", policy="poly:1")
    res = _sim(algo, problem, 800)
    assert 1e-4 < res.final_error < 1.0, res.final_error
    d_mean = float(torch.linalg.norm(torch.mean(res.state.inner.d, dim=0)))
    assert d_mean > 1e-6, d_mean


def test_fedcet_drift_invariant_survives_uniform_staleness(problem):
    """Mirror of ``test_fedcet_drift_invariant_survives_uniform_staleness``:
    ``sum_i d_i = 0`` within 1e-10 under drop and last."""
    base = _fedcet(problem)
    for pol in ("drop", "last"):
        res = _sim(with_delay(base, "rr:2", policy=pol), problem, 60)
        d_mean = torch.mean(res.state.inner.d, dim=0).numpy()
        np.testing.assert_allclose(d_mean, 0.0, atol=1e-10, err_msg=pol)


def test_scaffold_delta_messages_not_stale_safe(problem):
    """Mirror of ``test_scaffold_delta_messages_not_stale_safe``: SCAFFOLD
    under rr:2 breaks with last (> 1e-1) and converges with drop
    (< 1e-2) at 800 rounds."""
    scaffold = _all_algos(problem)["scaffold"]
    res_last = _sim(with_delay(scaffold, "rr:2", policy="last"), problem, 800)
    assert res_last.final_error > 1e-1, res_last.final_error
    res_drop = _sim(with_delay(scaffold, "rr:2", policy="drop"), problem, 800)
    assert res_drop.final_error < 1e-2, res_drop.final_error


# -------------------------------------------------------- comm duty account
def test_comm_meter_delay_duty(problem):
    """Mirror of ``test_comm_meter_delay_duty``: buffered rounds transmit
    zero uplink bits (fixed:2 -> 1/3, rr:2 -> (N-2)/N, geom:p -> p); the
    downlink stays dense; the duty composes with compression."""
    n = problem.n_clients
    base = _fedcet(problem)
    assert base.transmit_frac == 1.0
    assert with_delay(base, "fixed:2").transmit_frac == pytest.approx(1 / 3)
    assert with_delay(base, "rr:2").transmit_frac == pytest.approx((n - 2) / n)
    assert with_delay(base, "geom:0.25").transmit_frac == pytest.approx(0.25)

    params = {"w": torch.zeros(problem.dim)}
    sync = CommMeter.for_params(params, algo=base, n_clients=n)
    dly = CommMeter.for_params(params, algo=with_delay(base, "fixed:2"),
                               n_clients=n)
    sync.tick_round(base)
    dly.tick_round(base)
    assert abs(dly.bytes_up * 3 - sync.bytes_up) <= 3
    assert dly.bytes_down == sync.bytes_down

    bits = comm_bits_per_round(with_delay(base, "fixed:2"), problem.dim,
                               n_clients=n)
    bits_sync = comm_bits_per_round(base, problem.dim, n_clients=n)
    assert bits["up_bits"] * 3 == pytest.approx(bits_sync["up_bits"])
    assert bits["down_bits"] == bits_sync["down_bits"]
    comp = with_delay(with_compression(base, compressor="shift:q8"), "fixed:2")
    assert comp.bits_per_coord == 8.0
    cbits = comm_bits_per_round(comp, problem.dim, n_clients=n)
    assert cbits["up_bits"] == pytest.approx(bits_sync["up_bits"] / 4 / 3)


# -------------------------------------------------------------- integration
def test_fed_trainer_runs_delayed_scenario(problem, tmp_path):
    """Mirror of ``test_fed_trainer_runs_delayed_scenario``: FedTrainer
    end to end with a delayed, compressed, sampled FedCET (float64 draws,
    the reference's under x64): finite losses, the duty-cycled meter to
    the byte, and a resume that restores the buffer-bearing state."""
    from repro_torch.fed import FedTrainer, TrainerConfig

    algo = with_delay(
        with_compression(with_participation(_fedcet(problem), 0.8, seed=3),
                         compressor="randk:0.5"),
        "rr:2", policy="last")
    tc = TrainerConfig(rounds=6, eval_every=3, ckpt_every=3,
                       ckpt_dir=str(tmp_path / "ck"))
    trainer = FedTrainer(algo, problem.client_loss, tc, device="cpu")
    batches_for = lambda r: problem.stacked_batches(TAU)  # noqa: E731
    state = trainer.init_state(
        torch.zeros(problem.dim, dtype=torch.float64),
        tree_map(lambda b: b[0], batches_for(0)))
    state = trainer.fit(state, batches_for)
    assert trainer.history and all(
        np.isfinite(h["loss_global"]) for h in trainer.history)
    n, dim, rounds = problem.n_clients, problem.dim, 6
    duty = 0.8 * (n - 2) / n
    per_round_up = int(dim * n * 16 * duty / 8)
    per_round_down = int(dim * n * 32 * 0.8 / 8)
    assert algo.transmit_frac == pytest.approx(duty)
    assert trainer.history[-1]["comm_bytes"] \
        == rounds * (per_round_up + per_round_down)
    restored, start = trainer.maybe_resume(state)
    assert start == 6
    assert isinstance(restored, EngineState)
    assert isinstance(restored.extras[-1], DelayState)


def test_fedprox_inherits_all_three_transforms(problem):
    """Mirror of ``tests/test_baselines.py::test_fedprox_inherits_all_three_transforms``:
    FedProx under ``shift:q8`` x 0.8 participation x ``rr:2`` / last
    converges exactly (< 1e-9 at 2000 rounds)."""
    base = FedProx(alpha=1.0 / (2 * 2 * problem.L), mu_prox=0.5, tau=2,
                   n_clients=problem.n_clients)
    algo = with_delay(
        with_compression(with_participation(base, 0.8, seed=3),
                         compressor="shift:q8"),
        "rr:2", policy="last")
    res = _sim(algo, problem, 2000)
    assert res.final_error < 1e-9, res.final_error


# ------------------------------------------------ against the reference
CURVES = {
    "fedcet_rr2_last_shift_q8": ("fedcet", "rr:2", "last", "shift:q8"),
    "fedcet_geom_drop_randk": ("fedcet", "geom:0.5", "drop", "randk:0.5"),
    "fedcet_rr2_poly1": ("fedcet", "rr:2", "poly:1", None),
    "scaffold_rr2_last": ("scaffold", "rr:2", "last", None),
    "fedavg_fixed2_drop_p0.8": ("fedavg", "fixed:2", "drop", "p0.8"),
    "fedlin_rr2_drop": ("fedlin", "rr:2", "drop", None),
}


def _scenario(pkg, problem, name, delay, pol, extra):
    algo = _all_algos(problem, pkg)[name]
    if extra == "p0.8":
        algo = pkg.with_participation(algo, 0.8, seed=3)
    elif extra is not None:
        algo = pkg.with_compression(algo, compressor=extra, seed=5)
    return pkg.with_delay(algo, delay, policy=pol, seed=7)


@pytest.mark.parametrize("case", sorted(CURVES))
def test_delayed_curves_match_the_reference(problems, case):
    """200 rounds of each scenario in both packages: e(k) within 1e-12
    (``poly:1`` within 1e-9 relative), and the final buffer ages equal."""
    import repro.core as J
    from repro.core.simulate import simulate_quadratic as jsim

    jp, port = problems
    name, delay, pol, extra = CURVES[case]
    got = _sim(_scenario(PORT, port, name, delay, pol, extra), port, 200)
    want = jsim(_scenario(J, jp, name, delay, pol, extra), jp, rounds=200)
    tol = (dict(rtol=1e-9, atol=0) if pol == "poly:1" else _TOL)
    np.testing.assert_allclose(got.errors.numpy(), np.asarray(want.errors),
                               **tol)
    assert np.array_equal(got.state.extras[-1].age.numpy(),
                          np.asarray(want.state.extras[-1].age))


def test_delayed_checkpoint_crosses_the_packages(problems, tmp_path):
    """A reference-written ``shift:q8`` x ``rr:2`` / last state (the
    ``DelayState(buf, age)`` in its last slot) restores in the port, and
    30 more rounds match the reference's own continuation within 1e-12;
    a port-written one loads in the reference's ``load_pytree`` bitwise,
    ``age`` as int32 in the reference's slot."""
    jax = _jax()
    import jax.numpy as jnp

    import repro.core as J
    from repro.checkpoint.ckpt import load_pytree as jload
    from repro.checkpoint.ckpt import save as jsave

    jp, port = problems
    jalgo = _scenario(J, jp, "fedcet", "rr:2", "last", "shift:q8")
    algo = _scenario(PORT, port, "fedcet", "rr:2", "last", "shift:q8")
    jgrad = jax.grad(jp.client_loss)
    jb = jp.stacked_batches(TAU)
    js0 = jalgo.init(jgrad, jnp.zeros(jp.dim),
                     jax.tree.map(lambda b: b[0], jb))
    js, _ = J.run_rounds(jalgo, jgrad, js0, jb, rounds=20)
    jsave(str(tmp_path / "ref"), 20, js)
    jerr = lambda s: jnp.linalg.norm(  # noqa: E731
        jalgo.global_params(s) - jp.x_star)
    js_end, jcurve = J.run_rounds(jalgo, jgrad, js, jb, rounds=30,
                                  metric_fn=jerr)

    grad = torch.func.grad(port.client_loss)
    batches = port.stacked_batches(TAU)
    like = algo.init(grad, torch.zeros(port.dim, dtype=torch.float64),
                     tree_map(lambda b: b[0], batches))
    state, step = restore(str(tmp_path / "ref"), like)
    assert step == 20 and state.inner.t == 40
    assert isinstance(state.extras[-1], DelayState)
    assert state.extras[-1].age.dtype == torch.int32
    x_star = port.x_star
    end, curve = run_rounds(algo, grad, state, batches, rounds=30,
                            metric_fn=lambda s: torch.linalg.norm(
                                algo.global_params(s) - x_star))
    np.testing.assert_allclose(curve.numpy(), np.asarray(jcurve), **_TOL)
    for got, want in zip(_flatten(end), jax.tree.leaves(js_end)):
        if isinstance(got, int):
            assert got == int(want)
        else:
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       **_TOL)

    path = str(tmp_path / "port.npz")
    save_pytree(path, end)
    back = jload(path, js0)
    assert type(back.extras[-1]).__name__ == "DelayState"
    assert np.asarray(back.extras[-1].age).dtype == np.int32
    for got, want in zip(jax.tree.leaves(back), _flatten(end)):
        if isinstance(want, int):
            assert int(got) == want
        else:
            assert np.array_equal(np.asarray(got), want.numpy())


def test_fused_tail_is_skipped_under_a_delay(problems, monkeypatch):
    """``shift:q8`` on the arena under ``rr:2`` / last: the fused round tail
    would aggregate the fresh messages and ignore the buffer, so the
    engine takes the generic seam (the reference's guard, ``dstate is None
    and self.delay is None``), and the run matches the reference's within
    1e-12. The same stack without the delay does take the tail."""
    import repro.core as J
    from repro.core.simulate import simulate_quadratic as jsim

    from repro_torch.core.engine import with_arena
    from repro_torch.kernels import ops

    calls = []
    real = ops.fedcet_round_tail
    monkeypatch.setattr(ops, "fedcet_round_tail",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    jp, port = problems

    def stack(pkg, arena, delay=True):
        algo = pkg.with_compression(_fedcet(port, pkg), compressor="shift:q8")
        algo = arena(algo)
        return pkg.with_delay(algo, "rr:2", policy="last") if delay else algo

    got = _sim(stack(PORT, with_arena), port, 60)
    assert calls == []
    want = jsim(stack(J, J.with_arena), jp, rounds=60)
    np.testing.assert_allclose(got.errors.numpy(), np.asarray(want.errors),
                               **_TOL)
    _sim(stack(PORT, with_arena, delay=False), port, 2)
    assert len(calls) == 3  # init and two rounds
