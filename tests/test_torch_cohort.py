"""The port's O(cohort) rounds (``with_cohort``, ``CohortSpec``,
``Topology.reduce_cohort``) against the JAX package's, on the CPU, in
float64, on the reference's own problem (``make_hetero_hessian_problem(0,
n_clients=24, dim=12, n_measurements=4)``, carried across as numpy).

* Mirrors of ``tests/test_cohort.py``, each named in its docstring: the
  gather lowering equals the dense one within 1e-12 (bare, composed with
  ``shift:q8`` x 0.8 participation x ``fixed:2``, under ``drop``, over a
  hierarchy with ``shift:q8`` tiers, for every selector); ``rr`` covers
  the population; checkpoint and resume mid-sweep is exact; the factory's
  identity cases and refusals; the spec grammar; ``FedScenario`` applies
  the cohort last; the cohort path converges.
* ``benchmarks/cohort_scaling.py``'s exactness check: at N 1000, cohort
  256, ``block``, dim 8, the two lowerings agree within 1e-12 after 4
  rounds for FedCET, FedAvg, SCAFFOLD and FedTrack.
* Against the reference: the gather lowering's final state within 1e-12
  of the reference's, bare and composed, for each algorithm; the
  selectors draw the reference's ids.
* The store is written in place: the same ``data_ptr()`` after a round,
  and the rows outside the cohort bitwise unchanged.
* The float32 LM cohort round's rows equal a plain engine's on the
  cohort's rows and tokens (``chip_smoke.py``'s path K, reduced).
"""

import types

import numpy as np
import pytest
import torch

from repro_torch.checkpoint.ckpt import load_pytree, save_pytree
from repro_torch.configs.base import FedScenario
from repro_torch.core import FedAvg, FedCET, FedLin, FedTrack, Scaffold
from repro_torch.core.engine import (CohortSpec, parse_cohort, run_rounds,
                                     with_cohort, with_compression,
                                     with_delay, with_participation,
                                     with_topology)
from repro_torch.data.quadratic import QuadraticProblem
from repro_torch.utils.tree import tree_leaves, tree_map

N, M, TAU, ROUNDS = 24, 7, 2, 6
TOL = 1e-12

PORT = types.SimpleNamespace(
    FedCET=FedCET, FedAvg=FedAvg, Scaffold=Scaffold, FedTrack=FedTrack,
    with_cohort=with_cohort, with_compression=with_compression,
    with_delay=with_delay, with_participation=with_participation,
    CohortSpec=CohortSpec)


def _jax():
    import jax

    jax.config.update("jax_enable_x64", True)
    return jax


def _reference_problem(**kw):
    _jax()
    from repro.data.quadratic import make_hetero_hessian_problem

    return make_hetero_hessian_problem(0, **kw)


JP = _reference_problem(n_clients=N, dim=12, n_measurements=4)
PROB = QuadraticProblem(b=torch.tensor(np.asarray(JP.b)),
                        m=torch.tensor(np.asarray(JP.m)))
GRAD = torch.func.grad(PROB.client_loss)
BATCHES = PROB.stacked_batches(TAU)
FIRST = tree_map(lambda b: b[0], BATCHES)


def _algos(pkg=PORT, n=N):
    return {
        "fedcet": pkg.FedCET(alpha=0.02, c=0.3, tau=TAU, n_clients=n),
        "fedavg": pkg.FedAvg(alpha=0.05, tau=TAU, n_clients=n),
        "scaffold": pkg.Scaffold(alpha_l=0.02, tau=TAU, n_clients=n),
        "fedlin": pkg.FedTrack(alpha=0.02, tau=TAU, n_clients=n),
    }


def _run(algo, rounds=ROUNDS, state=None, prob=PROB):
    grad = GRAD if prob is PROB else torch.func.grad(prob.client_loss)
    batches = prob.stacked_batches(TAU)
    if state is None:
        state = algo.init(grad, torch.zeros(prob.dim, dtype=torch.float64),
                          tree_map(lambda b: b[0], batches))
    final, _ = run_rounds(algo, grad, state, batches, rounds=rounds)
    return final


def _tensors(tree):
    return [a for a in tree_leaves(tree) if isinstance(a, torch.Tensor)]


def _assert_close(a, b, tol=TOL):
    la, lb = _tensors(a), _tensors(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert float(torch.max(torch.abs(x - y))) <= tol


def _composed(algo, pkg=PORT):
    """``shift:q8`` x 0.8 participation x ``fixed:2`` / last (composed
    first; the cohort wraps the whole spec)."""
    algo = pkg.with_participation(algo, 0.8, seed=3)
    algo = pkg.with_compression(algo, compressor="shift:q8", seed=5)
    return pkg.with_delay(algo, "fixed:2", policy="last", seed=7)


def _lowerings(algo, **spec):
    return [with_cohort(algo, CohortSpec(size=M, lowering=lo, **spec))
            for lo in ("gather", "dense")]


# ------------------------------------------------- gather == dense lowering
@pytest.mark.parametrize("name", list(_algos()))
def test_cohort_lowerings_agree_bare(name):
    """Mirror of ``test_cohort_lowerings_agree_bare``."""
    g, d = _lowerings(_algos()[name])
    _assert_close(_run(g), _run(d))


@pytest.mark.parametrize("name", list(_algos()))
def test_cohort_lowerings_agree_composed(name):
    """Mirror of ``test_cohort_lowerings_agree_composed``."""
    g, d = _lowerings(_composed(_algos()[name]))
    _assert_close(_run(g), _run(d))


def test_cohort_lowerings_agree_drop_policy():
    """Mirror of ``test_cohort_lowerings_agree_drop_policy``: the drop
    continuation step runs on cohort rows in both lowerings."""
    g, d = _lowerings(with_delay(FedCET(alpha=0.02, c=0.3, tau=TAU,
                                        n_clients=N), "rr:2", policy="drop"))
    _assert_close(_run(g), _run(d))


def test_cohort_lowerings_agree_hierarchical_tier_compression():
    """Mirror of ``test_cohort_lowerings_agree_hierarchical_tier_compression``:
    first-tier ids are the population's, gathered at the cohort's ids, so
    the ``[g, ...]`` tier memory advances identically."""
    g, d = _lowerings(with_topology(
        FedCET(alpha=0.02, c=0.3, tau=TAU, n_clients=N), "hier:g4",
        tier_compression="shift:q8"))
    _assert_close(_run(g), _run(d))


@pytest.mark.parametrize("selector", ["block", "rr", "uniform"])
def test_cohort_selectors_lowering_invariant(selector):
    """Mirror of ``test_cohort_selectors_lowering_invariant``."""
    g, d = _lowerings(FedCET(alpha=0.02, c=0.3, tau=TAU, n_clients=N),
                      selector=selector)
    _assert_close(_run(g), _run(d))


def test_rr_selector_covers_population():
    """Mirror of ``test_rr_selector_covers_population``."""
    spec = CohortSpec(size=M, selector="rr")
    seen = set()
    for r in range(-(-N // M)):
        seen.update(spec.indices(r * TAU, TAU, N).tolist())
    assert seen == set(range(N))


# ------------------------------------------------------- checkpoint/resume
def test_cohort_checkpoint_resume_mid_sweep(tmp_path):
    """Mirror of ``test_cohort_checkpoint_resume_mid_sweep``: 4 + 4 rounds
    through a checkpoint equal 8 straight, bit for bit."""
    algo = with_cohort(_composed(FedCET(alpha=0.02, c=0.3, tau=TAU,
                                        n_clients=N)), M)
    straight = _run(algo, rounds=8)
    mid = _run(algo, rounds=4)
    path = str(tmp_path / "ckpt.npz")
    save_pytree(path, mid)
    resumed = _run(algo, rounds=4, state=load_pytree(path, mid))
    _assert_close(straight, resumed, tol=0.0)


# ----------------------------------------------------- factory + validation
def test_with_cohort_identity_cases():
    """Mirror of ``test_with_cohort_identity_cases``."""
    algo = FedCET(alpha=0.02, c=0.3, tau=TAU, n_clients=N)
    for spec in (None, "none", "off", "full", 0, "0", "", N, str(N)):
        assert with_cohort(algo, spec) is algo
    with pytest.raises(ValueError):
        with_cohort(algo, N + 1)


def test_with_cohort_rejects_stacking():
    """Mirror of ``test_with_cohort_rejects_stacking``."""
    algo = with_cohort(FedCET(alpha=0.02, c=0.3, tau=TAU, n_clients=N), M)
    with pytest.raises(ValueError):
        with_cohort(algo, M)


def test_with_cohort_rejects_mixing_both_orders():
    """Mirror of ``test_with_cohort_rejects_mixing_both_orders``."""
    algo = FedCET(alpha=0.02, c=0.3, tau=TAU, n_clients=N)
    with pytest.raises(ValueError):
        with_cohort(with_topology(algo, "ring"), M)
    with pytest.raises(ValueError):
        with_topology(with_cohort(algo, M), "ring")


def test_with_cohort_rejects_fedlin_cross_client_topk():
    """Mirror of ``test_with_cohort_rejects_fedlin_cross_client_topk``."""
    with pytest.raises(ValueError):
        with_cohort(FedLin(alpha=0.02, tau=TAU, n_clients=N, k_frac=0.3), M)
    assert with_cohort(FedTrack(alpha=0.02, tau=TAU, n_clients=N),
                       M).cohort is not None


def test_parse_cohort_grammar():
    """Mirror of ``test_parse_cohort_grammar``."""
    assert parse_cohort(None) is None
    assert parse_cohort("none") is None
    assert parse_cohort(256) == CohortSpec(size=256)
    assert parse_cohort("256") == CohortSpec(size=256)
    assert parse_cohort("block:256") == CohortSpec(size=256, selector="block")
    assert parse_cohort("rr:64:dense") == CohortSpec(
        size=64, selector="rr", lowering="dense")
    assert parse_cohort("1024:dense") == CohortSpec(size=1024,
                                                    lowering="dense")
    for bad in ("block", "block:", "nope:8", "8:nope", "block:8:gather:x"):
        with pytest.raises(ValueError):
            parse_cohort(bad)


def test_cohort_spec_validation():
    """Mirror of ``test_cohort_spec_validation``."""
    with pytest.raises(ValueError):
        CohortSpec(size=0)
    with pytest.raises(ValueError):
        CohortSpec(size=4, selector="nope")
    with pytest.raises(ValueError):
        CohortSpec(size=4, lowering="nope")


def test_cohort_scenario_applies_last():
    """Mirror of ``test_cohort_scenario_applies_last``: FedScenario's
    cohort wraps the fully composed spec, bit for bit."""
    sc = FedScenario(compression="shift:q8", participation=0.8,
                     delay="fixed:2", cohort=f"block:{M}", seed=3)
    algo = sc.apply(FedCET(alpha=0.02, c=0.3, tau=TAU, n_clients=N))
    assert algo.cohort == CohortSpec(size=M, selector="block", seed=3)
    ref = with_cohort(
        FedScenario(compression="shift:q8", participation=0.8,
                    delay="fixed:2", seed=3).apply(
            FedCET(alpha=0.02, c=0.3, tau=TAU, n_clients=N)),
        CohortSpec(size=M, selector="block", seed=3))
    _assert_close(_run(algo), _run(ref), tol=0.0)


def test_cohort_converges_on_quadratic():
    """Mirror of ``test_cohort_converges_on_quadratic``: a rotating block
    cohort cuts the error below 0.2x its start in 400 rounds, on the
    reference's ``make_quadratic_problem(1, n_clients=24, ...)``."""
    from repro.data.quadratic import make_quadratic_problem

    jp = make_quadratic_problem(1, n_clients=N, dim=12, n_measurements=4)
    prob = QuadraticProblem(b=torch.tensor(np.asarray(jp.b)),
                            m=torch.tensor(np.asarray(jp.m)))
    algo = with_cohort(FedCET(alpha=0.05, c=0.5, tau=TAU, n_clients=N),
                       CohortSpec(size=M, selector="rr"))
    grad = torch.func.grad(prob.client_loss)
    batches = prob.stacked_batches(TAU)
    state = algo.init(grad, torch.zeros(prob.dim, dtype=torch.float64),
                      tree_map(lambda b: b[0], batches))
    err0 = float(torch.linalg.norm(algo.client_params(state)[0]
                                   - prob.x_star))
    final, _ = run_rounds(algo, grad, state, batches, rounds=400)
    err = float(torch.linalg.norm(algo.client_params(final)[0]
                                  - prob.x_star))
    assert err < 0.2 * err0, (err0, err)


# ------------------------------------------ benchmarks/cohort_scaling.py
@pytest.mark.parametrize("name", ["fedcet", "fedavg", "scaffold", "fedlin"])
def test_cohort_scaling_lowerings_agree(name):
    """``benchmarks/cohort_scaling.py``'s exactness check: N 1000, cohort
    256, ``block``, dim 8, 4 rounds, the two lowerings within 1e-12."""
    from repro.data.quadratic import make_quadratic_problem

    jp = make_quadratic_problem(0, n_clients=1000, n_measurements=1, dim=8)
    prob = QuadraticProblem(b=torch.tensor(np.asarray(jp.b)),
                            m=torch.tensor(np.asarray(jp.m)))
    algo = _algos(n=1000)[name]
    g, d = [with_cohort(algo, CohortSpec(size=256, selector="block",
                                         lowering=lo))
            for lo in ("gather", "dense")]
    _assert_close(_run(g, rounds=4, prob=prob), _run(d, rounds=4, prob=prob))


# ------------------------------------------------ against the reference
def _jax_run(jalgo, rounds=ROUNDS):
    jax = _jax()
    import jax.numpy as jnp

    import repro.core as J

    grad = jax.grad(JP.client_loss)
    batches = JP.stacked_batches(TAU)
    s = jalgo.init(grad, jnp.zeros(JP.dim), jax.tree.map(lambda b: b[0],
                                                         batches))
    return J.run_rounds(jalgo, grad, s, batches, rounds=rounds)[0]


@pytest.mark.parametrize("composed", [False, True], ids=["bare", "composed"])
@pytest.mark.parametrize("name", list(_algos()))
def test_cohort_round_matches_the_reference(name, composed):
    """The gather lowering, ``uniform`` selector, 6 rounds: every state
    leaf within 1e-12 of the reference's (the step counter equal)."""
    jax = _jax()
    import repro.core as J

    def build(pkg):
        algo = _algos(pkg)[name]
        if composed:
            algo = _composed(algo, pkg)
        return pkg.with_cohort(algo, pkg.CohortSpec(size=M, seed=9))

    got, want = _run(build(PORT)), _jax_run(build(J))
    leaves, jleaves = tree_leaves(got), jax.tree.leaves(want)
    assert len(leaves) == len(jleaves)
    for a, b in zip(leaves, jleaves):
        if isinstance(a, int):
            assert a == int(b)
        else:
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=TOL)


@pytest.mark.parametrize("selector", ["block", "rr", "uniform"])
def test_cohort_indices_match_the_reference(selector):
    """Each selector draws the reference's ids, round by round, at N 24
    and at N 2000 (two sort rounds in ``permutation``)."""
    _jax()
    import jax.numpy as jnp

    from repro.core import CohortSpec as JSpec

    for n, m in ((N, M), (2000, 64)):
        spec, jspec = (CohortSpec(m, selector, seed=4),
                       JSpec(m, selector, seed=4))
        for step in (0, 2, 10, 38):
            assert np.array_equal(spec.indices(step, TAU, n).numpy(),
                                  np.asarray(jspec.indices(
                                      jnp.asarray(step), TAU, n)))


# ------------------------------------------------------ in-place scatter
def test_cohort_round_writes_the_store_in_place():
    """A cohort round under ``shift:q8`` x ``rr:2`` / last consumes its
    input store: every ``[N, ...]`` leaf (x, d, the shift memory, the
    delay buffer) keeps its ``data_ptr()``; the rows outside the cohort
    are bitwise unchanged (the buffer's too, their ages one older)."""
    algo = with_cohort(with_delay(with_compression(
        FedCET(alpha=0.02, c=0.3, tau=TAU, n_clients=N),
        compressor="shift:q8"), "rr:2", policy="last"), "block:7")
    state = algo.init(GRAD, torch.zeros(PROB.dim, dtype=torch.float64),
                      FIRST)
    for _ in range(3):
        idx = algo.cohort.indices(state.inner.t, TAU, N)
        out = torch.ones(N, dtype=torch.bool)
        out[idx] = False
        store = [a for a in tree_leaves(state)
                 if isinstance(a, torch.Tensor) and a.shape[0] == N
                 and a.dim() > 1]
        before = [a[out].clone() for a in store]
        ptrs = [a.data_ptr() for a in store]
        age = state.extras[-1].age.clone()
        state = algo.round(GRAD, state, BATCHES)
        after = [a for a in tree_leaves(state)
                 if isinstance(a, torch.Tensor) and a.shape[0] == N
                 and a.dim() > 1]
        assert len(store) == 4
        assert [a.data_ptr() for a in after] == ptrs
        for b, a in zip(before, after):
            assert torch.equal(b, a[out])
        assert torch.equal(state.extras[-1].age[out], age[out] + 1)


def test_lm_cohort_rows_match_a_plain_engine_on_the_cohort():
    """The float32 LM round of ``chip_smoke.py``'s path K at the reduced
    size (fedlm-100m reduced, 8 clients, ``block:4``, ``shift:q8`` on the
    arena, float32 draws): the cohort round's updated rows of x, d and the
    shift memory equal a plain 4-client engine's round run from the same
    rows and tokens, gathered here and not by the engine, within float32
    rounding of the client mean (the plain engine takes the fused round
    tail, the cohort round the rows quantizer and the 4-op pair)."""
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import make_hetero_lm_dataset
    from repro_torch.models import build_model

    n, c = 8, 0.05
    model = build_model(get_config("fedlm-100m").reduced())
    params = model.init(torch.Generator().manual_seed(0))
    ds = make_hetero_lm_dataset(model.cfg.vocab_size, n, 16, 2, seed=1)
    grad = torch.func.grad(model.loss)
    cohort = FedScenario(compression="shift:q8", arena=True,
                         cohort="block:4").apply(
        FedCET(alpha=3e-3, c=c, tau=TAU, n_clients=n, x64=False))
    plain = FedScenario(compression="shift:q8", arena=True).apply(
        FedCET(alpha=3e-3, c=c, tau=TAU, n_clients=4, x64=False))
    state = cohort.init(grad, params, {"tokens": ds.sample_round(0, TAU)[0]})
    state = cohort.round(grad, state, {"tokens": ds.sample_round(0, TAU)})
    tokens = ds.sample_round(1, TAU)
    idx = cohort.cohort.indices(state.inner.t, TAU, n)
    rows = tree_map(lambda a: a[idx] if isinstance(a, torch.Tensor)
                    and a.dim() >= 1 and a.shape[0] == n else a, state)
    want = plain.round(grad, rows, {"tokens": tokens[:, idx]})
    got = cohort.round(grad, state, {"tokens": tokens})
    leaves = lambda st: [a.data for a in (st.inner.x, st.inner.d,  # noqa
                                          st.extras[0])]
    (gx, gd, gh), (wx, wd, wh) = ([a[idx] for a in leaves(got)],
                                  leaves(want))
    norm = torch.linalg.vector_norm
    assert float(norm(gx - wx) / norm(wx)) <= 1e-6
    assert float(norm(gd - wd) / (c * norm(wx))) <= 1e-5
    assert float(norm(gh - wh) / norm(wh)) <= 1e-6


def test_cohort_round_unaliases_a_store_that_shares_memory():
    """A store whose leaves share memory (the delay buffer seeded with a
    message that IS a state leaf) is split before the in-place scatter:
    the result equals the run from an unshared copy."""
    algo = with_cohort(with_delay(FedCET(alpha=0.02, c=0.3, tau=TAU,
                                         n_clients=N), "rr:2"), M)
    state = algo.init(GRAD, torch.zeros(PROB.dim, dtype=torch.float64),
                      FIRST)
    shared = state._replace(extras=(state.extras[0]._replace(
        buf=state.inner.x),))
    copied = tree_map(lambda a: a.clone() if isinstance(a, torch.Tensor)
                      else a, shared)
    _assert_close(_run(algo, rounds=3, state=shared),
                  _run(algo, rounds=3, state=copied), tol=0.0)


def test_fed_trainer_runs_a_cohort_scenario(tmp_path):
    """``FedTrainer`` over the composed cohort scenario: finite eval
    losses, uplink and downlink billed at the cohort's 7/24 duty, and a
    checkpoint of the consumed-and-rebound state that resumes into the
    same layout."""
    from repro_torch.fed import FedTrainer, TrainerConfig

    algo = with_cohort(_composed(FedCET(alpha=0.02, c=0.3, tau=TAU,
                                        n_clients=N)), M)
    tc = TrainerConfig(rounds=6, eval_every=3, ckpt_every=3,
                       ckpt_dir=str(tmp_path / "ck"))
    trainer = FedTrainer(algo, PROB.client_loss, tc, device="cpu")
    state = trainer.init_state(torch.zeros(PROB.dim, dtype=torch.float64),
                               FIRST)
    state = trainer.fit(state, lambda r: BATCHES)
    assert trainer.history and all(np.isfinite(h["loss_global"])
                                   for h in trainer.history)
    duty = M / N * 0.8
    assert algo.transmit_frac == pytest.approx(duty / 3)  # x fixed:2
    assert algo.receive_frac == pytest.approx(duty)
    restored, start = trainer.maybe_resume(state)
    assert start == 6
    _assert_close(restored, state, tol=0.0)
