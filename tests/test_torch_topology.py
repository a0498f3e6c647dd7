"""The port's aggregation topologies, NIDS and topology-aware accounting
against the JAX package, on the reference's ``make_quadratic_problem(0)``
arrays passed in as numpy, in float64 on the CPU.

* quadratic trajectories: the per-round error AND every leaf of the final
  state agree with the reference within 1e-12 (of each leaf's scale) over
  60 rounds, for ring, ring:sparse, torus:sparse, er:0.5, er:0.5:t:sparse,
  hier:g5, hier:4x2, hier:g5 with shift:q8 tiers, ring:sparse under
  shift:q8 x 0.8 participation, and shift:q8 on the arena over a ring (the
  fused round tail computes the star mean, so it must not run under a
  topology); the graphs, the tier dither and the resampled graphs come
  from the same bits (numpy for the static Erdős–Rényi draw,
  ``core/prng.py`` for the rest);
* NIDS: on the star it is FedCETLiteral with c*alpha = 1/2 (within
  1e-12), and over a ring it matches the reference;
* accounting: ``comm_bits_per_round`` and ``comm_hops_per_round`` equal
  the reference's for every spec;
* grammar and validation: ``parse_topology`` and ``Mixing`` accept and
  refuse what the reference does, with the same messages (mirrors of
  ``tests/test_topology.py``'s grammar tests);
* the weighted-reduce contract and the neighbor tables against the
  reference's, including masked weights, dead groups and the wide-table
  branch.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import FedCET, FedCETLiteral, max_weight_c
from repro_torch.core import topology as T
from repro_torch.core.arena import Arena
from repro_torch.core.baselines import NIDS
from repro_torch.core.comm import comm_bits_per_round, comm_hops_per_round
from repro_torch.core.engine import (EngineState, with_arena,
                                     with_compression, with_participation,
                                     with_topology)
from repro_torch.core.lr_search import lr_search
from repro_torch.core.simulate import simulate_quadratic
from repro_torch.data.quadratic import QuadraticProblem
from repro_torch.utils.tree import tree_leaves

N, TAU, ROUNDS = 10, 2, 60
TOL = 1e-12


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


def _hyper(port):
    alpha = lr_search(port.mu, port.L, TAU)
    return alpha, max_weight_c(port.mu, alpha)


def _stack(pkg, spec, tier, extra, alpha, c):
    """FedCET with ``spec`` attached and the scenario ``extra`` composed,
    built from either package's factories (``pkg``: a namespace)."""
    algo = pkg.FedCET(alpha=alpha, c=c, tau=TAU, n_clients=N)
    if extra == "arena_q8":
        algo = pkg.with_arena(algo)
    algo = pkg.with_topology(algo, spec, seed=11, tier_compression=tier)
    if extra == "q8_part":
        algo = pkg.with_participation(algo, 0.8, seed=3)
    if extra in ("q8_part", "arena_q8"):
        algo = pkg.with_compression(algo, compressor="shift:q8", seed=5)
    return algo


class _Port:
    FedCET = FedCET
    with_arena = staticmethod(with_arena)
    with_topology = staticmethod(with_topology)
    with_participation = staticmethod(with_participation)
    with_compression = staticmethod(with_compression)


def _reference():
    _jax()
    import repro.core as jc

    return jc


def _assert_runs_match(got, want):
    """Errors within 1e-12, and every state leaf within 1e-12 of its
    scale (the drift ``d`` is a gradient-sized quantity)."""
    jax = _jax()
    np.testing.assert_allclose(got.errors.numpy(), np.asarray(want.errors),
                               rtol=0, atol=TOL)
    gl = [g for g in tree_leaves(got.state) if g is not None]
    wl = jax.tree.leaves(want.state)
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        w = np.asarray(w)
        if isinstance(g, int):
            assert g == int(w)
            continue
        g = g.numpy()
        scale = max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(g.reshape(w.shape), w, rtol=0,
                                   atol=TOL * scale)


TRAJECTORIES = [("ring", None, None), ("ring:sparse", None, None),
                ("torus:sparse", None, None), ("er:0.5", None, None),
                ("er:0.5:t:sparse", None, None), ("hier:g5", None, None),
                ("hier:4x2", None, None), ("hier:g5", "shift:q8", None),
                ("hier:g5", "topk:0.3", None), ("ring:sparse", None, "q8_part")]


@pytest.mark.parametrize("spec,tier,extra", TRAJECTORIES,
                         ids=[f"{s}-{t}-{e}" for s, t, e in TRAJECTORIES])
def test_quadratic_trajectory_matches_jax(problems, spec, tier, extra):
    from repro.core.simulate import simulate_quadratic as jsim

    jp, port = problems
    alpha, c = _hyper(port)
    want = jsim(_stack(_reference(), spec, tier, extra, alpha, c), jp,
                rounds=ROUNDS)
    got = simulate_quadratic(_stack(_Port, spec, tier, extra, alpha, c),
                             port, ROUNDS, device="cpu")
    _assert_runs_match(got, want)


def test_fused_tail_is_skipped_under_a_topology(problems):
    """shift:q8 on the arena with a ring attached: the fused round tail
    would average over the star, so the engine takes the generic seam and
    the ring's neighborhood means, as the reference does
    (``src/repro/core/engine.py:809-810``)."""
    from repro.core.simulate import simulate_quadratic as jsim

    jp, port = problems
    alpha, c = _hyper(port)
    want = jsim(_stack(_reference(), "ring", None, "arena_q8", alpha, c), jp,
                rounds=ROUNDS)
    algo = _stack(_Port, "ring", None, "arena_q8", alpha, c)
    got = simulate_quadratic(algo, port, ROUNDS, device="cpu")
    assert isinstance(got.state.inner.x, Arena)
    _assert_runs_match(got, want)
    # without the topology the same stack does take the fused tail, and
    # its trajectory is another one: the guard is what the match above
    # tests.
    star = simulate_quadratic(dataclasses.replace(algo, topology=None), port,
                              ROUNDS, device="cpu")
    assert float((star.state.inner.x.data - got.state.inner.x.data)
                 .abs().max()) > 1e-6


# ---------------------------------------------------------------- NIDS
def test_nids_star_is_fedcet_literal(problems):
    _, port = problems
    alpha = 1.0 / port.L
    nids = simulate_quadratic(NIDS(alpha=alpha, n_clients=N), port, 150,
                              device="cpu")
    lit = simulate_quadratic(
        FedCETLiteral(alpha=alpha, c=0.5 / alpha, tau=1, n_clients=N), port,
        150, device="cpu")
    np.testing.assert_allclose(nids.errors.numpy(), lit.errors.numpy(),
                               rtol=0, atol=TOL)


@pytest.mark.parametrize("spec", ["ring", "torus:sparse"])
def test_nids_gossip_matches_jax(problems, spec):
    from repro.core import NIDS as JNIDS
    from repro.core import with_topology as jwt
    from repro.core.simulate import simulate_quadratic as jsim

    jp, port = problems
    alpha = 1.0 / port.L
    want = jsim(jwt(JNIDS(alpha=alpha, n_clients=N), spec), jp,
                rounds=ROUNDS)
    got = simulate_quadratic(with_topology(NIDS(alpha=alpha, n_clients=N),
                                           spec), port, ROUNDS, device="cpu")
    _assert_runs_match(got, want)


# ----------------------------------------------------------- accounting
ACCOUNTING = [("ring", None, None), ("ring:sparse", None, "q8_part"),
              ("torus", None, None), ("torus:sparse", None, None),
              ("er:0.5", None, None), ("er:0.4:t", None, None),
              ("er:0.5:t:sparse", None, "q8_part"), ("hier:g5", None, None),
              ("hier:4x2", None, "q8_part"), ("hier:g5", "shift:q8", None),
              ("hier:g5", "q8", "q8_part"), ("star", None, "q8_part")]


@pytest.mark.parametrize("spec,tier,extra", ACCOUNTING,
                         ids=[f"{s}-{t}-{e}" for s, t, e in ACCOUNTING])
def test_accounting_matches_jax(problems, spec, tier, extra):
    from repro.core import comm_bits_per_round as jbits
    from repro.core import comm_hops_per_round as jhops

    _, port = problems
    alpha, c = _hyper(port)
    ja = _stack(_reference(), spec, tier, extra, alpha, c)
    pa = _stack(_Port, spec, tier, extra, alpha, c)
    dim = port.dim
    assert comm_hops_per_round(pa, dim, N) == jhops(ja, dim, N)
    assert comm_bits_per_round(pa, dim, N) == jbits(ja, dim, N)
    leaf_info = [("w", dim)]
    assert comm_bits_per_round(pa, dim, N, leaf_info) \
        == jbits(ja, dim, N, leaf_info)


def test_gossip_bills_edges_and_no_broadcast(problems):
    _, port = problems
    alpha, c = _hyper(port)
    ring = with_topology(FedCET(alpha=alpha, c=c, tau=TAU, n_clients=N),
                         "ring:sparse")
    assert ring.topology.client_up_mult(N) == 2.0
    bits = comm_bits_per_round(ring, port.dim, N)
    assert bits["up_bits"] == port.dim * N * 2 * 32.0
    assert bits["down_bits"] == 0.0
    hier = with_topology(FedCET(alpha=alpha, c=c, tau=TAU, n_clients=N),
                         "hier:g5", tier_compression="shift:q8")
    hops = comm_hops_per_round(hier, port.dim, N)
    assert [h["hop"] for h in hops] == ["client", "tier1->root"]
    assert hops[1]["bits"] == port.dim * 5 * 8.0


# -------------------------------------------------------------- grammar
def _both_raise(fn_port, fn_ref, exc=ValueError):
    """Both calls raise ``exc`` with the same message (the reference's
    ``repro.core.compressors.Compressor`` is renamed in the port)."""
    with pytest.raises(exc) as got:
        fn_port()
    with pytest.raises(exc) as want:
        fn_ref()
    assert str(got.value).replace("repro_torch.", "repro.") \
        == str(want.value)


def test_parse_topology_grammar():
    from repro.core import topology as JT

    parse = T.parse_topology
    for spec in ("star", None, "none", "", "off", T.Star()):
        assert parse(spec, N) is None
    assert parse("hier:g5", N) == T.Hierarchical((5,))
    assert parse("hier:5", N) == T.Hierarchical((5,))
    assert parse("hier:5x2", N) == T.Hierarchical((5, 2))
    assert parse("ring", N).graph == "ring"
    assert parse("torus", N).graph == "torus2x5"
    assert parse("torus:2x5", N).graph == "torus2x5"
    er = parse("er:0.4", N)
    assert er.graph == "er" and er.p == 0.4 and not er.resample
    ert = parse("er:0.4:t", N)
    assert ert.resample and ert.stateful and ert.n == N
    for spec in ("ring", "torus", "er:0.4", "er:0.9", "hier:4x2"):
        got, want = parse(spec, N, seed=3), JT.parse_topology(spec, N, seed=3)
        if isinstance(got, T.Mixing):
            assert got.w == want.w and got.graph == want.graph
        else:
            assert got.groups == want.groups
    for bad in ("tree:3", "hier:", "hier:2x5", "torus:3x5", "hier:g5:sparse",
                "hier:g20"):
        _both_raise(lambda: parse(bad, N), lambda: JT.parse_topology(bad, N))
    _both_raise(lambda: parse(T.Mixing.ring(8), N),
                lambda: JT.parse_topology(JT.Mixing.ring(8), N))


def test_sparse_spec_grammar():
    from repro.core import topology as JT

    parse = T.parse_topology
    t = parse("ring:sparse", N)
    assert isinstance(t, T.Mixing) and t.graph == "ring"
    assert t.lowering == "sparse"
    assert parse("ring", N).lowering == "dense"
    assert parse("torus:2x5:sparse", N).lowering == "sparse"
    t = parse("er:0.4:sparse", N)
    assert t.lowering == "sparse" and not t.resample
    t = parse("er:0.4:t:sparse", N)
    assert t.lowering == "sparse" and t.resample and t.stateful
    for spec in ("ring", "star"):
        _both_raise(lambda: parse(spec, N, tier_compression="q8"),
                    lambda: JT.parse_topology(spec, N, tier_compression="q8"))
    from repro_torch.core.compressors import Shifted, StochasticQuant

    h = parse("hier:g5", N, tier_compression="q8")
    assert isinstance(h.tier_compression, StochasticQuant)
    assert isinstance(parse("hier:g5", N, tier_compression="shift:q8")
                      .tier_compression, Shifted)
    assert parse("hier:g5", N, tier_compression="none") \
        == parse("hier:g5", N)
    # a biased tier spec gets the engine's auto error feedback, in both
    # packages alike.
    from repro.core.compressors import ErrorFeedback as JEF
    from repro.core.compressors import TopK as JTopK

    from repro_torch.core.compressors import ErrorFeedback, TopK

    tier = parse("hier:g5", N, tier_compression="topk:0.3").tier_compression
    jtier = JT.parse_topology("hier:g5", N,
                              tier_compression="topk:0.3").tier_compression
    assert tier == ErrorFeedback(TopK(0.3)) and jtier == JEF(JTopK(0.3))
    assert (tier.stateful, tier.bits_per_coord) == (jtier.stateful,
                                                    jtier.bits_per_coord)
    _both_raise(lambda: T.Hierarchical((5,), tier_compression="q8"),
                lambda: JT.Hierarchical((5,), tier_compression="q8"))


def test_mixing_validation_gaps():
    from repro.core import topology as JT

    _both_raise(lambda: T.Mixing.torus(10, shape=(3, 4)),
                lambda: JT.Mixing.torus(10, shape=(3, 4)))
    assert T.Mixing.torus(12, shape=(3, 4)).n == 12
    _both_raise(
        lambda: dataclasses.replace(T.Mixing.erdos_renyi(10, 0.9, seed=1),
                                    lowering="sparse", max_degree=2),
        lambda: dataclasses.replace(JT.Mixing.erdos_renyi(10, 0.9, seed=1),
                                    lowering="sparse", max_degree=2))
    _both_raise(
        lambda: dataclasses.replace(
            T.Mixing.erdos_renyi(10, 0.5, resample=True), max_degree=4),
        lambda: dataclasses.replace(
            JT.Mixing.erdos_renyi(10, 0.5, resample=True), max_degree=4))
    _both_raise(lambda: dataclasses.replace(T.Mixing.ring(10),
                                            lowering="csr"),
                lambda: dataclasses.replace(JT.Mixing.ring(10),
                                            lowering="csr"))
    _both_raise(lambda: T.Mixing(), lambda: JT.Mixing())
    _both_raise(lambda: T.Mixing.ring(1), lambda: JT.Mixing.ring(1))
    # a resampled cap above n-1 clamps to the n-1 slots a node can have
    wide = dataclasses.replace(T.Mixing.erdos_renyi(10, 0.5, resample=True),
                               lowering="sparse", max_degree=15)
    out = wide.reduce({"v": torch.ones((10, 3), dtype=torch.float64)},
                      torch.ones(10, dtype=torch.float64), T.TopoState(k=0))
    np.testing.assert_allclose(out["v"].numpy(), 1.0, rtol=1e-12)
    ok = dataclasses.replace(T.Mixing.ring(10), lowering="sparse",
                             max_degree=4)
    idx, wgt = ok._static_tables()
    assert idx.shape == (10, 5) and (wgt[:, 3:] == 0).all()


def test_star_specs_are_noops_and_stacking_raises(problems):
    _, port = problems
    alpha, c = _hyper(port)
    algo = FedCET(alpha=alpha, c=c, tau=TAU, n_clients=N)
    for spec in ("star", "none", "", None, T.Star()):
        assert with_topology(algo, spec) is algo
    hier = with_topology(algo, "hier:g5")
    with pytest.raises(ValueError, match="already has a topology"):
        with_topology(hier, "ring")
    # a gossip graph has no server to sample a cohort: the reference's
    # ValueError in both factory orders.
    from repro_torch.core.engine import with_cohort

    with pytest.raises(ValueError, match="cohort"):
        with_cohort(with_topology(algo, "ring"), 4)
    with pytest.raises(ValueError, match="cohort"):
        with_topology(with_cohort(algo, 4), "ring")
    with pytest.raises(NotImplementedError, match="cohort"):
        with_topology(algo, "ring").topology.reduce_cohort(
            {}, torch.ones(2), torch.zeros(2, dtype=torch.int64), N)


# ----------------------------------------------- reduce and tables
def _tree(n, seed):
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal((n, 7)), "b": rng.standard_normal((n,))}


def _to_torch(tree):
    return {k: torch.from_numpy(v) for k, v in tree.items()}


WEIGHTS = [np.ones(N), np.random.default_rng(2).random(N),
           np.array([0.0, 0.0, 1, 1, 1, 0, 1, 1, 1, 1.0])]


@pytest.mark.parametrize("wi", range(len(WEIGHTS)))
def test_weighted_reduce_matches_jax(wi):
    """Star, hierarchies and gossip rows under uniform, random and masked
    weights (a dead first group) against the reference's reduce."""
    import jax.numpy as jnp

    from repro.core import topology as JT

    w = WEIGHTS[wi]
    tree = _tree(N, wi)
    tw, jw = torch.from_numpy(w), jnp.asarray(w)
    cases = [(T.Star(), JT.Star())]
    cases += [(T.Hierarchical(g), JT.Hierarchical(g))
              for g in ((5,), (3,), (4, 2), (7,))]
    for spec in ("ring", "ring:sparse", "torus:sparse", "er:0.5",
                 "er:0.5:sparse"):
        cases.append((T.parse_topology(spec, N),
                      JT.parse_topology(spec, N)))
    for mine, ref in cases:
        got = mine.reduce(_to_torch(tree), tw)
        want = ref.reduce({k: jnp.asarray(v) for k, v in tree.items()}, jw)
        for k in tree:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=0, atol=TOL, err_msg=repr(mine))


def test_neighbor_tables_match_jax():
    import jax.numpy as jnp

    from repro.core import topology as JT

    for spec in ("ring:sparse", "torus:sparse", "er:0.5:sparse"):
        mine, ref = T.parse_topology(spec, N), JT.parse_topology(spec, N)
        for a, b in zip(mine._static_tables(), ref._static_tables()):
            np.testing.assert_array_equal(a, b)
        assert mine.spectral_gap == ref.spectral_gap
    n = 40
    mine = T.Mixing.erdos_renyi(n, 0.3, seed=4, resample=True)
    ref = JT.Mixing.erdos_renyi(n, 0.3, seed=4, resample=True)
    for k in (0, 1, 7):
        idx, wgt = mine._resampled_tables(T.TopoState(k=k), n, torch.float64,
                                          "cpu")
        jidx, jwgt = ref._resampled_tables(
            JT.TopoState(k=jnp.asarray(k, jnp.int32)), n, jnp.float64)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        np.testing.assert_allclose(wgt.numpy(), np.asarray(jwgt), rtol=0,
                                   atol=TOL)
        np.testing.assert_allclose(
            mine._matrix(T.TopoState(k=k), n, torch.float64, "cpu").numpy(),
            np.asarray(ref._matrix(JT.TopoState(k=jnp.asarray(k)), n,
                                   jnp.float64)), rtol=0, atol=TOL)


@pytest.mark.parametrize("n", [40, 64])
def test_wide_resampled_table_matches_jax_dense(n):
    """Resampled tables of n = 40 and 64 (S = n > 32 slots, where the
    reference's default route switches to a segment sum): the kernel route
    (its plain version here) against the reference's dense matrix of the
    same draw, with two clients masked out."""
    import jax.numpy as jnp

    from repro.core import topology as JT

    sparse = dataclasses.replace(T.Mixing.erdos_renyi(n, 0.3, resample=True),
                                 lowering="sparse")
    dense = JT.Mixing.erdos_renyi(n, 0.3, resample=True)
    tree = _tree(n, 5)
    w = np.ones(n)
    w[[3, 11]] = 0.0
    for k in (0, 1, 7):
        got = sparse.reduce(_to_torch(tree), torch.from_numpy(w),
                            T.TopoState(k=k))
        want = dense.reduce({a: jnp.asarray(v) for a, v in tree.items()},
                            jnp.asarray(w),
                            JT.TopoState(k=jnp.asarray(k, jnp.int32)))
        for a in tree:
            np.testing.assert_allclose(got[a].numpy(), np.asarray(want[a]),
                                       rtol=0, atol=TOL)


def test_topo_state_rides_the_engine_state(problems):
    """A resampled graph carries a TopoState after the transform extras
    (init's warm-up aggregation plus one per round); stateful tier
    compression carries a [g, ...] memory per tier."""
    _, port = problems
    alpha, c = _hyper(port)
    base = FedCET(alpha=alpha, c=c, tau=TAU, n_clients=N)
    res = simulate_quadratic(with_topology(base, "er:0.5:t", seed=11), port,
                             40, device="cpu")
    assert isinstance(res.state, EngineState)
    assert isinstance(res.state.extras[-1], T.TopoState)
    assert res.state.extras[-1].k == 41
    algo = with_compression(with_topology(base, "hier:g5",
                                          tier_compression="shift:q8"),
                            compressor="shift:q8")
    res = simulate_quadratic(algo, port, 3, device="cpu")
    assert len(res.state.extras) == 2
    tstate = res.state.extras[-1]
    assert tstate.k == 4 and len(tstate.tier) == 1
    assert tuple(tstate.tier[0].shape) == (5, port.dim)
    q8 = with_topology(base, "hier:g5", tier_compression="q8")
    s0 = simulate_quadratic(q8, port, 1, device="cpu").state
    assert isinstance(s0.extras[-1], T.TopoState)
    assert s0.extras[-1].tier is None
    assert not with_topology(base, "ring").topology.stateful
