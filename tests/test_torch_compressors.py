"""The port's compressors, comm accounting and compressed-round results
against the JAX package.

* ``StochasticQuant.compress`` / ``apply_arena`` and ``Shifted.apply``
  from the same key as the reference, float64, within 1e-12 (they land
  bitwise: same bits from ``core/prng.py``), including ``pq8`` and a zero
  leaf;
* ``from_spec``'s accepted and refused specs;
* ``stack_wire_bits`` and ``comm_bits_per_round`` equal to the
  reference's numbers;
* mirrors of ``tests/test_engine.py:310-349`` on the paper's problem with
  the ported compressors only: ``shift:q8`` x 0.8 sampling within 10x of
  the uncompressed run under the same sampling, and plain ``q8``'s
  sampling floor. The reference runs 4000 / 3000 rounds; 800 are enough
  here: the uncompressed sampled run reaches the float64 floor
  (~4e-15) by round 800, and plain q8's floor (~3e-5) is in place by
  round 400.
"""

import math

import numpy as np
import pytest
import torch

from repro_torch.core import compressors as C
from repro_torch.core import prng
from repro_torch.core.arena import Arena, pack, unpack
from repro_torch.core.comm import comm_bits_per_round, leaf_info_of
from repro_torch.core.engine import (ErrorFeedbackCompression,
                                     MessageCompression, with_compression,
                                     with_participation)
from repro_torch.core.fedcet import FedCET, max_weight_c
from repro_torch.core.fedcet_compressed import FedCETCompressed
from repro_torch.core.participation import FedCETPartial
from repro_torch.utils.tree import tree_leaves

TOL = 1e-12


def _jax():
    import jax

    jax.config.update("jax_enable_x64", True)
    return jax


def _msg(seed=0, zero_leaf=False):
    """A stacked [4, ...] message tree, dict keys sorted (JAX's order)."""
    rng = np.random.default_rng(seed)
    tree = {"b": rng.standard_normal((4, 7)),
            "big": rng.standard_normal((4, 3, 517)),
            "w": rng.standard_normal((4, 5, 3))}
    if zero_leaf:
        tree["z"] = np.zeros((4, 6))
    return tree


def _close(got, want):
    for g, w in zip(tree_leaves(got), _jax().tree.leaves(want)):
        g = g.data if isinstance(g, Arena) else g
        assert g.shape == tuple(np.shape(w))
        assert float(np.abs(g.numpy() - np.asarray(w)).max()) <= TOL


@pytest.mark.parametrize("spec", ["q8", "pq8", "q4", "shift:q8"])
@pytest.mark.parametrize("zero_leaf", [False, True], ids=["", "zero_leaf"])
def test_apply_matches_jax_from_the_same_key(spec, zero_leaf):
    jax = _jax()
    from repro.core.compressors import from_spec as jfrom

    key_j = jax.random.fold_in(jax.random.key(5), 17)
    key_t = prng.fold_in(prng.key(5), 17)
    tree = _msg(1, zero_leaf)
    h = _msg(2, zero_leaf) if spec.startswith("shift") else None
    as_t = lambda tr: None if tr is None else {  # noqa: E731
        k: torch.tensor(v) for k, v in tr.items()}
    got, got_h = C.from_spec(spec).apply(key_t, as_t(tree), as_t(h))
    want, want_h = jfrom(spec).apply(key_j, tree, h)
    _close(got, want)
    if h is not None:
        _close(got_h, want_h)
    if zero_leaf:
        assert float(got["z"].abs().max()) == 0.0


@pytest.mark.parametrize("spec", ["q8", "pq8"])
def test_apply_arena_matches_jax_and_the_per_leaf_path(spec):
    jax = _jax()
    from repro.core.arena import pack as jpack
    from repro.core.compressors import from_spec as jfrom

    tree = _msg(3, zero_leaf=True)
    model = {k: v[0] for k, v in tree.items()}
    from repro.core.arena import ArenaLayout as JLayout
    from repro_torch.core.arena import ArenaLayout

    ja = jpack(tree, JLayout.for_tree(model))
    ta = pack({k: torch.tensor(v) for k, v in tree.items()},
              ArenaLayout.for_tree({k: torch.tensor(v)
                                    for k, v in model.items()}))
    key_j = jax.random.fold_in(jax.random.key(9), -1 % 2 ** 32)
    key_t = prng.fold_in(prng.key(9), -1)
    got, _ = C.from_spec(spec).apply(key_t, ta, None)
    want, _ = jfrom(spec).apply(key_j, ja, None)
    assert isinstance(got, Arena)
    assert float(np.abs(got.data.numpy() - np.asarray(want.data)).max()) <= TOL
    per_leaf, _ = C.from_spec(spec).apply(key_t, unpack(ta), None)
    for a, b in zip(tree_leaves(unpack(got)), tree_leaves(per_leaf)):
        assert torch.equal(a, b)


def _nested_msg(seed):
    """A stacked [4, ...] message with nested dicts and a list, keys
    sorted (JAX's flatten order)."""
    rng = np.random.default_rng(seed)
    return {"b": rng.standard_normal((4, 7)),
            "layers": [{"down": rng.standard_normal((4, 5, 3)),
                        "up": rng.standard_normal((4, 3, 5))}
                       for _ in range(2)],
            "w": rng.standard_normal((4, 9))}


def _unsorted(tree):
    """``tree`` as tensors, every dict built in reverse-sorted key order
    (the port's models build dicts in an order of their own)."""
    if isinstance(tree, dict):
        return {k: _unsorted(tree[k]) for k in sorted(tree, reverse=True)}
    if isinstance(tree, list):
        return [_unsorted(v) for v in tree]
    return torch.tensor(tree)


def _close_by_name(got, want):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _close_by_name(got[k], want[k])
    elif isinstance(want, list):
        for g, w in zip(got, want, strict=True):
            _close_by_name(g, w)
    else:
        assert float(np.abs(got.numpy() - np.asarray(want)).max()) <= TOL


@pytest.mark.parametrize("spec", ["q8", "pq8", "shift:q8", "plan",
                                  "arena"])
def test_dithers_follow_the_reference_leaf_order(spec):
    """A message whose dicts are not in sorted key order draws the
    reference's dither on every leaf: the per-leaf subkeys fold in the
    leaf's index in JAX's flatten order (``reference_leaf_index``), in
    the per-leaf path, a plan and the arena's packed dither alike."""
    jax = _jax()
    from repro.core.arena import ArenaLayout as JLayout
    from repro.core.arena import pack as jpack
    from repro.core.arena import unpack as junpack
    from repro.core.compressors import from_spec as jfrom
    from repro.core.compressors import parse_plan as jplan

    from repro_torch.core.arena import ArenaLayout

    key_j = jax.random.fold_in(jax.random.key(5), 17)
    key_t = prng.fold_in(prng.key(5), 17)
    tree = _nested_msg(6)
    h = _nested_msg(7) if spec in ("shift:q8", "plan") else None
    if spec == "plan":
        comp, jcomp = C.parse_plan("*:shift:q8"), jplan("*:shift:q8")
    else:
        comp = C.from_spec("q8" if spec == "arena" else spec)
        jcomp = jfrom("q8" if spec == "arena" else spec)
    msg, jmsg = _unsorted(tree), tree
    if spec == "arena":
        model = jax.tree.map(lambda a: a[0], tree)
        msg = pack(msg, ArenaLayout.for_tree(_unsorted(model)))
        jmsg = jpack(tree, JLayout.for_tree(model))
    got, got_h = comp.apply(key_t, msg, None if h is None else _unsorted(h))
    want, want_h = jcomp.apply(key_j, jmsg, h)
    if spec == "arena":
        got, want = unpack(got), junpack(want)
    assert list(got) == sorted(tree, reverse=True)  # the port's own order
    _close_by_name(got, want)
    if h is not None:
        _close_by_name(got_h, want_h)
    assert C.reference_leaf_index(msg if spec != "arena" else got) \
        == [5, 2, 1, 4, 3, 0]


def test_kernel_switch_agrees_on_the_cpu():
    key = prng.key(1)
    leaf = torch.tensor(_msg(4)["big"])
    on = C.StochasticQuant(8, use_kernel=True).compress(key, leaf)
    off = C.StochasticQuant(8, use_kernel=False).compress(key, leaf)
    assert torch.equal(on, off)


def test_from_spec_accepts_the_ported_grammar():
    assert C.from_spec("none") is None and C.from_spec(None) is None
    assert C.from_spec("q8") == C.StochasticQuant(8)
    assert C.from_spec("quant:6") == C.StochasticQuant(6)
    assert C.from_spec("pq8") == C.StochasticQuant(8, per_client_dither=True)
    s = C.from_spec("shift:q8")
    assert isinstance(s, C.Shifted) and s.inner == C.StochasticQuant(8)
    assert s.step == 1.0 and s.bits_per_coord == 8.0 and s.up_frac == 0.25
    comp = C.StochasticQuant(4)
    assert C.from_spec(comp) is comp and C.auto_wrap(comp) is comp


@pytest.mark.parametrize("spec", ["topk:0.3", "randk:0.25", "nat", "bf16",
                                  "ef:q8", "randk:0.5+q8", "shift:topk:0.3"])
def test_from_spec_refuses_what_later_slices_port(spec):
    """The specs the port once refused now parse, and each one's ``apply``
    equals the reference's from the same key, bitwise in float64, per
    leaf and on an arena (with a memory for the stateful wrappers)."""
    _spec_matches_jax(spec)


def _spec_matches_jax(spec, seed=1):
    jax = _jax()
    from repro.core.arena import ArenaLayout as JLayout
    from repro.core.arena import pack as jpack
    from repro.core.compressors import from_spec as jfrom

    from repro_torch.core.arena import ArenaLayout

    key_j = jax.random.fold_in(jax.random.key(5), 17)
    key_t = prng.fold_in(prng.key(5), 17)
    tree = _msg(seed, zero_leaf=True)
    comp, jcomp = C.from_spec(spec), jfrom(spec)
    assert comp.stateful == jcomp.stateful
    h = _msg(seed + 1, zero_leaf=True) if comp.stateful else None
    as_t = lambda tr: None if tr is None else {  # noqa: E731
        k: torch.tensor(v) for k, v in tr.items()}
    got, got_h = comp.apply(key_t, as_t(tree), as_t(h))
    want, want_h = jcomp.apply(key_j, tree, h)
    for k in tree:
        assert np.array_equal(got[k].numpy(), np.asarray(want[k])), (spec, k)
        if h is not None:
            assert np.array_equal(got_h[k].numpy(), np.asarray(want_h[k]))
    model = {k: v[0] for k, v in tree.items()}
    lo_t = ArenaLayout.for_tree(as_t(model))
    lo_j = JLayout.for_tree(model)
    pk = lambda tr: None if tr is None else pack(as_t(tr), lo_t)  # noqa: E731
    jpk = lambda tr: None if tr is None else jpack(tr, lo_j)  # noqa: E731
    got, got_h = comp.apply(key_t, pk(tree), pk(h))
    want, want_h = jcomp.apply(key_j, jpk(tree), jpk(h))
    assert np.array_equal(got.data.numpy(), np.asarray(want.data)), spec
    if h is not None:
        assert np.array_equal(got_h.data.numpy(), np.asarray(want_h.data))


@pytest.mark.parametrize("spec", [
    "topk_global:0.3", "pq4", "shift:nat", "shift:randk:0.5",
    "ef:topk:0.3+bf16", "q8+bf16", "randk:0.5+topk:0.5+q4", "bf16+q6",
    "topk:0.7+q12+bf16", "ef:randk:0.25+nat", "shift:pq8"])
def test_the_whole_grammar_matches_jax_from_the_same_key(spec):
    """Every stage, chain and prefix of the grammar beyond the cases
    above: bitwise equal to the reference per leaf and on an arena."""
    _spec_matches_jax(spec, seed=7)


def test_natural_quant_code_flips_are_rare_in_float32():
    """``NaturalQuant`` takes ``floor(log2|v|)`` in float, as the
    reference: where XLA's and torch's ``log2`` round apart just below a
    power of two, a code moves one bucket. On 200,000 float32 values,
    half of them within a few ulps below a power of two, the share of
    codes that differ from the reference's stays <= 1e-3."""
    jax = _jax()
    import jax.numpy as jnp
    from repro.core.compressors import NaturalQuant as JNat

    rng = np.random.default_rng(3)
    base = np.ldexp(1.0, rng.integers(-20, 20, 100_000)).astype(np.float32)
    near = np.nextafter(base, np.float32(0)) * np.where(
        rng.random(100_000) < 0.5, 1, -1).astype(np.float32)
    v = np.concatenate([near, rng.standard_normal(100_000).astype(
        np.float32)])[None]
    got = C.NaturalQuant().compress(prng.key(4), torch.tensor(v)).numpy()
    want = np.asarray(JNat().compress(jax.random.key(4), jnp.asarray(v)))
    assert got.dtype == want.dtype == np.float32
    flipped = float(np.mean(got != want))
    assert flipped <= 1e-3, flipped


@pytest.mark.parametrize("spec", ["zz8", "shift:", ""])
def test_from_spec_rejects_bad_specs(spec):
    if spec == "":
        assert C.from_spec(spec) is None
        return
    with pytest.raises(ValueError):
        C.from_spec(spec)


def test_legacy_and_error_feedback_forms_raise():
    """The legacy ``k_frac=`` / ``quantize=`` form and forced error
    feedback now run; mixing the legacy kwargs with ``compressor=`` still
    raises. The legacy transform's rounds equal the reference's."""
    base = FedCET(alpha=0.1, c=0.2, tau=2, n_clients=4)
    assert with_compression(base) is base  # identity: exact no-op
    legacy = with_compression(base, k_frac=0.5)
    (t,) = legacy.transforms
    assert isinstance(t, ErrorFeedbackCompression) and t.error_feedback
    forced = with_compression(base, compressor="q8", error_feedback=True)
    assert forced.transforms[0].compressor == C.ErrorFeedback(
        C.StochasticQuant(8))
    with pytest.raises(ValueError, match="EITHER"):
        with_compression(base, compressor="q8", quantize=True)
    _jax()
    from repro.core import FedCET as JFedCET
    from repro.core import with_compression as jwc
    from repro.core.simulate import simulate_quadratic as jsim

    from repro_torch.core.simulate import simulate_quadratic

    problem, jproblem = _problem(), _jproblem()
    for kw in (dict(k_frac=0.3, quantize=True),
               dict(k_frac=0.5, error_feedback=False)):
        algo = with_compression(FedCET(alpha=0.1, c=0.2, tau=2,
                                       n_clients=10), **kw)
        got = simulate_quadratic(algo, problem, 60, device="cpu")
        want = jsim(jwc(JFedCET(alpha=0.1, c=0.2, tau=2, n_clients=10),
                        **kw), jproblem, 60)
        np.testing.assert_allclose(np.asarray(got.errors),
                                   np.asarray(want.errors), rtol=0,
                                   atol=TOL)


# ---------------------------------------------------------------- accounting
def _params():
    rng = np.random.default_rng(0)
    return {"embed": rng.standard_normal((50, 8)),
            "layers": [{"attn": rng.standard_normal((8, 8)),
                        "ln1": rng.standard_normal((8,))}],
            "scale": np.float64(1.5)}


@pytest.mark.parametrize("spec,rate", [("none", 1.0), ("q8", 1.0),
                                       ("shift:q8", 0.8), ("pq4", 0.5),
                                       ("shift:q12", 1.0)])
def test_wire_bits_match_the_reference(spec, rate):
    _jax()
    from repro.core import FedCET as JFedCET
    from repro.core import with_compression as jwc
    from repro.core import with_participation as jwp
    from repro.core.comm import comm_bits_per_round as jbits
    from repro.core.comm import leaf_info_of as jinfo
    from repro.core.compressors import from_spec as jfrom
    from repro.core.compressors import stack_wire_bits as jstack

    kw = dict(alpha=0.1, c=0.2, tau=2, n_clients=6)
    algo = with_participation(with_compression(FedCET(**kw), compressor=spec),
                              rate, seed=1)
    jalgo = jwp(jwc(JFedCET(**kw), compressor=spec), rate, seed=1)
    params = _params()
    info = leaf_info_of({k: (torch.tensor(v) if not isinstance(v, list) else
                             [{kk: torch.tensor(vv) for kk, vv in d.items()}
                              for d in v]) for k, v in params.items()})
    assert info == jinfo(params)
    n = sum(s for _, s in info)
    assert comm_bits_per_round(algo, n, 6, info) == jbits(jalgo, n, 6, info)
    assert comm_bits_per_round(algo, n, 6) == jbits(jalgo, n, 6)
    assert algo.bits_per_coord == jalgo.bits_per_coord
    assert algo.up_frac == jalgo.up_frac
    if spec != "none":
        assert [C.stack_wire_bits([C.from_spec(spec)], i, nm, s)
                for i, (nm, s) in enumerate(info)] == [
            jstack([jfrom(spec)], i, nm, s) for i, (nm, s) in enumerate(info)]


def test_sugar_factories_and_transform_properties():
    a = FedCETCompressed(0.1, 0.2, 2, 4, compressor="shift:q8", seed=7)
    (t,) = a.transforms
    assert isinstance(t, MessageCompression) and t.seed == 7 and t.index == 0
    assert t.unbiased and t.value_bits == 8.0 and a.name == "fedcet_c"
    assert FedCETCompressed(0.1, 0.2, 2, 4).transforms == ()
    p = FedCETPartial(0.1, 0.2, 2, 4, participation=0.5, seed=2)
    assert p.sampling.rate == 0.5 and p.sampling.seed == 2
    assert p.transmit_frac == p.receive_frac == 0.5
    assert FedCETPartial(0.1, 0.2, 2, 4).sampling is None


# ------------------------------- compressed x sampled rounds (test_engine)
ROUNDS = 800


def _jproblem():
    _jax()
    from repro.data.quadratic import make_quadratic_problem

    return make_quadratic_problem(0)


def _problem():
    from repro_torch.data.quadratic import QuadraticProblem

    jp = _jproblem()
    return QuadraticProblem(b=torch.tensor(np.asarray(jp.b)),
                            m=torch.tensor(np.asarray(jp.m)))


def _base(problem, rate=None):
    from repro_torch.core.lr_search import lr_search

    alpha = lr_search(problem.mu, problem.L, 2)
    algo = FedCET(alpha=alpha, c=max_weight_c(problem.mu, alpha), tau=2,
                  n_clients=problem.n_clients)
    return algo if rate is None else with_participation(algo, rate, seed=3)


def _final_error(algo, problem, rounds=ROUNDS):
    from repro_torch.core.simulate import simulate_quadratic

    return simulate_quadratic(algo, problem, rounds, device="cpu").final_error


def test_shift_q8_x_participation_has_no_error_floor():
    """Unbiased shifted quantization under random participation converges
    to the exact optimum: within 10x of the uncompressed sampled run."""
    problem = _problem()
    base = _base(problem, 0.8)
    ref_err = _final_error(base, problem)
    assert ref_err < 1e-12
    err = _final_error(with_compression(base, compressor="shift:q8"), problem)
    assert err < 10 * ref_err, (err, ref_err)


def test_plain_q8_floor_is_participation_induced():
    """Plain (unshifted) dithered quantization converges exactly under full
    participation but keeps a small re-excitation floor under sampling."""
    problem = _problem()
    full = with_compression(_base(problem), compressor="q8")
    assert _final_error(full, problem, 400) < 1e-12
    part = with_compression(_base(problem, 0.8), compressor="q8")
    err = _final_error(part, problem)
    assert 1e-8 < err < 5e-4, err


# --------------------------------- mirrors of tests/test_compressors.py
def _leaf(seed, clients=6, dim=40):
    """The reference's ``_leaf``: ``jax.random.normal(key(seed), (clients,
    dim))`` in float64, carried over through numpy."""
    jax = _jax()
    return torch.tensor(np.asarray(jax.random.normal(jax.random.key(seed),
                                                     (clients, dim))))


def _keys(n):
    """``jax.random.split(key(1), n)``, as the reference's statistical
    tests draw them (``core/prng.py`` splits bit for bit alike)."""
    return prng.split(prng.key(1), n)


@pytest.mark.parametrize("comp,qbits", [
    (C.RandK(0.25), None), (C.RandK(0.5), None),
    (C.StochasticQuant(bits=4), 4), (C.StochasticQuant(bits=8), 8),
    (C.Chain((C.RandK(0.5), C.StochasticQuant(bits=8))), 8),
    (C.NaturalQuant(), None),
], ids=["randk0.25", "randk0.5", "q4", "q8", "randk+q8", "nat"])
def test_statistical_unbiasedness(comp, qbits):
    """E[compress(v)] == v over the key distribution: the mean over 4000
    keys is within 5 standard errors per coordinate (plus the binomial
    dither-flip bound ``s/(2 sqrt(n))`` for quantizers), on the
    reference's leaf and keys."""
    v = _leaf(0)
    n_keys = 4000
    outs = torch.stack([comp.compress(k, v) for k in _keys(n_keys)])
    mean = outs.mean(0).numpy()
    se = outs.std(0, correction=0).numpy() / np.sqrt(n_keys)
    if qbits is not None:
        step = float(v.abs().max()) / (2 ** (qbits - 1) - 1)
        se = se + step / (2.0 * np.sqrt(n_keys))
    np.testing.assert_array_less(np.abs(mean - v.numpy()), 5.0 * se + 1e-9)


@pytest.mark.parametrize("comp", [C.TopK(0.3), C.Bf16(),
                                  C.Chain((C.TopK(0.3), C.Bf16()))],
                         ids=["topk", "bf16", "topk+bf16"])
def test_biased_compressors_flagged(comp):
    assert not comp.unbiased
    assert not comp.requires_key


def test_unbiased_flags():
    assert C.RandK(0.3).unbiased and C.RandK(0.3).requires_key
    assert C.StochasticQuant(8).unbiased and C.StochasticQuant(8).requires_key
    assert C.Chain((C.RandK(0.5), C.StochasticQuant(8))).unbiased
    assert not C.Chain((C.TopK(0.5), C.StochasticQuant(8))).unbiased
    assert C.Shifted(C.StochasticQuant(8)).unbiased
    assert not C.ErrorFeedback(C.TopK(0.5)).unbiased


def test_topk_per_client_rows():
    """per_client=True keeps exactly round(k*dim) entries in EVERY row; the
    legacy flatten lets clients compete for one top-k."""
    from repro_torch.core.comm import topk_sparsify

    v = _leaf(2, clients=5, dim=50)
    per_row = np.count_nonzero(C.TopK(0.2).compress(None, v).numpy(), axis=1)
    np.testing.assert_array_equal(per_row, 10)
    legacy = C.TopK(0.2, per_client=False).compress(None, v).numpy()
    np.testing.assert_array_equal(legacy, topk_sparsify(v, 0.2).numpy())
    assert np.count_nonzero(legacy) == 50
    assert np.count_nonzero(legacy, axis=1).max() > 10


def test_topk_kept_values_exact():
    v = _leaf(3)
    out = C.TopK(0.4).compress(None, v).numpy()
    nz = out != 0
    np.testing.assert_array_equal(out[nz], v.numpy()[nz])


def test_randk_mask_shared_across_clients():
    """One rand-k mask per round, shared by every client, rescaled n/k."""
    v = _leaf(4, clients=7, dim=30)
    out = C.RandK(0.3).compress(prng.key(5), v).numpy()
    support = out != 0
    for r in range(1, 7):
        np.testing.assert_array_equal(support[r], support[0])
    assert support[0].sum() == 9
    nz = support[0]
    np.testing.assert_allclose(out[:, nz], v.numpy()[:, nz] * (30 / 9))


def test_bits_per_coord_accounting():
    assert C.TopK(0.3).bits_per_coord == pytest.approx(0.3 * 64)
    assert C.RandK(0.25).bits_per_coord == pytest.approx(8.0)
    assert C.StochasticQuant(8).bits_per_coord == 8.0
    assert C.Bf16().bits_per_coord == 16.0
    assert C.Chain((C.TopK(0.3), C.Bf16())).bits_per_coord == pytest.approx(
        0.3 * (16 + 32))
    assert C.Chain((C.RandK(0.5), C.StochasticQuant(8))).bits_per_coord \
        == pytest.approx(4.0)
    assert C.ErrorFeedback(C.TopK(0.3)).bits_per_coord == pytest.approx(
        0.3 * 64)
    assert C.Shifted(C.StochasticQuant(4)).bits_per_coord == 4.0
    assert C.Identity().bits_per_coord == 32.0 and C.Identity().up_frac == 1.0


def test_chain_value_bits_first_narrowest_wins():
    SQ, B = C.StochasticQuant, C.Bf16
    assert C.Chain((SQ(8), B())).value_bits == 8
    assert C.Chain((B(), SQ(8))).value_bits == 8
    assert C.Chain((SQ(8), B())).bits_per_coord == 8.0
    assert C.Chain((C.TopK(0.5), SQ(4), B())).bits_per_coord \
        == pytest.approx(0.5 * (4 + 32))
    assert C.Shifted(C.Chain((SQ(6), B()))).bits_per_coord == 6.0
    assert C.Chain((SQ(8), B())).wire_bits(100) == 800.0


_STAGES = [
    ("topk", "topk:0.3"), ("randk", "randk:0.25"), ("q6", "q6"),
    ("bf16", "bf16"), ("topk+bf16", "topk:0.3+bf16"),
    ("randk+q8", "randk:0.5+q8"), ("randk+topk+q4", "randk:0.5+topk:0.5+q4"),
    ("q8+bf16", "q8+bf16"), ("topk+q12+bf16", "topk:0.7+q12+bf16")]


@pytest.mark.parametrize("spec", [s for _, s in _STAGES],
                         ids=[i for i, _ in _STAGES])
@pytest.mark.parametrize("n", [1, 3, 7, 100, 12345])
def test_chain_wire_bits_is_per_stage_sum(spec, n):
    """``wire_bits(n)`` is the exact per-stage walk, equal to the
    reference's, and within per-stage rounding of the smooth rate."""
    _jax()
    from repro.core.compressors import from_spec as jfrom

    comp = C.from_spec(spec)
    stages = comp.stages if isinstance(comp, C.Chain) else (comp,)
    frac, kept, idx, value = 1.0, float(n), 0.0, None
    for s in stages:
        if s.keep_frac < 1.0:
            frac *= s.keep_frac
            kept = float(max(1, int(round(frac * n))))
        idx += kept * s.index_bits
        if s.value_bits is not None:
            value = (s.value_bits if value is None
                     else min(value, s.value_bits))
    expect = kept * (32.0 if value is None else value) + idx
    assert comp.wire_bits(n) == expect == jfrom(spec).wire_bits(n)
    assert comp.bits_per_coord == jfrom(spec).bits_per_coord
    assert abs(comp.wire_bits(n) - n * comp.bits_per_coord) \
        <= 64.0 * (len(stages) + 1)


def test_omega_and_auto_beta():
    assert C.RandK(0.25).omega == pytest.approx(3.0)
    assert C.StochasticQuant(8).omega == 0.0
    assert C.Chain((C.RandK(0.5), C.RandK(0.5))).omega == pytest.approx(3.0)
    assert C.Shifted(C.RandK(0.5)).step == pytest.approx(0.5)
    assert C.Shifted(C.StochasticQuant(8)).step == 1.0
    assert C.Shifted(C.RandK(0.5), beta=0.1).step == pytest.approx(0.1)


def test_legacy_wrapper_keeps_approx_up_frac_but_reports_true_bits():
    from repro_torch.core.comm import bits_per_coord_of

    t = ErrorFeedbackCompression(k_frac=0.3, quantize=True)
    assert t.up_frac == pytest.approx(0.3)
    assert t.bits_per_coord == pytest.approx(0.3 * (16 + 32))
    algo = with_compression(FedCET(alpha=0.01, c=0.3, tau=2, n_clients=4),
                            k_frac=0.3, quantize=True)
    assert bits_per_coord_of(algo) == pytest.approx(14.4)


def test_engine_bits_per_coord_for_compressor_stacks():
    base = FedCET(alpha=0.01, c=0.3, tau=2, n_clients=4)
    assert base.bits_per_coord == 32.0
    assert with_compression(base, compressor="randk:0.25").bits_per_coord \
        == pytest.approx(8.0)
    b = comm_bits_per_round(with_compression(base, compressor="q8"),
                            n_params=1000, n_clients=4)
    assert b["up_bits"] == 1 * 1000 * 4 * 8
    assert b["down_bits"] == 1 * 1000 * 4 * 32


def test_per_round_keys_distinct_and_deterministic():
    t = MessageCompression(C.RandK(0.5), seed=0)
    msg = {"v": _leaf(6)}
    a, _ = t.apply(msg, None, step=0)
    b, _ = t.apply(msg, None, step=0)
    c, _ = t.apply(msg, None, step=2)
    assert torch.equal(a["v"], b["v"])
    assert not torch.equal(a["v"], c["v"])


def test_key_schedule_domain_separated_from_participation():
    t = MessageCompression(C.RandK(0.5), seed=0)
    v = _leaf(7)
    for step in (0, 2, 4):
        out, _ = t.apply({"v": v}, None, step=step)
        naive = C.RandK(0.5).compress(
            prng.fold_in(prng.fold_in(prng.key(0), step), 0), v)
        assert not torch.equal(out["v"], naive)


def test_stochastic_quant_dither_shared_across_clients():
    row = _leaf(8, clients=1, dim=25)[0]
    out = C.StochasticQuant(8).compress(prng.key(9),
                                        torch.stack([row, row, row]))
    assert torch.equal(out[0], out[1]) and torch.equal(out[0], out[2])


def test_scalar_parameter_leaves_stay_synchronized():
    v = torch.full((6,), 1.7, dtype=torch.float64)
    assert torch.equal(C.RandK(0.5).compress(prng.key(0), v), v)
    q = C.StochasticQuant(8).compress(prng.key(1), v)
    assert len(set(q.tolist())) == 1
    assert torch.equal(C.TopK(0.5).compress(None, v), v)


def test_stateful_wrappers_cannot_nest():
    with pytest.raises(ValueError, match="nest stateful"):
        C.ErrorFeedback(C.Shifted(C.StochasticQuant(8)))
    with pytest.raises(ValueError, match="nest stateful"):
        C.Shifted(C.ErrorFeedback(C.TopK(0.3)))
    with pytest.raises(ValueError, match="AROUND a chain"):
        C.Chain((C.Shifted(C.StochasticQuant(8)), C.Bf16()))


def test_with_compression_guards():
    base = FedCET(alpha=0.01, c=0.3, tau=2, n_clients=4)
    algo = with_compression(base, compressor="shift:bf16")
    assert isinstance(algo.transforms[0].compressor, C.Shifted)
    with pytest.raises(ValueError, match="not both"):
        with_compression(base, k_frac=0.3, compressor="q8")
    with pytest.raises(ValueError, match="nest stateful"):
        with_compression(base, compressor="shift:q8", error_feedback=True)


def test_stacked_transforms_distinct_keys_and_chain_accounting():
    base = FedCET(alpha=0.01, c=0.3, tau=2, n_clients=4)
    algo = with_compression(with_compression(base, compressor="randk:0.5"),
                            compressor="randk:0.5")
    t0, t1 = algo.transforms
    v = {"v": _leaf(11)}
    s0 = t0.apply(v, None, step=0)[0]["v"] != 0
    s1 = t1.apply(v, None, step=0)[0]["v"] != 0
    assert bool((s0 != s1).any())
    stacked = with_compression(with_compression(base, compressor="topk:0.3"),
                               compressor="q8")
    assert stacked.bits_per_coord == pytest.approx(0.3 * (8 + 32))
    assert with_compression(base, compressor="topk:0.3+q8").bits_per_coord \
        == pytest.approx(0.3 * (8 + 32))


def test_empty_prefixed_spec_raises():
    for bad in ("ef:", "shift:", "ef: + "):
        with pytest.raises(ValueError, match="empty compressor spec"):
            C.from_spec(bad)


def test_comm_meter_bits_down_zero_is_honored():
    from repro_torch.core.comm import CommMeter

    m = CommMeter(n_params=10, n_clients=2, bits_up=32.0, bits_down=0.0)
    m.tick(1, 1)
    assert m.bytes_down == 0 and m.bytes_up == 10 * 2 * 4


def test_from_spec_round_trips():
    assert C.from_spec("none") is None and C.from_spec("") is None
    assert C.from_spec("topk:0.3") == C.TopK(0.3, per_client=True)
    assert C.from_spec("topk_global:0.3") == C.TopK(0.3, per_client=False)
    assert C.from_spec("randk:0.25") == C.RandK(0.25)
    assert C.from_spec("quant:4") == C.StochasticQuant(bits=4)
    assert C.from_spec("bf16") == C.Bf16()
    assert C.from_spec("topk:0.3+bf16") == C.Chain((C.TopK(0.3), C.Bf16()))
    assert C.from_spec("ef:topk:0.3") == C.ErrorFeedback(C.TopK(0.3))
    comp = C.RandK(0.5)
    assert C.from_spec(comp) is comp and C.as_compressor("q8") \
        == C.StochasticQuant(8)
    with pytest.raises(ValueError, match="unknown compressor"):
        C.from_spec("zstd:9")
    with pytest.raises(TypeError):
        C.as_compressor(None)


def test_comm_meter_bit_true_mode():
    """The port's meter is the reference's bit-true mode only: ``tick``
    takes no ``up_frac`` (the reference raises on it) and ``for_params``
    no ``itemsize`` (removed there, with a migration hint)."""
    from repro_torch.core.comm import CommMeter

    algo = with_compression(FedCET(alpha=0.01, c=0.3, tau=2, n_clients=3),
                            compressor="randk:0.25")
    params = {"w": torch.zeros((100,))}
    m = CommMeter.for_params(params, algo=algo, n_clients=3)
    m.tick_round(algo)
    assert m.bytes_up == int(1 * 100 * 3 * 8 / 8)
    assert m.bytes_down == int(1 * 100 * 3 * 32 / 8)
    with pytest.raises(TypeError):
        m.tick(1, 1, up_frac=0.5)
    with pytest.raises(TypeError):
        CommMeter.for_params(params, itemsize=2)


def test_fed_scenario_apply():
    from repro_torch.configs.base import FedScenario

    base = FedCET(alpha=0.01, c=0.3, tau=2, n_clients=4)
    assert FedScenario().apply(base) is base
    algo = FedScenario(compression="shift:q8", participation=0.5).apply(base)
    assert algo.sampling.rate == 0.5 and algo.bits_per_coord == 8.0
    assert isinstance(algo.transforms[0].compressor, C.Shifted)
    ef_algo = FedScenario(compression="topk:0.3").apply(base)
    assert isinstance(ef_algo.transforms[0].compressor, C.ErrorFeedback)


def test_per_client_dither_unbiased():
    comp = C.StochasticQuant(bits=8, per_client_dither=True)
    v = _leaf(0)
    n_keys = 4000
    outs = torch.stack([comp.compress(k, v) for k in _keys(n_keys)])
    mean = outs.mean(0).numpy()
    se = outs.std(0, correction=0).numpy() / np.sqrt(n_keys)
    se = se + float(v.abs().max()) / 127 / (2.0 * np.sqrt(n_keys))
    np.testing.assert_array_less(np.abs(mean - v.numpy()), 5.0 * se + 1e-9)


def test_per_client_dither_desynchronizes_clients():
    row = _leaf(7, clients=1)[0]
    v = row[None].expand(6, 40)
    shared = C.StochasticQuant(bits=8).compress(prng.key(8), v)
    assert all(torch.equal(shared[r], shared[0]) for r in range(1, 6))
    per = C.StochasticQuant(bits=8, per_client_dither=True).compress(
        prng.key(8), v)
    assert any(not torch.equal(per[r], per[0]) for r in range(1, 6))
    assert C.StochasticQuant(8, per_client_dither=True).bits_per_coord == 8.0


def test_per_client_dither_spec():
    comp = C.from_spec("pq8")
    assert comp.per_client_dither and comp.bits == 8
    assert C.from_spec("shift:pq4").inner.per_client_dither


def test_natural_quant_outputs_signed_powers_of_two():
    v = _leaf(12)
    out = C.NaturalQuant().compress(prng.key(13), v).numpy()
    nz = out[out != 0]
    exps = np.log2(np.abs(nz))
    np.testing.assert_array_equal(exps, np.round(exps))
    assert np.array_equal(np.sign(out), np.sign(v.numpy()))
    ratio = np.abs(nz) / np.abs(v.numpy()[out != 0])
    assert (ratio >= 0.5 - 1e-12).all() and (ratio <= 2.0 + 1e-12).all()
    z = torch.zeros((3, 5), dtype=torch.float64)
    assert float(C.NaturalQuant().compress(prng.key(0), z).abs().max()) == 0


def test_natural_quant_accounting_and_spec():
    comp = C.NaturalQuant()
    assert comp.bits_per_coord == 9.0 and comp.value_bits == 9.0
    assert comp.omega == pytest.approx(1.0 / 8.0)
    assert comp.unbiased and comp.requires_key
    assert C.from_spec("nat") == C.NaturalQuant()
    shifted = C.from_spec("shift:nat")
    assert shifted.inner == C.NaturalQuant()
    assert shifted.step == pytest.approx(1.0 / 1.125)
    assert C.Chain((C.RandK(0.5), C.NaturalQuant())).bits_per_coord \
        == pytest.approx(4.5)


def test_natural_quant_dither_shared_across_clients():
    row = _leaf(14, clients=1, dim=30)[0]
    out = C.NaturalQuant().compress(prng.key(15), torch.stack([row] * 3))
    assert torch.equal(out[0], out[1]) and torch.equal(out[0], out[2])


def test_pow2_is_exact_over_the_exponent_range():
    """NaturalQuant's power of two (``jnp.ldexp(1, e)`` in the reference)
    is exact from the subnormals to the largest exponent."""
    for dtype, lo, hi in ((torch.float64, -1074, 1023),
                          (torch.float32, -149, 127)):
        e = torch.arange(lo, hi + 1, dtype=dtype)
        got = C._pow2(e, dtype)
        want = torch.tensor([math.ldexp(1.0, int(k)) for k in e.tolist()],
                            dtype=dtype)
        assert torch.equal(got, want), dtype


# ---------------------------------------- mirrors of tests/test_comm.py
def test_remark2_half_communication():
    from repro_torch.core import FedAvg, FedTrack, Scaffold
    from repro_torch.core.api import comm_bytes_per_round

    fedcet = FedCET(alpha=0.01, c=0.4, tau=2, n_clients=10)
    n = 123_457
    b_cet = comm_bytes_per_round(fedcet, n, n_clients=10)
    for other in (Scaffold(alpha_l=0.001, tau=2, n_clients=10),
                  FedTrack(alpha=0.001, tau=2, n_clients=10)):
        assert comm_bytes_per_round(other, n, n_clients=10)["total"] \
            == 2 * b_cet["total"]
    avg = FedAvg(alpha=0.1, tau=2, n_clients=10)
    assert comm_bytes_per_round(avg, n, n_clients=10)["total"] \
        == b_cet["total"]


def test_comm_meter_accumulates():
    from repro_torch.core.comm import CommMeter

    m = CommMeter(n_params=100, n_clients=3)
    m.tick(1, 1)
    m.tick(2, 2)
    assert m.rounds == 2
    assert m.bytes_up == m.bytes_down == (1 + 2) * 100 * 4 * 3


@pytest.mark.parametrize("seed", range(25))
def test_property_topk_sparsify(seed):
    """Top-k keeps >= round(k*size) largest magnitudes, zeros the rest and
    never changes a kept value (the reference's hypothesis property, over
    25 drawn cases)."""
    from repro_torch.core.comm import topk_sparsify

    rng = np.random.default_rng(seed)
    size, k_frac = int(rng.integers(4, 301)), float(rng.uniform(0.05, 1.0))
    a = rng.standard_normal(size)
    out = topk_sparsify(torch.tensor(a), k_frac).numpy()
    nz = np.nonzero(out)[0]
    k = max(1, int(round(k_frac * size)))
    assert len(nz) >= min(k, size - np.sum(a == 0))
    np.testing.assert_array_equal(out[nz], a[nz])
    if len(nz) < size:
        dropped = np.setdiff1d(np.arange(size), nz)
        assert np.all(np.abs(a[dropped]) <= np.min(np.abs(a[nz])) + 1e-12)


@pytest.mark.parametrize("seed", range(20))
def test_property_bf16_quantization_bounded(seed):
    from repro_torch.core.comm import quantize_bf16

    rng = np.random.default_rng(seed)
    a = torch.tensor(rng.standard_normal(int(rng.integers(1, 65))) * 100.0,
                     dtype=torch.float32)
    np.testing.assert_allclose(quantize_bf16(a).numpy(), a.numpy(),
                               rtol=2 ** -8, atol=1e-30)


def test_topk_shape_and_dtype_preserved():
    from repro_torch.core.comm import topk_sparsify

    a = torch.ones((4, 5, 6), dtype=torch.float32)
    out = topk_sparsify(a, 0.5)
    assert out.shape == a.shape and out.dtype == a.dtype


def test_meter_bills_actual_kept_counts_per_leaf():
    from repro_torch.core.comm import CommMeter, message_leaf_bits_of

    params = {"a": torch.zeros((3,)), "b": torch.zeros((10,)),
              "c": torch.zeros((100,))}
    algo = with_compression(FedCET(alpha=0.01, c=0.4, tau=2, n_clients=4),
                            compressor="topk:0.3")
    info = leaf_info_of(params)
    lb = message_leaf_bits_of(algo, info)
    assert lb == [1 * 64.0, 3 * 64.0, 30 * 64.0]
    m = CommMeter.for_params(params, algo=algo, n_clients=4)
    assert m.leaf_bits == tuple(lb)
    assert m.bits_up == pytest.approx(sum(lb) / 113)
    comp = algo.transforms[0].compressor.inner
    for i, (nm, n) in enumerate(info):
        leaf = torch.tensor(np.random.default_rng(i).standard_normal((1, n)))
        actual = int((comp.compress(None, leaf) != 0).sum())
        assert abs(lb[i] / 64.0 - actual) <= 1, (nm, lb[i], actual)


def test_fedlin_is_billed_at_its_own_width_not_per_leaf():
    """FedLin compresses its round-start gradient itself, which per-leaf
    billing cannot see: ``message_leaf_bits`` declines (None) and the meter
    bills ``bits_per_coord``, as the reference's does."""
    _jax()
    from repro.core import FedLin as JFedLin
    from repro.core.comm import CommMeter as JMeter

    from repro_torch.core import FedLin
    from repro_torch.core.comm import CommMeter

    algo = FedLin(alpha=0.01, tau=2, n_clients=4, k_frac=0.3)
    assert algo.message_leaf_bits([("w", 100)]) is None
    m = CommMeter.for_params({"w": torch.zeros((100,))}, algo=algo,
                             n_clients=4)
    j = JMeter.for_params({"w": np.zeros((100,))},
                          algo=JFedLin(alpha=0.01, tau=2, n_clients=4,
                                       k_frac=0.3), n_clients=4)
    assert m.bits_up == j.bits_up == algo.bits_per_coord
    assert m.leaf_bits is None and j.leaf_bits is None
