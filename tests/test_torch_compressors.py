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

import numpy as np
import pytest
import torch

from repro_torch.core import compressors as C
from repro_torch.core import prng
from repro_torch.core.arena import Arena, pack, unpack
from repro_torch.core.comm import comm_bits_per_round, leaf_info_of
from repro_torch.core.engine import (MessageCompression, with_compression,
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
    with pytest.raises(NotImplementedError, match="not yet ported"):
        C.from_spec(spec)


@pytest.mark.parametrize("spec", ["zz8", "shift:", ""])
def test_from_spec_rejects_bad_specs(spec):
    if spec == "":
        assert C.from_spec(spec) is None
        return
    with pytest.raises(ValueError):
        C.from_spec(spec)


def test_legacy_and_error_feedback_forms_raise():
    base = FedCET(alpha=0.1, c=0.2, tau=2, n_clients=4)
    assert with_compression(base) is base  # identity: exact no-op
    with pytest.raises(NotImplementedError, match="not yet ported"):
        with_compression(base, k_frac=0.5)
    with pytest.raises(NotImplementedError, match="not yet ported"):
        with_compression(base, compressor="q8", error_feedback=True)
    with pytest.raises(ValueError, match="EITHER"):
        with_compression(base, compressor="q8", quantize=True)


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


def _problem():
    _jax()
    from repro.data.quadratic import make_quadratic_problem

    from repro_torch.data.quadratic import QuadraticProblem

    jp = make_quadratic_problem(0)
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
