"""Per-leaf compression plans (``core/compressors.py:CompressionPlan``)
against the JAX package's: mirrors of the 15 tests of
``tests/test_comp_plan.py``, and the plan result of
``results/BENCH_comp_plan.json`` reproduced from the reference's own
reduced fedlm-100m parameters.

The load-bearing contract: a plan mapping EVERY leaf to one spec is
BITWISE equal to uniform ``with_compression`` with that spec (same
``fold_in(key, i)`` per-leaf keys, the same wrapper math leaf by leaf,
the same extras, so checkpoints interchange), on the per-leaf and the
arena lowering. Each plan run is also held to the reference's run of the
same plan within 1e-12, on the reference's composed stack:
participation x compression x a block cohort, and the arena.

Leaf order: trees crossed over from the reference arrive with sorted
keys (JAX's flatten order). A model the port initializes itself
flattens in insertion order, and so does its arena. A digit rule names a
leaf by its index in the reference's order whatever order the tree was
built in: on a port-initialized model every digit plan compresses, and
bills, the leaves the reference's plan names, and the allocator gives
every leaf the reference's width (a tie goes to the lower reference
index). The arena lowering equals the per-leaf one bit for bit there.
"""

import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.checkpoint.ckpt import load_pytree, save_pytree
from repro_torch.core import FedAvg
from repro_torch.core.arena import ArenaLayout, pack, unpack
from repro_torch.core.compressors import (AdaptivePlan, Bf16, Chain,
                                          CompressionPlan, ErrorFeedback,
                                          RandK, Shifted, StochasticQuant,
                                          TopK, parse_plan)
from repro_torch.core.engine import (CohortSpec, run_rounds, with_arena,
                                     with_cohort, with_compression,
                                     with_participation)
from repro_torch.core.fedcet import FedCET
from repro_torch.data.quadratic import QuadraticProblem
from repro_torch.utils.tree import tree_leaves, tree_map

N, M, TAU, ROUNDS = 24, 7, 2, 4
SPLIT = 5  # params live as a 2-leaf dict so per-leaf rules mean something
TOL = 1e-12
ROOT = Path(__file__).resolve().parents[1]


def _jax():
    import jax

    jax.config.update("jax_enable_x64", True)
    return jax


def _jprob():
    _jax()
    from repro.data.quadratic import make_hetero_hessian_problem

    return make_hetero_hessian_problem(0, n_clients=N, dim=12,
                                       n_measurements=4)


JPROB = _jprob()
PROB = QuadraticProblem(b=torch.tensor(np.asarray(JPROB.b)),
                        m=torch.tensor(np.asarray(JPROB.m)))


def _loss(params, batch):
    return PROB.client_loss(torch.cat([params["head"], params["tail"]]),
                            batch)


GRAD = torch.func.grad(_loss)
BATCHES = PROB.stacked_batches(TAU)
FIRST = tree_map(lambda b: b[0], BATCHES)
PARAMS0 = {"head": torch.zeros((SPLIT,), dtype=PROB.b.dtype),
           "tail": torch.zeros((PROB.dim - SPLIT,), dtype=PROB.b.dtype)}


def _algos(pkg=None):
    if pkg is None:
        return {"fedcet": FedCET(alpha=0.02, c=0.3, tau=TAU, n_clients=N),
                "fedavg": FedAvg(alpha=0.05, tau=TAU, n_clients=N)}
    return {"fedcet": pkg.FedCET(alpha=0.02, c=0.3, tau=TAU, n_clients=N),
            "fedavg": pkg.FedAvg(alpha=0.05, tau=TAU, n_clients=N)}


def _composed(algo, compressor, pkg=None):
    """Participation x compression x a block cohort of ``M``, the
    reference's composed stack."""
    wp = with_participation if pkg is None else pkg.with_participation
    wc = with_compression if pkg is None else pkg.with_compression
    wco = with_cohort if pkg is None else pkg.with_cohort
    spec = (CohortSpec if pkg is None else pkg.CohortSpec)(size=M,
                                                           selector="block")
    return wco(wc(wp(algo, 0.8, seed=3), compressor=compressor, seed=5),
               spec, seed=7)


def _run(algo, rounds=ROUNDS, state=None):
    if state is None:
        state = algo.init(GRAD, PARAMS0, FIRST)
    return run_rounds(algo, GRAD, state, BATCHES, rounds=rounds)[0]


def _jrun(algo, rounds=ROUNDS):
    """The reference's run of ``algo`` on the same problem and params."""
    jax = _jax()
    import jax.numpy as jnp
    from repro.core import run_rounds as jrun_rounds

    def loss(params, batch):
        return JPROB.client_loss(
            jnp.concatenate([params["head"], params["tail"]]), batch)

    grad = jax.grad(loss)
    batches = JPROB.stacked_batches(TAU)
    first = jax.tree.map(lambda b: b[0], batches)
    p0 = {k: jnp.asarray(v.numpy()) for k, v in PARAMS0.items()}
    state = algo.init(grad, p0, first)
    return jrun_rounds(algo, grad, state, batches, rounds=rounds)[0]


def _leaves(state):
    out = []
    for leaf in tree_leaves(state):
        if isinstance(leaf, torch.Tensor):
            out.append(leaf)
        elif hasattr(leaf, "data") and isinstance(leaf.data, torch.Tensor):
            out.append(leaf.data)
    return out


def _assert_bitwise(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb) and la
    for x, y in zip(la, lb):
        assert torch.equal(x, y)


def _assert_matches_jax(got, want):
    jax = _jax()
    wl = [np.asarray(w) for w in jax.tree.leaves(want)
          if np.ndim(w) > 0]
    gl = [g for g in _leaves(got) if g.dim() > 0]
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        np.testing.assert_allclose(g.numpy().reshape(w.shape), w, rtol=0,
                                   atol=TOL)


# ------------------------------------------------------------ parse grammar
def test_parse_plan_grammar():
    p = parse_plan("embed*:q12,ln*:bf16,*:shift:q6")
    assert isinstance(p, CompressionPlan) and len(p.rules) == 3
    pat0, c0 = p.rules[0]
    assert pat0 == "embed*" and c0 == StochasticQuant(12)  # unbiased: bare
    pat1, c1 = p.rules[1]
    assert pat1 == "ln*" and isinstance(c1, ErrorFeedback)  # biased: auto-EF
    assert isinstance(c1.inner, Bf16)
    pat2, c2 = p.rules[2]
    assert pat2 == "*" and isinstance(c2, Shifted)
    assert c2.inner == StochasticQuant(6)


def test_parse_plan_none_and_passthrough():
    for spec in (None, "", "none", "off", "  NONE  "):
        assert parse_plan(spec) is None
    p = CompressionPlan(rules=(("*", StochasticQuant(8)),))
    assert parse_plan(p) is p
    q = parse_plan("ln*:none,*:q8")
    assert q.rules[0] == ("ln*", None)
    bare = parse_plan("*:topk:0.3", error_feedback=False)
    assert bare.rules[0][1] == TopK(0.3)


def test_parse_plan_rejects_bad_rules():
    with pytest.raises(ValueError, match="bad plan rule"):
        parse_plan("justapattern")
    with pytest.raises(ValueError, match="bad plan rule"):
        parse_plan("embed*:")
    with pytest.raises(ValueError):
        parse_plan("*:bogus")
    with pytest.raises(TypeError, match="not a compression plan"):
        parse_plan(123)


# --------------------------------------------------------------- resolution
def test_resolution_first_match_wins_and_digit_index():
    plan = CompressionPlan(rules=(("0", TopK(0.5)),
                                  ("w*", StochasticQuant(8)),
                                  ("*", StochasticQuant(4))),
                           default=Bf16())
    assert plan.resolve(0, "zzz") == TopK(0.5)
    assert plan.resolve(1, "weight") == StochasticQuant(8)
    assert plan.resolve(2, "layers/0/wq") == StochasticQuant(8)
    assert plan.resolve(3, "bias") == StochasticQuant(4)
    short = CompressionPlan(rules=(("w*", StochasticQuant(8)),),
                            default=Bf16())
    assert isinstance(short.resolve(0, "bias"), Bf16)
    assert CompressionPlan(rules=(("w*", TopK(0.5)),)).resolve(0, "b") is None


def test_plans_cannot_nest_and_default_must_be_stateless():
    inner = CompressionPlan(rules=(("*", StochasticQuant(8)),))
    with pytest.raises(ValueError, match="nest"):
        CompressionPlan(rules=(("*", inner),))
    with pytest.raises(ValueError, match="default"):
        CompressionPlan(default=Shifted(StochasticQuant(8)))


# --------------------------------------- bitwise equivalence vs uniform path
@pytest.mark.parametrize("name", ["fedcet", "fedavg"])
@pytest.mark.parametrize("spec", ["shift:q8", "q8", "topk:0.3",
                                  "randk:0.5+q8", "ef:topk:0.3+bf16"])
def test_uniform_plan_bitwise_equiv_bare(name, spec):
    """A '*:<spec>' plan IS uniform with_compression(<spec>), bitwise; and
    it runs as the reference's plan does, within 1e-12."""
    import repro.core as jc
    from repro.core.compressors import parse_plan as jparse

    uni = with_compression(_algos()[name], compressor=spec, seed=5)
    pln = with_compression(_algos()[name], compressor=parse_plan(f"*:{spec}"),
                           seed=5)
    got = _run(pln)
    _assert_bitwise(got, _run(uni))
    jpln = jc.with_compression(_algos(jc)[name],
                               compressor=jparse(f"*:{spec}"), seed=5)
    _assert_matches_jax(got, _jrun(jpln))


@pytest.mark.parametrize("name", ["fedcet", "fedavg"])
def test_uniform_plan_bitwise_equiv_composed(name):
    """Same under participation x compression, per leaf AND on the arena.
    On the arena the uniform ``shift:q8`` FedCET would take the fused
    round tail, a plan never does: bitwise against the uniform generic
    seam (``use_fused_kernel=False``), within 1e-12 against the fused
    tail."""
    import dataclasses

    uni = _composed(_algos()[name], "shift:q8")
    pln = _composed(_algos()[name], parse_plan("*:shift:q8"))
    got = _run(pln)
    _assert_bitwise(got, _run(uni))
    got_a = _run(with_arena(pln))
    if name == "fedcet":
        fused = _run(with_arena(uni))
        for a, b in zip(_leaves(got_a), _leaves(fused)):
            assert float((a - b).abs().max()) <= TOL
        uni = dataclasses.replace(uni, use_fused_kernel=False)
    _assert_bitwise(got_a, _run(with_arena(uni)))
    import repro.core as jc
    from repro.core.compressors import parse_plan as jparse

    _assert_matches_jax(got, _jrun(_composed(_algos(jc)[name],
                                             jparse("*:shift:q8"), jc)))


def test_checkpoint_interchange_plan_uniform(tmp_path):
    """A mid-run checkpoint of the uniform stack restores into the plan
    stack (and back) and continues bitwise alike."""
    uni = with_compression(_algos()["fedcet"], compressor="shift:q8", seed=5)
    pln = with_compression(_algos()["fedcet"],
                           compressor=parse_plan("*:shift:q8"), seed=5)
    mid_u = _run(uni, rounds=2)
    path = str(tmp_path / "mid.npz")
    save_pytree(path, mid_u)
    mid_p = load_pytree(path, _run(pln, rounds=2))
    _assert_bitwise(mid_p, mid_u)
    _assert_bitwise(_run(pln, state=mid_p, rounds=2),
                    _run(uni, state=mid_u, rounds=2))
    save_pytree(path, mid_p)
    back = load_pytree(path, mid_u)
    _assert_bitwise(_run(uni, state=back, rounds=2),
                    _run(pln, state=mid_p, rounds=2))


def test_mixed_plan_runs_and_bills_per_leaf():
    from repro.core import CommMeter as JMeter
    from repro.core import with_compression as jwc
    from repro.core.compressors import parse_plan as jparse
    from repro.core.fedcet import FedCET as JFedCET

    from repro_torch.core.comm import CommMeter, leaf_info_of

    plan = parse_plan("head:shift:q4,*:shift:q8")
    algo = with_compression(_algos()["fedcet"], compressor=plan, seed=5)
    final = _run(algo)
    assert all(bool(torch.isfinite(t).all()) for t in _leaves(final))
    info = leaf_info_of(PARAMS0)
    want = (SPLIT * 4.0, (PROB.dim - SPLIT) * 8.0)
    assert [plan.leaf_wire_bits(i, nm, n)
            for i, (nm, n) in enumerate(info)] == list(want)
    meter = CommMeter.for_params(PARAMS0, algo=algo, n_clients=N)
    assert meter.leaf_bits == want
    assert meter.bits_up == pytest.approx(sum(want) / PROB.dim)
    jalgo = jwc(JFedCET(alpha=0.02, c=0.3, tau=TAU, n_clients=N),
                compressor=jparse("head:shift:q4,*:shift:q8"), seed=5)
    jm = JMeter.for_params({k: np.zeros(v.shape) for k, v in PARAMS0.items()},
                           algo=jalgo, n_clients=N)
    assert (meter.bits_up, meter.leaf_bits) == (jm.bits_up, jm.leaf_bits)
    assert algo.bits_per_coord == jalgo.bits_per_coord
    _assert_matches_jax(final, _jrun(jalgo))


def test_scenario_knob_and_conflict():
    from repro_torch.configs.base import FedScenario

    sc = FedScenario(compression_plan="head:q4,*:shift:q8")
    algo = sc.apply(_algos()["fedcet"])
    assert all(bool(torch.isfinite(t).all()) for t in _leaves(_run(algo)))
    with pytest.raises(ValueError, match="not both"):
        FedScenario(compression="q8",
                    compression_plan="*:q4").apply(_algos()["fedcet"])


# ---------------------------------------------------------------- allocator
def _toy_params(seed):
    """The reference's ``_toy_params(jax.random.key(seed))`` as numpy."""
    jax = _jax()
    ks = jax.random.split(jax.random.key(seed), 3)
    return {"big": np.asarray(jax.random.normal(ks[0], (4096,)) * 0.02),
            "hot": np.asarray(jax.random.normal(ks[1], (256,)) * 2.0),
            "cold": np.asarray(jax.random.normal(ks[2], (256,)) * 0.001)}


def _torch(tree):
    """Numpy leaves as tensors, keys sorted (JAX's flatten order)."""
    return {k: torch.tensor(tree[k]) for k in sorted(tree)}


def test_allocator_respects_budget_and_weights_sensitivity():
    from repro.core.compressors import CompressionPlan as JPlan

    from repro_torch.core.comm import leaf_info_of

    npp = _toy_params(0)
    params = _torch(npp)
    info = leaf_info_of(params)
    n_total = sum(n for _, n in info)
    budget = 3.0 * n_total
    plan = CompressionPlan().allocate(budget, leaves=params,
                                      sensitivity="rms", wrap="shift",
                                      max_bits=16)
    bits = {nm: plan.leaf_wire_bits(i, nm, n) / n
            for i, (nm, n) in enumerate(info)}
    assert sum(plan.tree_wire_bits(info)) <= budget + 1e-9
    assert bits["hot"] > bits["cold"] and bits["hot"] > bits["big"]
    assert plan.leaves == tuple(info)
    assert plan.bits_per_coord <= 3.0 + 1e-12
    pa = CompressionPlan().allocate(budget, leaves=params,
                                    sensitivity="absmax", wrap="shift",
                                    max_bits=16)
    ba = {nm: pa.leaf_wire_bits(i, nm, n) / n
          for i, (nm, n) in enumerate(info)}
    assert ba["hot"] > ba["cold"]
    # the same allocation as the reference's on the same leaves
    for sens, got in (("rms", plan), ("absmax", pa)):
        want = JPlan().allocate(budget, leaves=npp, sensitivity=sens,
                                wrap="shift", max_bits=16)
        assert [(p, c.inner.bits) for p, c in got.rules] \
            == [(p, c.inner.bits) for p, c in want.rules]


def test_allocator_below_floor_falls_back_to_randk():
    from repro_torch.core.comm import leaf_info_of

    params = _torch(_toy_params(1))
    info = leaf_info_of(params)
    n_total = sum(n for _, n in info)
    plan = CompressionPlan().allocate(0.5 * n_total, leaves=params,
                                      sensitivity=None, wrap=None)
    assert len(plan.rules) == len(info)
    ks = set()
    for (pat, comp), (nm, _) in zip(plan.rules, info):
        assert pat == nm and isinstance(comp, Chain)
        assert isinstance(comp.stages[0], RandK)
        assert isinstance(comp.stages[1], StochasticQuant)
        ks.add(comp.stages[0].k_frac)
    assert len(ks) == 1
    assert sum(plan.tree_wire_bits(info)) <= 0.5 * n_total * 1.001


def test_allocator_validates_inputs():
    params = _torch(_toy_params(2))
    with pytest.raises(ValueError, match="sensitivity"):
        CompressionPlan().allocate(1e4, leaves=params, sensitivity="bogus")
    with pytest.raises(ValueError, match="entries"):
        CompressionPlan().allocate(1e4, leaves=params,
                                   sensitivity=[1.0, 2.0])
    with pytest.raises(ValueError, match="rms"):
        CompressionPlan().allocate(1e4, leaves=[("a", 100)],
                                   sensitivity="rms")
    with pytest.raises(ValueError, match="grads"):
        CompressionPlan().allocate(1e4, leaves=params,
                                   sensitivity="grad_norm")
    g = CompressionPlan().allocate(1e5, leaves=params,
                                   sensitivity="grad_norm", grads=params)
    assert g.leaves is not None


# ------------------------------------------------------------ adaptive plan
def test_tightened_preserves_wrappers_and_floors():
    plan = CompressionPlan(rules=(
        ("a", Shifted(StochasticQuant(8))),
        ("b", ErrorFeedback(TopK(0.5))),
        ("c", Chain((RandK(0.5), StochasticQuant(2))))))
    t = plan.tightened()
    a, b, c = (c for _, c in t.rules)
    assert isinstance(a, Shifted) and a.inner == StochasticQuant(7)
    assert isinstance(b, ErrorFeedback) and b.inner == TopK(0.25)
    assert c.stages[0] == RandK(0.25)
    assert c.stages[1] == StochasticQuant(2)
    assert t.stateful == plan.stateful


def test_adaptive_plan_tightens_on_residual_shrink():
    plan = CompressionPlan(rules=(("*", Shifted(StochasticQuant(8))),))
    sched = AdaptivePlan(plan=plan, factor=10.0)
    assert sched.update(1.0) is None
    assert sched.update(0.5) is None
    new = sched.update(0.05)
    assert new is not None
    assert new.rules[0][1].inner == StochasticQuant(7)
    assert sched.update(float("nan")) is None
    assert sched.update(0.0) is None


# ------------------------------------------- the port's own leaf order
_TINY = dict(d_model=32, n_heads=2, n_kv_heads=2, head_dim=16, d_ff=64,
             vocab_size=96)


def _tiny_lm():
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = dataclasses.replace(get_config("fedlm-100m").reduced(),
                              **_TINY).with_dtype("float64")
    model = build_model(cfg)
    return model, model.init(torch.Generator().manual_seed(0))


PORT_PLAN = "0:q4,ln*:bf16,3:ef:topk:0.3,*:shift:q6"


def test_plan_on_a_port_initialized_model_packs_and_unpacks_alike():
    """The port's own init flattens in insertion order (``embed`` first,
    ``lm_head`` last), not JAX's sorted order, and so does the arena's
    layout. Digit rules resolve by the reference's leaf index in both
    lowerings (the arena unpacks to the same tree), so the plan's arena
    lowering equals its per-leaf lowering bit for bit, for the message
    and the memory."""
    from repro_torch.core import prng
    from repro_torch.core.comm import leaf_info_of

    _, params = _tiny_lm()
    info = leaf_info_of(params)
    assert info[0][0] == "embed" and info[-1][0] == "lm_head"
    plan = parse_plan(PORT_PLAN)
    rng = np.random.default_rng(0)
    msg = tree_map(lambda p: torch.tensor(rng.standard_normal(
        (3,) + tuple(p.shape))), params)
    mem = plan.init_extra(msg)
    mem = tree_map(lambda e: e + torch.tensor(rng.standard_normal(e.shape)),
                   mem)
    key = prng.key(11)
    out, new_mem = plan.apply(key, msg, mem)
    lo = ArenaLayout.for_tree(params)
    out_a, mem_a = plan.apply(key, pack(msg, lo), pack(mem, lo))
    for a, b in zip(tree_leaves(unpack(out_a)), tree_leaves(out)):
        assert torch.equal(a, b)
    for a, b in zip(tree_leaves(unpack(mem_a)), tree_leaves(new_mem)):
        assert torch.equal(a, b)
    assert not torch.equal(tree_leaves(out)[0], tree_leaves(msg)[0])


DIGIT_PLANS = ["7:bf16,*:shift:q6", "1:bf16,3:ef:topk:0.3,*:shift:q6",
               PORT_PLAN]


def _spec_of(comp) -> str:
    """A compressor's fields as text, either package's (the kernel switch,
    which the reference's CPU tests leave off, dropped)."""
    return re.sub(r"use_kernel=\w+, ", "", repr(comp))


def _by_name(info, values):
    return dict(zip((nm for nm, _ in info), values))


@pytest.mark.parametrize("spec", DIGIT_PLANS)
def test_digit_rules_name_the_reference_leaves_on_a_port_model(spec):
    """On the port-initialized tiny LM (dicts in insertion order), a plan
    with digit rules resolves, compresses and bills every leaf as the
    reference's plan does on the same values (its dicts sorted): the same
    compressor per leaf name, the same codes and memories within 1e-12,
    and the same bits per leaf through the plan, the engine's per-leaf
    billing and a bound plan's ``bits_per_coord``."""
    jax = _jax()
    from repro.core.comm import leaf_info_of as jinfo_of
    from repro.core.comm import message_leaf_bits_of as jbits_of
    from repro.core.compressors import parse_plan as jparse
    from repro.core.engine import with_compression as jwith
    from repro.core.fedcet import FedCET as JFedCET
    from torch.utils import _pytree as pytree

    from repro_torch.core import prng
    from repro_torch.core.comm import leaf_info_of, message_leaf_bits_of

    _, params = _tiny_lm()
    info = leaf_info_of(params)
    as_np = lambda t: pytree.tree_map(lambda a: a.numpy(), t)  # noqa: E731
    jparams = as_np(params)
    jinfo = jinfo_of(jparams)
    assert [nm for nm, _ in info] != [nm for nm, _ in jinfo]  # unsorted
    plan, jplan = parse_plan(spec), jparse(spec)
    assert _by_name(info, plan.tree_wire_bits(info)) \
        == _by_name(jinfo, jplan.tree_wire_bits(jinfo))
    assert plan.bind(info).bits_per_coord == jplan.bind(jinfo).bits_per_coord
    algo = with_compression(FedCET(alpha=1e-2, c=0.1, tau=TAU, n_clients=3),
                            compressor=plan)
    jalgo = jwith(JFedCET(alpha=1e-2, c=0.1, tau=TAU, n_clients=3),
                  compressor=jplan)
    assert _by_name(info, message_leaf_bits_of(algo, info)) \
        == _by_name(jinfo, jbits_of(jalgo, jinfo))

    rng = np.random.default_rng(0)
    msg = tree_map(lambda p: torch.tensor(rng.standard_normal(
        (3,) + tuple(p.shape))), params)
    mem = plan.init_extra(msg)
    if mem is not None:
        mem = tree_map(lambda e: e + torch.tensor(
            rng.standard_normal(e.shape)), mem)
    out, new_mem = plan.apply(prng.key(11), msg, mem)
    want, want_mem = jplan.apply(jax.random.key(11), as_np(msg),
                                 None if mem is None else as_np(mem))
    for got_t, want_t in ((out, want), (new_mem, want_mem)):
        if got_t is None:
            assert want_t is None
            continue
        got_n = _by_name(info, tree_leaves(got_t))
        want_n = _by_name(jinfo, jax.tree.leaves(want_t))
        assert got_n.keys() == want_n.keys()
        for nm, g in got_n.items():
            np.testing.assert_allclose(g.numpy(), np.asarray(want_n[nm]),
                                       rtol=0, atol=TOL, err_msg=nm)
    comps = _by_name(info, [_spec_of(plan.resolve(j, nm)) for j, (nm, _)
                            in zip(info.ref_index, info)])
    assert comps == {nm: _spec_of(jplan.resolve(i, nm))
                     for i, (nm, _) in enumerate(jinfo)}


@pytest.mark.parametrize("budget", [3.3, 4.7, "sequence"])
def test_allocator_gives_each_leaf_the_reference_width(budget):
    """``allocate`` on the port-initialized tiny LM gives every leaf name
    the reference's width: uniform sensitivity at 3.3 and 4.7 bits a
    coordinate (every leaf ties; the last partial round of bits goes by
    the reference's index), and an explicit per-leaf sequence, read in the
    reference's flatten order, at 3.3."""
    _jax()
    from repro.core.comm import leaf_info_of as jinfo_of
    from repro.core.compressors import CompressionPlan as JPlan
    from torch.utils import _pytree as pytree

    from repro_torch.core.comm import leaf_info_of

    _, params = _tiny_lm()
    jparams = pytree.tree_map(lambda a: a.numpy(), params)
    info, jinfo = leaf_info_of(params), jinfo_of(jparams)
    n_total = sum(n for _, n in info)
    sens = None
    if budget == "sequence":  # one weight a leaf, in the reference's order
        sens, budget = [1.0 + (i % 3) for i in range(len(info))], 3.3
    kw = dict(sensitivity=sens, wrap="shift", min_bits=2, max_bits=12)
    plan = CompressionPlan().allocate(budget * n_total, leaves=params, **kw)
    want = JPlan().allocate(budget * n_total, leaves=jparams, **kw)
    width = lambda p: {nm: c.inner.bits for nm, c in p.rules}  # noqa: E731
    assert width(plan) == width(want)
    assert [nm for nm, _ in plan.rules] == [nm for nm, _ in want.rules]
    assert len(set(width(plan).values())) > 1  # the budget splits widths
    assert sum(plan.tree_wire_bits(info)) == sum(want.tree_wire_bits(jinfo))
    assert plan.bits_per_coord == want.bits_per_coord


def test_plan_rounds_take_the_generic_seam_on_the_arena(monkeypatch):
    """FedCET on the arena under a plan never takes the fused round tail
    (a plan is not ``Shifted(StochasticQuant)``), and two rounds of the
    tiny LM end bitwise equal on both lowerings."""
    from repro_torch.core.arena import adapt_state
    from repro_torch.kernels import ops

    def fused(*a, **k):
        raise AssertionError("the fused round tail ran under a plan")

    monkeypatch.setattr(ops, "fedcet_round_tail", fused)
    model, params = _tiny_lm()
    algo = with_compression(FedCET(alpha=3e-3, c=0.05, tau=TAU, n_clients=3),
                            compressor=parse_plan(PORT_PLAN), seed=5)
    grad_fn = torch.func.grad(model.loss)
    toks = torch.tensor(np.random.default_rng(1).integers(
        0, _TINY["vocab_size"], (TAU, 3, 1, 8)))
    runs = []
    for a in (algo, with_arena(algo)):
        s = a.init(grad_fn, params, {"tokens": toks[0]})
        runs.append(run_rounds(a, grad_fn, s, {"tokens": toks}, rounds=2)[0])
    _assert_bitwise(adapt_state(runs[1], runs[0]), runs[0])


# ------------------------------- results/BENCH_comp_plan.json, reproduced
#: ``results/BENCH_comp_plan.json`` was measured with float32 defaults and
#: jax's older threefry mode (``jax_threefry_partitionable`` off, the
#: default before jax 0.5): with both, the reference reproduces its rules
#: and its 0.8531 exactly. With the newer mode its seed-0 init draws other
#: weights (0.8608 then). The port's own dithers (``core/prng.py``) are
#: the newer mode's, which moves the ratio by ~3e-4 (relative).
BENCH_ENV = {"jax_enable_x64": False, "jax_threefry_partitionable": False}


class _bench_env:
    """The reference's JAX settings of the committed benchmark run,
    restored on exit (the test process runs with x64 on)."""

    def __enter__(self):
        jax = _jax()
        self.saved = {k: getattr(jax.config, k) for k in BENCH_ENV}
        for k, v in BENCH_ENV.items():
            jax.config.update(k, v)
        return jax

    def __exit__(self, *exc):
        jax = _jax()
        for k, v in self.saved.items():
            jax.config.update(k, v)


def _bench_params(full: bool = False):
    """The reference's fedlm-100m parameters at seed 0 (reduced unless
    ``full``) in the benchmark's settings, as numpy and as the port's
    tensors (sorted keys; at full width the tensors share the numpy
    buffers, 428 MB of them)."""
    from torch.utils import _pytree as pytree

    from repro.configs import get_config as jget
    from repro.models import build_model as jbuild

    from repro_torch.models.convert import params_from_numpy

    cfg = jget("fedlm-100m")
    if not full:
        cfg = cfg.reduced()
    with _bench_env() as jax:
        npp = jax.tree.map(lambda a: np.array(a),
                           jbuild(cfg).init(jax.random.key(0)))
    if full:
        return npp, pytree.tree_map(torch.from_numpy, npp)
    return npp, params_from_numpy(npp)


def _head_to_head(plan, params):
    """The port's ``benchmarks/comp_plan_bench.py:quant_error_head_to_head``
    (bare quantizers: round one, zero shift memory), from key 7."""
    from repro_torch.core import prng
    from repro_torch.core.comm import leaf_info_of

    def strip(c):
        return c.inner if isinstance(c, (ErrorFeedback, Shifted)) else c

    key = prng.key(7)
    flat = tree_leaves(params)
    names = [nm for nm, _ in leaf_info_of(params)]

    def tree_mse(comp_for_leaf):
        num = den = 0.0
        for i, leaf in enumerate(flat):
            comp = comp_for_leaf(i)
            sub = prng.fold_in(key, i)
            q = leaf if comp is None else comp.compress(
                sub if comp.requires_key else None, leaf[None])[0]
            num += float(torch.sum(torch.square(q - leaf)))
            den += float(torch.sum(torch.square(leaf)))
        return num / den

    q8 = StochasticQuant(8)
    uni = tree_mse(lambda i: q8)
    pln = tree_mse(lambda i: strip(plan.resolve(i, names[i])))
    return uni, pln


def _bench_plan(params, n_clients):
    from repro_torch.core.comm import leaf_info_of, message_leaf_bits_of

    info = leaf_info_of(params)
    uniform = with_compression(
        FedCET(alpha=3e-3, c=0.05, tau=TAU, n_clients=n_clients),
        compressor="shift:q8", seed=0)
    budget = float(sum(message_leaf_bits_of(uniform, info)))
    plan = CompressionPlan().allocate(budget, leaves=params,
                                      sensitivity="absmax", wrap="shift",
                                      min_bits=2, max_bits=14)
    return info, budget, plan, float(sum(plan.tree_wire_bits(info)))


def _jax_bench(npp, n_clients):
    """The reference's own budget, plan and head-to-head on ``npp``, in
    the benchmark's settings."""
    import sys

    from repro.core import (CompressionPlan as JPlan, FedCET as JFedCET,
                            leaf_info_of as jinfo,
                            message_leaf_bits_of as jbits,
                            with_compression as jwc)

    sys.path.insert(0, str(ROOT))
    try:
        from benchmarks.comp_plan_bench import quant_error_head_to_head
    finally:
        sys.path.remove(str(ROOT))
    with _bench_env():
        info = jinfo(npp)
        budget = float(sum(jbits(jwc(JFedCET(alpha=3e-3, c=0.05, tau=TAU,
                                             n_clients=n_clients),
                                     compressor="shift:q8", seed=0), info)))
        plan = JPlan().allocate(budget, leaves=npp, sensitivity="absmax",
                                wrap="shift", min_bits=2, max_bits=14)
        mse = quant_error_head_to_head(plan, npp)
    return budget, plan, mse


def test_reproduces_bench_comp_plan():
    """Reduced fedlm-100m, 8 clients, seed 0, ``absmax``, ``shift``: the
    allocated rules are the committed ones (and the reference's), the bits
    exactly 12,585,472 against uniform ``shift:q8``'s 12,593,152, and the
    quantization MSE ratio within 1e-3 (relative) of the committed
    0.8531 (and of the reference's ratio recomputed here)."""
    bench = json.loads((ROOT / "results" / "BENCH_comp_plan.json").read_text())
    npp, params = _bench_params()
    info, budget, plan, plan_bits = _bench_plan(params, n_clients=8)
    assert (budget, plan_bits) == (12_593_152.0, 12_585_472.0)
    assert (budget, plan_bits) == (bench["bits"]["uniform_q8"],
                                   bench["bits"]["plan"])
    rules = [(p, c.inner.bits) for p, c in plan.rules]
    assert rules == [(p, int(r.split("bits=")[1].split(",")[0]))
                     for p, r in bench["plan_rules"]]
    jbudget, jplan, jmse = _jax_bench(npp, n_clients=8)
    assert jbudget == budget
    assert rules == [(p, c.inner.bits) for p, c in jplan.rules]
    uni, pln = _head_to_head(plan, params)
    want = bench["quant_mse"]["mse_ratio"]
    assert abs(jmse["mse_ratio"] - want) <= 1e-6 * want
    assert abs(pln / uni - want) <= 1e-3 * want, (pln / uni, want)
    assert abs(uni - bench["quant_mse"]["mse_uniform_q8"]) \
        <= 1e-3 * bench["quant_mse"]["mse_uniform_q8"]


#: the reference's head-to-head at FULL width (fedlm-100m, 14 stacked
#: layers, 12 leaves, 4 clients), on its own seed-0 parameters in the
#: benchmark's settings, as ``test_full_width_head_to_head`` computes it:
#: the plan does NOT beat uniform q8 there (at this leaf granularity the
#: greedy fill lifts the attention matrices to 9-10 bits and drops embed
#: and lm_head to 7). ``chip_smoke.py``'s ``plans`` check holds the card's
#: full-width ratio to at most this value.
FULL_WIDTH_RATIO = 1.0354588721039204


def test_full_width_head_to_head():
    """At full width the port allocates the reference's rules on the
    reference's parameters, within the same budget, and the reference's
    head-to-head ratio there is ``FULL_WIDTH_RATIO``, above 1. (The port's
    own full-width head-to-head runs on the card, in ``chip_smoke.py``: its
    eager threefry over 107M coordinates is too slow for this CPU test.)"""
    npp, params = _bench_params(full=True)
    info, budget, plan, plan_bits = _bench_plan(params, n_clients=4)
    jbudget, jplan, jmse = _jax_bench(npp, n_clients=4)
    assert budget == jbudget and plan_bits <= budget
    assert [(p, c.inner.bits) for p, c in plan.rules] \
        == [(p, c.inner.bits) for p, c in jplan.rules]
    assert abs(jmse["mse_ratio"] - FULL_WIDTH_RATIO) <= 1e-6
    assert FULL_WIDTH_RATIO > 1.0
