"""The port's packed parameter arena (``core/arena.py``), mirroring
``tests/test_arena.py:96-186``: bitwise pack/unpack round-trips, zero pads,
row segments, rejected trees, the arena as one pytree leaf; then the
compressed, sampled FedCET round on the hetero-Hessian quadratic in
float64:

(a) the port against the JAX package for ``shift:q8`` x 0.8 participation,
    per leaf and on the arena, fused and unfused: the same state after 4
    rounds within 1e-12 (the bitwise PRNG makes this comparison possible:
    both draw the same masks and dithers);
(b) within the port: arena == per-leaf and fused == generic, within 1e-12,
    bare and masked.

The problem's arrays come from the JAX package and cross through numpy.
"""

import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from repro_torch.core.arena import (LANES, Arena, ArenaLayout, adapt_state,
                                    pack, unpack)
from repro_torch.core.engine import (run_rounds, with_arena, with_compression,
                                     with_participation)
from repro_torch.core.fedcet import FedCET
from repro_torch.data.quadratic import QuadraticProblem
from repro_torch.utils.tree import tree_leaves, tree_map

N, TAU, ROUNDS = 24, 2, 4
TOL = 1e-12
KW = dict(alpha=0.02, c=0.3, tau=TAU, n_clients=N)


def _odd_tree(seed=0, dtype=torch.float64, lead=None):
    """Leaf sizes chosen to exercise lane padding: none divides 1024."""
    gen = torch.Generator().manual_seed(seed)
    shapes = [("w", (3, 5)), ("b", (7,)), ("scalar", ()), ("big", (1030,)),
              ("nest_k", (2, 513))]
    return {name: torch.randn((lead,) + s if lead is not None else s,
                              generator=gen, dtype=dtype)
            for name, s in shapes}


# --------------------------------------------------- pack/unpack round-trip
def test_pack_unpack_roundtrip_bitwise():
    tree = _odd_tree(0)
    lo = ArenaLayout.for_tree(tree)
    arena = pack(tree, lo)
    assert arena.data.shape == (lo.rows, LANES)
    back = unpack(arena)
    for a, b in zip(tree_leaves(tree), tree_leaves(back)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)


def test_pack_unpack_roundtrip_stacked_and_unpack_is_a_view():
    tree = _odd_tree(1, lead=5)
    lo = ArenaLayout.for_tree(_odd_tree(1))
    arena = pack(tree, lo)
    assert arena.data.shape == (5, lo.rows, LANES)
    back = unpack(arena)
    for a, b in zip(tree_leaves(tree), tree_leaves(back)):
        assert torch.equal(a, b)
        assert b.untyped_storage().data_ptr() == \
            arena.data.untyped_storage().data_ptr()


def test_pack_pads_are_zero():
    arena = pack({"b": torch.ones(7, dtype=torch.float64)})
    assert float(arena.data.sum()) == 7.0  # everything past n is 0


def test_layout_row_segments():
    lo = ArenaLayout.for_tree(_odd_tree(2))
    seg = lo.row_segments()
    assert seg.shape == (lo.rows,)
    counts = torch.bincount(seg, minlength=len(lo.shapes))
    assert tuple(counts.tolist()) == lo.rows_per_leaf
    assert lo.num_params == sum(int(np.prod(s)) for s in lo.shapes)
    assert lo.row_segments() is seg  # kept per device


def test_layout_rejects_bad_trees():
    with pytest.raises(ValueError):  # mixed dtypes
        ArenaLayout.for_tree({"a": torch.ones(2, dtype=torch.float32),
                              "b": torch.ones(2, dtype=torch.float64)})
    with pytest.raises(ValueError):  # non-float
        ArenaLayout.for_tree({"a": torch.ones(2, dtype=torch.int32)})
    lo = ArenaLayout.for_tree({"a": torch.ones(3)})
    with pytest.raises(ValueError):  # wrong leaf count
        pack({"a": torch.ones(3), "b": torch.ones(3)}, lo)
    with pytest.raises(ValueError):  # neither model- nor stacked-shaped
        pack({"a": torch.ones(4, 4)}, lo)


def test_arena_is_transparent_pytree():
    a = pack(_odd_tree(3))
    b = tree_map(lambda x: 2.0 * x, a)
    assert isinstance(b, Arena) and b.layout is a.layout
    assert torch.equal(b.data, 2.0 * a.data)
    assert pytree.tree_leaves(a) == [a.data]


def test_layout_matches_the_reference():
    """Same shapes, row extents and segments as the JAX package. JAX
    flattens a dict in sorted key order, torch in insertion order, so the
    tree is built sorted (as trees carried across from the reference
    arrive): then both enumerate the leaves alike."""
    import jax

    jax.config.update("jax_enable_x64", True)
    from repro.core.arena import ArenaLayout as JLayout

    tree = dict(sorted(_odd_tree(4).items()))
    jlo = JLayout.for_tree({k: v.numpy() for k, v in tree.items()})
    lo = ArenaLayout.for_tree(tree)
    assert lo.shapes == jlo.shapes and lo.rows_per_leaf == jlo.rows_per_leaf
    assert lo.row_segments().tolist() == jlo.row_segments().tolist()


# ------------------------------ compressed, sampled FedCET on the quadratic
def _problems():
    import jax

    jax.config.update("jax_enable_x64", True)
    from repro.data.quadratic import make_hetero_hessian_problem

    jp = make_hetero_hessian_problem(0, n_clients=N, dim=12,
                                     n_measurements=4)
    tp = QuadraticProblem(b=torch.tensor(np.asarray(jp.b)),
                          m=torch.tensor(np.asarray(jp.m)))
    return jp, tp


def _port_algo(fused=True, arena=False, participation=None):
    a = FedCET(**KW, use_fused_kernel=fused)
    if arena:
        a = with_arena(a)
    a = with_compression(a, compressor="shift:q8", seed=5)
    if participation is not None:
        a = with_participation(a, participation, seed=3)
    return a


def _port_run(algo, tp, rounds=ROUNDS):
    grad = torch.func.grad(tp.client_loss)
    batches = tp.stacked_batches(TAU)
    state = algo.init(grad, torch.zeros(12, dtype=torch.float64),
                      {k: v[0] for k, v in batches.items()})
    return run_rounds(algo, grad, state, batches, rounds=rounds)[0]


def _jax_run(jp, fused, arena, participation):
    import jax
    import jax.numpy as jnp
    from repro.core import (run_rounds as jrun, with_arena as jwa,
                            with_compression as jwc,
                            with_participation as jwp)
    from repro.core.fedcet import FedCET as JFedCET

    a = JFedCET(**KW, use_fused_kernel=fused)
    if arena:
        a = jwa(a)
    a = jwc(a, compressor="shift:q8", seed=5)
    if participation is not None:
        a = jwp(a, participation, seed=3)
    grad = jax.grad(jp.client_loss)
    batches = jp.stacked_batches(TAU)
    state = a.init(grad, jnp.zeros((12,), jp.b.dtype),
                   jax.tree.map(lambda b: b[0], batches))
    return jrun(a, grad, state, batches, rounds=ROUNDS)[0]


def _per_leaf(state):
    """(x, d, h) of an engine state as per-leaf numpy arrays."""
    inner = state.inner
    return [np.asarray(unpack(a) if isinstance(a, Arena) else a)
            for a in (inner.x, inner.d, state.extras[0])]


def _jax_per_leaf(state):
    from repro.core.arena import Arena as JArena, unpack as junpack

    inner = state.inner
    return [np.asarray(junpack(a) if isinstance(a, JArena) else a)
            for a in (inner.x, inner.d, state.extras[0])]


@pytest.mark.parametrize("participation", [None, 0.8], ids=["full", "p0.8"])
@pytest.mark.parametrize("fused,arena", [(False, False), (False, True),
                                         (True, True)],
                         ids=["per_leaf", "arena", "arena_fused"])
def test_compressed_sampled_fedcet_matches_jax(fused, arena, participation):
    jp, tp = _problems()
    got = _port_run(_port_algo(fused, arena, participation), tp)
    want = _jax_run(jp, fused, arena, participation)
    assert got.inner.t == int(want.inner.t) == ROUNDS * TAU
    for g, w in zip(_per_leaf(got), _jax_per_leaf(want)):
        assert g.shape == w.shape
        assert float(np.abs(g - w).max()) <= TOL


def _assert_equiv(arena_state, per_leaf_state, tol=TOL):
    adapted = adapt_state(arena_state, per_leaf_state)
    la, lb = tree_leaves(adapted), tree_leaves(per_leaf_state)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        if isinstance(x, torch.Tensor):
            assert float((x - y).abs().max()) <= tol
        else:
            assert x == y


@pytest.mark.parametrize("participation", [None, 0.8], ids=["bare", "masked"])
def test_fused_tail_equals_generic_and_per_leaf(participation):
    """``use_fused_kernel=True`` routes the arena round through the fused
    tail (``FedCET._fused_tail`` -> ``ops.fedcet_round_tail``); it must
    match the generic arena path and the per-leaf path."""
    _, tp = _problems()
    fused = _port_run(_port_algo(True, True, participation), tp)
    generic = _port_run(_port_algo(False, True, participation), tp)
    per_leaf = _port_run(_port_algo(True, False, participation), tp)
    _assert_equiv(fused, generic)
    _assert_equiv(fused, per_leaf)
    _assert_equiv(generic, per_leaf)


def test_adapt_state_flips_representations_bitwise():
    _, tp = _problems()
    arena_state = _port_run(_port_algo(True, True, 0.8), tp, rounds=2)
    per_leaf_like = _port_run(_port_algo(True, False, 0.8), tp, rounds=1)
    flipped = adapt_state(arena_state, per_leaf_like)
    back = adapt_state(flipped, arena_state)
    assert torch.equal(back.inner.x.data, arena_state.inner.x.data)
    assert torch.equal(back.extras[0].data, arena_state.extras[0].data)
