"""The port's round-engine plumbing against the JAX package's: the masked
client mean, loop segmentation, the multi-round driver and the Remark 2
byte accounting, on the same numpy inputs (float64, exact or within the
last bit of a reduction)."""

import numpy as np
import pytest
import torch

from repro_torch.core import FedCET
from repro_torch.core.api import comm_bytes_per_round, replicate, vmap_grads
from repro_torch.core.engine import (
    make_round_runner,
    masked_client_mean,
    run_rounds,
    scan_segments,
)
from repro_torch.data.quadratic import make_quadratic_problem


def _jax():
    import jax

    jax.config.update("jax_enable_x64", True)
    return jax


@pytest.mark.parametrize("mask", [[1, 0, 1, 1, 0], [0, 0, 0, 0, 0]])
def test_masked_client_mean_matches_jax(mask):
    _jax()
    from repro.core.engine import masked_client_mean as jmasked

    tree = {"a": np.random.default_rng(0).standard_normal((5, 3, 4)),
            "b": [np.arange(5.0)]}
    m = np.asarray(mask, bool)
    got = masked_client_mean({"a": torch.tensor(tree["a"]),
                              "b": [torch.tensor(tree["b"][0])]},
                             torch.tensor(m))
    want = jmasked(tree, m)
    np.testing.assert_allclose(got["a"].numpy(), np.asarray(want["a"]),
                               rtol=1e-15, atol=1e-15)
    np.testing.assert_allclose(got["b"][0].numpy(), np.asarray(want["b"][0]),
                               rtol=1e-15, atol=1e-15)


@pytest.mark.parametrize("start,total,every", [(0, 100, 10), (3, 17, 4),
                                               (0, 70, 50)])
def test_scan_segments_match_jax(start, total, every):
    _jax()
    from repro.core.engine import scan_segments as jsegments

    def boundary(r):
        return r % every == 0

    assert (list(scan_segments(start, total, boundary))
            == list(jsegments(start, total, boundary)))


def test_comm_bytes_match_jax():
    _jax()
    from repro.core import FedCET as JFedCET
    from repro.core.api import comm_bytes_per_round as jbytes

    kw = dict(alpha=0.1, c=0.2, tau=2, n_clients=4)
    assert (comm_bytes_per_round(FedCET(**kw), 1000, 4, 4)
            == jbytes(JFedCET(**kw), 1000, 4, 4))


def test_replicate_and_grads_are_contiguous():
    x = {"w": torch.randn(3, 5).t()}  # a non-contiguous leaf
    stacked = replicate(x, 4)
    assert stacked["w"].shape == (4, 5, 3) and stacked["w"].is_contiguous()
    assert torch.equal(stacked["w"][2], x["w"])
    gf = vmap_grads(torch.func.grad(lambda p, b: (p["w"].t() * b).sum()))
    g = gf(stacked, torch.randn(4, 3, 5))
    assert g["w"].shape == (4, 5, 3) and g["w"].is_contiguous()


def test_stacked_and_repeated_round_loops_agree():
    """``run_rounds`` over per-round stacked batches equals the repeat mode
    on the same batch, round by round."""
    p = make_quadratic_problem(1, n_clients=4, dim=8)
    algo = FedCET(alpha=0.05, c=0.3, tau=2, n_clients=4)
    grad_fn = torch.func.grad(p.client_loss)
    batches = p.stacked_batches(2)
    s0 = algo.init(grad_fn, torch.zeros(8, dtype=torch.float64),
                   {k: v[0] for k, v in batches.items()})
    err = lambda s: torch.linalg.norm(algo.global_params(s) - p.x_star)  # noqa: E731
    s_rep, e_rep = run_rounds(algo, grad_fn, s0, batches, rounds=3,
                              metric_fn=err)
    stacked = {k: v.unsqueeze(0).expand((3,) + v.shape)
               for k, v in batches.items()}
    s_stk, e_stk = make_round_runner(algo, grad_fn, metric_fn=err)(s0,
                                                                   stacked)
    assert torch.equal(e_rep, e_stk) and e_rep.shape == (3,)
    assert torch.equal(s_rep.x, s_stk.x) and s_rep.t == s_stk.t == 6


# ------------------------------------- mirrors of tests/test_engine.py
@pytest.fixture(scope="module")
def problem():
    _jax()
    from repro.data.quadratic import make_quadratic_problem as jmake

    from repro_torch.data.quadratic import QuadraticProblem

    jp = jmake(0)
    return QuadraticProblem(b=torch.tensor(np.asarray(jp.b)),
                            m=torch.tensor(np.asarray(jp.m)))


def _base(problem, tau=2):
    from repro_torch.core import max_weight_c
    from repro_torch.core.lr_search import lr_search

    alpha = lr_search(problem.mu, problem.L, tau)
    return FedCET(alpha=alpha, c=max_weight_c(problem.mu, alpha), tau=tau,
                  n_clients=problem.n_clients)


def _sim(algo, problem, rounds):
    from repro_torch.core.simulate import simulate_quadratic

    return simulate_quadratic(algo, problem, rounds, device="cpu")


def test_identity_transforms_are_exact_noops(problem):
    """Mirror of ``test_identity_transforms_are_exact_noops``."""
    from repro_torch.core.engine import with_compression, with_participation
    from repro_torch.core.fedcet_compressed import FedCETCompressed
    from repro_torch.core.participation import FedCETPartial

    base = _base(problem)
    assert with_participation(base, 1.0) is base
    assert with_compression(base, k_frac=1.0, quantize=False) is base
    part = FedCETPartial(alpha=base.alpha, c=base.c, tau=2,
                         n_clients=problem.n_clients, participation=1.0)
    comp = FedCETCompressed(alpha=base.alpha, c=base.c, tau=2,
                            n_clients=problem.n_clients, k_frac=1.0)
    ref = _sim(base, problem, 20).errors
    for algo in (part, comp):
        assert torch.equal(_sim(algo, problem, 20).errors, ref)


def test_composed_other_order_and_drift_invariant(problem):
    """Mirror of ``test_composed_other_order_and_drift_invariant``:
    participation over top-k compression keeps ``sum_i d_i = 0``."""
    from repro_torch.core.engine import with_compression, with_participation

    algo = with_participation(with_compression(_base(problem), k_frac=0.5),
                              0.7, seed=11)
    inner, _extras = _sim(algo, problem, 60).state
    np.testing.assert_allclose(torch.mean(inner.d, dim=0).numpy(), 0.0,
                               atol=1e-10)


def test_composed_up_frac_accounting(problem):
    """Mirror of ``test_composed_up_frac_accounting``."""
    from repro_torch.core import FedLin, FedTrack
    from repro_torch.core.engine import with_compression

    n = problem.n_clients
    assert FedLin(alpha=0.01, tau=2, n_clients=n, k_frac=0.1).up_frac \
        == pytest.approx(0.6)
    assert with_compression(FedTrack(alpha=0.01, tau=2, n_clients=n),
                            quantize=True).up_frac == pytest.approx(0.75)
    assert with_compression(FedCET(alpha=0.01, c=0.3, tau=2, n_clients=n),
                            k_frac=0.3).up_frac == pytest.approx(0.6)


def test_stale_checkpoint_layout_fails_loudly(tmp_path, problem):
    """Mirror of ``test_stale_checkpoint_layout_fails_loudly``: the seed's
    (x, d, e, t) order does not restore transposed into (x, d, t, e)."""
    from repro_torch.checkpoint.ckpt import load_pytree, save_pytree
    from repro_torch.core.engine import with_compression

    algo = with_compression(_base(problem), quantize=True)
    state = _sim(algo, problem, 2).state
    inner, (e,) = state
    path = str(tmp_path / "old.npz")
    save_pytree(path, (inner.x, inner.d, e, inner.t))
    with pytest.raises(ValueError, match="incompatible"):
        load_pytree(path, state)


def test_composed_state_checkpoint_roundtrip(tmp_path, problem):
    """Mirror of ``test_composed_state_checkpoint_roundtrip``."""
    from repro_torch.checkpoint.ckpt import load_pytree, save_pytree
    from repro_torch.core.engine import with_compression
    from repro_torch.utils.tree import tree_leaves

    state = _sim(with_compression(_base(problem), quantize=True), problem,
                 3).state
    path = str(tmp_path / "state.npz")
    save_pytree(path, state)
    for a, b in zip(tree_leaves(state), tree_leaves(load_pytree(path,
                                                                state))):
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b


def test_participation_step_counter_advances_tau_per_round(problem):
    """Mirror of ``test_participation_step_counter_advances_tau_per_round``."""
    from repro_torch.core.participation import FedCETPartial

    base = _base(problem)
    algo = FedCETPartial(alpha=base.alpha, c=base.c, tau=2,
                         n_clients=problem.n_clients, participation=0.6)
    assert _sim(algo, problem, 7).state.t == 7 * 2


def test_participation_mask_key_split():
    """Mirror of ``test_participation_mask_key_split``: at rate 0 the
    forced client is uniform over 300 keys."""
    from repro_torch.core import prng
    from repro_torch.core.engine import participation_mask

    chosen = set()
    for s in range(300):
        idx = torch.nonzero(participation_mask(prng.key(s), 10, 0.0))
        assert idx.numel() == 1
        chosen.add(int(idx[0, 0]))
    assert chosen == set(range(10))


def test_participation_masks_deterministic_per_round():
    """Mirror of ``test_participation_masks_deterministic_per_round``."""
    from repro_torch.core import prng
    from repro_torch.core.engine import participation_mask

    key = prng.fold_in(prng.key(5), 12)
    assert torch.equal(participation_mask(key, 8, 0.4),
                       participation_mask(key, 8, 0.4))
