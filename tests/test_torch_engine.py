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
