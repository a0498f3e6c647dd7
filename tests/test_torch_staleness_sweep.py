"""The cells of the staleness table that ``benchmarks/staleness_sweep.py``
asserts, reproduced by the port on the CPU in float64: the reference's
problem (``make_quadratic_problem(0)``, carried across as numpy), its
algorithms and learning rates, its 1500 rounds and its bounds.

* FedCET stays exact (< 1e-9) at delay 2 under ``drop`` and ``last``, for
  ``fixed:2``, ``rr:2`` and ``geom:0.5``, with and without a ``shift:q8``
  uplink.
* SCAFFOLD's delta pair breaks under ``last`` (> 1e-1 at ``rr:2``) and
  converges under ``drop`` (< 1e-2).
* ``poly:1`` floors FedCET where ages differ (> 1e-4 at ``rr:2`` and
  ``geom:0.5``) and keeps it exact where they do not (< 1e-9 at
  ``fixed:2``).
"""

import numpy as np
import pytest
import torch

from repro_torch.core import FedCET, Scaffold, max_weight_c
from repro_torch.core.engine import with_compression, with_delay
from repro_torch.core.lr_search import lr_search
from repro_torch.core.simulate import simulate_quadratic
from repro_torch.data.quadratic import QuadraticProblem

ROUNDS = 1500

#: (algorithm, compression, delay, policy) -> the script's bound: ("<", b)
#: or (">", b) on the final error.
CELLS = {
    **{("fedcet", comp, delay, pol): ("<", 1e-9)
       for comp in ("none", "shift:q8")
       for delay in ("fixed:2", "rr:2", "geom:0.5")
       for pol in ("drop", "last")},
    ("scaffold", "none", "rr:2", "last"): (">", 1e-1),
    ("scaffold", "none", "rr:2", "drop"): ("<", 1e-2),
    ("fedcet", "none", "rr:2", "poly:1"): (">", 1e-4),
    ("fedcet", "none", "geom:0.5", "poly:1"): (">", 1e-4),
    ("fedcet", "none", "fixed:2", "poly:1"): ("<", 1e-9),
}


@pytest.fixture(scope="module")
def problem():
    import jax

    jax.config.update("jax_enable_x64", True)
    from repro.data.quadratic import make_quadratic_problem

    jp = make_quadratic_problem(0)
    return QuadraticProblem(b=torch.tensor(np.asarray(jp.b)),
                            m=torch.tensor(np.asarray(jp.m)))


def _algo(problem, name, comp, delay, pol, tau=2):
    """``benchmarks/staleness_sweep.py:_algos`` and its composition."""
    mu, L, n = problem.mu, problem.L, problem.n_clients
    if name == "fedcet":
        alpha = lr_search(mu, L, tau)
        base = FedCET(alpha=alpha, c=max_weight_c(mu, alpha), tau=tau,
                      n_clients=n)
    else:
        base = Scaffold(alpha_l=1.0 / (81 * tau * L), tau=tau, n_clients=n)
    if comp != "none":
        base = with_compression(base, compressor=comp)
    return with_delay(base, delay, policy=pol)


@pytest.mark.parametrize("cell", sorted(CELLS), ids="/".join)
def test_staleness_sweep_cell(problem, cell):
    op, bound = CELLS[cell]
    err = simulate_quadratic(_algo(problem, *cell), problem, ROUNDS,
                             device="cpu").final_error
    assert (err < bound) if op == "<" else (err > bound), (cell, err)
