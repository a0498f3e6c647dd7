"""Algorithm 1 — learning-rate search for FedCET (port of
``src/repro/core/lr_search.py``; pure Python, copied verbatim).

Implemented verbatim from the paper, plus a validated variant that searches
directly against the convergence inequalities (16) of Remark 1 and reports
the resulting contraction factors (rho_1, rho_2) of Corollary 1.
"""

from __future__ import annotations

import dataclasses
import math


def _growth(tau: int) -> float:
    """(1 + 2/tau)^(2 tau - 2) — the local-drift amplification constant."""
    return (1.0 + 2.0 / tau) ** (2 * tau - 2)


def alpha0_upper_bound(mu: float, L: float, tau: int) -> float:
    """Initial learning-rate bound from Algorithm 1 / Remark 1:

    alpha_0 < min{ 1/(2 tau L),
                   mu^2 / (2 tau (1+2/tau)^(2tau-2) L^3),
                   mu  / (5 tau (1+2/tau)^(2tau-2) L^2) }.
    """
    g = _growth(tau)
    return min(
        1.0 / (2.0 * tau * L),
        mu**2 / (2.0 * tau * g * L**3),
        mu / (5.0 * tau * g * L**2),
    )


def _alg1_predicates(alpha: float, mu: float, L: float, tau: int) -> tuple[float, float]:
    """The two while-loop expressions of Algorithm 1 (search continues while
    both are > 0)."""
    g = _growth(tau)
    p1 = 1.0 - tau * mu * alpha + tau * L**2 * (tau * alpha - 2.0 / mu) * g * alpha
    p2 = (1.0 - tau * L * alpha) * tau * mu * alpha \
        + tau**3 * L**4 * (tau * alpha - 2.0 / mu) * g * alpha**3
    return p1, p2


def lr_search(mu: float, L: float, tau: int, *, h_frac: float = 1e-3,
              alpha0_frac: float = 0.999) -> float:
    """Algorithm 1, exactly as printed.

    ``h = h_frac * alpha_0`` (the paper's experiments use h = 0.001 alpha_0).
    Starts from ``alpha_0 = alpha0_frac * upper_bound`` (any value strictly
    below the bound is admissible) and grows alpha by h while both predicates
    hold, returning the last alpha that satisfied them.
    """
    if not (0 < mu <= L):
        raise ValueError(f"need 0 < mu <= L, got mu={mu}, L={L}")
    if tau < 1:
        raise ValueError(f"tau must be a positive integer, got {tau}")
    alpha0 = alpha0_frac * alpha0_upper_bound(mu, L, tau)
    h = h_frac * alpha0
    alpha = alpha0
    # Termination is guaranteed: at alpha = 2/(tau L) the predicates fail
    # (Corollary 1, part (ii)), so the loop runs at most O(1/h_frac) steps.
    max_iters = int(math.ceil((2.0 / (tau * L) - alpha0) / h)) + 2
    for _ in range(max_iters):
        p1, p2 = _alg1_predicates(alpha, mu, L, tau)
        if not (p1 > 0.0 and p2 > 0.0):
            break
        alpha += h
    return alpha - h


def remark1_inequalities(alpha: float, mu: float, L: float, tau: int) -> tuple[float, float]:
    """LHS - RHS of the two inequalities in (16); both must be > 0."""
    g = _growth(tau)
    lhs = 1.0 - tau * mu * alpha
    rhs1 = (
        1.0
        + L * mu * tau**2 * alpha**2
        + (2.0 * tau**3 / mu) * g * L**4 * alpha**3
        - 2.0 * tau * mu * alpha
        - tau**4 * g * L**4 * alpha**4
    )
    rhs2 = (2.0 / (tau * mu * alpha) - 1.0) * tau**2 * g * L**2 * alpha**2
    return lhs - rhs1, lhs - rhs2


@dataclasses.dataclass(frozen=True)
class ContractionFactors:
    alpha: float
    c: float
    rho1: float
    rho2: float

    @property
    def rho(self) -> float:
        return max(self.rho1, self.rho2)

    @property
    def converges(self) -> bool:
        return 0.0 < self.rho < 1.0


def contraction_factors(alpha: float, mu: float, L: float, tau: int,
                        n_clients: int) -> ContractionFactors:
    """rho_1, rho_2 from the proof of Corollary 1.

    M = c^{-1} (I - 11^T/N)^\\dagger - alpha I restricted to range(I - 11^T/N)
    has lambda_max(M) = 1/c - alpha (the pseudo-inverse of the centering
    projector is itself, eigenvalue 1 on that range).
    """
    g = _growth(tau)
    b2 = tau**2 * g
    c = mu / (2.0 * mu * alpha + 8.0)
    tma = tau * mu * alpha
    rho1 = (1.0 - (2.0 - tau * alpha * L) * tma
            + (2.0 / tma - 1.0) * b2 * tau**2 * alpha**4 * L**4) / (1.0 - tma)
    lam = 1.0 / c - alpha
    rho2 = (lam + (2.0 / tma - 1.0) * b2 * alpha**2 * L**2 * tau * alpha) / (
        lam + (1.0 - tma) * tau * alpha)
    return ContractionFactors(alpha=alpha, c=c, rho1=rho1, rho2=rho2)


def lr_search_validated(mu: float, L: float, tau: int, *, h_frac: float = 1e-3,
                        alpha0_frac: float = 0.999) -> float:
    """Variant searching directly against (16): returns the largest alpha on
    the search grid for which BOTH Remark-1 inequalities hold strictly."""
    alpha0 = alpha0_frac * alpha0_upper_bound(mu, L, tau)
    h = h_frac * alpha0
    alpha = alpha0
    max_iters = int(math.ceil((2.0 / (tau * L) - alpha0) / h)) + 2
    for _ in range(max_iters):
        d1, d2 = remark1_inequalities(alpha, mu, L, tau)
        if not (d1 > 0.0 and d2 > 0.0):
            break
        alpha += h
    return alpha - h
