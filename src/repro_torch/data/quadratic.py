"""The paper's numerical-evaluation problem, Section IV, Eq. 17 (port of
``src/repro/data/quadratic.py``).

Client i holds n_i noisy measurements b_ij of x with a diagonal
measurement matrix M_i = diag(m_i):

    f_i(x) = (1/n_i) sum_j ||M_i x - b_ij||^2 + ||x||^2.

The paper fixes M_i = I (mu = L = 4, x* = (1/2) mean_ij b_ij). Each
client's batch is ``{"b": [n_i, n], "m": [n]}``. The data is drawn with a
``torch.Generator`` and will not reproduce the reference's JAX draws: a
test that compares the two passes the reference's arrays in as numpy.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class QuadraticProblem:
    b: torch.Tensor          # [N, n_i, n] measurements
    m: torch.Tensor          # [N, n] diagonal measurement matrices

    @property
    def n_clients(self) -> int:
        return self.b.shape[0]

    @property
    def dim(self) -> int:
        return self.b.shape[-1]

    @property
    def mu(self) -> float:
        """Global strong-convexity constant: min_i lambda_min(2 m_i^2 + 2)."""
        return float(2.0 * torch.min(self.m ** 2) + 2.0)

    @property
    def L(self) -> float:
        return float(2.0 * torch.max(self.m ** 2) + 2.0)

    @property
    def x_star(self) -> torch.Tensor:
        """grad f = mean_i [2 m_i^2 x - 2 m_i mean_j b_ij + 2x] = 0."""
        m2 = torch.mean(self.m ** 2, dim=0)
        mb = torch.mean(self.m * torch.mean(self.b, dim=1), dim=0)
        return mb / (m2 + 1.0)

    def to(self, device) -> "QuadraticProblem":
        return QuadraticProblem(b=self.b.to(device), m=self.m.to(device))

    def client_loss(self, x: torch.Tensor, batch) -> torch.Tensor:
        """f_i for a single client; batch = {"b": [n_i, n], "m": [n]}."""
        residual = batch["m"][None, :] * x[None, :] - batch["b"]
        return torch.mean(torch.sum(residual ** 2, dim=-1)) + torch.sum(x ** 2)

    def client_grad(self, x: torch.Tensor, batch) -> torch.Tensor:
        """Closed form 2 m^2 x - 2 m mean_j b_ij + 2x."""
        m = batch["m"]
        return (2.0 * m ** 2 * x - 2.0 * m * torch.mean(batch["b"], dim=0)
                + 2.0 * x)

    def stacked_batches(self, tau: int):
        """Full-batch training: every local step sees the whole local set.
        Leading axes [tau, N, ...] as the round API expects."""
        return {"b": self.b.unsqueeze(0).expand((tau,) + self.b.shape),
                "m": self.m.unsqueeze(0).expand((tau,) + self.m.shape)}


def make_quadratic_problem(seed: int = 0, *, n_clients: int = 10,
                           n_measurements: int = 10, dim: int = 60,
                           spread: float = 10.0, dtype=torch.float64,
                           device="cpu") -> QuadraticProblem:
    """Paper settings: N=10 clients, n_i=10 measurements, n=60,
    b_ij ~ U[-10, 10], M_i = I (so mu = L = 4)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    b = (torch.rand((n_clients, n_measurements, dim), generator=gen,
                    dtype=dtype, device=device) * (2 * spread) - spread)
    m = torch.ones((n_clients, dim), dtype=dtype, device=device)
    return QuadraticProblem(b=b, m=m)


def make_hetero_hessian_problem(seed: int = 0, *, n_clients: int = 10,
                                n_measurements: int = 10, dim: int = 60,
                                spread: float = 10.0, m_low: float = 0.5,
                                m_high: float = 1.5, dtype=torch.float64,
                                device="cpu") -> QuadraticProblem:
    """Heterogeneous-Hessian variant (reference ``data/quadratic.py:95``):
    M_i = diag(m_i), m_i ~ U[m_low, m_high]. Exhibits genuine FedAvg
    client drift. Drawn with a ``torch.Generator``, like
    :func:`make_quadratic_problem`."""
    gen = torch.Generator(device=device).manual_seed(seed)
    b = (torch.rand((n_clients, n_measurements, dim), generator=gen,
                    dtype=dtype, device=device) * (2 * spread) - spread)
    m = (torch.rand((n_clients, dim), generator=gen, dtype=dtype,
                    device=device) * (m_high - m_low) + m_low)
    return QuadraticProblem(b=b, m=m)
