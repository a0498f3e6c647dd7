"""Staleness: asynchronous (delayed-uplink) federated rounds (port of
``src/repro/core/staleness.py``).

Every client computes its round, but a per-client *delay model* decides on
which rounds its uplink lands at the server. The server keeps a
**last-known message buffer** (:class:`DelayState`: each client's most
recent wire message, post-compression, and its age in rounds), and a
*stale-aggregation policy* decides how buffered messages enter the server
mean.

Delay models (``parse_delay``; ``FedScenario(delay=...)`` / ``--delay``):

* ``fixed:k``: every client lands only on rounds ``r % (k+1) == 0``.
* ``rr:k``: at round ``r`` the ``k`` clients ``{r, .., r+k-1} mod N``
  miss the round (max age ``k``).
* ``geom:p``: each uplink lands with probability ``p`` per round, drawn
  from the step counter through a domain-separated key.

``fixed:0``, ``rr:0``, ``geom:1`` and ``none`` are synchronous: the factory
returns the algorithm unchanged.

Stale-aggregation policies (``parse_policy``):

* ``drop``: aggregate fresh arrivals only; clients whose message did not
  land take the tau-th step as a pure local step instead.
* ``last``: average the whole buffer uniformly; every client applies the
  update with the server's copy of its own message. Uniform weights keep
  FedCET's ``sum_i d_i = 0``.
* ``poly:a``: weights ``(1 + age_i)^(-a)`` over the buffer, which break
  the mean-zero structure whenever ages differ.

All policies are weighted buffer means (:func:`weighted_client_mean`), so
with every client fresh every round they all reduce to the plain mean.
The buffer is server state: it updates and ages every round, rides the
``EngineState`` extras as their last slot, and is seeded at ``init`` with
each client's would-be first message.

Draw dtypes. ``geom:p`` draws its Bernoulli mask, and ``poly:a`` computes
its weights, in the reference's canonical dtypes: float64 where the engine
runs with ``x64`` (the reference's setting under ``jax_enable_x64``: its
tests and the float64 quadratic), float32 where it does not (its float32
LM entry points). The engine passes that choice explicitly.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from repro_torch.core import prng
from repro_torch.utils.sharding_ctx import resolve_partial
from repro_torch.utils.tree import tree_map

__all__ = [
    "DelayState",
    "FixedDelay",
    "GeometricDelay",
    "RoundRobinStraggler",
    "StalePolicy",
    "StalenessConfig",
    "parse_delay",
    "parse_policy",
    "weighted_client_mean",
]

#: domain-separation tag folded into geometric-delay keys (never collides
#: with the participation or compression schedules at seed=0).
_DELAY_KEY_TAG = 0x57A1E


class DelayState(NamedTuple):
    """The server-side message buffer in the ``EngineState`` extras:
    ``buf`` holds each client's last wire message (stacked ``[clients,
    ...]`` leaves), ``age`` is ``[clients] int32``, the rounds since that
    client's last arrival (0: landed this round)."""

    buf: Any
    age: torch.Tensor


def weighted_client_mean(tree, w: torch.Tensor):
    """Weighted mean over the leading clients axis with weights ``w``
    (normalized here; an all-zero ``w`` yields zeros). Reduces to the plain
    client mean for any uniform positive ``w``. The zero-sum guard does not
    clamp small positive sums: a clamp would silently shrink the mean of
    weights that sum below 1. On a client-sharded DTensor the sums are
    reduced across the client axes: a value, not a pending sum."""
    s = resolve_partial(torch.sum(w))
    denom = torch.where(s > 0, s, torch.ones_like(s))

    def mean_leaf(a):
        wb = w.reshape((-1,) + (1,) * (a.dim() - 1)).to(a.dtype)
        return resolve_partial(torch.sum(a * wb, dim=0, keepdim=True)
                               / denom.to(a.dtype))

    return tree_map(mean_leaf, tree)


# ------------------------------------------------------------- delay models
@dataclasses.dataclass(frozen=True)
class FixedDelay:
    """Periodic uplink: all clients land every ``k+1`` rounds (age cycles
    ``0..k``). ``k=0`` = synchronous."""

    k: int

    requires_key = False

    @property
    def identity(self) -> bool:
        return self.k <= 0

    @property
    def max_age(self) -> int:
        return max(self.k, 0)

    def fresh(self, key, round_index: int, n_clients: int,
              device=None) -> torch.Tensor:
        del key
        hit = round_index % (self.k + 1) == 0
        return torch.full((n_clients,), hit, dtype=torch.bool, device=device)

    def transmit_frac(self, n_clients: int) -> float:
        del n_clients
        return 1.0 / (self.k + 1)


@dataclasses.dataclass(frozen=True)
class RoundRobinStraggler:
    """Deterministic rotating stragglers: at round ``r`` the ``k`` clients
    ``(r + j) mod N`` (``j < k``) miss the round (max age ``k``)."""

    k: int

    requires_key = False

    @property
    def identity(self) -> bool:
        return self.k <= 0

    @property
    def max_age(self) -> int:
        return max(self.k, 0)

    def fresh(self, key, round_index: int, n_clients: int,
              device=None) -> torch.Tensor:
        del key
        idx = torch.arange(n_clients, device=device)
        return torch.remainder(idx - round_index, n_clients) >= self.k

    def transmit_frac(self, n_clients: int) -> float:
        return max(n_clients - self.k, 0) / n_clients


@dataclasses.dataclass(frozen=True)
class GeometricDelay:
    """Independent per-client Bernoulli(``p``) arrival per round: geometric
    inter-arrival times with mean ``1/p``. ``p=1`` = synchronous. The draw
    takes the key's float dtype (``core/prng.py``)."""

    p: float

    requires_key = True

    def __post_init__(self):
        assert 0.0 < self.p <= 1.0, self.p

    @property
    def identity(self) -> bool:
        return self.p >= 1.0

    def fresh(self, key, round_index: int, n_clients: int,
              device=None) -> torch.Tensor:
        del round_index  # already folded into the key by StalenessConfig
        return prng.bernoulli(key, self.p, (n_clients,), device=device)

    def transmit_frac(self, n_clients: int) -> float:
        del n_clients
        return self.p


# ----------------------------------------------------------------- policies
@dataclasses.dataclass(frozen=True)
class StalePolicy:
    """Stale-robust aggregation over the server buffer. ``kind`` selects
    the weight rule over (age, fresh); ``apply_stale`` says whether clients
    with no fresh arrival still apply the aggregation update (with their
    buffered message) or take the local continuation (``drop``)."""

    kind: str            # "drop" | "last" | "poly"
    a: float = 0.0       # poly discount exponent

    @property
    def apply_stale(self) -> bool:
        return self.kind != "drop"

    def weights(self, age: torch.Tensor, fresh: torch.Tensor,
                x64: bool = True) -> torch.Tensor:
        """Per-client weights in the canonical float dtype: float64 with
        ``x64`` (float32 weights would leave a ~1e-8 non-cancellation in
        the weighted mean and floor exact float64 runs), else float32."""
        ft = torch.float64 if x64 else torch.float32
        if self.kind == "drop":
            return fresh.to(ft)
        if self.kind == "last":
            return torch.ones(age.shape, dtype=ft, device=age.device)
        if self.kind == "poly":
            return (1.0 + age.to(ft)) ** (-self.a)
        raise ValueError(f"unknown stale policy kind {self.kind!r}")


def parse_policy(spec: "str | StalePolicy") -> StalePolicy:
    """``drop`` | ``last`` | ``poly:<a>`` (``poly:0`` == ``last`` weights)."""
    if isinstance(spec, StalePolicy):
        return spec
    s = spec.strip().lower()
    name, _, arg = s.partition(":")
    if name == "drop":
        return StalePolicy("drop")
    if name == "last":
        return StalePolicy("last")
    if name == "poly":
        return StalePolicy("poly", a=float(arg) if arg else 1.0)
    raise ValueError(f"unknown stale policy {spec!r} (try drop, last, poly:1)")


def parse_delay(spec):
    """Parse a delay-model spec; returns ``None`` for synchronous specs
    (``none``/``off``/``fixed:0``/``rr:0``/``geom:1``), so ``with_delay``
    can be an exact no-op at the identity settings."""
    if spec is None:
        return None
    if isinstance(spec, (FixedDelay, RoundRobinStraggler, GeometricDelay)):
        return None if spec.identity else spec
    s = str(spec).strip().lower()
    if s in ("", "none", "off", "sync"):
        return None
    name, _, arg = s.partition(":")
    if name == "fixed":
        model = FixedDelay(int(arg))
    elif name == "rr":
        model = RoundRobinStraggler(int(arg))
    elif name == "geom":
        model = GeometricDelay(float(arg))
    else:
        raise ValueError(
            f"unknown delay spec {spec!r} (try fixed:2, rr:1, geom:0.5)")
    return None if model.identity else model


# ------------------------------------------------------------ configuration
@dataclasses.dataclass(frozen=True)
class StalenessConfig:
    """The engine-level staleness knob (``RoundEngine.delay``): a delay
    model, a stale-aggregation policy and the seed of stochastic
    schedules."""

    model: Any
    policy: StalePolicy = StalePolicy("last")
    seed: int = 0

    def fresh_mask(self, step: int, tau: int, n_clients: int, *,
                   x64: bool = True, device=None) -> torch.Tensor:
        """``[n_clients]`` bool arrival mask for the round entered at step
        counter ``step`` (round index ``step // tau``). Stochastic models
        key on ``fold_in(fold_in(key(seed), 0x57A1E), int32(step))``, whose
        draws take float64 (``x64``) or float32."""
        r = int(step) // tau
        key = None
        if getattr(self.model, "requires_key", False):
            key = prng.fold_in(prng.fold_in(prng.key(self.seed, x64),
                                            _DELAY_KEY_TAG), step)
        return self.model.fresh(key, r, n_clients, device=device)

    def transmit_frac(self, n_clients: int) -> float:
        """Expected fraction of rounds on which a client's uplink lands:
        the duty cycle CommMeter folds into uplink bytes."""
        return float(self.model.transmit_frac(n_clients))
