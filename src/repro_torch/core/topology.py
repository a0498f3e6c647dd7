"""Topology: where the aggregation happens — star, hierarchical, gossip
(port of ``src/repro/core/topology.py``).

The paper's round is the STAR topology: every client's message goes to one
server, which averages. This module makes the aggregation geometry an
axis of the engine's message/aggregate seam:

* :class:`Star` — the flat all-to-one weighted mean. ``with_topology``
  returns the algorithm unchanged for star specs; attaching ``Star``
  explicitly runs the weighted-reduce machinery.
* :class:`Hierarchical` — a tree of edge aggregators, each over a
  contiguous block of clients, forwarding its weighted partial mean; the
  root combines them. Numerically the star mean up to reassociation, but
  the root ingests ``groups[-1]`` messages instead of ``n_clients``. With
  ``tier_compression`` the partial means are re-compressed at every
  interior hop (dither keyed from :class:`TopoState` through
  ``_TIER_KEY_TAG + tier``; the memory of a stateful tier compressor,
  ``shift:`` or error feedback, per aggregator in ``TopoState.tier``).
  The tier spec takes the whole ``from_spec`` grammar, through the
  engine's auto error-feedback policy (``compressors.auto_wrap``:
  ``topk:0.3`` runs as ``ErrorFeedback(TopK(0.3))``).
* :class:`Mixing` — no server: client i receives ``sum_j W_ij w_j m_j /
  sum_j W_ij w_j`` for a doubly-stochastic Metropolis matrix ``W`` (ring,
  torus, Erdős–Rényi, static or resampled every aggregation from the
  ``TopoState`` round index). The aggregate is per client (``[clients,
  ...]``); column-stochasticity keeps FedCET's ``sum_i d_i = 0``.

Lowerings of ``Mixing``. ``dense`` contracts the ``N x N`` matrix with each
leaf (``torch.matmul``, as the reference leaves ``Ww @ flat`` to XLA).
``sparse`` (spec suffix ``:sparse``) reduces each node's ``S = max_degree
+ 1`` neighbor slots (slot 0 the node itself, pad slots weight 0 and a
self index) through ``kernels/ops.py:gossip_reduce``: on the card the
hand-written CUDA kernel, for every ``S``; on the CPU its plain version,
the reference's unrolled slot loop. Static tables are built once per device and kept; resampled
tables are rebuilt on the device each round from the same key stream as
the dense matrix (``core/prng.py``: the reference's bits), so sparse and
dense resampled runs draw the same graphs.

Weighted reduction contract: ``reduce(tree, w, tstate)`` under per-client
weights ``w`` (uniform, or the participation mask), READ-ONLY; the engine's
aggregating step calls ``reduce_and_advance``, the one place topology
state moves. ``TopoState.k`` is a Python int, like the engine's step
counter, so every key of a round derives on the host.

Cohort execution (``with_cohort``): ``reduce_cohort(tree, w, idx,
n_clients, tstate)`` reduces GATHERED cohort rows; a hierarchy routes each
row to the first-tier aggregator of its GLOBAL id ``idx`` and sizes its
tiers from the full population, so the tier memory keeps its shapes and an
edge aggregator with no cohort member weighs zero. Gossip has no server to
sample a cohort (``supports_cohort`` False).

Accounting: ``client_up_mult`` (gossip: one message per directed edge),
``aggregator_hops`` (hierarchy tiers; upward hops at
``tier_bits_per_coord``) and ``broadcast_mult`` (0 for gossip), folded in
by ``core/comm.py``.

Draw dtypes: the resampled graph's Bernoulli draws and a tier
compressor's keys take the dtype of the weights ``w`` the engine passes
(its canonical float: float64 with ``x64``, the reference's under
``jax_enable_x64``, else float32).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.core.compressors import auto_wrap
from repro_torch.core.compressors import from_spec as compressor_from_spec
from repro_torch.core.staleness import weighted_client_mean
from repro_torch.kernels import ops as kops
from repro_torch.utils.spans import spanned
from repro_torch.utils.tree import tree_leaves, tree_map

__all__ = ["Hierarchical", "Mixing", "Star", "TopoState", "Topology",
           "parse_topology"]

#: domain-separation tag folded into resampled-graph keys (never collides
#: with the participation, compression or delay schedules at seed=0).
_TOPO_KEY_TAG = 0x70_70

#: domain-separation tag (+ tier index) for tier-compression dither keys.
_TIER_KEY_TAG = 0x71_E5

class TopoState(NamedTuple):
    """Per-run topology state in the ``EngineState`` extras (after the
    transform extras): the aggregation round index ``k`` (init included)
    that keys resampled graphs and tier dither, plus the per-tier
    compressor memory ``tier`` of a hierarchy with stateful tier
    compression (a tuple of per-aggregator trees)."""

    k: int
    tier: Any = None


# ------------------------------------------------------------------ protocol
@dataclasses.dataclass(frozen=True)
class Topology:
    """Base: a weighted cross-client reduction with a declared traffic
    shape. Subclasses implement ``reduce`` and the accounting hooks;
    stateful topologies also override ``init_state`` /
    ``reduce_and_advance``."""

    #: does this topology carry a TopoState in the EngineState extras?
    stateful = False
    #: does ``init_state`` need the message tree to shape its state?
    needs_msg_shapes = False
    #: can this topology reduce a gathered cohort (star, hierarchical)?
    supports_cohort = False

    # --------------------------------------------------------------- state
    def init_state(self, msg_like=None) -> TopoState | None:
        del msg_like
        return TopoState(k=0) if self.stateful else None

    def advance(self, tstate: TopoState | None) -> TopoState | None:
        if not self.stateful:
            return None
        return TopoState(k=tstate.k + 1, tier=tstate.tier)

    # -------------------------------------------------------------- compute
    def reduce(self, tree, w: torch.Tensor, tstate: TopoState | None = None):
        """Aggregate a stacked ``[clients, ...]`` tree under per-client
        weights ``w``: ``[1, ...]`` (star, hierarchical) or ``[clients,
        ...]`` (gossip). Read-only: topology state is used, never
        advanced."""
        raise NotImplementedError

    @spanned("topology")
    def reduce_and_advance(self, tree, w: torch.Tensor,
                           tstate: TopoState | None = None):
        """The aggregating step's entry point: reduce AND advance the
        topology state. Returns ``(aggregate, next_tstate)``."""
        return self.reduce(tree, w, tstate), self.advance(tstate)

    def reduce_cohort(self, tree, w: torch.Tensor, idx: torch.Tensor,
                      n_clients: int, tstate: TopoState | None = None):
        """Reduce a GATHERED ``[cohort, ...]`` tree under cohort-slot
        weights ``w``; ``idx`` holds the cohort's GLOBAL client ids (a
        hierarchy routes each member to its own edge aggregator). Only
        topologies with ``supports_cohort`` implement it."""
        raise NotImplementedError(
            f"{type(self).__name__} does not support cohort execution")

    def reduce_cohort_and_advance(self, tree, w, idx, n_clients,
                                  tstate=None):
        return (self.reduce_cohort(tree, w, idx, n_clients, tstate),
                self.advance(tstate))

    # ----------------------------------------------------------- accounting
    def client_up_mult(self, n_clients: int) -> float:
        """Uplink messages per client on the first hop (gossip: degree)."""
        del n_clients
        return 1.0

    def aggregator_hops(self, n_clients: int) -> tuple:
        """``(label, messages)`` per aggregator tier above the clients."""
        del n_clients
        return ()

    @property
    def tier_bits_per_coord(self) -> float:
        """Wire bits per coordinate on upward aggregator-tier hops."""
        return 32.0

    def broadcast_mult(self, n_clients: int) -> float:
        """Downlink client-hop multiplier (0 = no broadcast at all)."""
        del n_clients
        return 1.0

    def validate(self, n_clients: int) -> None:
        """Raise if the topology cannot serve ``n_clients`` nodes."""
        del n_clients


# ---------------------------------------------------------------------- star
@dataclasses.dataclass(frozen=True)
class Star(Topology):
    """Flat all-to-one aggregation, as an explicit object (``with_topology``
    never attaches it: star specs are identity shortcuts)."""

    supports_cohort = True

    def reduce(self, tree, w, tstate=None):
        del tstate
        return weighted_client_mean(tree, w)

    def reduce_cohort(self, tree, w, idx, n_clients, tstate=None):
        del idx, n_clients, tstate
        return weighted_client_mean(tree, w)


# -------------------------------------------------------------- hierarchical
def _segment_sum(x: torch.Tensor, ids: list, g: int) -> torch.Tensor:
    """Rows of ``x`` summed into ``g`` segments by the host list ``ids``,
    each segment from zero in row order: the reference's
    ``jax.ops.segment_sum`` (a sequential scatter-add on the CPU), with no
    atomics, so it is deterministic on the card too."""
    acc = [torch.zeros_like(x[0]) for _ in range(g)]
    for r, k in enumerate(ids):
        acc[k] = acc[k] + x[r]
    return torch.stack(acc)


@dataclasses.dataclass(frozen=True)
class Hierarchical(Topology):
    """Tree aggregation: ``groups = (g1, g2, ...)`` aggregators per tier,
    clients in contiguous near-equal blocks. Each tier forwards weighted
    partial means; the root value equals the star weighted mean up to
    reassociation. ``tier_compression`` re-compresses each interior tier's
    partial means with a ``core/compressors.py`` compressor."""

    groups: tuple
    tier_compression: Any = None
    seed: int = 0

    supports_cohort = True

    def __post_init__(self):
        g = (self.groups,) if isinstance(self.groups, int) else tuple(self.groups)
        object.__setattr__(self, "groups", g)
        if not g or any(int(x) < 1 for x in g):
            raise ValueError(f"need >= 1 aggregator per tier: {g}")
        if any(b >= a for a, b in zip(g, g[1:])):
            raise ValueError(f"tier sizes must strictly decrease: {g}")
        if self.tier_compression is not None and not (
                hasattr(self.tier_compression, "apply")
                and hasattr(self.tier_compression, "bits_per_coord")):
            raise ValueError(
                "tier_compression must be a repro_torch.core.compressors."
                f"Compressor (got {self.tier_compression!r}); pass spec "
                "strings through parse_topology / with_topology")

    def validate(self, n_clients: int) -> None:
        if self.groups[0] > n_clients:
            raise ValueError(
                f"hierarchical tier of {self.groups[0]} aggregators over "
                f"only {n_clients} clients (want fan-in > 1)")

    # ---------------------------------------------------------------- state
    @property
    def stateful(self) -> bool:  # type: ignore[override]
        c = self.tier_compression
        return c is not None and (c.stateful or c.requires_key)

    @property
    def needs_msg_shapes(self) -> bool:  # type: ignore[override]
        return self.tier_compression is not None and self.tier_compression.stateful

    def _tiers(self, n: int) -> list:
        return [g for g in self.groups if g < n]  # degenerate tiers drop out

    def init_state(self, msg_like=None) -> TopoState | None:
        """``msg_like``: a stacked ``[clients, ...]`` tree shaped like the
        wire message (the engine passes it); stateful tier compression
        sizes one ``[g, ...]`` memory tree per tier from it."""
        if not self.stateful:
            return None
        tier = None
        if self.needs_msg_shapes:
            if msg_like is None:
                raise ValueError(
                    "stateful tier compression needs the message shapes to "
                    "size its per-tier memory: the engine passes them at "
                    "init")
            n = tree_leaves(msg_like)[0].shape[0]
            tier = tuple(
                self.tier_compression.init_extra(tree_map(
                    lambda a, _g=g: torch.empty((_g,) + tuple(a.shape[1:]),
                                                dtype=a.dtype,
                                                device=a.device), msg_like))
                for g in self._tiers(n))
        return TopoState(k=0, tier=tier)

    # -------------------------------------------------------------- compute
    @staticmethod
    def _segments(n_in: int, n_out: int) -> list:
        """Contiguous near-equal block assignment ``[n_in] -> n_out``."""
        return [i * n_out // n_in for i in range(n_in)]

    def _tier_key(self, t_i: int, k: int, x64: bool = True):
        return prng.fold_in(prng.fold_in(prng.key(self.seed, x64),
                                         _TIER_KEY_TAG + t_i), k)

    def _reduce_impl(self, tree, w, tstate, seg0=None, n_total=None):
        """The tier walk; returns ``(aggregate, new tier memory)``.
        ``seg0`` / ``n_total`` are the cohort entry: ``tree`` / ``w`` are
        cohort rows, ``seg0`` (a host list) maps each row to the first-tier
        aggregator of its GLOBAL id, and the tiers are sized from
        ``n_total``, so the tier shapes and memory are those of the full
        population and an aggregator with no cohort member weighs zero."""
        n = n_total if n_total is not None else w.shape[0]
        comp = self.tier_compression
        k = tstate.k if tstate is not None else 0
        x64 = w.dtype == torch.float64
        vals, wt, cur = tree, w, n
        new_mem = []
        for t_i, g in enumerate(self._tiers(n)):
            ids = (seg0 if t_i == 0 and seg0 is not None
                   else self._segments(cur, g))
            wsum = _segment_sum(wt, ids, g)
            denom = torch.where(wsum > 0, wsum, 1.0)

            def pmean(a, _ids=ids, _wt=wt, _den=denom, _g=g):
                wb = _wt.to(a.dtype).reshape((-1,) + (1,) * (a.dim() - 1))
                sums = _segment_sum(a * wb, _ids, _g)
                db = _den.to(a.dtype).reshape((-1,) + (1,) * (a.dim() - 1))
                # the edge aggregator transmits its PARTIAL MEAN.
                return sums / db

            vals = tree_map(pmean, vals)
            if comp is not None:
                key = (self._tier_key(t_i, k, x64) if comp.requires_key
                       else None)
                extra = None
                if comp.stateful:
                    extra = (tstate.tier[t_i]
                             if tstate is not None and tstate.tier is not None
                             else tree_map(torch.zeros_like, vals))
                vals, extra = comp.apply(key, vals, extra)
                new_mem.append(extra)
            wt, cur = wsum, g

        def final(a):
            wb = wt.to(a.dtype).reshape((-1,) + (1,) * (a.dim() - 1))
            total = torch.sum(wt).to(a.dtype)
            denom = torch.where(total > 0, total, torch.ones_like(total))
            return torch.sum(a * wb, dim=0, keepdim=True) / denom

        return tree_map(final, vals), tuple(new_mem)

    def reduce(self, tree, w, tstate=None):
        return self._reduce_impl(tree, w, tstate)[0]

    def _advanced(self, tstate, mem):
        if not self.stateful:
            return None
        k = tstate.k if tstate is not None else 0
        tier = mem if self.needs_msg_shapes else (
            tstate.tier if tstate is not None else None)
        return TopoState(k=k + 1, tier=tier)

    @spanned("topology")
    def reduce_and_advance(self, tree, w, tstate=None):
        out, mem = self._reduce_impl(tree, w, tstate)
        return out, self._advanced(tstate, mem)

    # -------------------------------------------------------------- cohort
    def _seg0(self, idx: torch.Tensor, n_clients: int):
        """Each cohort member's GLOBAL first-tier aggregator id (a host
        list): the full population's segment table at the cohort's ids."""
        tiers = self._tiers(n_clients)
        if not tiers:
            return None
        table = self._segments(n_clients, tiers[0])
        return [table[i] for i in idx.tolist()]

    def reduce_cohort(self, tree, w, idx, n_clients, tstate=None):
        return self._reduce_impl(tree, w, tstate,
                                 seg0=self._seg0(idx, n_clients),
                                 n_total=n_clients)[0]

    def reduce_cohort_and_advance(self, tree, w, idx, n_clients,
                                  tstate=None):
        out, mem = self._reduce_impl(tree, w, tstate,
                                     seg0=self._seg0(idx, n_clients),
                                     n_total=n_clients)
        return out, self._advanced(tstate, mem)

    # ----------------------------------------------------------- accounting
    def aggregator_hops(self, n_clients: int) -> tuple:
        tiers = self._tiers(n_clients)
        return tuple(
            (f"tier{i + 1}->" + ("root" if i == len(tiers) - 1
                                 else f"tier{i + 2}"), int(g))
            for i, g in enumerate(tiers))

    @property
    def tier_bits_per_coord(self) -> float:  # type: ignore[override]
        if self.tier_compression is None:
            return 32.0
        return float(self.tier_compression.bits_per_coord)


# -------------------------------------------------------------------- mixing
def _metropolis(n: int, edges: set) -> list:
    """Doubly-stochastic Metropolis–Hastings weights for an undirected
    graph: ``W_ij = 1 / (1 + max(d_i, d_j))`` on edges, the diagonal
    absorbs the slack."""
    deg = [0] * n
    for i, j in edges:
        deg[i] += 1
        deg[j] += 1
    W = [[0.0] * n for _ in range(n)]
    for i, j in edges:
        wij = 1.0 / (1.0 + max(deg[i], deg[j]))
        W[i][j] = W[j][i] = wij
    for i in range(n):
        W[i][i] = 1.0 - sum(W[i])
    return W


@dataclasses.dataclass(frozen=True)
class Mixing(Topology):
    """Gossip aggregation through a doubly-stochastic matrix ``W``: client
    i receives its weight-renormalized neighborhood mean. Build with
    :meth:`ring` / :meth:`torus` / :meth:`erdos_renyi`, or pass ``w``
    (nested tuples). ``resample=True`` (Erdős–Rényi) redraws the graph at
    every aggregation. ``lowering="sparse"`` reduces the padded neighbor
    tables (``max_degree=0`` sizes them automatically) through
    ``kernels/ops.py:gossip_reduce``, the reference's ``use_kernel=True``
    route, always."""

    w: tuple | None = None
    n: int = 0
    graph: str = "custom"
    p: float = 0.0
    seed: int = 0
    resample: bool = False
    lowering: str = "dense"
    max_degree: int = 0
    #: per-device tables and matrices of a static graph, built on first use.
    _cache: dict = dataclasses.field(default_factory=dict, init=False,
                                     compare=False, repr=False)

    def __post_init__(self):
        if self.w is not None:
            object.__setattr__(self, "w", tuple(tuple(float(x) for x in r)
                                                for r in self.w))
            object.__setattr__(self, "n", len(self.w))
        if self.w is None and not self.resample:
            raise ValueError("Mixing needs a matrix (w=) or resample=True")
        if self.resample and not (0.0 < self.p <= 1.0):
            raise ValueError(f"resampled Erdos-Renyi needs 0 < p <= 1: {self.p}")
        if self.lowering not in ("dense", "sparse"):
            raise ValueError(f"unknown mixing lowering {self.lowering!r} "
                             "(dense | sparse)")
        if self.max_degree:
            if self.w is not None and self.max_degree < self._max_degree():
                raise ValueError(
                    f"max_degree={self.max_degree} overflows: the "
                    f"{self.graph} graph has a node of degree "
                    f"{self._max_degree()} (use max_degree=0 for auto)")
            if self.resample and self.max_degree < self.n - 1:
                raise ValueError(
                    "a resampled Erdos-Renyi graph can draw any degree up "
                    f"to n-1={self.n - 1}; max_degree={self.max_degree} "
                    "cannot bound it (use max_degree=0 for auto)")

    # ------------------------------------------------------------- builders
    @classmethod
    def ring(cls, n: int) -> "Mixing":
        if n < 2:
            raise ValueError(f"ring needs >= 2 nodes: {n}")
        edges = {(min(i, (i + 1) % n), max(i, (i + 1) % n)) for i in range(n)}
        return cls(w=tuple(map(tuple, _metropolis(n, edges))), graph="ring")

    @classmethod
    def torus(cls, n: int | None = None, shape: tuple | None = None) -> "Mixing":
        """2-D periodic grid; ``shape=(rows, cols)`` or the most-square
        factorization of ``n`` (prime ``n`` degenerates to a ring and is
        rejected)."""
        if shape is None:
            r = max(d for d in range(1, int(math.isqrt(n)) + 1) if n % d == 0)
            shape = (r, n // r)
        rows, cols = shape
        if n is not None and rows * cols != n:
            raise ValueError(f"torus shape {shape} has {rows * cols} nodes "
                             f"but n={n} was requested")
        if min(rows, cols) < 2:
            raise ValueError(
                f"torus needs both dims >= 2, got {shape} (use ring)")
        n = rows * cols
        edges = set()
        for i in range(rows):
            for j in range(cols):
                a = i * cols + j
                for b in (i * cols + (j + 1) % cols, ((i + 1) % rows) * cols + j):
                    if a != b:
                        edges.add((min(a, b), max(a, b)))
        return cls(w=tuple(map(tuple, _metropolis(n, edges))),
                   graph=f"torus{rows}x{cols}")

    @classmethod
    def erdos_renyi(cls, n: int, p: float, seed: int = 0,
                    resample: bool = False) -> "Mixing":
        """G(n, p) with Metropolis weights. ``resample=False`` draws ONE
        graph here on the host (numpy, from ``seed``: the reference's graph);
        ``resample=True`` redraws it at every aggregation."""
        if resample:
            return cls(w=None, n=n, graph="er", p=p, seed=seed, resample=True)
        rng = np.random.default_rng(seed)
        edges = {(i, j) for i in range(n) for j in range(i + 1, n)
                 if rng.random() < p}
        return cls(w=tuple(map(tuple, _metropolis(n, edges))),
                   graph="er", p=p, seed=seed)

    # ---------------------------------------------------------------- state
    @property
    def stateful(self) -> bool:  # type: ignore[override]
        return self.resample

    # -------------------------------------------------------------- compute
    def _max_degree(self) -> int:
        """Actual max node degree of a static graph (off-diagonal support)."""
        return max(sum(1 for j, x in enumerate(row) if j != i and x != 0.0)
                   for i, row in enumerate(self.w))

    def _cached(self, key, build):
        val = self._cache.get(key)
        if val is None:
            val = self._cache[key] = build()
        return val

    def _adjacency(self, tstate, n: int, device, x64: bool) -> torch.Tensor:
        """The round's resampled graph: ``fold_in(fold_in(key(seed),
        TAG), k)`` Bernoulli draws of the upper triangle (float64 with
        ``x64``, else float32), symmetrized."""
        key = prng.fold_in(prng.fold_in(prng.key(self.seed, x64),
                                        _TOPO_KEY_TAG), tstate.k)
        upper = torch.triu(prng.bernoulli(key, self.p, (n, n), device=device),
                           diagonal=1)
        return upper | upper.T

    def _matrix(self, tstate, n: int, dtype, device,
                x64: bool = True) -> torch.Tensor:
        if not self.resample:
            return self._cached(("W", dtype, device), lambda: torch.tensor(
                self.w, dtype=dtype, device=device))
        adj = self._adjacency(tstate, n, device, x64)
        deg = torch.sum(adj, dim=1)
        mw = 1.0 / (1.0 + torch.maximum(deg[:, None], deg[None, :]).to(dtype))
        W = torch.where(adj, mw, 0.0)
        return W + torch.diag(1.0 - torch.sum(W, dim=1))

    def _static_tables(self):
        """Padded neighbor tables from the fixed matrix, host-side: slot 0
        is the node itself (the Metropolis diagonal), then its neighbors;
        pad slots carry weight 0 and a self index."""
        n = self.n
        W = np.asarray(self.w, dtype=np.float64)
        nbrs = [[j for j in range(n) if j != i and W[i, j] != 0.0]
                for i in range(n)]
        dmax = self.max_degree or max((len(v) for v in nbrs), default=0)
        idx = np.tile(np.arange(n, dtype=np.int64)[:, None], (1, dmax + 1))
        wgt = np.zeros((n, dmax + 1))
        for i, v in enumerate(nbrs):
            wgt[i, 0] = W[i, i]
            for s, j in enumerate(v):
                idx[i, s + 1] = j
                wgt[i, s + 1] = W[i, j]
        return idx, wgt

    def _resampled_tables(self, tstate, n: int, dtype, device):
        """The padded neighbor tables of the round's resampled graph, built
        on the device from the same draws as the dense ``_matrix``."""
        adj = self._adjacency(tstate, n, device, dtype == torch.float64)
        deg = torch.sum(adj, dim=1)
        # a node has at most n-1 neighbors: larger caps clamp.
        cap = min(self.max_degree or n - 1, n - 1)
        # a stable argsort puts the neighbor columns first, in id order.
        order = torch.argsort((~adj).to(torch.int8), dim=1,
                              stable=True)[:, :cap]
        valid = torch.arange(cap, device=device)[None, :] < deg[:, None]
        nd = torch.maximum(deg[:, None], deg[order])
        wn = torch.where(valid, 1.0 / (1.0 + nd.to(dtype)), 0.0)
        selfw = 1.0 - torch.sum(wn, dim=1)
        me = torch.arange(n, device=device)[:, None]
        idx = torch.cat([me, torch.where(valid, order, me)], dim=1)
        wgt = torch.cat([selfw[:, None], wn], dim=1)
        return idx.contiguous(), wgt

    def _tables(self, tstate, n: int, dtype, device):
        """``(idx [n, S] int64, wgt [n, S])`` on ``device``: the static
        tables are built once per device and kept."""
        if self.resample:
            return self._resampled_tables(tstate, n, dtype, device)

        def build():
            idx, wgt = self._static_tables()
            return (torch.from_numpy(idx).to(device),
                    torch.from_numpy(wgt).to(dtype=dtype, device=device))

        return self._cached(("tables", dtype, device), build)

    def _reduce_sparse(self, tree, w, tstate):
        n = w.shape[0]
        idx, wgt = self._tables(tstate, n, w.dtype, w.device)
        wn = wgt * w[idx]                        # [n, S]: W_ij * w_j
        denom = torch.sum(wn, dim=1)
        denom = torch.where(denom > 0, denom, 1.0)

        def mean_leaf(a):
            # the CUDA kernel on the card (every S), its plain version on
            # the CPU; gather, weights, slot sum and division in one.
            out = kops.gossip_reduce(a.reshape(n, -1), idx, wn.to(a.dtype),
                                     denom.to(a.dtype))
            return out.reshape(a.shape)

        return tree_map(mean_leaf, tree)

    def reduce(self, tree, w, tstate=None):
        n = w.shape[0]
        if self.w is not None and self.n != n:
            raise ValueError(f"mixing matrix is {self.n}x{self.n}, "
                             f"state has {n} clients")
        if self.lowering == "sparse":
            return self._reduce_sparse(tree, w, tstate)

        def mean_leaf(a):
            W = self._matrix(tstate, n, a.dtype, a.device,
                             w.dtype == torch.float64)
            Ww = W * w.to(a.dtype)[None, :]          # row i: W_ij * w_j
            denom = torch.sum(Ww, dim=1)
            denom = torch.where(denom > 0, denom, 1.0)
            out = (Ww @ a.reshape(n, -1)) / denom[:, None]
            return out.reshape(a.shape)

        return tree_map(mean_leaf, tree)

    # ----------------------------------------------------------- accounting
    def _directed_edges(self, n: int) -> float:
        if self.resample:
            return n * (n - 1) * self.p  # expected
        return sum(1 for i, row in enumerate(self.w)
                   for j, x in enumerate(row) if i != j and x != 0.0)

    def client_up_mult(self, n_clients: int) -> float:
        """Gossip clients send their wire message to each neighbor: one
        message per directed edge, whichever lowering runs the exchange."""
        return self._directed_edges(n_clients) / n_clients

    def broadcast_mult(self, n_clients: int) -> float:
        return 0.0  # no server, no broadcast: the exchange is the uplink

    def validate(self, n_clients: int) -> None:
        if self.n and self.n != n_clients:
            raise ValueError(f"{self.graph} mixing is over {self.n} nodes but "
                             f"the algorithm has {n_clients} clients")

    # ------------------------------------------------------------- analysis
    @property
    def spectral_gap(self) -> float | None:
        """``1 - |lambda_2(W)|``; None for resampled graphs."""
        if self.w is None:
            return None
        lam = np.sort(np.abs(np.linalg.eigvalsh(np.asarray(self.w))))
        return float(1.0 - lam[-2])


# ------------------------------------------------------------------- parsing
def parse_topology(spec, n_clients: int, seed: int = 0,
                   tier_compression=None):
    """Parse a topology spec; ``None`` for star specs (``star`` / ``none``
    / ``""``), so ``with_topology`` is an exact no-op there.

    Grammar: ``star`` | ``hier:g8`` / ``hier:8`` / ``hier:16x4`` (tree
    tiers, coarsest last) | ``ring`` | ``torus`` / ``torus:2x5`` |
    ``er:0.4`` (one fixed G(n,p) graph) | ``er:0.4:t`` (resampled every
    round). Gossip specs take a trailing ``:sparse`` (``ring:sparse``,
    ``er:0.4:t:sparse``). ``tier_compression`` (a compressor spec or
    object; hierarchies only) re-compresses interior tier uplinks, with the
    engine's auto error-feedback policy."""
    tier = auto_wrap(compressor_from_spec(tier_compression))

    def _check_tier(topo):
        if tier is not None and not isinstance(topo, Hierarchical):
            raise ValueError(
                "tier_compression re-compresses hierarchical aggregator "
                f"tiers; topology {spec!r} has none (gossip edges carry "
                "the client compressor's wire message already)")

    if spec is None:
        _check_tier(None)
        return None
    if isinstance(spec, Topology):
        if isinstance(spec, Star):
            _check_tier(None)
            return None
        _check_tier(spec)
        if tier is not None:
            spec = dataclasses.replace(spec, tier_compression=tier, seed=seed)
        spec.validate(n_clients)
        return spec
    s = str(spec).strip().lower()
    if s in ("", "star", "none", "off"):
        _check_tier(None)
        return None
    lowering = "dense"
    parts = s.split(":")
    if parts[-1] in ("sparse", "dense"):
        lowering, parts = parts[-1], parts[:-1]
        s = ":".join(parts)
    name, _, arg = s.partition(":")
    if name == "hier":
        arg = arg.lstrip("g")
        try:
            groups = tuple(int(tok) for tok in arg.split("x") if tok)
        except ValueError:
            groups = ()
        if not groups:
            raise ValueError(f"bad hierarchical spec {spec!r} "
                             "(try hier:g8 or hier:16x4)")
        topo = Hierarchical(groups, tier_compression=tier, seed=seed)
    elif name == "ring":
        topo = Mixing.ring(n_clients)
    elif name == "torus":
        shape = None
        if arg:
            r, _, c = arg.partition("x")
            shape = (int(r), int(c))
            if shape[0] * shape[1] != n_clients:
                raise ValueError(f"torus {shape} has {shape[0] * shape[1]} "
                                 f"nodes but the algorithm has {n_clients}")
        topo = Mixing.torus(n_clients, shape=shape)
    elif name == "er":
        p, _, flag = arg.partition(":")
        topo = Mixing.erdos_renyi(n_clients, float(p), seed=seed,
                                  resample=flag in ("t", "resample"))
    else:
        raise ValueError(f"unknown topology spec {spec!r} "
                         "(try star, hier:g8, ring, ring:sparse, torus, "
                         "er:0.4)")
    if lowering == "sparse":
        if not isinstance(topo, Mixing):
            raise ValueError(f"the :sparse lowering applies to gossip "
                             f"(ring/torus/er) topologies, not {spec!r}")
        topo = dataclasses.replace(topo, lowering="sparse")
    _check_tier(topo)
    topo.validate(n_clients)
    return topo
