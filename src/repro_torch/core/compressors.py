"""Message compressors for the round engine and per-leaf compression plans
(port of ``src/repro/core/compressors.py``, all of it: ``Compressor``
:131-228, ``Identity``, ``TopK`` :241, ``RandK`` :275, ``StochasticQuant``
:311-408, ``NaturalQuant`` :412, ``Bf16`` :462, ``Chain`` :475,
``ErrorFeedback`` :545, ``Shifted`` :598-670, the exact wire-bit walk
:674-716, ``CompressionPlan`` :732 with ``allocate`` and ``tightened``,
``AdaptivePlan`` :1056, ``parse_plan`` :1084, ``from_spec`` /
``_parse_stage`` :1121-1169, ``auto_wrap`` :1172 and ``as_compressor``).

A :class:`Compressor` is a stateless ``compress(key, leaf) -> leaf``
object attached to an engine algorithm through ``with_compression(...,
compressor=...)`` (``core/engine.py``); client-side error feedback is the
explicit :class:`ErrorFeedback` wrapper, whose memory rides in the engine
state like any transform extra. Message leaves are STACKED ``[clients,
...]`` tensors, axis 0 the client axis: ``TopK(per_client=True)`` works
row by row, ``per_client=False`` keeps the legacy flatten where clients
compete for one top-k. Stochastic compressors receive a per-round key
derived from the engine state's step counter and draw randomness SHARED
across clients (one mask or dither per round, the same for every client
and the server): :class:`RandK` then sends values only (the server
regenerates the mask), and clients at consensus transmit identical
messages, which keeps FedCET's fixed point exact; unbiasedness keeps the
drift update mean-zero. Keys and draws are ``core/prng.py``'s, bit for bit
those of ``jax.random``, so a compressed run is comparable with the
reference's run for run. Draws whose dtype the reference leaves to
``jax_enable_x64`` (``RandK``'s scores) take the key's float dtype: the
engine's keys carry float64 or float32 (``RoundEngine.x64``), the
reference's under x64 on and off.

Accounting contract: every compressor declares ``keep_frac``,
``index_bits`` (32 for TopK's int32 indices, 0 for seed-synchronized
RandK), ``value_bits`` (``None`` = the incoming width) and derives
``bits_per_coord`` (exact wire bits per dense-f32 coordinate) and
``up_frac``; ``wire_bits(n)`` is the exact per-leaf cost with the actual
kept count ``max(1, round(k_frac * n))``. :class:`Chain` composes stages
left to right: the value width is the narrowest any stage sets
(first-narrowest-wins), index bits accumulate per sparsifying stage.

:class:`CompressionPlan` maps leaf paths (globs over ``embed/w``-style
slash-joined names, or flatten-order leaf indices: the same order as
``ArenaLayout.row_segments``) to per-leaf compressor specs, with a greedy
bit-budget allocator (``allocate``) and a telemetry-driven tightening
schedule (:class:`AdaptivePlan`). A plan IS a Compressor: it rides the
same ``MessageCompression`` transform, and a plan mapping every leaf to
one spec is bitwise-identical to the uniform path.

``from_spec`` parses the launch-config grammar: ``topk:<frac>``,
``topk_global:<frac>``, ``randk:<frac>``, ``q<b>`` / ``quant:<b>``,
``pq<b>`` (per-client dither), ``nat``, ``bf16``, chained with ``+``, with
an optional ``ef:`` (error feedback) or ``shift:`` (DIANA shift) prefix
around the whole chain.
"""

from __future__ import annotations

import dataclasses
import fnmatch
import heapq
import math
from typing import Any

import torch
from torch.utils import _pytree as pytree

from repro_torch.core import arena as ar
from repro_torch.core import prng
from repro_torch.core.comm import (leaf_info_of, leaf_name, quantize_bf16,
                                   topk_sparsify)
from repro_torch.kernels import ops as kops
from repro_torch.utils.tree import tree_leaves, tree_map

__all__ = ["AdaptivePlan", "Bf16", "Chain", "CompressionPlan", "Compressor",
           "ErrorFeedback", "Identity", "NaturalQuant", "RandK", "Shifted",
           "StochasticQuant", "TopK", "arena_scale", "as_compressor",
           "auto_wrap", "from_spec", "parse_plan", "stack_wire_bits"]


def _coord_shape(leaf) -> tuple:
    """The per-client coordinate space of a stacked leaf (axis 0 is ALWAYS
    the client axis: a ``(n_clients,)`` leaf is a stacked scalar)."""
    return tuple(leaf.shape[1:])


def reference_leaf_index(tree) -> list[int]:
    """Each leaf's position (``tree``'s leaves in torch's pytree order) in
    the reference's flatten order. JAX flattens a dict by sorted key,
    torch in insertion order; lists and tuples flatten in order in both.
    The per-leaf subkeys ``fold_in(key, i)`` take this ``i``, so a message
    draws the reference's dithers whatever order its dicts were built
    in."""
    paths = [p for p, _ in pytree.tree_flatten_with_path(tree)[0]]
    first: dict = {}    # a path prefix -> its rank among its siblings
    children: dict = {}
    keys = []
    for p in paths:
        k = []
        for depth, c in enumerate(p):
            if isinstance(c, pytree.MappingKey):
                k.append(c.key)
                continue
            pre = p[:depth + 1]
            if pre not in first:
                first[pre] = children.get(p[:depth], 0)
                children[p[:depth]] = first[pre] + 1
            k.append(first[pre])
        keys.append(tuple(k))
    index = [0] * len(paths)
    for rank, j in enumerate(sorted(range(len(paths)), key=keys.__getitem__)):
        index[j] = rank
    return index


def _is_arena(x) -> bool:
    return isinstance(x, ar.Arena)


def _has_arena(tree) -> bool:
    return any(map(_is_arena, pytree.tree_leaves(tree, is_leaf=_is_arena)))


def _k_of(k_frac: float, n: int) -> int:
    return max(1, int(round(k_frac * n)))


def _unpack_tree(tree):
    """Every Arena node of ``tree`` unpacked to its stacked leaf tree."""
    nodes, spec = pytree.tree_flatten(tree, is_leaf=_is_arena)
    return pytree.tree_unflatten(
        [ar.unpack(a) if _is_arena(a) else a for a in nodes], spec)


def _repack_tree(like, tree):
    """Inverse of :func:`_unpack_tree`: repack ``tree``'s subtrees where
    ``like`` holds an Arena, with that Arena's layout."""
    nodes, spec = pytree.tree_flatten(like, is_leaf=_is_arena)
    return pytree.tree_unflatten(
        [ar.pack(o, a.layout) if _is_arena(a) else o
         for a, o in zip(nodes, spec.flatten_up_to(tree))], spec)


def _pow2(e: torch.Tensor, dtype) -> torch.Tensor:
    """``2**e`` for integer-valued ``e``, exactly: the value of
    ``jnp.ldexp(1, e)``, built from its bits (a power of two below the
    normal range is subnormal; ``e`` never exceeds the dtype's exponent
    range here, being ``floor(log2)`` of a finite value)."""
    mant, bias, itype = ((52, 1023, torch.int64) if dtype == torch.float64
                         else (23, 127, torch.int32))
    e = e.to(itype)
    normal = ((e + bias).clamp(min=1) << mant).view(dtype)
    sub = (torch.ones_like(e) << (e + bias - 1 + mant).clamp(min=0,
                                                             max=mant - 1))
    sub = torch.where(e + bias - 1 + mant >= 0, sub, 0).view(dtype)
    return torch.where(e + bias >= 1, normal, sub)


def arena_scale(a: torch.Tensor, layout: ar.ArenaLayout,
                levels: int) -> torch.Tensor:
    """The per-leaf quantizer step ``max|leaf| / levels`` of a stacked
    arena ``a`` ``[C, rows, LANES]``, broadcast to its rows ``[rows, 1]``:
    a per-row max, then a segment max over each leaf's rows (pads are zero,
    so the max is the per-leaf max exactly). Stays on ``a``'s device."""
    seg = layout.row_segments(a.device)
    row_max = torch.amax(torch.abs(a), dim=(0, 2))
    leaf_max = torch.zeros(len(layout.shapes), dtype=a.dtype,
                           device=a.device).scatter_reduce(
        0, seg, row_max, "amax", include_self=False)
    return (leaf_max / levels)[seg][:, None]


@dataclasses.dataclass(frozen=True)
class Compressor:
    """Base: a stateless per-leaf transform with declared wire cost.

    Subclasses implement ``compress(key, leaf)`` (``key`` is ``None`` for
    deterministic compressors; ``requires_key`` gates whether the engine
    derives one) and override the accounting attributes."""

    #: does compress() consume a PRNG key (stochastic compressor)?
    requires_key = False
    #: is E[compress(v)] = v over the key distribution?
    unbiased = False
    #: does apply() carry per-client memory in `extra` (ErrorFeedback /
    #: Shifted)? Stateful wrappers cannot nest inside another stateful
    #: wrapper or a Chain: there is one `extra` slot per transform.
    stateful = False

    # ------------------------------------------------------------ accounting
    @property
    def keep_frac(self) -> float:
        return 1.0

    @property
    def index_bits(self) -> float:
        return 0.0

    @property
    def value_bits(self) -> float | None:
        """Transmitted width of kept values; None = unchanged (passthrough)."""
        return None

    @property
    def bits_per_coord(self) -> float:
        """Exact wire bits per original dense-f32 coordinate."""
        return self.keep_frac * ((self.value_bits or 32.0) + self.index_bits)

    @property
    def up_frac(self) -> float:
        """Uplink fraction vs a dense f32 payload (bit-true)."""
        return self.bits_per_coord / 32.0

    @property
    def omega(self) -> float:
        """Variance parameter of an unbiased compressor
        (``E|C(x) - x|^2 <= omega |x|^2``); drives :class:`Shifted`'s
        stable step ``beta = 1/(1+omega)``."""
        return 0.0

    def wire_bits(self, n: int) -> float:
        """EXACT uplink wire bits one client pays for one leaf of ``n``
        coordinates: sparsifying stages keep ``max(1, round(k_frac * n))``
        coordinates, as ``compress`` does."""
        return _stages_wire_bits(_wire_stages(self), n)

    # -------------------------------------------------------------- compute
    def compress(self, key, leaf):
        raise NotImplementedError

    # ---------------------------------------------- tree-level application
    def init_extra(self, msg_like):
        """Per-client carried state (None for stateless compressors)."""
        del msg_like
        return None

    def apply(self, key, msg, extra):
        """Compress a message tree; distinct subkey ``fold_in(key, i)`` per
        leaf, ``i`` its :func:`reference_leaf_index`. Arena-packed messages
        route through ``apply_arena``."""
        if _has_arena(msg):
            return self.apply_arena(key, msg, extra)
        leaves, spec = pytree.tree_flatten(msg)
        index = reference_leaf_index(msg) if self.requires_key else None
        out = [self.compress(prng.fold_in(key, index[i]) if self.requires_key
                             else None, leaf)
               for i, leaf in enumerate(leaves)]
        return pytree.tree_unflatten(out, spec), extra

    def apply_arena(self, key, msg, extra):
        """Compress an arena-packed message: unpack each Arena to its
        stacked per-leaf tree, compress leaf by leaf, repack. The unpacked
        tree flattens in the arena's layout order, so subkeys, scales and
        dithers are IDENTICAL to the per-leaf engine's (which is what holds
        arena runs to per-leaf runs for every compressor, the pad-unsafe
        sparsifiers included). Only :class:`StochasticQuant` overrides
        this, with its packed-rows kernel."""
        out, extra = self.apply(key, _unpack_tree(msg), extra)
        return _repack_tree(msg, out), extra


@dataclasses.dataclass(frozen=True)
class Identity(Compressor):
    """Exact no-op (a ``from_spec`` result and a Chain unit)."""

    def compress(self, key, leaf):
        del key
        return leaf


@dataclasses.dataclass(frozen=True)
class TopK(Compressor):
    """Magnitude top-k sparsification (biased: pair with ErrorFeedback).

    ``per_client=True`` keeps the top ``round(k_frac * n)`` entries (min 1)
    of each client's OWN row: the row's k-th largest magnitude is the
    threshold and every entry at or above it is kept, so ties keep more,
    as ``jax.lax.top_k``'s threshold does in the reference. ``False`` is
    the legacy flatten (``comm.topk_sparsify``), where clients compete for
    the top-k of the whole stacked leaf."""

    k_frac: float
    per_client: bool = True

    @property
    def keep_frac(self) -> float:
        return min(self.k_frac, 1.0)

    @property
    def index_bits(self) -> float:
        return 32.0 if self.keep_frac < 1.0 else 0.0

    def compress(self, key, leaf):
        del key
        if self.k_frac >= 1.0:
            return leaf
        if not self.per_client:
            return topk_sparsify(leaf, self.k_frac)
        rows = leaf.reshape(leaf.shape[0], -1)  # axis 0 = clients, always
        k = _k_of(self.k_frac, rows.shape[1])
        mag = torch.abs(rows)
        thresh = torch.topk(mag, k, dim=1).values[:, -1:]
        return torch.where(mag >= thresh, rows, 0.0).reshape(leaf.shape)


@dataclasses.dataclass(frozen=True)
class RandK(Compressor):
    """Uniform random-k sparsification, rescaled by ``n/k``: UNBIASED.

    One exact-k coordinate mask per round per leaf from the shared round
    key (the ``k`` largest of ``n`` uniform scores in the key's float
    dtype, ``core/prng.py``; all clients and the server regenerate it, so
    no index bits travel), kept entries rescaled so ``E[compress(v)] =
    v``."""

    k_frac: float

    requires_key = True
    unbiased = True

    @property
    def keep_frac(self) -> float:
        return min(self.k_frac, 1.0)

    @property
    def omega(self) -> float:
        """Classic rand-k variance: E|C(x) - x|^2 = (n/k - 1) |x|^2."""
        return max(1.0 / self.keep_frac - 1.0, 0.0)

    def compress(self, key, leaf):
        if self.k_frac >= 1.0:
            return leaf
        shape = _coord_shape(leaf)
        n = math.prod(shape)
        k = _k_of(self.k_frac, n)
        scores = prng.uniform(key, (n,), device=leaf.device)
        thresh = torch.topk(scores, k).values[-1]
        mask = (scores >= thresh).reshape(shape)
        scale = torch.tensor(n / k, dtype=leaf.dtype, device=leaf.device)
        return torch.where(mask, leaf * scale, 0.0)


@dataclasses.dataclass(frozen=True)
class StochasticQuant(Compressor):
    """Dithered fixed-point quantization to ``bits``, UNBIASED.

    Per leaf: ``s = max|leaf| / L`` with ``L = 2^(bits-1) - 1`` (one scale
    shared across clients), then ``q = clip(floor(leaf/s + u), -L, L)``
    with a shared dither ``u ~ U[0,1)``; the round-trip transmits ``q*s``.
    ``per_client_dither=True`` (``pq<b>``) draws an independent dither per
    client row instead.

    ``use_kernel=True`` (the port's default, unlike the reference's
    False) routes the round-trip through ``kernels/ops.py``: the CUDA
    kernel for a CUDA tensor. The reason is ``FedCET.use_fused_kernel``'s:
    eager PyTorch has no fuser, so the hand-written kernel IS the fusion,
    and it broadcasts the shared dither instead of materializing it over
    the clients. On the CPU ``ops`` computes the plain expression, so both
    settings agree there."""

    bits: int = 8
    use_kernel: bool = True
    per_client_dither: bool = False

    requires_key = True
    unbiased = True

    def __post_init__(self):
        if not 2 <= self.bits <= 16:
            raise ValueError(f"StochasticQuant bits must be in [2, 16], got "
                             f"{self.bits}")

    @property
    def value_bits(self) -> float:
        return float(self.bits)

    def compress(self, key, leaf):
        levels = 2 ** (self.bits - 1) - 1
        ct = (leaf.dtype if leaf.dtype in (torch.float32, torch.float64)
              else torch.float32)
        a = leaf.to(ct)
        scale = torch.amax(torch.abs(a)) / levels
        shape = tuple(a.shape) if self.per_client_dither else _coord_shape(a)
        u = prng.uniform(key, shape, dtype=ct, device=a.device)
        if self.use_kernel:
            return kops.stochastic_quantize(a, u, scale, self.bits).to(
                leaf.dtype)
        inv = torch.where(scale > 0, 1.0 / scale, 0.0)
        q = torch.clamp(torch.floor(a * inv + u), -levels, levels)
        return (q * scale).to(leaf.dtype)

    def arena_dither(self, key, layout: ar.ArenaLayout, lead: int, device):
        """The per-leaf dithers, drawn from the same ``fold_in(key, i)``
        enumeration as the per-leaf path at the same coordinate shapes and
        packed next to the data (pad dither 0 keeps pads at exactly 0)."""
        shapes = [((lead,) + s if self.per_client_dither else s)
                  for s in layout.shapes]
        index = reference_leaf_index(pytree.tree_unflatten(
            [0] * len(shapes), layout.treedef))
        u = [prng.uniform(prng.fold_in(key, index[i]), s, dtype=layout.dtype,
                          device=device) for i, s in enumerate(shapes)]
        return ar.pack_rows(u, layout,
                            lead=lead if self.per_client_dither else None)

    def apply_arena(self, key, msg, extra):
        """Native packed-rows quantization: ONE launch for the whole tree.
        Bitwise-equivalent to the per-leaf path: the per-leaf scale is a
        segment max over the leaf's rows, the dithers come from the same
        key enumeration at the same shapes, and the elementwise expression
        is identical."""
        if (not isinstance(msg, ar.Arena) or msg.data.dim() != 3
                or msg.layout.dtype not in (torch.float32, torch.float64)):
            return super().apply_arena(key, msg, extra)
        lo, a = msg.layout, msg.data
        levels = 2 ** (self.bits - 1) - 1
        scale = arena_scale(a, lo, levels)                       # [rows, 1]
        u = self.arena_dither(key, lo, a.shape[0], a.device)
        if self.use_kernel:
            out = kops.stochastic_quantize_rows(a, u, scale, self.bits)
            return ar.Arena(out, lo), extra
        inv = torch.where(scale > 0, 1.0 / scale, 0.0)
        q = torch.clamp(torch.floor(a * inv + u), -levels, levels)
        return ar.Arena(q * scale, lo), extra


@dataclasses.dataclass(frozen=True)
class NaturalQuant(Compressor):
    """Natural (exponent-only) compression [Horvath et al., 2019],
    UNBIASED: each value keeps its sign and is stochastically rounded to
    one of the two nearest powers of two (for ``2^a <= |v| < 2^(a+1)``,
    ``2^(a+1)`` with probability ``|v|/2^a - 1``, else ``2^a``). A sign bit
    plus an 8-bit exponent is 9 bits a coordinate, with no shared scale;
    ``omega = 1/8``. The rounding dither is shared across clients.

    The exponent is the reference's expression, ``floor(log2(|v|))`` in
    float, then an exact power of two (``jnp.ldexp`` there, built from its
    bits here). Where XLA's and torch's ``log2`` round differently just
    below a power of two, one code can land one bucket apart."""

    requires_key = True
    unbiased = True

    @property
    def value_bits(self) -> float:
        return 9.0  # sign + 8-bit exponent; mantissa dropped

    @property
    def omega(self) -> float:
        """E|C(x) - x|^2 <= (1/8) |x|^2 (Horvath et al., Thm. 7)."""
        return 0.125

    def compress(self, key, leaf):
        ct = (leaf.dtype if leaf.dtype in (torch.float32, torch.float64)
              else torch.float32)
        a = leaf.to(ct)
        mag = torch.abs(a)
        e = torch.floor(torch.log2(torch.where(mag > 0, mag, 1.0)))
        low = _pow2(e, ct)
        # the clip guards floor(log2) at exact powers of two, where float
        # rounding could leave p just outside [0, 1).
        p_up = torch.clamp(mag / low - 1.0, 0.0, 1.0)
        u = prng.uniform(key, _coord_shape(leaf), dtype=ct, device=a.device)
        out = torch.sign(a) * low * torch.where(u < p_up, 2.0, 1.0)
        return torch.where(mag > 0, out, 0.0).to(leaf.dtype)


@dataclasses.dataclass(frozen=True)
class Bf16(Compressor):
    """bfloat16 round-trip (deterministic nearest-even rounding, biased)."""

    @property
    def value_bits(self) -> float:
        return 16.0

    def compress(self, key, leaf):
        del key
        return quantize_bf16(leaf)


@dataclasses.dataclass(frozen=True)
class Chain(Compressor):
    """Left-to-right composition: ``Chain((a, b))`` transmits ``b(a(v))``;
    stage ``i`` draws from ``fold_in(key, i)``.

    Accounting is exact: the value width is the narrowest any stage sets
    (first-narrowest-wins), index bits accumulate per sparsifying stage at
    that stage's survival fraction (``TopK(0.3) + Bf16`` costs ``0.3 * (16
    + 32)`` bits a coordinate)."""

    stages: tuple

    def __post_init__(self):
        if any(s.stateful for s in self.stages):
            raise ValueError("stateful wrappers (ErrorFeedback/Shifted) go "
                             "AROUND a chain, not inside it")

    @property
    def requires_key(self):  # type: ignore[override]
        return any(s.requires_key for s in self.stages)

    @property
    def unbiased(self):  # type: ignore[override]
        return all(s.unbiased for s in self.stages) and bool(self.stages)

    @property
    def keep_frac(self) -> float:
        return math.prod(s.keep_frac for s in self.stages)

    @property
    def omega(self) -> float:
        """Independent unbiased stages compose as 1+w = prod_i (1+w_i)."""
        return math.prod(1.0 + s.omega for s in self.stages) - 1.0

    @property
    def index_bits(self) -> float:
        """Position bits per FINALLY-kept coordinate: each sparsifying
        stage pays its indices at its survival fraction, normalized by the
        end-to-end keep fraction, so ``keep_frac * (value + index)``
        reproduces the exact sum."""
        keep, idx = 1.0, 0.0
        for s in self.stages:
            keep *= s.keep_frac
            idx += keep * s.index_bits
        return idx / keep if keep > 0 else 0.0

    @property
    def value_bits(self) -> float | None:
        """First-narrowest-wins: a later, wider stage re-encodes already
        narrow values and cannot widen the payload."""
        vb = None
        for s in self.stages:
            if s.value_bits is not None:
                vb = s.value_bits if vb is None else min(vb, s.value_bits)
        return vb

    def compress(self, key, leaf):
        for i, s in enumerate(self.stages):
            sub = (prng.fold_in(key, i)
                   if (s.requires_key and key is not None) else None)
            leaf = s.compress(sub, leaf)
        return leaf


@dataclasses.dataclass(frozen=True)
class ErrorFeedback(Compressor):
    """Client-side error feedback around an inner compressor: ``e += msg;
    tx = C(e); e -= tx``, so the compression error is re-injected next
    round instead of lost. The per-client memory ``e`` is transform extra
    state riding in the engine state (checkpointed with the run).

    Meant for BIASED inner compressors (TopK, Bf16): around an unbiased
    stochastic one it reintroduces a feedback limit cycle, so
    :func:`auto_wrap` applies it to biased compressors only."""

    inner: Compressor

    stateful = True

    def __post_init__(self):
        if self.inner.stateful:
            raise ValueError("cannot nest stateful wrappers: "
                             f"ErrorFeedback({type(self.inner).__name__})")

    @property
    def requires_key(self):  # type: ignore[override]
        return self.inner.requires_key

    @property
    def keep_frac(self) -> float:
        return self.inner.keep_frac

    @property
    def index_bits(self) -> float:
        return self.inner.index_bits

    @property
    def value_bits(self) -> float | None:
        return self.inner.value_bits

    @property
    def bits_per_coord(self) -> float:
        return self.inner.bits_per_coord

    def compress(self, key, leaf):
        raise TypeError("ErrorFeedback is stateful; use apply(), not compress()")

    def init_extra(self, msg_like):
        return tree_map(torch.zeros_like, msg_like)

    def apply(self, key, msg, extra):
        carried = tree_map(torch.add, extra, msg)
        tx, _ = self.inner.apply(key, carried, None)
        return tx, tree_map(torch.sub, carried, tx)


@dataclasses.dataclass(frozen=True)
class Shifted(Compressor):
    """DIANA-style shifted compression: compress the RESIDUAL against a
    per-client shift ``h`` that both ends track from transmitted data::

        q  = C(msg - h)        (transmitted payload)
        tx = h + q             (server-side reconstruction, enters the mean)
        h' = h + beta * q

    With :class:`StochasticQuant` scaling to ``max|input|``, the step
    shrinks as clients converge, which removes plain dithered
    quantization's re-excitation floor under random participation while
    keeping ``inner``'s wire bits. The shift memory rides in the engine
    state and freezes for absent clients."""

    inner: Compressor
    #: shift step; None = the DIANA-stable ``1/(1 + inner.omega)``.
    beta: float | None = None

    stateful = True

    def __post_init__(self):
        if self.inner.stateful:
            raise ValueError("cannot nest stateful wrappers: "
                             f"Shifted({type(self.inner).__name__})")

    @property
    def step(self) -> float:
        return 1.0 / (1.0 + self.inner.omega) if self.beta is None else self.beta

    @property
    def requires_key(self):  # type: ignore[override]
        return self.inner.requires_key

    @property
    def unbiased(self):  # type: ignore[override]
        return self.inner.unbiased

    @property
    def keep_frac(self) -> float:
        return self.inner.keep_frac

    @property
    def index_bits(self) -> float:
        return self.inner.index_bits

    @property
    def value_bits(self) -> float | None:
        return self.inner.value_bits

    @property
    def bits_per_coord(self) -> float:
        return self.inner.bits_per_coord

    def compress(self, key, leaf):
        raise TypeError("Shifted is stateful; use apply(), not compress()")

    def init_extra(self, msg_like):
        return tree_map(torch.zeros_like, msg_like)

    def apply(self, key, msg, extra):
        resid = tree_map(torch.sub, msg, extra)
        q, _ = self.inner.apply(key, resid, None)
        recon = tree_map(torch.add, extra, q)
        b = self.step
        shift = tree_map(lambda h, qq: h + b * qq, extra, q)
        return recon, shift


# -------------------------------------------------- exact per-leaf wire bits
def _wire_stages(comp: Compressor) -> list:
    """The billable stage list of a compressor stack: stateful wrappers
    bill their inner compressor (EF and shift memories never ride the
    wire), chains flatten to their stages."""
    while isinstance(comp, (ErrorFeedback, Shifted)):
        comp = comp.inner
    return list(comp.stages) if isinstance(comp, Chain) else [comp]


def _stages_wire_bits(stages, n: int) -> float:
    """Exact wire bits for one leaf of ``n`` coords through a stage list:
    the actual kept count ``max(1, round(cum_keep * n))``, index bits per
    sparsifying stage at the count after it, first-narrowest-wins value
    width."""
    frac, kept, idx, value = 1.0, float(n), 0.0, None
    for s in stages:
        kf = s.keep_frac
        if kf < 1.0:
            frac *= kf
            kept = float(_k_of(frac, n))
        idx += kept * s.index_bits
        vb = s.value_bits
        if vb is not None:
            value = vb if value is None else min(value, vb)
    return kept * (32.0 if value is None else value) + idx


def stack_wire_bits(stack, index: int, name: str, n: int) -> float:
    """Exact wire bits one client pays for leaf ``(index, name)`` of ``n``
    coords through a TRANSFORM stack (one compressor per attached engine
    transform, applied left to right). Plans resolve to their per-leaf
    rule first; ``None`` entries bill nothing. Both lowerings (per leaf and
    arena) bill through this one rule."""
    stages: list = []
    for comp in stack:
        if isinstance(comp, CompressionPlan):
            comp = comp.resolve(index, name)
        if comp is None:
            continue
        stages.extend(_wire_stages(comp))
    return _stages_wire_bits(stages, n)


# --------------------------------------------------------- per-leaf planning
def _match_leaf(name: str, pattern: str) -> bool:
    """Glob match against the slash-joined leaf path or any one of its
    components (``embed*`` matches ``embed/w``, ``ln*`` matches
    ``layers/0/ln1/weight``)."""
    return (fnmatch.fnmatchcase(name, pattern)
            or any(fnmatch.fnmatchcase(part, pattern)
                   for part in name.split("/")))


@dataclasses.dataclass(frozen=True)
class CompressionPlan(Compressor):
    """Per-leaf compression policy: an ordered ``(pattern, compressor)``
    rule list resolved FIRST-MATCH-WINS against each message leaf.

    Patterns are globs over the slash-joined leaf path (the names of
    ``core/comm.py:leaf_info_of``), matched against the full path or any
    single component, or all-digit strings naming a flatten-order leaf
    index (the order of ``ArenaLayout.row_segments``). Unmatched leaves
    fall through to ``default`` (``None`` = dense f32 passthrough).

    Leaf ``i`` is compressed with subkey ``fold_in(key, j)``, ``j`` its
    :func:`reference_leaf_index` (the uniform per-tree enumeration), and stateful rule wrappers (:class:`Shifted`,
    :class:`ErrorFeedback`) run leaf by leaf against a message-shaped
    memory tree: a plan mapping EVERY leaf to one spec is bitwise equal to
    uniform ``with_compression`` with that spec, and checkpoints
    interchange between the two. Arena messages unpack, apply per leaf and
    repack (flatten order == layout order), so both lowerings compress and
    bill identically.

    ``leaves`` optionally binds the leaf decomposition ``((name, n),
    ...)`` so the scalar accounting (``bits_per_coord``) is exact; unbound
    plans estimate it from their catch-all rule. Per-leaf billing
    (``CommMeter.for_params``, ``comm_bits_per_round(..., leaf_info=)``)
    is always exact."""

    rules: tuple = ()
    default: Compressor | None = None
    #: optional bound leaf decomposition ((name, n_coords), ...); attach
    #: via ``bind`` / ``allocate``.
    leaves: tuple | None = None

    def __post_init__(self):
        for _, comp in self.rules:
            if comp is not None and isinstance(comp, CompressionPlan):
                raise ValueError("plans cannot nest inside plans")
        if self.default is not None and self.default.stateful:
            raise ValueError("the default rule must be stateless; name the "
                             "leaves a stateful wrapper should cover (a "
                             "'*' catch-all rule may be stateful)")

    # ------------------------------------------------------------ resolution
    def resolve(self, index: int, name: str) -> Compressor | None:
        """The compressor for leaf ``(index, name)``: first matching rule,
        else ``default``, else None (dense passthrough)."""
        for pat, comp in self.rules:
            if pat.isdigit():
                if int(pat) == index:
                    return comp
            elif _match_leaf(name, pat):
                return comp
        return self.default

    def _rule_comps(self):
        comps = [c for _, c in self.rules if c is not None]
        if self.default is not None:
            comps.append(self.default)
        return comps

    # ------------------------------------------------------------ accounting
    @property
    def stateful(self):  # type: ignore[override]
        return any(c.stateful for c in self._rule_comps())

    @property
    def requires_key(self):  # type: ignore[override]
        return any(c.requires_key for c in self._rule_comps())

    @property
    def unbiased(self):  # type: ignore[override]
        return all(c.unbiased for c in self._rule_comps())

    @property
    def omega(self) -> float:
        return max((c.omega for c in self._rule_comps()), default=0.0)

    @property
    def keep_frac(self):  # type: ignore[override]
        """None on purpose: a plan has no single keep fraction; the
        engine's ``_transforms_bits`` falls through to ``bits_per_coord``
        and per-leaf billing uses ``stack_wire_bits``."""
        return None

    @property
    def index_bits(self):  # type: ignore[override]
        return None

    @property
    def value_bits(self) -> float | None:
        return None

    @property
    def bits_per_coord(self) -> float:
        """Size-weighted average wire bits per coordinate: EXACT when the
        plan is bound to a leaf decomposition, else estimated from the
        catch-all rule (32.0 if none)."""
        if self.leaves:
            total = sum(n for _, n in self.leaves)
            return sum(self.tree_wire_bits(self.leaves)) / float(total)
        for pat, comp in self.rules:
            if pat == "*":
                return 32.0 if comp is None else comp.bits_per_coord
        return 32.0 if self.default is None else self.default.bits_per_coord

    def leaf_wire_bits(self, index: int, name: str, n: int) -> float:
        comp = self.resolve(index, name)
        return float(n) * 32.0 if comp is None else comp.wire_bits(n)

    def tree_wire_bits(self, leaf_info) -> list:
        """Exact per-leaf wire bits for a ``[(name, n), ...]`` leaf
        decomposition (one client, one up-vector)."""
        return [self.leaf_wire_bits(i, nm, int(n))
                for i, (nm, n) in enumerate(leaf_info)]

    def bind(self, leaf_info) -> "CompressionPlan":
        """Attach the leaf decomposition so scalar accounting is exact."""
        info = tuple((str(nm), int(n)) for nm, n in leaf_info)
        return dataclasses.replace(self, leaves=info)

    # -------------------------------------------------------------- compute
    def compress(self, key, leaf):
        raise TypeError("CompressionPlan is a whole-tree policy; "
                        "use apply(), not compress()")

    def init_extra(self, msg_like):
        """One message-shaped memory tree when ANY rule is stateful (the
        structure the uniform Shifted / ErrorFeedback wrappers carry, so
        checkpoints interchange); leaves whose rule is stateless keep
        zeros there untouched."""
        if not self.stateful:
            return None
        return tree_map(torch.zeros_like, msg_like)

    def _apply_leaf(self, comp, sub, leaf, e):
        """One leaf through its resolved rule: stateful wrappers run with
        EXACTLY the uniform wrappers' math and key gating."""
        if comp is None:
            return leaf, e
        if isinstance(comp, ErrorFeedback):
            carried = e + leaf
            tx = comp.inner.compress(
                sub if comp.inner.requires_key else None, carried)
            return tx, carried - tx
        if isinstance(comp, Shifted):
            resid = leaf - e
            q = comp.inner.compress(
                sub if comp.inner.requires_key else None, resid)
            return e + q, e + comp.step * q
        return comp.compress(sub if comp.requires_key else None, leaf), e

    def apply(self, key, msg, extra):
        if _has_arena(msg):
            return self.apply_arena(key, msg, extra)
        flat, spec = pytree.tree_flatten_with_path(msg)
        e_leaves = (tree_leaves(extra) if extra is not None
                    else [None] * len(flat))
        index = reference_leaf_index(msg)
        out, new_e = [], []
        for i, ((path, leaf), e) in enumerate(zip(flat, e_leaves)):
            comp = self.resolve(i, leaf_name(path))
            sub = (prng.fold_in(key, index[i])
                   if key is not None and comp is not None
                   and comp.requires_key else None)
            o, ne = self._apply_leaf(comp, sub, leaf, e)
            out.append(o)
            new_e.append(ne)
        out = pytree.tree_unflatten(out, spec)
        if extra is None:
            return out, None
        return out, pytree.tree_unflatten(new_e, spec)

    def apply_arena(self, key, msg, extra):
        """Unpack message AND memory, apply per leaf, repack both: the
        unpacked tree flattens in the arena's layout order, so rule
        resolution, subkeys and wrapper memories are IDENTICAL to the
        per-leaf lowering."""
        out, new_e = self.apply(
            key, _unpack_tree(msg),
            _unpack_tree(extra) if extra is not None else None)
        out = _repack_tree(msg, out)
        if extra is None:
            return out, None
        return out, _repack_tree(extra, new_e)

    # ------------------------------------------------------------- allocator
    def allocate(self, budget_bits_per_round: float, *, leaves,
                 sensitivity="rms", grads=None, wrap: str | None = "shift",
                 min_bits: int = 2, max_bits: int = 12) -> "CompressionPlan":
        """Greedy bit-budget allocation: per-leaf quantizer widths (or one
        shared ``k_frac`` when the budget is below the all-``min_bits``
        floor) meeting a TOTAL uplink budget of ``budget_bits_per_round``
        bits per client per round; returns the bound plan.

        ``leaves`` is the message / params tree (or a ``[(name, n)]``
        decomposition). ``sensitivity`` weighs leaves: ``"rms"``
        (per-leaf root-mean-square), ``"absmax"`` (per-leaf ``max|x|``,
        the grid scale StochasticQuant uses), ``"grad_norm"`` (``|g| /
        sqrt(n)`` of the ``grads`` tree), an explicit per-leaf sequence,
        or None (uniform). Dithered quantization at ``b`` bits costs
        ``~ n s^2 4^-b`` mean-square error, so the allocator water-fills,
        granting +1 bit to the leaf with the highest ``s_i^2 4^-b_i`` that
        still fits. ``wrap`` wraps every per-leaf quantizer (``"shift"``,
        ``"ef"``, or None = bare)."""
        if isinstance(leaves, (list, tuple)) and leaves \
                and isinstance(leaves[0], (list, tuple)) \
                and len(leaves[0]) == 2 and isinstance(leaves[0][1], int):
            info = [(str(nm), int(n)) for nm, n in leaves]
            values = None
        else:
            info = leaf_info_of(leaves)
            values = tree_leaves(leaves)
        if sensitivity is None or sensitivity == "uniform":
            s = [1.0] * len(info)
        elif isinstance(sensitivity, str):
            if sensitivity == "rms":
                if values is None:
                    raise ValueError("sensitivity='rms' needs the actual "
                                     "leaf arrays, not a (name, n) list")
                s = [float(torch.sqrt(torch.mean(torch.square(
                    v.to(torch.float32))))) for v in values]
            elif sensitivity == "absmax":
                if values is None:
                    raise ValueError("sensitivity='absmax' needs the "
                                     "actual leaf arrays")
                s = [float(torch.amax(torch.abs(v.to(torch.float32))))
                     for v in values]
            elif sensitivity == "grad_norm":
                if grads is None:
                    raise ValueError("sensitivity='grad_norm' needs grads=")
                s = [float(torch.linalg.vector_norm(
                    g.to(torch.float32).reshape(-1))
                    / math.sqrt(max(g.numel(), 1)))
                    for g in tree_leaves(grads)]
            else:
                raise ValueError(f"unknown sensitivity {sensitivity!r} "
                                 "(rms | absmax | grad_norm | sequence "
                                 "| None)")
        else:
            s = [float(v) for v in sensitivity]
        if len(s) != len(info):
            raise ValueError(f"sensitivity has {len(s)} entries for "
                             f"{len(info)} leaves")
        max_bits = min(max_bits, 16)
        floor_cost = sum(n for _, n in info) * min_bits
        mk_wrap = {"shift": Shifted, "ef": ErrorFeedback,
                   None: lambda c: c, "none": lambda c: c}[wrap]
        if budget_bits_per_round < floor_cost:
            # below the all-min_bits floor: trade coordinates, not width;
            # one shared k_frac scales the whole message into budget.
            k = max(budget_bits_per_round / float(floor_cost), 1.0 / 64.0)
            rules = tuple(
                (nm, mk_wrap(Chain((RandK(k), StochasticQuant(min_bits)))))
                for nm, _ in info)
            return CompressionPlan(rules=rules, leaves=tuple(info))
        bits = [min_bits] * len(info)
        spend = budget_bits_per_round - floor_cost
        heap = [(-(s[i] ** 2 * 4.0 ** -bits[i]), i)
                for i in range(len(info)) if s[i] > 0.0]
        heapq.heapify(heap)
        while heap:
            _, i = heapq.heappop(heap)
            n_i = info[i][1]
            if bits[i] >= max_bits or n_i > spend:
                continue  # this leaf is done; cheaper leaves may still fit
            bits[i] += 1
            spend -= n_i
            heapq.heappush(heap, (-(s[i] ** 2 * 4.0 ** -bits[i]), i))
        rules = tuple((nm, mk_wrap(StochasticQuant(bits[i])))
                      for i, (nm, _) in enumerate(info))
        return CompressionPlan(rules=rules, leaves=tuple(info))

    def tightened(self, *, bits_step: int = 1, k_scale: float = 0.5,
                  min_bits: int = 2, min_k: float = 1.0 / 64.0
                  ) -> "CompressionPlan":
        """One adaptive-schedule step: every quantizer drops ``bits_step``
        bits (floor ``min_bits``) and every sparsifier scales its
        ``k_frac`` by ``k_scale`` (floor ``min_k``). Wrapper structure,
        and so the carried memory's shape, is preserved: the tightened
        plan swaps into a live run without touching the engine state."""
        def t(c):
            if c is None:
                return None
            if isinstance(c, (ErrorFeedback, Shifted)):
                return dataclasses.replace(c, inner=t(c.inner))
            if isinstance(c, Chain):
                return Chain(tuple(t(stg) for stg in c.stages))
            if isinstance(c, StochasticQuant):
                return dataclasses.replace(
                    c, bits=max(min_bits, c.bits - bits_step))
            if isinstance(c, (TopK, RandK)):
                return dataclasses.replace(
                    c, k_frac=max(min_k, c.k_frac * k_scale))
            return c

        return dataclasses.replace(
            self, rules=tuple((p, t(c)) for p, c in self.rules),
            default=t(self.default))


@dataclasses.dataclass
class AdaptivePlan:
    """Telemetry-driven plan schedule: call ``update(compress_err)`` with
    the round's compression residual; each time it has shrunk by
    ``factor`` since the last tightening, the plan tightens one step
    (``CompressionPlan.tightened``) and the NEW plan is returned (else
    None). The caller re-attaches it; the extras' shapes are preserved, so
    the live engine state carries over unchanged."""

    plan: CompressionPlan
    factor: float = 10.0
    min_bits: int = 2
    ref_err: float | None = None

    def update(self, compress_err: float) -> CompressionPlan | None:
        err = float(compress_err)
        if not math.isfinite(err) or err <= 0.0:
            return None
        if self.ref_err is None:
            self.ref_err = err
            return None
        if err * self.factor <= self.ref_err:
            self.plan = self.plan.tightened(min_bits=self.min_bits)
            self.ref_err = err
            return self.plan
        return None


def parse_plan(spec, *, error_feedback: bool | None = None
               ) -> CompressionPlan | None:
    """Parse the launch-config plan grammar: comma-separated
    ``pattern:compressor-spec`` rules, first-match-wins, e.g.
    ``"embed*:q12,ln*:bf16,*:shift:q6"``. The pattern is everything before
    the FIRST colon (a glob over slash-joined leaf paths, or an all-digit
    leaf index); the rest is a full :func:`from_spec` spec.
    ``pattern:none`` pins matched leaves to dense passthrough. Each rule
    goes through the uniform path's :func:`auto_wrap` policy, which keeps
    an all-one-spec plan bitwise equal to uniform ``with_compression``."""
    if spec is None or isinstance(spec, CompressionPlan):
        return spec
    if not isinstance(spec, str):
        raise TypeError(f"not a compression plan: {spec!r}")
    s = spec.strip()
    if s.lower() in ("", "none", "off"):
        return None
    rules = []
    for part in s.split(","):
        part = part.strip()
        if not part:
            continue
        pat, sep, cspec = part.partition(":")
        pat = pat.strip()
        if not sep or not pat or not cspec.strip():
            raise ValueError(
                f"bad plan rule {part!r} (want 'pattern:spec', e.g. "
                "'embed*:q12' or '*:shift:q8'); full grammar: "
                "'embed*:q12,ln*:bf16,*:shift:q6'")
        rules.append((pat, auto_wrap(from_spec(cspec.strip()),
                                     error_feedback)))
    return CompressionPlan(rules=tuple(rules))


# ------------------------------------------------------------------ parsing
def _parse_stage(tok: str) -> Compressor:
    name, _, arg = tok.partition(":")
    name = name.strip().lower()
    if name == "topk":
        return TopK(float(arg), per_client=True)
    if name == "topk_global":
        return TopK(float(arg), per_client=False)
    if name == "randk":
        return RandK(float(arg))
    if name in ("quant", "q"):
        return StochasticQuant(bits=int(arg))
    if name.startswith("q") and name[1:].isdigit():
        return StochasticQuant(bits=int(name[1:]))
    if name.startswith("pq") and name[2:].isdigit():  # per-client dither
        return StochasticQuant(bits=int(name[2:]), per_client_dither=True)
    if name == "nat":
        return NaturalQuant()
    if name == "bf16":
        return Bf16()
    raise ValueError(f"unknown compressor spec {tok!r} (try topk:0.3, "
                     "topk_global:0.3, randk:0.25, q8, pq8, nat, bf16, "
                     "ef:..., a+b)")


def from_spec(spec: str | Compressor | None) -> Compressor | None:
    """Parse a launch-config compression spec into a Compressor (or None).

    Grammar: ``none`` | stage (``+`` stage)* with an optional ``ef:`` or
    ``shift:`` prefix around the whole chain. Stages: ``topk:<frac>``
    (per-client), ``topk_global:<frac>`` (legacy cross-client),
    ``randk:<frac>``, ``q<bits>`` / ``quant:<bits>``, ``pq<bits>``
    (per-client dither), ``nat``, ``bf16``. Examples: ``"randk:0.25"``,
    ``"ef:topk:0.3+bf16"``, ``"shift:q8"``."""
    if spec is None or isinstance(spec, Compressor):
        return spec
    s = spec.strip().lower()
    if s in ("", "none", "off"):
        return None
    wrap = None
    if s.startswith("ef:"):
        wrap, s = ErrorFeedback, s[3:]
    elif s.startswith("shift:"):
        wrap, s = Shifted, s[6:]
    stages = tuple(_parse_stage(tok) for tok in s.split("+") if tok.strip())
    if not stages:
        raise ValueError(f"empty compressor spec {spec!r} (a bare ef:/shift: "
                         "prefix would wrap a no-op in model-size memory)")
    comp: Compressor = stages[0] if len(stages) == 1 else Chain(stages)
    return wrap(comp) if wrap else comp


def auto_wrap(comp: Compressor | None,
              error_feedback: bool | None = None) -> Compressor | None:
    """The default error-feedback policy, shared by the engine's
    ``with_compression``, plan rules and hierarchical tier recompression
    (``core/topology.py``): wrap BIASED STATELESS compressors in
    :class:`ErrorFeedback`, leave everything else bare. Pass
    ``error_feedback=True/False`` to force either way; ``None`` passes
    through."""
    if comp is None:
        return None
    ef = ((not comp.unbiased and not comp.stateful)
          if error_feedback is None else error_feedback)
    if ef and not isinstance(comp, ErrorFeedback):
        comp = ErrorFeedback(comp)  # raises if comp is stateful
    return comp


def as_compressor(obj: Any) -> Compressor:
    """Coerce a Compressor or spec string; reject None and unknown types."""
    comp = from_spec(obj)
    if not isinstance(comp, Compressor):
        raise TypeError(f"not a compressor: {obj!r}")
    return comp
