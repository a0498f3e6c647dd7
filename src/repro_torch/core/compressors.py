"""Message compressors for the round engine, the subset the compressed
FedCET round needs (port of ``src/repro/core/compressors.py``:
``Compressor`` :131-228, ``Identity``, ``StochasticQuant`` :311-408,
``Shifted`` :598-670, the exact wire-bit walk :674-716, ``from_spec`` /
``_parse_stage`` :1121-1169 and ``auto_wrap`` :1172-1187).

A :class:`Compressor` is a stateless ``compress(key, leaf) -> leaf``
object attached to an engine algorithm through ``with_compression(...,
compressor=...)`` (``core/engine.py``). Message leaves are STACKED
``[clients, ...]`` tensors, axis 0 the client axis. Stochastic compressors
receive a per-round key derived from the engine state's step counter and
draw randomness SHARED across clients (one dither per round, the same for
every client and the server): clients at consensus then transmit identical
messages, which keeps FedCET's fixed point exact, and unbiasedness keeps
the drift update mean-zero. Keys and draws are ``core/prng.py``'s, bit for
bit those of ``jax.random``, so a compressed run is comparable with the
reference's run for run.

Accounting contract: every compressor declares ``keep_frac``,
``index_bits``, ``value_bits`` and derives ``bits_per_coord`` (exact wire
bits per dense-f32 coordinate) and ``up_frac``; ``wire_bits(n)`` is the
exact per-leaf cost.

Grammar of :func:`from_spec` in this slice: ``none``, ``q<b>`` /
``quant:<b>``, ``pq<b>`` (per-client dither), with an optional
``shift:`` prefix (DIANA-style shifted compression). The other stages
(``topk``, ``randk``, ``nat``, ``bf16``), ``+`` chains and the ``ef:``
prefix raise ``NotImplementedError`` naming the slice that ports them.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.utils import _pytree as pytree

from repro_torch.core import arena as ar
from repro_torch.core import prng
from repro_torch.kernels import ops as kops
from repro_torch.utils.tree import tree_map

__all__ = ["Compressor", "Identity", "Shifted", "StochasticQuant",
           "arena_scale", "auto_wrap", "from_spec", "stack_wire_bits"]

#: stages and wrappers whose port comes later.
_LATER_STAGES = {
    "topk": "TopK", "topk_global": "TopK", "randk": "RandK",
    "nat": "NaturalQuant", "bf16": "Bf16",
}
_LATER_SLICE = "a later slice of the port (ROADMAP Queue 1 item 6)"


def _coord_shape(leaf) -> tuple:
    """The per-client coordinate space of a stacked leaf (axis 0 is ALWAYS
    the client axis)."""
    return tuple(leaf.shape[1:])


def _is_arena(x) -> bool:
    return isinstance(x, ar.Arena)


def _has_arena(tree) -> bool:
    return any(map(_is_arena, pytree.tree_leaves(tree, is_leaf=_is_arena)))


def _k_of(k_frac: float, n: int) -> int:
    return max(1, int(round(k_frac * n)))


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
    #: does apply() carry per-client memory in `extra` (Shifted)?
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
        """Variance parameter of an unbiased compressor; drives
        :class:`Shifted`'s stable step ``beta = 1/(1+omega)``."""
        return 0.0

    def wire_bits(self, n: int) -> float:
        """EXACT uplink wire bits one client pays for one leaf of ``n``
        coordinates."""
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
        leaf. Arena-packed messages route through ``apply_arena``."""
        if _has_arena(msg):
            return self.apply_arena(key, msg, extra)
        leaves, spec = pytree.tree_flatten(msg)
        out = [self.compress(prng.fold_in(key, i) if self.requires_key
                             else None, leaf)
               for i, leaf in enumerate(leaves)]
        return pytree.tree_unflatten(out, spec), extra

    def apply_arena(self, key, msg, extra):
        """Compress an arena-packed message: unpack each Arena to its
        stacked per-leaf tree, compress leaf by leaf, repack. The unpacked
        tree flattens in the arena's layout order, so subkeys, scales and
        dithers are IDENTICAL to the per-leaf engine's. Compressors whose
        math runs over packed rows override this (StochasticQuant)."""
        nodes, spec = pytree.tree_flatten(msg, is_leaf=_is_arena)
        unpacked = pytree.tree_unflatten(
            [ar.unpack(a) if _is_arena(a) else a for a in nodes], spec)
        out, extra = self.apply(key, unpacked, extra)
        packed = [ar.pack(o, a.layout) if _is_arena(a) else o
                  for a, o in zip(nodes, spec.flatten_up_to(out))]
        return pytree.tree_unflatten(packed, spec), extra


@dataclasses.dataclass(frozen=True)
class Identity(Compressor):
    """Exact no-op."""

    def compress(self, key, leaf):
        del key
        return leaf


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
        u = [prng.uniform(prng.fold_in(key, i), s, dtype=layout.dtype,
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
    bill their inner compressor (shift memories never ride the wire)."""
    while isinstance(comp, Shifted):
        comp = comp.inner
    return [comp]


def _stages_wire_bits(stages, n: int) -> float:
    """Exact wire bits for one leaf of ``n`` coords through a stage list:
    the actual kept count ``max(1, round(cum_keep * n))``, index bits per
    sparsifying stage, first-narrowest-wins value width."""
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
    transform, applied left to right); ``None`` entries bill nothing."""
    del index, name  # per-leaf plans resolve on these (a later slice)
    stages: list = []
    for comp in stack:
        if comp is None:
            continue
        stages.extend(_wire_stages(comp))
    return _stages_wire_bits(stages, n)


# ------------------------------------------------------------------ parsing
def _parse_stage(tok: str) -> Compressor:
    name, _, arg = tok.partition(":")
    name = name.strip().lower()
    if name in ("quant", "q"):
        return StochasticQuant(bits=int(arg))
    if name.startswith("q") and name[1:].isdigit():
        return StochasticQuant(bits=int(name[1:]))
    if name.startswith("pq") and name[2:].isdigit():  # per-client dither
        return StochasticQuant(bits=int(name[2:]), per_client_dither=True)
    if name in _LATER_STAGES:
        raise NotImplementedError(
            f"compressor stage {tok!r} ({_LATER_STAGES[name]}) is not yet "
            f"ported to PyTorch: it comes with {_LATER_SLICE}")
    raise ValueError(f"unknown compressor spec {tok!r} (try q8, quant:8, "
                     "pq8, shift:q8)")


def from_spec(spec: str | Compressor | None) -> Compressor | None:
    """Parse a launch-config compression spec into a Compressor (or None).

    Grammar in this slice: ``none`` | stage with an optional ``shift:``
    prefix; stages ``q<bits>`` / ``quant:<bits>`` / ``pq<bits>``. Examples:
    ``"q8"``, ``"shift:q8"``, ``"pq8"``."""
    if spec is None or isinstance(spec, Compressor):
        return spec
    s = spec.strip().lower()
    if s in ("", "none", "off"):
        return None
    wrap = None
    if s.startswith("ef:"):
        raise NotImplementedError(
            f"{spec!r}: error feedback (ErrorFeedback) is not yet ported to "
            f"PyTorch: it comes with {_LATER_SLICE}")
    if s.startswith("shift:"):
        wrap, s = Shifted, s[6:]
    toks = [tok for tok in s.split("+") if tok.strip()]
    if not toks:
        raise ValueError(f"empty compressor spec {spec!r} (a bare shift: "
                         "prefix would wrap a no-op in model-size memory)")
    if len(toks) > 1:
        raise NotImplementedError(
            f"{spec!r}: chained stages (Chain) are not yet ported to "
            f"PyTorch: they come with {_LATER_SLICE}")
    comp = _parse_stage(toks[0])
    return wrap(comp) if wrap else comp


def auto_wrap(comp: Compressor | None,
              error_feedback: bool | None = None) -> Compressor | None:
    """The default error-feedback policy: BIASED STATELESS compressors
    would be wrapped in ``ErrorFeedback`` (not ported in this slice, so
    that case raises); unbiased or stateful ones stay bare. ``None``
    passes through."""
    if comp is None:
        return None
    ef = ((not comp.unbiased and not comp.stateful)
          if error_feedback is None else error_feedback)
    if ef:
        raise NotImplementedError(
            f"error feedback around {comp!r} is not yet ported to PyTorch: "
            f"it comes with {_LATER_SLICE}")
    return comp
