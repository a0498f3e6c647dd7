"""The federated round engine: the synchronous round with message
compression, client sampling, the packed arena and aggregation topologies
(port of ``src/repro/core/engine.py``).

Every algorithm shares the paper's round structure (Remark 2): ``tau - 1``
pure-local steps, then ONE aggregating step in which each client transmits
a message, the server reduces it, and clients apply the result. The engine
owns that structure once; an algorithm is a frozen-dataclass *spec* with
the reference's hooks, under identical names and signatures:

* ``init_warmup(gf, x0, init_batch) -> (state, run_init_comm_step)``;
* ``begin_round(gf, state, first_batch, agg) -> (state, rctx)``;
* ``local_step(gf, state, batch, rctx) -> state``;
* ``message(gf, state, batch, rctx) -> (msg, mctx)``;
* ``server_aggregate(state, msg, msg_bar, mctx, rctx) -> state``;
* ``_fused_tail(inner, msg, mctx, extras, step, mask)``, optional.

Composable factories, as in the reference:

* :func:`with_compression` inserts a ``core/compressors.py`` compressor
  into the message path (:class:`MessageCompression`, with a fresh PRNG key
  per round from the state's step counter), a per-leaf
  ``CompressionPlan``, or the legacy top-k + bf16 error-feedback form
  (:class:`ErrorFeedbackCompression`); transform memory (the shift ``h``
  of ``shift:q8``, the error-feedback memory of ``ef:``) rides in an
  :class:`EngineState` wrapper, and the
  spec's ``server_aggregate`` receives the client's own COMPRESSED message
  as ``msg`` (so FedCET's ``sum_i d_i = 0`` survives) and the exact local
  vector in ``mctx``;
* :func:`with_participation` draws a Bernoulli client mask per round
  (from the step counter), averages over present clients only and freezes
  absent ones;
* :func:`with_arena` packs the model tree into the ``[clients, rows,
  1024]`` arena of ``core/arena.py``, unpacked only at the gradient
  boundary; on plain synchronous arena rounds (no delay, no topology; a
  cohort round never reaches it), the spec's ``_fused_tail`` may run
  compression -> reduce -> aggregate as one kernel;
* :func:`with_topology` replaces the flat star mean with a hierarchical
  tree or a gossip graph (``core/topology.py``), under the same per-client
  weights (uniform, or the participation mask). A stateful topology's
  :class:`~repro_torch.core.topology.TopoState` rides the ``EngineState``
  extras after the transform extras; the aggregating step advances it
  through ``reduce_and_advance``, and ``begin_round`` gets the read-only
  ``reduce``.

* :func:`with_delay` simulates asynchronous rounds on the same seam: a
  per-client delay model decides which uplinks land each round, the
  server keeps the last-known wire message of every client
  (:class:`~repro_torch.core.staleness.DelayState`, the last extras slot)
  and a stale policy (``drop`` / ``last`` / ``poly:a``) turns that buffer
  into the aggregate (``core/staleness.py``). Delay applies after
  compression and composes with participation (absent clients cannot
  deliver; their buffer entry keeps aging).
* :func:`with_cohort` makes per-round work O(cohort) instead of O(N): the
  per-client state stays in the ``[N, ...]`` client store, and each round
  gathers the sampled cohort's rows, runs ``begin_round``, the local steps
  and ``message`` on them (phase A), runs every cross-client step on
  cohort-sized arrays (phase B: transforms, the delay buffer, the weighted
  reduce, ``server_aggregate``, the participation freeze) and writes the
  rows back IN PLACE (``index_copy_``): the round consumes its input
  store, as the reference's donated carry does. ``lowering="dense"`` runs
  phase A on all N rows and gathers the results instead (the O(N)
  reference the tests hold the gather lowering to). Gossip topologies and
  FedLin's cross-client top-k refuse a cohort.
* :func:`with_telemetry` attaches the in-round telemetry spec of
  ``core/telemetry.py``: the round captures gradient and message norms,
  compression error, the participation count, the staleness ages and the
  cohort's ids onto the tape the round runner opens, and
  :func:`make_round_runner` stacks the finalized per-round metrics
  (invariant residual, consensus error, sketches) next to its own. With no
  spec attached no capture op runs.

Random draws take the reference's canonical dtypes, chosen by the
engine's ``x64`` field (never a global): with ``x64`` (the default) the
participation mask, the within-cohort mask, ``geom:p`` arrivals, ``poly:a``
weights, topology weights and every compressor key draw in float64 /
int64, the reference's dtypes under ``jax_enable_x64`` (its tests and the
float64 quadratic); without it in float32 / int32, its dtypes on the
float32 LM entry points (``run_training`` builds its algorithm so).

PyTorch runs eagerly, so the reference's ``lax.scan`` over local steps and
over rounds become Python loops, and the step counter ``t`` is a Python
int: every PRNG key of a round is derived on the host, and only the bulk
draws run on the card. ``spmd_client_axes`` names the clients' mesh axes
of the production round (``launch/train.py:make_plan``): on a state of
DTensors whose dim 0 is sharded over them, each rank computes the
gradients of its own clients (``api.vmap_grads``), the FedCET kernels run
on the local shards (``kernels/ops.py``), and every client mean reduces
across the client axes to a value (``utils/tree.py:tree_client_mean``,
:func:`masked_client_mean`, ``core/staleness.py:weighted_client_mean``).
On plain tensors the field changes nothing.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from repro_torch.core import arena as ar
from repro_torch.core import prng
from repro_torch.core import telemetry as tele
from repro_torch.core.api import GradFn, vmap_grads
from repro_torch.core.comm import sparsified_up_frac
from repro_torch.core.staleness import (DelayState, StalenessConfig,
                                        parse_delay, parse_policy,
                                        weighted_client_mean)
from repro_torch.core.topology import parse_topology
from repro_torch.utils.sharding_ctx import resolve_partial
from repro_torch.utils.tree import tree_client_mean, tree_leaves, tree_map


class EngineState(NamedTuple):
    """Algorithm state plus per-transform extra state (the shift or
    error-feedback memory of stateful compressors), then a stateful
    topology's ``TopoState``, then the delay buffer (``DelayState``) as
    the last slot. Only used when a transform, a stateful topology or a
    delay model is attached; bare algorithms keep their bare spec
    state."""

    inner: Any
    extras: tuple


# --------------------------------------------------------------------- masks
def participation_mask(key, n_clients: int, rate: float) -> torch.Tensor:
    """Bernoulli(rate) participation mask (a CPU bool tensor), guaranteed
    non-empty: if no client draws in, one uniformly random client is forced
    in. The Bernoulli draw and the fallback index use independent subkeys.
    Both take the key's dtypes (``core/prng.py``): float64 / int64 from a
    ``key(seed, x64=True)``, the reference's under ``jax_enable_x64``,
    float32 / int32 otherwise."""
    k_draw, k_fallback = prng.split(key)
    m = prng.bernoulli(k_draw, rate, (n_clients,))
    if bool(m.any()):
        return m
    first = int(prng.randint(k_fallback, (), 0, n_clients))
    return torch.arange(n_clients) == first


def masked_client_mean(tree, mask: torch.Tensor, *, keepdims: bool = True):
    """Mean over the leading clients axis restricted to ``mask``-selected
    clients (the server average under partial participation); on a
    client-sharded DTensor the sum is reduced across the client axes."""
    denom = torch.clamp(mask.to(torch.int64).sum(), min=1)

    def mean_leaf(a):
        mb = mask.reshape((-1,) + (1,) * (a.dim() - 1)).to(a.dtype)
        return resolve_partial(torch.sum(a * mb, dim=0, keepdim=keepdims)
                               / denom.to(a.dtype))

    return tree_map(mean_leaf, tree)


def select_clients(new, old, mask: torch.Tensor, n_clients: int):
    """Per-client select between two same-structure trees: tensors with a
    leading ``n_clients`` axis take ``new`` where the mask is set and
    ``old`` elsewhere; everything else (the step counter) takes ``new``."""

    def sel(n, o):
        if isinstance(n, torch.Tensor) and n.dim() >= 1 \
                and n.shape[0] == n_clients:
            return torch.where(mask.reshape((-1,) + (1,) * (n.dim() - 1)),
                               n, o)
        return n

    return tree_map(sel, new, old)


# --------------------------------------------------------------------- cohort
#: domain-separation tag folded into cohort-selection keys (never collides
#: with the participation, compression, delay or topology schedules).
_COHORT_KEY_TAG = 0xC0_807


def _per_client(a, n_clients: int) -> bool:
    return isinstance(a, torch.Tensor) and a.dim() >= 1 \
        and a.shape[0] == n_clients


def gather_clients(tree, idx: torch.Tensor, n_clients: int):
    """The ``idx`` rows of every per-client leaf (leading ``n_clients``
    axis) of the client store; other leaves (the step counter, ``[1, ...]``
    means) pass through."""
    return tree_map(lambda a: a[idx] if _per_client(a, n_clients) else a,
                    tree)


def scatter_clients(store, rows, idx: torch.Tensor, n_clients: int):
    """Write the cohort ``rows`` back into the client ``store`` IN PLACE
    (``index_copy_`` on every per-client leaf: O(cohort) bytes, the
    store's memory kept) and return it; other leaves take the cohort's
    value, as :func:`select_clients` does. The reference writes
    ``x.at[idx].set(rows)`` into a donated carry, which XLA updates in
    place too."""

    def s(o, r):
        if _per_client(o, n_clients):
            return o.index_copy_(0, idx, r.to(o.dtype))
        return r

    return tree_map(s, store, rows)


def _unalias(tree, n_clients: int):
    """``tree`` with every per-client leaf that shares storage with an
    earlier one cloned: an in-place scatter into one must not write into
    the other (a spec whose message returns a state leaf itself seeds the
    delay buffer with that very tensor)."""
    seen = set()

    def own(a):
        if not _per_client(a, n_clients):
            return a
        ptr = a.untyped_storage().data_ptr()
        if ptr in seen:
            return a.clone()
        seen.add(ptr)
        return a

    return tree_map(own, tree)


@dataclasses.dataclass(frozen=True)
class CohortSpec:
    """Per-round cohort selection for O(cohort) round execution (reference
    ``core/engine.py:249-300``).

    ``selector`` picks which ``size`` global client ids train each round,
    all from the round-entry step counter (deterministic and
    restart-stable): ``"uniform"`` (a random size-subset, from
    ``prng.permutation``), ``"block"`` (a contiguous block at a random
    offset) or ``"rr"`` (round-robin blocks ``[r*size, (r+1)*size) mod
    N``). ``lowering`` is ``"gather"`` (phase A on the gathered ``[size,
    ...]`` rows: O(cohort)) or ``"dense"`` (phase A on all ``[N, ...]``
    rows, then gathered: the O(N) reference)."""

    size: int
    selector: str = "uniform"
    seed: int = 0
    lowering: str = "gather"

    def __post_init__(self):
        if self.size < 1:
            raise ValueError(f"cohort size must be >= 1: {self.size}")
        if self.selector not in ("uniform", "block", "rr"):
            raise ValueError(f"unknown cohort selector {self.selector!r} "
                             "(uniform | block | rr)")
        if self.lowering not in ("gather", "dense"):
            raise ValueError(f"unknown cohort lowering {self.lowering!r} "
                             "(gather | dense)")

    def indices(self, step: int, tau: int, n_clients: int,
                device=None) -> torch.Tensor:
        """The round's ``[size]`` global client ids (int64, on ``device``),
        keyed by the round-entry step counter: ``rr`` on ``int32(step) //
        tau``; ``block`` and ``uniform`` on ``fold_in(fold_in(key(seed),
        0xC0807), int32(step))``, a ``randint`` offset in int32 or the
        first ``size`` of ``permutation(N)``."""
        m = self.size
        ar_m = torch.arange(m, dtype=torch.int64, device=device)
        if self.selector == "rr":
            return torch.remainder((int(step) // tau) * m + ar_m, n_clients)
        key = prng.fold_in(prng.fold_in(prng.key(self.seed), _COHORT_KEY_TAG),
                           step)
        if self.selector == "block":
            off = int(prng.randint(key, (), 0, n_clients, torch.int32))
            return torch.remainder(off + ar_m, n_clients)
        return prng.permutation(key, n_clients, device=device)[:m]


def parse_cohort(spec):
    """Parse a cohort spec; ``None`` for identity specs (``None`` /
    ``"none"`` / ``"off"`` / ``"full"`` / ``0``). Grammar: an int,
    ``"256"``, ``"uniform:256"``, ``"block:256"``, ``"rr:256"``, with an
    optional trailing ``":dense"`` / ``":gather"`` lowering."""
    if spec is None or isinstance(spec, CohortSpec):
        return spec
    if isinstance(spec, int):
        return CohortSpec(size=spec) if spec > 0 else None
    s = str(spec).strip().lower()
    if s in ("", "none", "off", "full", "0"):
        return None
    parts = s.split(":")
    lowering = "gather"
    if parts[-1] in ("gather", "dense"):
        lowering = parts.pop()
    if len(parts) == 1:
        selector, size = "uniform", parts[0]
    elif len(parts) == 2:
        selector, size = parts
    else:
        raise ValueError(f"bad cohort spec {spec!r} "
                         "(try 256, block:256, rr:256, block:256:dense)")
    try:
        size_i = int(size)
    except ValueError:
        raise ValueError(f"bad cohort size in spec {spec!r}: {size!r}")
    if size_i <= 0:
        return None
    return CohortSpec(size=size_i, selector=selector, lowering=lowering)


# ---------------------------------------------------------------- transforms
#: domain-separation tag folded into compression keys so they never collide
#: with the participation-mask key schedule (both default to seed=0).
_COMPRESS_KEY_TAG = 0x7A11A5


def compression_key(seed: int, index: int, step: int, x64: bool = True):
    """``fold_in(fold_in(key(seed), TAG + index), int32(step))``: the
    reference's per-round compression key (``step`` -1 at the warm-up
    aggregation folds in as ``0xFFFFFFFF``); its draws that name no dtype
    take float64 (``x64``) or float32."""
    return prng.fold_in(prng.fold_in(prng.key(seed, x64),
                                     _COMPRESS_KEY_TAG + index), step)


@dataclasses.dataclass(frozen=True)
class MessageCompression:
    """Message transform adapting a ``core/compressors.py`` compressor into
    the engine's message path.

    Owns the per-round PRNG schedule for stochastic compressors: the key is
    ``fold_in(fold_in(key(seed), TAG + index), step)`` where ``step`` is
    the state's step counter at round entry (advanced by exactly ``tau``
    per round, -1 at the warm-up aggregation): a fresh key every round,
    never shared with the participation schedule. Randomness is shared
    across clients."""

    compressor: Any
    seed: int = 0
    #: position in the algorithm's transform stack, folded into the key.
    index: int = 0

    @property
    def up_frac(self) -> float:
        return self.compressor.up_frac

    @property
    def bits_per_coord(self) -> float:
        return self.compressor.bits_per_coord

    @property
    def keep_frac(self) -> float:
        return self.compressor.keep_frac

    @property
    def index_bits(self) -> float:
        return self.compressor.index_bits

    @property
    def value_bits(self) -> float | None:
        return self.compressor.value_bits

    @property
    def unbiased(self) -> bool:
        return getattr(self.compressor, "unbiased", False)

    def init_extra(self, msg_like):
        return self.compressor.init_extra(msg_like)

    def apply(self, msg, extra, step: int, x64: bool = True):
        key = (compression_key(self.seed, self.index, step, x64)
               if self.compressor.requires_key else None)
        return self.compressor.apply(key, msg, extra)


@dataclasses.dataclass(frozen=True)
class ErrorFeedbackCompression:
    """Legacy message transform (reference ``core/engine.py:401-445``):
    cross-client top-k sparsification and/or bf16 quantization with
    optional client-side error feedback, as construction sugar over
    ``ErrorFeedback(Chain((TopK(k_frac, per_client=False), Bf16())))``.
    ``up_frac`` keeps the legacy APPROXIMATE accounting ("bf16 halves
    whatever remains"); ``bits_per_coord`` is the bit-true cost (bf16
    halves values only, top-k's int32 indices stay), which is what
    ``CommMeter`` meters."""

    k_frac: float = 1.0
    quantize: bool = False
    error_feedback: bool = True

    @property
    def up_frac(self) -> float:
        """Uplink fraction vs a dense f32 payload (top-k transmits values
        + int32 indices; bf16 halves whatever remains)."""
        frac = sparsified_up_frac(self.k_frac)
        if self.quantize:
            frac = min(0.5 * frac, 0.5)
        return min(frac, 1.0)

    def _compressor(self):
        from repro_torch.core.compressors import (Bf16, Chain, ErrorFeedback,
                                                  Identity, TopK)

        stages = []
        if self.k_frac < 1.0:
            stages.append(TopK(self.k_frac, per_client=False))
        if self.quantize:
            stages.append(Bf16())
        comp = (stages[0] if len(stages) == 1
                else Chain(tuple(stages)) if stages else Identity())
        return ErrorFeedback(comp) if self.error_feedback else comp

    @property
    def bits_per_coord(self) -> float:
        return self._compressor().bits_per_coord

    @property
    def keep_frac(self) -> float:
        return self._compressor().keep_frac

    @property
    def index_bits(self) -> float:
        return self._compressor().index_bits

    @property
    def value_bits(self) -> float | None:
        return self._compressor().value_bits

    def init_extra(self, msg_like):
        """Feedback memory, shaped like the message."""
        return self._compressor().init_extra(msg_like)

    def apply(self, msg, extra, step: int, x64: bool = True):
        del step, x64  # deterministic stack
        return self._compressor().apply(None, msg, extra)


@dataclasses.dataclass(frozen=True)
class ClientSampling:
    """Per-round Bernoulli client participation policy."""

    rate: float
    seed: int = 0


# --------------------------------------------------------------------- engine
@dataclasses.dataclass(frozen=True)
class RoundEngine:
    """Shared round driver; algorithms subclass it and implement the hooks.

    Subclasses declare ``name``, ``tau``, ``n_clients``, ``vectors_up`` and
    ``vectors_down``; their state is a NamedTuple whose per-client leaves
    carry a leading ``n_clients`` axis, plus a step counter ``t`` (a Python
    int) that a round advances by exactly ``tau``."""

    transforms: tuple = dataclasses.field(default=(), kw_only=True)
    sampling: ClientSampling | None = dataclasses.field(default=None,
                                                        kw_only=True)
    #: asynchronous rounds (delay model, buffer, stale policy); attach via
    #: ``with_delay`` (core/staleness.py).
    delay: StalenessConfig | None = dataclasses.field(default=None,
                                                      kw_only=True)
    topology: Any | None = dataclasses.field(default=None, kw_only=True)
    #: O(cohort) round execution on the client store; attach via
    #: ``with_cohort``. None: every client trains.
    cohort: CohortSpec | None = dataclasses.field(default=None, kw_only=True)
    #: pack the model tree into the contiguous [rows, 1024] parameter arena
    #: (core/arena.py); attach via ``with_arena``.
    arena: bool = dataclasses.field(default=False, kw_only=True)
    telemetry: Any | None = dataclasses.field(default=None, kw_only=True)
    #: mesh axes carrying the client dimension (the production lowering,
    #: ``launch/train.py``; see the module docstring).
    spmd_client_axes: tuple = dataclasses.field(default=(), kw_only=True)
    #: the dtypes of the round's random draws and weights: float64 / int64
    #: (the reference's under ``jax_enable_x64``: its tests, the float64
    #: quadratic) or, False, float32 / int32 (its float32 LM entry points).
    x64: bool = dataclasses.field(default=True, kw_only=True)

    # ------------------------------------------------------------ spec hooks
    def init_warmup(self, gf, x0, init_batch):
        raise NotImplementedError

    def begin_round(self, gf, state, first_batch, agg):
        """Optional round-start exchange; returns (state, round context)."""
        del gf, first_batch, agg
        return state, None

    def local_step(self, gf, state, batch, rctx):
        raise NotImplementedError

    def message(self, gf, state, batch, rctx):
        raise NotImplementedError

    def server_aggregate(self, state, msg, msg_bar, mctx, rctx):
        raise NotImplementedError

    def _fused_tail(self, inner, msg, mctx, extras, step, mask):
        """Optional whole-round-tail fusion hook, consulted by
        ``_comm_step`` on plain synchronous arena rounds, with no delay and
        no topology attached (the fused tail computes the star mean of the
        fresh messages). A spec that can
        run transform -> reduce -> ``server_aggregate`` as one fused pass
        over its packed message returns ``(new_inner, new_extras)``;
        ``None`` falls through to the generic seam."""
        del inner, msg, mctx, extras, step, mask
        return None

    def message_like(self, inner):
        """A tree shaped like the wire message of ``inner``. The reference
        shapes transform memory with ``jax.eval_shape`` of ``message``;
        torch has none, and a real message costs a gradient evaluation. A
        spec's message has the shape of its parameters (FedCET's ``v`` is
        shaped like ``x``), as the reference's ``launch/train.py:131``
        (``abstract_state``) also assumes."""
        return self.client_params_of(inner)

    def client_params_of(self, inner):
        """The stacked parameters of a spec state (``inner.x``)."""
        return inner.x

    def client_params(self, state):
        """Stacked [clients, ...] model parameters, unpacked from the arena
        when the state carries one."""
        x = self.client_params_of(self._inner(state))
        return ar.unpack(x) if isinstance(x, ar.Arena) else x

    def global_params(self, state):
        return tree_client_mean(self.client_params(state), keepdims=False)

    # ------------------------------------------------------------ accounting
    @property
    def up_frac(self) -> float:
        """Effective uplink bytes fraction after message transforms."""
        frac = 1.0
        for t in self.transforms:
            frac *= getattr(t, "up_frac", 1.0)
        return frac

    def _transforms_bits(self, bits: float = 32.0) -> float:
        """Fold the attached transforms' bit-true cost onto a dense width,
        composing stacked transforms through their (keep_frac, index_bits,
        value_bits) triple, first-narrowest value width wins. A transform
        with no keep fraction (a per-leaf plan) scales the width by its
        ``bits_per_coord`` instead."""
        keep, idx, value = 1.0, 0.0, bits
        for t in self.transforms:
            kf = getattr(t, "keep_frac", None)
            if kf is None:
                value *= t.bits_per_coord / 32.0
                continue
            keep *= kf
            idx += keep * t.index_bits
            if t.value_bits is not None:
                value = min(value, t.value_bits)
        return keep * value + idx

    @property
    def bits_per_coord(self) -> float:
        """Bit-true average wire bits per model coordinate per UP vector
        (32.0 when dense)."""
        return self._transforms_bits(32.0)

    def message_leaf_bits(self, leaf_info):
        """EXACT per-leaf uplink wire bits for one client's one UP vector,
        given the message leaf decomposition ``[(name, n_coords), ...]``
        (``core/comm.py:leaf_info_of``): actual kept counts, and a plan's
        rule per leaf. ``None`` where per-leaf billing does not apply: a
        spec that overrides ``bits_per_coord`` bills compression of its own
        the engine cannot decompose (FedLin's round-start top-k). Never
        inspects the arena: the decomposition comes from the unpacked
        parameters either way."""
        if type(self).bits_per_coord is not RoundEngine.bits_per_coord:
            return None
        from repro_torch.core.compressors import stack_wire_bits

        stack = [t._compressor() if isinstance(t, ErrorFeedbackCompression)
                 else t.compressor for t in self.transforms]
        return [stack_wire_bits(stack, i, nm, int(n))
                for i, (nm, n) in enumerate(leaf_info)]

    @property
    def down_frac(self) -> float:
        return 1.0

    @property
    def transmit_frac(self) -> float:
        """Expected fraction of rounds a client's uplink lands (1.0
        synchronous): the cohort's ``size/N``, times the sampling rate,
        times the delay model's duty cycle (independent streams, so the
        expectations multiply). Ignores the non-empty-mask fallback's tiny
        upward correction."""
        frac = self._cohort_frac
        if self.sampling is not None:
            frac *= min(self.sampling.rate, 1.0)
        if self.delay is not None:
            frac *= self.delay.transmit_frac(self.n_clients)
        return frac

    @property
    def receive_frac(self) -> float:
        """Expected fraction of rounds a client RECEIVES the downlink: the
        server broadcasts to present clients only, and only the cohort's
        ``size/N`` slice receives anything. Delay does not reduce it:
        stale-but-present clients still apply the update."""
        frac = self._cohort_frac
        if self.sampling is not None:
            frac *= min(self.sampling.rate, 1.0)
        return frac

    @property
    def _cohort_frac(self) -> float:
        return (self.cohort.size / self.n_clients
                if self.cohort is not None else 1.0)

    @property
    def cohort_compatible(self) -> bool:
        """Whether the spec's own math is cohort-safe: True unless it runs
        a cross-client computation outside the engine's phase-B seam
        (FedLin's cross-client top-k overrides this)."""
        return True

    # ------------------------------------------------------- state wrapping
    @property
    def _topo_stateful(self) -> bool:
        return self.topology is not None and self.topology.stateful

    @property
    def _wrapped(self) -> bool:
        return (bool(self.transforms) or self.delay is not None
                or self._topo_stateful)

    def _wrap(self, inner, extras, tstate=None, dstate=None):
        if not self._wrapped:
            return inner
        extras = tuple(extras)
        if self._topo_stateful:
            extras += (tstate,)
        if self.delay is not None:
            extras += (dstate,)
        return EngineState(inner, extras)

    def _split(self, state):
        """-> (inner, transform extras, TopoState | None, DelayState |
        None). Extras layout: per-transform slots first, then the stateful
        topology's TopoState, then the delay buffer as the last slot."""
        if not self._wrapped:
            return state, (), None, None
        extras, tstate, dstate = state.extras, None, None
        if self.delay is not None:
            extras, dstate = extras[:-1], extras[-1]
        if self._topo_stateful:
            extras, tstate = extras[:-1], extras[-1]
        return state.inner, extras, tstate, dstate

    def _inner(self, state):
        return state.inner if self._wrapped else state

    # ------------------------------------------------------------- plumbing
    def _grad(self, grad_fn: GradFn) -> GradFn:
        gf = vmap_grads(grad_fn,
                        spmd_axis_name=self.spmd_client_axes or None)
        if self.arena:
            base = gf

            # the model-apply boundary: the loss sees the real tree (views
            # of the arena), the engine sees the arena; the repack is the
            # one copy per call.
            def arena_gf(x, batch):
                if not isinstance(x, ar.Arena):
                    return base(x, batch)
                return ar.pack(base(ar.unpack(x), batch), x.layout)

            gf = arena_gf
        if self.telemetry is None:
            return gf
        inner_gf = gf

        # a no-op outside the runner's tape and inside the muted tau-1
        # local steps; an Arena gradient's zero pads make the packed norm
        # equal the per-leaf norm.
        def recording_gf(x, batch):
            g = inner_gf(x, batch)
            if tele.collecting():
                tele.capture("grad_norm", tele.mean_client_norm(g))
            return g

        return recording_gf

    def _init_extras(self, inner) -> tuple:
        """Per-transform extra state, shaped like the wire message."""
        if not self.transforms:
            return ()
        like = self.message_like(inner)
        return tuple(t.init_extra(like) for t in self.transforms)

    def _comm_step(self, gf, inner, extras, batch, rctx, agg, step,
                   tstate=None, dstate=None, fresh=None, mask=None):
        """The single aggregating step: message -> transforms -> [delay
        buffer] -> reduce -> apply. ``step`` is the state's step counter at
        round entry (keys the stochastic transforms). With a topology
        attached the reduction goes through ``reduce_and_advance``, the
        one place topology state moves, under the ``mask``-derived weights.
        The spec's fused tail may take the whole seam only on plain
        synchronous arena rounds (no delay, no topology: it computes the
        star mean).

        With ``dstate`` / ``fresh`` (a ``with_delay`` round) the wire
        message lands in the server buffer only where ``fresh``, the stale
        policy turns buffer and ages into the weights of the mean, and
        stale clients apply the update with their BUFFERED message
        (``last`` / ``poly``) or take the tau-th step as a pure local step
        (``drop``); they did not transmit, so their transform memory
        reverts. Returns ``(inner, extras, tstate, dstate, tx)``, ``tx``
        the post-transform wire message (``init`` seeds the buffer from
        it)."""
        msg, mctx = self.message(gf, inner, batch, rctx)
        # observer-only telemetry: rec is False when no spec is attached or
        # no tape is active (init, direct round calls).
        rec = self.telemetry is not None and tele.collecting()
        if rec:
            tele.capture("msg_norm", tele.mean_client_norm(msg))
            if self.telemetry.leaf_stats:
                tele.capture("leaf_msg_norm", tele.leaf_client_norms(msg))
        if (dstate is None and self.delay is None and self.topology is None
                and self.arena):
            fused = self._fused_tail(inner, msg, mctx, extras, step, mask)
            if fused is not None:
                inner, new_extras = fused
                return inner, tuple(new_extras), tstate, None, None
        msg, new_extras = self._transmit(msg, extras, step, rec)
        like = tree_leaves(msg)[0]
        if dstate is None:  # synchronous path (and always: init)
            if self.topology is not None:
                msg_bar, tstate = self.topology.reduce_and_advance(
                    msg, self._topo_weights(mask, like), tstate)
            else:
                msg_bar = agg(msg)
            inner = self.server_aggregate(inner, msg, msg_bar, mctx, rctx)
            return inner, new_extras, tstate, None, msg
        # fresh arrivals replace the buffered copy and reset its age; the
        # buffer is server state: it updates and ages every round.
        n = self.n_clients
        buf = select_clients(msg, dstate.buf, fresh, n)
        age = torch.where(fresh, 0, dstate.age + 1).to(dstate.age.dtype)
        if rec:
            self._capture_ages(fresh, age)
        w = self.delay.policy.weights(age, fresh, self.x64)
        if self.topology is not None:
            msg_bar, tstate = self.topology.reduce_and_advance(buf, w, tstate)
        else:
            msg_bar = weighted_client_mean(buf, w)
        # each client's own-message slot is what the server attributed to
        # it: the fresh wire message where it landed, the buffer elsewhere.
        agg_inner = self.server_aggregate(inner, buf, msg_bar, mctx, rctx)
        if not self.delay.policy.apply_stale:
            # drop: no-arrival clients take the tau-th step locally.
            local = self.local_step(gf, inner, batch, rctx)
            agg_inner = select_clients(agg_inner, local, fresh, n)
        new_extras = tuple(select_clients(ne, e, fresh, n)
                           for ne, e in zip(new_extras, extras))
        return agg_inner, new_extras, tstate, DelayState(buf=buf, age=age), msg

    def _transmit(self, msg, extras, step: int, rec: bool):
        """The transform stack on ``msg``: ``(wire message, new extras)``,
        with the compression-error captures when ``rec``."""
        raw = msg
        new_extras = []
        for t, e in zip(self.transforms, extras):
            msg, e = t.apply(msg, e, step, self.x64)
            new_extras.append(e)
        if rec and self.transforms:
            diff = tree_map(lambda a, b: a - b, msg, raw)
            tele.capture("compress_err", tele.mean_client_norm(diff))
            if self.telemetry.wants_sketch("compress_err"):
                tele.capture("compress_err_clients",
                             torch.sqrt(tele.client_sq_norms(diff)))
            if self.telemetry.leaf_stats:
                tele.capture("leaf_compress_err",
                             tele.leaf_client_norms(diff))
        return msg, tuple(new_extras)

    @staticmethod
    def _capture_ages(fresh: torch.Tensor, age: torch.Tensor) -> None:
        """The staleness captures: arrivals, and the buffer's ages."""
        tele.capture("fresh_count", fresh.to(torch.int32).sum(
            dtype=torch.int32))
        tele.capture("age_min", torch.min(age))
        tele.capture("age_mean", torch.mean(age.to(torch.float32)))
        tele.capture("age_max", torch.max(age))

    def _would_transmit(self, gf, inner, extras, batch):
        """The wire message the current state WOULD transmit (round context
        and transform-memory updates discarded): seeds the delay buffer of
        specs whose warm-up runs no aggregation."""
        st, rctx = self.begin_round(gf, inner, batch, tree_client_mean)
        msg, _ = self.message(gf, st, batch, rctx)
        for t, e in zip(self.transforms, extras):
            msg, _ = t.apply(msg, e, inner.t, self.x64)
        return msg

    @property
    def _float(self) -> torch.dtype:
        """The canonical float dtype of draws and weights."""
        return torch.float64 if self.x64 else torch.float32

    def _topo_weights(self, mask, like: torch.Tensor,
                      n: int | None = None) -> torch.Tensor:
        """The per-client weights a topology reduces under on non-delayed
        rounds, on ``like``'s device: uniform, or the participation mask,
        in the canonical float dtype. ``n`` overrides the length (cohort
        rounds reduce over the cohort slots)."""
        if mask is not None:
            return mask.to(device=like.device, dtype=self._float)
        return torch.ones((n or self.n_clients,), dtype=self._float,
                          device=like.device)

    def _aggregator(self, mask, tstate, like: torch.Tensor):
        """The round's READ-ONLY cross-client reduction, for
        ``begin_round``: the attached topology's weighted reduce (topology
        state frozen), else the star mean, or the present-clients mean
        under sampling."""
        if self.topology is not None:
            w = self._topo_weights(mask, like)
            return lambda tr: self.topology.reduce(tr, w, tstate)
        if mask is not None:
            return lambda tr: masked_client_mean(tr, mask)
        return tree_client_mean

    def _cohort_aggregator(self, mask, idx, tstate, like: torch.Tensor):
        """The cohort round's READ-ONLY reduction over gathered ``[cohort,
        ...]`` rows: the topology's cohort reduce (fed the cohort's global
        ids) or the weighted cohort mean."""
        w = self._topo_weights(mask, like, self.cohort.size)
        if self.topology is not None:
            return lambda tr: self.topology.reduce_cohort(
                tr, w, idx, self.n_clients, tstate)
        return lambda tr: weighted_client_mean(tr, w)

    def _mask(self, step: int, like: torch.Tensor, n: int | None = None):
        """The round's participation mask over ``n`` (default all) clients
        on ``like``'s device, or None."""
        if self.sampling is None:
            return None
        key = prng.fold_in(prng.key(self.sampling.seed, self.x64), step)
        return participation_mask(key, n or self.n_clients,
                                  self.sampling.rate).to(like.device)

    def _capture_participating(self, mask, n: int, like) -> None:
        tele.capture("participating",
                     mask.to(torch.int32).sum(dtype=torch.int32)
                     if mask is not None
                     else torch.tensor(n, dtype=torch.int32,
                                       device=like.device))

    # -------------------------------------------------------------- protocol
    def init(self, grad_fn: GradFn, x0, init_batch):
        """Replicate-and-warm-up, plus one aggregating step if the spec's
        warm-up requests it. Client sampling and delay never apply at init
        (the paper's full-participation synchronous initialization), and
        ``init`` stays dense over all N clients under a cohort; the
        topology does apply: the warm-up aggregation already flows through
        the tree or graph. The delay buffer is seeded with each client's
        init-time wire message (or the one it would send), age 0."""
        gf = self._grad(grad_fn)
        if self.arena and not isinstance(x0, ar.Arena):
            # every state, message and transform-memory tree the spec builds
            # from x0 is arena-valued from here on.
            x0 = ar.pack(x0)
        inner, run_comm = self.init_warmup(gf, x0, init_batch)
        extras = self._init_extras(inner)
        like = self.message_like(inner)
        tstate = None
        if self.topology is not None:
            tstate = self.topology.init_state(
                like if self.topology.needs_msg_shapes else None)
        tx = None
        if run_comm:
            inner, extras, tstate, _, tx = self._comm_step(
                gf, inner, extras, init_batch, None,
                self._aggregator(None, tstate, tree_leaves(like)[0]),
                step=inner.t, tstate=tstate)
        dstate = None
        if self.delay is not None:
            if tx is None:
                tx = self._would_transmit(gf, inner, extras, init_batch)
            age = torch.zeros((self.n_clients,), dtype=torch.int32,
                              device=tree_leaves(tx)[0].device)
            dstate = DelayState(buf=tx, age=age)
        return self._wrap(inner, extras, tstate, dstate)

    def round(self, grad_fn: GradFn, state, batches):
        """One communication round: optional round-start exchange, tau-1
        local steps, one aggregating step. ``batches`` leaves have leading
        ``[tau, clients, ...]`` axes. With a cohort attached the round is
        :meth:`_cohort_round`: same state layout and hooks, O(cohort)
        work."""
        if self.cohort is not None:
            return self._cohort_round(grad_fn, state, batches)
        gf = self._grad(grad_fn)
        inner, extras, tstate, dstate = self._split(state)
        step0 = inner.t  # round-entry counter: keys masks AND compressors
        like = tree_leaves(self.message_like(inner))[0]
        mask = self._mask(step0, like)
        agg = self._aggregator(mask, tstate, like)
        fresh = None
        if self.delay is not None:
            fresh = self.delay.fresh_mask(step0, self.tau, self.n_clients,
                                          x64=self.x64, device=like.device)
            if mask is not None:
                fresh = fresh & mask  # absent clients cannot deliver
        if self.telemetry is not None and tele.collecting():
            self._capture_participating(mask, self.n_clients, like)
        frozen_inner, frozen_extras = inner, extras
        inner, rctx = self.begin_round(
            gf, inner, tree_map(lambda b: b[0], batches), agg)
        inner = self._local_steps(gf, inner, batches, rctx)
        last_b = tree_map(lambda b: b[self.tau - 1], batches)
        inner, extras, tstate, dstate, _ = self._comm_step(
            gf, inner, extras, last_b, rctx, agg, step=step0, tstate=tstate,
            dstate=dstate, fresh=fresh, mask=mask)
        if mask is not None:
            # absent clients keep their pre-round state entirely; the delay
            # buffer and the topology round index are server and network
            # state and are never reverted.
            inner = select_clients(inner, frozen_inner, mask, self.n_clients)
            extras = tuple(select_clients(e, fe, mask, self.n_clients)
                           for e, fe in zip(extras, frozen_extras))
        return self._wrap(inner, extras, tstate, dstate)

    def _local_steps(self, gf, inner, batches, rctx):
        """The tau-1 pure-local steps, muted as the reference's local
        ``lax.scan`` (``grad_norm`` is the aggregating step's)."""
        with tele.muted():
            for k in range(self.tau - 1):
                inner = self.local_step(gf, inner,
                                        tree_map(lambda b: b[k], batches),
                                        rctx)
        return inner

    def _cohort_round(self, grad_fn: GradFn, state, batches):
        """One O(cohort) round (reference ``core/engine.py:1023-1185``):
        select the cohort's global ids, gather their rows from the client
        store, run phase A (per-client compute) on the cohort, phase B (all
        cross-client work) on cohort-sized arrays, and scatter the updated
        rows back into the store IN PLACE. The round consumes ``state``:
        its per-client tensors ARE the returned state's, as the
        reference's donated carry is; a caller that needs the pre-round
        state clones it first. Non-cohort clients are untouched but for
        the server-side aging of their delay-buffer entries."""
        gf = self._grad(grad_fn)
        inner, extras, tstate, dstate = self._split(state)
        N, m, tau = self.n_clients, self.cohort.size, self.tau
        # the scatter writes into these tensors: no two may share memory.
        if dstate is not None:
            inner, extras, buf = _unalias((inner, extras, dstate.buf), N)
            dstate = DelayState(buf=buf, age=dstate.age)
        else:
            inner, extras = _unalias((inner, extras), N)
        like = tree_leaves(self.message_like(inner))[0]
        step0 = inner.t  # round-entry counter: keys cohort, masks, dither
        idx = self.cohort.indices(step0, tau, N, device=like.device)
        # within-cohort participation: an absent member freezes.
        mask = self._mask(step0, like, m)
        fresh = None
        if self.delay is not None:
            # delay schedules key on GLOBAL client ids.
            fresh = self.delay.fresh_mask(step0, tau, N, x64=self.x64,
                                          device=like.device)[idx]
            if mask is not None:
                fresh = fresh & mask
        agg = self._cohort_aggregator(mask, idx, tstate, like)
        frozen_inner = gather_clients(inner, idx, N)  # pre-round rows
        extras_c = tuple(gather_clients(e, idx, N) for e in extras)

        # ---- phase A: per-client compute (begin_round -> local -> message)
        if self.cohort.lowering == "dense":
            # the O(N) reference: every client computes, the cohort's rows
            # feed phase B.
            st, rctx = self.begin_round(
                gf, inner, tree_map(lambda b: b[0], batches),
                lambda tr: agg(gather_clients(tr, idx, N)))
            st = self._local_steps(gf, st, batches, rctx)
            last_b = tree_map(lambda b: b[tau - 1], batches)
            msg, mctx = self.message(gf, st, last_b, rctx)
            inner_c = gather_clients(st, idx, N)
            msg_c = gather_clients(msg, idx, N)
            mctx_c = msg_c if mctx is msg else gather_clients(mctx, idx, N)
            rctx_c = gather_clients(rctx, idx, N)
            last_b_c = gather_clients(last_b, idx, N)
        else:
            batches_c = tree_map(
                lambda b: (b[:, idx] if isinstance(b, torch.Tensor)
                           and b.dim() >= 2 and b.shape[1] == N else b),
                batches)
            inner_c, rctx_c = self.begin_round(
                gf, frozen_inner, tree_map(lambda b: b[0], batches_c), agg)
            inner_c = self._local_steps(gf, inner_c, batches_c, rctx_c)
            last_b_c = tree_map(lambda b: b[tau - 1], batches_c)
            msg_c, mctx_c = self.message(gf, inner_c, last_b_c, rctx_c)

        # ---- phase B: transforms -> [buffer] -> reduce -> apply, on
        # cohort-sized arrays in both lowerings.
        rec = self.telemetry is not None and tele.collecting()
        if rec:
            tele.capture("msg_norm", tele.mean_client_norm(msg_c))
            self._capture_participating(mask, m, like)
            if self.telemetry.leaf_stats:
                tele.capture("leaf_msg_norm", tele.leaf_client_norms(msg_c))
        tx_c, new_extras_c = self._transmit(msg_c, extras_c, step0, rec)
        if rec and self.transforms \
                and self.telemetry.wants_sketch("compress_err"):
            # cohort-sized wire data: finalize maps the top-k slots to
            # GLOBAL client ids through the captured index.
            tele.capture("cohort_ids", idx.to(torch.int32))
        dstate_next = None
        if dstate is None:
            w = self._topo_weights(mask, like, m)
            if self.topology is not None:
                msg_bar, tstate = self.topology.reduce_cohort_and_advance(
                    tx_c, w, idx, N, tstate)
            else:
                msg_bar = weighted_client_mean(tx_c, w)
            inner_c = self.server_aggregate(inner_c, tx_c, msg_bar, mctx_c,
                                            rctx_c)
        else:
            buf_c = select_clients(tx_c, gather_clients(dstate.buf, idx, N),
                                   fresh, m)
            age_c = torch.where(fresh, 0, dstate.age[idx] + 1).to(
                dstate.age.dtype)
            w = self.delay.policy.weights(age_c, fresh, self.x64)
            if self.topology is not None:
                msg_bar, tstate = self.topology.reduce_cohort_and_advance(
                    buf_c, w, idx, N, tstate)
            else:
                msg_bar = weighted_client_mean(buf_c, w)
            agg_inner_c = self.server_aggregate(inner_c, buf_c, msg_bar,
                                                mctx_c, rctx_c)
            if not self.delay.policy.apply_stale:
                local = self.local_step(gf, inner_c, last_b_c, rctx_c)
                agg_inner_c = select_clients(agg_inner_c, local, fresh, m)
            inner_c = agg_inner_c
            new_extras_c = tuple(select_clients(ne, e, fresh, m)
                                 for ne, e in zip(new_extras_c, extras_c))
            # the buffer is server state: every non-cohort entry keeps
            # aging, cohort entries land.
            age = (dstate.age + 1).to(dstate.age.dtype).index_copy_(
                0, idx, age_c)
            dstate_next = DelayState(
                buf=scatter_clients(dstate.buf, buf_c, idx, N), age=age)
            if rec:
                # cohort arrivals; ages over the FULL server buffer.
                self._capture_ages(fresh, age)
        if mask is not None:
            # absent cohort members keep their pre-round rows entirely.
            inner_c = select_clients(inner_c, frozen_inner, mask, m)
            new_extras_c = tuple(select_clients(e, fe, mask, m)
                                 for e, fe in zip(new_extras_c, extras_c))

        # ---- scatter the cohort rows back into the client store, in place
        inner_next = scatter_clients(inner, inner_c, idx, N)
        extras_next = tuple(scatter_clients(e, ec, idx, N)
                            for e, ec in zip(extras, new_extras_c))
        return self._wrap(inner_next, extras_next, tstate, dstate_next)


# ------------------------------------------------------- transform factories
def with_participation(algo: RoundEngine, rate: float,
                       seed: int = 0) -> RoundEngine:
    """Per-round Bernoulli client sampling for ANY engine algorithm.
    ``rate >= 1.0`` is an exact no-op (returns ``algo`` unchanged)."""
    if rate >= 1.0:
        return algo
    return dataclasses.replace(algo, sampling=ClientSampling(rate=rate,
                                                             seed=seed))


def with_compression(algo: RoundEngine, *, k_frac: float = 1.0,
                     quantize: bool = False,
                     error_feedback: bool | None = None,
                     compressor=None, seed: int = 0) -> RoundEngine:
    """Compressed uplink for ANY engine algorithm's message path. Two
    entry forms, as in the reference:

    * ``compressor=``: a ``core/compressors.py`` Compressor, spec string
      (``"randk:0.25"``, ``"ef:topk:0.3+bf16"``, ``"shift:q8"``) or
      CompressionPlan. ``error_feedback=None`` wraps BIASED compressors in
      ``ErrorFeedback`` and leaves unbiased ones bare; True/False forces
      either. A plan applies that policy per rule (``parse_plan``), so it
      is never wrapped whole.
    * legacy ``k_frac=`` / ``quantize=``: cross-client top-k + bf16 under
      error feedback (``ErrorFeedbackCompression``; ``error_feedback=None``
      means True here). ``k_frac >= 1.0 and not quantize`` is an exact
      no-op.

    Transforms stack: the last one attached compresses the output of the
    previous one."""
    if compressor is not None:
        if k_frac < 1.0 or quantize:
            raise ValueError(
                "pass EITHER compressor= or the legacy k_frac=/quantize= "
                "kwargs, not both (the legacy pair would be silently "
                f"ignored): compressor={compressor!r}, k_frac={k_frac}, "
                f"quantize={quantize}")
        from repro_torch.core.compressors import (CompressionPlan, auto_wrap,
                                                  from_spec)

        comp = from_spec(compressor)
        if comp is None:  # the "none" spec: exact no-op
            return algo
        if not isinstance(comp, CompressionPlan):
            comp = auto_wrap(comp, error_feedback)
        t = MessageCompression(comp, seed=seed, index=len(algo.transforms))
        return dataclasses.replace(algo, transforms=algo.transforms + (t,))
    if k_frac >= 1.0 and not quantize:
        return algo
    t = ErrorFeedbackCompression(
        k_frac=k_frac, quantize=quantize,
        error_feedback=True if error_feedback is None else error_feedback)
    return dataclasses.replace(algo, transforms=algo.transforms + (t,))


def with_topology(algo: RoundEngine, topology, *, seed: int = 0,
                  tier_compression=None) -> RoundEngine:
    """Non-star aggregation geometry for ANY engine algorithm: a
    hierarchical tree or a gossip graph at the aggregation seam (see
    ``core/topology.py``).

    ``topology`` is a spec string (``"hier:g8"``, ``"hier:16x4"``,
    ``"ring"``, ``"torus"``, ``"er:0.4"``, ``"er:0.4:t"`` resampled every
    round; gossip specs take a trailing ``":sparse"``) or a Topology
    object; ``seed`` keys graph draws and tier-compression dither.
    ``tier_compression`` (hierarchies only) re-compresses interior tier
    uplinks. Star specs are exact no-ops: the algorithm is returned
    unchanged. The topology applies wherever the engine reduces across
    clients (the aggregating step, ``begin_round``, the warm-up
    aggregation at ``init``) under the star engine's per-client weights,
    so it composes with ``with_compression`` / ``with_participation`` in
    any order."""
    topo = parse_topology(topology, algo.n_clients, seed=seed,
                          tier_compression=tier_compression)
    if topo is None:
        return algo
    if algo.topology is not None:
        raise ValueError("algorithm already has a topology attached "
                         f"({algo.topology!r}); stacked topologies are "
                         "undefined")
    if algo.cohort is not None and not topo.supports_cohort:
        raise ValueError(
            f"topology {topo!r} does not support cohort execution (gossip "
            "mixing has no server to sample a cohort: every node exchanges "
            "with its neighbors every round)")
    return dataclasses.replace(algo, topology=topo)


def with_delay(algo: RoundEngine, delay, *, policy="last",
               seed: int = 0) -> RoundEngine:
    """Asynchronous rounds for ANY engine algorithm: delayed uplinks with a
    server-side last-known message buffer and a stale-aggregation policy
    (see ``core/staleness.py``).

    ``delay`` is a spec string (``"fixed:2"``, ``"rr:1"``, ``"geom:0.5"``)
    or a delay-model object; ``policy`` is ``"drop"`` / ``"last"`` /
    ``"poly:<a>"`` (or a ``StalePolicy``); ``seed`` keys stochastic
    schedules. Identity delays (``"none"``, ``"fixed:0"``, ``"rr:0"``,
    ``"geom:1"``) return the algorithm unchanged, for every policy. Delay
    applies at the aggregation seam after the compression transforms (the
    buffer holds wire messages), so factory order does not matter."""
    model = parse_delay(delay)
    if model is None:
        return algo
    if algo.delay is not None:
        raise ValueError("algorithm already has a delay model attached "
                         f"({algo.delay!r}); stacked delays are undefined")
    cfg = StalenessConfig(model=model, policy=parse_policy(policy), seed=seed)
    return dataclasses.replace(algo, delay=cfg)


def with_cohort(algo: RoundEngine, cohort, *, seed: int = 0) -> RoundEngine:
    """O(cohort) round execution for ANY engine algorithm: the per-client
    state stays in the client store and each round runs on a gathered
    fixed-size cohort (see the module docstring).

    ``cohort`` is a size (int), a spec string (``"256"``, ``"block:256"``,
    ``"rr:256"``, with an optional trailing ``":dense"``) or a
    :class:`CohortSpec`; ``seed`` keys the stochastic selectors. Identity
    specs (``None`` / ``"none"`` / ``0`` / ``size >= n_clients``) return
    the algorithm unchanged. Attach the cohort LAST: the factory validates
    the axes already attached, and refuses gossip topologies, stacking and
    specs whose own math crosses clients (``cohort_compatible`` False:
    FedLin with ``k_frac < 1``)."""
    spec = cohort if isinstance(cohort, CohortSpec) else parse_cohort(cohort)
    if spec is not None and not isinstance(cohort, CohortSpec):
        spec = dataclasses.replace(spec, seed=seed)
    if spec is None or spec.size >= algo.n_clients:
        if spec is not None and spec.size > algo.n_clients:
            raise ValueError(f"cohort size {spec.size} exceeds "
                             f"n_clients={algo.n_clients}")
        return algo
    if algo.cohort is not None:
        raise ValueError("algorithm already has a cohort attached "
                         f"({algo.cohort!r}); stacked cohorts are undefined")
    if not algo.cohort_compatible:
        raise ValueError(
            f"{algo.name} is not cohort-compatible: its spec performs a "
            "cross-client computation outside the engine's aggregation "
            "seam (FedLin's internal cross-client top-k needs the full "
            "population: use k_frac=1.0 / FedTrack, or move compression "
            "to with_compression)")
    if algo.topology is not None and not algo.topology.supports_cohort:
        raise ValueError(
            f"topology {algo.topology!r} does not support cohort execution "
            "(gossip mixing has no server to sample a cohort)")
    return dataclasses.replace(algo, cohort=spec)


def with_arena(algo: RoundEngine, enable: bool = True) -> RoundEngine:
    """Packed-parameter-arena execution for ANY engine algorithm: ``init``
    flattens the model tree once into the ``[rows, 1024]`` buffer of
    core/arena.py, and every state / message / transform-memory tree stays
    packed, unpacked only at the gradient boundary. ``enable=False`` is an
    exact no-op."""
    if not enable:
        return algo
    return dataclasses.replace(algo, arena=True)


def with_telemetry(algo: RoundEngine, telemetry=True) -> RoundEngine:
    """In-round telemetry for ANY engine algorithm (see
    ``core/telemetry.py``): the round captures per-round metrics
    (gradient / message norms, compression error, participation, the
    ``sum_i d_i`` invariant residual, the consensus error, the sketches)
    onto the runner's tape, as device tensors, with no extra algorithm
    state. ``telemetry`` is ``True``, a
    :class:`~repro_torch.core.telemetry.Telemetry` spec or a truthy spec
    string; disabled specs (``None`` / ``False`` / ``"none"`` / ``"off"``)
    return the algorithm object unchanged."""
    spec = tele.parse_telemetry(telemetry)
    if spec is None:
        return algo
    return dataclasses.replace(algo, telemetry=spec)


# --------------------------------------------------------- multi-round driver
def make_round_runner(algo, grad_fn: GradFn, *, metric_fn=None,
                      repeat: bool = False, metric_with_batch: bool = False):
    """The K-round loop over ``algo.round`` (the reference's jitted scan).

    * ``repeat=False``: ``run(state, batches)`` loops over stacked
      per-round batches (leaves ``[rounds, tau, clients, ...]``).
    * ``repeat=True``: ``run(state, batches, rounds)`` replays the SAME
      per-round batch tree (leaves ``[tau, clients, ...]``).

    ``metric_fn(state)`` (or ``metric_fn(state, round_batches)`` with
    ``metric_with_batch``) runs after every round; its results (a tensor
    or a tree of tensors) are stacked leaf by leaf into the second return
    value (``None`` without a hook).

    With telemetry attached (``with_telemetry``) each round runs under a
    :func:`~repro_torch.core.telemetry.collect` tape and the second return
    value becomes ``{"metric": ..., "telemetry": {name: [rounds, ...]}}``
    (split it with :func:`~repro_torch.core.telemetry.split_metrics`);
    without telemetry it is exactly the plain structure.

    A cohort algorithm's round writes into its input state (the
    reference's ``donate=True``), so the runner consumes ``state``: rebind
    the result and read nothing of the state passed in."""
    tel = getattr(algo, "telemetry", None)

    def _metric(s, b):
        if metric_fn is None:
            return None
        return metric_fn(s, b) if metric_with_batch else metric_fn(s)

    def _round(s, b):
        if tel is None:
            return algo.round(grad_fn, s, b), None
        with tele.collect() as tape:
            s = algo.round(grad_fn, s, b)
        return s, tel.finalize(tape, algo, s)

    def _stack(ys, tls):
        m = None if metric_fn is None else tree_map(
            lambda *a: torch.stack(a), ys[0], *ys[1:])
        if tel is None:
            return m
        return {"metric": m,
                "telemetry": {k: torch.stack([t[k] for t in tls])
                              for k in tls[0]} if tls else {}}

    if repeat:
        def run(state, batches, rounds):
            ys, tls = [], []
            for _ in range(rounds):
                state, tl = _round(state, batches)
                ys.append(_metric(state, batches))
                tls.append(tl)
            return state, _stack(ys, tls)

        return run

    def run(state, batches):
        ys, tls = [], []
        for r in range(tree_leaves(batches)[0].shape[0]):
            b = tree_map(lambda a: a[r], batches)
            state, tl = _round(state, b)
            ys.append(_metric(state, b))
            tls.append(tl)
        return state, _stack(ys, tls)

    return run


def scan_segments(start: int, total: int, is_boundary, *, max_rounds: int = 32):
    """Yield ``(first, last)`` round indices of loop segments: each ends at
    the next boundary round (inclusive) or after ``max_rounds``."""
    r = start
    while r < total:
        cap = min(total - 1, r + max_rounds - 1)
        stop = next((s for s in range(r, cap) if is_boundary(s)), cap)
        yield r, stop
        r = stop + 1


def run_rounds(algo, grad_fn: GradFn, state, batches, *,
               rounds: int | None = None, metric_fn=None):
    """Run K communication rounds. With ``rounds=None`` the batches leaves
    are ``[rounds, tau, clients, ...]`` stacks; with ``rounds=K`` one
    per-round tree is replayed K times. Returns ``(state, metrics)``."""
    if rounds is not None:
        return make_round_runner(algo, grad_fn, metric_fn=metric_fn,
                                 repeat=True)(state, batches, rounds)
    return make_round_runner(algo, grad_fn, metric_fn=metric_fn)(state,
                                                                 batches)
