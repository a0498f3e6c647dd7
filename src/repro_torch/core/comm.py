"""Communication accounting and the uplink helpers of FedLin (port of
``src/repro/core/comm.py``: ``topk_sparsify``, ``quantize_bf16``, the
bit-true helpers, ``CommMeter`` and ``sparsified_up_frac``).

The paper's headline (Remark 2) is a communication-volume claim: FedCET
moves ONE model-sized vector per client per round each way. These helpers
bill it bit-true from the algorithm's attached compressor stack: the
uplink pays the stack's exact per-leaf wire bits (``shift:q8`` is 8 bits
per coordinate; a sparsifier its actual kept count per leaf, ``max(1,
round(k * n))``; a ``CompressionPlan`` each leaf's own rule, resolved by
the leaf's name and its index in the reference's flatten order, both from
:func:`leaf_info_of`) times the sampling
duty cycle; the downlink stays dense f32 and is billed to present clients
only. An attached topology reshapes
the traffic (:func:`comm_hops_per_round`): gossip bills one message per
directed edge on the client hop and no broadcast (the same for the dense
and sparse lowerings); a hierarchy adds its aggregator-tier messages,
upward at the tier compressor's width, downward dense f32.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.utils import _pytree as pytree

from repro_torch.kernels.ref import topk_mask
from repro_torch.utils.tree import tree_num_params


def topk_sparsify(a: torch.Tensor, k_frac: float) -> torch.Tensor:
    """Keep the top ``round(k_frac * size)`` (min 1) entries of ``|a|`` (per
    leaf), zeroing the rest; shape-preserving. The threshold rule (ties
    kept, as ``jax.lax.top_k``'s threshold in the reference) is
    ``kernels/ref.py:topk_mask``'s."""
    if k_frac >= 1.0:
        return a
    return topk_mask(a, max(1, int(round(k_frac * a.numel()))))


def quantize_bf16(a: torch.Tensor) -> torch.Tensor:
    """Round-trip through bfloat16: a half-width transmitted vector."""
    return a.to(torch.bfloat16).to(a.dtype)


def leaf_name(path) -> str:
    """Canonical slash-joined leaf name for a torch pytree key path (e.g.
    ``(MappingKey('embed'), MappingKey('w')) -> "embed/w"``; list positions
    render as digits)."""
    parts = []
    for k in path:
        if isinstance(k, pytree.MappingKey):
            parts.append(str(k.key))
        elif isinstance(k, pytree.GetAttrKey):
            parts.append(str(k.name))
        elif isinstance(k, pytree.SequenceKey):
            parts.append(str(k.idx))
        else:
            parts.append(str(getattr(k, "key", k)).strip(".[]'\""))
    return "/".join(parts)


def reference_leaf_index(tree) -> list[int]:
    """Each leaf's position (``tree``'s leaves in torch's pytree order) in
    the reference's flatten order. JAX flattens a dict by sorted key,
    torch in insertion order; lists and tuples flatten in order in both.
    The per-leaf subkeys ``fold_in(key, i)`` and a plan's digit rules take
    this ``i``, so a message draws the reference's dithers, and a plan
    names the reference's leaves, whatever order its dicts were built
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


class LeafInfo(list):
    """A message leaf decomposition ``[(name, n_coords), ...]`` in torch's
    flatten order (the arena's layout order) that carries, as
    ``ref_index``, each leaf's position in the reference's flatten order
    (:func:`reference_leaf_index` of the tree it was built from)."""

    def __init__(self, pairs, ref_index):
        super().__init__(pairs)
        self.ref_index = tuple(ref_index)


def leaf_info_of(params) -> LeafInfo:
    """The message leaf decomposition ``[(name, n_coords), ...]`` of a
    model tree, in flatten order (the arena's layout order): names feed
    plan globs, sizes the exact per-leaf wire-bit rounding, and its
    ``ref_index`` the plan's digit rules."""
    flat, _ = pytree.tree_flatten_with_path(params)
    return LeafInfo([(leaf_name(p), int(leaf.numel())) for p, leaf in flat],
                    reference_leaf_index(params))


def leaf_ref_index(leaf_info) -> list:
    """Each entry's index in the reference's flatten order: a
    :class:`LeafInfo`'s ``ref_index``; a plain ``(name, n)`` list is
    taken to be in the reference's order already."""
    index = getattr(leaf_info, "ref_index", None)
    return list(range(len(leaf_info)) if index is None else index)


def message_leaf_bits_of(algo, leaf_info) -> list | None:
    """Per-leaf exact uplink wire bits for one client's one UP vector, or
    None when the algorithm cannot bill per leaf (no ``message_leaf_bits``
    hook, or compression of its own the engine cannot decompose:
    FedLin)."""
    fn = getattr(algo, "message_leaf_bits", None)
    return None if fn is None else fn(leaf_info)


def bits_per_coord_of(algo) -> float:
    """Bit-true uplink width (bits per model coordinate per UP vector);
    ``32 * up_frac`` for objects that declare no width."""
    bits = getattr(algo, "bits_per_coord", None)
    if bits is not None:
        return float(bits)
    return 32.0 * float(getattr(algo, "up_frac", 1.0))


def transmit_frac_of(algo) -> float:
    """Uplink duty cycle: the expected fraction of rounds a client's
    message lands (the sampling rate; 1.0 at full participation)."""
    return float(getattr(algo, "transmit_frac", 1.0))


def receive_frac_of(algo) -> float:
    """Downlink duty cycle: absent clients keep frozen replicas and are not
    billed a broadcast."""
    return float(getattr(algo, "receive_frac", 1.0))


def topology_of(algo):
    """The algorithm's aggregation topology, or None for the flat star."""
    return getattr(algo, "topology", None)


def tier_bits_of(topo) -> float:
    """Wire bits per coordinate on UPWARD aggregator-tier hops: 32.0 dense
    f32, or the hierarchy's ``tier_compression`` width."""
    return float(getattr(topo, "tier_bits_per_coord", 32.0))


def comm_hops_per_round(algo, n_params: int, n_clients: int = 1,
                        leaf_info=None) -> list:
    """Per-hop EXPECTED uplink traffic for one round, as dicts of
    ``{hop, messages, bits}``. The client hop pays the compressor stack's
    wire width (exact per leaf when ``leaf_info`` is given) times the
    transmit duty cycle, once per message: one per directed edge under
    gossip, one per client otherwise. Aggregator-tier hops carry dense
    f32 partial aggregates, or the tier compressor's width."""
    topo = topology_of(algo)
    up_mult = topo.client_up_mult(n_clients) if topo is not None else 1.0
    msg_bits = float(n_params) * bits_per_coord_of(algo)
    if leaf_info is not None:
        lb = message_leaf_bits_of(algo, leaf_info)
        if lb is not None:
            msg_bits = float(sum(lb))
    hops = [{
        "hop": "client",
        "messages": n_clients * up_mult,
        "bits": (algo.vectors_up * msg_bits * n_clients * up_mult
                 * transmit_frac_of(algo)),
    }]
    for label, msgs in (topo.aggregator_hops(n_clients) if topo else ()):
        hops.append({"hop": label, "messages": msgs,
                     "bits": algo.vectors_up * n_params * msgs
                     * tier_bits_of(topo)})
    return hops


def comm_bits_per_round(algo, n_params: int, n_clients: int = 1,
                        leaf_info=None) -> dict:
    """Bit-true EXPECTED wire bits per communication round: ``up_bits``
    sums the hops of :func:`comm_hops_per_round`; ``down_bits`` is dense
    f32 to present clients times the topology's broadcast multiplier (0
    under gossip), plus the hierarchy's downward tier re-broadcasts."""
    topo = topology_of(algo)
    up = sum(h["bits"] for h in
             comm_hops_per_round(algo, n_params, n_clients, leaf_info))
    down_mult = topo.broadcast_mult(n_clients) if topo is not None else 1.0
    agg_msgs = (sum(m for _, m in topo.aggregator_hops(n_clients))
                if topo is not None else 0)
    down = algo.vectors_down * n_params * (
        n_clients * down_mult * 32.0 * receive_frac_of(algo)
        + agg_msgs * 32.0)
    return {"up_bits": up, "down_bits": down, "total_bits": up + down}


@dataclasses.dataclass
class CommMeter:
    """Accumulates transmitted bytes across rounds for one algorithm, in
    the reference's bit-true mode (``for_params(params, algo=...)``): the
    per-vector uplink cost is ``n_params * bits_up / 8`` bytes with
    ``bits_up`` from the compressor stack's exact per-leaf wire bits
    (``leaf_bits``), times the sampling duty cycle and the topology's
    traffic shape (gossip degree up, no broadcast down; a hierarchy's
    tier hops, up at the tier compressor's width and down dense f32).
    The reference's legacy dense mode (``itemsize`` x an explicit
    ``up_frac`` per tick) serves no port caller and is not ported."""

    n_params: int
    n_clients: int = 1
    bits_up: float = 32.0
    bits_down: float = 32.0
    #: expected fraction of rounds a client's uplink lands / it receives.
    up_duty: float = 1.0
    down_duty: float = 1.0
    #: first-hop uplink messages per client, downlink client-hop
    #: multiplier, aggregator-tier messages per vector and their width.
    up_mult: float = 1.0
    down_mult: float = 1.0
    agg_msgs: float = 0.0
    tier_bits_up: float = 32.0
    #: exact per-leaf uplink wire bits for one client's one UP vector, in
    #: leaf flatten order; ``bits_up == sum(leaf_bits) / n_params``.
    leaf_bits: tuple | None = None
    rounds: int = 0
    bytes_up: int = 0
    bytes_down: int = 0

    @classmethod
    def for_params(cls, params, *, algo, n_clients: int = 1) -> "CommMeter":
        """Bit-true meter for one parameter tree under ``algo``."""
        topo = topology_of(algo)
        n_params = tree_num_params(params)
        lb = message_leaf_bits_of(algo, leaf_info_of(params))
        bits_up = (sum(lb) / float(n_params) if lb
                   else bits_per_coord_of(algo))
        return cls(n_params=n_params, n_clients=n_clients, bits_up=bits_up,
                   leaf_bits=tuple(lb) if lb else None,
                   bits_down=32.0 * float(getattr(algo, "down_frac", 1.0)),
                   up_duty=transmit_frac_of(algo),
                   down_duty=receive_frac_of(algo),
                   up_mult=(topo.client_up_mult(n_clients)
                            if topo is not None else 1.0),
                   down_mult=(topo.broadcast_mult(n_clients)
                              if topo is not None else 1.0),
                   agg_msgs=float(sum(m for _, m in
                                      topo.aggregator_hops(n_clients))
                                  if topo is not None else 0.0),
                   tier_bits_up=(tier_bits_of(topo)
                                 if topo is not None else 32.0))

    def tick(self, vectors_up: int, vectors_down: int) -> None:
        """Record one communication round."""
        self.rounds += 1
        per_coord = self.n_params * self.n_clients
        agg_bits_up = self.agg_msgs * self.n_params * self.tier_bits_up
        agg_bits_down = self.agg_msgs * self.n_params * 32.0
        self.bytes_up += int(vectors_up * (per_coord * self.up_mult
                                           * self.bits_up * self.up_duty
                                           + agg_bits_up) / 8.0)
        self.bytes_down += int(vectors_down * (per_coord * self.down_mult
                                               * self.bits_down
                                               * self.down_duty
                                               + agg_bits_down) / 8.0)

    def tick_round(self, algo) -> None:
        """Record one round for ``algo``."""
        self.tick(algo.vectors_up, algo.vectors_down)

    @property
    def total(self) -> int:
        return self.bytes_up + self.bytes_down


def sparsified_up_frac(k_frac: float) -> float:
    """Effective uplink fraction for top-k: values + int32 indices."""
    if k_frac >= 1.0:
        return 1.0
    return 2.0 * k_frac
