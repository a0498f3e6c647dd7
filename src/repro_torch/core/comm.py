"""Communication accounting (port of ``src/repro/core/comm.py:64-181,
320-342``; ``CommMeter`` is not ported yet).

The paper's headline (Remark 2) is a communication-volume claim: FedCET
moves ONE model-sized vector per client per round each way. These helpers
bill it bit-true from the algorithm's attached compressor stack: the
uplink pays the stack's exact per-leaf wire bits (``shift:q8`` is 8 bits
per coordinate) times the sampling duty cycle; the downlink stays dense
f32 and is billed to present clients only. An attached topology reshapes
the traffic (:func:`comm_hops_per_round`): gossip bills one message per
directed edge on the client hop and no broadcast (the same for the dense
and sparse lowerings); a hierarchy adds its aggregator-tier messages,
upward at the tier compressor's width, downward dense f32.
"""

from __future__ import annotations

from torch.utils import _pytree as pytree


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


def leaf_info_of(params) -> list:
    """The message leaf decomposition ``[(name, n_coords), ...]`` of a
    model tree, in flatten order (the arena's layout order)."""
    flat, _ = pytree.tree_flatten_with_path(params)
    return [(leaf_name(p), int(leaf.numel())) for p, leaf in flat]


def message_leaf_bits_of(algo, leaf_info) -> list | None:
    """Per-leaf exact uplink wire bits for one client's one UP vector, or
    None when the algorithm has no ``message_leaf_bits`` hook."""
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
