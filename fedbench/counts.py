"""The work a FedCET round needs, counted from the cell's shapes: the
yardstick of the rooflines and the model-FLOPs share."""

from __future__ import annotations

from fedbench.reference import fedcet


def fedcet_update_bytes(n_params: int, mix: dict, itemsize: int = 4) -> int:
    """Bytes the FedCET update of one round needs to move, each input read
    once and each output written once, over every client: a local step
    reads ``x``, the gradient and ``d`` and writes ``x``; the aggregating
    step reads ``x``, the gradient, ``d`` (and the shift memory ``h``) and
    writes ``x`` and ``d`` (and ``h``). Intermediates (the sent vector, the
    dither, the quantizer's codes and scales) are not counted."""
    shift = fedcet.compression(mix["compression"]) is not None
    per_client = 4 * (mix["tau"] - 1) + (7 if shift else 5)
    return itemsize * n_params * mix["n_clients"] * per_client


def tokens_per_round(mix: dict) -> int:
    """Tokens every client trains on in one round, over all clients."""
    return mix["n_clients"] * mix["tau"] * mix["batch"] * mix["seq_len"]


def train_flops_per_round(family, conf: dict, mix: dict) -> float:
    """Model FLOPs of one round's trained tokens (recomputation and the
    logged loss not counted)."""
    return family.train_flops_per_token(conf, mix["seq_len"]) \
        * tokens_per_round(mix)
