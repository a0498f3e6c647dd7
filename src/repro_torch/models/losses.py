"""Language-model loss (port of ``src/repro/models/losses.py``:
``chunked_ce``).

The reference scans the sequence in ``CE_CHUNK`` chunks under
``jax.checkpoint`` so that the full ``[B, S, V]`` logits never live at
once. The port loops over the same chunks without checkpointing: it runs
inside ``torch.func`` transforms, and at the slice's shapes (seq 128, one
chunk) the float32 logits of 4 clients x 8 x 128 x 16384 take about
268 MB. Logits are float32 whatever the hidden dtype, as in the reference;
autograd casts the cotangent back to the hidden dtype, which is what the
reference's ``_grad_dtype_guard`` does by hand.
"""

from __future__ import annotations

import torch

from repro_torch.utils.sharding_ctx import (is_dtensor, resolve_partial,
                                            shard_logits)

CE_CHUNK = 512


def chunked_ce(x: torch.Tensor, head: torch.Tensor, tokens: torch.Tensor, *,
               prefix: int = 0, chunk: int = CE_CHUNK) -> torch.Tensor:
    """Mean next-token cross entropy.

    x:      [B, S_total, d] final-norm hidden states
    head:   [d, V]
    tokens: [B, S_text] — x positions prefix..prefix+S_text-1 align with
            them (prefix = image-token count for VLMs, else 0)."""
    B = x.shape[0]
    preds = x[:, prefix:-1, :]              # predicts tokens[:, 1:]
    targets = tokens[:, 1:]
    n = targets.shape[1]
    c = min(chunk, n)
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for s in range(0, n, c):
        logits = shard_logits((preds[:, s:s + c] @ head).to(torch.float32))
        logz = _logsumexp(logits)
        gold = resolve_partial(torch.gather(
            logits, -1, targets[:, s:s + c, None].to(torch.int64)))[..., 0]
        total = total + torch.sum(logz - gold)
    return total / (B * n)


def _logsumexp(logits: torch.Tensor) -> torch.Tensor:
    """``logsumexp`` over the last (vocab) dim. DTensor has no sharded
    rule for it and would gather a vocab-sharded chunk whole, so on a
    DTensor the max and the sum of exponentials reduce across the shards
    (two ``[B, chunk]`` all-reduces) instead."""
    if not is_dtensor(logits):
        return torch.logsumexp(logits, dim=-1)
    m = resolve_partial(torch.amax(logits, dim=-1, keepdim=True)).detach()
    total = resolve_partial(torch.sum(torch.exp(logits - m), dim=-1))
    return torch.log(total) + m[..., 0]
