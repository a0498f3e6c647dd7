"""Model-input construction (port of ``src/repro/launch/input_specs.py``:
``batch_shapes`` and ``make_batch``).

Batch layouts per family:
  text/moe/ssm/hybrid : ``{"tokens": [B, S] int32}``
  vlm                 : + ``{"image_embeds": [B, n_modal_tokens, d]}`` (the
                        stub anyres vision tower's output)
  audio               : ``{"frames": [B, encoder_len, d]}`` (the stub conv
                        frontend's output) + ``{"tokens": [B, S] int32}``

``make_batch`` draws the reference's inputs: the same key splits, the
tokens through ``core/prng.py``'s ``randint`` bit for bit, the embeddings
as ``normal * 0.02`` in the key's float dtype (float64 under the x64 the
reference's tests turn on, float32 without it), then cast to
``cfg.dtype``; ``prng.normal`` agrees with ``jax.random.normal`` to a few
ulps. The ``ShapeDtypeStruct`` stand-ins of the dry-run have no
counterpart.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import prng
from repro_torch.models.layers import torch_dtype


def batch_shapes(cfg: ArchConfig, batch: int, seq_len: int) -> dict:
    """{name: (shape, dtype)} for a single (non-federated) batch."""
    emb_dtype = torch_dtype(cfg.dtype)
    shapes = {"tokens": ((batch, seq_len), torch.int32)}
    if cfg.family == "vlm":
        shapes["image_embeds"] = ((batch, cfg.n_modal_tokens, cfg.d_model),
                                  emb_dtype)
    if cfg.family == "audio":
        shapes["frames"] = ((batch, cfg.encoder_len, cfg.d_model), emb_dtype)
    return shapes


def make_batch(cfg: ArchConfig, batch: int, seq_len: int, *, key=0,
               device=None) -> dict:
    """Concrete random batch: ``key`` (an int seed or a ``core/prng.py``
    key) split once per input, tokens uniform in ``[0, vocab)``,
    embeddings ``normal * 0.02``."""
    if isinstance(key, int):
        key = prng.key(key)
    out = {}
    for name, (shape, dtype) in batch_shapes(cfg, batch, seq_len).items():
        key, k = prng.split(key)
        if dtype.is_floating_point:
            out[name] = (prng.normal(k, shape, device=device)
                         * 0.02).to(dtype)
        else:
            out[name] = prng.randint(k, shape, 0, cfg.vocab_size, dtype,
                                     device=device)
    return out
