"""Model-input construction (port of ``src/repro/launch/input_specs.py``:
``batch_shapes`` and ``make_batch``, text family).

A text batch is ``{"tokens": [B, S] int32}``. ``make_batch`` draws the
reference's tokens bit for bit: the same key splits and ``randint`` draws
through ``core/prng.py``. The VLM and audio inputs (image embeddings,
encoder frames) come with those families (ROADMAP.md Queue 1 item 6);
the ``ShapeDtypeStruct`` stand-ins of the dry-run have no counterpart.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import prng


def batch_shapes(cfg: ArchConfig, batch: int, seq_len: int) -> dict:
    """{name: (shape, dtype)} for a single (non-federated) batch."""
    if cfg.family in ("vlm", "audio"):
        raise NotImplementedError(
            f"{cfg.name}: {cfg.family} inputs are not yet ported (ROADMAP.md "
            "Queue 1 item 6); the port builds text batches")
    return {"tokens": ((batch, seq_len), torch.int32)}


def make_batch(cfg: ArchConfig, batch: int, seq_len: int, *, key=0,
               device=None) -> dict:
    """Concrete random batch: ``key`` (an int seed or a ``core/prng.py``
    key) split once per input, tokens uniform in ``[0, vocab)``."""
    if isinstance(key, int):
        key = prng.key(key)
    out = {}
    for name, (shape, dtype) in batch_shapes(cfg, batch, seq_len).items():
        key, k = prng.split(key)
        out[name] = prng.randint(k, shape, 0, cfg.vocab_size, dtype,
                                 device=device)
    return out
