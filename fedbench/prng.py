"""A frozen copy of the threefry2x32 draws the port's compressors key their
dither with (``jax.random`` bit for bit, ``jax_threefry_partitionable``
on): the key schedule and float32 ``uniform``. The benchmark's reference
draws its dither from here, never from the program.

A key is a pair of 32-bit words held as Python ints; the bulk draws run
over int64 tensors masked to 32 bits on the requested device."""

from __future__ import annotations

import math

import torch

MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
#: the tag the port folds into a compression key, so that it never
#: collides with the participation schedule keyed by the same seed
COMPRESS_KEY_TAG = 0x7A11A5


def _rotl(v, r: int):
    return ((v << r) | (v >> (32 - r))) & MASK32


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32, 20 rounds, of the counter pair ``(x0, x1)`` under the
    key ``(k0, k1)``; operands are ints or int64 tensors of 32-bit words."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & MASK32
    x1 = (x1 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK32
    return x0, x1


def key(seed: int) -> tuple:
    """``jax.random.key(seed)``: the 64-bit seed's high word first."""
    seed &= (1 << 64) - 1
    return (seed >> 32, seed & MASK32)


def fold_in(k: tuple, data: int) -> tuple:
    """``jax.random.fold_in``: ``data`` wraps to uint32 (-1 is 2**32 - 1)."""
    return threefry2x32(k[0], k[1], 0, int(data) & MASK32)


def compression_key(seed: int, index: int, step: int) -> tuple:
    """The round key of the ``index``-th message transform at round-entry
    step ``step`` (-1 at the warm-up aggregation)."""
    return fold_in(fold_in(key(seed), COMPRESS_KEY_TAG + index), step)


def uniform(k: tuple, shape, device=None) -> torch.Tensor:
    """float32 ``jax.random.uniform(k, shape)`` on ``[0, 1)``: 32 random
    bits of the row-major flat index, the top 23 OR'd into 1.0, minus 1."""
    n = math.prod(shape)
    idx = torch.arange(n, dtype=torch.int64, device=device)
    b1, b2 = threefry2x32(k[0], k[1], idx >> 32, idx & MASK32)
    bits = ((b1 ^ b2) >> 9) | 0x3F800000
    return (bits.to(torch.int32).view(torch.float32) - 1.0).reshape(shape)
