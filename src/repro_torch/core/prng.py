"""The subset of ``jax.random`` the core uses, bit for bit (port of
``jax/_src/prng.py`` and ``jax/_src/random.py`` as of jax 0.9, threefry2x32
with ``jax_threefry_partitionable`` on, the default).

A key is a pair of 32-bit words held as two Python ints: the key schedule
(``key``, ``fold_in``, ``split``) is a handful of hashes on scalars and
runs on the host, so deriving a round's keys launches nothing on the card.
The bulk draws (``uniform``, ``bernoulli``, ``randint``) run threefry2x32
over torch integer tensors on the requested device. ``uint32`` has too
few kernels in torch, so words live in ``int64`` masked to 32 bits:
sums and rotations of values below 2**32 cannot overflow there.

The same arithmetic runs on ints and on tensors (``+``, ``^``, ``&``,
``<<``, ``>>``), so the one ``threefry2x32`` below serves both.

Bits as jax draws them (the traps, with their lines in jax's ``prng.py``):

* ``key(seed)`` (``threefry_seed``, :802-829): the 64-bit seed's HIGH word
  comes first.
* ``fold_in(key, data)`` (:1163-1169) casts ``data`` to uint32 first (so
  -1 folds in as ``0xFFFFFFFF``) and hashes the counter pair ``(0, data)``.
* Random bits (:1184-1200) hash the hi and lo words of the row-major flat
  index; 32-bit draws are ``bits1 ^ bits2``, 64-bit draws
  ``(bits1 << 32) | bits2``.
* ``uniform`` ORs the top mantissa bits into 1.0 and subtracts 1.0;
  ``normal`` maps such a draw onto ``[nextafter(-1, 0), 1)`` and through
  ``sqrt(2) * erfinv``.
* ``bernoulli(key, p)`` draws its uniform in the dtype of ``p``, and
  ``uniform`` and ``randint`` default to jax's canonical dtypes: float64 /
  int64 under ``jax_enable_x64`` (the reference's tests and its float64
  quadratic), float32 / int32 without it (its float32 LM entry points).
  Here that choice is the key's: ``key(seed, x64=...)`` sets it, every
  key derived through ``fold_in`` / ``split`` keeps it, and a draw given
  no dtype takes it. There is no global setting.
* ``permutation(key, n)`` (``random.py:_shuffle``) runs ``ceil(3 ln n /
  ln(2**32 - 1))`` rounds; each splits the key, draws 32 bits over
  ``[n]`` from the subkey and sorts by them, stably. The bits are
  unsigned, so they sort as int64 here.
* ``categorical(key, logits)`` (``random.py:_gumbel``, mode "low") draws
  its uniform in the logits' dtype on ``[tiny, 1)``, as
  ``max(tiny, u * (1 - tiny) + tiny)``, and takes the argmax of
  ``-log(-log(u)) + logits``; ``log`` is the only step that may differ
  from XLA's in the last bit.
"""

from __future__ import annotations

import math

import torch

MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))



class Key(tuple):
    """A key's two 32-bit words ``(hi, lo)``, each an int in ``[0,
    2**32)``, and ``x64``: whether a draw from it that names no dtype takes
    float64 / int64 (True) or float32 / int32 (False), as jax's canonical
    dtypes do with ``jax_enable_x64`` on or off. A key equals the plain
    tuple of its words; a plain tuple passed as a key draws as ``x64``."""

    x64: bool

    def __new__(cls, words, x64: bool = True):
        k = super().__new__(cls, words)
        k.x64 = bool(x64)
        return k


def _x64(k) -> bool:
    return getattr(k, "x64", True)


def float_dtype(k) -> torch.dtype:
    """The float dtype of a draw from ``k`` that names none."""
    return torch.float64 if _x64(k) else torch.float32


def int_dtype(k) -> torch.dtype:
    """The integer dtype of a draw from ``k`` that names none."""
    return torch.int64 if _x64(k) else torch.int32


def _rotl(v, r: int):
    return ((v << r) | (v >> (32 - r))) & MASK32


def threefry2x32(k0, k1, x0, x1):
    """The Threefry-2x32 hash (20 rounds) of the counter pair ``(x0, x1)``
    under the key ``(k0, k1)``: ``_threefry2x32_lowering`` of jax's
    ``prng.py``. Operands are ints or int64 tensors holding 32-bit words."""
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


def key(seed: int, x64: bool = True) -> Key:
    """``jax.random.key(seed)``'s key data for a 64-bit integer seed; its
    draws default to float64 / int64 (``x64``) or float32 / int32."""
    seed &= (1 << 64) - 1
    return Key((seed >> 32, seed & MASK32), x64)


def fold_in(k: Key, data: int) -> Key:
    """``jax.random.fold_in(k, data)``: ``data`` wraps to uint32 first."""
    return Key(threefry2x32(k[0], k[1], 0, int(data) & MASK32), _x64(k))


def split(k: Key, num: int = 2) -> list:
    """``jax.random.split(k, num)`` as a list of ``num`` keys."""
    return [Key(threefry2x32(k[0], k[1], 0, i), _x64(k))
            for i in range(num)]


def _counters(shape, device):
    """Hi and lo words of the row-major flat index (``iota_2x32_shape``)."""
    n = math.prod(shape)
    idx = torch.arange(n, dtype=torch.int64, device=device)
    return idx >> 32, idx & MASK32


def random_bits(k: Key, bit_width: int, shape, device=None) -> torch.Tensor:
    """``jax.random.bits``-style draws of 32 or 64 bits, as int64 words of
    ``shape`` (64-bit draws come back as the pair ``(hi, lo)``)."""
    shape = tuple(shape)
    hi, lo = _counters(shape, device)
    b1, b2 = threefry2x32(k[0], k[1], hi, lo)
    if bit_width == 32:
        return (b1 ^ b2).reshape(shape)
    if bit_width == 64:
        return b1.reshape(shape), b2.reshape(shape)
    raise ValueError(f"bit_width must be 32 or 64, got {bit_width}")


def uniform(k: Key, shape=(), dtype=None, device=None) -> torch.Tensor:
    """``jax.random.uniform(k, shape, dtype)`` on ``[0, 1)``; ``dtype``
    None is the key's float dtype."""
    shape = tuple(shape)
    dtype = dtype or float_dtype(k)
    hi, lo = _counters(shape, device)
    return uniform_of_words(*threefry2x32(k[0], k[1], hi, lo),
                            dtype).reshape(shape)


def uniform_of_words(b1: torch.Tensor, b2: torch.Tensor,
                     dtype) -> torch.Tensor:
    """``uniform``'s float on ``[0, 1)`` from the hash words ``(b1, b2)``
    of each counter (int64 tensors holding 32-bit words)."""
    if dtype == torch.float32:
        fbits = ((b1 ^ b2) >> 9) | 0x3F800000     # 23 mantissa bits, 1.0
        return fbits.to(torch.int32).view(torch.float32) - 1.0
    if dtype == torch.float64:
        # the 64-bit draw >> 12, OR'd into 1.0's bits 0x3FF0000000000000
        fbits = (b1 << 20) | (b2 >> 12) | 0x3FF0000000000000
        return fbits.view(torch.float64) - 1.0
    raise TypeError(f"uniform: float32 or float64 only, got {dtype}")


#: XLA's ``erf_inv`` (the CHLO decomposition jax lowers to): Giles'
#: polynomials in ``w = -log1p(-x * x)``, highest power first. float32:
#: (w < 5, else) in ``w - 2.5`` / ``sqrt(w) - 3``; float64: (w < 6.25,
#: w < 16, else) in ``w - 3.125`` / ``sqrt(w) - 3.25`` / ``sqrt(w) - 5``.
_ERFINV_F32 = (
    (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
     0.00021858087, -0.00125372503, -0.00417768164, 0.246640727,
     1.50140941),
    (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
     0.00573950773, -0.0076224613, 0.00943887047, 1.00167406,
     2.83297682))
_ERFINV_F64 = (
    (-3.6444120640178196996e-21, -1.685059138182016589e-19,
     1.2858480715256400167e-18, 1.115787767802518096e-17,
     -1.333171662854620906e-16, 2.0972767875968561637e-17,
     6.6376381343583238325e-15, -4.0545662729752068639e-14,
     -8.1519341976054721522e-14, 2.6335093153082322977e-12,
     -1.2975133253453532498e-11, -5.4154120542946279317e-11,
     1.051212273321532285e-09, -4.1126339803469836976e-09,
     -2.9070369957882005086e-08, 4.2347877827932403518e-07,
     -1.3654692000834678645e-06, -1.3882523362786468719e-05,
     0.0001867342080340571352, -0.00074070253416626697512,
     -0.0060336708714301490533, 0.24015818242558961693,
     1.6536545626831027356),
    (2.2137376921775787049e-09, 9.0756561938885390979e-08,
     -2.7517406297064545428e-07, 1.8239629214389227755e-08,
     1.5027403968909827627e-06, -4.013867526981545969e-06,
     2.9234449089955446044e-06, 1.2475304481671778723e-05,
     -4.7318229009055733981e-05, 6.8284851459573175448e-05,
     2.4031110387097893999e-05, -0.0003550375203628474796,
     0.00095328937973738049703, -0.0016882755560235047313,
     0.0024914420961078508066, -0.0037512085075692412107,
     0.005370914553590063617, 1.0052589676941592334,
     3.0838856104922207635),
    (-2.7109920616438573243e-11, -2.5556418169965252055e-10,
     1.5076572693500548083e-09, -3.7894654401267369937e-09,
     7.6157012080783393804e-09, -1.4960026627149240478e-08,
     2.9147953450901080826e-08, -6.7711997758452339498e-08,
     2.2900482228026654717e-07, -9.9298272942317002539e-07,
     4.5260625972231537039e-06, -1.9681778105531670567e-05,
     7.5995277030017761139e-05, -0.00021503011930044477347,
     -0.00013871931833623122026, 1.0103004648645343977,
     4.8499064014085844221))


def _horner(coeffs, w):
    p = torch.full_like(w, coeffs[0])
    for c in coeffs[1:]:
        p = c + p * w
    return p


def erfinv(x: torch.Tensor) -> torch.Tensor:
    """XLA's ``erf_inv`` for float32 and float64 tensors (torch's own
    ``erfinv`` is another approximation: up to 63 float32 and 5672
    float64 ulps apart in the tails)."""
    w = -torch.log1p(x * -x)
    if x.dtype == torch.float32:
        lt5 = w < 5.0
        w = torch.where(lt5, w - 2.5, torch.sqrt(w) - 3.0)
        p = torch.where(lt5, _horner(_ERFINV_F32[0], w),
                        _horner(_ERFINV_F32[1], w))
    elif x.dtype == torch.float64:
        lt625, lt16 = w < 6.25, w < 16.0
        w = torch.where(lt625, w - 3.125,
                        torch.sqrt(w) - torch.where(lt16, 3.25, 5.0))
        p = torch.where(lt625, _horner(_ERFINV_F64[0], w),
                        torch.where(lt16, _horner(_ERFINV_F64[1], w),
                                    _horner(_ERFINV_F64[2], w)))
    else:
        raise TypeError(f"erfinv: float32 or float64 only, got {x.dtype}")
    return torch.where(x.abs() == 1.0, x * math.inf, p * x)


def normal(k: Key, shape=(), dtype=None, device=None) -> torch.Tensor:
    """``jax.random.normal(k, shape, dtype)`` (``random.py:_normal_real``):
    ``sqrt(2) * erfinv(u)`` for ``u`` uniform on ``[nextafter(-1, 0), 1)``,
    drawn as ``max(lo, f * (1 - lo) + lo)`` from ``uniform``'s ``f`` in
    ``[0, 1)`` (bit for bit), through XLA's ``erf_inv`` (:func:`erfinv`);
    ``dtype`` None is the key's float dtype. Torch's ``log1p`` and XLA's
    may round apart, so the draws agree with jax's to a few ulps."""
    dtype = dtype or float_dtype(k)
    f = uniform(k, shape, dtype, device)
    lo = torch.nextafter(torch.tensor(-1.0, dtype=dtype, device=f.device),
                         torch.tensor(0.0, dtype=dtype, device=f.device))
    u = torch.clamp_min(f * (1.0 - lo) + lo, lo)
    return erfinv(u) * torch.tensor(math.sqrt(2), dtype=dtype,
                                    device=f.device)


def bernoulli(k: Key, p: float, shape=(), dtype=None,
              device=None) -> torch.Tensor:
    """``jax.random.bernoulli(k, p, shape)`` with ``p`` of dtype ``dtype``
    (None: the key's float dtype, what a Python ``p`` becomes in jax)."""
    dtype = dtype or float_dtype(k)
    u = uniform(k, shape, dtype, device)
    return u < torch.tensor(p, dtype=dtype, device=u.device)


def randint(k: Key, shape, minval: int, maxval: int, dtype=None,
            device=None) -> torch.Tensor:
    """``jax.random.randint(k, shape, minval, maxval, dtype)`` for int32
    and int64 (``_randint``: two draws, the high one reduced through
    ``2**nbits mod span``); ``dtype`` None is the key's integer dtype.
    ``maxval`` must not exceed the dtype's range."""
    dtype = dtype or int_dtype(k)
    nbits = {torch.int32: 32, torch.int64: 64}[dtype]
    k1, k2 = split(k)
    span = maxval - minval if maxval > minval else 1
    mult = pow(2, nbits // 2, span)
    mult = (mult * mult) % span
    if nbits == 32:
        hi = random_bits(k1, 32, shape, device)
        lo = random_bits(k2, 32, shape, device)
    else:  # reduce the 64-bit words mod span without leaving int64
        hi = _mod64(*random_bits(k1, 64, shape, device), span)
        lo = _mod64(*random_bits(k2, 64, shape, device), span)
    off = ((hi % span) * mult + lo % span) % span
    return (minval + off).to(dtype)


def _mod64(w_hi: torch.Tensor, w_lo: torch.Tensor, span: int) -> torch.Tensor:
    """``(w_hi * 2**32 + w_lo) % span`` for span < 2**31, in int64."""
    if not 0 < span < 2 ** 31:
        raise ValueError(f"randint span must be in (0, 2**31), got {span}")
    return ((w_hi % span) * (2 ** 32 % span) + w_lo % span) % span


def permutation(k: Key, n: int, device=None) -> torch.Tensor:
    """``jax.random.permutation(k, n)``: a shuffle of ``arange(n)`` (int64)
    by stable sorts on fresh 32-bit keys, as many rounds as jax's
    ``_shuffle`` runs for ``n`` (0 at n 1, 1 up to 1625, 2 up to
    2,642,245, then 3)."""
    x = torch.arange(n, dtype=torch.int64, device=device)
    rounds = math.ceil(3 * math.log(max(1, n)) / math.log(MASK32))
    for _ in range(rounds):
        k, sub = split(k)
        bits = random_bits(sub, 32, (n,), device)   # unsigned, in int64
        x = x[torch.sort(bits, stable=True).indices]
    return x


def categorical(k: Key, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(k, logits)`` over the last axis: the
    Gumbel-max draw, one Gumbel variate per logit from ``uniform`` in the
    logits' dtype (float32 or float64). Returns int64 indices of
    ``logits.shape[:-1]``; ties go to the lower index, as in
    ``jnp.argmax``."""
    tiny = torch.finfo(logits.dtype).tiny
    u = uniform(k, logits.shape, logits.dtype, device=logits.device)
    # (1 - tiny) rounds to 1 in float32 and float64, as in jax's _uniform.
    u = torch.clamp_min(u * (1.0 - tiny) + tiny, tiny)
    return torch.argmax(-torch.log(-torch.log(u)) + logits, dim=-1)
