"""The port's attention (``models/attention.py``) and the plain version of
its flash-attention kernel (``kernels/ref.py:flash_attention``) against
the JAX package on the CPU, on the same numpy inputs and parameters.

* Plain flash attention against the reference's Pallas kernel (interpret
  mode) and against its ``attend_naive``: every mask kind, G in {1, 2, 4},
  tiles that do not divide S, T != S, and query rows with no allowed key
  (chunked and sliding with T < S), whose value the CUDA kernel matches. Tolerance: rtol = atol = 2e-5 in
  float32 (the reference kernel's own bound against naive attention,
  ``tests/test_kernels.py``), 5e-2 in bfloat16.
* ``attend_blockwise`` at a small block size and ``attention()`` at
  S = 1100 (the blockwise branch) against the reference: 2e-5.
* The KV cache (init, prefill with and without a ring wrap, append),
  ``attend_decode``, ``decode_attention`` and ``prefill_attention`` with
  qk-norm and biases (moved off zero so they act): cache contents equal,
  outputs within 2e-5 (float32 einsums summed in another order).
* The decode-equals-forward and prefill-then-decode properties of
  ``tests/test_attention.py``, on the port alone, at its 2e-4.
"""

import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref
from repro_torch.models import attention as A
from repro_torch.models.convert import params_from_numpy

KINDS = ["causal", "sliding", "chunked", "bidirectional"]
TOL = dict(rtol=2e-5, atol=2e-5)


def _jax():
    import jax

    jax.config.update("jax_enable_x64", True)
    from repro.kernels import ops as jops
    from repro.models import attention as JA

    return jax, jops, JA


def _qkv(B, S, T, Hkv, G, D, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, Hkv * G, D)).astype(dtype),
            rng.standard_normal((B, T, Hkv, D)).astype(dtype),
            rng.standard_normal((B, T, Hkv, D)).astype(dtype))


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


# ---------------------------------------------------- plain flash attention
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("G", [1, 2, 4])
def test_plain_flash_matches_the_pallas_kernel_and_naive(kind, G):
    jax, jops, JA = _jax()
    import jax.numpy as jnp

    q, k, v = _qkv(2, 37, 37, 2, G, 8, seed=G)
    kw = dict(kind=kind, window=5, chunk=7)
    got = ref.flash_attention(*_t(q, k, v), q_blk=16, kv_blk=8, **kw)
    pallas = jops.flash_attention(q, k, v, q_blk=16, kv_blk=8, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), **TOL)
    kr, vr = (jnp.repeat(t, G, axis=2) for t in (k, v))
    naive = JA.attend_naive(jnp.asarray(q), kr, vr,
                            JA.mask_fn(kind, window=5, chunk=7))
    np.testing.assert_allclose(got.numpy(), np.asarray(naive), **TOL)
    # the CPU route of ops is the plain version, whatever its tiles
    np.testing.assert_allclose(ops.flash_attention(*_t(q, k, v), **kw),
                               got.numpy(), **TOL)


@pytest.mark.parametrize("S,T", [(20, 45), (45, 20)])
def test_plain_flash_with_t_unlike_s_matches_the_pallas_kernel(S, T):
    jax, jops, JA = _jax()
    q, k, v = _qkv(1, S, T, 2, 2, 16, seed=S)
    got = ref.flash_attention(*_t(q, k, v), q_blk=16, kv_blk=16)
    want = jops.flash_attention(q, k, v, q_blk=16, kv_blk=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("kind,S,T", [("chunked", 520, 300),
                                      ("sliding", 200, 100)])
def test_plain_flash_rows_with_no_allowed_key_match_the_pallas_kernel(
        kind, S, T):
    """T < S leaves query rows with no allowed key (a chunk of 64 that
    starts at or after T; a sliding row with qpos - 16 >= T - 1). The
    reference's kernel, at its default tiles, gives them every key and pad
    key the weight exp(0) = 1: sum_{t<T} v_t / (nk * kv_blk), kv_blk =
    min(256, T). The plain version, which the CUDA kernel is held to on
    the card, gives the same."""
    jax, jops, JA = _jax()
    G = 2
    q, k, v = _qkv(1, S, T, 2, G, 16, seed=S)
    kw = dict(kind=kind, window=16, chunk=64)
    got = ref.flash_attention(*_t(q, k, v), **kw).numpy()
    np.testing.assert_allclose(got, np.asarray(jops.flash_attention(
        q, k, v, **kw)), **TOL)
    qpos = np.arange(S)
    empty = ((qpos // 64) * 64 >= T if kind == "chunked"
             else qpos - 16 >= T - 1)
    assert 0 < empty.sum() < S
    blk = min(256, T)
    mean = np.repeat(v.sum(axis=1) / (-(-T // blk) * blk), G, axis=1)
    np.testing.assert_allclose(got[:, empty],
                               np.broadcast_to(mean[:, None],
                                               got[:, empty].shape), **TOL)


def test_plain_flash_bf16_matches_the_pallas_kernel():
    jax, jops, JA = _jax()
    import jax.numpy as jnp

    q, k, v = _qkv(1, 64, 64, 2, 4, 16, seed=1)
    jq, jk, jv = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v))
    want = jops.flash_attention(jq, jk, jv, q_blk=32, kv_blk=32)
    tq, tk, tv = (torch.from_numpy(np.array(a.astype(jnp.float32))).to(
        torch.bfloat16) for a in (jq, jk, jv))
    got = ref.flash_attention(tq, tk, tv, q_blk=32, kv_blk=32)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=5e-2, atol=5e-2)


def _tf32(t, nearest=True):
    """float32 to TF32 (10 mantissa bits): to nearest with ties away from
    zero, as ``cvt.rna.tf32.f32`` rounds (add half a unit of the 13 dropped
    bits to the magnitude, then clear them), or truncated, as the tensor
    cores read a float32 operand."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000 if nearest else bits) & -0x2000).view(
        torch.float32)


def _flash_on_tf32(q, k, v, kind, window, passes):
    """The CUDA kernel's float32 arithmetic in plain torch: ``q k^T`` and
    ``p v`` as float32 sums of products of TF32 values (exact in float32,
    as on the tensor cores), the softmax in float32. ``passes=3`` is
    3xTF32 (``a_lo b_hi + a_hi b_lo + a_hi b_hi``, ``hi = tf32(v)`` to
    nearest, ``lo = v - hi`` as the tensor cores read it, truncated);
    ``passes=1`` one TF32 product ``a_hi b_hi``."""
    def product(eq, a, b):
        ah, bh = _tf32(a), _tf32(b)
        out = torch.einsum(eq, ah, bh)
        if passes == 3:
            out = (torch.einsum(eq, _tf32(a - ah, nearest=False), bh)
                   + torch.einsum(eq, ah, _tf32(b - bh, nearest=False))
                   + out)
        return out

    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    qg = q.reshape(B, S, Hkv, Hq // Hkv, D)
    s = product("bqhgd,bkhd->bqhgk", qg, k) / math.sqrt(D)
    qp, kp = torch.arange(S)[:, None], torch.arange(T)[None, :]
    ok = kp <= qp
    if kind == "sliding":
        ok = ok & (kp > qp - window)
    s = torch.where(ok[None, :, None, None, :], s, ref.NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    out = product("bqhgk,bkhd->bqhgd", p, v) / p.sum(dim=-1)[..., None]
    return out.reshape(B, S, Hq, D)


@pytest.mark.parametrize("kind", ["causal", "sliding"])
@pytest.mark.parametrize("D", [64, 128])
def test_flash_3xtf32_emulation_within_the_float32_gate(kind, D):
    """Why the CUDA kernel runs both products as 3xTF32 on the tensor cores
    in float32: emulated here at 1024 tokens, it stays within the card's
    float32 gate (rtol = atol = 2e-5) of the plain float32 version, where
    one TF32 pass misses it (~1e-3). fedlm-100m's and qwen3-1.7b's head
    dims, G = 2."""
    q, k, v = _t(*_qkv(1, 1024, 1024, 1, 2, D, seed=D))
    want = ref.flash_attention(q, k, v, kind=kind, window=300).numpy()
    three = _flash_on_tf32(q, k, v, kind, 300, passes=3).numpy()
    one = _flash_on_tf32(q, k, v, kind, 300, passes=1).numpy()
    np.testing.assert_allclose(three, want, **TOL)
    assert not np.allclose(one, want, **TOL)


# ------------------------------------------------------ blockwise, attention
@pytest.mark.parametrize("kind", ["causal", "sliding", "chunked"])
def test_attend_blockwise_matches_jax(kind):
    jax, jops, JA = _jax()
    q, k, v = _qkv(2, 50, 50, 2, 2, 8, seed=3)
    got = A.attend_blockwise(*_t(q, k, v), A.mask_fn(kind, window=7, chunk=9),
                             block_size=16)
    want = JA.attend_blockwise(q, k, v, JA.mask_fn(kind, window=7, chunk=9),
                               block_size=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _params(jax, JA, d, Hq, Hkv, D, seed, *, qk_norm=True, with_bias=True):
    """The reference's init, with norm weights and biases moved off 0."""
    import jax.numpy as jnp

    p = JA.init_attention(jax.random.key(seed), d, Hq, Hkv, D, jnp.float32,
                          qk_norm=qk_norm, with_bias=with_bias)
    rng = np.random.default_rng(seed)
    p = {n: np.asarray(a) + (0.1 * rng.standard_normal(a.shape).astype(
        np.float32) if n in ("q_norm", "k_norm", "bq", "bk", "bv", "bo")
        else 0) for n, a in p.items()}
    return p, params_from_numpy(p)


def _x(B, S, d, seed):
    return np.random.default_rng(seed).standard_normal((B, S, d)).astype(
        np.float32)


@pytest.mark.parametrize("kind", ["full", "sliding"])
def test_attention_long_sequence_takes_the_blockwise_path(kind):
    jax, jops, JA = _jax()
    B, S, Hq, Hkv, D, d = 1, 1100, 4, 2, 4, 16
    jp, tp = _params(jax, JA, d, Hq, Hkv, D, 0)
    x = _x(B, S, d, 1)
    kw = dict(n_heads=Hq, n_kv_heads=Hkv, head_dim=D, kind=kind, window=300)
    got = A.attention(tp, torch.from_numpy(x), **kw)
    want = JA.attention(jp, x, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # and use_pallas (the plain flash version on the CPU) agrees
    flash = A.attention(tp, torch.from_numpy(x), use_pallas=True, **kw)
    np.testing.assert_allclose(flash.numpy(), np.asarray(want), **TOL)


def test_use_pallas_refuses_autograd():
    B, S, Hq, Hkv, D, d = 1, 8, 2, 1, 4, 8
    jax, jops, JA = _jax()
    _, tp = _params(jax, JA, d, Hq, Hkv, D, 0)
    x = torch.from_numpy(_x(B, S, d, 1)).requires_grad_()
    kw = dict(n_heads=Hq, n_kv_heads=Hkv, head_dim=D)
    with pytest.raises(NotImplementedError,
                       match="Beyond the reference item 1"):
        A.attention(tp, x, use_pallas=True, **kw)
    with torch.no_grad():
        A.attention(tp, x, use_pallas=True, **kw)
    A.attention(tp, x, **kw).sum().backward()  # the other paths train


# ------------------------------------------------------------------- cache
def _cache_np(cache):
    return [np.asarray(a) for a in (cache.k, cache.v, cache.pos)]


def _same_cache(got, want):
    for g, w in zip(_cache_np(got), _cache_np(want)):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, **TOL)
    assert got.length == int(want.length)


@pytest.mark.parametrize("S,cap,ring", [(10, 16, False), (10, 16, True),
                                        (23, 8, True), (16, 8, True)])
def test_prefill_and_append_fill_the_cache_like_jax(S, cap, ring):
    jax, jops, JA = _jax()
    import jax.numpy as jnp

    B, Hkv, D = 2, 2, 4
    rng = np.random.default_rng(S + cap)
    k, v = (rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
            for _ in range(2))
    jc = JA.prefill_into_cache(JA.init_cache(B, cap, Hkv, D, jnp.float32),
                               k, v, ring=ring)
    tc = A.prefill_into_cache(A.init_cache(B, cap, Hkv, D, torch.float32),
                              *_t(k, v), ring=ring)
    _same_cache(tc, jc)
    for step in range(cap + 2):  # a non-ring cache clamps to its last slot
        k1, v1 = (rng.standard_normal((B, 1, Hkv, D)).astype(np.float32)
                  for _ in range(2))
        jc = JA.append_to_cache(jc, k1, v1, ring=ring)
        tc = A.append_to_cache(tc, *_t(k1, v1), ring=ring)
        _same_cache(tc, jc)
        q1 = rng.standard_normal((B, 2 * Hkv, D)).astype(np.float32)
        for kind, kw in (("full", {}), ("sliding", dict(window=5)),
                         ("chunked", dict(chunk=6))):
            np.testing.assert_allclose(
                A.attend_decode(torch.from_numpy(q1), tc, kind=kind,
                                **kw).numpy(),
                np.asarray(JA.attend_decode(q1, jc, kind=kind, **kw)), **TOL)


@pytest.mark.parametrize("kind,window,ring", [("full", 0, False),
                                              ("sliding", 6, True)])
def test_prefill_and_decode_attention_match_jax(kind, window, ring):
    jax, jops, JA = _jax()
    import jax.numpy as jnp

    B, S, Hq, Hkv, D, d = 2, 13, 4, 2, 8, 16
    cap = window if ring else S + 3
    jp, tp = _params(jax, JA, d, Hq, Hkv, D, 4)
    x = _x(B, S + 3, d, 5)
    kw = dict(n_heads=Hq, n_kv_heads=Hkv, head_dim=D, kind=kind,
              window=window, ring=ring)
    jo, jc = JA.prefill_attention(
        jp, x[:, :S], cache=JA.init_cache(B, cap, Hkv, D, jnp.float32), **kw)
    to, tc = A.prefill_attention(
        tp, torch.from_numpy(x[:, :S]),
        cache=A.init_cache(B, cap, Hkv, D, torch.float32), **kw)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
    _same_cache(tc, jc)
    for t in range(S, S + 3):
        jo, jc = JA.decode_attention(jp, x[:, t:t + 1], jc, **kw)
        to, tc = A.decode_attention(tp, torch.from_numpy(x[:, t:t + 1]), tc,
                                    **kw)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
        _same_cache(tc, jc)


# --------------------------------------------------------------- properties
@pytest.mark.parametrize("kind,window,chunk", [
    ("full", 0, 0), ("sliding", 8, 0), ("chunked", 0, 8)])
def test_decode_matches_full_forward(kind, window, chunk):
    """Token-by-token decode through the cache reproduces the full-sequence
    attention output at every position (``tests/test_attention.py:42``)."""
    jax, jops, JA = _jax()
    B, S, Hq, Hkv, D, d = 2, 24, 4, 2, 8, 32
    _, tp = _params(jax, JA, d, Hq, Hkv, D, 0, with_bias=False)
    x = torch.from_numpy(_x(B, S, d, 1))
    kw = dict(n_heads=Hq, n_kv_heads=Hkv, head_dim=D, kind=kind,
              window=window, chunk=chunk)
    full = A.attention(tp, x, force_naive=True, **kw)
    ring = kind == "sliding"
    cache = A.init_cache(B, window if ring else S, Hkv, D, torch.float32)
    outs = []
    for t in range(S):
        o, cache = A.decode_attention(tp, x[:, t:t + 1], cache, ring=ring,
                                      **kw)
        outs.append(o)
    np.testing.assert_allclose(torch.cat(outs, dim=1).numpy(), full.numpy(),
                               rtol=2e-4, atol=2e-4)


def test_prefill_then_decode_matches_forward():
    """prefill(x[:P]) + decode steps == full attention on x
    (``tests/test_attention.py:66``)."""
    jax, jops, JA = _jax()
    B, S, P, Hq, Hkv, D, d = 1, 20, 12, 4, 4, 8, 32
    _, tp = _params(jax, JA, d, Hq, Hkv, D, 3, qk_norm=False,
                    with_bias=False)
    x = torch.from_numpy(_x(B, S, d, 5))
    kw = dict(n_heads=Hq, n_kv_heads=Hkv, head_dim=D, kind="full")
    full = A.attention(tp, x, force_naive=True, **kw)
    pre, cache = A.prefill_attention(
        tp, x[:, :P], cache=A.init_cache(B, S, Hkv, D, torch.float32), **kw)
    np.testing.assert_allclose(pre.numpy(), full[:, :P].numpy(), rtol=2e-4,
                               atol=2e-4)
    for t in range(P, S):
        o, cache = A.decode_attention(tp, x[:, t:t + 1], cache, **kw)
        np.testing.assert_allclose(o[:, 0].numpy(), full[:, t].numpy(),
                                   rtol=2e-4, atol=2e-4)
