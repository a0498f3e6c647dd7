"""The port's Mamba2 blocks (``models/mamba2.py``) and the plain version of
its SSD intra-chunk kernel (``kernels/ref.py:ssd_intra``) against the JAX
package on the CPU, on the same numpy inputs and parameters.

* ``tests/test_mamba2.py`` mirrored: the chunked dual form against the
  per-token recurrence (a hypothesis property over shapes and chunkings),
  a carried initial state, the block's chunked and naive paths, prefill
  plus token-by-token decode against the full block, and the constant
  cache size; each also against the reference's own outputs. Tolerance:
  rtol = atol = 2e-4 (the reference's), 2e-3 for decode steps.
* ``tests/test_kernels.py::test_ssd_intra_kernel_sweep`` and
  ``::test_ssd_intra_matches_mamba_chunked_path`` mirrored: the plain
  version against the reference's Pallas kernel in interpret mode, within
  1e-4 in float32 and 1e-1 in bfloat16 (the reference's bounds), plus a
  ragged chunk of 37 and a chunk whose cumulative decay reaches ~-1e3.
* The CUDA kernel's numerics, emulated: 3xTF32 tensor-core products stay
  within 1e-5 of the output's scale of the plain version; one TF32 pass
  does not stay within the card's 1e-4.
* The helpers the family adds: ``softplus`` (``jax.nn.softplus`` is
  ``logaddexp(x, 0)`` at every x), the depthwise causal conv and its
  one-token step, ``layer_norm`` / ``apply_norm`` / ``init_norm``.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro_torch.configs import get_config
from repro_torch.kernels import ops, ref
from repro_torch.models import layers as TL
from repro_torch.models import mamba2 as M
from repro_torch.models.convert import params_from_numpy

TOL = dict(rtol=2e-4, atol=2e-4)
DECODE_TOL = dict(rtol=2e-3, atol=2e-3)


def _jax():
    import jax

    jax.config.update("jax_enable_x64", True)
    from repro.models import mamba2 as JM

    return jax, JM


def _ssd_inputs(seed, B, S, H, P, N, a_scale=0.5):
    rng = np.random.default_rng(seed)
    f = np.float32
    return (rng.standard_normal((B, S, H, P)).astype(f),
            np.logaddexp(rng.standard_normal((B, S, H)), 0).astype(f),
            (-np.exp(rng.standard_normal(H) * a_scale)).astype(f),
            rng.standard_normal((B, S, N)).astype(f),
            rng.standard_normal((B, S, N)).astype(f))


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **tol)


# ------------------------------------------------------------- SSD forms
@settings(max_examples=6, deadline=None)
@given(
    seed=st.integers(0, 10_000),
    S=st.integers(2, 80),
    H=st.sampled_from([1, 2, 4]),
    P=st.sampled_from([4, 8]),
    N=st.sampled_from([4, 16]),
    chunk=st.sampled_from([4, 16, 128]),
)
def test_property_ssd_chunked_matches_naive(seed, S, H, P, N, chunk):
    """Chunked == recurrence for any chunking (chunks that do not divide S
    included), and both == the reference's."""
    jax, JM = _jax()
    arrays = _ssd_inputs(seed, 2, S, H, P, N)
    y, h = M.ssd_chunked(*_t(*arrays), chunk=chunk)
    y_n, h_n = M.ssd_naive(*_t(*arrays))
    _close(y, y_n)
    _close(h, h_n)
    jy, jh = JM.ssd_chunked(*arrays, chunk=chunk)
    jy_n, jh_n = JM.ssd_naive(*arrays)
    _close(y, jy)
    _close(h, jh)
    _close(y_n, jy_n)
    _close(h_n, jh_n)


def test_ssd_with_initial_state():
    """A carried h0 continues a longer sequence, as in the reference."""
    jax, JM = _jax()
    x, dt, A, Bm, Cm = _t(*_ssd_inputs(0, 1, 32, 2, 4, 8))
    y_full, h_full = M.ssd_chunked(x, dt, A, Bm, Cm, chunk=8)
    cut = 20
    y1, h1 = M.ssd_chunked(x[:, :cut], dt[:, :cut], A, Bm[:, :cut],
                           Cm[:, :cut], chunk=8)
    y2, h2 = M.ssd_chunked(x[:, cut:], dt[:, cut:], A, Bm[:, cut:],
                           Cm[:, cut:], chunk=8, h0=h1)
    _close(torch.cat([y1, y2], 1), y_full)
    _close(h2, h_full)
    jy2, jh2 = JM.ssd_chunked(*(np.asarray(t)[:, cut:] if t.dim() > 1
                                else np.asarray(t)
                                for t in (x, dt, A, Bm, Cm)),
                              chunk=8, h0=h1.numpy())
    _close(y2, jy2)
    _close(h2, jh2)


def _block(jax, JM, seed=0):
    """Reduced mamba2-130m block parameters drawn by the reference, with
    the norm weights and biases moved off zero so they act."""
    from repro.configs import get_config as jget

    jcfg = jget("mamba2-130m").reduced()
    jp = JM.init_mamba_block(jax.random.key(seed), jcfg)
    rng = np.random.default_rng(seed + 100)
    jp = {k: (np.asarray(v) + 0.05 * rng.standard_normal(v.shape).astype(
        np.asarray(v).dtype)) if k in ("norm", "out_norm", "dt_bias",
                                       "conv_b") else np.asarray(v)
          for k, v in jp.items()}
    return jcfg, get_config("mamba2-130m").reduced(), jp, params_from_numpy(jp)


def _u(cfg, B, S, seed=1):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)


def test_block_full_vs_naive_path():
    jax, JM = _jax()
    jcfg, cfg, jp, p = _block(jax, JM)
    u = _u(cfg, 2, 24)
    (tu,) = _t(u)
    out_c = M.apply_mamba_block(p, tu, cfg)
    out_n = M.apply_mamba_block(p, tu, cfg, naive=True)
    _close(out_c, out_n)
    _close(out_c, JM.apply_mamba_block(jp, u, jcfg))
    _close(out_n, JM.apply_mamba_block(jp, u, jcfg, naive=True))


def test_prefill_plus_decode_matches_full():
    """prefill(u[:9]) then token-by-token decode == the full block, and
    the prefill's caches and outputs == the reference's."""
    jax, JM = _jax()
    import jax.numpy as jnp

    jcfg, cfg, jp, p = _block(jax, JM)
    B, S, cut = 2, 16, 9
    u = _u(cfg, B, S)
    (tu,) = _t(u)
    with torch.no_grad():
        full = M.apply_mamba_block(p, tu, cfg)
        cache = M.init_ssm_cache(B, cfg, torch.float32)
        out_pre, cache = M.apply_mamba_block_prefill(p, tu[:, :cut], cache,
                                                     cfg)
    _close(out_pre, full[:, :cut])
    jout, jcache = JM.apply_mamba_block_prefill(
        jp, u[:, :cut], JM.init_ssm_cache(B, jcfg, jnp.float32), jcfg)
    _close(out_pre, jout)
    _close(cache.conv, jcache.conv)
    _close(cache.state, jcache.state)
    assert cache.length == int(jcache.length) == cut
    for t in range(cut, S):
        with torch.no_grad():
            o, cache = M.apply_mamba_block_decode(p, tu[:, t:t + 1], cache,
                                                  cfg)
        _close(o[:, 0], full[:, t], DECODE_TOL)
        jo, jcache = JM.apply_mamba_block_decode(jp, u[:, t:t + 1], jcache,
                                                 jcfg)
        _close(o, jo, DECODE_TOL)
    assert cache.length == S


@pytest.mark.parametrize("S", [1, 2])
def test_prefill_shorter_than_the_conv_keeps_the_cache_tail(S):
    """The degenerate branch (S < K - 1): the conv tail shifts the empty
    cache's zeros left and appends the prompt, as in the reference."""
    jax, JM = _jax()
    import jax.numpy as jnp

    jcfg, cfg, jp, p = _block(jax, JM, seed=2)
    u = _u(cfg, 2, S, seed=3)
    (tu,) = _t(u)
    with torch.no_grad():
        out, cache = M.apply_mamba_block_prefill(
            p, tu, M.init_ssm_cache(2, cfg, torch.float32), cfg)
    jout, jcache = JM.apply_mamba_block_prefill(
        jp, u, JM.init_ssm_cache(2, jcfg, jnp.float32), jcfg)
    assert tuple(cache.conv.shape) == jcache.conv.shape
    _close(out, jout)
    _close(cache.conv, jcache.conv)
    _close(cache.state, jcache.state)


def test_decode_state_is_constant_size():
    """The SSM cache size does not depend on the sequence length, and its
    leaves have the reference's shapes and dtypes."""
    jax, JM = _jax()
    import jax.numpy as jnp

    cfg = get_config("mamba2-130m").reduced()
    c1 = M.init_ssm_cache(1, cfg, torch.float32)
    assert c1.conv.numel() + c1.state.numel() < 100_000
    assert c1.state.dtype == torch.float32 and c1.length == 0
    jc = JM.init_ssm_cache(1, cfg, jnp.float32)
    assert tuple(c1.conv.shape) == jc.conv.shape
    assert tuple(c1.state.shape) == jc.state.shape
    from repro_torch.models import build_model

    model = build_model(cfg)
    short, long = model.init_caches(2, 16), model.init_caches(2, 500_000)
    assert [tuple(c.state.shape) for c in short] == [
        tuple(c.state.shape) for c in long]


# ------------------------------------------------- the intra-chunk kernel
def _intra_inputs(shape, seed=3, decay=1.0):
    """x, dt, a_cs, Bm, Cm as numpy float32, the reference sweep's
    distributions (a_cs a cumulative sum of -softplus(normal) * decay)."""
    B, Nc, Lc, H, P, N = shape
    rng = np.random.default_rng(seed)
    f = np.float32
    a = -np.logaddexp(rng.standard_normal((B, Nc, Lc, H)), 0) * decay
    return (rng.standard_normal((B, Nc, Lc, H, P)).astype(f),
            np.logaddexp(rng.standard_normal((B, Nc, Lc, H)), 0).astype(f),
            np.cumsum(a, axis=2).astype(f),
            rng.standard_normal((B, Nc, Lc, N)).astype(f),
            rng.standard_normal((B, Nc, Lc, N)).astype(f))


@pytest.mark.parametrize("shape", [
    (1, 1, 8, 1, 4, 4),
    (2, 3, 16, 2, 8, 8),
    (1, 2, 128, 3, 64, 32),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_intra_plain_matches_the_pallas_kernel(shape, dtype):
    jax, JM = _jax()
    import jax.numpy as jnp
    from repro.kernels import ops as jops

    arrays = _intra_inputs(shape)
    jarrays = [jnp.asarray(a).astype(dtype) for a in arrays]
    want = jops.ssd_intra(*jarrays)
    tdt = getattr(torch, dtype)
    targs = [torch.from_numpy(np.array(a.astype(jnp.float32))).to(tdt)
             for a in jarrays]
    got = ref.ssd_intra(*targs)
    assert got.dtype == tdt and tuple(got.shape) == shape[:5]
    tol = 1e-4 if dtype == "float32" else 1e-1
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=tol, atol=tol)
    # the CPU route of ops is the plain version
    assert torch.equal(ops.ssd_intra(*targs), got)


@pytest.mark.parametrize("case", ["ragged_37", "decay_1e3"])
def test_ssd_intra_ragged_and_deep_decay(case):
    """A chunk of 37 (not a tile multiple) and a_cs falling to ~-1e3 over
    a 128-token chunk (A = -16 with dt ~ 0.5): the masked difference is
    taken before the exp, so nothing overflows."""
    jax, JM = _jax()
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref

    if case == "ragged_37":
        arrays = _intra_inputs((2, 2, 37, 3, 16, 16), seed=4)
    else:
        arrays = _intra_inputs((1, 2, 128, 2, 16, 16), seed=5, decay=11.0)
        assert arrays[2].min() < -900
    got = ref.ssd_intra(*_t(*arrays))
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(jref.ssd_intra(
        *arrays)), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.numpy(), np.asarray(jops.ssd_intra(
        *arrays)), rtol=1e-4, atol=1e-4)


def test_ssd_intra_matches_mamba_chunked_path():
    """The intra-chunk term on the first chunk is the whole SSD output
    there (no inter-chunk term): == ssd_chunked and ssd_naive."""
    x, dt, A, Bm, Cm = _t(*_ssd_inputs(5, 1, 32, 2, 8, 8, a_scale=0.3))
    B, S, H, P = x.shape
    N, Lc = Bm.shape[-1], 8
    Nc = S // Lc
    dtf = dt.reshape(B, Nc, Lc, H)
    y_intra = ops.ssd_intra(x.reshape(B, Nc, Lc, H, P), dtf,
                            torch.cumsum(dtf * A, dim=2),
                            Bm.reshape(B, Nc, Lc, N),
                            Cm.reshape(B, Nc, Lc, N)).reshape(B, S, H, P)
    y_full, _ = M.ssd_chunked(x, dt, A, Bm, Cm, chunk=Lc)
    y_first, _ = M.ssd_naive(x[:, :Lc], dt[:, :Lc], A, Bm[:, :Lc],
                             Cm[:, :Lc])
    _close(y_intra[:, :Lc], y_full[:, :Lc])
    _close(y_intra[:, :Lc], y_first)


def _tf32(t, nearest=True):
    """float32 to TF32 (10 mantissa bits): to nearest with ties away from
    zero, as ``cvt.rna.tf32.f32`` rounds (add half a unit of the 13 dropped
    bits to the magnitude, then clear them), or truncated, as the tensor
    cores read a float32 operand."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000 if nearest else bits) & -0x2000).view(
        torch.float32)


def _ssd_intra_on_tf32(x, dt, a_cs, Bm, Cm, passes):
    """The CUDA kernel's arithmetic in plain torch: ``C B^T`` and ``W @ x``
    as float32 sums of products of TF32 values (exact in float32, as on the
    tensor cores). ``passes=3`` is 3xTF32 (``a_lo b_hi + a_hi b_lo + a_hi
    b_hi``, ``hi = tf32(v)`` to nearest, ``lo = v - hi`` as the tensor
    cores read it, truncated); ``passes=1`` one TF32 product
    ``a_hi b_hi``."""
    def product(eq, a, b):
        ah, bh = _tf32(a), _tf32(b)
        out = torch.einsum(eq, ah, bh)
        if passes == 3:
            out = (torch.einsum(eq, _tf32(a - ah, nearest=False), bh)
                   + torch.einsum(eq, ah, _tf32(b - bh, nearest=False))
                   + out)
        return out

    cb = product("bcin,bcjn->bcij", Cm, Bm)
    lc = x.shape[2]
    causal = torch.tril(torch.ones((lc, lc), dtype=torch.bool))[
        None, None, :, :, None]
    seg = torch.where(causal, a_cs[:, :, :, None] - a_cs[:, :, None], 0.0)
    w = torch.where(causal, cb[..., None] * torch.exp(seg)
                    * dt[:, :, None], 0.0)
    return product("bcijh,bcjhp->bcihp", w, x)


@pytest.mark.parametrize("shape", [(1, 2, 128, 4, 64, 128),
                                   (2, 3, 45, 3, 20, 12)])
def test_ssd_intra_3xtf32_emulation_within_the_float32_gate(shape):
    """Why the CUDA kernel runs both products as 3xTF32 on the tensor
    cores: emulated here, it stays within 1e-5 of the output's scale of the
    plain float32 version (the card's gate is 1e-4), where one TF32 pass
    misses that gate (~5e-4). mamba2-130m's head dim and state (P 64, N
    128) and Lc, P, N off the 16 / 8 / 8 tiles."""
    args = _t(*_intra_inputs(shape, seed=7))
    want = ref.ssd_intra(*args)
    scale = float(want.abs().max())
    err3 = float((_ssd_intra_on_tf32(*args, passes=3) - want).abs().max())
    err1 = float((_ssd_intra_on_tf32(*args, passes=1) - want).abs().max())
    assert err3 <= 1e-5 * scale
    assert err1 > 1e-4 * scale


def test_ssd_intra_kernel_route_refuses_cpu_tensors_and_autograd():
    """``impl="kernel"`` needs CUDA tensors; and the kernel has no backward,
    so the kernel route raises under autograd before anything else."""
    args = _t(*_intra_inputs((1, 1, 8, 1, 4, 4)))
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.ssd_intra(*args, impl="kernel")
    args[0].requires_grad_(True)
    with pytest.raises(NotImplementedError, match="backward"):
        ops.ssd_intra(*args, impl="kernel")
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA tensors"):
        ops.ssd_intra(*args, impl="kernel")
    # the plain route differentiates
    ops.ssd_intra(*args).sum().backward()
    assert args[0].grad is not None and torch.isfinite(args[0].grad).all()


# ----------------------------------------------------------------- helpers
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_softplus_is_jax_softplus(dtype):
    """Within a few ulps at every x (XLA's CPU flushes the denormal
    exp(-100) to 0, torch keeps it); in float64 above 20 the two differ
    from ``F.softplus``, which returns x itself there."""
    jax, JM = _jax()
    x = np.array([-100.0, -20.5, -1.0, 0.0, 0.3, 19.9, 20.1, 25.0, 35.0,
                  100.0], dtype)
    got = M.softplus(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax.nn.softplus(x)),
                               rtol=4 * np.finfo(dtype).eps, atol=1e-30)
    if dtype == np.float64:
        assert got[7] != torch.nn.functional.softplus(
            torch.from_numpy(x))[7].item()


def test_causal_conv_and_conv_step_match_jax():
    jax, JM = _jax()
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 11, 6)).astype(np.float32)
    w = rng.standard_normal((6, 4)).astype(np.float32)
    b = rng.standard_normal(6).astype(np.float32)
    state = rng.standard_normal((2, 3, 6)).astype(np.float32)
    got = M.causal_conv(*_t(x, w, b))
    _close(got, JM.causal_conv(x, w, b), dict(rtol=1e-6, atol=1e-6))
    out, new = M.conv_step(*_t(x[:, 0], state, w, b))
    jout, jnew = JM.conv_step(x[:, 0], state, w, b)
    _close(out, jout, dict(rtol=1e-6, atol=1e-6))
    np.testing.assert_array_equal(new.numpy(), np.asarray(jnew))


@pytest.mark.parametrize("with_bias", [False, True])
def test_layer_norm_and_apply_norm_match_jax(with_bias):
    jax, JM = _jax()
    import jax.numpy as jnp
    from repro.models import layers as JL

    kind = "layernorm" if with_bias else "rmsnorm"
    jn = JL.init_norm(16, jnp.float32, with_bias=with_bias)
    tn = TL.init_norm(16, torch.float32, with_bias=with_bias)
    assert sorted(tn) == sorted(jn)
    rng = np.random.default_rng(8)
    jn = {k: np.asarray(v) + 0.1 * rng.standard_normal(16).astype(np.float32)
          for k, v in jn.items()}
    x = (3.0 + rng.standard_normal((3, 5, 16))).astype(np.float32)
    got = TL.apply_norm(torch.from_numpy(x), params_from_numpy(jn), kind)
    _close(got, JL.apply_norm(x, jn, kind), dict(rtol=1e-6, atol=1e-6))
    if with_bias:
        _close(TL.layer_norm(*_t(x, jn["weight"], jn["bias"])),
               JL.layer_norm(x, jn["weight"], jn["bias"]),
               dict(rtol=1e-6, atol=1e-6))
