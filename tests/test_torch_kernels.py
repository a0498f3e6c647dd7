"""The port's kernels against the JAX package and against their own plain
versions: the FedCET triad and pair, the dithered quantizer (one scale per
leaf, and one per arena row), the fused round tail, the gossip neighbor
reduce (its CPU tests against the JAX package are in
``tests/test_torch_gossip.py``), the telemetry client sketch (its CPU
tests in ``tests/test_torch_telemetry_dist.py``), flash attention (its
CPU tests in ``tests/test_torch_attention.py``) and the Mamba2 SSD
intra-chunk term (its CPU tests in ``tests/test_torch_mamba2.py``), and
the arena's packed threefry dither (its CPU tests in
``tests/test_torch_compressors.py``).

CPU tests: the port's ``ops``/``ref`` (plain versions on a CPU tensor)
against JAX's ``ref`` and JAX's ``ops`` with ``impl="kernel"`` (the Pallas
kernels in interpret mode), on the same numpy inputs. Tolerance: 1e-6 in
float32. In float64 the port equals JAX's ``ref`` exactly (both round each
product and difference once; the round tail's client sum runs in client
order in both); against the jitted Pallas kernel it holds within 4 ulps of
the largest operand, because XLA's CPU compiler contracts ``a*b - c`` into
one fused multiply-add inside the kernel's fusion (measured: at most 2
ulps of the operand scale). The quantizer's plain versions equal JAX's
``ref`` exactly in both dtypes.

Card tests (marker ``cuda``): each CUDA kernel against its plain version
on the card. The kernels are built with ``--fmad=false``, so they round
like the plain PyTorch expression and must agree bit for bit (the gossip
reduce on both of its routes, column-owning and node-owning); flash
attention sums its dot products on the tensor cores (3xTF32 in float32,
one bfloat16 pass) in another order than the plain version's einsums,
and is held to the reference kernel's own tolerance against naive
attention (``tests/test_kernels.py``) in float32, 2e-5; in bfloat16 to
rtol 2e-2, atol 5e-3 (tighter than the reference's 5e-2: one bfloat16
unit of the output, and a p rounded against another running max); and
to its own repeat bit for bit; the SSD kernel sums 3xTF32 tensor-core
products in float32 and rounds once as its plain version does, and is
held at the reference's
sweep shapes to 1e-4 in float32 and 1e-2 (a few bfloat16 ulps) in
bfloat16, elsewhere to 1e-4 of the output's scale (1e-2 in bfloat16),
and to its own repeat bit for bit; the packed dither is ``torch.equal``
to the eager per-leaf draws it replaces, at the granite-moe cell's whole
layout too, one launch a draw. These tests
import no JAX, so they also run where JAX is not installed
(``pytest --noconftest -m cuda``).
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import fedcet_update as K
from repro_torch.kernels import ops, ref

SHAPES = [(7,), (1025,), (3, 5, 17), (4, 256, 1024)]
DTYPES = ["float32", "float64"]
ALPHA, C = 0.0123, 0.31


def _jax():
    import jax

    jax.config.update("jax_enable_x64", True)
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref

    return jax, jops, jref


def _inputs(shape, dtype, n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(dtype) for _ in range(n)]


def _close(got, want, dtype, scale=None):
    """Exact in float64 unless ``scale`` (the largest operand magnitude of
    a jitted JAX computation) grants its FMA contraction 4 ulps."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    elif scale is None:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=4 * np.finfo(np.float64).eps * scale)


def _scale(*arrays):
    return max(float(np.abs(a).max()) for a in arrays)


# ------------------------------------------------------------------ CPU
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_fedcet_v_matches_jax(shape, dtype):
    jax, jops, jref = _jax()
    x, g, d = _inputs(shape, dtype, 3)
    got = ops.fedcet_v(*map(torch.from_numpy, (x, g, d)), ALPHA).numpy()
    jx = [jax.numpy.asarray(a) for a in (x, g, d)]
    _close(got, jref.fedcet_v(*jx, ALPHA), dtype)
    _close(got, jops.fedcet_v(*jx, ALPHA, impl="kernel"), dtype,
           scale=_scale(x, g, d))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("with_v", [False, True], ids=["3op", "4op"])
def test_fedcet_comm_matches_jax(shape, dtype, with_v):
    jax, jops, jref = _jax()
    d, m, v = _inputs(shape, dtype, 3, seed=1)
    m_bar = m.mean(axis=0, keepdims=True)  # the [1, ...] client mean
    tv = torch.from_numpy(v) if with_v else None
    got = ops.fedcet_comm(torch.from_numpy(d), torch.from_numpy(m),
                          torch.from_numpy(m_bar), C, ALPHA, v=tv)
    jnp = jax.numpy
    jv = jnp.asarray(v) if with_v else None
    want_ref = jref.fedcet_comm(jnp.asarray(d), jnp.asarray(m),
                                jnp.broadcast_to(jnp.asarray(m_bar), m.shape),
                                C, ALPHA, v=jv)
    want_kernel = jops.fedcet_comm(jnp.asarray(d), jnp.asarray(m),
                                   jnp.asarray(m_bar), C, ALPHA, v=jv,
                                   impl="kernel")
    for g_, r_, k_ in zip(got, want_ref, want_kernel):
        _close(g_.numpy(), r_, dtype)
        _close(g_.numpy(), k_, dtype, scale=_scale(d, m, v))


def _ring_mix(m, axis=0):
    """A per-client m_bar of m's shape, as a gossip round hands it over:
    each client's mean with its two ring neighbors."""
    return (m + np.roll(m, 1, axis) + np.roll(m, -1, axis)) / 3


@pytest.mark.parametrize("shape", [(8, 33), (7, 5, 17), (4, 256, 1024)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_fedcet_comm_per_client_m_bar_matches_jax(shape, dtype):
    """The one-client form (m_bar of m's shape, the gossip aggregate)
    against the reference's kernel, which broadcasts nothing then."""
    jax, jops, jref = _jax()
    d, m = _inputs(shape, dtype, 2, seed=4)
    m_bar = _ring_mix(m)
    got = ops.fedcet_comm(torch.from_numpy(d), torch.from_numpy(m),
                          torch.from_numpy(m_bar), C, ALPHA)
    jnp = jax.numpy
    want_ref = jref.fedcet_comm(jnp.asarray(d), jnp.asarray(m),
                                jnp.asarray(m_bar), C, ALPHA)
    want_kernel = jops.fedcet_comm(jnp.asarray(d), jnp.asarray(m),
                                   jnp.asarray(m_bar), C, ALPHA,
                                   impl="kernel")
    for g_, r_, k_ in zip(got, want_ref, want_kernel):
        _close(g_.numpy(), r_, dtype)
        _close(g_.numpy(), k_, dtype, scale=_scale(d, m))


def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    x, g, d = map(torch.from_numpy, _inputs((5, 9), "float64", 3))
    K.reset_launches()
    out = ops.fedcet_v(x, g, d, ALPHA)
    assert torch.equal(out, ref.fedcet_v(x, g, d, ALPHA))
    out = ops.fedcet_comm(d, x, x.mean(0, keepdim=True), C, ALPHA)
    assert all(torch.equal(a, b) for a, b in
               zip(out, ref.fedcet_comm(d, x, x.mean(0, keepdim=True), C,
                                        ALPHA)))
    a, u = x.reshape(5, 9), g[0]
    assert torch.equal(ops.stochastic_quantize(a, u, a.abs().max() / 127, 8),
                       ref.stochastic_quantize(a, u, a.abs().max() / 127, 8))
    sketch = ops.telemetry_sketch(a, bins=8, lo=-2.0, hi=2.0, k=2)
    assert torch.equal(sketch[1], ref.client_sketch(a, bins=8, lo=-2.0,
                                                    hi=2.0)[1])
    q = x.float().reshape(1, 5, 3, 3)
    kv = q[:, :, :1].contiguous()
    assert torch.equal(ops.flash_attention(q, kv, kv),
                       ref.flash_attention(q, kv, kv))
    xs = x.float().reshape(1, 1, 5, 1, 9)
    ssd = (xs, xs[..., 0].abs(), -xs[..., 0].abs().cumsum(2), xs[:, :, :, 0],
           xs[:, :, :, 0])
    assert torch.equal(ops.ssd_intra(*ssd), ref.ssd_intra(*ssd))
    from repro_torch.core import prng
    from repro_torch.core.arena import ArenaLayout

    layout = ArenaLayout.for_tree({"w": x, "b": g[0]})
    args = (prng.key(4), layout.leaf_table(), layout.row_segments(), 2)
    assert torch.equal(ops.arena_uniform(*args, dtype=x.dtype),
                       ref.arena_uniform(*args, x.dtype))
    assert set(K.LAUNCHES) == {"fedcet_v", "fedcet_comm", "fedcet_comm4",
                               "stochastic_quantize",
                               "stochastic_quantize_rows",
                               "fedcet_round_tail", "gossip_reduce",
                               "telemetry_sketch", "flash_attention",
                               "ssd_intra", "threefry_uniform_rows"}
    assert not any(K.LAUNCHES.values())
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.fedcet_v(x, g, d, ALPHA, impl="kernel")
    with pytest.raises(ValueError, match="unknown impl"):
        ops.fedcet_v(x, g, d, ALPHA, impl="pallas")


def _tail_inputs(clients, rows, dtype, lanes=1024, seed=0, zero_row=True):
    """Round-tail operands: v, h, d [C, rows, lanes], a shared dither, one
    scale per row (one of them zero), 0/1 weights (some zero) and den."""
    rng = np.random.default_rng(seed)
    v, h, d = (rng.standard_normal((clients, rows, lanes)).astype(dtype)
               for _ in range(3))
    u = rng.random((rows, lanes)).astype(dtype)
    scale = (np.abs(v - h).max(axis=(0, 2))[:, None] / 127).astype(dtype)
    if zero_row:
        scale[rows // 2, 0] = 0.0
    w = (rng.random((clients, 1)) < 0.7).astype(dtype)
    den = np.maximum(w.sum(), 1).astype(dtype).reshape(1, 1)
    return v, h, d, u, scale, w, den


TAIL = dict(c=0.3, alpha=0.02, beta=0.5, bits=8)


@pytest.mark.parametrize("clients", [1, 3, 4, 7])
@pytest.mark.parametrize("dtype", DTYPES)
def test_fedcet_round_tail_matches_jax(clients, dtype):
    jax, jops, jref = _jax()
    v, h, d, u, scale, w, den = _tail_inputs(clients, 5, dtype)
    got = ops.fedcet_round_tail(*map(torch.from_numpy,
                                     (v, h, d, u, scale, w, den)), **TAIL)
    want_ref = jref.fedcet_round_tail(v, h, d, u, scale, w[:, :, None],
                                      den[0, 0], **TAIL)
    want_kernel = jops.fedcet_round_tail(v, h, d, u, scale, w, den,
                                         impl="kernel", **TAIL)
    for g_, r_, k_ in zip(got, want_ref, want_kernel):
        np.testing.assert_array_equal(g_.numpy(), np.asarray(r_))
        _close(g_.numpy(), k_, dtype, scale=_scale(v, h, d))


@pytest.mark.parametrize("shape", [(4, 7), (3, 5, 517), (2, 1030)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_stochastic_quantize_matches_jax(shape, dtype):
    jax, jops, jref = _jax()
    rng = np.random.default_rng(2)
    a = rng.standard_normal(shape).astype(dtype)
    u = rng.random(shape[1:]).astype(dtype)  # the client-shared dither
    s = np.asarray(np.abs(a).max() / 127, dtype)
    got = ops.stochastic_quantize(torch.from_numpy(a), torch.from_numpy(u),
                                  torch.tensor(s), 8).numpy()
    ub = np.broadcast_to(u, a.shape)
    np.testing.assert_array_equal(got, np.asarray(jref.stochastic_quantize(
        a, ub, s, 8)))
    np.testing.assert_array_equal(got, np.asarray(jops.stochastic_quantize(
        a, ub, s, 8)))


@pytest.mark.parametrize("dtype", DTYPES)
def test_stochastic_quantize_rows_matches_jax(dtype):
    jax, jops, jref = _jax()
    rng = np.random.default_rng(3)
    a = rng.standard_normal((4, 9, 1024)).astype(dtype)
    u = rng.random((9, 1024)).astype(dtype)
    s = (np.abs(a).max(axis=(0, 2))[:, None] / 127).astype(dtype)
    s[4, 0] = 0.0
    got = ops.stochastic_quantize_rows(torch.from_numpy(a),
                                       torch.from_numpy(u),
                                       torch.from_numpy(s), 8).numpy()
    np.testing.assert_array_equal(got, np.asarray(jref.stochastic_quantize(
        a, u, s, 8)))
    tiled = jops.stochastic_quantize_rows(
        a.reshape(36, 1024), np.broadcast_to(u, a.shape).reshape(36, 1024),
        np.broadcast_to(s, (4, 9, 1)).reshape(36, 1), 8)
    np.testing.assert_array_equal(got, np.asarray(tiled).reshape(a.shape))


# ----------------------------------------------------------------- card
CARD_SHAPES = [(7,), (100_003,), (3, 5, 17), (4, 256, 1024), (10, 60)]


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA is not available)")


def _card_inputs(shape, dtype, n, seed=0):
    return [torch.from_numpy(a).cuda() for a in _inputs(shape, dtype, n, seed)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CARD_SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_fedcet_v_equals_plain(shape, dtype):
    _need_cuda()
    x, g, d = _card_inputs(shape, dtype, 3)
    before = K.LAUNCHES["fedcet_v"]
    got = ops.fedcet_v(x, g, d, ALPHA)
    torch.cuda.synchronize()
    assert K.LAUNCHES["fedcet_v"] == before + 1
    assert torch.equal(got, ref.fedcet_v(x, g, d, ALPHA))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CARD_SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("with_v", [False, True], ids=["3op", "4op"])
def test_cuda_fedcet_comm_equals_plain(shape, dtype, with_v):
    _need_cuda()
    d, m, v = _card_inputs(shape, dtype, 3, seed=1)
    m_bar = m.mean(0, keepdim=True)
    v = v if with_v else None
    form = "fedcet_comm" if v is None else "fedcet_comm4"
    before = dict(K.LAUNCHES)
    got = ops.fedcet_comm(d, m, m_bar, C, ALPHA, v=v)
    torch.cuda.synchronize()
    assert K.LAUNCHES == {**before, form: before[form] + 1}
    for a, b in zip(got, ref.fedcet_comm(d, m, m_bar, C, ALPHA, v=v)):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 4096), (7, 100_003), (10, 60),
                                   (8, 13, 1024)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_fedcet_comm_one_client_form_equals_plain(shape, dtype):
    """m_bar of m's shape (the gossip aggregate): the wrapper reads the
    stack as one client, counted as ``fedcet_comm``; (7, 100_003) takes
    the scalar path, the others the vector path."""
    _need_cuda()
    d, m = _card_inputs(shape, dtype, 2, seed=5)
    m_bar = torch.from_numpy(_ring_mix(m.cpu().numpy())).cuda()
    before = dict(K.LAUNCHES)
    got = ops.fedcet_comm(d, m, m_bar, C, ALPHA)
    torch.cuda.synchronize()
    assert K.LAUNCHES == {**before, "fedcet_comm": before["fedcet_comm"] + 1}
    for a, b in zip(got, ref.fedcet_comm(d, m, m_bar, C, ALPHA)):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_unaligned_operands_take_the_scalar_path(dtype):
    _need_cuda()
    x, g, d = (a.reshape(-1)[1:] for a in _card_inputs((4, 1024), dtype, 3))
    assert x.data_ptr() % 16 != 0 and x.is_contiguous()
    assert torch.equal(ops.fedcet_v(x, g, d, ALPHA),
                       ref.fedcet_v(x, g, d, ALPHA))
    m, dd = x.reshape(3, 1365), d.reshape(3, 1365)
    mb = m.mean(0, keepdim=True)
    for a, b in zip(ops.fedcet_comm(dd, m, mb, C, ALPHA),
                    ref.fedcet_comm(dd, m, mb, C, ALPHA)):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_wrappers_reject_what_the_kernels_do_not_take():
    _need_cuda()
    x, g, d = _card_inputs((8, 16), "float32", 3)
    with pytest.raises(ValueError, match="contiguous"):
        ops.fedcet_v(x.t(), g.t(), d.t(), ALPHA)
    with pytest.raises(TypeError, match="float32 or float64"):
        ops.fedcet_v(x.half(), g.half(), d.half(), ALPHA)
    with pytest.raises(ValueError, match="device or dtype"):
        ops.fedcet_v(x, g.double(), d, ALPHA)
    with pytest.raises(ValueError, match="m_bar"):
        ops.fedcet_comm(d, x, x[:, :1].contiguous(), C, ALPHA)


def _card(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)).cuda() for a in arrays]


@pytest.mark.cuda
@pytest.mark.parametrize("clients", [1, 3, 4, 7])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("lanes,rows", [(1024, 6), (1030, 3), (7, 5)],
                         ids=["arena", "ragged", "narrow"])
def test_cuda_round_tail_equals_plain(clients, dtype, lanes, rows):
    """Tolerance 0, with zero weights (absent clients), a zero-scale row
    and lane counts that defeat the vector path."""
    _need_cuda()
    args = _card(*_tail_inputs(clients, rows, dtype, lanes, seed=clients))
    before = K.LAUNCHES["fedcet_round_tail"]
    got = ops.fedcet_round_tail(*args, **TAIL)
    torch.cuda.synchronize()
    assert K.LAUNCHES["fedcet_round_tail"] == before + 1
    for a, b in zip(got, ref.fedcet_round_tail(*args, **TAIL)):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_round_tail_keeps_zero_pads_zero(dtype):
    _need_cuda()
    v, h, d, u, scale, w, den = _card(*_tail_inputs(4, 3, dtype))
    for t in (v, h, d, u):
        t[..., 1000:] = 0.0
    d2, x2, h2 = ops.fedcet_round_tail(v, h, d, u, scale, w, den, **TAIL)
    for t in (d2, x2, h2):
        assert not bool(t[..., 1000:].any())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(4, 14, 64, 256), (3, 100_003), (7, 5),
                                   (1, 33)])
@pytest.mark.parametrize("per_client", [False, True], ids=["shared", "pq"])
def test_cuda_stochastic_quantize_equals_plain(dtype, shape, per_client):
    _need_cuda()
    rng = np.random.default_rng(5)
    a = rng.standard_normal(shape).astype(dtype)
    u = rng.random(shape if per_client else shape[1:]).astype(dtype)
    a, u = _card(a, u)
    for s in (a.abs().max() / 127, torch.zeros((), dtype=a.dtype,
                                               device="cuda")):
        before = K.LAUNCHES["stochastic_quantize"]
        got = ops.stochastic_quantize(a, u, s, 8)
        torch.cuda.synchronize()
        assert K.LAUNCHES["stochastic_quantize"] == before + 1
        assert torch.equal(got, ref.stochastic_quantize(a, u, s, 8))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("clients,lanes", [(4, 1024), (3, 1030), (1, 7)])
def test_cuda_stochastic_quantize_rows_equals_plain(dtype, clients, lanes):
    _need_cuda()
    rng = np.random.default_rng(6)
    a = rng.standard_normal((clients, 9, lanes)).astype(dtype)
    u = rng.random((9, lanes)).astype(dtype)
    s = (np.abs(a).max(axis=(0, 2)) / 127).astype(dtype)
    s[4] = 0.0
    a, u, s = _card(a, u, s)
    before = K.LAUNCHES["stochastic_quantize_rows"]
    got = ops.stochastic_quantize_rows(a, u, s, 8)
    torch.cuda.synchronize()
    assert K.LAUNCHES["stochastic_quantize_rows"] == before + 1
    assert torch.equal(got, ref.stochastic_quantize_rows(a, u, s, 8))
    assert torch.equal(ops.stochastic_quantize_rows(a, u.expand_as(a)
                                                    .contiguous(), s, 8), got)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_new_kernels_take_unaligned_operands(dtype):
    _need_cuda()
    v, h, d, u, scale, w, den = _tail_inputs(3, 2, dtype, lanes=1024)
    off = [torch.from_numpy(np.concatenate([[0.0], t.reshape(-1)])
                            .astype(dtype)).cuda()[1:] for t in (v, h, d, u)]
    vv, hh, dd = (t.reshape(3, 2, 1024) for t in off[:3])
    uu = off[3].reshape(2, 1024)
    assert vv.data_ptr() % 16 != 0 and vv.is_contiguous()
    rest = _card(scale, w, den)
    for a, b in zip(ops.fedcet_round_tail(vv, hh, dd, uu, *rest, **TAIL),
                    ref.fedcet_round_tail(vv, hh, dd, uu, *rest, **TAIL)):
        assert torch.equal(a, b)
    s = vv.abs().max() / 127
    assert torch.equal(ops.stochastic_quantize(vv, uu, s, 8),
                       ref.stochastic_quantize(vv, uu, s, 8))
    assert torch.equal(ops.stochastic_quantize_rows(vv, uu, rest[0], 8),
                       ref.stochastic_quantize_rows(vv, uu, rest[0], 8))


@pytest.mark.cuda
def test_cuda_new_wrappers_reject_what_the_kernels_do_not_take():
    _need_cuda()
    v, h, d, u, scale, w, den = _card(*_tail_inputs(3, 2, "float32"))
    with pytest.raises(ValueError, match="u must be"):
        ops.fedcet_round_tail(v, h, d, u[:1], scale, w, den, **TAIL)
    with pytest.raises(ValueError, match="scale needs"):
        ops.fedcet_round_tail(v, h, d, u, scale[:1], w, den, **TAIL)
    with pytest.raises(ValueError, match="one scale"):
        ops.stochastic_quantize(v, u, scale, 8)
    with pytest.raises(ValueError, match="u must be"):
        ops.stochastic_quantize(v, u[:1], scale[0], 8)


def _gossip_inputs(n, slots, dim, dtype, rows=None, seed=0):
    """src [rows or n, dim], a padded table (slot 0 the node itself, the
    last slot a zero-weight self pad on even nodes) and its denominators,
    on the card."""
    rng = np.random.default_rng(seed)
    rows = n if rows is None else rows
    idx = rng.integers(0, rows, size=(n, slots)).astype(np.int64)
    idx[:, 0] = np.arange(n) % rows
    wgt = rng.random((n, slots)).astype(dtype)
    if slots > 1:
        pad = np.arange(n) % 2 == 0
        idx[pad, -1] = idx[pad, 0]
        wgt[pad, -1] = 0.0
    denom = wgt.sum(axis=1).astype(dtype)
    src = rng.standard_normal((rows, dim)).astype(dtype)
    return _card(src, idx, wgt, denom)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,slots,dim", [(1, 1, 7), (8, 3, 4096),
                                         (10, 5, 100_003), (8, 8, 1030),
                                         (3, 7, 33), (1024, 3, 4096)])
def test_cuda_gossip_reduce_equals_plain(dtype, n, slots, dim):
    """Tolerance 0, with and without the division, with zero-weight pad
    slots, ragged widths (no vector path) and n = 1 / 1024."""
    _need_cuda()
    src, idx, wgt, denom = _gossip_inputs(n, slots, dim, dtype, seed=n)
    for den in (denom, None):
        before = K.LAUNCHES["gossip_reduce"]
        got = ops.gossip_reduce(src, idx, wgt, den)
        torch.cuda.synchronize()
        assert K.LAUNCHES["gossip_reduce"] == before + 1
        assert torch.equal(got, ref.gossip_reduce(src, idx, wgt, den))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("slots", [64, 5000], ids=["shared", "global"])
def test_cuda_gossip_reduce_wide_tables(dtype, slots):
    """S = n (a resampled graph's table) and a table too wide for shared
    memory, whose indices and weights are read from device memory."""
    _need_cuda()
    src, idx, wgt, denom = _gossip_inputs(64, slots, 520, dtype,
                                          rows=slots, seed=slots)
    got = ops.gossip_reduce(src, idx, wgt, denom)
    torch.cuda.synchronize()
    assert torch.equal(got, ref.gossip_reduce(src, idx, wgt, denom))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("vec", [True, False], ids=["vec", "scalar"])
@pytest.mark.parametrize("extra", [0, 1], ids=["at_limit", "one_past"])
def test_cuda_gossip_reduce_on_each_side_of_the_route_boundary(dtype, vec,
                                                               extra):
    """The most source rows whose column tile fits in shared memory (the
    column-owning route) and one row more (the node-owning route), both at
    tolerance 0; D ragged where the scalar path is asked for."""
    _need_cuda()
    from repro_torch.kernels import gossip_reduce as KG
    from repro_torch.kernels import library as L

    n, slots = 8, 3
    size = np.dtype(dtype).itemsize
    rows = L.library().gossip_reduce_column_rows(n, slots, size,
                                                 int(vec)) + extra
    dim = 2048 if vec else 2051
    src, idx, wgt, denom = _gossip_inputs(n, slots, dim, dtype, rows=rows,
                                          seed=rows)
    idx[:, 1] = rows - 1  # the last row is read
    assert KG.route(src, idx) == ("column" if extra == 0 else "node")
    for den in (denom, None):
        got = ops.gossip_reduce(src, idx, wgt, den)
        torch.cuda.synchronize()
        assert torch.equal(got, ref.gossip_reduce(src, idx, wgt, den))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_gossip_reduce_identity_form_and_unaligned(dtype):
    _need_cuda()
    rng = np.random.default_rng(7)
    contrib = _card(rng.standard_normal((8 * 3, 1024)).astype(dtype))[0]
    got = ops.gossip_reduce(contrib, slots=3)
    assert torch.equal(got, ref.segment_reduce(contrib, 3))
    flat = torch.from_numpy(np.concatenate(
        [[0.0], rng.standard_normal(8 * 1024)]).astype(dtype)).cuda()[1:]
    src = flat.reshape(8, 1024)
    assert src.data_ptr() % 16 != 0 and src.is_contiguous()
    _, idx, wgt, denom = _gossip_inputs(8, 3, 1024, dtype)
    assert torch.equal(ops.gossip_reduce(src, idx, wgt, denom),
                       ref.gossip_reduce(src, idx, wgt, denom))


@pytest.mark.cuda
def test_cuda_gossip_wrapper_rejects_what_the_kernel_does_not_take():
    _need_cuda()
    src, idx, wgt, denom = _gossip_inputs(4, 3, 16, "float32")
    with pytest.raises(ValueError, match="int64"):
        ops.gossip_reduce(src, idx.int(), wgt, denom)
    with pytest.raises(ValueError, match="int64"):
        ops.gossip_reduce(src, idx.cpu(), wgt, denom)
    with pytest.raises(ValueError, match="one \\[n, S\\] shape"):
        ops.gossip_reduce(src, idx, wgt[:, :2].contiguous(), denom)
    with pytest.raises(ValueError, match="denom"):
        ops.gossip_reduce(src, idx, wgt, denom[:2])
    with pytest.raises(ValueError, match="device or dtype"):
        ops.gossip_reduce(src, idx, wgt.double(), denom)


@pytest.mark.cuda
@pytest.mark.parametrize("spec", ["ring:sparse", "er:0.5:t:sparse"])
def test_cuda_sparse_mixing_matches_the_cpu(spec):
    """The sparse lowering on the card (the kernel) against the same
    reduce on the CPU (its plain version), with a masked client."""
    _need_cuda()
    from repro_torch.core.topology import TopoState, parse_topology

    topo = parse_topology(spec, 8)
    rng = np.random.default_rng(3)
    tree = {"a": torch.from_numpy(rng.standard_normal((8, 5, 7))),
            "b": torch.from_numpy(rng.standard_normal((8,)))}
    w = torch.ones(8, dtype=torch.float64)
    w[2] = 0.0
    ts = TopoState(k=3)
    want = topo.reduce(tree, w, ts)
    before = K.LAUNCHES["gossip_reduce"]
    got = topo.reduce({k: v.cuda() for k, v in tree.items()}, w.cuda(), ts)
    assert K.LAUNCHES["gossip_reduce"] == before + 2
    for k in tree:
        np.testing.assert_allclose(got[k].cpu().numpy(), want[k].numpy(),
                                   rtol=0, atol=1e-12)


def _sketch_store(n, d, dtype, seed=0, zero_rows=()):
    """[n, d] rows spanning 1e-15 .. 1e6 in norm (both clipped edge bins),
    some rows all zero, on the card."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)) * np.logspace(-17, 4, n)[:, None]
    x[list(zero_rows)] = 0.0
    return _card(x.astype(dtype))[0]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,d", [(8, 4 * 1024 * 1024), (8, 100_003),
                                 (1, 1024), (13, 3 * 1024), (1024, 2048),
                                 (3, 5)])
def test_cuda_telemetry_sketch_equals_plain(dtype, n, d):
    """Norms, histogram and top ids at tolerance 0 against the plain
    version (the same fixed sum order), with zero rows and norms past both
    edges of the bin range; two runs agree bit for bit."""
    _need_cuda()
    x = _sketch_store(n, d, dtype, seed=n, zero_rows=(0,) if n > 1 else ())
    kw = dict(bins=48, lo=-12.0, hi=4.0, k=4)
    before = K.LAUNCHES["telemetry_sketch"]
    got = ops.telemetry_sketch(x, **kw)
    again = ops.telemetry_sketch(x, **kw)
    torch.cuda.synchronize()
    assert K.LAUNCHES["telemetry_sketch"] == before + 2
    want = ops.telemetry_sketch(x, impl="ref", **kw)
    for g, a, w in zip(got, again, want):
        assert torch.equal(g, w) and torch.equal(a, w)
    assert int(got[1].sum()) == n


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_telemetry_sketch_unaligned_and_rejects(dtype):
    _need_cuda()
    rng = np.random.default_rng(5)
    flat = torch.from_numpy(rng.standard_normal(8 * 4096 + 1).astype(
        dtype)).cuda()[1:]
    x = flat.reshape(8, 4096)
    assert x.data_ptr() % 16 != 0
    kw = dict(bins=16, lo=-3.0, hi=3.0, k=3)
    for g, w in zip(ops.telemetry_sketch(x, **kw),
                    ops.telemetry_sketch(x, impl="ref", **kw)):
        assert torch.equal(g, w)
    with pytest.raises(ValueError, match="hi > lo"):
        ops.telemetry_sketch(x, bins=16, lo=1.0, hi=1.0, k=3)
    with pytest.raises(TypeError, match="float32 or float64"):
        ops.telemetry_sketch(x.half(), **kw)


#: (B, S, T, Hkv, G, D, kind, window, chunk): tiles that do not divide S,
#: T != S, every mask kind, G in {1, 2, 3, 8}, every built head dim and a
#: sliding window (5) smaller than one kv tile.
FLASH_CASES = [
    (1, 1000, 1000, 2, 2, 64, "causal", 0, 0),
    (1, 2047, 2047, 1, 1, 128, "sliding", 5, 0),
    (2, 300, 300, 1, 8, 32, "chunked", 0, 7),
    (1, 513, 513, 2, 2, 256, "chunked", 0, 64),
    (2, 200, 333, 2, 2, 16, "bidirectional", 0, 0),
    (1, 200, 333, 3, 2, 64, "causal", 0, 0),
    (1, 333, 200, 1, 8, 128, "causal", 0, 0),
    (2, 129, 129, 5, 2, 64, "sliding", 40, 0),
    # T < S: rows with no allowed key (a chunk starting at or after T, a
    # sliding row with qpos - window >= T - 1), two kv tiles of the
    # reference in the first
    (1, 520, 300, 2, 2, 64, "chunked", 0, 64),
    (2, 200, 100, 1, 8, 32, "sliding", 16, 0),
    # S and T off the 16-row warp tiles and the 32- / 64-key kv tiles; G = 3
    # puts one query's heads on two warps, G = 8 fills half a warp
    (1, 17, 17, 2, 8, 64, "causal", 0, 0),
    (2, 63, 63, 2, 3, 128, "causal", 0, 0),
    (1, 63, 17, 1, 8, 256, "bidirectional", 0, 0),
    (2, 17, 63, 3, 3, 16, "sliding", 9, 0),
    (1, 63, 63, 1, 8, 32, "chunked", 0, 5),
    (1, 63, 17, 2, 3, 64, "sliding", 4, 0),
]


def _flash_inputs(B, S, T, Hkv, G, D, dtype, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, Hkv * G, D))
    k, v = (rng.standard_normal((B, T, Hkv, D)) for _ in range(2))
    return [torch.from_numpy(a.astype(np.float32)).to(dtype).cuda()
            for a in (q, k, v)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", FLASH_CASES)
def test_cuda_flash_attention_matches_plain(case):
    _need_cuda()
    from repro_torch.kernels import library as L

    B, S, T, Hkv, G, D, kind, window, chunk = case
    q, k, v = _flash_inputs(B, S, T, Hkv, G, D, torch.float32)
    kw = dict(kind=kind, window=window, chunk=chunk)
    before = L.LAUNCHES["flash_attention"]
    got = ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert L.LAUNCHES["flash_attention"] == before + 1
    want = ops.flash_attention(q, k, v, impl="ref", **kw)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["causal", "sliding"])
def test_cuda_flash_attention_bf16(kind):
    _need_cuda()
    q, k, v = _flash_inputs(2, 257, 257, 5, 2, 64, torch.bfloat16, seed=1)
    kw = dict(kind=kind, window=100)
    got = ops.flash_attention(q, k, v, **kw)
    want = ops.flash_attention(q, k, v, impl="ref", **kw)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=2e-2,
                               atol=5e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [16, 32, 64, 128, 256])
def test_cuda_flash_attention_bf16_at_every_head_dim(D):
    """One bfloat16 tensor-core pass (m16n8k16) at every built head dim,
    S and T off the tiles, G = 3 across warps, every mask kind in turn."""
    _need_cuda()
    kind = ["causal", "sliding", "chunked", "bidirectional", "causal"][
        [16, 32, 64, 128, 256].index(D)]
    q, k, v = _flash_inputs(2, 77, 77, 2, 3, D, torch.bfloat16, seed=D)
    kw = dict(kind=kind, window=20, chunk=24)
    got = ops.flash_attention(q, k, v, **kw)
    want = ops.flash_attention(q, k, v, impl="ref", **kw)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=2e-2,
                               atol=5e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("case,dtype", [
    (FLASH_CASES[0], torch.float32), (FLASH_CASES[1], torch.float32),
    (FLASH_CASES[8], torch.float32), (FLASH_CASES[11], torch.float32),
    (FLASH_CASES[0], torch.bfloat16), (FLASH_CASES[3], torch.bfloat16)])
def test_cuda_flash_attention_repeats_bit_for_bit(case, dtype):
    """Two launches on the same inputs give the same bits: each row's sums
    run in a fixed order, without atomics, and no warp reads a K/V buffer
    that the cp.async ring is still filling."""
    _need_cuda()
    from repro_torch.kernels import library as L

    B, S, T, Hkv, G, D, kind, window, chunk = case
    q, k, v = _flash_inputs(B, S, T, Hkv, G, D, dtype, seed=2)
    kw = dict(kind=kind, window=window, chunk=chunk)
    before = L.LAUNCHES["flash_attention"]
    first = ops.flash_attention(q, k, v, **kw)
    again = ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert L.LAUNCHES["flash_attention"] == before + 2
    assert torch.equal(first, again)


@pytest.mark.cuda
def test_cuda_flash_attention_rejects_what_the_kernel_does_not_take():
    _need_cuda()
    q, k, v = _flash_inputs(1, 16, 16, 2, 2, 64, torch.float32)
    with pytest.raises(ValueError, match="supports"):
        ops.flash_attention(q[..., :48].contiguous(), k[..., :48].contiguous(),
                            v[..., :48].contiguous())
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ops.flash_attention(q.double(), k.double(), v.double())
    with pytest.raises(ValueError, match="contiguous"):
        ops.flash_attention(q.transpose(1, 2), k, v)
    with pytest.raises(ValueError, match="multiple of Hkv"):
        ops.flash_attention(q[:, :, :3].contiguous(), k, v)
    with pytest.raises(ValueError, match="window"):
        ops.flash_attention(q, k, v, kind="sliding")


#: (B, Nc, Lc, H, P, N): the reference's sweep shapes
#: (``tests/test_kernels.py``).
SSD_SWEEP = [(1, 1, 8, 1, 4, 4), (2, 3, 16, 2, 8, 8), (1, 2, 128, 3, 64, 32)]
#: label -> (shape, decay, dtype): mamba2-130m's prefill at batch 4 and
#: 2048 tokens, in float32 and bfloat16; a ragged chunk with P and N off
#: the 16-wide tiles; Lc, P and N all off the tensor-core tiles (16 rows,
#: 8 columns, 8 deep); a_cs falling to ~-1e3 over a chunk; P = 128 (the
#: widest); 7 heads in two uneven groups (100 chunks on the card's SMs).
SSD_CASES = {
    "main": ((4, 16, 128, 24, 64, 128), 1.0, torch.float32),
    "main_bf16": ((4, 16, 128, 24, 64, 128), 1.0, torch.bfloat16),
    "ragged_37": ((2, 3, 37, 5, 24, 40), 1.0, torch.float32),
    "off_tiles": ((2, 3, 45, 3, 20, 12), 1.0, torch.float32),
    "decay_1e3": ((1, 2, 128, 2, 16, 16), 11.0, torch.float32),
    "p_128": ((1, 2, 128, 3, 128, 64), 1.0, torch.float32),
    "uneven_head_groups": ((4, 25, 16, 7, 8, 8), 1.0, torch.float32),
}
#: the gate of a case: its error as a share of the output's scale
SSD_SCALE_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}


def _ssd_inputs(shape, dtype, seed=0, decay=1.0):
    """x, dt, a_cs, Bm, Cm on the card, the reference sweep's
    distributions (a_cs the cumulative sum of -softplus(normal) * decay)."""
    B, Nc, Lc, H, P, N = shape
    g = torch.Generator().manual_seed(seed)
    sp = lambda t: torch.logaddexp(t, torch.zeros_like(t))  # noqa: E731
    x = torch.randn((B, Nc, Lc, H, P), generator=g)
    dt = sp(torch.randn((B, Nc, Lc, H), generator=g))
    a_cs = torch.cumsum(-sp(torch.randn((B, Nc, Lc, H), generator=g))
                        * decay, dim=2)
    bm, cm = (torch.randn((B, Nc, Lc, N), generator=g) for _ in range(2))
    return [t.to(dtype).cuda() for t in (x, dt, a_cs, bm, cm)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SSD_SWEEP)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_ssd_intra_matches_plain_at_the_reference_shapes(shape, dtype):
    _need_cuda()
    from repro_torch.kernels import library as L

    args = _ssd_inputs(shape, dtype, seed=3)
    before = L.LAUNCHES["ssd_intra"]
    got = ops.ssd_intra(*args)
    torch.cuda.synchronize()
    assert L.LAUNCHES["ssd_intra"] == before + 1
    want = ops.ssd_intra(*args, impl="ref")
    assert got.dtype == dtype and got.shape == want.shape
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(SSD_CASES))
def test_cuda_ssd_intra_matches_plain_within_its_scale(case):
    _need_cuda()
    shape, decay, dtype = SSD_CASES[case]
    args = _ssd_inputs(shape, dtype, seed=4, decay=decay)
    got = ops.ssd_intra(*args)
    want = ops.ssd_intra(*args, impl="ref")
    torch.cuda.synchronize()
    assert got.dtype == dtype and torch.isfinite(got).all()
    got, want = got.float(), want.float()
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= SSD_SCALE_TOL[dtype] * scale


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["main", "main_bf16", "off_tiles",
                                  "uneven_head_groups"])
def test_cuda_ssd_intra_repeats_bit_for_bit(case):
    """Two launches on the same inputs give the same bits: the block's sums
    run in a fixed order, and no warp reads a shared buffer that the
    cp.async pipeline is still filling."""
    _need_cuda()
    from repro_torch.kernels import library as L

    shape, decay, dtype = SSD_CASES[case]
    args = _ssd_inputs(shape, dtype, seed=6, decay=decay)
    before = L.LAUNCHES["ssd_intra"]
    first = ops.ssd_intra(*args)
    again = ops.ssd_intra(*args)
    torch.cuda.synchronize()
    assert L.LAUNCHES["ssd_intra"] == before + 2
    assert torch.equal(first, again)


@pytest.mark.cuda
def test_cuda_ssd_intra_refuses_autograd_and_what_it_does_not_take():
    _need_cuda()
    x, dt, a_cs, bm, cm = _ssd_inputs((1, 2, 16, 2, 8, 8), torch.float32)
    with pytest.raises(NotImplementedError, match="backward"):
        ops.ssd_intra(x.requires_grad_(True), dt, a_cs, bm, cm)
    x = x.detach()
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.ssd_intra(*(t.cpu() for t in (x, dt, a_cs, bm, cm)),
                      impl="kernel")
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ops.ssd_intra(*(t.double() for t in (x, dt, a_cs, bm, cm)))
    with pytest.raises(ValueError, match="contiguous"):
        ops.ssd_intra(x.transpose(3, 4), dt, a_cs, bm, cm)
    with pytest.raises(ValueError, match="disagree"):
        ops.ssd_intra(x, dt[:, :1].contiguous(), a_cs, bm, cm)
    big = _ssd_inputs((1, 1, 129, 1, 4, 4), torch.float32)
    with pytest.raises(ValueError, match="Lc <= 128"):
        ops.ssd_intra(*big)


# --------------------------------------------------------- the arena's dither
def _eager_arena_dither(key, layout, lead, per_client, device):
    """The arena's dither as the port drew it before the packed kernel: one
    eager ``prng.uniform`` per leaf under ``fold_in(key, i)``, ``i`` the
    leaf's reference index, then ``arena.pack_rows``."""
    from torch.utils import _pytree as pytree

    from repro_torch.core import prng
    from repro_torch.core.arena import pack_rows
    from repro_torch.core.comm import reference_leaf_index

    shapes = [((lead,) + s if per_client else s) for s in layout.shapes]
    index = reference_leaf_index(pytree.tree_unflatten([0] * len(shapes),
                                                        layout.treedef))
    u = [prng.uniform(prng.fold_in(key, index[i]), s, dtype=layout.dtype,
                      device=device) for i, s in enumerate(shapes)]
    return pack_rows(u, layout, lead=lead if per_client else None)


def _dither_layout(case, dtype):
    """An arena layout from meta tensors: ``small`` has leaves of 1, 1,023,
    1,024, 1,025 and 100,003 coordinates and a scalar, dicts in other than
    sorted key order; ``big`` a leaf of 2**24 + 5 coordinates between two
    small ones."""
    from repro_torch.core.arena import ArenaLayout

    def z(*shape):
        return torch.empty(shape, dtype=dtype, device="meta")

    tree = ({"z": z(100_003), "m": [z(1), z(1023)],
             "b": {"y": z(1024), "x": z(5, 205)}, "a": z()}
            if case == "small" else
            {"t": z(7), "big": z(2 ** 24 + 5), "a": z(3, 3)})
    return ArenaLayout.for_tree(tree)


def _granite_cell_layout():
    """The arena layout of the benchmark's granite-moe cell: 2 of 32
    layers, stacked, head tied to the embedding (276,959,232 float32
    coordinates), from meta tensors."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core.arena import ArenaLayout
    from repro_torch.models import build_model

    cfg = dataclasses.replace(get_config("granite-moe-3b-a800m"), n_layers=2,
                              tie_embeddings=True, scan_layers=True)
    params = build_model(cfg).init(torch.Generator().manual_seed(0),
                                   device="meta")
    return ArenaLayout.for_tree(params)


def _check_packed_dither(layout, per_client, key, lead=4):
    from repro_torch.core.compressors import StochasticQuant

    quant = StochasticQuant(8, per_client_dither=per_client)
    before = K.LAUNCHES["threefry_uniform_rows"]
    got = quant.arena_dither(key, layout, lead, "cuda")
    torch.cuda.synchronize()
    assert K.LAUNCHES["threefry_uniform_rows"] == before + 1
    want = _eager_arena_dither(key, layout, lead, per_client, "cuda")
    assert got.shape == want.shape and got.dtype == want.dtype
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("per_client", [False, True])
@pytest.mark.parametrize("case", ["small", "big"])
def test_cuda_arena_dither_equals_the_eager_draw(dtype, per_client, case):
    _need_cuda()
    from repro_torch.core import prng

    layout = _dither_layout(case, dtype)
    for key in (prng.key(3), prng.fold_in(prng.key(2 ** 40 + 3), 11)):
        _check_packed_dither(layout, per_client, key)


@pytest.mark.cuda
def test_cuda_arena_dither_at_the_granite_cell_layout():
    _need_cuda()
    from repro_torch.core import prng
    from repro_torch.core.engine import compression_key

    layout = _granite_cell_layout()
    assert layout.num_params == 276_959_232
    _check_packed_dither(layout, False, compression_key(2900000041, 0, 5,
                                                        False))
    _check_packed_dither(layout, False, prng.key(0))


@pytest.mark.cuda
def test_cuda_arena_uniform_rejects_what_the_kernel_does_not_take():
    _need_cuda()
    from repro_torch.core import prng

    layout = _dither_layout("small", torch.float32)
    table, seg = layout.leaf_table("cuda"), layout.row_segments("cuda")
    with pytest.raises(TypeError, match="float32 or float64"):
        ops.arena_uniform(prng.key(0), table, seg, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="contiguous int64"):
        ops.arena_uniform(prng.key(0), table.int(), seg, dtype=torch.float32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.arena_uniform(prng.key(0), table.cpu(), seg.cpu(),
                          dtype=torch.float32, impl="kernel")
