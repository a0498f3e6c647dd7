"""The port's FedCET kernels against the JAX package and against their own
plain versions.

CPU tests: the port's ``ops``/``ref`` (plain versions on a CPU tensor)
against JAX's ``ref`` and JAX's ``ops`` with ``impl="kernel"`` (the Pallas
kernels in interpret mode), on the same numpy inputs. Tolerance: 1e-6 in
float32. In float64 the port equals JAX's ``ref`` exactly (both round each
product and difference once); against the jitted Pallas kernel it holds
within 4 ulps of the largest operand, because XLA's CPU compiler contracts
``a*b - c`` into one fused multiply-add inside the kernel's fusion
(measured: at most 1 ulp of the operand scale).

Card tests (marker ``cuda``): each CUDA kernel against its plain version
on the card. The kernels are built with ``--fmad=false``, so they round
like the plain PyTorch expression and must agree bit for bit. These tests
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


def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    x, g, d = map(torch.from_numpy, _inputs((5, 9), "float64", 3))
    K.reset_launches()
    out = ops.fedcet_v(x, g, d, ALPHA)
    assert torch.equal(out, ref.fedcet_v(x, g, d, ALPHA))
    out = ops.fedcet_comm(d, x, x.mean(0, keepdim=True), C, ALPHA)
    assert all(torch.equal(a, b) for a, b in
               zip(out, ref.fedcet_comm(d, x, x.mean(0, keepdim=True), C,
                                        ALPHA)))
    assert K.LAUNCHES == {"fedcet_v": 0, "fedcet_comm": 0}
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.fedcet_v(x, g, d, ALPHA, impl="kernel")
    with pytest.raises(ValueError, match="unknown impl"):
        ops.fedcet_v(x, g, d, ALPHA, impl="pallas")


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
    before = K.LAUNCHES["fedcet_comm"]
    got = ops.fedcet_comm(d, m, m_bar, C, ALPHA, v=v)
    torch.cuda.synchronize()
    assert K.LAUNCHES["fedcet_comm"] == before + 1
    for a, b in zip(got, ref.fedcet_comm(d, m, m_bar, C, ALPHA, v=v)):
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
