"""The gossip neighbor reduce and the weighted client mean against the JAX
package, on the CPU (where ``ops`` takes the plain versions).

* ``ops.gossip_reduce(contrib, slots=S)`` (the reference's contract)
  against the reference's ``ref.segment_reduce`` and its Pallas kernel in
  interpret mode (``ops.gossip_reduce``), on ``tests/test_gossip_kernel.py``'s
  ``GRIDS``: float32 within 1e-6 (the reference's own bound), float64
  exact against ``ref.segment_reduce`` (both add the slots in order) and
  within 4 ulps of the largest sum against the jitted kernel;
* the gather form ``ops.gossip_reduce(src, idx, wgt, denom)``, which the
  sparse ``Mixing`` lowering calls, against the reference's kernel route
  (gather, weight, segment reduce, divide) on the same tables, and equal
  to the identity-table form;
* zero-weight pad slots contribute exactly 0;
* ``weighted_client_mean`` against the reference, with the zero-sum guard
  (all-zero weights give zeros; small positive sums are not clamped);
* ``Mixing(lowering="sparse")`` against the dense lowering and the plain
  slot loop (a mirror of
  ``test_gossip_kernel.py::test_mixing_use_kernel_path_matches_default``);
* a CPU tensor takes the plain version and counts no launch.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core.staleness import weighted_client_mean
from repro_torch.core.topology import Mixing
from repro_torch.kernels import library as L
from repro_torch.kernels import ops, ref

GRIDS = [(4, 3, 60), (8, 5, 128), (10, 3, 1025), (3, 7, 33), (1, 2, 4)]


def _jax():
    import jax

    jax.config.update("jax_enable_x64", True)
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref

    return jax, jops, jref


@pytest.mark.parametrize("n,slots,dim", GRIDS)
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_segment_reduce_matches_jax(n, slots, dim, dtype):
    jax, jops, jref = _jax()
    vals = (np.random.default_rng(n * slots + dim)
            .standard_normal((n * slots, dim)) * 3.0).astype(dtype)
    got = ops.gossip_reduce(torch.from_numpy(vals), slots=slots).numpy()
    assert got.shape == (n, dim) and got.dtype == vals.dtype
    np.testing.assert_array_equal(got, ref.segment_reduce(
        torch.from_numpy(vals), slots).numpy())
    want = np.asarray(jref.segment_reduce(jax.numpy.asarray(vals), slots))
    kern = np.asarray(jops.gossip_reduce(jax.numpy.asarray(vals),
                                         slots=slots))
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(got, kern, rtol=1e-6, atol=1e-6)
    else:
        np.testing.assert_array_equal(got, want)
        ulps = 4 * np.finfo(np.float64).eps * float(np.abs(want).max())
        np.testing.assert_allclose(got, kern, rtol=0, atol=ulps)


def _tables(n, slots, seed):
    """A padded neighbor table: slot 0 the node itself, random neighbors,
    the last slot a pad (self index, weight 0) on every other node."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, n, size=(n, slots)).astype(np.int64)
    idx[:, 0] = np.arange(n)
    wgt = rng.random((n, slots))
    if slots > 1:
        pad = np.arange(n) % 2 == 0
        idx[pad, -1] = np.arange(n)[pad]
        wgt[pad, -1] = 0.0
    denom = wgt.sum(axis=1)
    return idx, wgt, denom


@pytest.mark.parametrize("n,slots,dim", GRIDS)
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_gather_form_matches_jax_kernel_route(n, slots, dim, dtype):
    """The sparse lowering's kernel route in the reference gathers
    ``flat[idx] * wgt`` into a ``[n*S, D]`` tensor, segment-reduces it and
    divides; the port's gather form computes the same in one call."""
    jax, jops, _ = _jax()
    jnp = jax.numpy
    idx, wgt, denom = _tables(n, slots, seed=dim)
    wgt, denom = wgt.astype(dtype), denom.astype(dtype)
    src = np.random.default_rng(slots).standard_normal((n, dim)).astype(dtype)
    got = ops.gossip_reduce(*map(torch.from_numpy, (src, idx, wgt, denom)))
    contrib = (jnp.asarray(src)[idx.reshape(-1)]
               * jnp.asarray(wgt).reshape(-1, 1))
    want = np.asarray(jops.gossip_reduce(contrib, slots=slots)
                      / jnp.asarray(denom)[:, None])
    tol = 1e-6 if dtype == "float32" else 4 * np.finfo(np.float64).eps
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=tol * max(1.0, float(np.abs(want).max())))
    # the identity-table form is the same reduce over the gathered rows
    t_contrib = torch.from_numpy(np.array(contrib))
    np.testing.assert_array_equal(
        (ops.gossip_reduce(t_contrib, slots=slots)
         / torch.from_numpy(denom)[:, None]).numpy(), got.numpy())
    # no division when denom is None
    undivided = ops.gossip_reduce(*map(torch.from_numpy, (src, idx, wgt)))
    np.testing.assert_array_equal(
        (undivided / torch.from_numpy(denom)[:, None]).numpy(), got.numpy())


def test_zero_weight_pad_slots_are_exact():
    n, slots, dim = 6, 4, 96
    rng = np.random.default_rng(0)
    src = torch.from_numpy(rng.standard_normal((n, dim)))
    idx = torch.from_numpy(rng.integers(0, n, (n, slots)))
    wgt = torch.from_numpy(rng.random((n, slots)))
    wgt[:, 2:] = 0.0                        # 2 live slots per node
    got = ops.gossip_reduce(src, idx, wgt)
    live = wgt[:, 0:1] * src[idx[:, 0]] + wgt[:, 1:2] * src[idx[:, 1]]
    assert torch.equal(got, live)


WEIGHTS = [np.ones(5), np.array([0.0, 1, 1, 0, 1]),
           np.array([0.1, 0.2, 0.05, 0.1, 0.2]), np.zeros(5)]


@pytest.mark.parametrize("wi", range(len(WEIGHTS)))
def test_weighted_client_mean_matches_jax(wi):
    jax, _, _ = _jax()
    from repro.core.staleness import weighted_client_mean as jwcm

    rng = np.random.default_rng(wi)
    tree = {"a": rng.standard_normal((5, 3, 4)), "b": rng.standard_normal(5)}
    w = WEIGHTS[wi]
    got = weighted_client_mean({k: torch.from_numpy(v)
                                for k, v in tree.items()},
                               torch.from_numpy(w))
    want = jwcm({k: jax.numpy.asarray(v) for k, v in tree.items()},
                jax.numpy.asarray(w))
    for k in tree:
        assert got[k].shape == (1,) + tree[k].shape[1:]
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=1e-15)
    if not w.any():
        assert not any(bool(v.any()) for v in got.values())


def test_mixing_kernel_route_matches_default_and_dense():
    topo = Mixing.torus(12, shape=(3, 4))
    rng = np.random.default_rng(1)
    tree = {"v": torch.from_numpy(rng.standard_normal((12, 37))),
            "s": torch.from_numpy(rng.standard_normal(12))}
    w = torch.tensor([1.0, 1, 0, 1, 1, 1, 1, 0, 1, 1, 1, 1],
                     dtype=torch.float64)
    dense = topo.reduce(tree, w)
    kern = dataclasses.replace(topo, lowering="sparse").reduce(tree, w)
    idx, wgt = map(torch.from_numpy, topo._static_tables())
    wn = wgt * w[idx]
    for leaf in tree:
        np.testing.assert_allclose(kern[leaf].numpy(), dense[leaf].numpy(),
                                   rtol=1e-12, atol=1e-12)
        # on the CPU the kernel route is the plain slot loop of the same sum
        flat = tree[leaf].reshape(12, -1)
        unrolled = wn[:, 0:1] * flat[idx[:, 0]]
        for s in range(1, idx.shape[1]):
            unrolled = unrolled + wn[:, s:s + 1] * flat[idx[:, s]]
        unrolled = unrolled / wn.sum(1)[:, None]
        assert torch.equal(kern[leaf], unrolled.reshape(tree[leaf].shape))


def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    src = torch.randn(6, 8, dtype=torch.float64)
    idx, wgt, denom = map(torch.from_numpy, _tables(6, 3, seed=2))
    L.reset_launches()
    assert torch.equal(ops.gossip_reduce(src, idx, wgt, denom),
                       ref.gossip_reduce(src, idx, wgt, denom))
    assert L.LAUNCHES["gossip_reduce"] == 0
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.gossip_reduce(src, idx, wgt, denom, impl="kernel")
    with pytest.raises(ValueError, match="slots= alone"):
        ops.gossip_reduce(src, idx, wgt, slots=3)
    with pytest.raises(ValueError, match="whole number"):
        ops.gossip_reduce(src, slots=4)
    with pytest.raises(ValueError, match="idx and wgt"):
        ops.gossip_reduce(src, idx)
