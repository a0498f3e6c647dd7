"""The port's threefry PRNG (``core/prng.py``) against ``jax.random`` on the
CPU, bit for bit: key data, ``fold_in`` (including the warm-up step -1 and
2**31 - 1), ``split``, ``uniform`` in float32 and float64, ``bernoulli``
in both dtypes, ``randint`` in int32 and int64, and ``categorical`` (the
Gumbel-max draw, float32 and float64 logits, and the sampled ``generate``
of the serving path, token for token), and ``permutation`` at sizes that
take 0, 1 and 2 sort rounds; ``normal`` (and its ``erfinv``, XLA's
polynomial) to a few ulps, with x64 on and off. The tests run with ``jax_enable_x64`` on
(``tests/conftest.py``), the reference's setting; one test turns it off
around the reference's calls (and restores it) and holds the port's
float32 / int32 draws (``x64=False``, the dtypes of ``run_training`` and
``FedTrainer``) to the reference's: participation masks, resampled
Erdős–Rényi graphs, ``RandK`` indices and ``geom:p`` arrival masks."""

import contextlib

import numpy as np
import pytest
import torch

from repro_torch.core import prng

SHAPES = [(), (7,), (3, 1030), (2, 513, 3)]


def _jax():
    import jax

    jax.config.update("jax_enable_x64", True)
    return jax


def _data(jax, k) -> tuple:
    return tuple(int(v) for v in np.asarray(jax.random.key_data(k)))


def _pair(seed=3, data=11):
    jax = _jax()
    import jax.numpy as jnp

    jk = jax.random.fold_in(jax.random.key(seed), jnp.asarray(data, jnp.int32))
    return jax, jk, prng.fold_in(prng.key(seed), data)


@pytest.mark.parametrize("seed", [0, 1, 5, 2 ** 31 - 1, 2 ** 40 + 3])
def test_key_and_split_match_jax(seed):
    jax = _jax()
    assert _data(jax, jax.random.key(seed)) == prng.key(seed)
    want = [_data(jax, k) for k in jax.random.split(jax.random.key(seed), 3)]
    assert prng.split(prng.key(seed), 3) == want
    assert prng.split(prng.key(seed)) == [
        _data(jax, k) for k in jax.random.split(jax.random.key(seed))]


@pytest.mark.parametrize("data", [0, 1, -1, 7, 2 ** 31 - 1, 0x7A11A5])
def test_fold_in_matches_jax(data):
    jax = _jax()
    import jax.numpy as jnp

    k = jax.random.key(5)
    want = _data(jax, jax.random.fold_in(k, jnp.asarray(data, jnp.int32)))
    assert prng.fold_in(prng.key(5), data) == want


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_uniform_matches_jax_bitwise(shape, dtype):
    jax, jk, pk = _pair()
    want = np.asarray(jax.random.uniform(jk, shape, dtype=dtype))
    got = prng.uniform(pk, shape, getattr(torch, dtype)).numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got.reshape(-1).view(np.uint8),
                          want.reshape(-1).view(np.uint8))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_bernoulli_matches_jax(shape, dtype):
    jax, jk, pk = _pair(seed=7, data=-1)
    import jax.numpy as jnp

    for p in (0.3, 0.8):
        want = np.asarray(jax.random.bernoulli(jk, jnp.asarray(p, dtype),
                                               shape))
        got = prng.bernoulli(pk, p, shape, getattr(torch, dtype)).numpy()
        assert np.array_equal(got, want)


def test_bernoulli_default_is_the_x64_python_float():
    jax, jk, pk = _pair()
    want = np.asarray(jax.random.bernoulli(jk, 0.8, (100,)))
    assert np.array_equal(prng.bernoulli(pk, 0.8, (100,)).numpy(), want)


@pytest.mark.parametrize("dtype", ["int32", "int64"])
@pytest.mark.parametrize("n", [1, 3, 10, 24])
def test_randint_matches_jax(dtype, n):
    jax, jk, pk = _pair()
    td = getattr(torch, dtype)
    assert int(prng.randint(pk, (), 0, n, td)) == int(
        jax.random.randint(jk, (), 0, n, dtype=dtype))
    want = np.asarray(jax.random.randint(jk, (50,), 2, n + 5, dtype=dtype))
    assert np.array_equal(prng.randint(pk, (50,), 2, n + 5, td).numpy(), want)


def test_uniform_runs_on_the_tensors_device_and_rejects_other_dtypes():
    u = prng.uniform(prng.key(0), (4, 5), torch.float64, device="cpu")
    assert u.device.type == "cpu" and bool(((u >= 0) & (u < 1)).all())
    with pytest.raises(TypeError, match="float32 or float64"):
        prng.uniform(prng.key(0), (3,), torch.float16)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("shape", [(5,), (3, 512), (2, 4, 100)])
def test_categorical_matches_jax(dtype, shape):
    jax, jk, pk = _pair(seed=11, data=2)
    logits = np.random.default_rng(0).standard_normal(shape).astype(dtype)
    want = np.asarray(jax.random.categorical(jk, logits))
    got = prng.categorical(pk, torch.from_numpy(logits))
    assert np.array_equal(got.numpy(), want)


def test_sampled_generate_draws_the_reference_tokens():
    """A reduced fedlm-100m ``generate(greedy=False)``: the reference's run
    (its weights from seed 0) against the port's loop on those weights;
    each step's token is a ``categorical`` draw under a split key."""
    jax = _jax()
    from repro.configs import get_config as jget
    from repro.launch import serve as jserve
    from repro.models import build_model as jbuild

    from repro_torch.configs import get_config
    from repro_torch.launch import input_specs, serve
    from repro_torch.models import build_model
    from repro_torch.models.convert import params_from_numpy

    want = jserve.generate("fedlm-100m", prompt_len=12, gen_len=8, batch=3,
                           greedy=False)
    jcfg = jget("fedlm-100m").reduced()
    cfg = get_config("fedlm-100m").reduced()
    params = params_from_numpy(jax.tree.map(
        np.asarray, jbuild(jcfg).init(jax.random.key(0))))
    got = serve.generate_tokens(
        build_model(cfg), params, input_specs.make_batch(cfg, 3, 12, key=1),
        gen_len=8, greedy=False)
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n", [1, 7, 24, 1000, 1625, 1626, 100000])
def test_permutation_matches_jax(n):
    jax, jk, pk = _pair(seed=4, data=n)
    want = np.asarray(jax.random.permutation(jk, n))
    assert np.array_equal(prng.permutation(pk, n).numpy(), want)


class _x64_off:
    """``jax_enable_x64`` off around the reference's calls, restored on
    exit (the test process runs with it on)."""

    def __enter__(self):
        jax = _jax()
        jax.config.update("jax_enable_x64", False)
        return jax

    def __exit__(self, *exc):
        _jax()


def test_x64_off_draws_match_the_reference_with_x64_off():
    """The draws of the float32 LM entry points: ``RoundEngine(x64=False)``
    participation masks, a resampled ``er:`` graph, ``RandK``'s kept
    indices and ``geom:p`` arrivals equal the reference's with x64 off.
    The same draws with ``x64=True`` differ somewhere (the float64
    uniform rounds otherwise), which is what the flag is for."""
    import dataclasses

    from repro_torch.core import FedCET
    from repro_torch.core.compressors import RandK
    from repro_torch.core.engine import with_participation
    from repro_torch.core.staleness import GeometricDelay, StalenessConfig
    from repro_torch.core.topology import Mixing, TopoState

    with _x64_off() as jax:
        from repro.core import StalenessConfig as JConfig
        from repro.core.compressors import RandK as JRandK
        from repro.core.engine import participation_mask as jmask
        from repro.core.staleness import GeometricDelay as JGeom
        from repro.core.topology import Mixing as JMixing
        from repro.core.topology import TopoState as JTopoState
        import jax.numpy as jnp

        masks = {(seed, step, rate): np.asarray(jmask(
            jax.random.fold_in(jax.random.key(seed),
                               jnp.asarray(step, jnp.int32)), 10, rate))
            for seed in (0, 3) for step in range(0, 40, 2)
            for rate in (0.05, 0.5, 0.75, 0.8)}
        graphs = {k: np.asarray(JMixing.erdos_renyi(
            12, 0.4, seed=5, resample=True)._matrix(
                JTopoState(k=jnp.asarray(k, jnp.int32)), 12, jnp.float32))
            for k in range(6)}
        leaf = np.linspace(1.0, 2.0, 1000, dtype=np.float32)[None]
        kept = {s: np.nonzero(np.asarray(JRandK(0.25).compress(
            jax.random.fold_in(jax.random.key(s), 9), jnp.asarray(leaf))))[1]
            for s in range(10)}
        jcfg = JConfig(JGeom(0.4), seed=5)
        fresh = {s: np.asarray(jcfg.fresh_mask(jnp.asarray(s), 2, 16))
                 for s in range(0, 40, 2)}

    differs = 0
    for (seed, step, rate), want in masks.items():
        algo = with_participation(FedCET(alpha=0.1, c=0.1, tau=2,
                                         n_clients=10), rate, seed=seed)
        like = torch.zeros(1)
        got = dataclasses.replace(algo, x64=False)._mask(step, like)
        assert np.array_equal(got.numpy(), want), (seed, step, rate)
        differs += not torch.equal(algo._mask(step, like), got)
    assert differs > 0
    er = Mixing.erdos_renyi(12, 0.4, seed=5, resample=True)
    off = ~np.eye(12, dtype=bool)
    for k, want in graphs.items():
        got = er._matrix(TopoState(k=k), 12, torch.float32, "cpu",
                         False).numpy()
        # the same graph and edge weights; the diagonal 1 - sum_j W_ij is
        # a float32 sum in another order.
        assert np.array_equal(got != 0, want != 0), k
        assert np.array_equal(got[off], want[off]), k
        np.testing.assert_allclose(np.diag(got), np.diag(want), rtol=0,
                                   atol=4 * np.finfo(np.float32).eps)
    for s, want in kept.items():
        key = prng.fold_in(prng.key(s, x64=False), 9)
        got = RandK(0.25).compress(key, torch.from_numpy(leaf))
        assert np.array_equal(np.nonzero(got.numpy())[1], want), s
    cfg = StalenessConfig(GeometricDelay(0.4), seed=5)
    for s, want in fresh.items():
        assert np.array_equal(cfg.fresh_mask(s, 2, 16, x64=False).numpy(),
                              want), s


#: ulps of |jax's draw| that ``prng.normal`` may differ by: the uniform
#: draw is bit for bit jax's, ``erfinv`` is XLA's polynomial, and torch's
#: ``log1p`` and the products' rounding may differ from XLA's (measured on
#: 1e6 draws: 3 float32 ulps at most, 30 float64 ulps near |x| 0.92).
NORMAL_ULPS = {torch.float32: 4, torch.float64: 32}


@pytest.mark.parametrize("x64", [True, False], ids=["x64", "x32"])
@pytest.mark.parametrize("shape", [(7,), (3, 1030), (200_000,)])
def test_normal_matches_jax_to_a_few_ulps(shape, x64):
    """``jax.random.normal`` with x64 on (float64 draws) and off (float32),
    against ``prng.normal`` from a key of the same ``x64``."""
    jax = _jax()
    with _x64_off() if not x64 else contextlib.nullcontext(jax) as jax:
        want = np.asarray(jax.random.normal(jax.random.key(7), shape))
    got = prng.normal(prng.key(7, x64=x64), shape)
    assert got.dtype == (torch.float64 if x64 else torch.float32)
    assert want.dtype == got.numpy().dtype
    ulps = np.spacing(np.abs(want)).astype(np.float64)
    err = np.abs(got.numpy().astype(np.float64) - want.astype(np.float64))
    assert (err <= NORMAL_ULPS[got.dtype] * ulps).all(), (err / ulps).max()
    assert np.isfinite(want).all()


def test_erfinv_is_xla_s_polynomial():
    """``prng.erfinv`` against ``jax.lax.erf_inv`` on a grid of (-1, 1)
    and at +-1 (+-inf), in both dtypes, to the same ulps."""
    jax = _jax()
    for dtype in (np.float32, np.float64):
        x = np.concatenate([np.linspace(-1, 1, 40001, dtype=dtype)[1:-1],
                            np.array([-1, 1, 0.9999999, -0.99999], dtype)])
        want = np.asarray(jax.lax.erf_inv(jax.numpy.asarray(x)))
        got = prng.erfinv(torch.from_numpy(x)).numpy()
        assert np.array_equal(np.isinf(got), np.isinf(want))
        ok = np.isfinite(want)
        ulps = np.spacing(np.abs(want[ok])).astype(np.float64)
        err = np.abs(got[ok].astype(np.float64) - want[ok])
        assert (err <= NORMAL_ULPS[torch.from_numpy(x).dtype] * ulps).all()
