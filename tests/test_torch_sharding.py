"""Sharding hooks of the port's models on the CPU: the token-sharded MoE
dispatch against the JAX package's, the activation-sharding context, and
the two serving kernels as custom ops.

* The ``moe_shards`` dispatch (``models/moe.py``) against the reference's
  branch (``src/repro/models/moe.py:63-113``) with ``nb`` 2, ``ns`` 2 and
  spec ``None`` (no token-grid constraint; the reference's weight
  constraints under a one-device mesh) on reduced granite-moe: a
  drop-free capacity, and capacity factor 1.25 under a skewed router,
  which drops assignments in every cell. Outputs within 1e-6 of their
  scale (the expert matmuls sum in another order than XLA's einsums),
  the load-balance term within rtol 1e-6, and each cell's kept mask
  equal to the reference's dispatch (``moe.py:135-148``) exactly.
* ``shard_residual`` / ``shard_logits`` are the identity without a spec,
  and on plain tensors with one.
* ``torch.ops.repro_torch.flash_attention`` / ``ssd_intra``: their fake
  implementations give the plain versions' shapes and dtypes, the ops on
  CPU tensors equal the plain versions bit for bit, and on DTensors of a
  fake 2 x 2 world they run shard-local on batch- or head-sharded
  operands and raise on any other layout.
"""


import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.kernels import ref as R
from repro_torch.models import moe
from repro_torch.models.convert import params_from_numpy
from repro_torch.utils import sharding_ctx as SC

NB, NS, B, S = 2, 2, 4, 16


def _jax():
    import jax

    jax.config.update("jax_enable_x64", True)
    return jax


@pytest.fixture(scope="module")
def granite():
    """(port cfg, reference moe layer as numpy): the reference's reduced
    granite init from seed 0 plus 0.02 N(0, 1) noise on every leaf."""
    jax = _jax()
    from repro.configs import get_config as jget
    from repro.models import build_model as jbuild

    jp = jbuild(jget("granite-moe-3b-a800m").reduced()).init(
        jax.random.key(0))
    layer = jp["layers"][0]["moe"]
    leaves, tdef = jax.tree.flatten(layer)
    keys = jax.random.split(jax.random.key(1), len(leaves))
    layer = jax.tree.unflatten(tdef, [
        np.asarray(a + 0.02 * jax.random.normal(k, a.shape, a.dtype))
        for a, k in zip(leaves, keys)])
    return get_config("granite-moe-3b-a800m").reduced(), layer


def _reference_keep(jnp, probs, k, cap):
    """The kept mask of ``moe.py:135-148`` of the reference, in jnp."""
    import jax

    _, tope = jax.lax.top_k(probs, k)
    flat_e = tope.reshape(-1)
    se = flat_e[jnp.argsort(flat_e, stable=True)]
    slot = jnp.arange(flat_e.shape[0]) - jnp.searchsorted(se, se,
                                                          side="left")
    return np.asarray(slot < cap)


@pytest.mark.parametrize("case", ["drop_free", "dropping"])
def test_grid_dispatch_matches_reference(granite, case):
    jax = _jax()
    import jax.numpy as jnp
    from repro.models.moe import apply_moe as japply
    from repro.utils.sharding_ctx import activation_sharding as jctx

    cfg, jlayer = granite
    jlayer = dict(jlayer)
    x = np.asarray(jax.random.normal(jax.random.key(3), (B, S, cfg.d_model),
                                     jnp.float32))
    if case == "dropping":
        cf = 1.25
        jlayer["router"] = jlayer["router"] + np.array(
            [0.05, 0.03, 0.0, 0.0], np.float32)
        x = x + np.float32(0.5)
    else:
        cf = float(cfg.n_experts)
    kw = dict(n_experts=cfg.n_experts, k=cfg.experts_per_token,
              capacity_factor=cf, activation=cfg.activation)
    shards = {"nb": NB, "ns": NS, "axes": None, "spec": None}
    # the reference's branch constrains its weights to be replicated,
    # which needs a mesh in context: one device, so no constraint moves
    # anything
    with jax.sharding.Mesh(np.array(jax.devices()[:1]), ("x",)), \
            jctx(moe_shards=shards):
        want, waux = japply(jlayer, jnp.asarray(x), shared_expert=False,
                            **kw)
    with SC.activation_sharding(moe_shards=shards), torch.no_grad():
        out, aux = moe.apply_moe(params_from_numpy(jlayer),
                                 torch.from_numpy(x), shared_expert=False,
                                 **kw)
    want = np.asarray(want)
    np.testing.assert_allclose(out.numpy(), want, rtol=1e-6,
                               atol=1e-6 * float(np.abs(want).max()))
    np.testing.assert_allclose(float(aux), float(waux), rtol=1e-6)

    # each cell of the grid keeps what the reference's dispatch keeps
    T = (B // NB) * (S // NS)
    cap = moe.capacity(T, cfg.experts_per_token, cfg.n_experts, cf)
    cells = (x.reshape(NB, B // NB, NS, S // NS, -1).transpose(0, 2, 1, 3, 4)
             .reshape(NB * NS, T, -1))
    dropped = 0
    for xc in cells:
        probs = np.array(jax.nn.softmax(
            jnp.asarray(xc @ jlayer["router"], jnp.float32), axis=-1))
        keep = _reference_keep(jnp, jnp.asarray(probs),
                               cfg.experts_per_token, cap)
        got = moe.route(torch.from_numpy(probs), cfg.experts_per_token,
                        cfg.n_experts, cap)
        np.testing.assert_array_equal(got.keep.numpy(), keep)
        dropped += int((~keep).sum())
    assert (dropped > 0) == (case == "dropping")


def test_grid_dispatch_differs_from_one_capacity(granite):
    """Per-cell capacity is not the call's: at factor 1.25 the grid drops
    other assignments than one dispatch over all B * S tokens."""
    cfg, jlayer = granite
    jlayer = dict(jlayer)
    jlayer["router"] = jlayer["router"] + np.array([0.05, 0.03, 0.0, 0.0],
                                                   np.float32)
    layer = params_from_numpy(jlayer)
    x = torch.randn(B, S, cfg.d_model, generator=torch.Generator()
                    .manual_seed(3)) + 0.5
    kw = dict(n_experts=cfg.n_experts, k=cfg.experts_per_token,
              capacity_factor=1.25, activation=cfg.activation,
              shared_expert=False)
    with torch.no_grad():
        plain, _ = moe.apply_moe(layer, x, **kw)
        with SC.activation_sharding(moe_shards={"nb": NB, "ns": NS}):
            grid, _ = moe.apply_moe(layer, x, **kw)
    assert float((plain - grid).abs().max()) > 1e-3


def test_shard_functions_are_the_identity_without_a_spec():
    x = torch.randn(2, 3, 4)
    assert SC.shard_residual(x) is x and SC.shard_logits(x) is x
    assert SC.moe_shards() is None
    with SC.activation_sharding(residual=(None, "model", None),
                                logits=(None, None, "model"),
                                moe_shards={"nb": 2, "ns": 1}):
        assert SC.shard_residual(x) is x and SC.shard_logits(x) is x
        assert SC.moe_shards() == {"nb": 2, "ns": 1}
        for f in (SC.batch_local, SC.resolve_partial, SC.replicate):
            assert f(x) is x
        assert SC.local_layout((x, x), (2, 2), 4) == (x, x)
    assert SC.moe_shards() is None


# ------------------------------------------------------------ custom ops
def _attn_inputs(dtype=torch.float32):
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 24, 4, 16, generator=g, dtype=dtype)
    k = torch.randn(2, 24, 2, 16, generator=g, dtype=dtype)
    v = torch.randn(2, 24, 2, 16, generator=g, dtype=dtype)
    return q, k, v


def _ssd_inputs():
    g = torch.Generator().manual_seed(1)
    x = torch.randn(2, 3, 8, 4, 16, generator=g)
    dt = torch.rand(2, 3, 8, 4, generator=g)
    a_cs = -torch.cumsum(torch.rand(2, 3, 8, 4, generator=g), dim=2)
    Bm = torch.randn(2, 3, 8, 5, generator=g)
    Cm = torch.randn(2, 3, 8, 5, generator=g)
    return x, dt, a_cs, Bm, Cm


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fake_implementations_give_the_plain_shapes(dtype):
    from torch._subclasses.fake_tensor import FakeTensorMode

    q, k, v = _attn_inputs(dtype)
    want = R.flash_attention(q, k, v, kind="causal")
    sargs = tuple(t.to(dtype) for t in _ssd_inputs())
    swant = R.ssd_intra(*sargs)
    with FakeTensorMode() as fm:
        fq, fk, fv = (fm.from_tensor(t) for t in (q, k, v))
        got = torch.ops.repro_torch.flash_attention(fq, fk, fv, "causal", 0,
                                                    0, False)
        sgot = torch.ops.repro_torch.ssd_intra(
            *(fm.from_tensor(t) for t in sargs), False)
    assert (got.shape, got.dtype) == (want.shape, want.dtype)
    assert (sgot.shape, sgot.dtype) == (swant.shape, swant.dtype)


@pytest.mark.parametrize("kind,window,chunk", [
    ("causal", 0, 0), ("sliding", 5, 0), ("chunked", 0, 8),
    ("bidirectional", 0, 0)])
def test_custom_ops_equal_the_plain_versions(kind, window, chunk):
    q, k, v = _attn_inputs()
    got = ops.flash_attention(q, k, v, kind=kind, window=window, chunk=chunk)
    want = R.flash_attention(q, k, v, kind=kind, window=window, chunk=chunk)
    assert torch.equal(got, want)
    sargs = _ssd_inputs()
    assert torch.equal(ops.ssd_intra(*sargs), R.ssd_intra(*sargs))
    # under autograd the plain version differentiates
    q.requires_grad_(True)
    ops.flash_attention(q, k, v, kind=kind, window=window,
                        chunk=chunk).sum().backward()
    assert q.grad is not None and q.grad.shape == q.shape


@pytest.fixture(scope="module")
def mesh22():
    from repro_torch.launch.mesh import fake_world, make_test_mesh

    with fake_world(4):
        yield make_test_mesh((2, 2))


def _dt(t, mesh, placements):
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(t, mesh, placements)


def test_kernel_ops_run_shard_local_or_raise(mesh22):
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor, Replicate, Shard

    q, k, v = _attn_inputs()
    fm = FakeTensorMode(allow_non_fake_inputs=True)

    def fake(t, placements):
        shape = list(t.shape)
        for p in placements:
            if p.is_shard():
                shape[p.dim] //= 2
        with fm:
            local = torch.empty(shape, dtype=t.dtype)
        return DTensor.from_local(local, mesh22, placements, run_check=False,
                                  shape=t.shape, stride=t.stride())

    for pl in [(Shard(0), Shard(2)), (Shard(0), Replicate()),
               (Replicate(), Shard(2)), (Replicate(), Replicate())]:
        out = ops.flash_attention(*(fake(t, pl) for t in (q, k, v)))
        assert isinstance(out, DTensor) and out.placements == pl
        assert out.shape == q.shape
    with pytest.raises(ValueError, match="redistribute first"):
        ops.flash_attention(*(fake(t, (Shard(1), Replicate()))
                              for t in (q, k, v)))
    with pytest.raises(ValueError, match="redistribute first"):
        ops.flash_attention(fake(q, (Shard(2), Replicate())),
                            fake(k, (Replicate(), Replicate())),
                            fake(v, (Replicate(), Replicate())))
    sargs = _ssd_inputs()
    heads = (Shard(3),) * 3 + (Replicate(),) * 2
    out = ops.ssd_intra(*(fake(t, (Shard(0), p))
                          for t, p in zip(sargs, heads)))
    assert out.placements == (Shard(0), Shard(3))
    with pytest.raises(ValueError, match="redistribute first"):
        ops.ssd_intra(*(fake(t, (Shard(1), Replicate())) for t in sargs))
    # the callers' layout: every operand batch- or head-sharded
    lq, lk, lv = SC.local_layout(
        tuple(fake(t, (Shard(1), Shard(1))) for t in (q, k, v)), (2, 2, 2),
        k.shape[2])
    # batch 2 over data; then 2 KV heads over model
    assert lq.placements == (Shard(0), Shard(2)) == lk.placements
