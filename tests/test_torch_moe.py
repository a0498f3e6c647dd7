"""The port's MoE block (``models/moe.py``) and the moe family of
``models/transformer.py`` against the JAX package on the CPU.

Reduced granite-moe-3b-a800m (4 experts, top 2, SwiGLU experts) in both
layer layouts, and reduced llama4-scout (top 1, a shared expert, chunked
attention). The reference's parameters cross over through
``models/convert.py:params_from_numpy`` after noise on every leaf, so the
experts (which the reference initializes from one draw) differ and the
norms act; inputs are the reference's ``make_batch`` draws. Tolerances,
float32 throughout:

* forward logits within rtol 1e-5 plus 1e-5 of their largest magnitude;
  loss (the load-balance term included) within rtol 1e-6;
* one FedCET round (tau 2, 2 clients): x within 1e-5 of each leaf's scale,
  d within 1e-5 of c times it (``tests/test_torch_ssm_lm.py``);
* prefill and three decode steps: logits within 1e-5 (rtol = atol);
* at capacity factor 1.25, where assignments ARE dropped: the kept mask
  and the slots equal the reference's dispatch (``moe.py:135-148``,
  evaluated with jnp) exactly, and the block's output within rtol 1e-6
  plus 1e-6 of its largest magnitude (the expert matmuls sum in another
  order than XLA's einsums).

The card test (skipped without one) runs the reduced prefill through the
flash-attention kernel against its plain version, within 1e-4 of the
logits' scale.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core import FedCET
from repro_torch.kernels import library as L
from repro_torch.launch import input_specs
from repro_torch.models import build_model, moe
from repro_torch.models.convert import params_from_numpy
from repro_torch.utils.tree import tree_leaves

B, S = 2, 16
VARIANTS = {"granite": ("granite-moe-3b-a800m", {}),
            "granite-stacked": ("granite-moe-3b-a800m",
                                dict(scan_layers=True)),
            "llama4": ("llama4-scout-17b-a16e", {})}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's side on one intra-op thread: the suite runs several
    workers on few cores, and oversubscribed threads slow these tests many
    times over (the results do not depend on it)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax():
    import jax

    jax.config.update("jax_enable_x64", True)
    return jax


def _tol(want, rel=1e-5):
    return dict(rtol=rel, atol=rel * float(np.abs(want).max()))


@pytest.fixture(scope="module")
def built():
    """name -> (jax cfg, port cfg, jax model, port model, jax params, port
    params): the reference's init from seed 0 plus 0.02 N(0, 1) noise."""
    jax = _jax()
    from repro.configs import get_config as jget
    from repro.models import build_model as jbuild

    out = {}
    for name, (arch, changes) in VARIANTS.items():
        jcfg = dataclasses.replace(jget(arch).reduced(), **changes)
        cfg = dataclasses.replace(get_config(arch).reduced(), **changes)
        jm = jbuild(jcfg)
        jp = jm.init(jax.random.key(0))
        leaves, tdef = jax.tree.flatten(jp)
        keys = jax.random.split(jax.random.key(1), len(leaves))
        jp = jax.tree.unflatten(tdef, [
            np.asarray(a + 0.02 * jax.random.normal(k, a.shape, a.dtype))
            for a, k in zip(leaves, keys)])
        out[name] = (jcfg, cfg, jm, build_model(cfg), jp,
                     params_from_numpy(jp))
    return out


def _tokens(jcfg, batch, seq, key):
    from repro.launch import input_specs as jspecs

    return np.array(jspecs.make_batch(jcfg, batch, seq, key=key)["tokens"])


@pytest.mark.parametrize("name", list(VARIANTS))
def test_forward_and_loss_match_jax(built, name):
    jcfg, cfg, jm, model, jp, params = built[name]
    tokens = _tokens(jcfg, B, S, key=1)
    want = np.asarray(jm.forward(jp, {"tokens": tokens}))
    tb = {"tokens": torch.from_numpy(tokens)}
    with torch.no_grad():
        got = model.forward(params, tb)
        loss = model.loss(params, tb)
    assert tuple(got.shape) == (B, S, cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), want, **_tol(want))
    np.testing.assert_allclose(float(loss),
                               float(jm.loss(jp, {"tokens": tokens})),
                               rtol=1e-6)


def test_loss_carries_the_load_balance_term(built):
    """``loss`` is the cross entropy plus ``MOE_AUX_COEF`` times the
    summed Switch terms, as the reference's (each >= 1 at balance)."""
    from repro_torch.models.transformer import MOE_AUX_COEF

    _, cfg, _, model, _, params = built["granite"]
    tb = {"tokens": torch.from_numpy(_tokens(built["granite"][0], B, S, 1))}
    with torch.no_grad():
        x, aux = model._hidden(params, tb)
        ce = model.loss(params, tb) - MOE_AUX_COEF * aux
    assert float(aux) >= cfg.n_layers * 0.99
    from repro_torch.models.losses import chunked_ce
    with torch.no_grad():
        want = chunked_ce(x, model._head(params), tb["tokens"])
    np.testing.assert_allclose(float(ce), float(want), rtol=1e-6)


def test_fedcet_round_on_moe_matches_jax(built):
    jax = _jax()
    import jax.numpy as jnp
    from repro.core import FedCET as JFedCET

    jcfg, cfg, jm, model, jp, params = built["granite"]
    tau, n, alpha, c = 2, 2, 1e-2, 0.1
    tokens = np.stack([np.stack([_tokens(jcfg, B, S, key=10 * t + i)
                                 for i in range(n)]) for t in range(tau)])
    jalgo = JFedCET(alpha=alpha, c=c, tau=tau, n_clients=n)
    jgrad = jax.grad(jm.loss)
    jstate = jalgo.init(jgrad, jp, {"tokens": tokens[0]})
    jstate = jax.jit(lambda s, b: jalgo.round(jgrad, s, b))(
        jstate, {"tokens": tokens})
    algo = FedCET(alpha=alpha, c=c, tau=tau, n_clients=n)
    grad = torch.func.grad(model.loss)
    state = algo.init(grad, params, {"tokens": torch.from_numpy(tokens[0])})
    state = algo.round(grad, state, {"tokens": torch.from_numpy(tokens)})
    d_norm = 0.0
    for gx, wx, gd, wd in zip(tree_leaves(state.x), jax.tree.leaves(jstate.x),
                              tree_leaves(state.d), jax.tree.leaves(jstate.d)):
        assert tuple(gx.shape) == wx.shape
        scale = float(jnp.abs(wx).max())
        np.testing.assert_allclose(gx.numpy(), np.asarray(wx), rtol=1e-5,
                                   atol=1e-5 * scale)
        np.testing.assert_allclose(gd.numpy(), np.asarray(wd), rtol=0,
                                   atol=1e-5 * c * scale)
        d_norm += float(gd.abs().sum())
    assert d_norm > 0.0, "the drift variable never moved"


@pytest.mark.parametrize("name", ["granite-stacked", "llama4"])
def test_prefill_and_decode_match_jax(built, name):
    jax = _jax()
    jcfg, cfg, jm, model, jp, params = built[name]
    tokens = _tokens(jcfg, B, S, key=1)
    jlog, jc = jax.jit(jm.prefill)(jp, {"tokens": tokens},
                                   jm.init_caches(B, S + 3))
    with torch.no_grad():
        log, caches = model.prefill(params,
                                    {"tokens": torch.from_numpy(tokens)},
                                    model.init_caches(B, S + 3))
    np.testing.assert_allclose(log.numpy(), np.asarray(jlog), rtol=1e-5,
                               atol=1e-5)
    tok = np.asarray(jax.numpy.argmax(jlog, axis=-1)).astype(np.int32)
    decode = jax.jit(jm.decode_step)
    for _ in range(3):
        jlog, jc = decode(jp, tok, jc)
        with torch.no_grad():
            log, caches = model.decode_step(params, torch.from_numpy(tok),
                                            caches)
        np.testing.assert_allclose(log.numpy(), np.asarray(jlog), rtol=1e-5,
                                   atol=1e-5)
        tok = np.asarray(jax.numpy.argmax(jlog, axis=-1)).astype(np.int32)


def _reference_dispatch(jnp, probs, k, n_experts, cap):
    """``moe.py:135-148`` of the reference, step for step, in jnp."""
    import jax

    topw, tope = jax.lax.top_k(probs, k)
    flat_e = tope.reshape(-1)
    order = jnp.argsort(flat_e, stable=True)
    se = flat_e[order]
    run_start = jnp.searchsorted(se, se, side="left")
    slot = jnp.arange(flat_e.shape[0]) - run_start
    keep = slot < cap
    return tope, order, se, jnp.where(keep, slot, 0), keep


def test_dropping_capacity_matches_the_reference_dispatch(built):
    """Capacity factor 1.25 over 32 tokens, top 2 of 4 experts: C = 20
    slots an expert; the skewed router overfills the favoured experts, so
    assignments are dropped. The dispatch equals the reference's exactly
    and the block's output is within 1e-6 of its scale."""
    jax = _jax()
    import jax.numpy as jnp
    from repro.models.moe import apply_moe as japply

    jcfg, cfg, _, _, jp, params = built["granite"]
    jlayer = dict(jp["layers"][0]["moe"])
    # tokens with a common offset, and a router that reads it toward
    # experts 0 and 1: both are everyone's top 2, 32 assignments each.
    jlayer["router"] = jlayer["router"] + np.array([0.05, 0.03, 0.0, 0.0],
                                                   np.float32)
    layer = params_from_numpy(jlayer)
    x = np.asarray(jax.random.normal(jax.random.key(3), (B, S, cfg.d_model),
                                     jnp.float32)) + np.float32(0.5)
    kw = dict(n_experts=cfg.n_experts, k=cfg.experts_per_token,
              capacity_factor=1.25, activation=cfg.activation)
    cap = moe.capacity(B * S, cfg.experts_per_token, cfg.n_experts, 1.25)
    assert cap == 20
    xt = x.reshape(B * S, -1)
    probs = np.array(jax.nn.softmax(
        jnp.asarray(xt @ jlayer["router"], jnp.float32), axis=-1))
    tope, order, se, slot, keep = (np.asarray(a) for a in _reference_dispatch(
        jnp, jnp.asarray(probs), cfg.experts_per_token, cfg.n_experts, cap))
    assert not keep.all(), "nothing was dropped: the case tests nothing"
    got = moe.route(torch.from_numpy(probs), cfg.experts_per_token,
                    cfg.n_experts, cap)
    np.testing.assert_array_equal(got.tope.numpy(), tope)
    np.testing.assert_array_equal(got.order.numpy(), order)
    np.testing.assert_array_equal(got.se.numpy(), se)
    np.testing.assert_array_equal(got.keep.numpy(), keep)
    np.testing.assert_array_equal(got.slot.numpy(), slot)
    want, waux = japply(jlayer, jnp.asarray(x), shared_expert=False, **kw)
    with torch.no_grad():
        out, aux = moe.apply_moe(layer, torch.from_numpy(x),
                                 shared_expert=False, **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(want),
                               **_tol(np.asarray(want), 1e-6))
    np.testing.assert_allclose(float(aux), float(waux), rtol=1e-6)


def test_decode_capacity_is_one_slot_at_granite_width():
    """At granite's decode (batch 4, top 8 of 40 experts) an expert holds
    one slot: the reference's formula, which drops differently from the
    prefill's."""
    cfg = get_config("granite-moe-3b-a800m")
    assert moe.capacity(4, cfg.experts_per_token, cfg.n_experts,
                        cfg.capacity_factor) == 1
    assert moe.capacity(4 * 2048, cfg.experts_per_token, cfg.n_experts,
                        cfg.capacity_factor) == 2048


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["granite-moe-3b-a800m",
                                  "llama4-scout-17b-a16e"])
def test_cuda_prefill_through_the_kernel_matches_plain(name):
    """The reduced prefill on the card: every layer's attention through
    the flash-attention kernel, held against the same prefill with the
    kernel's plain version, within 1e-4 of the logits' scale."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA is not available)")
    from repro_torch.kernels import ops

    cfg = get_config(name).reduced()
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        device="cuda")
    batch = input_specs.make_batch(cfg, B, 96, key=1, device="cuda")

    def run():
        with torch.no_grad():
            return model.prefill(params, batch,
                                 model.init_caches(B, 96, device="cuda"))[0]

    L.reset_launches()
    got = run()
    assert L.LAUNCHES["flash_attention"] == cfg.n_layers
    real = ops.flash_attention
    ops.flash_attention = lambda *a, **kw: real(*a, **{**kw, "impl": "ref"})
    try:
        want = run()
    finally:
        ops.flash_attention = real
    assert float((got - want).abs().max() / want.abs().max()) <= 1e-4
