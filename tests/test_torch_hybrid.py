"""The port's hybrid LM (``models/hybrid.py``, zamba2-1.2b) against the
JAX package on the CPU.

Reduced zamba2-1.2b (2 Mamba2 layers, each followed by the shared
attention block: ``shared_attn_every`` 1, a 64-token sliding window) in
both layouts of the Mamba groups: nested lists (``reduced()``) and one
tree of ``[G, every, ...]`` leaves (``scan_layers=True``), and a variant
with trailing Mamba layers (``n_layers`` 3, every 2: one group of two,
then one ``rest`` layer). The reference's parameters cross over through
``models/convert.py:params_from_numpy`` after noise on every leaf (the
norms and biases act); the tokens are the reference's ``make_batch``
draws. Tolerances, float32 throughout:

* forward logits within rtol 1e-5 plus 1e-5 of their largest magnitude;
  loss within rtol 1e-6;
* one FedCET round (tau 2, 2 clients): x within 1e-5 of each leaf's scale,
  d within 1e-5 of c times it;
* prefill of 96 tokens (past the 64-slot ring of every application of the
  shared block) and three decode steps: logits within 1e-5 of their
  scale; the KV rings' slot positions equal, one per application.

The card test (skipped without one) runs the reduced prefill through the
flash-attention and SSD kernels against their plain versions.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core import FedCET
from repro_torch.kernels import library as L
from repro_torch.launch import input_specs
from repro_torch.models import build_model
from repro_torch.models.convert import params_from_numpy
from repro_torch.utils.tree import tree_leaves

B, S, PROMPT = 2, 16, 96
VARIANTS = {"list": {}, "stacked": dict(scan_layers=True),
            "rest": dict(n_layers=3, shared_attn_every=2)}


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
    for name, changes in VARIANTS.items():
        jcfg = dataclasses.replace(jget("zamba2-1.2b").reduced(), **changes)
        cfg = dataclasses.replace(get_config("zamba2-1.2b").reduced(),
                                  **changes)
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


def test_layout_and_tree_match_the_reference(built):
    """38 = 6 x 6 + 2 at full width; the port's tree has the reference's
    keys and shapes in every layout."""
    from repro_torch.models.hybrid import _layout

    def shapes(tree, path=""):
        if isinstance(tree, dict):
            return {k: v for key in tree
                    for k, v in shapes(tree[key], f"{path}/{key}").items()}
        if isinstance(tree, (list, tuple)):
            return {k: v for i, t in enumerate(tree)
                    for k, v in shapes(t, f"{path}/{i}").items()}
        return {path: tuple(np.shape(tree))}

    assert _layout(get_config("zamba2-1.2b")) == (6, 6, 2)
    for name in VARIANTS:
        _, _, _, model, jp, _ = built[name]
        mine = model.init(torch.Generator().manual_seed(0))
        assert shapes(mine) == shapes(jp)


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


def test_fedcet_round_on_hybrid_matches_jax(built):
    jax = _jax()
    import jax.numpy as jnp
    from repro.core import FedCET as JFedCET

    jcfg, cfg, jm, model, jp, params = built["list"]
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


def _ring_positions(caches, stacked):
    """Each shared-block application's KV slot positions, as numpy."""
    kv = caches["kv"]
    if stacked:
        return [np.asarray(p) for p in np.asarray(kv.pos)]
    return [np.asarray(c.pos) for c in kv]


@pytest.mark.parametrize("name", list(VARIANTS))
def test_prefill_and_decode_match_jax(built, name):
    jax = _jax()
    jcfg, cfg, jm, model, jp, params = built[name]
    stacked = cfg.scan_layers
    tokens = _tokens(jcfg, B, PROMPT, key=1)
    jlog, jc = jax.jit(jm.prefill)(jp, {"tokens": tokens},
                                   jm.init_caches(B, PROMPT + 3))
    with torch.no_grad():
        log, caches = model.prefill(params,
                                    {"tokens": torch.from_numpy(tokens)},
                                    model.init_caches(B, PROMPT + 3))
    np.testing.assert_allclose(log.numpy(), np.asarray(jlog),
                               **_tol(np.asarray(jlog)))
    tok = np.asarray(jax.numpy.argmax(jlog, axis=-1)).astype(np.int32)
    decode = jax.jit(jm.decode_step)
    for _ in range(3):
        jlog, jc = decode(jp, tok, jc)
        with torch.no_grad():
            log, caches = model.decode_step(params, torch.from_numpy(tok),
                                            caches)
        np.testing.assert_allclose(log.numpy(), np.asarray(jlog),
                                   **_tol(np.asarray(jlog)))
        tok = np.asarray(jax.numpy.argmax(jlog, axis=-1)).astype(np.int32)
    got_pos = _ring_positions(caches, stacked)
    assert len(got_pos) == cfg.n_layers // cfg.shared_attn_every
    for g, w in zip(got_pos, _ring_positions(jc, stacked)):
        np.testing.assert_array_equal(g, w)


@pytest.mark.cuda
def test_cuda_prefill_through_the_kernels_matches_plain():
    """The reduced prefill on the card, 96 tokens: the shared block's
    attention through the flash-attention kernel (once per application)
    and every Mamba2 block's SSD term through the SSD kernel (once a
    layer), held against the same prefill with both plain versions,
    within 1e-4 of the logits' scale."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA is not available)")
    from repro_torch.kernels import ops

    cfg = get_config("zamba2-1.2b").reduced()
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        device="cuda")
    batch = input_specs.make_batch(cfg, B, PROMPT, key=1, device="cuda")

    def run():
        with torch.no_grad():
            return model.prefill(params, batch, model.init_caches(
                B, PROMPT, device="cuda"))[0]

    L.reset_launches()
    got = run()
    assert L.LAUNCHES["flash_attention"] == cfg.n_layers
    assert L.LAUNCHES["ssd_intra"] == cfg.n_layers
    real = {k: getattr(ops, k) for k in ("flash_attention", "ssd_intra")}
    for k, fn in real.items():
        setattr(ops, k, lambda *a, fn=fn, **kw: fn(*a, **{**kw,
                                                          "impl": "ref"}))
    try:
        want = run()
    finally:
        for k, fn in real.items():
            setattr(ops, k, fn)
    assert float((got - want).abs().max() / want.abs().max()) <= 1e-4
