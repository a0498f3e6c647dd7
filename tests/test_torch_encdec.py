"""The port's encoder-decoder LM (``models/encdec.py``, whisper-small)
against the JAX package on the CPU.

Reduced whisper-small (2 encoder and 2 decoder layers, d_model 256, 4
heads, LayerNorm, GELU, biases, 32 stub frames) in both layer layouts:
lists (``reduced()``) and stacked ``[L, ...]`` leaves
(``scan_layers=True``, with stacked caches). The reference's parameters
cross over through ``models/convert.py:params_from_numpy`` after noise on
every leaf (so the LayerNorm and the zero-initialized biases act); the
tokens and frames are the reference's ``make_batch`` draws. Tolerances,
float32 throughout:

* forward logits within rtol 1e-5 plus 1e-5 of their largest magnitude;
  loss within rtol 1e-6; the encoder's output within 1e-5 of its scale;
* one FedCET round (tau 2, 2 clients): x within 1e-5 of each leaf's scale,
  d within 1e-5 of c times it;
* prefill and three decode steps: logits within 1e-5 of their scale, the
  caches' cross-attention keys and values within 1e-5 of theirs.

The card test (skipped without one) runs the reduced prefill through the
flash-attention kernel (bidirectional in the encoder, causal in the
decoder) against its plain version.
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

B, S = 2, 16
LAYOUTS = {"list": {}, "stacked": dict(scan_layers=True)}


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
    """layout -> (jax cfg, port cfg, jax model, port model, jax params,
    port params): the reference's init from seed 0 plus 0.02 N(0, 1)."""
    jax = _jax()
    from repro.configs import get_config as jget
    from repro.models import build_model as jbuild

    out = {}
    for name, changes in LAYOUTS.items():
        jcfg = dataclasses.replace(jget("whisper-small").reduced(), **changes)
        cfg = dataclasses.replace(get_config("whisper-small").reduced(),
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


def _batch(jcfg, batch, seq, key):
    """The reference's batch as numpy, and the port's as tensors."""
    from repro.launch import input_specs as jspecs

    jb = {k: np.array(v) for k, v in jspecs.make_batch(jcfg, batch, seq,
                                                       key=key).items()}
    return jb, {k: torch.from_numpy(v.copy()) for k, v in jb.items()}


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_forward_loss_and_encoder_match_jax(built, layout):
    jcfg, cfg, jm, model, jp, params = built[layout]
    jb, tb = _batch(jcfg, B, S, key=1)
    assert tb["frames"].shape == (B, cfg.encoder_len, cfg.d_model)
    want = np.asarray(jm.forward(jp, jb))
    with torch.no_grad():
        got = model.forward(params, tb)
        loss = model.loss(params, tb)
        memory = model.encode(params, tb["frames"])
    assert tuple(got.shape) == (B, S, cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), want, **_tol(want))
    np.testing.assert_allclose(float(loss), float(jm.loss(jp, jb)),
                               rtol=1e-6)
    jmem = np.asarray(jm.encode(jp, jb["frames"]))
    np.testing.assert_allclose(memory.numpy(), jmem, **_tol(jmem))


def test_fedcet_round_on_encdec_matches_jax(built):
    jax = _jax()
    import jax.numpy as jnp
    from repro.core import FedCET as JFedCET

    jcfg, cfg, jm, model, jp, params = built["list"]
    tau, n, alpha, c = 2, 2, 1e-2, 0.1
    draws = [[_batch(jcfg, B, S, key=10 * t + i)[0] for i in range(n)]
             for t in range(tau)]
    jb = {k: np.stack([np.stack([d[k] for d in row]) for row in draws])
          for k in draws[0][0]}
    jalgo = JFedCET(alpha=alpha, c=c, tau=tau, n_clients=n)
    jgrad = jax.grad(jm.loss)
    jstate = jalgo.init(jgrad, jp, {k: v[0] for k, v in jb.items()})
    jstate = jax.jit(lambda s, b: jalgo.round(jgrad, s, b))(jstate, jb)
    tb = {k: torch.from_numpy(v) for k, v in jb.items()}
    algo = FedCET(alpha=alpha, c=c, tau=tau, n_clients=n)
    grad = torch.func.grad(model.loss)
    state = algo.init(grad, params, {k: v[0] for k, v in tb.items()})
    state = algo.round(grad, state, tb)
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


def _cross(caches, stacked):
    """(cross_k, cross_v) stacked over the layers, as numpy."""
    if stacked:
        return np.asarray(caches["cross_k"]), np.asarray(caches["cross_v"])
    return (np.stack([np.asarray(c["cross_k"]) for c in caches]),
            np.stack([np.asarray(c["cross_v"]) for c in caches]))


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_prefill_and_decode_match_jax(built, layout):
    jax = _jax()
    jcfg, cfg, jm, model, jp, params = built[layout]
    jb, tb = _batch(jcfg, B, S, key=1)
    jlog, jc = jax.jit(jm.prefill)(jp, jb, jm.init_caches(B, S + 3))
    with torch.no_grad():
        log, caches = model.prefill(params, tb, model.init_caches(B, S + 3))
    np.testing.assert_allclose(log.numpy(), np.asarray(jlog),
                               **_tol(np.asarray(jlog)))
    for g, w in zip(_cross(caches, cfg.scan_layers),
                    _cross(jc, cfg.scan_layers)):
        np.testing.assert_allclose(g, w, **_tol(w))
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


@pytest.mark.cuda
def test_cuda_prefill_through_the_kernel_matches_plain():
    """The reduced prefill on the card: the encoder's bidirectional and
    the decoder's causal attention through the flash-attention kernel
    (once a layer of each), held against the same prefill with the plain
    version, within 1e-4 of the logits' scale."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA is not available)")
    from repro_torch.kernels import ops

    cfg = get_config("whisper-small").reduced()
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        device="cuda")
    batch = input_specs.make_batch(cfg, B, S, key=1, device="cuda")

    def run():
        with torch.no_grad():
            return model.prefill(params, batch, model.init_caches(
                B, S, device="cuda"))[0]

    L.reset_launches()
    got = run()
    assert L.LAUNCHES["flash_attention"] == cfg.encoder_layers + cfg.n_layers
    real = ops.flash_attention
    ops.flash_attention = lambda *a, **kw: real(*a, **{**kw, "impl": "ref"})
    try:
        want = run()
    finally:
        ops.flash_attention = real
    assert float((got - want).abs().max() / want.abs().max()) <= 1e-4
