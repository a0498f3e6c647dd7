"""The port's Mamba2 LM (``models/ssm_lm.py``), its serving path and one
FedCET round on it, against the JAX package on the CPU at the reduced
mamba2-130m (2 layers, d_model 256, 32 SSD heads of P = 16, N = 16).

Both layer layouts: a list of per-layer dicts (``reduced()``) and stacked
``[L, ...]`` leaves (``scan_layers=True``, the full config's layout; the
port's stacked caches carry one host-int length where the reference
stacks one per layer). The reference's parameters cross over through
``models/convert.py:params_from_numpy``, with the norm weights and biases
moved off zero so they act; the prompts are the reference's ``make_batch``
draws. Tolerances, float32 throughout: rtol = atol = 2e-4 for forward and
prefill logits and caches (the reference's own bound between its kernel
and plain paths), 2e-3 for decode steps (``tests/test_arch_smoke.py``);
the FedCET round's x within 1e-5 of each leaf's scale and d within 1e-5 *
c of it, as in ``tests/test_torch_train.py``; greedy tokens equal.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core import FedCET
from repro_torch.launch import input_specs, serve
from repro_torch.models import build_model
from repro_torch.models.convert import params_from_numpy
from repro_torch.utils.tree import tree_leaves

LAYOUTS = {"list": {}, "stacked": dict(scan_layers=True)}
B, S = 2, 16
TOL = dict(rtol=2e-4, atol=2e-4)
DECODE_TOL = dict(rtol=2e-3, atol=2e-3)
#: norm weights and biases: moved off their zero init by this much noise
OFF_ZERO = ("norm", "out_norm", "dt_bias", "conv_b", "weight")


def _jax():
    import jax

    jax.config.update("jax_enable_x64", True)
    return jax


def _configs(layout, **changes):
    from repro.configs import get_config as jget

    changes = {**LAYOUTS[layout], **changes}
    return (dataclasses.replace(jget("mamba2-130m").reduced(), **changes),
            dataclasses.replace(get_config("mamba2-130m").reduced(),
                                **changes))


def _reference(layout, seed=0, **changes):
    """(jax cfg, port cfg, jax model, port model, jax params, port
    params): the reference's init from ``seed``, norms moved off zero."""
    jax = _jax()
    from repro.models import build_model as jbuild

    jcfg, cfg = _configs(layout, **changes)
    jm = jbuild(jcfg)
    noise = jax.random.key(seed + 1)

    def move(path, a):
        name = getattr(path[-1], "key", None)
        if name not in OFF_ZERO:
            return a
        return a + 0.05 * jax.random.normal(noise, a.shape, a.dtype)

    jp = jax.tree_util.tree_map_with_path(move, jm.init(jax.random.key(seed)))
    jp = jax.tree.map(np.asarray, jp)
    return jcfg, cfg, jm, build_model(cfg), jp, params_from_numpy(jp)


def _tokens(jcfg, batch, seq, key):
    from repro.launch import input_specs as jspecs

    return np.array(jspecs.make_batch(jcfg, batch, seq, key=key)["tokens"])


def _caches(caches, stacked):
    """[(conv, state, length)] per layer as numpy, from either package."""
    if stacked:
        n = np.asarray(caches.conv).shape[0]
        lengths = np.broadcast_to(np.asarray(caches.length), (n,))
        return [(np.asarray(caches.conv)[i], np.asarray(caches.state)[i],
                 int(lengths[i])) for i in range(n)]
    return [(np.asarray(c.conv), np.asarray(c.state), int(np.asarray(
        c.length))) for c in caches]


def _same_caches(got, want, stacked, tol=TOL):
    got, want = _caches(got, stacked), _caches(want, stacked)
    assert len(got) == len(want)
    for (gc, gs, gl), (wc, ws, wl) in zip(got, want):
        np.testing.assert_allclose(gc, wc, **tol)
        np.testing.assert_allclose(gs, ws, **tol)
        assert gl == wl


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_forward_and_loss_match_jax(layout):
    jcfg, cfg, jm, model, jp, params = _reference(layout)
    tokens = _tokens(jcfg, B, S, key=1)
    want = np.asarray(jm.forward(jp, {"tokens": tokens}))
    with torch.no_grad():
        got = model.forward(params, {"tokens": torch.from_numpy(tokens)})
        loss = model.loss(params, {"tokens": torch.from_numpy(tokens)})
    assert tuple(got.shape) == (B, S, cfg.vocab_size)
    assert torch.isfinite(got).all() and torch.isfinite(loss)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(float(loss),
                               float(jm.loss(jp, {"tokens": tokens})),
                               rtol=1e-5)


def test_pallas_ssd_in_mamba_forward():
    """``use_pallas_ssd`` (the kernel route; on the CPU ``ops.ssd_intra``'s
    plain version) against the plain forward and against the reference's
    forward through its Pallas kernel in interpret mode, over two chunks
    (``tests/test_kernel_integration.py``: rtol 2e-4)."""
    jcfg, cfg, jm, model, jp, params = _reference("list")
    from repro.models import build_model as jbuild

    tokens = _tokens(jcfg, 2, 256, key=3)
    jk = jbuild(dataclasses.replace(jcfg, use_pallas_ssd=True))
    want = np.asarray(jk.forward(jp, {"tokens": tokens}))
    kernel = build_model(dataclasses.replace(cfg, use_pallas_ssd=True))
    tb = {"tokens": torch.from_numpy(tokens)}
    with torch.no_grad():
        got = kernel.forward(params, tb)
        plain = model.forward(params, tb)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **TOL)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_fedcet_round_on_mamba2_matches_jax():
    """One FedCET round (tau 2, 2 heterogeneous clients) on the model
    tree, through the port's FedCET and ``torch.func`` gradients, against
    the reference's round from the same parameters and tokens."""
    jax = _jax()
    import jax.numpy as jnp
    from repro.core import FedCET as JFedCET

    jcfg, cfg, jm, model, jp, params = _reference("list")
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
    assert state.t == tau
    d_norm = 0.0
    for gx, wx, gd, wd in zip(tree_leaves(state.x),
                              jax.tree.leaves(jstate.x),
                              tree_leaves(state.d),
                              jax.tree.leaves(jstate.d)):
        assert torch.isfinite(gx).all() and torch.isfinite(gd).all()
        assert tuple(gx.shape) == wx.shape
        scale = float(jnp.abs(wx).max())
        np.testing.assert_allclose(gx.numpy(), np.asarray(wx), rtol=1e-5,
                                   atol=1e-5 * scale)
        np.testing.assert_allclose(gd.numpy(), np.asarray(wd), rtol=0,
                                   atol=1e-5 * c * scale)
        d_norm += float(gd.abs().sum())
    assert d_norm > 0.0, "the drift variable never moved"


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_prefill_caches_and_decode_match_jax(layout):
    jax = _jax()
    jcfg, cfg, jm, model, jp, params = _reference(layout)
    tokens = _tokens(jcfg, B, S, key=1)
    jlog, jc = jax.jit(jm.prefill)(jp, {"tokens": tokens},
                                   jm.init_caches(B, S + 3))
    with torch.no_grad():
        log, caches = model.prefill(params,
                                    {"tokens": torch.from_numpy(tokens)},
                                    model.init_caches(B, S + 3))
    assert tuple(log.shape) == (B, 1, cfg.vocab_size)
    np.testing.assert_allclose(log.numpy(), np.asarray(jlog), **TOL)
    _same_caches(caches, jc, cfg.scan_layers)
    tok = np.asarray(jax.numpy.argmax(jlog, axis=-1)).astype(np.int32)
    decode = jax.jit(jm.decode_step)
    for _ in range(3):
        jlog, jc = decode(jp, tok, jc)
        with torch.no_grad():
            log, caches = model.decode_step(params, torch.from_numpy(tok),
                                            caches)
        np.testing.assert_allclose(log.numpy(), np.asarray(jlog),
                                   **DECODE_TOL)
        _same_caches(caches, jc, cfg.scan_layers, DECODE_TOL)
        tok = np.asarray(jax.numpy.argmax(jlog, axis=-1)).astype(np.int32)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_prefill_decode_consistency(layout):
    """prefill(tokens[:-1]) + decode(last token) == forward's last two
    positions (``tests/test_arch_smoke.py``), on the port's own init."""
    _, cfg = _configs(layout)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    tokens = input_specs.make_batch(cfg, B, S, key=3)["tokens"]
    with torch.no_grad():
        full = model.forward(params, {"tokens": tokens})
        pre, caches = model.prefill(params, {"tokens": tokens[:, :-1]},
                                    model.init_caches(B, S))
        dec, _ = model.decode_step(params, tokens[:, -1:], caches)
    np.testing.assert_allclose(pre[:, 0].numpy(), full[:, -2].numpy(),
                               **DECODE_TOL)
    np.testing.assert_allclose(dec[:, 0].numpy(), full[:, -1].numpy(),
                               **DECODE_TOL)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_greedy_generate_emits_the_reference_tokens(layout, monkeypatch):
    """The reference's ``generate`` (its own init from seed 0 and its
    prompt from seed 1) against the port's loop on the same weights."""
    jax = _jax()
    from repro.launch import serve as jserve
    from repro.models import build_model as jbuild

    jcfg, cfg = _configs(layout)
    monkeypatch.setattr(jserve, "get_config", lambda arch: jcfg)
    want = jserve.generate("mamba2-130m", prompt_len=S, gen_len=6, batch=B,
                           reduced=False)
    params = params_from_numpy(jax.tree.map(
        np.asarray, jbuild(jcfg).init(jax.random.key(0))))
    batch = input_specs.make_batch(cfg, B, S, key=1)
    got = serve.generate_tokens(build_model(cfg), params, batch, gen_len=6)
    assert got.dtype == torch.int32 and tuple(got.shape) == (B, 6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_cli_and_config():
    """``--arch mamba2-130m`` serves on the CPU, and the full config
    equals the reference's field for field."""
    from repro.configs import get_config as jget

    out = serve.generate("mamba2-130m", prompt_len=12, gen_len=3,
                         device="cpu")
    assert tuple(out.shape) == (2, 3) and out.dtype == torch.int32
    want = dataclasses.asdict(jget("mamba2-130m"))
    got = dataclasses.asdict(get_config("mamba2-130m"))
    assert {k: got[k] for k in want} == want
    # the port's own fields (nemotron_h's) stay at their defaults
    assert {k: v for k, v in got.items() if k not in want} == {
        f.name: f.default for f in dataclasses.fields(type(get_config(
            "mamba2-130m"))) if f.name not in want}
    assert (got["n_layers"], got["d_model"], got["vocab_size"],
            got["ssm_state"], got["ssm_headdim"]) == (24, 768, 50280, 128, 64)
