"""Per-architecture smoke tests of the port (mirror of
``tests/test_arch_smoke.py``), and the dense variants and the vlm family
against the JAX package, on the CPU.

For each of the 11 registered architectures, at ``reduced()`` (2 layers,
d_model <= 256, <= 4 experts) with the port's own random init: a forward
pass (shape and finiteness, loss finite), one FedCET round (tau 2, 2
heterogeneous clients) on the model tree, and prefill of all but the last
token plus one decode step against ``forward``'s last two positions
within 2e-3 (rtol = atol, the reference's bound). Then the two config
tests, and every config equal to the reference's field for field, the
port's own fields (nemotron_h's) at their defaults.

Against the reference, on its parameters (``models/convert.py:
params_from_numpy``, after 0.02 N(0, 1) noise on every leaf so the norms
act) and its ``make_batch`` draws, float32: reduced gemma-2b (GeGLU,
embeddings scaled by sqrt(d) and tied, one KV head, a 64-token sliding
window) and reduced llava-next-34b (16 image-patch embeddings before the
text, the loss on text positions only): forward logits within rtol 1e-5
plus 1e-5 of their largest magnitude, loss within rtol 1e-6, one FedCET
round's x within 1e-5 of each leaf's scale and d within 1e-5 of c times
it, prefill (96 tokens: past gemma's ring) and three decode steps within
1e-5 of the logits' scale.

The card test (skipped without one) runs both reduced prefills through the
flash-attention kernel against its plain version.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import ASSIGNED, ArchConfig, get_config, list_archs
from repro_torch.core import FedCET
from repro_torch.kernels import library as L
from repro_torch.launch import input_specs, serve
from repro_torch.models import build_model
from repro_torch.models.convert import params_from_numpy
from repro_torch.utils.tree import tree_leaves, tree_map

ARCHS = list_archs()
B, S, PROMPT = 2, 16, 96
PARITY = ("gemma-2b", "llava-next-34b")


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


def _finite(tree) -> bool:
    return all(bool(torch.isfinite(t).all()) for t in tree_leaves(tree)
               if t.is_floating_point())


@pytest.fixture(scope="module")
def built():
    out = {}
    for name in ARCHS:
        cfg = get_config(name).reduced()
        model = build_model(cfg)
        out[name] = (cfg, model, model.init(torch.Generator().manual_seed(0)))
    return out


@pytest.mark.parametrize("name", ARCHS)
def test_forward_shapes_and_finiteness(built, name):
    cfg, model, params = built[name]
    batch = input_specs.make_batch(cfg, B, S, key=1)
    with torch.no_grad():
        logits = model.forward(params, batch)
        loss = model.loss(params, batch)
    extra = cfg.n_modal_tokens if cfg.family == "vlm" else 0
    assert tuple(logits.shape) == (B, S + extra, cfg.vocab_size)
    assert _finite(logits), f"{name}: non-finite logits"
    assert bool(torch.isfinite(loss)), f"{name}: non-finite loss"


@pytest.mark.parametrize("name", ARCHS)
def test_fedcet_round_on_arch(built, name):
    """One FedCET round on the model tree: params stay finite, shapes
    unchanged, and the drift variable d has moved."""
    cfg, model, params = built[name]
    tau, n_clients = 2, 2
    algo = FedCET(alpha=1e-2, c=0.1, tau=tau, n_clients=n_clients)
    rows = [[input_specs.make_batch(cfg, B, S, key=10 * t + c)
             for c in range(n_clients)] for t in range(tau)]
    batches = {k: torch.stack([torch.stack([b[k] for b in row])
                               for row in rows]) for k in rows[0][0]}
    grad_fn = torch.func.grad(model.loss)
    state = algo.init(grad_fn, params, {k: v[0] for k, v in batches.items()})
    state = algo.round(grad_fn, state, batches)
    assert _finite(state.x), f"{name}: non-finite params after round"
    assert _finite(state.d), f"{name}: non-finite drift state"
    want = tree_map(lambda a: (n_clients,) + tuple(a.shape), params)
    got = tree_map(lambda a: tuple(a.shape), state.x)
    assert tree_leaves(got) == tree_leaves(want)
    assert sum(float(d.abs().sum()) for d in tree_leaves(state.d)) > 0.0


@pytest.mark.parametrize("name", ARCHS)
def test_prefill_decode_consistency(built, name):
    """prefill(tokens[:-1]) + decode(last token) == forward's last
    logits."""
    cfg, model, params = built[name]
    batch = input_specs.make_batch(cfg, B, S, key=3)
    prefix = {**batch, "tokens": batch["tokens"][:, :-1]}
    with torch.no_grad():
        full = model.forward(params, batch)
        caches = model.init_caches(B, serve.cache_len(cfg, S, 0))
        pre, caches = model.prefill(params, prefix, caches)
        dec, _ = model.decode_step(params, batch["tokens"][:, -1:], caches)
    np.testing.assert_allclose(pre[:, 0].numpy(), full[:, -2].numpy(),
                               rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(dec[:, 0].numpy(), full[:, -1].numpy(),
                               rtol=2e-3, atol=2e-3)


def test_reduced_configs_meet_constraints():
    for name in ARCHS:
        cfg = get_config(name).reduced()
        assert cfg.n_layers <= 2
        assert cfg.d_model <= 512
        assert cfg.n_experts <= 4


def test_full_configs_match_assignment():
    """The assigned hyperparameters (``tests/test_arch_smoke.py``), and
    every config and its ``reduced()`` equal to the reference's field for
    field."""
    from repro.configs import ASSIGNED as JASSIGNED
    from repro.configs import registry as jregistry

    spec = {
        "internlm2-20b": (48, 6144, 48, 8, 16384, 92544),
        "zamba2-1.2b": (38, 2048, 32, 32, 8192, 32000),
        "qwen3-1.7b": (28, 2048, 16, 8, 6144, 151936),
        "minicpm-2b": (40, 2304, 36, 36, 5760, 122753),
        "llava-next-34b": (60, 7168, 56, 8, 20480, 64000),
        "llama4-scout-17b-a16e": (48, 5120, 40, 8, 8192, 202048),
        "gemma-2b": (18, 2048, 8, 1, 16384, 256000),
        "mamba2-130m": (24, 768, 0, 0, 0, 50280),
        "granite-moe-3b-a800m": (32, 1536, 24, 8, 512, 49155),
        "whisper-small": (12, 768, 12, 12, 3072, 51865),
    }
    assert set(spec) == set(ASSIGNED) and ASSIGNED == JASSIGNED
    for name, (layers, d, h, kv, ff, v) in spec.items():
        cfg = get_config(name)
        got = (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
               cfg.d_ff, cfg.vocab_size)
        assert got == (layers, d, h, kv, ff, v), (name, got)
    assert get_config("zamba2-1.2b").ssm_state == 64
    assert get_config("llama4-scout-17b-a16e").experts_per_token == 1
    assert get_config("granite-moe-3b-a800m").n_experts == 40
    assert get_config("gemma-2b").head_dim == 256
    jreg = jregistry()
    assert sorted(jreg) == ARCHS
    # the port's ArchConfig is the reference's plus fields of its own
    # (nemotron_h's), which every mirrored config leaves at their defaults
    jfields = [f.name for f in dataclasses.fields(type(jreg[ARCHS[0]]))]
    port_only = {f.name: f.default for f in dataclasses.fields(ArchConfig)
                 if f.name not in jfields}
    assert port_only
    for name in ARCHS:
        for pick in (lambda c: c, lambda c: c.reduced()):
            got = dataclasses.asdict(pick(get_config(name)))
            assert ({k: got[k] for k in jfields}
                    == dataclasses.asdict(pick(jreg[name]))), name
            assert {k: got[k] for k in port_only} == port_only, name


# --------------------------------------------------------- against the JAX
@pytest.fixture(scope="module")
def reference():
    """arch -> (jax model, port model, jax params, port params)."""
    jax = _jax()
    from repro.configs import get_config as jget
    from repro.models import build_model as jbuild

    out = {}
    for name in PARITY:
        jm = jbuild(jget(name).reduced())
        jp = jm.init(jax.random.key(0))
        leaves, tdef = jax.tree.flatten(jp)
        keys = jax.random.split(jax.random.key(1), len(leaves))
        jp = jax.tree.unflatten(tdef, [
            np.asarray(a + 0.02 * jax.random.normal(k, a.shape, a.dtype))
            for a, k in zip(leaves, keys)])
        out[name] = (jm, build_model(get_config(name).reduced()), jp,
                     params_from_numpy(jp))
    return out


def _batch(name, batch, seq, key):
    """The reference's batch as numpy, and the port's as tensors."""
    from repro.configs import get_config as jget
    from repro.launch import input_specs as jspecs

    jb = {k: np.array(v) for k, v in jspecs.make_batch(
        jget(name).reduced(), batch, seq, key=key).items()}
    return jb, {k: torch.from_numpy(v.copy()) for k, v in jb.items()}


@pytest.mark.parametrize("name", PARITY)
def test_forward_and_loss_match_jax(reference, name):
    jm, model, jp, params = reference[name]
    jb, tb = _batch(name, B, S, key=1)
    want = np.asarray(jm.forward(jp, jb))
    with torch.no_grad():
        got = model.forward(params, tb)
        loss = model.loss(params, tb)
    np.testing.assert_allclose(got.numpy(), want, **_tol(want))
    np.testing.assert_allclose(float(loss), float(jm.loss(jp, jb)),
                               rtol=1e-6)


@pytest.mark.parametrize("name", PARITY)
def test_fedcet_round_matches_jax(reference, name):
    jax = _jax()
    import jax.numpy as jnp
    from repro.core import FedCET as JFedCET

    jm, model, jp, params = reference[name]
    tau, n, alpha, c = 2, 2, 1e-2, 0.1
    draws = [[_batch(name, B, S, key=10 * t + i)[0] for i in range(n)]
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
    for gx, wx, gd, wd in zip(tree_leaves(state.x), jax.tree.leaves(jstate.x),
                              tree_leaves(state.d), jax.tree.leaves(jstate.d)):
        scale = float(jnp.abs(wx).max())
        np.testing.assert_allclose(gx.numpy(), np.asarray(wx), rtol=1e-5,
                                   atol=1e-5 * scale)
        np.testing.assert_allclose(gd.numpy(), np.asarray(wd), rtol=0,
                                   atol=1e-5 * c * scale)


@pytest.mark.parametrize("name", PARITY)
def test_prefill_and_decode_match_jax(reference, name):
    jax = _jax()
    jm, model, jp, params = reference[name]
    cfg = model.cfg
    jb, tb = _batch(name, B, PROMPT, key=1)
    total = serve.cache_len(cfg, PROMPT, 3)
    jlog, jc = jax.jit(jm.prefill)(jp, jb, jm.init_caches(B, total))
    with torch.no_grad():
        log, caches = model.prefill(params, tb, model.init_caches(B, total))
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


@pytest.mark.cuda
@pytest.mark.parametrize("name", PARITY)
def test_cuda_prefill_through_the_kernel_matches_plain(name):
    """The reduced prefill on the card (96 tokens, after llava's 16 image
    tokens): every layer's attention through the flash-attention kernel,
    held against the same prefill with the plain version, within 1e-4 of
    the logits' scale."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA is not available)")
    from repro_torch.kernels import ops

    cfg = get_config(name).reduced()
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        device="cuda")
    batch = input_specs.make_batch(cfg, B, PROMPT, key=1, device="cuda")

    def run():
        with torch.no_grad():
            return model.prefill(params, batch, model.init_caches(
                B, serve.cache_len(cfg, PROMPT, 0), device="cuda"))[0]

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
