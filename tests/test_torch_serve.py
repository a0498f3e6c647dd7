"""The port's serving path (``launch/serve.py``, ``TransformerLM.prefill``
/ ``decode_step`` / ``init_caches``, ``launch/input_specs.py``) against
the JAX package on the CPU.

Variants: reduced fedlm-100m and reduced qwen3-1.7b (qk-norm, a 64-token
sliding window with a ring cache; a 96-token prompt wraps it), each also
with grouped KV heads (``n_kv_heads=2``; ``reduced()`` leaves 4/4), and
one stacked-layer variant (``scan_layers=True``: stacked caches). The
reference's parameters cross over through ``models/convert.py:
params_from_numpy``; the prompts are the reference's ``make_batch`` draws,
which the port's ``make_batch`` reproduces bit for bit.

* Prefill logits, caches and three decode steps, from parameters with
  their norm weights moved off zero: logits within rtol = atol = 1e-5,
  cache keys and values within 1e-5, slot positions and lengths equal
  (float32 throughout; the port's einsums sum in another order).
* ``generate``'s greedy tokens equal the reference's ``generate`` tokens.
* Prefill of ``tokens[:-1]`` plus one decode step equals ``forward``'s
  last two logits (``tests/test_arch_smoke.py:86``), within 1e-4.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.launch import input_specs, serve
from repro_torch.models import build_model
from repro_torch.models.convert import params_from_numpy

#: name -> (arch, config changes on reduced(), prompt length)
VARIANTS = {
    "fedlm": ("fedlm-100m", {}, 16),
    "fedlm-gqa": ("fedlm-100m", dict(n_kv_heads=2), 16),
    "fedlm-gqa-stacked": ("fedlm-100m", dict(n_kv_heads=2, scan_layers=True),
                          16),
    "qwen3": ("qwen3-1.7b", {}, 96),
    "qwen3-gqa": ("qwen3-1.7b", dict(n_kv_heads=2), 96),
}
B, GEN = 2, 6
TOL = dict(rtol=1e-5, atol=1e-5)


def _jax():
    import jax

    jax.config.update("jax_enable_x64", True)
    return jax


def _configs(name):
    from repro.configs import get_config as jget

    arch, changes, prompt = VARIANTS[name]
    return (dataclasses.replace(jget(arch).reduced(), **changes),
            dataclasses.replace(get_config(arch).reduced(), **changes),
            prompt)


def _np_tree(jax, tree):
    return jax.tree.map(np.asarray, tree)


def _caches(caches, stacked):
    """(k, v, pos, lengths) per layer as numpy, from either package."""
    if stacked:
        n = np.asarray(caches.k).shape[0]
        lengths = np.broadcast_to(np.asarray(caches.length), (n,))
        return [(np.asarray(caches.k)[i], np.asarray(caches.v)[i],
                 np.asarray(caches.pos)[i], int(lengths[i]))
                for i in range(n)]
    return [(np.asarray(c.k), np.asarray(c.v), np.asarray(c.pos),
             int(np.asarray(c.length))) for c in caches]


def _same_caches(got, want, stacked):
    for (gk, gv, gp, gl), (wk, wv, wp, wl) in zip(_caches(got, stacked),
                                                  _caches(want, stacked)):
        np.testing.assert_allclose(gk, wk, **TOL)
        np.testing.assert_allclose(gv, wv, **TOL)
        np.testing.assert_array_equal(gp, wp)
        assert gl == wl


def test_make_batch_draws_the_reference_tokens():
    _jax()
    from repro.launch import input_specs as jspecs

    for name in ("fedlm", "qwen3"):
        jcfg, cfg, prompt = _configs(name)
        want = jspecs.make_batch(jcfg, 3, prompt, key=7)["tokens"]
        got = input_specs.make_batch(cfg, 3, prompt, key=7)["tokens"]
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("name", list(VARIANTS))
def test_prefill_caches_and_decode_match_jax(name):
    jax = _jax()
    from repro.launch import input_specs as jspecs
    from repro.models import build_model as jbuild

    jcfg, cfg, prompt = _configs(name)
    jm, model = jbuild(jcfg), build_model(cfg)
    jp = jm.init(jax.random.key(0))
    noise = jax.random.key(1)
    jp = jax.tree.map(
        lambda a: a + 0.01 * jax.random.normal(noise, a.shape, a.dtype), jp)
    params = params_from_numpy(_np_tree(jax, jp))
    batch = jspecs.make_batch(jcfg, B, prompt, key=1)
    total = prompt + 3
    jlog, jc = jax.jit(jm.prefill)(jp, batch, jm.init_caches(B, total))
    with torch.no_grad():
        tb = {"tokens": torch.from_numpy(np.array(batch["tokens"]))}
        log, caches = model.prefill(params, tb, model.init_caches(B, total))
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
        np.testing.assert_allclose(log.numpy(), np.asarray(jlog), **TOL)
        _same_caches(caches, jc, cfg.scan_layers)
        tok = np.asarray(jax.numpy.argmax(jlog, axis=-1)).astype(np.int32)


@pytest.mark.parametrize("name", list(VARIANTS))
def test_greedy_generate_emits_the_reference_tokens(name, monkeypatch):
    """The reference's ``generate`` (its own init from seed 0 and its
    prompt from seed 1) against the port's loop on the same weights."""
    jax = _jax()
    from repro.launch import serve as jserve
    from repro.models import build_model as jbuild

    jcfg, cfg, prompt = _configs(name)
    monkeypatch.setattr(jserve, "get_config", lambda arch: jcfg)
    want = jserve.generate(name, prompt_len=prompt, gen_len=GEN, batch=B,
                           reduced=False)
    params = params_from_numpy(_np_tree(jax, jbuild(jcfg).init(
        jax.random.key(0))))
    batch = input_specs.make_batch(cfg, B, prompt, key=1)
    got = serve.generate_tokens(build_model(cfg), params, batch, gen_len=GEN)
    assert got.dtype == torch.int32 and tuple(got.shape) == (B, GEN)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("name", ["fedlm-gqa-stacked", "qwen3-gqa"])
def test_prefill_plus_decode_equals_forward(name):
    """prefill(tokens[:-1]) + decode(last token) == forward's last logits."""
    _, cfg, prompt = _configs(name)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    tokens = input_specs.make_batch(cfg, B, prompt, key=3)["tokens"]
    with torch.no_grad():
        full = model.forward(params, {"tokens": tokens})
        pre, caches = model.prefill(params, {"tokens": tokens[:, :-1]},
                                    model.init_caches(B, prompt))
        dec, _ = model.decode_step(params, tokens[:, -1:], caches)
    np.testing.assert_allclose(pre[:, 0].numpy(), full[:, -2].numpy(),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(dec[:, 0].numpy(), full[:, -1].numpy(),
                               rtol=1e-4, atol=1e-4)


def test_use_pallas_forward_matches_and_refuses_training():
    _, cfg, prompt = _configs("qwen3-gqa")
    flash = dataclasses.replace(cfg, use_pallas_attention=True)
    params = build_model(cfg).init(torch.Generator().manual_seed(0))
    tokens = input_specs.make_batch(cfg, B, prompt, key=3)["tokens"]
    with torch.no_grad():
        want = build_model(cfg).forward(params, {"tokens": tokens})
        got = build_model(flash).forward(params, {"tokens": tokens})
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-4)
    with pytest.raises(NotImplementedError, match="backward"):
        torch.func.grad(build_model(flash).loss)(params, {"tokens": tokens})


def test_cli_runs_on_cpu_and_needs_a_card_otherwise(capsys):
    serve.main(["--arch", "fedlm-100m", "--prompt-len", "32", "--gen-len",
                "8", "--batch", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "generated token ids:" in out
    sampled = serve.generate("qwen3-1.7b", prompt_len=8, gen_len=4,
                             greedy=False, device="cpu")
    assert tuple(sampled.shape) == (2, 4)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            serve.main(["--arch", "fedlm-100m", "--gen-len", "2"])


@pytest.mark.parametrize("arch", ["fedlm-100m", "mamba2-130m",
                                  "granite-moe-3b-a800m", "llava-next-34b",
                                  "zamba2-1.2b", "whisper-small"],
                         ids=["dense", "ssm", "moe", "vlm", "hybrid",
                              "audio"])
def test_every_family_builds_batches_and_generates(arch):
    """``build_model`` and ``make_batch`` for one arch of each family at
    ``reduced()``, the batch holding the family's inputs (image
    embeddings for vlm, encoder frames for audio), and ``generate`` on
    the CPU emitting int32 tokens."""
    cfg = get_config(arch).reduced()
    model = build_model(cfg)
    assert type(model).__name__ == {
        "dense": "TransformerLM", "moe": "TransformerLM",
        "vlm": "TransformerLM", "ssm": "Mamba2LM", "hybrid": "HybridLM",
        "audio": "EncDecLM"}[cfg.family]
    batch = input_specs.make_batch(cfg, 2, 8, key=1)
    extra = {"vlm": {"image_embeds": (2, cfg.n_modal_tokens, cfg.d_model)},
             "audio": {"frames": (2, cfg.encoder_len, cfg.d_model)}}.get(
                 cfg.family, {})
    assert {k: tuple(v.shape) for k, v in batch.items()} == {
        "tokens": (2, 8), **extra}
    assert batch["tokens"].dtype == torch.int32
    assert all(batch[k].dtype == torch.float32 for k in extra)
    out = serve.generate(arch, prompt_len=8, gen_len=3, device="cpu")
    assert tuple(out.shape) == (2, 3) and out.dtype == torch.int32
