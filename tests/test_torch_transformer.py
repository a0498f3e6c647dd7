"""The port's dense transformer against the JAX package's on the reduced
fedlm-100m: the same JAX-initialized parameters (through
``params_from_numpy``, norm weights moved off zero so RMSNorm's scale is
exercised), the same numpy tokens, loss and per-leaf gradients compared.

Both layer layouts: a list of per-layer dicts (``reduced()``'s
``scan_layers=False``) and stacked ``[L, ...]`` leaves (``scan_layers=True``,
the full config's layout), the latter also with grouped KV heads (2 KV
heads for 4 query heads). Tolerances: loss within 1e-6 relative; each
gradient leaf within rtol 1e-5 plus 1e-5 of the leaf's largest magnitude.
float64 is held to the same bounds: the reference (and so the port)
computes RMSNorm, RoPE, the attention softmax and the logits in float32
whatever the parameter dtype, and those float32 steps bound the agreement
(measured: ~2e-6 of the leaf scale in both dtypes).
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.models.convert import params_from_numpy
from repro_torch.utils.tree import tree_leaves

LAYOUTS = {
    "list": dict(scan_layers=False),
    "stacked": dict(scan_layers=True),
    "stacked-gqa": dict(scan_layers=True, n_kv_heads=2),
}


def _reference(layout, dtype, tokens):
    import jax

    jax.config.update("jax_enable_x64", True)
    from repro.configs import get_config as jget
    from repro.models import build_model as jbuild

    cfg = dataclasses.replace(jget("fedlm-100m").reduced(),
                              **LAYOUTS[layout]).with_dtype(dtype)
    model = jbuild(cfg)
    params = model.init(jax.random.key(0))
    noise = jax.random.key(1)
    params = jax.tree.map(
        lambda a: a + 0.01 * jax.random.normal(noise, a.shape, a.dtype),
        params)
    loss, grads = jax.jit(jax.value_and_grad(model.loss))(
        params, {"tokens": tokens})
    to_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return to_np(params), float(loss), jax.tree.leaves(to_np(grads))


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_loss_and_grads_match_jax(layout, dtype):
    cfg = dataclasses.replace(get_config("fedlm-100m").reduced(),
                              **LAYOUTS[layout]).with_dtype(dtype)
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 32)).astype(np.int32)
    params, jloss, jgrads = _reference(layout, dtype, tokens)
    model = build_model(cfg)
    grads, loss = torch.func.grad_and_value(model.loss)(
        params_from_numpy(params), {"tokens": torch.tensor(tokens)})
    assert loss.dtype == torch.float32
    np.testing.assert_allclose(float(loss), jloss, rtol=1e-6)
    got = tree_leaves(grads)
    assert len(got) == len(jgrads)
    for g, want in zip(got, jgrads):
        assert g.dtype == getattr(torch, dtype)
        np.testing.assert_allclose(g.numpy(), want, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(want).max()))


def test_forward_logits_match_jax():
    import jax

    jax.config.update("jax_enable_x64", True)
    from repro.configs import get_config as jget
    from repro.models import build_model as jbuild

    jmodel = jbuild(jget("fedlm-100m").reduced())
    params = jax.tree.map(np.asarray, jmodel.init(jax.random.key(2)))
    tokens = np.random.default_rng(1).integers(0, 512, (2, 16)).astype(
        np.int32)
    want = np.asarray(jmodel.forward(params, {"tokens": tokens}))
    got = build_model(get_config("fedlm-100m").reduced()).forward(
        params_from_numpy(params), {"tokens": torch.tensor(tokens)})
    assert tuple(got.shape) == (2, 16, 512)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))


def test_full_config_geometry_and_own_init():
    cfg = get_config("fedlm-100m")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.head_dim, cfg.d_ff, cfg.vocab_size) == (14, 640, 10, 5, 64,
                                                        2560, 16384)
    small = dataclasses.replace(cfg, n_layers=2)  # full width, 2 layers
    params = build_model(small).init(torch.Generator().manual_seed(0))
    assert tuple(params["layers"]["mlp"]["gate"].shape) == (2, 640, 2560)
    assert tuple(params["lm_head"].shape) == (640, 16384)
    assert params["lm_head"].is_contiguous()
    per_layer = 4 * 640 * 640 // 2 + 640 * 640 + 3 * 640 * 2560 + 2 * 640
    assert sum(t.numel() for t in tree_leaves(params)) == (
        2 * per_layer + 2 * 16384 * 640 + 640)
    # 14 layers: ~107.0 M parameters
    assert 14 * per_layer + 2 * 16384 * 640 + 640 == 107_006_080
