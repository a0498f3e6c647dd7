"""The port's FedCET rounds on the reduced fedlm-100m against the JAX
package's, and the port's training entry point end to end on the CPU.

Both packages start from the same JAX-initialized parameters (carried
across by ``params_from_numpy``) and consume the same JAX-sampled tokens
(the port's own sampler draws from torch generators and cannot reproduce
JAX's draws). Three rounds of 4 clients, batch 2, seq 32, tau 2.

Tolerances, per leaf: ``x`` within 1e-5 of the leaf's largest magnitude.
``d = c (v - mean v)`` is a difference of nearly equal client vectors, so
its rounding error scales with ``x``, not with ``d``: it is held within
1e-5 * c * max|x|. The logged loss agrees within 1e-6 relative. float64
parameters run through the model's float32 casts (RMSNorm, RoPE, logits),
so float64 is held to the same bounds.
"""

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.fedcet import FedCET
from repro_torch.launch.train import main, run_training
from repro_torch.models import build_model
from repro_torch.models.convert import params_from_numpy
from repro_torch.utils.tree import tree_leaves

C, B, S, TAU, ROUNDS = 4, 2, 32, 2, 3
ALPHA, CW = 3e-3, 0.05


def _jax_run(dtype):
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_enable_x64", True)
    from repro.configs import get_config as jget
    from repro.core.fedcet import FedCET as JFedCET
    from repro.data.synthetic import make_hetero_lm_dataset
    from repro.models import build_model as jbuild

    cfg = jget("fedlm-100m").reduced().with_dtype(dtype)
    model = jbuild(cfg)
    params = model.init(jax.random.key(0))
    ds = make_hetero_lm_dataset(cfg.vocab_size, C, S, B, seed=0)
    tokens = [np.asarray(ds.sample_round(r, TAU)) for r in range(ROUNDS)]
    algo = JFedCET(alpha=ALPHA, c=CW, tau=TAU, n_clients=C)
    grad_fn = jax.grad(model.loss)
    state = jax.jit(lambda p, b: algo.init(grad_fn, p, b))(
        params, {"tokens": tokens[0][0]})
    step = jax.jit(lambda s, b: algo.round(grad_fn, s, b))
    mean_loss = jax.jit(lambda x, t: jnp.mean(jax.vmap(model.loss)(
        x, {"tokens": t})))
    losses = []
    for r in range(ROUNDS):
        state = step(state, {"tokens": tokens[r]})
        losses.append(float(mean_loss(state.x, tokens[r][0])))
    to_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return to_np(params), tokens, to_np(state.x), to_np(state.d), losses


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_three_rounds_match_jax(dtype):
    params, tokens, jx, jd, jlosses = _jax_run(dtype)
    model = build_model(get_config("fedlm-100m").reduced().with_dtype(dtype))
    algo = FedCET(alpha=ALPHA, c=CW, tau=TAU, n_clients=C)
    grad_fn = torch.func.grad(model.loss)
    state = algo.init(grad_fn, params_from_numpy(params),
                      {"tokens": torch.tensor(tokens[0][0])})
    losses = []
    for r in range(ROUNDS):
        b = {"tokens": torch.tensor(tokens[r])}
        state = algo.round(grad_fn, state, b)
        losses.append(float(torch.mean(torch.func.vmap(model.loss)(
            state.x, {"tokens": b["tokens"][0]}))))
    assert state.t == ROUNDS * TAU  # init leaves t = 0
    import jax

    for got_x, want_x, got_d, want_d in zip(
            tree_leaves(state.x), jax.tree.leaves(jx),
            tree_leaves(state.d), jax.tree.leaves(jd)):
        scale = float(np.abs(want_x).max())
        np.testing.assert_allclose(got_x.numpy(), want_x, rtol=1e-5,
                                   atol=1e-5 * scale)
        np.testing.assert_allclose(got_d.numpy(), want_d, rtol=0,
                                   atol=1e-5 * CW * scale)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-6)


def test_run_training_end_to_end_on_cpu(capsys):
    seen = []
    hist = run_training("fedlm-100m", steps=2, n_clients=2, batch=2,
                        seq_len=16, device="cpu", log_every=1,
                        callback=lambda r, loss, comm, st: seen.append(st.t))
    out = capsys.readouterr().out
    assert hist["round"] == [0, 1] and len(hist["loss"]) == 2
    assert all(np.isfinite(hist["loss"]))
    assert "round     1  loss" in out and "bits_up" in out
    assert seen == [2, 4]  # t = 0 after init, +tau per round
    n_params = sum(t.numel() for t in tree_leaves(build_model(
        get_config("fedlm-100m").reduced()).init(torch.Generator())))
    assert hist["comm_bytes"][0] == 2 * 2 * n_params * 4  # up + down, f32


def test_entry_points_refuse_what_this_slice_does_not_run():
    with pytest.raises(NotImplementedError, match="not yet ported"):
        run_training("fedlm-100m", steps=1, device="cpu",
                     compression="shift:q8")
    with pytest.raises(NotImplementedError, match="not yet ported"):
        FedCET(alpha=ALPHA, c=CW, tau=TAU, n_clients=C, arena=True)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            run_training("fedlm-100m", steps=1)


def test_cli_runs_on_cpu_and_refuses_scenarios(capsys):
    main(["--arch", "fedlm-100m", "--steps", "1", "--clients", "2",
          "--batch", "1", "--seq-len", "8", "--device", "cpu"])
    assert "final loss:" in capsys.readouterr().out
    with pytest.raises(NotImplementedError, match="participation"):
        main(["--arch", "fedlm-100m", "--device", "cpu",
              "--participation", "0.5"])
