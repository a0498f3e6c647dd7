"""The port's ``FedTrainer`` and checkpoints against the JAX package's on
the reduced fedlm-100m (3 clients, batch 2, seq 32, tau 2), on the CPU,
from the same JAX weights and tokens (carried across as numpy).

* The trainer's history against the reference's ``FedTrainer`` (FedCET
  and SCAFFOLD, 4 rounds, eval every 2): the same rounds and
  ``comm_bytes``, losses within 1e-5 relative and the heterogeneity gap
  within 1e-4 (the model's float32 internals, ``tests/test_torch_train.py``).
* A JAX-written parameter checkpoint loads into the port (leaves numbered
  in JAX's sorted-key order, restored into the port's own key order), and
  3 FedCET rounds from it match the reference's within
  ``tests/test_torch_train.py``'s bounds (x within 1e-5 of each leaf's
  scale, d within 1e-5 * c * scale).
"""

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import load_pytree
from repro_torch.configs import get_config
from repro_torch.core import FedCET
from repro_torch.fed import FedTrainer, TrainerConfig
from repro_torch.models import build_model
from repro_torch.models.convert import params_from_numpy

N_CLIENTS, TAU, B, S = 3, 2, 2, 32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The reduced LM's matmuls on one intra-op thread: the suite runs
    several workers on few cores, and oversubscribed threads slow these
    tests many times over (the results do not depend on it)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax():
    import jax

    jax.config.update("jax_enable_x64", True)
    return jax


def _jax_lm(dtype="float32"):
    jax = _jax()
    from repro.configs import get_config as jget
    from repro.data.synthetic import make_hetero_lm_dataset as jds
    from repro.models import build_model as jbuild

    cfg = jget("fedlm-100m").reduced().with_dtype(dtype)
    model = jbuild(cfg)
    params = model.init(jax.random.key(0))
    ds = jds(cfg.vocab_size, N_CLIENTS, S, B, seed=1)
    tokens = [np.asarray(ds.sample_round(r, TAU)) for r in range(4)]
    return model, params, tokens


@pytest.mark.parametrize("name", ["fedcet", "scaffold"])
def test_trainer_history_matches_jax(name):
    jax = _jax()
    import repro.core as J
    from repro.fed import FedTrainer as JTrainer
    from repro.fed import TrainerConfig as JConfig

    jmodel, jparams, tokens = _jax_lm()
    make = {"fedcet": lambda m: m.FedCET(alpha=3e-3, c=0.05, tau=TAU,
                                         n_clients=N_CLIENTS),
            "scaffold": lambda m: m.Scaffold(alpha_l=3e-3, tau=TAU,
                                             n_clients=N_CLIENTS)}[name]
    jt = JTrainer(make(J), jmodel.loss, JConfig(rounds=4, eval_every=2))
    jb = lambda r: {"tokens": jax.numpy.asarray(tokens[r])}  # noqa: E731
    jt.fit(jt.init_state(jparams, {"tokens": tokens[0][0]}), jb)

    import repro_torch.core as P

    model = build_model(get_config("fedlm-100m").reduced())
    params = params_from_numpy(jax.tree.map(np.asarray, jparams))
    t = FedTrainer(make(P), model.loss, TrainerConfig(rounds=4, eval_every=2),
                   device="cpu")
    pb = lambda r: {"tokens": torch.tensor(tokens[r])}  # noqa: E731
    t.fit(t.init_state(params, {"tokens": torch.tensor(tokens[0][0])}), pb)
    assert [h["round"] for h in t.history] == [h["round"]
                                                 for h in jt.history]
    for got, want in zip(t.history, jt.history):
        assert got["comm_bytes"] == want["comm_bytes"]
        for k in ("loss_global", "loss_local_mean"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5)
        np.testing.assert_allclose(got["heterogeneity_gap"],
                                   want["heterogeneity_gap"], rtol=0,
                                   atol=1e-4)


def test_reference_lm_checkpoint_resumes_in_the_port(tmp_path):
    jax = _jax()
    import jax.numpy as jnp

    import repro.core as J
    from repro.checkpoint.ckpt import save_pytree as jsave

    jmodel, jparams, tokens = _jax_lm()
    path = str(tmp_path / "params.npz")
    jsave(path, jparams)
    jalgo = J.FedCET(alpha=3e-3, c=0.05, tau=TAU, n_clients=N_CLIENTS)
    jgrad = jax.grad(jmodel.loss)
    js = jalgo.init(jgrad, jparams, {"tokens": jnp.asarray(tokens[0][0])})
    step = jax.jit(lambda s, b: jalgo.round(jgrad, s, b))
    for r in range(3):
        js = step(js, {"tokens": jnp.asarray(tokens[r])})

    model = build_model(get_config("fedlm-100m").reduced())
    like = model.init(torch.Generator().manual_seed(5))
    params = load_pytree(path, like)
    assert list(params) == list(like)  # the port's own key order kept
    algo = FedCET(alpha=3e-3, c=0.05, tau=TAU, n_clients=N_CLIENTS)
    grad = torch.func.grad(model.loss)
    state = algo.init(grad, params, {"tokens": torch.tensor(tokens[0][0])})
    for r in range(3):
        state = algo.round(grad, state, {"tokens": torch.tensor(tokens[r])})
    assert state.t == 3 * TAU == int(js.t)
    jx, jd = jax.tree.map(np.asarray, js.x), jax.tree.map(np.asarray, js.d)
    from repro_torch.checkpoint.ckpt import _flatten

    # the port's leaves in JAX's order, beside the reference's.
    for got_x, want_x, got_d, want_d in zip(
            _flatten(state.x), jax.tree.leaves(jx), _flatten(state.d),
            jax.tree.leaves(jd)):
        scale = float(np.abs(want_x).max())
        np.testing.assert_allclose(got_x.numpy(), want_x, rtol=1e-5,
                                   atol=1e-5 * scale)
        np.testing.assert_allclose(got_d.numpy(), want_d, rtol=0,
                                   atol=1e-5 * 0.05 * scale)
