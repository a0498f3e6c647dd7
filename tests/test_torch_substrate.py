"""The port's substrate against the JAX package's, on the CPU: the
optimizers and schedules (``optim/``) and the checkpoints
(``checkpoint/ckpt.py``).

* Mirrors of ``tests/test_substrate.py``: SGD, momentum SGD and Adam
  minimize a quadratic, the WSD schedule's shape, a tree round trip,
  round-robin retention, and the hypothesis round trip of FedCET states
  (``max_examples=10``).
* The optimizers' iterates (float32) and the schedules' values equal the
  reference's within 1e-6 relative.
* Checkpoints cross between the packages in both directions. A file the
  reference writes (FedCET and SCAFFOLD states on the quadratic, a
  ``shift:q8`` + arena ``EngineState``) loads into the port, and 30 more
  rounds match the reference's own continuation within 1e-12 (float64),
  the step counter included. A file the port writes loads in the
  reference's ``load_pytree`` with every leaf bitwise equal, numbered in
  JAX's flatten order (dicts by sorted key): the port's own insertion
  order (``TransformerLM.init``: embed, layers, final_norm, lm_head)
  never reaches ``leaf_i``.
"""

import os

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro_torch.checkpoint import (all_steps, latest_step, load_pytree,
                                    restore, save, save_pytree)
from repro_torch.core import FedCET, Scaffold, max_weight_c
from repro_torch.core.arena import Arena
from repro_torch.core.engine import (EngineState, run_rounds, with_arena,
                                     with_compression)
from repro_torch.core.lr_search import lr_search
from repro_torch.core.simulate import simulate_quadratic
from repro_torch.data.quadratic import QuadraticProblem, make_quadratic_problem
from repro_torch.optim import Adam, Sgd, constant, cosine, wsd
from repro_torch.utils.tree import tree_leaves, tree_map


def _jax():
    import jax

    jax.config.update("jax_enable_x64", True)
    return jax


# ------------------------------------------------------------- optimizers
def test_sgd_and_adam_minimize_quadratic():
    target = torch.tensor([1.0, -2.0, 3.0])

    def loss(p):
        return torch.sum((p["w"] - target) ** 2)

    for opt, lr, steps in ((Sgd(), 0.1, 200), (Sgd(momentum=0.9), 0.02, 200),
                           (Adam(), 0.05, 400)):
        params = {"w": torch.zeros(3)}
        state = opt.init(params)
        for _ in range(steps):
            g = torch.func.grad(loss)(params)
            params, state = opt.update(g, state, params, lr)
        assert float(loss(params)) < 1e-3, (opt, float(loss(params)))


@pytest.mark.parametrize("name", ["sgd", "momentum", "adam", "adam_wd"])
def test_optimizer_iterates_match_jax(name):
    jax = _jax()
    import jax.numpy as jnp

    import repro.optim as J

    make = {"sgd": lambda m: m.Sgd(), "momentum": lambda m: m.Sgd(momentum=0.9),
            "adam": lambda m: m.Adam(),
            "adam_wd": lambda m: m.Adam(weight_decay=0.1)}[name]
    rng = np.random.default_rng(3)
    p0 = {"a": rng.standard_normal((4, 5)).astype(np.float32),
          "b": rng.standard_normal(7).astype(np.float32)}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32)
              for k, v in p0.items()} for _ in range(5)]
    jopt, opt = make(J), make(__import__("repro_torch.optim").optim)
    jp, js = {k: jnp.asarray(v) for k, v in p0.items()}, None
    js = jopt.init(jp)
    p = {k: torch.tensor(v) for k, v in p0.items()}
    s = opt.init(p)
    for i, g in enumerate(grads):
        jp, js = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, js,
                             jp, 0.01 * (i + 1))
        p, s = opt.update({k: torch.tensor(v) for k, v in g.items()}, s, p,
                          0.01 * (i + 1))
    for k in p0:
        assert p[k].dtype == torch.float32
        np.testing.assert_allclose(p[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-7)
    if name.startswith("adam"):
        assert int(s["t"]) == int(js["t"]) == 5
        assert s["t"].dtype == torch.int32
    del jax


def test_wsd_schedule_shape():
    f = wsd(1.0, 1000, warmup_frac=0.02, decay_frac=0.2)
    assert float(f(0)) == 0.0
    assert float(f(20)) == pytest.approx(1.0)       # end of warmup
    assert float(f(500)) == pytest.approx(1.0)      # stable plateau
    assert float(f(800)) == pytest.approx(1.0)      # decay starts after 800
    assert float(f(900)) < 0.2                      # mid-decay
    assert float(f(1000)) == pytest.approx(0.01, rel=1e-3)


def test_schedules_match_jax():
    _jax()
    import repro.optim as J

    pairs = [(constant(3e-4), J.constant(3e-4)),
             (cosine(1e-3, 500, warmup=20), J.cosine(1e-3, 500, warmup=20)),
             (wsd(2e-3, 1000), J.wsd(2e-3, 1000)),
             (wsd(1.0, 1000, warmup_frac=0.02, decay_frac=0.2),
              J.wsd(1.0, 1000, warmup_frac=0.02, decay_frac=0.2))]
    for f, jf in pairs:
        for step in (0, 1, 7, 20, 21, 250, 499, 500, 800, 901, 1000, 1200):
            got = f(step)
            assert got.dtype == torch.float32
            np.testing.assert_allclose(float(got), float(jf(step)),
                                       rtol=1e-6, atol=0)


# ------------------------------------------------------------ checkpoints
def test_pytree_roundtrip(tmp_path):
    tree = {
        "a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
        "nested": {"b": torch.ones((4,), dtype=torch.int32),
                   "c": [torch.zeros(2), torch.ones(1)]},
    }
    p = str(tmp_path / "ck.npz")
    save_pytree(p, tree)
    back = load_pytree(p, tree)
    assert list(back) == ["a", "nested"] and list(back["nested"]) == ["b", "c"]
    for x, y in zip(tree_leaves(tree), tree_leaves(back)):
        assert torch.equal(x, y) and x.dtype == y.dtype


def test_round_robin_retention(tmp_path):
    d = str(tmp_path / "ckpts")
    tree = {"w": torch.zeros(2)}
    for s in range(6):
        save(d, s, tree, keep=3)
    assert all_steps(d) == [3, 4, 5] and latest_step(d) == 5
    got, step = restore(d, tree)
    assert step == 5
    assert restore(str(tmp_path / "none"), tree) == (None, None)


def test_load_refuses_another_layout(tmp_path):
    p = str(tmp_path / "ck.npz")
    save_pytree(p, {"a": torch.zeros(3), "b": torch.zeros(2)})
    with pytest.raises(ValueError, match="leaf 0 has shape"):
        load_pytree(p, {"a": torch.zeros(2), "b": torch.zeros(3)})
    with pytest.raises(ValueError, match="holds 2 leaves"):
        load_pytree(p, {"a": torch.zeros(3)})


@settings(max_examples=10, deadline=None)
@given(seed=st.integers(0, 1000))
def test_property_fedcet_state_roundtrip(tmp_path_factory, seed):
    """Algorithm states (what a run checkpoints) survive exactly, the step
    counter as an int."""
    p = make_quadratic_problem(seed, n_clients=3, dim=8)
    algo = FedCET(alpha=0.01, c=0.3, tau=2, n_clients=3)
    res = simulate_quadratic(algo, p, rounds=3, device="cpu")
    path = str(tmp_path_factory.mktemp("ck") / "state.npz")
    save_pytree(path, res.state)
    back = load_pytree(path, res.state)
    assert type(back) is type(res.state) and back.t == res.state.t == 6
    assert isinstance(back.t, int)
    for x, y in zip(tree_leaves(res.state), tree_leaves(back)):
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y) and x.dtype == y.dtype


# ------------------------------------------------ across the two packages
N_BEFORE, N_AFTER = 20, 30


def _quadratic_pair():
    _jax()
    from repro.data.quadratic import make_quadratic_problem as jmake

    jp = jmake(0)
    return jp, QuadraticProblem(b=torch.tensor(np.asarray(jp.b)),
                                m=torch.tensor(np.asarray(jp.m)))


def _algos(kind, jp):
    import repro.core as J

    alpha = lr_search(jp.mu, jp.L, 2)
    c = max_weight_c(jp.mu, alpha)
    if kind == "fedcet":
        return (J.FedCET(alpha=alpha, c=c, tau=2, n_clients=10),
                FedCET(alpha=alpha, c=c, tau=2, n_clients=10))
    if kind == "scaffold":
        kw = dict(alpha_l=1.0 / (81 * 2 * jp.L), tau=2, n_clients=10)
        return J.Scaffold(**kw), Scaffold(**kw)
    return (J.with_compression(J.with_arena(
                J.FedCET(alpha=alpha, c=c, tau=2, n_clients=10)),
                compressor="shift:q8"),
            with_compression(with_arena(
                FedCET(alpha=alpha, c=c, tau=2, n_clients=10)),
                compressor="shift:q8"))


def _port_state0(algo, port):
    batches = port.stacked_batches(algo.tau)
    return algo.init(torch.func.grad(port.client_loss),
                     torch.zeros(port.dim, dtype=torch.float64),
                     tree_map(lambda b: b[0], batches))


@pytest.mark.parametrize("kind", ["fedcet", "scaffold", "fedcet_shift_q8_arena"])
def test_reference_checkpoint_resumes_in_the_port(tmp_path, kind):
    jax = _jax()
    import jax.numpy as jnp

    from repro.checkpoint.ckpt import save as jsave
    from repro.core.engine import run_rounds as jrun

    jp, port = _quadratic_pair()
    jalgo, algo = _algos(kind, jp)
    jgrad = jax.grad(jp.client_loss)
    jb = jp.stacked_batches(2)
    js = jalgo.init(jgrad, jnp.zeros(jp.dim), jax.tree.map(lambda b: b[0], jb))
    js, _ = jrun(jalgo, jgrad, js, jb, rounds=N_BEFORE)
    jsave(str(tmp_path), N_BEFORE, js)
    jerr = lambda s: jnp.linalg.norm(  # noqa: E731
        jalgo.global_params(s) - jp.x_star)
    js_end, jcurve = jrun(jalgo, jgrad, js, jb, rounds=N_AFTER,
                          metric_fn=jerr)

    like = _port_state0(algo, port)
    state, step = restore(str(tmp_path), like)
    assert step == N_BEFORE
    inner = state.inner if isinstance(state, EngineState) else state
    assert isinstance(inner.t, int) and inner.t == int(
        (js.inner if hasattr(js, "extras") else js).t)
    if kind.endswith("arena"):
        assert isinstance(inner.x, Arena) and isinstance(state.extras[0],
                                                         Arena)
    grad = torch.func.grad(port.client_loss)
    x_star = port.x_star
    end, curve = run_rounds(algo, grad, state, port.stacked_batches(2),
                            rounds=N_AFTER,
                            metric_fn=lambda s: torch.linalg.norm(
                                algo.global_params(s) - x_star))
    np.testing.assert_allclose(curve.numpy(), np.asarray(jcurve), rtol=0,
                               atol=1e-12)
    jleaves = jax.tree.leaves(js_end)
    from repro_torch.checkpoint.ckpt import _flatten

    leaves = _flatten(end)
    assert len(leaves) == len(jleaves)
    for got, want in zip(leaves, jleaves):
        if isinstance(got, int):
            assert got == int(want)
        else:
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=0, atol=1e-12)


def test_port_checkpoint_loads_in_the_reference(tmp_path):
    """A port-written ``shift:q8`` + arena state after 5 rounds, and the
    port's reduced fedlm-100m parameters, load bitwise in the reference's
    ``load_pytree``."""
    jax = _jax()
    import jax.numpy as jnp

    from repro.checkpoint.ckpt import load_pytree as jload
    from repro.configs import get_config as jget
    from repro.models import build_model as jbuild

    from repro_torch.checkpoint.ckpt import _flatten
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    jp, port = _quadratic_pair()
    jalgo, algo = _algos("fedcet_shift_q8_arena", jp)
    state, _ = run_rounds(algo, torch.func.grad(port.client_loss),
                          _port_state0(algo, port), port.stacked_batches(2),
                          rounds=5)
    path = str(tmp_path / "state.npz")
    save_pytree(path, state)
    jlike = jalgo.init(jax.grad(jp.client_loss), jnp.zeros(jp.dim),
                       jax.tree.map(lambda b: b[0], jp.stacked_batches(2)))
    back = jload(path, jlike)
    assert type(back).__name__ == "EngineState"
    for got, want in zip(jax.tree.leaves(back), _flatten(state)):
        if isinstance(want, int):
            assert int(got) == want == 10
        else:
            assert np.array_equal(np.asarray(got), want.numpy())

    params = build_model(get_config("fedlm-100m").reduced()).init(
        torch.Generator().manual_seed(0))
    assert list(params)[:2] == ["embed", "layers"]  # not JAX's order
    path = str(tmp_path / "params.npz")
    save_pytree(path, params)
    jparams = jbuild(jget("fedlm-100m").reduced()).init(jax.random.key(0))
    back = jload(path, jparams)
    flat, _ = jax.tree_util.tree_flatten_with_path(back)
    for kp, leaf in flat:
        t = params
        for k in kp:
            t = t[k.key] if hasattr(k, "key") else t[k.idx]
        assert np.array_equal(np.asarray(leaf), t.numpy()), kp
    with np.load(path) as z:
        assert sorted(z.files) == sorted(
            [f"leaf_{i}" for i in range(len(flat))] + ["treedef"])
    assert os.path.exists(path)
