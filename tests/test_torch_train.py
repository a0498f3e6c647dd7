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

One round over a gossip graph (``ring:sparse`` on the arena,
4 clients) is held to the same bounds: the sparse neighbor reduce runs
through ``kernels/ops.py:gossip_reduce`` (its plain version here).

The compressed round (``shift:q8`` x 0.8 participation) runs on a tiny LM
(as ``tests/test_arena.py:200-238``): the arena against the per-leaf path
inside the port, and the port against the JAX package for 3 rounds. Both
packages draw the same masks and dithers (``core/prng.py``), but the
model's float32 internals make ``v`` differ by ~1e-7 of scale even with
float64 parameters, and where ``(v - h)/s + u`` lands that close to an
integer, a quantizer code moves by exactly one step. Such a flip shifts
``d`` by ``c*s`` and ``h`` by ``s`` for that coordinate. The test counts
the coordinates outside the tight bounds above and holds their share below
1e-3 (measured: none in 3 rounds), rather than loosening the bounds.
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


def _jax_run(dtype, rounds=ROUNDS, **scenario):
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_enable_x64", True)
    from repro.configs import get_config as jget
    from repro.configs.base import FedScenario as JScenario
    from repro.core.arena import Arena as JArena
    from repro.core.arena import unpack as junpack
    from repro.core.fedcet import FedCET as JFedCET
    from repro.data.synthetic import make_hetero_lm_dataset
    from repro.models import build_model as jbuild

    cfg = jget("fedlm-100m").reduced().with_dtype(dtype)
    model = jbuild(cfg)
    params = model.init(jax.random.key(0))
    ds = make_hetero_lm_dataset(cfg.vocab_size, C, S, B, seed=0)
    tokens = [np.asarray(ds.sample_round(r, TAU)) for r in range(rounds)]
    algo = JScenario(**scenario).apply(
        JFedCET(alpha=ALPHA, c=CW, tau=TAU, n_clients=C))
    grad_fn = jax.grad(model.loss)
    state = jax.jit(lambda p, b: algo.init(grad_fn, p, b))(
        params, {"tokens": tokens[0][0]})
    step = jax.jit(lambda s, b: algo.round(grad_fn, s, b))
    mean_loss = jax.jit(lambda x, t: jnp.mean(jax.vmap(model.loss)(
        x, {"tokens": t})))
    losses = []
    for r in range(rounds):
        state = step(state, {"tokens": tokens[r]})
        losses.append(float(mean_loss(algo.client_params(state),
                                      tokens[r][0])))
    d = junpack(state.d) if isinstance(state.d, JArena) else state.d
    to_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return (to_np(params), tokens, to_np(algo.client_params(state)),
            to_np(d), losses)


def _assert_lm_state_close(x, d, jx, jd):
    """x within 1e-5 of each leaf's scale, d within 1e-5 * c * scale."""
    import jax

    for got_x, want_x, got_d, want_d in zip(
            tree_leaves(x), jax.tree.leaves(jx),
            tree_leaves(d), jax.tree.leaves(jd)):
        scale = float(np.abs(want_x).max())
        np.testing.assert_allclose(got_x.numpy(), want_x, rtol=1e-5,
                                   atol=1e-5 * scale)
        np.testing.assert_allclose(got_d.numpy(), want_d, rtol=0,
                                   atol=1e-5 * CW * scale)


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
    _assert_lm_state_close(state.x, state.d, jx, jd)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-6)


def test_gossip_arena_round_matches_jax():
    """One round with ``ring:sparse`` on the arena: the per-client
    neighborhood means replace the star mean, and ``fedcet_comm`` takes
    its one-client form (``m_bar`` shaped like ``m``)."""
    from repro_torch.configs.base import FedScenario
    from repro_torch.core.arena import Arena, unpack

    scenario = dict(topology="ring:sparse", arena=True)
    params, tokens, jx, jd, jlosses = _jax_run("float32", rounds=1,
                                               **scenario)
    model = build_model(get_config("fedlm-100m").reduced())
    algo = FedScenario(**scenario).apply(
        FedCET(alpha=ALPHA, c=CW, tau=TAU, n_clients=C))
    assert algo.topology.lowering == "sparse" and algo.arena
    grad_fn = torch.func.grad(model.loss)
    state = algo.init(grad_fn, params_from_numpy(params),
                      {"tokens": torch.tensor(tokens[0][0])})
    b = {"tokens": torch.tensor(tokens[0])}
    state = algo.round(grad_fn, state, b)
    assert isinstance(state.d, Arena) and state.t == TAU
    x = algo.client_params(state)
    loss = float(torch.mean(torch.func.vmap(model.loss)(
        x, {"tokens": b["tokens"][0]})))
    _assert_lm_state_close(x, unpack(state.d), jx, jd)
    np.testing.assert_allclose([loss], jlosses, rtol=1e-6)


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


def test_entry_points_refuse_what_this_slice_does_not_run(capsys):
    """A delayed run finishes on the CPU and bills its uplink at the
    ``fixed:2`` duty cycle (1/3); the multi-GPU client axes still raise,
    and the default device refuses to fall back."""
    hist = run_training("fedlm-100m", steps=2, n_clients=2, batch=1,
                        seq_len=8, device="cpu", log_every=1,
                        delay="fixed:2", stale_policy="drop")
    out = capsys.readouterr().out
    n = hist["n_params"]
    assert all(np.isfinite(hist["loss"]))
    assert f"bits_up {2 * n * 32.0 / 3:.4g}" in out
    assert hist["comm_bytes"][0] == int(2 * n * 32 / 3 / 8) + 2 * n * 4
    with pytest.raises(NotImplementedError, match="not yet ported"):
        FedCET(alpha=ALPHA, c=CW, tau=TAU, n_clients=C,
               spmd_client_axes=("data",))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            run_training("fedlm-100m", steps=1)


def test_cli_runs_on_cpu_and_refuses_scenarios(capsys):
    main(["--arch", "fedlm-100m", "--steps", "1", "--clients", "2",
          "--batch", "1", "--seq-len", "8", "--device", "cpu"])
    assert "final loss:" in capsys.readouterr().out
    # a cohort of 4 of 8 clients finishes; under a gossip graph it is the
    # reference's ValueError.
    main(["--arch", "fedlm-100m", "--steps", "2", "--clients", "8",
          "--batch", "1", "--seq-len", "8", "--device", "cpu",
          "--cohort", "4", "--log-every", "1"])
    out = capsys.readouterr().out
    assert "final loss:" in out and "active_clients 8" in out
    with pytest.raises(ValueError, match="cohort"):
        main(["--arch", "fedlm-100m", "--device", "cpu", "--clients", "8",
              "--cohort", "4", "--topology", "ring"])


def test_compressed_sampled_arena_training_on_cpu(capsys):
    """The slice's options through ``run_training`` and the CLI: bits_up
    is billed at 8 bits per coordinate, ``active_clients`` is the expected
    count, and the default device still refuses to fall back."""
    hist = run_training("fedlm-100m", steps=2, n_clients=4, batch=1,
                        seq_len=8, device="cpu", log_every=1,
                        compression="shift:q8", participation=0.5,
                        arena=True)
    out = capsys.readouterr().out
    assert all(np.isfinite(hist["loss"])) and "active_clients 2" in out
    n = hist["n_params"]
    up, down = 4 * n * 8 * 0.5, 4 * n * 32 * 0.5  # 8-bit up, dense down
    assert f"bits_up {up:.4g}" in out
    assert hist["comm_bytes"][0] == int(up / 8) + int(down / 8)
    main(["--arch", "fedlm-100m", "--steps", "1", "--clients", "2",
          "--batch", "1", "--seq-len", "8", "--device", "cpu",
          "--compression", "q8", "--arena"])
    assert "final loss:" in capsys.readouterr().out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            run_training("fedlm-100m", steps=1, compression="shift:q8",
                         arena=True)


# ------------------------------------------- compressed round, tiny LM
NC_T, ROUNDS_T = 5, 3
_TINY = dict(d_model=32, n_heads=2, n_kv_heads=2, head_dim=16, d_ff=64,
             vocab_size=96)


def _tiny_setup():
    """JAX-initialized float64 tiny-LM parameters and JAX-sampled tokens."""
    import dataclasses

    import jax

    jax.config.update("jax_enable_x64", True)
    from repro.configs import get_config as jget
    from repro.data.synthetic import make_hetero_lm_dataset
    from repro.models import build_model as jbuild

    jcfg = dataclasses.replace(jget("fedlm-100m").reduced(),
                               **_TINY).with_dtype("float64")
    jmodel = jbuild(jcfg)
    params = jmodel.init(jax.random.key(0))
    ds = make_hetero_lm_dataset(jcfg.vocab_size, NC_T, 8, 2, seed=0)
    tokens = np.asarray(ds.sample_round(0, TAU))
    cfg = dataclasses.replace(get_config("fedlm-100m").reduced(),
                              **_TINY).with_dtype("float64")
    return jmodel, params, tokens, build_model(cfg)


def _port_compressed(model, params, tokens, arena):
    from repro_torch.core.engine import (run_rounds, with_arena,
                                         with_compression, with_participation)

    algo = with_participation(with_compression(
        FedCET(alpha=ALPHA, c=CW, tau=TAU, n_clients=NC_T),
        compressor="shift:q8", seed=5), 0.8, seed=3)
    if arena:
        algo = with_arena(algo)
    grad_fn = torch.func.grad(model.loss)
    b = {"tokens": torch.tensor(tokens)}
    state = algo.init(grad_fn, params, {"tokens": b["tokens"][0]})
    return run_rounds(algo, grad_fn, state, b, rounds=ROUNDS_T)[0]


def test_compressed_sampled_arena_matches_per_leaf_tiny_lm():
    import jax

    from repro_torch.core.arena import adapt_state

    _, params, tokens, model = _tiny_setup()
    tp = params_from_numpy(jax.tree.map(np.asarray, params))
    per_leaf = _port_compressed(model, tp, tokens, arena=False)
    arena = adapt_state(_port_compressed(model, tp, tokens, arena=True),
                        per_leaf)
    assert arena.inner.t == per_leaf.inner.t == ROUNDS_T * TAU
    for a, b in zip(tree_leaves(arena), tree_leaves(per_leaf)):
        if isinstance(a, torch.Tensor):
            assert float((a - b).abs().max()) <= 1e-5


def test_compressed_sampled_round_matches_jax_tiny_lm():
    import jax

    from repro.core import with_compression as jwc
    from repro.core import with_participation as jwp
    from repro.core.fedcet import FedCET as JFedCET

    jmodel, params, tokens, model = _tiny_setup()
    jalgo = jwp(jwc(JFedCET(alpha=ALPHA, c=CW, tau=TAU, n_clients=NC_T),
                    compressor="shift:q8", seed=5), 0.8, seed=3)
    jgrad = jax.grad(jmodel.loss)
    want = jax.jit(lambda p, b: jalgo.init(jgrad, p, b))(
        params, {"tokens": tokens[0]})
    step = jax.jit(lambda s, b: jalgo.round(jgrad, s, b))
    for _ in range(ROUNDS_T):
        want = step(want, {"tokens": tokens})
    got = _port_compressed(model, params_from_numpy(
        jax.tree.map(np.asarray, params)), tokens, arena=False)
    flagged = total = 0
    for gx, wx, gd, wd, gh, wh in zip(
            tree_leaves(got.inner.x), jax.tree.leaves(want.inner.x),
            tree_leaves(got.inner.d), jax.tree.leaves(want.inner.d),
            tree_leaves(got.extras[0]), jax.tree.leaves(want.extras[0])):
        scale = float(np.abs(np.asarray(wx)).max())
        np.testing.assert_allclose(gx.numpy(), np.asarray(wx), rtol=0,
                                   atol=1e-5 * scale)
        h_scale = float(np.abs(np.asarray(wh)).max())
        off = ((np.abs(gd.numpy() - np.asarray(wd)) > 1e-5 * CW * scale)
               | (np.abs(gh.numpy() - np.asarray(wh)) > 1e-5 * h_scale))
        flagged += int(off.sum())
        total += off.size
    assert flagged / total <= 1e-3, (flagged, total)


def test_topology_training_on_cpu(capsys):
    """``--topology`` through ``run_training`` and the CLI: gossip bills
    one message per directed edge up and no broadcast down; a hierarchy
    adds its tier hops (8-bit up under ``shift:q8`` tiers, dense down)."""
    hist = run_training("fedlm-100m", steps=1, n_clients=8, batch=1,
                        seq_len=8, device="cpu", topology="ring:sparse",
                        arena=True)
    out = capsys.readouterr().out
    n = hist["n_params"]
    assert all(np.isfinite(hist["loss"]))
    assert f"bits_up {8 * 2 * n * 32.0:.4g}" in out    # ring degree 2
    assert hist["comm_bytes"][0] == int(8 * 2 * n * 32 / 8)
    hist = run_training("fedlm-100m", steps=1, n_clients=8, batch=1,
                        seq_len=8, device="cpu", topology="hier:g4",
                        tier_compression="shift:q8")
    up, down = (8 * 32.0 + 4 * 8.0) * n, (8 + 4) * 32.0 * n
    assert f"bits_up {up:.4g}" in capsys.readouterr().out
    assert hist["comm_bytes"][0] == int(up / 8) + int(down / 8)
    main(["--arch", "fedlm-100m", "--steps", "1", "--clients", "8",
          "--batch", "1", "--seq-len", "8", "--device", "cpu",
          "--topology", "er:0.5:t:sparse"])
    assert "final loss:" in capsys.readouterr().out
    with pytest.raises(ValueError, match="tier_compression"):
        run_training("fedlm-100m", steps=1, n_clients=4, device="cpu",
                     topology="ring", tier_compression="q8")


def test_compression_plan_with_adaptive_tightening_on_cpu(tmp_path, capsys):
    """``--compression-plan`` / ``--plan-adapt`` through ``run_training``:
    the plan bills per leaf (``shift:q6`` on every leaf but ``embed``'s 12
    bits), and the adaptive schedule tightens at the rounds where the
    reference's ``AdaptivePlan`` does on the same ``compress_err`` series
    (read from the run's own JSONL, one segment per round as
    ``log_every=1`` makes them), to the same plan. Both ``ValueError``s
    of the reference stand."""
    import json

    import jax

    from repro.core.compressors import AdaptivePlan as JAdaptive
    from repro.core.compressors import parse_plan as jparse

    from repro_torch.core.comm import leaf_info_of

    spec = "embed*:q12,ln*:bf16,*:shift:q6"
    path = tmp_path / "t.jsonl"
    hist = run_training("fedlm-100m", steps=12, n_clients=2, batch=1,
                        seq_len=8, device="cpu", log_every=1,
                        compression_plan=spec, plan_adapt=10.0,
                        telemetry=f"jsonl:{path}")
    assert all(np.isfinite(hist["loss"]))
    events = [json.loads(line) for line in open(path)]
    assert events[0]["config"]["compression_plan"] == spec
    assert events[0]["config"]["plan_adapt"] == 10.0
    errs = [e["compress_err"] for e in events if e["event"] == "round"]
    assert len(errs) == 12
    adapted = [e["round"] for e in events if e["event"] == "plan_adapt"]
    sched = JAdaptive(plan=jparse(spec), factor=10.0)
    want = [r for r, err in enumerate(errs)
            if sched.update(err) is not None]
    assert adapted == want and adapted, (adapted, want, errs)
    # the first round's bits: embed 12, ln* bf16 16, the rest 6 per coord
    params = build_model(get_config("fedlm-100m").reduced()).init(
        torch.Generator())
    info = leaf_info_of(params)
    per = [12 if nm == "embed" else 16 if "/ln" in f"/{nm}" else 6
           for nm, _ in info]
    bits0 = 2 * sum(b * n for b, (_, n) in zip(per, info))
    assert f"round     0  loss" in capsys.readouterr().out
    assert hist["comm_bytes"][0] == int(bits0 / 8) \
        + int(2 * hist["n_params"] * 32 / 8)
    assert jax.tree.leaves(sched.plan.rules) is not None
    with pytest.raises(ValueError, match="compression_plan"):
        run_training("fedlm-100m", steps=1, device="cpu", plan_adapt=10.0,
                     telemetry=f"jsonl:{tmp_path / 'u.jsonl'}")
    with pytest.raises(ValueError, match="telemetry"):
        run_training("fedlm-100m", steps=1, device="cpu",
                     compression_plan=spec, plan_adapt=10.0)
    main(["--arch", "fedlm-100m", "--steps", "1", "--clients", "2",
          "--batch", "1", "--seq-len", "8", "--device", "cpu",
          "--compression-plan", spec])
    assert "final loss:" in capsys.readouterr().out
