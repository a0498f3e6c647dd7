"""The port's ``FedTrainer`` (``fed/trainer.py``) and ``run_training``'s
checkpoints, on the CPU, on the reduced fedlm-100m (3 clients, batch 2,
seq 32, tau 2, as ``tests/test_trainer.py``).

* Mirrors of ``tests/test_trainer.py``: training lowers the held-out loss
  and logs finite rows; checkpoint then resume equals the uninterrupted
  run (here bit for bit, where the reference allows 1e-6); the
  heterogeneity gap is finite.
* Mirrors of ``tests/test_telemetry.py``: telemetry adds no state (a
  checkpoint written with it on resumes bitwise into the off algorithm,
  on the synchronous ``shift:q8`` x participation round and on the
  reference's ``composed`` scenario), and the trainer's CSV is
  identical with telemetry and sinks on (``wall_s`` aside).
* Against the reference: ``tests/test_torch_trainer_parity.py``.
* SCAFFOLD and FedTrack meter twice FedAvg's bytes.
* ``run_training(ckpt_dir=)`` writes ``step_000000050.npz`` after 50
  rounds, and it restores into the run's state layout.
"""

import json
import os

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import all_steps, restore, save
from repro_torch.configs import get_config
from repro_torch.configs.base import FedScenario
from repro_torch.core import (FedAvg, FedCET, FedTrack, Scaffold,
                              max_weight_c)
from repro_torch.core.engine import run_rounds, with_telemetry
from repro_torch.core.lr_search import lr_search
from repro_torch.data.quadratic import QuadraticProblem
from repro_torch.data.synthetic import make_hetero_lm_dataset
from repro_torch.fed import FedTrainer, TrainerConfig
from repro_torch.models import build_model
from repro_torch.utils.tree import tree_leaves, tree_map

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


def _setup(tmp=None, rounds=6, ckpt_every=0, algo=None, telemetry=False,
           sinks=None, log_csv=None, eval_every=2):
    cfg = get_config("fedlm-100m").reduced()
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    algo = algo or FedCET(alpha=3e-3, c=0.05, tau=TAU, n_clients=N_CLIENTS)
    algo = with_telemetry(algo, telemetry)
    ds = make_hetero_lm_dataset(cfg.vocab_size, N_CLIENTS, S, B, seed=1)
    batches_for = lambda r: {"tokens": ds.sample_round(r, TAU)}  # noqa: E731
    tc = TrainerConfig(rounds=rounds, eval_every=eval_every,
                       ckpt_every=ckpt_every, ckpt_dir=tmp, log_csv=log_csv)
    trainer = FedTrainer(algo, model.loss, tc, sinks=sinks, device="cpu")
    state = trainer.init_state(params, tree_map(lambda b: b[0],
                                                batches_for(0)))
    return trainer, state, batches_for


def _assert_bitwise(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y)
        else:
            assert x == y


# ------------------------------------------------ mirrors of test_trainer
def test_training_reduces_loss_and_logs():
    trainer, state, batches_for = _setup(rounds=20)
    eval_b = batches_for(10_001)  # a fixed held-out batch
    trainer.fit(state, batches_for, eval_batch_for=lambda r: eval_b)
    assert trainer.history, "eval rows must be recorded"
    losses = [h["loss_global"] for h in trainer.history]
    assert losses[-1] < losses[0]
    assert [h["round"] for h in trainer.history] == list(range(0, 20, 2)) \
        + [19]
    for h in trainer.history:
        assert np.isfinite(h["loss_global"])
        assert np.isfinite(h["heterogeneity_gap"])
        assert h["comm_bytes"] > 0


def test_checkpoint_resume_is_deterministic(tmp_path):
    d = str(tmp_path / "ck")
    trainer, state, batches_for = _setup(rounds=6)
    final_a = trainer.fit(state, batches_for)
    trainer_b, state_b, _ = _setup(tmp=d, rounds=3, ckpt_every=3)
    trainer_b.fit(state_b, batches_for)
    assert all_steps(d) == [3]
    trainer_c, state_c, _ = _setup(tmp=d, rounds=6, ckpt_every=0)
    resumed, start = trainer_c.maybe_resume(state_c)
    assert start == 3 and resumed.t == 3 * TAU
    final_b = trainer_c.fit(resumed, batches_for, start_round=start)
    _assert_bitwise(final_a, final_b)
    row_a, row_b = trainer.history[-1], trainer_c.history[-1]
    assert row_a["round"] == row_b["round"] == 5
    for k in ("loss_global", "loss_local_mean", "heterogeneity_gap"):
        assert row_a[k] == row_b[k]


def test_heterogeneity_gap_positive_on_noniid():
    trainer, state, batches_for = _setup(rounds=4)
    trainer.fit(state, batches_for)
    gaps = [h["heterogeneity_gap"] for h in trainer.history]
    assert len(gaps) == 3 and all(np.isfinite(g) for g in gaps)


def test_baselines_meter_their_vectors():
    """SCAFFOLD and FedTrack send two vectors each way: twice FedAvg's
    bytes a round; every loss is finite."""
    bytes_ = {}
    for name, algo in {
            "fedavg": FedAvg(alpha=3e-3, tau=TAU, n_clients=N_CLIENTS),
            "scaffold": Scaffold(alpha_l=3e-3, tau=TAU, n_clients=N_CLIENTS),
            "fedtrack": FedTrack(alpha=3e-3, tau=TAU, n_clients=N_CLIENTS)
    }.items():
        trainer, state, batches_for = _setup(rounds=2, algo=algo,
                                             eval_every=1)
        trainer.fit(state, batches_for)
        assert all(np.isfinite(h["loss_global"]) for h in trainer.history)
        bytes_[name] = trainer.history[-1]["comm_bytes"]
    assert bytes_["scaffold"] == bytes_["fedtrack"] == 2 * bytes_["fedavg"]


# ---------------------------------------------- mirrors of test_telemetry
def _assert_noop_across_resume(tmp_path, **kw):
    """A checkpoint written mid-run with telemetry ON restores into the
    telemetry-OFF algorithm of ``FedScenario(**kw)`` and continues bitwise
    identically to the uninterrupted run. A cohort round writes into its
    input state, so each run starts from its own copy of the first."""
    _jax()
    from repro.data.quadratic import make_quadratic_problem as jmake

    jp = jmake(0, n_clients=8, dim=24)
    problem = QuadraticProblem(b=torch.tensor(np.asarray(jp.b)),
                               m=torch.tensor(np.asarray(jp.m)))
    alpha = lr_search(problem.mu, problem.L, 2)
    base = FedCET(alpha=alpha, c=max_weight_c(problem.mu, alpha), tau=2,
                  n_clients=8)
    off = FedScenario(telemetry=False, **kw).apply(base)
    on = FedScenario(telemetry=True, **kw).apply(base)
    grad = torch.func.grad(problem.client_loss)
    batches = problem.stacked_batches(2)
    x0 = torch.zeros(problem.dim, dtype=torch.float64)
    init_b = tree_map(lambda b: b[0], batches)
    state0 = off.init(grad, x0, init_b)
    _assert_bitwise(state0, on.init(grad, x0, init_b))
    rounds = 8
    copy = lambda st: tree_map(  # noqa: E731
        lambda a: a.clone() if isinstance(a, torch.Tensor) else a, st)
    straight, _ = run_rounds(off, grad, copy(state0), batches, rounds=rounds)
    mid_on, _ = run_rounds(on, grad, copy(state0), batches,
                           rounds=rounds // 2)
    save(str(tmp_path / "ck"), rounds // 2, mid_on)
    restored, step = restore(str(tmp_path / "ck"), mid_on)
    assert step == rounds // 2
    resumed_off, _ = run_rounds(off, grad, restored, batches,
                                rounds=rounds - rounds // 2)
    _assert_bitwise(straight, resumed_off)


def test_disabled_is_bitwise_noop_across_checkpoint_resume(tmp_path):
    """Telemetry adds no state across a checkpoint on the synchronous
    round: ``shift:q8`` x 0.8 participation on the arena."""
    _assert_noop_across_resume(tmp_path, compression="shift:q8",
                               participation=0.8, arena=True)


def test_disabled_is_bitwise_noop_across_checkpoint_resume_composed(
        tmp_path):
    """The same on the reference's ``composed`` scenario, whose rounds
    take the cohort path: ``shift:q8`` x 0.8 participation x ``fixed:2``
    / ``poly:1`` x a ``block:4`` cohort on the arena."""
    _assert_noop_across_resume(tmp_path, compression="shift:q8",
                               participation=0.8, delay="fixed:2",
                               stale_policy="poly:1", cohort="block:4",
                               arena=True)


def test_trainer_csv_bytes_identical_with_telemetry(tmp_path):
    csv_off, csv_on = str(tmp_path / "off.csv"), str(tmp_path / "on.csv")
    jsonl = str(tmp_path / "run.jsonl")
    trainer, state, batches_for = _setup(rounds=4, log_csv=csv_off)
    final_off = trainer.fit(state, batches_for)
    trainer2, state2, batches_for2 = _setup(
        rounds=4, telemetry=True, sinks=f"jsonl:{jsonl}", log_csv=csv_on)
    final_on = trainer2.fit(state2, batches_for2)
    with open(csv_off) as a, open(csv_on) as b:
        rows_a, rows_b = a.read().splitlines(), b.read().splitlines()
    assert rows_a[0] == rows_b[0]          # identical header
    header = rows_a[0].split(",")
    wall = header.index("wall_s")          # the only nondeterministic field
    assert len(rows_a) == len(rows_b) == 4
    for ra, rb in zip(rows_a[1:], rows_b[1:]):
        ca, cb = ra.split(","), rb.split(",")
        ca[wall] = cb[wall] = ""
        assert ca == cb, (ra, rb)
    _assert_bitwise(final_off, final_on)
    events = [json.loads(line) for line in open(jsonl)]
    assert events[0]["event"] == "manifest"
    assert sum(e["event"] == "round" for e in events) == 4


def test_run_training_checkpoints_every_50_rounds(tmp_path, capsys):
    from repro_torch.launch.train import main

    d = str(tmp_path / "ck")
    main(["--arch", "fedlm-100m", "--steps", "50", "--clients", "2",
          "--batch", "1", "--seq-len", "8", "--device", "cpu",
          "--log-every", "25", "--compression", "shift:q8", "--arena",
          "--ckpt-dir", d])
    assert "final loss:" in capsys.readouterr().out
    assert os.listdir(d) == ["step_000000050.npz"]
    model = build_model(get_config("fedlm-100m").reduced())
    algo = FedScenario(compression="shift:q8", arena=True).apply(
        FedCET(alpha=3e-3, c=0.05, tau=2, n_clients=2))
    ds = make_hetero_lm_dataset(model.cfg.vocab_size, 2, 8, 1)
    like = algo.init(torch.func.grad(model.loss),
                     model.init(torch.Generator().manual_seed(0)),
                     {"tokens": ds.sample_round(0, 2)[0]})
    state, step = restore(d, like)
    assert step == 50 and state.inner.t == 100
    assert all(bool(torch.isfinite(t).all()) for t in tree_leaves(state)
               if isinstance(t, torch.Tensor))
