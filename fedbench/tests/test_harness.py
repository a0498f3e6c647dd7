"""The harness on the CPU at test sizes: every cell resolves what it names,
a sound run of each cell comes out correct, a run with the timed path
broken underneath comes out not correct, and ``run.py`` refuses to run
without a card."""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from fedbench import readings, run

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
GRANITE = "granite-moe-l2.shiftq8-arena"


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("workload", CELLS)
def test_cell_resolves_by_name(workload):
    from repro_torch.configs.base import ArchConfig

    c = run.load_cell(workload)
    assert set(c["limits"]) <= {"loss", "grad_clients"} | {
        k + m for k in ("grad", "update", "drift", "shift")
        for m in ("", "_median")}
    assert all(v > 0 for v in c["limits"].values())
    for kind in ("end_to_end", "per_layer"):
        assert c["readers"][kind]
        for reader in c["readers"][kind].values():
            assert callable(reader.read)
    assert "setup_s" in c["readers"]["end_to_end"]
    ArchConfig(**c["family"].arch_kwargs(c["conf"]))
    for key in ("n_clients", "tau", "alpha", "c", "batch", "seq_len",
                "compression", "distinct_rounds"):
        assert key in c["mix"]


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(workload):
    result, info = run.run_cell(run.load_cell(workload), 2 ** 31 + 5, 0.0,
                                False, device="cpu", test_sizes=True)
    assert result["correct"], info
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert list(result)[-1] == "checks"


def _unchanged(monkeypatch):
    from repro_torch.core import engine

    monkeypatch.setattr(engine.RoundEngine, "round",
                        lambda self, grad_fn, state, batches: state)


def _half_batch(monkeypatch):
    from repro_torch.core import engine

    real = engine.vmap_grads

    def half(f, **kw):
        gf = real(f, **kw)
        return lambda x, b: gf(x, {k: v[:, :v.shape[1] // 2]
                                   for k, v in b.items()})

    monkeypatch.setattr(engine, "vmap_grads", half)


def _no_exchange(monkeypatch):
    from repro_torch.kernels import ops

    real = ops.fedcet_round_tail

    def alone(v, h, d, u, scale, w, den, **kw):  # each client its own mean
        parts = [real(v[i:i + 1], h[i:i + 1], d[i:i + 1], u, scale,
                      w[i:i + 1], torch.ones_like(den), **kw)
                 for i in range(v.shape[0])]
        return tuple(torch.cat(p) for p in zip(*parts))

    monkeypatch.setattr(ops, "fedcet_round_tail", alone)


@pytest.mark.parametrize("fault", [_unchanged, _half_batch, _no_exchange])
def test_broken_timed_path_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    result, info = run.run_cell(run.load_cell(GRANITE), 2 ** 31 + 5, 0.0,
                                False, device="cpu", test_sizes=True)
    assert not result["correct"], info


def test_gaps_take_the_worst_compared_leaf():
    ref = {"loss": [2.0],
           "grad": {"a": [1.0, 1.0], "b": [2.0, 2.0], "c": [1e-9, 1e-9]},
           "update": {"a": 1.0, "b": 2.0, "c": 5.0}}
    prog = {"loss": [2.002],
            "grad": {"a": [1.0, 1.5], "b": [2.0, 2.0], "c": [0.0, 0.0]},
            "update": {"a": 1.1, "b": 2.0, "c": 0.0}}
    g = readings.gaps(prog, ref)
    assert g["loss"][0] == pytest.approx(1e-3)
    assert g["update"] == (pytest.approx(0.1 / 1.5), "a")  # c is nought
    assert g["update_median"] == (0.0, "b")
    # client 1's leaf a is 0.5 off its norm 1 (against the median 1.5):
    # one client of two, so the median over clients is half of it
    assert g["grad_clients"][0] == pytest.approx(0.5 / 1.5 / 2)


def test_run_without_a_card_fails_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, "fedbench/run.py", "--workload", GRANITE,
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode != 0
    assert '"correct"' not in out.stdout
