"""The port's telemetry sketch kernel, sinks, monitors, grammar, comm meter
and telemetry entry points, on the CPU.

* The plain ``client_sketch`` (``kernels/ref.py``, the CPU route of
  ``ops.telemetry_sketch``) against JAX's ``kernels/ref.py:client_sketch``
  and JAX's ``ops.telemetry_sketch(impl="kernel")`` (the Pallas kernel in
  interpret mode), on ``[n, rows, 1024]`` stores with zero pads, n in
  {1, 8, 13}, float32 and float64: squared norms within 1e-12 relative
  (float64) / 1e-5 (float32) (the port sums in the CUDA kernel's fixed
  order, JAX in XLA's), histograms and top ids equal.
* Mirrors of the reference's pure-logic tests (``tests/test_telemetry.py``,
  ``tests/test_telemetry_dist.py``): the binning formula, monitor modes,
  ``fit_rate``, ``RateMonitor`` firing and silent, ``rate_axis``,
  ``resolve_monitors``, the sink and spec grammars, CSV flattening, JSONL
  vectors, drain's ``leaf_stats`` split, ``wants_sketch`` and the metric
  filter, and ``replay_jsonl`` giving the reference's WARN list on the
  same file. ``CommMeter`` bills what the reference's bills.
* ``run_training`` and the CLI on the CPU with ``--telemetry`` and
  ``--trace-rounds``: manifest first, one round event per round, a
  Chrome trace written; ``benchmarks/report.py`` (run as a subprocess)
  renders the port's JSONL.

Reference tests not mirrored, because their axis is not ported yet:
``test_disabled_is_bitwise_noop_across_checkpoint_resume`` (checkpoints),
``test_invariant_monitor_fires_on_poly_staleness``, the ``fixed:2`` case of
``test_invariant_monitor_silent_on_exact_scenarios``,
``test_rate_monitor_reproduces_staleness_boundary`` and the delay case of
``test_rate_axis_names_lossy_axes`` (delay), ``test_cohort_and_dense_
lowerings_sketch_identically`` and the cohort / delay parts of the
composed scenario (cohort, delay), the FedAvg / SCAFFOLD cases of
``test_disabled_vs_enabled_is_bitwise_identical`` (baselines) and
``test_trainer_csv_bytes_identical_with_telemetry`` (FedTrainer).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import FedCET, max_weight_c
from repro_torch.core import telemetry as T
from repro_torch.core.comm import CommMeter
from repro_torch.core.engine import with_telemetry
from repro_torch.core.lr_search import lr_search
from repro_torch.core.simulate import simulate_quadratic
from repro_torch.data.quadratic import make_quadratic_problem
from repro_torch.kernels import ops, ref
from repro_torch.launch.train import main, run_training

ROOT = Path(__file__).resolve().parents[1]


def _jax():
    import jax

    jax.config.update("jax_enable_x64", True)
    return jax


def _problem():
    return make_quadratic_problem(0, n_clients=8, dim=24)


def _fedcet(problem, tau=2):
    alpha = lr_search(problem.mu, problem.L, tau)
    return FedCET(alpha=alpha, c=max_weight_c(problem.mu, alpha), tau=tau,
                  n_clients=problem.n_clients)


# ------------------------------------------------------ kernel vs JAX
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("n_clients", [1, 8, 13])
def test_client_sketch_matches_jax(n_clients, dtype):
    jax = _jax()
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref

    rng = np.random.default_rng(n_clients)
    data = (rng.normal(size=(n_clients, 3, 1024))
            * np.logspace(-6, 2, n_clients)[:, None, None]).astype(dtype)
    data[:, -1, 512:] = 0.0  # arena zero padding
    kw = dict(bins=48, lo=-12.0, hi=4.0)
    got = ops.telemetry_sketch(torch.from_numpy(data), k=4, **kw)
    sq, hist = ref.client_sketch(torch.from_numpy(data.reshape(n_clients,
                                                               -1)), **kw)
    jsq, jhist = jref.client_sketch(jnp.asarray(data.reshape(n_clients, -1)),
                                    **kw)
    want = jops.telemetry_sketch(jnp.asarray(data), impl="kernel", k=4, **kw)
    rtol = 1e-12 if dtype == "float64" else 1e-5
    np.testing.assert_allclose(sq.numpy(), np.asarray(jsq), rtol=rtol)
    np.testing.assert_array_equal(hist.numpy(), np.asarray(jhist))
    assert sq.dtype == got[0].dtype == getattr(torch, dtype)
    for g, w in zip(got, jax.tree.map(np.asarray, want)):
        if w.dtype.kind in "iu":
            np.testing.assert_array_equal(g.numpy(), w)
        else:
            np.testing.assert_allclose(g.numpy(), w, rtol=rtol)
    assert int(got[1].sum()) == n_clients


def test_client_sketch_sums_in_the_kernels_order():
    """Ragged width, zero rows, norms past both edge bins: the plain
    version's squared norms equal a float64 sum to rounding, and its
    histogram the shared binning formula."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(6, 100_003))
                         * np.logspace(-17, 4, 6)[:, None])
    x[2] = 0.0
    sq, hist = ref.client_sketch(x, bins=32, lo=-12.0, hi=4.0)
    np.testing.assert_allclose(sq.numpy(), (x.numpy() ** 2).sum(axis=1),
                               rtol=1e-13)
    assert torch.equal(hist, T.log_histogram(torch.sqrt(sq), 32, -12.0, 4.0))
    assert hist[0] == 2 and hist[-1] == 1  # the zero row + 1e-17, 1e4
    assert ref.sketch_geometry(8, 107_006_976, 4) == (128, 4)
    assert ref.sketch_geometry(1024, 2048, 8) == (1, 2)


def test_top_k_breaks_ties_by_the_lower_client_index():
    data = torch.tensor([[1.0], [3.0], [3.0], [2.0], [3.0]])
    _, _, tv, ti = ops.telemetry_sketch(data, bins=4, lo=-1.0, hi=1.0, k=4)
    assert ti.tolist() == [1, 2, 4, 3] and ti.dtype == torch.int32
    assert tv.tolist() == [3.0, 3.0, 3.0, 2.0]


def test_histogram_matches_shared_binning_formula():
    spec = T.Telemetry(sketches="auto")
    vals = torch.tensor([0.0, 1e-13, 3e-7, 0.5, 2.0, 9e3, 1e9],
                        dtype=torch.float64)
    hist = T.log_histogram(vals, spec.hist_bins, spec.hist_lo, spec.hist_hi)
    assert int(hist.sum()) == vals.shape[0] and hist.dtype == torch.int32
    assert hist[0] >= 1 and hist[-1] >= 1


# -------------------------------------------------- series and specs
SKETCH_SPEC = T.Telemetry(sketches="auto", topk=3, leaf_stats=True)
#: the generic seam (on the arena the fused round tail takes the whole
#: seam and returns before the transform captures, as in the reference).
SCENARIO = dict(compression="shift:q8", participation=0.8)


def _run(spec, rounds=6, **scenario):
    from repro_torch.configs.base import FedScenario

    problem = _problem()
    algo = FedScenario(telemetry=spec, **scenario).apply(_fedcet(problem))
    return algo, simulate_quadratic(algo, problem, rounds, device="cpu")


def test_series_keys_shapes_and_invariants():
    _, res = _run(SKETCH_SPEC, **SCENARIO)
    tel = res.telemetry
    for key in ("grad_norm", "msg_norm", "compress_err", "participating",
                "invariant_residual", "consensus_err"):
        assert key in tel and len(tel[key]) == 6, sorted(tel)
    assert bool((tel["participating"] <= 8).all())
    assert bool((tel["grad_norm"] > 0).all())
    for src in ("d_norm", "drift", "compress_err"):
        hist = tel[f"{src}_hist"]
        assert tuple(hist.shape) == (6, SKETCH_SPEC.hist_bins)
        assert bool((hist.sum(dim=1) == 8).all()), src
        p50, p90, p99, mx = (tel[f"{src}_{q}"]
                             for q in ("p50", "p90", "p99", "max"))
        assert bool((p50 <= p90).all() and (p90 <= p99).all()
                    and (p99 <= mx).all())
        assert tuple(tel[f"{src}_top_ids"].shape) == (6, 3)
        assert torch.equal(tel[f"{src}_top_vals"][:, 0], mx)
    # one leaf (the quadratic's x), per round.
    assert tuple(tel["leaf_msg_norm"].shape) == (6, 1)
    assert tuple(tel["leaf_compress_err"].shape) == (6, 1)


def test_metric_subset_and_sketch_filter():
    _, res = _run(T.Telemetry(metrics=("grad_norm", "msg_norm")), rounds=3)
    assert sorted(res.telemetry) == ["grad_norm", "msg_norm"]
    spec = T.Telemetry(sketches="auto", metrics=("d_norm_hist", "d_norm_p99"))
    _, res = _run(spec, rounds=2, **SCENARIO)
    assert set(res.telemetry) == {"d_norm_hist", "d_norm_p99"}


def test_with_telemetry_disabled_returns_same_object():
    algo = _fedcet(_problem())
    for spec in (None, False, "none", "off", ""):
        assert with_telemetry(algo, spec) is algo
    on = with_telemetry(algo, True)
    assert on is not algo and isinstance(on.telemetry, T.Telemetry)
    assert with_telemetry(algo, T.Telemetry()).telemetry == T.Telemetry()


def test_invariant_monitor_silent_on_the_exact_scenario():
    _, res = _run(True, rounds=24)
    events = T.drain(res.telemetry, monitors=(T.INVARIANT_MONITOR,))
    residuals = [e["invariant_residual"] for e in events
                 if e["event"] == "round"]
    assert max(residuals) < 1e-9
    assert not [e for e in events if e["event"] == "monitor"]


def test_monitor_modes():
    assert T.Monitor("m", 2.0, "max").violated(3.0)
    assert not T.Monitor("m", 2.0, "max").violated(1.0)
    assert T.Monitor("m", 2.0, "min").violated(1.0)
    assert not T.Monitor("m", 2.0, "min").violated(3.0)


def test_fit_rate_recovers_rho_on_geometric_series():
    for rho in (0.5, 0.9, 0.99):
        r = np.arange(40)
        assert T.fit_rate(r, 3.7 * rho ** r) == pytest.approx(rho, rel=1e-9)


def test_rate_monitor_fires_on_synthetic_stall():
    m = T.RateMonitor(axis="synthetic-axis")
    vals = [0.8 ** r for r in range(30)] + [0.8 ** 30] * 25
    events = T.drain({"err": np.asarray(vals)}, monitors=(m,))
    warns = [e for e in events if e.get("kind") == "rate_break"]
    assert warns and warns[0]["axis"] == "synthetic-axis"
    assert warns[0]["rho_hat"] >= m.stall_rho and warns[0]["round"] >= 30
    annotated = [e for e in events
                 if e["event"] == "round" and "rho_hat" in e]
    assert len(annotated) >= len(vals) - m.window
    assert annotated[0]["rho_hat"] == pytest.approx(0.8, rel=1e-6)


def test_rate_monitor_silent_on_clean_contraction():
    events = T.drain({"err": np.asarray([0.9 ** r for r in range(60)])},
                     monitors=(T.RateMonitor(),))
    assert not [e for e in events if e.get("kind") == "rate_break"]


def test_rate_axis_and_resolve_monitors():
    from repro_torch.core.engine import with_compression, with_topology

    base = _fedcet(_problem())
    assert "no lossy axis" in T.rate_axis(base)
    assert "compression" in T.rate_axis(with_compression(
        base, compressor="shift:q8"))
    assert "tier_compression" in T.rate_axis(with_topology(
        base, "hier:g4", tier_compression="shift:q8"))
    algo = with_telemetry(base, True)
    plain = T.resolve_monitors(algo.telemetry)
    withalgo = T.resolve_monitors(algo.telemetry, algo)
    assert not any(isinstance(m, T.RateMonitor) for m in plain)
    assert len([m for m in withalgo if isinstance(m, T.RateMonitor)]) == 1
    assert T.resolve_monitors(None) == ()


def test_replay_jsonl_gives_the_references_warnings(tmp_path):
    """A stalled residual and invariant violations drained to a JSONL
    file: the port's and the reference's monitors replay the same WARN
    events from it."""
    _jax()
    from repro.core import telemetry as jtele

    vals = [0.8 ** r for r in range(30)] + [0.8 ** 30] * 25
    resid = [1e-9] * 40 + [1e-3] * 15
    path = str(tmp_path / "run.jsonl")
    sinks = T.parse_sinks(f"jsonl:{path}")
    T.drain({"err": np.asarray(vals), "invariant_residual": np.asarray(resid),
             "d_norm_hist": np.ones((55, 4), np.int32)}, sinks=sinks)
    T.close_sinks(sinks)
    got = T.replay_jsonl(path, (T.INVARIANT_MONITOR,
                                T.RateMonitor(axis="a")))
    want = jtele.replay_jsonl(path, (jtele.INVARIANT_MONITOR,
                                     jtele.RateMonitor(axis="a")))
    assert got == want
    assert {w.get("kind", "threshold") for w in got} == {"rate_break",
                                                         "threshold"}


def test_comm_meter_bills_what_the_reference_bills():
    _jax()
    from repro.core import FedCET as JFedCET
    from repro.core.comm import CommMeter as JMeter
    from repro.configs.base import FedScenario as JScenario

    from repro_torch.configs.base import FedScenario

    params = {"a": np.zeros((3, 5)), "b": np.zeros((7,))}
    tparams = {k: torch.from_numpy(v) for k, v in params.items()}
    for kw in ({}, dict(compression="shift:q8", participation=0.8),
               dict(topology="ring:sparse"),
               dict(topology="hier:g4", tier_compression="shift:q8")):
        alg = FedScenario(**kw).apply(FedCET(alpha=0.1, c=0.1, tau=2,
                                             n_clients=8))
        jalg = JScenario(**kw).apply(JFedCET(alpha=0.1, c=0.1, tau=2,
                                             n_clients=8))
        got = CommMeter.for_params(tparams, algo=alg, n_clients=8)
        want = JMeter.for_params(params, algo=jalg, n_clients=8)
        for _ in range(3):
            got.tick_round(alg)
            want.tick_round(jalg)
        assert (got.bytes_up, got.bytes_down, got.total) == (
            want.bytes_up, want.bytes_down, want.total), kw
        assert got.leaf_bits == want.leaf_bits and got.rounds == 3


# ------------------------------------------------------------- sinks
def test_csv_sink_flattens_vector_metrics(tmp_path):
    path = str(tmp_path / "m.csv")
    sink = T.CsvSink(path)
    sink.emit({"event": "round", "round": 0, "loss": 1.5,
               "d_norm_hist": [1, 2, 3], "d_norm_p50": 0.5})
    sink.emit({"event": "round", "round": 1, "loss": 1.2,
               "d_norm_hist": [0, 4, 2], "d_norm_p50": 0.4})
    sink.close()
    lines = open(path).read().strip().split("\n")
    header = lines[0].split(",")
    assert "d_norm_hist.0" in header and "d_norm_hist.2" in header
    assert dict(zip(header, lines[2].split(",")))["d_norm_hist.1"] == "4"


def test_csv_sink_rejects_nested_vectors():
    sink = T.CsvSink(os.devnull)
    with pytest.raises(ValueError, match="jsonl"):
        sink.emit({"event": "round", "round": 0, "bad": [[1, 2], [3, 4]]})
    sink.close()


def test_jsonl_round_events_carry_vectors(tmp_path):
    path = str(tmp_path / "r.jsonl")
    sinks = T.parse_sinks(f"jsonl:{path}")
    T.drain({"loss": torch.tensor([1.0, 0.5]),
             "d_norm_hist": torch.tensor([[1, 2], [3, 4]],
                                         dtype=torch.int32)}, sinks=sinks)
    T.close_sinks(sinks)
    evs = [json.loads(line) for line in open(path)]
    assert evs[0]["d_norm_hist"] == [1, 2] and evs[1]["d_norm_hist"] == [3, 4]


def test_drain_splits_leaf_series_into_leaf_stats_events():
    sink = T.MemorySink()
    T.drain({"loss": np.asarray([1.0, 0.5]),
             "leaf_msg_norm": np.asarray([[1.0, 2.0], [3.0, 4.0]]),
             "leaf_compress_err": np.asarray([[0.1, 0.2], [0.3, 0.4]])},
            sinks=[sink], leaf_names=["embed", "head"], leaf_bits=[8, 16])
    rounds = [e for e in sink.events if e["event"] == "round"]
    leaves = [e for e in sink.events if e["event"] == "leaf_stats"]
    assert len(rounds) == len(leaves) == 2
    assert "leaf_msg_norm" not in rounds[0]
    assert leaves[0]["names"] == ["embed", "head"]
    assert leaves[0]["bits"] == [8.0, 16.0]
    assert "names" not in leaves[1] and "bits" not in leaves[1]
    assert leaves[1]["msg_norm"] == [3.0, 4.0]
    assert leaves[0]["compress_err"] == [0.1, 0.2]


def test_parse_sinks_and_telemetry_grammar(tmp_path):
    sinks = T.parse_sinks(f"jsonl:{tmp_path}/a.jsonl,memory,stdout:5")
    assert [type(s).__name__ for s in sinks] == ["JsonlSink", "MemorySink",
                                                 "StdoutSink"]
    assert sinks[2].every == 5
    T.close_sinks(sinks)
    assert T.parse_sinks(None) == []
    mem = T.MemorySink()
    assert T.parse_sinks([mem]) == [mem]
    with pytest.raises(ValueError, match="unknown telemetry sink"):
        T.parse_sinks("carrier-pigeon:coop")
    sinks = T.parse_sinks(f"jsonl:{tmp_path}/b.jsonl,hist:48,topk:4,leafstats")
    assert len(sinks) == 1
    T.close_sinks(sinks)
    for off in (None, "none", False, "off", ""):
        assert T.parse_telemetry(off) is None
    assert T.parse_telemetry(True) == T.Telemetry()
    assert T.parse_telemetry("jsonl:x.jsonl") == T.Telemetry()
    spec = T.Telemetry(metrics=("grad_norm",))
    assert T.parse_telemetry(spec) is spec
    spec = T.parse_telemetry("jsonl:r.jsonl,hist:32:-10:2,topk:6,leafstats")
    assert spec.sketches == "auto" and spec.hist_bins == 32
    assert (spec.hist_lo, spec.hist_hi, spec.topk) == (-10.0, 2.0, 6)
    assert spec.leaf_stats and T.parse_telemetry("hist").sketches == "auto"
    assert T.Telemetry(sketches="auto").wants_sketch("d_norm")
    assert not T.Telemetry(sketches=False).wants_sketch("d_norm")
    only = T.Telemetry(sketches=("drift",))
    assert only.wants_sketch("drift") and not only.wants_sketch("d_norm")


def test_trace_rounds_grammar_and_boundaries():
    assert T.parse_trace_rounds(None) is None
    assert T.parse_trace_rounds("3:5") == (3, 5)
    assert T.parse_trace_rounds("2") == (2, 3)
    with pytest.raises(ValueError, match="trace-rounds"):
        T.parse_trace_rounds("4:4")
    assert T.TraceSession((3, 4)).boundaries() == (2, 3)
    assert T.TraceSession((0, 2)).boundaries() == (1,)


# ------------------------------------------------------- entry points
def test_run_training_drains_telemetry_and_writes_a_trace(capsys, tmp_path):
    jsonl = str(tmp_path / "t.jsonl")
    trace_dir = str(tmp_path / "trace")
    hist = run_training("fedlm-100m", steps=3, n_clients=2, batch=1,
                        seq_len=8, device="cpu", log_every=2,
                        participation=0.5, arena=True,
                        telemetry=f"jsonl:{jsonl},hist:16",
                        trace_rounds="1:2", trace_dir=trace_dir)
    out = capsys.readouterr().out
    lines = [ln for ln in out.splitlines() if ln.startswith("round ")]
    assert len(lines) == 2 and hist["round"] == [0, 2]
    events = [json.loads(line) for line in open(jsonl)]
    assert events[0]["event"] == "manifest"
    assert events[0]["mesh"] == {"backend": "cpu", "n_devices": 1}
    rounds = [e for e in events if e["event"] == "round"]
    assert [e["round"] for e in rounds] == [0, 1, 2]
    for ln, ev in zip(lines, (rounds[0], rounds[2])):  # the in-round count
        assert ln.endswith(f"active_clients {ev['participating']}")
    assert all(sum(e["drift_hist"]) == 2 and "loss" in e for e in rounds)
    actions = [e["action"] for e in events if e["event"] == "profile"]
    assert actions == ["start_trace", "stop_trace"]
    assert os.path.exists(os.path.join(trace_dir, "rounds_1-2.trace.json"))
    report = subprocess.run(
        [sys.executable, str(ROOT / "benchmarks" / "report.py"), jsonl,
         "-o", str(tmp_path / "report.html")], capture_output=True,
        text=True, timeout=120)
    assert report.returncode == 0, report.stderr
    assert os.path.getsize(tmp_path / "report.html") > 1000


def test_cli_takes_telemetry_and_trace_flags(capsys, tmp_path):
    jsonl = str(tmp_path / "c.jsonl")
    main(["--arch", "fedlm-100m", "--steps", "2", "--clients", "2",
          "--batch", "1", "--seq-len", "8", "--device", "cpu",
          "--log-every", "1", "--telemetry", f"jsonl:{jsonl},stdout",
          "--trace-rounds", "0", "--trace-dir", str(tmp_path / "tr")])
    out = capsys.readouterr().out
    assert "final loss:" in out and "[telemetry] round     1" in out
    events = [json.loads(line) for line in open(jsonl)]
    assert events[0]["event"] == "manifest"
    assert sum(e["event"] == "round" for e in events) == 2
    assert (tmp_path / "tr" / "rounds_0-1.trace.json").exists()
