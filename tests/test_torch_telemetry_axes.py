"""The port's telemetry on the two scenario axes of this slice, delay and
cohort, on the CPU in float64, on the reference's problem
(``make_quadratic_problem(0, n_clients=8, dim=24)``, carried across as
numpy).

* Mirrors of ``tests/test_telemetry.py``: the composed scenario's series
  keys and shapes (``fresh_count``, ``age_*``, ``participating`` at most
  the cohort), the invariant monitor silent under ``fixed:2`` + ``poly:1``
  (uniform ages) and firing under ``rr:2`` + ``poly:1``, naming the axis.
* Mirrors of ``tests/test_telemetry_dist.py``: the rate monitor
  reproduces the staleness boundary live and from the JSONL alone;
  ``rate_axis`` names the delay axis; the gather and dense cohort
  lowerings sketch identically (integer series exactly, floats within
  1e-12).
* Against the reference: the composed scenario's ``age`` sketch, the
  staleness scalars and the cohort's global top ids equal the reference's
  series (``tests/test_torch_telemetry.py`` holds every other series).
"""

import numpy as np
import torch

from repro_torch.configs.base import FedScenario
from repro_torch.core import FedCET, max_weight_c
from repro_torch.core import telemetry as T
from repro_torch.core.engine import with_delay, with_telemetry
from repro_torch.core.lr_search import lr_search
from repro_torch.core.simulate import simulate_quadratic
from repro_torch.data.quadratic import QuadraticProblem

ROUNDS = 6
COMPOSED = dict(compression="shift:q8", participation=0.8, delay="fixed:2",
                stale_policy="poly:1", cohort="block:4", arena=True)


def _jax():
    import jax

    jax.config.update("jax_enable_x64", True)
    return jax


def _reference_problem():
    _jax()
    from repro.data.quadratic import make_quadratic_problem

    return make_quadratic_problem(0, n_clients=8, dim=24)


JP = _reference_problem()
PROB = QuadraticProblem(b=torch.tensor(np.asarray(JP.b)),
                        m=torch.tensor(np.asarray(JP.m)))


def _fedcet(problem=PROB, pkg_fedcet=FedCET, tau=2):
    alpha = lr_search(problem.mu, problem.L, tau)
    return pkg_fedcet(alpha=alpha, c=max_weight_c(problem.mu, alpha),
                      tau=tau, n_clients=problem.n_clients)


def _sim(algo, rounds=ROUNDS):
    return simulate_quadratic(algo, PROB, rounds, device="cpu")


def test_series_keys_and_shapes():
    """Mirror of ``tests/test_telemetry.py::test_series_keys_and_shapes``
    on the composed scenario (delay and cohort included)."""
    algo = FedScenario(telemetry=True, **COMPOSED).apply(_fedcet())
    series = _sim(algo, 8).telemetry
    for key in ("grad_norm", "msg_norm", "compress_err", "participating",
                "fresh_count", "age_min", "age_mean", "age_max",
                "invariant_residual", "consensus_err"):
        assert key in series, sorted(series)
        assert len(series[key]) == 8
    assert bool((series["participating"] <= 4).all())  # cohort size
    assert bool((series["grad_norm"] > 0).all())


def _residual_series(delay, policy, rounds=24):
    algo = _fedcet()
    if delay != "none":
        algo = with_delay(algo, delay, policy=policy)
    res = _sim(with_telemetry(algo, True), rounds)
    events = T.drain(res.telemetry, monitors=(T.INVARIANT_MONITOR,))
    warns = [e for e in events if e["event"] == "monitor"]
    residuals = [e["invariant_residual"] for e in events
                 if e["event"] == "round"]
    return residuals, warns


def test_invariant_monitor_silent_on_exact_scenarios():
    """The ``fixed:2`` + ``poly:1`` case of
    ``tests/test_telemetry.py::test_invariant_monitor_silent_on_exact_scenarios``
    (the ``none`` case is ``tests/test_torch_telemetry_dist.py``'s): ages
    are uniform, so are the weights; the residual stays below 1e-9 and
    no WARN fires."""
    residuals, warns = _residual_series("fixed:2", "poly:1")
    assert max(residuals) < 1e-9, max(residuals)
    assert not warns, warns[:1]


def test_invariant_monitor_fires_on_poly_staleness():
    """Mirror of ``tests/test_telemetry.py::test_invariant_monitor_fires_on_poly_staleness``."""
    residuals, warns = _residual_series("rr:2", "poly:1")
    assert max(residuals) > 1e-4
    assert warns, "monitor must fire"
    w = warns[0]
    assert w["level"] == "WARN" and w["metric"] == "invariant_residual"
    assert "stale_policy" in w["axis"]


def _boundary_run(delay_spec, path):
    algo = with_telemetry(with_delay(_fedcet(), delay_spec, policy="poly:1"),
                          True)
    monitors = (T.RateMonitor(axis=T.rate_axis(algo)),)
    res = _sim(algo, 48)
    sinks = T.parse_sinks(f"jsonl:{path}")
    events = T.drain({**res.telemetry, "err": res.errors[1:]}, sinks=sinks,
                     monitors=monitors, algo=algo, n_params=PROB.dim)
    T.close_sinks(sinks)
    return [e for e in events if e.get("kind") == "rate_break"]


def test_rate_monitor_reproduces_staleness_boundary(tmp_path):
    """Mirror of ``tests/test_telemetry_dist.py::test_rate_monitor_reproduces_staleness_boundary``:
    rr:2 + poly:1 breaks the rate and names ``stale_policy`` (rho_hat >=
    0.99), fixed:2 + poly:1 stays silent, and the JSONL replays both."""
    silent = _boundary_run("fixed:2", str(tmp_path / "fixed2.jsonl"))
    assert not silent, silent[:1]
    breaks = _boundary_run("rr:2", str(tmp_path / "rr2.jsonl"))
    assert breaks, "no rate break on rr:2 + poly:1"
    assert "stale_policy" in breaks[0]["axis"]
    assert breaks[0]["rho_hat"] >= 0.99
    replayed = [w for w in T.replay_jsonl(str(tmp_path / "rr2.jsonl"),
                                          (T.RateMonitor(),))
                if w.get("kind") == "rate_break"]
    assert replayed and replayed[0]["round"] == breaks[0]["round"]
    again = [w for w in T.replay_jsonl(str(tmp_path / "fixed2.jsonl"),
                                       (T.RateMonitor(),))
             if w.get("kind") == "rate_break"]
    assert not again


def test_rate_axis_names_lossy_axes():
    """The delay case of ``tests/test_telemetry_dist.py::test_rate_axis_names_lossy_axes``."""
    base = _fedcet()
    assert "no lossy axis" in T.rate_axis(base)
    assert "stale_policy" in T.rate_axis(
        with_delay(base, "rr:2", policy="poly:1"))


SKETCH_SPEC = dict(sketches="auto", topk=3, leaf_stats=True)


def _sketch_keys(series):
    return sorted(k for k in series
                  if any(k.startswith(s + "_") for s in T.SKETCH_SOURCES))


def test_cohort_and_dense_lowerings_sketch_identically():
    """Mirror of ``tests/test_telemetry_dist.py::test_cohort_and_dense_lowerings_sketch_identically``:
    the sketches read the post-round store, which both lowerings produce
    equal: histograms and ids exactly, quantiles within 1e-12."""
    res_g = _sim(FedScenario(telemetry=T.Telemetry(**SKETCH_SPEC),
                             **COMPOSED).apply(_fedcet()))
    res_d = _sim(FedScenario(telemetry=T.Telemetry(**SKETCH_SPEC),
                             **{**COMPOSED, "cohort": "block:4:dense"}).apply(
        _fedcet()))
    keys = _sketch_keys(res_g.telemetry)
    assert "age_hist" in keys and "compress_err_top_ids" in keys
    assert keys == _sketch_keys(res_d.telemetry)
    for k in keys:
        a, b = res_g.telemetry[k], res_d.telemetry[k]
        if not a.is_floating_point():
            assert torch.equal(a, b), k
        else:
            assert float((a - b).abs().max()) <= 1e-12, k


def test_composed_axes_series_match_the_reference():
    """The composed scenario in both packages: the arrivals, the ages and
    their sketch, the participant count and the compression error's top
    ids (GLOBAL client ids through the captured cohort index) equal the
    reference's series exactly."""
    _jax()
    from repro.configs.base import FedScenario as JScenario
    from repro.core import FedCET as JFedCET
    from repro.core import Telemetry as JTelemetry
    from repro.core.simulate import simulate_quadratic as jsim

    got = _sim(FedScenario(telemetry=T.Telemetry(**SKETCH_SPEC),
                           **COMPOSED).apply(_fedcet())).telemetry
    want = jsim(JScenario(telemetry=JTelemetry(**SKETCH_SPEC),
                          **COMPOSED).apply(_fedcet(JP, JFedCET)), JP,
                rounds=ROUNDS).telemetry
    for k in ("fresh_count", "age_min", "age_max", "age_mean",
              "participating", "age_hist", "age_top_ids",
              "compress_err_top_ids", "compress_err_hist"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
