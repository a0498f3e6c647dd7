"""The port's in-round telemetry against the JAX package's, on the CPU.

* Every series on the float64 quadratic (``make_quadratic_problem(0,
  n_clients=8, dim=24)`` passed in as numpy, 6 rounds, the full spec
  ``Telemetry(sketches="auto", topk=3, leaf_stats=True)``): FedCET under
  ``none``, ``shift:q8`` x 0.8 participation, the arena (the sketches'
  kernel route, its plain version here), ``ring:sparse`` and
  ``hier:g5``, the reference's ``composed`` scenario (``shift:q8`` x 0.8
  participation x ``fixed:2`` / ``poly:1`` x a ``block:4`` cohort on the
  arena), and NIDS over ``ring:sparse``. Float series agree within
  1e-12 of the series' scale (its largest magnitude; 1 for the
  invariant residual, a ratio that sits at rounding noise in these exact
  scenarios), histograms and top ids exactly.
* The port's own telemetry on/off identity on the same scenarios: the
  final state and the error curve differ by exactly 0.0. (The reference's
  own on/off cases for ``bare``/``hier`` fail on this host; the port is
  held against its own off path.)
* The reduced fedlm-100m in float64, ``ring:sparse`` on the arena, 2
  rounds from JAX's weights and tokens (``models/convert.py``). The model
  computes RMSNorm, RoPE, softmax and logits in float32 whatever the
  parameter dtype, so the two packages' states drift apart by ~1e-6 of
  scale (``tests/test_torch_train.py``) and the series are held within
  1e-5 of their scale, histograms and top ids exactly. The state-derived
  series computed on the SAME state (JAX's, carried across) agree within
  1e-12. The run manifest and the drained JSONL events carry the same
  keys, event by event, and the same values (all but ``commit`` and
  ``mesh``; round values within the series bound).
"""

import json

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import FedScenario
from repro_torch.core import FedCET, max_weight_c
from repro_torch.core import telemetry as T
from repro_torch.core.arena import Arena
from repro_torch.core.baselines import NIDS
from repro_torch.core.comm import CommMeter, leaf_info_of
from repro_torch.core.engine import (make_round_runner, with_telemetry,
                                     with_topology)
from repro_torch.core.fedcet import FedCETState
from repro_torch.core.lr_search import lr_search
from repro_torch.core.simulate import simulate_quadratic
from repro_torch.data.quadratic import QuadraticProblem
from repro_torch.models import build_model
from repro_torch.models.convert import params_from_numpy
from repro_torch.utils.tree import tree_leaves

ROUNDS, TAU = 6, 2
SCENARIOS = {
    "none": {},
    "shift_q8_p0.8": dict(compression="shift:q8", participation=0.8),
    "arena": dict(arena=True),
    "ring_sparse": dict(topology="ring:sparse"),
    "hier_g5": dict(topology="hier:g5"),
    "composed": dict(compression="shift:q8", participation=0.8,
                     delay="fixed:2", stale_policy="poly:1",
                     cohort="block:4", arena=True),
    "nids_ring_sparse": None,
}


def _jax():
    import jax

    jax.config.update("jax_enable_x64", True)
    return jax


@pytest.fixture(scope="module")
def problems():
    _jax()
    from repro.data.quadratic import make_quadratic_problem as jmake

    jp = jmake(0, n_clients=8, dim=24)
    port = QuadraticProblem(b=torch.tensor(np.asarray(jp.b)),
                            m=torch.tensor(np.asarray(jp.m)))
    return jp, port


def _algo(pkg, name, port, spec):
    """``name``'s algorithm from either package (``pkg``: a namespace of
    ``FedCET``, ``FedScenario``, ``NIDS``, ``with_topology``,
    ``with_telemetry``, ``Telemetry``)."""
    if name == "nids_ring_sparse":
        algo = pkg.with_topology(pkg.NIDS(alpha=1.0 / port.L,
                                          n_clients=port.n_clients),
                                 "ring:sparse")
        return pkg.with_telemetry(algo, spec)
    alpha = lr_search(port.mu, port.L, TAU)
    base = pkg.FedCET(alpha=alpha, c=max_weight_c(port.mu, alpha), tau=TAU,
                      n_clients=port.n_clients)
    return pkg.FedScenario(telemetry=spec, **SCENARIOS[name]).apply(base)


class _Port:
    FedCET, FedScenario, NIDS = FedCET, FedScenario, NIDS
    with_topology, with_telemetry = staticmethod(with_topology), \
        staticmethod(with_telemetry)
    Telemetry = T.Telemetry


def _ref():
    _jax()
    from repro.configs.base import FedScenario as JScenario
    from repro.core import NIDS as JNIDS
    from repro.core import FedCET as JFedCET
    from repro.core import Telemetry as JTelemetry
    from repro.core import with_telemetry as jwt
    from repro.core import with_topology as jtopo

    class Ref:
        FedCET, FedScenario, NIDS = JFedCET, JScenario, JNIDS
        with_topology, with_telemetry = staticmethod(jtopo), \
            staticmethod(jwt)
        Telemetry = JTelemetry

    return Ref


def _spec(pkg):
    return pkg.Telemetry(sketches="auto", topk=3, leaf_stats=True)


def _assert_series_close(got: dict, want: dict, rel: float):
    """Same keys; integer series equal; float series within ``rel`` of the
    series' scale (1 for the invariant residual, already a ratio)."""
    assert sorted(got) == sorted(want)
    for k in want:
        a = got[k].numpy() if isinstance(got[k], torch.Tensor) \
            else np.asarray(got[k])
        b = np.asarray(want[k])
        assert a.shape == b.shape, k
        if b.dtype.kind in "iu":
            np.testing.assert_array_equal(a, b, err_msg=k)
            continue
        scale = 1.0 if k == "invariant_residual" else float(np.abs(b).max())
        np.testing.assert_allclose(a, b, rtol=0, atol=rel * scale,
                                   err_msg=k)


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_every_series_matches_reference_on_the_quadratic(problems, name):
    from repro.core.simulate import simulate_quadratic as jsim

    jp, port = problems
    ref = _ref()
    want = jsim(_algo(ref, name, port, _spec(ref)), jp, ROUNDS).telemetry
    got = simulate_quadratic(_algo(_Port, name, port, _spec(_Port)), port,
                             ROUNDS, device="cpu").telemetry
    _assert_series_close(got, want, 1e-12)
    assert "drift_hist" in got
    if name != "nids_ring_sparse":
        assert "d_norm_hist" in got and "invariant_residual" in got
    if name.startswith("shift"):
        assert "compress_err_hist" in got and "leaf_compress_err" in got


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_telemetry_on_is_bitwise_identical_to_off(problems, name):
    _, port = problems
    off = simulate_quadratic(_algo(_Port, name, port, None), port, ROUNDS,
                             device="cpu")
    on = simulate_quadratic(_algo(_Port, name, port, _spec(_Port)), port,
                            ROUNDS, device="cpu")
    assert off.telemetry is None and on.telemetry
    assert float((on.errors - off.errors).abs().max()) == 0.0
    la, lb = tree_leaves(on.state), tree_leaves(off.state)
    assert len(la) == len(lb)
    for a, b in zip(la, lb):
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and float((a - b).abs().max()) == 0.0
        else:
            assert a == b


# ------------------------------------------------------------- tiny LM
C, B, S = 4, 2, 16
LM_SCENARIO = dict(topology="ring:sparse", arena=True)
LM_CONFIG = {"arch": "fedlm-100m", "steps": 2, "tau": TAU, "n_clients": C}


def _jax_lm():
    jax = _jax()
    import jax.numpy as jnp
    from repro.configs import get_config as jget
    from repro.core.engine import make_round_runner as jrunner
    from repro.core.fedcet import FedCET as JFedCET
    from repro.core.telemetry import split_metrics as jsplit
    from repro.data.synthetic import make_hetero_lm_dataset
    from repro.models import build_model as jbuild

    ref = _ref()
    cfg = jget("fedlm-100m").reduced().with_dtype("float64")
    model = jbuild(cfg)
    params = model.init(jax.random.key(0))
    ds = make_hetero_lm_dataset(cfg.vocab_size, C, S, B, seed=0)
    tokens = np.stack([np.asarray(ds.sample_round(r, TAU))
                       for r in range(2)])
    algo = ref.FedScenario(telemetry=_spec(ref), **LM_SCENARIO).apply(
        JFedCET(alpha=3e-3, c=0.05, tau=TAU, n_clients=C))
    grad = jax.grad(model.loss)
    state = jax.jit(lambda p, b: algo.init(grad, p, b))(
        params, {"tokens": tokens[0][0]})

    def loss(s, b):
        return jnp.mean(jax.vmap(model.loss)(
            algo.client_params(s), {"tokens": b["tokens"][0]}))

    run = jrunner(algo, grad, metric_fn=loss, metric_with_batch=True)
    state, ys = run(state, {"tokens": jnp.asarray(tokens)})
    losses, series = jsplit(algo, ys)
    return (algo, jax.tree.map(np.asarray, params), tokens, state,
            np.asarray(losses), jax.tree.map(np.asarray, series))


def _events(pkg_tele, algo, params, series, losses, path, leaf_info_fn,
            meter_cls, **kw):
    """Manifest + drained round events of one package, as run_training
    writes them, read back from a JSONL file."""
    spec = algo.telemetry
    monitors = pkg_tele.resolve_monitors(spec, algo)
    info = leaf_info_fn(params)
    meter = meter_cls.for_params(params, algo=algo, n_clients=C)
    sink = pkg_tele.JsonlSink(str(path))
    sink.emit(pkg_tele.run_manifest(algo, n_params=meter.n_params,
                                    config=LM_CONFIG, monitors=monitors,
                                    leaf_info=info, **kw))
    pkg_tele.drain({**series, "loss": losses}, sinks=[sink],
                   monitors=monitors, algo=algo, n_params=meter.n_params,
                   leaf_names=[nm for nm, _ in info],
                   leaf_bits=meter.leaf_bits)
    sink.close()
    return [json.loads(line) for line in open(path)]


def _close_value(a, b, rel, key):
    if isinstance(b, list):
        assert len(a) == len(b), key
        for x, y in zip(a, b):
            _close_value(x, y, rel, key)
    elif isinstance(b, float):
        assert abs(a - b) <= rel * max(abs(b), 1e-300) or a == b, (key, a, b)
    else:
        assert a == b, (key, a, b)


def test_tiny_lm_series_and_events_match_reference(tmp_path):
    jax = _jax()
    from repro.core import telemetry as jtele
    from repro.core.comm import CommMeter as JMeter
    from repro.core.comm import leaf_info_of as jinfo

    jalgo, params, tokens, jstate, jlosses, jseries = _jax_lm()
    model = build_model(get_config("fedlm-100m").reduced().with_dtype(
        "float64"))
    algo = FedScenario(telemetry=_spec(_Port), **LM_SCENARIO).apply(
        FedCET(alpha=3e-3, c=0.05, tau=TAU, n_clients=C))
    grad = torch.func.grad(model.loss)
    tp = params_from_numpy(params)
    state = algo.init(grad, tp, {"tokens": torch.tensor(tokens[0][0])})

    def loss(s, b):
        return torch.mean(torch.func.vmap(model.loss)(
            algo.client_params(s), {"tokens": b["tokens"][0]}))

    run = make_round_runner(algo, grad, metric_fn=loss,
                            metric_with_batch=True)
    state, ys = run(state, {"tokens": torch.tensor(tokens)})
    losses, series = T.split_metrics(algo, ys)
    _assert_series_close(series, jseries, 1e-5)
    np.testing.assert_allclose(losses.numpy(), jlosses, rtol=1e-6)

    # the state-derived series on the same (JAX's) post-round state.
    lay = state.x.layout
    same = FedCETState(x=Arena(torch.tensor(np.asarray(jstate.x.data)), lay),
                       d=Arena(torch.tensor(np.asarray(jstate.d.data)), lay),
                       t=int(jstate.t))
    want = jax.tree.map(np.asarray, jalgo.telemetry.finalize({}, jalgo,
                                                             jstate))
    _assert_series_close(algo.telemetry.finalize({}, algo, same), want,
                         1e-12)

    got_ev = _events(T, algo, tp, series, losses, tmp_path / "port.jsonl",
                     leaf_info_of, CommMeter, device="cpu")
    want_ev = _events(jtele, jalgo, params, jseries, jlosses,
                      tmp_path / "ref.jsonl", jinfo, JMeter)
    assert [e["event"] for e in got_ev] == [e["event"] for e in want_ev]
    assert got_ev[0]["event"] == "manifest"
    assert sum(e["event"] == "round" for e in got_ev) == 2
    for g, w in zip(got_ev, want_ev):
        assert sorted(g) == sorted(w), (g["event"], sorted(g), sorted(w))
        rel = 0.0 if g["event"] == "manifest" else 1e-5
        for k in w:
            if k in ("commit", "mesh"):
                continue
            if k == "invariant_residual":
                assert abs(g[k] - w[k]) <= 1e-12
                continue
            _close_value(g[k], w[k], rel, k)
    assert got_ev[0]["mesh"] == {"backend": "cpu", "n_devices": 1}


# ---------------------------------------------------- instruction_count
def test_instruction_count_exact_on_three_ops():
    """mul, add and sum: three aten operations, on any device."""
    x = torch.ones(5, dtype=torch.float64)
    assert T.instruction_count(lambda t: (t * 2.0 + 1.0).sum(), x) == 3


def test_instruction_count_grows_with_telemetry(problems, tmp_path):
    """One 8-client ``ring:sparse`` round with ``jsonl,hist:48`` telemetry
    dispatches more operations than the same round without."""
    _, port = problems

    def count(spec):
        algo = _algo(_Port, "ring_sparse", port, spec)
        return T.instruction_count(simulate_quadratic, algo, port, 1,
                                   device="cpu")

    off = count(None)
    on = count(f"jsonl:{tmp_path / 'run.jsonl'},hist:48")
    assert port.n_clients == 8
    assert on > off > 0, (on, off)
