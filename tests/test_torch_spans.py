"""The port's span recorder (``repro_torch/utils/spans.py``), on the CPU.

* Off (the default) a FedCET ``shift:q8`` round over the arena and a
  per-leaf one give bitwise the state they give with the recorder on, and
  off records nothing and constructs no ``torch.cuda.Event`` and no
  ``record_function``.
* On, the round runner's spans nest as the round does: ``local`` and
  ``comm`` in ``round``, ``grad`` in both, ``loss`` and ``telemetry``
  after the round with its index.
* A hand-built span tree: parents, round indices, self time, counters;
  ``enable()`` refused while records wait for ``drain()``.
* One clock a window: the first span since ``enable()`` chooses CUDA
  events or the host's clock for every span of the window.
* The shared clock: inside a CPU ``torch.profiler`` session each
  ``repro_torch.*`` range lies within its recorded span, converted by the
  trace's ``baseTimeNanoseconds``.
* ``TraceSession`` turns the recorder on inside its window, so the Chrome
  trace it writes names ``repro_torch.round`` and ``repro_torch.grad``.
"""

import json
import time

import pytest
import torch

from repro_torch.configs.base import FedScenario
from repro_torch.core import FedCET
from repro_torch.core import telemetry as T
from repro_torch.core.engine import make_round_runner
from repro_torch.utils import spans
from repro_torch.utils.tree import tree_leaves

C, TAU, B = 4, 2, 5


@pytest.fixture(autouse=True)
def _recorder_left_off():
    spans.disable()
    spans.drain()
    yield
    spans.disable()
    spans.drain()


def _loss(p, b):
    return torch.mean((b["a"] @ p["w"] + p["b"] - b["y"]) ** 2)


def _problem(rounds=2):
    g = torch.Generator().manual_seed(0)
    x0 = {"w": torch.randn(8, 3, generator=g),
          "b": torch.randn(3, generator=g)}
    data = {"a": torch.randn(rounds, TAU, C, B, 8, generator=g),
            "y": torch.randn(rounds, TAU, C, B, 3, generator=g)}
    return x0, data


def _run(arena: bool, on: bool):
    """Init and two logged rounds of FedCET with ``shift:q8``; the state's
    tensors and the recording."""
    x0, data = _problem()
    algo = FedScenario(compression="shift:q8", arena=arena,
                       telemetry=True).apply(
        FedCET(alpha=0.01, c=0.05, tau=TAU, n_clients=C, x64=False))
    gf = torch.func.grad(_loss)
    state = algo.init(gf, x0, {k: v[0, 0] for k, v in data.items()})
    if on:
        spans.enable()
    run = make_round_runner(
        algo, gf, metric_with_batch=True,
        metric_fn=lambda s, b: _loss(
            {k: v[0] for k, v in algo.client_params(s).items()},
            {k: v[0, 0] for k, v in b.items()}))
    state, ys = run(state, data)
    spans.disable()
    leaves = [t for t in tree_leaves(state) if isinstance(t, torch.Tensor)]
    return leaves + tree_leaves(ys), spans.drain()


@pytest.mark.parametrize("arena", [True, False], ids=["arena", "per_leaf"])
def test_off_is_bitwise_and_silent(arena, monkeypatch):
    made = {"event": 0, "record_function": 0}
    real_event, real_rf = torch.cuda.Event, torch.profiler.record_function

    def counted(kind, real):
        def make(*a, **kw):
            made[kind] += 1
            return real(*a, **kw)
        return make

    monkeypatch.setattr(torch.cuda, "Event", counted("event", real_event))
    monkeypatch.setattr(torch.profiler, "record_function",
                        counted("record_function", real_rf))
    off, rec_off = _run(arena, on=False)
    assert made == {"event": 0, "record_function": 0}
    assert rec_off.spans == [] and rec_off.counts == {}
    on, rec_on = _run(arena, on=True)
    assert made["record_function"] == len(rec_on.spans) > 0
    assert made["event"] == 0  # no CUDA in use on the CPU
    assert len(off) == len(on)
    assert all(torch.equal(a, b) for a, b in zip(off, on))
    names = {s.name for s in rec_on.spans}
    assert {"round", "local", "comm", "grad", "dither", "fedcet_v", "loss",
            "telemetry"} <= names
    assert ("pack" in names) == arena
    assert ("transmit" in names) != arena  # the arena takes the fused tail


def test_runner_spans_nest_as_the_round():
    _, rec = _run(True, on=True)
    sp = rec.spans
    rounds = [i for i, s in enumerate(sp) if s.name == "round"]
    assert [sp[i].round for i in rounds] == [0, 1]
    assert all(sp[i].parent == -1 for i in rounds)
    for s in sp:
        if s.name in ("local", "comm"):
            assert sp[s.parent].name == "round"
        if s.name == "grad":
            assert sp[s.parent].name in ("local", "comm")
        if s.name in ("loss", "telemetry"):
            assert s.parent == -1 and s.round in (0, 1)
        assert s.ms >= 0
        assert s.start_ns <= s.end_ns
    assert {s.round for s in sp} == {0, 1}
    own = spans.self_ms(sp)
    assert all(m >= -1e-9 for m in own)


def test_hand_built_tree_parents_rounds_self_time_counts():
    spans.enable()
    with spans.span("setup"):
        spans.count("x", 5)
    for r in range(2):
        with spans.span("round"):
            with spans.span("local"):
                time.sleep(0.002)
            with spans.span("comm"):
                with spans.span("dither"):
                    time.sleep(0.003)
            spans.count("x", r + 1)
        with spans.span("loss"):
            pass
    with pytest.raises(RuntimeError, match="open span"):
        with spans.span("round"):
            spans.drain()
    spans.disable()
    with spans.span("off"):  # off: nothing recorded
        spans.count("x", 100)
    rec = spans.drain()
    names = [s.name for s in rec.spans]
    assert names == ["setup"] + ["round", "local", "comm", "dither",
                                 "loss"] * 2 + ["round"]
    assert [s.parent for s in rec.spans] == [-1, -1, 1, 1, 3, -1,
                                             -1, 6, 6, 8, -1, -1]
    assert [s.round for s in rec.spans] == [-1] + [0] * 5 + [1] * 5 + [2]
    assert rec.counts == {"x": {-1: 5, 0: 1, 1: 2}}
    own = spans.self_ms(rec.spans)
    sp = rec.spans
    assert own[1] == pytest.approx(sp[1].ms - sp[2].ms - sp[3].ms)
    assert own[3] == pytest.approx(sp[3].ms - sp[4].ms)
    assert own[4] == sp[4].ms >= 3.0
    assert sp[2].ms >= 2.0
    assert spans.drain() == spans.Recording([], {})
    with spans.span("setup"):  # off: records nothing, so nothing waits
        pass
    spans.enable()
    with spans.span("round"):
        pass
    spans.disable()
    with pytest.raises(RuntimeError, match="not drained"):
        spans.enable()
    assert [s.round for s in spans.drain().spans] == [0]
    spans.enable()
    assert not spans.drain().spans


class _FakeEvent:
    """A timing event on the host's clock, for the CPU."""

    made = 0

    def __init__(self, enable_timing=False):
        _FakeEvent.made += 1
        self.ns = None

    def record(self):
        self.ns = time.perf_counter_ns()

    def elapsed_time(self, end):
        return (end.ns - self.ns) / 1e6


def test_one_clock_a_window(monkeypatch):
    cuda_on = [False]
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: cuda_on[0])
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(torch.cuda, "memory_stats", lambda: {
        "segment.all.allocated": 3 * _FakeEvent.made,
        "num_alloc_retries": 0})
    _FakeEvent.made = 0
    spans.enable()
    with spans.span("round"):  # CUDA starts inside the window's first span
        cuda_on[0] = True
        with spans.span("grad"):
            pass
    spans.disable()
    rec = spans.drain()
    assert _FakeEvent.made == 0 and rec.counts == {}
    assert [s.name for s in rec.spans] == ["round", "grad"]
    spans.enable()  # CUDA in use from the first span: every span on events
    with spans.span("round"):
        with spans.span("grad"):
            time.sleep(0.002)
    spans.disable()
    rec = spans.drain()
    assert _FakeEvent.made == 4
    assert rec.counts == {"mallocs": {0: 12}, "alloc_retries": {0: 0}}
    outer, inner = rec.spans
    assert outer.ms >= inner.ms >= 2.0
    assert spans.self_ms(rec.spans)[0] == pytest.approx(outer.ms - inner.ms)


def test_profiler_ranges_lie_within_their_spans(tmp_path):
    path = tmp_path / "cpu.trace.json"
    spans.enable()
    cpu = torch.profiler.ProfilerActivity.CPU
    with torch.profiler.profile(activities=[cpu]) as prof:
        for _ in range(3):
            with spans.span("round"):
                with spans.span("grad"):
                    torch.randn(64, 64) @ torch.randn(64, 64)
                with spans.span("comm"):
                    torch.randn(4096).sum()
    spans.disable()
    rec = spans.drain()
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    base = int(trace["baseTimeNanoseconds"])
    ranges = sorted((e for e in trace["traceEvents"]
                     if e.get("name", "").startswith(spans.PREFIX)),
                    key=lambda e: e["ts"])
    assert [e["name"] for e in ranges] == [spans.PREFIX + s.name
                                           for s in rec.spans]
    for e, s in zip(ranges, rec.spans):
        lo = base + round(e["ts"] * 1000)
        hi = lo + round(e["dur"] * 1000)
        assert s.start_ns <= lo <= hi <= s.end_ns, (e, s)


def test_trace_session_names_the_layers(tmp_path):
    x0, data = _problem(rounds=3)
    algo = FedScenario(compression="shift:q8", arena=True).apply(
        FedCET(alpha=0.01, c=0.05, tau=TAU, n_clients=C, x64=False))
    gf = torch.func.grad(_loss)
    state = algo.init(gf, x0, {k: v[0, 0] for k, v in data.items()})
    run = make_round_runner(algo, gf)
    session = T.TraceSession((1, 2), out_dir=str(tmp_path))
    for r in range(3):
        assert session.maybe_start(r) is None or r == 1
        assert spans.enabled() == (r == 1)
        state, _ = run(state, {k: v[r:r + 1] for k, v in data.items()})
        session.maybe_stop(r + 1)
        assert not spans.enabled()
    assert spans.drain().spans == []
    trace = json.loads((tmp_path / "rounds_1-2.trace.json").read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert {"repro_torch.round", "repro_torch.grad",
            "repro_torch.dither"} <= names
