"""In-round telemetry: per-round metrics, invariant monitors, event sinks,
distribution sketches and the profiler window (port of
``src/repro/core/telemetry.py:80-949``).

The reference captures scalars while its jitted round is traced; PyTorch
runs eagerly, so the same dynamic-scope tape records device tensors as
the round runs:

* :func:`capture` writes a named value onto the active **tape**, which the
  round runner opens around ``algo.round`` with :func:`collect`. Outside a
  tape (direct ``algo.round`` calls, ``init``) and inside :func:`muted`
  regions (the engine mutes its ``tau - 1`` local steps) it does nothing.
  A capture is a new tensor on the device, never a view of a state
  buffer, and nothing here reads a value back to the host.
* :meth:`Telemetry.finalize` turns tape + post-round state into the
  round's metric dict: the tape plus FedCET's ``sum_i d_i = 0`` invariant
  residual (Lemma 2, relative: ``||mean_i d_i|| / mean_i ||d_i||``), the
  consensus error ``max_i ||x_i - x_bar||`` and, when the spec asks, the
  population sketches of the per-client ``||d_i||`` and drift
  ``||x_i - x_bar||`` (log10 histogram, p50/p90/p99/max, top-k outlier
  ids). On a packed arena the norm + histogram pass goes through the CUDA
  kernel of ``kernels/csrc/telemetry_reduce.cu``
  (``kernels/ops.py:telemetry_sketch``).
* :func:`drain` copies a segment's stacked series to the host ONCE and
  emits per-round events (plus :class:`Monitor` WARN events and bit
  accounting from ``core/comm.py``) into sinks: :class:`JsonlSink` (one
  JSON object per line, manifest first; the reference's schema, so
  ``benchmarks/report.py`` renders a port run unchanged),
  :class:`CsvSink`, :class:`StdoutSink`, :class:`MemorySink`.
* :class:`RateMonitor` fits the windowed linear rate ``rho_hat`` at drain
  time and WARNs (``rate_break``) when a contracting series stalls.
* :class:`TraceSession` brackets a ``--trace-rounds a:b`` window with
  ``torch.profiler`` (CPU and CUDA activities) and writes a Chrome trace
  under its ``out_dir``; inside the window the span recorder is on, so
  the trace names the round's layers (``repro_torch.round``, ``.grad``,
  ``.dither``, ...).
* :mod:`spans` (``repro_torch.utils.spans``, re-exported here) is the
  same dynamic-scope idea for time: spans at the layer boundaries of a
  round (``span``, ``spanned``), counters (``count``), on and off
  (``enable``, ``disable``), and the records (``spans.drain()``); off by
  default, where a span costs one bool check. Its docstring lists the
  sites.

Telemetry disabled (``algo.telemetry is None``) adds no operation: the
engine guards every capture on the attached spec.
:func:`instruction_count` is the counterpart of the reference's count of
optimized-HLO instructions: eager PyTorch has no compiled program, so it
counts the aten operations one call dispatches, the same on the CPU and
on the card.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import subprocess
from typing import Any

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.kernels import ops
from repro_torch.kernels.ref import log_histogram
from repro_torch.utils import spans  # noqa: F401  (re-exported)
from repro_torch.utils.spans import spanned
from repro_torch.utils.tree import tree_leaves, tree_map

# ------------------------------------------------------------------ the tape
#: stack of active collectors (nested collect()s shadow like dynamic scope)
#: and a mute depth counter.
_TAPES: list[dict] = []
_MUTE: int = 0


def collecting() -> bool:
    """True when a tape is active and not muted: the engine's guard for
    building capture ops at all."""
    return bool(_TAPES) and _MUTE == 0


def capture(name: str, value) -> None:
    """Record a named value on the active tape (no-op without one).
    Repeated captures of the same name within a round keep the LAST value
    (``grad_norm`` at the aggregating step, not a ``begin_round`` probe)."""
    if collecting():
        _TAPES[-1][name] = value


@contextlib.contextmanager
def collect():
    """Open a tape around a round; yields the dict of captured tensors."""
    tape: dict = {}
    _TAPES.append(tape)
    try:
        yield tape
    finally:
        _TAPES.pop()


@contextlib.contextmanager
def muted():
    """Suppress captures (the engine's ``tau - 1`` local steps)."""
    global _MUTE
    _MUTE += 1
    try:
        yield
    finally:
        _MUTE -= 1


# ----------------------------------------------------------- metric helpers
def _leaf_sq(a: torch.Tensor) -> torch.Tensor:
    return torch.sum(torch.square(a), dim=tuple(range(1, a.dim())))


def client_sq_norms(tree):
    """``[clients]`` squared L2 norms: per-client sum of squares over every
    leaf's non-leading axes (an Arena leaf's zero pads contribute
    nothing, so packed == per-leaf)."""
    tot = None
    for a in tree_leaves(tree):
        s = _leaf_sq(a)
        tot = s if tot is None else tot + s
    return tot


def mean_client_norm(tree):
    """Mean over clients of the per-client L2 norm."""
    return torch.mean(torch.sqrt(client_sq_norms(tree)))


def _tree_norm(tree):
    return torch.sqrt(sum(torch.sum(torch.square(a))
                          for a in tree_leaves(tree)))


# ------------------------------------------------------ distribution sketches
#: the state-derived per-client distributions ``sketches="auto"`` tracks
#: (each is silently absent when its source state is: no ``age_*`` without
#: a delay model, no ``compress_err_*`` without transforms).
SKETCH_SOURCES = ("d_norm", "drift", "compress_err", "age")


def _finish_sketch(name, vals, hist, spec, ids=None, top=None) -> dict:
    """Quantiles + top-k around a per-client value vector whose histogram
    is already computed; ``ids`` maps local indices to global client ids,
    ``top`` passes kernel-route top-k through."""
    q = torch.quantile(vals, torch.tensor([0.5, 0.9, 0.99], dtype=vals.dtype,
                                          device=vals.device))
    tv, ti = ops.top_k(vals, spec.topk) if top is None else top
    if ids is not None:
        ti = ids[ti]
    return {f"{name}_hist": hist,
            f"{name}_p50": q[0], f"{name}_p90": q[1], f"{name}_p99": q[2],
            f"{name}_max": torch.max(vals),
            f"{name}_top_vals": tv, f"{name}_top_ids": ti}


def sketch_values(name, vals, spec, ids=None) -> dict:
    """Distribution sketch of a per-client ``[n]`` value vector: log-bin
    histogram, p50/p90/p99/max and the top-k outlier (value, client-id)
    pairs, all still on the device."""
    if not vals.dtype.is_floating_point:
        vals = vals.to(torch.float32)
    hist = log_histogram(vals, spec.hist_bins, spec.hist_lo, spec.hist_hi)
    return _finish_sketch(name, vals, hist, spec, ids=ids)


def sketch_client_norms(name, tree, spec, ids=None) -> dict:
    """Sketch the per-client L2 norms of a ``[clients, ...]`` state tree. A
    packed-arena tree takes the one-pass norm + histogram kernel
    (``kernels/ops.py:telemetry_sketch``: the CUDA kernel on the card, its
    plain version on the CPU); any other tree takes the generic
    ``client_sq_norms`` path. Both bin identically."""
    from repro_torch.core.arena import Arena

    if isinstance(tree, Arena) and tree.data.dim() == 3:
        norms, hist, tv, ti = ops.telemetry_sketch(
            tree.data, bins=spec.hist_bins, lo=spec.hist_lo,
            hi=spec.hist_hi, k=spec.topk)
        return _finish_sketch(name, norms, hist, spec, ids=ids,
                              top=(tv, ti))
    return sketch_values(name, torch.sqrt(client_sq_norms(tree)), spec,
                         ids=ids)


def leaf_client_norms(tree):
    """``[n_leaves]`` mean-client L2 norm per MODEL leaf (the per-leaf
    breakdown of ``msg_norm`` / ``compress_err``). On an arena the
    reduction runs over the packed buffer through the row->leaf segment
    map; on a plain tree it is the per-leaf norm stack."""
    from repro_torch.core.arena import Arena

    if isinstance(tree, Arena):
        data = tree.data
        seg = tree.layout.row_segments(data.device)
        n_leaves = len(tree.layout.shapes)
        row_sq = torch.sum(torch.square(data), dim=-1)
        if row_sq.dim() == 1:
            row_sq = row_sq[None, :]
        per = torch.zeros((n_leaves, row_sq.shape[0]), dtype=row_sq.dtype,
                          device=row_sq.device).index_add_(0, seg, row_sq.T)
        return torch.mean(torch.sqrt(per), dim=1)
    return torch.stack([torch.mean(torch.sqrt(_leaf_sq(a)))
                        for a in tree_leaves(tree)])


# ------------------------------------------------------------------ monitors
@dataclasses.dataclass(frozen=True)
class Monitor:
    """Declarative per-round alert: WARN when ``metric`` crosses ``bound``
    (``mode="max"``: value > bound; ``"min"``: value < bound). ``axis``
    names the scenario axis the violation implicates."""

    metric: str
    bound: float
    mode: str = "max"
    axis: str = ""

    def violated(self, value) -> bool:
        v = float(value)
        return v > self.bound if self.mode == "max" else v < self.bound


#: FedCET's redistributive drift updates keep sum_i d_i = 0 exactly (Lemma
#: 2) under every exact scenario; non-uniform stale-policy weights and tier
#: recompression break the redistribution. The residual is RELATIVE
#: (||mean_i d_i|| / mean_i ||d_i||): exact float64 scenarios sit at
#: accumulation noise (~1e-13); float32 LM runs read ~1e-4, as in the
#: reference.
INVARIANT_MONITOR = Monitor(
    metric="invariant_residual", bound=1e-6, mode="max",
    axis="stale_policy (poly:a discounting with non-uniform ages) or "
         "tier_compression — non-uniform aggregation weights break the "
         "sum_i d_i = 0 redistribution (Lemma 2)")


# ------------------------------------------------------ linear-rate estimator
def fit_rate(rounds, values) -> float:
    """Windowed log-residual regression: the least-squares slope of
    ``ln(value)`` against round index, as the per-round contraction factor
    ``rho_hat = exp(slope)`` (< 1: converging linearly; >= 1: stalled)."""
    r = np.asarray(rounds, dtype=float)
    v = np.log(np.asarray(values, dtype=float))
    r = r - r.mean()
    denom = float(np.sum(r * r)) or 1.0
    return float(math.exp(float(np.sum(r * (v - v.mean()))) / denom))


def rate_axis(algo) -> str:
    """The scenario axes attached to ``algo`` that can break the paper's
    linear rate: what a :class:`RateMonitor` WARN names as the suspects."""
    parts = []
    delay = getattr(algo, "delay", None)
    if delay is not None:
        parts.append("stale_policy (poly:a discounting under non-uniform "
                     "delay ages floors FedCET)")
    topo = getattr(algo, "topology", None)
    if topo is not None and getattr(topo, "tier_compression", None) is not None:
        parts.append("tier_compression (interior-hop recompression lacks "
                     "wire-consistency and freezes sum_i d_i)")
    if getattr(algo, "transforms", ()):
        parts.append("compression (a biased compressor without error "
                     "feedback keeps an error floor)")
    return " or ".join(parts) or "no lossy axis attached"


@dataclasses.dataclass
class RateMonitor:
    """Online linear-rate estimator + rate-break alert, evaluated at drain
    time over the streamed round events (stateful across a run's drain
    segments: :func:`resolve_monitors` builds a fresh one per run).

    Each round it appends ``(round, metric)``, fits :func:`fit_rate` over
    the trailing ``window`` points and annotates the event with
    ``rho_hat``. A rate break fires when a series that had converged
    linearly (best estimate ``<= ref_rho``) stalls (``rho_hat >=
    stall_rho``) while still above ``floor``; the WARN event carries
    ``kind="rate_break"`` and ``axis``. ``metric`` defaults to ``"err"``;
    rounds without it are skipped."""

    metric: str = "err"
    window: int = 12
    stall_rho: float = 0.99
    ref_rho: float = 0.97
    floor: float = 1e-10
    cooldown: int = 10
    axis: str = ""

    def __post_init__(self):
        self._rounds: list[int] = []
        self._values: list[float] = []
        self._best: float | None = None
        self._last_warn: int | None = None

    def observe(self, ev: dict) -> dict | None:
        """Feed one round event (annotates it with ``rho_hat`` in place);
        returns the rate-break WARN event when one fires, else None."""
        v = ev.get(self.metric)
        if not isinstance(v, (int, float)) or isinstance(v, bool) or v <= 0:
            return None
        r = int(ev.get("round", len(self._rounds)))
        self._rounds.append(r)
        self._values.append(float(v))
        if len(self._rounds) < self.window:
            return None
        rho = fit_rate(self._rounds[-self.window:],
                       self._values[-self.window:])
        ev["rho_hat"] = rho
        self._best = rho if self._best is None else min(self._best, rho)
        if (rho >= self.stall_rho and self._best <= self.ref_rho
                and v > self.floor
                and (self._last_warn is None
                     or r - self._last_warn >= self.cooldown)):
            self._last_warn = r
            return {"event": "monitor", "kind": "rate_break",
                    "level": "WARN", "metric": self.metric, "round": r,
                    "value": float(v), "rho_hat": rho,
                    "rho_ref": self._best, "axis": self.axis}
        return None


def _threshold_warn(m: Monitor, ev: dict) -> dict | None:
    v = ev.get(m.metric)
    if isinstance(v, (int, float)) and not isinstance(v, bool) \
            and m.violated(v):
        return {"event": "monitor", "level": "WARN", "metric": m.metric,
                "round": ev["round"], "value": v, "bound": m.bound,
                "mode": m.mode, "axis": m.axis}
    return None


def replay_jsonl(path: str, monitors) -> list[dict]:
    """Re-run a monitor set over a finished run's JSONL file alone: stream
    its round events through threshold :class:`Monitor` checks and
    :class:`RateMonitor` observers exactly as a live drain would, and
    return the WARN events."""
    warns: list[dict] = []
    with open(path) as f:
        for line in f:
            ev = json.loads(line)
            if ev.get("event") != "round":
                continue
            for m in monitors:
                w = m.observe(ev) if hasattr(m, "observe") \
                    else _threshold_warn(m, ev)
                if w:
                    warns.append(w)
    return warns


# ------------------------------------------------------------- the spec
@dataclasses.dataclass(frozen=True)
class Telemetry:
    """The telemetry spec attached to an engine algorithm
    (``with_telemetry`` / ``FedScenario(telemetry=...)``). Hashable and
    stateless: it adds no algorithm state.

    ``metrics="auto"`` keeps everything captured plus the state-derived
    series; a tuple restricts to those names. ``monitors="auto"``
    evaluates :data:`INVARIANT_MONITOR` (plus a :class:`RateMonitor` when
    :func:`resolve_monitors` is given the algorithm); a tuple overrides.
    ``sketches`` turns on the population sketches: ``False`` (default),
    ``"auto"`` / ``True`` (every source in :data:`SKETCH_SOURCES` whose
    state exists) or a tuple of source names. Each source ``s`` adds
    ``s_hist`` (``[hist_bins]`` int32 over ``[10^hist_lo, 10^hist_hi)``),
    ``s_p50``/``s_p90``/``s_p99``/``s_max`` and the ``[topk]`` outlier
    pairs ``s_top_vals`` / ``s_top_ids``. ``leaf_stats=True`` adds the
    per-leaf ``leaf_msg_norm`` / ``leaf_compress_err`` vectors."""

    metrics: tuple | str = "auto"
    monitors: tuple | str = "auto"
    sketches: tuple | str | bool = False
    hist_bins: int = 48
    hist_lo: float = -12.0
    hist_hi: float = 4.0
    topk: int = 4
    leaf_stats: bool = False

    def wants_sketch(self, name: str) -> bool:
        """Whether the spec sketches source ``name``: the engine's guard
        for building the per-client capture ops at all."""
        if not self.sketches:
            return False
        if self.sketches is True or self.sketches == "auto":
            return True
        return name in self.sketches

    @spanned("telemetry")
    def finalize(self, tape: dict, algo, state) -> dict:
        """Tape + post-round state -> the round's metric dict of device
        tensors. Sketches read the post-round client store."""
        out = dict(tape)
        # raw per-client seam captures feed sketches only, never emitted.
        cohort_ids = out.pop("cohort_ids", None)
        err_clients = out.pop("compress_err_clients", None)
        inner = algo._inner(state)
        d = getattr(inner, "d", None)
        if d is not None:
            num = _tree_norm(tree_map(lambda a: torch.mean(a, dim=0), d))
            den = mean_client_norm(d)
            out["invariant_residual"] = num / torch.clamp(den, min=1e-30)
        x = getattr(inner, "x", None)
        if x is None:
            x = getattr(inner, "x_curr", None)
        dev = None
        if x is not None:
            # tree_map keeps an Arena an Arena, so the drift sketch below
            # takes the kernel route on a packed store.
            dev = tree_map(lambda a: a - torch.mean(a, dim=0, keepdim=True),
                           x)
            out["consensus_err"] = torch.sqrt(torch.max(client_sq_norms(dev)))
        if self.sketches:
            if d is not None and self.wants_sketch("d_norm"):
                out.update(sketch_client_norms("d_norm", d, self))
            if dev is not None and self.wants_sketch("drift"):
                out.update(sketch_client_norms("drift", dev, self))
            if err_clients is not None and self.wants_sketch("compress_err"):
                out.update(sketch_values("compress_err", err_clients, self,
                                         ids=cohort_ids))
            if self.wants_sketch("age"):
                split = getattr(algo, "_split", None)
                dstate = split(state)[3] if split is not None else None
                if dstate is not None:
                    out.update(sketch_values(
                        "age", dstate.age.to(torch.float32), self))
        if self.metrics != "auto":
            out = {k: out[k] for k in self.metrics if k in out}
        return out


#: spec-string parts that configure the SPEC rather than name a sink:
#: ``parse_telemetry`` consumes them, ``parse_sinks`` skips them, so one
#: ``--telemetry`` string drives both (``"jsonl:run.jsonl,hist:48"``).
_SPEC_PART_KINDS = ("hist", "topk", "leafstats", "leaf_stats")


def _spec_overrides(spec: str) -> dict:
    """Telemetry-field overrides encoded in a sink-spec string:
    ``hist[:bins[:lo:hi]]`` and ``topk[:k]`` turn the sketches on,
    ``leafstats`` the per-leaf breakdown."""
    ov: dict = {}
    for part in spec.split(","):
        kind, _, arg = part.strip().partition(":")
        kind = kind.lower()
        if kind == "hist":
            ov["sketches"] = "auto"
            sub = [s for s in arg.split(":") if s]
            if sub:
                ov["hist_bins"] = int(sub[0])
            if len(sub) >= 3:
                ov["hist_lo"], ov["hist_hi"] = float(sub[1]), float(sub[2])
        elif kind == "topk":
            ov["sketches"] = "auto"
            if arg:
                ov["topk"] = int(arg)
        elif kind in ("leafstats", "leaf_stats"):
            ov["leaf_stats"] = True
    return ov


def parse_telemetry(spec) -> Telemetry | None:
    """Normalize a telemetry knob: ``None`` / ``False`` / ``"none"`` /
    ``"off"`` / ``""`` -> None (disabled); a :class:`Telemetry` passes
    through; any other truthy value -> the default spec, with the
    ``hist``/``topk``/``leafstats`` parts of a spec string applied."""
    if spec is None or spec is False:
        return None
    if isinstance(spec, Telemetry):
        return spec
    if isinstance(spec, str):
        if spec.strip().lower() in ("", "none", "off", "0", "false"):
            return None
        return Telemetry(**_spec_overrides(spec))
    return Telemetry()


def resolve_monitors(telemetry: Telemetry | None, algo=None) -> tuple:
    """The drain-time monitor set for a spec: explicit tuples pass
    through; ``"auto"`` is the invariant monitor plus, when the algorithm
    is given, a fresh :class:`RateMonitor` naming its lossy axes."""
    if telemetry is None:
        return ()
    if telemetry.monitors == "auto":
        if algo is None:
            return (INVARIANT_MONITOR,)
        return (INVARIANT_MONITOR, RateMonitor(axis=rate_axis(algo)))
    return tuple(telemetry.monitors)


def split_metrics(algo, ys):
    """Split a round runner's stacked ys into ``(metrics, telemetry)``; the
    runner nests them only when the algorithm has telemetry attached."""
    if getattr(algo, "telemetry", None) is None or ys is None:
        return ys, None
    return ys["metric"], ys["telemetry"]


# --------------------------------------------------------------------- sinks
def _scalar(v):
    a = np.asarray(v)
    if a.dtype.kind == "b":
        return bool(a)
    if a.dtype.kind in "iu":
        return int(a)
    return float(a)


def _jsonable(v):
    """Host value -> JSON-serializable event value: a native scalar, or a
    list for the 1-D sketch vectors."""
    a = np.asarray(v)
    if a.ndim == 0:
        return _scalar(a)
    if a.ndim == 1:
        return [_scalar(x) for x in a]
    raise ValueError("telemetry events carry scalars or 1-D vectors, got "
                     f"shape {a.shape}")


class MemorySink:
    """Collects events in a list (tests / programmatic consumers)."""

    def __init__(self):
        self.events: list[dict] = []

    def emit(self, event: dict) -> None:
        self.events.append(event)

    def close(self) -> None:
        pass


def _open_for_write(path: str):
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    return open(path, "w")


class JsonlSink:
    """One JSON object per line; the run manifest is the first event."""

    def __init__(self, path: str):
        self.path = path
        self._f = _open_for_write(path)

    def emit(self, event: dict) -> None:
        self._f.write(json.dumps(event) + "\n")
        self._f.flush()

    def close(self) -> None:
        self._f.close()


class CsvSink:
    """Round events as CSV; columns fixed by the first round event
    (non-round events are skipped). Vector metrics flatten into indexed
    columns ``name.0 .. name.{k-1}``; anything deeper than 1-D is
    rejected with a pointer at the JSONL sink."""

    def __init__(self, path: str):
        self.path = path
        self._f = _open_for_write(path)
        self._keys: list[str] | None = None

    @staticmethod
    def _flatten(event: dict) -> dict:
        flat = {}
        for k, v in event.items():
            if k == "event":
                continue
            if isinstance(v, (list, tuple)):
                if any(isinstance(x, (list, tuple)) for x in v):
                    raise ValueError(
                        f"CsvSink cannot flatten nested vector metric {k!r}"
                        " — route this stream to a jsonl:<path> sink")
                for i, x in enumerate(v):
                    flat[f"{k}.{i}"] = x
            else:
                flat[k] = v
        return flat

    def emit(self, event: dict) -> None:
        if event.get("event") != "round":
            return
        flat = self._flatten(event)
        if self._keys is None:
            self._keys = list(flat)
            self._f.write(",".join(self._keys) + "\n")
        self._f.write(",".join(str(flat.get(k, "")) for k in self._keys)
                      + "\n")

    def close(self) -> None:
        self._f.close()


class StdoutSink:
    """Human-readable summary lines; round lines gated by ``every``."""

    def __init__(self, every: int = 1):
        self.every = max(int(every), 1)

    @staticmethod
    def _fmt(v):
        return f"{v:.6g}" if isinstance(v, float) else str(v)

    def emit(self, event: dict) -> None:
        kind = event.get("event")
        if kind == "round":
            if event.get("round", 0) % self.every:
                return
            # sketch vectors stay in jsonl/csv.
            body = "  ".join(f"{k}={self._fmt(v)}" for k, v in event.items()
                             if k not in ("event", "round")
                             and not isinstance(v, (list, tuple)))
            print(f"[telemetry] round {event.get('round', 0):5d}  {body}")
        elif kind == "monitor" and event.get("kind") == "rate_break":
            print(f"[telemetry] WARN round {event.get('round')}: rate break "
                  f"on {event.get('metric')} — rho_hat="
                  f"{self._fmt(event.get('rho_hat'))} after established "
                  f"{self._fmt(event.get('rho_ref'))} at value "
                  f"{self._fmt(event.get('value'))}  "
                  f"(axis: {event.get('axis', '')})")
        elif kind == "monitor":
            print(f"[telemetry] WARN round {event.get('round')}: "
                  f"{event.get('metric')}={self._fmt(event.get('value'))} "
                  f"{'>' if event.get('mode', 'max') == 'max' else '<'} "
                  f"{event.get('bound')}  (axis: {event.get('axis', '')})")
        elif kind == "manifest":
            print(f"[telemetry] run algo={event.get('algo')} "
                  f"n_clients={event.get('n_clients')} tau={event.get('tau')} "
                  f"commit={event.get('commit')}")
        elif kind == "profile":
            print(f"[telemetry] profiler {event.get('action')} at round "
                  f"{event.get('round')} -> {event.get('dir')}")

    def close(self) -> None:
        pass


def parse_sinks(spec) -> list:
    """Sink spec grammar (the ``--telemetry`` CLI knob): comma-separated
    ``jsonl:<path>`` | ``csv:<path>`` | ``stdout[:every]`` | ``memory``.
    Spec-configuring parts (``hist``/``topk``/``leafstats``) are skipped.
    Sink objects / lists pass through; None -> []."""
    if spec is None or spec is True:
        return []
    if not isinstance(spec, str):
        return list(spec) if isinstance(spec, (list, tuple)) else [spec]
    sinks = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        kind, _, arg = part.partition(":")
        kind = kind.lower()
        if kind in _SPEC_PART_KINDS:
            continue
        if kind == "jsonl":
            sinks.append(JsonlSink(arg or "telemetry.jsonl"))
        elif kind == "csv":
            sinks.append(CsvSink(arg or "telemetry.csv"))
        elif kind == "stdout":
            sinks.append(StdoutSink(every=int(arg) if arg else 1))
        elif kind in ("memory", "mem"):
            sinks.append(MemorySink())
        else:
            raise ValueError(f"unknown telemetry sink {part!r} "
                             "(jsonl:<path> | csv:<path> | stdout[:k] | "
                             "memory)")
    return sinks


def emit_event(sinks, event: dict) -> None:
    for s in sinks:
        s.emit(event)


def close_sinks(sinks) -> None:
    for s in sinks:
        s.close()


# ----------------------------------------------------------- manifest/drain
def _git_commit() -> str | None:
    try:
        out = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"], capture_output=True,
            text=True, cwd=os.path.dirname(os.path.abspath(__file__)))
        return out.stdout.strip() or None
    except OSError:
        return None


def run_manifest(algo, *, n_params: int | None = None,
                 config: dict | None = None, monitors: tuple = (),
                 extra: dict | None = None, leaf_info=None,
                 device=None) -> dict:
    """The run's first event: what ran, where, and what one round costs on
    the wire (the per-hop contract + totals). ``mesh`` names the backend
    the run's ``device`` belongs to (``"cuda"`` or ``"cpu"``) and its
    device count. ``leaf_info`` (``core/comm.py:leaf_info_of``) adds exact
    per-leaf wire bits (``leaf_names`` / ``leaf_bits``)."""
    from repro_torch.core.comm import (comm_bits_per_round,
                                       comm_hops_per_round,
                                       message_leaf_bits_of)

    tel = getattr(algo, "telemetry", None)
    backend = torch.device("cpu" if device is None else device).type
    ev = {
        "event": "manifest", "schema": 1,
        "algo": getattr(algo, "name", type(algo).__name__),
        "n_clients": getattr(algo, "n_clients", None),
        "tau": getattr(algo, "tau", None),
        "commit": _git_commit(),
        "mesh": {"backend": backend,
                 "n_devices": (torch.cuda.device_count()
                               if backend == "cuda" else 1)},
        "metrics": (list(tel.metrics)
                    if tel is not None and tel.metrics != "auto" else "auto"),
        "monitors": [dataclasses.asdict(m) for m in monitors],
        "config": dict(config or {}),
    }
    if n_params:
        nc = getattr(algo, "n_clients", 1)
        ev["bits_per_round"] = comm_bits_per_round(algo, n_params, nc,
                                                   leaf_info)
        ev["hops"] = comm_hops_per_round(algo, n_params, nc, leaf_info)
        if leaf_info is not None:
            lb = message_leaf_bits_of(algo, leaf_info)
            if lb is not None:
                ev["leaf_names"] = [nm for nm, _ in leaf_info]
                ev["leaf_sizes"] = [int(n) for _, n in leaf_info]
                ev["leaf_bits"] = [float(b) for b in lb]
    if extra:
        ev.update(extra)
    return ev


def _to_host(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def drain(series: dict | None, *, sinks=(), monitors=(), start_round: int = 0,
          static: dict | None = None, algo=None,
          n_params: int | None = None, leaf_names=None,
          leaf_bits=None) -> list:
    """Copy the stacked per-round series to the host ONCE and emit one
    ``round`` event per round into the sinks, evaluating ``monitors``
    against each (violations emit a WARN event right after their round).
    ``static`` merges constant per-round fields; ``algo``/``n_params``
    add ``bits_up``/``bits_down`` per round. Vector series land as JSON
    lists; ``leaf_*`` series split off into a per-round ``leaf_stats``
    event (``leaf_names`` and ``leaf_bits`` ride on the segment's first).
    Observer monitors (:class:`RateMonitor`) annotate each round event
    before it is emitted; threshold monitors skip vector values. Returns
    the emitted events."""
    events: list[dict] = []
    if not series:
        return events
    host = {k: _to_host(v) for k, v in series.items()}
    n = len(next(iter(host.values())))
    stat = dict(static or {})
    if algo is not None and n_params:
        from repro_torch.core.comm import comm_bits_per_round

        bits = comm_bits_per_round(algo, n_params,
                                   getattr(algo, "n_clients", 1))
        stat.setdefault("bits_up", bits["up_bits"])
        stat.setdefault("bits_down", bits["down_bits"])
    leaf_keys = [k for k in host if k.startswith("leaf_")]
    observers = [m for m in monitors if hasattr(m, "observe")]
    checks = [m for m in monitors if not hasattr(m, "observe")]
    for i in range(n):
        ev = {"event": "round", "round": int(start_round + i)}
        for k, v in host.items():
            if k not in leaf_keys:
                ev[k] = _jsonable(v[i])
        ev.update(stat)
        rate_warns = [w for w in (m.observe(ev) for m in observers) if w]
        out = [ev]
        if leaf_keys:
            lev = {"event": "leaf_stats", "round": ev["round"]}
            if leaf_names is not None and i == 0:
                lev["names"] = list(leaf_names)
            if leaf_bits is not None and i == 0:
                lev["bits"] = [float(b) for b in leaf_bits]
            for k in leaf_keys:
                lev[k[len("leaf_"):]] = _jsonable(host[k][i])
            out.append(lev)
        out += [w for w in (_threshold_warn(m, ev) for m in checks) if w]
        out += rate_warns
        for e in out:
            events.append(e)
            emit_event(sinks, e)
    return events


def write_csv_rows(path: str, rows: list[dict]) -> None:
    """The trainer's CSV contract: header from the first row's keys,
    ``str()``-formatted values."""
    if not rows:
        return
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    keys = list(rows[0])
    with open(path, "w") as f:
        f.write(",".join(keys) + "\n")
        for row in rows:
            f.write(",".join(str(row[k]) for k in keys) + "\n")


# ----------------------------------------------------------------- profiling
def parse_trace_rounds(spec) -> tuple[int, int] | None:
    """``"a:b"`` -> the half-open round window [a, b) to trace; ``"a"``
    traces the single round a. None/empty -> no tracing."""
    if spec is None or spec == "":
        return None
    if isinstance(spec, tuple):
        lo, hi = spec
    else:
        a, _, b = str(spec).partition(":")
        lo = int(a)
        hi = int(b) if b else lo + 1
    if hi <= lo or lo < 0:
        raise ValueError(f"bad --trace-rounds window {spec!r} (want a:b "
                         "with 0 <= a < b)")
    return lo, hi


@dataclasses.dataclass
class TraceSession:
    """Brackets a ``--trace-rounds a:b`` window with ``torch.profiler``
    (CPU activities, and CUDA ones where a card is present). The caller
    forces segment boundaries at the window edges (:meth:`boundaries`) and
    calls :meth:`maybe_start` before / :meth:`maybe_stop` after each
    segment; both return a ``profile`` event for the sinks when they act.
    Inside the window the span recorder is on (where the caller had not
    turned it on already; what it records there is dropped at the stop),
    so the trace names the round's layers. The stop waits for the card,
    then writes the Chrome trace to ``out_dir/rounds_<a>-<b>.trace.json``."""

    window: tuple[int, int] | None
    out_dir: str = "profile_trace"
    active: bool = False
    profile: Any = None
    spans_on: bool = False

    def boundaries(self) -> tuple:
        """Round indices that must END a segment so the traced segment
        starts/stops exactly at the window edges."""
        if self.window is None:
            return ()
        return tuple(b for b in (self.window[0] - 1, self.window[1] - 1)
                     if b >= 0)

    def maybe_start(self, first_round: int) -> dict | None:
        if (self.window is None or self.active
                or not (self.window[0] <= first_round < self.window[1])):
            return None
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
            torch.cuda.synchronize()
        self.profile = torch.profiler.profile(activities=acts)
        self.profile.start()
        self.active = True
        self.spans_on = not spans.enabled()
        if self.spans_on:
            spans.enable()
        return {"event": "profile", "action": "start_trace",
                "round": first_round, "dir": self.out_dir}

    def maybe_stop(self, next_round: int) -> dict | None:
        if not self.active or next_round < self.window[1]:
            return None
        self._stop()
        return {"event": "profile", "action": "stop_trace",
                "round": next_round, "dir": self.out_dir}

    def _stop(self) -> None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.profile.stop()
        self.active = False
        if self.spans_on:
            spans.disable()
            spans.drain()
        os.makedirs(self.out_dir, exist_ok=True)
        a, b = self.window
        self.profile.export_chrome_trace(
            os.path.join(self.out_dir, f"rounds_{a}-{b}.trace.json"))

    def close(self) -> None:
        if self.active:
            self._stop()


class _OpCount(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def instruction_count(fn, *args, **kwargs) -> int:
    """The eager footprint of one call ``fn(*args, **kwargs)``: the number
    of aten operations it dispatches (views and copies included, as HLO
    counts its instructions). Benchmarks use it to report telemetry's
    footprint next to its wall-clock cost."""
    with _OpCount() as c:
        fn(*args, **kwargs)
    return c.n
