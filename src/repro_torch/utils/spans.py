"""Spans and counters of the port's layers (re-exported by
``core/telemetry.py``, beside the in-round tape; a leaf module so that
``kernels/ops.py`` can import it).

A span is a named interval of host code, ``with span("dither"): ...``;
:func:`spanned` wraps a function in one. The sites are the layers of a
round: ``round`` (``RoundEngine.round``, a cohort round included),
``local`` (the tau - 1 local steps), ``comm`` (the aggregating step),
``grad`` (the vmapped gradient call), ``pack`` (the arena at the gradient
boundary and ``arena.pack_rows``), ``transmit`` (the transform stack),
``dither``, ``scale``, the kernel wrappers of ``kernels/ops.py``
(``fedcet_v``, ``fedcet_comm``, ``quantize``, ``round_tail``, ``gossip``,
``sketch``), ``topology``, ``telemetry`` (``Telemetry.finalize``),
``gather`` and ``scatter`` (a cohort's rows), and ``loss`` (the round
runner's metric call). Every site lies outside every ``torch.func``
transform.

The recorder is off by default, and off it costs one bool check a span:
:func:`span` returns a shared ``nullcontext``, :func:`count` returns at
once, and nothing is constructed or allocated. :func:`enable` turns it on
(and restarts the round index), :func:`disable` off. On, each span

* opens ``torch.profiler.record_function("repro_torch.<name>")``, so an
  active profiler's trace names the layer beside the kernels it launched;
* takes the host's ``time.time_ns()`` before it opens and after it closes:
  the clock of ``torch.profiler``'s Chrome trace, whose ``ts`` is
  ``(ns - baseTimeNanoseconds) / 1000`` microseconds;
* records a pair of timing CUDA events on the current stream where CUDA
  was in use (``torch.cuda.is_initialized()``) at the first span since
  :func:`enable`; else its time is the host's. One clock serves every
  span of an :func:`enable` window, so a parent and its children compare;
* keeps its parent span and the round index: the number of ``round``
  spans opened since :func:`enable`, less one (``-1`` before the first).

Counters add up per round index (:func:`count`). At the close of each
``round`` span, with CUDA in use, the recorder counts ``mallocs`` (the
rise of the caching allocator's ``segment.all.allocated``: new
``cudaMalloc`` segments) and ``alloc_retries`` (of ``num_alloc_retries``:
allocations that freed the cache and tried again).

Records stay in memory until :func:`drain` returns them as a
:class:`Recording` and clears them; :func:`enable` refuses to start while
records wait, so no two windows share a round index. A span's self time
is its time less the time of the spans directly inside it
(:func:`self_ms`)."""

from __future__ import annotations

import contextlib
import functools
import time
from typing import NamedTuple

import torch

#: the span that advances the round index and reads the round counters
ROUND = "round"
#: the prefix of a span's ``record_function`` name in a profiler trace
PREFIX = "repro_torch."

_ON = False
_NULL = contextlib.nullcontext()
_OPEN: list = []       # records, in the order their spans opened
_STACK: list = []      # indices into _OPEN of the spans now open
_COUNTS: dict = {}     # {name: {round: n}}
_ROUND = -1
_DEVICE = None         # this window's clock: CUDA events, host, or not chosen


class Span(NamedTuple):
    """One closed span: ``parent`` indexes the enclosing span in the same
    :class:`Recording` (``-1`` at the top); ``start_ns``/``end_ns`` are
    host ``time.time_ns()``; ``ms`` is the window's clock: CUDA-event time
    or host time."""

    name: str
    parent: int
    round: int
    start_ns: int
    end_ns: int
    ms: float


class Recording(NamedTuple):
    """What :func:`drain` returns: the spans in the order they opened and
    the counters, ``{name: {round: n}}``."""

    spans: list
    counts: dict


def enabled() -> bool:
    return _ON


def enable() -> None:
    """Turn the recorder on; the next ``round`` span is round 0, and the
    next span chooses the window's clock. Refused while records wait for
    :func:`drain`."""
    global _ON, _ROUND, _DEVICE
    if _OPEN or _COUNTS:
        raise RuntimeError("enable() with records not drained")
    _ON, _ROUND, _DEVICE = True, -1, None


def disable() -> None:
    """Turn the recorder off; what it recorded waits for :func:`drain`."""
    global _ON
    _ON = False


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` of the current round."""
    if not _ON:
        return
    per = _COUNTS.setdefault(name, {})
    per[_ROUND] = per.get(_ROUND, 0) + n


def _alloc_stats() -> tuple:
    s = torch.cuda.memory_stats()
    return s.get("segment.all.allocated", 0), s.get("num_alloc_retries", 0)


class _Span:
    __slots__ = ("rec", "fn", "mem")

    def __init__(self, name: str):
        self.rec = [name, _STACK[-1] if _STACK else -1, _ROUND, 0, 0,
                    None, None]
        self.fn = torch.profiler.record_function(PREFIX + name)
        self.mem = None

    def __enter__(self):
        global _ROUND, _DEVICE
        rec = self.rec
        if rec[0] == ROUND:
            _ROUND += 1
            rec[2] = _ROUND
        if _DEVICE is None:
            _DEVICE = torch.cuda.is_initialized()
        cuda = _DEVICE
        if cuda and rec[0] == ROUND:
            self.mem = _alloc_stats()
        _STACK.append(len(_OPEN))
        _OPEN.append(rec)
        rec[3] = time.time_ns()
        self.fn.__enter__()
        if cuda:
            rec[5] = torch.cuda.Event(enable_timing=True)
            rec[6] = torch.cuda.Event(enable_timing=True)
            rec[5].record()
        return self

    def __exit__(self, *exc):
        rec = self.rec
        if rec[6] is not None:
            rec[6].record()
        self.fn.__exit__(*exc)
        rec[4] = time.time_ns()
        _STACK.pop()
        if self.mem is not None:
            mallocs, retries = _alloc_stats()
            count("mallocs", mallocs - self.mem[0])
            count("alloc_retries", retries - self.mem[1])
        return False


def span(name: str):
    """A context manager timing the layer ``name`` (see the module
    docstring); off, a shared ``nullcontext``."""
    if not _ON:
        return _NULL
    return _Span(name)


def spanned(name: str):
    """Decorate a function so that each call runs inside ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            if not _ON:
                return fn(*args, **kwargs)
            with _Span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


def drain() -> Recording:
    """The closed spans and the counters since the last drain, clearing
    both; waits for the card where a span recorded events. Call it with
    no span open."""
    global _OPEN, _COUNTS
    if _STACK:
        raise RuntimeError(f"drain() inside the open span "
                           f"{_OPEN[_STACK[-1]][0]!r}")
    recs, counts = _OPEN, _COUNTS
    _OPEN, _COUNTS = [], {}
    if any(r[5] is not None for r in recs):
        torch.cuda.synchronize()
    out = [Span(name, parent, rnd, t0, t1,
                s.elapsed_time(e) if s is not None else (t1 - t0) / 1e6)
           for name, parent, rnd, t0, t1, s, e in recs]
    return Recording(out, counts)


def self_ms(spans: list) -> list:
    """Each span's time less the time of the spans directly inside it."""
    out = [s.ms for s in spans]
    for s in spans:
        if s.parent >= 0:
            out[s.parent] -= s.ms
    return out

