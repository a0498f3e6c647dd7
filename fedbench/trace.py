"""Reading a ``torch.profiler`` Chrome trace: the device's busy time
inside the traced window, device time by kernel, and the device's idle
gaps by what the host was doing."""

from __future__ import annotations

import bisect
import json

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
WINDOW = "fedbench.window"


def read(path: str, marker: str | None = None) -> dict:
    """``{"window_s", "busy_s", "kernels": [(name, s), ...] (every device
    operation in the window, clipped to it), "idle_gaps": {label: s}}``.

    The window is the ``fedbench.window`` range or, with ``marker``, the
    span from the end of the first kernel whose name holds ``marker`` to
    the start of the last (a trace of the device alone has no host
    ranges). Busy time is the union of the device operations' intervals.
    An idle gap is labelled by the outermost ``fedbench.*`` range and the
    innermost host event open at its start."""
    events = [e for e in json.load(open(path))["traceEvents"]
              if e.get("ph") == "X" and "dur" in e]
    if marker is None:
        win = [e for e in events if e.get("name") == WINDOW
               and e.get("cat") == "user_annotation"]
        if not win:
            raise ValueError(f"no {WINDOW} range in {path}")
        w0, w1 = win[0]["ts"], win[0]["ts"] + win[0]["dur"]
    else:
        marks = sorted((e for e in events if e.get("cat") == "kernel"
                        and marker in e["name"]), key=lambda e: e["ts"])
        if len(marks) < 2:
            raise ValueError(f"fewer than two {marker} kernels in {path}")
        w0, w1 = marks[0]["ts"] + marks[0]["dur"], marks[-1]["ts"]
    device = sorted((e for e in events if e.get("cat") in DEVICE_CATS
                     and e["ts"] < w1 and e["ts"] + e["dur"] > w0),
                    key=lambda e: e["ts"])
    kernels, spans = [], []
    for e in device:
        lo, hi = max(e["ts"], w0), min(e["ts"] + e["dur"], w1)
        kernels.append((e["name"], (hi - lo) / 1e6))
        if spans and lo <= spans[-1][1]:
            spans[-1][1] = max(spans[-1][1], hi)
        else:
            spans.append([lo, hi])
    busy = sum(hi - lo for lo, hi in spans)
    gaps, t = [], w0
    for lo, hi in spans:
        if lo > t:
            gaps.append((t, lo))
        t = max(t, hi)
    if w1 > t:
        gaps.append((t, w1))
    return {"window_s": (w1 - w0) / 1e6, "busy_s": busy / 1e6,
            "kernels": kernels, "idle_gaps": _label(gaps, events, w0, w1)}


def _label(gaps, events, w0, w1) -> dict:
    host = sorted((e for e in events if e.get("cat") in HOST_CATS
                   and e.get("name") != WINDOW
                   and e["ts"] < w1 and e["ts"] + e["dur"] > w0),
                  key=lambda e: e["ts"])
    ranges = [e for e in host if e["name"].startswith("fedbench.")]
    starts = [e["ts"] for e in host]
    out: dict = {}
    for lo, hi in gaps:
        # the innermost open host event is the latest-started one still
        # open: a short scan back from the last one that began before lo
        j = bisect.bisect_right(starts, lo)
        inner = next((e["name"] for e in reversed(host[max(0, j - 4000):j])
                      if e["ts"] + e["dur"] >= lo), "no host event")
        outer = next((e["name"][len("fedbench."):] for e in ranges
                      if e["ts"] <= lo <= e["ts"] + e["dur"]), "host")
        label = f"{outer}: {inner}"
        out[label] = out.get(label, 0.0) + (hi - lo) / 1e6
    return out


def top(items, n: int = 10) -> list:
    """The ``n`` largest ``[name, seconds]`` of ``{name: seconds}`` or of
    ``(name, seconds)`` pairs summed by name."""
    acc: dict = {}
    for k, v in (items.items() if isinstance(items, dict) else items):
        acc[k] = acc.get(k, 0.0) + v
    return [[k, v] for k, v in sorted(acc.items(), key=lambda kv: -kv[1])[:n]]
