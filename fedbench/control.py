#!/usr/bin/env python3
"""The readings that set a cell's limits (``fedbench/limits/``), on the
card at the cell's own size:

    python3 fedbench/control.py --workload <name> --seeds 1,2,... \
        [--control-seeds 1,2,3] [--out <file.jsonl>]

For every seed of ``--seeds`` the program's set-up (warm-up aggregation
and first rounds, no window) against the reference: the lower readings.
For every seed of ``--control-seeds`` also the control, the reference in
place of the program computed with TF32 matmuls (the precision below the
configuration's float32 with TF32 off), and the reference with each fault
a training cell can have planted: half of every batch left out
(``half_batch``) and the exchange between clients left out
(``no_exchange``); a state left unchanged reads 1 on ``update`` by
construction. Prints one JSON line a seed and reading."""

import argparse
import gc
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from fedbench import readings, run  # noqa: E402

import torch  # noqa: E402  (after run, which set the cache directories)


def _free():
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def calibrate(workload: str, seeds: list, control_seeds: list,
              device="cuda", test_sizes: bool = False) -> list:
    """The readings of every seed, as records (one a seed and reading)."""
    c = run.load_cell(workload)
    if torch.device(device).type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    out = []

    def put(seed, what, gaps, seconds):
        rec = {"workload": workload, "seed": seed, "reading": what,
               "seconds": seconds,
               "gaps": {k: v[0] for k, v in gaps.items()},
               "where": {k: v[1] for k, v in gaps.items()}}
        out.append(rec)

    for seed in seeds:
        _seed(c, seed, seed in control_seeds, device, test_sizes, put)
    return out


def _seed(c, seed, with_control, device, test_sizes, put):
    """The program's readings of ``seed`` against the reference's and,
    ``with_control``, the control's and the faults'."""
    t = time.perf_counter()
    prog, state, pool, x0_host, got, conf = run.first_rounds(
        c, seed, device, test_sizes=test_sizes)
    t_prog = time.perf_counter() - t
    del prog, state
    _free()
    t = time.perf_counter()
    ref = run.reference_readings(c, conf, x0_host, pool, seed, device)
    put(seed, "program", readings.gaps(got, ref),
        [t_prog, time.perf_counter() - t])
    if not with_control:
        return
    unchanged = dict(got, update={n: 0.0 for n in got["update"]})
    put(seed, "fault:unchanged", readings.gaps(unchanged, ref), None)
    if torch.device(device).type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        try:
            t = time.perf_counter()
            ctl = run.reference_readings(c, conf, x0_host, pool, seed,
                                         device)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        put(seed, "control:tf32", readings.gaps(ctl, ref),
            time.perf_counter() - t)
    for fault in ("half_batch", "no_exchange"):
        t = time.perf_counter()
        bad = run.reference_readings(c, conf, x0_host, pool, seed, device,
                                     fault=fault)
        put(seed, f"fault:{fault}", readings.gaps(bad, ref),
            time.perf_counter() - t)
    _free()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--out")
    a = ap.parse_args(argv)
    seeds = [int(s) for s in a.seeds.split(",")]
    ctl = [int(s) for s in a.control_seeds.split(",") if s]
    if not torch.cuda.is_available():
        print("control: needs a CUDA device", file=sys.stderr)
        return 3
    sink = open(a.out, "a") if a.out else None

    def emit(line):
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")
            sink.flush()

    try:
        for rec in calibrate(a.workload, seeds, ctl):
            emit(json.dumps(rec))
    finally:
        if sink:
            sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
