#!/usr/bin/env python3
"""Run one cell of ``BENCHMARK.json`` once:

    python3 fedbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the card(s) the cell asks
for. Set-up makes the weights and the traffic from ``--seed``, runs the
program's warm-up aggregation and its first rounds, and reads what its
state says of them; the window then runs whole rounds until ``--seconds``
have passed. Afterwards the plain reference (``fedbench/reference/``)
works the first rounds out again from the same weights and tokens, and
``correct`` says whether every number compared lies within its limit
(``fedbench/limits/<workload>.json``).

The last line of standard output is the result, one JSON object; with
``--trace 0`` its metrics are the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics (spans around the program's calls,
and a ``torch.profiler`` trace of a few rounds after the window). The
numbers compared, each beside its limit, are the last lines of standard
error and the result's last key. Without a card the run fails and prints
no result."""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import types  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "fedbench"
#: modules the measured process may not hold: JAX and the JAX package the
#: port was made from, compared by whole top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
#: rounds in set-up after the warm-up aggregation; the reference follows
#: them and the window runs on from their state
FIRST_ROUNDS = 3
#: rounds the traced run profiles after its window
PROFILED_ROUNDS = 2

for _var, _dir in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TRITON_CACHE_DIR", "triton")):
    os.environ.setdefault(_var, str(ROOT / "build" / "fedbench" / _dir))
for _p in (str(ROOT / "src"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import torch  # noqa: E402

# one host thread of intra-op work: the program's host side is one Python
# thread launching kernels, and idle pool threads spinning beside it on a
# shared host only add noise
torch.set_num_threads(1)

from fedbench import counts, program, readings, trace  # noqa: E402
from fedbench import traffic_gen  # noqa: E402
from fedbench.peaks import peaks_for  # noqa: E402
from fedbench.reference.common import make_weights  # noqa: E402


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_cell(workload: str) -> dict:
    """The cell ``workload`` of ``BENCHMARK.json`` with everything it names,
    each found by its name: the configuration file, the traffic mix
    ``traffic/<name>.json``, the limits ``limits/<workload>.json``, the
    family's and the algorithm's reference modules, and a reader
    ``metrics/<name>.py`` for each of its metrics."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = next((w for w in bench["workloads"] if w["name"] == workload),
                None)
    if cell is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    conf = json.loads((ROOT / entry["file"]).read_text())
    mix = json.loads((BENCH / "traffic" / f"{cell['traffic']}.json")
                     .read_text())
    limits = json.loads((BENCH / "limits" / f"{workload}.json").read_text())

    readers = {kind: {m["name"]: _load(BENCH / "metrics" / f"{m['name']}.py",
                                       f"fedbench_metric_{m['name']}")
                      for m in bench[kind]}
               for kind in ("end_to_end", "per_layer")}
    units = {m["name"]: m["unit"] for kind in ("end_to_end", "per_layer")
             for m in bench[kind]}
    return {"cell": cell, "conf": conf, "mix": mix, "limits": limits,
            "family": importlib.import_module(
                f"fedbench.reference.{conf['family']}"),
            "algorithm": importlib.import_module(
                f"fedbench.reference.{mix['algorithm']}"),
            "readers": readers, "units": units}


def _weight_seed(seed: int) -> int:
    return (seed * 0x9E3779B97F4A7C15 + 0x5EED) % 2 ** 63


def first_rounds(c: dict, seed: int, device, *, test_sizes: bool = False):
    """Set-up: the weights, the traffic, the program, its warm-up
    aggregation and ``FIRST_ROUNDS`` rounds through the window's own call.
    Returns ``(prog, state, pool, x0 on the host, the program's readings,
    conf)``."""
    family, mix = c["family"], c["mix"]
    conf = family.test_conf(c["conf"]) if test_sizes else c["conf"]
    _, x0 = make_weights(family.param_spec(conf), _weight_seed(seed), device)
    x0_host = {n: a.cpu() for n, a in x0.items()}
    pool = traffic_gen.round_pool(mix, conf["vocab_size"], seed % 2 ** 48,
                                  device)
    prog = program.Program(family, conf, mix, seed)
    state = prog.init(x0, pool[0][0])
    del x0
    v = prog.views(state)
    got = {"grad": readings.warmup_grad_norms(v["x"], v["d"], x0_host,
                                              mix["alpha"])}
    del v
    losses = []
    for r in range(FIRST_ROUNDS):
        state, loss = prog.round(state, traffic_gen.round_batch(pool, r))
        losses.append(float(loss[0]))
    v = prog.views(state)
    got.update(loss=losses, update=readings.leaf_norms(v["x"], x0_host),
               drift=readings.leaf_norms(v["d"]),
               shift=None if v["h"] is None else readings.leaf_norms(v["h"]))
    return prog, state, pool, x0_host, got, conf


def reference_readings(c: dict, conf: dict, x0_host: dict, pool: list,
                       seed: int, device, fault: str | None = None) -> dict:
    """The reference's readings of the warm-up and the first rounds, from
    the same weights and tokens."""
    family, alg, mix = c["family"], c["algorithm"], c["mix"]
    x0 = {n: a.to(device) for n, a in x0_host.items()}
    st = alg.init(family, conf, mix, x0, pool[0][0], seed, fault)
    got = {"grad": readings.warmup_grad_norms(st["x"], st["d"], x0,
                                              mix["alpha"])}
    got["loss"] = [alg.round_(family, conf, mix, st,
                              traffic_gen.round_batch(pool, r), seed, fault)
                   for r in range(FIRST_ROUNDS)]
    got.update(update=readings.leaf_norms(st["x"], x0),
               drift=readings.leaf_norms(st["d"]),
               shift=None if st["h"] is None else readings.leaf_norms(
                   st["h"]))
    return got


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _smi() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def run_cell(c: dict, seed: int, seconds: float, trace_on: bool,
             device="cuda", *, test_sizes: bool = False) -> dict:
    """One run of the cell ``c`` (``load_cell``): set-up, the window, the
    reference; returns the result and an ``info`` record."""
    from repro_torch.kernels import library

    if torch.device(device).type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    mix = c["mix"]
    prog, state, pool, x0_host, got, conf = first_rounds(
        c, seed, device, test_sizes=test_sizes)
    n_params = sum(a.numel() for a in x0_host.values())
    launches0 = dict(library.LAUNCHES)
    spans = program.Spans() if trace_on else None
    undo = program.instrument(spans) if trace_on else None
    _sync(device)
    t0 = time.perf_counter()
    setup_s = t0 - T_START
    rounds = failed = 0
    ends = []
    # each round's loss is read once the next round has been dispatched, so
    # the device works on through a pause of the host; at the deadline no
    # more is sent, and the window closes when all that was sent has ended
    pending = None
    while True:
        state, loss = prog.round(state, traffic_gen.round_batch(
            pool, FIRST_ROUNDS + rounds))
        rounds += 1
        if spans is not None:
            spans.close_round()
        if pending is not None:
            failed += not all(map(math.isfinite, pending.tolist()))
        pending = loss
        ends.append(time.perf_counter() - t0)
        if ends[-1] >= seconds:
            break
    failed += not all(map(math.isfinite, pending.tolist()))
    _sync(device)
    window_s = time.perf_counter() - t0
    launches = {k: v - launches0[k] for k, v in library.LAUNCHES.items()
                if v != launches0[k]}
    cuda = torch.device(device).type == "cuda"
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    traced = None
    if trace_on:
        traced = _profile(prog, state, pool, FIRST_ROUNDS + rounds, spans)
        undo()
    info = {"wire_bits_per_round": prog.wire_bits(x0_host),
            "window_launches": launches, "window_rounds": rounds,
            "round_s": [b - a for a, b in zip([0.0] + ends, ends)],
            "first_round_losses": got["loss"]}
    del prog, state
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    ref = reference_readings(c, conf, x0_host, pool, seed, device)
    info["reference_s"] = time.perf_counter() - t_ref
    gaps = readings.gaps(got, ref)
    checks = {k: {"value": gaps[k][0], "limit": lim, "where": gaps[k][1]}
              for k, lim in c["limits"].items()}
    correct = failed == 0 and all(ch["value"] <= ch["limit"]
                                  for ch in checks.values())
    info["gaps"] = {k: list(v) for k, v in gaps.items()}
    info["leaves_not_compared"] = sorted(
        set(ref["grad"]) - set(readings.compared_leaves(
            readings.over_clients(ref["grad"]))))

    record = types.SimpleNamespace(
        rounds=rounds, window_s=window_s, setup_s=setup_s, peak_bytes=peak,
        tokens=rounds * counts.tokens_per_round(mix), family=c["family"],
        conf=conf, mix=mix, n_params=n_params, spans=spans and spans.rounds,
        trace=traced, profiled_rounds=PROFILED_ROUNDS,
        peaks=peaks_for(torch.cuda.get_device_name()) if cuda else None)
    metrics = {}
    if cuda:
        kind = "per_layer" if trace_on else "end_to_end"
        for name, reader in c["readers"][kind].items():
            value = reader.read(record)
            if value is not None:
                metrics[name] = {"value": value, "unit": c["units"][name]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name() if cuda else "cpu",
           "count": c["cell"]["chips"], "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": rounds, "failed": failed,
              "metrics": metrics, "device": dev}
    if traced is not None:
        dev.update(busy_s=traced["busy_s"], window_s=traced["window_s"])
        result["breakdown"] = {
            "device_ops": trace.top(traced["kernels"]),
            "idle_gaps": trace.top(traced["idle_gaps"])}
    result["checks"] = {k: {"value": ch["value"], "limit": ch["limit"]}
                        for k, ch in checks.items()}
    info["checks_where"] = {k: ch["where"] for k, ch in checks.items()}
    return result, info


#: the marker kernel that brackets the device-only profiled window
MARK = "spin_kernel"


def _profile(prog, state, pool, r0: int, spans) -> dict:
    """After the window: ``PROFILED_ROUNDS`` rounds profiled on the device
    alone, between two marker kernels launched after a synchronize (busy
    time, device time by kernel), then one round profiled on host and
    device whose idle gaps are labelled by what the host was doing (its
    host-side recording slows the host, so it sets no time). The Chrome
    traces go under ``TMPDIR`` and are removed."""
    tmp = tempfile.mkdtemp(prefix="fedbench-trace-")
    cuda = torch.profiler.ProfilerActivity.CUDA
    try:
        path = os.path.join(tmp, "device.json")
        with torch.profiler.profile(activities=[cuda]) as prof:
            torch.cuda.synchronize()
            torch.cuda._sleep(1000)
            for k in range(PROFILED_ROUNDS):
                state, loss = prog.round(state, traffic_gen.round_batch(
                    pool, r0 + k))
                loss.tolist()
            torch.cuda.synchronize()
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        prof.export_chrome_trace(path)
        out = trace.read(path, marker=MARK)
        path = os.path.join(tmp, "host.json")
        acts = [torch.profiler.ProfilerActivity.CPU, cuda]
        with torch.profiler.profile(activities=acts) as prof:
            with torch.profiler.record_function(trace.WINDOW):
                state, loss = prog.round(state, traffic_gen.round_batch(
                    pool, r0 + PROFILED_ROUNDS))
                loss.tolist()
                torch.cuda.synchronize()
        prof.export_chrome_trace(path)
        out["idle_gaps"] = trace.read(path)["idle_gaps"]
        spans.open = []
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def forbidden_modules() -> list:
    """Top-level names in ``sys.modules`` that the run may not hold."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    c = load_cell(a.workload)
    chips = c["cell"]["chips"]
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < chips:
        print(f"fedbench: {a.workload} needs {chips} CUDA device(s), "
              f"found {have}", file=sys.stderr)
        return 3
    # the system under test: without it there is no result to print
    import repro_torch  # noqa: F401

    print(json.dumps({"card": _smi()}), flush=True)
    result, info = run_cell(c, a.seed, a.seconds, bool(a.trace))
    bad = forbidden_modules()
    if bad:
        print(f"fedbench: the process holds {bad}; no result",
              file=sys.stderr)
        return 4
    print(json.dumps({"info": info}, default=str), flush=True)
    for k, ch in result["checks"].items():
        print(f"check {k}: {ch['value']!r} limit {ch['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
