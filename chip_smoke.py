#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA H100.

    python3 chip_smoke.py

Drives the port (``src/repro_torch``) only, and imports nothing of JAX or
of the JAX package. Phases, one JSON line each:

1. device    — the card, its power limit, the software versions;
2. build     — the CUDA kernels compiled from ``csrc/`` with nvcc;
3. kernels   — each kernel against its plain PyTorch version at the main
               path's shapes (the largest stacked fedlm-100m leaf, float32),
               in float64, at a ragged size and at the quadratic's shape;
               kernel, plain and bound times from CUDA events;
4. quadratic — FedCET on the paper's §IV problem (float64, 400 rounds)
               through the kernels; must reach the exact optimum (< 1e-9);
5. parity    — one FedCET round of the reduced model on the card and on
               the CPU from the same parameters and tokens;
6. train     — the main path: ``run_training`` of fedlm-100m at full width
               (4 clients, batch 8, seq 128, tau 2, 5 rounds), with the
               kernels' launch counts reset just before and read just after,
               per-round loss, time, the Lemma 2 invariant and where the
               round's time goes (gradients vs the two kernels).

Then the kernels summary line, the ``nvidia-smi`` name/power-limit line and
the final ``{"ok": true, ...}`` line. Any failed check raises: the script
exits non-zero and prints no final line. Without a CUDA card it exits 2.
"""

from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
FP32_FLOPS = 67e12             # H100 SXM float32, outside the tensor cores
FP64_FLOPS = 34e12             # H100 SXM float64, outside the tensor cores
MAIN_SHAPE = (4, 14, 640, 2560)  # fedlm-100m's largest stacked leaf (mlp)
ALPHA, C = 3e-3, 0.05
INVARIANT_MAX = 1e-5           # ||sum_i d_i|| / (c ||x||), float32 rounding


class SmokeFailure(AssertionError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def emit(obj):
    print(json.dumps(obj), flush=True)


def smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters=20, warmup=3) -> float:
    """Mean device time of ``fn`` over ``iters`` calls, CUDA events."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, flops: float, dtype) -> tuple[float, str]:
    peak = FP64_FLOPS if dtype == torch.float64 else FP32_FLOPS
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


# ---------------------------------------------------------------- phases
def phase_build():
    from repro_torch.kernels import fedcet_update as K

    path, seconds, log = K.build(verbose=True)
    regs = [ln.split("Used", 1)[1].strip() for ln in log.splitlines()
            if "Used" in ln and "registers" in ln]
    emit({"phase": "build", "source": str(K.SOURCE.relative_to(ROOT)),
          "library": str(Path(path).relative_to(ROOT)),
          "seconds": seconds, "flags": list(K.NVCC_FLAGS),
          "ptxas_registers": regs})


def _operands(shape, dtype, n, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(shape, generator=gen, device="cuda", dtype=dtype)
            for _ in range(n)]


def _max_err(got, want) -> float:
    return max(float((a - b).abs().max()) for a, b in zip(got, want))


def phase_kernels():
    """Every kernel against its plain version; bitwise (tolerance 0) since
    the kernels are built with --fmad=false."""
    from repro_torch.kernels import fedcet_update as K
    from repro_torch.kernels import ref

    results = {}
    for form in ("fedcet_v", "fedcet_comm", "fedcet_comm4"):
        # ragged: 100003 elements (v) or columns (comm) defeat the 16-byte
        # vector path; (10, 60) float64 is the quadratic phase's shape.
        ragged = (100_003,) if form == "fedcet_v" else (4, 100_003)
        cases = [(MAIN_SHAPE, torch.float32), (MAIN_SHAPE, torch.float64),
                 (ragged, torch.float32), (ragged, torch.float64),
                 ((10, 60), torch.float64)]
        errs, timing = [], None
        K.reset_launches()
        for shape, dtype in cases:
            a, b, e = _operands(shape, dtype, 3, seed=len(errs))
            if form == "fedcet_v":
                x, g, d = a, b, e
                kern = lambda: (K.fedcet_v(x, g, d, ALPHA),)  # noqa: E731
                plain = lambda: (ref.fedcet_v(x, g, d, ALPHA),)  # noqa: E731
                nbytes = 4 * x.numel() * x.element_size()
                flops = 4 * x.numel()
            else:
                d, m, v = a, b, e
                mb = m.mean(0, keepdim=True)
                vv = v if form == "fedcet_comm4" else None
                kern = lambda: K.fedcet_comm(d, m, mb, C, ALPHA, v=vv)  # noqa: E731
                plain = lambda: ref.fedcet_comm(d, m, mb, C, ALPHA, v=vv)  # noqa: E731
                reads = 3 if vv is not None else 2
                nbytes = ((reads + 2) * m.numel() + mb.numel()) * m.element_size()
                flops = 5 * m.numel()
            err = _max_err(kern(), plain())
            torch.cuda.synchronize()
            errs.append({"shape": list(shape), "dtype": str(dtype)[6:],
                         "max_abs_err": err})
            check(err == 0.0, f"{form} {shape} {dtype}: kernel differs from "
                              f"its plain version by {err}")
            if shape == MAIN_SHAPE and dtype == torch.float32:
                p1, k1, k2, p2 = (time_ms(plain), time_ms(kern),
                                  time_ms(kern), time_ms(plain))
                b_ms, b_by = bound(nbytes, flops, dtype)
                timing = {"ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2,
                          "bound_ms": b_ms, "bound_by": b_by,
                          "bytes": nbytes, "flops": flops,
                          "max_abs_err": err}
            torch.cuda.empty_cache()
        results[form] = {**timing, "checks": errs, "tolerance": 0.0,
                         "launches": sum(K.LAUNCHES.values())}
        emit({"phase": "kernels", "kernel": form, **results[form]})
    return results


def phase_quadratic():
    from repro_torch.core import FedCET, max_weight_c
    from repro_torch.core.lr_search import lr_search
    from repro_torch.core.simulate import simulate_quadratic
    from repro_torch.data.quadratic import make_quadratic_problem
    from repro_torch.kernels import fedcet_update as K

    problem = make_quadratic_problem(0, device="cuda")
    tau = 2
    alpha = lr_search(problem.mu, problem.L, tau)
    algo = FedCET(alpha=alpha, c=max_weight_c(problem.mu, alpha), tau=tau,
                  n_clients=problem.n_clients)
    K.reset_launches()
    t0 = time.perf_counter()
    res = simulate_quadratic(algo, problem, 400, device="cuda")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    plain = simulate_quadratic(
        dataclasses.replace(algo, use_fused_kernel=False), problem, 400,
        device="cuda")
    diff = float((res.errors - plain.errors).abs().max())
    emit({"phase": "quadratic", "rounds": 400, "dtype": "float64",
          "alpha": alpha, "c": algo.c, "final_error": res.final_error,
          "max_diff_vs_plain_path": diff, "seconds": seconds,
          "launches": launches})
    check(res.final_error < 1e-9,
          f"quadratic did not reach the exact optimum: {res.final_error}")
    check(diff <= 1e-12, f"kernel and plain FedCET paths differ by {diff}")
    check(all(n > 0 for n in launches.values()), f"launches {launches}")


def phase_parity():
    """One round of the reduced model on the card (kernels, cuBLAS) and on
    the CPU (plain versions) from the same parameters and tokens. Held to
    the CPU tests' bounds against the reference: x within 1e-5 of each
    leaf's scale, d within 1e-5 * c * scale."""
    from repro_torch.configs import get_config
    from repro_torch.core import FedCET
    from repro_torch.data.synthetic import make_hetero_lm_dataset
    from repro_torch.models import build_model
    from repro_torch.utils.tree import tree_leaves, tree_map

    cfg = get_config("fedlm-100m").reduced()
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    toks = make_hetero_lm_dataset(cfg.vocab_size, 4, 32, 2).sample_round(0, 2)
    algo = FedCET(alpha=ALPHA, c=C, tau=2, n_clients=4)
    grad_fn = torch.func.grad(model.loss)
    states = {}
    for dev in ("cpu", "cuda"):
        p = tree_map(lambda t: t.to(dev), params)
        b = {"tokens": toks.to(dev)}
        s = algo.init(grad_fn, p, {"tokens": b["tokens"][0]})
        states[dev] = algo.round(grad_fn, s, b)
    worst = 0.0
    for name, tol in (("x", 1e-5), ("d", 1e-5 * C)):
        for a, b, xs in zip(tree_leaves(getattr(states["cuda"], name)),
                            tree_leaves(getattr(states["cpu"], name)),
                            tree_leaves(states["cpu"].x)):
            scale = float(xs.abs().max())
            err = float((a.cpu() - b).abs().max()) / scale
            worst = max(worst, err / tol)
            check(err <= tol, f"card vs CPU {name}: {err} > {tol} of scale")
    emit({"phase": "parity", "model": "fedlm-100m reduced", "rounds": 1,
          "worst_error_over_tolerance": worst})


class _Timeline:
    """CUDA-event intervals of the gradient evaluations and the two kernel
    wrappers, grouped per training round (closed by the round callback)."""

    def __init__(self):
        self.open, self.rounds = [], []

    def wrap(self, fn, key):
        def timed(*args, **kw):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            out = fn(*args, **kw)
            e.record()
            self.open.append((key, s, e))
            return out
        return timed

    def close_round(self):
        torch.cuda.synchronize()
        split = {"grad_ms": 0.0, "fedcet_v_ms": 0.0, "fedcet_comm_ms": 0.0}
        for key, s, e in self.open:
            split[key + "_ms"] += s.elapsed_time(e)
        self.rounds.append(split)
        self.open = []


def phase_train():
    from repro_torch.core import engine
    from repro_torch.kernels import fedcet_update as K
    from repro_torch.kernels import ops
    from repro_torch.launch.train import run_training
    from repro_torch.utils.tree import tree_leaves

    timeline = _Timeline()
    real = (engine.vmap_grads, ops.fedcet_v, ops.fedcet_comm)
    engine.vmap_grads = lambda f: timeline.wrap(real[0](f), "grad")
    ops.fedcet_v = timeline.wrap(real[1], "fedcet_v")
    ops.fedcet_comm = timeline.wrap(real[2], "fedcet_comm")
    invariants = []

    def on_round(r, loss, comm, state):
        timeline.close_round()
        norm = lambda ts: math.sqrt(sum(float(t.double().pow(2).sum())  # noqa: E731
                                        for t in ts))
        d = tree_leaves(state.d)
        resid = norm(t.double().sum(0) for t in d)
        # d_i = c (v_i - mean v) accumulates float32 rounding of v, so the
        # residual is measured against c ||x||; against ||d|| (small while
        # the clients are still close) it reads ~1e-4 in the reference too.
        invariants.append({"sum_d_over_c_x": resid / (C * norm(
            tree_leaves(state.x))), "sum_d_over_d": resid / norm(d)})
        check(math.isfinite(loss), f"round {r}: loss {loss}")
        check(invariants[-1]["sum_d_over_c_x"] <= INVARIANT_MAX,
              f"round {r}: Lemma 2 residual {invariants[-1]}")

    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    try:
        hist = run_training("fedlm-100m", reduced=False, n_clients=4,
                            batch=8, seq_len=128, tau=2, steps=5,
                            device="cuda", log_every=1, callback=on_round)
    finally:
        engine.vmap_grads, ops.fedcet_v, ops.fedcet_comm = real
    launches = dict(K.LAUNCHES)
    for i, r in enumerate(hist["round"]):
        emit({"phase": "train", "round": r, "loss": hist["loss"][i],
              "round_s": hist["seconds"][i],
              "invariant": invariants[i],
              "split_ms": timeline.rounds[i],
              "note": "round 0 also holds the warm-up" if r == 0 else ""})
    emit({"phase": "train", "arch": "fedlm-100m", "reduced": False,
          "n_params": hist["n_params"], "clients": 4, "batch": 8, "seq_len": 128,
          "tau": 2, "rounds": len(hist["round"]),
          "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
          "launches": launches})
    check(len(hist["loss"]) == 5, "train did not log 5 rounds")
    check(all(n > 0 for n in launches.values()),
          f"a kernel of the main path never launched: {launches}")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA card; torch.cuda.is_available() "
              "is false", file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = smi_line()
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    t0 = time.perf_counter()
    phase_build()
    kernels = phase_kernels()
    phase_quadratic()
    phase_parity()
    launches = phase_train()
    src = "src/repro_torch/kernels/csrc/fedcet_update.cu"
    summary = []
    for name, form, replaces in (
            ("fedcet_v", "fedcet_v",
             "src/repro/kernels/fedcet_update.py:45"),
            ("fedcet_comm", "fedcet_comm",
             "src/repro/kernels/fedcet_update.py:154")):
        k = kernels[form]
        summary.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max(c["max_abs_err"] for c in k["checks"]),
            "ms": k["ms"], "plain_ms": k["plain_ms"],
            "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
            "library_ms": None})
    four = kernels["fedcet_comm4"]
    summary[1]["four_operand"] = {
        "replaces": "src/repro/kernels/fedcet_update.py:80",
        "max_abs_err": max(c["max_abs_err"] for c in four["checks"]),
        **{k: four[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")}}
    emit({"phase": "done", "seconds": time.perf_counter() - t0})
    emit({"kernels": summary})
    print(smi)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
