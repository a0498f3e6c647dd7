#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA H100.

    python3 chip_smoke.py

Drives the port (``src/repro_torch``) only, and imports nothing of JAX or
of the JAX package. Phases, one JSON line each:

1. device    — the card, its power limit, the software versions;
2. build     — every CUDA source of ``csrc/`` compiled with nvcc (one
               process per source, all started together) and linked;
               ``-Xptxas -v``'s registers, spills and static shared memory
               per kernel, and the registers and spills of every flash
               attention instantiation (operand type x head dim);
3. kernels   — each kernel form against its plain PyTorch version, at
               tolerance 0, at the main paths' shapes (the largest stacked
               fedlm-100m leaf ``[4, 14, 640, 2560]``, the arena
               ``[4, 104499, 1024]``, and path E's 8-client arena
               ``[8, 107006976]``: the gossip reduce with the 8-ring's
               table (each gossip case with the route it took: column-
               owning where all R source rows of a column tile fit in
               shared memory, node-owning for the wide table and n 1024),
               the triad, the pair in its one-client form with a
               per-client m_bar of m's shape, and the telemetry sketch's
               norms, histogram and top ids, run twice) in float32
               and float64, at ragged sizes and at the edge cases (zero
               scales, zero client weights, per-client dither, unaligned
               pointers, zero-weight pad slots, S in {1, 3, 5, n}, n in
               {1, 8, 10, 13, 1024}, zero rows, norms past both edge bins);
               flash attention within 2e-5 (in bfloat16 rtol 2e-2, atol
               5e-3, element by element) at the serve prefills
               (fedlm-100m ``[4, 2048, 10/5, 64]`` causal, qwen3-1.7b
               ``[1, 8192, 16/8, 128]`` sliding 4096, zamba2-1.2b
               ``[1, 8192, 32/32, 64]`` sliding 4096, granite-moe ``[4,
               2048, 24/8, 64]`` causal, gemma-2b ``[1, 8192, 8/1, 256]``
               sliding 4096, whisper-small's encoder ``[4, 1500, 12/12,
               64]`` bidirectional, llava-next-34b ``[1, 3904, 56/8,
               128]`` causal), the first also in bfloat16, and at S in {1000, 2047}, T != S,
               every mask kind (chunk 7 and 64, a window of 5 inside one
               kv tile), G in {1, 2, 8}, D in {16, 32, 64, 128, 256}, and
               rows with no allowed key (chunked and sliding, T < S), each
               equal to its own repeat bit for bit, the main case timed in
               float32 and in bfloat16 (the gossip reduce's in float32 and
               float64); the
               SSD intra-chunk term within 1e-4 of the output's scale (1e-2
               in bfloat16) at mamba2-130m's prefill ``[4, 16, 128, 24,
               64]``, N 128 (also in bfloat16), at zamba2-1.2b's ``[1,
               64, 128, 64, 64]``, N 64, at the reference's sweep
               shapes in float32 and bfloat16, a ragged chunk of 37, Lc, P
               and N all off the tensor-core tiles (45, 20, 12), a_cs near
               -1e3, P 128 and uneven head groups, and equal to its own
               repeat bit for bit; kernel, plain and bound times from CUDA
               events (the bound of the two float32 forms on the tensor
               cores, flash attention and the SSD term, at 495 / 3 TFLOP/s:
               3xTF32), the kernel's and the library call's device time
               (``device_ms``: the same 20 calls replayed from one CUDA
               graph, without the host's dispatch), and the library
               yardsticks: torch.matmul with the
               dense weighted matrix for the gossip reduce,
               torch.linalg.vector_norm (norms only) for the sketch,
               scaled_dot_product_attention (enable_gqa) for flash
               attention, the two batched torch.matmul products alone
               (C B^T and W @ x, no mask or exp) for the SSD term; the
               arena's packed dither (``threefry_uniform_rows``) bit for
               bit at the granite-moe cell's layout ``[1|4, 270469,
               1024]`` (client-shared and per-client, float32 and
               float64) and at ragged leaves, its bound the write or its
               busiest integer pipe (132 x 64 lanes x 1.98 GHz);
4. quadratic — FedCET on the paper's §IV problem in float64 through the
               kernels: uncompressed (400 rounds), ``shift:q8`` on the
               arena through the fused tail and per leaf (both must reach
               < 1e-9), and ``shift:q8`` on the arena at 0.8 participation
               (within 10x of the uncompressed run under the same
               sampling); then the topologies: NIDS over ``ring:sparse``,
               ``torus:sparse`` and ``er:0.5:sparse`` (2000 rounds,
               max-client error < 1e-9), FedCET over ``ring:sparse`` (1200
               rounds, < 1e-9, ``|mean_i d_i| <= 1e-10``) and ``hier:g5``
               (800 rounds, < 1e-9), and ``er:0.5:t:sparse`` against
               ``er:0.5:t`` (per-round errors within 1e-12 over 50 rounds);
               FedCET on the arena with the population sketches (the sketch
               kernel in float64, 400 rounds: < 1e-9, Lemma 2 residual
               <= 1e-6, telemetry on equal to off bit for bit);
4b. staleness — ``benchmarks/staleness_sweep.py``'s bounds in float64 on
               the paper's problem (1500 rounds): FedCET under ``rr:2``
               with ``drop`` and ``last`` and under ``fixed:2`` with
               ``poly:1`` < 1e-9, under ``rr:2`` with ``poly:1`` > 1e-4;
               SCAFFOLD under ``rr:2`` with ``last`` > 1e-1, with ``drop``
               < 1e-2;
4c. cohort   — ``benchmarks/cohort_scaling.py`` in float64 (cohort 256,
               ``block``, dim 8): the gather and dense lowerings within
               1e-12 after 4 rounds for FedCET, FedAvg, SCAFFOLD and
               FedTrack at N 1000; the gather round's ms at N 1e3..1e6
               (growth from 1e4 to 1e6 at most 1.5x) and the dense round's
               at N 1e3..1e5 (printed only);
5. parity    — one FedCET round of the reduced model on the card and on
               the CPU from the same parameters and tokens;
6. prng      — the arena's threefry dither of fedlm-100m and of the
               granite-moe benchmark cell's layout (2 of 32 layers): the
               packed kernel (``threefry_uniform_rows``, one launch) and
               the eager per-leaf draw it replaced, timed, bitwise equal,
               beside the write bound and the busiest integer pipe's;
7. fig1      — the paper's Fig. 1 in float64 (``paper_fig1_algorithms``:
               FedCET, FedTrack, SCAFFOLD, FedAvg on the §IV problem, tau
               2, 300 rounds): e(k) at rounds 0/50/100/200/300, bytes per
               round and seconds; the ordering fedcet < fedtrack <
               scaffold at round 300; every card curve within 1e-10 of the
               same algorithm's CPU curve at every round; FedCET launches
               exactly fedcet_v 601 and fedcet_comm 301, the baselines no
               kernel; FedAvg's drift floor (> 1e-4, flat over the last
               100 rounds) on the heterogeneous-Hessian problem at 800
               rounds;
8. train     — ``run_training`` of fedlm-100m at full width (4 clients,
               batch 8, seq 128, tau 2, 5 rounds) on four paths, each with
               the launch counts reset just before and read just after:
               (A) the dense star round, (B) ``shift:q8`` on the arena (the
               fused round tail), (C) ``shift:q8`` per leaf at
               participation 0.75, (D) ``q8`` on the arena; then at 8
               clients, batch 4 (the same tokens per round): (E) the gossip
               main path, ``ring:sparse`` on the arena (the gossip reduce
               kernel), (F) ``ring`` on the arena (the dense lowering,
               torch.matmul; its losses and its final drift d held against
               E's), (G) ``hier:g4`` on the arena; (E2) path E again, for
               its run-to-run gap; (H) path E with telemetry
               (``jsonl``, ``hist:48``, ``--trace-rounds 3:4``): its final
               x and d equal E's bit for bit (or within E's own gap), it
               launches exactly E's kernels plus ``telemetry_sketch`` 10,
               its JSONL renders with ``benchmarks/report.py`` and the
               profiler trace of round 3 gives the top device kernels and
               the device idle share; then at 4 clients again (P) a
               per-leaf ``CompressionPlan`` on the arena, allocated at
               uniform ``shift:q8``'s exact bits on the run's own
               parameters (``absmax``, ``shift`` wrappers): exactly
               fedcet_v 11, fedcet_comm4 6 and one stochastic_quantize per
               quantized leaf per aggregation, no fedcet_round_tail (a plan
               is not ``Shifted(StochasticQuant)``); (L) B under ``rr:2``
               stragglers with the ``last`` policy: exactly fedcet_v 11,
               stochastic_quantize_rows 6, threefry_uniform_rows 6,
               fedcet_comm4 6 and no fedcet_round_tail (a delayed
               aggregation never fuses), the
               uplink billed at exactly half of B's bits; (K) a 16-client
               store at batch 4 with a ``block:4`` cohort, through the
               engine: init (dense, 16 clients) exactly fedcet_v 1,
               fedcet_round_tail 1 and threefry_uniform_rows 1, the 5
               rounds exactly fedcet_v 10, stochastic_quantize_rows 5,
               threefry_uniform_rows 5 and fedcet_comm4 5, each round
               writing the store in place (the same ``data_ptr()``) and
               leaving the 12 other rows bitwise unchanged, its first
               round's cohort rows held against a plain 4-client engine
               on the same rows and tokens, with its gather and scatter
               timed and the peak GB; (M) B's scenario on mamba2-130m at
               full width: exactly fedcet_v 11, fedcet_round_tail 6 and
               threefry_uniform_rows 6, no ssd_intra (the gradients take the plain SSD), and one
               ``use_pallas_ssd`` forward at the training shape within
               2e-4 (rtol = atol) of the plain one; the remat check (one
               local step's ``vmap(grad)`` of 4 clients x 8 x 128 with the
               rematerialized bodies of ``models/remat.py`` and without:
               fedlm-100m, whose only recompute is the chunked cross
               entropy, and mamba2-130m, ``remat=True``: the gradients bit
               for bit, peak GB and ms of each); (MO, ZA, WH)
               granite-moe-3b-a800m cut to 2 of 32 layers, zamba2-1.2b to 6
               of 38 and whisper-small whole (4 clients x 2 sequences of
               1500 frames + 64 tokens, rematerialized layer by layer as
               its config asks) through the engine under B's scenario, 3
               rounds each: exactly fedcet_v 7, fedcet_round_tail 4 and
               threefry_uniform_rows 4, the
               round-0 loss within 1e-5 of the CPU's, round 1 against a
               rerun on the plain kernels. Per round: loss, time,
               the Lemma 2 residual and where the time goes (gradients,
               each kernel, the dither, the scale pass, pack/unpack, the
               topology's reduce, the loss, the telemetry and its sketch
               kernel);
8b. plans    — per-leaf plans at full width, fedlm-100m's seed-0 weights
               from the CPU generator moved to the card: the benchmark's
               head-to-head (``benchmarks/comp_plan_bench.py``), plan bits
               <= uniform ``shift:q8`` bits exactly and the quantization
               MSE ratio at most the reference's own full-width value
               (1.0355: the reference does not reach < 1 at full width);
               the uniform plan ``*:shift:q8`` and
               ``Shifted(StochasticQuant(8))`` on one full-width 4-client
               message and shift memory, bitwise equal;
9. trainer   — ``fed/trainer.py:FedTrainer`` on fedlm-100m at full width
               (4 clients, batch 8, seq 128, tau 2). Path T, B's scenario
               (``shift:q8`` on the arena): 6 rounds straight (eval every
               3); 3 rounds with a checkpoint at round 3 (keep 1) into a
               temporary directory; a fresh trainer that resumes from it
               and runs rounds 3-5 (checkpointing at 6): its final x, d
               and shift memory equal the straight run's bit for bit, and
               so do its round-5 losses; exact launches of fedcet_v,
               fedcet_round_tail and threefry_uniform_rows in each run; segment times, the
               checkpoints' bytes and save and restore seconds, peak GB.
               The directory needs ~10.3 GB of disk while round 6 is
               saved (two 5.1 GB files) and is removed. Then T-fedavg,
               T-scaffold and T-fedtrack (alpha 3e-3, no transform, 3
               rounds, eval every round): finite losses, no FedCET kernel
               launched, SCAFFOLD and FedTrack billed twice FedAvg's bytes
               a round;
10. serve    — ``launch/serve.py:generate_tokens`` at full width, float32,
               random weights from seed 0, the reference's prompt draw:
               (S1) fedlm-100m, batch 4, prompt 2048, 64 tokens; (S2)
               qwen3-1.7b, batch 1, prompt 8192 through its 4096-slot
               ring cache, 32 tokens; (S3) mamba2-130m, batch 4, prompt
               2048, 64 tokens; (S4) zamba2-1.2b, batch 1, prompt 8192
               through the shared block's 4096-slot rings, 32 tokens; (S5)
               granite-moe-3b-a800m, batch 4, prompt 2048, 64 tokens;
               (S6) gemma-2b, batch 1, prompt 8192 through a 4096-slot
               ring, 32 tokens; (S7) whisper-small, batch 4, 1500 frames
               and a 64-token prompt, 64 tokens; (S8) llava-next-34b cut
               to 4 of its 60 layers, batch 1, 2880 image tokens and a
               1024-token prompt, 32 tokens. Launch counts reset just
               before and read just after, exact per prefill:
               flash_attention 14, 28, 0, 6, 32, 18, 24 (12 bidirectional
               over the frames, 12 causal), 4; ssd_intra 24 on S3 and 38
               on S4; no other kernel. Prefill ms (the run's first, then
               three more into fresh caches), decode ms per token,
               tokens/s and peak GB; the logits of the run (teacher-forced
               on its tokens) within 1e-4 of their scale of the same run
               with the kernels' plain versions; the prefill of all but
               the last prompt token plus one decode step against
               ``forward`` (S1, S7: plain attention, within 1e-4; S3: the
               plain SSD, within 2e-3); S3's ``forward`` with
               ``use_pallas_ssd`` within 2e-4 (rtol = atol) of the plain
               one; all finite; then 4 decode steps under
               ``torch.profiler``: top device kernels and the device idle
               share (trace in ``build/smoke/``);
11. sharded  — S1 and S3 at full width through ``launch/serve.py:
               lower_prefill`` / ``lower_decode`` on a real one-rank NCCL
               group and a 1 x 1 ("data", "model") mesh, the weights
               distributed with the partition rules' placements: exactly
               flash 14 / ssd_intra 24 in the prefill, the prefill's and 8
               decode steps' logits within 1e-5 of their scale of the same
               weights served unsharded, 0 collective bytes; then the
               train round of ``launch/train.py`` (``make_plan`` on that
               mesh, 4 clients x batch 8 x seq 128, fedlm-100m at full
               width in float32, tau 2, weights from seed 0) under A's
               scenario (``A_sharded``: exactly fedcet_v 24 / fedcet_comm
               12 a round) and C's (``C_sharded``: fedcet_v 24 /
               fedcet_comm4 12 / stochastic_quantize 12 a round): the
               unsharded engine's init, the state distributed with
               ``state_shardings``, 3 rounds through ``LoweredTrain.run``
               against the same 3 rounds unsharded from the same state and
               batches: x and d of every leaf within 1e-6 of the leaf's
               scale (max |x|), every loss finite, 0 collective bytes;
               round ms (host clock to ``torch.cuda.synchronize()``) and
               peak GB printed;
12. roofline — the port's cost model (``roofline/flops.py:cost_for``, one
               card, H100 data-sheet peaks) for train paths B, M and
               A_sharded (``[n_clients * batch, seq]`` a local step, tau 2) and serve
               paths S1-S8 (S8 at its 4 layers) at their own configs,
               shapes and dtypes: compute and memory terms, the bottleneck,
               the time this run measured (rounds 1-4's median; the
               repeated prefills' median; the mean decode step, at the
               mean context), ``round_mfu`` / ``prefill_mfu`` /
               ``decode_mfu`` = model FLOPs / (measured s x peak of the
               dtype), each gated to (0, 1.05], and ``bound_share`` = the
               larger term / measured (printed only: the analytic
               attention context is the whole sequence);
13. dryrun   — seven full-width cells of ``launch/dryrun.py`` on a fake
               16 x 16 world (bfloat16): qwen3-1.7b x prefill_32k and
               decode_32k, granite-moe-3b-a800m x prefill_32k (the
               token-sharded MoE dispatch), mamba2-130m x long_500k,
               llama4-scout-17b-a16e x decode_32k (108 B parameters as
               fake shards), and two FedCET train rounds: qwen3-1.7b x
               train_4k (16 clients on data, TP 16) and
               llama4-scout-17b-a16e x train_4k (the fsdp 4 view), in a
               subprocess that sees no card; each ends
               ok, its argument bytes equal the local shards' from the
               specs' arithmetic, and its memory, collectives by kind and
               three roofline terms are printed; the train cells' temp
               (layer bodies rematerialized as the configs ask) is printed
               beside, and must stay below, what it was without
               activation checkpointing (165 and 1,058 GB a device).

Then the kernels summary line, the ``nvidia-smi`` name/power-limit line and
the final ``{"ok": true, ...}`` line. Any failed check raises: the script
exits non-zero and prints no final line. Without a CUDA card it exits 2.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import re
import socket
import statistics
import shutil
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
BF16_FLOPS = 989e12            # H100 SXM bfloat16, tensor cores, dense
TF32_FLOPS = 495e12            # H100 SXM TF32, tensor cores, dense
#: forms that run float32 on the tensor cores as 3xTF32: three TF32
#: products (lo hi + hi lo + hi hi) for each float32 one, so their float32
#: peak is TF32_FLOPS / 3 (one TF32 pass misses their gates); every other
#: float32 form runs outside the tensor cores, at FP32_FLOPS
TENSOR_CORE_F32 = ("flash_attention", "ssd_intra")
#: 32-bit integer operations an H100 SXM executes a second on one pipe:
#: 132 SMs x 64 lanes x 1.98 GHz, for the ALU pipe (SHF, LOP3, IADD3) and
#: for IMAD on the FMA pipe alike (the SM issues 128 lanes a clock, so two
#: pipes together can reach its issue rate, one alone half of it)
INT_PIPE_OPS_PER_S = 132 * 64 * 1.98e9
#: forms whose operations are 32-bit integer ones (their "flops" count
#: the operations on their busiest pipe, timed at INT_PIPE_OPS_PER_S)
INT_FORMS = ("threefry_uniform_rows",)
#: operations a coordinate of ``threefry_uniform_rows`` (float32) takes on
#: each pipe, from its SASS (SHF 101, LOP3 106, IADD3 58, IMAD 113 for the
#: five inlined hashes: a thread's four chains and the leaf key, which a
#: block recomputes only where its run of rows enters another leaf): one
#: hash is 20 rounds of add, rotate and xor, 5 key injections and the
#: key's first add, the adds split by the compiler between IADD3 and IMAD
THREEFRY_ALU_OPS = 53
THREEFRY_IMAD_OPS = 23
MAIN_SHAPE = (4, 14, 640, 2560)  # fedlm-100m's largest stacked leaf (mlp)
ARENA_SHAPE = (4, 104_499, 1024)  # fedlm-100m's stacked arena
ALPHA, C = 3e-3, 0.05
BITS, BETA = 8, 1.0              # shift:q8: 8-bit codes, DIANA step 1
INVARIANT_MAX = 1e-5           # ||sum_i d_i|| / (c ||x||), float32 rounding
D_GAP_MAX = 1e-3               # ||d_E - d_F|| / ||d_F|| after 5 rounds
TRAIN = dict(n_clients=4, batch=8, seq_len=128, tau=2, steps=5)
TRAIN_TOPO = dict(n_clients=8, batch=4, seq_len=128, tau=2, steps=5)
GOSSIP_SHAPE = (8, 107_006_976)  # fedlm-100m's 8-client arena, [n, rows*1024]
SRC = "src/repro_torch/kernels/csrc/"
#: kernel form -> (source, TPU kernel it replaces: def / pallas_call line)
KERNELS = {
    "fedcet_v": ("fedcet_update.cu", "src/repro/kernels/fedcet_update.py:45"),
    "fedcet_comm": ("fedcet_update.cu",
                    "src/repro/kernels/fedcet_update.py:154"),
    "fedcet_comm4": ("fedcet_update.cu",
                     "src/repro/kernels/fedcet_update.py:80"),
    "stochastic_quantize": ("quantize.cu", "src/repro/kernels/quantize.py:59"),
    "stochastic_quantize_rows": ("quantize.cu",
                                 "src/repro/kernels/quantize.py:90"),
    "fedcet_round_tail": ("fedcet_update.cu",
                          "src/repro/kernels/fedcet_update.py:136"),
    "gossip_reduce": ("gossip_reduce.cu",
                      "src/repro/kernels/gossip_reduce.py:59"),
    "telemetry_sketch": ("telemetry_reduce.cu",
                         "src/repro/kernels/telemetry_reduce.py:93"),
    "flash_attention": ("flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:110"),
    "ssd_intra": ("ssd_intra.cu", "src/repro/kernels/ssd_intra.py:52"),
    "threefry_uniform_rows": ("threefry.cu",
                              "none: XLA fuses each jax.random.uniform, "
                              "src/repro/core/compressors.py:388-395"),
}
SKETCH = dict(bins=48, lo=-12.0, hi=4.0, k=4)  # hist:48, the default topk


#: the times the train and serve phases measured, for the roofline phase
MEASURED: dict = {}


class SmokeFailure(AssertionError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def emit(obj):
    print(json.dumps(obj, default=str), flush=True)


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


def device_ms(fn, iters=20, warmup=3) -> float:
    """Mean device time of ``fn`` over ``iters`` calls captured in one CUDA
    graph and replayed, CUDA events: the calls' kernels back to back,
    without the host's dispatch between them (no profiler: a profiler
    session leaves the host slower for the rest of the process)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    torch.cuda.empty_cache()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, flops: float, dtype,
          form: str | None = None) -> tuple[float, str]:
    if form in INT_FORMS:
        peak = INT_PIPE_OPS_PER_S
    elif dtype == torch.float32 and form in TENSOR_CORE_F32:
        peak = TF32_FLOPS / 3
    else:
        peak = {torch.float64: FP64_FLOPS, torch.bfloat16: BF16_FLOPS}.get(
            dtype, FP32_FLOPS)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


# ---------------------------------------------------------------- phases
def phase_build():
    from repro_torch.kernels import library as L

    path, seconds, log = L.build(verbose=True)
    ptxas = _ptxas(log)
    emit({"phase": "build",
          "sources": [str(f.relative_to(ROOT)) for f in L.SOURCES],
          "library": str(Path(path).relative_to(ROOT)),
          "seconds": seconds, "flags": list(L.NVCC_FLAGS),
          "ptxas": ptxas, "flash_ptxas": _flash_ptxas(ptxas)})


def _flash_ptxas(ptxas):
    """Registers and spills of each flash-attention instantiation (operand
    type x head dim), from its mangled name (``flash_fwd_kernelI<T>Li<D>E``)."""
    out = []
    for k in ptxas:
        m = re.search(r"flash_fwd_kernelI(f|13__nv_bfloat16)Li(\d+)E",
                      k["kernel"] or "")
        if m:
            regs = re.search(r"(\d+) registers", k["usage"])
            spill = re.findall(r"(\d+) bytes spill (stores|loads)",
                               k["frame"] or "")
            out.append({"dtype": "float32" if m[1] == "f" else "bfloat16",
                        "head_dim": int(m[2]),
                        "registers": int(regs[1]) if regs else None,
                        "spill_bytes": {kind: int(n) for n, kind in spill}})
    return sorted(out, key=lambda e: (e["dtype"], e["head_dim"]))


def _ptxas(log):
    """Per kernel of ``-Xptxas -v``'s build log: its source, its (mangled)
    name, its stack frame and spills, and its registers, barriers and
    static shared memory."""
    out, src, fn, frame = [], None, None, None
    for ln in log.splitlines():
        if ln.startswith("== "):
            src = ln[3:].strip()
        elif "Compiling entry function" in ln:
            fn = ln.split("'")[1]
        elif "bytes stack frame" in ln:
            frame = ln.strip()
        elif "Used" in ln and "registers" in ln:
            out.append({"source": src, "kernel": fn, "frame": frame,
                        "usage": ln.split("Used", 1)[1].strip()})
    return out


def _operands(shape, dtype, n, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(shape, generator=gen, device="cuda", dtype=dtype)
            for _ in range(n)]


def _uniform(shape, dtype, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return torch.rand(shape, generator=gen, device="cuda", dtype=dtype)


def _max_err(got, want, chunk=1 << 27) -> float:
    """Largest |got - want| over the pairs, in chunks (no full-size
    temporary beside the 6.8 GB float64 gossip operands)."""
    return max(float((x - y).abs().max())
               for a, b in zip(got, want)
               for x, y in zip(a.reshape(-1).split(chunk),
                               b.reshape(-1).split(chunk)))


def _case_fedcet(form, shape, dtype, seed, one_client=False):
    """(kernel, plain, bytes, flops) of a triad / pair case. ``one_client``:
    a per-client m_bar of m's shape, the gossip aggregate of path E, which
    the wrapper reads as one client."""
    from repro_torch.kernels import fedcet_update as K
    from repro_torch.kernels import ref

    a, b, e = _operands(shape, dtype, 3, seed)
    es = a.element_size()
    if form == "fedcet_v":
        return (lambda: (K.fedcet_v(a, b, e, ALPHA),),
                lambda: (ref.fedcet_v(a, b, e, ALPHA),),
                4 * a.numel() * es, 4 * a.numel())
    mb = e if one_client else b.mean(0, keepdim=True)
    vv = e if form == "fedcet_comm4" else None
    reads = 3 if vv is not None else 2
    return (lambda: K.fedcet_comm(a, b, mb, C, ALPHA, v=vv),
            lambda: ref.fedcet_comm(a, b, mb, C, ALPHA, v=vv),
            ((reads + 2) * b.numel() + mb.numel()) * es, 5 * b.numel())


def _case_quantize(shape, dtype, seed, per_client=False, zero=False):
    """One scale per leaf; u shared ([...]) or per client ([C, ...])."""
    from repro_torch.kernels import quantize as KQ
    from repro_torch.kernels import ref

    (a,) = _operands(shape, dtype, 1, seed)
    u = _uniform(shape if per_client else shape[1:], dtype, seed + 1)
    s = (torch.zeros((), dtype=dtype, device="cuda") if zero
         else a.abs().amax() / 127)
    es = a.element_size()
    return (lambda: (KQ.stochastic_quantize(a, u, s, BITS),),
            lambda: (ref.stochastic_quantize(a, u, s, BITS),),
            (2 * a.numel() + u.numel() + 1) * es, 4 * a.numel())


def _arena_rows_scale(a, zero_rows=True):
    s = a.abs().amax(dim=(0, 2)) / 127
    if zero_rows:
        s[1::97] = 0.0  # constant-zero leaves quantize to 0
    return s[:, None].contiguous()


def _case_quantize_rows(shape, dtype, seed):
    from repro_torch.kernels import quantize as KQ
    from repro_torch.kernels import ref

    (a,) = _operands(shape, dtype, 1, seed)
    u = _uniform(shape[1:], dtype, seed + 1)
    s = _arena_rows_scale(a)
    es = a.element_size()
    return (lambda: (KQ.stochastic_quantize_rows(a, u, s, BITS),),
            lambda: (ref.stochastic_quantize_rows(a, u, s, BITS),),
            (2 * a.numel() + u.numel() + s.numel()) * es, 4 * a.numel())


def _case_round_tail(shape, dtype, seed, mask=None):
    """v, h, d [C, rows, lanes], shared dither, a scale per row (some zero),
    client weights from ``mask`` (zeros for absent clients) and den."""
    from repro_torch.kernels import fedcet_update as K
    from repro_torch.kernels import ref

    v, h, d = _operands(shape, dtype, 3, seed)
    h.mul_(0.5)
    u = _uniform(shape[1:], dtype, seed + 1)
    s = _arena_rows_scale(v - h)
    n = shape[0]
    m = torch.ones(n, dtype=torch.bool) if mask is None else torch.tensor(mask)
    w = m.to(dtype).reshape(n, 1).cuda()
    den = torch.clamp(m.to(torch.int64).sum(), min=1).to(dtype).reshape(
        1, 1).cuda()
    kw = dict(c=C, alpha=ALPHA, beta=BETA, bits=BITS)
    es = v.element_size()
    return (lambda: K.fedcet_round_tail(v, h, d, u, s, w, den, **kw),
            lambda: ref.fedcet_round_tail(v, h, d, u, s, w, den, **kw),
            (6 * v.numel() + u.numel() + s.numel() + n + 1) * es,
            14 * v.numel())


def _gossip_table(n, slots, rows, seed, dtype):
    """A padded neighbor table on the card: slot 0 the node itself, random
    neighbors, a zero-weight self pad in the last slot of even nodes."""
    gen = torch.Generator().manual_seed(seed)
    idx = torch.randint(0, rows, (n, slots), generator=gen)
    idx[:, 0] = torch.arange(n) % rows
    wgt = torch.rand((n, slots), generator=gen, dtype=torch.float64)
    if slots > 1:
        pad = torch.arange(n) % 2 == 0
        idx[pad, -1] = idx[pad, 0]
        wgt[pad, -1] = 0.0
    return idx.cuda(), wgt.to(dtype).cuda()


def _case_gossip(shape, dtype, seed, slots=3, rows=None, ring=False,
                 unaligned=False, identity=False):
    """(kernel, plain, bytes, flops, library, {"route": ...}) of a gossip
    reduce case (the route the kernel takes: ``"column"`` or ``"node"``).
    ``ring``: the 8-ring's Metropolis table (``Mixing._static_tables``);
    ``identity``: the reference's contract, a segment sum over a
    ``[n*S, D]`` tensor; the library call is torch.matmul with the dense
    row-normalized matrix of the same table, ``(W / denom) @ src``."""
    from repro_torch.core.topology import Mixing
    from repro_torch.kernels import gossip_reduce as KG
    from repro_torch.kernels import ops, ref

    n, dim = shape
    es = torch.empty((), dtype=dtype).element_size()
    if identity:
        (contrib,) = _operands((n * slots, dim), dtype, 1, seed)
        table = torch.arange(n * slots, device="cuda").view(n, slots)
        return (lambda: (ops.gossip_reduce(contrib, slots=slots,
                                           impl="kernel"),),
                lambda: (ref.segment_reduce(contrib, slots),),
                (n * slots + n) * dim * es, n * (slots - 1) * dim, None,
                {"route": KG.route(contrib, table)})
    rows = n if rows is None else rows
    if ring:
        idx_np, wgt_np = Mixing.ring(n)._static_tables()
        idx = torch.from_numpy(idx_np).cuda()
        wgt = torch.from_numpy(wgt_np).to(dtype).cuda()
        slots = idx.shape[1]
    else:
        idx, wgt = _gossip_table(n, slots, rows, seed, dtype)
    denom = wgt.sum(dim=1)
    if unaligned:
        (buf,) = _operands((rows * dim + 1,), dtype, 1, seed)
        src = buf[1:].view(rows, dim)
    else:
        (src,) = _operands((rows, dim), dtype, 1, seed)
    library = None
    if rows == n:
        dense = torch.zeros((n, n), dtype=dtype, device="cuda").index_put_(
            (torch.arange(n, device="cuda")[:, None].expand_as(idx), idx),
            wgt, accumulate=True) / denom[:, None]
        library = lambda: (torch.matmul(dense, src),)  # noqa: E731
    nbytes = ((rows + n) * dim + n * slots + n) * es + n * slots * 8
    return (lambda: (KG.gossip_reduce(src, idx, wgt, denom),),
            lambda: (ref.gossip_reduce(src, idx, wgt, denom),),
            nbytes, 2 * slots * n * dim, library,
            {"route": KG.route(src, idx)})


def _case_sketch(shape, dtype, seed, unaligned=False, zero_rows=(0,)):
    """(kernel, plain, bytes, flops, library) of a sketch case: rows whose
    norms span 1e-15 .. 1e6 (past both edges of hist:48's range), some all
    zero; the library call is torch.linalg.vector_norm (norms only)."""
    from repro_torch.kernels import ops

    n, dim = shape
    (buf,) = _operands((n * dim + int(unaligned),), dtype, 1, seed)
    x = buf[int(unaligned):].view(n, dim)
    x.mul_(torch.logspace(-17, 4, n, dtype=dtype, device="cuda")[:, None])
    x[list(z for z in zero_rows if z < n)] = 0.0
    es, k = x.element_size(), min(SKETCH["k"], n)
    nbytes = (n * dim + 2 * n + k) * es + (SKETCH["bins"] + k) * 4
    return (lambda: ops.telemetry_sketch(x, impl="kernel", **SKETCH),
            lambda: ops.telemetry_sketch(x, impl="ref", **SKETCH),
            nbytes, 2 * n * dim,
            lambda: (torch.linalg.vector_norm(x, dim=1),))


def _case_flash(geom, dtype, seed):
    """(kernel, plain, bytes, flops, library) of a flash-attention case:
    q [B, S, Hkv*G, D], k/v [B, T, Hkv, D] from seed; flops are 4 B Hq D
    times the (q, k) pairs the mask allows, so a masked-out tile is not
    billed; the library call is scaled_dot_product_attention with
    enable_gqa (causal as is_causal when S == T, any other mask as the
    boolean tensor of the naive path's ``mask_fn``)."""
    from repro_torch.kernels import flash_attention as KF
    from repro_torch.kernels import ref
    from repro_torch.models.attention import mask_fn

    B, S, T, Hkv, G, D, kind, window, chunk = geom
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((B, S, Hkv * G, D), generator=gen, device="cuda")
    k, v = (torch.randn((B, T, Hkv, D), generator=gen, device="cuda")
            for _ in range(2))
    q, k, v = (t.to(dtype) for t in (q, k, v))
    kw = dict(kind=kind, window=window, chunk=chunk)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    mask = mask_fn(kind, window=window, chunk=chunk)(
        torch.arange(S, device="cuda")[:, None],
        torch.arange(T, device="cuda")[None, :])
    lib_kw = (dict(is_causal=True) if kind == "causal" and S == T
              else dict(attn_mask=mask))
    es = q.element_size()
    return (lambda: (KF.flash_attention(q, k, v, **kw),),
            lambda: (ref.flash_attention(q, k, v, **kw),),
            2 * (q.numel() + k.numel()) * es,
            4 * B * Hkv * G * D * int(mask.sum()),
            lambda: (sdpa(qt, kt, vt, enable_gqa=True, **lib_kw),))


def _case_ssd(shape, dtype, seed, decay=1.0):
    """(kernel, plain, bytes, flops, library) of an SSD intra-chunk case:
    x [B, Nc, Lc, H, P], dt, a_cs [B, Nc, Lc, H] (a_cs the cumulative sum
    of -softplus(normal) * decay), Bm, Cm [B, Nc, Lc, N] from seed. Bytes:
    every operand read once, y written once; operations: 2 N for C B^T
    once per (batch, chunk) plus 2 P for W @ x per head, each times the
    Lc (Lc + 1) / 2 causal pairs (j <= i) of a chunk, so a masked-out
    pair is not billed. The library call is the two batched
    torch.matmul products alone, C B^T and W @ x (W precomputed, x in a
    head-major copy), without mask or exp."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_intra as KS

    B, Nc, Lc, H, P, N = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*sh):
        return torch.randn(sh, generator=gen, device="cuda")

    sp = lambda t: torch.logaddexp(t, torch.zeros_like(t))  # noqa: E731
    x = randn(B, Nc, Lc, H, P)
    dt = sp(randn(B, Nc, Lc, H))
    a_cs = torch.cumsum(-sp(randn(B, Nc, Lc, H)) * decay, dim=2)
    bm, cm = randn(B, Nc, Lc, N), randn(B, Nc, Lc, N)
    x, dt, a_cs, bm, cm = (t.to(dtype) for t in (x, dt, a_cs, bm, cm))
    es = x.element_size()
    w = randn(B, Nc, H, Lc, Lc).to(dtype)
    xh = x.permute(0, 1, 3, 2, 4).contiguous()
    bt = bm.transpose(-1, -2)
    chunks = B * Nc
    return (lambda: (KS.ssd_intra(x, dt, a_cs, bm, cm),),
            lambda: (ref.ssd_intra(x, dt, a_cs, bm, cm),),
            (2 * x.numel() + 2 * dt.numel() + 2 * bm.numel()) * es,
            chunks * Lc * (Lc + 1) * (N + H * P),
            lambda: (torch.matmul(cm, bt), torch.matmul(w, xh)))


def _dither_layout(name: str):
    """An arena layout from meta tensors, built once: ``fedlm-100m`` whole,
    ``granite-moe-l2`` the granite-moe benchmark cell's (2 of 32 layers,
    stacked, head tied: 276,959,232 coordinates, 270,469 rows), and
    ``ragged`` leaves of 1, 1,023, 1,024, 1,025 and 100,003 coordinates and
    a scalar, dicts in other than sorted key order (104 rows)."""
    from repro_torch.configs import get_config
    from repro_torch.core.arena import ArenaLayout
    from repro_torch.models import build_model

    if name not in _DITHER_LAYOUTS:
        if name == "ragged":
            def z(*shape):
                return torch.empty(shape, device="meta")

            tree = {"z": z(100_003), "m": [z(1), z(1023)],
                    "b": {"y": z(1024), "x": z(5, 205)}, "a": z()}
        else:
            cfg = get_config("fedlm-100m") if name == "fedlm-100m" else (
                dataclasses.replace(get_config("granite-moe-3b-a800m"),
                                    n_layers=2, tie_embeddings=True,
                                    scan_layers=True))
            tree = build_model(cfg).init(torch.Generator().manual_seed(0),
                                         device="meta")
        _DITHER_LAYOUTS[name] = ArenaLayout.for_tree(tree)
    return _DITHER_LAYOUTS[name]


_DITHER_LAYOUTS: dict = {}


def threefry_ops(n: int) -> int:
    """Operations on ``threefry_uniform_rows``' busiest pipe for ``n``
    coordinates (the ALU pipe: :data:`THREEFRY_ALU_OPS`)."""
    return max(THREEFRY_ALU_OPS, THREEFRY_IMAD_OPS) * n


def _case_threefry(shape, dtype, seed, layout="granite-moe-l2"):
    """The packed dither ``[planes, rows, 1024]`` of a layout (planes 1:
    the client-shared draw; more: the per-client one) through
    ``ops.arena_uniform``, kernel against its plain version
    (``ref.arena_uniform``, which ``_plain`` routes to), bit for bit; the
    bound is the write or the busiest integer pipe."""
    from repro_torch.core import prng
    from repro_torch.kernels import ops

    lo = _dither_layout(layout)
    planes, rows, lanes = shape
    check(lo.rows == rows, f"threefry case: {layout} has {lo.rows} rows")
    table, seg = lo.leaf_table("cuda"), lo.row_segments("cuda")
    key = prng.fold_in(prng.key(2 ** 40 + seed), 5)
    lead = None if planes == 1 else planes

    def draw(impl):
        return lambda: (ops.arena_uniform(key, table, seg, lead, dtype=dtype,
                                          impl=impl),)

    return (draw("kernel"), draw("ref"),
            planes * rows * lanes * dtype.itemsize,
            threefry_ops(planes * lo.num_params))


#: labels of the cases timed (their first float32 case); "main" is the
#: one the summary line reports.
TIMED = ("main", "gossip_arena", "one_client_gossip_arena", "qwen3_prefill",
         "zamba2_prefill", "granite_prefill", "gemma_prefill",
         "whisper_encoder", "llava_prefill")
#: cases timed beside the float32 ones, (form, label, dtype), reported
#: under "<label>_<dtype>" in also_timed
TIMED_OTHER = {("flash_attention", "main", torch.bfloat16),
               ("gossip_reduce", "main", torch.float64)}
#: (B, S, T, Hkv, G, D, kind, window, chunk) of the serve paths' prefills:
#: fedlm-100m at batch 4 and 2048 tokens, qwen3-1.7b at 8192 tokens.
FLASH_FEDLM = (4, 2048, 2048, 5, 2, 64, "causal", 0, 0)
FLASH_QWEN3 = (1, 8192, 8192, 8, 2, 128, "sliding", 4096, 0)
#: the other families' prefills (serve paths S4-S8): zamba2-1.2b's shared
#: block (8192 tokens, 32 KV heads, G 1), granite-moe at batch 4 (G 3),
#: gemma-2b (one KV head, G 8, D 256), whisper-small's encoder (batch 4,
#: 1500 frames, bidirectional) and llava-next-34b (2880 image + 1024 text
#: tokens, G 7).
FLASH_ZAMBA2 = (1, 8192, 8192, 32, 1, 64, "sliding", 4096, 0)
FLASH_GRANITE = (4, 2048, 2048, 8, 3, 64, "causal", 0, 0)
FLASH_GEMMA = (1, 8192, 8192, 1, 8, 256, "sliding", 4096, 0)
FLASH_WHISPER = (4, 1500, 1500, 12, 1, 64, "bidirectional", 0, 0)
FLASH_LLAVA = (1, 3904, 3904, 8, 7, 128, "causal", 0, 0)
#: (B, Nc, Lc, H, P, N) of mamba2-130m's prefill at batch 4, 2048 tokens.
SSD_MAMBA2 = (4, 16, 128, 24, 64, 128)
#: zamba2-1.2b's prefill at batch 1, 8192 tokens: 64 heads, N 64.
SSD_ZAMBA2 = (1, 64, 128, 64, 64, 64)
#: forms held to a tolerance instead of 0, by dtype: flash attention and
#: the SSD term sum their products in another order than the einsums. A
#: number is rtol = atol, a pair (rtol, atol). Flash in bfloat16: p is
#: rounded to bfloat16 against the running max of a 64-key tile where the
#: plain version's is of a 256-key tile, so a p may round to the other
#: neighbour (2^-9 of it): up to ~2e-3 absolute near a zero output (a CPU
#: emulation of that tiling at these shapes), and one bfloat16 unit
#: (2^-7 relative) in the output's own rounding.
TOLERANCE = {"flash_attention": {torch.float32: 2e-5,
                                 torch.bfloat16: (2e-2, 5e-3)},
             "ssd_intra": {torch.float32: 1e-4, torch.bfloat16: 1e-2}}
#: forms whose tolerance is a share of the output's scale (max |plain|);
#: the others' is rtol = atol, element by element.
SCALED = ("ssd_intra",)
#: launches and iterations of a timing (the plain flash version at the
#: qwen3 shape takes ~0.45 s a call, the plain dither at granite's layout
#: some 0.3 s).
TIMING = {"flash_attention": dict(iters=5, warmup=1),
          "threefry_uniform_rows": dict(iters=5, warmup=1)}


def _cases(form):
    """(label, shape, dtype, builder) cases of one kernel form."""
    f32, f64 = torch.float32, torch.float64
    if form == "threefry_uniform_rows":  # shape: (planes, rows, 1024)
        def ragged(sh, dt, i):
            return _case_threefry(sh, dt, i, layout="ragged")

        return [("main", (1, 270_469, 1024), f32, _case_threefry),
                ("per_client", (4, 270_469, 1024), f32, _case_threefry),
                ("main", (1, 270_469, 1024), f64, _case_threefry),
                ("ragged", (1, 104, 1024), f32, ragged),
                ("ragged", (3, 104, 1024), f64, ragged)]
    if form == "flash_attention":  # shape: (B, S, T, Hkv, G, D, mask...)
        bf16, f = torch.bfloat16, _case_flash
        return [("main", FLASH_FEDLM, f32, f),
                ("qwen3_prefill", FLASH_QWEN3, f32, f),
                ("zamba2_prefill", FLASH_ZAMBA2, f32, f),
                ("granite_prefill", FLASH_GRANITE, f32, f),
                ("gemma_prefill", FLASH_GEMMA, f32, f),
                ("whisper_encoder", FLASH_WHISPER, f32, f),
                ("llava_prefill", FLASH_LLAVA, f32, f),
                ("main", FLASH_FEDLM, bf16, f),
                ("s_1000", (1, 1000, 1000, 2, 2, 64, "causal", 0, 0), f32, f),
                ("window_5_s_2047", (1, 2047, 2047, 1, 1, 128, "sliding", 5,
                                     0), f32, f),
                ("window_5_s_2047", (1, 2047, 2047, 5, 2, 64, "sliding", 5,
                                     0), bf16, f),
                ("t_above_s", (1, 200, 333, 3, 2, 64, "causal", 0, 0), f32, f),
                ("t_below_s", (1, 333, 200, 1, 8, 128, "causal", 0, 0), f32,
                 f),
                ("chunked_7_g8", (2, 300, 300, 1, 8, 32, "chunked", 0, 7),
                 f32, f),
                ("chunked_64_d256", (1, 513, 513, 2, 2, 256, "chunked", 0,
                                     64), f32, f),
                ("bidirectional_d16", (2, 200, 333, 2, 2, 16,
                                       "bidirectional", 0, 0), f32, f),
                ("g8_d256", (1, 1000, 1000, 1, 8, 256, "causal", 0, 0), f32,
                 f),
                ("no_key_rows_chunked", (1, 520, 300, 2, 2, 64, "chunked", 0,
                                         64), f32, f),
                ("no_key_rows_sliding", (2, 200, 100, 1, 8, 32, "sliding",
                                         16, 0), f32, f)]
    if form == "ssd_intra":  # shape: (B, Nc, Lc, H, P, N)
        bf16, d = torch.bfloat16, _case_ssd
        sweep = [(1, 1, 8, 1, 4, 4), (2, 3, 16, 2, 8, 8),
                 (1, 2, 128, 3, 64, 32)]
        return ([("main", SSD_MAMBA2, f32, d), ("main", SSD_MAMBA2, bf16, d),
                 ("zamba2_prefill", SSD_ZAMBA2, f32, d)]
                + [(f"sweep_{i}", sh, dt, d) for i, sh in enumerate(sweep)
                   for dt in (f32, bf16)]
                + [("ragged_37", (2, 3, 37, 5, 24, 40), f32, d),
                   ("off_tiles", (2, 3, 45, 3, 20, 12), f32, d),
                   ("decay_1e3", (1, 2, 128, 2, 16, 16), f32,
                    lambda sh, dt, i: d(sh, dt, i, decay=11.0)),
                   ("p_128", (1, 2, 128, 3, 128, 64), f32, d),
                   ("uneven_head_groups", (4, 25, 16, 7, 8, 8), f32, d)])
    if form == "telemetry_sketch":
        k = _case_sketch

        def with_(**kw):
            return lambda sh, dt, i: k(sh, dt, i, **kw)

        return [("main", GOSSIP_SHAPE, f32, k), ("main", GOSSIP_SHAPE, f64, k),
                ("ragged", (8, 100_003), f32, k),
                ("ragged", (8, 100_003), f64, k),
                ("unaligned", (8, 4096), f32, with_(unaligned=True)),
                ("unaligned", (13, 4099), f64, with_(unaligned=True)),
                ("n_1", (1, 4096), f32, with_(zero_rows=())),
                ("n_1", (1, 1030), f64, with_(zero_rows=())),
                ("n_13", (13, 3 * 1024), f32, with_(zero_rows=(0, 5))),
                ("n_13", (13, 3 * 1024), f64, k),
                ("n_1024", (1024, 4096), f32,
                 with_(zero_rows=tuple(range(0, 1024, 7)))),
                ("n_1024", (1024, 1030), f64, k),
                ("all_zero", (8, 2048), f32, with_(zero_rows=range(8))),
                ("quadratic", (10, 1024), f64, k)]
    if form == "gossip_reduce":
        g = _case_gossip

        def with_(**kw):
            return lambda sh, dt, i: g(sh, dt, i, **kw)

        return [("main", GOSSIP_SHAPE, f32, with_(ring=True)),
                ("main", GOSSIP_SHAPE, f64, with_(ring=True)),
                ("ragged", (8, 100_003), f32, with_(ring=True)),
                ("ragged", (8, 100_003), f64, with_(ring=True)),
                ("unaligned", (8, 4096), f32, with_(ring=True,
                                                    unaligned=True)),
                ("unaligned", (10, 4099), f64, with_(slots=5,
                                                     unaligned=True)),
                ("slots_1", (10, 4096), f64, with_(slots=1)),
                ("slots_5", (10, 4096), f32, with_(slots=5)),
                ("slots_n", (10, 4096), f64, with_(slots=10)),
                ("one_node", (1, 4096), f32, with_(slots=1)),
                ("one_node", (1, 1030), f64, with_(slots=3)),
                ("n_1024", (1024, 4096), f32, with_(slots=3)),
                ("n_1024_slots_n", (1024, 256), f64, with_(slots=1024)),
                ("wide_table", (64, 520), f32, with_(slots=5000, rows=5000)),
                ("identity", (8, 4096), f32, with_(identity=True)),
                ("identity", (10, 1030), f64, with_(slots=5,
                                                    identity=True))]
    if form in ("fedcet_v", "fedcet_comm", "fedcet_comm4"):
        ragged = (100_003,) if form == "fedcet_v" else (4, 100_003)
        cases = [(lbl, sh, dt, lambda sh, dt, i: _case_fedcet(form, sh, dt, i))
                 for lbl, sh, dt in (("main", MAIN_SHAPE, f32),
                                     ("main", MAIN_SHAPE, f64),
                                     ("ragged", ragged, f32),
                                     ("ragged", ragged, f64),
                                     ("quadratic", (10, 60), f64))]
        if form == "fedcet_v":  # path E's 8-client arena, one launch
            cases += [("gossip_arena", GOSSIP_SHAPE, dt, cases[0][3])
                      for dt in (f32, f64)]
        if form == "fedcet_comm":  # path E's one-client form, m_bar [n, P]
            one = lambda sh, dt, i: _case_fedcet(form, sh, dt, i,  # noqa: E731
                                                 one_client=True)
            cases += [("one_client_gossip_arena", GOSSIP_SHAPE, f32, one),
                      ("one_client_gossip_arena", GOSSIP_SHAPE, f64, one),
                      ("one_client_ragged", (7, 100_003), f32, one),
                      ("one_client_ragged", (7, 100_003), f64, one),
                      ("one_client_quadratic", (10, 60), f64, one)]
        return cases
    if form == "stochastic_quantize":
        q = _case_quantize
        return [("main", MAIN_SHAPE, f32, q), ("main", MAIN_SHAPE, f64, q),
                ("ragged", (4, 100_003), f32, q),
                ("ragged", (3, 5, 517), f64, q),
                ("per_client_dither", (4, 100_003), f32,
                 lambda sh, dt, i: q(sh, dt, i, per_client=True)),
                ("zero_scale", (4, 1030), f64,
                 lambda sh, dt, i: q(sh, dt, i, zero=True))]
    if form == "stochastic_quantize_rows":
        r = _case_quantize_rows
        return [("main", ARENA_SHAPE, f32, r), ("main", ARENA_SHAPE, f64, r),
                ("ragged", (3, 97, 1030), f32, r),
                ("ragged", (1, 13, 7), f64, r)]
    t = _case_round_tail
    return [("main", ARENA_SHAPE, f32, t), ("main", ARENA_SHAPE, f64, t),
            ("masked", (4, 2048, 1024), f32,
             lambda sh, dt, i: t(sh, dt, i, mask=[True, False, True, True])),
            ("one_client", (1, 300, 1024), f64, t),
            ("ragged", (3, 97, 1030), f32,
             lambda sh, dt, i: t(sh, dt, i, mask=[False, True, True])),
            ("seven_clients", (7, 33, 1024), f64, t),
            ("ragged", (4, 5, 7), f64, t),
            ("no_client_present", (3, 9, 1024), f32,
             lambda sh, dt, i: t(sh, dt, i, mask=[False, False, False]))]


#: forms with a reduction across blocks, held to bitwise equal repeats.
REPEATED = ("telemetry_sketch",)
#: forms held to a tolerance whose repeat must still equal the first run
#: bit for bit (no atomics, and no race in their cp.async pipelines).
REPEATS_EXACTLY = ("ssd_intra", "flash_attention")


def _excess(got, want, tol, chunk=1 << 27) -> float:
    """Largest ``|got - want| - tol |want|`` over the pairs (<= atol is
    numpy's allclose with rtol = tol), in chunks."""
    return max(float(((x.double() - y.double()).abs()
                      - tol * y.double().abs()).max())
               for a, b in zip(got, want)
               for x, y in zip(a.reshape(-1).split(chunk),
                               b.reshape(-1).split(chunk)))


def phase_kernels():
    """Every kernel form against its plain version: bitwise (tolerance 0)
    for the forms built with --fmad=false and one fixed sum order, within
    TOLERANCE for flash attention and the SSD term."""
    from repro_torch.kernels import library as L

    results = {}
    for form in KERNELS:
        errs, timing = [], {}
        L.reset_launches()
        for i, (label, shape, dtype, build) in enumerate(_cases(form)):
            kern, plain, nbytes, flops, *rest = build(shape, dtype, i)
            library = rest[0] if rest else None
            extra = rest[1] if len(rest) > 1 else {}
            got = kern()
            want = plain()
            err = _max_err(got, want)
            tol = TOLERANCE.get(form, {}).get(dtype, 0.0)
            rtol, atol = tol if isinstance(tol, tuple) else (tol, tol)
            if form in SCALED:
                excess = err / max(float(t.abs().max()) for t in want)
            else:
                excess = _excess(got, want, rtol) if tol else err
            if form in REPEATED:
                err = max(err, _max_err(kern(), got))
                excess = err
            if form in REPEATS_EXACTLY:
                check(_bitwise(kern(), got), f"{form} {label} {shape} "
                                             f"{dtype}: a repeat differs")
            del got, want
            torch.cuda.synchronize()
            errs.append({"case": label, "shape": list(shape),
                         "dtype": str(dtype)[6:], "max_abs_err": err,
                         "tolerance": tol, **extra,
                         **({"err_of_scale": excess} if form in SCALED
                            else {"err_over_rtol": excess}
                            if isinstance(tol, tuple) else {})})
            check(excess <= atol, f"{form} {label} {shape} {dtype}: kernel "
                                 f"differs from its plain version (or from "
                                 f"its own repeat) by {err} (tolerance "
                                 f"{tol})")
            key = label if dtype == torch.float32 else (
                f"{label}_{str(dtype)[6:]}")
            if label in TIMED and key not in timing and (
                    dtype == torch.float32
                    or (form, label, dtype) in TIMED_OTHER):
                how = TIMING.get(form, {})
                p1, k1, k2, p2 = (time_ms(fn, **how)
                                  for fn in (plain, kern, kern, plain))
                b_ms, b_by = bound(nbytes, flops, dtype, form)
                lib_ms = lib_dev = None
                if library is not None:
                    lib_ms = (time_ms(library, **how)
                              + time_ms(library, **how)) / 2
                    lib_dev = device_ms(library, **how)
                timing[key] = {"shape": list(shape), "ms": (k1 + k2) / 2,
                               "device_ms": device_ms(kern, **how),
                               "plain_ms": (p1 + p2) / 2, "bound_ms": b_ms,
                               "bound_by": b_by, "bytes": nbytes,
                               "flops": flops, "library_ms": lib_ms,
                               "library_device_ms": lib_dev, **extra}
            del kern, plain, library
            torch.cuda.empty_cache()
        results[form] = {**timing.pop("main"), "also_timed": timing,
                         "checks": errs,
                         "tolerance": TOLERANCE.get(form, {
                             torch.float32: 0.0})[torch.float32],
                         "max_abs_err": max(c["max_abs_err"] for c in errs),
                         "check_launches": L.LAUNCHES[form]}
        emit({"phase": "kernels", "kernel": form, **results[form]})
    return results


def phase_quadratic():
    """The paper's problem in float64 through the kernels: uncompressed,
    and the compressed, sampled, arena-packed rounds of this slice."""
    from repro_torch.core import FedCET, max_weight_c
    from repro_torch.core.engine import (with_arena, with_compression,
                                         with_participation, with_telemetry)
    from repro_torch.core.lr_search import lr_search
    from repro_torch.core.telemetry import Telemetry
    from repro_torch.core.simulate import simulate_quadratic
    from repro_torch.data.quadratic import make_quadratic_problem
    from repro_torch.kernels import library as L

    problem = make_quadratic_problem(0, device="cuda")
    tau = 2
    alpha = lr_search(problem.mu, problem.L, tau)
    base = FedCET(alpha=alpha, c=max_weight_c(problem.mu, alpha), tau=tau,
                  n_clients=problem.n_clients)
    shift = lambda a: with_compression(a, compressor="shift:q8")  # noqa: E731
    sampled = with_participation(base, 0.8, seed=3)
    runs = {
        "plain": (base, 400),
        "shift_q8_arena_fused": (shift(with_arena(base)), 400),
        "shift_q8_per_leaf": (shift(base), 400),
        "sampled_0.8": (sampled, 800),
        "shift_q8_arena_sampled_0.8": (shift(with_arena(sampled)), 800),
        "arena": (with_arena(base), 400),
        "arena_sketches": (with_telemetry(with_arena(base),
                                          Telemetry(sketches="auto")), 400),
    }
    finals, launches, curves, series = {}, {}, {}, {}
    for name, (algo, rounds) in runs.items():
        L.reset_launches()
        t0 = time.perf_counter()
        res = simulate_quadratic(algo, problem, rounds, device="cuda")
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches[name] = {k: n for k, n in L.LAUNCHES.items() if n}
        finals[name], curves[name] = res.final_error, res.errors
        series[name] = res.telemetry
        emit({"phase": "quadratic", "run": name, "rounds": rounds,
              "dtype": "float64", "alpha": alpha, "c": base.c,
              "final_error": res.final_error, "seconds": seconds,
              "launches": launches[name]})
    plain = simulate_quadratic(
        dataclasses.replace(base, use_fused_kernel=False), problem, 400,
        device="cuda")
    diff = float((plain.errors - curves["plain"]).abs().max())
    emit({"phase": "quadratic", "run": "plain_path_without_kernels",
          "final_error": plain.final_error, "max_diff_vs_kernels": diff})
    tel = series["arena_sketches"]
    resid = float(tel["invariant_residual"].max())
    on_off = float((curves["arena_sketches"] - curves["arena"]).abs().max())
    hist_ok = all(bool((tel[f"{s}_hist"].sum(dim=1) == problem.n_clients)
                       .all()) for s in ("d_norm", "drift"))
    emit({"phase": "quadratic", "run": "arena_sketch_checks",
          "max_invariant_residual": resid, "on_vs_off_max_diff": on_off,
          "final_drift_hist": tel["drift_hist"][-1].tolist(),
          "final_d_norm_top_ids": tel["d_norm_top_ids"][-1].tolist()})
    check(resid <= 1e-6, f"arena sketches: invariant residual {resid}")
    check(on_off == 0.0, f"arena sketches: telemetry on differs from off "
                         f"by {on_off}")
    check(hist_ok, "arena sketches: a histogram does not count every client")
    check(launches["arena_sketches"].get("telemetry_sketch") == 2 * 400,
          f"arena sketches: launches {launches['arena_sketches']}")
    for name in ("plain", "shift_q8_arena_fused", "shift_q8_per_leaf",
                 "arena_sketches"):
        check(finals[name] < 1e-9,
              f"quadratic {name} did not reach the exact optimum: "
              f"{finals[name]}")
    check(diff <= 1e-12, f"kernel and plain FedCET paths differ by {diff}")
    check(finals["shift_q8_arena_sampled_0.8"] < 10 * finals["sampled_0.8"],
          f"shift:q8 x 0.8 sampling {finals['shift_q8_arena_sampled_0.8']} "
          f"not within 10x of uncompressed {finals['sampled_0.8']}")
    expect = {"plain": ("fedcet_v", "fedcet_comm"),
              "shift_q8_arena_fused": ("fedcet_v", "fedcet_round_tail"),
              "shift_q8_per_leaf": ("fedcet_v", "stochastic_quantize",
                                    "fedcet_comm4"),
              "shift_q8_arena_sampled_0.8": ("fedcet_v", "fedcet_round_tail")}
    for name, forms in expect.items():
        check(all(launches[name].get(f, 0) > 0 for f in forms),
              f"quadratic {name}: expected launches of {forms}, got "
              f"{launches[name]}")
    launches.update(_quadratic_topologies(problem, base))
    return launches


def _quadratic_topologies(problem, base):
    """The reference's own topology checks (``tests/test_topology.py``) on
    the card, in float64: NIDS over the sparse gossip graphs (max-client
    error, since the mean error is blind to the graph), FedCET over
    ``ring:sparse`` (exact, drift mean zero) and ``hier:g5``, and the
    resampled graph's sparse and dense lowerings round by round."""
    from repro_torch.core.baselines import NIDS
    from repro_torch.core.engine import with_topology
    from repro_torch.core.simulate import simulate_quadratic
    from repro_torch.kernels import library as L

    nids = NIDS(alpha=1.0 / problem.L, n_clients=problem.n_clients)
    runs = {f"nids_{spec}": (with_topology(nids, spec), 2000)
            for spec in ("ring:sparse", "torus:sparse", "er:0.5:sparse")}
    runs["fedcet_ring:sparse"] = (with_topology(base, "ring:sparse"), 1200)
    runs["fedcet_hier:g5"] = (with_topology(base, "hier:g5"), 800)
    runs["fedcet_er:0.5:t:sparse"] = (with_topology(base, "er:0.5:t:sparse",
                                                    seed=11), 50)
    runs["fedcet_er:0.5:t"] = (with_topology(base, "er:0.5:t", seed=11), 50)
    launches, res = {}, {}
    for name, (algo, rounds) in runs.items():
        L.reset_launches()
        t0 = time.perf_counter()
        res[name] = simulate_quadratic(algo, problem, rounds, device="cuda")
        x = algo.client_params(res[name].state)
        max_client = float(torch.linalg.norm(x - problem.x_star, dim=1).max())
        torch.cuda.synchronize()
        launches[name] = {k: n for k, n in L.LAUNCHES.items() if n}
        emit({"phase": "quadratic", "run": name, "rounds": rounds,
              "dtype": "float64", "final_error": res[name].final_error,
              "max_client_error": max_client,
              "seconds": time.perf_counter() - t0,
              "launches": launches[name]})
        if name.startswith("nids"):
            check(max_client < 1e-9, f"quadratic {name}: max-client error "
                                     f"{max_client}")
        if name in ("fedcet_ring:sparse", "fedcet_hier:g5"):
            check(res[name].final_error < 1e-9,
                  f"quadratic {name}: {res[name].final_error}")
        sparse = name.endswith("sparse")
        check((launches[name].get("gossip_reduce", 0) > 0) == sparse,
              f"quadratic {name}: gossip_reduce launches {launches[name]}")
    d_mean = float(res["fedcet_ring:sparse"].state.d.mean(0).abs().max())
    diff = float((res["fedcet_er:0.5:t:sparse"].errors
                  - res["fedcet_er:0.5:t"].errors).abs().max())
    emit({"phase": "quadratic", "run": "topology_checks",
          "ring_sparse_max_abs_mean_d": d_mean,
          "er_t_sparse_vs_dense_max_diff": diff})
    check(d_mean <= 1e-10, f"ring:sparse |mean_i d_i| = {d_mean}")
    check(diff <= 1e-12, f"er:0.5:t sparse vs dense differ by {diff}")
    return launches


#: ``benchmarks/staleness_sweep.py``'s checks on the card (float64, the
#: paper's problem drawn on the card, 1500 rounds, the script's bounds):
#: (algorithm, delay, policy) -> ("<" or ">", bound on the final error).
STALENESS_CELLS = {
    ("fedcet", "rr:2", "drop"): ("<", 1e-9),
    ("fedcet", "rr:2", "last"): ("<", 1e-9),
    ("fedcet", "fixed:2", "poly:1"): ("<", 1e-9),
    ("fedcet", "rr:2", "poly:1"): (">", 1e-4),
    ("scaffold", "rr:2", "last"): (">", 1e-1),
    ("scaffold", "rr:2", "drop"): ("<", 1e-2),
}
STALENESS_ROUNDS = 1500


def phase_staleness():
    """FedCET and SCAFFOLD under delayed uplinks on the card in float64:
    FedCET exact under ``drop`` and ``last`` at rr:2 and under ``poly:1``
    at fixed:2 (uniform ages), floored by ``poly:1`` at rr:2; SCAFFOLD's
    delta pair broken by ``last`` and convergent under ``drop``."""
    from repro_torch.core import FedCET, Scaffold, max_weight_c
    from repro_torch.core.engine import with_delay
    from repro_torch.core.lr_search import lr_search
    from repro_torch.core.simulate import simulate_quadratic
    from repro_torch.data.quadratic import make_quadratic_problem
    from repro_torch.kernels import library as L

    problem = make_quadratic_problem(0, device="cuda")
    tau = 2
    alpha = lr_search(problem.mu, problem.L, tau)
    algos = {"fedcet": FedCET(alpha=alpha, c=max_weight_c(problem.mu, alpha),
                              tau=tau, n_clients=problem.n_clients),
             "scaffold": Scaffold(alpha_l=1.0 / (81 * tau * problem.L),
                                  tau=tau, n_clients=problem.n_clients)}
    for (name, delay, pol), (op, bound) in STALENESS_CELLS.items():
        L.reset_launches()
        t0 = time.perf_counter()
        res = simulate_quadratic(with_delay(algos[name], delay, policy=pol),
                                 problem, STALENESS_ROUNDS, device="cuda")
        err = res.final_error
        emit({"phase": "staleness", "algo": name, "delay": delay,
              "policy": pol, "rounds": STALENESS_ROUNDS, "final_error": err,
              "bound": f"{op} {bound}", "seconds": time.perf_counter() - t0,
              "launches": {k: v for k, v in L.LAUNCHES.items() if v}})
        check(err < bound if op == "<" else err > bound,
              f"staleness {name} {delay} {pol}: final error {err}, "
              f"bound {op} {bound}")


#: ``benchmarks/cohort_scaling.py`` on the card: cohort 256, ``block``,
#: dim 8, tau 2, one measurement a client.
COHORT_SIZE, COHORT_DIM = 256, 8
COHORT_NS_GATHER = (1_000, 10_000, 100_000, 1_000_000)
COHORT_NS_DENSE = (1_000, 10_000, 100_000)
COHORT_GROWTH_MAX = 1.5   # gather round time, N 1e4 -> 1e6


def _cohort_algos(n):
    from repro_torch.core import FedAvg, FedCET, FedTrack, Scaffold

    return {"fedcet": FedCET(alpha=0.02, c=0.3, tau=2, n_clients=n),
            "fedavg": FedAvg(alpha=0.05, tau=2, n_clients=n),
            "scaffold": Scaffold(alpha_l=0.02, tau=2, n_clients=n),
            "fedtrack": FedTrack(alpha=0.02, tau=2, n_clients=n)}


def _round_ms(algo, problem, rounds=10, batches_n=3):
    """Best of ``batches_n`` batches of ``rounds`` rounds, ms a round
    (host clock, synchronized), after two warm-up rounds."""
    grad = torch.func.grad(problem.client_loss)
    batches = problem.stacked_batches(2)
    state = algo.init(grad, torch.zeros(problem.dim, dtype=torch.float64,
                                        device="cuda"),
                      {k: v[0] for k, v in batches.items()})
    for _ in range(2):
        state = algo.round(grad, state, batches)
    best = math.inf
    for _ in range(batches_n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(rounds):
            state = algo.round(grad, state, batches)
        torch.cuda.synchronize()
        best = min(best, 1e3 * (time.perf_counter() - t0) / rounds)
    return best


def phase_cohort():
    """The cohort lowerings and their scaling on the card in float64:
    gather and dense agree within 1e-12 after 4 rounds for FedCET,
    FedAvg, SCAFFOLD and FedTrack at N 1000; the gather round's time at
    N 1e3..1e6 (its growth from 1e4 to 1e6 at most 1.5x) and the dense
    round's at N 1e3..1e5 (printed only)."""
    from repro_torch.core.engine import CohortSpec, run_rounds, with_cohort
    from repro_torch.data.quadratic import make_quadratic_problem
    from repro_torch.utils.tree import tree_leaves

    def problem(n):
        return make_quadratic_problem(0, n_clients=n, n_measurements=1,
                                      dim=COHORT_DIM, device="cuda")

    def spec(lowering):
        return CohortSpec(size=COHORT_SIZE, selector="block",
                          lowering=lowering)

    prob = problem(1_000)
    grad = torch.func.grad(prob.client_loss)
    batches = prob.stacked_batches(2)
    gaps = {}
    for name, algo in _cohort_algos(1_000).items():
        finals = []
        for lowering in ("gather", "dense"):
            a = with_cohort(algo, spec(lowering))
            s = a.init(grad, torch.zeros(COHORT_DIM, dtype=torch.float64,
                                         device="cuda"),
                       {k: v[0] for k, v in batches.items()})
            finals.append(run_rounds(a, grad, s, batches, rounds=4)[0])
        gaps[name] = max(float((x - y).abs().max()) for x, y in zip(
            *(tree_leaves(f) for f in finals)) if isinstance(x, torch.Tensor))
    emit({"phase": "cohort", "check": "lowerings", "n": 1_000,
          "cohort": COHORT_SIZE, "rounds": 4, "max_abs_gap": gaps})
    check(all(g <= 1e-12 for g in gaps.values()),
          f"cohort lowerings differ: {gaps}")
    times = {}
    for n in COHORT_NS_GATHER:
        times[f"gather/n{n}"] = _round_ms(
            with_cohort(_cohort_algos(n)["fedcet"], spec("gather")),
            problem(n))
    for n in COHORT_NS_DENSE:
        times[f"dense/n{n}"] = _round_ms(_cohort_algos(n)["fedcet"],
                                         problem(n))
    growth = times["gather/n1000000"] / times["gather/n10000"]
    emit({"phase": "cohort", "check": "scaling", "ms_per_round": times,
          "gather_growth_1e4_to_1e6": growth,
          "dense_growth_1e4_to_1e5": (times["dense/n100000"]
                                      / times["dense/n10000"])})
    check(growth <= COHORT_GROWTH_MAX,
          f"gather round time grew {growth}x from N 1e4 to 1e6")


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


def phase_prng():
    """The arena's client-shared float32 dither as a compressed round draws
    it (``StochasticQuant.arena_dither``) at fedlm-100m's and the granite
    cell's layouts (``_dither_layout``):
    the packed kernel (``threefry_uniform_rows``, one launch) beside the
    eager per-leaf draw it replaced (``prng.uniform`` under each leaf's
    ``fold_in``, then ``arena.pack_rows``), both timed with CUDA events and
    held bitwise equal, with the bound of writing the arena and that of
    the threefry's busiest integer pipe."""
    from torch.utils import _pytree as pytree

    from repro_torch.core import prng
    from repro_torch.core.arena import LANES, pack_rows
    from repro_torch.core.comm import reference_leaf_index
    from repro_torch.core.compressors import StochasticQuant
    from repro_torch.kernels import library as L

    key = prng.fold_in(prng.key(0), 5)
    quant = StochasticQuant(8)
    for name in ("fedlm-100m", "granite-moe-l2"):
        layout = _dither_layout(name)
        index = reference_leaf_index(pytree.tree_unflatten(
            [0] * len(layout.shapes), layout.treedef))

        def eager(layout=layout, index=index):
            return pack_rows([prng.uniform(prng.fold_in(key, i), s,
                                           torch.float32, device="cuda")
                              for i, s in zip(index, layout.shapes)], layout)

        def kernel(layout=layout):
            return quant.arena_dither(key, layout, 4, "cuda")

        before = L.LAUNCHES["threefry_uniform_rows"]
        equal = torch.equal(kernel(), eager())
        launches = L.LAUNCHES["threefry_uniform_rows"] - before
        ms, eager_ms = time_ms(kernel), time_ms(eager, iters=3, warmup=1)
        n = layout.num_params
        emit({"phase": "prng", "layout": name,
              "what": "arena dither, float32, client-shared",
              "leaves": len(layout.shapes), "elements": n,
              "rows": layout.rows, "ms": ms, "eager_ms": eager_ms,
              "bitwise_equal": equal, "launches_per_draw": launches,
              "write_bound_ms": 1e3 * 4 * layout.rows * LANES
              / HBM_BYTES_PER_S,
              "int_pipe_bound_ms": 1e3 * threefry_ops(n)
              / INT_PIPE_OPS_PER_S})
        check(equal, f"prng {name}: the packed dither is not the eager one")
        check(launches == 1, f"prng {name}: {launches} launches a draw")
    torch.cuda.empty_cache()


#: the ``split_ms`` keys of a train line: each the summed self time of the
#: program's spans of that name (``repro_torch/utils/spans.py``), so they
#: and ``other`` partition the round, its loss and its telemetry
SPLIT_KEYS = ("grad", "fedcet_v", "fedcet_comm", "quantize", "round_tail",
              "dither", "scale", "pack", "topology", "gossip", "loss",
              "telemetry", "sketch", "gather", "scatter")
#: the round's structural spans: their self time is ``other_ms``, the time
#: no keyed span covers (masks, the in-round telemetry captures, glue)
SPLIT_OTHER = ("round", "local", "comm", "transmit")


def _split_ms(recording):
    """One round's ``split_ms`` from the span recorder's ``drain()``: every
    span drained, whatever its round index (round 0's holds the warm-up)."""
    from repro_torch.utils import spans

    split = {k + "_ms": 0.0 for k in SPLIT_KEYS + ("other",)}
    for s, ms in zip(recording.spans, spans.self_ms(recording.spans)):
        key = "other" if s.name in SPLIT_OTHER else s.name
        split[key + "_ms"] = split.get(key + "_ms", 0.0) + ms
    return split


def _counts(recording) -> dict:
    """The recorder's round counters, summed: new ``cudaMalloc`` segments
    and allocations that freed the cache and tried again."""
    return {k: sum(recording.counts.get(k, {}).values())
            for k in ("mallocs", "alloc_retries")}


#: train paths: scenario options, the kernel forms each must launch, and
#: the run's size (B and E, the main paths of slices 2 and 3, must launch
#: exactly these counts: init + 5 rounds).
PATHS = {
    "A_dense": ({}, ("fedcet_v", "fedcet_comm"), TRAIN),
    "B_shift_q8_arena": ({"compression": "shift:q8", "arena": True},
                         ("fedcet_v", "fedcet_round_tail"), TRAIN),
    "C_shift_q8_per_leaf_p0.75": ({"compression": "shift:q8",
                                   "participation": 0.75},
                                  ("fedcet_v", "stochastic_quantize",
                                   "fedcet_comm4"), TRAIN),
    "D_q8_arena": ({"compression": "q8", "arena": True},
                   ("fedcet_v", "stochastic_quantize_rows", "fedcet_comm4"),
                   TRAIN),
    "E_ring_sparse_arena": ({"topology": "ring:sparse", "arena": True},
                            ("fedcet_v", "fedcet_comm", "gossip_reduce"),
                            TRAIN_TOPO),
    "F_ring_dense_arena": ({"topology": "ring", "arena": True},
                           ("fedcet_v", "fedcet_comm"), TRAIN_TOPO),
    "G_hier_g4_arena": ({"topology": "hier:g4", "arena": True},
                        ("fedcet_v", "fedcet_comm"), TRAIN_TOPO),
}
SMOKE_DIR = ROOT / "build" / "smoke"   # git-ignored; H's JSONL and trace
TELEMETRY_PATH = "H_ring_sparse_arena_telemetry"
PATHS["E2_ring_sparse_arena_repeat"] = PATHS["E_ring_sparse_arena"]
PATHS[TELEMETRY_PATH] = (
    {"topology": "ring:sparse", "arena": True,
     "telemetry": f"jsonl:{SMOKE_DIR / 'h.jsonl'},hist:48",
     "trace_rounds": "3:4", "trace_dir": str(SMOKE_DIR / "trace")},
    ("fedcet_v", "fedcet_comm", "gossip_reduce", "telemetry_sketch"),
    TRAIN_TOPO)
#: paths whose final x and d are compared (kept on the host).
#: path P: fedlm-100m under a per-leaf plan, ``CompressionPlan().allocate``
#: at uniform ``shift:q8``'s exact bits on the run's own parameters
#: (``absmax``, ``shift``), on the arena. A plan is not
#: ``Shifted(StochasticQuant)``, so no fused round tail: the per-leaf
#: quantize kernel, once per quantized leaf per aggregation.
PLAN_PATH = "P_plan_arena"
PATHS[PLAN_PATH] = ({"arena": True},
                    ("fedcet_v", "stochastic_quantize", "fedcet_comm4"),
                    TRAIN)
#: path L: B's scenario under round-robin stragglers (``rr:2``: 2 of the 4
#: clients miss each round) with the ``last`` stale policy. A delayed round
#: never takes the fused tail: per aggregation (init included) the rows
#: quantizer and the 4-op pair on the buffer's weighted mean.
DELAY_PATH = "L_shift_q8_arena_rr2_last"
PATHS[DELAY_PATH] = ({"compression": "shift:q8", "arena": True,
                      "delay": "rr:2", "stale_policy": "last"},
                     ("fedcet_v", "stochastic_quantize_rows",
                      "fedcet_comm4"), TRAIN)
#: path M: B's scenario on mamba2-130m at full width (24 Mamba2 blocks):
#: FedCET training of the ssm family on the card. The gradients take the
#: plain SSD (the kernel has no backward), so no ssd_intra launch.
MAMBA_PATH = "M_mamba2_130m_shift_q8_arena"
PATHS[MAMBA_PATH] = ({"compression": "shift:q8", "arena": True},
                     ("fedcet_v", "fedcet_round_tail"),
                     dict(TRAIN, arch="mamba2-130m"))
COMPARED = ("E_ring_sparse_arena", "F_ring_dense_arena",
            "E2_ring_sparse_arena_repeat", TELEMETRY_PATH)
_E_LAUNCHES = {"fedcet_v": 11, "fedcet_comm": 6, "gossip_reduce": 6}
#: each aggregation over the arena draws its dither in one packed launch
MAIN_PATH_LAUNCHES = {"B_shift_q8_arena": {"fedcet_v": 11,
                                           "fedcet_round_tail": 6,
                                           "threefry_uniform_rows": 6},
                      "E_ring_sparse_arena": _E_LAUNCHES,
                      "E2_ring_sparse_arena_repeat": _E_LAUNCHES,
                      # 5 rounds x (the d_norm and drift sketches).
                      TELEMETRY_PATH: {**_E_LAUNCHES,
                                       "telemetry_sketch": 10},
                      DELAY_PATH: {"fedcet_v": 11,
                                   "stochastic_quantize_rows": 6,
                                   "threefry_uniform_rows": 6,
                                   "fedcet_comm4": 6},
                      MAMBA_PATH: {"fedcet_v": 11, "fedcet_round_tail": 6,
                                   "threefry_uniform_rows": 6}}


def _allocated_plan(params, **allocate_kw):
    """A plan at uniform ``shift:q8``'s exact per-leaf bits on ``params``,
    allocated by ``absmax`` with shift wrappers (``allocate_kw`` passes the
    width limits on); returns ``(plan, budget bits, plan bits, leaf
    info)``."""
    from repro_torch.core import FedCET
    from repro_torch.core.comm import leaf_info_of, message_leaf_bits_of
    from repro_torch.core.compressors import CompressionPlan
    from repro_torch.core.engine import with_compression

    info = leaf_info_of(params)
    uniform = with_compression(
        FedCET(alpha=ALPHA, c=C, tau=TRAIN["tau"],
               n_clients=TRAIN["n_clients"]), compressor="shift:q8")
    budget = sum(message_leaf_bits_of(uniform, info))
    plan = CompressionPlan().allocate(budget, leaves=params,
                                      sensitivity="absmax", wrap="shift",
                                      **allocate_kw)
    return plan, budget, sum(plan.tree_wire_bits(info)), info


def _plan_scenario():
    """Path P's scenario: the plan allocated on the very parameters
    ``run_training`` draws (fedlm-100m, seed 0, on the card), and the exact
    launches it implies (init + 5 aggregations, one quantize launch per
    quantized leaf in each)."""
    from repro_torch.configs import get_config
    from repro_torch.core.compressors import StochasticQuant
    from repro_torch.models import build_model

    params = build_model(get_config("fedlm-100m")).init(
        torch.Generator(device="cuda").manual_seed(0), device="cuda")
    plan, budget, bits, info = _allocated_plan(params)
    del params
    torch.cuda.empty_cache()
    quantized = sum(isinstance(getattr(plan.resolve(i, nm), "inner", None),
                               StochasticQuant)
                    for i, (nm, _) in enumerate(info))
    steps = TRAIN["steps"] + 1
    MAIN_PATH_LAUNCHES[PLAN_PATH] = {"fedcet_v": 2 * TRAIN["steps"] + 1,
                                     "fedcet_comm4": steps,
                                     "stochastic_quantize": steps * quantized}
    emit({"phase": "train", "path": PLAN_PATH, "check": "plan",
          "budget_bits": budget, "plan_bits": bits, "leaves": len(info),
          "quantized_leaves": quantized,
          "rules": [[p, c.inner.bits] for p, c in plan.rules]})
    check(bits <= budget, f"P: the plan spends {bits} > {budget} bits")
    return {"compression_plan": plan}


def _train_path(name, scenario, expected, config):
    from repro_torch.kernels import library as L
    from repro_torch.launch.train import run_training
    from repro_torch.utils import spans
    from repro_torch.utils.tree import tree_leaves

    config = dict(config)
    arch = config.pop("arch", "fedlm-100m")
    invariants, final, rounds, counts = [], {}, [], []

    def on_round(r, loss, comm, state):
        rec = spans.drain()
        rounds.append(_split_ms(rec))
        counts.append(_counts(rec))
        inner = state.inner if hasattr(state, "extras") else state
        if r == config["steps"] - 1 and name in COMPARED:
            final["x"] = [t.cpu() for t in tree_leaves(inner.x)]
            final["d"] = [t.cpu() for t in tree_leaves(inner.d)]
        norm = lambda ts: math.sqrt(sum(float(t.double().pow(2).sum())  # noqa: E731
                                        for t in ts))
        # arena data or per-leaf tensors: pads are 0, so the norms agree.
        d = tree_leaves(inner.d)
        resid = norm(t.double().sum(0) for t in d)
        # d_i = c (m_i - mean m) accumulates float32 rounding, so the
        # residual is measured against c ||x||; against ||d|| (small while
        # the clients are still close) it reads ~1e-4 in the reference too.
        invariants.append({"sum_d_over_c_x": resid / (C * norm(
            tree_leaves(inner.x))), "sum_d_over_d": resid / norm(d)})
        check(math.isfinite(loss), f"{name} round {r}: loss {loss}")
        check(invariants[-1]["sum_d_over_c_x"] <= INVARIANT_MAX,
              f"{name} round {r}: Lemma 2 residual {invariants[-1]}")

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    L.reset_launches()
    spans.enable()
    try:
        hist = run_training(arch, reduced=False, device="cuda",
                            log_every=1, callback=on_round, **config,
                            **scenario)
    finally:
        spans.disable()
        spans.drain()
    launches = dict(L.LAUNCHES)
    for i, r in enumerate(hist["round"]):
        emit({"phase": "train", "path": name, "round": r,
              "loss": hist["loss"][i], "round_s": hist["seconds"][i],
              "invariant": invariants[i], "split_ms": rounds[i],
              **counts[i],
              "note": "round 0 also holds the warm-up" if r == 0 else ""})
    emit({"phase": "train", "path": name, "scenario": scenario,
          "arch": arch, "reduced": False,
          "n_params": hist["n_params"], **config,
          "rounds": len(hist["round"]),
          "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
          "launches": launches})
    check(len(hist["loss"]) == config["steps"], f"{name}: not 5 rounds")
    check(all(launches[f] > 0 for f in expected),
          f"{name}: a kernel of the path never launched: {launches}")
    final["comm_bytes"] = hist["comm_bytes"]
    MEASURED[name] = {"arch": arch, "config": config,
                      "round_s": hist["seconds"]}
    return launches, hist["loss"], final, rounds


def _state_gap(got, want):
    """``||got - want|| / ||want||`` over the leaves, in float64, on the
    card (the leaves may wait on the host)."""
    sq = lambda ts: sum(float(t.cuda().double().pow(2).sum())  # noqa: E731
                        for t in ts)
    return math.sqrt(sq(a.cuda() - b.cuda() for a, b in zip(got, want))
                     / sq(want))


def _bitwise(got, want) -> bool:
    return all(torch.equal(a, b) for a, b in zip(got, want))


def _read_trace(path):
    """Top device kernels by time and the device idle share of a Chrome
    trace: device activity (kernels, copies, fills) as a union of
    intervals, over the profiled window (first to last event, host or
    device) and over the device's own span (first to last device
    event). The profiler's host-side recording lengthens the window."""
    events = [e for e in json.load(open(path))["traceEvents"]
              if e.get("ph") == "X" and "dur" in e]
    device = sorted((e for e in events
                     if e.get("cat") in ("kernel", "gpu_memcpy",
                                         "gpu_memset")),
                    key=lambda e: e["ts"])
    t0 = min(e["ts"] for e in events)
    t1 = max(e["ts"] + e["dur"] for e in events)
    busy, end = 0.0, t0
    for e in device:
        lo, hi = max(e["ts"], end), e["ts"] + e["dur"]
        if hi > lo:
            busy += hi - lo
            end = hi
    by_name: dict = {}
    for e in device:
        if e.get("cat") == "kernel":
            by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"]
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    out = {"window_ms": (t1 - t0) / 1e3, "device_busy_ms": busy / 1e3,
           "device_kernel_launches": sum(e.get("cat") == "kernel"
                                         for e in device),
           "top_kernels_ms": [[n[:120], d / 1e3] for n, d in top]}
    if device:
        span = end - device[0]["ts"]
        out.update(device_idle_share=1.0 - busy / (t1 - t0),
                   device_span_ms=span / 1e3,
                   device_idle_share_in_span=1.0 - busy / span)
    return out


def _check_telemetry_path(rounds):
    """H's JSONL (manifest, 5 round events with full histograms and a
    finite consensus error), its report and its profiler trace."""
    jsonl = SMOKE_DIR / "h.jsonl"
    events = [json.loads(line) for line in open(jsonl)]
    check(events[0]["event"] == "manifest", "H: the JSONL has no manifest")
    evs = [e for e in events if e["event"] == "round"]
    check([e["round"] for e in evs] == list(range(TRAIN_TOPO["steps"])),
          f"H: round events {[e['round'] for e in evs]}")
    for e in evs:
        check(sum(e["d_norm_hist"]) == sum(e["drift_hist"])
              == TRAIN_TOPO["n_clients"], f"H round {e['round']}: histograms "
                                          f"{e['d_norm_hist']}, "
                                          f"{e['drift_hist']}")
        check(math.isfinite(e["consensus_err"]) and e["consensus_err"] > 0,
              f"H round {e['round']}: consensus_err {e['consensus_err']}")
    report = subprocess.run(
        [sys.executable, str(ROOT / "benchmarks" / "report.py"), str(jsonl),
         "-o", str(SMOKE_DIR / "h_report.html")], capture_output=True,
        text=True, timeout=300)
    check(report.returncode == 0, f"H: report.py failed: {report.stderr}")
    trace = SMOKE_DIR / "trace" / "rounds_3-4.trace.json"
    check(trace.exists(), f"H: no profiler trace at {trace}")
    emit({"phase": "train", "path": TELEMETRY_PATH, "check": "telemetry",
          "round_events": len(evs),
          "warnings": sum(e["event"] == "monitor" for e in events),
          "per_round": [{k: e[k] for k in ("round", "invariant_residual",
                                            "consensus_err", "d_norm_p50",
                                            "drift_max", "drift_top_ids")}
                        for e in evs],
          "telemetry_ms": [r["telemetry_ms"] for r in rounds],
          "sketch_ms": [r["sketch_ms"] for r in rounds],
          "trace": {"file": str(trace.relative_to(ROOT)),
                    "bytes": trace.stat().st_size, **_read_trace(trace)}})


def phase_train():
    # The loss barely sees the mixing (m_bar reaches x only through
    # c*alpha*(v - m_bar)); the drift d = sum_rounds c*(m - W m) carries it
    # at full scale: a reduce that returned m unmixed leaves d = 0, a wrong
    # table moves it by O(1). So E's final d is held against F's.
    shutil.rmtree(SMOKE_DIR, ignore_errors=True)
    launches, losses, finals, rounds, comm = {}, {}, {}, {}, {}
    for name, (scenario, expected, config) in PATHS.items():
        if name == PLAN_PATH:
            scenario = {**scenario, **_plan_scenario()}
        launches[name], losses[name], fin, rounds[name] = _train_path(
            name, scenario, expected, config)
        if name in COMPARED:  # on the host: the next path's peak stays its
            finals[name] = fin
        comm[name] = fin["comm_bytes"]
        del fin
        torch.cuda.empty_cache()
    e, e2, h = (finals[p] for p in ("E_ring_sparse_arena",
                                    "E2_ring_sparse_arena_repeat",
                                    TELEMETRY_PATH))
    d_gap = _state_gap(e["d"], finals["F_ring_dense_arena"]["d"])
    repeat = {k: _bitwise(e2[k], e[k]) for k in ("x", "d")}
    same = {k: _bitwise(h[k], e[k]) for k in ("x", "d")}
    gaps = {f"{k}_{who}": _state_gap(o[k], e[k]) for k in ("x", "d")
            for who, o in (("E2", e2), ("H", h))}
    split = lambda p: [r["other_ms"] + r["telemetry_ms"]  # noqa: E731
                       for r in rounds[p]]
    emit({"phase": "train", "check": "H_vs_E", "E2_bitwise_equal_E": repeat,
          "H_bitwise_equal_E": same, "relative_gaps": gaps,
          "H_loss_equal_E": losses[TELEMETRY_PATH]
          == losses["E_ring_sparse_arena"],
          "E_other_plus_telemetry_ms": split("E_ring_sparse_arena"),
          "H_other_plus_telemetry_ms": split(TELEMETRY_PATH)})
    for k in ("x", "d"):
        if repeat[k]:
            check(same[k], f"H's final {k} differs from E's, though E "
                           f"repeats bit for bit (gap {gaps[k + '_H']})")
        else:
            check(gaps[k + "_H"] <= gaps[k + "_E2"],
                  f"H's final {k} gap {gaps[k + '_H']} exceeds E's own "
                  f"run-to-run gap {gaps[k + '_E2']}")
    _check_telemetry_path(rounds[TELEMETRY_PATH])
    for name, counts in MAIN_PATH_LAUNCHES.items():
        want = {f: counts.get(f, 0) for f in launches[name]}
        check(launches[name] == want,
              f"{name} launches {launches[name]}, expected {want}")
    check(launches["F_ring_dense_arena"]["gossip_reduce"] == 0,
          "the dense lowering launched the gossip reduce")
    check(all(n["telemetry_sketch"] == 0 for p, n in launches.items()
              if p != TELEMETRY_PATH),
          "a path without telemetry launched the sketch kernel")
    rel = max(abs(a - b) / abs(b) for a, b in
              zip(losses["F_ring_dense_arena"], losses["E_ring_sparse_arena"]))
    emit({"phase": "train", "check": "F_vs_E",
          "loss_max_relative_difference": rel,
          "final_d_relative_difference": d_gap, "d_tolerance": D_GAP_MAX})
    check(rel <= 1e-4, f"dense and sparse ring losses differ by {rel}")
    check(d_gap <= D_GAP_MAX, f"dense and sparse ring final drift differ by "
                              f"{d_gap} (relative)")
    _check_delay_bits(comm)
    _check_mamba_pallas_forward()
    _check_remat()
    launches[COHORT_PATH] = _cohort_path()
    for name, spec in FAMILY_PATHS.items():
        launches[name] = _family_path(name, spec)
    return launches


def _check_mamba_pallas_forward():
    """Path M's model with ``use_pallas_ssd``: one forward at the training
    shape (batch 8, seq 128, ``run_training``'s seed-0 weights), every
    block's SSD term through the kernel, against the plain forward."""
    from repro_torch.configs import get_config
    from repro_torch.launch import input_specs
    from repro_torch.models import build_model

    cfg = get_config("mamba2-130m")
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        device="cuda")
    batch = input_specs.make_batch(cfg, TRAIN["batch"], TRAIN["seq_len"],
                                   key=1, device="cuda")
    with torch.no_grad():
        full = model.forward(params, batch)
    emit({"phase": "train", "check": f"{MAMBA_PATH}_use_pallas_ssd_forward",
          "tolerance": PALLAS_SSD_TOL,
          **_pallas_ssd_forward(cfg, params, batch, full)})
    del model, params, full
    torch.cuda.empty_cache()


#: the remat check's models: fedlm-100m (``remat=False``: only the chunked
#: cross entropy is rematerialized, always, as in the reference; "off" is
#: ``models/remat.py:checkpoint`` replaced by the identity, the parent's
#: unwrapped loop) and mamba2-130m (``remat=True``: every stacked block).
REMAT_ARCHS = ("fedlm-100m", "mamba2-130m")


def _check_remat():
    """One local step's ``vmap(grad)`` at a train path's shape (4 clients x
    8 x 128, seed-0 weights, float32, TF32 off) with the rematerialized
    bodies and without: the gradients bit for bit (the recompute runs the
    same kernels on the same inputs), with the peak memory and time of
    each and the time of one forward (the recompute's cost)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import input_specs
    from repro_torch.models import build_model, remat
    from repro_torch.utils.tree import tree_leaves, tree_map

    n = TRAIN["n_clients"]
    for arch in REMAT_ARCHS:
        base = get_config(arch)
        params = build_model(base).init(
            torch.Generator(device="cuda").manual_seed(0), device="cuda")
        stack = tree_map(lambda a: a.unsqueeze(0).expand(
            (n,) + tuple(a.shape)).contiguous(), params)
        del params
        batch = tree_map(lambda *xs: torch.stack(xs), *[
            input_specs.make_batch(base, TRAIN["batch"], TRAIN["seq_len"],
                                   key=c, device="cuda") for c in range(n)])
        out, grads = {}, {}
        for on in (True, False):
            model = build_model(dataclasses.replace(base, remat=on)
                                if base.remat else base)
            step = torch.func.vmap(torch.func.grad(model.loss))
            forward = torch.func.vmap(model.loss)
            real = remat.checkpoint
            if not on and not base.remat:
                remat.checkpoint = lambda body: body
            try:
                step(stack, batch)  # warm-up (and the allocator's cache)
                torch.cuda.synchronize()
                gc.collect()
                torch.cuda.reset_peak_memory_stats()
                held = torch.cuda.memory_allocated()
                t0 = time.perf_counter()
                grads[on] = step(stack, batch)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                peak = torch.cuda.max_memory_allocated()
                with torch.no_grad():
                    forward(stack, batch)
                torch.cuda.synchronize()
                out[on] = {"ms": (t1 - t0) * 1e3,
                           "forward_ms": (time.perf_counter() - t1) * 1e3,
                           "peak_gb": peak / 1e9,
                           "peak_over_held_gb": (peak - held) / 1e9}
            finally:
                remat.checkpoint = real
        gaps = [float(torch.max(torch.abs(a - b)))
                / max(float(torch.max(torch.abs(b))), 1e-30)
                for a, b in zip(tree_leaves(grads[True]),
                                tree_leaves(grads[False]))]
        equal = all(torch.equal(a, b) for a, b in
                    zip(tree_leaves(grads[True]), tree_leaves(grads[False])))
        emit({"phase": "train", "check": "remat", "arch": arch,
              "cfg_remat": base.remat, "clients": n, "batch": TRAIN["batch"],
              "seq_len": TRAIN["seq_len"], "remat_on": out[True],
              "remat_off": out[False], "bitwise_equal": equal,
              "max_relative_gap": max(gaps)})
        check(equal, f"{arch}: gradients with remat differ from those "
                     f"without (largest gap {max(gaps)} of a leaf's scale)")
        del stack, batch, grads
        gc.collect()
        torch.cuda.empty_cache()


def _check_delay_bits(comm):
    """L bills half of B's uplink bits (rr:2 of 4 clients: duty 0.5) and
    all of its downlink: per round, bit-true from the compressor stack's
    per-leaf widths (``comm_bits_per_round``), and in the bytes the run's
    meter counted."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import FedScenario
    from repro_torch.core import FedCET
    from repro_torch.core.comm import (CommMeter, comm_bits_per_round,
                                       leaf_info_of)
    from repro_torch.models import build_model

    params = build_model(get_config("fedlm-100m")).init(
        torch.Generator().manual_seed(0))  # on the host: names and sizes
    info, nc = leaf_info_of(params), TRAIN["n_clients"]
    out = {}
    for p in ("B_shift_q8_arena", DELAY_PATH):
        algo = FedScenario(**PATHS[p][0]).apply(
            FedCET(alpha=ALPHA, c=C, tau=TRAIN["tau"], n_clients=nc))
        meter = CommMeter.for_params(params, algo=algo, n_clients=nc)
        metered = []
        for _ in range(TRAIN["steps"]):
            meter.tick_round(algo)
            metered.append(meter.total)
        out[p] = (comm_bits_per_round(algo, meter.n_params, nc, info),
                  meter, metered)
    (b_bits, b_meter, _), (l_bits, l_meter, l_want) = (
        out["B_shift_q8_arena"], out[DELAY_PATH])
    ratio = l_bits["up_bits"] / b_bits["up_bits"]
    emit({"phase": "train", "check": "L_bits", "up_bits_L_over_B": ratio,
          "up_bits_B": b_bits["up_bits"], "up_bits_L": l_bits["up_bits"],
          "down_bits_equal": l_bits["down_bits"] == b_bits["down_bits"],
          "bytes_up_5_rounds_B": b_meter.bytes_up,
          "bytes_up_5_rounds_L": l_meter.bytes_up,
          "comm_bytes_B": comm["B_shift_q8_arena"],
          "comm_bytes_L": comm[DELAY_PATH]})
    check(ratio == 0.5, f"L bills {ratio} of B's uplink bits, not 0.5")
    check(l_bits["down_bits"] == b_bits["down_bits"],
          "L's downlink differs from B's")
    check(comm[DELAY_PATH] == l_want,
          f"L's run metered {comm[DELAY_PATH]}, expected {l_want}")
    check(abs(2 * l_meter.bytes_up - b_meter.bytes_up)
          <= 2 * TRAIN["steps"], "L's uplink bytes are not half of B's")


#: path K: fedlm-100m at full width over a 16-client store, a ``block:4``
#: cohort per round, ``shift:q8`` on the arena, batch 4 a client (the
#: store's x, d and shift memory take 3 x 16 x 428 MB; the dense 16-client
#: warm-up at init comes on top).
COHORT_PATH = "K_cohort_block4_of16_shift_q8_arena"
COHORT_RUN = dict(n_clients=16, cohort="block:4", batch=4, seq_len=128,
                  tau=2, steps=5)
#: K's exact launches. Init is dense and synchronous over all 16 clients
#: on the arena with no delay or topology, so the reference's guard lets
#: FedCET's fused tail take its aggregation; the 5 cohort rounds never
#: do (a cohort round has its own phase B): per round the triad twice on
#: the 4 gathered rows, one rows quantize (and its dither) and one 4-op
#: pair.
K_INIT_LAUNCHES = {"fedcet_v": 1, "fedcet_round_tail": 1,
                   "threefry_uniform_rows": 1}
K_ROUND_LAUNCHES = {"fedcet_v": 10, "stochastic_quantize_rows": 5,
                    "threefry_uniform_rows": 5, "fedcet_comm4": 5}
#: K's first round against a plain 4-client engine on the cohort's rows
#: and tokens (gathered here, not by the engine): phase A runs the same
#: code at the same shapes, phase B the fused tail instead of the rows
#: quantize and the 4-op pair, so the two differ by float32 rounding of
#: the client mean. x and the shift memory are held relative to their own
#: norms, d relative to c ||x|| (the Lemma 2 scale).
K_PLAIN_MAX = {"x": 1e-6, "h": 1e-6, "d": INVARIANT_MAX}


def _drive_rounds(name, algo, grad_fn, held, steps, batches, hook):
    """Rounds ``0 .. steps - 1`` of ``algo`` through the engine under the
    span recorder from ``held["state"]`` (taken out of ``held``: the caller
    keeps no other reference, so a round frees the state it replaces),
    each timed on the host clock. ``hook(r, state, batch)`` runs
    before round ``r`` and returns ``after(state)``, which returns the
    round's loss and the fields it adds to the round's line (and makes the
    path's own checks). Each round: its line, the Lemma 2 residual (at
    most ``INVARIANT_MAX``) and a finite loss. Returns the last state and
    the round times."""
    from repro_torch.utils import spans

    norm = lambda t: math.sqrt(float(t.double().pow(2).sum()))  # noqa: E731
    state = held.pop("state")
    times = []
    spans.enable()
    try:
        for r in range(steps):
            bt = batches(r)
            after = hook(r, state, bt)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state = algo.round(grad_fn, state, bt)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            rec = spans.drain()
            loss, fields = after(state)
            d, x = state.inner.d.data, state.inner.x.data
            resid = norm(d.sum(0)) / (C * norm(x))
            emit({"phase": "train", "path": name, "round": r,
                  "round_s": times[-1], "loss": loss,
                  "sum_d_over_c_x": resid, **fields,
                  "split_ms": {k: v for k, v in _split_ms(rec).items()
                               if v},
                  **_counts(rec)})
            check(resid <= INVARIANT_MAX,
                  f"{name} round {r}: Lemma 2 residual {resid}")
            check(math.isfinite(loss), f"{name} round {r}: loss {loss}")
    finally:
        spans.disable()
        spans.drain()
    return state, times


def _plain_gap_check(name, what, got, want, **fields):
    """Holds two (x, d, shift memory) arena data triples, host or card,
    within ``K_PLAIN_MAX``: ``||x - x'|| / ||x'||``, ``||d - d'|| / (c
    ||x'||)`` and ``||h - h'|| / ||h'||``, summed in float64 on the card a
    client row at a time. Emits the gaps and whether each pair is bitwise
    equal (a zero difference)."""
    def sq(rows):
        return sum(float(r.cuda().double().pow(2).sum()) for r in rows)

    diff = [sq(a[i].cuda() - b[i].cuda() for i in range(a.shape[0]))
            for a, b in zip(got, want)]
    x2, h2 = sq(want[0]), sq(want[2])
    gaps = {"x": math.sqrt(diff[0] / x2), "d": math.sqrt(diff[1] / x2) / C,
            "h": math.sqrt(diff[2] / max(h2, 1e-300))}
    emit({"phase": "train", "path": name, "check": what, "gaps": gaps,
          "bounds": K_PLAIN_MAX, "bitwise_equal": {
              k: v == 0.0 for k, v in zip(("x", "d", "h"), diff)}, **fields})
    for k, gap in gaps.items():
        check(gap <= K_PLAIN_MAX[k], f"{name} {what}: {k} is {gap} apart")


def _cohort_path():
    """Path K through the engine (``FedScenario.apply``, ``init``,
    ``round``), checking each round: the store's arena tensors keep their
    ``data_ptr()`` (the scatter is in place), the 12 rows outside the
    round's cohort are bitwise unchanged in x, d and the shift memory,
    the Lemma 2 residual, a finite cohort loss. After the rounds, the
    first round's cohort rows are held against a plain 4-client engine
    run from the same rows and tokens (``K_PLAIN_MAX``). Emits each
    round's time and split (gather, gradients, dither, kernels, scatter),
    the peak GB, and the exact launches of init and of the rounds."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import FedScenario
    from repro_torch.core import FedCET
    from repro_torch.core.arena import Arena
    from repro_torch.data.synthetic import make_hetero_lm_dataset
    from repro_torch.kernels import library as L
    from repro_torch.models import build_model
    from repro_torch.utils.tree import tree_map

    run = COHORT_RUN
    n, tau = run["n_clients"], run["tau"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = build_model(get_config("fedlm-100m"))
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        device="cuda")
    algo = FedScenario(compression="shift:q8", arena=True,
                       cohort=run["cohort"]).apply(
        FedCET(alpha=ALPHA, c=C, tau=tau, n_clients=n, x64=False))
    ds = make_hetero_lm_dataset(model.cfg.vocab_size, n, run["seq_len"],
                                run["batch"], heterogeneity=0.8, seed=0,
                                device="cuda")
    grad_fn = torch.func.grad(model.loss)
    client_losses = torch.func.vmap(model.loss)
    L.reset_launches()
    t0 = time.perf_counter()
    state = algo.init(grad_fn, params, tree_map(
        lambda b: b[0], {"tokens": ds.sample_round(0, tau)}))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    del params
    init_launches = {k: v for k, v in L.LAUNCHES.items() if v}
    init_peak = torch.cuda.max_memory_allocated()

    def store(st):
        return [a.data for a in (st.inner.x, st.inner.d, st.extras[0])]

    def rows_of(tree, idx):  # the cohort's rows of every per-client leaf
        return tree_map(lambda a: a[idx] if isinstance(a, torch.Tensor)
                        and a.dim() >= 1 and a.shape[0] == n else a, tree)

    check(all(isinstance(a, Arena) for a in (state.inner.x, state.inner.d,
                                             state.extras[0])),
          "K: the store is not on the arena")
    L.reset_launches()
    first = {}

    def hook(r, state, bt):
        idx = algo.cohort.indices(state.inner.t, tau, n, device="cuda")
        out = torch.ones(n, dtype=torch.bool, device="cuda")
        out[idx] = False
        before = store(state)
        ptrs = [a.data_ptr() for a in before]
        kept = [a[out] for a in before]
        if r == 0:  # copies: the round consumes the store
            first["in"] = (rows_of(state, idx),
                           {"tokens": bt["tokens"][:, idx]})
        del before

        def after(state):
            new = store(state)
            if r == 0:
                first["out"] = [a[idx] for a in new]
            in_place = [a.data_ptr() for a in new] == ptrs
            unchanged = all(torch.equal(k.view(torch.int32),
                                        a[out].view(torch.int32))
                            for k, a in zip(kept, new))
            kept.clear()
            check(in_place, f"K round {r}: the scatter moved the store")
            check(unchanged, f"K round {r}: a row outside the cohort changed")
            with torch.no_grad():
                params_c = tree_map(lambda a: a[idx],
                                    algo.client_params(state))
                loss = float(torch.mean(client_losses(
                    params_c, {"tokens": bt["tokens"][0][idx]})))
            return loss, {"cohort": idx.tolist(), "in_place": in_place,
                          "others_unchanged": unchanged}
        return after

    held = {"state": state}
    del state
    state, _ = _drive_rounds(
        COHORT_PATH, algo, grad_fn, held, run["steps"],
        lambda r: {"tokens": ds.sample_round(r, tau)}, hook)
    launches = {k: v for k, v in L.LAUNCHES.items() if v}
    rows = first.pop("out")
    plain = FedScenario(compression="shift:q8", arena=True).apply(
        FedCET(alpha=ALPHA, c=C, tau=tau, n_clients=rows[0].shape[0],
               x64=False))
    want = store(plain.round(grad_fn, *first.pop("in")))
    _plain_gap_check(COHORT_PATH, "round_0_vs_plain_engine_on_the_cohort",
                     rows, want)
    del want, rows
    emit({"phase": "train", "path": COHORT_PATH, "scenario": {
              "compression": "shift:q8", "arena": True,
              "cohort": run["cohort"]},
          "arch": "fedlm-100m", "reduced": False, **run,
          "init_s": init_s, "init_launches": init_launches,
          "init_peak_gb": init_peak / 1e9,
          "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
          "launches": launches})
    check(init_launches == K_INIT_LAUNCHES,
          f"K init launches {init_launches}, expected {K_INIT_LAUNCHES}")
    check(launches == K_ROUND_LAUNCHES,
          f"K round launches {launches}, expected {K_ROUND_LAUNCHES}")
    del state
    torch.cuda.empty_cache()
    return {f: launches.get(f, 0) + init_launches.get(f, 0)
            for f in KERNELS}


#: paths MO, ZA, WH: FedCET training of the moe, hybrid and audio families
#: at their configs' published widths, under B's scenario (``shift:q8`` +
#: arena: the triad and the fused round tail), depth cut only with
#: ``dataclasses.replace(cfg, n_layers=...)`` (None: whole), driven through
#: the engine as ``tests/test_arch_smoke.py::test_fedcet_round_on_arch``
#: drives it. Per-client batch and sequence as the reference's smoke: WH
#: runs 4 clients x 2 x 1500 frames, which fits because whisper-small's
#: ``remat`` rematerializes each encoder and decoder layer in the backward
#: (without it the vmapped backward held ~80 GB of encoder activations).
FAMILY_PATHS = {
    "MO_granite_moe_3b_a800m": dict(arch="granite-moe-3b-a800m",
                                    n_layers=2, batch=2, seq_len=128),
    "ZA_zamba2_1p2b": dict(arch="zamba2-1.2b", n_layers=6, batch=2,
                           seq_len=128),
    "WH_whisper_small": dict(arch="whisper-small", n_layers=None, batch=2,
                             seq_len=64),
}
FAMILY_RUN = dict(n_clients=4, tau=2, steps=3)
#: init (1 triad, 1 tail, its dither), then 2 triads and 1 tail with its
#: dither a round, as on B
FAMILY_LAUNCHES = {"fedcet_v": 1 + 2 * FAMILY_RUN["steps"],
                   "fedcet_round_tail": 1 + FAMILY_RUN["steps"],
                   "threefry_uniform_rows": 1 + FAMILY_RUN["steps"]}
FAMILY_LOSS_RTOL = 1e-5  # the card's round-0 loss against the CPU port's
#: the forms ``_plain`` routes to their plain versions for the rerun
OPS_FORMS = ("fedcet_v", "fedcet_comm", "stochastic_quantize",
             "stochastic_quantize_rows", "fedcet_round_tail",
             "gossip_reduce", "telemetry_sketch", "flash_attention",
             "ssd_intra", "arena_uniform")


def _host(tree):
    from repro_torch.utils.tree import tree_map

    return tree_map(lambda a: a.cpu() if isinstance(a, torch.Tensor)
                    else a, tree)


def _family_loss_check(name, cfg, model, params, batch):
    """The loss of ``params`` on one client's batch on the card and on the
    CPU (the same tensors copied over), and for an MoE the kept mask of
    its first layer's dispatch on each."""
    from repro_torch.models import moe

    keeps, real = [], moe.route

    def recording(*a, **kw):
        out = real(*a, **kw)
        keeps.append(out.keep)
        return out

    moe.route = recording
    try:
        with torch.no_grad():
            card = float(model.loss(params, batch))
            layers = len(keeps)
            cpu = float(model.loss(_host(params), _host(batch)))
    finally:
        moe.route = real
    rel = abs(card - cpu) / abs(cpu)
    out = {"phase": "train", "path": name, "check": "loss_vs_cpu",
           "card_loss": card, "cpu_loss": cpu, "relative": rel,
           "tolerance": FAMILY_LOSS_RTOL}
    if cfg.n_experts:
        k_card, k_cpu = keeps[0].cpu(), keeps[layers]
        out.update(moe_layers=layers, kept=int(k_card.sum()),
                   assignments=k_card.numel(),
                   kept_mask_equal=torch.equal(k_card, k_cpu))
    emit(out)
    check(rel <= FAMILY_LOSS_RTOL,
          f"{name}: round-0 loss {card} on the card, {cpu} on the CPU")
    if cfg.n_experts:
        check(out["kept_mask_equal"], f"{name}: the first layer's MoE kept "
                                      "mask differs from the CPU's")


def _plain_tail_by_rows(v, h, d, u, scale, w, den, *, blocks=8, **kw):
    """``kernels/ref.py:fedcet_round_tail`` a block of arena rows at a
    time into whole outputs: the plain version is elementwise over rows
    (the client sum is per coordinate), so the values are the same, and
    its temporaries (~31 GB more than the kernel at MO's arena) shrink to
    a block's."""
    from repro_torch.kernels import ref as R

    out = [torch.empty_like(t) for t in (d, v, h)]
    scale = scale.reshape(-1, 1)
    step = -(-v.shape[1] // blocks)
    for a in range(0, v.shape[1], step):
        rows = slice(a, a + step)
        for o, r in zip(out, R.fedcet_round_tail(
                v[:, rows], h[:, rows], d[:, rows], u[rows], scale[rows], w,
                den, **kw)):
            o[:, rows] = r
    return tuple(out)


def _family_path(name, spec):
    """One of ``FAMILY_PATHS`` through ``FedScenario(...).apply(FedCET)``:
    seed-0 weights on the card, batches from
    ``launch/input_specs.make_batch`` (a key per round, local step and
    client), init and 3 rounds, float32, TF32 off. Gates: the loss is
    finite each round; Lemma 2 (``sum_d_over_c_x`` <= ``INVARIANT_MAX``);
    exactly ``FAMILY_LAUNCHES``; the round-0 loss within
    ``FAMILY_LOSS_RTOL`` of the CPU port's on the same weights and batch
    (and an MoE's first-layer kept mask bit for bit); and round 1 rerun on
    the card with every kernel routed to its plain version (``impl="ref"``)
    from the same state and batches: x, d and the shift memory within
    ``K_PLAIN_MAX`` (B's scenario's plain-engine bounds: x and h 1e-6 of
    their norms, d 1e-5 of ``c ||x||``; the kernels equal their plain
    versions bit for bit, but the gradients' atomics need not repeat). The
    plain round tail runs a block of rows at a time
    (``_plain_tail_by_rows``): whole, it peaks at 77.6 GB on MO."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import FedScenario
    from repro_torch.core import FedCET
    from repro_torch.kernels import library as L
    from repro_torch.kernels import ops
    from repro_torch.launch import input_specs
    from repro_torch.models import build_model
    from repro_torch.utils.tree import tree_map, tree_num_params

    cfg = get_config(spec["arch"])
    if spec["n_layers"]:
        cfg = dataclasses.replace(cfg, n_layers=spec["n_layers"])
    n, tau, steps = (FAMILY_RUN[k] for k in ("n_clients", "tau", "steps"))
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        device="cuda")
    n_params = tree_num_params(params)

    def batches(r):  # [tau, clients, ...]
        return tree_map(lambda *xs: torch.stack(xs), *[
            tree_map(lambda *ys: torch.stack(ys), *[
                input_specs.make_batch(cfg, spec["batch"], spec["seq_len"],
                                       key=100 * r + 10 * t + c,
                                       device="cuda")
                for c in range(n)]) for t in range(tau)])

    first = batches(0)
    _family_loss_check(name, cfg, model, params,
                       tree_map(lambda b: b[0, 0], first))
    algo = FedScenario(compression="shift:q8", arena=True).apply(
        FedCET(alpha=ALPHA, c=C, tau=tau, n_clients=n, x64=False))
    grad_fn = torch.func.grad(model.loss)
    client_losses = torch.func.vmap(model.loss)
    data = lambda st: [a.data for a in (st.inner.x, st.inner.d,  # noqa: E731
                                        st.extras[0])]
    L.reset_launches()
    t0 = time.perf_counter()
    held = {"state": algo.init(grad_fn, params,
                               tree_map(lambda b: b[0], first))}
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    del params
    kept = {}

    def hook(r, state, bt):
        if r == 1:  # round 1's input, on the host for the plain rerun
            kept["in"] = (_host(state), _host(bt))

        def after(state):
            if r == 1:
                kept["out"] = [a.cpu() for a in data(state)]
            with torch.no_grad():
                loss = float(torch.mean(client_losses(
                    algo.client_params(state), tree_map(lambda b: b[0], bt))))
            return loss, {
                "allocated_gb": torch.cuda.memory_allocated() / 1e9,
                "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                "note": "round 0 also holds the warm-up" if r == 0 else ""}
        return after

    state, rounds = _drive_rounds(
        name, algo, grad_fn, held, steps,
        lambda r: first if r == 0 else batches(r), hook)
    launches = {k: v for k, v in L.LAUNCHES.items() if v}
    emit({"phase": "train", "path": name, "arch": cfg.name,
          "n_layers": cfg.n_layers, "reduced": False, "n_params": n_params,
          "scenario": {"compression": "shift:q8", "arena": True},
          **FAMILY_RUN, "batch": spec["batch"], "seq_len": spec["seq_len"],
          "init_s": init_s, "round_s": rounds,
          "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
          "launches": launches})
    check(launches == FAMILY_LAUNCHES,
          f"{name} launches {launches}, expected {FAMILY_LAUNCHES}")
    del state
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    undo = _plain(OPS_FORMS)
    ops.fedcet_round_tail = lambda *a, impl=None, **kw: \
        _plain_tail_by_rows(*a, **kw)
    L.reset_launches()
    try:
        want = data(algo.round(grad_fn, *tree_map(
            lambda a: a.cuda() if isinstance(a, torch.Tensor) else a,
            kept.pop("in"))))
    finally:
        undo()
    plain_launches = {k: v for k, v in L.LAUNCHES.items() if v}
    check(not plain_launches, f"{name}: the plain rerun launched "
                              f"{plain_launches}")
    _plain_gap_check(name, "round_1_vs_plain_kernels", kept.pop("out"), want,
                     held_before_bytes=held, max_memory_allocated_bytes=(
                         torch.cuda.max_memory_allocated()))
    del want
    gc.collect()
    torch.cuda.empty_cache()
    return {f: launches.get(f, 0) for f in KERNELS}


#: the reference's quantization-error ratio (plan / uniform q8) at FULL
#: width, on its own seed-0 parameters in the settings of its committed
#: benchmark run: tests/test_torch_comp_plan.py computes it
#: (``FULL_WIDTH_RATIO``). The reference does not reach < 1 there, so the
#: ``plans`` phase holds the card's ratio to at most this value.
PLAN_FULL_WIDTH_RATIO = 1.0354588721039204


def _head_to_head(plan, params):
    """``benchmarks/comp_plan_bench.py:quant_error_head_to_head`` in the
    port: one message-shaped tree (the parameters, one client) through
    bare uniform q8 and through the plan's bare per-leaf quantizers, from
    key 7 (round one: zero shift memory), relative MSE of each."""
    from repro_torch.core import prng
    from repro_torch.core.comm import leaf_info_of
    from repro_torch.core.compressors import (ErrorFeedback, Shifted,
                                              StochasticQuant)
    from repro_torch.utils.tree import tree_leaves

    def strip(c):
        return c.inner if isinstance(c, (ErrorFeedback, Shifted)) else c

    key = prng.key(7)
    flat = tree_leaves(params)
    names = [nm for nm, _ in leaf_info_of(params)]

    def tree_mse(comp_for_leaf):
        num = den = 0.0
        for i, leaf in enumerate(flat):
            comp = comp_for_leaf(i)
            q = leaf if comp is None else comp.compress(
                prng.fold_in(key, i) if comp.requires_key else None,
                leaf[None])[0]
            num += float(torch.sum(torch.square(q - leaf)))
            den += float(torch.sum(torch.square(leaf)))
        return num / den

    q8 = StochasticQuant(8)
    uni = tree_mse(lambda i: q8)
    return uni, tree_mse(lambda i: strip(plan.resolve(i, names[i])))


def phase_plans():
    """Per-leaf plans at full width (fedlm-100m, seed 0, drawn with the
    CPU generator so any machine draws the same weights, then moved to the
    card): (a) the benchmark's head-to-head, the plan allocated at uniform
    ``shift:q8``'s exact bits (``absmax``, ``shift``, max 14 bits as the
    benchmark): plan bits <= uniform bits exactly, and the MSE ratio at
    most the reference's own full-width value; (b) the uniform plan
    ``*:shift:q8`` against ``Shifted(StochasticQuant(8))`` on one
    full-width 4-client message tree and shift memory, from one key:
    message and memory bitwise equal."""
    from repro_torch.configs import get_config
    from repro_torch.core import prng
    from repro_torch.core.compressors import (Shifted, StochasticQuant,
                                              parse_plan)
    from repro_torch.models import build_model
    from repro_torch.utils.tree import tree_leaves, tree_map

    params = tree_map(lambda t: t.cuda(), build_model(
        get_config("fedlm-100m")).init(torch.Generator().manual_seed(0)))
    t0 = time.perf_counter()
    plan, budget, bits, info = _allocated_plan(params, min_bits=2,
                                               max_bits=14)
    alloc_s = time.perf_counter() - t0
    uni, pln = _head_to_head(plan, params)
    ratio = pln / uni
    gen = torch.Generator(device="cuda").manual_seed(1)
    msg = tree_map(lambda t: t[None] + 1e-2 * torch.randn(
        (4,) + tuple(t.shape), generator=gen, device="cuda"), params)
    mem = tree_map(lambda t: 0.5 * t + 1e-3 * torch.randn(
        t.shape, generator=gen, device="cuda"), msg)
    del params
    key = prng.fold_in(prng.key(3), 17)
    out_p, mem_p = parse_plan("*:shift:q8").apply(key, msg, mem)
    out_u, mem_u = Shifted(StochasticQuant(8)).apply(key, msg, mem)
    same = (_bitwise(tree_leaves(out_p), tree_leaves(out_u))
            and _bitwise(tree_leaves(mem_p), tree_leaves(mem_u)))
    moved = not _bitwise(tree_leaves(out_p), tree_leaves(msg))
    emit({"phase": "plans", "leaves": len(info),
          "params": sum(n for _, n in info), "uniform_bits": budget,
          "plan_bits": bits, "bits_ratio": bits / budget,
          "mse_uniform_q8": uni, "mse_plan": pln, "mse_ratio": ratio,
          "mse_ratio_limit": PLAN_FULL_WIDTH_RATIO, "allocate_s": alloc_s,
          "rules": [[p, c.inner.bits] for p, c in plan.rules],
          "uniform_plan_bitwise_equal_shifted_q8": same})
    del msg, mem, out_p, mem_p, out_u, mem_u
    torch.cuda.empty_cache()
    check(bits <= budget, f"plans: the plan spends {bits} > {budget} bits")
    check(ratio <= PLAN_FULL_WIDTH_RATIO,
          f"plans: MSE ratio {ratio} above the reference's full-width "
          f"{PLAN_FULL_WIDTH_RATIO}")
    check(same and moved, "plans: '*:shift:q8' differs from "
                          "Shifted(StochasticQuant(8)) on the card")


#: the Fig. 1 phase: rounds, the rounds whose e(k) is printed, the limit of
#: |card - CPU| on every round, and FedAvg's drift run (the reference's
#: tests/test_baselines.py:19-33).
FIG1_ROUNDS, FIG1_AT = 300, (0, 50, 100, 200, 300)
FIG1_CARD_VS_CPU = 1e-10
DRIFT_ROUNDS, DRIFT_FLOOR = 800, 1e-4
FEDCET_KERNELS = ("fedcet_v", "fedcet_comm", "fedcet_comm4",
                  "fedcet_round_tail", "stochastic_quantize",
                  "stochastic_quantize_rows")


def phase_fig1():
    """The paper's Fig. 1 in float64 on the card: the four algorithms of
    ``paper_fig1_algorithms`` on the §IV problem, tau 2, 300 rounds, each
    curve held against the same script's CPU curve; FedCET launches its
    triad and pair exactly as the quadratic phase does, the baselines no
    kernel; then FedAvg's drift floor on the heterogeneous-Hessian
    problem."""
    from repro_torch.core import FedAvg
    from repro_torch.core.simulate import (paper_fig1_algorithms,
                                           simulate_quadratic)
    from repro_torch.data.quadratic import (make_hetero_hessian_problem,
                                            make_quadratic_problem)
    from repro_torch.kernels import library as L

    problem = make_quadratic_problem(0, device="cuda")
    cpu_problem = problem.to("cpu")
    launches, final = {}, {}
    for name, algo in paper_fig1_algorithms(problem, tau=2).items():
        L.reset_launches()
        t0 = time.perf_counter()
        res = simulate_quadratic(algo, problem, FIG1_ROUNDS, device="cuda")
        errors = res.errors.cpu()
        seconds = time.perf_counter() - t0
        launches[f"fig1_{name}"] = dict(L.LAUNCHES)
        t0 = time.perf_counter()
        cpu = simulate_quadratic(algo, cpu_problem, FIG1_ROUNDS,
                                 device="cpu").errors
        cpu_seconds = time.perf_counter() - t0
        gap = float((errors - cpu).abs().max())
        final[name] = float(errors[-1])
        emit({"phase": "fig1", "algo": name, "dtype": "float64",
              "rounds": FIG1_ROUNDS, "e_k": {str(k): float(errors[k])
                                             for k in FIG1_AT},
              "bytes_per_round": res.bytes_per_round, "seconds": seconds,
              "cpu_seconds": cpu_seconds, "max_abs_card_minus_cpu": gap,
              "launches": {k: n for k, n in L.LAUNCHES.items() if n}})
        check(gap <= FIG1_CARD_VS_CPU,
              f"fig1 {name}: card and CPU curves differ by {gap}")
        n = L.LAUNCHES
        if name == "fedcet":  # init: v + pair; a round: two v, one pair
            want = {"fedcet_v": 1 + 2 * FIG1_ROUNDS,
                    "fedcet_comm": 1 + FIG1_ROUNDS}
            check({k: v for k, v in n.items() if v} == want,
                  f"fig1 fedcet launches {dict(n)}, expected {want}")
        else:
            check(not any(n.values()),
                  f"fig1 {name} launched a kernel: {dict(n)}")
    check(final["fedcet"] < final["fedtrack"] < final["scaffold"],
          f"fig1 ordering at round {FIG1_ROUNDS}: {final}")
    hetero = make_hetero_hessian_problem(11, device="cuda")
    L.reset_launches()
    errs = simulate_quadratic(
        FedAvg(alpha=1.0 / (2 * 2 * hetero.L), tau=2,
               n_clients=hetero.n_clients), hetero, DRIFT_ROUNDS,
        device="cuda").errors.cpu()
    launches["fig1_fedavg_drift"] = dict(L.LAUNCHES)
    floor, move = float(errs[-1]), float(abs(errs[-1] - errs[-100]))
    emit({"phase": "fig1", "algo": "fedavg", "problem": "hetero_hessian_11",
          "rounds": DRIFT_ROUNDS, "final_error": floor,
          "last_100_rounds_move": move, "floor_limit": DRIFT_FLOOR})
    check(floor > DRIFT_FLOOR, f"FedAvg drift floor {floor}")
    check(move < 0.01 * floor + 1e-12, f"FedAvg still moving: {move}")
    check(not any(L.LAUNCHES.values()), "FedAvg launched a kernel")
    return launches


#: trainer paths: fedlm-100m at full width through ``FedTrainer``.
TRAINER = dict(n_clients=4, batch=8, seq_len=128, tau=2)
#: T's kernel launches per run: init (one v, one tail and its dither) + 2
#: v and 1 tail with its dither a round.
T_LAUNCHES = {6: {"fedcet_v": 13, "fedcet_round_tail": 7,
                  "threefry_uniform_rows": 7},
              3: {"fedcet_v": 7, "fedcet_round_tail": 4,
                  "threefry_uniform_rows": 4}}
LOSS_KEYS = ("loss_global", "loss_local_mean", "heterogeneity_gap")


class _SegmentClock:
    """Host-clock time of each segment the trainer runs, synchronized at
    both ends: wraps the trainer's round runners."""

    def __init__(self, trainer):
        self.segments = []
        for attr in ("_runner", "_metric_runner"):
            setattr(trainer, attr, self.wrap(getattr(trainer, attr)))

    def wrap(self, run):
        from repro_torch.utils.tree import tree_leaves

        def timed(state, stacked):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = run(state, stacked)
            torch.cuda.synchronize()
            n = tree_leaves(stacked)[0].shape[0]
            self.segments.append({"rounds": n, "round_s":
                                  (time.perf_counter() - t0) / n})
            return out

        return timed


def _trainer_setup():
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import make_hetero_lm_dataset
    from repro_torch.models import build_model

    cfg = get_config("fedlm-100m")
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        device="cuda")
    ds = make_hetero_lm_dataset(cfg.vocab_size, TRAINER["n_clients"],
                                TRAINER["seq_len"], TRAINER["batch"],
                                heterogeneity=0.8, seed=0, device="cuda")
    return model, params, (lambda r: {"tokens": ds.sample_round(
        r, TRAINER["tau"])})


def _trainer(algo, model, cfg):
    from repro_torch.fed import FedTrainer

    trainer = FedTrainer(algo, model.loss, cfg, device="cuda")
    return trainer, _SegmentClock(trainer)


def _engine_leaves(state):
    """x, d and the shift memory of an arena ``EngineState``."""
    return {"x": state.inner.x.data, "d": state.inner.d.data,
            "h": state.extras[0].data}


def phase_trainer():
    """Path T: FedCET with ``shift:q8`` on the arena (B's scenario) through
    ``FedTrainer``: (i) 6 rounds straight, eval every 3; (ii) 3 rounds with
    a checkpoint at round 3 (keep 1); (iii) a fresh trainer resumes from
    it and runs rounds 3-5, checkpointing at 6. (iii)'s final x, d and
    shift memory must equal (i)'s bit for bit, and so must its round-5
    losses. Then the baselines' paths T-fedavg, T-scaffold and T-fedtrack
    (``benchmarks/fed_lm_bench.py``'s configuration: alpha 3e-3, no
    transform), 3 rounds each."""
    import os
    import tempfile

    from repro_torch.checkpoint import ckpt
    from repro_torch.configs.base import FedScenario
    from repro_torch.core import FedAvg, FedCET, FedTrack, Scaffold
    from repro_torch.fed import TrainerConfig
    from repro_torch.fed import trainer as trainer_mod
    from repro_torch.kernels import library as L
    from repro_torch.utils.tree import tree_map

    gc.collect()
    torch.cuda.empty_cache()
    model, params, batches_for = _trainer_setup()
    init_b = tree_map(lambda b: b[0], batches_for(0))
    algo = FedScenario(compression="shift:q8", arena=True).apply(
        FedCET(alpha=ALPHA, c=C, tau=TRAINER["tau"],
               n_clients=TRAINER["n_clients"], x64=False))
    saves = []
    real_save = trainer_mod.save

    def timed_save(ckpt_dir, step, tree, keep=3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = real_save(ckpt_dir, step, tree, keep=keep)
        saves.append({"step": step, "seconds": time.perf_counter() - t0,
                      "bytes": os.path.getsize(path),
                      "files_after": ckpt.all_steps(ckpt_dir)})
        return path

    trainer_mod.save = timed_save
    ckpt_dir = tempfile.mkdtemp(prefix="fedcet_ckpt_")
    runs, launches = {}, {}
    try:
        for run, cfg in (
                ("T", TrainerConfig(rounds=6, eval_every=3)),
                ("T_checkpointed", TrainerConfig(
                    rounds=3, ckpt_every=3, ckpt_keep=1, ckpt_dir=ckpt_dir)),
                ("T_resumed", TrainerConfig(
                    rounds=6, eval_every=3, ckpt_every=3, ckpt_keep=1,
                    ckpt_dir=ckpt_dir))):
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            L.reset_launches()
            trainer, clock = _trainer(algo, model, cfg)
            state = trainer.init_state(params, init_b)
            start, restore_s = 0, None
            if run == "T_resumed":
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, start = trainer.maybe_resume(state)
                torch.cuda.synchronize()
                restore_s = time.perf_counter() - t0
                check(start == 3, f"T: resumed from round {start}, not 3")
            state = trainer.fit(state, batches_for, start_round=start)
            torch.cuda.synchronize()
            launches[run] = dict(L.LAUNCHES)
            # the states kept for the comparison count in the next peaks.
            held = sum(t.numel() * t.element_size() for v in runs.values()
                       for t in v["state"].values()) / 1e9
            if run != "T_checkpointed":
                runs[run] = {"state": _engine_leaves(state),
                             "t": state.inner.t, "history": trainer.history}
            emit({"phase": "trainer", "path": run, "algo": "fedcet",
                  "scenario": {"compression": "shift:q8", "arena": True},
                  "arch": "fedlm-100m", "reduced": False, **TRAINER,
                  "rounds": cfg.rounds, "start_round": start,
                  "segments": clock.segments, "history": trainer.history,
                  "restore_s": restore_s, "held_gb": held,
                  "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                  "launches": {k: n for k, n in L.LAUNCHES.items() if n}})
            check(all(math.isfinite(h[k]) for h in trainer.history
                      for k in LOSS_KEYS), f"{run}: a loss is not finite")
            want = T_LAUNCHES[cfg.rounds - start]
            got = {k: n for k, n in L.LAUNCHES.items() if n}
            check(got == want, f"{run} launches {got}, expected {want}")
            del trainer, clock, state
    finally:
        trainer_mod.save = real_save
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    u, r = runs["T"], runs["T_resumed"]
    same = {k: torch.equal(u["state"][k], r["state"][k]) for k in u["state"]}
    row_u = next(h for h in u["history"] if h["round"] == 5)
    row_r = next(h for h in r["history"] if h["round"] == 5)
    rows_equal = all(row_u[k] == row_r[k] for k in LOSS_KEYS)
    emit({"phase": "trainer", "check": "resume_vs_uninterrupted",
          "bitwise_equal": same, "t": [u["t"], r["t"]],
          "round_5_rows_equal": rows_equal, "saves": saves,
          "state_bytes": sum(t.numel() * t.element_size()
                             for t in u["state"].values())})
    check(all(same.values()) and u["t"] == r["t"],
          f"T: the resumed run's state differs from the uninterrupted "
          f"run's: {same}")
    check(rows_equal, f"T: round-5 rows differ: {row_u} vs {row_r}")
    check([s["step"] for s in saves] == [3, 6]
          and saves[-1]["files_after"] == [6], f"T: checkpoints {saves}")
    del runs, u, r
    gc.collect()
    torch.cuda.empty_cache()

    comm = {}
    for name, base in (
            ("T-fedavg", FedAvg(alpha=ALPHA, tau=TRAINER["tau"],
                                n_clients=TRAINER["n_clients"])),
            ("T-scaffold", Scaffold(alpha_l=ALPHA, tau=TRAINER["tau"],
                                    n_clients=TRAINER["n_clients"])),
            ("T-fedtrack", FedTrack(alpha=ALPHA, tau=TRAINER["tau"],
                                    n_clients=TRAINER["n_clients"]))):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        L.reset_launches()
        trainer, clock = _trainer(base, model,
                                  TrainerConfig(rounds=3, eval_every=1))
        state = trainer.fit(trainer.init_state(params, init_b), batches_for)
        torch.cuda.synchronize()
        launches[name] = dict(L.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() / 1e9
        t0 = time.perf_counter()
        trainer.evaluate(state, batches_for(2))
        eval_s = time.perf_counter() - t0
        comm[name] = trainer.history[-1]["comm_bytes"] / 3
        emit({"phase": "trainer", "path": name, "algo": base.name,
              "arch": "fedlm-100m", "reduced": False, **TRAINER,
              "rounds": 3, "segments": clock.segments,
              "eval_s": eval_s, "history": trainer.history,
              "comm_bytes_per_round": comm[name], "peak_gb": peak,
              "launches": {k: n for k, n in L.LAUNCHES.items() if n}})
        check(all(math.isfinite(h[k]) for h in trainer.history
                  for k in LOSS_KEYS), f"{name}: a loss is not finite")
        check(not any(L.LAUNCHES[k] for k in FEDCET_KERNELS),
              f"{name} launched a FedCET kernel: {dict(L.LAUNCHES)}")
        del trainer, clock, state
        gc.collect()
    check(comm["T-scaffold"] == comm["T-fedtrack"] == 2 * comm["T-fedavg"],
          f"baseline bytes per round {comm}")
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    return launches


#: serve paths: full width, float32, random weights from seed 0, the
#: reference's prompt draw (make_batch under seed 1); ``launches``: the
#: kernel launches of one prefill, exactly (decode launches none); the
#: limit of prefill + decode against ``forward`` (None: not checked; a
#: sliding forward would take the blockwise path over 8192 tokens, and at
#: granite's capacity factor 1.25 forward, prefill and decode drop
#: different expert assignments); ``pallas_ssd``: hold the
#: ``use_pallas_ssd`` forward against the plain one; ``changes``: config
#: cuts, listed in the path's ``reduced``.
SERVE = {"S1_fedlm_100m": dict(arch="fedlm-100m", batch=4, prompt=2048,
                               gen=64, launches={"flash_attention": 14},
                               forward_tol=1e-4),
         "S2_qwen3_1p7b": dict(arch="qwen3-1.7b", batch=1, prompt=8192,
                               gen=32, launches={"flash_attention": 28},
                               forward_tol=None),
         "S3_mamba2_130m": dict(arch="mamba2-130m", batch=4, prompt=2048,
                                gen=64, launches={"ssd_intra": 24},
                                forward_tol=2e-3, pallas_ssd=True),
         "S4_zamba2_1p2b": dict(arch="zamba2-1.2b", batch=1, prompt=8192,
                                gen=32, launches={"flash_attention": 6,
                                                  "ssd_intra": 38},
                                forward_tol=None),
         "S5_granite_moe_3b": dict(arch="granite-moe-3b-a800m", batch=4,
                                   prompt=2048, gen=64,
                                   launches={"flash_attention": 32},
                                   forward_tol=None),
         "S6_gemma_2b": dict(arch="gemma-2b", batch=1, prompt=8192, gen=32,
                             launches={"flash_attention": 18},
                             forward_tol=None),
         # 12 bidirectional encoder layers over 1500 frames, 12 causal
         # decoder layers over the prompt.
         "S7_whisper_small": dict(arch="whisper-small", batch=4, prompt=64,
                                  gen=64, launches={"flash_attention": 24},
                                  forward_tol=1e-4),
         # the whole model takes ~136 GB in float32: 4 of its 60 layers.
         "S8_llava_next_34b": dict(arch="llava-next-34b", batch=1,
                                   prompt=1024, gen=32,
                                   launches={"flash_attention": 4},
                                   forward_tol=None,
                                   changes=dict(n_layers=4))}
SERVE_TOL = 1e-4   # logits: max |kernel run - plain run| / max |plain run|
PALLAS_SSD_TOL = 2e-4  # forward with use_pallas_ssd vs plain, rtol = atol


def _plain(kernels):
    """Route ``ops.<kernel>`` of each of ``kernels`` to its plain version;
    returns an undo."""
    from repro_torch.kernels import ops

    real = {k: getattr(ops, k) for k in kernels}
    for k, fn in real.items():
        setattr(ops, k, lambda *a, fn=fn, **kw: fn(*a, **{**kw,
                                                          "impl": "ref"}))

    def undo():
        for k, fn in real.items():
            setattr(ops, k, fn)

    return undo


def _teacher_forced(model, params, prompt, tokens):
    """Prefill's last logits and the logits of decoding each of
    ``tokens`` [B, n] in turn: the logits a generate run that emitted
    ``tokens`` saw. Returns [n + 1, B, V]."""
    from repro_torch.launch.serve import cache_len

    B, S = prompt["tokens"].shape
    caches = model.init_caches(B, cache_len(model.cfg, S, tokens.shape[1]),
                               device="cuda")
    with torch.no_grad():
        logits, caches = model.prefill(params, prompt, caches)
        out = [logits[:, 0]]
        for i in range(tokens.shape[1]):
            logits, caches = model.decode_step(params, tokens[:, i:i + 1],
                                               caches)
            out.append(logits[:, 0])
    return torch.stack(out)


def _prefill_ms(model, params, prompt, reps=3):
    """CUDA-event times of ``reps`` more prefills of ``prompt``, each into
    fresh caches: the steady state, where the run's first prefill also
    holds one-time costs."""
    from repro_torch.launch.serve import cache_len

    B, S = prompt["tokens"].shape
    times = []
    for _ in range(reps):
        caches = model.init_caches(B, cache_len(model.cfg, S, 1),
                                   device="cuda")
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with torch.no_grad():
            start.record()
            model.prefill(params, prompt, caches)
            end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
        del caches
    return times


def _rel(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max())


def _decode_trace(name, model, params, prompt, tokens, steps=4):
    """Top device kernels and device idle share of ``steps`` decode steps
    (after a prefill and one untraced step) under ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.serve import cache_len

    B, S = prompt["tokens"].shape
    steps = min(steps, tokens.shape[1] - 1)
    caches = model.init_caches(B, cache_len(model.cfg, S, steps + 1),
                               device="cuda")
    with torch.no_grad():
        _, caches = model.prefill(params, prompt, caches)
        _, caches = model.decode_step(params, tokens[:, :1], caches)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for i in range(1, steps + 1):
                _, caches = model.decode_step(params, tokens[:, i:i + 1],
                                              caches)
            torch.cuda.synchronize()
    SMOKE_DIR.mkdir(parents=True, exist_ok=True)
    path = SMOKE_DIR / f"{name}_decode.trace.json"
    prof.export_chrome_trace(str(path))
    return {"decode_steps": steps, **_read_trace(path)}


def _serve_path(name, spec):
    """Drive ``generate_tokens`` once (launches counted, prefill and each
    decode step timed with CUDA events), then hold its logits against the
    same run with the kernels' plain versions on the card."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import library as L
    from repro_torch.launch import input_specs, serve
    from repro_torch.models import build_model
    from repro_torch.utils import spans as recorder
    from repro_torch.utils.tree import tree_leaves

    changes = spec.get("changes", {})
    full_cfg = get_config(spec["arch"])
    cfg = dataclasses.replace(full_cfg, **changes)
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        device="cuda")
    n_params = sum(t.numel() for t in tree_leaves(params))
    prompt = input_specs.make_batch(cfg, spec["batch"], spec["prompt"],
                                    key=1, device="cuda")
    model.prefill = recorder.spanned("prefill")(model.prefill)
    model.decode_step = recorder.spanned("decode")(model.decode_step)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    L.reset_launches()
    recorder.enable()
    t0 = time.perf_counter()
    try:
        tokens = serve.generate_tokens(model, params, prompt,
                                       gen_len=spec["gen"])
        torch.cuda.synchronize()
    finally:
        recorder.disable()
    total_s = time.perf_counter() - t0
    launches = dict(L.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    drained = recorder.drain().spans
    spans = {k: [s.ms for s in drained if s.name == k]
             for k in ("prefill", "decode")}
    del model.prefill, model.decode_step
    prefill_repeat = _prefill_ms(model, params, prompt)
    MEASURED[name] = {"cfg": cfg, "batch": spec["batch"],
                      "prompt": spec["prompt"], "gen": spec["gen"],
                      "prefill_ms_repeat": prefill_repeat,
                      "decode_ms_per_token": sum(spans["decode"])
                      / len(spans["decode"])}
    want_launches = {k: spec["launches"].get(k, 0) for k in launches}
    check(launches == want_launches,
          f"{name}: one prefill launched {launches}, expected "
          f"{spec['launches']}")
    B, n = tokens.shape
    decode_s = sum(spans["decode"]) / 1e3
    out = {"phase": "serve", "path": name, "arch": cfg.name,
           "reduced": {k: [getattr(full_cfg, k), v]
                       for k, v in changes.items()} or False,
           "dtype": cfg.dtype, "n_params": n_params,
           "batch": B, "prompt_len": spec["prompt"], "gen_len": n,
           "prefill_ms": spans["prefill"][0],
           "prefill_ms_repeat": prefill_repeat,
           "decode_ms_per_token": sum(spans["decode"]) / n,
           "decode_ms_range": [min(spans["decode"]), max(spans["decode"])],
           "decode_tokens_per_s": B * n / decode_s,
           "generate_s": total_s, "tokens_per_s": B * n / total_s,
           "peak_gb": peak / 1e9, "launches": launches,
           "tokens_head": tokens[0, :8].tolist()}

    got = _teacher_forced(model, params, prompt, tokens)
    undo = _plain(spec["launches"])
    try:
        want = _teacher_forced(model, params, prompt, tokens)
    finally:
        undo()
    finite = bool(torch.isfinite(got).all()) and bool(
        torch.isfinite(want).all())
    out.update(prefill_logits_rel_err=_rel(got[0], want[0]),
               decode_logits_rel_err=_rel(got[1:], want[1:]),
               kernel_run_reproduces_its_tokens=bool(
                   (got[:-1].argmax(-1).T == tokens).all()),
               plain_run_token_agreement=float(
                   (want[:-1].argmax(-1).T == tokens).double().mean()),
               finite=finite, tolerance=SERVE_TOL)
    del got, want
    check(finite, f"{name}: non-finite logits")
    check(out["prefill_logits_rel_err"] <= SERVE_TOL,
          f"{name}: prefill logits differ from the plain run by "
          f"{out['prefill_logits_rel_err']} of their scale")
    check(out["decode_logits_rel_err"] <= SERVE_TOL,
          f"{name}: decode logits differ from the plain run by "
          f"{out['decode_logits_rel_err']} of their scale")
    toks = prompt["tokens"]
    full = None  # forward over the S tokens; it takes the plain path
    if spec["forward_tol"] is not None or spec.get("pallas_ssd"):
        with torch.no_grad():
            full = model.forward(params, prompt)
    if spec["forward_tol"] is not None:
        with torch.no_grad():
            caches = model.init_caches(
                B, serve.cache_len(cfg, toks.shape[1], 0), device="cuda")
            pre, caches = model.prefill(
                params, {**prompt, "tokens": toks[:, :-1]}, caches)
            dec, _ = model.decode_step(params, toks[:, -1:], caches)
        fwd = max(_rel(pre[:, 0], full[:, -2]), _rel(dec[:, 0], full[:, -1]))
        out["prefill_decode_vs_forward_rel_err"] = fwd
        check(fwd <= spec["forward_tol"],
              f"{name}: prefill + decode differ from forward by {fwd} of "
              f"their scale (limit {spec['forward_tol']})")
        del caches, pre, dec
    if spec.get("pallas_ssd"):  # the use_pallas_ssd forward, S tokens
        out.update(_pallas_ssd_forward(cfg, params, prompt, full))
        state = model.init_caches(B, 1, device="cuda").state
        out["decode_state_bytes_per_layer"] = (
            state[0].numel() * state.element_size())
    del full
    out["decode_trace"] = _decode_trace(name, model, params, prompt, tokens)
    emit(out)
    del model, params, prompt
    return launches


def _pallas_ssd_forward(cfg, params, batch, full):
    """``forward`` with ``use_pallas_ssd`` (every block's SSD term through
    the kernel) against the plain ``full``, within PALLAS_SSD_TOL (rtol =
    atol)."""
    from repro_torch.models import build_model

    pallas = build_model(dataclasses.replace(cfg, use_pallas_ssd=True))
    with torch.no_grad():
        got = pallas.forward(params, batch)
    excess = _excess((got,), (full,), PALLAS_SSD_TOL)
    out = {"pallas_ssd_forward_max_abs_err": _max_err((got,), (full,)),
           "pallas_ssd_forward_finite": bool(torch.isfinite(got).all())}
    check(out["pallas_ssd_forward_finite"] and excess <= PALLAS_SSD_TOL,
          f"{cfg.name}: the use_pallas_ssd forward differs from the plain "
          f"one beyond rtol = atol = {PALLAS_SSD_TOL}")
    return out


def phase_serve():
    """The serving path at full width, one path per entry of SERVE: S1
    fedlm-100m, S2 qwen3-1.7b, S3 mamba2-130m, S4 zamba2-1.2b, S5
    granite-moe-3b-a800m, S6 gemma-2b, S7 whisper-small, S8 llava-next-34b
    (4 of its 60 layers)."""
    gc.collect()
    torch.cuda.empty_cache()
    launches = {}
    for name, spec in SERVE.items():
        launches[name] = _serve_path(name, spec)
        gc.collect()
        torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------- roofline
#: the train paths whose rounds the roofline phase reads, and the serve
#: paths (every one of SERVE).
ROOFLINE_TRAIN = ("B_shift_q8_arena", MAMBA_PATH, "A_sharded")
MFU_MAX = 1.05     # a model-FLOPs share above this means a count is wrong


def _roofline_row(path, kind, cfg, shape, measured_s, tau=2):
    """The analytic cost of ``cfg`` at ``shape`` on one card (H100
    constants), beside the time the path measured: the model-FLOPs share
    ``<kind>_mfu`` = model FLOPs / (measured s x peak of cfg.dtype)."""
    from repro_torch.roofline import constants as RC
    from repro_torch.roofline.flops import cost_for

    cost = cost_for(cfg, shape, n_devices=1, tau=tau)
    peak = RC.peak_flops(cfg.dtype)
    compute_s = cost.flops_per_device / peak
    memory_s = cost.hbm_bytes_per_device / RC.HBM_BW
    key = {"train": "round_mfu"}.get(kind, f"{kind}_mfu")
    mfu = cost.model_flops_total / (measured_s * peak)
    row = {"phase": "roofline", "path": path, "kind": kind,
           "arch": cfg.name, "n_layers": cfg.n_layers, "dtype": cfg.dtype,
           "shape": dataclasses.asdict(shape), "tau": tau,
           "n_params": cost.n_params, "n_active_params": cost.n_active_params,
           "model_flops": cost.model_flops_total,
           "analytic_flops": cost.flops_per_device,
           "hbm_bytes": cost.hbm_bytes_per_device, "peak_flops": peak,
           "compute_s": compute_s, "memory_s": memory_s,
           "bottleneck": "compute" if compute_s >= memory_s else "memory",
           "measured_s": measured_s, key: mfu,
           "bound_share": max(compute_s, memory_s) / measured_s}
    emit(row)
    check(0.0 < mfu <= MFU_MAX,
          f"{path}: {key} {mfu} is outside (0, {MFU_MAX}]: a count is wrong")
    return row


def phase_roofline():
    """The port's cost model (``roofline/flops.py``) for the train paths B,
    M and A_sharded and the serve paths S1-S8 at their own configs, shapes
    and dtypes, against the times this run measured: the rounds' median
    but round 0's (it holds the warm-up), the median of the three repeated
    prefills, the mean decode step."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig

    for path in ROOFLINE_TRAIN:
        m = MEASURED[path]
        cfg, conf = get_config(m["arch"]), m["config"]
        shape = ShapeConfig(path, conf["seq_len"],
                            conf["n_clients"] * conf["batch"], "train")
        _roofline_row(path, "train", cfg, shape,
                      statistics.median(m["round_s"][1:]), tau=conf["tau"])
    for path in SERVE:
        m = MEASURED[path]
        _roofline_row(path, "prefill", m["cfg"],
                      ShapeConfig(path, m["prompt"], m["batch"], "prefill"),
                      statistics.median(m["prefill_ms_repeat"]) / 1e3)
        # the decode steps attend over prompt + 1 .. prompt + gen tokens
        _roofline_row(path, "decode", m["cfg"],
                      ShapeConfig(path, m["prompt"] + m["gen"] // 2,
                                  m["batch"], "decode"),
                      m["decode_ms_per_token"] / 1e3)


# ----------------------------------------------------------- sharded
SHARDED = ("S1_fedlm_100m", "S3_mamba2_130m")
SHARDED_STEPS = 8
SHARDED_TOL = 1e-5   # logits: max |sharded - unsharded| / max |unsharded|


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _sharded_path(name, mesh):
    """S1 / S3 at full width through ``lower_prefill`` / ``lower_decode``
    on ``mesh`` against the same weights and prompt served unsharded:
    prefill, then SHARDED_STEPS decode steps on the unsharded run's
    argmax tokens."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import INPUT_SHAPES, ShapeConfig
    from repro_torch.kernels import library as L
    from repro_torch.launch import input_specs, partition, serve
    from repro_torch.models import build_model

    spec = SERVE[name]
    cfg = get_config(spec["arch"])
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        device="cuda")
    B, S = spec["batch"], spec["prompt"]
    prompt = input_specs.make_batch(cfg, B, S, key=1, device="cuda")
    cap = serve.cache_len(cfg, S, SHARDED_STEPS)
    with torch.no_grad():
        logits, caches = model.prefill(
            params, prompt, model.init_caches(B, cap, device="cuda"))
        want, toks = [logits], []
        for _ in range(SHARDED_STEPS):
            toks.append(torch.argmax(want[-1][:, -1:], -1).to(torch.int32))
            logits, caches = model.decode_step(params, toks[-1], caches)
            want.append(logits)
    del caches
    INPUT_SHAPES[name + "_prefill"] = ShapeConfig(name, S, B, "prefill")
    INPUT_SHAPES[name + "_decode"] = ShapeConfig(name, cap, B, "decode")
    pre = serve.lower_prefill(cfg.name, mesh, shape_name=name + "_prefill",
                              cfg=cfg)
    dec = serve.lower_decode(cfg.name, mesh, shape_name=name + "_decode",
                             cfg=cfg)
    dparams = partition.distribute(params, pre.specs[0], mesh)
    torch.cuda.synchronize()
    L.reset_launches()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    (got, caches), coll = pre.run(dparams, prompt,
                                  model.init_caches(B, cap, device="cuda"))
    end.record()
    torch.cuda.synchronize()
    launches = dict(L.LAUNCHES)
    got_all, coll_bytes = [got.to_local()], coll["total_bytes"]
    for tok in toks:
        (g, caches), coll = dec.run(dparams, tok, caches)
        got_all.append(g.to_local())
        coll_bytes += coll["total_bytes"]
    torch.cuda.synchronize()
    want_launches = {k: spec["launches"].get(k, 0) for k in launches}
    out = {"phase": "sharded", "path": name, "arch": cfg.name,
           "mesh": "1x1", "backend": "nccl", "batch": B, "prompt_len": S,
           "decode_steps": SHARDED_STEPS, "prefill_ms": start.elapsed_time(
               end), "prefill_launches": launches,
           "prefill_logits_rel_err": _rel(got_all[0], want[0]),
           "decode_logits_rel_err": max(_rel(g, w) for g, w in
                                        zip(got_all[1:], want[1:])),
           "collective_bytes": coll_bytes,
           "placements_embed": str(dparams["embed"].placements),
           "finite": all(bool(torch.isfinite(g).all()) for g in got_all),
           "tolerance": SHARDED_TOL}
    emit(out)
    check(launches == want_launches,
          f"{name} sharded: one prefill launched {launches}, expected "
          f"{spec['launches']}")
    check(out["finite"], f"{name} sharded: non-finite logits")
    check(out["prefill_logits_rel_err"] <= SHARDED_TOL
          and out["decode_logits_rel_err"] <= SHARDED_TOL,
          f"{name} sharded: logits differ from the unsharded run: {out}")
    check(coll_bytes == 0, f"{name} sharded: {coll_bytes} collective bytes "
                           f"on one rank")
    return launches


#: the sharded train paths: (path whose scenario they take, the launches
#: of one round).
SHARDED_TRAIN = {
    "A_sharded": ("A_dense", {"fedcet_v": 24, "fedcet_comm": 12}),
    "C_sharded": ("C_shift_q8_per_leaf_p0.75",
                  {"fedcet_v": 24, "fedcet_comm4": 12,
                   "stochastic_quantize": 12}),
}
SHARDED_ROUNDS = 3
SHARDED_TRAIN_TOL = 1e-6  # x, d: max |sharded - unsharded| / max |x leaf|


def _sharded_train_path(name, mesh):
    """fedlm-100m at full width through ``launch/train.py``'s lowered
    round on ``mesh`` against the unsharded engine: the same init state
    and batches, SHARDED_ROUNDS rounds each."""
    from repro_torch.configs.base import INPUT_SHAPES, FedScenario, ShapeConfig
    from repro_torch.data.synthetic import make_hetero_lm_dataset
    from repro_torch.kernels import library as L
    from repro_torch.launch import partition, train
    from repro_torch.launch.train import mean_client_loss
    from repro_torch.models import build_model
    from repro_torch.utils.tree import tree_leaves, tree_map

    base, per_round = SHARDED_TRAIN[name]
    nc, batch, seq, tau = (TRAIN[k] for k in ("n_clients", "batch",
                                               "seq_len", "tau"))
    INPUT_SHAPES[name] = ShapeConfig(name, seq, nc * batch, "train")
    plan = train.make_plan("fedlm-100m", mesh, shape_name=name, tau=tau,
                           alpha=ALPHA, c=C, dtype="float32",
                           scenario=FedScenario(**PATHS[base][0]))
    # the reference's own test does the same: more clients than the 1 x 1
    # mesh's one, all on its one rank
    plan = dataclasses.replace(plan, n_clients=nc, per_client_batch=batch,
                               algo=dataclasses.replace(plan.algo,
                                                        n_clients=nc))
    model = build_model(plan.cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        device="cuda")
    unsharded = dataclasses.replace(plan.algo, spmd_client_axes=())
    ds = make_hetero_lm_dataset(plan.cfg.vocab_size, nc, seq, batch,
                                heterogeneity=0.8, seed=0, device="cuda")
    grad_fn = torch.func.grad(model.loss)
    client_losses = torch.func.vmap(model.loss)
    state = unsharded.init(grad_fn, params,
                           {"tokens": ds.sample_round(0, tau)[0]})
    del params
    want = tree_map(lambda t: t.clone() if isinstance(t, torch.Tensor)
                    else t, state)
    low = train.lower_train_step(plan)
    got = partition.distribute(state, low.specs[0], mesh)
    del state
    rounds = [{"tokens": ds.sample_round(r, tau)} for r in
              range(SHARDED_ROUNDS)]
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    L.reset_launches()
    round_s, losses, coll_bytes = [], [], 0
    for b in rounds:
        t0 = time.perf_counter()
        got, coll = low.run(got, b)
        torch.cuda.synchronize()
        round_s.append(time.perf_counter() - t0)
        coll_bytes += coll["total_bytes"]
        x = tree_map(lambda t: t.full_tensor(), unsharded.client_params(got))
        losses.append(float(mean_client_loss(client_losses, x, b)))
    launches = dict(L.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    unsharded_s = []
    for b in rounds:
        t0 = time.perf_counter()
        want = unsharded.round(grad_fn, want, b)
        torch.cuda.synchronize()
        unsharded_s.append(time.perf_counter() - t0)
    gaps = {"x": 0.0, "d": 0.0}
    gi, wi = unsharded._inner(got), unsharded._inner(want)
    for xg, xw, dg, dw in zip(tree_leaves(gi.x), tree_leaves(wi.x),
                              tree_leaves(gi.d), tree_leaves(wi.d)):
        scale = float(xw.abs().max())
        gaps["x"] = max(gaps["x"], float((xg.full_tensor() - xw).abs().max())
                        / scale)
        gaps["d"] = max(gaps["d"], float((dg.full_tensor() - dw).abs().max())
                        / scale)
    bitwise = all(torch.equal(a.full_tensor(), b) for a, b in zip(
        tree_leaves((gi.x, gi.d)), tree_leaves((wi.x, wi.d))))
    want_launches = {k: SHARDED_ROUNDS * per_round.get(k, 0)
                     for k in launches}
    out = {"phase": "sharded", "path": name, "scenario": PATHS[base][0],
           "arch": plan.cfg.name, "dtype": plan.cfg.dtype, "mesh": "1x1",
           "backend": "nccl", "n_clients": nc, "batch": batch,
           "seq_len": seq, "tau": tau, "rounds": SHARDED_ROUNDS,
           "round_s": round_s, "unsharded_round_s": unsharded_s,
           "loss": losses, "launches": launches,
           "state_gap_over_x_scale": gaps, "bitwise": bitwise,
           "collective_bytes": coll_bytes,
           "placements_x_embed": str(gi.x["embed"].placements),
           "max_memory_allocated_bytes": peak,
           "tolerance": SHARDED_TRAIN_TOL}
    emit(out)
    check(launches == want_launches,
          f"{name}: {SHARDED_ROUNDS} rounds launched {launches}, expected "
          f"{want_launches}")
    check(all(math.isfinite(v) for v in losses), f"{name}: loss {losses}")
    check(max(gaps.values()) <= SHARDED_TRAIN_TOL,
          f"{name}: x, d differ from the unsharded rounds: {gaps}")
    check(coll_bytes == 0, f"{name}: {coll_bytes} collective bytes on one "
                           f"rank")
    MEASURED[name] = {"arch": plan.cfg.name, "round_s": round_s,
                      "config": {"n_clients": nc, "batch": batch,
                                 "seq_len": seq, "tau": tau}}
    return launches


#: the mesh path's per-client gradients against the same clients'
#: ``torch.autograd.grad`` on plain tensors and against the vmapped
#: gradients (fedlm-100m, float32, TF32 off): max |a - b| / max |the leaf's
#: vmapped gradient| over the leaves. Twice the H100's readings, which
#: repeat exactly: 1.530e-6 and 7.182e-6 (PERF.md).
GRAD_PATH_TOL = {"dtensor_vs_autograd": 3e-6, "dtensor_vs_vmapped": 1.5e-5}


def _per_client_grad_check(mesh):
    """``core/api.py:per_client_grads``, the mesh path's gradients (each
    client's rows as DTensors on the one-rank ``model`` sub-mesh, through
    ``spmd_grad``'s ``torch.autograd.grad`` under the lowered step's
    layouts), at A_sharded's plan, against three plain (no DTensor) ways:
    the vmapped ``torch.func.grad`` a one-rank sub-mesh takes, the same a
    client at a time, and ``torch.autograd.grad`` a client at a time. The
    gaps between neighbours name the step that moves the sums: batching,
    the gradient transform, DTensor. The clients share seed 0's weights
    and take round 0's first batch."""
    from torch.distributed.tensor.experimental import implicit_replication
    from torch.utils import _pytree as pytree

    from repro_torch.configs.base import INPUT_SHAPES, ShapeConfig
    from repro_torch.core.api import (per_client_grads, replicate, spmd_grad,
                                      vmap_grads)
    from repro_torch.data.synthetic import make_hetero_lm_dataset
    from repro_torch.launch import partition, train
    from repro_torch.models import build_model
    from repro_torch.utils.sharding_ctx import activation_sharding
    from repro_torch.utils.tree import tree_leaves, tree_map

    nc, batch, seq, tau = (TRAIN[k] for k in ("n_clients", "batch",
                                               "seq_len", "tau"))
    INPUT_SHAPES["grad_paths"] = ShapeConfig("grad_paths", seq, nc * batch,
                                             "train")
    plan = train.make_plan("fedlm-100m", mesh, shape_name="grad_paths",
                           tau=tau, alpha=ALPHA, c=C, dtype="float32")
    plan = dataclasses.replace(plan, n_clients=nc, per_client_batch=batch,
                               algo=dataclasses.replace(plan.algo,
                                                        n_clients=nc))
    low = train.lower_train_step(plan)
    model = build_model(plan.cfg)
    x = replicate(model.init(torch.Generator(device="cuda").manual_seed(0),
                             device="cuda"), nc)
    ds = make_hetero_lm_dataset(plan.cfg.vocab_size, nc, seq, batch,
                                heterogeneity=0.8, seed=0, device="cuda")
    b = {"tokens": ds.sample_round(0, tau)[0]}
    one = torch.func.grad(model.loss)
    times = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times[name] = (time.perf_counter() - t0) * 1e3
        return out

    def autograd_one(p, bb):
        leaves, tdef = pytree.tree_flatten(p)
        leaves = [t.detach().requires_grad_(True) for t in leaves]
        with torch.enable_grad():
            out = model.loss(pytree.tree_unflatten(leaves, tdef), bb)
            return pytree.tree_unflatten(
                list(torch.autograd.grad(out, leaves)), tdef)

    def each(fn):
        return tree_map(lambda *gs: torch.stack(gs), *[
            fn(tree_map(lambda t: t[i], x), {"tokens": b["tokens"][i]})
            for i in range(nc)])

    vm = timed("vmapped_ms", lambda: vmap_grads(one)(x, b))
    plain = timed("plain_ms", lambda: each(one))
    auto = timed("autograd_ms", lambda: each(autograd_one))
    spec = low.specs[0]
    dx = partition.distribute(x, getattr(spec, "inner", spec).x, mesh)
    db = partition.distribute(b, partition.batch_shardings(
        b, mesh, dim_axes=(plan.client_axes, train._fsdp(plan))), mesh)
    with activation_sharding(residual=low.residual, logits=low.logits,
                             moe_shards=low.moe), implicit_replication():
        dt = timed("dtensor_ms", lambda: per_client_grads(
            spmd_grad(model.loss), dx, db, plan.client_axes))
    placements = str(tree_leaves(dt)[0].placements)
    dt = tree_map(lambda t: t.full_tensor(), dt)

    def gap(a, c):
        return max(float((u - v).abs().max()) / float(w.abs().max())
                   for u, v, w in zip(tree_leaves(a), tree_leaves(c),
                                      tree_leaves(vm)))

    def same(a, c):
        return all(torch.equal(u, v) for u, v in
                   zip(tree_leaves(a), tree_leaves(c)))

    pairs = {"plain_vs_vmapped": (plain, vm),
             "autograd_vs_plain": (auto, plain),
             "dtensor_vs_autograd": (dt, auto),
             "dtensor_vs_vmapped": (dt, vm)}
    gaps = {k: gap(*v) for k, v in pairs.items()}
    out = {"phase": "sharded", "path": "grad_paths", "arch": plan.cfg.name,
           "dtype": plan.cfg.dtype, "mesh": "1x1", "backend": "nccl",
           "n_clients": nc, "batch": batch, "seq_len": seq,
           "tf32": torch.backends.cuda.matmul.allow_tf32,
           "placements_grad": placements, "gap_over_grad_scale": gaps,
           "bitwise": {k: same(*v) for k, v in pairs.items()},
           **times, "tolerance": GRAD_PATH_TOL}
    emit(out)
    check(all(math.isfinite(v) for v in gaps.values()),
          f"grad_paths: non-finite gradients: {gaps}")
    for k, tol in GRAD_PATH_TOL.items():
        check(gaps[k] <= tol,
              f"grad_paths: {k} {gaps[k]} above {tol}")


def phase_sharded():
    """S1 and S3 through the sharded serving steps, and the train round
    under A's and C's scenarios through the lowered train step, on a real
    one-rank NCCL process group and a 1 x 1 ("data", "model") mesh on the
    card."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_test_mesh

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{_free_port()}", world_size=1, rank=0)
    try:
        mesh = make_test_mesh((1, 1))
        launches = {}
        for name in SHARDED:
            launches[name + "_sharded"] = _sharded_path(name, mesh)
            gc.collect()
            torch.cuda.empty_cache()
        for name in SHARDED_TRAIN:
            launches[name] = _sharded_train_path(name, mesh)
            gc.collect()
            torch.cuda.empty_cache()
        _per_client_grad_check(mesh)
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    return launches


# ------------------------------------------------------------ dryrun
#: (arch, shape) cells of the dry run, full width, 16 x 16, bfloat16.
DRYRUN_CELLS = (("qwen3-1.7b", "prefill_32k"), ("qwen3-1.7b", "decode_32k"),
                ("granite-moe-3b-a800m", "prefill_32k"),
                ("mamba2-130m", "long_500k"),
                ("llama4-scout-17b-a16e", "decode_32k"),
                ("qwen3-1.7b", "train_4k"),
                ("llama4-scout-17b-a16e", "train_4k"))
#: the train cells' temp a device without activation checkpointing (this
#: script's dryrun phase on the card's host before ``models/remat.py``), GB
DRYRUN_TEMP_BEFORE_REMAT_GB = {"qwen3-1.7b": 165.0,
                               "llama4-scout-17b-a16e": 1058.0}
DRYRUN_SCRIPT = r"""
import json, sys
from repro_torch.launch import dryrun, partition, serve, train
from repro_torch.launch.mesh import (axis_size, fake_world,
                                     make_production_mesh)

cells = json.loads(sys.argv[1])
with fake_world(256):
    for arch, shape in cells:
        rec = dryrun.run_one(arch, shape, multi_pod=False)
        mesh = make_production_mesh()
        if shape == "train_4k":
            low = train.lower_train_step(train.make_plan(arch, mesh),
                                         donate=False)
            mesh = low.plan.mesh
        else:
            low = (serve.lower_prefill if "prefill" in shape
                   else serve.lower_decode)(arch, mesh, shape_name=shape)
        want = 0  # the local shards' bytes, from the specs' arithmetic
        for tree, specs in zip(low.abstract, low.specs):
            for (_, leaf), spec in zip(partition._leaves(tree)[0],
                                       partition.spec_leaves(specs)):
                if spec is None:
                    continue
                n = leaf.numel()
                for ax in spec:
                    for a in (ax if isinstance(ax, tuple)
                              else (ax,) if ax else ()):
                        n //= axis_size(mesh, a)
                want += n * leaf.element_size()
        rec["argument_bytes_from_specs"] = want
        print("DRYRUN " + json.dumps(rec), flush=True)
"""


def phase_dryrun():
    """The dry run's cells on this machine's host, in a process of its own
    with no card visible: a fake world of 256 ranks never meets the real
    process group, and nothing touches the card."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-c", DRYRUN_SCRIPT,
                          json.dumps(DRYRUN_CELLS)], capture_output=True,
                         text=True, timeout=600, env=env, cwd=ROOT)
    check(res.returncode == 0, f"dry run failed:\n{res.stderr[-4000:]}")
    recs = [json.loads(line[len("DRYRUN "):])
            for line in res.stdout.splitlines() if line.startswith("DRYRUN ")]
    check(len(recs) == len(DRYRUN_CELLS), f"dry run gave {len(recs)} records")
    for rec in recs:
        rl = rec.get("roofline", {})
        emit({"phase": "dryrun", "arch": rec["arch"], "shape": rec["shape"],
              "mesh": rec["mesh"], "status": rec["status"],
              "lower_s": rec.get("lower_s"), "trace_s": rec.get("trace_s"),
              "memory": rec.get("memory"),
              "argument_bytes_from_specs": rec["argument_bytes_from_specs"],
              "collectives": rl.get("collective_detail", {}).get(
                  "bytes_by_kind"),
              "collective_counts": rl.get("collective_detail", {}).get(
                  "count_by_kind"),
              "compute_s": rl.get("compute_s"), "memory_s": rl.get("memory_s"),
              "collective_s": rl.get("collective_s"),
              "bottleneck": rl.get("bottleneck"),
              "constants": "H100 SXM data sheet",
              **({"temp_gb": rec["memory"]["temp_bytes"] / 1e9,
                  "temp_gb_before_remat": DRYRUN_TEMP_BEFORE_REMAT_GB[
                      rec["arch"]]} if rec["shape"] == "train_4k" else {})})
        check(rec["status"] == "ok", f"dry run {rec['arch']} x "
                                     f"{rec['shape']}: {rec}")
        check(rec["memory"]["argument_bytes"]
              == rec["argument_bytes_from_specs"],
              f"dry run {rec['arch']} x {rec['shape']}: argument bytes "
              f"{rec['memory']['argument_bytes']} are not the local shards' "
              f"{rec['argument_bytes_from_specs']}")
        if rec["shape"] == "train_4k":
            check(rec["memory"]["temp_bytes"] / 1e9
                  < DRYRUN_TEMP_BEFORE_REMAT_GB[rec["arch"]],
                  f"dry run {rec['arch']} x train_4k: temp "
                  f"{rec['memory']['temp_bytes'] / 1e9} GB, not below the "
                  f"{DRYRUN_TEMP_BEFORE_REMAT_GB[rec['arch']]} GB it held "
                  "without activation checkpointing")
    emit({"phase": "dryrun", "cells": len(recs),
          "seconds": time.perf_counter() - t0})


#: the path whose run each kernel's summary launch count comes from.
OWNER = {"fedcet_v": "B_shift_q8_arena", "fedcet_comm": "A_dense",
         "fedcet_comm4": "C_shift_q8_per_leaf_p0.75",
         "stochastic_quantize": "C_shift_q8_per_leaf_p0.75",
         "stochastic_quantize_rows": "D_q8_arena",
         "fedcet_round_tail": "B_shift_q8_arena",
         "gossip_reduce": "E_ring_sparse_arena",
         "telemetry_sketch": TELEMETRY_PATH,
         "flash_attention": "S1_fedlm_100m",
         "ssd_intra": "S3_mamba2_130m",
         "threefry_uniform_rows": "B_shift_q8_arena"}


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
    phase_staleness()
    phase_cohort()
    phase_parity()
    phase_prng()
    paths = phase_fig1()
    paths.update(phase_train())
    phase_plans()
    paths.update(phase_trainer())
    paths.update(phase_serve())
    paths.update(phase_sharded())
    phase_roofline()
    phase_dryrun()
    summary = []
    for form, (src, replaces) in KERNELS.items():
        k = kernels[form]
        routes = {f"{c['case']}/{c['dtype']}": c["route"]
                  for c in k["checks"] if "route" in c}
        summary.append({
            "name": form, "route": "cuda", "source": SRC + src,
            "replaces": replaces, "launches": paths[OWNER[form]][form],
            "max_abs_err": k["max_abs_err"], "ms": k["ms"],
            "device_ms": k["device_ms"],
            "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"], "library_ms": k["library_ms"],
            "library_device_ms": k["library_device_ms"],
            "launches_by_path": {p: n.get(form, 0)
                                 for p, n in paths.items()},
            **({"routes": routes} if routes else {})})
    check(all(s["launches"] > 0 for s in summary),
          f"a kernel form has no launch on its path: {summary}")
    emit({"phase": "done", "seconds": time.perf_counter() - t0})
    emit({"kernels": summary})
    print(smi)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
