"""Federated LM training driver, single host (port of
``src/repro/launch/train.py``: ``run_training`` and ``main``).

FedCET (Algorithm 2) on a real model: every client holds a replica and a
heterogeneous token stream, takes ``tau - 1`` local steps and one
aggregating step per round, and the FedCET update runs through the
port's CUDA kernels on the card. It prints the reference's per-round
lines (``round … loss … bits_up … active_clients …``), with ``bits_up``
billed bit-true from the attached compressor and topology
(``core/comm.py``: gossip bills one message per directed edge, a
hierarchy its aggregator tiers).

The synchronous round takes five scenario options of the reference:
``compression`` (a ``core/compressors.py`` spec: ``shift:q8``, ``q8``,
``pq8``), ``participation``, ``arena``, ``topology`` (a
``core/topology.py`` spec: ``hier:g8``, ``ring``, ``ring:sparse``,
``torus``, ``er:0.4:t``) and ``tier_compression``, composed by
``configs/base.py:FedScenario``. The others (delay, cohort, compression
plans, telemetry, tracing, checkpoints) raise "not yet ported" when set to
anything but their default. The mesh launcher (``make_plan``,
``lower_train_step``) waits for a multi-GPU slice.

Run as a script:
    python -m repro_torch.launch.train --arch fedlm-100m --full --steps 5 \
        --compression shift:q8 --arena
    python -m repro_torch.launch.train --arch fedlm-100m --full --steps 5 \
        --clients 8 --batch 4 --topology ring:sparse --arena
"""

from __future__ import annotations

import time

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.configs.base import FedScenario
from repro_torch.core.comm import comm_bits_per_round, leaf_info_of
from repro_torch.core.fedcet import FedCET
from repro_torch.data.synthetic import make_hetero_lm_dataset
from repro_torch.models import build_model
from repro_torch.utils.tree import tree_map, tree_num_params

#: the reference's scenario options and their defaults.
SCENARIO_DEFAULTS = {
    "compression": "none", "compression_plan": "none", "plan_adapt": 0.0,
    "participation": 1.0, "delay": "none", "stale_policy": "last",
    "topology": "star", "tier_compression": "none", "cohort": "none",
    "arena": False, "telemetry": None, "trace_rounds": None,
    "ckpt_dir": None,
}
#: the options this slice runs; the others accept their default only.
PORTED = ("compression", "participation", "arena", "topology",
          "tier_compression")


def run_training(arch: str, *, steps: int = 100, tau: int = 2,
                 n_clients: int = 4, batch: int = 8, seq_len: int = 128,
                 alpha: float = 3e-3, c: float = 0.05,
                 heterogeneity: float = 0.8, reduced: bool = True,
                 seed: int = 0, device=None, log_every: int = 10,
                 callback=None, **scenario) -> dict:
    """End-to-end FedCET LM training on ``device`` (``cuda`` unless the
    caller passes another; with no card and no explicit device it raises).

    ``scenario`` takes ``compression``, ``participation``, ``arena``,
    ``topology`` and ``tier_compression`` (see the module docstring); the
    reference's other options raise "not yet ported" unless at their
    default.

    Returns the history ``{"round", "loss", "comm_bytes", "seconds"}`` of
    the logged rounds (every ``log_every``-th and the last) and the model's
    ``n_params``: ``loss`` is the mean client loss on the round's first
    batch after the round, as in the reference; ``comm_bytes`` the
    cumulative bit-true bytes up and down; ``seconds`` the round's
    host-clock time, measured after the device has finished it.
    ``callback(round, loss, comm_bytes, state)`` runs after each logged
    round."""
    for k, v in scenario.items():
        if k not in SCENARIO_DEFAULTS:
            raise TypeError(f"run_training() got an unexpected option {k!r}")
        if k not in PORTED and v != SCENARIO_DEFAULTS[k]:
            raise NotImplementedError(
                f"{k}={v!r} is not yet ported to PyTorch (the port runs "
                f"the synchronous round: {k}={SCENARIO_DEFAULTS[k]!r})")
    ported = {k: scenario.get(k, SCENARIO_DEFAULTS[k]) for k in PORTED}
    device = resolve_device(device)
    if device.type == "cuda":
        # full-float32 matmuls: what the reference computes on its CPU path.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    model = build_model(cfg)
    params = model.init(torch.Generator(device=device).manual_seed(seed),
                        device=device)
    algo = FedScenario(**ported, seed=seed).apply(
        FedCET(alpha=alpha, c=c, tau=tau, n_clients=n_clients))
    ds = make_hetero_lm_dataset(cfg.vocab_size, n_clients, seq_len, batch,
                                heterogeneity=heterogeneity, seed=seed,
                                device=device)
    grad_fn = torch.func.grad(model.loss)
    client_losses = torch.func.vmap(model.loss)

    def batches_for(r):
        return {"tokens": ds.sample_round(r, tau)}  # [tau, C, B, S]

    state = algo.init(grad_fn, params,
                      tree_map(lambda b: b[0], batches_for(0)))
    n_params = tree_num_params(params)
    bits = comm_bits_per_round(algo, n_params, n_clients,
                               leaf_info_of(params))
    bytes_per_round = int(bits["up_bits"] / 8) + int(bits["down_bits"] / 8)
    # the expected participant count, as the reference prints without
    # telemetry.
    active = int(round(n_clients * min(ported["participation"], 1.0)))

    history = {"round": [], "loss": [], "comm_bytes": [], "seconds": [],
               "n_params": n_params}
    for r in range(steps):
        b = batches_for(r)
        _sync(device)
        t0 = time.perf_counter()
        state = algo.round(grad_fn, state, b)
        _sync(device)
        seconds = time.perf_counter() - t0
        with torch.no_grad():
            loss = float(torch.mean(client_losses(
                algo.client_params(state),
                tree_map(lambda a: a[0], b))))
        if r % log_every == 0 or r == steps - 1:
            print(f"round {r:5d}  loss {loss:.4f}  "
                  f"bits_up {(r + 1) * bits['up_bits']:.4g}  "
                  f"active_clients {active}")
            comm = (r + 1) * bytes_per_round
            history["round"].append(r)
            history["loss"].append(loss)
            history["comm_bytes"].append(comm)
            history["seconds"].append(seconds)
            if callback:
                callback(r, loss, comm, state)
    return history


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--tau", type=int, default=2)
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--alpha", type=float, default=3e-3)
    ap.add_argument("--full", action="store_true",
                    help="use the full (non-reduced) architecture")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu; without a card the "
                         "default raises instead of falling back")
    ap.add_argument("--log-every", type=int, default=10,
                    help="print a per-round summary line every k rounds")
    ap.add_argument("--compression", default="none",
                    help="uplink compressor spec: none | q8 | pq8 | shift:q8")
    ap.add_argument("--participation", type=float, default=1.0,
                    help="per-round Bernoulli client participation rate")
    ap.add_argument("--arena", action="store_true",
                    help="pack the client store into the contiguous "
                         "[clients, rows, 1024] parameter arena (fused "
                         "round tail under shift:q<b> on the star)")
    ap.add_argument("--topology", default="star",
                    help="aggregation geometry: star | hier:g8 | hier:16x4 "
                         "| ring | torus | er:0.4 (gossip specs take a "
                         "trailing :sparse for the padded neighbor-exchange "
                         "lowering, e.g. ring:sparse, er:0.4:t:sparse)")
    ap.add_argument("--tier-compression", default="none",
                    help="hierarchies only: compressor spec for interior "
                         "edge->root tier uplinks (e.g. shift:q8)")
    for k, v in SCENARIO_DEFAULTS.items():
        if k in PORTED:
            continue
        ap.add_argument("--" + k.replace("_", "-"), default=v,
                        type=type(v) if v is not None else None,
                        help="not yet ported: only the default is accepted")
    args = vars(ap.parse_args(argv))
    scenario = {k: args.pop(k) for k in SCENARIO_DEFAULTS}
    hist = run_training(
        args["arch"], steps=args["steps"], tau=args["tau"],
        n_clients=args["clients"], batch=args["batch"],
        seq_len=args["seq_len"], alpha=args["alpha"],
        reduced=not args["full"], device=args["device"],
        log_every=args["log_every"], **scenario)
    print("final loss:", hist["loss"][-1])


if __name__ == "__main__":
    main()
