"""Federated LM training: the single-host driver and the production
train step on a mesh (port of ``src/repro/launch/train.py``).

FedCET (Algorithm 2) on a real model: every client holds a replica and a
heterogeneous token stream, takes ``tau - 1`` local steps and one
aggregating step per round, and the FedCET update runs through the
port's CUDA kernels on the card. It prints the reference's per-round
lines (``round … loss … bits_up … active_clients …``), with ``bits_up``
billed bit-true from the attached compressor and topology
(``core/comm.py``: gossip bills one message per directed edge, a
hierarchy its aggregator tiers).

The round takes the reference's ``compression`` (a
``core/compressors.py`` spec: ``shift:q8``, ``q8``, ``randk:0.25``,
``ef:topk:0.3+bf16``, ...) or ``compression_plan`` (per-leaf
``pattern:spec`` rules, ``embed*:q12,ln*:bf16,*:shift:q6``, or a ready
``CompressionPlan``, billed exactly per leaf) with ``plan_adapt`` (> 1:
tighten the plan one step each time telemetry's ``compress_err`` shrinks
by that factor, swapped in at a segment boundary with the state carried
over; needs ``telemetry``), ``participation``, ``arena``, ``topology`` (a
``core/topology.py`` spec: ``hier:g8``, ``ring``, ``ring:sparse``,
``torus``, ``er:0.4:t``) and ``tier_compression``, composed by
``configs/base.py:FedScenario``, and its
in-round telemetry (``telemetry``, a ``core/telemetry.py`` sink spec such
as ``jsonl:run.jsonl,hist:48``) with the profiler window
(``trace_rounds``, ``trace_dir``). With ``ckpt_dir`` the full round state
is saved every 50 rounds (``checkpoint/ckpt.py``, the reference's
``.npz`` layout; like the reference, the run saves and does not resume:
``fed/trainer.py:FedTrainer.maybe_resume`` resumes). Random draws take
float32 / int32, the reference's dtypes on this entry point (it runs with
``jax_enable_x64`` off).

The production train step (``make_plan``, ``state_shardings``,
``abstract_state``, ``build_round_fn``, ``lower_train_step``) is the
FedCET round over a ``DeviceMesh`` (``launch/{mesh,partition}.py``):

  * clients laid out along the ("pod", "data") mesh axes (one model
    replica and one heterogeneous data shard per client), the algorithm's
    ``spmd_client_axes``: each rank computes its own clients' gradients;
  * each replica tensor-parallel over "model" (the partition rules), with
    an "fsdp" split of the data axis for the archs of
    ``launch/overrides.py``;
  * sequence-sharded residual activations (``utils/sharding_ctx.py``);
  * the FedCET kernels on the local shards (``kernels/ops.py``), and the
    client mean the one reduction across the client axes, once per tau
    gradient steps.

``LoweredTrain.trace()`` runs one round on fake local shards (the dry
run, ``launch/dryrun.py``); ``.run()`` runs it on real DTensors.

Run as a script:
    python -m repro_torch.launch.train --arch fedlm-100m --full --steps 5 \
        --compression shift:q8 --arena
    python -m repro_torch.launch.train --arch fedlm-100m --full --steps 5 \
        --compression shift:q8 --arena --delay rr:2 --stale-policy last
    python -m repro_torch.launch.train --arch fedlm-100m --full --steps 5 \
        --clients 16 --batch 4 --cohort block:4 --compression shift:q8 --arena
    python -m repro_torch.launch.train --arch fedlm-100m --steps 100 \
        --device cpu --ckpt-dir ckpts
    python -m repro_torch.launch.train --arch fedlm-100m --full --steps 5 \
        --clients 8 --batch 4 --topology ring:sparse --arena \
        --telemetry jsonl:run.jsonl,hist:48 --trace-rounds 3:4
    python -m repro_torch.launch.train --arch fedlm-100m --steps 20 \
        --device cpu --compression-plan "embed*:q12,ln*:bf16,*:shift:q6" \
        --plan-adapt 10 --telemetry csv:m.csv
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import torch

from repro_torch import resolve_device
from repro_torch.checkpoint.ckpt import save
from repro_torch.configs import get_config
from repro_torch.configs.base import INPUT_SHAPES, ArchConfig, FedScenario
from repro_torch.core import telemetry as tele
from repro_torch.core.api import spmd_grad
from repro_torch.core.comm import CommMeter, comm_bits_per_round, leaf_info_of
from repro_torch.core.compressors import AdaptivePlan, CompressionPlan
from repro_torch.core.engine import (EngineState, make_round_runner,
                                     scan_segments)
from repro_torch.core.fedcet import FedCET, FedCETState
from repro_torch.core.staleness import DelayState
from repro_torch.core.topology import TopoState
from repro_torch.data.synthetic import make_hetero_lm_dataset
from repro_torch.launch import input_specs as ispec
from repro_torch.launch import partition
from repro_torch.launch.mesh import axis_size, client_axes, n_clients, tp_size
from repro_torch.models import build_model
from repro_torch.roofline.comm_count import CollectiveCounter
from repro_torch.utils.sharding_ctx import activation_sharding, resolve_partial
from repro_torch.utils.tree import tree_map

#: the reference's scenario options and their defaults.
SCENARIO_DEFAULTS = {
    "compression": "none", "compression_plan": "none", "plan_adapt": 0.0,
    "participation": 1.0, "delay": "none", "stale_policy": "last",
    "topology": "star", "tier_compression": "none", "cohort": "none",
    "arena": False, "telemetry": None, "trace_rounds": None,
    "trace_dir": "profile_trace", "ckpt_dir": None,
}
#: rounds between the checkpoints of a run with ``ckpt_dir``.
CKPT_EVERY = 50


def run_training(arch: str, *, steps: int = 100, tau: int = 2,
                 n_clients: int = 4, batch: int = 8, seq_len: int = 128,
                 alpha: float = 3e-3, c: float = 0.05,
                 heterogeneity: float = 0.8, reduced: bool = True,
                 seed: int = 0, device=None, log_every: int = 10,
                 callback=None, **scenario) -> dict:
    """End-to-end FedCET LM training on ``device`` (``cuda`` unless the
    caller passes another; with no card and no explicit device it raises).

    ``scenario`` takes ``compression``, ``compression_plan``,
    ``plan_adapt``, ``participation``, ``delay``, ``stale_policy``,
    ``cohort``, ``arena``, ``topology``, ``tier_compression``,
    ``telemetry``, ``trace_rounds``, ``trace_dir`` and ``ckpt_dir`` (see
    the module docstring). With
    ``plan_adapt > 1`` an ``AdaptivePlan`` reads the last round's
    ``compress_err`` at each segment end; when it tightens, the new plan
    replaces the attached one, the runner is rebuilt and the state carries
    over unchanged (a ``plan_adapt`` event goes to the sinks).

    The rounds run through ``engine.make_round_runner`` in segments that
    end at every logged round, at the edges of the ``trace_rounds``
    window and, with ``ckpt_dir``, at every 50th round, after which the
    state is saved as ``step_<rounds done>.npz`` (the three newest
    kept). ``telemetry`` is a sink spec (``jsonl:<path>``, ``csv:<path>``,
    ``stdout[:k]``, ``memory``, comma-chained; ``hist[:bins[:lo:hi]]`` /
    ``topk[:k]`` turn on the per-client ``||d_i||`` and drift sketches,
    ``leafstats`` the per-leaf breakdown): any non-empty spec attaches the
    in-round telemetry, emits the run manifest first and drains each
    segment's series (with the loss merged in) into the sinks, once per
    segment; the per-round line then prints the in-round participant
    count. ``trace_rounds`` (``"a:b"`` or ``"a"``) brackets that window
    with ``torch.profiler`` and writes a Chrome trace under ``trace_dir``.

    Returns the history ``{"round", "loss", "comm_bytes", "seconds"}`` of
    the logged rounds (every ``log_every``-th and the last) and the model's
    ``n_params``: ``loss`` is the mean client loss on the round's first
    batch after the round, as in the reference; ``comm_bytes`` the
    cumulative bit-true bytes up and down (``CommMeter``); ``seconds`` the
    host-clock time per round of the logged round's segment (the rounds,
    their losses and telemetry), measured after the device has finished
    it. ``callback(round, loss, comm_bytes, state)`` runs after each
    logged round."""
    for k in scenario:
        if k not in SCENARIO_DEFAULTS:
            raise TypeError(f"run_training() got an unexpected option {k!r}")
    opt = {**SCENARIO_DEFAULTS, **scenario}
    telemetry = opt["telemetry"]
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
    algo = FedScenario(compression=opt["compression"],
                       compression_plan=opt["compression_plan"],
                       participation=opt["participation"],
                       delay=opt["delay"], stale_policy=opt["stale_policy"],
                       cohort=opt["cohort"], topology=opt["topology"],
                       tier_compression=opt["tier_compression"],
                       arena=opt["arena"], telemetry=telemetry or False,
                       seed=seed).apply(
        FedCET(alpha=alpha, c=c, tau=tau, n_clients=n_clients, x64=False))
    ds = make_hetero_lm_dataset(cfg.vocab_size, n_clients, seq_len, batch,
                                heterogeneity=heterogeneity, seed=seed,
                                device=device)
    grad_fn = torch.func.grad(model.loss)
    client_losses = torch.func.vmap(model.loss)

    def batches_for(r):
        return {"tokens": ds.sample_round(r, tau)}  # [tau, C, B, S]

    def round_loss(s, b):
        return mean_client_loss(client_losses, algo.client_params(s), b)

    state = algo.init(grad_fn, params,
                      tree_map(lambda b: b[0], batches_for(0)))
    runner = make_round_runner(algo, grad_fn, metric_fn=round_loss,
                               metric_with_batch=True)

    sinks = tele.parse_sinks(telemetry)
    tel_spec = getattr(algo, "telemetry", None)
    monitors = tele.resolve_monitors(tel_spec, algo)
    leaf_info = leaf_info_of(params)
    leaf_names = None
    if tel_spec is not None and tel_spec.leaf_stats:
        leaf_names = [nm for nm, _ in leaf_info]
    trace = tele.TraceSession(tele.parse_trace_rounds(opt["trace_rounds"]),
                              out_dir=opt["trace_dir"])
    trace_stops = set(trace.boundaries())

    ckpt_dir = opt["ckpt_dir"]

    def is_stop(r):
        return (r % log_every == 0 or r == steps - 1 or r in trace_stops
                or (ckpt_dir is not None and (r + 1) % CKPT_EVERY == 0))

    meter = CommMeter.for_params(params, algo=algo, n_clients=n_clients)
    bits = comm_bits_per_round(algo, meter.n_params, n_clients, leaf_info)
    adaptive = None
    if opt["plan_adapt"] and opt["plan_adapt"] > 1.0:
        plans = [t.compressor for t in algo.transforms
                 if isinstance(getattr(t, "compressor", None),
                               CompressionPlan)]
        if not plans:
            raise ValueError("plan_adapt needs a compression_plan attached")
        if telemetry is None:
            raise ValueError("plan_adapt reads the telemetry compress_err "
                             "residual; pass --telemetry")
        adaptive = AdaptivePlan(plan=plans[-1],
                                factor=float(opt["plan_adapt"]))
    # the expected participant count when telemetry is off; with it on,
    # the line reports the in-round count.
    expected_active = int(round(n_clients * min(opt["participation"], 1.0)))
    if sinks:
        tele.emit_event(sinks, tele.run_manifest(
            algo, n_params=meter.n_params, device=device,
            config={"arch": arch, "steps": steps, "tau": tau,
                    "n_clients": n_clients, "batch": batch,
                    "seq_len": seq_len, "compression": opt["compression"],
                    "compression_plan": str(opt["compression_plan"]),
                    "plan_adapt": opt["plan_adapt"],
                    "participation": opt["participation"],
                    "delay": opt["delay"],
                    "stale_policy": opt["stale_policy"],
                    "topology": opt["topology"],
                    "tier_compression": opt["tier_compression"],
                    "cohort": str(opt["cohort"]), "arena": opt["arena"],
                    "seed": seed},
            monitors=monitors, leaf_info=leaf_info))

    history = {"round": [], "loss": [], "comm_bytes": [], "seconds": [],
               "n_params": meter.n_params}
    for r, stop in scan_segments(0, steps, is_stop):
        ev = trace.maybe_start(r)
        if ev:
            tele.emit_event(sinks, ev)
        stacked = tree_map(lambda *bs: torch.stack(bs),
                           *[batches_for(i) for i in range(r, stop + 1)])
        _sync(device)
        t0 = time.perf_counter()
        state, ys = runner(state, stacked)
        _sync(device)
        seconds = (time.perf_counter() - t0) / (stop + 1 - r)
        losses, tel_series = tele.split_metrics(algo, ys)
        ev = trace.maybe_stop(stop + 1)
        if ev:
            tele.emit_event(sinks, ev)
        if tel_series is not None and sinks:
            tele.drain({**tel_series, "loss": losses}, sinks=sinks,
                       monitors=monitors, start_round=r, algo=algo,
                       n_params=meter.n_params, leaf_names=leaf_names,
                       leaf_bits=meter.leaf_bits)
        for _ in range(r, stop + 1):
            meter.tick_round(algo)
        if adaptive is not None and tel_series is not None \
                and "compress_err" in tel_series:
            new_plan = adaptive.update(
                float(tel_series["compress_err"][-1]))
            if new_plan is not None:
                # the tightened plan keeps every wrapper, so the extras keep
                # their shapes and the state carries into the new runner.
                algo = _swap_plan(algo, new_plan)
                runner = make_round_runner(algo, grad_fn,
                                           metric_fn=round_loss,
                                           metric_with_batch=True)
                meter = dataclasses.replace(
                    CommMeter.for_params(params, algo=algo,
                                         n_clients=n_clients),
                    rounds=meter.rounds, bytes_up=meter.bytes_up,
                    bytes_down=meter.bytes_down)
                bits = comm_bits_per_round(algo, meter.n_params, n_clients,
                                           leaf_info)
                if sinks:
                    tele.emit_event(sinks, {
                        "event": "plan_adapt", "round": stop,
                        "bits_per_round": bits["up_bits"]})
        losses = losses.tolist()
        active = (None if tel_series is None
                  or "participating" not in tel_series
                  else tel_series["participating"].tolist())
        for i, rr in enumerate(range(r, stop + 1)):
            if rr % log_every == 0 or rr == steps - 1:
                a = expected_active if active is None else int(active[i])
                print(f"round {rr:5d}  loss {losses[i]:.4f}  "
                      f"bits_up {(rr + 1) * bits['up_bits']:.4g}  "
                      f"active_clients {a}")
        if stop % log_every == 0 or stop == steps - 1:
            history["round"].append(stop)
            history["loss"].append(losses[-1])
            history["comm_bytes"].append(meter.total)
            history["seconds"].append(seconds)
            if callback:
                callback(stop, losses[-1], meter.total, state)
        if ckpt_dir and (stop + 1) % CKPT_EVERY == 0:
            save(ckpt_dir, stop + 1, state)
    trace.close()
    tele.close_sinks(sinks)
    return history


def _swap_plan(algo, plan):
    """``algo`` with ``plan`` in place of its attached CompressionPlan."""
    ts = tuple(dataclasses.replace(t, compressor=plan)
               if isinstance(getattr(t, "compressor", None), CompressionPlan)
               else t for t in algo.transforms)
    return dataclasses.replace(algo, transforms=ts)


def mean_client_loss(client_losses, params, batches) -> torch.Tensor:
    """Mean client loss of the stacked ``params`` on the round's first
    batch (the logged loss), on the device."""
    with torch.no_grad():
        return torch.mean(client_losses(params,
                                        tree_map(lambda a: a[0], batches)))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# ---------------------------------------------------- production train step
@dataclasses.dataclass(frozen=True)
class TrainPlan:
    cfg: ArchConfig
    algo: Any  # FedCET, possibly wrapped by scenario transforms
    mesh: Any
    n_clients: int
    per_client_batch: int
    seq_len: int

    @property
    def client_axes(self) -> tuple[str, ...]:
        return client_axes(self.mesh)


def make_plan(arch: str, mesh, *, shape_name: str = "train_4k",
              tau: int = 2, alpha: float = 1e-3, c: float = 0.05,
              dtype: str = "bfloat16",
              scenario: FedScenario | None = None) -> TrainPlan:
    """The production round of ``arch`` at ``shape_name`` on ``mesh``
    (its fsdp view, ``overrides.train_mesh_view``): one client per
    client-axes coordinate, ``global_batch / n_clients`` sequences each.
    The draws take float32 / int32 (``x64`` off), as the reference's LM
    runs (``jax_enable_x64`` off)."""
    from repro_torch.launch.overrides import distribution_for, train_mesh_view

    cfg = get_config(arch).with_dtype(dtype)
    shp = INPUT_SHAPES[shape_name]
    mesh = train_mesh_view(mesh, distribution_for(arch).fsdp)
    nc = n_clients(mesh)
    if shp.global_batch % nc:
        raise ValueError(f"make_plan: {nc} clients do not divide the global "
                         f"batch {shp.global_batch} of {shape_name}")
    algo = FedCET(alpha=alpha, c=c, tau=tau, n_clients=nc, x64=False,
                  spmd_client_axes=client_axes(mesh))
    if scenario is not None:
        algo = scenario.apply(algo)
    return TrainPlan(cfg=cfg, algo=algo, mesh=mesh, n_clients=nc,
                     per_client_batch=shp.global_batch // nc,
                     seq_len=shp.seq_len)


def _fsdp(plan: TrainPlan) -> str | None:
    return "fsdp" if "fsdp" in plan.mesh.mesh_dim_names else None


def state_shardings(plan: TrainPlan, state_shapes):
    """Specs for the algorithm state, entry for entry the reference's: x
    and d are stacked-client parameter trees; transform extras (shift or
    error-feedback memory) and the delay buffer are message-shaped, the
    same stacked layout as x, and shard identically (the buffer's
    ``[clients] int32`` age shards over the client axes); a stateful
    topology's tensors (the tier memory) are replicated. The step counter
    ``t`` and a ``TopoState``'s round index ``k`` are host ints: they have
    no spec and pass through the spec tree as they are."""
    mesh, tp, ca = plan.mesh, tp_size(plan.mesh), plan.client_axes

    def tree_sh(tree):
        return partition.tree_shardings(tree, mesh, tp, ca,
                                        extra_axis=_fsdp(plan))

    wrapped = isinstance(state_shapes, EngineState)
    inner = state_shapes.inner if wrapped else state_shapes
    inner_sh = FedCETState(x=tree_sh(inner.x), d=tree_sh(inner.d), t=inner.t)
    if not wrapped:
        return inner_sh

    def extra_sh(e):
        if e is None:
            return None
        if isinstance(e, TopoState):
            return partition.replicated_shardings(e)
        return tree_sh(e)

    return EngineState(inner=inner_sh,
                       extras=tuple(extra_sh(e) for e in state_shapes.extras))


def abstract_state(plan: TrainPlan):
    """The algorithm state on the ``meta`` device (nothing allocated):
    ``FedCETState`` (``t`` 0, the counter after ``init``), wrapped in
    ``EngineState`` when the plan's scenario attaches message transforms
    (extras from each transform's ``init_extra`` on the x-shaped message),
    a STATEFUL topology (its ``TopoState``, tier memory included, just
    before the delay slot) and/or a delay model (the last slot: the
    server buffer, an x-shaped tree, and the ``[clients] int32`` age)."""
    model = build_model(plan.cfg)
    params = model.init(torch.Generator(), device="meta")

    def stack(tree):
        return tree_map(lambda a: torch.empty(
            (plan.n_clients,) + tuple(a.shape), dtype=a.dtype,
            device="meta"), tree)

    inner = FedCETState(x=stack(params), d=stack(params), t=0)
    algo = plan.algo
    topo = getattr(algo, "topology", None)
    topo_stateful = topo is not None and topo.stateful
    delay = getattr(algo, "delay", None)
    transforms = getattr(algo, "transforms", ())
    if not transforms and delay is None and not topo_stateful:
        return inner
    extras = tuple(t.init_extra(inner.x) for t in transforms)
    if topo_stateful:
        extras += (topo.init_state(inner.x),)
    if delay is not None:
        extras += (DelayState(buf=stack(params), age=torch.empty(
            (plan.n_clients,), dtype=torch.int32, device="meta")),)
    return EngineState(inner=inner, extras=extras)


def build_round_fn(plan: TrainPlan) -> Callable:
    """The production train step: one FedCET round of ``plan.algo``, the
    gradients by ``core/api.py:spmd_grad`` (``torch.func.grad`` on plain
    tensors, autograd on DTensors)."""
    model = build_model(plan.cfg)
    grad_fn = spmd_grad(model.loss)
    algo = plan.algo

    def train_round(state, batches):
        return algo.round(grad_fn, state, batches)

    return train_round


@dataclasses.dataclass
class LoweredTrain:
    """The train step over a mesh: ``build_round_fn(plan)``, the ``meta``
    trees of its arguments (state, ``[tau, clients, ...]`` batches), their
    specs and the activation layouts it runs under."""

    plan: TrainPlan
    fn: Callable
    abstract: tuple           # (state, batches) on meta
    specs: tuple              # their spec trees
    residual: tuple
    logits: tuple
    moe: dict | None
    donate: bool

    def _step(self, state, batches):
        # the model's and the engine's own constants (positions, masks,
        # weights) are plain tensors: they enter as replicated
        from torch.distributed.tensor.experimental import implicit_replication

        with activation_sharding(residual=self.residual, logits=self.logits,
                                 moe_shards=self.moe), torch.no_grad(), \
                implicit_replication():
            return tree_map(resolve_partial, self.fn(state, batches))

    def trace(self) -> dict:
        """One round on fake local shards (a fake process group, no
        device), donation-free: ``memory`` as argument, temp (the peak of
        live storages) and output bytes per device, and ``collectives``,
        the counter's summary."""
        from repro_torch.launch.serve import trace_on_fake_shards

        return trace_on_fake_shards(self._step, self.abstract, self.specs,
                                    self.plan.mesh)

    def run(self, state, batches):
        """One round for real: the state and batches (tensors, or DTensors
        such as a previous round's state) are distributed with the specs'
        placements, and the new state comes back as DTensors with the
        counter's summary: ``(new_state, collectives)``. With ``donate``
        the new state is written into the argument's local shards and the
        argument's tensors are returned, so the caller holds one client
        store."""
        mesh = self.plan.mesh
        args = tuple(partition.distribute(t, s, mesh)
                     for t, s in zip((state, batches), self.specs))
        with CollectiveCounter() as cc:
            new = self._step(*args)
        if self.donate:
            new = tree_map(_write_into, args[0], new)
        return new, cc.collective_summary()


def _write_into(old, new):
    """``new``'s value in ``old``'s storage (tensor leaves), else
    ``new``."""
    if not isinstance(old, torch.Tensor):
        return new
    if new is not old:
        new = new.redistribute(old.device_mesh, old.placements)
        old.to_local().copy_(new.to_local())
    return old


def lower_train_step(plan: TrainPlan, *, donate: bool = True) -> LoweredTrain:
    """The FedCET round on the production mesh, ready to trace or run.

    ``donate`` makes ``.run`` update the argument's client store in place
    ((x, d), transform extras, delay buffers), the reference's aliased
    state. ``.trace()`` is donation-free, as the reference's dry run
    lowers with ``donate=False``."""
    mesh = plan.mesh
    state_shapes = abstract_state(plan)
    batch_shapes = ispec.fed_batch_specs(
        plan.cfg, plan.algo.tau, plan.n_clients, plan.per_client_batch,
        plan.seq_len)
    fs = _fsdp(plan)
    st_sh = state_shardings(plan, state_shapes)
    b_sh = partition.batch_shardings(batch_shapes, mesh,
                                     dim_axes=(None, plan.client_axes, fs))
    tp = tp_size(mesh)
    # token-sharded MoE dispatch when experts don't divide the model axis;
    # per-client tokens are seq-sharded over `model` (and batch over fsdp
    # when present).
    moe = None
    if plan.cfg.n_experts and plan.cfg.n_experts % tp:
        nb = axis_size(mesh, fs) if fs else 1
        axes = (fs, "model") if fs else ("model",)
        moe = {"nb": nb, "ns": tp, "axes": axes,
               "spec": (axes if len(axes) > 1 else axes[0], None, None)}
    # per-client activations [B, S, d]: batch over fsdp (when present),
    # sequence over model, d replicated.
    return LoweredTrain(plan=plan, fn=build_round_fn(plan),
                        abstract=(state_shapes, batch_shapes),
                        specs=(st_sh, b_sh), residual=(fs, "model", None),
                        logits=(fs, None, "model"), moe=moe, donate=donate)


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
                    help="uplink compressor spec: none | bf16 | topk:0.3 | "
                         "randk:0.25 | nat | q8 | pq8 | shift:q8 | "
                         "randk:0.5+q8 | ef:...")
    ap.add_argument("--compression-plan", default="none",
                    help="per-leaf uplink compression plan: comma-separated"
                         " first-match-wins pattern:spec rules over leaf "
                         "paths (glob or flatten-order leaf index), e.g. "
                         "'embed*:q12,ln*:bf16,*:shift:q6'; mutually "
                         "exclusive with --compression; billed exactly per "
                         "leaf")
    ap.add_argument("--plan-adapt", type=float, default=0.0,
                    help="> 1: tighten the plan one step each time the "
                         "telemetry compress_err residual shrinks by this "
                         "factor (needs --compression-plan and "
                         "--telemetry)")
    ap.add_argument("--participation", type=float, default=1.0,
                    help="per-round Bernoulli client participation rate")
    ap.add_argument("--delay", default="none",
                    help="asynchronous rounds: none | fixed:k | rr:k | "
                         "geom:p (delayed uplinks, server message buffer)")
    ap.add_argument("--stale-policy", default="last",
                    help="stale aggregation: drop | last | poly:a")
    ap.add_argument("--cohort", default="none",
                    help="O(cohort) rounds: none | <m> | uniform:<m> | "
                         "block:<m> | rr:<m>, with an optional :dense "
                         "lowering")
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
    ap.add_argument("--telemetry", default=None,
                    help="telemetry sink spec: jsonl:<path> | csv:<path> | "
                         "stdout[:k] | memory, comma-chained; any non-empty "
                         "spec enables in-round telemetry; add "
                         "hist[:bins[:lo:hi]] / topk[:k] for the per-client "
                         "distribution sketches, leafstats for per-leaf "
                         "norms")
    ap.add_argument("--trace-rounds", default=None,
                    help="round window a:b (or a) to trace with "
                         "torch.profiler; the Chrome trace is written "
                         "under --trace-dir")
    ap.add_argument("--trace-dir", default="profile_trace")
    ap.add_argument("--ckpt-dir", default=None,
                    help="save the round state here every 50 rounds")
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
