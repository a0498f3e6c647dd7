"""FedTrainer, the training harness around any engine algorithm (port of
``src/repro/fed/trainer.py``).

What a deployment needs beyond the algorithm's round:

* round orchestration with a pluggable data source (round -> batches)
  through the shared round runner (``engine.make_round_runner``), in
  segments that end at every eval or checkpoint boundary (at most
  ``max_scan_rounds`` rounds each);
* periodic evaluation: the global model's loss AND the clients' local
  losses (their gap, mean local minus global, is the practical drift
  diagnostic). By default on the train batches, computed after every
  round by the runner's metric hook and read once per boundary; a
  held-out ``eval_batch_for`` goes through :meth:`FedTrainer.evaluate`;
* checkpoint and resume of the FULL algorithm state (the step counter and
  any transform state such as the shift memory included,
  ``checkpoint/ckpt.py``);
* bit-true communication metering (``core/comm.py:CommMeter``) from the
  algorithm's vector counts and compressor stack, sampling duty cycle
  and topology;
* CSV metrics (``core/telemetry.py:write_csv_rows``) and, when the
  algorithm has ``with_telemetry`` attached and the trainer is given
  ``sinks=``, the per-round telemetry of each segment drained into the
  sinks (a run manifest first).

Works with any engine algorithm (FedCET plain, compressed, sampled,
delayed, on a cohort or on a topology through the ``with_*`` factories,
FedAvg, SCAFFOLD, FedTrack, FedLin, FedProx, FedDyn, NIDS) and any model
exposing ``loss(params, batch)``. It runs on ``device``: ``cuda`` unless
the caller passes another; parameters, batches and restored states are
moved there. Random draws take the algorithm's own ``x64`` dtypes: an
LM algorithm is built with ``x64=False`` (float32 / int32, the
reference's dtypes on its LM runs, which leave ``jax_enable_x64`` off).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import torch

from repro_torch import resolve_device
from repro_torch.checkpoint.ckpt import restore, save
from repro_torch.core import telemetry as tele
from repro_torch.core.comm import CommMeter
from repro_torch.core.engine import make_round_runner, scan_segments
from repro_torch.utils.tree import tree_map


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    rounds: int = 100
    eval_every: int = 25
    ckpt_every: int = 0              # 0 = no checkpoints
    ckpt_dir: str | None = None
    ckpt_keep: int = 3
    log_csv: str | None = None
    #: upper bound on rounds per segment: bounds the memory spent on the
    #: stacked per-round batches when eval and checkpoints are sparse.
    max_scan_rounds: int = 32


class FedTrainer:
    def __init__(self, algo, loss_fn: Callable, cfg: TrainerConfig,
                 sinks=None, device=None):
        self.algo = algo
        self.loss_fn = loss_fn
        self.cfg = cfg
        self.device = resolve_device(device)
        #: telemetry event sinks (a ``parse_sinks`` spec string, a list of
        #: sink objects, or None); round telemetry flows into them when
        #: the algorithm has ``with_telemetry`` attached.
        self.sinks = tele.parse_sinks(sinks)
        self.monitors = tele.resolve_monitors(getattr(algo, "telemetry",
                                                      None))
        self.grad_fn = torch.func.grad(loss_fn)
        self._runner = make_round_runner(algo, self.grad_fn)
        client_losses = torch.func.vmap(loss_fn)
        global_losses = torch.func.vmap(loss_fn, in_dims=(None, 0))

        def _scan_metrics(state, batches):
            """Per-round eval losses (the math of ``evaluate``: the first
            tau-slice of that round's batches)."""
            b = tree_map(lambda a: a[0], batches)
            with torch.no_grad():
                local = client_losses(algo.client_params(state), b)
                glob = torch.mean(global_losses(algo.global_params(state),
                                                b))
            return {"loss_global": glob, "loss_local_mean": torch.mean(local)}

        self._metric_runner = make_round_runner(
            algo, self.grad_fn, metric_fn=_scan_metrics,
            metric_with_batch=True)
        self._client_losses = client_losses
        self._global_losses = global_losses
        self.history: list[dict] = []

    def _to_device(self, tree):
        return tree_map(lambda a: a.to(self.device), tree)

    # ------------------------------------------------------------ lifecycle
    def init_state(self, params, init_batch):
        return self.algo.init(self.grad_fn, self._to_device(params),
                              self._to_device(init_batch))

    def maybe_resume(self, state):
        """Resume from the newest checkpoint if one exists: ``(state,
        first round to run)``."""
        if not self.cfg.ckpt_dir:
            return state, 0
        restored, step = restore(self.cfg.ckpt_dir, state)
        if restored is None:
            return state, 0
        return restored, step

    # ------------------------------------------------------------ schedule
    def _eval_at(self, r: int) -> bool:
        return bool(self.cfg.eval_every) and (
            r % self.cfg.eval_every == 0 or r == self.cfg.rounds - 1)

    def _ckpt_at(self, r: int) -> bool:
        return bool(self.cfg.ckpt_every and self.cfg.ckpt_dir
                    and (r + 1) % self.cfg.ckpt_every == 0)

    # ------------------------------------------------------------ main loop
    def fit(self, state, batches_for: Callable[[int], Any],
            eval_batch_for: Callable[[int], Any] | None = None,
            start_round: int = 0, callback=None):
        params1 = tree_map(lambda a: a[0], self.algo.client_params(state))
        meter = CommMeter.for_params(params1, algo=self.algo,
                                     n_clients=self.algo.n_clients)
        if self.sinks:
            tele.emit_event(self.sinks, tele.run_manifest(
                self.algo, n_params=meter.n_params, device=self.device,
                config={"rounds": self.cfg.rounds,
                        "eval_every": self.cfg.eval_every},
                monitors=self.monitors))
        t0 = time.time()
        # train-batch eval rides the runner's metric hook; a held-out eval
        # batch needs the out-of-loop evaluator.
        scan_eval = bool(self.cfg.eval_every) and eval_batch_for is None
        runner = self._metric_runner if scan_eval else self._runner
        for r, stop in scan_segments(
                start_round, self.cfg.rounds,
                lambda s: self._eval_at(s) or self._ckpt_at(s),
                max_rounds=self.cfg.max_scan_rounds):
            stacked = self._to_device(tree_map(
                lambda *bs: torch.stack(bs),
                *[batches_for(i) for i in range(r, stop + 1)]))
            state, ys = runner(state, stacked)
            metrics, tel_series = tele.split_metrics(self.algo, ys)
            if tel_series is not None and self.sinks:
                tele.drain(tel_series, sinks=self.sinks,
                           monitors=self.monitors, start_round=r,
                           algo=self.algo, n_params=meter.n_params)
            for _ in range(r, stop + 1):
                meter.tick_round(self.algo)
            if self._eval_at(stop):
                if scan_eval:  # the segment's last round == stop
                    glob = float(metrics["loss_global"][-1])
                    loc = float(metrics["loss_local_mean"][-1])
                    row = {"loss_global": glob, "loss_local_mean": loc,
                           "heterogeneity_gap": loc - glob}
                else:
                    row = self.evaluate(state, eval_batch_for(stop))
                row.update(round=stop, comm_bytes=meter.total,
                           wall_s=round(time.time() - t0, 2))
                self.history.append(row)
                if callback:
                    callback(row)
            if self._ckpt_at(stop):
                save(self.cfg.ckpt_dir, stop + 1, state,
                     keep=self.cfg.ckpt_keep)
        if self.cfg.log_csv:
            tele.write_csv_rows(self.cfg.log_csv, self.history)
        tele.close_sinks(self.sinks)
        return state

    # ----------------------------------------------------------------- eval
    def evaluate(self, state, batches) -> dict:
        """``batches``: ``[tau, clients, ...]``; evaluation uses the first
        slice."""
        b = self._to_device(tree_map(lambda a: a[0], batches))
        with torch.no_grad():
            local = torch.mean(self._client_losses(
                self.algo.client_params(state), b))
            glob = torch.mean(self._global_losses(
                self.algo.global_params(state), b))
        return {"loss_global": float(glob),
                "loss_local_mean": float(local),
                "heterogeneity_gap": float(local - glob)}
