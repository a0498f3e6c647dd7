"""The system under test, the port ``repro_torch``, driven as its
``launch/train.py:run_training`` drives it: the model from
``models.build_model``, the algorithm ``FedScenario(...).apply(FedCET(...))``,
gradients ``torch.func.grad(model.loss)``, rounds through
``core.engine.make_round_runner`` with the logged loss
(``launch.train.mean_client_loss``) after every round.

Its spans (``--trace 1``) come from outside the program, by rebinding the
module attributes it calls through: CUDA events around every vmapped
gradient call and every aggregating step, each also a profiler range."""

from __future__ import annotations

import torch

from fedbench.reference.common import flatten, unflatten


class Program:
    """One cell's program objects; ``init`` and ``round`` are the calls the
    set-up and the window make."""

    def __init__(self, family, conf: dict, mix: dict, seed: int):
        from repro_torch.configs.base import ArchConfig, FedScenario
        from repro_torch.core import FedCET
        from repro_torch.core.engine import make_round_runner
        from repro_torch.launch import train
        from repro_torch.models import build_model

        self.mix = mix
        model = build_model(ArchConfig(**family.arch_kwargs(conf)))
        self.algo = FedScenario(
            compression=mix["compression"], arena=mix["arena"],
            topology=mix["topology"], seed=seed).apply(
            FedCET(alpha=mix["alpha"], c=mix["c"], tau=mix["tau"],
                   n_clients=mix["n_clients"], x64=False))
        self.grad_fn = torch.func.grad(model.loss)
        client_losses = torch.func.vmap(model.loss)

        def round_loss(s, b):  # read at call time, as a span may rebind it
            return train.mean_client_loss(client_losses,
                                          self.algo.client_params(s), b)

        self.runner = make_round_runner(self.algo, self.grad_fn,
                                        metric_fn=round_loss,
                                        metric_with_batch=True)

    def init(self, x0: dict, tokens: torch.Tensor):
        """The warm-up from the flat ``x0`` on ``tokens [C, B, S]``."""
        return self.algo.init(self.grad_fn, unflatten(x0),
                              {"tokens": tokens})

    def round(self, state, tokens: torch.Tensor):
        """One round on ``tokens [tau, C, B, S]``: ``(state, loss)``, the
        loss a one-element tensor on the device."""
        state, losses = self.runner(state, {"tokens": tokens[None]})
        return state, losses

    def views(self, state) -> dict:
        """``{"x", "d", "h"}`` of ``state`` as flat ``{name: [C, ...]}``
        views (``h`` None without a shift memory)."""
        from repro_torch.core import arena

        def tree(a):
            return flatten(arena.unpack(a) if isinstance(a, arena.Arena)
                           else a)

        inner = getattr(state, "inner", state)
        extras = getattr(state, "extras", ())
        return {"x": flatten(self.algo.client_params(state)),
                "d": tree(inner.d),
                "h": tree(extras[0]) if extras else None}

    def wire_bits(self, x0: dict) -> dict:
        """The program's own bit-true uplink and downlink bits a round."""
        from repro_torch.core.comm import comm_bits_per_round, leaf_info_of

        tree = unflatten(x0)
        n = sum(a.numel() for a in x0.values())
        return comm_bits_per_round(self.algo, n, self.mix["n_clients"],
                                   leaf_info_of(tree))


class Spans:
    """CUDA-event intervals of the gradient calls and the aggregating
    steps, grouped per round (``close_round``). ``agg`` is the aggregating
    step's self time: its span less the gradient call inside it."""

    def __init__(self):
        self.open, self.rounds, self.depth = [], [], 0

    def wrap(self, fn, key):
        def timed(*args, **kw):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            inside = self.depth > 0
            self.depth += key == "comm"
            with torch.profiler.record_function(f"fedbench.{key}"):
                s.record()
                try:
                    out = fn(*args, **kw)
                finally:
                    e.record()
                    self.depth -= key == "comm"
            self.open.append((key, inside, s, e))
            return out
        return timed

    def close_round(self) -> None:
        torch.cuda.synchronize()
        grad = comm = grad_in_comm = 0.0
        for key, inside, s, e in self.open:
            ms = s.elapsed_time(e)
            if key == "grad":
                grad += ms
                grad_in_comm += ms if inside else 0.0
            else:
                comm += ms
        self.rounds.append({"grad_ms": grad, "agg_ms": comm - grad_in_comm})
        self.open = []


def instrument(spans: Spans):
    """Route the program's gradient calls and aggregating steps through
    ``spans``; returns an undo."""
    from repro_torch.core import engine

    real_vmap, real_comm = engine.vmap_grads, engine.RoundEngine._comm_step
    engine.vmap_grads = lambda f, **kw: spans.wrap(real_vmap(f, **kw), "grad")
    engine.RoundEngine._comm_step = spans.wrap(real_comm, "comm")

    def undo():
        engine.vmap_grads = real_vmap
        engine.RoundEngine._comm_step = real_comm

    return undo
