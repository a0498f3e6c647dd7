"""Minimal optimizer library over tensor trees (port of
``src/repro/optim/optimizers.py``).

FedCET itself is a GD-type method whose update rule lives in
``repro_torch.core``; these optimizers serve the baselines and local-Adam
training. API: ``init(params) -> state``, ``update(grads, state, params,
lr) -> (new_params, new_state)``, pure functions of tensor trees. States
are trees, so they compose with the stacked-client layout and with
``checkpoint/ckpt.py`` unchanged.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.utils.tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class Sgd:
    momentum: float = 0.0

    def init(self, params):
        if self.momentum == 0.0:
            return ()
        return tree_map(torch.zeros_like, params)

    def update(self, grads, state, params, lr):
        if self.momentum == 0.0:
            return tree_map(lambda p, g: p - lr * g, params, grads), state
        vel = tree_map(lambda v, g: self.momentum * v + g, state, grads)
        new = tree_map(lambda p, v: p - lr * v, params, vel)
        return new, vel


@dataclasses.dataclass(frozen=True)
class Adam:
    """Adam with float32 moments whatever the parameter dtype, and the
    step count ``t`` as a 0-d int32 tensor leaf of the state (as the
    reference's, so an Adam state checkpoints with the same leaves)."""

    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0

    def init(self, params):
        def zeros():
            return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                            params)

        leaves = tree_leaves(params)
        device = leaves[0].device if leaves else None
        return {"m": zeros(), "v": zeros(),
                "t": torch.zeros((), dtype=torch.int32, device=device)}

    def update(self, grads, state, params, lr):
        t = state["t"] + 1
        m = tree_map(lambda m, g: self.b1 * m + (1 - self.b1) * g.float(),
                     state["m"], grads)
        v = tree_map(lambda v, g: self.b2 * v
                     + (1 - self.b2) * torch.square(g.float()),
                     state["v"], grads)
        tf = t.float()
        bc1 = 1.0 - torch.pow(torch.tensor(self.b1, dtype=torch.float32,
                                           device=tf.device), tf)
        bc2 = 1.0 - torch.pow(torch.tensor(self.b2, dtype=torch.float32,
                                           device=tf.device), tf)

        def upd(p, m, v):
            step = (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
            if self.weight_decay:
                step = step + self.weight_decay * p.float()
            return (p.float() - lr * step).to(p.dtype)

        return tree_map(upd, params, m, v), {"m": m, "v": v, "t": t}
