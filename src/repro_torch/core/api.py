"""Federated-algorithm API (port of ``src/repro/core/api.py``).

State is a stacked tree (every per-client leaf has a leading ``clients``
axis, plus a step counter ``t``); ``init(grad_fn, x0, init_batch)`` and
``round(grad_fn, state, batches)`` are the whole protocol, with
``batches`` leaves shaped ``[tau, clients, ...]``. ``grad_fn(params,
batch) -> grads`` takes ONE client's parameters; the engine lifts it over
the client axis with :func:`vmap_grads`.
"""

from __future__ import annotations

from typing import Any, Callable, Protocol, runtime_checkable

import torch

from repro_torch.utils.tree import tree_map

GradFn = Callable[[Any, Any], Any]  # (params, batch) -> grads, one client


@runtime_checkable
class FederatedAlgorithm(Protocol):
    """Structural interface shared by FedCET and the baselines."""

    name: str
    tau: int
    vectors_up: int
    vectors_down: int

    def init(self, grad_fn: GradFn, x0, init_batch): ...

    def round(self, grad_fn: GradFn, state, batches): ...

    def global_params(self, state): ...


def vmap_grads(grad_fn: GradFn) -> GradFn:
    """Lift a single-client ``grad_fn`` to stacked ``[clients, ...]`` trees
    with ``torch.func.vmap``. The model is a pure function of its
    parameter tree, so ``grad_fn`` is typically ``torch.func.grad(loss)``
    and needs no ``functional_call``. Gradients come back contiguous: the
    FedCET kernels stream flat memory."""
    batched = torch.func.vmap(grad_fn, in_dims=(0, 0))

    def gf(x, batch):
        return tree_map(lambda g: g.contiguous(), batched(x, batch))

    return gf


def replicate(x0, n_clients: int):
    """Stack one parameter tree into ``[n_clients, ...]``. Materialized
    (not a stride-0 ``expand``): the kernels need contiguous memory."""
    return tree_map(
        lambda a: a.unsqueeze(0).expand((n_clients,) + tuple(a.shape))
        .contiguous(), x0)


def comm_bytes_per_round(algo: FederatedAlgorithm, n_params: int,
                         itemsize: int = 4, n_clients: int = 1) -> dict:
    """Bytes moved per communication round (Remark 2 accounting)."""
    up = algo.vectors_up * n_params * itemsize * n_clients
    down = algo.vectors_down * n_params * itemsize * n_clients
    return {"up": up, "down": down, "total": up + down}
