"""Federated-algorithm API (port of ``src/repro/core/api.py``).

State is a stacked tree (every per-client leaf has a leading ``clients``
axis, plus a step counter ``t``); ``init(grad_fn, x0, init_batch)`` and
``round(grad_fn, state, batches)`` are the whole protocol, with
``batches`` leaves shaped ``[tau, clients, ...]``. ``grad_fn(params,
batch) -> grads`` takes ONE client's parameters; the engine lifts it over
the client axis with :func:`vmap_grads`, whose ``spmd_axis_name`` runs a
mesh's client axes (the production train step of ``launch/train.py``).
"""

from __future__ import annotations

from typing import Any, Callable, Protocol, runtime_checkable

import torch
from torch.utils import _pytree as pytree

from repro_torch.utils.sharding_ctx import is_dtensor
from repro_torch.utils.tree import tree_leaves, tree_map

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


def vmap_grads(grad_fn: GradFn, spmd_axis_name=None) -> GradFn:
    """Lift a single-client ``grad_fn`` to stacked ``[clients, ...]`` trees
    with ``torch.func.vmap``. The model is a pure function of its
    parameter tree, so ``grad_fn`` is typically ``torch.func.grad(loss)``
    and needs no ``functional_call``. Gradients come back contiguous: the
    FedCET kernels stream flat memory.

    ``spmd_axis_name`` (the mesh axes carrying the client dimension, e.g.
    ``("pod", "data")``) is the reference's SPMD client axis. On DTensors
    whose dim 0 is ``Shard(0)`` on those mesh dims each rank computes the
    gradients of its own clients. Where the other mesh dims (``model``,
    ``fsdp``) hold more than one rank, the clients' rows, as DTensors on
    that sub-mesh, go one client at a time through ``grad_fn``
    (``torch.func.vmap`` has no batching rule for DTensor's strided
    shards), each gradient is brought to the layout of its parameter (a
    pending sum over ``model`` is reduced there), and they are stacked
    back under the clients' placements. The model's layout helpers must
    see DTensors, which ``torch.func`` transforms hide, so this path takes
    a ``grad_fn`` that runs under autograd (:func:`spmd_grad`). Where the
    other dims hold one rank, the local shards are whole parameters and
    the rank vmaps its clients as the unsharded engine does. Plain tensors
    take the plain path."""
    batched = torch.func.vmap(grad_fn, in_dims=(0, 0))

    def gf(x, batch):
        return tree_map(lambda g: g.contiguous(), batched(x, batch))

    if not spmd_axis_name:
        return gf
    axes = ((spmd_axis_name,) if isinstance(spmd_axis_name, str)
            else tuple(spmd_axis_name))

    def spmd_gf(x, batch):
        if not is_dtensor(tree_leaves(x)[0]):
            return gf(x, batch)
        return _client_local_grads(grad_fn, gf, x, batch, axes)

    return spmd_gf


def _client_local_grads(grad_fn: GradFn, gf: GradFn, x, batch,
                        axes: tuple):
    """The gradients of this rank's clients (see :func:`vmap_grads`):
    :func:`per_client_grads` where the sub-mesh of the other dims holds
    more than one rank, else ``gf`` (``grad_fn`` vmapped) on the local
    shards, which are whole parameters."""
    mesh = tree_leaves(x)[0].device_mesh
    rest = tuple(n for n in mesh.mesh_dim_names if n not in axes)
    if rest and mesh[rest].size() > 1:
        return per_client_grads(grad_fn, x, batch, axes)
    local = lambda t: _clients(t, mesh, axes, None)  # noqa: E731
    return _restack(x, gf(tree_map(local, x), tree_map(local, batch)))


def per_client_grads(grad_fn: GradFn, x, batch, axes: tuple):
    """The mesh path of :func:`vmap_grads`: this rank's clients' rows, as
    DTensors on the sub-mesh of the other dims (one rank or more), one
    client at a time through ``grad_fn``; each gradient is brought to the
    layout of its parameter (a pending sum over ``model`` is reduced
    there), and they are stacked back under the clients' placements."""
    mesh = tree_leaves(x)[0].device_mesh
    rest = tuple(n for n in mesh.mesh_dim_names if n not in axes)
    sub = mesh[rest] if rest else None
    xs = tree_map(lambda t: _clients(t, mesh, axes, sub), x)
    bs = tree_map(lambda t: _clients(t, mesh, axes, sub), batch)
    per_client = []
    for i in range(tree_leaves(xs)[0].shape[0]):
        xi = tree_map(lambda t: t[i], xs)
        gi = grad_fn(xi, tree_map(lambda t: t[i], bs))
        per_client.append(tree_map(
            lambda g, p: (g.redistribute(p.device_mesh, p.placements)
                          .to_local() if sub is not None else g), gi, xi))
    return _restack(x, tree_map(lambda *gs: torch.stack(gs), *per_client))


def _clients(t, mesh, axes: tuple, sub):
    """``t``'s local clients: the local tensor (``sub`` None), else a
    DTensor on the sub-mesh ``sub`` of the other dims."""
    from torch.distributed.tensor import DTensor, Shard

    if not isinstance(t, DTensor) or t.device_mesh != mesh:
        raise ValueError("vmap_grads: the state and the batch must be "
                         "DTensors on one mesh")
    names = tuple(mesh.mesh_dim_names)
    for a in axes:
        if t.placements[names.index(a)] != Shard(0):
            raise ValueError(f"vmap_grads: client axis {a!r} must shard dim "
                             f"0, got {t.placements}")
    loc = t.to_local()
    if sub is None:
        return loc
    shape = (loc.shape[0],) + tuple(t.shape[1:])
    return DTensor.from_local(
        loc, sub, [p for n, p in zip(names, t.placements) if n not in axes],
        run_check=False, shape=shape,
        stride=torch.empty(shape, device="meta").stride())


def _restack(x, grads):
    """The local gradients ``grads`` as DTensors in ``x``'s layout."""
    from torch.distributed.tensor import DTensor

    return tree_map(lambda t, g: DTensor.from_local(
        g.contiguous(), t.device_mesh, t.placements, run_check=False,
        shape=t.shape, stride=t.stride()), x, grads)


def spmd_grad(loss) -> GradFn:
    """``grad(params, batch)`` of ``loss`` for both paths of
    :func:`vmap_grads`: ``torch.func.grad(loss)`` on plain tensors (so it
    vmaps), ``torch.autograd.grad`` on DTensor parameters (the mesh path,
    where the model's layout helpers must see the DTensors)."""
    func_grad = torch.func.grad(loss)

    def grad_fn(params, batch):
        leaves, spec = pytree.tree_flatten(params)
        if not is_dtensor(leaves[0]):
            return func_grad(params, batch)
        leaves = [t.detach().requires_grad_(True) for t in leaves]
        with torch.enable_grad():
            out = loss(pytree.tree_unflatten(leaves, spec), batch)
            grads = torch.autograd.grad(out, leaves)
        return pytree.tree_unflatten(list(grads), spec)

    return grad_fn


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
