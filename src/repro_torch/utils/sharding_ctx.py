"""Ambient activation-sharding context (port of
``src/repro/utils/sharding_ctx.py``).

Model code is mesh-agnostic; the serving lowerings (``launch/serve.py``)
enable activation layouts for the mesh via::

    with activation_sharding(residual=(None, "model", None)):
        ... run the step on DTensors ...

and the model blocks call ``shard_residual(x)`` on the residual stream at
layer boundaries. A spec is the reference's ``PartitionSpec`` as a plain
tuple: per tensor dim an axis name, a tuple of names, or ``None``. On a
DTensor under an active spec the two shard functions redistribute it to
the spec's placements (``spec_placements``); anywhere else, which includes
every CPU test and every unsharded path, they are the identity. The
default prefill spec shards the SEQUENCE over the ``model`` axis between
layers (sequence parallelism), as the reference's does.

A spec names the mesh axes it shards; its placements put ``Shard(i)`` on
each mesh dim named in tensor dim ``i`` and ``Replicate()`` on the
others. Two axes on one tensor dim must come in the mesh's order (the
reference's ``("pod", "data")``), the order DTensor shards in.
"""

from __future__ import annotations

import contextlib
import threading

import torch

_state = threading.local()


def spec_placements(spec, mesh) -> tuple:
    """The DTensor placements of ``spec`` on ``mesh`` (a ``DeviceMesh``
    with named dims)."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for i, ax in enumerate(spec):
        axes = ax if isinstance(ax, tuple) else ((ax,) if ax else ())
        dims = []
        for a in axes:
            if a not in names:
                raise ValueError(f"spec {spec} names axis {a!r}, not in the "
                                 f"mesh's {names}")
            dims.append(names.index(a))
        if dims != sorted(dims):
            raise ValueError(f"spec {spec}: the axes of dim {i} must follow "
                             f"the mesh's order {names}")
        for m in dims:
            out[m] = Shard(i)
    return tuple(out)


def is_dtensor(x) -> bool:
    if type(x) is torch.Tensor:  # the unsharded paths: no import, no lookup
        return False
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def redistribute(x, spec):
    """``x`` redistributed to ``spec``'s placements when it is a DTensor;
    a plain tensor comes back as it is."""
    if not is_dtensor(x):
        return x
    return x.redistribute(x.device_mesh,
                          spec_placements(spec, x.device_mesh))


def _moves_free_first(x, want):
    """``x.redistribute`` to ``want`` in two steps: first the moves that
    cost no traffic (replicated to sharded: each rank keeps its slice),
    then the rest. In one step DTensor may order a gather first, which
    then gathers the not yet sliced dims too."""
    cur = list(x.placements)
    want = list(want)
    if cur == want:
        return x
    free = [w if c.is_replicate() and w.is_shard() else c
            for c, w in zip(cur, want)]
    if free != cur:
        x = x.redistribute(x.device_mesh, free)
    return x.redistribute(x.device_mesh, want) if free != want else x


def batch_local(x):
    """The input of column-parallel projections: a DTensor with its batch
    (dim 0) over every mesh dim the batch divides, where it is replicated
    or already there (no traffic), every other dim whole (a sequence
    sharded between layers is gathered once, not once per projection),
    and its local shard contiguous (``dense_shards``); anything else as it
    is."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard

    mesh, nb, want = x.device_mesh, 1, []
    for m, p in enumerate(x.placements):
        n = mesh.size(m)
        if (p.is_replicate() or p == Shard(0)) and x.shape[0] % (nb * n) == 0:
            nb *= n
            want.append(Shard(0))
        else:
            want.append(Replicate())
    return dense_shards(_moves_free_first(x, want))


def dense_shards(x):
    """A DTensor whose local shard is contiguous. DTensor computes a
    result's strides from the global shapes and may hand back a permuted
    local shard (an einsum's); a reshape then runs as a view of it and
    fails. Anything else as it is."""
    if is_dtensor(x) and not x.to_local().is_contiguous():
        from torch.distributed.tensor import DTensor

        x = DTensor.from_local(x.to_local().contiguous(), x.device_mesh,
                               x.placements, run_check=False, shape=x.shape,
                               stride=x.stride())
    return x


def resolve_partial(x):
    """A DTensor with pending sums (``Partial`` placements, such as a
    lookup in a vocab-sharded embedding leaves) reduced to replicated on
    those mesh dims; anything else as it is."""
    if is_dtensor(x) and any(p.is_partial() for p in x.placements):
        from torch.distributed.tensor import Replicate

        x = x.redistribute(x.device_mesh, [
            Replicate() if p.is_partial() else p for p in x.placements])
    return x


def gather_dims(x, dims):
    """A DTensor replicated on the mesh dims that shard any of its tensor
    dims ``dims``; anything else as it is."""
    if is_dtensor(x):
        from torch.distributed.tensor import Replicate

        dims = [d % x.ndim for d in dims]
        pl = [Replicate() if p.is_shard() and p.dim in dims else p
              for p in x.placements]
        if pl != list(x.placements):
            x = x.redistribute(x.device_mesh, pl)
    return x


def replicate(x):
    """A DTensor replicated on every mesh dim; anything else as it is."""
    if is_dtensor(x):
        from torch.distributed.tensor import Replicate

        x = x.redistribute(x.device_mesh,
                           [Replicate()] * x.device_mesh.ndim)
    return x


def split_dim(x, n: int, size: int, dim: int = -1):
    """``x`` with dim ``dim`` (of ``n * size``) viewed as ``[n, size]``. A
    DTensor sharded on that dim over a mesh dim that ``n`` does not divide
    is gathered on that mesh dim first (the split would cut a group); the
    gather then comes after the batch (dim 0) is sharded over the mesh
    dims it is replicated on and divides, which costs no traffic."""
    dim = dim % x.ndim
    if is_dtensor(x):
        from torch.distributed.tensor import Replicate, Shard

        mesh = x.device_mesh
        pl = [Replicate() if p.is_shard(dim) and n % mesh.size(m) else p
              for m, p in enumerate(x.placements)]
        if pl != list(x.placements):
            nb = 1
            for m, p in enumerate(x.placements):
                if p.is_shard(0):
                    nb *= mesh.size(m)
            for m, p in enumerate(x.placements):
                if (dim and p.is_replicate()
                        and x.shape[0] % (nb * mesh.size(m)) == 0):
                    nb *= mesh.size(m)
                    pl[m] = Shard(0)
            x = _moves_free_first(x, pl)
    return x.reshape(*x.shape[:dim], n, size, *x.shape[dim + 1:])


def local_layout(ts, head_dims, n_heads: int):
    """The DTensors ``ts`` redistributed so that each rank can compute on
    its own shards: per mesh dim in order, every operand on its batch dim
    (dim 0) while the batch divides the mesh dims given to it so far, else
    the operands with a head dim (``head_dims[i]``, ``None`` for an
    operand without one) on it while ``n_heads`` divides likewise, else
    all replicated. Plain tensors come back as they are."""
    if not is_dtensor(ts[0]):
        return ts
    from torch.distributed.tensor import Replicate, Shard

    mesh = ts[0].device_mesh
    want = [[] for _ in ts]
    nb = nh = 1
    for m in range(mesh.ndim):
        n = mesh.size(m)
        if ts[0].shape[0] % (nb * n) == 0:
            nb *= n
            pls = [Shard(0)] * len(ts)
        elif n_heads % (nh * n) == 0:
            nh *= n
            pls = [Replicate() if h is None else Shard(h) for h in head_dims]
        else:
            pls = [Replicate()] * len(ts)
        for w, p in zip(want, pls):
            w.append(p)
    return tuple(_moves_free_first(t, w) for t, w in zip(ts, want))


@contextlib.contextmanager
def activation_sharding(residual=None, logits=None, moe_shards=None):
    """moe_shards: optional ``{"nb", "ns", "axes", "spec"}`` enabling the
    locality-preserving token-sharded MoE dispatch (see models/moe.py)."""
    prev = (getattr(_state, "residual", None), getattr(_state, "logits", None),
            getattr(_state, "moe_shards", None))
    _state.residual = residual
    _state.logits = logits
    _state.moe_shards = moe_shards
    try:
        yield
    finally:
        _state.residual, _state.logits, _state.moe_shards = prev


def moe_shards():
    return getattr(_state, "moe_shards", None)


def shard_residual(x):
    spec = getattr(_state, "residual", None)
    if spec is None:
        return x
    return redistribute(x, spec)


def shard_logits(x):
    """Per-chunk CE logits: vocab over `model` (the residual layout moves
    the model axis to seq, so logits left alone would replicate the vocab
    dim)."""
    spec = getattr(_state, "logits", None)
    if spec is None:
        return x
    return redistribute(x, spec)
