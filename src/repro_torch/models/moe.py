"""Mixture-of-Experts block: a top-k router and a sort-based capacity
dispatch (port of ``src/repro/models/moe.py``: ``init_moe``,
``apply_moe`` and ``_moe_tokens``, :20-41 and :116-174).

The dispatch sorts the ``T * k`` (token, expert) assignments by expert
id, stably, so each assignment's slot in its expert's buffer is its rank
within the expert's run. An expert holds ``C = max(1, int(capacity_factor
* T * k / E))`` slots; an assignment ranked ``C`` or later is dropped and
its token gets nothing from that expert. ``C`` depends on the number of
tokens in the call, so ``forward``, ``prefill`` and ``decode_step`` drop
different assignments at the same capacity factor: the reference's
semantics, kept. The experts run as batched matmuls over the ``[E, C, d]``
buffers; their FLOPs are the only ones of the block. The Switch-style
load-balance term ``E * sum(frac * prob)`` is returned for the loss.

Every step is a gather, so nothing sums through atomics: the buffers are
gathered from the sorted order (the reference scatters with
``.at[].add``, which adds each kept token to a zero slot exactly once),
and each token's output comes back through the inverse permutation as
``[T, k, d]``, summed over its ``k`` assignments in a fixed order (the
reference scatter-adds them in expert order; the two differ in the last
bits only). The rank within a run is the position in the sorted order
less the run's start, the count of smaller expert ids: the reference's
``searchsorted(side="left")``.

The token-sharded dispatch (the reference's ``moe_shards()`` branch,
:63-113): under ``utils/sharding_ctx.py:moe_shards()`` the ``[B, S, d]``
tokens form an ``[nb * ns, B/nb * S/ns, d]`` grid (batch blocks by
sequence blocks) and each cell routes into its own capacity buffer
(per-shard capacity, the standard per-device MoE semantics), through
``torch.func.vmap`` over ``_moe_tokens``; the shared expert is added
after, and the load-balance term is the cells' mean. On DTensors the
cells are the ranks' local shards: the tokens are laid out batch over the
data axes and sequence over ``model``, the expert weights are gathered
for the layer (gather-at-use, as the reference's), and each rank runs its
cell alone. Without a grid (and at decode, which keeps the plain
dispatch) DTensor tokens are replicated before routing.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import apply_mlp, dense_init, gelu_tanh, \
    init_mlp
from repro_torch.utils.sharding_ctx import (grad_in_layout, is_dtensor,
                                            moe_shards, redistribute,
                                            replicate)


def init_moe(gen: torch.Generator, d: int, d_ff: int, n_experts: int, dtype,
             *, shared_expert: bool, activation: str, lead: tuple = (),
             device=None) -> dict:
    """Router ``[d, E]`` (scale 0.02) and stacked expert weights ``[E, d,
    d_ff]`` / ``[E, d_ff, d]`` (``gate`` for the gated activations), every
    expert starting from one draw, as the reference's do; ``shared`` is an
    ordinary MLP."""
    kw = dict(lead=lead, device=device)

    def expert(d_in, d_out):
        w = dense_init(gen, d_in, d_out, dtype, **kw)
        return w.unsqueeze(len(lead)).expand(
            lead + (n_experts, d_in, d_out)).contiguous()

    p = {"router": dense_init(gen, d, n_experts, dtype, scale=0.02, **kw)}
    if activation in ("swiglu", "geglu"):
        p["gate"] = expert(d, d_ff)
    p["up"] = expert(d, d_ff)
    p["down"] = expert(d_ff, d)
    if shared_expert:
        p["shared"] = init_mlp(gen, d, d_ff, dtype, activation=activation,
                               **kw)
    return p


def capacity(n_tokens: int, k: int, n_experts: int,
             capacity_factor: float) -> int:
    """Slots per expert for a call over ``n_tokens`` tokens
    (``moe.py:145``)."""
    return max(1, int(capacity_factor * n_tokens * k / n_experts))


class Dispatch(NamedTuple):
    """The routing of ``T`` tokens to ``k`` of ``E`` experts each."""
    tope: torch.Tensor    # [T, k] expert ids, by descending probability
    topw: torch.Tensor    # [T, k] their weights, normalized over k
    order: torch.Tensor   # [T * k] flat assignments sorted by expert, stably
    se: torch.Tensor      # [T * k] the sorted expert ids
    counts: torch.Tensor  # [E] assignments per expert
    starts: torch.Tensor  # [E] start of each expert's run in the sort
    slot: torch.Tensor    # [T * k] rank within the expert's run (0 if dropped)
    keep: torch.Tensor    # [T * k] the rank is below the capacity


def _histogram(ids: torch.Tensor, n: int) -> torch.Tensor:
    return (ids[:, None] == torch.arange(n, device=ids.device)).sum(0)


def route(probs: torch.Tensor, k: int, n_experts: int,
          cap: int) -> Dispatch:
    """The dispatch of ``_moe_tokens`` (``moe.py:135-148``) for router
    probabilities ``[T, E]`` in float32."""
    topw, tope = torch.topk(probs, k, dim=-1, sorted=True)
    topw = topw / torch.clamp_min(topw.sum(-1, keepdim=True), 1e-9)
    flat_e = tope.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]
    counts = _histogram(flat_e, n_experts)
    starts = torch.cumsum(counts, 0) - counts
    slot = torch.arange(se.shape[0], device=se.device) - starts[se]
    keep = slot < cap
    return Dispatch(tope, topw, order, se, counts, starts,
                    torch.where(keep, slot, 0), keep)


def _moe_tokens(params: dict, xt: torch.Tensor, *, n_experts: int, k: int,
                capacity_factor: float, activation: str):
    """The sort-based dispatch over a flat token stream ``xt [T, d]``:
    ``(out [T, d], aux)``."""
    T, d = xt.shape
    cap = capacity(T, k, n_experts, capacity_factor)
    # a replicated router (fsdp may shard it) keeps the routing's indices
    # replicated on a DTensor token stream
    logits = xt @ replicate(params["router"])                 # [T, E]
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    r = route(probs, k, n_experts, cap)
    st = r.order // k                                         # token ids

    # buffers [E, C, d]: slot c of expert e holds the sorted assignment
    # starts[e] + c when the expert has more than c of them, else zeros.
    c = torch.arange(cap, device=xt.device)
    src = torch.clamp_max(r.starts[:, None] + c[None, :], T * k - 1)
    filled = c[None, :] < r.counts[:, None]
    # the gathers' gradients come back in their forward layouts: DTensor's
    # index_put (their backward) in torch 2.11 fails on the layouts the
    # expert-sharded products hand back
    buf = torch.where(filled[..., None], grad_in_layout(xt[st[src]]),
                      torch.zeros((), dtype=xt.dtype, device=xt.device))

    if "gate" in params:
        act = F.silu if activation == "swiglu" else gelu_tanh
        h = act(torch.bmm(buf, params["gate"]))
        h = h * torch.bmm(buf, params["up"])
    else:
        h = gelu_tanh(torch.bmm(buf, params["up"]))
    y = torch.bmm(h, params["down"])                          # [E, C, d]

    sw = r.topw.reshape(-1)[r.order]
    w_keep = torch.where(r.keep, sw, 0.0).to(xt.dtype)
    out_slots = grad_in_layout(y[r.se, r.slot]) * w_keep[:, None]  # sorted
    out = grad_in_layout(out_slots[torch.argsort(r.order)]).reshape(
        T, k, d).sum(1)

    frac = _histogram(r.tope[:, 0], n_experts).to(torch.float32) / T
    aux = n_experts * torch.sum(frac * torch.mean(probs, dim=0))
    return out, aux


def _moe_grid(params: dict, xs: torch.Tensor, kw: dict):
    """``_moe_tokens`` over each cell of the token grid ``xs [n, T, d]``:
    ``(out [n, T, d], aux [n])``."""
    return torch.func.vmap(lambda t: _moe_tokens(params, t, **kw))(xs)


def _grid_dtensor(params: dict, x, shards: dict, kw: dict):
    """The grid dispatch on a DTensor ``x [B, S, d]``: batch over the grid's
    data axes, sequence over ``model`` when the grid cuts it, so each
    rank's local shard is one cell; the expert weights replicated."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    axes = tuple(shards["axes"])
    batch_axes = tuple(a for a in axes if a != "model")
    spec = (batch_axes or None, "model" if shards["ns"] > 1 else None, None)
    x = redistribute(x, spec)
    local = {name: (replicate(w).to_local() if is_dtensor(w) else w)
             for name, w in params.items() if name != "shared"}
    xl = x.to_local()
    out, aux = _moe_grid(local, xl.reshape(1, -1, xl.shape[-1]), kw)
    mesh = x.device_mesh
    out = DTensor.from_local(out.reshape(xl.shape), mesh, x.placements,
                             run_check=False, shape=x.shape,
                             stride=x.stride())
    names = mesh.mesh_dim_names
    aux = DTensor.from_local(aux[0], mesh, [
        Partial("avg") if n in axes else Replicate() for n in names],
        run_check=False)
    return out, aux


def apply_moe(params: dict, x: torch.Tensor, *, n_experts: int, k: int,
              capacity_factor: float, activation: str,
              shared_expert: bool):
    """x: [B, S, d] -> ([B, S, d], the aux loss, a float32 scalar); the
    ``B * S`` tokens of the call share one capacity, or each cell of the
    token grid has its own under ``moe_shards()``."""
    B, S, d = x.shape
    kw = dict(n_experts=n_experts, k=k, capacity_factor=capacity_factor,
              activation=activation)
    shards = moe_shards()
    if shards is not None:
        nb, ns = shards["nb"], shards["ns"]
        if B % nb == 0 and B >= nb and S % ns == 0 and S >= ns:
            if is_dtensor(x):
                out, aux = _grid_dtensor(params, x, shards, kw)
            else:
                xs = (x.reshape(nb, B // nb, ns, S // ns, d)
                      .transpose(1, 2).reshape(nb * ns, -1, d))
                out, aux = _moe_grid(params, xs, kw)
                out = (out.reshape(nb, ns, B // nb, S // ns, d)
                       .transpose(1, 2).reshape(B, S, d))
                aux = torch.mean(aux)
            if shared_expert and "shared" in params:
                out = out + apply_mlp(x, params["shared"],
                                      activation=activation)
            return grad_in_layout(out), aux
    xt = replicate(x).reshape(B * S, d)
    out, aux = _moe_tokens(params, xt, **kw)
    if shared_expert and "shared" in params:
        out = out + apply_mlp(xt, params["shared"], activation=activation)
    return grad_in_layout(out.reshape(B, S, d)), aux
