"""Activation checkpointing (the port's ``jax.checkpoint``).

``checkpoint(body)`` wraps a layer body so that the backward pass keeps
only the body's inputs and recomputes the rest: the reference's
``jax.checkpoint`` on its scanned layer bodies (under ``cfg.remat``), on
each KV block of the blockwise attention and on each chunk of the
chunked cross entropy (always).

The port takes its gradients inside ``torch.func`` transforms
(``vmap(grad(loss))``), where ``torch.utils.checkpoint`` does not work
(saved-tensor hooks are refused there). So the wrapper is a
``torch.autograd.Function`` with a generated vmap rule: ``forward`` runs
the body, ``setup_context`` saves only the inputs, and ``backward`` runs
the body again under ``torch.func.vjp`` and returns the vjp of the
incoming gradients. The same operations run in the same order, so the
gradients equal the unwrapped body's. The recompute is not recorded, so
a rematerialized body has no second derivative.

On DTensors (the lowered step's ``torch.autograd.grad`` over a mesh,
``core/api.py:spmd_grad``) the recompute takes ``torch.autograd.grad``
instead: the model's layout helpers must see the DTensors, which a
``torch.func`` transform hides.

Nested bodies (the blockwise attention's blocks inside a rematerialized
encoder layer) are wrapped only at the outer level: without autograd
(the outer forward, and serving) and inside an outer recompute the inner
bodies run as they are.

Every tensor the body reads must come in through its arguments (pytrees
of tensors): a tensor closed over would get no gradient and would escape
the vmap rule. Static arguments (the config, ints, flags) are closed
over. Integer tensors (token ids) may be passed; they get no gradient.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.utils import _pytree as pytree

from repro_torch.utils.sharding_ctx import is_dtensor

__all__ = ["checkpoint"]


#: how many recomputes are running: a body wrapped inside a body being
#: recomputed runs as is (functorch cannot nest one recompute's vjp in
#: another's), so the recompute keeps one outer body's intermediates.
_RECOMPUTING = [0]


class _Recompute(torch.autograd.Function):
    generate_vmap_rule = True

    @staticmethod
    def forward(run, *leaves):
        return run(*leaves)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.run = inputs[0]
        ctx.save_for_backward(*inputs[1:])

    @staticmethod
    def backward(ctx, *grads):
        leaves = ctx.saved_tensors
        diff = [i for i, t in enumerate(leaves)
                if t.is_floating_point() and ctx.needs_input_grad[i + 1]]

        def run_diff(*prims):
            full = list(leaves)
            for i, p in zip(diff, prims):
                full[i] = p
            return ctx.run(*full)

        prims = [leaves[i] for i in diff]
        _RECOMPUTING[0] += 1
        try:
            if any(is_dtensor(t) for t in leaves):
                got = _autograd_vjp(run_diff, prims, grads)
            else:
                # detached: torch.func's grad runs this backward with
                # create_graph, so the vjp's history would keep every
                # recompute's graph alive until the whole gradient is done
                got = [g.detach() for g in torch.func.vjp(
                    run_diff, *prims)[1](tuple(grads))]
        finally:
            _RECOMPUTING[0] -= 1
        out = [None] * len(leaves)
        for i, g in zip(diff, got):
            out[i] = g
        return (None, *out)


def _autograd_vjp(run, prims, grads):
    """The recompute's vjp through ``torch.autograd.grad`` (DTensors)."""
    prims = [p.detach().requires_grad_(True) for p in prims]
    with torch.enable_grad():
        outs = run(*prims)
        pairs = [(o, g) for o, g in zip(outs, grads) if o.requires_grad]
        got = torch.autograd.grad([o for o, _ in pairs],
                                  prims, [g for _, g in pairs],
                                  allow_unused=True)
    return [torch.zeros_like(p) if g is None else g
            for p, g in zip(prims, got)]


def checkpoint(body: Callable) -> Callable:
    """``body`` (a function of pytrees of tensors returning a tensor or a
    pytree of tensors) as a function whose backward recomputes it from its
    inputs."""

    def wrapped(*args):
        if not torch.is_grad_enabled() or _RECOMPUTING[0]:
            return body(*args)  # serving, or inside an outer recompute
        leaves, in_spec = pytree.tree_flatten(args)
        out_spec = []

        def run(*flat):
            out, spec = pytree.tree_flatten(
                body(*pytree.tree_unflatten(list(flat), in_spec)))
            out_spec[:] = [spec]
            return tuple(out)

        out = _Recompute.apply(run, *leaves)
        return pytree.tree_unflatten(list(out), out_spec[0])

    return wrapped
