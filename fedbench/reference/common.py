"""Helpers the family references share: nested parameter trees as flat
``{dotted name: tensor}`` views, weights made in one draw, RMSNorm and
RoPE as published."""

from __future__ import annotations

import math

import torch


def flatten(tree, prefix: str = "") -> dict:
    """``{dotted path: leaf}`` of a tree of dicts, in insertion order."""
    out = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flatten(v, name + "."))
        else:
            out[name] = v
    return out


def unflatten(flat: dict) -> dict:
    """Inverse of :func:`flatten`."""
    tree: dict = {}
    for name, v in flat.items():
        *path, last = name.split(".")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[last] = v
    return tree


def make_weights(spec: dict, seed: int, device) -> tuple:
    """Weights from ``spec`` ``{name: (shape, init)}`` in one buffer:
    ``("normal", std)``, ``("uniform", lo, hi)``, ``("const", value)`` or
    ``("log_uniform", lo, hi)`` (``log`` of a uniform draw on ``[lo,
    hi)``), ``("inv_softplus_log_uniform", lo, hi)`` (the inverse softplus
    of ``exp`` of a uniform draw on ``[log lo, log hi)``). One normal and
    one uniform draw from a generator on ``device`` seeded with ``seed``
    fill every leaf. Returns ``(flat buffer, {name: view})``."""
    sizes = {n: math.prod(s) for n, (s, _) in spec.items()}
    total = sum(sizes.values())
    n_normal = sum(sizes[n] for n, (_, i) in spec.items() if i[0] == "normal")
    n_uniform = sum(sizes[n] for n, (_, i) in spec.items()
                    if i[0] not in ("normal", "const"))
    gen = torch.Generator(device=device).manual_seed(seed)
    normal = torch.randn(n_normal, generator=gen, device=device)
    unif = torch.rand(max(n_uniform, 1), generator=gen, device=device)
    buf = torch.empty(total, device=device)
    views, off, on, ou = {}, 0, 0, 0
    for name, (shape, init) in spec.items():
        n = sizes[name]
        dst = buf[off:off + n]
        kind = init[0]
        if kind == "normal":
            torch.mul(normal[on:on + n], init[1], out=dst)
            on += n
        elif kind == "const":
            dst.fill_(init[1])
        else:
            u = unif[ou:ou + n]
            ou += n
            lo, hi = init[1], init[2]
            if kind == "uniform":
                torch.add(u * (hi - lo), lo, out=dst)
            elif kind == "log_uniform":
                dst.copy_(torch.log(u * (hi - lo) + lo))
            elif kind == "inv_softplus_log_uniform":
                dt = torch.exp(u * (math.log(hi) - math.log(lo))
                               + math.log(lo))
                dst.copy_(dt + torch.log(-torch.expm1(-dt)))
            else:
                raise ValueError(f"unknown init {init!r} for {name}")
        views[name] = dst.view(shape)
        off += n
    del normal, unif
    return buf, views


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm with its weight stored as a delta around 1."""
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) \
        * (1.0 + w)


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embeddings of ``x`` ``[B, S, H, D]`` at positions 0..S-1,
    ``rotate_half`` layout (the first half of D pairs with the second)."""
    S, D = x.shape[1], x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, D, 2, dtype=torch.float32,
                                       device=x.device) / D)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
    x1, x2 = x[..., :D // 2], x[..., D // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def next_token_ce(hidden: torch.Tensor, head: torch.Tensor,
                  tokens: torch.Tensor, logits_scaling: float) -> torch.Tensor:
    """Mean cross entropy of ``hidden [B, S, d] @ head`` predicting
    ``tokens[:, 1:]``."""
    logits = (hidden[:, :-1] @ head) / logits_scaling
    gold = torch.gather(logits, -1, tokens[:, 1:, None].long())[..., 0]
    return torch.mean(torch.logsumexp(logits, dim=-1) - gold)
