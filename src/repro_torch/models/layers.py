"""Shared building blocks (port of ``src/repro/models/layers.py``): pure
functions over parameter dicts, with the reference's layouts (dense
weights ``[d_in, d_out]``, used as ``x @ w``) and its numerics: RMSNorm,
LayerNorm and RoPE compute in float32 whatever the input dtype, exactly
where the reference casts."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.utils.sharding_ctx import (batch_local, grad_in_layout,
                                            resolve_partial)

_DTYPES = {"float32": torch.float32, "float64": torch.float64,
           "bfloat16": torch.bfloat16}


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a config's dtype name."""
    return _DTYPES[name]


# --------------------------------------------------------------------- init
def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype, *,
               lead: tuple = (), scale: float | None = None,
               device=None) -> torch.Tensor:
    """N(0, 1/d_in) weights ``[*lead, d_in, d_out]``."""
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    w = torch.randn(lead + (d_in, d_out), generator=gen, device=device)
    return (w * scale).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int, dtype, *,
               device=None) -> torch.Tensor:
    return (torch.randn((vocab, d), generator=gen, device=device)
            * 0.02).to(dtype)


def init_norm(d: int, dtype, *, with_bias: bool = False, lead: tuple = (),
              device=None) -> dict:
    """LayerNorm ``weight`` (ones) and ``bias`` (zeros) when ``with_bias``;
    else the RMSNorm weight, stored as a delta around 1 (zeros =
    identity)."""
    shape = lead + (d,)
    if with_bias:
        return {"weight": torch.ones(shape, dtype=dtype, device=device),
                "bias": torch.zeros(shape, dtype=dtype, device=device)}
    return {"weight": torch.zeros(shape, dtype=dtype, device=device)}


def embed_lookup(tokens: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Rows ``table[tokens]``; a lookup in a vocab-sharded table is summed
    across its shards at once (``resolve_partial``)."""
    return resolve_partial(F.embedding(tokens.to(torch.int64), table))


# -------------------------------------------------------------------- norms
def rms_norm(x: torch.Tensor, weight: torch.Tensor, *,
             eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(x * x, dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps)
    return (out * (1.0 + weight.to(torch.float32))).to(dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, *,
               eps: float = 1e-5) -> torch.Tensor:
    dtype = x.dtype
    x = x.to(torch.float32)
    mean = torch.mean(x, dim=-1, keepdim=True)
    var = torch.var(x, dim=-1, keepdim=True, correction=0)
    out = (x - mean) * torch.rsqrt(var + eps)
    return (out * weight.to(torch.float32)
            + bias.to(torch.float32)).to(dtype)


def apply_norm(x: torch.Tensor, params: dict,
               kind: str = "rmsnorm") -> torch.Tensor:
    if kind == "layernorm":
        return layer_norm(x, params["weight"], params["bias"])
    return rms_norm(x, params["weight"])


# --------------------------------------------------------------------- rope
def rope_frequencies(head_dim: int, theta: float,
                     device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 1e4) -> torch.Tensor:
    """x: [..., S, H, Dh]; positions: broadcastable to [..., S]. Half-split
    layout (first half / second half of Dh), in float32."""
    head_dim = x.shape[-1]
    freqs = rope_frequencies(head_dim, theta, device=x.device)     # [Dh/2]
    angles = positions[..., None].to(torch.float32) * freqs        # [..., S, Dh/2]
    angles = angles[..., None, :]                                  # [..., S, 1, Dh/2]
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(n_pos: int, d: int, dtype=torch.float32,
                         device=None) -> torch.Tensor:
    """Whisper-style fixed sinusoidal position embeddings ``[n_pos, d]``:
    ``[sin | cos]`` of ``pos / 10000 ** (2i / d)``, in float32."""
    inv = 1.0 / (10000.0 ** (torch.arange(0, d, 2, dtype=torch.float32,
                                          device=device) / d))
    ang = torch.arange(n_pos, dtype=torch.float32,
                       device=device)[:, None] * inv[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


# ---------------------------------------------------------------------- mlp
def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu(x, approximate=True)``, the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def relu2(x: torch.Tensor) -> torch.Tensor:
    """Squared ReLU, ``relu(x)²`` (nemotron_h's ``relu2``)."""
    return torch.square(F.relu(x))


def init_mlp(gen: torch.Generator, d: int, d_ff: int, dtype, *,
             activation: str, with_bias: bool = False, lead: tuple = (),
             device=None) -> dict:
    """Gated (``swiglu``, ``geglu``: ``gate``, ``up``, ``down``) or plain
    GELU or squared-ReLU (``up``, ``down``) weights; ``with_bias`` adds
    zero ``up_b [d_ff]`` and ``down_b [d]`` (the gated forms carry them
    unused, as in the reference)."""
    kw = dict(lead=lead, device=device)
    if activation in ("swiglu", "geglu"):
        p = {"gate": dense_init(gen, d, d_ff, dtype, **kw),
             "up": dense_init(gen, d, d_ff, dtype, **kw),
             "down": dense_init(gen, d_ff, d, dtype, **kw)}
    elif activation in ("gelu", "relu2"):  # plain (whisper, nemotron_h)
        p = {"up": dense_init(gen, d, d_ff, dtype, **kw),
             "down": dense_init(gen, d_ff, d, dtype, **kw)}
    else:
        raise ValueError(f"unknown MLP activation {activation!r}")
    if with_bias:
        p["up_b"] = torch.zeros(lead + (d_ff,), dtype=dtype, device=device)
        p["down_b"] = torch.zeros(lead + (d,), dtype=dtype, device=device)
    return p


def apply_mlp(x: torch.Tensor, params: dict, *,
              activation: str) -> torch.Tensor:
    x = batch_local(x)
    if activation in ("swiglu", "geglu"):
        act = F.silu if activation == "swiglu" else gelu_tanh
        h = act(x @ params["gate"]) * (x @ params["up"])
        return grad_in_layout(h @ params["down"])
    h = x @ params["up"]
    if "up_b" in params:
        h = h + params["up_b"]
    out = (relu2(h) if activation == "relu2" else gelu_tanh(h)) \
        @ params["down"]
    if "down_b" in params:
        out = out + params["down_b"]
    return grad_in_layout(out)
