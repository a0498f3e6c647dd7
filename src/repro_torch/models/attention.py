"""Attention for training (port of ``src/repro/models/attention.py``):
GQA/MQA/MHA projections, RoPE, the causal / sliding / chunked masks and
``attend_naive`` (no qk-norm yet: the transformer refuses it).

The slice trains at sequence lengths <= 1024, where the reference also
takes ``attend_naive`` (``models/attention.py:194``), so the blockwise
flash path, the decode/prefill caches and the Pallas attention kernel wait
for later slices: a longer sequence raises.
"""

from __future__ import annotations

import math

import torch

from repro_torch.models.layers import apply_rope, dense_init

NEG_INF = -1e30
NAIVE_MAX_SEQ = 1024


def init_attention(gen, d_model: int, n_heads: int, n_kv_heads: int,
                   head_dim: int, dtype, *, lead: tuple = (),
                   device=None) -> dict:
    kw = dict(lead=lead, device=device)
    return {
        "wq": dense_init(gen, d_model, n_heads * head_dim, dtype, **kw),
        "wk": dense_init(gen, d_model, n_kv_heads * head_dim, dtype, **kw),
        "wv": dense_init(gen, d_model, n_kv_heads * head_dim, dtype, **kw),
        "wo": dense_init(gen, n_heads * head_dim, d_model, dtype, **kw),
    }


def _project_qkv(params, x, n_heads, n_kv_heads, head_dim):
    B, S, _ = x.shape
    q = (x @ params["wq"]).reshape(B, S, n_heads, head_dim)
    k = (x @ params["wk"]).reshape(B, S, n_kv_heads, head_dim)
    v = (x @ params["wv"]).reshape(B, S, n_kv_heads, head_dim)
    return q, k, v


def mask_fn(kind: str, *, window: int = 0, chunk: int = 0):
    """Returns allowed(q_pos, k_pos) -> bool tensor, broadcasting."""

    def allowed(qp, kp):
        ok = kp <= qp  # causal
        if kind == "sliding":
            ok = ok & (kp > qp - window)
        elif kind == "chunked":
            ok = ok & ((kp // chunk) == (qp // chunk))
        elif kind == "bidirectional":
            ok = torch.ones_like(ok)
        return ok

    return allowed


def attend_naive(q, k, v, allowed):
    """q [B,S,H,D], k/v [B,T,H,D] (heads already matched). Scores in
    float32 over sqrt(D), masked with -1e30, probabilities cast back to
    q's dtype — the reference's numerics."""
    S, D, T = q.shape[1], q.shape[3], k.shape[1]
    scores = torch.einsum("bshd,bthd->bhst", q, k).to(torch.float32)
    scores = scores / math.sqrt(D)
    qp = torch.arange(S, device=q.device)
    kp = torch.arange(T, device=q.device)
    mask = allowed(qp[:, None], kp[None, :])  # [S, T]
    scores = scores.masked_fill(~mask[None, None], NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhst,bthd->bshd", probs.to(q.dtype), v)


def attention(params, x, *, n_heads: int, n_kv_heads: int, head_dim: int,
              kind: str = "causal", window: int = 0, chunk: int = 0,
              rope_theta: float = 1e4, use_rope: bool = True):
    """Training attention over a full sequence. Returns [B, S, d]."""
    B, S, _ = x.shape
    if S > NAIVE_MAX_SEQ:
        raise NotImplementedError(
            f"sequence length {S} > {NAIVE_MAX_SEQ} needs the blockwise "
            "attention path, which is not yet ported")
    q, k, v = _project_qkv(params, x, n_heads, n_kv_heads, head_dim)
    if use_rope:
        pos = torch.arange(S, device=x.device)[None, :]
        q = apply_rope(q, pos, rope_theta)
        k = apply_rope(k, pos, rope_theta)
    allowed = mask_fn("causal" if kind == "full" else kind, window=window,
                      chunk=chunk)
    groups = n_heads // n_kv_heads
    if groups > 1:  # repeat KV heads up to the query-head count
        k = torch.repeat_interleave(k, groups, dim=2)
        v = torch.repeat_interleave(v, groups, dim=2)
    out = attend_naive(q, k, v, allowed)
    return out.reshape(B, S, n_heads * head_dim) @ params["wo"]
