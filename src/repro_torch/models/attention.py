"""Attention (port of ``src/repro/models/attention.py``): GQA/MQA/MHA
projections with optional biases, qk-norm, RoPE, the causal / sliding /
chunked / bidirectional masks, and three execution paths:

* ``attend_naive`` materializes the ``[S, T]`` scores (short sequences,
  and the oracle of the others);
* ``attend_blockwise`` streams the softmax over KV blocks in grouped form
  (``[B, S, Hkv, G, D]`` queries; KV never repeated to Hq), so a long
  sequence never materializes ``[S, S]``;
* ``attend_decode`` is one-token attention against a KV cache, in grouped
  form, masked by the absolute position stored in each cache slot.

``attention(use_pallas=True)`` and every prefill route the full-sequence
attention through ``kernels/ops.py:flash_attention`` (the CUDA kernel on a
CUDA tensor, its plain version on the CPU). The reference's prefill takes
``attend_naive`` or ``attend_blockwise`` by length; both compute the same
function. The kernel has no backward yet: under autograd
``attention(use_pallas=True)`` raises.

KV caches are full-length or ring buffers of the window (``ring=True``);
keys are stored post-RoPE, so a ring wrap needs no re-rotation. The port
writes a cache's tensors in place (the reference returns new arrays) and
keeps ``length`` as a host integer, so a decode step reads nothing back
from the card.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.kernels import ops as kops
from repro_torch.models.layers import apply_rope, dense_init, rms_norm
from repro_torch.utils.sharding_ctx import (batch_local, gather_dims,
                                            grad_in_layout, is_dtensor,
                                            local_layout, split_dim)

NEG_INF = -1e30


# ------------------------------------------------------------------- params
def init_attention(gen, d_model: int, n_heads: int, n_kv_heads: int,
                   head_dim: int, dtype, *, qk_norm: bool = False,
                   with_bias: bool = False, lead: tuple = (),
                   device=None) -> dict:
    kw = dict(lead=lead, device=device)
    p = {
        "wq": dense_init(gen, d_model, n_heads * head_dim, dtype, **kw),
        "wk": dense_init(gen, d_model, n_kv_heads * head_dim, dtype, **kw),
        "wv": dense_init(gen, d_model, n_kv_heads * head_dim, dtype, **kw),
        "wo": dense_init(gen, n_heads * head_dim, d_model, dtype, **kw),
    }
    zeros = lambda n: torch.zeros(lead + (n,), dtype=dtype,  # noqa: E731
                                  device=device)
    if qk_norm:  # rms_norm weights, stored as deltas around 1
        p["q_norm"] = zeros(head_dim)
        p["k_norm"] = zeros(head_dim)
    if with_bias:
        p["bq"] = zeros(n_heads * head_dim)
        p["bk"] = zeros(n_kv_heads * head_dim)
        p["bv"] = zeros(n_kv_heads * head_dim)
        p["bo"] = zeros(d_model)
    return p


def _project_qkv(params, x, n_heads, n_kv_heads, head_dim):
    x = batch_local(x)
    q = x @ params["wq"]
    k = x @ params["wk"]
    v = x @ params["wv"]
    if "bq" in params:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    return (split_dim(q, n_heads, head_dim),
            split_dim(k, n_kv_heads, head_dim),
            split_dim(v, n_kv_heads, head_dim))


def _qk_norm(params, q, k):
    if "q_norm" in params:
        q = rms_norm(q, params["q_norm"])
        k = rms_norm(k, params["k_norm"])
    return q, k


def _out(params, o, B, S):
    out = grad_in_layout(o.reshape(B, S, -1)) @ params["wo"]
    return grad_in_layout(out + params["bo"] if "bo" in params else out)


def _mask_kind(kind: str) -> str:
    return "causal" if kind == "full" else kind


# -------------------------------------------------------------------- masks
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


# ------------------------------------------------------------- naive oracle
def attend_naive(q, k, v, allowed):
    """q [B,S,H,D], k/v [B,T,H,D] (heads already matched). Scores in
    float32 over sqrt(D), masked with -1e30, probabilities cast back to
    q's dtype — the reference's numerics."""
    S, D, T = q.shape[1], q.shape[3], k.shape[1]
    scores = grad_in_layout(torch.einsum("bshd,bthd->bhst", q,
                                         k)).to(torch.float32)
    scores = scores / math.sqrt(D)
    qp = torch.arange(S, device=q.device)
    kp = torch.arange(T, device=q.device)
    mask = allowed(qp[:, None], kp[None, :])  # [S, T]
    scores = scores.masked_fill(~mask[None, None], NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return grad_in_layout(torch.einsum("bhst,bthd->bshd", probs.to(q.dtype),
                                       v))


# ------------------------------------------------------ blockwise (flash)
def attend_blockwise(q, k, v, allowed, *, block_size: int = 512):
    """Streaming-softmax attention over KV blocks of ``block_size``, GQA in
    grouped form (q ``[B,S,Hkv,G,D]``, k/v at Hkv heads, never repeated).
    The score and PV products take their inputs in float32 (the
    reference's ``preferred_element_type``), ``p`` cast to q's dtype
    first; running max and denominator in float32."""
    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    nblk = -(-T // block_size)
    pad = nblk * block_size - T
    # DTensor has no sharding rule for pad in torch 2.11: on DTensors the
    # last block is cut to the keys there are instead (a padded key adds
    # exactly 0 to a row that allows any key of its block)
    cut = is_dtensor(k)
    if pad and not cut:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    qg = q.reshape(B, S, Hkv, G, D).to(torch.float32)
    qpos = torch.arange(S, device=q.device)
    # the running sums take q's layout (a DTensor's shards, not a whole
    # replicated tensor)
    acc = torch.zeros_like(qg)
    m = torch.full_like(qg[..., 0], NEG_INF)
    denom = torch.zeros_like(m)
    for i in range(nblk):
        lo = i * block_size
        hi = min(lo + block_size, T) if cut else lo + block_size
        sl = slice(lo, hi)
        kpos = lo + torch.arange(hi - lo, device=q.device)
        scores = torch.einsum("bshgd,bthd->bshgt", qg,
                              k[:, sl].to(torch.float32)) / math.sqrt(D)
        ok = allowed(qpos[:, None], kpos[None, :]) & (kpos < T)[None, :]
        scores = torch.where(ok[None, :, None, None, :], scores, NEG_INF)
        m_new = torch.maximum(m, scores.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(scores - m_new[..., None])
        acc = acc * alpha[..., None] + torch.einsum(
            "bshgt,bthd->bshgd", p.to(q.dtype).to(torch.float32),
            v[:, sl].to(torch.float32))
        denom = denom * alpha + p.sum(dim=-1)
        m = m_new
    out = acc / torch.clamp(denom[..., None], min=1e-30)
    return out.reshape(B, S, Hq, D).to(q.dtype)


def _flash(q, k, v, kind, window, chunk):
    """Full-sequence attention through ``kops.flash_attention`` (read at
    call time, so a caller may swap the implementation)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "attention through the flash-attention kernel has no backward "
            "yet (ROADMAP.md, Beyond the reference item 1, the "
            "flash-attention backward kernel): train with "
            "use_pallas_attention=False")
    q, k, v = local_layout((q, k, v), (2, 2, 2), k.shape[2])
    return kops.flash_attention(q, k, v, kind=_mask_kind(kind),
                                window=window, chunk=chunk)


# ------------------------------------------------------------ full attention
def attention(params, x, *, n_heads: int, n_kv_heads: int, head_dim: int,
              kind: str = "causal", window: int = 0, chunk: int = 0,
              rope_theta: float = 1e4, use_rope: bool = True,
              block_size: int = 512, force_naive: bool = False,
              use_pallas: bool = False):
    """Training / prefill attention over a full sequence. Returns [B,S,d].
    The reference's three-way choice: the flash kernel (``use_pallas``),
    else ``attend_naive`` up to 1024 tokens (or ``force_naive``), else
    ``attend_blockwise``."""
    B, S, _ = x.shape
    q, k, v = _project_qkv(params, x, n_heads, n_kv_heads, head_dim)
    q, k = _qk_norm(params, q, k)
    if use_rope:
        pos = torch.arange(S, device=x.device)[None, :]
        q = apply_rope(q, pos, rope_theta)
        k = apply_rope(k, pos, rope_theta)
    if use_pallas and not force_naive:
        return _out(params, _flash(q, k, v, kind, window, chunk), B, S)
    allowed = mask_fn(_mask_kind(kind), window=window, chunk=chunk)
    # on DTensors each rank attends over its own batch rows or KV heads
    q, k, v = local_layout((q, k, v), (2, 2, 2), n_kv_heads)
    if force_naive or S <= 1024:
        groups = n_heads // n_kv_heads
        if groups > 1:  # repeat KV heads up to the query-head count
            k = torch.repeat_interleave(k, groups, dim=2)
            v = torch.repeat_interleave(v, groups, dim=2)
        out = attend_naive(q, k, v, allowed)
    else:
        out = attend_blockwise(q, k, v, allowed, block_size=block_size)
    return _out(params, out, B, S)


# ----------------------------------------------------------------- KV cache
class KVCache(NamedTuple):
    k: torch.Tensor       # [B, C, Hkv, D] (C = max len, or window for SWA)
    v: torch.Tensor       # [B, C, Hkv, D]
    pos: torch.Tensor     # [C] int32 absolute position of each slot (-1 empty)
    length: int           # tokens seen so far (a host integer)


def init_cache(batch: int, capacity: int, n_kv_heads: int, head_dim: int,
               dtype, *, device=None) -> KVCache:
    return KVCache(
        k=torch.zeros((batch, capacity, n_kv_heads, head_dim), dtype=dtype,
                      device=device),
        v=torch.zeros((batch, capacity, n_kv_heads, head_dim), dtype=dtype,
                      device=device),
        pos=torch.full((capacity,), -1, dtype=torch.int32, device=device),
        length=0)


def _roll(t, shift: int, dim: int):
    """``torch.roll(t, shift, dim)`` for ``0 <= shift < t.shape[dim]``, as
    two slices and a concatenation: DTensor has no sharding rule for
    ``roll`` in torch 2.11."""
    if shift == 0:
        return t
    n = t.shape[dim]
    return torch.cat([t.narrow(dim, n - shift, shift),
                      t.narrow(dim, 0, n - shift)], dim=dim)


def prefill_into_cache(cache: KVCache, k, v, *, ring: bool = False) -> KVCache:
    """Write a prefix [B, S, Hkv, D] (post-RoPE) into the cache, in place.

    Non-ring: slots [0, S). Ring (cap < S possible): token at absolute
    position p lands in slot p % cap, so later ring appends (slot = t %
    cap) always evict exactly the expired entry."""
    S = k.shape[1]
    cap = cache.k.shape[1]
    dev = cache.pos.device
    if ring and S > cap:
        shift = S % cap  # kept[i] has pos S-cap+i -> slot (i + S%cap) % cap
        cache.k.copy_(_roll(k[:, -cap:], shift, 1))
        cache.v.copy_(_roll(v[:, -cap:], shift, 1))
        cache.pos.copy_(_roll(torch.arange(S - cap, S, dtype=torch.int32,
                                           device=dev), shift, 0))
    else:
        cache.k[:, :S] = k
        cache.v[:, :S] = v
        cache.pos[:S] = torch.arange(S, dtype=torch.int32, device=dev)
    return cache._replace(length=S)


def append_to_cache(cache: KVCache, k1, v1, *, ring: bool = False) -> KVCache:
    """Append one token's K/V [B, 1, Hkv, D] in place; ring caches wrap, a
    full non-ring cache overwrites its last slot (the reference's clamp)."""
    cap = cache.k.shape[1]
    t = cache.length
    slot = t % cap if ring else min(t, cap - 1)
    if is_dtensor(cache.k):
        # a write at one slot of a slot-sharded cache would gather it:
        # select the slot elementwise, which every shard does alone
        at = (torch.arange(cap, device=cache.pos.device)
              == slot)[None, :, None, None]
        cache.k.copy_(torch.where(at, k1, cache.k))
        cache.v.copy_(torch.where(at, v1, cache.v))
    else:
        cache.k[:, slot] = k1[:, 0]
        cache.v[:, slot] = v1[:, 0]
    cache.pos[slot] = t
    return cache._replace(length=t + 1)


def attend_decode(q1, cache: KVCache, *, window: int = 0, chunk: int = 0,
                  kind: str = "full"):
    """One-token attention vs the cache, grouped-query form (no KV repeat).

    q1: [B, Hq, D]. Returns [B, Hq, D] in the cache's dtype. Scores in
    float32; the absolute position in each slot drives the mask, so full,
    sliding-window (ring) and chunked caches share this path."""
    B, Hq, D = q1.shape
    Hkv = cache.k.shape[2]
    # the query's heads whole (it is one token): the cache is sharded on
    # its slots, and DTensor's einsum would flatten a sharded head dim
    qg = gather_dims(split_dim(q1, Hkv, Hq // Hkv, dim=1), (1,))
    t = cache.length - 1  # absolute position of the query token
    scores = torch.einsum("bhgd,bshd->bhgs", qg.to(torch.float32),
                          cache.k.to(torch.float32)) / math.sqrt(D)
    kp = cache.pos
    ok = (kp >= 0) & (kp <= t)
    if kind == "sliding":
        ok = ok & (kp > t - window)
    elif kind == "chunked":
        ok = ok & ((kp // chunk) == (t // chunk))
    scores = scores.masked_fill(~ok[None, None, None, :], NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgs,bshd->bhgd", probs,
                       cache.v.to(torch.float32))
    return out.reshape(B, Hq, D).to(cache.k.dtype)


def decode_attention(params, x1, cache: KVCache, *, n_heads: int,
                     n_kv_heads: int, head_dim: int, kind: str = "full",
                     window: int = 0, chunk: int = 0, rope_theta: float = 1e4,
                     use_rope: bool = True, ring: bool = False):
    """Full decode step for one layer: project, RoPE at the absolute
    position ``cache.length``, append to the cache, attend. x1: [B, 1, d].
    Returns ([B, 1, d], the cache)."""
    B = x1.shape[0]
    q, k, v = _project_qkv(params, x1, n_heads, n_kv_heads, head_dim)
    q, k = _qk_norm(params, q, k)
    if use_rope:
        pos = torch.full((1, 1), cache.length, dtype=torch.int32,
                         device=x1.device)
        q = apply_rope(q, pos, rope_theta)
        k = apply_rope(k, pos, rope_theta)
    cache = append_to_cache(cache, k, v, ring=ring)
    out = attend_decode(q[:, 0], cache, window=window, chunk=chunk, kind=kind)
    return _out(params, out, B, 1), cache


def prefill_attention(params, x, *, n_heads: int, n_kv_heads: int,
                      head_dim: int, cache: KVCache, kind: str = "full",
                      window: int = 0, chunk: int = 0, rope_theta: float = 1e4,
                      use_rope: bool = True, ring: bool = False):
    """Prefill: full-sequence attention through the flash kernel AND the
    cache populated (post-RoPE). Returns ([B, S, d], the cache)."""
    B, S, _ = x.shape
    q, k, v = _project_qkv(params, x, n_heads, n_kv_heads, head_dim)
    q, k = _qk_norm(params, q, k)
    if use_rope:
        pos = torch.arange(S, device=x.device)[None, :]
        q = apply_rope(q, pos, rope_theta)
        k = apply_rope(k, pos, rope_theta)
    cache = prefill_into_cache(cache, k, v, ring=ring)
    return _out(params, _flash(q, k, v, kind, window, chunk), B, S), cache
