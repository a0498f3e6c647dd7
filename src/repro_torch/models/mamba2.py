"""Mamba2 SSD (state-space duality) blocks [arXiv:2405.21060] (port of
``src/repro/models/mamba2.py``).

The SSD computation is implemented twice, as in the reference:

* ``ssd_naive``: the literal per-token recurrence
  ``h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t``, ``y_t = C_t h_t``; the
  correctness oracle.
* ``ssd_chunked``: the chunked dual form. The quadratic term within each
  chunk goes through ``kernels/ops.py:ssd_intra`` (the CUDA kernel of
  ``kernels/csrc/ssd_intra.cu`` on the card with ``use_kernel``, the plain
  version otherwise); the chunk states and the recurrence across them are
  plain PyTorch, the reference's ``lax.scan`` a loop over the chunks.

Routing: ``apply_mamba_block`` takes the kernel when
``cfg.use_pallas_ssd`` is set, as the reference does. The prefill
(``apply_mamba_block_prefill``) always asks ``ops.ssd_intra`` for its
``"auto"`` route, the kernel on the card and the plain version on the
CPU, where the reference's prefill leaves the kernel out (a deliberate
difference, logged in ROADMAP.md). Decode is O(1) in the sequence length:
the carried state is ``[B, H, P, N]`` in float32.

Parameters keep the reference's keys and layouts (``A_log =
log(linspace(1, 16, H))``, ``conv_w [conv_ch, K]``), so the reference's
trees carry across through ``models/convert.py``.

Grouped B/C (``cfg.ssm_groups`` G > 1, the nemotron_h family; no
reference counterpart): ``wB`` and ``wC`` project to ``[G * N]``, head
``j`` reads group ``j // (H / G)``, and the gated RMSNorm normalizes each
group's ``d_inner / G`` channels apart. ``cfg.ssm_heads`` sets the head
count, so ``d_inner = ssm_heads * ssm_headdim``. Grouped training runs the
plain SSD (``ssd_chunked``, ``ssd_naive`` on ``[B, S, G, N]`` B and C); the
SSD kernel and serving take one group and raise for more. With G = 1
every path is the one-group code.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops as kops
from repro_torch.models.layers import dense_init, rms_norm, torch_dtype
from repro_torch.utils.sharding_ctx import (batch_local, dense_shards,
                                            gather_dims, grad_in_layout,
                                            is_dtensor, local_layout,
                                            shard_residual, split_dim)

DEFAULT_CHUNK = 128


def ssm_dims(cfg: ArchConfig):
    """``(d_inner, heads, head dim, state)``."""
    if cfg.ssm_heads:
        return (cfg.ssm_heads * cfg.ssm_headdim, cfg.ssm_heads,
                cfg.ssm_headdim, cfg.ssm_state)
    d_inner = cfg.ssm_expand * cfg.d_model
    n_heads = d_inner // cfg.ssm_headdim
    return d_inner, n_heads, cfg.ssm_headdim, cfg.ssm_state


def _one_group(cfg: ArchConfig, what: str) -> None:
    if cfg.ssm_groups != 1:
        raise NotImplementedError(
            f"{cfg.name}: {what} takes one B/C group, not "
            f"ssm_groups={cfg.ssm_groups}")


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``, which is ``logaddexp(x, 0)`` at every x
    (``F.softplus`` returns x itself above its threshold of 20)."""
    return torch.logaddexp(x, torch.zeros_like(x))


# ------------------------------------------------------------------- params
def init_mamba_block(gen: torch.Generator, cfg: ArchConfig, *,
                     lead: tuple = (), device=None) -> dict:
    """Random block parameters ``[*lead, ...]`` from ``gen``: the
    reference's shapes and scales, not its draws."""
    d_inner, H, P, N = ssm_dims(cfg)
    GN = cfg.ssm_groups * N
    d, conv_ch = cfg.d_model, d_inner + 2 * GN
    dtype = torch_dtype(cfg.param_dtype)
    kw = dict(lead=lead, device=device)

    def full(n, value):
        return torch.full(lead + (n,), value, dtype=dtype, device=device)

    a_log = torch.log(torch.linspace(1.0, 16.0, H, dtype=torch.float64))
    return {
        "norm": full(d, 0.0),
        "wz": dense_init(gen, d, d_inner, dtype, **kw),
        "wx": dense_init(gen, d, d_inner, dtype, **kw),
        "wB": dense_init(gen, d, GN, dtype, **kw),
        "wC": dense_init(gen, d, GN, dtype, **kw),
        "wdt": dense_init(gen, d, H, dtype, **kw),
        "dt_bias": full(H, 0.0),
        "A_log": a_log.to(dtype=dtype, device=device).expand(
            lead + (H,)).contiguous(),
        "D": full(H, 1.0),
        "conv_w": (torch.randn(lead + (conv_ch, cfg.ssm_conv), generator=gen,
                               device=device) * 0.1).to(dtype),
        "conv_b": full(conv_ch, 0.0),
        "out_norm": full(d_inner, 0.0),
        "out_proj": dense_init(gen, d_inner, d, dtype, **kw),
    }


# --------------------------------------------------------------------- conv
def causal_conv(x: torch.Tensor, w: torch.Tensor,
                b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv. x: [B, S, C]; w: [C, K]: ``out_t = sum_k
    x_{t-K+1+k} w_k + b`` over the zero-padded past, a sum of K shifted
    products (no cuDNN, so no TF32). The zero past is concatenated, not
    padded: torch 2.11's DTensor gives ``F.pad``'s result one placement
    on a two-dim mesh."""
    K, S = w.shape[-1], x.shape[1]
    xp = torch.cat([x.new_zeros((x.shape[0], K - 1, x.shape[2])), x], dim=1)
    out = xp[:, 0:S] * w[:, 0]
    for k in range(1, K):
        out = out + xp[:, k:k + S] * w[:, k]
    return out + b


def conv_step(x1: torch.Tensor, conv_state: torch.Tensor, w: torch.Tensor,
              b: torch.Tensor):
    """One-token conv using the carried last K-1 inputs.
    x1: [B, C]; conv_state: [B, K-1, C] -> (out [B, C], new state)."""
    window = torch.cat([conv_state, x1[:, None, :]], dim=1)   # [B, K, C]
    out = torch.einsum("bkc,ck->bc", window, w) + b
    return out, window[:, 1:]


# ---------------------------------------------------------------------- SSD
def ssd_naive(x, dt, A, Bm, Cm, *, h0=None):
    """Literal recurrence. x: [B,S,H,P], dt: [B,S,H], A: [H] (tensors),
    Bm/Cm: [B,S,N], or [B,S,G,N] in G groups (head j reads group
    j // (H / G)). Returns (y [B,S,H,P], h_final [B,H,P,N])."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    f32 = torch.float32
    h = (torch.zeros((Bsz, H, P, N), dtype=f32, device=x.device)
         if h0 is None else h0)
    Af = A.to(f32)
    xf, dtf, bf, cf = (t.to(f32) for t in (x, dt, Bm, Cm))
    if Bm.dim() == 4:  # each head its group's B and C: [B,S,H,N]
        per = H // Bm.shape[2]
        bf = bf.repeat_interleave(per, dim=2)
        cf = cf.repeat_interleave(per, dim=2)
    ys = []
    for t in range(S):
        decay = torch.exp(dtf[:, t] * Af)[..., None, None]       # [B,H,1,1]
        b_t = bf[:, t, None, None, :] if bf.dim() == 3 else bf[:, t, :, None]
        inject = (dtf[:, t, :, None] * xf[:, t])[..., None] * b_t
        h = h * decay + inject                                   # [B,H,P,N]
        if cf.dim() == 3:
            ys.append(torch.einsum("bhpn,bn->bhp", h, cf[:, t]))
        else:
            ys.append(torch.einsum("bhpn,bhn->bhp", h, cf[:, t]))
    return torch.stack(ys, dim=1).to(x.dtype), h


class _ChunkCumsum(torch.autograd.Function):
    """The inclusive cumsum over dim 2 whose backward, the reverse cumsum,
    is a product with a triangular matrix: DTensor has no sharding rule
    for ``flip`` (autograd's reverse cumsum) in torch 2.11."""

    @staticmethod
    def forward(ctx, a):
        return torch.cumsum(a, dim=2)

    @staticmethod
    def backward(ctx, g):
        n = g.shape[2]
        upper = torch.ones((n, n), dtype=g.dtype,
                           device=g.device).tril()      # [i, j]: i >= j
        return torch.einsum("bcih,ij->bcjh", g, upper)


def _chunk_cumsum(a):
    """``torch.cumsum(a, dim=2)`` (``a`` ``[B, Nc, Lc, H]``), on a DTensor
    that needs a gradient through :class:`_ChunkCumsum`."""
    if is_dtensor(a) and a.requires_grad:
        return _ChunkCumsum.apply(a)
    return torch.cumsum(a, dim=2)


def ssd_chunked(x, dt, A, Bm, Cm, *, chunk: int = DEFAULT_CHUNK, h0=None,
                use_kernel: bool = False):
    """Chunked dual form. Same signature/returns as ssd_naive.
    ``use_kernel`` computes the intra-chunk term through
    ``ops.ssd_intra(impl="auto")`` (the CUDA kernel for CUDA tensors);
    without it, through the plain version, the reference's einsums.
    Grouped B and C (``[B, S, G, N]``) go through :func:`_ssd_grouped`."""
    if Bm.dim() == 4:
        if use_kernel:
            raise NotImplementedError(
                "the SSD kernel takes one B/C group; grouped B and C "
                f"({Bm.shape[2]} groups) train through the plain SSD")
        return _ssd_grouped(x, dt, A, Bm, Cm, chunk=chunk, h0=h0)
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    Lc = min(chunk, S)
    pad = (-S) % Lc
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
    Sp = S + pad
    Nc = Sp // Lc
    f32 = torch.float32
    # contiguous: the kernel takes dense operands, and x, Bm, Cm arrive as
    # column slices of one projection.
    xf = x.reshape(Bsz, Nc, Lc, H, P).to(f32).contiguous()
    dtf = dt.reshape(Bsz, Nc, Lc, H).to(f32).contiguous()
    Bf = Bm.reshape(Bsz, Nc, Lc, N).to(f32).contiguous()
    Cf = Cm.reshape(Bsz, Nc, Lc, N).to(f32).contiguous()

    a = dtf * A.to(f32)                 # log-decay increments
    a_cs = _chunk_cumsum(a)             # inclusive cumsum within chunk

    # y_intra[i] = sum_{j<=i} (C_i . B_j) exp(a_cs[i] - a_cs[j]) dt[j] x[j]
    y_intra = kops.ssd_intra(
        *local_layout((xf, dtf, a_cs, Bf, Cf), (3, 3, 3, None, None), H),
        impl="auto" if use_kernel else "ref").to(f32)

    # state_c = sum_j B_j^T (dt_j x_j) exp(a_end - a_cs[j])   [B,Nc,H,P,N]
    decay_to_end = torch.exp(a_cs[:, :, -1:, :] - a_cs)        # [B,Nc,Lc,H]
    states = torch.einsum("bcjh,bcjhp,bcjn->bchpn", dtf * decay_to_end, xf,
                          Bf)
    # the chunk states whole in their heads and head dims, as the carried
    # state below: DTensor's einsums would flatten a sharded head dim
    states = gather_dims(states, (2, 3))

    # recurrence over chunk states; h_prevs[c] is the state BEFORE chunk c
    chunk_decay = torch.exp(torch.sum(a, dim=2))                # [B,Nc,H]
    h = (torch.zeros((Bsz, H, P, N), dtype=f32, device=x.device)
         if h0 is None else gather_dims(h0, (1, 2)))
    h_prevs = []
    for c in range(Nc):
        h_prevs.append(h)
        h = h * chunk_decay[:, c, :, None, None] + states[:, c]
    h_prevs = torch.stack(h_prevs, dim=1)                       # [B,Nc,H,P,N]

    # y_inter[i] = C_i . (exp(a_cs[i]) h_prev)
    y_inter = torch.einsum("bcin,bcih,bchpn->bcihp", Cf, torch.exp(a_cs),
                           h_prevs)
    y = (y_intra + y_inter).reshape(Bsz, Sp, H, P)[:, :S]
    return y.to(x.dtype), h


def _ssd_grouped(x, dt, A, Bm, Cm, *, chunk: int, h0=None):
    """:func:`ssd_chunked` with B and C in ``G`` groups, ``[B, S, G, N]``:
    the heads split as ``(G, R)``, ``R = H / G``, and each group's
    ``C_i . B_j`` is shared by its R heads. Plain PyTorch throughout."""
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    R = H // G
    Lc = min(chunk, S)
    pad = (-S) % Lc
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, 0, 0, pad))
    Nc = (S + pad) // Lc
    f32 = torch.float32
    xf = x.reshape(Bsz, Nc, Lc, G, R, P).to(f32)
    dtf = dt.reshape(Bsz, Nc, Lc, G, R).to(f32)
    Bf = Bm.reshape(Bsz, Nc, Lc, G, N).to(f32)
    Cf = Cm.reshape(Bsz, Nc, Lc, G, N).to(f32)
    a = dtf * A.to(f32).reshape(G, R)
    a_cs = torch.cumsum(a, dim=2)                            # [B,Nc,Lc,G,R]

    # y_intra[i] = sum_{j<=i} (C_i . B_j) exp(a_cs[i] - a_cs[j]) dt[j] x[j],
    # the causal mask on before the exp (an acausal difference is > 0)
    cb = torch.einsum("bcign,bcjgn->bcijg", Cf, Bf)
    seg = a_cs[:, :, :, None] - a_cs[:, :, None, :]         # [B,Nc,i,j,G,R]
    causal = torch.ones((Lc, Lc), dtype=torch.bool,
                        device=x.device).tril()[None, None, :, :, None, None]
    w = cb[..., None] * torch.exp(torch.where(causal, seg, -torch.inf))
    y_intra = torch.einsum("bcijgr,bcjgrp->bcigrp", w, dtf[..., None] * xf)

    # chunk states [B,Nc,G,R,P,N] and the recurrence across chunks
    decay_to_end = torch.exp(a_cs[:, :, -1:] - a_cs)
    states = torch.einsum("bcjgrp,bcjgn->bcgrpn",
                          (dtf * decay_to_end)[..., None] * xf, Bf)
    chunk_decay = torch.exp(torch.sum(a, dim=2))             # [B,Nc,G,R]
    h = (torch.zeros((Bsz, G, R, P, N), dtype=f32, device=x.device)
         if h0 is None else h0.reshape(Bsz, G, R, P, N))
    h_prevs = []
    for c in range(Nc):
        h_prevs.append(h)
        h = h * chunk_decay[:, c, :, :, None, None] + states[:, c]
    h_prevs = torch.stack(h_prevs, dim=1)                    # [B,Nc,G,R,P,N]
    y_inter = torch.einsum("bcign,bcgrpn->bcigrp", Cf, h_prevs) \
        * torch.exp(a_cs)[..., None]
    y = (y_intra + y_inter).reshape(Bsz, Nc * Lc, H, P)[:, :S]
    return y.to(x.dtype), h.reshape(Bsz, H, P, N)


# ------------------------------------------------------------------- block
class SSMCache(NamedTuple):
    conv: torch.Tensor    # [B, K-1, conv_ch]
    state: torch.Tensor   # [B, H, P, N] (float32)
    #: tokens seen: a host int (the reference keeps an int32 array), so a
    #: decode step reads nothing back from the card.
    length: int


def init_ssm_cache(batch: int, cfg: ArchConfig, dtype,
                   device=None) -> SSMCache:
    _one_group(cfg, "the SSM cache")
    d_inner, H, P, N = ssm_dims(cfg)
    conv_ch = d_inner + 2 * N
    return SSMCache(
        conv=torch.zeros((batch, cfg.ssm_conv - 1, conv_ch), dtype=dtype,
                         device=device),
        state=torch.zeros((batch, H, P, N), dtype=torch.float32,
                          device=device),
        length=0)


def _ssm_inputs(p, u, cfg: ArchConfig):
    dims = ssm_dims(cfg)
    u = batch_local(u)
    z = u @ p["wz"]
    xBC = torch.cat([u @ p["wx"], u @ p["wB"], u @ p["wC"]], dim=-1)
    return z, xBC, dims


def _ssd_operands(p, h, xBC, dims, groups: int = 1):
    """(x [B,S,H,P], dt, A, Bm, Cm) from the conv's output; Bm and Cm
    ``[B,S,N]``, or ``[B,S,G,N]`` in ``groups`` > 1."""
    d_inner, H, P, N = dims
    x, Bm, Cm = torch.split(xBC, [d_inner, groups * N, groups * N], dim=-1)
    x = split_dim(x, H, P)
    if groups > 1:
        Bm = Bm.unflatten(-1, (groups, N))
        Cm = Cm.unflatten(-1, (groups, N))
    dt = softplus((batch_local(h) @ p["wdt"]) + p["dt_bias"])
    A = -torch.exp(p["A_log"].to(torch.float32))
    return x, dt, A, Bm, Cm


def _out(p, u, y, x, z, d_inner, cfg: ArchConfig):
    y = dense_shards(y + p["D"][None, None, :, None] * x)
    y = y.reshape(*y.shape[:2], d_inner)
    y = y * F.silu(z)
    G = cfg.ssm_groups
    if G == 1:
        y = rms_norm(y, p["out_norm"], eps=cfg.norm_eps)
    else:  # the gated norm over each group's d_inner / G channels
        y = rms_norm(y.unflatten(-1, (G, d_inner // G)),
                     p["out_norm"].unflatten(-1, (G, d_inner // G)),
                     eps=cfg.norm_eps).flatten(-2)
    return u + grad_in_layout(y @ p["out_proj"])


def apply_mamba_block(p, u, cfg: ArchConfig, *, naive: bool = False):
    """Full-sequence mamba2 block. u: [B, S, d] -> [B, S, d]."""
    u = shard_residual(u)
    h = rms_norm(u, p["norm"], eps=cfg.norm_eps)
    z, xBC, dims = _ssm_inputs(p, h, cfg)
    xBC = F.silu(causal_conv(xBC, p["conv_w"], p["conv_b"]))
    x, dt, A, Bm, Cm = _ssd_operands(p, h, xBC, dims, cfg.ssm_groups)
    if naive:
        y, _ = ssd_naive(x, dt, A, Bm, Cm)
    else:
        y, _ = ssd_chunked(x, dt, A, Bm, Cm, use_kernel=cfg.use_pallas_ssd)
    return _out(p, u, y, x, z, dims[0], cfg)


def apply_mamba_block_prefill(p, u, cache: SSMCache, cfg: ArchConfig):
    """Full-sequence forward that also returns the carried SSM/conv state;
    the intra-chunk term through ``ops.ssd_intra``'s auto route."""
    _one_group(cfg, "the prefill")
    S = u.shape[1]
    h = rms_norm(u, p["norm"], eps=cfg.norm_eps)
    z, xBC, dims = _ssm_inputs(p, h, cfg)
    keep = cfg.ssm_conv - 1
    if S < keep:  # degenerate tiny-seq case
        conv_tail = torch.cat([cache.conv[:, S:],
                               xBC.to(cache.conv.dtype)], dim=1)
    else:  # a copy: a view would keep all of xBC alive in the cache
        conv_tail = xBC[:, S - keep:].to(cache.conv.dtype).contiguous()
    xBC = F.silu(causal_conv(xBC, p["conv_w"], p["conv_b"]))
    x, dt, A, Bm, Cm = _ssd_operands(p, h, xBC, dims)
    y, h_final = ssd_chunked(x, dt, A, Bm, Cm, h0=cache.state,
                             use_kernel=True)
    out = _out(p, u, y, x, z, dims[0], cfg)
    return out, SSMCache(conv=conv_tail, state=h_final,
                         length=cache.length + S)


def apply_mamba_block_decode(p, u1, cache: SSMCache, cfg: ArchConfig):
    """One-token step. u1: [B, 1, d]."""
    _one_group(cfg, "the decode step")
    B_ = u1.shape[0]
    h = rms_norm(u1[:, 0], p["norm"], eps=cfg.norm_eps)
    z = h @ p["wz"]
    xBC1 = torch.cat([h @ p["wx"], h @ p["wB"], h @ p["wC"]], dim=-1)
    d_inner, H, P, N = ssm_dims(cfg)
    xBC, conv_state = conv_step(xBC1, cache.conv, p["conv_w"], p["conv_b"])
    xBC = F.silu(xBC)
    x, Bm, Cm = torch.split(xBC, [d_inner, N, N], dim=-1)
    x = split_dim(x, H, P)
    dt = softplus(h @ p["wdt"] + p["dt_bias"])               # [B, H]
    A = -torch.exp(p["A_log"].to(torch.float32))
    decay = torch.exp(dt.to(torch.float32) * A)              # [B, H]
    inject = (dt[..., None] * x)[..., None] * Bm[:, None, None, :]
    state = cache.state * decay[..., None, None] + inject
    # the state whole in its heads and head dims: DTensor's einsum would
    # flatten a sharded head dim (torch 2.11 refuses)
    y = torch.einsum("bhpn,bn->bhp", gather_dims(state, (1, 2)),
                     Cm.to(torch.float32))
    y = (y + p["D"][None, :, None] * x).reshape(B_, d_inner).to(u1.dtype)
    y = rms_norm(y * F.silu(z), p["out_norm"], eps=cfg.norm_eps)
    out = u1[:, 0] + y @ p["out_proj"]
    return out[:, None, :], SSMCache(conv=conv_state, state=state,
                                     length=cache.length + 1)
