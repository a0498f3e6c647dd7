"""Plain PyTorch versions of the port's kernels (port of
``src/repro/kernels/ref.py``, and the math of the Pallas
flash-attention kernel, ``src/repro/kernels/flash_attention.py``), term
for term: the CPU path of ``kernels/ops.py`` and the yardstick the CUDA
kernels are held against."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.threefry import LANES

#: threads per block of the client sketch (``csrc/telemetry_reduce.cu``)
#: and the block count it aims for over all clients.
SKETCH_THREADS = 256
SKETCH_BLOCKS = 1024


def fedcet_v(x, g, d, alpha: float):
    """The FedCET local-step triad: v = x - alpha*g - alpha*d.

    (== the paper's 2x(t) - x(t-1) - a grad(t) + a grad(t-1), via Lemma 1.)
    """
    return x - alpha * g - alpha * d


def fedcet_comm(d, m, m_bar, c: float, alpha: float, v=None):
    """The FedCET aggregation step:
    d' = d + c (m - m_bar);  x' = v - c*alpha*(m - m_bar).

    ``m`` is the client's own WIRE message and ``v`` the exact local vector
    the x-update starts from; without compression they coincide (the
    ``v=None`` default). ``m_bar`` broadcasts against ``m`` (``[1, ...]``)."""
    if v is None:
        v = m
    delta = m - m_bar
    return d + c * delta, v - (c * alpha) * delta


def fedcet_round_tail(v, h, d, u, scale, w, den, *, c: float, alpha: float,
                      beta: float, bits: int):
    """The whole shift:q8 -> reduce -> FedCET pair round tail, one pass.

    With ``h`` the shift memory and ``q`` the dithered fixed-point code of
    the residual ``v - h``::

        q     = clip(floor((v - h)/scale + u), -levels, levels)
        recon = h + q*scale                    # the wire message
        m_bar = sum_c(recon * w) / den         # (masked) client mean
        d'    = d + c*(recon - m_bar)
        x'    = v - c*alpha*(recon - m_bar)
        h'    = h + beta*q*scale               # the DIANA shift step

    Shapes: ``v``/``h``/``d`` ``[clients, rows, lanes]``; ``u`` the
    client-shared dither ``[rows, lanes]``; ``scale`` one step per row
    (``[rows, 1]`` or ``[rows]``); ``w`` the ``clients`` weights (ones, or
    the participation mask) and ``den`` their one-element denominator.

    One change from the reference: the client sum runs in a FIXED
    sequential order, ``acc = recon[0]*w[0]``, then ``acc + recon[c]*w[c]``
    for c = 1, 2, ..., and only then ``/ den``. The CUDA kernel sums in the
    same order, so the card check holds a tolerance of 0. Returns
    ``(d', x', h')``."""
    levels = 2 ** (bits - 1) - 1
    scale = scale.reshape(-1, 1)
    inv = torch.where(scale > 0, 1.0 / scale, 0.0)
    q = torch.clamp(torch.floor((v - h) * inv + u), -levels, levels)
    qs = q * scale
    recon = h + qs
    w = w.reshape(-1)
    acc = recon[0] * w[0]
    for k in range(1, recon.shape[0]):
        acc = acc + recon[k] * w[k]
    m_bar = (acc / den.reshape(()))[None]
    delta = recon - m_bar
    return d + c * delta, v - (c * alpha) * delta, h + beta * qs


def ssd_intra(x, dt, a_cs, Bm, Cm):
    """The Mamba2 SSD intra-chunk term (``src/repro/kernels/ref.py:62``):
    ``y_i = sum_{j<=i} (C_i . B_j) exp(a_cs_i - a_cs_j) dt_j x_j`` per
    (batch, chunk, head), with x ``[B, Nc, Lc, H, P]``, dt and a_cs
    ``[B, Nc, Lc, H]``, Bm and Cm ``[B, Nc, Lc, N]``. Sums in float32;
    returns x's shape and dtype. The causal mask goes on BEFORE the exp:
    an acausal entry has ``a_cs_i - a_cs_j > 0`` and would overflow."""
    cb = torch.einsum("bcin,bcjn->bcij", Cm.to(torch.float32),
                      Bm.to(torch.float32))
    acs = a_cs.to(torch.float32)
    seg = acs[:, :, :, None, :] - acs[:, :, None, :, :]      # [B,Nc,i,j,H]
    lc = x.shape[2]
    causal = torch.tril(torch.ones((lc, lc), dtype=torch.bool,
                                   device=x.device))[None, None, :, :, None]
    seg = torch.where(causal, seg, -math.inf)
    w = cb[..., None] * torch.exp(seg)
    y = torch.einsum("bcijh,bcjh,bcjhp->bcihp", w, dt.to(torch.float32),
                     x.to(torch.float32))
    return y.to(x.dtype)


def stochastic_quantize(a, u, scale, bits: int):
    """Dithered fixed-point quantize round-trip.

    ``u ~ U[0,1)`` dither (broadcast against ``a``), ``scale`` = per-leaf
    step (max|a| / levels, a tensor):
    ``out = scale * clip(floor(a/scale + u), -levels, levels)``; unbiased
    because ``E_u[floor(v + u)] = v``. ``scale == 0`` maps everything to 0.
    """
    levels = 2 ** (bits - 1) - 1
    inv = torch.where(scale > 0, 1.0 / scale, 0.0)
    q = torch.clamp(torch.floor(a * inv + u), -levels, levels)
    return q * scale


def stochastic_quantize_rows(a, u, scale_rows, bits: int):
    """The row-scale form over the packed arena ``[..., rows, lanes]``:
    ``scale_rows`` holds one step per row."""
    return stochastic_quantize(a, u, scale_rows.reshape(-1, 1), bits)


#: arena rows a plain dither draw (:func:`arena_uniform`) hashes at once:
#: 16 Mi coordinates, ~1 GB of int64 temporaries
ARENA_UNIFORM_ROWS = 16384


def arena_uniform(key, table, row_leaf, planes: int, dtype):
    """The packed arena's dither ``[planes, rows, LANES]`` (plain version
    of ``kernels/threefry.py``): per leaf of ``table`` (int64 ``[leaves,
    3]``: first row, element count ``n``, reference index ``i``) the draw
    ``prng.uniform(fold_in(key, i), (planes,) + shape, dtype)`` laid into
    the leaf's rows of each plane, its pads 0; ``row_leaf`` maps each row
    to its leaf. One threefry over whole blocks of rows, each coordinate
    hashing its leaf's key and its row-major index in the leaf's draw."""
    from repro_torch.core import prng  # core imports this module

    dev = table.device
    first, numel, index = table.unbind(1)
    lk0, lk1 = prng.threefry2x32(key[0], key[1], torch.zeros_like(index),
                                 index & prng.MASK32)
    rows = row_leaf.shape[0]
    out = torch.empty((planes, rows, LANES), dtype=dtype, device=dev)
    lane = torch.arange(LANES, device=dev)
    for r0 in range(0, rows, ARENA_UNIFORM_ROWS):
        leaf = row_leaf[r0:r0 + ARENA_UNIFORM_ROWS]
        r1 = r0 + leaf.shape[0]
        row = torch.arange(r0, r1, device=dev)
        within = ((row - first[leaf]) * LANES)[:, None] + lane
        n = numel[leaf][:, None]
        k0, k1 = lk0[leaf][:, None], lk1[leaf][:, None]
        for c in range(planes):
            local = c * n + within
            u = prng.uniform_of_words(*prng.threefry2x32(
                k0, k1, local >> 32, local & prng.MASK32), dtype)
            out[c, r0:r1] = torch.where(within < n, u, 0.0)
    return out


def topk_mask(x, k: int):
    """Magnitude top-k (per flattened leaf): keep the k largest |x|. The
    threshold is the k-th largest magnitude and every entry with ``|x| >=
    threshold`` is kept, so ties keep more than k entries."""
    flat = x.reshape(-1)
    mag = torch.abs(flat)
    thresh = torch.topk(mag, k).values[-1]
    return torch.where(mag >= thresh, flat, 0.0).reshape(x.shape)


def gossip_reduce(src, idx, wgt, denom=None):
    """The gossip neighbor reduce, gather form: ``out[i] = (sum_s
    wgt[i, s] * src[idx[i, s]]) / denom[i]`` for ``src`` ``[R, D]``,
    ``idx``/``wgt`` ``[n, S]`` and ``denom`` ``[n]`` (None: no division).

    The slots are summed in order from the slot-0 product, the unrolled
    branch of the reference's sparse lowering (``core/topology.py:732-734``)
    term for term, so the CUDA kernel, which sums in the same order, is
    held to a tolerance of 0."""
    out = wgt[:, 0:1] * src[idx[:, 0]]
    for s in range(1, idx.shape[1]):
        out = out + wgt[:, s:s + 1] * src[idx[:, s]]
    return out if denom is None else out / denom[:, None]


def segment_reduce(vals, slots: int):
    """Fixed-slot segment sum (the reference's ``segment_reduce_2d``
    contract): ``vals`` is ``[n * slots, d]``, node i's contributions in
    rows ``i*slots .. (i+1)*slots``; returns the per-node sums ``[n, d]``,
    slot 0 first. It is :func:`gossip_reduce` with the identity table
    ``idx[i, s] = i*slots + s`` and unit weights (``x * 1.0 == x``)."""
    v = vals.reshape(-1, slots, vals.shape[-1])
    out = v[:, 0]
    for s in range(1, slots):
        out = out + v[:, s]
    return out


def sketch_geometry(n: int, d: int, itemsize: int) -> tuple[int, int]:
    """``(nblk, lanes)`` of the client sketch over ``[n, d]``: ``lanes`` =
    16 / itemsize values per thread, and ``nblk`` blocks per client, a
    power of two near ``SKETCH_BLOCKS / n`` and no more than one block per
    ``SKETCH_THREADS * lanes`` elements of the row."""
    lanes = 16 // itemsize
    steps = max(1, -(-d // (SKETCH_THREADS * lanes)))
    want = min(max(1, SKETCH_BLOCKS // max(n, 1)), steps)
    return 1 << (want.bit_length() - 1), lanes


def log_histogram(vals, bins: int, lo: float, hi: float):
    """``[bins]`` int32 counts of the non-negative ``vals`` over log10-spaced
    bins covering ``[10^lo, 10^hi)``, by the reference's shared binning
    formula ``clip(floor((log10(v) - lo) * bins / (hi - lo)), 0, bins - 1)``
    in ``vals``' dtype: zeros take ``lo`` (bin 0), out-of-range values clip
    to the edge bins. The CUDA kernel bins by the same expression."""
    logs = torch.where(vals > 0, torch.log10(vals), lo)
    idx = torch.clamp(torch.floor((logs - lo) * (bins / (hi - lo))), 0,
                      bins - 1)
    return torch.bincount(idx.to(torch.int64), minlength=bins).to(
        torch.int32)


def client_sketch(x, *, bins: int, lo: float, hi: float):
    """Per-client squared norm + log-histogram of the norms over the
    flattened client store ``x`` ``[clients, D]``. Returns ``(sq_norms
    [clients], hist [bins] int32)``.

    The sum runs in the CUDA kernel's fixed order (``csrc/
    telemetry_reduce.cu``), so the card check holds a tolerance of 0: with
    ``(nblk, W)`` from :func:`sketch_geometry` and ``S = nblk * 256 * W``,
    the squares of the row (zero-padded to whole ``S`` strides) are added
    stride by stride into ``[nblk, 256, W]`` accumulators, which then
    reduce by halving trees over the ``W`` lanes, the 256 threads and the
    ``nblk`` blocks. The reference's plain ``sum(x * x, axis=1)`` is the
    same function in another order."""
    n, d = x.shape
    nblk, w = sketch_geometry(n, d, x.element_size())
    stride = nblk * SKETCH_THREADS * w
    acc = torch.zeros((n, stride), dtype=x.dtype, device=x.device)
    for k in range(0, d, stride):
        part = x[:, k:k + stride]
        acc = acc + F.pad(part * part, (0, stride - part.shape[1]))
    a = acc.reshape(n, nblk, SKETCH_THREADS, w)
    for axis_len in (w, SKETCH_THREADS, nblk):
        h = axis_len // 2
        while h:
            a = a[..., :h] + a[..., h:2 * h]
            h //= 2
        a = a[..., 0]
    return a, log_histogram(torch.sqrt(a), bins, lo, hi)


#: the masked-score fill of the attention kernels (the reference's NEG_INF).
NEG_INF = -1e30
#: the mask kinds of :func:`flash_attention`, in the CUDA kernel's order.
MASK_KINDS = ("causal", "sliding", "chunked", "bidirectional")


def flash_attention(q, k, v, *, kind: str = "causal", window: int = 0,
                    chunk: int = 0, q_blk: int = 256, kv_blk: int = 256):
    """Grouped-GQA online-softmax attention, forward: the reference's
    Pallas kernel (``src/repro/kernels/flash_attention.py``) written out
    in torch, tile by tile.

    q ``[B, S, Hq, D]``, k/v ``[B, T, Hkv, D]`` (``Hq = G * Hkv``; query
    head ``h * G + g`` reads KV head ``h``, which is never repeated).
    Per ``q_blk`` query tile and ``kv_blk`` kv tile: scores in float32
    over ``sqrt(D)``; the mask from global positions (``kpos < T``,
    ``qpos < S``, causal unless bidirectional, then ``kpos > qpos -
    window`` or the same ``chunk``); masked scores ``-1e30``; running max
    ``m``, denominator ``l`` and accumulator ``acc`` in float32; ``p``
    cast to v's dtype before ``p @ v``; a final ``acc / max(l, 1e-30)``
    in q's dtype. Every tile is visited, as in the reference: a row whose
    first tiles are all masked gathers ``exp(0)`` junk that the first
    allowed tile's ``alpha = exp(-1e30 - m) = 0`` wipes. Returns
    ``[B, S, Hq, D]``."""
    if kind not in MASK_KINDS:
        raise ValueError(f"flash_attention: kind {kind!r} not in "
                         f"{MASK_KINDS}")
    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    q_blk, kv_blk = min(q_blk, S), min(kv_blk, T)
    nq, nk = -(-S // q_blk), -(-T // kv_blk)
    qg = F.pad(q.reshape(B, S, Hkv, G, D),
               (0, 0, 0, 0, 0, 0, 0, nq * q_blk - S))
    k = F.pad(k, (0, 0, 0, 0, 0, nk * kv_blk - T))
    v = F.pad(v, (0, 0, 0, 0, 0, nk * kv_blk - T))
    sqrt_d = math.sqrt(D)
    dev = q.device
    out = torch.empty(qg.shape, dtype=q.dtype, device=dev)
    for iq in range(nq):
        qt = qg[:, iq * q_blk:(iq + 1) * q_blk].to(torch.float32)
        qpos = iq * q_blk + torch.arange(q_blk, device=dev)
        m = torch.full((B, q_blk, Hkv, G), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros_like(m)
        acc = torch.zeros((B, q_blk, Hkv, G, D), dtype=torch.float32,
                          device=dev)
        for ik in range(nk):
            sl = slice(ik * kv_blk, (ik + 1) * kv_blk)
            scores = torch.einsum("bqhgd,bkhd->bqhgk", qt,
                                  k[:, sl].to(torch.float32)) / sqrt_d
            kpos = ik * kv_blk + torch.arange(kv_blk, device=dev)
            qp, kp = qpos[:, None], kpos[None, :]
            ok = (kp < T) & (qp < S)
            if kind != "bidirectional":
                ok = ok & (kp <= qp)
            if kind == "sliding":
                ok = ok & (kp > qp - window)
            elif kind == "chunked":
                ok = ok & ((kp // chunk) == (qp // chunk))
            scores = torch.where(ok[None, :, None, None, :], scores,
                                 NEG_INF)
            m_new = torch.maximum(m, scores.amax(dim=-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(scores - m_new[..., None])
            l = l * alpha + p.sum(dim=-1)
            pv = torch.einsum("bqhgk,bkhd->bqhgd",
                              p.to(v.dtype).to(torch.float32),
                              v[:, sl].to(torch.float32))
            acc = acc * alpha[..., None] + pv
            m = m_new
        out[:, iq * q_blk:(iq + 1) * q_blk] = (
            acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)
    return out[:, :S].reshape(B, S, Hq, D)
