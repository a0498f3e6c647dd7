"""Public wrappers of the port's kernels (port of
``src/repro/kernels/ops.py``: ``fedcet_v``, ``fedcet_comm``,
``stochastic_quantize``, ``stochastic_quantize_rows``,
``fedcet_round_tail``, ``gossip_reduce``, ``telemetry_sketch``,
``flash_attention`` and ``ssd_intra``), and ``arena_uniform``, the packed
arena's dither, which no TPU kernel had.

``impl`` selects the implementation:

* ``"auto"`` (default): the CUDA kernel for a CUDA tensor, the plain
  PyTorch version (``kernels/ref.py``) for a CPU tensor. For a CUDA tensor
  a kernel that fails to build or launch raises; nothing falls back.
* ``"kernel"``: the CUDA kernel (CUDA tensors only).
* ``"ref"``: the plain version, on any device.

Unlike the reference's TPU wrappers there is no ``[rows, 1024]`` tiling or
padding, and no broadcast operand is materialized: the CUDA kernels work
on the flat leaf and broadcast the shared operand themselves.

The FedCET triad and pair, the per-leaf quantizer and the two serving
kernels, ``flash_attention`` and ``ssd_intra``, are reached through custom
ops (``torch.ops.repro_torch.*``) with fake implementations: on fake
tensors (the dry run's local shards) they give the true output shape and
allocate none of the plain version's intermediates. On DTensors the
wrappers run the op on each rank's local shards when the layout lets
every shard compute alone, and place the result as the first operand:

* ``fedcet_v``, ``fedcet_comm``: the elementwise operands (``x``, ``g``,
  ``d``; ``d``, ``m``, ``v``) carry equal placements on every mesh dim;
  ``m_bar`` (the ``[1, ...]`` client mean) is replicated where they shard
  the clients (dim 0) and carries their placement elsewhere, its pending
  sums reduced first (they are its value);
* ``stochastic_quantize``: the scale, a max over the whole stacked leaf,
  is reduced over every mesh dim (a shard's own max would give other
  codes) and must end replicated; a plain dither is the full leaf's draw,
  of which each rank takes its shard's coordinates, so the sharded round
  draws what the unsharded one does;
* attention: per mesh dim, all operands sharded on the batch dim, or on
  the head dim when the KV heads divide, or all replicated; SSD: the
  batch dim, or the head dim for x, dt and a_cs with B and C replicated,
  or all replicated.

Any other layout raises: nothing is gathered behind the caller's back
(the callers in ``models/`` and ``core/`` bring their operands to such a
layout first). Under autograd the serving wrappers skip their custom ops,
which have no backward: the plain version differentiates, the kernels
raise as before.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import fedcet_update as K
from repro_torch.kernels import flash_attention as KF
from repro_torch.kernels import gossip_reduce as KG
from repro_torch.kernels import quantize as KQ
from repro_torch.kernels import ref as R
from repro_torch.kernels import ssd_intra as KS
from repro_torch.kernels import telemetry_reduce as KT
from repro_torch.kernels import threefry as KR
from repro_torch.utils.sharding_ctx import is_dtensor, resolve_partial
from repro_torch.utils.spans import spanned


def _use_kernel(impl: str, t: torch.Tensor) -> bool:
    if impl == "auto":
        return t.device.type == "cuda"
    if impl in ("kernel", "ref"):
        return impl == "kernel"
    raise ValueError(f"unknown impl {impl!r} (auto | kernel | ref)")


@torch.library.custom_op("repro_torch::fedcet_v", mutates_args=())
def _fedcet_v_op(x: torch.Tensor, g: torch.Tensor, d: torch.Tensor,
                 alpha: float, kernel: bool) -> torch.Tensor:
    if kernel:
        return K.fedcet_v(x, g, d, alpha)
    return R.fedcet_v(x, g, d, alpha)


@_fedcet_v_op.register_fake
def _(x, g, d, alpha, kernel):
    return torch.empty_like(x)


@torch.library.custom_op("repro_torch::fedcet_comm", mutates_args=())
def _fedcet_comm_op(d: torch.Tensor, m: torch.Tensor, m_bar: torch.Tensor,
                    v: torch.Tensor | None, c: float, alpha: float,
                    kernel: bool) -> tuple[torch.Tensor, torch.Tensor]:
    if kernel:
        return K.fedcet_comm(d, m, m_bar, c, alpha, v=v)
    return R.fedcet_comm(d, m, m_bar, c, alpha, v=v)


@_fedcet_comm_op.register_fake
def _(d, m, m_bar, v, c, alpha, kernel):
    return torch.empty_like(d), torch.empty_like(m)


@torch.library.custom_op("repro_torch::stochastic_quantize", mutates_args=())
def _quantize_op(a: torch.Tensor, u: torch.Tensor, scale: torch.Tensor,
                 bits: int, kernel: bool) -> torch.Tensor:
    if kernel:
        return KQ.stochastic_quantize(a, u, scale, bits)
    return R.stochastic_quantize(a, u, scale, bits)


@_quantize_op.register_fake
def _(a, u, scale, bits, kernel):
    return torch.empty_like(a)


def _same(mesh_dim, pl) -> bool:
    """Equal placements, none a pending sum: elementwise operands."""
    return all(p == pl[0] for p in pl) and not pl[0].is_partial()


@spanned("fedcet_v")
def fedcet_v(x, g, d, alpha: float, impl: str = "auto"):
    """Fused FedCET local-step triad (see kernels/ref.py:fedcet_v).
    DTensors run shard-local under equal placements or raise."""
    kernel = _use_kernel(impl, x)
    if is_dtensor(x):
        return _local(_fedcet_v_op, "fedcet_v", (x, g, d), _same, alpha,
                      kernel)
    return _fedcet_v_op(x, g, d, alpha, kernel)


@spanned("fedcet_comm")
def fedcet_comm(d, m, m_bar, c: float, alpha: float, v=None,
                impl: str = "auto"):
    """Fused FedCET aggregation pair (see kernels/ref.py:fedcet_comm).

    ``m`` is the client's own WIRE message; pass ``v`` (the exact local
    vector) when the message path is compressed. ``v=None`` keeps the
    uncompressed behavior (``v = m``). Returns ``(d', x')``. DTensors run
    shard-local (see the module docstring) or raise."""
    kernel = _use_kernel(impl, m)
    if not is_dtensor(m):
        return _fedcet_comm_op(d, m, m_bar, v, c, alpha, kernel)
    from torch.distributed.tensor import Replicate, Shard

    m_bar = resolve_partial(m_bar)
    mean = m_bar.shape[0] == 1  # the [1, ...] mean, not a per-client one
    ops = (d, m) + (() if v is None else (v,)) + (m_bar,)

    def allowed(mesh_dim, pl):
        *elem, mb = pl
        if not _same(mesh_dim, elem):
            return False
        if elem[0] == Shard(0) and mean:
            return mb == Replicate()
        return mb == elem[0]

    def op(d_, m_, *rest):
        v_ = rest[0] if v is not None else None
        return _fedcet_comm_op(d_, m_, rest[-1], v_, c, alpha, kernel)

    return _local(op, "fedcet_comm", ops, allowed)


@spanned("quantize")
def stochastic_quantize(a, u, scale, bits: int, impl: str = "auto"):
    """Fused dithered-quantize round-trip over a stacked ``[C, ...]`` leaf
    (see kernels/ref.py:stochastic_quantize). ``u`` is the dither, of the
    leaf's coordinate shape (client-shared) or of ``a``'s shape;
    ``scale`` the per-leaf step as a one-element tensor. On a DTensor
    ``a`` the scale is reduced over the mesh and the dither taken at the
    shard's coordinates (see the module docstring)."""
    kernel = _use_kernel(impl, a)
    if not is_dtensor(a):
        return _quantize_op(a, u, scale, bits, kernel)
    from torch.distributed.tensor import DTensor

    scale = resolve_partial(scale)
    if is_dtensor(scale):
        if any(not p.is_replicate() for p in scale.placements):
            raise ValueError(f"stochastic_quantize: the scale must be one "
                             f"replicated value, got {scale.placements}")
        scale = scale.to_local()
    if any(p.is_partial() for p in a.placements):
        raise ValueError(f"stochastic_quantize: a has pending sums "
                         f"{a.placements}; reduce them first")
    out = _quantize_op(a.to_local(), _dither_shard(u, a), scale, bits,
                       kernel)
    return DTensor.from_local(out, a.device_mesh, a.placements,
                              run_check=False, shape=a.shape,
                              stride=a.stride())


def _dither_shard(u, a):
    """This rank's part of the dither ``u`` for the DTensor ``a``: ``u``
    shaped like ``a`` (per client) or like one client (shared, so the
    mesh dims that shard the clients leave it whole). A plain ``u`` is
    the full draw and is cut to the shard's coordinates; a DTensor ``u``
    must already be placed so."""
    from torch.distributed.tensor import Replicate, Shard

    lead = 0 if tuple(u.shape) == tuple(a.shape) else 1
    if lead and tuple(u.shape) != tuple(a.shape[1:]):
        raise ValueError(f"stochastic_quantize: u must be shaped like a "
                         f"{tuple(a.shape)} or like one client "
                         f"{tuple(a.shape[1:])}, got {tuple(u.shape)}")
    mesh = a.device_mesh
    want = [Shard(p.dim - lead) if p.is_shard() and p.dim >= lead
            else Replicate() for p in a.placements]
    if is_dtensor(u):
        if list(u.placements) != want:
            raise ValueError(f"stochastic_quantize: u has placements "
                             f"{u.placements}, the shard needs {want}")
        return u.to_local()
    coord = mesh.get_coordinate()
    for m, p in enumerate(want):
        if p.is_shard():
            n = mesh.size(m)
            if u.shape[p.dim] % n:
                raise ValueError(f"stochastic_quantize: dim {p.dim} of u "
                                 f"{tuple(u.shape)} does not divide over "
                                 f"{n} ranks")
            size = u.shape[p.dim] // n
            u = u.narrow(p.dim, coord[m] * size, size)
    return u.contiguous()


@spanned("quantize")
def stochastic_quantize_rows(a, u, scale_rows, bits: int, impl: str = "auto"):
    """Row-scale dithered-quantize round-trip over the packed arena
    ``[C, rows, 1024]`` (see kernels/ref.py:stochastic_quantize_rows);
    ``u`` is ``[rows, 1024]`` or ``a``'s shape, ``scale_rows`` one step per
    row."""
    if _use_kernel(impl, a):
        return KQ.stochastic_quantize_rows(a, u, scale_rows, bits)
    return R.stochastic_quantize_rows(a, u, scale_rows, bits)


@spanned("round_tail")
def fedcet_round_tail(v, h, d, u, scale, w, den, *, c: float, alpha: float,
                      beta: float, bits: int, impl: str = "auto"):
    """The fused shift-compressed FedCET round tail (see
    kernels/ref.py:fedcet_round_tail): dithered-quantize the shifted
    residual, reconstruct the wire message, weighted-reduce it across
    clients and apply the paired ``(d', x')`` update plus the DIANA shift
    step, one kernel visit per element on the card.

    Shapes: ``v``/``h``/``d`` [clients, rows, 1024]; ``u`` [rows, 1024];
    ``scale`` one step per row; ``w`` the clients' weights; ``den`` one
    element. Returns ``(d', x', h')``."""
    if _use_kernel(impl, v):
        return K.fedcet_round_tail(v, h, d, u, scale, w, den, c=c,
                                   alpha=alpha, beta=beta, bits=bits)
    return R.fedcet_round_tail(v, h, d, u, scale, w, den, c=c, alpha=alpha,
                               beta=beta, bits=bits)


def arena_uniform(key, table, row_leaf, lead=None, *, dtype,
                  impl: str = "auto"):
    """The packed arena's dither in one pass (see kernels/threefry.py;
    plain version: kernels/ref.py:arena_uniform): every leaf's
    ``prng.uniform(prng.fold_in(key, i), shape, dtype)`` (``(lead,) +
    shape`` for a per-client dither), ``i`` its reference index, laid into
    the leaf's rows with zero pads. ``table`` is ``ArenaLayout.leaf_table``
    and ``row_leaf`` ``ArenaLayout.row_segments`` on the draw's device.
    Returns ``[rows, LANES]``, or ``[lead, rows, LANES]`` when ``lead`` is
    given. The CUDA kernel takes float32 and float64."""
    planes = 1 if lead is None else lead
    if _use_kernel(impl, table):
        out = KR.threefry_uniform_rows(key, table, row_leaf, planes, dtype)
    else:
        out = R.arena_uniform(key, table, row_leaf, planes, dtype)
    return out[0] if lead is None else out


@spanned("gossip")
def gossip_reduce(src, idx=None, wgt=None, denom=None, *, slots=None,
                  impl: str = "auto"):
    """The gossip neighbor reduce (see kernels/ref.py:gossip_reduce), in
    two forms:

    * ``gossip_reduce(src, idx, wgt, denom)``, the gather form the sparse
      ``Mixing`` lowering calls on each stacked leaf viewed as ``[n, D]``:
      ``out[i] = (sum_s wgt[i, s] * src[idx[i, s]]) / denom[i]``;
    * ``gossip_reduce(contrib, slots=S)``, the reference's contract: the
      fixed-slot segment sum of a ``[n*S, D]`` contribution tensor (the
      same kernel with the identity table and unit weights, no division).

    Returns ``[n, D]``."""
    if slots is not None:
        if idx is not None or wgt is not None or denom is not None:
            raise ValueError("gossip_reduce: pass slots= alone, or idx and "
                             "wgt (and denom), not both")
        if src.shape[0] % slots:
            raise ValueError(f"gossip_reduce: {src.shape[0]} rows are not "
                             f"a whole number of {slots}-slot nodes")
        n = src.shape[0] // slots
        idx = torch.arange(n * slots, device=src.device).reshape(n, slots)
        wgt = torch.ones((n, slots), dtype=src.dtype, device=src.device)
    elif idx is None or wgt is None:
        raise ValueError("gossip_reduce: pass idx and wgt, or slots=")
    if _use_kernel(impl, src):
        return KG.gossip_reduce(src, idx, wgt, denom)
    return R.gossip_reduce(src, idx, wgt, denom)


@spanned("sketch")
def telemetry_sketch(data, *, bins: int, lo: float, hi: float, k: int,
                     impl: str = "auto"):
    """One-pass per-client distribution sketch over the client store (see
    kernels/telemetry_reduce.py; plain version: kernels/ref.py:
    client_sketch). ``data`` is ``[clients, ...]``, typically the arena's
    ``[clients, rows, 1024]`` buffer, flattened per client here (zero pad
    entries contribute 0 to the norms).

    Returns ``(norms [clients], hist [bins] int32, top_vals [k], top_ids
    [k] int32)``: the per-client ``||x_i||``, their log10 histogram over
    ``[10^lo, 10^hi)`` and the k largest with their client indices. The
    top-k runs on the ``[clients]`` norms outside the kernel, as a stable
    descending sort, so ties go to the lower client index as in
    ``jax.lax.top_k``."""
    flat = data.reshape(data.shape[0], -1)
    if _use_kernel(impl, flat):
        sq, hist = KT.client_sketch(flat, bins=bins, lo=lo, hi=hi)
    else:
        sq, hist = R.client_sketch(flat, bins=bins, lo=lo, hi=hi)
    norms = torch.sqrt(sq)
    return (norms, hist) + top_k(norms, k)


def top_k(vals, k: int):
    """The ``min(k, n)`` largest of ``vals`` ``[n]`` and their int32
    indices, by a stable descending sort: ties go to the lower index, as
    in ``jax.lax.top_k`` (``torch.topk`` leaves their order open)."""
    srt, order = torch.sort(vals, descending=True, stable=True)
    return srt[:k], order[:k].to(torch.int32)


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def _flash_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kind: str,
              window: int, chunk: int, kernel: bool) -> torch.Tensor:
    if kernel:
        return KF.flash_attention(q, k, v, kind=kind, window=window,
                                  chunk=chunk)
    return R.flash_attention(q, k, v, kind=kind, window=window, chunk=chunk)


@_flash_op.register_fake
def _(q, k, v, kind, window, chunk, kernel):
    return torch.empty_like(q)


@torch.library.custom_op("repro_torch::ssd_intra", mutates_args=())
def _ssd_op(x: torch.Tensor, dt: torch.Tensor, a_cs: torch.Tensor,
            Bm: torch.Tensor, Cm: torch.Tensor,
            kernel: bool) -> torch.Tensor:
    if kernel:
        return KS.ssd_intra(x, dt, a_cs, Bm, Cm)
    return R.ssd_intra(x, dt, a_cs, Bm, Cm)


@_ssd_op.register_fake
def _(x, dt, a_cs, Bm, Cm, kernel):
    return torch.empty_like(x)


def _needs_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def _local(op, name: str, ops: tuple, allowed, *args):
    """``op`` on each rank's local shards of the DTensors ``ops`` when
    ``allowed(m, placements)`` holds on every mesh dim ``m`` (the
    placements of ``ops`` on it); each result is placed as ``ops[0]``."""
    from torch.distributed.tensor import DTensor

    mesh = ops[0].device_mesh
    if not all(is_dtensor(t) and t.device_mesh == mesh for t in ops):
        raise ValueError(f"{name}: every operand must be a DTensor on one "
                         f"mesh")
    for m in range(mesh.ndim):
        pl = tuple(t.placements[m] for t in ops)
        if not allowed(m, pl):
            raise ValueError(
                f"{name}: mesh dim {mesh.mesh_dim_names[m]!r} has placements "
                f"{pl}, a layout on which the shards cannot compute alone; "
                f"redistribute first")
    out = op(*(t.to_local() for t in ops), *args)
    place = lambda o: DTensor.from_local(  # noqa: E731
        o, mesh, ops[0].placements, run_check=False, shape=ops[0].shape,
        stride=ops[0].stride())
    return tuple(map(place, out)) if isinstance(out, tuple) else place(out)


def _all(pl, *want) -> bool:
    return all(p == w for p, w in zip(pl, want))


def flash_attention(q, k, v, *, kind: str = "causal", window: int = 0,
                    chunk: int = 0, impl: str = "auto"):
    """Grouped-GQA flash attention, forward (see
    kernels/flash_attention.py; plain version: kernels/ref.py:
    flash_attention): q ``[B, S, Hq, D]``, k/v ``[B, T, Hkv, D]``, ``kind``
    one of causal, sliding (``window``), chunked (``chunk``) and
    bidirectional. Returns ``[B, S, Hq, D]``. The CUDA kernel takes
    float32 and bfloat16; the plain version also float64. DTensors run
    shard-local (batch- or head-sharded, or replicated) or raise."""
    kernel = _use_kernel(impl, q)
    if _needs_grad(q, k, v) or not (kernel or is_dtensor(q)):
        # the plain version on plain tensors runs as torch ops: it takes
        # autograd and batches under vmap (a rematerialized body's
        # forward runs without autograd inside the clients' vmap)
        return (KF if kernel else R).flash_attention(
            q, k, v, kind=kind, window=window, chunk=chunk)
    if is_dtensor(q):
        from torch.distributed.tensor import Replicate, Shard

        def allowed(m, pl):
            return (_all(pl, *(Shard(0),) * 3) or _all(pl, *(Shard(2),) * 3)
                    or _all(pl, *(Replicate(),) * 3))

        return _local(_flash_op, "flash_attention", (q, k, v), allowed,
                      kind, window, chunk, kernel)
    return _flash_op(q, k, v, kind, window, chunk, kernel)


def ssd_intra(x, dt, a_cs, Bm, Cm, impl: str = "auto"):
    """The Mamba2 SSD intra-chunk term (see kernels/ssd_intra.py; plain
    version: kernels/ref.py:ssd_intra): x ``[B, Nc, Lc, H, P]``, dt and
    a_cs ``[B, Nc, Lc, H]``, Bm and Cm ``[B, Nc, Lc, N]``. Returns x's
    shape and dtype. The CUDA kernel takes float32 and bfloat16 and has no
    backward; the plain version also takes float64 and autograd. DTensors
    run shard-local (batch- or head-sharded, or replicated) or raise. One
    B/C group: grouped ``[B, Nc, Lc, G, N]`` operands raise."""
    if Bm.dim() != 4:
        raise NotImplementedError(
            f"ssd_intra takes one B/C group, not B of shape "
            f"{tuple(Bm.shape)}")
    kernel = _use_kernel(impl, x)
    if _needs_grad(x, dt, a_cs, Bm, Cm) or not (kernel or is_dtensor(x)):
        # the plain version on plain tensors as torch ops, as above
        return (KS if kernel else R).ssd_intra(x, dt, a_cs, Bm, Cm)
    if is_dtensor(x):
        from torch.distributed.tensor import Replicate, Shard

        def allowed(m, pl):
            r = Replicate()
            return (_all(pl, *(Shard(0),) * 5)
                    or _all(pl, Shard(3), Shard(3), Shard(3), r, r)
                    or _all(pl, *(r,) * 5))

        return _local(_ssd_op, "ssd_intra", (x, dt, a_cs, Bm, Cm), allowed,
                      kernel)
    return _ssd_op(x, dt, a_cs, Bm, Cm, kernel)
