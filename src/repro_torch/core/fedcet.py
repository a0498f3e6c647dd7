"""FedCET — the paper's contribution (Algorithm 2), as engine specs (port
of ``src/repro/core/fedcet.py``).

* :class:`FedCET` — the production form, the ``(d, x)`` recursion of
  Lemma 1, with TWO persistent model-sized states per client::

      v      = x - alpha * grad - alpha * d        # transmitted at comm rounds
      d_next = d + c * (v - mean_clients(v))       # comm round only
      x_next = v - c * alpha * (v - mean_clients(v))   (comm) / v (local)

* :class:`FedCETLiteral` — Algorithm 2 exactly as printed (states
  ``x(t), x(t-1)`` and gradients at both); the reference oracle for
  Lemma 1.

A communication round is ``tau - 1`` pure-local steps followed by one
aggregating step. Under message compression the drift update uses the
client's own compressed message (``msg`` in ``server_aggregate``) so
``sum_i d_i = 0`` is preserved (Lemma 2), while the x-update corrects the
exact local vector ``v`` carried in ``mctx``. On the packed arena with a
``shift:q<b>`` uplink, :meth:`FedCET._fused_tail` runs the whole round tail
as one kernel (``kernels/ops.py:fedcet_round_tail``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch
from torch.utils import _pytree as pytree

from repro_torch.core import arena as ar
from repro_torch.core.api import replicate
from repro_torch.core.engine import RoundEngine
from repro_torch.kernels import ops as kops
from repro_torch.utils.tree import tree_leaves, tree_map, tree_zeros_like


class FedCETState(NamedTuple):
    x: Any  # stacked [clients, ...] model parameters
    d: Any  # stacked [clients, ...] drift-correction variable (Lemma 1)
    t: int  # global iteration counter


@dataclasses.dataclass(frozen=True)
class FedCET(RoundEngine):
    """FedCET in the memory-efficient (d, x) form of Lemma 1."""

    alpha: float
    c: float
    tau: int
    n_clients: int
    name: str = "fedcet"
    vectors_up: int = 1  # Remark 2: ONE n-dim vector per client per round
    vectors_down: int = 1
    #: route the local-step triad and the aggregation pair through
    #: kernels/ops.py (the CUDA kernels for CUDA tensors). On by default,
    #: unlike the reference: JAX leaves these expressions to XLA, which
    #: fuses them, while eager PyTorch has no fuser (``x - a*g - a*d`` is
    #: four launches and three temporaries per leaf), so the hand-written
    #: kernel IS the port's fusion. On the CPU ``ops`` computes the same
    #: expression as the unfused path, so both settings agree exactly.
    use_fused_kernel: bool = True

    def init_warmup(self, gf, x0, init_batch):
        """Paper's warm-up: x(-1) = x(-2) - a*grad(x(-2)), d(-1) = 0, then
        one aggregating step (run by the engine) produces (d(0), x(0))."""
        x_m2 = replicate(x0, self.n_clients)
        g_m2 = gf(x_m2, init_batch)
        x_m1 = tree_map(lambda x, g: x - self.alpha * g, x_m2, g_m2)
        return FedCETState(x=x_m1, d=tree_zeros_like(x_m1), t=-1), True

    def _v(self, x, g, d):
        """The single transmitted vector v = x - a*g - a*d."""
        a = self.alpha
        if self.use_fused_kernel:
            return tree_map(lambda xx, gg, dd: kops.fedcet_v(xx, gg, dd, a),
                            x, g, d)
        return tree_map(lambda xx, gg, dd: xx - a * gg - a * dd, x, g, d)

    def local_step(self, gf, state, batch, rctx):
        """Eq. (3): pure extrapolated local training, d frozen."""
        g = gf(state.x, batch)
        return FedCETState(x=self._v(state.x, g, state.d), d=state.d,
                           t=state.t + 1)

    def message(self, gf, state, batch, rctx):
        """The single uplink vector v, also carried as mctx (the exact
        local vector the x-update starts from)."""
        g = gf(state.x, batch)
        v = self._v(state.x, g, state.d)
        return v, v

    def server_aggregate(self, state, msg, msg_bar, mctx, rctx):
        """Eq. (2): the aggregating step. ``msg`` is the client's own
        transmitted vector, ``mctx`` the exact v; with ``use_fused_kernel``
        both outputs come from one kernel visit per element."""
        if self.use_fused_kernel:
            d_leaves, spec = pytree.tree_flatten(state.d)
            pairs = [
                kops.fedcet_comm(dd, mm, mb, self.c, self.alpha,
                                 v=(None if vv is mm else vv))
                for dd, mm, mb, vv in zip(d_leaves, tree_leaves(msg),
                                          tree_leaves(msg_bar),
                                          tree_leaves(mctx))]
            d_next = pytree.tree_unflatten([p[0] for p in pairs], spec)
            x_next = pytree.tree_unflatten([p[1] for p in pairs], spec)
            return FedCETState(x=x_next, d=d_next, t=state.t + 1)
        ca = self.c * self.alpha
        d_next = tree_map(lambda dd, mm, mb: dd + self.c * (mm - mb),
                          state.d, msg, msg_bar)
        x_next = tree_map(lambda vv, mm, mb: vv - ca * (mm - mb),
                          mctx, msg, msg_bar)
        return FedCETState(x=x_next, d=d_next, t=state.t + 1)

    def _fused_tail(self, inner, msg, mctx, extras, step, mask):
        """The fully fused arena round tail (engine hook; reference
        ``core/fedcet.py:132-196``): when the transform stack is exactly
        one shift-quantized compression with a client-shared dither over a
        packed arena message, the quantize + dequantize + weighted reduce +
        paired ``(d', x')`` update + DIANA shift step run as ONE kernel
        visit per element (``kernels/ops.py:fedcet_round_tail``). Same PRNG
        schedule, per-leaf segment-max scale and masked-mean ``w``/``den``
        expressions as the generic seam; any other configuration returns
        None and takes the generic path."""
        if not self.use_fused_kernel or len(self.transforms) != 1:
            return None
        from repro_torch.core import compressors as C
        from repro_torch.core.engine import MessageCompression, compression_key

        t = self.transforms[0]
        if not isinstance(t, MessageCompression):
            return None
        comp = t.compressor
        if not (isinstance(comp, C.Shifted)
                and isinstance(comp.inner, C.StochasticQuant)
                and not comp.inner.per_client_dither):
            return None
        h = extras[0]
        if not (isinstance(msg, ar.Arena) and isinstance(h, ar.Arena)
                and msg.data.dim() == 3
                and msg.layout.dtype in (torch.float32, torch.float64)):
            return None
        lo, va, ha, da = msg.layout, msg.data, h.data, inner.d.data
        ft, dev, n = va.dtype, va.device, va.shape[0]
        quant = comp.inner
        levels = 2 ** (quant.bits - 1) - 1
        # the per-leaf quantizer scale of the shifted RESIDUAL.
        scale = C.arena_scale(va - ha, lo, levels)
        # MessageCompression's round key, then the per-leaf dither draws in
        # flatten (== layout) order: bit-identical to the generic path.
        u = quant.arena_dither(
            compression_key(t.seed, t.index, step, self.x64), lo, n, dev)
        if mask is None:
            w = torch.ones((n, 1), dtype=ft, device=dev)
            den = torch.full((1, 1), n, dtype=ft, device=dev)
        else:  # the exact masked_client_mean expressions
            w = mask.to(ft).reshape(n, 1)
            den = torch.clamp(mask.to(torch.int64).sum(), min=1).to(
                ft).reshape(1, 1)
        d2, x2, h2 = kops.fedcet_round_tail(
            va, ha, da, u, scale, w, den, c=self.c, alpha=self.alpha,
            beta=comp.step, bits=quant.bits)
        inner = FedCETState(x=ar.Arena(x2, lo), d=ar.Arena(d2, lo),
                            t=inner.t + 1)
        return inner, (ar.Arena(h2, lo),)

class FedCETLiteralState(NamedTuple):
    x_curr: Any  # x(t)
    x_prev: Any  # x(t-1)
    g_prev: Any  # grad f(x(t-1))
    t: int


@dataclasses.dataclass(frozen=True)
class FedCETLiteral(RoundEngine):
    """Algorithm 2 exactly as printed (3 persistent states). Reference only."""

    alpha: float
    c: float
    tau: int
    n_clients: int
    name: str = "fedcet_literal"
    vectors_up: int = 1
    vectors_down: int = 1

    def init_warmup(self, gf, x0, init_batch):
        x_m2 = replicate(x0, self.n_clients)
        g_m2 = gf(x_m2, init_batch)
        x_m1 = tree_map(lambda x, g: x - self.alpha * g, x_m2, g_m2)
        return FedCETLiteralState(x_curr=x_m1, x_prev=x_m2, g_prev=g_m2,
                                  t=-1), True

    def _extrapolate(self, gf, state, batch):
        """2x(t) - x(t-1) - a grad(t) + a grad(t-1), and grad(t) for carry."""
        a = self.alpha
        g = gf(state.x_curr, batch)
        m = tree_map(lambda xc, xp, gc, gp: 2.0 * xc - xp - a * gc + a * gp,
                     state.x_curr, state.x_prev, g, state.g_prev)
        return m, g

    def local_step(self, gf, state, batch, rctx):
        m, g = self._extrapolate(gf, state, batch)
        return FedCETLiteralState(x_curr=m, x_prev=state.x_curr, g_prev=g,
                                  t=state.t + 1)

    def message(self, gf, state, batch, rctx):
        return self._extrapolate(gf, state, batch)

    def server_aggregate(self, state, msg, msg_bar, mctx, rctx):
        ca = self.c * self.alpha
        x_next = tree_map(lambda mm, mb: ca * mb + (1.0 - ca) * mm,
                          msg, msg_bar)
        return FedCETLiteralState(x_curr=x_next, x_prev=state.x_curr,
                                  g_prev=mctx, t=state.t + 1)

    def client_params_of(self, inner):
        return inner.x_curr


def max_weight_c(mu: float, alpha: float) -> float:
    """Largest admissible weight parameter: c = mu / (2 mu alpha + 8)."""
    return mu / (2.0 * mu * alpha + 8.0)
