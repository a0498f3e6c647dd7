"""FedCET (Algorithm 2 of the paper) in its ``(d, x)`` form, with the
uplink compressions the benchmark's traffic names, in plain PyTorch.

Each client holds ``x`` and the drift correction ``d``. A round is ``tau
- 1`` local steps ``x <- x - alpha (g + d)`` and one aggregating step:
``v = x - alpha (g + d)`` is sent, the server takes the client mean
``m`` of what it received, and every client sets ``d <- d + c (msg -
m)``, ``x <- v - c alpha (msg - m)``. The warm-up starts every client
from ``x0``, takes ``x <- x0 - alpha g`` with ``d = 0`` and runs one
aggregating step.

``shift:q<b>`` (DIANA-style shifted stochastic quantization): each client
keeps a shift ``h``; it sends ``q = clip(floor((v - h) / s + u), -L, L)``
with ``L = 2^(b-1) - 1``, ``s`` the leaf's ``max |v - h|`` over every
client divided by ``L`` and a dither ``u`` shared by the clients; the
message is ``msg = h + q s`` and the shift steps to ``h + q s``. The
dither of leaf ``i`` is the float32 threefry ``uniform`` of
``fold_in(round key, i)``, ``i`` the leaf's rank in sorted-name order,
and the round key folds the scenario seed, the transform's index 0 and
the round-entry step (-1 at the warm-up, then 0, tau, 2 tau, ...).
``none`` sends ``v`` itself.

The client mean adds the clients in order and divides by their count.
Everything runs one parameter leaf at a time (the quantizer's scale and
dither are per leaf), so no whole-model temporary is made."""

from __future__ import annotations

import re

import torch

from fedbench import prng


def compression(spec: str):
    """``None`` for ``none``, else the bits of ``shift:q<bits>``."""
    if spec == "none":
        return None
    m = re.fullmatch(r"shift:q(\d+)", spec)
    if not m:
        raise ValueError(f"the FedCET reference computes 'none' and "
                         f"'shift:q<bits>', not {spec!r}")
    return int(m.group(1))


def client_grads(family, conf: dict, x: dict, tokens: torch.Tensor,
                 fault: str | None = None) -> dict:
    """``{name: [C, ...]}`` gradients of each client's loss at its own
    leaves of ``x`` on its ``tokens [C, B, S]``, one client at a time.
    ``fault="half_batch"`` drops the second half of each client's batch."""
    names = list(x)
    out = {n: torch.empty_like(x[n]) for n in names}
    for i in range(tokens.shape[0]):
        leaves = [x[n][i].detach().requires_grad_() for n in names]
        toks = tokens[i]
        if fault == "half_batch":
            toks = toks[:max(1, toks.shape[0] // 2)]
        loss = family.loss(conf, dict(zip(names, leaves)), toks)
        for n, g in zip(names, torch.autograd.grad(loss, leaves)):
            out[n][i] = g
    return out


def mean_loss(family, conf: dict, x: dict, tokens: torch.Tensor) -> float:
    """The mean over clients of each client's loss on its ``tokens``."""
    with torch.no_grad():
        losses = [family.loss(conf, {n: t[i] for n, t in x.items()},
                              tokens[i]) for i in range(tokens.shape[0])]
    return float(torch.stack(losses).mean())


def sorted_rank(names) -> dict:
    """Each leaf's rank when the leaves are sorted by their name's path."""
    order = sorted(names, key=lambda n: tuple(n.split(".")))
    return {n: i for i, n in enumerate(order)}


def aggregate(state: dict, v: dict, *, c: float, alpha: float, bits,
              key, rank: dict, fault: str | None = None) -> None:
    """The aggregating step on every leaf, in place on ``state`` (``x``,
    ``d`` and, with a compression, ``h``). ``fault="no_exchange"`` leaves
    out the exchange: every client's mean is its own message."""
    for n, vv in v.items():
        d = state["d"][n]
        if bits is None:
            msg = vv
        else:
            h = state["h"][n]
            levels = 2 ** (bits - 1) - 1
            r = vv - h
            scale = torch.amax(torch.abs(r)) / levels
            inv = torch.where(scale > 0, 1.0 / scale, 0.0)
            u = prng.uniform(prng.fold_in(key, rank[n]), vv.shape[1:],
                             device=vv.device)
            qs = torch.clamp(torch.floor(r * inv + u), -levels, levels) \
                * scale
            del r, u
            msg = h + qs
            state["h"][n] = h + qs
            del qs
        if fault == "no_exchange":
            m = msg
        else:
            acc = msg[0]
            for k in range(1, msg.shape[0]):
                acc = acc + msg[k]
            m = (acc / msg.shape[0])[None]
        delta = msg - m
        state["d"][n] = d + c * delta
        state["x"][n] = vv - (c * alpha) * delta
        del delta, msg, m


def init(family, conf: dict, mix: dict, x0: dict, tokens: torch.Tensor,
         seed: int, fault: str | None = None) -> dict:
    """The warm-up from ``x0`` on the init ``tokens [C, B, S]``: the state
    ``{"x", "d", "h", "t"}`` after its aggregating step."""
    C, alpha = mix["n_clients"], mix["alpha"]
    bits = compression(mix["compression"])
    x = {n: a.unsqueeze(0).expand((C,) + tuple(a.shape)).contiguous()
         for n, a in x0.items()}
    g = client_grads(family, conf, x, tokens, fault)
    for n in x:
        x[n] -= alpha * g[n]
    del g
    state = {"x": x, "d": {n: torch.zeros_like(a) for n, a in x.items()},
             "h": ({n: torch.zeros_like(a) for n, a in x.items()}
                   if bits is not None else None), "t": -1}
    _comm(family, conf, mix, state, tokens, seed, step=-1, fault=fault)
    return state


def _comm(family, conf, mix, state, tokens, seed, *, step, fault):
    alpha = mix["alpha"]
    g = client_grads(family, conf, state["x"], tokens, fault)
    v = {n: state["x"][n] - alpha * g[n] - alpha * state["d"][n]
         for n in g}
    del g
    aggregate(state, v, c=mix["c"], alpha=alpha,
              bits=compression(mix["compression"]),
              key=prng.compression_key(seed, 0, step),
              rank=sorted_rank(v), fault=fault)
    state["t"] += 1


def round_(family, conf: dict, mix: dict, state: dict, tokens: torch.Tensor,
           seed: int, fault: str | None = None) -> float:
    """One round on ``tokens [tau, C, B, S]``, in place; returns the
    round's logged loss: the client mean on the round's first batch after
    the round."""
    step0, alpha = state["t"], mix["alpha"]
    for k in range(mix["tau"] - 1):
        g = client_grads(family, conf, state["x"], tokens[k], fault)
        for n in g:
            x, d = state["x"][n], state["d"][n]
            state["x"][n] = x - alpha * g[n] - alpha * d
        del g
        state["t"] += 1
    _comm(family, conf, mix, state, tokens[mix["tau"] - 1], seed,
          step=step0, fault=fault)
    return mean_loss(family, conf, state["x"], tokens[0])
