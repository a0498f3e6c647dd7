"""The numbers that decide ``correct``: what a training state says about
its first steps, taken alike from the program's state and from the
reference's, and the gaps between the two.

* ``loss``: each of the first rounds' logged loss; the gap is the largest
  ``|program - reference| / |reference|``.
* ``grad``: the first gradient as the update takes it, worked out from the
  state after the warm-up aggregation, ``(x0 - x) / alpha - d`` (the sum
  of the warm-up's two gradients): per leaf, its norm over every client;
  ``grad_clients`` is the median over clients of each client's worst-leaf
  gap (a client's warm-up gradients depend on no other client, so a
  discrete flip in one client's routing moves one of the four).
* ``update``: per leaf, the norm of ``x - x0`` after the first rounds.
* ``drift``, ``shift``: per leaf, the norm of ``d`` and of the shift
  memory ``h`` after the first rounds.

A per-leaf number's gap is the worst leaf's ``|norm_program -
norm_reference|`` over the larger of the reference's norm of that leaf and
of the median leaf; ``<number>_median`` is the median leaf's gap, which a
discrete decision flipped by round-off in one small leaf (an MoE router's
top-k at a near-tie) leaves steady. Leaves whose reference gradient is
under a thousandth of the median leaf's move by round-off alone and are
left out."""

from __future__ import annotations

import math
import statistics

import torch

#: a leaf whose reference gradient norm is under this share of the median
#: leaf's is not compared
NOUGHT = 1e-3


def _sq(t: torch.Tensor) -> float:
    return float(t.double().pow(2).sum())


def leaf_norms(tree: dict, x0: dict | None = None) -> dict:
    """``{name: norm}`` of each stacked leaf of ``tree`` (of ``tree - x0``
    with ``x0``), one client at a time, in float64."""
    out = {}
    for n, a in tree.items():
        s = 0.0
        for i in range(a.shape[0]):
            s += _sq(a[i] if x0 is None else a[i] - x0[n].to(a.device))
        out[n] = math.sqrt(s)
    return out


def warmup_grad_norms(x: dict, d: dict, x0: dict, alpha: float) -> dict:
    """Per-leaf, per-client norms of ``(x0 - x) / alpha - d``:
    ``{name: [norm of client 0, ...]}``."""
    out = {}
    for n, a in x.items():
        x0n = x0[n].to(a.device)
        out[n] = [math.sqrt(_sq((x0n - a[i]) / alpha - d[n][i]))
                  for i in range(a.shape[0])]
    return out


def over_clients(by_client: dict) -> dict:
    """``{name: norm over every client}`` of per-client norms."""
    return {n: math.sqrt(sum(v * v for v in c)) for n, c in by_client.items()}


def compared_leaves(ref_grad: dict) -> list:
    """The leaves whose reference gradient (norm over every client) moves
    them."""
    floor = NOUGHT * statistics.median(ref_grad.values())
    return [n for n, g in ref_grad.items() if g >= floor]


def leaf_gaps(prog: dict, ref: dict, leaves: list) -> dict:
    """``{leaf: gap}`` over the compared leaves."""
    med = statistics.median(ref[n] for n in leaves)
    return {n: (abs(prog[n] - ref[n]) / max(ref[n], med, 1e-300)
                if math.isfinite(prog[n]) else math.inf) for n in leaves}


def gaps(prog: dict, ref: dict) -> dict:
    """``{number: (gap, where)}`` between two readings dicts (``loss`` a
    list; ``grad`` per-leaf, per-client norms; ``update``, ``drift`` and,
    where both have it, ``shift`` per-leaf norms). Each per-leaf number
    comes as the worst leaf's gap and as the median leaf's,
    ``<name>_median``; ``grad`` also as ``grad_clients``."""
    ref_grad = over_clients(ref["grad"])
    leaves = compared_leaves(ref_grad)
    losses = [abs(p - r) / abs(r) for p, r in zip(prog["loss"], ref["loss"])]
    if len(prog["loss"]) != len(ref["loss"]) or not all(
            map(math.isfinite, prog["loss"])):
        losses = [math.inf]
    out = {"loss": (max(losses), f"round {losses.index(max(losses))}")}
    per_leaf = {"grad": (over_clients(prog["grad"]), ref_grad)}
    for k in ("update", "drift", "shift"):
        if ref.get(k) is not None and prog.get(k) is not None:
            per_leaf[k] = (prog[k], ref[k])
    for k, (p, r) in per_leaf.items():
        by = leaf_gaps(p, r, leaves)
        ranked = sorted(by, key=by.get)
        out[k] = (by[ranked[-1]], ranked[-1])
        mid = ranked[(len(ranked) - 1) // 2]
        out[f"{k}_median"] = (by[mid], mid)
    worst = []
    for i in range(len(next(iter(ref["grad"].values())))):
        by = leaf_gaps({n: prog["grad"][n][i] for n in leaves},
                       {n: ref["grad"][n][i] for n in leaves}, leaves)
        worst.append(max(by.values()))
    out["grad_clients"] = (statistics.median(worst), "clients " + " ".join(
        f"{w:.3g}" for w in worst))
    return out
