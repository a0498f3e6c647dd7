"""The nemotron_h family of the port (``models/nemotron_h.py``, the grouped
Mamba2 of ``models/mamba2.py``, the sigmoid router and held share of
``models/moe.py``) against the benchmark's plain reference
(``fedbench/reference/nemotron_h.py``), on the CPU at small sizes.

Port and reference run in float32 from the same weights (the reference's
``param_spec`` drawn by ``make_weights``, unflattened into the port's
tree, so the check also ties the two layouts). Tolerances: the loss within
rtol 2e-5 and every leaf's gradient within 2e-4 of the largest gradient
of that leaf. The two compute the same sums in other orders (the grouped
SSD against a per-head one, a dense product over the held experts against
a loop over the tokens that chose each), so they part by float32
round-off, a few 1e-6 of a value's scale through a few layers; a bfloat16
program (a relative step of 3.9e-3 on every operand) would part by 1e-3
or more. The router's top k are chosen alike: at these sizes no score
lies within round-off of its neighbour."""

import dataclasses
import json
from pathlib import Path

import pytest
import torch

from fedbench.reference import nemotron_h as ref
from fedbench.reference.common import flatten, make_weights, unflatten
from repro_torch.configs import get_config, list_archs
from repro_torch.configs.base import ArchConfig
from repro_torch.core import FedCET
from repro_torch.kernels import ops as kops
from repro_torch.models import build_model
from repro_torch.models import mamba2 as M
from repro_torch.models import moe
from repro_torch.utils import spans
from repro_torch.utils.tree import tree_leaves, tree_map

ROOT = Path(__file__).resolve().parents[1]
CONF = ref.test_conf(json.loads(
    (ROOT / "fedbench" / "configs" / "nemotron-3-nano-30b-a3b-p7.json")
    .read_text()))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _conf(pattern: str, **kw) -> dict:
    return {**CONF, "hybrid_override_pattern": pattern,
            "num_hidden_layers": len(pattern), **kw}


def _pair(conf: dict, seed: int = 3):
    """(port model, its tree, the reference's flat leaves), one weights."""
    _, flat = make_weights(ref.param_spec(conf), seed, "cpu")
    flat = {n: t.clone() for n, t in flat.items()}
    model = build_model(ArchConfig(**ref.arch_kwargs(conf)))
    return model, unflatten(flat), flat


def _tokens(S: int, B: int = 2, seed: int = 0) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, CONF["vocab_size"], (B, S), generator=g)


@pytest.mark.parametrize("pattern,S", [("M", 256), ("E", 64), ("*", 96),
                                       ("*", 1100), ("MEMEM*E", 256),
                                       ("MEMEM*E", 1152)])
def test_loss_and_grads_match_the_reference(pattern, S):
    """Each mixer alone (attention both under 1,024 tokens and on the
    blockwise path past it) and the published period on both paths, in
    the benchmark's program settings (stacked layers, rematerialized)."""
    conf = _conf(pattern)
    model, tree, flat = _pair(conf)
    toks = _tokens(S)
    loss, grads = torch.func.grad_and_value(model.loss)(
        tree, {"tokens": toks})[::-1]
    leaves = {n: t.clone().requires_grad_() for n, t in flat.items()}
    want = ref.loss(conf, leaves, toks)
    wgrads = dict(zip(leaves, torch.autograd.grad(want, list(
        leaves.values()))))
    torch.testing.assert_close(loss, want, rtol=2e-5, atol=0)
    for name, g in flatten(grads).items():
        w = wgrads[name]
        err = float((g - w).abs().max())
        assert err <= 2e-4 * max(float(w.abs().max()), 1e-12), (name, err)


def test_grouped_ssd_matches_the_recurrence():
    """The chunked dual form with B and C in 4 groups (two chunks and a
    padded third) against ``ssd_naive``'s literal recurrence, and G = 1
    against the one-group code."""
    g = torch.Generator().manual_seed(1)
    Bz, S, H, P, G, N = 2, 300, 8, 4, 4, 6
    x = torch.randn(Bz, S, H, P, generator=g, dtype=torch.float64)
    dt = torch.rand(Bz, S, H, generator=g, dtype=torch.float64) * 0.2
    A = -torch.rand(H, generator=g, dtype=torch.float64) * 4 - 0.5
    Bm = torch.randn(Bz, S, G, N, generator=g, dtype=torch.float64)
    Cm = torch.randn(Bz, S, G, N, generator=g, dtype=torch.float64)
    want, h_want = M.ssd_naive(x, dt, A, Bm, Cm)
    got, h_got = M.ssd_chunked(x, dt, A, Bm, Cm, chunk=128)
    torch.testing.assert_close(got.double(), want.double(), rtol=1e-5,
                               atol=1e-5)
    torch.testing.assert_close(h_got.double(), h_want.double(), rtol=1e-5,
                               atol=1e-5)
    one, _ = M.ssd_chunked(x, dt, A, Bm[:, :, 0], Cm[:, :, 0], chunk=128)
    grouped, _ = M.ssd_chunked(x, dt, A, Bm[:, :, :1], Cm[:, :, :1],
                               chunk=128)
    torch.testing.assert_close(grouped, one, rtol=1e-6, atol=1e-6)
    with pytest.raises(NotImplementedError, match="one B/C group"):
        M.ssd_chunked(x, dt, A, Bm, Cm, use_kernel=True)
    with pytest.raises(NotImplementedError, match="one B/C group"):
        kops.ssd_intra(x.reshape(Bz, 3, 100, H, P), dt.reshape(Bz, 3, 100, H),
                       dt.reshape(Bz, 3, 100, H),
                       Bm.reshape(Bz, 3, 100, G, N),
                       Cm.reshape(Bz, 3, 100, G, N))


def test_shares_of_the_experts_add_up_to_the_uncut_layer():
    """At ``test_conf`` size, 16 experts over 4 cards of 4: each card's
    port layer (its experts put first in the router's order, which routes
    alike) less the shared expert, summed over the cards, plus the shared
    expert once, equals the reference's layer holding all 16."""
    E, Eh = CONF["router_experts"], CONF["n_routed_experts"]
    conf = _conf("E", n_routed_experts=E)
    _, flat = make_weights(ref.param_spec(conf), 5, "cpu")
    x = torch.randn(64, CONF["hidden_size"],
                    generator=torch.Generator().manual_seed(2))
    want = ref._moe(flat, x, 0, conf, ref._dims(conf))
    shared = {"up": flat["moe.shared.up"][0],
              "down": flat["moe.shared.down"][0]}
    kw = dict(k=CONF["num_experts_per_tok"], held=Eh,
              routed_scale=CONF["routed_scaling_factor"], activation="relu2")
    total = moe.apply_mlp(x, shared, activation="relu2")
    for card in range(E // Eh):
        mine = torch.arange(card * Eh, (card + 1) * Eh)
        order = torch.cat([mine, torch.tensor(
            [e for e in range(E) if e not in mine.tolist()])])
        p = {"router": flat["moe.router"][0][:, order],
             "router_bias": flat["moe.router_bias"][0][order],
             "up": flat["moe.up"][0][mine], "down": flat["moe.down"][0][mine],
             "shared": shared}
        part = moe.apply_moe_held(p, x[None], **kw)[0]
        total = total + part - moe.apply_mlp(x, shared, activation="relu2")
    torch.testing.assert_close(total, want, rtol=1e-5, atol=1e-6)


def test_skewed_routing_drops_no_token():
    """Every token routed to expert 0 (a correction bias of 10 on it): the
    capacity of the softmax path's dispatch at 1.25 would keep a fraction
    of them; the held layer gives every token expert 0's part at its
    weight, token by token."""
    T, d, E, k, held, ff = 48, 16, 8, 2, 4, 8
    g = torch.Generator().manual_seed(4)
    p = {"router": torch.randn(d, E, generator=g) * 0.1,
         "router_bias": torch.zeros(E).index_fill(0, torch.tensor([0]), 10.),
         "up": torch.randn(held, d, ff, generator=g),
         "down": torch.randn(held, ff, d, generator=g)}
    x = torch.randn(1, T, d, generator=g)
    assert moe.capacity(T, k, E, 1.25) < T
    out = moe.apply_moe_held(p, x, k=k, held=held, routed_scale=1.0,
                             activation="relu2")[0]
    w, ids = moe.sigmoid_route(x[0] @ p["router"], p["router_bias"], k,
                               scale=1.0)
    assert bool((ids == 0).any(-1).all())
    for t in range(T):
        want = torch.zeros(d)
        for j in range(k):
            e = int(ids[t, j])
            if e < held:
                want = want + w[t, j] * (
                    torch.relu(x[0, t] @ p["up"][e]).square() @ p["down"][e])
        torch.testing.assert_close(out[t], want, rtol=1e-5, atol=1e-5)


def test_spans_split_the_forward_and_change_nothing():
    """Recorder on or off, the loss and the gradients are bitwise equal;
    on, each block records its mixer's span."""
    conf = _conf("MEMEM*E")
    model, tree, _ = _pair(conf)
    batch = {"tokens": _tokens(64)}
    fn = torch.func.grad_and_value(model.loss)
    off = fn(tree, batch)
    spans.enable()
    try:
        on = fn(tree, batch)
    finally:
        spans.disable()
    names = [s.name for s in spans.drain().spans]
    assert names == [ref.KINDS[c] for c in "MEMEM*E"]
    assert torch.equal(off[1], on[1])
    for a, b in zip(tree_leaves(off[0]), tree_leaves(on[0])):
        assert torch.equal(a, b)


def test_fedcet_round_on_the_reduced_config():
    """One FedCET round (tau 2, 2 clients) on the reduced published
    config holding half its experts: finite, shapes kept, the drift moved,
    the correction bias untouched."""
    cfg = dataclasses.replace(get_config("nemotron-3-nano-30b-a3b").reduced(),
                              experts_held=2)
    assert cfg.layer_pattern == "ME*" and cfg.ssm_groups == 2
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    params["moe"][0]["router_bias"].uniform_(-0.05, 0.05)
    algo = FedCET(alpha=1e-2, c=0.1, tau=2, n_clients=2)
    toks = torch.randint(0, cfg.vocab_size, (2, 2, 2, 16),
                         generator=torch.Generator().manual_seed(1))
    grad_fn = torch.func.grad(model.loss)
    state = algo.init(grad_fn, params, {"tokens": toks[0]})
    state = algo.round(grad_fn, state, {"tokens": toks})
    assert all(bool(torch.isfinite(t).all()) for t in tree_leaves(state.x))
    assert tree_leaves(tree_map(lambda a: tuple(a.shape[1:]), state.x)) \
        == tree_leaves(tree_map(lambda a: tuple(a.shape), params))
    assert sum(float(d.abs().sum()) for d in tree_leaves(state.d)) > 0.0
    for c in range(2):
        assert torch.equal(state.x["moe"][0]["router_bias"][c],
                           params["moe"][0]["router_bias"])


def test_config_resolves_and_serving_raises():
    """The port-only entry resolves by name, stays out of the mirrored
    registry, carries the published sizes, and its family refuses to
    serve."""
    cfg = get_config("nemotron-3-nano-30b-a3b")
    assert cfg.name not in list_archs()
    assert (cfg.n_layers, cfg.d_model, M.ssm_dims(cfg), cfg.ssm_groups,
            cfg.n_experts, cfg.experts_per_token, cfg.moe_shared_ff,
            cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.vocab_size) == (
        52, 2688, (4096, 64, 64, 128), 8, 128, 6, 3712, 32, 2, 128, 131072)
    assert cfg.layer_pattern.count("*") == 6
    model = build_model(cfg.reduced())
    with pytest.raises(NotImplementedError, match="nemotron_h"):
        model.init_caches(1, 8)

