"""One FedCET round of the moe, hybrid and audio families through the
card's kernels (``@pytest.mark.cuda``: each skips where CUDA is not
available). Reduced granite-moe, zamba2 and whisper under B's scenario
(``shift:q8`` + arena), 4 clients, tau 2, seed-0 weights, batches from
``launch/input_specs.make_batch``: the init and the round launch the triad
3 times and the fused round tail and the packed dither twice each, and
x, d and the shift memory
equal the same init and round with every kernel routed to its plain
version (``impl="ref"``) within ``chip_smoke.py``'s ``K_PLAIN_MAX`` (x and
h 1e-6 of their norms, d 1e-5 of ``c ||x||``). Against the reference on
the CPU these rounds are held by ``tests/test_torch_{moe,hybrid,
encdec}.py``; the full-width paths MO, ZA and WH are ``chip_smoke.py``'s.
"""

import math

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import FedScenario
from repro_torch.core import FedCET
from repro_torch.kernels import library as L
from repro_torch.kernels import ops
from repro_torch.launch import input_specs
from repro_torch.models import build_model
from repro_torch.utils.tree import tree_map

NC, TAU, ALPHA, CW = 4, 2, 3e-3, 0.05
TOL = {"x": 1e-6, "h": 1e-6, "d": 1e-5}


def _round(model, cfg, params, batches, plain):
    algo = FedScenario(compression="shift:q8", arena=True).apply(
        FedCET(alpha=ALPHA, c=CW, tau=TAU, n_clients=NC, x64=False))
    grad = torch.func.grad(model.loss)
    forms = ("fedcet_v", "fedcet_round_tail", "arena_uniform")
    real = {k: getattr(ops, k) for k in forms}
    if plain:
        for k, fn in real.items():
            setattr(ops, k, lambda *a, fn=fn, **kw: fn(*a, **{**kw,
                                                             "impl": "ref"}))
    try:
        state = algo.init(grad, params, tree_map(lambda b: b[0], batches))
        state = algo.round(grad, state, batches)
    finally:
        for k, fn in real.items():
            setattr(ops, k, fn)
    return [a.data for a in (state.inner.x, state.inner.d, state.extras[0])]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["granite-moe-3b-a800m", "zamba2-1.2b",
                                  "whisper-small"])
def test_cuda_fedcet_round_through_the_kernels_matches_plain(name):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA is not available)")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(name).reduced()
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        device="cuda")
    seq = 16 if cfg.family == "audio" else 32
    batches = tree_map(lambda *xs: torch.stack(xs), *[
        tree_map(lambda *ys: torch.stack(ys), *[
            input_specs.make_batch(cfg, 2, seq, key=10 * t + c,
                                   device="cuda") for c in range(NC)])
        for t in range(TAU)])
    L.reset_launches()
    got = _round(model, cfg, params, batches, plain=False)
    launches = {k: v for k, v in L.LAUNCHES.items() if v}
    assert launches == {"fedcet_v": 3, "fedcet_round_tail": 2,
                        "threefry_uniform_rows": 2}, launches
    L.reset_launches()
    want = _round(model, cfg, params, batches, plain=True)
    assert not any(L.LAUNCHES.values()), dict(L.LAUNCHES)
    norm = lambda t: math.sqrt(float(t.double().pow(2).sum()))  # noqa: E731
    x = norm(want[0])
    gaps = {"x": norm(got[0] - want[0]) / x,
            "d": norm(got[1] - want[1]) / (CW * x),
            "h": norm(got[2] - want[2]) / norm(want[2])}
    assert all(math.isfinite(norm(t)) for t in got), name
    assert all(g <= TOL[k] for k, g in gaps.items()), (name, gaps)
