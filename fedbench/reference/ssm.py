"""The ``ssm`` family as published: Mamba2 (arXiv:2405.21060), an
attention-free stack of pre-norm residual blocks. A block projects its
normed input to ``z``, ``x``, ``B``, ``C`` (one group) and ``dt``; ``x, B,
C`` go through a depthwise causal conv of width ``d_conv`` and SiLU; the
SSD scan ``h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t``, ``y_t = C_t h_t +
D x_t`` runs in its chunked dual form (``chunk_size`` positions a chunk,
the states passed from chunk to chunk); ``y * silu(z)`` is RMS-normed and
projected back. Plain PyTorch, one client at a time, autograd.

Parameters use the port's layout: the input projection split into ``wz,
wx, wB, wC, wdt`` (``[d_in, d_out]``), layers stacked ``[L, ...]``, norm
weights as deltas around 1, ``conv_w [channels, d_conv]``, an untied
``lm_head [d, V]``. Initial values as published: ``A = -exp(A_log)``
with ``exp(A_log)`` uniform on [1, 16], ``dt_bias`` the inverse softplus
of a log-uniform draw on [1e-3, 0.1], ``D`` 1, the conv uniform on
``+-1/sqrt(d_conv)``."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from fedbench.reference.common import next_token_ce, rms_norm


def _dims(conf: dict) -> dict:
    """Sizes of ``conf``; the vocabulary padded up to a multiple of
    ``pad_vocab_size_multiple``, as the published model pads it."""
    s = conf["ssm_cfg"]
    d = conf["d_model"]
    di = s["expand"] * d
    pad = conf.get("pad_vocab_size_multiple", 1)
    return dict(L=conf["n_layer"], d=d, di=di, P=s["headdim"],
                H=di // s["headdim"], N=s["d_state"], K=s["d_conv"],
                conv=di + 2 * s["ngroups"] * s["d_state"],
                V=-(-conf["vocab_size"] // pad) * pad, chunk=s["chunk_size"])


def param_spec(conf: dict) -> dict:
    """``{dotted name: (shape, init)}`` in the port's tree order."""
    n = _dims(conf)
    L, d, di, H, N, K, ch, V = (n[k] for k in
                                ("L", "d", "di", "H", "N", "K", "conv", "V"))
    std = lambda fan_in: ("normal", fan_in ** -0.5)  # noqa: E731
    bound = K ** -0.5
    return {
        "embed": ((V, d), ("normal", 0.02)),
        "layers.norm": ((L, d), ("const", 0.0)),
        "layers.wz": ((L, d, di), std(d)),
        "layers.wx": ((L, d, di), std(d)),
        "layers.wB": ((L, d, N), std(d)),
        "layers.wC": ((L, d, N), std(d)),
        "layers.wdt": ((L, d, H), std(d)),
        "layers.dt_bias": ((L, H), ("inv_softplus_log_uniform", 1e-3, 0.1)),
        "layers.A_log": ((L, H), ("log_uniform", 1.0, 16.0)),
        "layers.D": ((L, H), ("const", 1.0)),
        "layers.conv_w": ((L, ch, K), ("uniform", -bound, bound)),
        "layers.conv_b": ((L, ch), ("uniform", -bound, bound)),
        "layers.out_norm": ((L, di), ("const", 0.0)),
        "layers.out_proj": ((L, di, d), std(di)),
        "final_norm.weight": ((d,), ("const", 0.0)),
        "lm_head": ((d, V), ("normal", 0.02)),
    }


def arch_kwargs(conf: dict) -> dict:
    """The port's ``ArchConfig`` fields for ``conf``; raises where the
    configuration asks for what the port does not compute."""
    n, s, port = _dims(conf), conf["ssm_cfg"], conf["program"]
    if conf["tie_embeddings"] or conf["norm_epsilon"] != 1e-6 \
            or s["ngroups"] != 1 or s["chunk_size"] != 128:
        raise ValueError("the port unties the head, takes RMSNorm eps "
                         "1e-6, one group and chunks of 128")
    return dict(name=conf["name"], family="ssm", n_layers=n["L"],
                d_model=n["d"], n_heads=0, n_kv_heads=0, head_dim=None,
                d_ff=0, vocab_size=n["V"], ssm_state=n["N"],
                ssm_headdim=n["P"], ssm_expand=s["expand"], ssm_conv=n["K"],
                dtype="float32", param_dtype="float32",
                remat=port["remat"], scan_layers=port["scan_layers"])


def ssd_chunked(x, dt, A, Bm, Cm, chunk: int):
    """The SSD scan of ``x [B, S, H, P]`` with steps ``dt [B, S, H]``,
    ``A [H]``, ``Bm, Cm [B, S, N]``, from a zero state: within a chunk the
    quadratic (attention-like) form, across chunks the carried state."""
    Bz, S, H, P = x.shape
    Lc = min(chunk, S)
    nc = S // Lc
    x = x.reshape(Bz, nc, Lc, H, P)
    dt = dt.reshape(Bz, nc, Lc, H)
    Bm = Bm.reshape(Bz, nc, Lc, -1)
    Cm = Cm.reshape(Bz, nc, Lc, -1)
    acs = torch.cumsum(dt * A, dim=2)                              # [B,c,l,H]
    seg = acs[:, :, :, None, :] - acs[:, :, None, :, :]          # [B,c,i,j,H]
    causal = torch.ones(Lc, Lc, dtype=torch.bool, device=x.device).tril()
    decay = torch.exp(seg.masked_fill(~causal[None, None, :, :, None],
                                      float("-inf")))
    # pairwise contractions: a many-operand einsum may materialize a
    # [B, c, i, j, H, P] product
    w = torch.einsum("bcin,bcjn->bcij", Cm, Bm)[..., None] * decay \
        * dt[:, :, None, :, :]                                   # [B,c,i,j,H]
    y = torch.einsum("bcijh,bcjhp->bcihp", w, x)
    to_end = torch.exp(acs[:, :, -1:, :] - acs)
    states = torch.einsum("bcjn,bcjhp->bchpn", Bm,
                          (to_end * dt)[..., None] * x)
    h = torch.zeros_like(states[:, 0])
    before = []
    for c in range(nc):
        before.append(h)
        h = h * torch.exp(acs[:, c, -1])[..., None, None] + states[:, c]
    y = y + torch.einsum("bcin,bchpn->bcihp", Cm, torch.stack(before, dim=1)) \
        * torch.exp(acs)[..., None]
    return y.reshape(Bz, S, H, P)


def _block(p: dict, u: torch.Tensor, l: int, conf: dict, n: dict):
    eps = conf["norm_epsilon"]
    Bz, S, _ = u.shape
    h = rms_norm(u, p["layers.norm"][l], eps)
    z = h @ p["layers.wz"][l]
    xbc = torch.cat([h @ p["layers.wx"][l], h @ p["layers.wB"][l],
                     h @ p["layers.wC"][l]], dim=-1)
    xbc = F.conv1d(F.pad(xbc.transpose(1, 2), (n["K"] - 1, 0)),
                   p["layers.conv_w"][l][:, None, :], p["layers.conv_b"][l],
                   groups=n["conv"]).transpose(1, 2)
    xs, Bm, Cm = torch.split(F.silu(xbc), [n["di"], n["N"], n["N"]], dim=-1)
    dt = F.softplus(h @ p["layers.wdt"][l] + p["layers.dt_bias"][l])
    A = -torch.exp(p["layers.A_log"][l])
    xs = xs.reshape(Bz, S, n["H"], n["P"])
    y = ssd_chunked(xs, dt, A, Bm, Cm, n["chunk"])
    y = (y + p["layers.D"][l][:, None] * xs).reshape(Bz, S, n["di"])
    y = rms_norm(y * F.silu(z), p["layers.out_norm"][l], eps)
    return u + y @ p["layers.out_proj"][l]


def loss(conf: dict, p: dict, tokens: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross entropy of one client's ``tokens [B, S]``;
    ``p`` maps dotted names to one client's leaves."""
    n = _dims(conf)
    x = p["embed"][tokens.long()]
    for l in range(n["L"]):
        x = _block(p, x, l, conf, n)
    x = rms_norm(x, p["final_norm.weight"], conf["norm_epsilon"])
    return next_token_ce(x, p["lm_head"], tokens, 1.0)


def train_flops_per_token(conf: dict, seq_len: int) -> float:
    """Model FLOPs of one trained token: ``6 N`` for the ``N`` weights a
    token multiplies by (the projections, the depthwise conv, the head;
    not the embedding lookup), plus the SSD recurrence's ``12 H P N`` a
    layer (forward: the state update and the read-out, ``2 H P N`` each;
    the backward twice the forward). Recomputation is not counted."""
    del seq_len
    n = _dims(conf)
    d, di, H, P, N = n["d"], n["di"], n["H"], n["P"], n["N"]
    per_layer = d * (2 * di + 2 * N + H) + n["conv"] * n["K"] + di * d
    return 6.0 * (n["L"] * per_layer + d * n["V"]) + n["L"] * 12.0 * H * P * N


def test_conf(conf: dict) -> dict:
    """A CPU-sized configuration of the same shape: 2 layers, narrow
    widths, the published chunk, a short vocabulary."""
    return {**conf, "n_layer": 2, "d_model": 64, "vocab_size": 256,
            "ssm_cfg": {**conf["ssm_cfg"], "d_state": 16, "headdim": 16}}
