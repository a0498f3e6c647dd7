"""The ``nemotron_h`` family as published (``NemotronHForCausalLM``,
nvidia/NVIDIA-Nemotron-3-Nano-30B-A3B-BF16): a stack of single-mixer
blocks, one letter of ``hybrid_override_pattern`` each, every block ``h <-
h + mixer(RMSNorm(h))`` (eps ``layer_norm_epsilon``), then the final
RMSNorm and an untied head. Plain PyTorch, one client at a time,
gradients by autograd.

* ``M``, Mamba2 with ``n_groups`` B/C groups: ``[z, xBC, dt] = h W_in``;
  ``xBC = silu(conv(xBC) + b)`` (depthwise, causal, ``conv_kernel`` taps),
  split into ``x, B, C``; ``dt = softplus(dt + dt_bias)``, ``A =
  -exp(A_log)``; the SSD scan ``s_t = exp(dt_t A) s_{t-1} + dt_t B_t x_t``,
  ``y_t = C_t s_t + D x_t``, head ``j`` reading group ``j // (H / G)``, in
  its chunked dual form (``chunk_size`` positions a chunk); ``y =
  RMSNorm(y * silu(z))`` within each group's channels; ``out = y W_out``.
* ``E``, MoE: ``s = sigmoid(h W_r)`` over ``router_experts`` experts;
  the top ``num_experts_per_tok`` by ``s + b_corr``; weights ``s_top /
  (sum s_top + 1e-20) * routed_scaling_factor``; ``out = sum over the
  chosen held experts w_e W_down,e relu(W_up,e h)^2`` plus the shared
  expert ``W_down,s relu(W_up,s h)^2``. The card holds experts ``0 ..
  n_routed_experts - 1`` (its share of an expert-parallel layer); an
  expert takes every token that chose it, the rest of the routed result
  lies on other cards and is left out.
* ``*``, attention: causal GQA with no positional embedding, scale
  ``head_dim ** -0.5``, computed in query blocks of ``QUERY_BLOCK``
  against the keys up to the block's end.

Parameters use the port's layout: ``embed``, then the layers stacked by
kind, ``mamba.*`` ``[L_M, ...]``, ``moe.*`` ``[L_E, ...]`` (held experts
``[L_E, E_held, d_in, d_out]``), ``attn.*`` ``[L_A, ...]``, each kind's
``norm`` first; dense weights ``[d_in, d_out]``, norm weights as deltas
around 1; ``final_norm.weight``, ``lm_head [d, V]``."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from fedbench.reference.common import next_token_ce, rms_norm

#: query rows a block of the attention: 32 heads x 1,024 x 8,192 float32
#: scores are 1 GiB, where the whole 8,192^2 would be 8
QUERY_BLOCK = 1024
KINDS = {"M": "mamba", "E": "moe", "*": "attn"}


def _dims(conf: dict) -> dict:
    H, P = conf["mamba_num_heads"], conf["mamba_head_dim"]
    G, N = conf["n_groups"], conf["ssm_state_size"]
    pattern = conf["hybrid_override_pattern"]
    return dict(
        pattern=pattern, d=conf["hidden_size"], eps=conf["layer_norm_epsilon"],
        H=H, P=P, di=H * P, G=G, N=N, K=conf["conv_kernel"],
        conv=H * P + 2 * G * N, chunk=conf["chunk_size"],
        E=conf["router_experts"], Eh=conf["n_routed_experts"],
        k=conf["num_experts_per_tok"], ff=conf["moe_intermediate_size"],
        ffs=conf["moe_shared_expert_intermediate_size"],
        Hq=conf["num_attention_heads"], Hkv=conf["num_key_value_heads"],
        dh=conf["head_dim"], V=conf["vocab_size"],
        count={kind: pattern.count(c) for c, kind in KINDS.items()})


def param_spec(conf: dict) -> dict:
    """``{dotted name: (shape, init)}`` in the port's tree order: dense
    weights normal of std ``1/sqrt(d_in)`` (0.02 for the router, the
    embedding and the head), the Mamba2 leaves as ``ssm.py`` draws them,
    norm deltas 0, ``router_bias`` uniform on +-0.05 (assumed: the
    published initial value is zeros, and a trained model's bias is not
    given)."""
    n = _dims(conf)
    d, di, H, G, N, K, ch = (n[k] for k in
                             ("d", "di", "H", "G", "N", "K", "conv"))
    std = lambda fan_in: ("normal", fan_in ** -0.5)  # noqa: E731
    bound = K ** -0.5
    spec = {"embed": ((n["V"], d), ("normal", 0.02))}
    L = n["count"]["mamba"]
    if L:
        spec.update({
            "mamba.norm": ((L, d), ("const", 0.0)),
            "mamba.wz": ((L, d, di), std(d)),
            "mamba.wx": ((L, d, di), std(d)),
            "mamba.wB": ((L, d, G * N), std(d)),
            "mamba.wC": ((L, d, G * N), std(d)),
            "mamba.wdt": ((L, d, H), std(d)),
            "mamba.dt_bias": ((L, H), ("inv_softplus_log_uniform", 1e-3,
                                       0.1)),
            "mamba.A_log": ((L, H), ("log_uniform", 1.0, 16.0)),
            "mamba.D": ((L, H), ("const", 1.0)),
            "mamba.conv_w": ((L, ch, K), ("uniform", -bound, bound)),
            "mamba.conv_b": ((L, ch), ("uniform", -bound, bound)),
            "mamba.out_norm": ((L, di), ("const", 0.0)),
            "mamba.out_proj": ((L, di, d), std(di)),
        })
    L = n["count"]["moe"]
    if L:
        E, Eh, ff, ffs = n["E"], n["Eh"], n["ff"], n["ffs"]
        spec.update({
            "moe.norm": ((L, d), ("const", 0.0)),
            "moe.router": ((L, d, E), ("normal", 0.02)),
            "moe.router_bias": ((L, E), ("uniform", -0.05, 0.05)),
            "moe.up": ((L, Eh, d, ff), std(d)),
            "moe.down": ((L, Eh, ff, d), std(ff)),
            "moe.shared.up": ((L, d, ffs), std(d)),
            "moe.shared.down": ((L, ffs, d), std(ffs)),
        })
    L = n["count"]["attn"]
    if L:
        Hq, Hkv, dh = n["Hq"], n["Hkv"], n["dh"]
        spec.update({
            "attn.norm": ((L, d), ("const", 0.0)),
            "attn.wq": ((L, d, Hq * dh), std(d)),
            "attn.wk": ((L, d, Hkv * dh), std(d)),
            "attn.wv": ((L, d, Hkv * dh), std(d)),
            "attn.wo": ((L, Hq * dh, d), std(Hq * dh)),
        })
    spec["final_norm.weight"] = ((d,), ("const", 0.0))
    spec["lm_head"] = ((d, n["V"]), ("normal", 0.02))
    return spec


def arch_kwargs(conf: dict) -> dict:
    """The port's ``ArchConfig`` fields for ``conf``; raises where the
    configuration asks for what the port does not compute."""
    n, port = _dims(conf), conf["program"]
    same = {"tie_word_embeddings": False, "mlp_hidden_act": "relu2",
            "mamba_hidden_act": "silu", "n_group": 1, "topk_group": 1,
            "n_shared_experts": 1, "use_bias": False, "use_conv_bias": True,
            "attention_bias": False, "mlp_bias": False,
            "mamba_proj_bias": False, "norm_topk_prob": True,
            "chunk_size": 128, "norm_eps": n["eps"]}
    off = {k: conf[k] for k, v in same.items() if conf[k] != v}
    if off:
        raise ValueError(f"the port's nemotron_h stack does not compute {off}")
    return dict(name=conf["name"], family="nemotron_h",
                n_layers=len(n["pattern"]), d_model=n["d"], n_heads=n["Hq"],
                n_kv_heads=n["Hkv"], head_dim=n["dh"], d_ff=n["ff"],
                vocab_size=n["V"], use_rope=False, activation="relu2",
                norm_eps=n["eps"], n_experts=n["E"], experts_per_token=n["k"],
                moe_routed_scale=float(conf["routed_scaling_factor"]),
                moe_shared_ff=n["ffs"], experts_held=n["Eh"],
                ssm_state=n["N"], ssm_headdim=n["P"], ssm_heads=n["H"],
                ssm_groups=n["G"], ssm_conv=n["K"],
                layer_pattern=n["pattern"], dtype="float32",
                param_dtype="float32", remat=port["remat"],
                scan_layers=port["scan_layers"])


def ssd_chunked(x, dt, A, Bm, Cm, chunk: int):
    """The SSD scan of ``x [B, S, H, P]`` with steps ``dt [B, S, H]``,
    ``A [H]`` and each head's own ``Bm, Cm [B, S, H, N]``, from a zero
    state: within a chunk the quadratic form, across chunks the carried
    state."""
    Bz, S, H, P = x.shape
    Lc = min(chunk, S)
    nc = S // Lc
    x = x.reshape(Bz, nc, Lc, H, P)
    dt = dt.reshape(Bz, nc, Lc, H)
    Bm = Bm.reshape(Bz, nc, Lc, H, -1)
    Cm = Cm.reshape(Bz, nc, Lc, H, -1)
    acs = torch.cumsum(dt * A, dim=2)                              # [B,c,l,H]
    seg = acs[:, :, :, None, :] - acs[:, :, None, :, :]          # [B,c,i,j,H]
    causal = torch.ones(Lc, Lc, dtype=torch.bool, device=x.device).tril()
    decay = torch.exp(seg.masked_fill(~causal[None, None, :, :, None],
                                      float("-inf")))
    w = torch.einsum("bcihn,bcjhn->bcijh", Cm, Bm) * decay \
        * dt[:, :, None, :, :]                                   # [B,c,i,j,H]
    y = torch.einsum("bcijh,bcjhp->bcihp", w, x)
    to_end = torch.exp(acs[:, :, -1:, :] - acs)
    states = torch.einsum("bcjhn,bcjhp->bchpn", Bm,
                          (to_end * dt)[..., None] * x)
    h = torch.zeros_like(states[:, 0])
    before = []
    for c in range(nc):
        before.append(h)
        h = h * torch.exp(acs[:, c, -1])[..., None, None] + states[:, c]
    y = y + torch.einsum("bcihn,bchpn->bcihp", Cm,
                         torch.stack(before, dim=1)) \
        * torch.exp(acs)[..., None]
    return y.reshape(Bz, S, H, P)


def _mamba(p: dict, h: torch.Tensor, l: int, n: dict) -> torch.Tensor:
    Bz, S, _ = h.shape
    H, P, G, N, di = n["H"], n["P"], n["G"], n["N"], n["di"]
    z = h @ p["mamba.wz"][l]
    xbc = torch.cat([h @ p["mamba.wx"][l], h @ p["mamba.wB"][l],
                     h @ p["mamba.wC"][l]], dim=-1)
    xbc = F.conv1d(F.pad(xbc.transpose(1, 2), (n["K"] - 1, 0)),
                   p["mamba.conv_w"][l][:, None, :], p["mamba.conv_b"][l],
                   groups=n["conv"]).transpose(1, 2)
    xs, Bm, Cm = torch.split(F.silu(xbc), [di, G * N, G * N], dim=-1)
    dt = F.softplus(h @ p["mamba.wdt"][l] + p["mamba.dt_bias"][l])
    A = -torch.exp(p["mamba.A_log"][l])
    xs = xs.reshape(Bz, S, H, P)
    per_head = lambda m: m.reshape(Bz, S, G, N).repeat_interleave(  # noqa
        H // G, dim=2)
    y = ssd_chunked(xs, dt, A, per_head(Bm), per_head(Cm), n["chunk"])
    y = (y + p["mamba.D"][l][:, None] * xs).reshape(Bz, S, di) * F.silu(z)
    y = rms_norm(y.reshape(Bz, S, G, di // G),
                 p["mamba.out_norm"][l].reshape(G, di // G), n["eps"])
    return y.reshape(Bz, S, di) @ p["mamba.out_proj"][l]


def _moe(p: dict, x: torch.Tensor, l: int, conf: dict, n: dict):
    """The held experts' part and the shared expert for ``x [T, d]``."""
    scores = torch.sigmoid(x @ p["moe.router"][l])
    bias = p["moe.router_bias"][l]
    top = torch.topk(scores + bias, n["k"], dim=-1)[1]
    # the bias only chooses: it enters the weights times 0, which adds an
    # exact 0 and gives autograd its zero gradient
    w = torch.gather(scores, -1, top) + 0.0 * bias[top]
    if conf["norm_topk_prob"]:
        w = w / (w.sum(-1, keepdim=True) + 1e-20)
    w = w * conf["routed_scaling_factor"]
    out = torch.zeros_like(x)
    for e in range(n["Eh"]):
        chose = top == e                                    # [T, k]
        toks = torch.nonzero(chose.any(-1))[:, 0]
        if toks.numel() == 0:
            continue
        we = (w * chose)[toks].sum(-1, keepdim=True)
        ye = F.relu(x[toks] @ p["moe.up"][l, e]).square() \
            @ p["moe.down"][l, e]
        out = out.index_add(0, toks, ye * we)
    return out + F.relu(x @ p["moe.shared.up"][l]).square() \
        @ p["moe.shared.down"][l]


def _attention(p: dict, x: torch.Tensor, l: int, n: dict):
    B, S, _ = x.shape
    Hq, Hkv, dh = n["Hq"], n["Hkv"], n["dh"]
    q = (x @ p["attn.wq"][l]).view(B, S, Hq, dh)
    k = (x @ p["attn.wk"][l]).view(B, S, Hkv, dh)
    v = (x @ p["attn.wv"][l]).view(B, S, Hkv, dh)
    k = k.repeat_interleave(Hq // Hkv, dim=2)
    v = v.repeat_interleave(Hq // Hkv, dim=2)
    outs = []
    for lo in range(0, S, QUERY_BLOCK):
        hi = min(lo + QUERY_BLOCK, S)
        s = torch.einsum("bshd,bthd->bhst", q[:, lo:hi], k[:, :hi]) \
            * dh ** -0.5
        causal = (torch.arange(hi, device=x.device)[None, :]
                  <= torch.arange(lo, hi, device=x.device)[:, None])
        a = torch.softmax(s.masked_fill(~causal, float("-inf")), dim=-1)
        outs.append(torch.einsum("bhst,bthd->bshd", a, v[:, :hi]))
    return torch.cat(outs, dim=1).reshape(B, S, Hq * dh) @ p["attn.wo"][l]


def loss(conf: dict, p: dict, tokens: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross entropy of one client's ``tokens [B, S]``;
    ``p`` maps dotted names to one client's leaves."""
    n = _dims(conf)
    eps = n["eps"]
    B, S = tokens.shape
    x = p["embed"][tokens.long()]
    seen = dict.fromkeys(KINDS.values(), 0)
    for c in n["pattern"]:
        kind = KINDS[c]
        l = seen[kind]
        seen[kind] += 1
        h = rms_norm(x, p[f"{kind}.norm"][l], eps)
        if kind == "mamba":
            x = x + _mamba(p, h, l, n)
        elif kind == "moe":
            x = x + _moe(p, h.reshape(B * S, -1), l, conf, n).view(B, S, -1)
        else:
            x = x + _attention(p, h, l, n)
    x = rms_norm(x, p["final_norm.weight"], eps)
    return next_token_ce(x, p["lm_head"], tokens, 1.0)


def train_flops_per_token(conf: dict, seq_len: int) -> float:
    """Model FLOPs of one trained token: ``6 N`` for the ``N`` weights a
    token multiplies by (the Mamba2 projections and conv; the router, the
    shared expert and ``k * E_held / E`` routed experts, the held
    experts' expected share of a token's k; the attention projections; the
    head; not the embedding lookup), plus the causal score and value
    products, ``6 Hq dh (S + 1)`` an attention layer, and the SSD
    recurrence's ``12 H P N`` a Mamba2 layer (each the forward's third,
    as in ``moe.py`` and ``ssm.py``). Recomputation and the executed
    dense-over-held expert work are not counted."""
    n = _dims(conf)
    d, di, H, P, G, N = (n[k] for k in ("d", "di", "H", "P", "G", "N"))
    Hq, Hkv, dh = n["Hq"], n["Hkv"], n["dh"]
    mamba = d * (2 * di + 2 * G * N + H) + n["conv"] * n["K"] + di * d
    moe = d * n["E"] + n["k"] * n["Eh"] / n["E"] * 2 * d * n["ff"] \
        + 2 * d * n["ffs"]
    attn = d * Hq * dh + 2 * d * Hkv * dh + Hq * dh * d
    c = n["count"]
    N_ = c["mamba"] * mamba + c["moe"] * moe + c["attn"] * attn + d * n["V"]
    return (6.0 * N_ + c["attn"] * 6.0 * Hq * dh * (seq_len + 1)
            + c["mamba"] * 12.0 * H * P * N)


def test_conf(conf: dict) -> dict:
    """A CPU-sized configuration of the same shape: the pattern's period,
    narrow widths (8 Mamba2 heads of 16 in 2 groups, state 16; 16 experts
    routed over, 4 held, top 3, a shared expert; 2 / 1 heads of 16), the
    published chunk, a short vocabulary."""
    return {**conf, "hidden_size": 64, "mamba_num_heads": 8,
            "mamba_head_dim": 16, "n_groups": 2, "ssm_state_size": 16,
            "router_experts": 16, "n_routed_experts": 4,
            "num_experts_per_tok": 3, "moe_intermediate_size": 32,
            "moe_shared_expert_intermediate_size": 48,
            "num_attention_heads": 2, "num_key_value_heads": 1,
            "head_dim": 16, "vocab_size": 256}
