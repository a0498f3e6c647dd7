"""The ``moe`` family as published: a decoder-only transformer (granite-
moe, ``GraniteMoeForCausalLM``) with RMSNorm, rotary grouped-query
attention and a sparse SwiGLU feed-forward of ``num_local_experts``
experts, ``num_experts_per_tok`` of them per token. Plain PyTorch, one
client at a time, gradients by autograd.

The router's top-k weights are renormalized over the k chosen experts;
an expert takes at most ``int(capacity_factor * T * k / E)`` of the ``T``
tokens of the call, the earliest in token order, and a token past that
gets nothing from it (the port's dispatch: the published model drops
nothing). The load-balance term ``E * sum_e frac_e * mean_prob_e`` (the
share of tokens whose first choice is e) enters the loss times
``router_aux_loss_coef``. The configuration's multipliers scale the
embeddings, the residual branches, the attention scores and the logits.

Parameters use the port's layout: layers stacked ``[L, ...]``, dense
weights ``[d_in, d_out]``, experts ``[L, E, d_in, d_out]``, norm weights
as deltas around 1; the output head is ``embed`` transposed where
``tie_word_embeddings`` (as published), else a leaf ``lm_head [d, V]``."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from fedbench.reference.common import next_token_ce, rms_norm, rope


def _dims(conf: dict) -> dict:
    d, H = conf["hidden_size"], conf["num_attention_heads"]
    return dict(L=conf["num_hidden_layers"], d=d, H=H,
                Hkv=conf["num_key_value_heads"], dh=d // H,
                ff=conf["intermediate_size"], E=conf["num_local_experts"],
                k=conf["num_experts_per_tok"], V=conf["vocab_size"])


def param_spec(conf: dict) -> dict:
    """``{dotted name: (shape, init)}`` in the port's tree order: normal
    weights of std ``1/sqrt(d_in)`` (0.02 for the router, the embedding and
    the head), every expert drawn apart, norm deltas 0; ``lm_head`` only
    where the head is untied."""
    n = _dims(conf)
    L, d, H, Hkv, dh, ff, E, V = (n[k] for k in
                                  ("L", "d", "H", "Hkv", "dh", "ff", "E", "V"))
    std = lambda fan_in: ("normal", fan_in ** -0.5)  # noqa: E731
    spec = {
        "embed": ((V, d), ("normal", 0.02)),
        "layers.ln1.weight": ((L, d), ("const", 0.0)),
        "layers.attn.wq": ((L, d, H * dh), std(d)),
        "layers.attn.wk": ((L, d, Hkv * dh), std(d)),
        "layers.attn.wv": ((L, d, Hkv * dh), std(d)),
        "layers.attn.wo": ((L, H * dh, d), std(H * dh)),
        "layers.ln2.weight": ((L, d), ("const", 0.0)),
        "layers.moe.router": ((L, d, E), ("normal", 0.02)),
        "layers.moe.gate": ((L, E, d, ff), std(d)),
        "layers.moe.up": ((L, E, d, ff), std(d)),
        "layers.moe.down": ((L, E, ff, d), std(ff)),
        "final_norm.weight": ((d,), ("const", 0.0)),
    }
    if not conf["tie_word_embeddings"]:
        spec["lm_head"] = ((d, V), ("normal", 0.02))
    return spec


def arch_kwargs(conf: dict) -> dict:
    """The port's ``ArchConfig`` fields for ``conf``; raises where the
    configuration asks for what the port does not compute."""
    n = _dims(conf)
    port = conf["program"]
    if (conf["embedding_multiplier"], conf["residual_multiplier"],
            conf["logits_scaling"]) != (1.0, 1.0, 1.0) \
            or conf["attention_multiplier"] != n["dh"] ** -0.5:
        raise ValueError("the port computes no granite multipliers")
    if conf["rms_norm_eps"] != 1e-6 or conf["router_aux_loss_coef"] != 0.01:
        raise ValueError("the port takes RMSNorm eps 1e-6 and a "
                         "load-balance coefficient of 0.01")
    return dict(name=conf["name"], family="moe", n_layers=n["L"],
                d_model=n["d"], n_heads=n["H"], n_kv_heads=n["Hkv"],
                head_dim=n["dh"], d_ff=n["ff"], vocab_size=n["V"],
                n_experts=n["E"], experts_per_token=n["k"],
                activation="swiglu", rope_theta=float(conf["rope_theta"]),
                capacity_factor=float(conf["capacity_factor"]),
                tie_embeddings=bool(conf["tie_word_embeddings"]),
                dtype="float32", param_dtype="float32",
                remat=port["remat"], scan_layers=port["scan_layers"])


def _attention(p: dict, x: torch.Tensor, l: int, conf: dict, n: dict):
    B, S, _ = x.shape
    H, Hkv, dh = n["H"], n["Hkv"], n["dh"]
    q = (x @ p["layers.attn.wq"][l]).view(B, S, H, dh)
    k = (x @ p["layers.attn.wk"][l]).view(B, S, Hkv, dh)
    v = (x @ p["layers.attn.wv"][l]).view(B, S, Hkv, dh)
    q, k = rope(q, conf["rope_theta"]), rope(k, conf["rope_theta"])
    k = k.repeat_interleave(H // Hkv, dim=2)
    v = v.repeat_interleave(H // Hkv, dim=2)
    s = torch.einsum("bshd,bthd->bhst", q, k) * conf["attention_multiplier"]
    causal = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
    a = torch.softmax(s.masked_fill(~causal, float("-inf")), dim=-1)
    o = torch.einsum("bhst,bthd->bshd", a, v).reshape(B, S, H * dh)
    return o @ p["layers.attn.wo"][l]


def _moe(p: dict, x: torch.Tensor, l: int, conf: dict, n: dict):
    """``(out [T, d], load-balance term)`` for the tokens ``x [T, d]``."""
    T, E, k = x.shape[0], n["E"], n["k"]
    probs = torch.softmax(x @ p["layers.moe.router"][l], dim=-1)
    topw, tope = torch.topk(probs, k, dim=-1)
    topw = topw / torch.clamp_min(topw.sum(-1, keepdim=True), 1e-9)
    cap = max(1, int(conf["capacity_factor"] * T * k / E))
    out = torch.zeros_like(x)
    for e in range(E):
        chose = tope == e                                   # [T, k]
        toks = torch.nonzero(chose.any(-1))[:cap, 0]
        if toks.numel() == 0:
            continue
        w = (topw * chose)[toks].sum(-1, keepdim=True)
        xe = x[toks]
        ye = (F.silu(xe @ p["layers.moe.gate"][l, e])
              * (xe @ p["layers.moe.up"][l, e])) @ p["layers.moe.down"][l, e]
        out = out.index_add(0, toks, ye * w)
    frac = torch.bincount(tope[:, 0], minlength=E).to(x.dtype) / T
    return out, E * torch.sum(frac * probs.mean(0))


def loss(conf: dict, p: dict, tokens: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross entropy of one client's ``tokens [B, S]`` plus
    the load-balance terms; ``p`` maps dotted names to one client's
    leaves."""
    n = _dims(conf)
    eps, r = conf["rms_norm_eps"], conf["residual_multiplier"]
    B, S = tokens.shape
    x = p["embed"][tokens.long()] * conf["embedding_multiplier"]
    aux = torch.zeros((), device=x.device)
    for l in range(n["L"]):
        x = x + r * _attention(p, rms_norm(x, p["layers.ln1.weight"][l], eps),
                               l, conf, n)
        h = rms_norm(x, p["layers.ln2.weight"][l], eps).reshape(B * S, -1)
        y, a = _moe(p, h, l, conf, n)
        x = x + r * y.view(B, S, -1)
        aux = aux + a
    x = rms_norm(x, p["final_norm.weight"], eps)
    head = p["embed"].t() if conf["tie_word_embeddings"] else p["lm_head"]
    return (next_token_ce(x, head, tokens, conf["logits_scaling"])
            + conf["router_aux_loss_coef"] * aux)


def train_flops_per_token(conf: dict, seq_len: int) -> float:
    """Model FLOPs of one trained token: ``6 N`` for the ``N`` weights a
    token multiplies by (attention, router, ``k`` of ``E`` experts, the
    head; not the embedding lookup), plus the causal score and value
    products, ``6 H dh (S + 1)`` a layer (forward ``2 H dh (S + 1)``, the
    backward twice that). Recomputation is not counted."""
    n = _dims(conf)
    d, H, Hkv, dh, ff = n["d"], n["H"], n["Hkv"], n["dh"], n["ff"]
    per_layer = (d * H * dh + 2 * d * Hkv * dh + H * dh * d + d * n["E"]
                 + n["k"] * 3 * d * ff)
    N = n["L"] * per_layer + d * n["V"]
    return 6.0 * N + n["L"] * 6.0 * H * dh * (seq_len + 1)


def test_conf(conf: dict) -> dict:
    """A CPU-sized configuration of the same shape: 2 layers, narrow
    widths, 4 experts (top 2), a short vocabulary, capacity unchanged."""
    return {**conf, "num_hidden_layers": 2, "hidden_size": 64,
            "num_attention_heads": 4, "num_key_value_heads": 2,
            "attention_multiplier": 0.25, "intermediate_size": 32,
            "num_local_experts": 4, "num_experts_per_tok": 2,
            "vocab_size": 256}
