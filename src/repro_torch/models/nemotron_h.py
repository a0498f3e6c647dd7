"""NemotronH hybrid LM, the nemotron_h family [hf:nvidia/NVIDIA-Nemotron-
3-Nano-30B-A3B-BF16, ``modeling_nemotron_h.py``] (no reference
counterpart: the JAX package has no such family).

A stack of single-mixer blocks, one letter of ``cfg.layer_pattern`` each
(``M`` Mamba2, ``E`` MoE, ``*`` attention). Every block is

    h <- h + mixer(RMSNorm(h))          (eps ``cfg.norm_eps``, no multipliers)

and after the blocks come the final RMSNorm, an untied ``lm_head [d, V]``
and the chunked cross entropy (``models/losses.py``). The mixers:

* **M** (``models/mamba2.py``, G = ``ssm_groups`` B/C groups, H heads of
  P, state N): ``[z, xBC, dt] = h W_in`` of widths ``(H P, H P + 2 G N,
  H)``; ``xBC = silu(causal_conv4(xBC) + b)``, split into ``x, B, C`` of
  widths ``(H P, G N, G N)``; ``dt = softplus(dt + dt_bias)`` (no clamp),
  ``A = -exp(A_log)``; the SSD recurrence ``s_t = exp(dt_t A) s_{t-1} +
  dt_t B_t^{g(j)} x_t``, ``y_t = C_t^{g(j)} . s_t + D x_t`` with ``g(j) =
  j // (H / G)``; ``y = GroupRMSNorm(y * silu(z))`` within each group of
  ``H P / G`` channels; ``out = y W_out``.
* **E** (``models/moe.py:apply_moe_held``): ``s = sigmoid(h W_r)`` over
  all ``n_experts``; the top k by ``s + b_corr`` (a leaf that no gradient
  moves); ``w = s_top / (sum s_top + 1e-20) * moe_routed_scale``,
  normalized over all k chosen experts, held or not; ``out = sum_{e in top
  and held} w_e W_down,e relu(W_up,e h)^2 + W_down,s relu(W_up,s h)^2``.
  Experts ``0 .. experts_held - 1`` live on this card, each run over every
  token (drop-free).
* **\\*** (``models/attention.py``): causal GQA, ``n_heads`` / ``n_kv_heads``
  heads of ``head_dim``, scale ``head_dim ** -0.5``, no positional
  embedding (``use_rope=False``); training takes the blockwise attention.

Parameters: ``embed [V, d]``, then one subtree a kind of mixer
(``mamba``, ``moe``, ``attn``, in that order, those the pattern names),
each with its block's ``norm`` first: stacked ``[L_kind, ...]`` leaves
with ``scan_layers``, else a list of per-layer dicts; then ``final_norm``
and ``lm_head``. With ``remat`` and ``scan_layers`` each Mamba2 and MoE
layer is recomputed in the backward; an attention layer relies on its KV
blocks' own recompute.

Spans (``utils/spans.py``, off by default): ``mamba``, ``moe`` and
``attn`` around each block's call, outside every rematerialization, so in
the round's ``loss`` call they split the forward by mixer. Serving is not
ported: ``init_caches``, ``prefill`` and ``decode_step`` raise.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn
from repro_torch.models import remat
from repro_torch.models.layers import (embed_init, embed_lookup, init_norm,
                                       rms_norm, torch_dtype)
from repro_torch.models.losses import chunked_ce
from repro_torch.models.mamba2 import apply_mamba_block, init_mamba_block
from repro_torch.models.moe import apply_moe_held, init_moe
from repro_torch.utils import spans
from repro_torch.utils.tree import tree_index

#: the pattern's letters, by the kind of mixer (and span name) each names
KINDS = {"M": "mamba", "E": "moe", "*": "attn"}


def layer_kinds(cfg: ArchConfig) -> list:
    """The kind of each layer, in order."""
    if len(cfg.layer_pattern) != cfg.n_layers:
        raise ValueError(f"{cfg.name}: layer_pattern has "
                         f"{len(cfg.layer_pattern)} letters for "
                         f"{cfg.n_layers} layers")
    return [KINDS[c] for c in cfg.layer_pattern]


def init_layer(gen: torch.Generator, cfg: ArchConfig, kind: str, *,
               lead: tuple = (), device=None) -> dict:
    """One block's parameters ``[*lead, ...]``: its ``norm``, then its
    mixer's."""
    if kind == "mamba":
        return init_mamba_block(gen, cfg, lead=lead, device=device)
    dtype = torch_dtype(cfg.param_dtype)
    kw = dict(lead=lead, device=device)
    p = {"norm": init_norm(cfg.d_model, dtype, **kw)["weight"]}
    if kind == "moe":
        p.update(init_moe(gen, cfg.d_model, cfg.d_ff, cfg.n_experts, dtype,
                          shared_expert=bool(cfg.moe_shared_ff),
                          activation=cfg.activation, router_bias=True,
                          held=cfg.experts_held,
                          shared_ff=cfg.moe_shared_ff, **kw))
    else:
        p.update(attn.init_attention(gen, cfg.d_model, cfg.n_heads,
                                     cfg.n_kv_heads, cfg.head_dim, dtype,
                                     **kw))
    return p


def apply_layer(p: dict, x: torch.Tensor, cfg: ArchConfig,
                kind: str) -> torch.Tensor:
    """``x + mixer(RMSNorm(x))`` for one block over a full sequence."""
    if kind == "mamba":  # the Mamba2 block norms and adds its residual
        return apply_mamba_block(p, x, cfg)
    h = rms_norm(x, p["norm"], eps=cfg.norm_eps)
    if kind == "moe":
        return x + apply_moe_held(
            p, h, k=cfg.experts_per_token,
            held=cfg.experts_held or cfg.n_experts,
            routed_scale=cfg.moe_routed_scale, activation=cfg.activation)
    return x + attn.attention(
        p, h, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.head_dim, kind="causal", use_rope=cfg.use_rope,
        rope_theta=cfg.rope_theta, block_size=cfg.attn_block_size,
        use_pallas=cfg.use_pallas_attention)


class NemotronHLM(nn.Module):
    """The pattern stack: ``init``, ``forward`` and ``loss`` over an
    explicit parameter tree; serving raises."""

    def __init__(self, cfg: ArchConfig):
        super().__init__()
        if cfg.family != "nemotron_h":
            raise ValueError(f"{cfg.name}: NemotronHLM builds the nemotron_h "
                             f"family, not {cfg.family!r}")
        self.cfg = cfg
        self.kinds = layer_kinds(cfg)

    def _present(self) -> list:
        return [k for k in KINDS.values() if k in self.kinds]

    # ------------------------------------------------------------------ init
    def init(self, gen: torch.Generator, device=None) -> dict:
        """Random parameters from ``gen`` (a ``torch.Generator`` on
        ``device``)."""
        cfg = self.cfg
        dtype = torch_dtype(cfg.param_dtype)
        p = {"embed": embed_init(gen, cfg.vocab_size, cfg.d_model, dtype,
                                 device=device)}
        for kind in self._present():
            n = self.kinds.count(kind)
            p[kind] = (init_layer(gen, cfg, kind, lead=(n,), device=device)
                       if cfg.scan_layers else
                       [init_layer(gen, cfg, kind, device=device)
                        for _ in range(n)])
        p["final_norm"] = init_norm(cfg.d_model, dtype, device=device)
        p["lm_head"] = embed_init(gen, cfg.vocab_size, cfg.d_model, dtype,
                                  device=device).t().contiguous()
        return p

    # -------------------------------------------------------------- forward
    def _hidden(self, params, tokens):
        """Final-norm hidden states [B, S, d]."""
        cfg = self.cfg
        x = embed_lookup(tokens, params["embed"]).to(torch_dtype(cfg.dtype))
        seen = dict.fromkeys(KINDS.values(), 0)
        for kind in self.kinds:
            i = seen[kind]
            seen[kind] += 1
            p = (tree_index(params[kind], i) if cfg.scan_layers
                 else params[kind][i])
            body = lambda p, x, kind=kind: apply_layer(  # noqa: E731
                p, x, cfg, kind)
            # an attention layer keeps to its KV blocks' own recompute:
            # inside a layer's recompute the blocks would run as they are
            # and keep every block's scores for the backward
            if cfg.remat and cfg.scan_layers and kind != "attn":
                body = remat.checkpoint(body)
            with spans.span(kind):
                x = body(p, x)
        return rms_norm(x, params["final_norm"]["weight"], eps=cfg.norm_eps)

    def forward(self, params, batch) -> torch.Tensor:
        """Full-sequence logits [B, S, V]."""
        return self._hidden(params, batch["tokens"]) @ params["lm_head"]

    def loss(self, params, batch) -> torch.Tensor:
        """Mean next-token cross entropy (a float32 scalar); the sigmoid
        router has no load-balance term."""
        return chunked_ce(self._hidden(params, batch["tokens"]),
                          params["lm_head"], batch["tokens"])

    # ---------------------------------------------------------------- serve
    def _no_serving(self, what: str):
        raise NotImplementedError(
            f"{self.cfg.name}: {what} is not ported for the nemotron_h "
            "family (ROADMAP.md queue C)")

    def init_caches(self, batch: int, seq_len: int, device=None):
        self._no_serving("init_caches")

    def prefill(self, params, batch, caches):
        self._no_serving("prefill")

    def decode_step(self, params, token, caches):
        self._no_serving("decode_step")
