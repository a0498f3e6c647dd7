"""Decoder-only dense transformer LM (port of
``src/repro/models/transformer.py``, dense family: training and serving).

The model is a pure function of an explicit parameter tree with the
reference's keys and layouts (``embed [V, d]``, ``lm_head [d, V]``, dense
weights ``[d_in, d_out]``), because FedCET treats the whole tree as the
optimization variable and stacks it over clients. Two layer layouts, as in
the reference: stacked ``[L, ...]`` leaves (``scan_layers=True``, the full
config; the reference's ``lax.scan`` becomes a loop over ``L``) or a list
of per-layer dicts (``reduced()``). Activation checkpointing (``remat``)
is not applied: the model runs inside ``torch.func`` transforms.

Serving: ``init_caches`` (stacked ``[L, ...]`` caches for stacked layers,
a list otherwise), ``prefill`` (every layer's full-sequence attention
through the flash-attention kernel, the caches filled in place) and
``decode_step``. ``use_pallas_attention`` sends ``forward`` through the
same kernel; it has no backward, so ``loss`` under autograd raises then.
MoE, layernorm, MLP biases, embedding scale and VLM inputs wait for later
slices.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn
from repro_torch.models.layers import (
    apply_mlp,
    embed_init,
    init_mlp,
    init_norm,
    rms_norm,
    torch_dtype,
)
from repro_torch.models.losses import chunked_ce
from repro_torch.utils.tree import tree_index


def init_block(gen: torch.Generator, cfg: ArchConfig, *, lead: tuple = (),
               device=None) -> dict:
    dtype = torch_dtype(cfg.param_dtype)
    kw = dict(lead=lead, device=device)
    return {
        "ln1": init_norm(cfg.d_model, dtype, **kw),
        "attn": attn.init_attention(
            gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
            dtype, qk_norm=cfg.qk_norm, with_bias=cfg.attn_bias, **kw),
        "ln2": init_norm(cfg.d_model, dtype, **kw),
        "mlp": init_mlp(gen, cfg.d_model, cfg.d_ff, dtype,
                        activation=cfg.activation, **kw),
    }


def _attn_kw(cfg: ArchConfig) -> dict:
    return dict(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                head_dim=cfg.head_dim, kind=cfg.attention, window=cfg.window,
                chunk=cfg.chunk, rope_theta=cfg.rope_theta,
                use_rope=cfg.use_rope)


def _mlp_residual(p: dict, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    h = rms_norm(x, p["ln2"]["weight"])
    return x + apply_mlp(h, p["mlp"], activation=cfg.activation)


def apply_block(p: dict, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """One decoder block over a full sequence."""
    h = attn.attention(p["attn"], rms_norm(x, p["ln1"]["weight"]),
                       block_size=cfg.attn_block_size,
                       use_pallas=cfg.use_pallas_attention, **_attn_kw(cfg))
    return _mlp_residual(p, x + h, cfg)


def apply_block_prefill(p: dict, x: torch.Tensor, cache: attn.KVCache,
                        cfg: ArchConfig, *, ring: bool):
    h, cache = attn.prefill_attention(
        p["attn"], rms_norm(x, p["ln1"]["weight"]), cache=cache, ring=ring,
        **_attn_kw(cfg))
    return _mlp_residual(p, x + h, cfg), cache


def apply_block_decode(p: dict, x1: torch.Tensor, cache: attn.KVCache,
                       cfg: ArchConfig, *, ring: bool):
    h, cache = attn.decode_attention(
        p["attn"], rms_norm(x1, p["ln1"]["weight"]), cache, ring=ring,
        **_attn_kw(cfg))
    return _mlp_residual(p, x1 + h, cfg), cache


class TransformerLM(nn.Module):
    """Dense decoder-only LM: ``init``, ``forward`` and ``loss`` over an
    explicit parameter tree."""

    def __init__(self, cfg: ArchConfig):
        super().__init__()
        unsupported = {
            "family": cfg.family != "dense",
            "n_experts": bool(cfg.n_experts),
            "norm": cfg.norm != "rmsnorm",
            "mlp_bias": cfg.mlp_bias,
            "embed_scale": cfg.embed_scale,
        }
        bad = [k for k, v in unsupported.items() if v]
        if bad:
            raise NotImplementedError(
                f"{cfg.name}: {', '.join(bad)} not yet ported (the port runs "
                "the dense RMSNorm/SwiGLU transformer; ROADMAP.md Queue 1 "
                "item 6)")
        self.cfg = cfg

    # ------------------------------------------------------------------ init
    def init(self, gen: torch.Generator, device=None) -> dict:
        """Random parameters from ``gen`` (a ``torch.Generator`` on
        ``device``); the reference's shapes and scales, not its draws."""
        cfg = self.cfg
        dtype = torch_dtype(cfg.param_dtype)
        if cfg.scan_layers:
            layers = init_block(gen, cfg, lead=(cfg.n_layers,), device=device)
        else:
            layers = [init_block(gen, cfg, device=device)
                      for _ in range(cfg.n_layers)]
        p = {
            "embed": embed_init(gen, cfg.vocab_size, cfg.d_model, dtype,
                                device=device),
            "layers": layers,
            "final_norm": init_norm(cfg.d_model, dtype, device=device),
        }
        if not cfg.tie_embeddings:
            p["lm_head"] = embed_init(gen, cfg.vocab_size, cfg.d_model, dtype,
                                      device=device).t().contiguous()
        return p

    # -------------------------------------------------------------- forward
    def _embed(self, params, tokens):
        x = F.embedding(tokens.to(torch.int64), params["embed"])
        return x.to(torch_dtype(self.cfg.dtype))

    def _hidden(self, params, tokens):
        """Final-norm hidden states [B, S, d]."""
        cfg = self.cfg
        x = self._embed(params, tokens)
        if cfg.scan_layers:
            for i in range(cfg.n_layers):
                x = apply_block(tree_index(params["layers"], i), x, cfg)
        else:
            for p in params["layers"]:
                x = apply_block(p, x, cfg)
        return rms_norm(x, params["final_norm"]["weight"])

    def _head(self, params):
        return (params["embed"].t() if self.cfg.tie_embeddings
                else params["lm_head"])

    def forward(self, params, batch) -> torch.Tensor:
        """Full-sequence logits [B, S, V]."""
        return self._hidden(params, batch["tokens"]) @ self._head(params)

    def loss(self, params, batch) -> torch.Tensor:
        """Mean next-token cross entropy (a float32 scalar)."""
        return chunked_ce(self._hidden(params, batch["tokens"]),
                          self._head(params), batch["tokens"])

    # ---------------------------------------------------------------- serve
    def _ring(self) -> bool:
        # sliding windows and chunked-local both keep a bounded ring cache
        return self.cfg.attention in ("sliding", "chunked")

    def cache_capacity(self, seq_len: int) -> int:
        cfg = self.cfg
        if cfg.attention == "sliding":
            return min(cfg.window, seq_len)
        if cfg.attention == "chunked":
            return min(cfg.chunk, seq_len)
        return seq_len

    def init_caches(self, batch: int, seq_len: int, device=None):
        """Empty KV caches for ``seq_len`` tokens: one ``KVCache`` with
        stacked ``[L, ...]`` tensors for stacked layers, a list of
        per-layer caches otherwise."""
        cfg = self.cfg
        cap = self.cache_capacity(seq_len)
        dtype = torch_dtype(cfg.dtype)
        one = lambda: attn.init_cache(batch, cap, cfg.n_kv_heads,  # noqa: E731
                                      cfg.head_dim, dtype, device=device)
        if cfg.scan_layers:
            c = one()
            stack = lambda t: t.expand(  # noqa: E731
                (cfg.n_layers,) + t.shape).contiguous()
            return attn.KVCache(stack(c.k), stack(c.v), stack(c.pos), 0)
        return [one() for _ in range(cfg.n_layers)]

    def _layers_with_caches(self, params, caches, x, block):
        """Run ``block(p, x, cache, cfg, ring=...)`` over the layers;
        stacked caches are written through per-layer views."""
        cfg, ring = self.cfg, self._ring()
        if cfg.scan_layers:
            cache = caches
            for i in range(cfg.n_layers):
                view = attn.KVCache(caches.k[i], caches.v[i], caches.pos[i],
                                    caches.length)
                x, cache = block(tree_index(params["layers"], i), x, view,
                                 cfg, ring=ring)
            return x, caches._replace(length=cache.length)
        new = []
        for p, cache in zip(params["layers"], caches):
            x, cache = block(p, x, cache, cfg, ring=ring)
            new.append(cache)
        return x, new

    def prefill(self, params, batch, caches):
        """Run the prompt; returns (last-token logits [B, 1, V], the
        caches filled)."""
        x = self._embed(params, batch["tokens"])
        x, caches = self._layers_with_caches(params, caches, x,
                                             apply_block_prefill)
        x = rms_norm(x[:, -1:], params["final_norm"]["weight"])
        return x @ self._head(params), caches

    def decode_step(self, params, token, caches):
        """One decode step. token: [B, 1] -> (logits [B, 1, V], caches)."""
        x = self._embed(params, token)
        x, caches = self._layers_with_caches(params, caches, x,
                                             apply_block_decode)
        x = rms_norm(x, params["final_norm"]["weight"])
        return x @ self._head(params), caches
