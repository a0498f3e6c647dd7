"""Decoder-only transformer LM (port of ``src/repro/models/transformer.py``:
the dense, moe and vlm families, training and serving).

The model is a pure function of an explicit parameter tree with the
reference's keys and layouts (``embed [V, d]``, ``lm_head [d, V]``, dense
weights ``[d_in, d_out]``, stacked experts ``[E, d, d_ff]``), because
FedCET treats the whole tree as the optimization variable and stacks it
over clients. Two layer layouts, as in the reference: stacked ``[L,
...]`` leaves (``scan_layers=True``, the full config; the reference's
``lax.scan`` becomes a loop over ``L``) or a list of per-layer dicts
(``reduced()``). With ``cfg.remat`` each stacked layer is
rematerialized (``models/remat.py``): the backward keeps the layer
boundaries and recomputes one layer at a time, as the reference's
``jax.checkpoint`` on its scan body.

Block variants: RMSNorm or LayerNorm (with biases), SwiGLU, GeGLU or GELU
MLPs (with biases), MoE feed-forwards (``models/moe.py``: their load-
balance term enters ``loss`` times ``MOE_AUX_COEF``), and embeddings
scaled by ``sqrt(d_model)`` in the parameters' dtype (gemma). The vlm
family (llava-next) takes stub image-patch embeddings
``batch["image_embeds"] [B, n_img, d]`` before the text: the sequence is
``[image tokens][text tokens]``, ``loss`` scores text positions only, and
serving caches hold ``S + n_modal_tokens`` positions.

Serving: ``init_caches`` (stacked ``[L, ...]`` caches for stacked layers,
a list otherwise), ``prefill`` (every layer's full-sequence attention
through the flash-attention kernel, the caches filled in place) and
``decode_step``. ``use_pallas_attention`` sends ``forward`` through the
same kernel; it has no backward, so ``loss`` under autograd raises then.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn
from repro_torch.models import remat
from repro_torch.models.layers import (
    apply_mlp,
    apply_norm,
    embed_init,
    embed_lookup,
    init_mlp,
    init_norm,
    torch_dtype,
)
from repro_torch.models.losses import chunked_ce
from repro_torch.models.moe import apply_moe, init_moe
from repro_torch.utils.sharding_ctx import shard_residual
from repro_torch.utils.tree import tree_index

MOE_AUX_COEF = 0.01


def init_block(gen: torch.Generator, cfg: ArchConfig, *, lead: tuple = (),
               device=None) -> dict:
    dtype = torch_dtype(cfg.param_dtype)
    kw = dict(lead=lead, device=device)
    with_bias = cfg.norm == "layernorm"
    p = {
        "ln1": init_norm(cfg.d_model, dtype, with_bias=with_bias, **kw),
        "attn": attn.init_attention(
            gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
            dtype, qk_norm=cfg.qk_norm, with_bias=cfg.attn_bias, **kw),
        "ln2": init_norm(cfg.d_model, dtype, with_bias=with_bias, **kw),
    }
    if cfg.n_experts:
        p["moe"] = init_moe(gen, cfg.d_model, cfg.d_ff, cfg.n_experts, dtype,
                            shared_expert=cfg.moe_shared_expert,
                            activation=cfg.activation, **kw)
    else:
        p["mlp"] = init_mlp(gen, cfg.d_model, cfg.d_ff, dtype,
                            activation=cfg.activation, with_bias=cfg.mlp_bias,
                            **kw)
    return p


def _attn_kw(cfg: ArchConfig) -> dict:
    return dict(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                head_dim=cfg.head_dim, kind=cfg.attention, window=cfg.window,
                chunk=cfg.chunk, rope_theta=cfg.rope_theta,
                use_rope=cfg.use_rope)


def _ffn_residual(p: dict, x: torch.Tensor, cfg: ArchConfig):
    """``(x + ffn(norm(x)), aux)``: the MLP, or the MoE and its
    load-balance term (a float32 0 for an MLP)."""
    h = apply_norm(x, p["ln2"], cfg.norm)
    if cfg.n_experts:
        h, aux = apply_moe(p["moe"], h, n_experts=cfg.n_experts,
                           k=cfg.experts_per_token,
                           capacity_factor=cfg.capacity_factor,
                           activation=cfg.activation,
                           shared_expert=cfg.moe_shared_expert)
        return x + h, aux
    return (x + apply_mlp(h, p["mlp"], activation=cfg.activation),
            torch.zeros((), dtype=torch.float32, device=x.device))


def apply_block(p: dict, x: torch.Tensor, cfg: ArchConfig):
    """``(x, aux)`` for one decoder block over a full sequence."""
    x = shard_residual(x)
    h = attn.attention(p["attn"], apply_norm(x, p["ln1"], cfg.norm),
                       block_size=cfg.attn_block_size,
                       use_pallas=cfg.use_pallas_attention, **_attn_kw(cfg))
    return _ffn_residual(p, x + h, cfg)


def apply_block_prefill(p: dict, x: torch.Tensor, cache: attn.KVCache,
                        cfg: ArchConfig, *, ring: bool):
    x = shard_residual(x)
    h, cache = attn.prefill_attention(
        p["attn"], apply_norm(x, p["ln1"], cfg.norm), cache=cache,
        ring=ring, **_attn_kw(cfg))
    return _ffn_residual(p, x + h, cfg)[0], cache


def apply_block_decode(p: dict, x1: torch.Tensor, cache: attn.KVCache,
                       cfg: ArchConfig, *, ring: bool):
    h, cache = attn.decode_attention(
        p["attn"], apply_norm(x1, p["ln1"], cfg.norm), cache, ring=ring,
        **_attn_kw(cfg))
    return _ffn_residual(p, x1 + h, cfg)[0], cache


class TransformerLM(nn.Module):
    """Decoder-only LM (dense, moe, vlm): ``init``, ``forward``, ``loss``
    and the serving surface over an explicit parameter tree."""

    def __init__(self, cfg: ArchConfig):
        super().__init__()
        if cfg.family not in ("dense", "moe", "vlm"):
            raise ValueError(f"{cfg.name}: TransformerLM builds the dense, "
                             f"moe and vlm families, not {cfg.family!r}")
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
            "final_norm": init_norm(cfg.d_model, dtype,
                                    with_bias=cfg.norm == "layernorm",
                                    device=device),
        }
        if not cfg.tie_embeddings:
            p["lm_head"] = embed_init(gen, cfg.vocab_size, cfg.d_model, dtype,
                                      device=device).t().contiguous()
        return p

    # -------------------------------------------------------------- forward
    def _embed(self, params, tokens, image_embeds=None):
        """Token embeddings (times ``sqrt(d_model)`` in their own dtype
        with ``embed_scale``), after the image embeddings when given."""
        cfg = self.cfg
        x = embed_lookup(tokens, params["embed"])
        if cfg.embed_scale:
            x = x * torch.sqrt(torch.tensor(cfg.d_model, dtype=x.dtype,
                                            device=x.device))
        if image_embeds is not None:
            x = torch.cat([image_embeds.to(x.dtype), x], dim=1)
        return x.to(torch_dtype(cfg.dtype))

    def _layers(self, params) -> list:
        if self.cfg.scan_layers:
            return [tree_index(params["layers"], i)
                    for i in range(self.cfg.n_layers)]
        return params["layers"]

    def _hidden(self, params, batch):
        """(final-norm hidden states [B, S(+n_img), d], the summed aux)."""
        cfg = self.cfg
        x = self._embed(params, batch["tokens"], batch.get("image_embeds"))
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        block = lambda p, x: apply_block(p, x, cfg)  # noqa: E731
        if cfg.remat and cfg.scan_layers:
            block = remat.checkpoint(block)
        for p in self._layers(params):
            x, a = block(p, x)
            aux = aux + a
        return apply_norm(x, params["final_norm"], cfg.norm), aux

    def _head(self, params):
        return (params["embed"].t() if self.cfg.tie_embeddings
                else params["lm_head"])

    def forward(self, params, batch) -> torch.Tensor:
        """Full-sequence logits [B, S(+n_img), V]."""
        return self._hidden(params, batch)[0] @ self._head(params)

    def loss(self, params, batch) -> torch.Tensor:
        """Mean next-token cross entropy over the text positions, plus
        ``MOE_AUX_COEF`` times the summed load-balance terms (a float32
        scalar)."""
        x, aux = self._hidden(params, batch)
        img = batch.get("image_embeds")
        ce = chunked_ce(x, self._head(params), batch["tokens"],
                        prefix=0 if img is None else img.shape[1])
        return ce + MOE_AUX_COEF * aux

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
            for i, p in enumerate(self._layers(params)):
                view = attn.KVCache(caches.k[i], caches.v[i], caches.pos[i],
                                    caches.length)
                x, cache = block(p, x, view, cfg, ring=ring)
            return x, caches._replace(length=cache.length)
        new = []
        for p, cache in zip(params["layers"], caches):
            x, cache = block(p, x, cache, cfg, ring=ring)
            new.append(cache)
        return x, new

    def prefill(self, params, batch, caches):
        """Run the prompt (after its image embeddings for the vlm family);
        returns (last-token logits [B, 1, V], the caches filled)."""
        x = self._embed(params, batch["tokens"], batch.get("image_embeds"))
        x, caches = self._layers_with_caches(params, caches, x,
                                             apply_block_prefill)
        x = apply_norm(x[:, -1:], params["final_norm"], self.cfg.norm)
        return x @ self._head(params), caches

    def decode_step(self, params, token, caches):
        """One decode step. token: [B, 1] -> (logits [B, 1, V], caches)."""
        x = self._embed(params, token)
        x, caches = self._layers_with_caches(params, caches, x,
                                             apply_block_decode)
        x = apply_norm(x, params["final_norm"], self.cfg.norm)
        return x @ self._head(params), caches
