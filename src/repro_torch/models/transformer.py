"""Decoder-only dense transformer LM (port of
``src/repro/models/transformer.py``, dense family, training path).

The model is a pure function of an explicit parameter tree with the
reference's keys and layouts (``embed [V, d]``, ``lm_head [d, V]``, dense
weights ``[d_in, d_out]``), because FedCET treats the whole tree as the
optimization variable and stacks it over clients. Two layer layouts, as in
the reference: stacked ``[L, ...]`` leaves (``scan_layers=True``, the full
config; the reference's ``lax.scan`` becomes a loop over ``L``) or a list
of per-layer dicts (``reduced()``). Activation checkpointing (``remat``)
is not applied: the model runs inside ``torch.func`` transforms.

MoE, VLM inputs, decode and prefill wait for later slices.
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
)
from repro_torch.models.losses import chunked_ce

_DTYPES = {"float32": torch.float32, "float64": torch.float64,
           "bfloat16": torch.bfloat16}


def torch_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


def init_block(gen: torch.Generator, cfg: ArchConfig, *, lead: tuple = (),
               device=None) -> dict:
    dtype = torch_dtype(cfg.param_dtype)
    kw = dict(lead=lead, device=device)
    return {
        "ln1": init_norm(cfg.d_model, dtype, **kw),
        "attn": attn.init_attention(
            gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
            dtype, **kw),
        "ln2": init_norm(cfg.d_model, dtype, **kw),
        "mlp": init_mlp(gen, cfg.d_model, cfg.d_ff, dtype,
                        activation=cfg.activation, **kw),
    }


def apply_block(p: dict, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """One decoder block over a full sequence."""
    h = rms_norm(x, p["ln1"]["weight"])
    h = attn.attention(
        p["attn"], h, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.head_dim, kind=cfg.attention, window=cfg.window,
        chunk=cfg.chunk, rope_theta=cfg.rope_theta, use_rope=cfg.use_rope)
    x = x + h
    h = rms_norm(x, p["ln2"]["weight"])
    return x + apply_mlp(h, p["mlp"], activation=cfg.activation)


class TransformerLM(nn.Module):
    """Dense decoder-only LM: ``init``, ``forward`` and ``loss`` over an
    explicit parameter tree."""

    def __init__(self, cfg: ArchConfig):
        super().__init__()
        unsupported = {
            "family": cfg.family != "dense",
            "n_experts": bool(cfg.n_experts),
            "norm": cfg.norm != "rmsnorm",
            "attn_bias": cfg.attn_bias,
            "qk_norm": cfg.qk_norm,
            "mlp_bias": cfg.mlp_bias,
            "use_pallas_attention": cfg.use_pallas_attention,
            "embed_scale": cfg.embed_scale,
        }
        bad = [k for k, v in unsupported.items() if v]
        if bad:
            raise NotImplementedError(
                f"{cfg.name}: {', '.join(bad)} not yet ported (the port runs "
                "the dense RMSNorm/SwiGLU transformer)")
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
    def _hidden(self, params, tokens):
        """Final-norm hidden states [B, S, d]."""
        cfg = self.cfg
        x = F.embedding(tokens.to(torch.int64), params["embed"])
        x = x.to(torch_dtype(cfg.dtype))
        if cfg.scan_layers:
            for i in range(cfg.n_layers):
                x = apply_block(_index(params["layers"], i), x, cfg)
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


def _index(tree, i: int):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]
