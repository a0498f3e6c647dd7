"""Zamba2-style hybrid LM: a Mamba2 backbone and ONE shared attention(+MLP)
block [arXiv:2411.15242] (port of ``src/repro/models/hybrid.py``).

Groups of ``shared_attn_every`` Mamba2 layers (``models/mamba2.py``)
alternate with an application of a single parameter-shared transformer
block (``models/transformer.py``'s ``apply_block*``). The shared block's
parameters exist once; each of its applications owns a KV cache, a ring
of ``window`` slots when the block attends through a sliding window.
Zamba2's per-application LoRA adapters are left out, as in the reference.

Layer layout for ``n_layers = G * every + R``: ``[every x mamba,
shared-attn] * G``, then the ``R`` trailing Mamba2 layers (``rest``).
The Mamba groups come in the reference's two layouts: one tree of
``[G, every, ...]`` leaves (``scan_layers=True``, the full config; the
reference's nested ``lax.scan`` a loop over both axes) or nested lists
(``reduced()``); with ``cfg.remat`` each stacked group (its Mamba2
layers and the shared block) is rematerialized in the backward
(``models/remat.py``), as the reference's ``jax.checkpoint`` on its
group body. Caches follow: ``{"ssm": SSMCache of [G, every, ...] (or
nested lists), "kv": KVCache of [G, ...] (or a list), "rest": [SSMCache]}``,
the stacked ones written in place through per-layer views.

Routing, as the port's other families: ``forward`` and ``loss`` follow
``cfg.use_pallas_attention`` and ``cfg.use_pallas_ssd``; ``prefill``
sends the shared block's full-sequence attention through
``ops.flash_attention`` and every Mamba2 block's intra-chunk SSD term
through ``ops.ssd_intra`` (each ``"auto"``: the kernel on the card, the
plain version on the CPU).
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn
from repro_torch.models import remat
from repro_torch.models.layers import (apply_norm, embed_init, embed_lookup,
                                       init_norm, torch_dtype)
from repro_torch.models.losses import chunked_ce
from repro_torch.models.mamba2 import (
    SSMCache,
    apply_mamba_block,
    apply_mamba_block_decode,
    apply_mamba_block_prefill,
    init_mamba_block,
    init_ssm_cache,
)
from repro_torch.models.transformer import (apply_block, apply_block_decode,
                                            apply_block_prefill, init_block)
from repro_torch.utils.tree import tree_map


def _layout(cfg: ArchConfig) -> tuple[int, int, int]:
    """(groups G, Mamba layers a group, trailing Mamba layers R)."""
    every = cfg.shared_attn_every
    groups = cfg.n_layers // every if every else 0
    return groups, every, cfg.n_layers - groups * every


def _expand(t: torch.Tensor, lead: tuple) -> torch.Tensor:
    return t.expand(lead + t.shape).contiguous()


class HybridLM(nn.Module):
    """Mamba2 + shared-attention LM: ``init``, ``forward``, ``loss`` and
    the serving surface over an explicit parameter tree."""

    def __init__(self, cfg: ArchConfig):
        super().__init__()
        if cfg.family != "hybrid":
            raise ValueError(f"{cfg.name}: HybridLM builds the hybrid family, "
                             f"not {cfg.family!r}")
        self.cfg = cfg

    def _stacked(self) -> bool:
        return self.cfg.scan_layers and _layout(self.cfg)[0] > 0

    # ------------------------------------------------------------------ init
    def init(self, gen: torch.Generator, device=None) -> dict:
        """Random parameters from ``gen`` (a ``torch.Generator`` on
        ``device``); the reference's shapes and scales, not its draws."""
        cfg = self.cfg
        dtype = torch_dtype(cfg.param_dtype)
        groups, every, rest = _layout(cfg)
        if self._stacked():
            grouped = init_mamba_block(gen, cfg, lead=(groups, every),
                                       device=device)
        else:
            grouped = [[init_mamba_block(gen, cfg, device=device)
                        for _ in range(every)] for _ in range(groups)]
        return {
            "embed": embed_init(gen, cfg.vocab_size, cfg.d_model, dtype,
                                device=device),
            "groups": grouped,
            "shared_attn": init_block(gen, cfg, device=device),
            "rest": [init_mamba_block(gen, cfg, device=device)
                     for _ in range(rest)],
            "final_norm": init_norm(cfg.d_model, dtype, device=device),
            "lm_head": embed_init(gen, cfg.vocab_size, cfg.d_model, dtype,
                                  device=device).t().contiguous(),
        }

    def _groups(self, params) -> list:
        """The Mamba blocks' parameters as ``[group][layer]``, from either
        layout."""
        groups, every, _ = _layout(self.cfg)
        if self._stacked():
            return [[tree_map(lambda t: t[g, i], params["groups"])
                     for i in range(every)] for g in range(groups)]
        return params["groups"]

    def _embed(self, params, tokens):
        x = embed_lookup(tokens, params["embed"])
        return x.to(torch_dtype(self.cfg.dtype))

    def _logits(self, params, x):
        return apply_norm(x, params["final_norm"],
                          self.cfg.norm) @ params["lm_head"]

    # ------------------------------------------------------------- training
    def _stack(self, params, x):
        cfg = self.cfg

        def group_body(group, shared, x):
            for p in group:
                x = apply_mamba_block(p, x, cfg)
            return apply_block(shared, x, cfg)[0]

        if cfg.remat and self._stacked():
            group_body = remat.checkpoint(group_body)
        for group in self._groups(params):
            x = group_body(group, params["shared_attn"], x)
        for p in params["rest"]:
            x = apply_mamba_block(p, x, cfg)
        return x

    def forward(self, params, batch) -> torch.Tensor:
        """Full-sequence logits [B, S, V]."""
        return self._logits(params, self._stack(
            params, self._embed(params, batch["tokens"])))

    def loss(self, params, batch) -> torch.Tensor:
        """Mean next-token cross entropy (a float32 scalar)."""
        x = self._stack(params, self._embed(params, batch["tokens"]))
        x = apply_norm(x, params["final_norm"], self.cfg.norm)
        return chunked_ce(x, params["lm_head"], batch["tokens"])

    # ---------------------------------------------------------------- serve
    def _attn_window_cap(self, seq_len: int) -> int:
        cfg = self.cfg
        # the shared block attends through a sliding window in long-context
        # serving, so the hybrid stays sub-quadratic.
        if cfg.attention == "sliding":
            return min(cfg.window, seq_len)
        return seq_len

    def init_caches(self, batch: int, seq_len: int, device=None) -> dict:
        """Empty caches: an SSM cache per Mamba2 layer (O(1) in
        ``seq_len``) and a KV cache per application of the shared block,
        of ``min(window, seq_len)`` slots for a sliding window."""
        cfg = self.cfg
        dtype = torch_dtype(cfg.dtype)
        groups, every, rest = _layout(cfg)
        cap = self._attn_window_cap(seq_len)
        ssm_one = lambda: init_ssm_cache(batch, cfg, dtype,  # noqa: E731
                                         device=device)
        kv_one = lambda: attn.init_cache(batch, cap, cfg.n_kv_heads,  # noqa: E731
                                         cfg.head_dim, dtype, device=device)
        if self._stacked():
            s, k = ssm_one(), kv_one()
            ssm = SSMCache(_expand(s.conv, (groups, every)),
                           _expand(s.state, (groups, every)), 0)
            kv = attn.KVCache(_expand(k.k, (groups,)), _expand(k.v, (groups,)),
                              _expand(k.pos, (groups,)), 0)
        else:
            ssm = [[ssm_one() for _ in range(every)] for _ in range(groups)]
            kv = [kv_one() for _ in range(groups)]
        return {"ssm": ssm, "kv": kv, "rest": [ssm_one() for _ in range(rest)]}

    def _with_caches(self, params, caches, x, mamba_block, attn_block):
        """Run the layers with their caches: ``mamba_block(p, x, cache,
        cfg)`` and ``attn_block(p, x, cache, cfg, ring=...)``. Stacked
        caches are read through per-layer views and written back in place;
        lists come back new."""
        cfg = self.cfg
        ring = cfg.attention == "sliding"
        stacked = self._stacked()
        ssm, kv = caches["ssm"], caches["kv"]
        ssm_new, kv_new, length = [], [], None
        for g, group in enumerate(self._groups(params)):
            gc = []
            for i, p in enumerate(group):
                if stacked:
                    c = SSMCache(ssm.conv[g, i], ssm.state[g, i], ssm.length)
                    x, c = mamba_block(p, x, c, cfg)
                    ssm.conv[g, i].copy_(c.conv)
                    ssm.state[g, i].copy_(c.state)
                else:
                    x, c = mamba_block(p, x, ssm[g][i], cfg)
                gc.append(c)
            view = (attn.KVCache(kv.k[g], kv.v[g], kv.pos[g], kv.length)
                    if stacked else kv[g])
            x, c = attn_block(params["shared_attn"], x, view, cfg, ring=ring)
            ssm_new.append(gc)
            kv_new.append(c)
            length = c.length
        rest = []
        for p, c in zip(params["rest"], caches["rest"]):
            x, c = mamba_block(p, x, c, cfg)
            rest.append(c)
        if stacked:
            ssm_new = ssm._replace(length=length)
            kv_new = kv._replace(length=length)
        return x, {"ssm": ssm_new, "kv": kv_new, "rest": rest}

    def prefill(self, params, batch, caches):
        """Run the prompt; returns (last-token logits [B, 1, V], the
        caches filled)."""
        x = self._embed(params, batch["tokens"])
        x, caches = self._with_caches(params, caches, x,
                                      apply_mamba_block_prefill,
                                      apply_block_prefill)
        return self._logits(params, x[:, -1:]), caches

    def decode_step(self, params, token, caches):
        """One decode step. token: [B, 1] -> (logits [B, 1, V], caches)."""
        x = self._embed(params, token)
        x, caches = self._with_caches(params, caches, x,
                                      apply_mamba_block_decode,
                                      apply_block_decode)
        return self._logits(params, x), caches
