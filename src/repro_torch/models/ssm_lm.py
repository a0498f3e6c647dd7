"""Pure-SSM language model, the mamba2-130m family (port of
``src/repro/models/ssm_lm.py``): an attention-free decoder of Mamba2
blocks (``models/mamba2.py``).

The model is a pure function of an explicit parameter tree with the
reference's keys and layouts (``embed [V, d]``, an untied ``lm_head [d,
V]``), in both of its layer layouts: stacked ``[L, ...]`` leaves
(``scan_layers=True``, the full config; the reference's ``lax.scan`` a
loop over ``L``) or a list of per-layer dicts (``reduced()``). With
``cfg.remat`` each stacked block is rematerialized in the backward
(``models/remat.py``), as the reference's ``jax.checkpoint``.

Serving: ``init_caches`` (one ``SSMCache`` of stacked ``[L, ...]``
tensors for stacked layers, a list otherwise; the state is O(1) in the
sequence length), ``prefill`` (every block's intra-chunk term through
the SSD kernel on the card) and ``decode_step``. ``use_pallas_ssd`` sends
``forward`` through the same kernel; it has no backward, so ``loss`` under
autograd raises then on the card.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
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
from repro_torch.utils.tree import tree_index


class Mamba2LM(nn.Module):
    """Mamba2 LM: ``init``, ``forward``, ``loss`` and the serving surface
    over an explicit parameter tree."""

    def __init__(self, cfg: ArchConfig):
        super().__init__()
        if cfg.family != "ssm":
            raise ValueError(f"{cfg.name}: Mamba2LM builds the ssm family, "
                             f"not {cfg.family!r}")
        self.cfg = cfg

    # ------------------------------------------------------------------ init
    def init(self, gen: torch.Generator, device=None) -> dict:
        """Random parameters from ``gen`` (a ``torch.Generator`` on
        ``device``); the reference's shapes and scales, not its draws."""
        cfg = self.cfg
        dtype = torch_dtype(cfg.param_dtype)
        if cfg.scan_layers:
            layers = init_mamba_block(gen, cfg, lead=(cfg.n_layers,),
                                      device=device)
        else:
            layers = [init_mamba_block(gen, cfg, device=device)
                      for _ in range(cfg.n_layers)]
        return {
            "embed": embed_init(gen, cfg.vocab_size, cfg.d_model, dtype,
                                device=device),
            "layers": layers,
            "final_norm": init_norm(cfg.d_model, dtype, device=device),
            "lm_head": embed_init(gen, cfg.vocab_size, cfg.d_model, dtype,
                                  device=device).t().contiguous(),
        }

    # -------------------------------------------------------------- forward
    def _embed(self, params, tokens):
        x = embed_lookup(tokens, params["embed"])
        return x.to(torch_dtype(self.cfg.dtype))

    def _layers(self, params) -> list:
        if self.cfg.scan_layers:
            return [tree_index(params["layers"], i)
                    for i in range(self.cfg.n_layers)]
        return params["layers"]

    def _hidden(self, params, tokens):
        """Final-norm hidden states [B, S, d]."""
        cfg = self.cfg
        x = self._embed(params, tokens)
        block = lambda p, x: apply_mamba_block(p, x, cfg)  # noqa: E731
        if cfg.remat and cfg.scan_layers:
            block = remat.checkpoint(block)
        for p in self._layers(params):
            x = block(p, x)
        return apply_norm(x, params["final_norm"], cfg.norm)

    def forward(self, params, batch) -> torch.Tensor:
        """Full-sequence logits [B, S, V]."""
        return self._hidden(params, batch["tokens"]) @ params["lm_head"]

    def loss(self, params, batch) -> torch.Tensor:
        """Mean next-token cross entropy (a float32 scalar)."""
        return chunked_ce(self._hidden(params, batch["tokens"]),
                          params["lm_head"], batch["tokens"])

    # ---------------------------------------------------------------- serve
    def init_caches(self, batch: int, seq_len: int, device=None):
        """Empty SSM caches; their size does not depend on ``seq_len``."""
        del seq_len
        cfg = self.cfg
        dtype = torch_dtype(cfg.dtype)
        if cfg.scan_layers:
            c = init_ssm_cache(batch, cfg, dtype, device=device)
            stack = lambda t: t.expand(  # noqa: E731
                (cfg.n_layers,) + t.shape).contiguous()
            return SSMCache(stack(c.conv), stack(c.state), 0)
        return [init_ssm_cache(batch, cfg, dtype, device=device)
                for _ in range(cfg.n_layers)]

    def _layers_with_caches(self, params, caches, x, block):
        """Run ``block(p, x, cache, cfg)`` over the layers; stacked caches
        come back restacked."""
        if self.cfg.scan_layers:
            convs, states, length = [], [], caches.length
            for i, p in enumerate(self._layers(params)):
                x, c = block(p, x, SSMCache(caches.conv[i], caches.state[i],
                                            caches.length), self.cfg)
                convs.append(c.conv)
                states.append(c.state)
                length = c.length
            return x, SSMCache(torch.stack(convs), torch.stack(states),
                               length)
        new = []
        for p, cache in zip(params["layers"], caches):
            x, cache = block(p, x, cache, self.cfg)
            new.append(cache)
        return x, new

    def _logits(self, params, x):
        return apply_norm(x, params["final_norm"],
                          self.cfg.norm) @ params["lm_head"]

    def prefill(self, params, batch, caches):
        """Run the prompt; returns (last-token logits [B, 1, V], the
        caches)."""
        x = self._embed(params, batch["tokens"])
        x, caches = self._layers_with_caches(params, caches, x,
                                             apply_mamba_block_prefill)
        return self._logits(params, x[:, -1:]), caches

    def decode_step(self, params, token, caches):
        """One decode step. token: [B, 1] -> (logits [B, 1, V], caches)."""
        x = self._embed(params, token)
        x, caches = self._layers_with_caches(params, caches, x,
                                             apply_mamba_block_decode)
        return self._logits(params, x), caches
