"""Whisper-style encoder-decoder transformer [arXiv:2212.04356] (port of
``src/repro/models/encdec.py``).

The modality frontend (log-mel spectrogram, 2x conv downsampling) is a
stub: ``launch/input_specs.py`` supplies frame embeddings ``batch["frames"]
[B, T_enc, d]``. Downstream everything runs: the bidirectional encoder over
the frames plus sinusoidal positions, the causal decoder with
cross-attention to the encoder's output (``_cross_kv``,
``_cross_attend``), and KV-cached serving whose caches also hold each
layer's cross-attention keys and values (``cross_k``, ``cross_v``).
Whisper's conventions, as in the reference: LayerNorm with biases, GELU
MLPs with biases, attention biases, sinusoidal positions in the decoder
too (Whisper learns that table), no RoPE, the head tied to the
embeddings.

Routing: ``forward`` and ``loss`` take the reference's plain paths
(``attend_naive`` up to 1024 tokens, ``attend_blockwise`` past that; the
reference's encdec passes no ``use_pallas``). ``prefill`` sends the
encoder's bidirectional attention and the decoder's causal
self-attention through ``ops.flash_attention`` (``"auto"``: the kernel on
the card, the plain version on the CPU). Cross-attention stays
``attend_naive`` everywhere: no kernel of the reference computes it.

With ``cfg.remat`` and stacked layers, each encoder and decoder layer is
rematerialized in the backward (``models/remat.py``), as the
reference's ``jax.checkpoint`` on its scan bodies; the decoder's layers
take the encoder's output as an input, so its gradient reaches the
encoder.
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
    sinusoidal_positions,
    torch_dtype,
)
from repro_torch.models.losses import chunked_ce
from repro_torch.utils.sharding_ctx import (batch_local, grad_in_layout,
                                            local_layout, shard_residual,
                                            split_dim)
from repro_torch.utils.tree import tree_index


def _cross_kv(p, memory, n_heads, head_dim):
    memory = batch_local(memory)
    k = split_dim(memory @ p["wk"] + p["bk"], n_heads, head_dim)
    v = split_dim(memory @ p["wv"] + p["bv"], n_heads, head_dim)
    return k, v


def _cross_attend(p, x, k, v, n_heads, head_dim):
    B, S, _ = x.shape
    q = split_dim(batch_local(x) @ p["wq"] + p["bq"], n_heads, head_dim)
    q, k, v = local_layout((q, k, v), (2, 2, 2), n_heads)
    out = attn.attend_naive(q, k, v, attn.mask_fn("bidirectional"))
    return grad_in_layout(out.reshape(B, S, n_heads * head_dim) @ p["wo"]
                          + p["bo"])


def init_enc_block(gen, cfg: ArchConfig, *, lead: tuple = (), device=None):
    dtype = torch_dtype(cfg.param_dtype)
    kw = dict(lead=lead, device=device)
    return {
        "ln1": init_norm(cfg.d_model, dtype, with_bias=True, **kw),
        "attn": attn.init_attention(gen, cfg.d_model, cfg.n_heads,
                                    cfg.n_kv_heads, cfg.head_dim, dtype,
                                    with_bias=True, **kw),
        "ln2": init_norm(cfg.d_model, dtype, with_bias=True, **kw),
        "mlp": init_mlp(gen, cfg.d_model, cfg.d_ff, dtype, activation="gelu",
                        with_bias=True, **kw),
    }


def init_dec_block(gen, cfg: ArchConfig, *, lead: tuple = (), device=None):
    dtype = torch_dtype(cfg.param_dtype)
    kw = dict(lead=lead, device=device)
    return {
        "ln1": init_norm(cfg.d_model, dtype, with_bias=True, **kw),
        "self_attn": attn.init_attention(gen, cfg.d_model, cfg.n_heads,
                                         cfg.n_kv_heads, cfg.head_dim, dtype,
                                         with_bias=True, **kw),
        "ln_x": init_norm(cfg.d_model, dtype, with_bias=True, **kw),
        "cross_attn": attn.init_attention(gen, cfg.d_model, cfg.n_heads,
                                          cfg.n_heads, cfg.head_dim, dtype,
                                          with_bias=True, **kw),
        "ln2": init_norm(cfg.d_model, dtype, with_bias=True, **kw),
        "mlp": init_mlp(gen, cfg.d_model, cfg.d_ff, dtype, activation="gelu",
                        with_bias=True, **kw),
    }


class EncDecLM(nn.Module):
    """Encoder-decoder LM: ``init``, ``encode``, ``forward``, ``loss`` and
    the serving surface over an explicit parameter tree."""

    def __init__(self, cfg: ArchConfig):
        super().__init__()
        if cfg.family != "audio":
            raise ValueError(f"{cfg.name}: EncDecLM builds the audio family, "
                             f"not {cfg.family!r}")
        self.cfg = cfg

    # ------------------------------------------------------------------ init
    def init(self, gen: torch.Generator, device=None) -> dict:
        """Random parameters from ``gen`` (a ``torch.Generator`` on
        ``device``); the reference's shapes and scales, not its draws."""
        cfg = self.cfg
        dtype = torch_dtype(cfg.param_dtype)
        if cfg.scan_layers:
            enc = init_enc_block(gen, cfg, lead=(cfg.encoder_layers,),
                                 device=device)
            dec = init_dec_block(gen, cfg, lead=(cfg.n_layers,),
                                 device=device)
        else:
            enc = [init_enc_block(gen, cfg, device=device)
                   for _ in range(cfg.encoder_layers)]
            dec = [init_dec_block(gen, cfg, device=device)
                   for _ in range(cfg.n_layers)]
        return {
            "embed": embed_init(gen, cfg.vocab_size, cfg.d_model, dtype,
                                device=device),
            "encoder": enc,
            "enc_norm": init_norm(cfg.d_model, dtype, with_bias=True,
                                  device=device),
            "decoder": dec,
            "final_norm": init_norm(cfg.d_model, dtype, with_bias=True,
                                    device=device),
        }

    def _layers(self, params, key: str, n: int) -> list:
        if self.cfg.scan_layers:
            return [tree_index(params[key], i) for i in range(n)]
        return params[key]

    def _attn_kw(self) -> dict:
        cfg = self.cfg
        return dict(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                    head_dim=cfg.head_dim, use_rope=False)

    def _logits(self, params, x):
        x = apply_norm(x, params["final_norm"], "layernorm")
        return x @ params["embed"].t()  # whisper ties the output head

    # -------------------------------------------------------------- encoder
    def encode(self, params, frames, *, use_pallas: bool = False):
        """The encoder's output ``[B, T, d]``: frames plus sinusoidal
        positions through the bidirectional blocks; ``use_pallas`` sends
        their attention through the flash-attention kernel."""
        cfg = self.cfg
        x = frames.to(torch_dtype(cfg.dtype))
        x = x + sinusoidal_positions(x.shape[1], cfg.d_model, x.dtype,
                                     device=x.device)[None]

        def body(p, x):
            x = shard_residual(x)
            h = apply_norm(x, p["ln1"], "layernorm")
            x = x + attn.attention(p["attn"], h, kind="bidirectional",
                                   block_size=cfg.attn_block_size,
                                   use_pallas=use_pallas, **self._attn_kw())
            h = apply_norm(x, p["ln2"], "layernorm")
            return x + apply_mlp(h, p["mlp"], activation="gelu")

        if cfg.remat and cfg.scan_layers:
            body = remat.checkpoint(body)
        for p in self._layers(params, "encoder", cfg.encoder_layers):
            x = body(p, x)
        return apply_norm(x, params["enc_norm"], "layernorm")

    # -------------------------------------------------------------- decoder
    def _dec_embed(self, params, tokens, start_pos: int | None = None):
        """Token embeddings plus the sinusoidal positions ``0..S-1``, or
        the one position ``start_pos`` of a decode step."""
        cfg = self.cfg
        x = embed_lookup(tokens, params["embed"])
        x = x.to(torch_dtype(cfg.dtype))
        if start_pos is None:
            return x + sinusoidal_positions(tokens.shape[1], cfg.d_model,
                                            x.dtype, device=x.device)[None]
        inv = 1.0 / (10000.0 ** (torch.arange(0, cfg.d_model, 2,
                                              dtype=torch.float32,
                                              device=x.device) / cfg.d_model))
        ang = torch.tensor(float(start_pos), dtype=torch.float32,
                           device=x.device) * inv
        pe = torch.cat([torch.sin(ang), torch.cos(ang)])[None, None, :]
        return x + pe.to(x.dtype)

    def _cross(self, p, x, k, v):
        cfg = self.cfg
        h = apply_norm(x, p["ln_x"], "layernorm")
        x = x + _cross_attend(p["cross_attn"], h, k, v, cfg.n_heads,
                              cfg.head_dim)
        h = apply_norm(x, p["ln2"], "layernorm")
        return x + apply_mlp(h, p["mlp"], activation="gelu")

    def _decode_stack(self, params, batch):
        cfg = self.cfg
        memory = self.encode(params, batch["frames"])
        x = self._dec_embed(params, batch["tokens"])

        def body(p, x, memory):
            x = shard_residual(x)
            h = apply_norm(x, p["ln1"], "layernorm")
            x = x + attn.attention(p["self_attn"], h, kind="full",
                                   block_size=cfg.attn_block_size,
                                   **self._attn_kw())
            k, v = _cross_kv(p["cross_attn"], memory, cfg.n_heads,
                             cfg.head_dim)
            return self._cross(p, x, k, v)

        if cfg.remat and cfg.scan_layers:
            body = remat.checkpoint(body)
        for p in self._layers(params, "decoder", cfg.n_layers):
            x = body(p, x, memory)
        return x

    def forward(self, params, batch) -> torch.Tensor:
        """Decoder logits [B, S, V] over ``batch["tokens"]``, attending to
        ``batch["frames"]``."""
        return self._logits(params, self._decode_stack(params, batch))

    def loss(self, params, batch) -> torch.Tensor:
        """Mean next-token cross entropy of the decoder (a float32
        scalar)."""
        x = apply_norm(self._decode_stack(params, batch),
                       params["final_norm"], "layernorm")
        return chunked_ce(x, params["embed"].t(), batch["tokens"])

    # ---------------------------------------------------------------- serve
    def init_caches(self, batch: int, seq_len: int, device=None):
        """Per decoder layer a self-attention KV cache of ``seq_len``
        slots and zero cross-attention keys and values ``[B,
        encoder_len, H, D]``: a list of ``{"self", "cross_k",
        "cross_v"}``, or one such dict of stacked ``[L, ...]`` tensors."""
        cfg = self.cfg
        dtype = torch_dtype(cfg.dtype)
        one = lambda: {  # noqa: E731
            "self": attn.init_cache(batch, seq_len, cfg.n_kv_heads,
                                    cfg.head_dim, dtype, device=device),
            "cross_k": torch.zeros((batch, cfg.encoder_len, cfg.n_heads,
                                    cfg.head_dim), dtype=dtype,
                                   device=device),
            "cross_v": torch.zeros((batch, cfg.encoder_len, cfg.n_heads,
                                    cfg.head_dim), dtype=dtype,
                                   device=device)}
        if cfg.scan_layers:
            c = one()
            stack = lambda t: t.expand(  # noqa: E731
                (cfg.n_layers,) + t.shape).contiguous()
            s = c["self"]
            return {"self": attn.KVCache(stack(s.k), stack(s.v),
                                         stack(s.pos), 0),
                    "cross_k": stack(c["cross_k"]),
                    "cross_v": stack(c["cross_v"])}
        return [one() for _ in range(cfg.n_layers)]

    def _with_caches(self, params, caches, x, block, *, cross: bool):
        """Run ``block(p, x, cache) -> (x, cache)`` over the decoder
        layers; a stacked self-attention cache is written in place through
        per-layer views, and the cross keys and values the blocks return
        are restacked when ``cross`` (the prefill computes them; decode
        steps keep them)."""
        cfg = self.cfg
        layers = self._layers(params, "decoder", cfg.n_layers)
        if not cfg.scan_layers:
            new = []
            for p, cache in zip(layers, caches):
                x, cache = block(p, x, cache)
                new.append(cache)
            return x, new
        s = caches["self"]
        out = []
        for i, p in enumerate(layers):
            view = {"self": attn.KVCache(s.k[i], s.v[i], s.pos[i], s.length),
                    "cross_k": caches["cross_k"][i],
                    "cross_v": caches["cross_v"][i]}
            x, c = block(p, x, view)
            out.append(c)
        caches = {**caches, "self": s._replace(length=out[-1]["self"].length)}
        if cross:
            caches["cross_k"] = torch.stack([c["cross_k"] for c in out])
            caches["cross_v"] = torch.stack([c["cross_v"] for c in out])
        return x, caches

    def prefill(self, params, batch, caches):
        """Encode ``batch["frames"]`` and run the decoder prompt
        ``batch["tokens"]``; returns (last-token logits [B, 1, V], the
        caches filled)."""
        cfg = self.cfg
        memory = self.encode(params, batch["frames"], use_pallas=True)

        def block(p, x, cache):
            h = apply_norm(x, p["ln1"], "layernorm")
            h, self_c = attn.prefill_attention(
                p["self_attn"], h, cache=cache["self"], kind="full",
                **self._attn_kw())
            k, v = _cross_kv(p["cross_attn"], memory, cfg.n_heads,
                             cfg.head_dim)
            return (self._cross(p, x + h, k, v),
                    {"self": self_c, "cross_k": k, "cross_v": v})

        x, caches = self._with_caches(
            params, caches, self._dec_embed(params, batch["tokens"]), block,
            cross=True)
        return self._logits(params, x[:, -1:]), caches

    def decode_step(self, params, token, caches):
        """One decode step. token: [B, 1] -> (logits [B, 1, V], caches)."""
        s = caches["self"] if self.cfg.scan_layers else caches[0]["self"]

        def block(p, x1, cache):
            h = apply_norm(x1, p["ln1"], "layernorm")
            h, self_c = attn.decode_attention(
                p["self_attn"], h, cache["self"], kind="full",
                **self._attn_kw())
            return (self._cross(p, x1 + h, cache["cross_k"],
                                cache["cross_v"]),
                    {**cache, "self": self_c})

        x, caches = self._with_caches(
            params, caches, self._dec_embed(params, token,
                                            start_pos=s.length), block,
            cross=False)
        return self._logits(params, x), caches
