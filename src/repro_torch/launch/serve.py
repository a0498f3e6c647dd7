"""Serving entry point, single host (port of ``src/repro/launch/serve.py``:
``generate`` and its CLI): a batched prefill that fills the caches, then
token-by-token decode against them, for every model family.

The prefill runs every full-sequence attention through the flash-attention
kernel (``kernels/csrc/flash_attention.cu``) on the card, its plain
version on the CPU: the decoder layers of the dense, moe and vlm families
(the vlm's over its image tokens and the prompt), the hybrid's shared
block, and whisper's bidirectional encoder and causal decoder. Every
Mamba2 block's intra-chunk SSD term (the ssm and hybrid families) goes
through the SSD kernel (``kernels/csrc/ssd_intra.cu``). Decode attends one
token against the KV caches (``models/attention.py:attend_decode``) and
advances the SSM states. The prompt batch is ``input_specs.make_batch``'s:
tokens, plus ``image_embeds`` (vlm) or ``frames`` (audio). Tokens are
greedy (argmax) or sampled with ``jax.random.categorical``'s draws
(``core/prng.py``), so a run from the reference's weights and prompt emits
the reference's tokens. ``lower_prefill`` and ``lower_decode`` (XLA AOT
lowering over a mesh) wait for ``launch/{mesh,partition}.py`` (ROADMAP.md
Queue 1, launch and roofline).

Run as a script:
    python -m repro_torch.launch.serve --arch fedlm-100m --full \\
        --prompt-len 2048 --gen-len 64 --batch 4
    python -m repro_torch.launch.serve --arch qwen3-1.7b --full \\
        --prompt-len 8192 --gen-len 32 --batch 1
    python -m repro_torch.launch.serve --arch zamba2-1.2b --full \\
        --prompt-len 8192 --gen-len 32 --batch 1
    python -m repro_torch.launch.serve --arch whisper-small --full \\
        --prompt-len 64 --gen-len 64 --batch 4
    python -m repro_torch.launch.serve --arch granite-moe-3b-a800m \\
        --prompt-len 32 --gen-len 8 --batch 2 --device cpu
"""

from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.core import prng
from repro_torch.launch import input_specs as ispec
from repro_torch.models import build_model


def cache_len(cfg, prompt_len: int, gen_len: int) -> int:
    """Positions a serving cache must hold: the prompt and the generated
    tokens, after the image tokens for the vlm family."""
    extra = cfg.n_modal_tokens if cfg.family == "vlm" else 0
    return prompt_len + gen_len + extra


def generate_tokens(model, params, batch: dict, *, gen_len: int,
                    greedy: bool = True, seed: int = 0) -> torch.Tensor:
    """The generation loop of :func:`generate` for given weights and
    prompt: prefill ``batch`` (``tokens [B, S]``, and ``image_embeds`` or
    ``frames``) into caches of :func:`cache_len` positions, then
    ``gen_len`` decode steps. The first token is the
    prefill's argmax; each next one the argmax (``greedy``) or a
    categorical draw under key ``seed + 2``, split once per step, as the
    reference draws. Returns int32 ``[B, gen_len]`` on the tokens' device."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    caches = model.init_caches(B, cache_len(model.cfg, S, gen_len),
                               device=tokens.device)
    key = prng.key(seed + 2)
    out = []
    with torch.no_grad():
        logits, caches = model.prefill(params, batch, caches)
        tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
        for _ in range(gen_len):
            out.append(tok)
            logits, caches = model.decode_step(params, tok, caches)
            if greedy:
                tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
            else:
                key, k = prng.split(key)
                tok = prng.categorical(k, logits[:, -1])[:, None].to(
                    torch.int32)
    return torch.cat(out, dim=1)


def generate(arch: str, *, prompt_len: int = 32, gen_len: int = 32,
             batch: int = 2, reduced: bool = True, seed: int = 0,
             greedy: bool = True, device=None) -> torch.Tensor:
    """Generate ``gen_len`` tokens for ``batch`` random prompts of
    ``prompt_len`` tokens (the reference's prompt: ``make_batch`` under key
    ``seed + 1``) from random weights drawn from ``seed`` (the port's own
    draws). Runs on the card unless ``device`` says otherwise."""
    device = resolve_device(device)
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    model = build_model(cfg)
    params = model.init(torch.Generator(device=device).manual_seed(seed),
                        device=device)
    prompt = ispec.make_batch(cfg, batch, prompt_len, key=seed + 1,
                              device=device)
    return generate_tokens(model, params, prompt, gen_len=gen_len,
                           greedy=greedy, seed=seed)


def main(argv=None) -> None:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=32)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--full", action="store_true",
                    help="the full-width config (default: reduced())")
    ap.add_argument("--device", default=None,
                    help="cpu to run without a card (default: cuda)")
    a = ap.parse_args(argv)
    out = generate(a.arch, prompt_len=a.prompt_len, gen_len=a.gen_len,
                   batch=a.batch, reduced=not a.full, device=a.device)
    print("generated token ids:")
    print(out)


if __name__ == "__main__":
    main()
