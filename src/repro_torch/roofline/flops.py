"""Analytic compute and memory cost of one step per (arch x shape) (port
of ``src/repro/roofline/flops.py``).

The formulas are the reference's, term for term and in its order of
operations, so at bfloat16 every field equals the reference's. Why
analytic there holds here too: eager PyTorch counts no FLOPs, and the dry
run traces on fake tensors, which compute nothing.

Conventions:
  * matmul FLOPs = 2mnk; training = 4x forward for the scanned blocks
    (fwd + 2x bwd + 1x remat recompute), 3x for the un-remat'd LM head.
    The port recomputes where ``cfg.remat`` holds (``models/remat.py``);
    fedlm-100m and the ``reduced()`` configs do not, as in the reference,
    and the term bills them the same 4x.
  * the baseline blockwise attention computes ALL KV blocks then masks, so
    its attention context is S (not S/2 causal / w sliding). The port's
    flash kernel skips fully masked tiles, so a measured time can beat
    this term.
  * MODEL_FLOPS = 6*N*D (train) / 2*N*D (inference), N = active params,
    D = tokens processed per step.

One generalisation: the reference writes every element width as a
literal 2 (bfloat16). The port takes it from the config: parameters at
``cfg.param_dtype``'s width, activations, logits and caches at
``cfg.dtype``'s, so a float32 path is not billed half its bytes. The SSM
state is float32 in both (``* 4``).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.models.layers import torch_dtype


@dataclasses.dataclass(frozen=True)
class StepCost:
    flops_per_device: float          # analytic compiled-work estimate
    hbm_bytes_per_device: float      # analytic HBM traffic estimate
    model_flops_total: float         # 6*N_active*D (or 2*N*D inference)
    n_params: int
    n_active_params: int
    detail: dict


def _width(name: str) -> int:
    return torch_dtype(name).itemsize


# ------------------------------------------------------------ param counts
def param_counts(cfg: ArchConfig) -> tuple[int, int]:
    """(total, active-per-token) parameter counts, exact from the port's
    tree built on the ``meta`` device (nothing is allocated)."""
    from repro_torch.models import build_model

    params = build_model(cfg).init(torch.Generator(), device="meta")
    leaves = torch.utils._pytree.tree_flatten_with_path(params)[0]
    total = sum(leaf.numel() for _, leaf in leaves)
    if not cfg.n_experts:
        return total, total
    expert = 0
    for kp, leaf in leaves:
        names = [getattr(k, "key", "") for k in kp]
        # routed experts only: the shared expert (".../moe/shared/...") is
        # always active and must not be discounted.
        if ("moe" in names and "shared" not in names
                and str(names[-1]) in ("gate", "up", "down")):
            expert += leaf.numel()
    active = total - expert + int(expert * cfg.experts_per_token / cfg.n_experts)
    return total, active


# ------------------------------------------------------- per-token forward
def _attn_ctx(cfg: ArchConfig, S: int, *, decode: bool) -> int:
    """Effective KV length each query attends over in the BASELINE impl."""
    if decode:
        if cfg.attention == "sliding":
            return min(cfg.window, S)
        if cfg.attention == "chunked":
            return min(cfg.chunk, S)
        return S
    # baseline blockwise visits every KV block (masking, not skipping)
    return S


def _dense_block_flops_per_token(cfg: ArchConfig, ctx: int) -> float:
    d, hq, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    proj = 2 * d * (hq * dh) * 2 + 2 * d * (hkv * dh) * 2  # wq+wo, wk+wv
    attn = 2 * hq * dh * ctx * 2                           # scores + AV
    if cfg.n_experts:
        k = cfg.experts_per_token
        mlp = 6 * d * cfg.d_ff * k + 2 * d * cfg.n_experts
        if cfg.moe_shared_expert:
            mlp += 6 * d * cfg.d_ff
    else:
        n_mats = 3 if cfg.activation in ("swiglu", "geglu") else 2
        mlp = 2 * d * cfg.d_ff * n_mats
    return proj + attn + mlp


def _mamba_block_flops_per_token(cfg: ArchConfig, chunk: int = 128) -> float:
    d = cfg.d_model
    d_in = cfg.ssm_expand * d
    h = d_in // cfg.ssm_headdim
    p = cfg.ssm_headdim
    n = cfg.ssm_state
    proj = 2 * d * (2 * d_in + 2 * n + h) + 2 * d_in * d
    conv = 2 * cfg.ssm_conv * (d_in + 2 * n)
    lc = chunk
    ssd = 2 * n * lc + 2 * lc * h * p + 4 * n * h * p  # cb + intra + states/inter
    return proj + conv + ssd


def _per_token_forward_flops(cfg: ArchConfig, ctx: int) -> float:
    """Per-token forward FLOPs through all blocks (no embed/head)."""
    if cfg.family == "ssm":
        return cfg.n_layers * _mamba_block_flops_per_token(cfg)
    if cfg.family == "hybrid":
        every = cfg.shared_attn_every or cfg.n_layers + 1
        n_attn = cfg.n_layers // every
        return (cfg.n_layers * _mamba_block_flops_per_token(cfg)
                + n_attn * _dense_block_flops_per_token(cfg, ctx))
    if cfg.family == "audio":
        # decoder blocks + cross attention against encoder_len
        dec = _dense_block_flops_per_token(cfg, ctx)
        d, hq, dh = cfg.d_model, cfg.n_heads, cfg.head_dim
        cross = 2 * d * (hq * dh) * 2 + 2 * hq * dh * cfg.encoder_len * 2
        return cfg.n_layers * (dec + cross)
    return cfg.n_layers * _dense_block_flops_per_token(cfg, ctx)


def _head_flops_per_token(cfg: ArchConfig) -> float:
    return 2 * cfg.d_model * cfg.vocab_size


def _encoder_flops(cfg: ArchConfig, batch: int) -> float:
    if cfg.family != "audio":
        return 0.0
    t = cfg.encoder_len
    per_tok = cfg.encoder_layers * _dense_block_flops_per_token(
        dataclasses.replace(cfg, n_experts=0, activation="gelu"), t)
    return per_tok * t * batch


# ------------------------------------------------------------- step costs
def train_cost(cfg: ArchConfig, shape: ShapeConfig, *, n_devices: int,
               tau: int = 2) -> StepCost:
    n_total, n_active = param_counts(cfg)
    S = shape.seq_len
    tokens = shape.global_batch * S          # per local step
    extra = cfg.n_modal_tokens if cfg.family == "vlm" else 0
    tokens_with_modal = shape.global_batch * (S + extra)

    fwd_blocks = _per_token_forward_flops(cfg, _attn_ctx(cfg, S + extra, decode=False))
    fwd = fwd_blocks * tokens_with_modal + _head_flops_per_token(cfg) * tokens_with_modal
    fwd += _encoder_flops(cfg, shape.global_batch)
    step = (4.0 * (fwd - _head_flops_per_token(cfg) * tokens_with_modal)
            + 3.0 * _head_flops_per_token(cfg) * tokens_with_modal)
    total = step * tau                       # tau local steps per round
    model_flops = 6.0 * n_active * tokens * tau

    # HBM traffic: FedCET state streams (x, d read; v written; grads) are
    # ~7 param-passes per local step + layer-boundary activations + logits.
    w = _width(cfg.dtype)
    param_bytes = n_total * _width(cfg.param_dtype)
    act_bytes = (cfg.n_layers * tokens_with_modal * cfg.d_model * w) * 4
    logit_bytes = tokens_with_modal * cfg.vocab_size * w * 3
    hbm = tau * (7.0 * param_bytes + act_bytes + logit_bytes)
    return StepCost(
        flops_per_device=total / n_devices,
        hbm_bytes_per_device=hbm / n_devices,
        model_flops_total=model_flops,
        n_params=n_total, n_active_params=n_active,
        detail={"fwd_flops": fwd, "tokens_per_local_step": tokens,
                "tau": tau, "param_bytes": param_bytes},
    )


def prefill_cost(cfg: ArchConfig, shape: ShapeConfig, *, n_devices: int) -> StepCost:
    n_total, n_active = param_counts(cfg)
    S = shape.seq_len
    extra = cfg.n_modal_tokens if cfg.family == "vlm" else 0
    tokens = shape.global_batch * (S + extra)
    fwd = (_per_token_forward_flops(cfg, _attn_ctx(cfg, S + extra, decode=False))
           * tokens + _head_flops_per_token(cfg) * shape.global_batch)
    fwd += _encoder_flops(cfg, shape.global_batch)
    model_flops = 2.0 * n_active * tokens
    param_bytes = n_total * _width(cfg.param_dtype)
    kv_token_bytes = _cache_bytes_per_token(cfg)
    # layer-boundary activations, written and read back
    hbm = param_bytes + tokens * kv_token_bytes + \
        cfg.n_layers * tokens * cfg.d_model * _width(cfg.dtype) * 2
    return StepCost(
        flops_per_device=fwd / n_devices,
        hbm_bytes_per_device=hbm / n_devices,
        model_flops_total=model_flops,
        n_params=n_total, n_active_params=n_active,
        detail={"tokens": tokens},
    )


def _cache_bytes_per_token(cfg: ArchConfig) -> float:
    if cfg.family == "ssm":
        return 0.0  # O(1) state
    n_attn = cfg.n_layers
    if cfg.family == "hybrid":
        n_attn = cfg.n_layers // (cfg.shared_attn_every or cfg.n_layers + 1)
    return n_attn * 2 * cfg.n_kv_heads * cfg.head_dim * _width(cfg.dtype)  # k+v


def decode_cost(cfg: ArchConfig, shape: ShapeConfig, *, n_devices: int) -> StepCost:
    n_total, n_active = param_counts(cfg)
    B = shape.global_batch
    ctx = _attn_ctx(cfg, shape.seq_len, decode=True)
    fwd = (_per_token_forward_flops(cfg, ctx) + _head_flops_per_token(cfg)) * B
    model_flops = 2.0 * n_active * B
    param_bytes = n_total * _width(cfg.param_dtype)
    # decode HBM: weights once + the live cache window read per step
    if cfg.family == "ssm":
        d_in = cfg.ssm_expand * cfg.d_model
        h = d_in // cfg.ssm_headdim
        cache_read = cfg.n_layers * B * h * cfg.ssm_headdim * cfg.ssm_state * 4 * 2
    else:
        cache_read = B * ctx * _cache_bytes_per_token(cfg)
        if cfg.family == "hybrid":
            d_in = cfg.ssm_expand * cfg.d_model
            h = d_in // cfg.ssm_headdim
            cache_read += cfg.n_layers * B * h * cfg.ssm_headdim * cfg.ssm_state * 4 * 2
    hbm = param_bytes + cache_read
    return StepCost(
        flops_per_device=fwd / n_devices,
        hbm_bytes_per_device=hbm / n_devices,
        model_flops_total=model_flops,
        n_params=n_total, n_active_params=n_active,
        detail={"ctx": ctx, "cache_read_bytes": cache_read},
    )


def cost_for(cfg: ArchConfig, shape: ShapeConfig, *, n_devices: int,
             tau: int = 2) -> StepCost:
    if shape.kind == "train":
        return train_cost(cfg, shape, n_devices=n_devices, tau=tau)
    if shape.kind == "prefill":
        return prefill_cost(cfg, shape, n_devices=n_devices)
    return decode_cost(cfg, shape, n_devices=n_devices)
