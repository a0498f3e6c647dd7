"""NVIDIA-Nemotron-3-Nano-30B-A3B [nemotron_h] (a port-only entry: the
JAX package has no such config, so it stays out of ``list_archs()``,
which mirrors the reference's registry; ``get_config`` resolves it):
[hf:nvidia/NVIDIA-Nemotron-3-Nano-30B-A3B-BF16, config.json] — 52
single-mixer blocks by ``hybrid_override_pattern`` (M Mamba2, E MoE, *
GQA attention), d_model 2688; Mamba2 64 heads of 64 (d_inner 4096), 8
B/C groups, state 128, conv 4, chunk 128; MoE 128 relu² experts of 1856,
top 6 by sigmoid score plus a correction bias, the top-k weights
normalized and times 2.5, one relu² shared expert of 3712; attention 32
query / 2 KV heads of 128 with no positional embedding; vocab 131,072,
untied head, RMSNorm eps 1e-5."""

from repro_torch.configs.base import ArchConfig

PATTERN = ("MEMEM*EMEMEM*EMEMEM*EMEMEM*EMEMEM*EMEMEMEM*EMEMEMEME")

CONFIG = ArchConfig(
    name="nemotron-3-nano-30b-a3b",
    family="nemotron_h",
    n_layers=len(PATTERN),
    d_model=2688,
    n_heads=32,
    n_kv_heads=2,
    head_dim=128,
    d_ff=1856,            # per routed expert
    vocab_size=131072,
    use_rope=False,
    activation="relu2",
    norm_eps=1e-5,
    n_experts=128,
    experts_per_token=6,
    moe_routed_scale=2.5,
    moe_shared_ff=3712,
    ssm_state=128,
    ssm_headdim=64,
    ssm_heads=64,
    ssm_groups=8,
    ssm_conv=4,
    layer_pattern=PATTERN,
    citation="hf:nvidia/NVIDIA-Nemotron-3-Nano-30B-A3B-BF16",
)
