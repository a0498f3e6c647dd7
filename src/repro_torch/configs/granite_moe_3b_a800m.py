"""granite-moe-3b-a800m [moe] (port of
``src/repro/configs/granite_moe_3b_a800m.py``): 40 experts, top-8 routing
[hf:ibm-granite/granite-3.0-1b-a400m-base] — 32 layers, d_model 1536, 24
query / 8 KV heads of 64, SwiGLU experts of d_ff 512, vocab 49,155,
capacity factor 1.25."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,       # GQA kv=8
    head_dim=64,
    d_ff=512,           # per expert
    vocab_size=49155,
    n_experts=40,
    experts_per_token=8,
    activation="swiglu",
    citation="hf:ibm-granite/granite-3.0-1b-a400m-base",
)
