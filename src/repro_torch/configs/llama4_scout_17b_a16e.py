"""llama4-scout-17b-a16e [moe] (port of
``src/repro/configs/llama4_scout_17b_a16e.py``): a 16-expert top-1 MoE
with a shared expert and chunked local attention (iRoPE-style, 8192-token
chunks) [hf:meta-llama/Llama-4-Scout-17B-16E] — 48 layers, d_model 5120,
40 query / 8 KV heads of 128, SwiGLU experts of d_ff 8192, vocab 202,048,
rope_theta 5e5. The chunked mask is the reference's sub-quadratic variant
for long-context decode; its workloads are text tokens."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,       # GQA kv=8
    head_dim=128,
    d_ff=8192,          # per expert
    vocab_size=202048,
    n_experts=16,
    experts_per_token=1,   # top-1 routing
    moe_shared_expert=True,
    attention="chunked",
    chunk=8192,
    activation="swiglu",
    rope_theta=5e5,
    citation="hf:meta-llama/Llama-4-Scout-17B-16E",
)
