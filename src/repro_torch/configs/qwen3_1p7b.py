"""qwen3-1.7b (port of ``src/repro/configs/qwen3_1p7b.py``): dense, 28
layers, d_model 2048, 16 query / 8 KV heads of 128, qk-norm, a 4096-token
sliding window (the reference's sub-quadratic variant), rope_theta 1e6,
SwiGLU d_ff 6144, vocab 151,936, untied head [hf:Qwen/Qwen3-8B]."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-1.7b",
    family="dense",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,       # GQA kv=8
    head_dim=128,
    d_ff=6144,
    vocab_size=151936,
    qk_norm=True,
    attention="sliding",
    window=4096,
    activation="swiglu",
    rope_theta=1e6,
    citation="hf:Qwen/Qwen3-8B",
)
