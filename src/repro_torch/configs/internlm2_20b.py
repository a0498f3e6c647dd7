"""internlm2-20b [dense] (port of ``src/repro/configs/internlm2_20b.py``):
GQA [arXiv:2403.17297] — 48 layers, d_model 6144, 48 query / 8 KV heads
of 128, SwiGLU d_ff 16,384, vocab 92,544, rope_theta 1e6, untied head."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="internlm2-20b",
    family="dense",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,       # GQA kv=8
    head_dim=128,
    d_ff=16384,
    vocab_size=92544,
    activation="swiglu",
    rope_theta=1e6,
    citation="arXiv:2403.17297",
)
