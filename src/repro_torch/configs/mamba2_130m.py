"""mamba2-130m [ssm] (port of ``src/repro/configs/mamba2_130m.py``): SSD
(state-space duality), attention-free [arXiv:2405.21060] — 24 layers,
d_model 768, 24 SSD heads of 64 (expand 2, d_inner 1536), state 128,
causal conv of 4, vocab 50,280, untied head."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-130m",
    family="ssm",
    n_layers=24,
    d_model=768,
    n_heads=0,          # attention-free
    n_kv_heads=0,
    head_dim=None,
    d_ff=0,             # no MLP blocks in mamba2
    vocab_size=50280,
    ssm_state=128,
    ssm_headdim=64,
    ssm_expand=2,       # d_inner = 1536 -> 24 SSD heads
    citation="arXiv:2405.21060",
)
