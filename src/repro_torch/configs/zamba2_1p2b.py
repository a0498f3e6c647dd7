"""zamba2-1.2b [hybrid] (port of ``src/repro/configs/zamba2_1p2b.py``): a
Mamba2 backbone with one parameter-shared attention(+MLP) block
[arXiv:2411.15242] — 38 Mamba2 layers (d_model 2048, 64 SSD heads of 64,
state 64), the shared block (32 heads of 64, MHA, SwiGLU d_ff 8192)
applied after every 6 of them, vocab 32,000. The shared block attends
through a 4096-token sliding window, the reference's sub-quadratic
variant for long-context serving."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,      # the shared attention block is MHA
    head_dim=64,
    d_ff=8192,          # shared block MLP
    vocab_size=32000,
    ssm_state=64,
    ssm_headdim=64,
    ssm_expand=2,
    shared_attn_every=6,
    attention="sliding",
    window=4096,
    activation="swiglu",
    citation="arXiv:2411.15242",
)
