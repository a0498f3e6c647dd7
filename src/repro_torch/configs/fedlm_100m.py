"""fedlm-100m (port of ``src/repro/configs/fedlm_100m.py``): the paper-side
~107M-parameter dense LM that FedCET trains end to end — 14 layers,
d_model 640, 10 query / 5 KV heads of 64, SwiGLU d_ff 2560, vocab 16384,
untied head."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="fedlm-100m",
    family="dense",
    n_layers=14,
    d_model=640,
    n_heads=10,
    n_kv_heads=5,
    head_dim=64,
    d_ff=2560,
    vocab_size=16384,
    activation="swiglu",
    scan_layers=True,
    remat=False,
    citation="(paper-side example config)",
)
