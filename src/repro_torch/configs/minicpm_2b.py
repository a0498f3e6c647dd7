"""minicpm-2b [dense] (port of ``src/repro/configs/minicpm_2b.py``): a
llama-like model trained with the WSD schedule [arXiv:2404.06395] — 40
layers, d_model 2304, 36 heads of 64 (MHA), SwiGLU d_ff 5760, vocab
122,753, tied embeddings. The WSD schedule lives in
``optim/schedules.py``."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="minicpm-2b",
    family="dense",
    n_layers=40,
    d_model=2304,
    n_heads=36,
    n_kv_heads=36,      # MHA
    head_dim=64,
    d_ff=5760,
    vocab_size=122753,
    activation="swiglu",
    tie_embeddings=True,  # MiniCPM ties input/output embeddings
    citation="arXiv:2404.06395",
)
